"""LMDB file-format reader and writer in Python (no liblmdb); counterpart of
videovector_tpu/data/lmdbio.py, whose files it writes byte for byte and
reads.

Every reference dataset lives in an LMDB (or LevelDB) environment: the data
layers open it read-only and walk a forward cursor
(ref:src/caffe/layers/video_sampled_shots_data_layer.cpp:122-135 —
mdb_env_open(MDB_RDONLY|MDB_NOTLS) → mdb_open(txn, NULL) → cursor MDB_FIRST/
MDB_NEXT), and FlexibleDataLayer additionally seeks by key
(ref:src/caffe/layers/flexible_data_layer.cpp:230-329, MDB_SET).

This module implements the LMDB 0.9.x on-disk format (little-endian, 64-bit
— the only layout the reference's Linux builds produce) directly:

  file = page[0..N), psize bytes each (default 4096)
  page 0, 1      : meta pages — MDB_page header (16 B, flags P_META) then
                   MDB_meta {magic 0xBEEFC0DE, version, address, mapsize,
                   dbs[2] (FREE_DBI, MAIN_DBI), last_pg, txnid};
                   the live meta is the one with the larger txnid.
                   psize lives in dbs[0].md_pad (mm_psize alias).
  branch page    : header {pgno u64, pad u16, flags u16, lower u16, upper u16}
                   + u16 node-offset array (sorted by key) + nodes packed
                   from the page end. Branch node = {pgno lo u16, pgno hi
                   u16, pgno top u16 (bits 32-47), ksize u16, key bytes};
                   node[0]'s key is ignored by search (-inf).
  leaf page      : same header; leaf node = {dsize lo u16, dsize hi u16,
                   flags u16, ksize u16, key bytes, value bytes}. Flag
                   F_BIGDATA (0x01) replaces the value with a u64 pgno of an
                   overflow-page chain.
  overflow pages : header with flags P_OVERFLOW and pb_pages = page count;
                   value bytes run contiguously from offset 16 of the first
                   page across the chain.

The reader mmaps data.mdb, walks the MAIN_DBI B-tree leaves in key order and
exposes the same interface as records.RecordReader (len/key/value/iter/
index_of), so every data source works over reference LMDBs unmodified.
The writer produces a single-transaction environment (txnid 1) laid out
bottom-up (sorted leaves, then branch levels, then metas), which the
reference's tools open: extract_features --backend=lmdb writes it, and
chip_smoke.py writes its training stores with it.

Not supported (and not used by any reference dataset): named sub-databases,
MDB_DUPSORT/DUPFIXED dup pages (P_LEAF2/P_SUBP), 32-bit and big-endian
layouts.
"""

from __future__ import annotations

import mmap
import os
import struct

MDB_MAGIC = 0xBEEFC0DE
P_INVALID = 0xFFFFFFFFFFFFFFFF

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

F_BIGDATA = 0x01
F_SUBDATA = 0x02
F_DUPDATA = 0x04

PAGEHDRSZ = 16
NODESZ = 8
DEFAULT_PSIZE = 4096

# MDB_page header: pgno u64 | pad u16 | flags u16 | lower u16 | upper u16
_PAGEHDR = struct.Struct("<QHHHH")
# MDB_node header: lo u16 | hi u16 | flags u16 | ksize u16
_NODEHDR = struct.Struct("<HHHH")
# MDB_db: pad u32 | flags u16 | depth u16 | branch u64 | leaf u64 | ovf u64
#         | entries u64 | root u64
_DB = struct.Struct("<IHHQQQQQ")
# MDB_meta prefix: magic u32 | version u32 | address u64 | mapsize u64
_METAHDR = struct.Struct("<IIQQ")
_META_TAIL = struct.Struct("<QQ")  # last_pg, txnid


def _even(n: int) -> int:
    return n + (n & 1)


def resolve_lmdb_path(path: str) -> str | None:
    """Return the data file for an LMDB environment path (directory
    containing data.mdb, or a direct file path that sniffs as LMDB)."""
    if os.path.isdir(path):
        cand = os.path.join(path, "data.mdb")
        return cand if os.path.exists(cand) else None
    if os.path.exists(path):
        try:
            with open(path, "rb") as f:
                head = f.read(PAGEHDRSZ + 8)
            if len(head) >= PAGEHDRSZ + 4 and \
                    struct.unpack_from("<I", head, PAGEHDRSZ)[0] == MDB_MAGIC:
                return path
        except OSError:
            return None
    return None


class LmdbReader:
    """Read-only view of an LMDB environment's MAIN_DBI, RecordReader-shaped.

    The key index (per-entry leaf offsets) is built eagerly at open; values
    stay mmap-backed and are sliced on demand (zero copy until touched).
    Iteration order is the B-tree key order — exactly the reference's
    MDB_FIRST/MDB_NEXT cursor order.
    """

    def __init__(self, path: str):
        data = resolve_lmdb_path(path)
        if data is None:
            raise ValueError(f"{path}: not an LMDB environment")
        self._file = open(data, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        meta = self._read_meta()
        self._psize = meta["psize"]
        # (key, value_offset, value_len) per entry, key order
        self._entries: list[tuple[bytes, int, int]] = []
        if meta["root"] != P_INVALID:
            self._walk(meta["root"])
        self._declared_entries = meta["entries"]
        self._key_to_idx: dict[bytes, int] | None = None

    # -- format decoding -------------------------------------------------
    def _read_meta(self) -> dict:
        mm = self._mm
        magic, version, _addr, _mapsize = _METAHDR.unpack_from(mm, PAGEHDRSZ)
        if magic != MDB_MAGIC:
            raise ValueError("bad LMDB magic in meta page 0")
        psize = struct.unpack_from("<I", mm, PAGEHDRSZ + _METAHDR.size)[0]
        metas = []
        for pg in (0, 1):
            base = pg * psize + PAGEHDRSZ
            m_magic, m_version, _, _ = _METAHDR.unpack_from(mm, base)
            if m_magic != MDB_MAGIC:
                continue
            dbs_off = base + _METAHDR.size
            main = _DB.unpack_from(mm, dbs_off + _DB.size)
            last_pg, txnid = _META_TAIL.unpack_from(
                mm, dbs_off + 2 * _DB.size)
            metas.append({
                "psize": psize, "version": m_version, "txnid": txnid,
                "last_pg": last_pg, "root": main[7], "entries": main[6],
                "depth": main[2],
            })
        if not metas:
            raise ValueError("no valid LMDB meta page")
        return max(metas, key=lambda m: m["txnid"])

    def _page(self, pgno: int) -> int:
        off = pgno * self._psize
        if off + PAGEHDRSZ > len(self._mm):
            raise ValueError(f"LMDB page {pgno} out of bounds")
        return off

    def _walk(self, pgno: int) -> None:
        mm = self._mm
        off = self._page(pgno)
        _pg, _pad, flags, lower, upper = _PAGEHDR.unpack_from(mm, off)
        nkeys = (lower - PAGEHDRSZ) >> 1
        if flags & P_LEAF2:
            raise ValueError("MDB_DUPFIXED (P_LEAF2) pages not supported")
        if flags & P_BRANCH:
            for i in range(nkeys):
                noff = off + struct.unpack_from("<H", mm,
                                                off + PAGEHDRSZ + 2 * i)[0]
                lo, hi, top, _ksize = _NODEHDR.unpack_from(mm, noff)
                child = lo | (hi << 16) | (top << 32)
                self._walk(child)
        elif flags & P_LEAF:
            for i in range(nkeys):
                noff = off + struct.unpack_from("<H", mm,
                                                off + PAGEHDRSZ + 2 * i)[0]
                lo, hi, nflags, ksize = _NODEHDR.unpack_from(mm, noff)
                if nflags & (F_SUBDATA | F_DUPDATA):
                    raise ValueError("DUPSORT databases not supported")
                dsize = lo | (hi << 16)
                key = bytes(mm[noff + NODESZ:noff + NODESZ + ksize])
                voff = noff + NODESZ + ksize
                if nflags & F_BIGDATA:
                    ovf_pgno = struct.unpack_from("<Q", mm, voff)[0]
                    voff = self._page(ovf_pgno) + PAGEHDRSZ
                self._entries.append((key, voff, dsize))
        else:
            raise ValueError(f"unexpected page flags {flags:#x} at pgno {pgno}")

    # -- RecordReader interface -------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    def key(self, i: int) -> bytes:
        return self._entries[i][0]

    def value(self, i: int) -> bytes:
        _, off, ln = self._entries[i]
        return self._mm[off:off + ln]

    def __getitem__(self, i: int) -> tuple[bytes, bytes]:
        key, off, ln = self._entries[i]
        return key, self._mm[off:off + ln]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]

    def index_of(self, key) -> int:
        """Exact-key seek (the reference's MDB_SET,
        ref:src/caffe/layers/flexible_data_layer.cpp:230-235)."""
        if isinstance(key, str):
            key = key.encode()
        if self._key_to_idx is None:
            self._key_to_idx = {k: i for i, (k, _, _) in
                                enumerate(self._entries)}
        idx = self._key_to_idx.get(key)
        if idx is None:
            raise KeyError(key)
        return idx

    def get(self, key) -> bytes:
        return self.value(self.index_of(key))

    def close(self) -> None:
        self._mm.close()
        self._file.close()


class LmdbWriter:
    """Write a fresh single-transaction LMDB environment.

    Keys are sorted (memcmp order — LMDB's default comparator) regardless of
    append order, matching what `mdb_put` of the reference converters
    produces. Values larger than the node maximum go to overflow pages, as
    liblmdb does (F_BIGDATA).
    """

    def __init__(self, path: str, *, psize: int = DEFAULT_PSIZE,
                 subdir: bool = True, mapsize: int | None = None):
        if subdir:
            os.makedirs(path, exist_ok=True)
            self._path = os.path.join(path, "data.mdb")
        else:
            self._path = path
        self._psize = psize
        self._mapsize = mapsize
        # liblmdb: me_nodemax = ((psize - PAGEHDRSZ) / MDB_MINKEYS) & -2
        self._nodemax = ((psize - PAGEHDRSZ) // 2) & ~1
        self._items: dict[bytes, bytes] = {}
        self._closed = False

    def put(self, key, value: bytes) -> None:
        if isinstance(key, str):
            key = key.encode()
        if isinstance(value, memoryview):
            value = bytes(value)
        if not 0 < len(key) <= 511:  # MDB_MAXKEYSIZE default
            raise ValueError(f"key length {len(key)} out of range [1, 511]")
        self._items[key] = value

    # alias matching the reference db-wrapper verb
    append = put

    def _pack_page(self, pgno: int, flags: int, nodes: list[bytes]) -> bytes:
        psize = self._psize
        lower = PAGEHDRSZ + 2 * len(nodes)
        page = bytearray(psize)
        upper = psize
        offs = []
        for nd in nodes:
            upper -= _even(len(nd))
            page[upper:upper + len(nd)] = nd
            offs.append(upper)
        if upper < lower:
            raise AssertionError("page overflow in writer")
        _PAGEHDR.pack_into(page, 0, pgno, 0, flags, lower, upper)
        for i, o in enumerate(offs):
            struct.pack_into("<H", page, PAGEHDRSZ + 2 * i, o)
        return bytes(page)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        psize = self._psize
        items = sorted(self._items.items())
        pages: list[bytes] = []  # data pages, pgno = 2 + index
        next_pgno = 2
        n_overflow = 0

        def alloc(n=1):
            nonlocal next_pgno
            pg = next_pgno
            next_pgno += n
            return pg

        # --- overflow chains (allocated before their leaf reference) -----
        # --- leaves -------------------------------------------------------
        cap = psize - PAGEHDRSZ
        leaf_specs: list[tuple[bytes, int]] = []  # (first_key, pgno)
        cur_nodes: list[bytes] = []
        cur_used = 0
        cur_first: bytes | None = None
        leaf_pages: list[tuple[int, list[bytes]]] = []

        def flush_leaf():
            nonlocal cur_nodes, cur_used, cur_first
            if cur_nodes:
                pg = alloc()
                leaf_pages.append((pg, cur_nodes))
                leaf_specs.append((cur_first, pg))
                cur_nodes, cur_used, cur_first = [], 0, None

        overflow_pages: list[tuple[int, int, bytes]] = []  # pgno, npages, val
        for key, value in items:
            if NODESZ + len(key) + len(value) > self._nodemax:
                ovpages = (PAGEHDRSZ + len(value) + psize - 1) // psize
                node = _NODEHDR.pack(len(value) & 0xFFFF,
                                     (len(value) >> 16) & 0xFFFF,
                                     F_BIGDATA, len(key)) + key
                flush_needed_size = _even(len(node) + 8) + 2
                if cur_used + flush_needed_size > cap:
                    flush_leaf()
                ov_pg = alloc(ovpages)
                n_overflow += ovpages
                overflow_pages.append((ov_pg, ovpages, value))
                node += struct.pack("<Q", ov_pg)
            else:
                node = _NODEHDR.pack(len(value) & 0xFFFF,
                                     (len(value) >> 16) & 0xFFFF,
                                     0, len(key)) + key + value
                if cur_used + _even(len(node)) + 2 > cap:
                    flush_leaf()
            if cur_first is None:
                cur_first = key
            cur_nodes.append(node)
            cur_used += _even(len(node)) + 2
        flush_leaf()

        # --- branch levels --------------------------------------------------
        depth = 1 if leaf_specs else 0
        n_branch = 0
        level = leaf_specs
        while len(level) > 1:
            depth += 1
            nxt: list[tuple[bytes, int]] = []
            cur: list[tuple[bytes, int]] = []
            cur_used = 0
            branch_batches: list[list[tuple[bytes, int]]] = []

            def flush_branch():
                nonlocal cur, cur_used
                if cur:
                    branch_batches.append(cur)
                    cur, cur_used = [], 0

            for j, (first_key, child_pg) in enumerate(level):
                ks = 0 if not cur else len(first_key)  # node[0] key = -inf
                sz = _even(NODESZ + ks) + 2
                if cur_used + sz > cap:
                    flush_branch()
                    ks = 0
                    sz = _even(NODESZ) + 2
                cur.append((first_key, child_pg))
                cur_used += sz
            flush_branch()

            branch_pages_local: list[tuple[int, list[bytes]]] = []
            for batch in branch_batches:
                pg = alloc()
                n_branch += 1
                nodes = []
                for i, (first_key, child_pg) in enumerate(batch):
                    k = b"" if i == 0 else first_key
                    nodes.append(_NODEHDR.pack(
                        child_pg & 0xFFFF, (child_pg >> 16) & 0xFFFF,
                        (child_pg >> 32) & 0xFFFF, len(k)) + k)
                branch_pages_local.append((pg, nodes))
                nxt.append((batch[0][0], pg))
            leaf_pages.extend(branch_pages_local)  # same emit list
            level = nxt

        root = level[0][1] if level else P_INVALID

        # --- emit file ------------------------------------------------------
        total_pages = next_pgno
        buf = bytearray(total_pages * psize)

        def meta_page(pgno: int, txnid: int) -> bytes:
            page = bytearray(psize)
            _PAGEHDR.pack_into(page, 0, pgno, 0, P_META, 0, 0)
            mapsize = self._mapsize or max(total_pages * psize, 1 << 20)
            _METAHDR.pack_into(page, PAGEHDRSZ, MDB_MAGIC, 1, 0, mapsize)
            dbs = PAGEHDRSZ + _METAHDR.size
            # FREE_DBI: md_pad doubles as mm_psize
            _DB.pack_into(page, dbs, psize, 0, 0, 0, 0, 0, 0, P_INVALID)
            # MAIN_DBI
            _DB.pack_into(page, dbs + _DB.size, 0, 0, depth,
                          n_branch, len(leaf_pages) - n_branch,
                          n_overflow, len(items), root)
            _META_TAIL.pack_into(page, dbs + 2 * _DB.size,
                                 total_pages - 1, txnid)
            return bytes(page)

        buf[0:psize] = meta_page(0, 0)
        buf[psize:2 * psize] = meta_page(1, 1)  # live meta: larger txnid
        # leaf_pages holds both leaves and branches; flags by membership
        leaf_pgnos = {pg for _, pg in leaf_specs}
        for pg, nodes in leaf_pages:
            flags = P_LEAF if pg in leaf_pgnos else P_BRANCH
            buf[pg * psize:(pg + 1) * psize] = self._pack_page(
                pg, flags, nodes)
        for ov_pg, npages, value in overflow_pages:
            hdr = bytearray(PAGEHDRSZ)
            _PAGEHDR.pack_into(hdr, 0, ov_pg, 0, P_OVERFLOW,
                               npages & 0xFFFF, (npages >> 16) & 0xFFFF)
            start = ov_pg * psize
            buf[start:start + PAGEHDRSZ] = hdr
            buf[start + PAGEHDRSZ:start + PAGEHDRSZ + len(value)] = value

        with open(self._path, "wb") as f:
            f.write(buf)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
