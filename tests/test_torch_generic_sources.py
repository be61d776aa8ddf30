"""The rest of the port's data layer zoo (videovector_tpu_torch.data.generic:
MEMORY_DATA, HDF5_DATA, WINDOW_DATA, FLEXIBLE_DATA, VIDEO_SHOT_WINDOW_DATA
and its VIDEO_ID_TEXT backend) against the JAX package's on the CPU.

The same stores, files and seed go through both packages' sources; every
batch must be equal bit for bit (the sources are numpy on both sides). The stores are
written by the port, in VVR, LMDB or LevelDB. The HDF5 files are written by
h5py with its defaults (superblock 0, a symbol-table root group, v1 object
headers, contiguous or chunked with deflate and shuffle), as the reference's
generate_sample_data.py writes sample_data.h5 and sample_data_2_gzip.h5, and
by the port's own writer; JAX's source reads them with h5py, the port's
with data/hdf5.py.
"""

import numpy as np
import pytest

from videovector_tpu.data import generic as jgen
from videovector_tpu_torch.data import generic as tgen
from videovector_tpu_torch.data import hdf5 as thdf5
from videovector_tpu_torch.data import records as trec
from videovector_tpu_torch.data import wire as twire
from videovector_tpu_torch.data.transformer import TransformConfig

h5py = pytest.importorskip("h5py")
cv2 = pytest.importorskip("cv2")

DIM = 12


def _bits_equal(a: dict, b: dict):
    assert list(a) == list(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape and x.dtype == y.dtype, (k, x.shape, y.shape)
        assert x.tobytes() == y.tobytes(), k


def _same_batches(tsrc, jsrc, n: int = 4):
    for _ in range(n):
        _bits_equal(tsrc.next_batch(), jsrc.next_batch())


# -- fixtures, shared with tests/test_torch_data_factory.py -----------------

def write_shot_windows(path: str, backend: str, *, n: int = 40,
                       contexts: int = 2, videos: int = 7, seed: int = 3):
    """n VideoShotWindow records (target + `contexts` context shots of DIM
    floats), keys "%08d", through the port's writer for `backend`."""
    rs = np.random.RandomState(seed)
    with trec.open_store_writer(path, backend) as w:
        for i in range(n):
            words = [twire.Datum(float_data=rs.randn(DIM).astype(np.float32))
                     for _ in range(1 + contexts)]
            w.put(f"{i:08d}", twire.VideoShotWindow(
                video_id=1 + i % videos, shot_id=i, target_shot_word=words[0],
                context_shot_words=words[1:]).encode())
    return path


def write_window_images(tmp, *, seed: int = 5):
    """Two PNG images and a window file in the reference's format, with
    foreground and background windows, some reaching past the border."""
    rs = np.random.RandomState(seed)
    lines = []
    for i, (h, w) in enumerate(((60, 80), (70, 50))):
        path = str(tmp / f"img{i}.png")
        cv2.imwrite(path, rs.randint(0, 256, (h, w, 3)).astype(np.uint8))
        boxes = [(1 + i, 0.9, 0, 0, w // 2, h // 2),
                 (2, 0.7, w // 3, h // 4, w - 1, h - 1),
                 (0, 0.1, 5, 5, 20, 30), (0, 0.2, w - 25, h - 20, w - 1, h - 1)]
        lines += [f"# {i}", path, "3", str(h), str(w), str(len(boxes))]
        lines += [" ".join(str(v) for v in b) for b in boxes]
    src = tmp / "windows.txt"
    src.write_text("\n".join(lines) + "\n")
    return str(src)


def write_flexible_stores(tmp, backend: str = "lmdb", *, frames: int = 9,
                          side: int = 10, seed: int = 6):
    """A frame store ("f<i>.png" keys, Datums of 3 x side x side pixels)
    and an index store (9-char prefix + frame name, value "<label>xx")."""
    rs = np.random.RandomState(seed)
    frame_path = str(tmp / f"frames_{backend}")
    with trec.open_store_writer(frame_path, backend) as w:
        for i in range(frames):
            pix = rs.randint(0, 256, (3, side, side)).astype(np.uint8)
            w.put(f"f{i}.png", twire.Datum(channels=3, height=side, width=side,
                                           data=pix.tobytes()).encode())
    index_path = str(tmp / f"index_{backend}")
    with trec.open_store_writer(index_path, backend) as w:
        for j, center in enumerate((2, 4, 3, 6)):
            w.put(f"{j:09d}f{center}", f"{7 + j:04d}ab".encode())
    return index_path, frame_path


def reference_sample_h5(tmp):
    """The reference's generate_sample_data.py: sample_data.h5 (f32
    arange data, 1-based labels) and its gzip twin (data + total, uint8
    labels, gzip level 1), written by h5py with its defaults."""
    total = 10 * 8 * 6 * 5
    data = np.arange(total).reshape(10, 8, 6, 5).astype("float32")
    label = (1 + np.arange(10)[:, np.newaxis]).astype("float32")
    label2 = (1 + 2 * np.arange(10)[:, np.newaxis]).astype("float32")
    plain, gz = str(tmp / "sample_data.h5"), str(tmp / "sample_data_2_gzip.h5")
    with h5py.File(plain, "w") as f:
        f["data"], f["label"], f["label2"] = data, label, label2
    with h5py.File(gz, "w") as f:
        f.create_dataset("data", data=data + total, compression="gzip",
                         compression_opts=1)
        for k, v in (("label", label), ("label2", label2)):
            f.create_dataset(k, data=v, compression="gzip",
                             compression_opts=1, dtype="uint8")
    return plain, gz


def _list_file(tmp, paths, name="list.txt"):
    path = tmp / name
    path.write_text("".join(f"{p}\n" for p in paths))
    return str(path)


# -- MEMORY_DATA and VIDEO_ID_TEXT ---------------------------------------------

def test_memory_data_source_matches_jax(rng):
    arrays = {"x": rng.randn(7, 3).astype(np.float32),
              "y": np.arange(7, dtype=np.int32)}
    _same_batches(tgen.MemoryDataSource(arrays, 4),
                  jgen.MemoryDataSource(arrays, 4), n=5)
    for mod in (tgen, jgen):
        with pytest.raises(ValueError, match="same leading dim"):
            mod.MemoryDataSource({"a": np.zeros(3), "b": np.zeros(4)}, 2)


def test_video_id_text_source_matches_jax(tmp_path):
    ids = tmp_path / "ids.txt"
    ids.write_text("4 8 15\n16 23\n42\n")
    _same_batches(tgen.VideoIdTextSource(str(ids), 4),
                  jgen.VideoIdTextSource(str(ids), 4), n=4)
    (tmp_path / "none.txt").write_text("\n")
    for mod in (tgen, jgen):
        with pytest.raises(ValueError, match="no video ids"):
            mod.VideoIdTextSource(str(tmp_path / "none.txt"), 2)


# -- VIDEO_SHOT_WINDOW_DATA --------------------------------------------------------

@pytest.mark.parametrize("backend", ["leveldb", "lmdb", "vvr"])
def test_video_shot_window_source_matches_jax(tmp_path, backend):
    """Reservoir negatives filled from the main cursor, swaps, the store
    read in its own key order, for each backend."""
    path = write_shot_windows(str(tmp_path / f"w_{backend}"), backend)
    kw = dict(num_negative_samples=3, max_buffer_size=8,
              negative_swap_percentage=50, seed=11)
    _same_batches(tgen.VideoShotWindowSource(path, 5, **kw),
                  jgen.VideoShotWindowSource(path, 5, **kw), n=10)


def test_video_shot_window_source_separate_negatives_and_errors(tmp_path):
    path = write_shot_windows(str(tmp_path / "w"), "leveldb")
    negs = write_shot_windows(str(tmp_path / "n"), "lmdb", n=20, seed=9)
    kw = dict(num_negative_samples=2, max_buffer_size=10,
              negative_swap_percentage=30, negative_path=negs, seed=2,
              display_all_ids=True)
    _same_batches(tgen.VideoShotWindowSource(path, 3, **kw),
                  jgen.VideoShotWindowSource(path, 3, **kw), n=6)
    for mod in (tgen, jgen):
        with pytest.raises(ValueError, match="max_buffer_size"):
            mod.VideoShotWindowSource(path, 2, num_negative_samples=4,
                                      max_buffer_size=3)


# -- FLEXIBLE_DATA ---------------------------------------------------------------

@pytest.mark.parametrize("backend", ["lmdb", "leveldb"])
def test_flexible_source_matches_jax(tmp_path, backend):
    """The index_of seek into the frame store, one crop/mirror draw per
    item, frames stacked as channels, train and test transforms."""
    index, frames = write_flexible_stores(tmp_path, backend)
    for train, use_center in ((True, True), (False, False)):
        cfg = dict(source=index, flexible_source=frames,
                   flexible_key_suffix=".png", forward_len=1, backward_len=2,
                   use_center_datum=use_center, batch_size=3)
        tcfg = tgen.FlexibleDataConfig(**cfg)
        jcfg = jgen.FlexibleDataConfig(**cfg)
        tf = dict(crop_size=6, mirror=True, scale=0.5)
        mean = np.full((3, 10, 10), 100.0, np.float32)
        from videovector_tpu.data.transformer import TransformConfig as JTC
        _same_batches(
            tgen.FlexibleDataSource(tcfg, transform=TransformConfig(**tf),
                                    mean=mean, train=train, seed=4),
            jgen.FlexibleDataSource(jcfg, transform=JTC(**tf), mean=mean,
                                    train=train, seed=4), n=3)
    bad = tgen.FlexibleDataSource(tgen.FlexibleDataConfig(
        source=index, flexible_source=frames, flexible_key_suffix=".png",
        backward_len=3, batch_size=1),
        transform=TransformConfig(crop_size=4))
    with pytest.raises(ValueError, match="store bounds"):
        bad.next_batch()


# -- WINDOW_DATA ---------------------------------------------------------------------

def test_window_geometry_matches_jax(rng):
    for _ in range(300):
        w, h = rng.randint(20, 200, size=2)
        x1, y1 = rng.randint(0, w - 5), rng.randint(0, h - 5)
        box = (x1, y1, rng.randint(x1 + 1, w), rng.randint(y1 + 1, h))
        cs = int(rng.choice([32, 57, 227]))
        pad = int(rng.randint(0, cs // 2))
        kw = dict(use_square=bool(rng.randint(2)),
                  do_mirror=bool(rng.randint(2)))
        assert tgen.window_geometry(box, w, h, cs, pad, **kw) == \
            jgen.window_geometry(box, w, h, cs, pad, **kw)
    for mod in (tgen, jgen):
        with pytest.raises(ValueError, match="context_pad"):
            mod.window_geometry((0, 0, 9, 9), 20, 20, 16, 8)


@pytest.mark.parametrize("mode", ["warp", "square"])
def test_window_source_matches_jax(tmp_path, mode):
    """fg/bg sampling by fraction, the context-pad warp, mirrors, the mean
    at the padded offsets: JAX's batches bit for bit (cv2 decodes and
    resizes on both sides)."""
    src = write_window_images(tmp_path)
    cfg = dict(source=src, batch_size=6, fg_threshold=0.5, bg_threshold=0.3,
               fg_fraction=0.5, context_pad=4, crop_size=24, crop_mode=mode,
               mirror=True)
    mean = np.random.RandomState(1).uniform(0, 255, (3, 28, 28)) \
        .astype(np.float32)
    _same_batches(tgen.WindowDataSource(tgen.WindowDataConfig(**cfg),
                                        mean=mean, seed=9),
                  jgen.WindowDataSource(jgen.WindowDataConfig(**cfg),
                                        mean=mean, seed=9), n=3)


# -- HDF5_DATA --------------------------------------------------------------------------

def test_hdf5_source_reads_the_reference_generator_files(tmp_path):
    """sample_data.h5 then its gzip twin, cycled (ref
    test_hdf5data_layer.cpp TestRead): the arange data, the 1-based labels,
    bit for bit JAX's source's batches."""
    plain, gz = reference_sample_h5(tmp_path)
    lst = _list_file(tmp_path, [plain, gz])
    t, j = tgen.HDF5Source(lst, 5), jgen.HDF5Source(lst, 5)
    b1 = t.next_batch()
    _bits_equal(b1, j.next_batch())
    expect = np.arange(10 * 8 * 6 * 5, dtype=np.float32).reshape(10, 8, 6, 5)
    np.testing.assert_array_equal(b1["data"], expect[:5])
    np.testing.assert_array_equal(b1["label"].reshape(-1), [1, 2, 3, 4, 5])
    _same_batches(t, j, n=5)


@pytest.mark.parametrize("layout", [
    "contiguous", "chunked_gzip", "shuffle_gzip", "int_types",
    "big_endian", "scalar_and_odd_chunks"])
def test_hdf5_source_matches_jax_on_h5py_files(tmp_path, layout, rng):
    rows = 13
    data = {"data": rng.randn(rows, 3, 4).astype(np.float32),
            "label": rng.randint(0, 9, (rows, 1)).astype(np.float64)}
    kw: dict = {}
    if layout == "chunked_gzip":
        kw = dict(chunks=True, compression="gzip", compression_opts=6)
    elif layout == "shuffle_gzip":
        kw = dict(chunks=(4, 2, 3), compression="gzip", shuffle=True)
    elif layout == "int_types":
        data = {"data": rng.randint(-500, 500, (rows, 5)).astype(np.int16),
                "label": rng.randint(0, 200, rows).astype(np.uint8),
                "wide": rng.randint(-2**40, 2**40, (rows, 2)).astype(np.int64)}
    elif layout == "big_endian":
        data = {k: v.astype(v.dtype.newbyteorder(">")) for k, v in data.items()}
        kw = dict(chunks=(5, 3, 4), shuffle=True)
    elif layout == "scalar_and_odd_chunks":
        kw = dict(chunks=(3, 2, 3), compression="gzip")
    path = str(tmp_path / "f.h5")
    with h5py.File(path, "w") as f:
        for k, v in data.items():
            f.create_dataset(k, data=v, **(kw if v.ndim == 3 else {}))
    got = thdf5.read_hdf5(path)
    assert list(got) == sorted(data)
    for k, v in data.items():
        np.testing.assert_array_equal(got[k], v)
        assert got[k].dtype == v.dtype.newbyteorder("=")
    lst = _list_file(tmp_path, [path, path])
    _same_batches(tgen.HDF5Source(lst, 4), jgen.HDF5Source(lst, 4), n=8)


def test_hdf5_source_reads_the_ports_own_writer(tmp_path, rng):
    """The port's writer's files (superblock 2, compact links): JAX's
    source (h5py) and the port's read the same rows."""
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"w{i}.h5"))
        thdf5.write_hdf5(paths[-1], {
            "data": rng.randn(3 + i, 2, 5).astype(np.float32),
            "label": np.arange(3 + i, dtype=np.int32) + 10 * i})
    lst = _list_file(tmp_path, paths)
    _same_batches(tgen.HDF5Source(lst, 2), jgen.HDF5Source(lst, 2), n=6)


@pytest.mark.parametrize("case,what", [
    ("fletcher32", "filter 3"),
    ("latest_chunked", "layout version 4"),
    ("dense_links", "dense link storage"),
    ("nested_group", "not a dataset"),
    ("string", "datatype class 3"),
    ("not_hdf5", "not an HDF5 file")])
def test_hdf5_unsupported_structures_raise_naming_them(tmp_path, case, what):
    path = str(tmp_path / f"{case}.h5")
    x = np.arange(24, dtype=np.float32).reshape(6, 4)
    if case == "not_hdf5":
        (tmp_path / f"{case}.h5").write_bytes(b"\0" * 600)
    else:
        libver = "latest" if case in ("latest_chunked", "dense_links") \
            else None
        with h5py.File(path, "w", libver=libver) as f:
            if case == "fletcher32":
                f.create_dataset("x", data=x, fletcher32=True)
            elif case == "latest_chunked":
                f.create_dataset("x", data=x, chunks=(2, 2))
            elif case == "dense_links":
                for i in range(20):
                    f[f"d{i:02d}"] = x
            elif case == "nested_group":
                f.create_group("g")["x"] = x
            else:
                f["x"] = np.array([b"abc", b"de"], dtype="S3")
    with pytest.raises(ValueError, match=what):
        thdf5.read_hdf5(path)


# -- layer messages for tests/test_torch_data_factory.py ------------------------------------

def factory_layers(tmp) -> dict:
    """One layer message per source of the item, over fixtures in tmp:
    {case: prototxt text}."""
    index, frames = write_flexible_stores(tmp, "lmdb")
    windows = write_shot_windows(str(tmp / "shot_windows_leveldb"), "leveldb")
    ids = tmp / "ids.txt"
    ids.write_text("3 1 4 1 5 9 2 6\n")
    lst = _list_file(tmp, reference_sample_h5(tmp), "h5.txt")
    src = write_window_images(tmp)
    return {
        "VIDEO_SHOT_WINDOW_DATA": f'''layers {{ name: "d"
            type: VIDEO_SHOT_WINDOW_DATA top: "x" top: "vid"
            video_shot_window_data_param {{ source: "{windows}" batch_size: 4
              backend: LEVELDB num_negative_samples: 3 max_buffer_size: 9
              negative_swap_percentage: 40 }} }}''',
        "VIDEO_ID_TEXT": f'''layers {{ name: "d"
            type: VIDEO_SHOT_WINDOW_DATA top: "ids"
            video_shot_window_data_param {{ source: "{ids}" batch_size: 5
              backend: VIDEO_ID_TEXT }} }}''',
        "WINDOW_DATA": f'''layers {{ name: "d" type: WINDOW_DATA
            top: "img" top: "cls"
            window_data_param {{ source: "{src}" batch_size: 4
              fg_threshold: 0.5 bg_threshold: 0.3 fg_fraction: 0.25
              context_pad: 2 crop_mode: "square" }}
            transform_param {{ crop_size: 20 mirror: true }} }}''',
        "FLEXIBLE_DATA": f'''layers {{ name: "d" type: FLEXIBLE_DATA
            top: "stack" top: "label"
            data_param {{ source: "{index}" batch_size: 3 backend: LMDB }}
            flexible_data_param {{ flexible_source: "{frames}"
              flexible_key_suffix: ".png" forward_len: 1 backward_len: 1 }}
            transform_param {{ crop_size: 8 mirror: true }} }}''',
        "HDF5_DATA": f'''layers {{ name: "d" type: HDF5_DATA
            top: "data" top: "label"
            hdf5_data_param {{ source: "{lst}" batch_size: 4 }} }}''',
    }
