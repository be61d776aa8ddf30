"""Numerics-parity harness; counterpart of videovector_tpu/tools/parity.py.

SURVEY section 7 step 3: diff layer activations between two runs - e.g. our graph
engine vs the reference's `dump_network` output, or the graph engine vs the
idiomatic fast-path models - and report per-blob max-abs/rel differences.

Accepts either the dump dirs of tools/dump.py (either package's: activations.npz + *.blob) or
directories of raw BlobProto files (what the reference's dump_network writes,
ref:tools/dump_network.cpp:27-77 - readable via data/wire.BlobProto).

Usage:
  python -m videovector_tpu_torch.tools.parity dumpA dumpB [--rtol 1e-4] [--atol 1e-5]
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

from videovector_tpu_torch.data.wire import BlobProto


def load_dump(path: str) -> dict:
    """Load a dump directory (activations.npz preferred, else *.blob files)
    or a single .npz file."""
    if os.path.isfile(path) and path.endswith(".npz"):
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    npz = os.path.join(path, "activations.npz")
    if os.path.exists(npz):
        with np.load(npz) as z:
            return {k: z[k] for k in z.files}
    out = {}
    for blob_path in glob.glob(os.path.join(path, "*.blob")):
        name = os.path.splitext(os.path.basename(blob_path))[0]
        with open(blob_path, "rb") as f:
            out[name] = BlobProto.decode(f.read()).to_array()
    if not out:
        raise FileNotFoundError(f"no dump found at {path}")
    return out


def compare(a: dict, b: dict, *, rtol: float = 1e-4, atol: float = 1e-5):
    """Returns (report rows, ok). A row per common blob:
    (name, shape_a, shape_b, max_abs_diff, max_rel_diff, pass)."""
    rows = []
    ok = True
    for name in sorted(set(a) & set(b)):
        x, y = np.asarray(a[name], np.float64), np.asarray(b[name], np.float64)
        if x.size != y.size:
            rows.append((name, x.shape, y.shape, np.inf, np.inf, False))
            ok = False
            continue
        y = y.reshape(x.shape)
        diff = np.abs(x - y)
        max_abs = float(diff.max()) if diff.size else 0.0
        denom = np.maximum(np.abs(y), 1e-12)
        max_rel = float((diff / denom).max()) if diff.size else 0.0
        passed = bool(np.allclose(x, y, rtol=rtol, atol=atol))
        ok &= passed
        rows.append((name, x.shape, y.shape, max_abs, max_rel, passed))
    missing = sorted(set(a) ^ set(b))
    # blobs in only one dump are a FAILURE, not a footnote: disjoint dumps
    # (e.g. mismatched blob naming) used to compare nothing and PASS
    if missing or not rows:
        ok = False
    return rows, ok, missing


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="vvtpu-torch-parity")
    parser.add_argument("dump_a")
    parser.add_argument("dump_b")
    parser.add_argument("--rtol", type=float, default=1e-4)
    parser.add_argument("--atol", type=float, default=1e-5)
    args = parser.parse_args(argv)
    rows, ok, missing = compare(load_dump(args.dump_a), load_dump(args.dump_b),
                                rtol=args.rtol, atol=args.atol)
    for name, sa, sb, mabs, mrel, passed in rows:
        flag = "OK " if passed else "FAIL"
        print(f"{flag} {name:30s} {str(sa):>20s} max_abs={mabs:.3e} "
              f"max_rel={mrel:.3e}")
    for name in missing:
        print(f"MISS {name} (present in only one dump)")
    print("PARITY:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
