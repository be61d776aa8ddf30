"""Dataset converters, the reference's tools/convert_*.cpp family;
counterpart of videovector_tpu/tools/converters.py.

  convert_imageset               ref:tools/convert_imageset.cpp
  convert_flexible_imageset      ref:tools/convert_flexible_imageset.cpp
  convert_flexible_imageset_scaled  ref:...:162-183 (per-channel range files
                                 stored into Datum.mean/min/max for
                                 use_datum_scales)
  convert_flexible_list          ref:tools/convert_flexible_list.cpp
  compute_image_mean             ref:tools/compute_image_mean.cpp:17-60
  write_mean_to_binary_proto     ref:tools/write_mean_to_binary_proto.cpp:14-30

All write VVR record stores (values = Datum wire protos); `import_*` /
`export_*` copy LMDB and LevelDB stores to and from VVR through the port's
data/lmdbio.py and data/leveldbio.py. Keys follow the reference conventions
(zero-padded running id + filename for the flexi variants so
FlexibleDataSource's seek works). Images load in the port's decoder order
(data/generic.py::_decode_bgr: the native libjpeg decoder for a .jpg, then
cv2 as the reference, then PIL), so a resized image takes cv::resize's
INTER_LINEAR where cv2 is there; the JAX package's converters take PIL's
bilinear resize.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from videovector_tpu_torch.data.generic import _decode_bgr
from videovector_tpu_torch.data.records import RecordWriter, open_store
from videovector_tpu_torch.data.wire import BlobProto, Datum
from videovector_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)


def _load_image(path: str, resize_h: int = 0, resize_w: int = 0) -> np.ndarray:
    """(3, H, W) uint8 BGR, resized to (resize_h, resize_w) when both are
    set."""
    hwc = _decode_bgr(path, resize_w if resize_h and resize_w else 0,
                      resize_h if resize_h and resize_w else 0)
    return np.ascontiguousarray(np.asarray(hwc, np.uint8).transpose(2, 0, 1))


def _image_datum(path: str, label: int, resize_h: int, resize_w: int) -> Datum:
    arr = _load_image(path, resize_h, resize_w)
    return Datum(channels=arr.shape[0], height=arr.shape[1],
                 width=arr.shape[2], data=arr.tobytes(), label=label)


def read_list(list_file: str) -> list[tuple[str, int]]:
    items = []
    with open(list_file) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.rsplit(None, 1)
            if len(parts) == 2 and parts[1].lstrip("-").isdigit():
                items.append((parts[0], int(parts[1])))
            else:
                items.append((line, 0))
    return items


def convert_imageset(root: str, list_file: str, out: str, *,
                     resize_h: int = 0, resize_w: int = 0,
                     shuffle: bool = False, seed: int = 1234) -> int:
    items = read_list(list_file)
    if shuffle:
        np.random.RandomState(seed).shuffle(items)
    with RecordWriter(out) as w:
        for i, (path, label) in enumerate(items):
            datum = _image_datum(os.path.join(root, path), label,
                                 resize_h, resize_w)
            # key = running id + the list file's path AS WRITTEN
            # (ref convert_imageset.cpp:143-144 uses lines[i].first whole,
            # nested directories included - basename would mismatch
            # reference-built stores on any nested entry)
            w.append(f"{i:08d}_{path}", datum.encode())
            if (i + 1) % 1000 == 0:
                log.info("Processed %d files.", i + 1)
    return len(items)


def convert_flexible_imageset(root: str, list_file: str, out: str, *,
                              resize_h: int = 0, resize_w: int = 0,
                              range_files: str | None = None) -> int:
    """Keys preserve the filename so FlexibleDataSource can seek; with
    `range_files` (scaled variant) per-channel mean/min/max are read from
    `<image>.range` csv lines `mean,min,max` and stored into the Datum."""
    items = read_list(list_file)
    with RecordWriter(out) as w:
        for i, (path, label) in enumerate(items):
            datum = _image_datum(os.path.join(root, path), label,
                                 resize_h, resize_w)
            if range_files:
                rp = os.path.join(range_files, os.path.basename(path) + ".range")
                means, mins, maxs = [], [], []
                with open(rp) as f:
                    for line in f:
                        m, lo, hi = (float(v) for v in line.strip().split(","))
                        means.append(m)
                        mins.append(lo)
                        maxs.append(hi)
                datum.mean = np.asarray(means, np.float32)
                datum.min = np.asarray(mins, np.float32)
                datum.max = np.asarray(maxs, np.float32)
            w.append(path, datum.encode())
    return len(items)


def convert_flexible_list(list_file: str, out: str) -> int:
    """Index store for FLEXIBLE_DATA: key = "%08d_" + the frame path MINUS
    its 4-char extension, value = the 4-digit label - byte-for-byte the
    reference's format (ref:tools/convert_flexible_list.cpp:125-140:
    file_name.substr(0, size-4); the layer re-appends flexible_key_suffix
    to the stripped base when seeking the frame store,
    flexible_data_layer.cpp:230-235). No images are read: the reference
    tool stores only keys and labels."""
    items = read_list(list_file)
    with RecordWriter(out) as w:
        for i, (path, label) in enumerate(items):
            key = f"{i:08d}_{path[:-4]}"
            w.append(key, f"{label:04d}".encode())
    return len(items)


def compute_image_mean(records_path: str, out: str) -> np.ndarray:
    """Stream Datum records, accumulate the mean image, write a BlobProto
    (ref compute_image_mean.cpp:17-60)."""
    from videovector_tpu_torch.data.transformer import datum_to_array
    reader = open_store(records_path)
    acc = None
    n = 0
    for _, value in reader:
        arr = datum_to_array(Datum.decode(bytes(value))).astype(np.float64)
        acc = arr if acc is None else acc + arr
        n += 1
    reader.close()
    mean = (acc / n).astype(np.float32)
    blob = BlobProto.from_array(mean[None])
    with open(out, "wb") as f:
        f.write(blob.encode())
    return mean


def write_mean_to_binary_proto(out: str, bgr: tuple[float, float, float],
                               height: int, width: int) -> None:
    """Constant per-channel mean -> BlobProto
    (ref write_mean_to_binary_proto.cpp:14-30)."""
    mean = np.zeros((1, 3, height, width), np.float32)
    for c, v in enumerate(bgr):
        mean[0, c] = v
    with open(out, "wb") as f:
        f.write(BlobProto.from_array(mean[0][None]).encode())


def import_lmdb(db_path: str, out: str) -> int:
    """Copy a reference LMDB environment into a VVR store (cursor order ==
    key order, matching MDB_FIRST/MDB_NEXT iteration,
    ref:src/caffe/layers/video_sampled_shots_data_layer.cpp:134-135).
    The converted file also unlocks the native C++ prefetch reader, which
    speaks VVR only. Returns the entry count."""
    from videovector_tpu_torch.data.lmdbio import LmdbReader
    reader = LmdbReader(db_path)
    with RecordWriter(out) as w:
        for key, value in reader:
            w.append(key, bytes(value))
    n = len(reader)
    reader.close()
    return n


def export_lmdb(records_path: str, db_path: str) -> int:
    """Write a VVR store out as an LMDB environment the reference binaries
    can open (liblmdb data format v1). Returns the entry count."""
    from videovector_tpu_torch.data.lmdbio import LmdbWriter
    reader = open_store(records_path)
    with LmdbWriter(db_path) as w:
        for key, value in reader:
            w.put(key, bytes(value))
    return len(reader)


def resize_and_crop_images(input_folder: str, output_folder: str, *,
                           side: int = 256) -> int:
    """Shorter-side resize to `side`, center-crop to sidexside - the
    reference's dataset-prep utility (ref:tools/extra/
    resize_and_crop_images.py:20-36 OpenCVResizeCrop), minus the mincepie
    map-reduce harness. Mirrors the input tree. Returns the image count."""
    from PIL import Image
    count = 0
    for root, _dirs, files in os.walk(input_folder):
        rel = os.path.relpath(root, input_folder)
        for fname in files:
            if not fname.lower().endswith(
                    (".jpg", ".jpeg", ".png", ".bmp")):
                continue
            img = Image.open(os.path.join(root, fname)).convert("RGB")
            w, h = img.size
            if h > w:
                new_w, new_h = side, round(side * h / w)
            else:
                new_w, new_h = round(side * w / h), side
            img = img.resize((new_w, new_h), Image.BILINEAR)
            left = (new_w - side) // 2
            top = (new_h - side) // 2
            img = img.crop((left, top, left + side, top + side))
            out_dir = os.path.join(output_folder, rel)
            os.makedirs(out_dir, exist_ok=True)
            img.save(os.path.join(out_dir, fname))
            count += 1
    return count


def import_leveldb(db_path: str, out: str) -> int:
    """Copy a reference LevelDB directory into a VVR store (iteration order
    == key order, matching SeekToFirst/Next cursor walks,
    ref:src/caffe/layers/data_layer.cpp:50-66). Returns the entry count."""
    from videovector_tpu_torch.data.leveldbio import LevelDbReader
    reader = LevelDbReader(db_path)
    with RecordWriter(out) as w:
        for key, value in reader:
            w.append(key, bytes(value))
    n = len(reader)
    reader.close()
    return n


def export_leveldb(records_path: str, db_path: str) -> int:
    """Write a store out as a LevelDB directory the reference binaries can
    open (compacted level-0 tables + MANIFEST). Returns the entry count."""
    from videovector_tpu_torch.data.leveldbio import LevelDbWriter
    reader = open_store(records_path)
    with LevelDbWriter(db_path) as w:
        for key, value in reader:
            w.put(key, bytes(value))
    return len(reader)


def export_net(net_prototxt: str, model: str, out: str) -> None:
    """Write a FULL binary NetParameter (layer configs + blobs [+ diffs if
    the .vvmodel carries snapshot_diff payload]) - Net::ToProto parity
    (ref:src/caffe/net.cpp:774-801): the reference can rebuild the net with
    its architecture from this single file."""
    from videovector_tpu_torch.config.textformat import parse_file
    from videovector_tpu_torch.data.netproto import save_net
    from videovector_tpu_torch.solver.checkpoint import load_diffs, load_model
    msg = parse_file(net_prototxt)
    params = load_model(model)
    diffs = load_diffs(model) if model.endswith(".vvmodel") else None
    save_net(out, msg, params, diffs=diffs)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="vvtpu-torch-convert")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("imageset")
    p.add_argument("root")
    p.add_argument("list_file")
    p.add_argument("out")
    p.add_argument("--resize_height", type=int, default=0)
    p.add_argument("--resize_width", type=int, default=0)
    p.add_argument("--shuffle", action="store_true")

    p = sub.add_parser("flexible_imageset")
    p.add_argument("root")
    p.add_argument("list_file")
    p.add_argument("out")
    p.add_argument("--resize_height", type=int, default=0)
    p.add_argument("--resize_width", type=int, default=0)
    p.add_argument("--range_files", default=None)

    p = sub.add_parser("flexible_list")
    p.add_argument("list_file")
    p.add_argument("out")

    p = sub.add_parser("compute_image_mean")
    p.add_argument("records")
    p.add_argument("out")

    p = sub.add_parser("write_mean")
    p.add_argument("out")
    p.add_argument("--bgr", default="104,117,123")
    p.add_argument("--height", type=int, required=True)
    p.add_argument("--width", type=int, required=True)

    p = sub.add_parser("import_lmdb")
    p.add_argument("db")
    p.add_argument("out")

    p = sub.add_parser("export_lmdb")
    p.add_argument("records")
    p.add_argument("db")

    p = sub.add_parser("resize_images")
    p.add_argument("input_folder")
    p.add_argument("output_folder")
    p.add_argument("--side", type=int, default=256)

    p = sub.add_parser("import_leveldb")
    p.add_argument("db")
    p.add_argument("out")

    p = sub.add_parser("export_leveldb")
    p.add_argument("records")
    p.add_argument("db")

    p = sub.add_parser("export_net")
    p.add_argument("net_prototxt")
    p.add_argument("model")
    p.add_argument("out")

    args = parser.parse_args(argv)
    if args.command == "imageset":
        convert_imageset(args.root, args.list_file, args.out,
                         resize_h=args.resize_height,
                         resize_w=args.resize_width, shuffle=args.shuffle)
    elif args.command == "flexible_imageset":
        convert_flexible_imageset(args.root, args.list_file, args.out,
                                  resize_h=args.resize_height,
                                  resize_w=args.resize_width,
                                  range_files=args.range_files)
    elif args.command == "flexible_list":
        convert_flexible_list(args.list_file, args.out)
    elif args.command == "compute_image_mean":
        compute_image_mean(args.records, args.out)
    elif args.command == "write_mean":
        bgr = tuple(float(v) for v in args.bgr.split(","))
        write_mean_to_binary_proto(args.out, bgr, args.height, args.width)
    elif args.command == "import_lmdb":
        n = import_lmdb(args.db, args.out)
        print(f"imported {n} entries from {args.db} -> {args.out}")
    elif args.command == "export_lmdb":
        n = export_lmdb(args.records, args.db)
        print(f"exported {n} entries from {args.records} -> {args.db}")
    elif args.command == "resize_images":
        n = resize_and_crop_images(args.input_folder, args.output_folder,
                                   side=args.side)
        print(f"resized {n} images -> {args.output_folder}")
    elif args.command == "import_leveldb":
        n = import_leveldb(args.db, args.out)
        print(f"imported {n} entries from {args.db} -> {args.out}")
    elif args.command == "export_leveldb":
        n = export_leveldb(args.records, args.db)
        print(f"exported {n} entries from {args.records} -> {args.db}")
    elif args.command == "export_net":
        export_net(args.net_prototxt, args.model, args.out)
        print(f"wrote full NetParameter to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
