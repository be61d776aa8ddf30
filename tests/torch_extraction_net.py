"""The extraction net of projects/videovec_embedding/generate_extraction_net.py
at test sizes, for the port's tests on the CPU and on the card (imports
neither JAX nor the JAX package)."""

import importlib.util
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
# CaffeNet's channel counts -> narrow ones; at a 99 crop the geometry gives
# conv1 23x23, pool1 11, conv2 11, pool2 5, conv3..5 5, pool5 2
NARROW = {"96": "8", "256": "16", "384": "24", "4096": "32"}
CROP, BATCH = 99, 2


def extraction_net(source="list.txt", mean_file="mean.blob", *, batch=BATCH,
                   crop=CROP, new_dim=112, widths=NARROW):
    """generate_extraction_net.emit's prototxt with `widths` substituted
    for CaffeNet's channel counts."""
    spec = importlib.util.spec_from_file_location(
        "generate_extraction_net",
        ROOT / "projects/videovec_embedding/generate_extraction_net.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    txt = mod.emit(source, mean_file, batch=batch, crop_size=crop,
                   new_dim=new_dim)
    for wide, narrow in widths.items():
        txt = txt.replace(f"num_output: {wide}\n", f"num_output: {narrow}\n")
        txt = txt.replace(f"num_output: {wide} ", f"num_output: {narrow} ")
    return txt


def data_layer_net(store: str, mean_file: str, batch: int = BATCH,
                   **kw) -> str:
    """The extraction prototxt with its IMAGE_DATA layer swapped for a DATA
    layer over `store`, keeping the transform_param."""
    txt = extraction_net(mean_file=mean_file, batch=batch, **kw)
    head, rest = txt.split("  image_data_param {\n", 1)
    _, rest = rest.split("  }\n", 1)
    head = head.replace("type: IMAGE_DATA", "type: DATA")
    return (head + f'  data_param {{\n    source: "{store}"\n'
            f"    batch_size: {batch}\n  }}\n" + rest)
