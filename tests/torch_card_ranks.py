"""The rank side of tests/test_torch_cuda_kernels.py's tests that need two
cards: one process a card, started by python -m torch.distributed.run. It
imports no JAX.

  export BACKEND OUT ARTIFACT NET WEIGHTS BLOB MESH
      export_serving(mesh=) of a MESH ("DxM") over a BACKEND ("nccl" or
      "gloo") group
  serve BACKEND OUT BATCH ARTIFACT... [--swap]
      each artifact through load_serving and mesh_serving on BATCH (.npz)
      over a BACKEND group; --swap puts each rank on the next rank's card

Each rank writes OUT.<rank>.pkl: its backend and card, and the export's
meta or, per artifact served, its outputs and the K1 and K2 launches of the
call, or the ValueError it raised.
"""

from __future__ import annotations

import os
import pickle
import sys

import numpy as np
import torch
import torch.distributed as dist


def _group(backend: str, swap: bool) -> int:
    rank = int(os.environ["RANK"])
    card = int(os.environ["LOCAL_RANK"])
    if swap:
        # make_mesh would put the rank back on card LOCAL_RANK
        del os.environ["LOCAL_RANK"]
        card = (card + 1) % int(os.environ["LOCAL_WORLD_SIZE"])
    torch.cuda.set_device(card)
    torch.zeros(1, device="cuda")
    dist.init_process_group(backend, init_method="env://")
    return rank


def _export(artifact, net, weights, blob, mesh) -> dict:
    from videovector_tpu_torch.parallel import make_mesh
    from videovector_tpu_torch.tools import serving
    data, model = (int(d) for d in mesh.split("x"))
    meta = serving.export_serving(net, [weights], [blob], artifact,
                                  mesh=make_mesh(data, model))
    return {"meta": meta}


def _serve(batch, *artifacts) -> dict:
    from videovector_tpu_torch.tools import serving
    from videovector_tpu_torch.utils import timer
    with np.load(batch) as z:
        feed = {k: z[k] for k in z.files}
    res = {}
    for art in artifacts:
        try:
            call, meta = serving.load_serving(art)
            run = serving.mesh_serving(call, meta)
            with timer.tally() as counts:
                got = run(feed)
            torch.cuda.synchronize()
            res[art] = {"outs": {k: v.cpu().numpy() for k, v in got.items()},
                        "launches": (counts.get("vvtpu.k1.launches", 0),
                                     counts.get("vvtpu.k2.launches", 0))}
        except ValueError as e:
            res[art] = {"error": str(e)}
    return res


def main(argv) -> int:
    swap = "--swap" in argv
    cmd, backend, out, *args = [a for a in argv if a != "--swap"]
    from videovector_tpu_torch import _build
    _build.load_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = _group(backend, swap)
    try:
        res = {"export": _export, "serve": _serve}[cmd](*args)
        res["backend"] = dist.get_backend()
        res["device"] = str(torch.device("cuda", torch.cuda.current_device()))
        dist.barrier()
    finally:
        dist.destroy_process_group()
    with open(f"{out}.{rank}.pkl", "wb") as f:
        pickle.dump(res, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
