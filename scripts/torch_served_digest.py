#!/usr/bin/env python3
"""Digests of what the frame and clip backbones serve on one CUDA card, to
show that two trees of the port serve the same bits:

    python3 scripts/torch_served_digest.py [--root DIR]

For CaffeNet (50 frames), GoogLeNet (50 frames) and I3D (one 64-frame
clip) at their published widths, with seeded weights, frames and a
seeded 20,000-row gallery: one query eager, then captured and replayed,
then replayed, each printed as the SHA-256 of its top-5 ids, its scores
and the features the pipeline kept. `--root` (default: this checkout)
names the tree whose `videovector_tpu_torch` is imported, so that two
trees run by one command give two lists to compare line by line. Exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import torch

CASES = (("caffenet", 227, 4096, 50, 50),      # backbone, crop, dim, frames,
         ("googlenet", 224, 1024, 50, 50),     # offsets a query
         ("i3d", 224, 1024, 64, 1))


def _digest(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(torch.uint8).numpy()
                 .tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_served_digest: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, args.root)
    from videovector_tpu_torch.models.retrieval_pipeline import (
        RetrievalPipeline, RetrievalPipelineConfig,
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    for backbone, crop, dim, frames, offsets in CASES:
        gen = torch.Generator(device=dev).manual_seed(31)
        pipe = RetrievalPipeline(RetrievalPipelineConfig(
            backbone=backbone, crop=crop, embed_dim=dim), device=dev)
        params = pipe.init(gen)
        gallery = torch.nn.functional.normalize(
            torch.randn((20_000, dim), generator=gen, device=dev), dim=1)
        ids = torch.randperm(20_000, generator=gen, device=dev).to(
            torch.int32)
        pix = torch.randint(0, 256, (frames, 256, 256, 3), generator=gen,
                            device=dev, dtype=torch.uint8)
        h, w = (torch.randint(0, 256 - crop + 1, (offsets,), generator=gen,
                              device=dev) for _ in range(2))
        mirror = torch.randint(0, 2, (offsets,), generator=gen,
                               device=dev) > 0
        for call in ("eager", "captured", "replayed"):
            top_ids, scores = pipe.query(params, pix, h, w, mirror, gallery,
                                         ids)
            torch.cuda.synchronize()
            print(json.dumps({"backbone": backbone, "call": call,
                              "ids": _digest(top_ids),
                              "scores": _digest(scores),
                              "features": _digest(pipe.features)}),
                  flush=True)
        del pipe, params, gallery
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
