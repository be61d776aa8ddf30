"""Where the port's entry points run: on the card unless the caller asks for
the CPU (as the CPU tests do), and never on the CPU in place of a missing
card; and whether a kernel's entry point launches it or runs its plain
PyTorch version."""

from __future__ import annotations

import contextlib

import torch

DEFAULT = "cuda"

# set by `plain_versions`; process-wide, so that a checkpointed recompute
# on autograd's thread chooses as the forward did
_PLAIN = False


def resolve(device) -> torch.device:
    """torch.device(device), raising if it names CUDA and there is no card.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} asked for, but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain versions on the CPU")
    return dev


def runs_kernel(t: torch.Tensor) -> bool:
    """Whether a kernel's entry point launches the kernel for operand `t`:
    for a CUDA tensor outside `plain_versions()`; not for one inside it, or
    a CPU or "meta" tensor (the plain version). Other devices raise."""
    kind = t.device.type
    if kind == "cuda":
        return not _PLAIN
    if kind in ("cpu", "meta"):
        return False
    raise ValueError(f"the kernels run on CUDA tensors, and their plain "
                     f"versions on CPU or meta tensors, not on {t.device}")


@contextlib.contextmanager
def plain_versions():
    """Every kernel's entry point runs its plain version on CUDA tensors too
    inside the block (to compare the two on one card), in every thread."""
    global _PLAIN
    prev = _PLAIN
    _PLAIN = True
    try:
        yield
    finally:
        _PLAIN = prev
