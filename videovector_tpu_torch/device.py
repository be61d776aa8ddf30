"""Where the port's entry points run: on the card unless the caller asks for
the CPU (as the CPU tests do), and never on the CPU in place of a missing
card."""

from __future__ import annotations

import torch

DEFAULT = "cuda"


def resolve(device) -> torch.device:
    """torch.device(device), raising if it names CUDA and there is no card.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} asked for, but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain versions on the CPU")
    return dev
