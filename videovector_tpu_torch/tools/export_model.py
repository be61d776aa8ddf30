"""Model export for serving: `torch.export` programs; counterpart of
videovector_tpu/tools/export_model.py (which writes StableHLO through
jax.export).

  save_exported(path, fn, *example_args)  trace, export, serialize
  load_exported(path)                      deserialize; returns the
                                           ExportedProgram (`.module()` runs it)

The program holds K1 and K2 as the custom ops `vvtpu::k1_matmul` and
`vvtpu::k2_conv2d_nhwc` (ops/hopper/), so exporting on CUDA tensors traces
them without launching, and running the loaded program launches them.
`load_exported` imports their registrations first. The batch axis can be
made symbolic by the caller through `dynamic_shapes` (torch.export.Dim).
"""

from __future__ import annotations

import torch


class _Fn(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def register_ops() -> None:
    """Import the modules that register the port's custom ops, so that a
    program holding them deserializes."""
    import videovector_tpu_torch.ops.hopper.conv_gemm  # noqa: F401
    import videovector_tpu_torch.ops.hopper.matmul  # noqa: F401


def export(fn, example_args: tuple, *, dynamic_shapes=None):
    """torch.export.export of `fn` (a Module, or a function wrapped in one)
    at `example_args`, non-strict (traced by running the Python code on
    fake tensors)."""
    mod = fn if isinstance(fn, torch.nn.Module) else _Fn(fn)
    return torch.export.export(mod, tuple(example_args),
                               dynamic_shapes=dynamic_shapes, strict=False)


def save(program, path) -> None:
    """torch.export.save of `program` without its example inputs (a
    program keeps them, and they would ride in every artifact)."""
    program.example_inputs = None
    torch.export.save(program, path)


def save_exported(path, fn, *example_args, dynamic_shapes=None) -> None:
    """Trace fn on example_args and serialize the program to `path` (a path
    or a binary file object)."""
    save(export(fn, example_args, dynamic_shapes=dynamic_shapes), path)


def load_exported(path):
    """The deserialized ExportedProgram; `.module()(*args)` runs it."""
    register_ops()
    return torch.export.load(path)
