"""The prototxt graph engine: the layer registry, the Net and the data-source
factory."""

from videovector_tpu_torch.graph.net import Net, filter_layers  # noqa: F401
