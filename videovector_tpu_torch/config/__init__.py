from videovector_tpu_torch.config.textformat import Message, parse, parse_file  # noqa: F401
