"""Command-line tools: the `vvtpu-torch` CLI (tools/cli.py), feature
extraction, the serving export (tools/serving.py), int8 quantization, the
dumps and the parity harness, the dataset converters and the log and proto
utilities."""
