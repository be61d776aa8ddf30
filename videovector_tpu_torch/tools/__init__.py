"""Command-line tools: the `vvtpu-torch` CLI (tools/cli.py)."""
