"""upgrade_net_proto: V0 -> V1 net-proto migration CLI, text and binary;
counterpart of videovector_tpu/tools/upgrade_net_proto.py.

ref:tools/upgrade_net_proto_text.cpp / upgrade_net_proto_binary.cpp. Reads a
legacy V0 net proto (nested `layer { ... }` connections, string types,
padding layers) - text prototxt or binary NetParameter (sniffed by content)
- and writes the V1 form. Output format follows the extension: .prototxt /
.txt -> text, anything else -> binary NetParameter (config/binproto.py).

Usage: python -m videovector_tpu_torch.tools.upgrade_net_proto in out
"""

from __future__ import annotations

import argparse
import sys

from videovector_tpu_torch.config.textformat import parse
from videovector_tpu_torch.config.upgrade import net_needs_upgrade, upgrade_net


def _read_net(path: str):
    with open(path, "rb") as f:
        raw = f.read()
    try:
        text = raw.decode("utf-8")
        if "{" in text or ":" in text:
            return parse(text)
    except UnicodeDecodeError:
        pass
    from videovector_tpu_torch.config import binproto
    return binproto.decode(raw, "NetParameter")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="vvtpu-torch-upgrade-net-proto")
    parser.add_argument("input")
    parser.add_argument("output")
    args = parser.parse_args(argv)
    msg = _read_net(args.input)
    if not net_needs_upgrade(msg):
        print("File already in V1 format; copying through.")
        out = msg
    else:
        out = upgrade_net(msg)
    if args.output.endswith((".prototxt", ".txt")):
        from videovector_tpu_torch.config import binproto
        with open(args.output, "w") as f:
            # schema-aware printer: strict TextFormat (quoted strings)
            f.write(binproto.to_text(out, "NetParameter") + "\n")
    else:
        from videovector_tpu_torch.config import binproto
        binproto.write_binary(args.output, out, "NetParameter")
    print(f"Wrote upgraded NetParameter to {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
