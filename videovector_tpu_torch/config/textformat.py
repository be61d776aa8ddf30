"""Schema-free protobuf text-format parser and printer; counterpart of
videovector_tpu/config/textformat.py, a copy of it (the port imports nothing
of the JAX package).

The reference's whole config surface is proto2 text files (solver and net
prototxts). This module parses protobuf text format into a lightweight
`Message` tree, with no compiled schema:

- every field maps to a *list* of values (proto repeated semantics; singular
  fields just have one entry),
- scalar values are auto-typed: quoted strings stay str, `true/false` -> bool,
  numeric literals -> int/float, bare identifiers (enum values) -> str,
- nested messages (`field { ... }` and the legacy `field: { ... }` form used by
  the reference prototxts, e.g. `include: { phase: TRAIN }`) -> `Message`.

Typed access with Caffe's defaults happens at the consumer
(`solver/solvers.py`, `data/shots.py`), keeping this parser generic.
"""

from __future__ import annotations

import re
from typing import Any, Iterator


class Message:
    """An ordered multimap of field name -> list of values."""

    __slots__ = ("fields",)

    def __init__(self) -> None:
        self.fields: dict[str, list[Any]] = {}

    # -- mutation ---------------------------------------------------------
    def add(self, key: str, value: Any) -> None:
        self.fields.setdefault(key, []).append(value)

    # -- access -----------------------------------------------------------
    def get(self, key: str, default: Any = None) -> Any:
        """Last value of a singular field (proto2 keeps the last occurrence)."""
        vals = self.fields.get(key)
        return vals[-1] if vals else default

    def get_list(self, key: str) -> list[Any]:
        return self.fields.get(key, [])

    def get_msg(self, key: str) -> "Message":
        """Singular sub-message; empty Message if absent (proto semantics:
        an absent message behaves as all-defaults)."""
        val = self.get(key)
        return val if isinstance(val, Message) else Message()

    def has(self, key: str) -> bool:
        return key in self.fields

    def __contains__(self, key: str) -> bool:
        return key in self.fields

    def __iter__(self) -> Iterator[str]:
        return iter(self.fields)

    def __repr__(self) -> str:
        return f"Message({self.fields!r})"

    def to_dict(self) -> dict:
        out: dict[str, Any] = {}
        for k, vals in self.fields.items():
            conv = [v.to_dict() if isinstance(v, Message) else v for v in vals]
            out[k] = conv[0] if len(conv) == 1 else conv
        return out

    # -- printing (round-trip) -------------------------------------------
    def dumps(self, indent: int = 0) -> str:
        pad = "  " * indent
        lines = []
        for key, vals in self.fields.items():
            for v in vals:
                if isinstance(v, Message):
                    lines.append(f"{pad}{key} {{")
                    lines.append(v.dumps(indent + 1))
                    lines.append(f"{pad}}}")
                elif isinstance(v, bool):
                    lines.append(f"{pad}{key}: {'true' if v else 'false'}")
                elif isinstance(v, str):
                    if (_BARE_RE.fullmatch(v) and not _looks_numeric(v)
                            and v not in _KEYWORD_STRINGS):
                        lines.append(f"{pad}{key}: {v}")  # enum
                    else:
                        # _KEYWORD_STRINGS would re-parse as bool/float if
                        # printed bare — quote to keep the round-trip typed
                        lines.append(f'{pad}{key}: "{_escape(v)}"')
                else:
                    lines.append(f"{pad}{key}: {v!r}")
        return "\n".join(l for l in lines if l != "")


_BARE_RE = re.compile(r"[A-Za-z_][A-Za-z0-9_]*")
_KEYWORD_STRINGS = frozenset(("true", "false", "inf", "nan"))
_NUM_RE = re.compile(r"[-+]?(\d+\.?\d*([eE][-+]?\d+)?|\.\d+([eE][-+]?\d+)?|0x[0-9a-fA-F]+)")


def _looks_numeric(s: str) -> bool:
    return bool(re.fullmatch(r"[-+0-9.].*", s))


def _escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>\#[^\n]*|//[^\n]*)
  | (?P<string>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<punct>[{}:;,])
  | (?P<number>[-+]?(?:0[xX][0-9a-fA-F]+|\d+\.\d*(?:[eE][-+]?\d+)?|\.\d+(?:[eE][-+]?\d+)?|\d+(?:[eE][-+]?\d+)?))
  | (?P<ident>[A-Za-z_][A-Za-z0-9_.]*)
    """,
    re.VERBOSE,
)


def _tokenize(text: str) -> list[tuple[str, str]]:
    tokens = []
    pos = 0
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise ValueError(f"textformat: bad token at offset {pos}: {text[pos:pos+40]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        tokens.append((kind, m.group()))
    return tokens


_ESC_CHARS = {"n": 0x0A, "t": 0x09, "r": 0x0D, "a": 0x07, "b": 0x08,
              "f": 0x0C, "v": 0x0B, "\\": 0x5C, "'": 0x27, '"': 0x22,
              "?": 0x3F}


def _unquote(tok: str) -> str:
    """Protobuf text-format string unescape. Escapes denote BYTES (the
    reference's TextFormat prints UTF-8 as octal byte escapes), so build a
    byte string and decode UTF-8 at the end — the old
    bytes(s, "utf-8").decode("unicode_escape") applied latin-1 semantics
    and mojibake'd every non-ASCII path/name."""
    body = tok[1:-1]
    out = bytearray()
    i = 0
    n = len(body)
    while i < n:
        c = body[i]
        if c != "\\":
            out += c.encode("utf-8")
            i += 1
            continue
        i += 1
        if i >= n:
            raise ValueError("textformat: dangling backslash in string")
        c = body[i]
        if c in _ESC_CHARS:
            out.append(_ESC_CHARS[c])
            i += 1
        elif c in "01234567":          # octal, up to 3 digits
            j = i + 1
            while j < min(i + 3, n) and body[j] in "01234567":
                j += 1
            out.append(int(body[i:j], 8) & 0xFF)
            i = j
        elif c in "xX":                # hex, up to 2 digits
            j = i + 1
            while j < min(i + 3, n) and body[j] in "0123456789abcdefABCDEF":
                j += 1
            if j == i + 1:
                raise ValueError("textformat: \\x with no hex digits")
            out.append(int(body[i + 1:j], 16))
            i = j
        else:
            raise ValueError(f"textformat: unknown escape \\{c}")
    return out.decode("utf-8", errors="surrogateescape")


class _Parser:
    def __init__(self, tokens: list[tuple[str, str]]):
        self.tokens = tokens
        self.i = 0

    def peek(self) -> tuple[str, str] | None:
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def next(self) -> tuple[str, str]:
        tok = self.peek()
        if tok is None:
            raise ValueError("textformat: unexpected end of input")
        self.i += 1
        return tok

    def parse_message(self, top_level: bool = False) -> Message:
        msg = Message()
        while True:
            tok = self.peek()
            if tok is None:
                if top_level:
                    return msg
                raise ValueError("textformat: unexpected EOF inside message")
            if tok[1] == "}":
                if top_level:
                    raise ValueError("textformat: unmatched '}'")
                self.next()
                return msg
            self.parse_field(msg)

    def parse_field(self, msg: Message) -> None:
        kind, name = self.next()
        if kind != "ident":
            raise ValueError(f"textformat: expected field name, got {name!r}")
        tok = self.peek()
        if tok is None:
            raise ValueError(f"textformat: dangling field {name!r}")
        if tok[1] == "{":
            self.next()
            msg.add(name, self.parse_message())
        elif tok[1] == ":":
            self.next()
            tok2 = self.peek()
            if tok2 is not None and tok2[1] == "{":  # legacy `field: { ... }`
                self.next()
                msg.add(name, self.parse_message())
            else:
                msg.add(name, self.parse_value())
        else:
            raise ValueError(f"textformat: expected ':' or '{{' after {name!r}")
        # optional separators
        tok = self.peek()
        while tok is not None and tok[1] in (";", ","):
            self.next()
            tok = self.peek()

    def parse_value(self) -> Any:
        kind, tok = self.next()
        if kind == "string":
            # adjacent string literals concatenate (proto text format)
            out = _unquote(tok)
            nxt = self.peek()
            while nxt is not None and nxt[0] == "string":
                out += _unquote(self.next()[1])
                nxt = self.peek()
            return out
        if kind == "number":
            if tok.lower().startswith(("0x", "-0x", "+0x")):
                return int(tok, 16)
            try:
                v = int(tok)
            except ValueError:
                return float(tok)
            if v == 0 and tok.startswith("-"):
                # C++ SimpleFtoa prints float -0.0 as "-0"; keep the sign
                # (int 0 would drop it through the binary codec)
                return -0.0
            return v
        if kind == "ident":
            if tok == "true":
                return True
            if tok == "false":
                return False
            if tok in ("inf", "nan"):
                return float(tok)
            return tok  # enum value name
        raise ValueError(f"textformat: unexpected value token {tok!r}")


def parse(text: str) -> Message:
    return _Parser(_tokenize(text)).parse_message(top_level=True)


def parse_file(path: str) -> Message:
    with open(path, "r") as f:
        return parse(f.read())
