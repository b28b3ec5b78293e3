# -*- coding: utf-8 -*-
"""A reader of the YAML subset that ``conf/`` uses, without PyYAML.

The JAX composer reads ``conf/`` with PyYAML's ``SafeLoader`` plus one float
rule (``climsr_tpu/config/compose.py:38-57``: ``1e-4`` is a float, where YAML
1.1 reads it as a string). The GPU machine may lack PyYAML, so the port reads
the same files with this module, and gives the same values:

- block mappings and block sequences (``- item``, ``- key: value``, a
  sequence under a key at the key's own indent);
- flow mappings and flow sequences, nested (``{ name: "esrgan" }``,
  ``[[-1.0, 1.0], [0.0, 1.0]]``, ``{}``);
- double- and single-quoted scalars, and plain scalars resolved as
  ``SafeLoader`` resolves them: ``null``/``~``/empty, YAML 1.1 booleans
  (``true``, ``yes``, ``on``, ...), ints (decimal, ``0x``, ``0b``, octal,
  ``_`` separators, base 60), floats under the JAX loader's rule, and strings
  (``???`` and ``${...}`` among them);
- comments, full-line and trailing.

Anything else (anchors, aliases, tags, block scalars, multi-line plain or flow
scalars, several documents, timestamps) raises
:class:`~climsr_tpu_torch.config.compose.ConfigError` naming the file and line.
"""
from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple


class ConfigError(ValueError):
    pass


_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(
    r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""",
    re.X,
)
# SafeLoader's float rule, then the JAX loader's (which adds exponents without a dot)
_FLOAT = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)
_FLOAT_JAX = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |\.[0-9][0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""",
    re.X,
)
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v", "f": "\f",
            "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0"}


def _base60(text: str, cast) -> Any:
    sign = -1 if text.startswith("-") else 1
    digits = [cast(part) for part in text.lstrip("+-").split(":")]
    value, base = 0, 1
    for d in reversed(digits):
        value += d * base
        base *= 60
    return sign * value


def _int(text: str) -> int:
    t = text.replace("_", "")
    sign = -1 if t.startswith("-") else 1
    body = t.lstrip("+-")
    if body == "0":
        return 0
    if body.startswith("0b"):
        return sign * int(body[2:], 2)
    if body.startswith("0x"):
        return sign * int(body[2:], 16)
    if body.startswith("0"):
        return sign * int(body, 8)
    if ":" in body:
        return _base60(t, int)
    return sign * int(body)


def _float(text: str) -> float:
    t = text.replace("_", "").lower()
    sign = -1.0 if t.startswith("-") else 1.0
    body = t.lstrip("+-")
    if body == ".inf":
        return sign * float("inf")
    if body == ".nan":
        return float("nan")
    if ":" in body:
        return _base60(t, float)
    return sign * float(body)


class _Reader:
    def __init__(self, text: str, source: str):
        self.source = source
        self.lines: List[Tuple[int, int, str]] = []  # (line number, indent, content)
        for number, raw in enumerate(text.splitlines(), start=1):
            if "\t" in raw[: len(raw) - len(raw.lstrip())]:
                self.fail(number, "tab in indentation")
            content = self._strip_comment(raw, number).rstrip()
            if not content.strip():
                continue
            if content.startswith(("---", "...", "%")):
                self.fail(number, "document markers and directives are not read")
            self.lines.append((number, len(content) - len(content.lstrip(" ")), content.strip()))

    def fail(self, line: int, why: str):
        raise ConfigError(f"{self.source}:{line}: {why} (outside the YAML subset that conf/ uses)")

    def _strip_comment(self, raw: str, number: int) -> str:
        quote = None
        for i, ch in enumerate(raw):
            if quote:
                if ch == quote:
                    if quote == "'" and raw[i + 1: i + 2] == "'":
                        continue
                    if quote == '"' and _escaped(raw, i):
                        continue
                    quote = None
            elif ch in "\"'" and (i == 0 or raw[i - 1] in " \t[{,:-"):
                quote = ch
            elif ch == "#" and (i == 0 or raw[i - 1] in " \t"):
                return raw[:i]
        return raw

    # -- block structure ---------------------------------------------------
    def document(self) -> Any:
        if not self.lines:
            return None
        value, i = self.block(0, self.lines[0][1])
        if i < len(self.lines):
            self.fail(self.lines[i][0], "unexpected indentation")
        return value

    def block(self, i: int, indent: int) -> Tuple[Any, int]:
        number, _, content = self.lines[i]
        if _is_item(content):
            return self.sequence(i, indent)
        if self.split_key(content, number) is not None:
            return self.mapping(i, indent)
        value = self.scalar_or_flow(content, number)
        i += 1
        if i < len(self.lines) and self.lines[i][1] > indent:
            self.fail(self.lines[i][0], "multi-line scalars are not read")
        return value, i

    def sequence(self, i: int, indent: int) -> Tuple[List[Any], int]:
        out = []
        while i < len(self.lines) and self.lines[i][1] == indent and _is_item(self.lines[i][2]):
            number, _, content = self.lines[i]
            rest = content[1:].lstrip(" ")
            if not rest:
                i += 1
                if i < len(self.lines) and self.lines[i][1] > indent:
                    value, i = self.block(i, self.lines[i][1])
                else:
                    value = None
            else:
                # the item's content starts a node at its own column
                self.lines[i] = (number, indent + len(content) - len(rest), rest)
                value, i = self.block(i, self.lines[i][1])
            out.append(value)
        return out, i

    def mapping(self, i: int, indent: int) -> Tuple[dict, int]:
        out = {}
        while i < len(self.lines) and self.lines[i][1] == indent and not _is_item(self.lines[i][2]):
            number, _, content = self.lines[i]
            split = self.split_key(content, number)
            if split is None:
                self.fail(number, "expected 'key: value'")
            key, rest = split
            i += 1
            if rest:
                out[key] = self.scalar_or_flow(rest, number)
                if i < len(self.lines) and self.lines[i][1] > indent:
                    self.fail(self.lines[i][0], "multi-line scalars are not read")
            elif i < len(self.lines) and self.lines[i][1] > indent:
                out[key], i = self.block(i, self.lines[i][1])
            elif i < len(self.lines) and self.lines[i][1] == indent and _is_item(self.lines[i][2]):
                out[key], i = self.sequence(i, indent)
            else:
                out[key] = None
        if i < len(self.lines) and self.lines[i][1] > indent:
            self.fail(self.lines[i][0], "unexpected indentation")
        return out, i

    def split_key(self, content: str, number: int) -> Optional[Tuple[Any, str]]:
        """``key: rest`` -> (key, rest); None where the line holds no mapping key."""
        if content[0] in "[{":
            return None
        if content[0] in "\"'":
            text, end = _quoted(content, 0, lambda why: self.fail(number, why))
            after = content[end:].lstrip(" ")
            if after.startswith(":") and (len(after) == 1 or after[1] == " "):
                return text, after[1:].strip()
            return None
        for m in re.finditer(r":( |$)", content):
            key = content[: m.start()].rstrip()
            return self.plain(key, number), content[m.end():].strip()
        return None

    # -- scalars and flow collections --------------------------------------
    def scalar_or_flow(self, text: str, number: int) -> Any:
        if text[0] in "[{":
            value, end = self.flow(text, 0, number)
            if text[end:].strip():
                self.fail(number, f"text after a flow collection: {text[end:]!r}")
            return value
        if text[0] in "\"'":
            value, end = _quoted(text, 0, lambda why: self.fail(number, why))
            if text[end:].strip():
                self.fail(number, f"text after a quoted scalar: {text[end:]!r}")
            return value
        if re.search(r": |:$", text):
            self.fail(number, "a mapping value on the line of another key")
        return self.plain(text, number)

    def plain(self, text: str, number: int) -> Any:
        if text and text[0] in "&*!|>%@`":
            self.fail(number, f"unsupported node {text!r}")
        if text in _NULL:
            return None
        if text in _TRUE:
            return True
        if text in _FALSE:
            return False
        if _INT.match(text):
            return _int(text)
        if _FLOAT.match(text) or _FLOAT_JAX.match(text):
            return _float(text)
        if _TIMESTAMP.match(text):
            self.fail(number, f"timestamps are not read: {text!r}")
        return text

    def flow(self, text: str, i: int, number: int) -> Tuple[Any, int]:
        close = "]" if text[i] == "[" else "}"
        out: Any = [] if close == "]" else {}
        i += 1
        while True:
            i = _skip_spaces(text, i)
            if i >= len(text):
                self.fail(number, "flow collections must close on their line")
            if text[i] == close:
                return out, i + 1
            if close == "}":
                key, i = self.flow_node(text, i, number, in_key=True)
                i = _skip_spaces(text, i)
                if i < len(text) and text[i] == ":":
                    value, i = self.flow_node(text, _skip_spaces(text, i + 1), number)
                else:
                    value = None
                out[key] = value
            else:
                value, i = self.flow_node(text, i, number)
                out.append(value)
            i = _skip_spaces(text, i)
            if i < len(text) and text[i] == ",":
                i += 1
            elif i >= len(text) or text[i] != close:
                self.fail(number, f"expected ',' or {close!r} in a flow collection")

    def flow_node(self, text: str, i: int, number: int, in_key: bool = False) -> Tuple[Any, int]:
        if i < len(text) and text[i] in "[{":
            return self.flow(text, i, number)
        if i < len(text) and text[i] in "\"'":
            return _quoted(text, i, lambda why: self.fail(number, why))
        j = i
        while j < len(text) and text[j] not in ",[]{}":
            if text[j] == ":" and (j + 1 == len(text) or text[j + 1] in " ,]}"):
                break
            j += 1
        if j < len(text) and text[j] in "[{":
            self.fail(number, "a flow indicator inside a plain scalar")
        return self.plain(text[i:j].strip(), number), j


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _skip_spaces(text: str, i: int) -> int:
    while i < len(text) and text[i] == " ":
        i += 1
    return i


def _escaped(text: str, i: int) -> bool:
    n = 0
    while i - 1 - n >= 0 and text[i - 1 - n] == "\\":
        n += 1
    return n % 2 == 1


def _quoted(text: str, i: int, fail) -> Tuple[str, int]:
    """The quoted scalar starting at ``text[i]`` -> (value, index after it)."""
    quote = text[i]
    out = []
    j = i + 1
    while j < len(text):
        ch = text[j]
        if quote == "'":
            if ch == "'":
                if text[j + 1: j + 2] == "'":
                    out.append("'")
                    j += 2
                    continue
                return "".join(out), j + 1
            out.append(ch)
            j += 1
            continue
        if ch == '"':
            return "".join(out), j + 1
        if ch == "\\":
            nxt = text[j + 1: j + 2]
            if nxt in _ESCAPES:
                out.append(_ESCAPES[nxt])
                j += 2
            elif nxt in ("x", "u", "U"):
                width = {"x": 2, "u": 4, "U": 8}[nxt]
                code = text[j + 2: j + 2 + width]
                if len(code) != width or not re.fullmatch(r"[0-9a-fA-F]+", code):
                    fail(f"bad escape \\{nxt}{code}")
                out.append(chr(int(code, 16)))
                j += 2 + width
            else:
                fail(f"bad escape \\{nxt}")
            continue
        out.append(ch)
        j += 1
    fail("quoted scalars must close on their line")


def load_yaml(text: str, source: str = "<string>") -> Any:
    """Parse ``text`` (the subset above) into dicts, lists and scalars."""
    return _Reader(text, source).document()


def _flow(value: Any) -> str:
    """One value as a flow scalar, sequence or mapping of the subset above."""
    import json
    import math

    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()  # as PyYAML writes a float: a dot before any exponent (1.0e-05),
        return text.replace("e", ".0e", 1) if "e" in text and "." not in text else text  # YAML 1.1 reads
    if isinstance(value, str):
        return json.dumps(value)  # JSON's escapes are YAML double-quoted escapes
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_flow(v) for v in value) + "]"
    if isinstance(value, dict):
        return "{" + ", ".join(f"{json.dumps(str(k))}: {_flow(v)}" for k, v in value.items()) + "}"
    raise TypeError(f"dump_yaml writes dicts, lists and scalars, got {type(value).__name__}")


def dump_yaml(data: Any, indent: int = 0) -> str:
    """``data`` (dicts, lists, str, int, float, bool, None) as text that
    :func:`load_yaml` reads back to equal values: mappings in block style with
    double-quoted keys, sequences and scalars in flow style, strings
    double-quoted. The port's counterpart of ``yaml.safe_dump`` where PyYAML
    may be missing (the hyperparameter search's ``best.yaml``)."""
    import json

    if not isinstance(data, dict):
        return " " * indent + _flow(data) + "\n"
    lines = []
    for k, v in data.items():
        key = " " * indent + json.dumps(str(k)) + ":"
        if isinstance(v, dict) and v:
            lines.append(key + "\n" + dump_yaml(v, indent + 2).rstrip("\n"))
        else:
            lines.append(f"{key} {_flow(v)}")
    return "\n".join(lines) + "\n"
