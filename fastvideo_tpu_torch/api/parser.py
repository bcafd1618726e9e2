"""Dict -> typed config tree parser (port of the parts of
fastvideo_tpu/api/parser.py that ``load_train_config`` needs).

``parse_dataclass`` walks nested dicts into the schema dataclasses and
rejects unknown keys with their full path. ``load_config_file`` reads JSON,
or else a YAML subset with its own reader (:func:`parse_simple_yaml`):
mappings nested by indentation, scalars and one-line flow collections, read
as ``yaml.safe_load`` reads them. The card's machine has no PyYAML, so the
reader never looks for it, and a file parses the same everywhere.
"""

from __future__ import annotations

import dataclasses
import json
import math
import re
import types
import typing
from typing import Any

from fastvideo_tpu_torch.api.errors import (ConfigValidationError,
                                            UnknownFieldError)


def _is_dataclass_type(tp) -> bool:
    return isinstance(tp, type) and dataclasses.is_dataclass(tp)


def _unwrap_optional(tp):
    if typing.get_origin(tp) in (typing.Union, types.UnionType):
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def parse_dataclass(cls, data: dict[str, Any], path: str = ""):
    """Build ``cls`` from a nested dict; raise on unknown keys."""
    if not isinstance(data, dict):
        raise ConfigValidationError(path or cls.__name__,
                                    f"expected a mapping, got {type(data)}")
    fields = {f.name: f for f in dataclasses.fields(cls)}
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for key, value in data.items():
        fpath = f"{path}.{key}" if path else key
        f = fields.get(key)
        if f is None:
            raise UnknownFieldError(
                fpath, f"unknown field; valid: {sorted(fields)}")
        ftype = _unwrap_optional(hints.get(key, f.type))
        if _is_dataclass_type(ftype) and isinstance(value, dict):
            kwargs[key] = parse_dataclass(ftype, value, fpath)
        else:
            kwargs[key] = value
    try:
        return cls(**kwargs)
    except TypeError as e:
        raise ConfigValidationError(path, str(e)) from None


def load_config_file(cls, path: str):
    """Load a JSON (or simple YAML) config file into a schema dataclass."""
    with open(path) as fh:
        text = fh.read()
    try:
        data = json.loads(text)
    except json.JSONDecodeError:
        data = parse_simple_yaml(text)
    return parse_dataclass(cls, data)


def parse_simple_yaml(text: str) -> dict[str, Any]:
    """The YAML subset of the training configs, read as ``yaml.safe_load``
    reads it: mappings nested by indentation whose values are scalars or
    one-line flow collections (``{k: v, ...}`` and ``[a, b]``, nested),
    plain or quoted. ``#`` starts a comment at the start of a line or after
    a blank, outside quotes."""
    root: dict[str, Any] = {}
    stack: list[tuple[int, dict[str, Any]]] = [(-1, root)]
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip())
        reader = _FlowReader(line.strip(), raw)
        key = reader.key()
        while indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        if reader.at_end():
            child: dict[str, Any] = {}
            parent[key] = child
            stack.append((indent, child))
        else:
            parent[key] = reader.value()
    return root


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " \t[{,:"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


class _FlowReader:
    """Reads one line's ``key: value`` with PyYAML's rules for the subset:
    flow collections end a plain scalar at ``,`` ``[`` ``]`` ``{`` ``}``, a
    ``:`` ends a key only before a blank or the end."""

    _ESCAPES = {"n": "\n", "t": "\t", "\\": "\\", '"': '"', "/": "/",
                "0": "\0", "r": "\r"}

    def __init__(self, text: str, raw: str):
        self.text, self.raw, self.pos = text, raw, 0

    def fail(self, what: str):
        raise ConfigValidationError(
            "", f"{what} at column {self.pos} of the YAML subset: "
            f"{self.raw!r}")

    def at_end(self) -> bool:
        self.skip_blanks()
        return self.pos >= len(self.text)

    def skip_blanks(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos] in " \t":
            self.pos += 1

    def key(self) -> Any:
        key = self.node(flow=True, as_key=True)
        self.skip_blanks()
        if not self.text.startswith(":", self.pos):
            self.fail("expected ':'")
        self.pos += 1
        return key

    def value(self) -> Any:
        out = self.node(flow=False)
        if not self.at_end():
            self.fail("unexpected text after a value")
        return out

    def node(self, flow: bool, as_key: bool = False) -> Any:
        self.skip_blanks()
        ch = self.text[self.pos:self.pos + 1]
        if ch == "{":
            return self.mapping()
        if ch == "[":
            return self.sequence()
        if ch in ("'", '"'):
            return self.quoted(ch)
        return _resolve_plain(self.plain(flow, as_key))

    def plain(self, flow: bool, as_key: bool) -> str:
        start, text = self.pos, self.text
        while self.pos < len(text):
            ch = text[self.pos]
            nxt = text[self.pos + 1:self.pos + 2]
            if ch == ":" and (nxt in ("", " ", "\t") or
                              (flow and nxt in ",[]{}")):
                if as_key or flow:
                    break
            if flow and ch in ",[]{}":
                break
            self.pos += 1
        return text[start:self.pos].strip()

    def quoted(self, q: str) -> str:
        text, out = self.text, []
        self.pos += 1
        while self.pos < len(text):
            ch = text[self.pos]
            if q == "'" and ch == "'":
                if text.startswith("''", self.pos):
                    out.append("'")
                    self.pos += 2
                    continue
                self.pos += 1
                return "".join(out)
            if q == '"' and ch == '"':
                self.pos += 1
                return "".join(out)
            if q == '"' and ch == "\\":
                esc = text[self.pos + 1:self.pos + 2]
                if esc not in self._ESCAPES:
                    self.fail(f"unknown escape \\{esc}")
                out.append(self._ESCAPES[esc])
                self.pos += 2
                continue
            out.append(ch)
            self.pos += 1
        self.fail("unterminated quoted string")

    def mapping(self) -> dict[Any, Any]:
        self.pos += 1
        out: dict[Any, Any] = {}
        while True:
            self.skip_blanks()
            if self.text.startswith("}", self.pos):
                self.pos += 1
                return out
            key = self.node(flow=True, as_key=True)
            self.skip_blanks()
            value = None
            if self.text.startswith(":", self.pos):
                self.pos += 1
                value = self.node(flow=True)
            out[key] = value
            self.end_item("}")

    def sequence(self) -> list[Any]:
        self.pos += 1
        out: list[Any] = []
        while True:
            self.skip_blanks()
            if self.text.startswith("]", self.pos):
                self.pos += 1
                return out
            out.append(self.node(flow=True))
            self.end_item("]")

    def end_item(self, close: str) -> None:
        self.skip_blanks()
        ch = self.text[self.pos:self.pos + 1]
        if ch == ",":
            self.pos += 1
        elif ch != close:
            self.fail(f"expected ',' or '{close}'")


# PyYAML's YAML 1.1 implicit types (yaml/resolver.py), and one addition:
# an exponent with no '.' ("1e-3") is a float here, as in JSON and YAML 1.2,
# where PyYAML keeps it a string
_BOOL = {"yes": True, "true": True, "on": True, "no": False, "false": False,
         "off": False}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(0b[01_]+|0x[0-9a-fA-F_]+|0[0-7_]+|0|[1-9][0-9_]*)")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*[eE][-+]?[0-9]+")
_INF_NAN = re.compile(r"([-+]?)\.(inf|Inf|INF)|\.(nan|NaN|NAN)")


def _resolve_plain(s: str) -> Any:
    if s in _NULL:
        return None
    if s.lower() in _BOOL and s in (s.lower(), s.capitalize(), s.upper()):
        return _BOOL[s.lower()]
    if _INT.fullmatch(s):
        digits = s.replace("_", "")
        sign = -1 if digits[0] == "-" else 1
        digits = digits.lstrip("+-")
        if digits.startswith(("0b", "0x")):
            return sign * int(digits, 0)
        if len(digits) > 1 and digits[0] == "0":
            return sign * int(digits, 8)
        return sign * int(digits)
    if _FLOAT.fullmatch(s) and s.strip("+-") != ".":
        return float(s.replace("_", ""))
    special = _INF_NAN.fullmatch(s)
    if special:
        return math.nan if special.group(3) else float(
            special.group(1) + "inf")
    return s
