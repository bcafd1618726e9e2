"""Dict -> typed config tree parser (port of the parts of
fastvideo_tpu/api/parser.py that ``load_train_config`` needs).

``parse_dataclass`` walks nested dicts into the schema dataclasses and
rejects unknown keys with their full path. ``load_config_file`` reads JSON,
or else a simple YAML subset with its own reader: nested mappings by
indentation, scalars (bool, null, int, float, quoted or bare strings) and
inline ``[a, b]`` lists. The card's machine has no PyYAML, so the reader
never looks for it, and a file parses the same everywhere.
"""

from __future__ import annotations

import dataclasses
import json
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
    """The YAML subset of the training configs: mappings nested by
    indentation, scalars and inline lists. ``#`` starts a comment."""
    root: dict[str, Any] = {}
    stack: list[tuple[int, dict[str, Any]]] = [(-1, root)]
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip())
        key, sep, rest = line.strip().partition(":")
        if not sep:
            raise ConfigValidationError(
                "", f"not a 'key: value' line of the YAML subset: {raw!r}")
        while indent <= stack[-1][0]:
            stack.pop()
        parent = stack[-1][1]
        rest = rest.strip()
        if not rest:
            child: dict[str, Any] = {}
            parent[key] = child
            stack.append((indent, child))
        else:
            parent[key] = _coerce_scalar(rest)
    return root


def _coerce_scalar(s: str) -> Any:
    low = s.lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    if low in ("null", "none", "~"):
        return None
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1].strip()
        return ([] if not inner
                else [_coerce_scalar(x.strip()) for x in inner.split(",")])
    if len(s) >= 2 and s[0] == s[-1] and s[0] in "'\"":
        return s[1:-1]
    for kind in (int, float):
        try:
            return kind(s)
        except ValueError:
            pass
    return s
