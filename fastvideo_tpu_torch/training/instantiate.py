"""``_target_``-based instantiation (port of
fastvideo_tpu/training/instantiate.py).

A config node may carry a ``_target_`` dotted path; its other keys become
constructor kwargs, filtered against the signature. The port imports
nothing of the JAX package: a path under ``fastvideo_tpu.`` resolves to the
same path under ``fastvideo_tpu_torch.``, where the port has the
counterpart, and raises where it has none; a path into JAX or Flax raises.
"""

from __future__ import annotations

import importlib
import inspect
import logging
from typing import Any

logger = logging.getLogger(__name__)

JAX_PACKAGE = "fastvideo_tpu"
PORT_PACKAGE = "fastvideo_tpu_torch"
_REFUSED = ("jax", "jaxlib", "flax")


def port_path(target: str) -> str:
    """``target`` with a leading ``fastvideo_tpu.`` read as the port's
    package."""
    head, _, rest = target.partition(".")
    return f"{PORT_PACKAGE}.{rest}" if head == JAX_PACKAGE else target


def resolve_target(target: str) -> Any:
    """Import and return the attribute at a fully-qualified dotted path."""
    if not isinstance(target, str) or "." not in target.strip():
        raise ValueError(
            f"_target_ must be a dotted path 'module.Attr', got {target!r}")
    module_path, attr = port_path(target.strip()).rsplit(".", 1)
    if module_path.split(".")[0] in _REFUSED:
        raise ImportError(f"_target_ {target!r}: the port imports no JAX")
    try:
        module = importlib.import_module(module_path)
    except ModuleNotFoundError as exc:
        raise ImportError(f"cannot import module {module_path!r} for "
                          f"_target_ {target!r}") from exc
    try:
        return getattr(module, attr)
    except AttributeError as exc:
        raise ImportError(
            f"module {module_path!r} has no attribute {attr!r} (_target_ "
            f"{target!r})") from exc


def instantiate(cfg: dict[str, Any], **extra: Any) -> Any:
    """Instantiate ``cfg['_target_']`` with the other keys and ``extra``.

    Keys the constructor does not take are dropped with a warning (unless
    it takes ``**kwargs``)."""
    if not isinstance(cfg, dict) or "_target_" not in cfg:
        raise KeyError("instantiate() needs a dict with a '_target_' key")
    cls = resolve_target(str(cfg["_target_"]))
    kwargs = {k: v for k, v in cfg.items() if k != "_target_"}
    kwargs.update(extra)

    params = inspect.signature(
        cls.__init__ if inspect.isclass(cls) else cls).parameters
    if not any(p.kind == inspect.Parameter.VAR_KEYWORD
               for p in params.values()):
        valid = {
            n for n, p in params.items()
            if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                          inspect.Parameter.KEYWORD_ONLY)
        } - {"self"}
        dropped = set(kwargs) - valid
        if dropped:
            logger.warning("instantiate(%s): dropping unrecognized keys %s",
                           cfg["_target_"], sorted(dropped))
            kwargs = {k: v for k, v in kwargs.items() if k in valid}
    return cls(**kwargs)
