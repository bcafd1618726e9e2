"""Composable training callbacks (port of fastvideo_tpu/training/callbacks.py).

Named callbacks are built from the config's ``callbacks:`` mapping
(built-in names need no ``_target_``; a dotted ``_target_`` under
``fastvideo_tpu.`` resolves in the port's package) and dispatched at train
start, step end, before the optimizer step and train end, where the JAX
trainers dispatch them; their ``state_dict`` round-trips through
checkpoints.

Where JAX differs by construction: the trainer's step is not a compiled
program, so ``GradNormClipCallback`` sets ``args.max_grad_norm``, which the
next step reads, and rebuilds nothing; ``EMACallback``'s shadow is a list
of fp32 tensors beside the trained parameters (``method.params``, the
port's counterpart of JAX's ``method.state.params``: the SFT trainer and
its subclasses), updated in place after each step.
"""

from __future__ import annotations

import contextlib
import inspect
import logging
from typing import Any

import torch

logger = logging.getLogger(__name__)

_BUILTIN_CALLBACKS = {
    "grad_clip": "fastvideo_tpu_torch.training.callbacks.GradNormClipCallback",
    "validation": "fastvideo_tpu_torch.training.callbacks.ValidationCallback",
    "ema": "fastvideo_tpu_torch.training.callbacks.EMACallback",
}


class Callback:
    """Base callback with no-op hooks."""

    name: str = ""

    def on_train_start(self, method, iteration: int = 0) -> None:
        pass

    def on_training_step_end(self, method, loss_dict: dict[str, Any],
                             iteration: int = 0) -> None:
        pass

    def on_before_optimizer_step(self, method, iteration: int = 0) -> None:
        pass

    def on_train_end(self, method, iteration: int = 0) -> None:
        pass

    def state_dict(self) -> dict[str, Any]:
        return {}

    def load_state_dict(self, state_dict: dict[str, Any]) -> None:
        pass


class CallbackDict:
    """Build named callbacks and fan each hook call out to all of them."""

    def __init__(self, callback_configs: dict[str, dict[str, Any]] | None):
        self._callbacks: dict[str, Callback] = {}
        for name, cb_cfg in (callback_configs or {}).items():
            cb_cfg = dict(cb_cfg or {})
            target = cb_cfg.pop("_target_", _BUILTIN_CALLBACKS.get(name))
            if target is None:
                logger.warning("Callback %r missing _target_; skipping",
                               name)
                continue
            if isinstance(target, str):
                from fastvideo_tpu_torch.training.instantiate import (
                    resolve_target)

                target = resolve_target(target)
            cb = target(**cb_cfg)
            if not isinstance(cb, Callback):
                raise TypeError(
                    f"Callback {name!r} resolved to {type(cb).__name__}, "
                    "expected a Callback subclass")
            cb.name = name
            self._callbacks[name] = cb

    def __iter__(self):
        return iter(self._callbacks.values())

    def __getitem__(self, name: str) -> Callback:
        return self._callbacks[name]

    def __len__(self) -> int:
        return len(self._callbacks)

    def state_dict(self) -> dict[str, Any]:
        return {n: cb.state_dict() for n, cb in self._callbacks.items()}

    def load_state_dict(self, state_dict: dict[str, Any]) -> None:
        for n, cb in self._callbacks.items():
            if n in state_dict:
                cb.load_state_dict(state_dict[n])

    def dispatch(self, hook: str, *args, **kwargs) -> None:
        for cb in self._callbacks.values():
            getattr(cb, hook)(*args, **kwargs)


def normalize_callbacks(callbacks) -> CallbackDict | None:
    """Accept a CallbackDict, a raw ``{name: cfg}`` mapping, or None."""
    if callbacks is None or isinstance(callbacks, CallbackDict):
        return callbacks
    return CallbackDict(callbacks)


class GradNormClipCallback(Callback):
    """Set the trainer's clip threshold; log its grad norms."""

    def __init__(self, *, max_grad_norm: float = 1.0,
                 log_grad_norms: bool = True):
        self.max_grad_norm = float(max_grad_norm)
        self.log_grad_norms = bool(log_grad_norms)

    def on_train_start(self, method, iteration: int = 0) -> None:
        args = getattr(method, "args", None)
        if args is not None and self.max_grad_norm > 0:
            args.max_grad_norm = self.max_grad_norm

    def on_training_step_end(self, method, loss_dict, iteration=0) -> None:
        tracker = getattr(method, "tracker", None)
        grad_norm = loss_dict.get("grad_norm")
        if self.log_grad_norms and tracker is not None and \
                grad_norm is not None:
            tracker.log({"grad_norm/transformer": float(grad_norm)},
                        iteration)


class EMACallback(Callback):
    """Exponential moving average of the trained parameters: an fp32 shadow
    of each, ``shadow * decay + param * (1 - decay)`` after each step from
    ``start_iter`` on (at ``start_iter > 0`` the shadow restarts from the
    parameters then)."""

    def __init__(self, *, decay: float = 0.9999, start_iter: int = 0):
        self.decay = float(decay)
        self.start_iter = int(start_iter)
        self.shadow: list[torch.Tensor] | None = None

    @staticmethod
    def _get_params(method) -> list[torch.Tensor]:
        from fastvideo_tpu_torch.training.training_pipeline import (
            TrainingPipeline)

        if isinstance(method, TrainingPipeline):
            return method.params
        raise ValueError("EMACallback: the method has no trained parameter "
                         "list (the SFT trainer's .params)")

    def _copy(self, params) -> list[torch.Tensor]:
        return [p.detach().float().clone() for p in params]

    def on_train_start(self, method, iteration: int = 0) -> None:
        self.shadow = self._copy(self._get_params(method))
        logger.info("EMA callback enabled (decay=%s, start_iter=%d)",
                    self.decay, self.start_iter)

    @torch.no_grad()
    def on_training_step_end(self, method, loss_dict, iteration=0) -> None:
        if iteration < self.start_iter:
            return
        params = self._get_params(method)
        if iteration == self.start_iter and self.start_iter > 0:
            self.shadow = self._copy(params)
            return
        # 1 - decay in double, each product and the sum in fp32, as JAX's
        # closure over the Python float computes them
        for s, p in zip(self.shadow, params):
            s.mul_(self.decay).add_(p.detach().float() * (1.0 - self.decay))

    @contextlib.contextmanager
    def ema_context(self, method):
        """Swap the shadow into the live parameters for the block."""
        params = self._get_params(method)
        with torch.no_grad():
            live = [p.detach().clone() for p in params]
            for p, s in zip(params, self.shadow):
                p.copy_(s)
        try:
            yield
        finally:
            with torch.no_grad():
                for p, v in zip(params, live):
                    p.copy_(v)

    def state_dict(self) -> dict[str, Any]:
        if self.shadow is None:
            return {}
        return {"decay": self.decay,
                "shadow_flat": [s.cpu().numpy() for s in self.shadow]}

    def load_state_dict(self, state_dict: dict[str, Any]) -> None:
        if not state_dict or self.shadow is None:
            return
        flat = state_dict.get("shadow_flat")
        if flat is None:
            return
        self.shadow = [torch.as_tensor(v, dtype=torch.float32).to(s.device)
                       for v, s in zip(flat, self.shadow)]


class ValidationCallback(Callback):
    """Call the method's ``validation_sample`` every ``every_n_steps`` with
    the keyword arguments it takes; skip (with one warning) where it needs
    data the callback cannot supply. With ``dataset_path`` (a validation
    file, ``dataset/validation.py``) each event samples the file's prompts
    in turn, at most ``max_samples`` of them."""

    def __init__(self, *, every_n_steps: int = 500, prompt: str = "",
                 num_inference_steps: int = 4, use_ema: bool = False,
                 dataset_path: str = "", max_samples: int = 4):
        self.every_n_steps = int(every_n_steps)
        self.prompt = prompt
        self.num_inference_steps = int(num_inference_steps)
        self.use_ema = bool(use_ema)
        self.max_samples = int(max_samples)
        self._val_prompts: list[str] = []
        self._warned_signature = False
        if dataset_path:
            from fastvideo_tpu_torch.dataset.validation import (
                ValidationDataset)

            self._val_prompts = [s["prompt"]
                                 for s in ValidationDataset(dataset_path)]

    def on_training_step_end(self, method, loss_dict, iteration=0) -> None:
        if self.every_n_steps <= 0 or iteration == 0 or \
                iteration % self.every_n_steps != 0:
            return
        sample_fn = getattr(method, "validation_sample", None)
        if sample_fn is None:
            return
        ctx = contextlib.nullcontext()
        if self.use_ema:
            for cb in getattr(method, "_callbacks", None) or []:
                if isinstance(cb, EMACallback):
                    ctx = cb.ema_context(method)
                    break
        try:
            sig = inspect.signature(sample_fn)
        except (TypeError, ValueError):
            sig = None
        kwargs = {"prompt": self.prompt or None,
                  "num_inference_steps": self.num_inference_steps}
        if sig is not None:
            kwargs = {k: v for k, v in kwargs.items() if k in sig.parameters}
            missing = [
                n for n, p in sig.parameters.items()
                if p.default is inspect.Parameter.empty
                and p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY)
                and n not in kwargs
            ]
            if missing:
                if not self._warned_signature:
                    self._warned_signature = True
                    logger.warning(
                        "validation callback: %s.validation_sample needs %s "
                        "which the callback cannot supply; skipping "
                        "validation sampling", type(method).__name__,
                        missing)
                return
        prompt_sets: list[dict] = [kwargs]
        if self._val_prompts and "prompt" in kwargs:
            prompt_sets = [{**kwargs, "prompt": p}
                           for p in self._val_prompts[:self.max_samples]]
        with ctx:
            metrics = None
            for kw in prompt_sets:
                metrics = sample_fn(**kw)
        tracker = getattr(method, "tracker", None)
        if tracker is not None and isinstance(metrics, dict):
            tracker.log({f"validation/{k}": v for k, v in metrics.items()
                         if isinstance(v, (int, float))}, iteration)
