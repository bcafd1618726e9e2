"""Training checkpoints (port of fastvideo_tpu/training/checkpoint.py).

The JAX package writes orbax checkpoints; the card's machine has no orbax,
so the port has its own format, one directory per step:

    <directory>/checkpoint-<step>/model.safetensors      the parameters
    <directory>/checkpoint-<step>/optimizer.safetensors  AdamW's per-param
                                                         state, "<i>.<key>"
    <directory>/checkpoint-<step>/meta.json              step, the random
                                                         generator's state,
                                                         the param groups

written with the port's safetensors writer. As in JAX, the caller restores
the random state last. ``max_to_keep`` older steps are kept.
"""

from __future__ import annotations

import json
import logging
import os
import re
import shutil
from typing import Any

import torch

from fastvideo_tpu_torch.models.loader.safetensors_io import (load_file,
                                                              save_file)

logger = logging.getLogger(__name__)

_STEP_DIR = re.compile(r"^checkpoint-(\d+)$")


class CheckpointManager:

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"checkpoint-{step}")

    def steps(self) -> list[int]:
        found = (_STEP_DIR.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, model_state: dict[str, torch.Tensor],
             opt_state: dict[str, Any], rng_state: torch.Tensor,
             extra: dict | None = None) -> None:
        """``opt_state`` is a torch optimizer's ``state_dict()``,
        ``rng_state`` a ``torch.Generator``'s ``get_state()``."""
        tmp = self._path(step) + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        save_file(dict(model_state), os.path.join(tmp, "model.safetensors"))
        opt = {f"{i}.{key}": t for i, st in opt_state["state"].items()
               for key, t in st.items()}
        save_file(opt, os.path.join(tmp, "optimizer.safetensors"))
        meta = {"step": step, "rng": rng_state.tolist(),
                "param_groups": opt_state["param_groups"], **(extra or {})}
        with open(os.path.join(tmp, "meta.json"), "w") as fh:
            json.dump(meta, fh)
        shutil.rmtree(self._path(step), ignore_errors=True)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(self._path(old), ignore_errors=True)
        logger.info("Saved checkpoint at step %d to %s", step, self.directory)

    def restore(self, step: int | None = None
                ) -> tuple[dict, dict, torch.Tensor, dict]:
        """(model_state, optimizer state_dict, rng_state, meta) of ``step``
        (default: the latest), tensors on the CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self._path(step)
        model_state = load_file(os.path.join(path, "model.safetensors"))
        with open(os.path.join(path, "meta.json")) as fh:
            meta = json.load(fh)
        state: dict[int, dict[str, torch.Tensor]] = {}
        for name, t in load_file(os.path.join(path,
                                              "optimizer.safetensors")).items():
            i, key = name.split(".", 1)
            state.setdefault(int(i), {})[key] = t
        groups = [dict(g, betas=tuple(g["betas"])) if "betas" in g else g
                  for g in meta.pop("param_groups")]
        rng = torch.tensor(meta.pop("rng"), dtype=torch.uint8)
        logger.info("Restored checkpoint step %d", step)
        return model_state, {"state": state, "param_groups": groups}, rng, meta
