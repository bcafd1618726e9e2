"""Experiment trackers (port of fastvideo_tpu/training/trackers.py):
``DummyTracker``, the local ``JsonlTracker``, ``SequentialTracker`` fan-out
and ``initialize_trackers``. A backend the port lacks (``wandb``: the
card's machine has no such package) or cannot open degrades to a no-op
with a warning, as an unavailable one does in JAX.
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections.abc import Iterable
from typing import Any

logger = logging.getLogger(__name__)


class BaseTracker:
    """Interface: subclasses implement log and finish."""

    def log(self, metrics: dict[str, Any], step: int) -> None:
        raise NotImplementedError

    def finish(self) -> None:
        raise NotImplementedError


class DummyTracker(BaseTracker):

    def log(self, metrics: dict[str, Any], step: int) -> None:
        pass

    def finish(self) -> None:
        pass


class JsonlTracker(BaseTracker):
    """Metrics to ``<log_dir>/<project>/<run>/metrics.jsonl``, the config's
    scalar fields to ``config.json`` beside it."""

    def __init__(self, project: str, config: dict[str, Any] | None = None,
                 log_dir: str = ".", run_name: str | None = None) -> None:
        run_name = run_name or f"run-{int(time.time())}"
        self.dir = os.path.join(log_dir, project, run_name)
        os.makedirs(self.dir, exist_ok=True)
        self._fh = open(os.path.join(self.dir, "metrics.jsonl"), "a")
        if config:
            clean = {k: v for k, v in config.items()
                     if isinstance(v, (int, float, str, bool, list, tuple,
                                       type(None)))}
            with open(os.path.join(self.dir, "config.json"), "w") as fh:
                json.dump(clean, fh, indent=2, default=str)

    def log(self, metrics: dict[str, Any], step: int) -> None:
        row = {"step": step, "time": time.time()}
        for k, v in metrics.items():
            if hasattr(v, "item"):
                v = v.item()
            if isinstance(v, (int, float, str, bool, type(None))):
                row[k] = v
        self._fh.write(json.dumps(row) + "\n")
        self._fh.flush()

    def finish(self) -> None:
        self._fh.close()


class SequentialTracker(BaseTracker):

    def __init__(self, trackers: Iterable[BaseTracker]) -> None:
        self.trackers = list(trackers)

    def log(self, metrics: dict[str, Any], step: int) -> None:
        for t in self.trackers:
            t.log(metrics, step)

    def finish(self) -> None:
        for t in self.trackers:
            t.finish()


_BACKENDS = {
    "dummy": lambda **kw: DummyTracker(),
    "jsonl": JsonlTracker,
}


def initialize_trackers(trackers: Iterable[str], project: str,
                        config: dict[str, Any] | None = None,
                        log_dir: str = ".",
                        run_name: str | None = None) -> BaseTracker:
    """The tracker stack; backends the port lacks or cannot open are
    skipped with a warning, and none at all gives a ``DummyTracker``."""
    built: list[BaseTracker] = []
    for name in trackers:
        factory = _BACKENDS.get(str(name).lower())
        if factory is None:
            logger.warning("Tracker %r is not available in the port; "
                           "skipping", name)
            continue
        try:
            built.append(factory(project=project, config=config,
                                 log_dir=log_dir, run_name=run_name))
        except OSError as e:
            logger.warning("Tracker %r unavailable (%s); skipping", name, e)
    if not built:
        return DummyTracker()
    if len(built) == 1:
        return built[0]
    return SequentialTracker(built)
