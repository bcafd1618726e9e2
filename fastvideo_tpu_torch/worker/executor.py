"""Executor: the engine wrapper around a pipeline (port of
fastvideo_tpu/worker/executor.py).

JAX drives every chip from one controller, so its ``collective_rpc`` is a
direct call. PyTorch runs one process per card: ``Executor`` keeps the
pipeline in this process (one card, or each process of a torchrun world,
which builds its own share), and ``MultiprocExecutor`` spawns one worker
process per rank (``torch.multiprocessing``, start method ``spawn``). Each
worker takes its card (``cuda:rank``) or the CPU, joins the process group
(NCCL on the card, gloo on the CPU; a file store in a temporary directory
for the rendezvous), builds the pipeline on the mesh and answers calls.
Every call goes to every worker; ``execute_forward`` returns rank 0's
batch, its clip already as one uint8 tensor and every tensor on the host
(host tensors cross the pipe through shared memory).

A worker that raises, or dies, fails the call at once: the executor stops
every worker and raises (a rank left waiting in a collective would never
return). ``dist_timeout`` bounds a call's wait too.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import faulthandler
import logging
import multiprocessing.connection as mp_connection
import os
import shutil
import tempfile
import threading
import time
import traceback
import weakref
from typing import Any

import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp

from fastvideo_tpu_torch import envs
from fastvideo_tpu_torch.fastvideo_args import FastVideoArgs
from fastvideo_tpu_torch.parallel.mesh import backend_for
from fastvideo_tpu_torch.pipelines import build_pipeline
from fastvideo_tpu_torch.pipelines.batch import ForwardBatch

logger = logging.getLogger(__name__)


@contextlib.contextmanager
def iteration_watchdog(what: str = "engine iteration", *,
                       _clock=time.monotonic,
                       _timer_cls=threading.Timer):
    """Wall-clock guard around one engine iteration.

    Enforces ``FASTVIDEO_ENGINE_ITERATION_TIMEOUT_S``: if the iteration
    exceeds the budget, every thread's stack is dumped via
    :mod:`faulthandler` and a critical log line is emitted so a hung
    iteration is visible instead of a silent stall. <=0 disables the
    guard. The iteration is not killed; the dump makes the hang
    diagnosable.

    ``_clock`` / ``_timer_cls`` exist so tests can drive the deadline with a
    fake clock and an inert timer instead of real sleeps (deterministic
    under CPU contention).
    """
    timeout = envs.FASTVIDEO_ENGINE_ITERATION_TIMEOUT_S
    if timeout <= 0:
        yield
        return
    fired = threading.Event()
    start = _clock()

    def _alarm() -> None:
        # log BEFORE setting the event: the main thread emits its
        # "eventually completed" line only once ``fired`` is set, so this
        # order guarantees the exceeded line precedes it.
        logger.critical(
            "%s exceeded FASTVIDEO_ENGINE_ITERATION_TIMEOUT_S=%ds "
            "(thread stacks dumped to stderr)", what, timeout)
        fired.set()

    watchdog = _timer_cls(timeout, _alarm)
    watchdog.daemon = True
    watchdog.start()
    try:
        # dumps all thread stacks to stderr if the deadline passes
        faulthandler.dump_traceback_later(timeout, exit=False)
    except (RuntimeError, OSError):  # pragma: no cover - no stderr fd
        pass
    try:
        yield
    finally:
        watchdog.cancel()
        with contextlib.suppress(RuntimeError, OSError):
            faulthandler.cancel_dump_traceback_later()
        elapsed = _clock() - start
        if not fired.is_set() and elapsed > timeout:
            # the Timer expired but cancel() raced its callback (starved
            # scheduler): report the breach deterministically from here
            logger.critical(
                "%s exceeded FASTVIDEO_ENGINE_ITERATION_TIMEOUT_S=%ds "
                "(thread stacks dumped to stderr)", what, timeout)
            fired.set()
        if fired.is_set():
            logger.warning("%s eventually completed after %.1fs "
                           "(budget %ds)", what, elapsed, timeout)


class Executor:
    """The pipeline in this process."""

    def __init__(self, fastvideo_args: FastVideoArgs, device: torch.device,
                 pipeline=None):
        self.fastvideo_args = fastvideo_args
        self.device = device
        self.pipeline = (pipeline if pipeline is not None else
                         build_pipeline(fastvideo_args, device))

    @classmethod
    def get_class(cls, fastvideo_args: FastVideoArgs) -> type["Executor"]:
        """Worker processes for more than one card, unless this process is
        one rank of a world that a launcher started (torchrun's or the JAX
        package's environment, or a default group that exists)."""
        launched = dist.is_initialized() or any(
            os.environ.get(k) for k in ("WORLD_SIZE",
                                        "FASTVIDEO_COORDINATOR_ADDRESS"))
        if fastvideo_args.num_gpus > 1 and not launched:
            return MultiprocExecutor
        return Executor

    def collective_rpc(self, method, *args, **kwargs) -> list[Any]:
        """One rank, a direct call: ``method`` names a pipeline or
        executor method, or is a function called as ``method(self, ...)``."""
        if callable(method):
            return [method(self, *args, **kwargs)]
        target = getattr(self.pipeline, method, None) or getattr(
            self, method)
        return [target(*args, **kwargs)]

    def execute_forward(self, batch: ForwardBatch,
                        fastvideo_args: FastVideoArgs) -> ForwardBatch:
        with iteration_watchdog("execute_forward"):
            return self.pipeline.forward(batch, fastvideo_args)

    def set_lora_adapter(self, lora_nickname: str,
                         lora_path: str | None = None) -> None:
        if hasattr(self.pipeline, "set_lora_adapter"):
            self.pipeline.set_lora_adapter(lora_nickname, lora_path)
        else:
            raise NotImplementedError(
                "Pipeline does not support LoRA adapters")

    def shutdown(self) -> None:
        self.pipeline = None


def to_host(obj):
    """Every tensor in ``obj`` (a batch, its lists and dicts) as a host
    copy, so that it crosses the pipe by value."""
    if torch.is_tensor(obj):
        return obj.detach().cpu().clone()
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            setattr(obj, f.name, to_host(getattr(obj, f.name)))
    return obj


class Worker:
    """One rank's pipeline, in a worker process."""

    def __init__(self, fastvideo_args: FastVideoArgs, device: torch.device,
                 rank: int):
        self.fastvideo_args = fastvideo_args
        self.device = device
        self.rank = rank
        self.pipeline = build_pipeline(fastvideo_args, device)

    def call(self, method, *args, **kwargs):
        if callable(method):
            return method(self, *args, **kwargs)
        target = getattr(self.pipeline, method, None) or getattr(
            self, method)
        return target(*args, **kwargs)

    def execute_forward(self, batch: ForwardBatch,
                        fastvideo_args: FastVideoArgs) -> ForwardBatch | None:
        from fastvideo_tpu_torch.entrypoints.video_generator import (
            video_uint8)

        t0 = time.perf_counter()
        with iteration_watchdog("execute_forward"):
            batch = self.pipeline.forward(batch, fastvideo_args)
        if self.rank != 0:
            return None
        # the clip crosses as one contiguous uint8 tensor (a quarter of its
        # fp32; host tensors cross through shared memory, where pickling
        # the frames' strided views cost seconds), the caller takes the
        # frames as views of it
        video = video_uint8(batch.output)
        batch.output = None
        batch = to_host(batch)
        batch.extra["video_uint8"] = video
        batch.extra["worker_forward_s"] = time.perf_counter() - t0
        return batch

    def kernel_counts(self) -> tuple[dict, dict]:
        """The kernel wrappers' launch counts and plain calls here."""
        from fastvideo_tpu_torch.ops import _build

        return dict(_build.LAUNCHES), dict(_build.PLAIN_CALLS)

    def reset_kernel_counts(self) -> None:
        from fastvideo_tpu_torch.ops import _build

        _build.reset_counts()


def _worker_main(rank: int, world: int, init_method: str,
                 fastvideo_args: FastVideoArgs, conn) -> None:
    """A worker process: join the group, build the pipeline, answer calls
    until the executor sends None (or goes away)."""
    try:
        device = torch.device(fastvideo_args.device or "cuda")
        if device.type == "cuda":
            device = torch.device("cuda", rank % torch.cuda.device_count())
            torch.cuda.set_device(device)
        backend = backend_for(device)
        timeout = ({} if fastvideo_args.dist_timeout is None else
                   {"timeout": datetime.timedelta(
                       seconds=fastvideo_args.dist_timeout)})
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world, **timeout)
        joined_at = time.time()
        args = dataclasses.replace(fastvideo_args, device=str(device))
        worker = Worker(args, device, rank)
        conn.send(("ok", {"joined_at": joined_at, "ready_at": time.time()}))
    except Exception:
        conn.send(("error", traceback.format_exc()))
        return
    try:
        while True:
            msg = conn.recv()
            if msg is None:
                break
            method, args, kwargs = msg
            try:
                conn.send(("ok", worker.call(method, *args, **kwargs)))
            except Exception:
                conn.send(("error", traceback.format_exc()))
    except EOFError:  # the executor went away
        pass
    finally:
        worker.pipeline = None
        dist.destroy_process_group()


def _stop(procs: list, conns: list, store: str | None,
          grace_s: float) -> None:
    """Ask every worker to leave, stop those that do not, free the store."""
    for conn in conns:
        with contextlib.suppress(OSError, ValueError, BrokenPipeError):
            conn.send(None)
    deadline = time.monotonic() + grace_s
    for proc in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
    for proc in procs:
        if proc.is_alive():
            proc.terminate()
            proc.join(5.0)
        if proc.is_alive():
            proc.kill()
            proc.join()
    for conn in conns:
        conn.close()
    if store:
        shutil.rmtree(store, ignore_errors=True)


class MultiprocExecutor(Executor):
    """One spawned worker process a rank; this process keeps no pipeline."""

    def __init__(self, fastvideo_args: FastVideoArgs, device: torch.device,
                 pipeline=None):
        if pipeline is not None:
            raise ValueError("the workers build their own pipelines")
        self.fastvideo_args = fastvideo_args
        self.device = device
        self.pipeline = None
        self.world = fastvideo_args.num_gpus
        if device.type == "cuda" and self.world > torch.cuda.device_count():
            raise ValueError(
                f"num_gpus={self.world} but this machine has "
                f"{torch.cuda.device_count()} CUDA device(s)")
        backend_for(device)  # no NCCL on a CUDA run raises here
        self.timeout = fastvideo_args.dist_timeout
        self._store = tempfile.mkdtemp(prefix="fastvideo_dist_")
        init_method = f"file://{self._store}/store"
        ctx = torch_mp.get_context("spawn")
        args = dataclasses.replace(fastvideo_args, device=str(device))
        self._procs, self._conns = [], []
        spawned_at = time.time()
        for rank in range(self.world):
            parent, child = ctx.Pipe()
            proc = ctx.Process(target=_worker_main, daemon=True,
                               args=(rank, self.world, init_method, args,
                                     child), name=f"fastvideo-worker-{rank}")
            proc.start()
            child.close()
            self._procs.append(proc)
            self._conns.append(parent)
        self._finalizer = weakref.finalize(self, _stop, self._procs,
                                           self._conns, self._store, 0.0)
        ready = self._gather()
        self.startup = {
            "start_s": max(r["joined_at"] for r in ready) - spawned_at,
            "load_s": max(r["ready_at"] - r["joined_at"] for r in ready),
        }
        logger.info("%d worker(s) joined in %.1f s, built the pipeline in "
                    "%.1f s", self.world, self.startup["start_s"],
                    self.startup["load_s"])

    def _fail(self, message: str):
        self.shutdown(grace_s=0.0)
        raise RuntimeError(message)

    def _gather(self) -> list:
        """Each worker's reply to the last request, in rank order."""
        deadline = (None if self.timeout is None else
                    time.monotonic() + self.timeout)
        replies: list = [None] * self.world
        pending = set(range(self.world))
        while pending:
            wait_s = (None if deadline is None else
                      max(0.0, deadline - time.monotonic()))
            handles = ([self._conns[r] for r in pending] +
                       [self._procs[r].sentinel for r in pending])
            if not mp_connection.wait(handles, wait_s):
                self._fail(f"worker(s) {sorted(pending)} gave no answer "
                           f"within dist_timeout={self.timeout} s")
            for rank in sorted(pending):
                conn = self._conns[rank]
                if conn.poll():
                    try:
                        status, payload = conn.recv()
                    except EOFError:
                        status, payload = "died", None
                    if status == "error":
                        self._fail(f"worker {rank} raised:\n{payload}")
                    if status == "ok":
                        replies[rank] = payload
                        pending.discard(rank)
                        continue
                if not self._procs[rank].is_alive():
                    self._fail(f"worker {rank} died (exit code "
                               f"{self._procs[rank].exitcode})")
        return replies

    def collective_rpc(self, method, *args, **kwargs) -> list[Any]:
        """Send the call to every worker; each rank's result, in rank
        order. ``method`` names a pipeline or ``Worker`` method, or is a
        module-level function, called as ``method(worker, ...)``."""
        if not self._finalizer.alive:
            raise RuntimeError("the executor is shut down")
        for conn in self._conns:
            conn.send((method, args, kwargs))
        return self._gather()

    def execute_forward(self, batch: ForwardBatch,
                        fastvideo_args: FastVideoArgs) -> ForwardBatch:
        return self.collective_rpc("execute_forward", batch,
                                   fastvideo_args)[0]

    def set_lora_adapter(self, lora_nickname: str,
                         lora_path: str | None = None) -> None:
        self.collective_rpc("set_lora_adapter", lora_nickname, lora_path)

    def shutdown(self, grace_s: float = 30.0) -> None:
        """Stop every worker (joined, else terminated) and free the store."""
        if self._finalizer.detach() is not None:
            _stop(self._procs, self._conns, self._store, grace_s)

    @property
    def alive(self) -> list[bool]:
        return [p.is_alive() for p in self._procs]
