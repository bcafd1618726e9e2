"""The device mesh on torch.distributed (port of
fastvideo_tpu/parallel/mesh.py).

JAX drives every chip from one controller over one ``jax.sharding.Mesh``
whose axes (dp, sp, tp) GSPMD reads. PyTorch runs one process per card, so
the port's mesh is this process's place in the same (dp, sp, tp) layout and
one process group per axis, over which the layers call their collectives
themselves. The ranks are laid out as JAX lays out its devices:
``arange(dp * sp * tp).reshape(dp, sp, tp)``, so tp varies fastest over the
ranks, then sp, and dp is outermost (it may span hosts).

The collectives go through NCCL on the card and through gloo on the CPU,
as the device asks; a CUDA run that cannot make its NCCL group raises, it
never drops to gloo.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

DP_AXIS = "dp"
SP_AXIS = "sp"
TP_AXIS = "tp"

AXIS_ORDER = (DP_AXIS, SP_AXIS, TP_AXIS)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Parallel layout. -1 on dp means "use all remaining devices"."""

    dp_size: int = -1
    sp_size: int = 1
    tp_size: int = 1

    def resolve(self, num_devices: int) -> tuple[int, int, int]:
        sp, tp = self.sp_size, self.tp_size
        dp = self.dp_size
        if dp == -1:
            if num_devices % (sp * tp) != 0:
                raise ValueError(
                    f"num_devices={num_devices} not divisible by "
                    f"sp*tp={sp * tp}")
            dp = num_devices // (sp * tp)
        if dp * sp * tp > num_devices:
            raise ValueError(
                f"dp*sp*tp={dp * sp * tp} > num_devices={num_devices}")
        return dp, sp, tp


class Mesh:
    """This process's place in the (dp, sp, tp) layout of the world.

    ``shape`` maps each axis to its size and ``coords`` to this rank's
    index on it (``jax.lax.axis_index``); ``groups`` holds the process
    group of the ranks that differ from this one on that axis alone (None
    where the axis has size 1), ``world_group`` the group of every rank
    (None at world size 1)."""

    def __init__(self, dp: int, sp: int, tp: int, rank: int = 0,
                 groups: dict | None = None, world_group=None):
        self.ranks = np.arange(dp * sp * tp).reshape(dp, sp, tp)
        self.shape = {DP_AXIS: dp, SP_AXIS: sp, TP_AXIS: tp}
        self.size = dp * sp * tp
        self.rank = rank
        where = np.argwhere(self.ranks == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is outside a mesh of {self.size}")
        self.coords = dict(zip(AXIS_ORDER, (int(i) for i in where[0])))
        self.groups = groups or {axis: None for axis in AXIS_ORDER}
        self.world_group = world_group

    def __repr__(self) -> str:
        return (f"Mesh(dp={self.shape[DP_AXIS]}, sp={self.shape[SP_AXIS]}, "
                f"tp={self.shape[TP_AXIS]}, rank={self.rank})")


class _MeshState:
    mesh: Mesh | None = None


_STATE = _MeshState()


def _axis_groups(ranks: np.ndarray, rank: int) -> dict:
    """One ``new_group`` for each line of ranks along each axis of size >
    1. Every rank makes every group, in the same order (torch.distributed's
    rule); each keeps the groups it belongs to."""
    groups = {}
    for i, axis in enumerate(AXIS_ORDER):
        n = ranks.shape[i]
        groups[axis] = None
        if n == 1:
            continue
        for line in np.moveaxis(ranks, i, -1).reshape(-1, n):
            group = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = group
    return groups


def init_mesh(mesh_config: MeshConfig | None = None) -> Mesh:
    """Create and install the global mesh over every process of the
    default process group (or over this process alone when there is
    none). The mesh must hold every process: a process outside it would
    have no share of the work."""
    mesh_config = mesh_config or MeshConfig()
    world = dist.get_world_size() if dist.is_initialized() else 1
    dp, sp, tp = mesh_config.resolve(world)
    if dp * sp * tp != world:
        raise ValueError(f"dp*sp*tp={dp * sp * tp} must equal the world "
                         f"size {world}: every process takes a place in the "
                         "mesh")
    rank = dist.get_rank() if dist.is_initialized() else 0
    ranks = np.arange(world).reshape(dp, sp, tp)
    groups = _axis_groups(ranks, rank) if world > 1 else None
    mesh = Mesh(dp, sp, tp, rank, groups,
                dist.group.WORLD if world > 1 else None)
    _STATE.mesh = mesh
    logger.info("Initialized mesh dp=%d sp=%d tp=%d over %d processes", dp,
                sp, tp, world)
    return mesh


def backend_for(device: str | torch.device | None) -> str:
    """The collectives' backend for a device: NCCL on the card, gloo on
    the CPU. ``None`` means the card; a CUDA run without CUDA or without
    NCCL raises (no fallback to gloo or to the CPU)."""
    dev = torch.device(device) if device is not None else torch.device("cuda")
    if dev.type == "cpu":
        return "gloo"
    if dev.type != "cuda":
        raise ValueError(f"no process-group backend for device {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA run needs a CUDA device: pass "
                           "device=\"cpu\" to run on the CPU")
    if not dist.is_nccl_available():
        raise RuntimeError("a CUDA run needs NCCL, and this PyTorch has "
                           "none: the port does not drop to gloo")
    return "nccl"


def init_method_of(address: str) -> str:
    """A coordinator address as an ``init_method``: ``host:port`` is a TCP
    rendezvous, a URL (``tcp://``, ``file://``, ``env://``) is kept."""
    return address if "://" in address else f"tcp://{address}"


def maybe_init_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None, *,
                           device: str | torch.device | None = None,
                           timeout_s: float | None = None) -> bool:
    """Multi-process runtime init (``init_process_group``).

    Reads ``FASTVIDEO_COORDINATOR_ADDRESS`` / ``FASTVIDEO_NUM_PROCESSES``
    / ``FASTVIDEO_PROCESS_ID`` when the arguments are omitted, as the JAX
    package does, and else torchrun's ``RANK`` / ``WORLD_SIZE`` (with its
    ``MASTER_ADDR`` / ``MASTER_PORT`` rendezvous). On the card each process
    takes ``cuda:LOCAL_RANK`` (``LOCAL_RANK`` from torchrun, else the
    process id modulo the node's cards) and an NCCL group; with
    ``device="cpu"`` a gloo group. No-op (returns False) for a
    single-process run; True when the default group exists."""
    if dist.is_initialized():
        return True
    env = os.environ
    init_method = None
    if coordinator_address or env.get("FASTVIDEO_COORDINATOR_ADDRESS"):
        init_method = init_method_of(coordinator_address or
                                     env["FASTVIDEO_COORDINATOR_ADDRESS"])
        if num_processes is None:
            num_processes = int(env.get("FASTVIDEO_NUM_PROCESSES", "1"))
        if process_id is None:
            process_id = int(env.get("FASTVIDEO_PROCESS_ID", "0"))
    elif "RANK" in env and "WORLD_SIZE" in env:
        init_method = "env://"
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env["RANK"])
    if init_method is None or (num_processes or 1) <= 1:
        return False
    backend = backend_for(device)
    if backend == "nccl":
        local = int(env.get("LOCAL_RANK",
                            process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    kwargs = {}
    if timeout_s is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            **kwargs)
    logger.info("torch.distributed initialized: process %d/%d via %s (%s)",
                process_id, num_processes, init_method, backend)
    return True


def maybe_init_mesh(mesh_config: MeshConfig | None = None, *,
                    device: str | torch.device | None = None) -> Mesh:
    if _STATE.mesh is None:
        maybe_init_distributed(device=device)
        return init_mesh(mesh_config)
    return _STATE.mesh


def get_mesh() -> Mesh:
    if _STATE.mesh is None:
        raise RuntimeError("Mesh not initialized; call init_mesh() first "
                           "(the pipeline does this when it is built).")
    return _STATE.mesh


def current_mesh() -> Mesh | None:
    """The installed mesh, or None."""
    return _STATE.mesh


def destroy_mesh() -> None:
    _STATE.mesh = None


@contextlib.contextmanager
def mesh_context(mesh: Mesh):
    """Temporarily install ``mesh`` as the global mesh."""
    prev = _STATE.mesh
    _STATE.mesh = mesh
    try:
        yield mesh
    finally:
        _STATE.mesh = prev


def get_dp_size() -> int:
    return get_mesh().shape[DP_AXIS]


def get_sp_size() -> int:
    mesh = _STATE.mesh
    return 1 if mesh is None else mesh.shape[SP_AXIS]


def get_tp_size() -> int:
    mesh = _STATE.mesh
    return 1 if mesh is None else mesh.shape[TP_AXIS]


def axis_size(axis: str) -> int:
    mesh = _STATE.mesh
    return 1 if mesh is None else mesh.shape[axis]


def axis_index(axis: str) -> int:
    """This rank's index on ``axis`` (0 with no mesh)."""
    mesh = _STATE.mesh
    return 0 if mesh is None else mesh.coords[axis]


def axis_group(axis: str):
    """The process group along ``axis``; raises where the axis has more
    than one rank and no mesh holds its group."""
    mesh = get_mesh()
    group = mesh.groups[axis]
    if group is None and mesh.shape[axis] > 1:
        raise RuntimeError(f"the mesh has no {axis} group")
    return group
