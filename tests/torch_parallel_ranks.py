"""Rank programs for the port's parallel tests, and the spawner that runs
them in gloo processes on the CPU.

Each program runs in every rank of a world of spawned processes (start
method ``spawn``: a child imports this module, which imports no JAX) that
meet through a file store under the test's temporary directory, so that
parallel test workers never share a TCP port. The programs take numpy
inputs (the JAX weights carried across by ``state_dict_from_jax``) and
return numpy outputs; the tests hold them against JAX in the pytest
process.
"""

from __future__ import annotations

import os
import pickle
import queue
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as torch_mp

SPAWN_TIMEOUT_S = 240


def start(fn, world: int, store: str, *args, init: bool = True,
          env: dict | None = None):
    """Start ``fn(rank, *args)`` in ``world`` processes (each in a gloo
    group of them when ``init``); ``collect`` gathers their results. Worlds
    started together import and run side by side."""
    # the program and its inputs go through a file: a process's arguments
    # are written to its pipe, which blocks ``start`` until the child has
    # started and read them, one child after another
    job = f"{store}.job"
    with open(job, "wb") as fh:
        pickle.dump((fn, args), fh)
    ctx = torch_mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_entry, daemon=True,
                         args=(job, rank, world, store, results, init,
                               env or {}))
             for rank in range(world)]
    for p in procs:
        p.start()
    return procs, results


def collect(started, timeout: float = SPAWN_TIMEOUT_S) -> list:
    """The results of a started world in rank order. A rank that raises
    fails the call with its traceback; one that gives no result within
    ``timeout`` fails it too. Every process is stopped before this
    returns."""
    procs, results = started
    world = len(procs)
    out: dict[int, object] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < world:
            try:
                rank, ok, payload = results.get(
                    timeout=max(0.1, deadline - time.monotonic()))
            except queue.Empty:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(out))}"
                                   f" gave no result in {timeout} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} raised:\n{payload}")
            out[rank] = payload
    finally:
        for p in procs:
            p.join(10 if len(out) == world else 0)
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world)]


def spawn(fn, world: int, store: str, *args, init: bool = True,
          env: dict | None = None, timeout: float = SPAWN_TIMEOUT_S) -> list:
    """``start`` then ``collect``."""
    return collect(start(fn, world, store, *args, init=init, env=env),
                   timeout)


def _entry(job, rank, world, store, results, init, env) -> None:
    os.environ.update(env)
    torch.set_num_threads(1)
    try:
        with open(job, "rb") as fh:
            fn, args = pickle.load(fh)
        if init:
            dist.init_process_group("gloo", init_method=f"file://{store}",
                                    rank=rank, world_size=world)
        results.put((rank, True, fn(rank, *args)))
    except Exception:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _tensors(d: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}


def _load_sharded(model, state: dict, mesh) -> None:
    """This rank's slice of the full state (``parallel.shard_state`` by the
    model's ``tp_axes``) into a model built under ``mesh``."""
    from fastvideo_tpu_torch.parallel.shard import (shard_state, tp_axes_of,
                                                    tp_segments_of)

    local = shard_state(_tensors(state), mesh, axes=tp_axes_of(model),
                        segments=tp_segments_of(model))
    model.load_state_dict(local, strict=True)


def wan_forwards(rank: int, cases: list[dict]) -> list[np.ndarray]:
    """The port's Wan DiT forward, once for each case: a layout (dp, sp,
    tp), an attention backend, VSA's sparsity, the arch fields, the full
    state dict and the inputs. Every rank returns the whole output."""
    from fastvideo_tpu_torch.attention.backends.abstract import (
        AttentionMetadata)
    from fastvideo_tpu_torch.configs.models.dits.wan import WanArchConfig
    from fastvideo_tpu_torch.forward_context import set_forward_context
    from fastvideo_tpu_torch.models.dits.wan import WanTransformer3DModel
    from fastvideo_tpu_torch.parallel import (MeshConfig, init_mesh,
                                              mesh_context)

    outs = []
    for case in cases:
        os.environ["FASTVIDEO_ATTENTION_BACKEND"] = case["backend"]
        mesh = init_mesh(MeshConfig(*case["layout"]))
        with mesh_context(mesh):
            model = WanTransformer3DModel(WanArchConfig(**case["arch"]),
                                          dtype=torch.float32)
            _load_sharded(model, case["state"], mesh)
            meta = AttentionMetadata(
                extra={"VSA_sparsity": case.get("sparsity", 0.0)})
            with set_forward_context(attn_metadata=meta), torch.no_grad():
                out = model(*(torch.from_numpy(case[k])
                              for k in ("x", "ctx", "ts")))
        outs.append(out.numpy())
    return outs


def tp_qk_norm(rank: int, x: np.ndarray, weight: np.ndarray) -> tuple:
    """The tp-sharded RMSNorm over all heads on this rank's features,
    beside the unsharded norm's same features."""
    from fastvideo_tpu_torch.layers.norm import RMSNorm
    from fastvideo_tpu_torch.parallel import (MeshConfig, init_mesh,
                                              mesh_context)
    from fastvideo_tpu_torch.parallel.ulysses import local_heads

    dim = x.shape[-1]
    whole = RMSNorm(dim, eps=1e-6)
    whole.weight.data = torch.from_numpy(weight)
    mesh = init_mesh(MeshConfig(1, 1, dist.get_world_size()))
    with mesh_context(mesh), torch.no_grad():
        norm = RMSNorm(dim, eps=1e-6, tp_sharded=True)
        norm.weight.data = local_heads(torch.from_numpy(weight), 0)
        xt = torch.from_numpy(x)
        got = norm(local_heads(xt, 2))
        want = local_heads(whole(xt), 2)
    return got.numpy(), want.numpy()


def t5_forward(rank: int, layout: tuple, arch: dict, state: dict,
               ids: np.ndarray, mask: np.ndarray,
               load: str = "shard_state") -> np.ndarray:
    """UMT5's last hidden state under ``layout``, its weights given to the
    rank by ``shard_state``, by the checkpoint loader (``load_weights``
    cuts each full tensor), or by the loader into int8 weight-only slots
    (the text encoder's quantize-at-load)."""
    from fastvideo_tpu_torch.configs.models.encoders.t5 import T5ArchConfig
    from fastvideo_tpu_torch.layers.quantization.int8 import (
        QuantizationConfig, quantize_model_linears)
    from fastvideo_tpu_torch.models.encoders.t5 import T5EncoderModel
    from fastvideo_tpu_torch.models.loader.weight_utils import load_weights
    from fastvideo_tpu_torch.parallel import (MeshConfig, init_mesh,
                                              mesh_context)

    mesh = init_mesh(MeshConfig(*layout))
    with mesh_context(mesh):
        if load == "shard_state":
            model = T5EncoderModel(T5ArchConfig(**arch), dtype=torch.float32)
            _load_sharded(model, state, mesh)
        else:
            model = T5EncoderModel(T5ArchConfig(**arch), device="meta",
                                   dtype=torch.float32)
            if load == "load_weights_int8":
                quantize_model_linears(model, QuantizationConfig(
                    method="int8_weight_only"), init_only=True)
            load_weights(model, _tensors(state).items(), device="cpu",
                         dtype=torch.float32)
        with torch.no_grad():
            out = model(torch.from_numpy(ids), torch.from_numpy(mask))
    return out.last_hidden_state.numpy()


def int8_linears(rank: int, x: np.ndarray, w: np.ndarray,
                 b: np.ndarray) -> dict:
    """W8A8 and weight-only ``Int8Linear`` from a column- and a
    row-parallel linear at tp = world, beside the unsplit layer's output,
    and each int8 layer's ``tp_axes``."""
    from fastvideo_tpu_torch.layers.linear import (ColumnParallelLinear,
                                                   Linear, RowParallelLinear)
    from fastvideo_tpu_torch.layers.quantization.int8 import Int8Linear
    from fastvideo_tpu_torch.parallel import (MeshConfig, init_mesh,
                                              mesh_context)
    from fastvideo_tpu_torch.parallel.ulysses import local_heads

    out_f, in_f = w.shape
    full = {"weight": torch.from_numpy(w), "bias": torch.from_numpy(b)}
    xt = torch.from_numpy(x)
    whole = Linear(in_f, out_f)
    whole.load_state_dict(full)
    mesh = init_mesh(MeshConfig(1, 1, dist.get_world_size()))
    got = {}
    with mesh_context(mesh), torch.no_grad():
        for cls, inp in ((ColumnParallelLinear, xt),
                         (RowParallelLinear, local_heads(xt, -1))):
            lin = cls(in_f, out_f)
            _load_sharded(lin, {k: v.numpy() for k, v in full.items()},
                          mesh)
            for weight_only in (False, True):
                want = Int8Linear.from_linear(whole, weight_only)(xt)
                q = Int8Linear.from_linear(lin, weight_only)
                got[(lin.tp_mode, weight_only)] = (
                    q(inp).numpy(), want.numpy(), dict(q.tp_axes))
    return got


def joint_forward(rank: int, q, k, v, rq, rk, rv, cos, sin,
                  backend: str) -> tuple[np.ndarray, np.ndarray]:
    """``DistributedAttention.joint_forward`` at sp = world: each rank
    passes its share of the (sp-padded) image tokens and the whole text,
    and returns its image rows and the whole text output."""
    from fastvideo_tpu_torch.attention.layer import DistributedAttention
    from fastvideo_tpu_torch.parallel import (MeshConfig, init_mesh,
                                              mesh_context, pad_rope_to,
                                              shard_seq)
    from fastvideo_tpu_torch.parallel.ulysses import sp_slice

    mesh = init_mesh(MeshConfig(1, dist.get_world_size(), 1))
    with mesh_context(mesh):
        attn = DistributedAttention(q.shape[2], q.shape[3],
                                    supported_backends=(backend,))
        (ql, orig), (kl, _), (vl, _) = (shard_seq(torch.from_numpy(t))
                                        for t in (q, k, v))
        padded = ql.shape[1] * dist.get_world_size()
        c, s = pad_rope_to(torch.from_numpy(cos), torch.from_numpy(sin),
                           padded)
        img, txt = attn.joint_forward(
            ql, kl, vl, *(torch.from_numpy(t) for t in (rq, rk, rv)),
            freqs_cis=(sp_slice(c, 0), sp_slice(s, 0)),
            kv_valid=orig if padded != orig else None)
    return img.numpy(), txt.numpy()


def tiled_decode(rank: int, arch: dict, state: dict, z: np.ndarray,
                 tile: tuple, stride: tuple) -> np.ndarray:
    """``parallel_tiled_decode`` over the world's ranks."""
    from fastvideo_tpu_torch.configs.models.vaes.wan import WanVAEArchConfig
    from fastvideo_tpu_torch.models.vaes.wan import AutoencoderKLWan
    from fastvideo_tpu_torch.parallel import (MeshConfig, init_mesh,
                                              mesh_context)

    mesh = init_mesh(MeshConfig(dist.get_world_size(), 1, 1))
    with mesh_context(mesh):
        vae = AutoencoderKLWan(WanVAEArchConfig(**arch), dtype=torch.float32)
        vae.load_state_dict(_tensors(state), strict=True)
        with torch.no_grad():
            out = vae.parallel_tiled_decode(
                torch.from_numpy(z), tile_latent_min=tile,
                tile_latent_stride=stride)
    return out.numpy()


def env_dp_group(rank: int, store: str) -> tuple:
    """Two processes joined from the environment alone, as a launcher
    sets it, then a dp = 2 mesh and a sum over dp."""
    from fastvideo_tpu_torch.parallel import (MeshConfig,
                                              maybe_init_distributed,
                                              maybe_init_mesh)
    from fastvideo_tpu_torch.parallel.collectives import all_reduce

    os.environ.update(FASTVIDEO_COORDINATOR_ADDRESS=f"file://{store}",
                      FASTVIDEO_NUM_PROCESSES="2",
                      FASTVIDEO_PROCESS_ID=str(rank))
    assert maybe_init_distributed(device="cpu")
    mesh = maybe_init_mesh(MeshConfig(dp_size=2), device="cpu")
    total = all_reduce(torch.full((4,), float(rank + 1)), "dp")
    return (dict(mesh.shape), mesh.coords["dp"], float(total.sum()),
            dist.get_backend())


def raise_on_rank(worker, bad_rank: int) -> int:
    """For the executor tests: rank ``bad_rank`` raises while the others
    wait in a collective for it (they would wait for ever)."""
    if worker.rank == bad_rank:
        raise ValueError(f"rank {bad_rank} fails on purpose")
    dist.barrier()
    return worker.rank


def exit_on_rank(worker, bad_rank: int) -> int:
    """For the executor tests: rank ``bad_rank`` dies with no reply."""
    if worker.rank == bad_rank:
        os._exit(3)
    dist.barrier()
    return worker.rank


def worker_mesh(worker) -> tuple:
    """The worker's mesh shape and place in it, and its pipeline's device."""
    mesh = worker.pipeline.mesh
    return dict(mesh.shape), dict(mesh.coords), str(worker.device)


def several(rank: int, calls: list) -> list:
    """Run several rank programs, ``(fn, args)`` each, in one world."""
    return [fn(rank, *args) for fn, args in calls]
