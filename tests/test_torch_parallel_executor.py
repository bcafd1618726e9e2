"""The serving path over several processes, and its refusals.

* A tiny FastWan generation (3 DMD steps, VSA on an exact-tile grid)
  through ``VideoGenerator.from_pretrained(..., device="cpu",
  num_gpus=2)``: two spawned gloo workers at sp 2 give the frames of
  ``num_gpus=1``, and latents within 5e-5 of the JAX package's at sp 2;
  the worker-process executor at one process gives the in-process frames.
* Two processes joined from the environment (``maybe_init_distributed``,
  after ``tests/distributed/test_multihost.py``) make a dp = 2 mesh.
* The refusals raise: more cards than the machine has, a CUDA run without
  NCCL (no fallback to gloo), a worker that raises while another waits in
  a collective, a worker that dies, and a head count sp * tp does not
  divide (as JAX raises); training on more than one card.
"""

import os
import sys
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import torch_parallel_ranks as ranks  # noqa: E402
from test_torch_jax_reference import jax_plain_attention  # noqa: E402,F401
from test_torch_wan_i2v import rbg_prng  # noqa: E402
from utils import make_tiny_wan_checkpoint  # noqa: E402

torch.set_num_threads(2)

TOL = 5e-5
GEN = dict(prompt="w1 w2 w3", height=64, width=64, num_frames=9, seed=11,
           save_video=False)
FP32 = dict(precision="fp32", vae_decode_precision="fp32",
            text_encoder_precisions=("fp32",))
CALL_TIMEOUT_S = 120


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("fastwan_parallel")
    mp = pytest.MonkeyPatch()
    mp.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    try:
        with rbg_prng():
            yield make_tiny_wan_checkpoint(
                str(root / "FastWan2.1-T2V-tiny-Diffusers"))
    finally:
        mp.undo()


@pytest.fixture
def workers_env(monkeypatch):
    """The workers inherit the backend, and one thread each."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


@pytest.fixture(scope="module")
def in_process(ckpt):
    """The one-process generation: the frames every layout must give."""
    from fastvideo_tpu_torch import VideoGenerator

    mp = pytest.MonkeyPatch()
    mp.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    try:
        gen = VideoGenerator.from_pretrained(ckpt, device="cpu",
                                             VSA_sparsity=0.5, **FP32)
        assert gen.executor.pipeline is gen.pipeline is not None
        return gen.generate_video(**GEN)
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def two_workers(ckpt):
    """``num_gpus=2`` on the CPU: two spawned workers, sp 2 by default."""
    from fastvideo_tpu_torch import VideoGenerator

    mp = pytest.MonkeyPatch()
    mp.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    mp.setenv("OMP_NUM_THREADS", "1")
    try:
        gen = VideoGenerator.from_pretrained(
            ckpt, device="cpu", num_gpus=2, VSA_sparsity=0.5,
            dist_timeout=CALL_TIMEOUT_S, **FP32)
    finally:
        mp.undo()
    yield gen
    gen.shutdown()


def test_two_workers_give_the_one_process_frames_and_jax_sp2_latents(
        ckpt, in_process, two_workers, jax_plain_attention, monkeypatch):
    import fastvideo_tpu.parallel as par
    from fastvideo_tpu import VideoGenerator as JaxGenerator

    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    gen = two_workers
    assert gen.pipeline is None and gen.executor.alive == [True, True]
    meshes = gen.executor.collective_rpc(ranks.worker_mesh)
    assert [m[0] for m in meshes] == [{"dp": 1, "sp": 2, "tp": 1}] * 2
    assert [m[1]["sp"] for m in meshes] == [0, 1]
    got = gen.generate_video(**GEN)
    assert got["forward_time"] < got["generation_time"]
    assert "DmdDenoisingStage" in got["stage_times"]
    f_got, f_one = got["frames"][0], in_process["frames"][0]
    assert f_got.shape == (9, 64, 64, 3) and f_got.dtype == np.uint8
    assert np.array_equal(f_got, f_one)

    par.destroy_mesh()
    try:
        with rbg_prng():
            jgen = JaxGenerator.from_pretrained(ckpt, num_gpus=2,
                                                VSA_sparsity=0.5, **FP32)
        assert jgen.fastvideo_args.sp_size == 2
        want = jgen.generate_video(**GEN)
    finally:
        par.destroy_mesh()
    lat_want = np.asarray(want["latents"], np.float32)
    assert got["latents"].shape == lat_want.shape == (1, 4, 5, 32, 32)
    assert np.abs(got["latents"].numpy() - lat_want).max() < TOL


def test_dp2_one_prompt_gives_the_one_process_frames(ckpt, in_process,
                                                     workers_env):
    """``num_gpus=2, dp_size=2``: at sp 1 each dp rank keeps the one
    prompt's batch whole, as JAX's ``shard_seq`` leaves it, and rank 0
    returns the one-process frames."""
    from fastvideo_tpu_torch import VideoGenerator

    gen = VideoGenerator.from_pretrained(
        ckpt, device="cpu", num_gpus=2, dp_size=2, VSA_sparsity=0.5,
        dist_timeout=CALL_TIMEOUT_S, **FP32)
    try:
        meshes = gen.executor.collective_rpc(ranks.worker_mesh)
        assert [m[0] for m in meshes] == [{"dp": 2, "sp": 1, "tp": 1}] * 2
        assert [m[1]["dp"] for m in meshes] == [0, 1]
        got = gen.generate_video(**GEN)
        assert np.array_equal(got["frames"][0], in_process["frames"][0])
    finally:
        gen.shutdown()


@pytest.mark.parametrize("layout,batch,pieces", [
    ((2, 1, 1), 2, [2, 2]),  # sp 1: whole, as in JAX
    ((2, 2, 1), 1, [1, 1, 1, 1]),  # dp does not divide 1: whole
    ((2, 2, 1), 2, [1, 1, 1, 1]),  # under sp: split over dp
], ids=["sp1", "indivisible", "split"])
def test_the_batch_splits_over_dp_only_under_sp_and_where_it_divides(
        layout, batch, pieces):
    from fastvideo_tpu_torch.parallel import mesh_context
    from fastvideo_tpu_torch.parallel.mesh import Mesh
    from fastvideo_tpu_torch.parallel.ulysses import shard_batch

    x = torch.arange(batch * 3.0).reshape(batch, 3)
    for rank, rows in enumerate(pieces):
        with mesh_context(Mesh(*layout, rank=rank)):
            got = shard_batch(x)
        start = 0 if rows == batch else (rank // layout[1]) * rows
        assert torch.equal(got, x[start:start + rows])


def test_a_worker_that_raises_stops_the_call_and_every_worker(two_workers):
    """Rank 1 raises while rank 0 waits for it in a collective, where it
    would wait for ever: the executor raises at once and stops both."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="worker 1 raised"):
        two_workers.executor.collective_rpc(ranks.raise_on_rank, 1)
    assert time.monotonic() - t0 < CALL_TIMEOUT_S
    assert two_workers.executor.alive == [False, False]
    with pytest.raises(RuntimeError, match="shut down"):
        two_workers.executor.collective_rpc("kernel_counts")


def test_one_worker_process_gives_the_in_process_frames_then_dies(
        ckpt, in_process, workers_env):
    """The worker-process executor at one process (the card's world-1
    path), built directly: the same frames as in-process, the worker's
    kernel counters through ``collective_rpc``; then the worker dies in a
    call and the executor raises instead of waiting."""
    from fastvideo_tpu_torch import VideoGenerator
    from fastvideo_tpu_torch.fastvideo_args import FastVideoArgs
    from fastvideo_tpu_torch.registry import get_pipeline_config_cls_for_name
    from fastvideo_tpu_torch.worker.executor import MultiprocExecutor

    args = FastVideoArgs.from_kwargs(model_path=ckpt, device="cpu",
                                     VSA_sparsity=0.5,
                                     dist_timeout=CALL_TIMEOUT_S)
    args.pipeline_config = get_pipeline_config_cls_for_name(ckpt)(
        model_path=ckpt, **FP32)
    dev = torch.device("cpu")
    gen = VideoGenerator(args, MultiprocExecutor(args, dev), dev)
    try:
        assert set(gen.executor.startup) == {"start_s", "load_s"}
        gen.executor.collective_rpc("reset_kernel_counts")
        got = gen.generate_video(**GEN)
        assert np.array_equal(got["frames"][0], in_process["frames"][0])
        [(launches, plain)] = gen.executor.collective_rpc("kernel_counts")
        assert not any(launches.values())  # the CPU runs plain versions
        assert plain["vsa_sparse_fwd"] > 0
        with pytest.raises(RuntimeError, match=r"worker 0 died \(exit code "
                           r"3\)"):
            gen.executor.collective_rpc(ranks.exit_on_rank, 0)
        assert gen.executor.alive == [False]
    finally:
        gen.shutdown()


def test_two_processes_join_from_the_environment(tmp_path):
    got = ranks.spawn(ranks.env_dp_group, 2, str(tmp_path / "unused"),
                      str(tmp_path / "store"), init=False)
    for rank, (shape, dp_index, total, backend) in enumerate(got):
        assert shape == {"dp": 2, "sp": 1, "tp": 1}
        assert dp_index == rank and backend == "gloo"
        assert total == 4 * (1 + 2)


def test_more_cards_than_the_machine_has_raise(ckpt, monkeypatch):
    from fastvideo_tpu_torch import VideoGenerator
    from fastvideo_tpu_torch.fastvideo_args import FastVideoArgs
    from fastvideo_tpu_torch.worker.executor import MultiprocExecutor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="num_gpus=2 but this machine has 1"):
        VideoGenerator.from_pretrained(ckpt, num_gpus=2)
    args = FastVideoArgs.from_kwargs(model_path=ckpt, num_gpus=2)
    with pytest.raises(ValueError, match="num_gpus=2 but this machine has 1"):
        MultiprocExecutor(args, torch.device("cuda", 0))


def test_a_cuda_run_without_nccl_raises(monkeypatch):
    """No fallback: a CUDA run needs NCCL, and this PyTorch has none."""
    import torch.distributed as dist

    from fastvideo_tpu_torch.parallel import maybe_init_distributed
    from fastvideo_tpu_torch.parallel.mesh import backend_for

    assert backend_for("cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        backend_for("cuda")
    with pytest.raises(RuntimeError, match="NCCL"):
        maybe_init_distributed("localhost:1", 2, 0, device="cuda")
    assert not dist.is_initialized()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        backend_for(None)


@pytest.mark.parametrize("layout,heads", [((1, 2, 1), 3), ((1, 2, 2), 6)])
def test_heads_that_sp_tp_do_not_divide_raise_as_in_jax(layout, heads):
    """3 heads over sp 2, and 6 (3 a tp rank) over sp 2 x tp 2: the port
    raises before any exchange, as JAX's ``ulysses_attention`` does."""
    import jax
    import jax.numpy as jnp

    import fastvideo_tpu.parallel as jpar
    from fastvideo_tpu_torch.parallel import mesh_context, ulysses_attention
    from fastvideo_tpu_torch.parallel.mesh import Mesh

    dp, sp, tp = layout
    match = rf"num_heads={heads} must be divisible by sp\*tp={sp * tp}"
    q = torch.zeros(1, 4, heads // tp, 8)
    with mesh_context(Mesh(*layout, rank=0)):
        with pytest.raises(ValueError, match=match):
            ulysses_attention(lambda *a: a[0], q, q, q)
    jpar.destroy_mesh()
    mesh = jpar.init_mesh(jpar.MeshConfig(*layout),
                          devices=jax.devices()[:dp * sp * tp])
    try:
        with jpar.mesh_context(mesh), pytest.raises(ValueError, match=match):
            jq = jnp.zeros((1, 4, heads, 8))
            jpar.ulysses_attention(lambda *a: a[0], jq, jq, jq)
    finally:
        jpar.destroy_mesh()


@pytest.mark.parametrize("kwargs", [
    dict(num_gpus=4), dict(num_gpus=4, tp_size=2), dict(num_gpus=8,
                                                        sp_size=2,
                                                        tp_size=2),
    dict(num_gpus=2, dp_size=2), dict(num_gpus=1)])
def test_mesh_config_follows_jax(kwargs):
    """num_gpus defines the world and sp fills it, as in JAX."""
    from fastvideo_tpu.fastvideo_args import FastVideoArgs as JaxArgs
    from fastvideo_tpu_torch.fastvideo_args import FastVideoArgs

    got = FastVideoArgs.from_kwargs(**kwargs)
    want = JaxArgs.from_kwargs(**kwargs)
    assert (got.sp_size, got.tp_size, got.dp_size) == (
        want.sp_size, want.tp_size, want.dp_size)
    assert got.mesh_config().resolve(got.num_gpus) == \
        want.mesh_config().resolve(want.num_gpus)


def test_layouts_that_leave_a_card_out_and_training_refuse():
    from fastvideo_tpu_torch.fastvideo_args import (FastVideoArgs,
                                                    TrainingArgs)

    with pytest.raises(ValueError, match="must equal num_gpus=4"):
        FastVideoArgs.from_kwargs(num_gpus=4, sp_size=2, dp_size=1)
    with pytest.raises(NotImplementedError, match="training half"):
        TrainingArgs(num_gpus=2)
    with pytest.raises(NotImplementedError, match="training half"):
        TrainingArgs(dp_size=2)


@pytest.mark.parametrize("kwargs,env,multiproc", [
    (dict(num_gpus=1), {}, False),
    (dict(num_gpus=2), {}, True),
    (dict(num_gpus=2, dp_size=2), {}, True),
    (dict(num_gpus=2), {"WORLD_SIZE": "2", "RANK": "0"}, False),
    (dict(num_gpus=2), {"FASTVIDEO_COORDINATOR_ADDRESS": "localhost:1"},
     False),
], ids=["one_card", "two_cards", "two_cards_dp", "torchrun", "coordinator"])
def test_executor_class(kwargs, env, multiproc, monkeypatch):
    """Worker processes for more than one card; in process where a
    launcher started this process as one rank of its world."""
    from fastvideo_tpu_torch.fastvideo_args import FastVideoArgs
    from fastvideo_tpu_torch.worker.executor import (Executor,
                                                     MultiprocExecutor)

    for key in ("WORLD_SIZE", "RANK", "FASTVIDEO_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    cls = Executor.get_class(FastVideoArgs.from_kwargs(**kwargs))
    assert cls is (MultiprocExecutor if multiproc else Executor)


def test_validation_dataset_takes_its_dp_share_from_the_mesh(tmp_path):
    """Each rank reads its dp group's share (padded cyclically to an equal
    share); with no mesh, all of it."""
    import json

    from fastvideo_tpu_torch.dataset.validation import ValidationDataset
    from fastvideo_tpu_torch.parallel import mesh_context
    from fastvideo_tpu_torch.parallel.mesh import Mesh

    path = tmp_path / "val.jsonl"
    path.write_text("".join(json.dumps({"caption": f"c{i}"}) + "\n"
                            for i in range(3)))
    assert [s["caption"] for s in ValidationDataset(str(path))] == [
        "c0", "c1", "c2"]
    shares = []
    for rank in range(4):  # (dp, sp) = (2, 2): ranks 0, 1 and 2, 3
        with mesh_context(Mesh(2, 2, 1, rank=rank)):
            ds = ValidationDataset(str(path))
        assert (ds.num_dp_groups, ds.dp_group_id) == (2, rank // 2)
        shares.append([s["caption"] for s in ds])
    assert shares == [["c0", "c1"], ["c0", "c1"], ["c2", "c0"],
                      ["c2", "c0"]]
