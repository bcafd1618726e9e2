"""The port's streaming long-tuning against the JAX package: the
multi-phase schedule parser and the stage selection on strings and dict
lists (and JAX's validation errors), the new-frame draw over 20 steps,
and three steps of ``StreamingLongTuningPipeline`` on the tiny causal Wan
of ``test_torch_self_forcing.py`` given JAX's draws: a plain
self-forcing stage's step, then the stream's first chunk (no student
update) and its second (a student update through both blocks' last
passes on the live caches, which evict)."""

import dataclasses
import os
import sys
import types

import jax
import numpy as np
import pytest
import torch

import fastvideo_tpu.parallel as par
from fastvideo_tpu.training import distillation_pipeline as jdp
from fastvideo_tpu.training import streaming_long_pipeline as jsl
from fastvideo_tpu_torch.entrypoints.cli.train import build_from_config
from fastvideo_tpu_torch.training import distillation_pipeline as tdp
from fastvideo_tpu_torch.training import streaming_long_pipeline as tsl
from fastvideo_tpu_torch.training.methods import NOT_PORTED, resolve_method
from fastvideo_tpu_torch.training.methods.distribution_matching import (
    StreamingLongTuningMethod)
from fastvideo_tpu_torch.training.run_config import load_train_config

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_dmd2 import _params  # noqa: E402
from test_torch_self_forcing import (EMBEDS, LATENT, STEPS,  # noqa: E402
                                     assert_params_close, causal_checkpoint,
                                     jax_args, jax_models, jax_rollout_draws,
                                     jax_step_draws, normal, roles_moved,
                                     torch_args, torch_model, train_config,
                                     write_shard)

torch.set_num_threads(2)

assert causal_checkpoint  # a fixture of this module too

SCHEDULES = [
    (None, dict(default_num_latent_t=8, default_streaming_chunk_size=4)),
    ("", dict(default_num_latent_t=8, default_streaming_max_length=12)),
    ("700:4,3000:16", dict(default_num_latent_t=4,
                           default_streaming_chunk_size=4)),
    ("0:5:4, 5:9:8 ,12:20:16", dict(default_num_latent_t=4,
                                    default_streaming_chunk_size=2)),
    ([{"stage": "self_forcing", "end_step": 10, "num_latent_t": 4},
      {"stage": "streaming_long", "streaming_max_length": 12,
       "streaming_chunk_size": 4, "streaming_min_new_frame": 2}],
     dict(default_num_latent_t=4)),
    ([{"name": "warm", "streaming_training": False, "end_step": 3},
      {"streaming_training": True, "start_step": 5, "end_step": 9,
       "max_length": 20, "streaming_fixed_overlap_latents": 1},
      {"stage": "long", "num_latent_t": 7}],
     dict(default_num_latent_t=6, default_streaming_chunk_size=4)),
    # JAX's validation errors
    ([{"stage": "streaming_long"}], dict(default_num_latent_t=4)),
    ("10:4,5:8", dict(default_num_latent_t=4,
                      default_streaming_chunk_size=4)),
    ("1:2:3:4", dict(default_num_latent_t=4)),
    ("5:0", dict(default_num_latent_t=4)),
    ([3], dict(default_num_latent_t=4)),
    ({"stage": "x"}, dict(default_num_latent_t=4)),
    ([], dict(default_num_latent_t=4)),
    ([{"streaming_training": True, "streaming_chunk_size": 4,
       "streaming_fixed_overlap_latents": 4}],
     dict(default_num_latent_t=4)),
    ([{"end_step": 4}, {"start_step": 4, "end_step": 4}],
     dict(default_num_latent_t=4)),
]


@pytest.mark.parametrize("i", range(len(SCHEDULES)))
def test_schedule_parser_and_stage_selection_match_jax(i):
    raw, kw = SCHEDULES[i]
    try:
        want = jsl.parse_multi_phased_distill_schedule(raw, **kw)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tsl.parse_multi_phased_distill_schedule(raw, **kw)
        assert str(got.value) == str(e)
        return
    got = tsl.parse_multi_phased_distill_schedule(raw, **kw)
    assert ([dataclasses.asdict(s) for s in got] ==
            [dataclasses.asdict(s) for s in want])
    for it in (0, 1, 3, 4, 5, 8, 9, 10, 12, 699, 700, 2999, 3000, 10**6):
        assert (got.index(tsl.select_distill_stage(got, it)) ==
                want.index(jsl.select_distill_stage(want, it)))


def _stub(module_cls, owner: str, seed: int, stage_chunk_default=None):
    """The attributes ``_select_new_frames`` reads, on a stand-in."""
    stub = types.SimpleNamespace(
        args=types.SimpleNamespace(seed=seed), step=0,
        default_chunk_size=stage_chunk_default)
    setattr(stub, owner, types.SimpleNamespace(
        config=types.SimpleNamespace(num_frames_per_block=2)))
    stub._stage_chunk = lambda st: module_cls._stage_chunk(stub, st)
    return stub


@pytest.mark.parametrize("overlap,min_new", [(None, None), (None, 4),
                                             (1, None)])
def test_select_new_frames_matches_jax(overlap, min_new):
    """20 steps of the new-frame draw (``default_rng(seed * 100003 +
    step)``), first chunks and later ones, at every remaining length."""
    stage = jsl.DistillStage(
        name="streaming_long", start_step=0, end_step=None, num_latent_t=24,
        streaming_training=True, streaming_chunk_size=8,
        streaming_max_length=24, streaming_min_new_frame=min_new,
        streaming_fixed_overlap_latents=overlap)
    tstage = tsl.DistillStage(**dataclasses.asdict(stage))
    jstub = _stub(jsl.StreamingLongTuningPipeline, "generator_model", 7)
    tstub = _stub(tsl.StreamingLongTuningPipeline, "generator", 7)
    for step in range(20):
        jstub.step = tstub.step = step
        for remaining in (2, 3, 5, 8, 24):
            for first in (True, False):
                want = jsl.StreamingLongTuningPipeline._select_new_frames(
                    jstub, stage, remaining, first)
                got = tsl.StreamingLongTuningPipeline._select_new_frames(
                    tstub, tstage, remaining, first)
                assert got == want, (step, remaining, first)


def jax_stream_draws(rng, shape):
    """JAX's draws of one stream step from the pipeline's key: the chunk's
    noise, then the step's three-way split (generator: rollout, timestep,
    noise; critic: timestep, noise)."""
    rng, k = jax.random.split(rng)
    out = {"noise": normal(k, shape)}
    _, k_gen, k_crit = jax.random.split(rng, 3)
    k_roll, k_t, k_n = jax.random.split(k_gen, 3)
    out["generator"] = tdp.UpdateDraws(
        jax_rollout_draws(k_roll, shape, STEPS),
        int(jax.random.randint(k_t, (1,), 0, 1000)[0]), normal(k_n, shape))
    k_t, k_n = jax.random.split(k_crit)
    out["critic"] = tdp.UpdateDraws(
        [], int(jax.random.randint(k_t, (1,), 0, 1000)[0]),
        normal(k_n, shape))
    return out


def test_three_steps_match_jax(monkeypatch):
    """Ratio 2 with a 1-step self-forcing stage, then a stream of at most
    8 latent frames in chunks of 4 (the window holds 4): step 0 is a
    self-forcing step with a generator update, step 1 the stream's first
    chunk (the critic only), step 2 its second chunk of JAX's drawn length
    (generator and critic). Each step's metrics equal JAX's (the stage,
    the stream's length and new frames), losses within 1e-2 relative, the
    generator's grad norm within 2e-2, and every parameter within the
    DMD2 test's bars."""
    par.destroy_mesh()
    stages = [{"stage": "self_forcing", "end_step": 1, "num_latent_t": 4},
              {"stage": "streaming_long", "start_step": 1,
               "streaming_max_length": 8, "streaming_chunk_size": 4}]
    jstages = jsl.parse_multi_phased_distill_schedule(
        stages, default_num_latent_t=4)
    tstages = tsl.parse_multi_phased_distill_schedule(
        stages, default_num_latent_t=4)
    jgen, jreal, jfake = jax_models()
    tgen, treal, tfake = (torch_model(m) for m in (jgen, jreal, jfake))
    starts = [{k: v.clone() for k, v in m.state_dict().items()}
              for m in (tgen, treal, tfake)]
    cfg = dict(dfake_gen_update_ratio=2)
    jpipe = jsl.StreamingLongTuningPipeline(
        jgen, jreal, jfake, jax_args(), jdp.DMDConfig(**cfg),
        denoise_steps=STEPS, stages=jstages)
    tpipe = tsl.StreamingLongTuningPipeline(
        tgen, treal, tfake, torch_args(), tdp.DMDConfig(**cfg),
        denoise_steps=STEPS, stages=tstages)
    monkeypatch.setattr(tpipe, "stream_draw",
                        lambda shape: jax_stream_draws(jpipe.rng, shape))
    rng = np.random.default_rng(5)
    embeds = rng.standard_normal(EMBEDS).astype(np.float32)
    neg = np.zeros_like(embeds)
    gen_updates = 0
    for step in range(3):
        if step == 0:
            _, draws, _ = jax_step_draws(jpipe.rng, True, LATENT, STEPS)
            monkeypatch.setattr(tpipe, "draw", lambda shape, g, d=draws: d)
        tout = tpipe.train_one_step(embeds, neg, LATENT)
        jout = jpipe.train_one_step(embeds, neg, LATENT)
        assert set(jout) <= set(tout)
        for name, want in jout.items():
            if name.endswith(("_loss", "_norm")):
                np.testing.assert_allclose(
                    tout[name], want, err_msg=name,
                    rtol=2e-2 if name.endswith("_norm") else 1e-2)
            else:
                assert tout[name] == want, name
        gen_updates += "generator_loss" in jout
        assert_params_close(dict(tgen.state_dict()),
                            _params(jpipe.gen_params), starts[0],
                            gen_updates)
        assert_params_close(dict(tfake.state_dict()),
                            _params(jpipe.fake_params), starts[2], step + 1)
    assert [gen_updates, tout["streaming_current_length"]] == [
        2, 4 + tout["streaming_new_frames"]]
    assert tpipe._stream.caches[0]["global_end"] == 16 * (
        tout["streaming_current_length"])
    for name, t in treal.state_dict().items():
        assert torch.equal(t, starts[1][name]), name
    par.destroy_mesh()


def test_build_from_config_trains_streaming_long_tuning(
        causal_checkpoint, tmp_path, monkeypatch):
    """``method: streaming_long_tuning`` with a streaming schedule from step
    0 on a Parquet shard: three steps of chunks of 2 frames up to 4, so
    the third starts a new stream; the generator and the fake score move,
    the teacher does not."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    cfg = load_train_config(train_config(
        tmp_path, "streaming_long_tuning", causal_checkpoint,
        write_shard(tmp_path),
        {"denoise_steps": [1000, 500], "streaming_chunk_size": 2,
         "streaming_max_length": 4}, steps=3))
    method, loader = build_from_config(cfg)
    assert isinstance(method, StreamingLongTuningMethod)
    assert "streaming_long_tuning" not in NOT_PORTED
    assert resolve_method("streaming_long_tuning") is StreamingLongTuningMethod
    pipe = method.pipeline
    assert [s.streaming_training for s in pipe.stages] == [True]
    before = [{n: p.detach().clone() for n, p in m.named_parameters()}
              for m in (pipe.generator, pipe.real_score, pipe.fake_score)]
    lengths = []
    record = pipe.tracker.log

    def log(metrics, step):
        lengths.append(metrics["streaming_current_length"])
        record(metrics, step)

    pipe.tracker.log = log
    try:
        method.train(loader)
    finally:
        loader.shutdown()
    assert lengths == [2, 4, 2]
    assert roles_moved(pipe, before) == [True, False, True]
