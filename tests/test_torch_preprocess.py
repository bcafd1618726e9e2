"""The port's three preprocess pipelines (T2V, I2V, ODE trajectories)
against the JAX package's on the CPU, on tiny components with the same
numpy-seeded weights, and their shards read across: the port's shards
through the JAX package's pyarrow readers and the JAX shards through the
port's readers, column for column.

Tolerances: ids, captions, shapes, dtypes, widths, heights, frame counts,
fps, durations and timesteps are equal. VAE latents, text embeddings and
CLIP features within 1e-5 of the JAX values relative to their largest
magnitude (fp32 on both sides, summed in another order). ODE
trajectories: the port's sampler driving the JAX DiT within 1e-5 of JAX's
sampler (the same bf16 DiT function; the guidance combine and the steps
in fp32 on both sides); driving the port's DiT, within 4e-2: each DiT pass
is bf16, as in JAX, and the two DiTs round their bf16 intermediates at
other places, so one pass's velocities differ by up to about two bf16
ulps (2**-7 relative); guidance at 6 scales the branches' difference by 6
and four steps carry it (2.5e-2 measured).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pyarrow.parquet as pq
import pytest
import torch
from flax import nnx
from transformers import AutoTokenizer

from fastvideo_tpu.configs.models.dits.wan import WanArchConfig
from fastvideo_tpu.configs.models.encoders.clip import (
    CLIPVisionArchConfig as JVisionArch)
from fastvideo_tpu.configs.models.encoders.t5 import T5ArchConfig
from fastvideo_tpu.configs.models.vaes.wan import WanVAEArchConfig
from fastvideo_tpu.dataset import parquet as jparquet
from fastvideo_tpu.models.dits.wan import WanTransformer3DModel
from fastvideo_tpu.models.encoders import clip as jclip
from fastvideo_tpu.models.encoders.t5 import T5EncoderModel
from fastvideo_tpu.models.loader.export import make_word_level_tokenizer
from fastvideo_tpu.models.vaes.wan import AutoencoderKLWan
from fastvideo_tpu.pipelines.preprocess import preprocess_pipeline as jpp
from fastvideo_tpu.pipelines.preprocess import (
    preprocess_pipeline_i2v as jpp_i2v)
from fastvideo_tpu.pipelines.preprocess import (
    preprocess_pipeline_ode as jpp_ode)
from fastvideo_tpu_torch.configs.models.dits.wan import (
    WanArchConfig as TWanArchConfig)
from fastvideo_tpu_torch.configs.models.encoders.clip import (
    CLIPVisionArchConfig)
from fastvideo_tpu_torch.configs.models.encoders.t5 import (
    T5ArchConfig as TT5ArchConfig)
from fastvideo_tpu_torch.configs.models.vaes.wan import (
    WanVAEArchConfig as TWanVAEArchConfig)
from fastvideo_tpu_torch.dataset import parquet as tparquet
from fastvideo_tpu_torch.dataset import parquet_io
from fastvideo_tpu_torch.models.dits.wan import (
    WanTransformer3DModel as TWanTransformer3DModel)
from fastvideo_tpu_torch.models.encoders import clip as tclip
from fastvideo_tpu_torch.models.encoders.t5 import (
    T5EncoderModel as TT5EncoderModel)
from fastvideo_tpu_torch.models.loader.jax_params import state_dict_from_jax
from fastvideo_tpu_torch.models.loader.tokenizer import load_tokenizer
from fastvideo_tpu_torch.models.vaes.wan import (
    AutoencoderKLWan as TAutoencoderKLWan)
from fastvideo_tpu_torch.pipelines.preprocess import (
    preprocess_pipeline as tpp)
from fastvideo_tpu_torch.pipelines.preprocess import (
    preprocess_pipeline_i2v as tpp_i2v)
from fastvideo_tpu_torch.pipelines.preprocess import (
    preprocess_pipeline_ode as tpp_ode)

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_jax_reference import jax_plain_attention  # noqa: E402,F401
from test_torch_wan_dit import jax_params, numpy_model  # noqa: E402
from utils import TINY_DIT, TINY_T5, TINY_VAE  # noqa: E402

torch.set_num_threads(2)

TEXT_LEN = 16
VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=4, image_size=28, patch_size=14,
              num_channels=3, hidden_act="quick_gelu", layer_norm_eps=1e-5)
ODE_DIT = dict(TINY_DIT, in_channels=4, out_channels=4)
ODE_TOL = {"jax_dit": 1e-5, "port_dit": 4e-2}


def _arch(cls, cfg, **kw):
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in cfg.items()}, **kw)


def _pair(jbuild, tmodel, seed):
    jmodel = numpy_model(jbuild, seed=seed)
    tmodel.load_state_dict(state_dict_from_jax(jax_params(jmodel)),
                           strict=True)
    return jmodel, tmodel.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def parts(tmp_path_factory):
    t5 = {k: v for k, v in TINY_T5.items() if k != "model_type"}
    vae = _pair(lambda: AutoencoderKLWan(
        _arch(WanVAEArchConfig, TINY_VAE), param_dtype=jnp.float32,
        rngs=nnx.Rngs(0)), TAutoencoderKLWan(
        _arch(TWanVAEArchConfig, TINY_VAE), dtype=torch.float32), seed=1)
    enc = _pair(lambda: T5EncoderModel(
        T5ArchConfig(**t5, is_umt5=True), param_dtype=jnp.float32,
        rngs=nnx.Rngs(1)), TT5EncoderModel(
        TT5ArchConfig(**t5, is_umt5=True), dtype=torch.float32), seed=2)
    clip = _pair(lambda: jclip.CLIPVisionModel(
        JVisionArch(**VISION), param_dtype=jnp.float32, rngs=nnx.Rngs(0)),
        tclip.CLIPVisionModel(CLIPVisionArchConfig(**VISION),
                              dtype=torch.float32), seed=3)
    tok_dir = str(tmp_path_factory.mktemp("tok"))
    make_word_level_tokenizer(tok_dir, TINY_T5["vocab_size"])
    tok = (AutoTokenizer.from_pretrained(tok_dir), load_tokenizer(tok_dir))
    return dict(vae=vae, enc=enc, clip=clip, tok=tok)


def _samples(n, frames=5, size=16, seed=0):
    rng = np.random.default_rng(seed)
    return [{"id": f"clip{i}", "caption": f"w{i} w{i + 1} w{i + 7}",
             "frames": rng.integers(0, 256, (frames, size, size + 4, 3),
                                    dtype=np.uint8)} for i in range(n)]


def _files(path):
    return sorted(f for f in os.listdir(path) if f.endswith(".parquet"))


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max abs err {err:.3e}, scale {scale:.3e}"


def _compare_shards(port_dir, jax_dir, schema, tensors, rel):
    """Every shard of both directories, each read by the other package's
    reader: the same files, rows and columns; tensor columns within
    ``rel``, every other column equal."""
    assert _files(port_dir) == _files(jax_dir)
    for name in _files(jax_dir):
        mine = pq.read_table(os.path.join(port_dir, name)).to_pydict()
        theirs = parquet_io.read_table(os.path.join(jax_dir, name))
        assert list(mine) == list(theirs) == [c for c, _ in schema]
        meta = pq.ParquetFile(os.path.join(port_dir, name)).schema_arrow
        assert meta == pq.ParquetFile(os.path.join(jax_dir, name)).schema_arrow
        for col in mine:
            if col in tensors:
                for m, t, mr, tr in zip(mine[col], theirs[col],
                                        _rows(mine, col), _rows(theirs, col)):
                    _close(jparquet._decode_field(mr, col),
                           tparquet._decode_field(tr, col), rel[col])
            else:
                assert mine[col] == theirs[col], col


def _rows(table, col):
    n = len(table[col])
    return [{k: table[k][i] for k in (col, f"{col}_shape", f"{col}_dtype")}
            for i in range(n)]


def test_t2v_shards_match_jax(parts, tmp_path, jax_plain_attention):
    (jvae, tvae), (jenc, tenc) = parts["vae"], parts["enc"]
    jtok, ttok = parts["tok"]
    samples = _samples(3)
    jpipe = jpp.PreprocessPipeline(jvae, jenc, jtok, text_len=TEXT_LEN,
                                   samples_per_file=2)
    tpipe = tpp.PreprocessPipeline(tvae, tenc, ttok, text_len=TEXT_LEN,
                                   samples_per_file=2)
    assert jpipe.run(samples, str(tmp_path / "jax"), fps=8.0) == 3
    assert tpipe.run(samples, str(tmp_path / "port"), fps=8.0) == 3
    assert _files(str(tmp_path / "port")) == ["data_00000.parquet",
                                              "data_00001.parquet"]
    _compare_shards(str(tmp_path / "port"), str(tmp_path / "jax"),
                    tparquet.SCHEMA_T2V, ("latents", "text_embedding"),
                    {"latents": 1e-5, "text_embedding": 1e-5})
    assert tpipe.stats["samples"] == 3 and tpipe.stats["bytes"] == sum(
        os.path.getsize(tmp_path / "port" / f)
        for f in _files(str(tmp_path / "port")))
    # a second run numbers its shards after the first's
    tpipe.run(samples[:1], str(tmp_path / "port"), fps=8.0)
    assert _files(str(tmp_path / "port"))[-1] == "data_00002.parquet"
    # each package's latents dataset reads the other's shards
    jds = jparquet.LatentsParquetMapStyleDataset(str(tmp_path / "port"))
    tds = tparquet.LatentsParquetMapStyleDataset(str(tmp_path / "jax"))
    assert len(jds) == 4 and len(tds) == 3
    lat, txt = tds[1]
    assert lat.shape == (4, 3, 8, 10) and txt.shape == (TEXT_LEN, 32)
    np.testing.assert_array_equal(jds[3][0], jds[0][0])


def test_text_padding_is_zero(parts):
    (_, tenc), (_, ttok) = parts["enc"], parts["tok"]
    emb = tpp.PreprocessPipeline(None, tenc, ttok,
                                 text_len=TEXT_LEN).encode_text("w1 w2")
    n = int(ttok(["w1 w2"], padding="max_length", max_length=TEXT_LEN,
                 truncation=True, return_tensors="np")[
        "attention_mask"].sum())
    assert emb.shape == (TEXT_LEN, 32) and 0 < n < TEXT_LEN
    assert np.abs(emb[:n]).min() > 0 and not emb[n:].any()


def test_i2v_shards_match_jax(parts, tmp_path, jax_plain_attention):
    (jvae, tvae), (jenc, tenc) = parts["vae"], parts["enc"]
    jclip_model, tclip_model = parts["clip"]
    jtok, ttok = parts["tok"]
    samples = _samples(2, seed=1)
    kw = dict(text_len=TEXT_LEN, samples_per_file=2)
    jpp_i2v.PreprocessPipelineI2V(jvae, jenc, jtok, image_encoder=jclip_model,
                                  **kw).run(samples, str(tmp_path / "jax"))
    tpipe = tpp_i2v.PreprocessPipelineI2V(tvae, tenc, ttok,
                                          image_encoder=tclip_model, **kw)
    tpipe.run(samples, str(tmp_path / "port"))
    tensors = ("latents", "text_embedding", "clip_feature",
               "first_frame_latent")
    _compare_shards(str(tmp_path / "port"), str(tmp_path / "jax"),
                    tparquet.SCHEMA_I2V, tensors, dict.fromkeys(tensors,
                                                                1e-5))
    tds = tparquet.LatentsParquetMapStyleDataset(
        str(tmp_path / "jax"), extra_columns=("clip_feature",
                                              "first_frame_latent"))
    _, _, extras = tds[0]
    assert extras["clip_feature"].shape == (5, 32)
    assert extras["first_frame_latent"].shape == (4, 1, 8, 10)
    # without an image encoder the column holds zeros [1, 1]
    none = tpp_i2v.PreprocessPipelineI2V(tvae, tenc, ttok, **kw)
    feat = none.encode_first_frame_clip(samples[0]["frames"][0])
    assert feat.shape == (1, 1) and not feat.any()


@pytest.fixture(scope="module")
def ode_dits():
    prev = os.environ.get("FASTVIDEO_ATTENTION_BACKEND")
    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = "FLASH_ATTN"
    try:
        return _pair(lambda: WanTransformer3DModel(
            _arch(WanArchConfig, ODE_DIT), param_dtype=jnp.float32,
            rngs=nnx.Rngs(0)), TWanTransformer3DModel(
            _arch(TWanArchConfig, ODE_DIT), dtype=torch.float32), seed=4)
    finally:
        if prev is None:
            os.environ.pop("FASTVIDEO_ATTENTION_BACKEND")
        else:
            os.environ["FASTVIDEO_ATTENTION_BACKEND"] = prev


class JaxDiT(torch.nn.Module):
    """The JAX DiT behind the port's call signature, so that the port's
    sampler and JAX's run the same DiT function."""

    def __init__(self, jdit):
        super().__init__()
        self.jdit = nnx.jit(lambda m, x, c, t: m(x, c, t).astype(
            jnp.float32))
        self.model = jdit
        self.anchor = torch.nn.Parameter(torch.zeros(1))

    def forward(self, x, ctx, t):
        def j(v):
            return jnp.asarray(v.float().numpy()).astype(
                jnp.bfloat16 if v.dtype == torch.bfloat16 else jnp.float32)

        return torch.from_numpy(np.asarray(self.jdit(
            self.model, j(x), j(ctx), j(t))))


@pytest.mark.parametrize("guidance", [1.0, 6.0], ids=["no_cfg", "cfg"])
@pytest.mark.parametrize("dit", ["jax_dit", "port_dit"])
def test_ode_shards_match_jax(parts, ode_dits, guidance, dit, tmp_path,
                              jax_plain_attention):
    (jvae, tvae), (jenc, tenc) = parts["vae"], parts["enc"]
    jtok, ttok = parts["tok"]
    jdit, tdit = ode_dits
    if dit == "jax_dit":
        tdit = JaxDiT(jdit)
    kw = dict(num_inference_steps=4, guidance_scale=guidance,
              negative_prompt="w9 w10", latent_shape=(4, 2, 8, 8),
              text_len=TEXT_LEN, samples_per_file=2, seed=5)
    prompts = [{"id": "a", "caption": "w1 w2"}, {"id": "b", "caption": " "},
               {"id": "c", "caption": "w3"}, {"id": "d", "caption": "w4 w5"}]
    assert jpp_ode.PreprocessPipelineODE(jvae, jenc, jtok, jdit, **kw).run(
        prompts, str(tmp_path / "jax")) == 3
    tpipe = tpp_ode.PreprocessPipelineODE(tvae, tenc, ttok, tdit, **kw)
    assert tpipe.run(prompts, str(tmp_path / "port")) == 3
    assert tpipe.stats["steps"] == 12
    _compare_shards(str(tmp_path / "port"), str(tmp_path / "jax"),
                    tparquet.SCHEMA_ODE, ("text_embedding",
                                          "trajectory_latents",
                                          "trajectory_timesteps"),
                    {"text_embedding": 1e-5,
                     "trajectory_latents": ODE_TOL[dit],
                     "trajectory_timesteps": 0.0})


def test_ode_reader_and_loader_match_jax(parts, ode_dits, tmp_path):
    """The ODE dataset and loader over shards the port writes: the port's
    and the JAX package's give the same items and the same batches over
    two epochs (and past them)."""
    (_, tvae), (_, tenc), (_, ttok) = parts["vae"], parts["enc"], \
        parts["tok"]
    _, tdit = ode_dits
    out = str(tmp_path / "ode")
    tpp_ode.PreprocessPipelineODE(
        tvae, tenc, ttok, tdit, num_inference_steps=3, guidance_scale=1.0,
        latent_shape=(4, 2, 8, 8), text_len=TEXT_LEN,
        samples_per_file=2).run(
        [{"id": f"p{i}", "caption": f"w{i}"} for i in range(5)], out)
    jds = jparquet.ODETrajectoryParquetDataset(out)
    tds = tparquet.ODETrajectoryParquetDataset(out)
    assert len(tds) == len(jds) == 5 and len(tds.files) == 3
    for i in range(5):
        for g, w in zip(tds[i], jds[i]):
            np.testing.assert_array_equal(g, w)
    traj, tsteps, emb = tds[0]
    assert traj.shape == (3, 4, 2, 8, 8) and tsteps.shape == (3,)
    assert (np.diff(tsteps) < 0).all() and emb.shape == (TEXT_LEN, 32)
    jl = jparquet.build_ode_dataloader(out, batch_size=2, seed=3)
    tl = tparquet.build_ode_dataloader(out, batch_size=2, seed=3)
    for _ in range(5):  # two epochs of two batches, and one more
        for g, w in zip(next(tl), next(jl)):
            np.testing.assert_array_equal(g, w)


def test_large_offsets_read_back(tmp_path):
    """A column chunk past 2**31 bytes: the footer's offsets and sizes are
    i64. The pages of a small shard are placed at an offset above 2**31 in
    a sparse file (no 2 GiB buffer) with a footer that says so; pyarrow and
    the port's reader read the same rows back."""
    schema = tparquet.SCHEMA_ODE
    rng = np.random.default_rng(0)
    recs = [tparquet.record_from_ode_sample(
        f"r{i}", rng.standard_normal((3, 4)).astype(np.float32),
        rng.standard_normal((2, 4, 1, 2, 2)).astype(np.float32),
        np.asarray([999.0, 500.0], np.float32), caption=f"c{i}")
        for i in range(2)]
    tparquet.write_parquet_dataset(recs, str(tmp_path / "small"),
                                   schema=schema)
    small = str(tmp_path / "small" / "data_00000.parquet")
    meta = parquet_io.ParquetFile(small)
    with open(small, "rb") as fh:
        body = fh.read()
    shift = (1 << 31) + (1 << 20)
    chunks = []
    for (name, kind), col in zip(schema, meta.row_groups[0][1]):
        m = col[3]
        ptype, _, is_list = parquet_io.KINDS[kind]
        chunks.append((m[9] + shift, parquet_io.column_meta(
            name, ptype, is_list, m[5], m[6], m[7]), m[7], m[6]))
    footer = parquet_io.file_footer(schema, meta.num_rows, chunks)
    end = chunks[-1][0] + chunks[-1][2]
    big = str(tmp_path / "big.parquet")
    with open(big, "wb") as fh:
        fh.write(parquet_io.MAGIC)
        fh.seek(4 + shift)
        fh.write(body[4:end - shift])
        fh.write(footer)
    assert os.path.getsize(big) > 1 << 31
    decoded = parquet_io._ThriftReader(footer[:-8]).struct()
    offsets = [c[3][9] for c in decoded[4][0][1]]
    assert min(offsets) > 1 << 31
    want = parquet_io.read_table(small)
    assert parquet_io.read_table(big) == want
    assert pq.read_table(big).to_pydict() == want


def test_workflow_filters_then_writes(parts, tmp_path):
    """PreprocessWorkflow: the validator's filter counts as the JAX
    workflow's validator counts them, and the kept samples written as the
    pipeline alone writes them."""
    from types import SimpleNamespace

    from fastvideo_tpu.workflow.preprocess_workflow import (
        PreprocessingDataValidator as JaxValidator)
    from fastvideo_tpu_torch.workflow.preprocess_workflow import (
        PreprocessWorkflow)
    from fastvideo_tpu_torch.workflow.workflow_base import WorkflowBase

    (_, tvae), (_, tenc), (_, ttok) = parts["vae"], parts["enc"], \
        parts["tok"]
    samples = _samples(3, seed=2)
    samples[1]["caption"] = ""  # the data-type validator drops it
    args = SimpleNamespace(mode="preprocess", num_frames=81, train_fps=16,
                           output_dir=str(tmp_path / "wf"))
    assert WorkflowBase.get_workflow_cls(args) is PreprocessWorkflow
    wf = PreprocessWorkflow(args, tvae, tenc, ttok)
    wf.preprocess_pipeline.text_len = TEXT_LEN
    assert wf.run(samples) == 2
    jv = JaxValidator(num_frames=81, train_fps=16)
    for s in samples:
        f = s["frames"]
        jv(dict(s, num_frames=f.shape[0], height=f.shape[1],
                width=f.shape[2], fps=16))
    assert wf.validator.filter_counts == jv.filter_counts
    assert wf.validator.filter_counts["data_type_validator"] == 1
    kept = [samples[0], samples[2]]
    tpp.PreprocessPipeline(tvae, tenc, ttok, text_len=TEXT_LEN).run(
        kept, str(tmp_path / "direct"))
    want = parquet_io.read_table(str(tmp_path / "direct" /
                                     "data_00000.parquet"))
    assert parquet_io.read_table(str(tmp_path / "wf" /
                                     "data_00000.parquet")) == want
    with pytest.raises(RuntimeError, match="without a VAE"):
        PreprocessWorkflow(args).run(samples)
