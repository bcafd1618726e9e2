"""The port's LoRA serving path against the JAX package's: ``LoRALinear``'s
forward, merge and unmerge; ``convert_to_lora_layers``' targets (the
embedders' MLPs included); ``set_lora_adapter`` on adapter files in every
naming the loader reads; the scaling 16 / r of an adapter loaded onto an
unconverted linear; int8 and LoRA; the tiny FastWan path's frames with an
adapter active, merged and unmerged; ``VideoGenerator.set_lora_adapter``
and ``lora_path`` (stored, not applied)."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from fastvideo_tpu.configs.models.dits.wan import (WanArchConfig,
                                                   WanVideoConfig)
from fastvideo_tpu.layers.linear import Linear as JLinear
from fastvideo_tpu.layers.lora import LoRALinear as JLoRALinear
from fastvideo_tpu.layers.quantization import int8 as jint8
from fastvideo_tpu.models.dits.wan import WanTransformer3DModel
from fastvideo_tpu.pipelines import lora_pipeline as jlp
from fastvideo_tpu_torch.configs.models.dits.wan import (
    WanArchConfig as TorchWanArchConfig, WanVideoConfig as TorchWanVideoConfig)
from fastvideo_tpu_torch.layers.linear import Linear
from fastvideo_tpu_torch.layers.lora import LoRALinear
from fastvideo_tpu_torch.layers.quantization import int8 as tint8
from fastvideo_tpu_torch.models.dits.wan import (
    WanTransformer3DModel as TorchWanTransformer3DModel)
from fastvideo_tpu_torch.models.loader.jax_params import state_dict_from_jax
from fastvideo_tpu_torch.models.loader.safetensors_io import save_file
from fastvideo_tpu_torch.pipelines import lora_pipeline as tlp

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_jax_reference import jax_plain_attention  # noqa: E402,F401
from test_torch_wan_dit import jax_params, numpy_model  # noqa: E402
from utils import TINY_DIT, make_tiny_wan_checkpoint  # noqa: E402

torch.set_num_threads(2)

DIM = TINY_DIT["num_attention_heads"] * TINY_DIT["attention_head_dim"]


def _arch(cls, **extra):
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in dict(TINY_DIT, **extra).items()})


# -- LoRALinear ---------------------------------------------------------------


def _layers(rank=4, alpha=8.0, seed=0):
    """A JAX and a port LoRALinear [32 -> 48] over the same weight, bias and
    adapters (JAX's layouts transposed)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((48, 32)).astype(np.float32) / 6
    b = rng.standard_normal(48).astype(np.float32)
    a = rng.standard_normal((rank, 32)).astype(np.float32) / 6
    bb = rng.standard_normal((48, rank)).astype(np.float32) / 2
    jl = JLoRALinear.from_linear(JLinear(32, 48, param_dtype=jnp.float32,
                                         rngs=nnx.Rngs(0)), alpha=alpha)
    jl.kernel.value = jnp.asarray(w.T)
    jl.bias.value = jnp.asarray(b)
    jl.set_adapter(a.T, bb.T)
    base = Linear(32, 48)
    with torch.no_grad():
        base.weight.copy_(torch.from_numpy(w))
        base.bias.copy_(torch.from_numpy(b))
    tl = LoRALinear.from_linear(base, alpha=alpha)
    tl.set_adapter(torch.from_numpy(a), torch.from_numpy(bb))
    assert tl.weight is base.weight and tl.bias is base.bias
    return jl, tl


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lora_linear_matches_jax(dtype):
    """Active, merged and unmerged forwards against JAX's at one input. In
    fp32 within 1e-5; in bf16 (the activations and the cast adapters
    rounded alike, the products' sums in other orders) within 2e-2 of the
    output's scale. The merged weight against JAX's merged kernel in fp32
    within 1e-6, and unmerge gives the base weight back within 1e-6."""
    jl, tl = _layers()
    assert tl.scaling == jl.scaling == 2.0 and tl.rank == jl.rank == 4
    x = np.random.default_rng(1).standard_normal((3, 5, 32)).astype(
        np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    tol = 1e-5 if dtype == "float32" else 2e-2
    w0 = tl.weight.detach().clone()

    def compare():
        want = np.asarray(jl(jnp.asarray(x, jdt)).astype(jnp.float32))
        with torch.no_grad():
            got = tl(torch.from_numpy(x).to(tdt)).float().numpy()
        np.testing.assert_allclose(got, want, atol=tol * np.abs(want).max(),
                                   rtol=0)
        return got

    active = compare()
    jl.merge()
    tl.merge()
    assert tl.merged and jl.merged
    np.testing.assert_allclose(tl.weight.detach().numpy(),
                               np.asarray(jl.kernel.value).T, atol=1e-6)
    merged = compare()
    if dtype == "float32":
        np.testing.assert_allclose(merged, active, atol=1e-5)
    tl.merge()  # a no-op when merged
    jl.unmerge()
    tl.unmerge()
    assert not tl.merged
    torch.testing.assert_close(tl.weight.detach(), w0, atol=1e-6, rtol=0)
    compare()
    tl.unmerge()  # a no-op when unmerged
    torch.testing.assert_close(tl.weight.detach(), w0, atol=1e-6, rtol=0)


def test_inactive_lora_is_the_base_linear_and_set_adapter_unmerges():
    """A fresh LoRA layer is inactive (merge is a no-op); set_adapter on a
    merged layer unmerges first, takes the new rank, keeps alpha."""
    base = Linear(8, 6)
    tl = LoRALinear.from_linear(base, rank=4)
    x = torch.randn(2, 8)
    w0 = base.weight.detach().clone()
    tl.merge()
    assert not tl.merged and torch.equal(tl(x), base(x))
    tl.set_adapter(torch.ones(2, 8), torch.ones(6, 2))
    tl.merge()
    tl.set_adapter(torch.zeros(3, 8), torch.zeros(6, 3))
    assert not tl.merged and tl.rank == 3 and tl.alpha == 4.0
    torch.testing.assert_close(base.weight.detach(), w0, atol=1e-6, rtol=0)
    assert tuple(tl.lora_A.shape) == (3, 8) and tuple(tl.lora_B.shape) == (
        6, 3)


# -- conversion ---------------------------------------------------------------


def _jax_model(**extra):
    return numpy_model(lambda: WanTransformer3DModel(
        _arch(WanArchConfig, **extra), param_dtype=jnp.float32,
        rngs=nnx.Rngs(0)), seed=0)


def _jax_lora_paths(jmodel) -> set[str]:
    return {p[:-len(".lora_A")] for p in jax_params(jmodel)
            if p.endswith(".lora_A")}


def _port_lora_paths(model) -> set[str]:
    return {n for n, m in model.named_modules() if isinstance(m, LoRALinear)}


@pytest.mark.parametrize("backend,extra", [
    ("FLASH_ATTN", {}),
    ("VIDEO_SPARSE_ATTN", {}),
    ("FLASH_ATTN", {"r_embedder": True}),
], ids=["flash", "vsa", "r_embedder"])
def test_convert_to_lora_layers_matches_jax(backend, extra, monkeypatch):
    """The default targets convert the same linears in both packages: 10 a
    block and the time and text embedders' fc_in / fc_out (2 more under
    an r_embedder), never to_gate_compress; a second pass converts none."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", backend)
    jmodel = _jax_model(**extra)
    model = TorchWanTransformer3DModel(_arch(TorchWanArchConfig, **extra))
    n_j = jlp.convert_to_lora_layers(jmodel, rank=4)
    n_t = tlp.convert_to_lora_layers(model, rank=4)
    layers = TINY_DIT["num_layers"]
    assert n_t == n_j == 10 * layers + 4 + 2 * bool(extra)
    assert _port_lora_paths(model) == _jax_lora_paths(jmodel)
    assert tlp.convert_to_lora_layers(model) == 0
    # the JAX LoRA leaves map onto the port's state_dict keys
    sd = state_dict_from_jax(jax_params(jmodel))
    assert set(sd) == set(model.state_dict())
    assert tuple(sd["blocks.0.to_q.lora_A"].shape) == (4, DIM)


# -- set_lora_adapter ---------------------------------------------------------


class _JaxPipe(jlp.LoRAPipelineMixin):

    def __init__(self, model):
        self.modules = {"transformer": model}
        self.pipeline_config = type("C", (), {"dit_config": WanVideoConfig()})

    def get_module(self, name):
        return self.modules[name]


class _TorchPipe(tlp.LoRAPipelineMixin):

    def __init__(self, model):
        self.modules = {"transformer": model}
        self.pipeline_config = type(
            "C", (), {"dit_config": TorchWanVideoConfig()})

    def get_module(self, name):
        return self.modules[name]


def _pair(rng, rank, fan_in, fan_out):
    return (rng.standard_normal((rank, fan_in)).astype(np.float32) / 8,
            rng.standard_normal((fan_out, rank)).astype(np.float32) / 8)


def _adapter(naming: str, rank: int, seed: int = 0) -> dict:
    """Adapter tensors in one of the namings the loader reads (an
    ``alpha`` key too, which it never reads)."""
    rng = np.random.default_rng(seed)
    out = {}
    freq = TINY_DIT["freq_dim"]
    for i in range(TINY_DIT["num_layers"]):
        if naming == "official":
            names = [(f"diffusion_model.blocks.{i}.{m}", "lora_A", "lora_B",
                      DIM, DIM)
                     for m in ("self_attn.q", "self_attn.o", "cross_attn.k",
                               "ffn.0")]
        elif naming == "diffusers":
            names = [(f"transformer.blocks.{i}.{m}", "lora_A", "lora_B",
                      DIM, DIM)
                     for m in ("attn1.to_k", "attn1.to_out.0", "attn2.to_v",
                               "ffn.net.2")]
        elif naming == "kohya":
            names = [(f"lora_unet_blocks.{i}.{m}", "lora_down", "lora_up",
                      DIM, DIM)
                     for m in ("attn1.to_v", "attn2.to_q", "attn2.to_out.0")]
        else:  # peft's adapter infix
            names = [(f"blocks.{i}.{m}", "lora_A.default", "lora_B.default",
                      DIM, DIM) for m in ("attn2.to_q", "ffn.net.0.proj")]
        for base, a_name, b_name, fin, fout in names:
            a, b = _pair(rng, rank, fin, fout)
            out[f"{base}.{a_name}.weight"] = a
            out[f"{base}.{b_name}.weight"] = b
            out[f"{base}.alpha"] = np.float32([2 * rank])
    if naming == "diffusers":
        a, b = _pair(rng, rank, freq, DIM)
        out["transformer.condition_embedder.time_embedder.linear_1."
            "lora_A.weight"] = a
        out["transformer.condition_embedder.time_embedder.linear_1."
            "lora_B.weight"] = b
    return out


def _write(tensors: dict, path: str) -> str:
    save_file({k: torch.from_numpy(np.asarray(v)) for k, v in
               tensors.items()}, path)
    return path


def _assert_same_adapters(jmodel, model):
    """The same active layers, each with JAX's A / B (transposed), rank and
    scaling."""
    jp = jax_params(jmodel)
    active = {n: m for n, m in model.named_modules()
              if isinstance(m, LoRALinear) and m.lora_active}
    assert active
    assert set(active) == {p for p in _jax_lora_paths(jmodel)}
    for name, m in active.items():
        np.testing.assert_array_equal(m.lora_A.detach().numpy(),
                                      jp[f"{name}.lora_A"].T)
        np.testing.assert_array_equal(m.lora_B.detach().numpy(),
                                      jp[f"{name}.lora_B"].T)
        assert m.rank == m.lora_A.shape[0]
        # converted on demand at rank 16, alpha 16: the file's rank sets
        # the scaling to 16 / r, whatever alpha the file holds
        assert m.alpha == 16.0 and m.scaling == 16.0 / m.rank


@pytest.mark.parametrize("naming,rank", [("official", 4), ("diffusers", 8),
                                         ("kohya", 4), ("peft", 2)])
def test_set_lora_adapter_matches_jax(naming, rank, tmp_path, monkeypatch):
    """A file in each naming (official names under ``diffusion_model.``,
    diffusers names under ``transformer.``, ``lora_unet_`` with lora_down /
    lora_up, peft's ``.default`` infix): the port attaches the same
    adapters to the same linears as JAX, converting on demand."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    path = _write(_adapter(naming, rank), str(tmp_path / "a.safetensors"))
    jmodel = _jax_model()
    model = TorchWanTransformer3DModel(_arch(TorchWanArchConfig))
    jpipe, tpipe = _JaxPipe(jmodel), _TorchPipe(model)
    jpipe.set_lora_adapter("x", path)
    tpipe.set_lora_adapter("x", path)
    assert tpipe.current_adapter == "x" and tpipe.lora_adapters == {
        "x": path}
    _assert_same_adapters(jmodel, model)


def test_set_lora_adapter_directory_and_nickname(tmp_path, monkeypatch):
    """A directory's ``.safetensors`` file reads as the file; a nickname
    seen before needs no path; an unknown one raises."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    d = tmp_path / "adapter"
    d.mkdir()
    _write(_adapter("official", 4), str(d / "w.safetensors"))
    (d / "README.md").write_text("x")
    model = TorchWanTransformer3DModel(_arch(TorchWanArchConfig))
    pipe = _TorchPipe(model)
    pipe.set_lora_adapter("a", str(d))
    first = {n: m.lora_A.detach().clone() for n, m in model.named_modules()
             if isinstance(m, LoRALinear)}
    pipe.merge_lora_weights()
    pipe.set_lora_adapter("a")
    assert all(not m.merged for m in tlp.lora_layers(model))
    for n, m in model.named_modules():
        if isinstance(m, LoRALinear):
            assert torch.equal(m.lora_A, first[n])
    with pytest.raises(ValueError, match="Unknown LoRA"):
        pipe.set_lora_adapter("b")


def test_adapter_on_converted_linear_keeps_alpha(tmp_path, monkeypatch):
    """A linear converted at rank 32, alpha 64 keeps alpha 64 when a rank-4
    adapter arrives (scaling 16), in both packages."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    path = _write(_adapter("official", 4), str(tmp_path / "a.safetensors"))
    jmodel = _jax_model()
    model = TorchWanTransformer3DModel(_arch(TorchWanArchConfig))
    jlp.convert_to_lora_layers(jmodel, rank=32, alpha=64.0)
    tlp.convert_to_lora_layers(model, rank=32, alpha=64.0)
    _JaxPipe(jmodel).set_lora_adapter("x", path)
    _TorchPipe(model).set_lora_adapter("x", path)
    jq = jmodel.blocks[0].to_q
    tq = model.blocks[0].to_q
    assert tq.lora_active and tq.rank == jq.rank == 4
    assert tq.alpha == jq.alpha == 64.0 and tq.scaling == jq.scaling == 16.0
    assert not model.blocks[0].to_k.lora_active  # converted, no adapter


def test_int8_and_lora_match_jax(tmp_path, monkeypatch):
    """W8A8 after conversion skips every LoRA linear; an adapter loaded onto
    a W8A8 model applies to none of the quantized linears (a warning
    each), so only the excluded kernel feeders take it: the same counts
    and layers as JAX."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    jmodel = _jax_model()
    model = TorchWanTransformer3DModel(_arch(TorchWanArchConfig))
    jlp.convert_to_lora_layers(jmodel)
    tlp.convert_to_lora_layers(model)
    jcount = jint8.quantize_model_linears(
        jmodel, jint8.QuantizationConfig(method="int8_w8a8"))
    tcount = tint8.quantize_model_linears(
        model, tint8.QuantizationConfig(method="int8_w8a8"))
    assert tcount == jcount > 0
    assert len(tlp.lora_layers(model)) == 10 * TINY_DIT["num_layers"] + 4

    path = _write(_adapter("official", 4), str(tmp_path / "a.safetensors"))
    jmodel = _jax_model()
    model = TorchWanTransformer3DModel(_arch(TorchWanArchConfig))
    for m, mod in ((jmodel, jint8), (model, tint8)):
        mod.quantize_model_linears(m, mod.QuantizationConfig(
            method="int8_w8a8"))
    _JaxPipe(jmodel).set_lora_adapter("x", path)
    _TorchPipe(model).set_lora_adapter("x", path)
    got = _port_lora_paths(model)
    assert got == _jax_lora_paths(jmodel)
    # self_attn.q is a kernel feeder (kept bf16); o and ffn.0 are int8
    assert got == {f"blocks.{i}.{m}" for i in range(TINY_DIT["num_layers"])
                   for m in ("to_q", "attn2.to_k")}
    assert isinstance(model.blocks[0].to_out, tint8.Int8Linear)


# -- the serving path ---------------------------------------------------------

GEN = dict(prompt="w1 w2 w3", height=32, width=32, num_frames=5, seed=4,
           save_video=False)
FP32 = dict(precision="fp32", vae_decode_precision="fp32",
            text_encoder_precisions=("fp32",))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    root = tmp_path_factory.mktemp("lora_port")
    return make_tiny_wan_checkpoint(
        str(root / "FastWan2.1-T2V-tiny-Diffusers"))


@pytest.fixture(scope="module")
def adapter_file(tmp_path_factory):
    """Rank-8 adapters on every default target of both blocks (official
    names under ``diffusion_model.``) and on the time embedder's fc_in."""
    rng = np.random.default_rng(3)
    out = {}
    mods = ("self_attn.q", "self_attn.k", "self_attn.v", "self_attn.o",
            "cross_attn.q", "cross_attn.k", "cross_attn.v", "cross_attn.o",
            "ffn.0", "ffn.2")
    for i in range(TINY_DIT["num_layers"]):
        for m in mods:
            fin = TINY_DIT["ffn_dim"] if m == "ffn.2" else DIM
            fout = TINY_DIT["ffn_dim"] if m == "ffn.0" else DIM
            a, b = _pair(rng, 8, fin, fout)
            out[f"diffusion_model.blocks.{i}.{m}.lora_A.weight"] = 2 * a
            out[f"diffusion_model.blocks.{i}.{m}.lora_B.weight"] = 2 * b
    path = tmp_path_factory.mktemp("adapter") / "lora.safetensors"
    return _write(out, str(path))


def test_fastwan_lora_frames_match_jax(ckpt, adapter_file, monkeypatch,
                                       jax_plain_attention):
    """The tiny FastWan DMD path (3 steps, fp32) with the same adapter file
    through each package's VideoGenerator: the base, the adapter active,
    merged and unmerged. Latents within 1e-3 and frames within 1 uint8
    level of JAX's at each stage (fp32 on both sides: summation order
    only); the adapter moves the frames; merged and unmerged stay within
    8 levels of active (JAX's own bar)."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    import fastvideo_tpu.parallel as par
    from fastvideo_tpu import VideoGenerator as JaxGenerator

    from fastvideo_tpu_torch import VideoGenerator

    par.destroy_mesh()
    jgen = JaxGenerator.from_pretrained(ckpt, num_gpus=1, **FP32)
    gen = VideoGenerator.from_pretrained(ckpt, device="cpu", **FP32)
    stages = {}

    def run(label):
        want = jgen.generate_video(**GEN)
        got = gen.generate_video(**GEN)
        np.testing.assert_allclose(got["latents"].numpy(),
                                   np.asarray(want["latents"], np.float32),
                                   atol=1e-3, rtol=0, err_msg=label)
        f_got, f_want = got["frames"][0], want["frames"][0]
        diff = np.abs(f_got.astype(np.int16) - f_want.astype(np.int16))
        assert diff.max() <= 1, label
        stages[label] = f_got.astype(np.int16)

    run("base")
    jgen.set_lora_adapter("style", adapter_file)
    gen.set_lora_adapter("style", adapter_file)
    assert gen.pipeline.current_adapter == "style"
    run("active")
    jgen.executor.pipeline.merge_lora_weights()
    gen.pipeline.merge_lora_weights()
    run("merged")
    jgen.executor.pipeline.unmerge_lora_weights()
    gen.pipeline.unmerge_lora_weights()
    run("unmerged")
    par.destroy_mesh()
    assert np.abs(stages["active"] - stages["base"]).max() > 0
    for label in ("merged", "unmerged"):
        assert np.abs(stages[label] - stages["active"]).max() <= 8, label


def test_lora_path_is_stored_not_applied(ckpt, adapter_file, monkeypatch):
    """``lora_path`` at from_pretrained is stored in FastVideoArgs and not
    applied (no LoRA layer in the DiT); a pipeline without the mixin makes
    set_lora_adapter raise as JAX's executor does."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    from fastvideo_tpu_torch import VideoGenerator

    gen = VideoGenerator.from_pretrained(ckpt, device="cpu",
                                         lora_path=adapter_file,
                                         lora_nickname="s", **FP32)
    assert gen.fastvideo_args.lora_path == adapter_file
    assert gen.fastvideo_args.lora_nickname == "s"
    dit = gen.pipeline.get_module("transformer")
    assert not tlp.lora_layers(dit)
    assert isinstance(dit.blocks[0].to_q, Linear)
    gen.pipeline = object()
    with pytest.raises(NotImplementedError, match="does not support LoRA"):
        gen.set_lora_adapter("s", adapter_file)
