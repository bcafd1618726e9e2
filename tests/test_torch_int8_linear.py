"""The port's int8 quantization (layers/quantization/int8.py and the
quantize-at-load) against the JAX package's, on the CPU: the int8 weights
and scales bit for bit, the outputs of the W8A8 and weight-only linears,
the module paths ``quantize_model_linears`` picks on the tiny Wan DiT and
UMT5, the method aliases, and a quantized JAX DiT's state carried into the
port's."""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from fastvideo_tpu.configs.models.dits.wan import WanArchConfig
from fastvideo_tpu.configs.models.encoders.t5 import T5ArchConfig
from fastvideo_tpu.layers.linear import Linear as JaxLinear
from fastvideo_tpu.layers.quantization import int8 as jint8
from fastvideo_tpu.models.dits.wan import WanTransformer3DModel
from fastvideo_tpu.models.encoders.t5 import T5EncoderModel
from fastvideo_tpu_torch.configs.models.dits.wan import (
    WanArchConfig as TorchWanArchConfig)
from fastvideo_tpu_torch.configs.models.encoders.t5 import (
    T5ArchConfig as TorchT5ArchConfig)
from fastvideo_tpu_torch.layers.linear import Linear
from fastvideo_tpu_torch.layers.quantization import int8 as tint8
from fastvideo_tpu_torch.models.dits.wan import (
    WanTransformer3DModel as TorchWanTransformer3DModel)
from fastvideo_tpu_torch.models.encoders.t5 import (
    T5EncoderModel as TorchT5EncoderModel)
from fastvideo_tpu_torch.models.loader.jax_params import state_dict_from_jax

sys.path.insert(0, os.path.dirname(__file__))

from utils import (TINY_DIT, TINY_T5, _export_torch_layout,  # noqa: E402
                   _save_safetensors)

torch.set_num_threads(2)

METHODS = ("int8_w8a8", "int8_weight_only")


def _linear_pair(rng, fin, fout, bias=True):
    """A JAX Linear and the port's with the same numpy weights."""
    kernel = (rng.standard_normal((fin, fout)) / np.sqrt(fin)).astype(
        np.float32)
    b = (0.1 * rng.standard_normal(fout)).astype(np.float32)
    jlin = JaxLinear(fin, fout, bias=bias, param_dtype=jnp.float32,
                     rngs=nnx.Rngs(0))
    jlin.kernel.value = jnp.asarray(kernel)
    tlin = Linear(fin, fout, bias=bias)
    with torch.no_grad():
        tlin.weight.copy_(torch.from_numpy(kernel.T.copy()))
        if bias:
            jlin.bias.value = jnp.asarray(b)
            tlin.bias.copy_(torch.from_numpy(b))
    return jlin, tlin


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("bias", [True, False])
def test_int8_linear_matches_jax(method, bias):
    rng = np.random.default_rng(0)
    jlin, tlin = _linear_pair(rng, 48, 40, bias)
    weight_only = method == "int8_weight_only"
    jq = jint8.Int8Linear.from_linear(jlin, weight_only=weight_only)
    tq = tint8.Int8Linear.from_linear(tlin, weight_only=weight_only)
    np.testing.assert_array_equal(tq.weight_q.numpy(),
                                  np.asarray(jq.kernel_q.value).T)
    np.testing.assert_array_equal(tq.scale.numpy(),
                                  np.asarray(jq.scale.value))
    x = rng.standard_normal((2, 9, 48)).astype(np.float32)
    want = np.asarray(jq(jnp.asarray(x)))
    got = tq(torch.from_numpy(x)).detach().numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_weight_and_activation_quantizers_are_bit_exact():
    """bf16 and fp32 weights, per-token activations with a zero row (scale
    1e-8) and values on the rounding ties."""
    rng = np.random.default_rng(1)
    w = rng.standard_normal((24, 64)).astype(np.float32)
    w[3] = 0.0
    jq, js = jint8.quantize_weight_int8(jnp.asarray(w.T))
    hq, hs = jint8.host_quantize_weight_int8(w.T)
    tq, ts = tint8.quantize_weight_int8(torch.from_numpy(w))
    for q, s in ((jq, js), (hq, hs)):
        np.testing.assert_array_equal(tq.numpy(), np.asarray(q).T)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
    wb = torch.from_numpy(w).to(torch.bfloat16)
    jq, js = jint8.quantize_weight_int8(
        jnp.asarray(wb.float().numpy().T).astype(jnp.bfloat16))
    tq, ts = tint8.quantize_weight_int8(wb)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    x = rng.standard_normal((5, 7, 32)).astype(np.float32)
    x[1, 2] = 0.0
    x[0, 0, :4] = [127.0, 63.5, -0.5, 1.5]  # scale 1: ties round to even
    jq, js = jint8._quantize_activation(jnp.asarray(x))
    tq, ts = tint8.quantize_activation(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_resolve_quant_method_matches_jax():
    specs = [*jint8.W8A8_ALIASES, *jint8.WEIGHT_ONLY_ALIASES, "INT8",
             " W8A8 ", "int8-weight-only", "Weight-Only"]
    for spec in specs:
        assert tint8.resolve_quant_method(spec) == \
            jint8.resolve_quant_method(spec)
    for bad in ("fp8", "int4", ""):
        with pytest.raises(ValueError, match="Unknown transformer_quant"):
            jint8.resolve_quant_method(bad)
        with pytest.raises(ValueError, match="Unknown transformer_quant"):
            tint8.resolve_quant_method(bad)


def _jax_paths(model) -> set[str]:
    return {".".join(map(str, path)) for path, node in nnx.iter_graph(model)
            if isinstance(node, jint8.Int8Linear)}


def _torch_paths(model) -> set[str]:
    return {name for name, m in model.named_modules()
            if isinstance(m, tint8.Int8Linear)}


def _arch(cls, cfg, **extra):
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in cfg.items() if k != "model_type"}, **extra)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("backend", ["FLASH_ATTN", "VIDEO_SPARSE_ATTN"])
def test_quantize_model_linears_picks_the_jax_paths_on_the_dit(
        method, backend, monkeypatch):
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", backend)
    jmodel = nnx.eval_shape(lambda: WanTransformer3DModel(
        _arch(WanArchConfig, TINY_DIT), param_dtype=jnp.float32,
        rngs=nnx.Rngs(0)))
    tmodel = TorchWanTransformer3DModel(_arch(TorchWanArchConfig, TINY_DIT),
                                        device="meta")
    cfg_j = jint8.QuantizationConfig(method=method)
    cfg_t = tint8.QuantizationConfig(method=method)
    n_j = jint8.quantize_model_linears(jmodel, cfg_j, init_only=True)
    n_t = tint8.quantize_model_linears(tmodel, cfg_t, init_only=True)
    assert n_t == n_j == len(_torch_paths(tmodel))
    assert _torch_paths(tmodel) == _jax_paths(jmodel)
    # W8A8 keeps the attention feeders (q/k/v, the VSA gate) in bf16; both
    # take patch_embedding.proj, and neither anything under
    # condition_embedder or proj_out
    per_block = 4 if method == "int8_w8a8" else 10 + (
        backend == "VIDEO_SPARSE_ATTN")
    assert n_t == per_block * TINY_DIT["num_layers"] + 1


@pytest.mark.parametrize("method", METHODS)
def test_quantize_model_linears_picks_the_jax_paths_on_umt5(method):
    jmodel = nnx.eval_shape(lambda: T5EncoderModel(
        _arch(T5ArchConfig, TINY_T5, is_umt5=True), param_dtype=jnp.float32,
        rngs=nnx.Rngs(0)))
    tmodel = TorchT5EncoderModel(_arch(TorchT5ArchConfig, TINY_T5,
                                       is_umt5=True), device="meta")
    n_j = jint8.quantize_model_linears(
        jmodel, jint8.QuantizationConfig(method=method), init_only=True)
    n_t = tint8.quantize_model_linears(
        tmodel, tint8.QuantizationConfig(method=method), init_only=True)
    assert _torch_paths(tmodel) == _jax_paths(jmodel)
    # q/k/v/o and wi_0/wi_1/wo per block; W8A8 skips nothing named q_proj..
    assert n_t == n_j == 7 * TINY_T5["num_layers"]


def numpy_model(build, seed: int):
    """A JAX module built abstractly with its parameters drawn from numpy
    (eager nnx initialisation costs seconds): weights ~ N(0, 1/fan_in),
    1-D leaves near 1 or 0."""
    graphdef, state = nnx.split(nnx.eval_shape(build))
    rng = np.random.default_rng(seed)

    def init(path, leaf):
        shape = leaf.shape
        if len(shape) >= 2:
            val = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif str(path[-1]) in ("gamma", "weight"):
            val = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            val = 0.1 * rng.standard_normal(shape)
        return jnp.asarray(val, jnp.float32)

    return nnx.merge(graphdef, jax.tree_util.tree_map_with_path(init, state))


@pytest.fixture(scope="module")
def text_encoder_dir(tmp_path_factory):
    """A tiny UMT5 checkpoint directory in the diffusers layout."""
    d = str(tmp_path_factory.mktemp("int8_load") / "text_encoder")
    os.makedirs(d)
    with open(os.path.join(d, "config.json"), "w") as fh:
        json.dump({"architectures": ["UMT5EncoderModel"], **TINY_T5}, fh)
    enc = numpy_model(lambda: T5EncoderModel(
        _arch(T5ArchConfig, TINY_T5, is_umt5=True), param_dtype=jnp.float32,
        rngs=nnx.Rngs(0)), seed=6)
    _save_safetensors(os.path.join(d, "model.safetensors"),
                      _export_torch_layout(enc))
    return d


@pytest.mark.parametrize("spec,precision", [("int8-weight-only", "fp32"),
                                            ("int8", "bf16")])
def test_quantize_at_load_matches_jax(text_encoder_dir, spec, precision):
    from fastvideo_tpu.models.loader.component_loader import (
        load_model_component as jax_load)
    from fastvideo_tpu_torch.models.loader.component_loader import (
        load_model_component)

    enc_dir = text_encoder_dir
    jenc = jax_load(enc_dir, precision=precision, quantize_spec=spec)
    tenc = load_model_component(enc_dir, device=torch.device("cpu"),
                                precision=precision, quantize_spec=spec)
    jq = {".".join(map(str, p)): n for p, n in nnx.iter_graph(jenc)
          if isinstance(n, jint8.Int8Linear)}
    tq = dict((n, m) for n, m in tenc.named_modules()
              if isinstance(m, tint8.Int8Linear))
    assert set(tq) == set(jq) and len(tq) == 7 * TINY_T5["num_layers"]
    for name, m in tq.items():
        assert m.weight_q.device.type == "cpu"
        np.testing.assert_array_equal(m.weight_q.numpy(),
                                      np.asarray(jq[name].kernel_q.value).T)
        np.testing.assert_array_equal(m.scale.numpy(),
                                      np.asarray(jq[name].scale.value))
    ids = np.array([[5, 9, 17, 3, 1, 0]], np.int32)
    mask = np.array([[1, 1, 1, 1, 1, 0]], np.int32)
    want = np.asarray(jenc(jnp.asarray(ids), jnp.asarray(mask))
                      .last_hidden_state, np.float32)
    with torch.no_grad():
        got = tenc(torch.from_numpy(ids).long(),
                   torch.from_numpy(mask)).last_hidden_state.float()
    tol = 1e-4 if precision == "fp32" else 5e-2
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=tol)


def test_quantized_jax_state_loads_into_the_port(monkeypatch):
    """A W8A8 JAX DiT's state (``kernel_q`` [in, out], ``scale``) carried by
    ``state_dict_from_jax`` into the port's quantized DiT: same forward."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    jmodel = numpy_model(lambda: WanTransformer3DModel(
        _arch(WanArchConfig, TINY_DIT), param_dtype=jnp.float32,
        rngs=nnx.Rngs(3)), seed=3)
    jint8.quantize_model_linears(jmodel)
    tmodel = TorchWanTransformer3DModel(_arch(TorchWanArchConfig, TINY_DIT),
                                        dtype=torch.float32)
    tint8.quantize_model_linears(tmodel, init_only=True)
    flat = {".".join(map(str, path)): np.asarray(var.get_value())
            for path, var in nnx.state(jmodel, nnx.Param).flat_state()}
    tmodel.load_state_dict(state_dict_from_jax(flat), strict=True)
    for name, m in tmodel.named_modules():
        if isinstance(m, tint8.Int8Linear):
            np.testing.assert_array_equal(m.weight_q.numpy(),
                                          flat[f"{name}.kernel_q"].T)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 4, 3, 8, 8), dtype=np.float32)
    ctx = rng.standard_normal((1, 12, TINY_DIT["text_dim"]), dtype=np.float32)
    t = np.array([757.0], np.float32)
    want = np.asarray(jmodel(jnp.asarray(x), jnp.asarray(ctx),
                             jnp.asarray(t)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x), torch.from_numpy(ctx),
                     torch.from_numpy(t)).numpy()
    # an fp32 summation-order difference that crosses a rounding boundary of
    # a per-token int8 quantization moves that activation by one step
    # (amax / 127), and the later layers carry it: measured 0.15 % relative
    # L2 and 0.3 % of the output's range at the worst element
    assert np.linalg.norm(got - want) <= 5e-3 * np.linalg.norm(want)
    assert np.abs(got - want).max() <= 1e-2 * np.abs(want).max()


def test_int8_mm_is_exact_for_any_shape():
    rng = np.random.default_rng(4)
    for m, k, n in ((1, 8, 8), (17, 24, 40), (5, 13, 7), (3, 4096, 8)):
        a = rng.integers(-127, 128, (m, k), dtype=np.int8)
        b = rng.integers(-127, 128, (n, k), dtype=np.int8)
        if k == 4096:  # extreme values: 16-bit pair sums would saturate
            a, b = np.where(a < 0, -127, 127).astype(np.int8), np.full_like(
                b, 127)
        got = tint8.int8_mm(torch.from_numpy(a), torch.from_numpy(b))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), a.astype(np.int64) @ b.astype(np.int64).T)


def test_w8a8_calls_are_counted():
    tint8.reset_forward_calls()
    _, tlin = _linear_pair(np.random.default_rng(5), 16, 8)
    tint8.Int8Linear.from_linear(tlin)(torch.zeros(3, 16))
    tint8.Int8Linear.from_linear(tlin, weight_only=True)(torch.zeros(3, 16))
    assert tint8.FORWARD_CALLS == {"int8_w8a8": 1, "int8_weight_only": 1}


@pytest.mark.parametrize("method", METHODS)
def test_output_dtype_follows_jax(method):
    """bf16 parameters, an fp32 input: the W8A8 output takes the parameter
    dtype (the bias is added after that cast), the weight-only output the
    activation's, on both sides."""
    rng = np.random.default_rng(6)
    jlin, tlin = _linear_pair(rng, 64, 32, True)
    weight_only = method == "int8_weight_only"
    jlin.kernel.value = jlin.kernel.value.astype(jnp.bfloat16)
    jlin.bias.value = jlin.bias.value.astype(jnp.bfloat16)
    tlin.to(torch.bfloat16)
    jq = jint8.Int8Linear.from_linear(jlin, weight_only=weight_only)
    tq = tint8.Int8Linear.from_linear(tlin, weight_only=weight_only)
    x = rng.standard_normal((5, 64)).astype(np.float32)
    want = jq(jnp.asarray(x))
    got = tq(torch.from_numpy(x)).detach()
    assert str(want.dtype) == ("float32" if weight_only else "bfloat16")
    assert got.dtype == (torch.float32 if weight_only else torch.bfloat16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=1e-5,
                               atol=1e-6)
