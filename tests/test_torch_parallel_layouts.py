"""The port's parallel layouts against the JAX package's: the port in 2,
4 and 8 gloo processes on the CPU, JAX on its forced 8-device CPU mesh at
the same layout, with the same weights (``state_dict_from_jax``) and numpy
inputs, within 5e-5 in fp32 (JAX's own bar for these layouts).

* Ulysses sequence parallelism of the Wan DiT at sp 2 and 4 on two token
  grids (one of 45 tokens, which sp does not divide), VSA at sparsity 0
  and 0.5 with sp 2 and 4 and with sp 2 x tp 2, and per-token timesteps
  over 45 tokens at sp 2 (after ``tests/distributed/test_sp_wan.py``,
  ``test_sp_wan_vsa.py`` and ``test_sp_pad_models.py``);
* tensor parallelism of the Wan DiT at (dp, sp, tp) = (1, 1, 2), (1, 2, 2)
  and (2, 2, 2) with a batch of dp (after ``test_tp.py``), and the
  tp-sharded q/k norm over all heads against the unsharded norm;
* ``param_spec`` / ``shard_state`` on the Wan DiT and on UMT5: the rank
  slices, concatenated, are the full weights, and every dim JAX's
  ``tp_axes`` split is split in the port's layout;
* UMT5 at tp 2, its weights also through the checkpoint loader (whole
  tensors cut to the rank's slice) and into int8 weight-only slots;
  ``Int8Linear`` from column- and row-parallel linears against the
  unsplit int8 layer; ``DistributedAttention.joint_forward`` at sp 2;
  ``parallel_tiled_decode`` over 2 ranks.

The port's ranks run every case of a world size in one spawn
(``port_outputs``); each test computes JAX's output at its layout and
holds every rank's output to it.
"""

import functools
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(__file__))

import torch_parallel_ranks as ranks  # noqa: E402
from test_torch_jax_reference import jax_plain_attention  # noqa: E402,F401
from utils import TINY_T5, TINY_VAE  # noqa: E402

torch.set_num_threads(2)

TOL = 5e-5
ARCH = dict(num_attention_heads=4, attention_head_dim=24, in_channels=4,
            out_channels=4, text_dim=32, freq_dim=32, ffn_dim=64,
            num_layers=2, text_len=16)
# name: (layout (dp, sp, tp), backend, VSA sparsity, latent shape, heads,
# per-token timesteps)
CASES = {
    "sp2_grid8": ((1, 2, 1), "FLASH_ATTN", 0.0, (1, 4, 4, 8, 8), 4, False),
    "sp2_odd45": ((1, 2, 1), "FLASH_ATTN", 0.0, (1, 4, 3, 6, 10), 4, False),
    "sp4_grid8": ((1, 4, 1), "FLASH_ATTN", 0.0, (1, 4, 4, 8, 8), 4, False),
    "sp4_odd45": ((1, 4, 1), "FLASH_ATTN", 0.0, (1, 4, 3, 6, 10), 4, False),
    "vsa_sp2_s0": ((1, 2, 1), "VIDEO_SPARSE_ATTN", 0.0, (1, 4, 4, 16, 16),
                   4, False),
    "vsa_sp2_s05": ((1, 2, 1), "VIDEO_SPARSE_ATTN", 0.5, (1, 4, 4, 16, 16),
                    4, False),
    "vsa_sp4_s0": ((1, 4, 1), "VIDEO_SPARSE_ATTN", 0.0, (1, 4, 4, 16, 16),
                   4, False),
    "vsa_sp4_s05": ((1, 4, 1), "VIDEO_SPARSE_ATTN", 0.5, (1, 4, 4, 16, 16),
                    4, False),
    "vsa_sp2_tp2": ((1, 2, 2), "VIDEO_SPARSE_ATTN", 0.5, (1, 4, 4, 16, 16),
                    4, False),
    "per_token_sp2_odd45": ((1, 2, 1), "FLASH_ATTN", 0.0, (1, 4, 3, 6, 10),
                            2, True),
    "tp_1x1x2": ((1, 1, 2), "FLASH_ATTN", 0.0, (1, 4, 4, 8, 8), 4, False),
    "tp_1x2x2": ((1, 2, 2), "FLASH_ATTN", 0.0, (1, 4, 4, 8, 8), 4, False),
    "tp_2x2x2": ((2, 2, 2), "FLASH_ATTN", 0.0, (2, 4, 4, 8, 8), 4, False),
}
T5_ARCH = {k: v for k, v in TINY_T5.items() if k != "model_type"}
VAE_ARCH = {k: tuple(v) if isinstance(v, list) else v
            for k, v in TINY_VAE.items()}
# 9 tiles of 4x4 latents at stride 3 over an 8x8 latent: 5 and 4 a rank
TILE, STRIDE = (4, 4), (3, 3)
JOINT = dict(img=9, txt=5, heads=4, head_dim=16)


def _flat(model) -> dict[str, np.ndarray]:
    from flax import nnx

    return {".".join(map(str, p)): np.asarray(v.get_value())
            for p, v in nnx.state(model, nnx.Param).flat_state()}


def _port_state(jmodel) -> dict[str, np.ndarray]:
    from fastvideo_tpu_torch.models.loader.jax_params import (
        state_dict_from_jax)

    return {k: v.numpy() for k, v in state_dict_from_jax(
        _flat(jmodel)).items()}


@functools.lru_cache(maxsize=None)
def _jax_wan(backend: str = "FLASH_ATTN", heads: int = 4):
    """The JAX DiT with numpy weights (the backend picks its block class)."""
    import jax.numpy as jnp
    from flax import nnx

    from fastvideo_tpu.configs.models.dits.wan import WanArchConfig
    from fastvideo_tpu.models.dits.wan import WanTransformer3DModel
    from test_torch_wan_dit import numpy_model

    os.environ["FASTVIDEO_ATTENTION_BACKEND"] = backend
    try:
        model = numpy_model(lambda: WanTransformer3DModel(
            WanArchConfig(**dict(ARCH, num_attention_heads=heads)),
            param_dtype=jnp.float32, rngs=nnx.Rngs(0)), seed=0)
    finally:
        os.environ.pop("FASTVIDEO_ATTENTION_BACKEND")
    assert model.vsa_tiled_order == (backend == "VIDEO_SPARSE_ATTN")
    return model


@functools.lru_cache(maxsize=None)
def _wan_case(name: str) -> dict:
    """The port's side of a DiT case: layout, backend, arch, the full
    state dict and the numpy inputs."""
    layout, backend, sparsity, shape, heads, per_token = CASES[name]
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape, dtype=np.float32)
    ctx = rng.standard_normal((shape[0], 16, 32), dtype=np.float32)
    n_tok = shape[2] * (shape[3] // 2) * (shape[4] // 2)
    ts = (np.full((shape[0], n_tok), 500.0, np.float32) if per_token else
          np.full((shape[0],), 500.0, np.float32))
    return dict(layout=layout, backend=backend, sparsity=sparsity,
                arch=dict(ARCH, num_attention_heads=heads),
                state=_port_state(_jax_wan(backend, heads)), x=x, ctx=ctx,
                ts=ts)


@functools.lru_cache(maxsize=None)
def _jax_t5():
    import jax.numpy as jnp
    from flax import nnx

    from fastvideo_tpu.configs.models.encoders.t5 import T5ArchConfig
    from fastvideo_tpu.models.encoders.t5 import T5EncoderModel
    from test_torch_wan_dit import numpy_model

    return numpy_model(lambda: T5EncoderModel(
        T5ArchConfig(**T5_ARCH, is_umt5=True), param_dtype=jnp.float32,
        rngs=nnx.Rngs(2)), seed=2)


@functools.lru_cache(maxsize=None)
def _jax_vae():
    import jax.numpy as jnp
    from flax import nnx

    from fastvideo_tpu.configs.models.vaes.wan import WanVAEArchConfig
    from fastvideo_tpu.models.vaes.wan import AutoencoderKLWan
    from test_torch_wan_dit import numpy_model

    return numpy_model(lambda: AutoencoderKLWan(
        WanVAEArchConfig(**VAE_ARCH), param_dtype=jnp.float32,
        rngs=nnx.Rngs(1)), seed=1)


def _t5_inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, TINY_T5["vocab_size"], (2, 16))
    mask = np.ones((2, 16), np.int64)
    mask[1, 9:] = 0
    return ids, mask


def _joint_inputs():
    from fastvideo_tpu_torch.layers.rotary import get_rotary_pos_embed_wan

    rng = np.random.default_rng(3)
    n, t, h, d = JOINT["img"], JOINT["txt"], JOINT["heads"], JOINT["head_dim"]
    q, k, v = (rng.standard_normal((1, n, h, d), dtype=np.float32)
               for _ in range(3))
    rq, rk, rv = (rng.standard_normal((1, t, h, d), dtype=np.float32)
                  for _ in range(3))
    cos, sin = (c.numpy() for c in get_rotary_pos_embed_wan((1, 3, 3), d))
    return q, k, v, rq, rk, rv, cos, sin


def _int8_inputs():
    rng = np.random.default_rng(7)
    return (rng.standard_normal((2, 5, 64), dtype=np.float32),
            rng.standard_normal((48, 64), dtype=np.float32) / 8,
            rng.standard_normal(48, dtype=np.float32) / 10)


def _vae_latent():
    return np.random.default_rng(4).standard_normal((1, 4, 2, 8, 8),
                                                    dtype=np.float32)


@pytest.fixture(scope="module")
def port_outputs(tmp_path_factory):
    """Every rank's outputs: a world of 2, 4 and 8 for the DiT cases of
    each size, and a second world of 2 for the q/k norm, UMT5, the int8
    linears, joint attention and the tiled decode."""
    qk_x = np.random.default_rng(5).standard_normal((1, 6, 96),
                                                    dtype=np.float32)
    qk_w = 1 + 0.1 * np.random.default_rng(6).standard_normal(
        96).astype(np.float32)
    others = {
        "qk_norm": (ranks.tp_qk_norm, (qk_x, qk_w)),
        "t5": (ranks.t5_forward, ((1, 1, 2), dict(T5_ARCH, is_umt5=True),
                                  _port_state(_jax_t5()), *_t5_inputs())),
        "t5_loader": (ranks.t5_forward, (
            (1, 1, 2), dict(T5_ARCH, is_umt5=True), _port_state(_jax_t5()),
            *_t5_inputs(), "load_weights")),
        "t5_int8": (ranks.t5_forward, (
            (1, 1, 2), dict(T5_ARCH, is_umt5=True), _port_state(_jax_t5()),
            *_t5_inputs(), "load_weights_int8")),
        "int8": (ranks.int8_linears, _int8_inputs()),
        "joint": (ranks.joint_forward, (*_joint_inputs(), "FLASH_ATTN")),
        "decode": (ranks.tiled_decode, (VAE_ARCH, _port_state(_jax_vae()),
                                        _vae_latent(), TILE, STRIDE)),
    }
    # (world, DiT cases, other programs): the worlds run side by side
    jobs = [(w, [n for n, c in CASES.items() if int(np.prod(c[0])) == w], [])
            for w in (2, 4, 8)] + [(2, [], list(others))]
    started = [ranks.start(
        ranks.several, world,
        str(tmp_path_factory.mktemp(f"world{world}") / "store"),
        [(ranks.wan_forwards, ([_wan_case(n) for n in names],))] +
        [others[k] for k in extra])
        for world, names, extra in jobs]
    out = {}
    for (_, names, extra), handle in zip(jobs, started):
        per_rank = ranks.collect(handle)
        for i, name in enumerate(names):
            out[name] = [r[0][i] for r in per_rank]
        for j, key in enumerate(extra, start=1):
            out[key] = [r[j] for r in per_rank]
    return out


def _mesh(layout):
    import jax

    import fastvideo_tpu.parallel as par

    par.destroy_mesh()
    n = int(np.prod(layout))
    return par.init_mesh(par.MeshConfig(*layout), devices=jax.devices()[:n])


def _sharded(jmodel, mesh):
    from flax import nnx

    import fastvideo_tpu.parallel as par

    graphdef, state = nnx.split(jmodel)
    return nnx.merge(graphdef, par.shard_state(state, mesh))


def _jit_call(model, *args, method="__call__", **kwargs):
    """``model.method(*args)`` under ``jax.jit`` (one compile, not one an
    op), as a numpy tree."""
    import jax
    import jax.numpy as jnp
    from flax import nnx

    graphdef, state = nnx.split(model)

    def run(state, *a):  # pure: the cached model keeps its own arrays
        return getattr(nnx.merge(graphdef, state), method)(*a, **kwargs)

    out = jax.jit(run)(state, *(jnp.asarray(a) for a in args))
    return jax.tree.map(np.asarray, out)


def _close(outs, want):
    for rank, got in enumerate(outs):
        assert got.shape == want.shape, (rank, got.shape, want.shape)
        err = np.abs(got - want).max()
        assert err < TOL, (rank, err)


@pytest.mark.parametrize("name", list(CASES))
def test_wan_matches_jax_at_the_same_layout(name, port_outputs,
                                            jax_plain_attention):
    import fastvideo_tpu.parallel as par
    from fastvideo_tpu.forward_context import (AttentionMetadata,
                                               set_forward_context)

    case = _wan_case(name)
    layout = case["layout"]
    jmodel = _jax_wan(case["backend"], case["arch"]["num_attention_heads"])
    meta = AttentionMetadata(extra={"VSA_sparsity": case["sparsity"]})
    mesh = _mesh(layout)
    try:
        with par.mesh_context(mesh), set_forward_context(attn_metadata=meta):
            if layout[2] > 1:
                jmodel = _sharded(jmodel, mesh)
            want = _jit_call(jmodel, *(case[k] for k in ("x", "ctx", "ts")))
    finally:
        par.destroy_mesh()
    assert want.shape == case["x"].shape
    _close(port_outputs[name], want)


def test_tp_qk_norm_equals_the_unsharded_norm(port_outputs):
    """RMSNorm over all heads on a column-parallel output: each rank's
    features, normalized by the mean of squares summed over tp, equal the
    same features of the unsharded norm."""
    for got, want in port_outputs["qk_norm"]:
        assert got.shape == (1, 6, 48)
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)
    whole = np.concatenate([w for _, w in port_outputs["qk_norm"]], -1)
    assert not np.allclose(whole[..., :48], whole[..., 48:])


def _rank_slices(build, state, layout=(1, 1, 2)):
    """Each rank's ``shard_state`` of ``state`` and the model it builds
    under that rank's place in ``layout``."""
    from fastvideo_tpu_torch.parallel import mesh_context, shard_state
    from fastvideo_tpu_torch.parallel.mesh import Mesh
    from fastvideo_tpu_torch.parallel.shard import tp_axes_of

    out = []
    full = {k: torch.from_numpy(v) for k, v in state.items()}
    for rank in range(int(np.prod(layout))):
        mesh = Mesh(*layout, rank=rank)
        with mesh_context(mesh):
            model = build()
        axes = tp_axes_of(model)
        out.append((shard_state(full, mesh, axes=axes), model, axes))
    return full, out


# the port splits these where GSPMD computes over a replicated JAX leaf:
# the q/k norms act on column-parallel features, the bias table on heads
PORT_ONLY = ("norm_q.weight", "norm_k.weight", "norm_added_k.weight",
             "relative_attention_bias.weight")


@pytest.mark.parametrize("which", ["wan", "umt5"])
def test_shard_rule_slices_concatenate_to_the_full_weights(which):
    from flax import nnx

    from fastvideo_tpu_torch.configs.models.dits.wan import (
        WanArchConfig as TorchWanArchConfig)
    from fastvideo_tpu_torch.configs.models.encoders.t5 import (
        T5ArchConfig as TorchT5ArchConfig)
    from fastvideo_tpu_torch.models.dits.wan import (
        WanTransformer3DModel as TorchWan)
    from fastvideo_tpu_torch.models.encoders.t5 import (
        T5EncoderModel as TorchT5)
    from fastvideo_tpu_torch.models.loader.jax_params import (
        state_dict_from_jax)

    if which == "wan":
        jmodel = _jax_wan()
        build = functools.partial(TorchWan, TorchWanArchConfig(**ARCH),
                                  dtype=torch.float32)
    else:
        jmodel = _jax_t5()
        build = functools.partial(
            TorchT5, TorchT5ArchConfig(**T5_ARCH, is_umt5=True),
            dtype=torch.float32)
    full, per_rank = _rank_slices(build, _port_state(jmodel))
    axes = per_rank[0][2]
    # JAX's tp_axes, in the port's names and layout
    jax_split = {}
    for path, var in nnx.state(jmodel, nnx.Param).flat_state():
        tp_axes = getattr(var, "tp_axes", None)
        if tp_axes and "tp" in tp_axes:
            name = next(iter(state_dict_from_jax(
                {".".join(map(str, path)): np.zeros(var.get_value().shape)})))
            jax_split[name] = (tp_axes.index("tp") if len(tp_axes) == 1 else
                               1 - tp_axes.index("tp"))
    assert jax_split
    port_split = {n: a.index("tp") for n, a in axes.items() if "tp" in a}
    assert {n: d for n, d in port_split.items()
            if not n.endswith(PORT_ONLY)} == jax_split
    for name, t in full.items():
        slices = [s[name] for s, _, _ in per_rank]
        for (_, model, _), piece in zip(per_rank, slices):
            assert piece.shape == model.state_dict()[name].shape, name
        if name in port_split:
            d = port_split[name]
            assert slices[0].shape[d] * 2 == t.shape[d], name
            assert torch.equal(torch.cat(slices, d), t), name
        else:
            assert all(torch.equal(s, t) for s in slices), name


def test_fsdp_axis_splits_the_largest_free_dim():
    """``fsdp_axis`` adds the dp axis on the largest dim that tp left free
    and dp divides, for tensors of at least ``min_fsdp_size`` elements."""
    from fastvideo_tpu_torch.parallel import param_spec, shard_state
    from fastvideo_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(2, 1, 2, rank=3)  # dp index 1, tp index 1
    assert param_spec((8, 6), ("tp", None), mesh, "dp", 16) == ("tp", "dp")
    assert param_spec((8, 6), (None, "tp"), mesh, "dp", 16) == ("dp", "tp")
    assert param_spec((8, 6), None, mesh, "dp", 64) == (None, None)
    assert param_spec((5, 6), ("tp", None), mesh, "dp", 16) == (None, "dp")
    w = torch.arange(48.).reshape(8, 6)
    got = shard_state({"w": w}, mesh, "dp", 16, axes={"w": ("tp", None)})
    assert torch.equal(got["w"], w[4:, 3:])


def test_umt5_tp2_matches_jax(port_outputs):
    import fastvideo_tpu.parallel as par

    ids, mask = _t5_inputs()
    mesh = _mesh((1, 1, 2))
    try:
        with par.mesh_context(mesh):
            want = _jit_call(_sharded(_jax_t5(), mesh), ids,
                             mask).last_hidden_state
    finally:
        par.destroy_mesh()
    _close(port_outputs["t5"], want)


def test_umt5_tp2_through_the_loader(port_outputs):
    """``load_weights`` cuts each full checkpoint tensor to the rank's
    slice: the same output as ``shard_state``'s; into int8 weight-only
    slots (quantized whole, then cut) it gives the one-process int8
    encoder's output."""
    from fastvideo_tpu_torch.configs.models.encoders.t5 import (
        T5ArchConfig as TorchT5ArchConfig)
    from fastvideo_tpu_torch.layers.quantization.int8 import (
        QuantizationConfig, quantize_model_linears)
    from fastvideo_tpu_torch.models.encoders.t5 import (
        T5EncoderModel as TorchT5)
    from fastvideo_tpu_torch.models.loader.weight_utils import load_weights

    for got, want in zip(port_outputs["t5_loader"], port_outputs["t5"]):
        np.testing.assert_array_equal(got, want)
    model = TorchT5(TorchT5ArchConfig(**T5_ARCH, is_umt5=True),
                    device="meta", dtype=torch.float32)
    quantize_model_linears(model, QuantizationConfig(
        method="int8_weight_only"), init_only=True)
    load_weights(model, ((k, torch.from_numpy(v)) for k, v in
                         _port_state(_jax_t5()).items()),
                 device="cpu", dtype=torch.float32)
    ids, mask = _t5_inputs()
    with torch.no_grad():
        want = model(torch.from_numpy(ids),
                     torch.from_numpy(mask)).last_hidden_state.numpy()
    _close(port_outputs["t5_int8"], want)


def test_int8_linears_keep_the_split_and_the_unsplit_scales(port_outputs):
    """W8A8 at tp 2 equals the unsplit W8A8 layer bit for bit (the amax of
    a row-parallel layer's weight and activations over the whole row, the
    int32 partial products summed before the dequantize); weight-only
    within fp32 summation order. ``weight_q`` splits as the weight, the
    scale as the bias of a column layer and whole for a row layer."""
    axes = {"column": {"weight_q": ("tp", None), "scale": ("tp",),
                       "bias": ("tp",)},
            "row": {"weight_q": (None, "tp"), "scale": (None,),
                    "bias": (None,)}}
    per_rank = port_outputs["int8"]
    for mode in ("column", "row"):
        for weight_only in (False, True):
            outs = [r[(mode, weight_only)] for r in per_rank]
            want = outs[0][1]
            assert all(o[2] == axes[mode] for o in outs)
            if mode == "column":
                np.testing.assert_array_equal(
                    np.concatenate([o[0] for o in outs], -1), want)
            elif not weight_only:
                for got, _, _ in outs:
                    np.testing.assert_array_equal(got, want)
            else:
                for got, _, _ in outs:
                    np.testing.assert_allclose(got, want, atol=1e-5,
                                               rtol=1e-5)


def test_joint_forward_sp2_matches_jax(port_outputs, jax_plain_attention,
                                       monkeypatch):
    """Image tokens (9: padded to 10 over sp 2) and 5 text tokens."""
    import jax.numpy as jnp

    import fastvideo_tpu.parallel as par
    from fastvideo_tpu.attention.layer import DistributedAttention

    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "FLASH_ATTN")
    q, k, v, rq, rk, rv, cos, sin = _joint_inputs()
    pad = ((0, 0), (0, 1), (0, 0), (0, 0))
    attn = DistributedAttention(JOINT["heads"], JOINT["head_dim"],
                                supported_backends=("FLASH_ATTN",))
    mesh = _mesh((1, 2, 1))
    try:
        with par.mesh_context(mesh):
            img, txt = attn.joint_forward(
                *(jnp.asarray(np.pad(t, pad)) for t in (q, k, v)),
                *(jnp.asarray(t) for t in (rq, rk, rv)),
                freqs_cis=par.pad_rope_to(jnp.asarray(cos), jnp.asarray(sin),
                                          10), kv_valid=9)
    finally:
        par.destroy_mesh()
    img, txt = np.asarray(img)[:, :9], np.asarray(txt)
    per_rank = port_outputs["joint"]
    got_img = np.concatenate([i for i, _ in per_rank], axis=1)[:, :9]
    assert np.abs(got_img - img).max() < TOL
    _close([t for _, t in per_rank], txt)


def test_parallel_tiled_decode_over_two_ranks_matches_jax(port_outputs):
    import fastvideo_tpu.parallel as par

    mesh = _mesh((2, 1, 1))
    try:
        with par.mesh_context(mesh):
            want = _jit_call(_jax_vae(), _vae_latent(),
                             method="parallel_tiled_decode",
                             tile_latent_min=TILE, tile_latent_stride=STRIDE)
    finally:
        par.destroy_mesh()
    assert want.shape == (1, 3, 3, 16, 16)
    _close(port_outputs["decode"], want)
