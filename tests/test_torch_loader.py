"""The port's safetensors reader/writer against the ``safetensors``
package, state_dict_from_jax against the JAX exporter, and the strict
two-way checkpoint load."""

import os
import sys

import jax
import numpy as np
import pytest
import torch
from flax import nnx

from fastvideo_tpu.configs.models.dits.wan import WanArchConfig
from fastvideo_tpu.configs.models.encoders.t5 import T5ArchConfig
from fastvideo_tpu.configs.models.vaes.wan import WanVAEArchConfig
from fastvideo_tpu.models.dits.wan import WanTransformer3DModel
from fastvideo_tpu.models.encoders.t5 import T5EncoderModel
from fastvideo_tpu.models.loader.export import export_torch_layout
from fastvideo_tpu.models.vaes.wan import AutoencoderKLWan
from fastvideo_tpu_torch.configs.models.dits.wan import (
    WanArchConfig as TorchWanArchConfig)
from fastvideo_tpu_torch.configs.models.encoders.t5 import (
    T5ArchConfig as TorchT5ArchConfig)
from fastvideo_tpu_torch.configs.models.vaes.wan import (
    WanVAEArchConfig as TorchWanVAEArchConfig)
from fastvideo_tpu_torch.models.dits.wan import (
    WanTransformer3DModel as TorchWanTransformer3DModel)
from fastvideo_tpu_torch.models.encoders.t5 import (
    T5EncoderModel as TorchT5EncoderModel)
from fastvideo_tpu_torch.models.loader import safetensors_io
from fastvideo_tpu_torch.models.loader.jax_params import state_dict_from_jax
from fastvideo_tpu_torch.models.loader.weight_utils import load_weights
from fastvideo_tpu_torch.models.vaes.wan import (
    AutoencoderKLWan as TorchAutoencoderKLWan)

sys.path.insert(0, os.path.dirname(__file__))

from utils import TINY_DIT, TINY_T5, TINY_VAE  # noqa: E402

torch.set_num_threads(2)


def _tensors():
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.standard_normal((6, 10), dtype=np.float32))
    return {
        "f32": torch.from_numpy(rng.standard_normal((3, 4, 5),
                                                    dtype=np.float32)),
        "bf16": base.to(torch.bfloat16),
        "transposed": base.t(),  # non-contiguous
        "i64": torch.arange(7, dtype=torch.int64),
        "scalar": torch.tensor(2.5),
    }


def test_writer_round_trips_through_safetensors(tmp_path):
    from safetensors.torch import load_file

    tensors = _tensors()
    path = str(tmp_path / "a.safetensors")
    safetensors_io.save_file(tensors, path)
    back = load_file(path)
    assert set(back) == set(tensors)
    for name, t in tensors.items():
        assert back[name].dtype == t.dtype
        assert torch.equal(back[name], t), name


def test_reader_round_trips_from_safetensors(tmp_path):
    from safetensors.torch import save_file

    tensors = {k: v.contiguous() for k, v in _tensors().items()}
    path = str(tmp_path / "b.safetensors")
    save_file(tensors, path, metadata={"format": "pt"})
    back = safetensors_io.load_file(path)
    assert set(back) == set(tensors)
    for name, t in tensors.items():
        assert back[name].dtype == t.dtype
        assert torch.equal(back[name], t), name
    # the mapped tensors are writable copies-on-write of the file
    back["f32"].add_(1.0)
    assert torch.equal(safetensors_io.load_file(path)["f32"], tensors["f32"])


def _arch(cls, cfg):
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in cfg.items() if k != "model_type"})


def _flat(model):
    return {".".join(map(str, p)): np.asarray(v.get_value())
            for p, v in nnx.state(model, nnx.Param).flat_state()}


@pytest.mark.parametrize("which", ["dit_vsa", "t5", "vae"])
def test_state_dict_from_jax_equals_the_exported_checkpoint(which,
                                                            monkeypatch):
    """Keys and values equal export_torch_layout's, and the port module
    takes them strictly (VAE: both halves)."""
    monkeypatch.setenv("FASTVIDEO_ATTENTION_BACKEND", "VIDEO_SPARSE_ATTN")
    if which == "dit_vsa":
        jm = nnx.eval_shape(lambda: WanTransformer3DModel(
            _arch(WanArchConfig, TINY_DIT), rngs=nnx.Rngs(0)))
        tm = TorchWanTransformer3DModel(_arch(TorchWanArchConfig, TINY_DIT),
                                        device="meta")
    elif which == "t5":
        jm = nnx.eval_shape(lambda: T5EncoderModel(
            _arch(T5ArchConfig, TINY_T5), rngs=nnx.Rngs(0)))
        tm = TorchT5EncoderModel(_arch(TorchT5ArchConfig, TINY_T5),
                                 device="meta")
    else:
        jm = nnx.eval_shape(lambda: AutoencoderKLWan(
            _arch(WanVAEArchConfig, TINY_VAE), rngs=nnx.Rngs(0)))
        tm = TorchAutoencoderKLWan(_arch(TorchWanVAEArchConfig, TINY_VAE),
                                   device="meta")
    # give every abstract leaf a distinct value so a wrong layout shows
    graphdef, state = nnx.split(jm)
    rng = np.random.default_rng(1)
    state = jax.tree.map(
        lambda s: np.asarray(rng.standard_normal(s.shape), np.float32), state)
    jm = nnx.merge(graphdef, state)
    exported = export_torch_layout(jm)
    ours = state_dict_from_jax(_flat(jm))
    assert set(ours) == set(exported)
    for k, v in exported.items():
        np.testing.assert_array_equal(ours[k].numpy(), v, err_msg=k)
    n = load_weights(tm, ours.items(), device="cpu", dtype=torch.float32)
    assert n == len(tm.state_dict())
    assert set(tm.state_dict()) == set(ours)


def test_load_is_strict_both_ways():
    cfg = _arch(TorchT5ArchConfig, TINY_T5)
    full = TorchT5EncoderModel(cfg, dtype=torch.float32).state_dict()
    with pytest.raises(KeyError, match="missing"):
        load_weights(TorchT5EncoderModel(cfg, device="meta"),
                     list(full.items())[1:], device="cpu",
                     dtype=torch.float32)
    extra = dict(full, **{"blocks.0.self_attn.extra.weight": torch.zeros(1)})
    with pytest.raises(KeyError, match="no matching parameter"):
        load_weights(TorchT5EncoderModel(cfg, device="meta"), extra.items(),
                     device="cpu", dtype=torch.float32)
