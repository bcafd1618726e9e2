"""Port (U)MT5 encoder against the JAX T5EncoderModel at the tiny test
config, and the port's tokenizer reader against transformers.AutoTokenizer
on a make_word_level_tokenizer directory."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import nnx

from fastvideo_tpu.configs.models.encoders.t5 import T5ArchConfig
from fastvideo_tpu.models.encoders.t5 import T5EncoderModel
from fastvideo_tpu.models.loader.export import make_word_level_tokenizer
from fastvideo_tpu_torch.configs.models.encoders.t5 import (
    T5ArchConfig as TorchT5ArchConfig)
from fastvideo_tpu_torch.models.encoders.t5 import (
    T5EncoderModel as TorchT5EncoderModel)
from fastvideo_tpu_torch.models.loader.jax_params import state_dict_from_jax
from fastvideo_tpu_torch.models.loader.tokenizer import WordLevelTokenizer

sys.path.insert(0, os.path.dirname(__file__))

from utils import TINY_T5  # noqa: E402

torch.set_num_threads(2)


@pytest.mark.parametrize("is_umt5", [True, False], ids=["umt5", "t5"])
def test_t5_encoder_matches_jax(is_umt5):
    kw = {k: v for k, v in TINY_T5.items() if k != "model_type"}
    jmodel = T5EncoderModel(T5ArchConfig(**kw, is_umt5=is_umt5),
                            param_dtype=jnp.float32, rngs=nnx.Rngs(2))
    flat = {".".join(map(str, p)): np.asarray(v.get_value())
            for p, v in nnx.state(jmodel, nnx.Param).flat_state()}
    tmodel = TorchT5EncoderModel(TorchT5ArchConfig(**kw, is_umt5=is_umt5),
                                 dtype=torch.float32)
    tmodel.load_state_dict(state_dict_from_jax(flat), strict=True)

    rng = np.random.default_rng(0)
    ids = rng.integers(0, TINY_T5["vocab_size"], (2, 16))
    mask = np.ones((2, 16), np.int64)
    mask[1, 9:] = 0
    want = jmodel(jnp.asarray(ids), jnp.asarray(mask)).last_hidden_state
    with torch.no_grad():
        got = tmodel(torch.from_numpy(ids),
                     torch.from_numpy(mask)).last_hidden_state
    # fp32 through 2 blocks: summation order only
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


def test_tokenizer_matches_transformers(tmp_path):
    from transformers import AutoTokenizer

    make_word_level_tokenizer(str(tmp_path), 128)
    hf = AutoTokenizer.from_pretrained(str(tmp_path))
    ours = WordLevelTokenizer.from_pretrained(str(tmp_path))
    words = [f"w{i}" for i in range(130)]
    prompts = [
        "w1 w2 w3",
        "w5, w7!! unknown w9.",
        "",
        "w3</s> w4 <pad>",
        " ".join(words[i % 130] for i in range(600)),  # over 512 tokens
    ]
    for max_length in (512, 16):
        want = hf(prompts, padding="max_length", max_length=max_length,
                  truncation=True, return_tensors="np")
        got = ours(prompts, padding="max_length", max_length=max_length,
                   truncation=True, return_tensors="np")
        np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
        np.testing.assert_array_equal(got["attention_mask"],
                                      want["attention_mask"])


def test_tokenizer_rejects_other_models(tmp_path):
    (tmp_path / "tokenizer.json").write_text(
        '{"model": {"type": "BPE"}, "pre_tokenizer": null}')
    with pytest.raises(NotImplementedError, match="BPE"):
        WordLevelTokenizer.from_pretrained(str(tmp_path))
