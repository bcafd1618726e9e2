"""The port's CLIP towers, PIL-free resize and ``ClipDualTower`` against the
JAX package: both towers on JAX's parameters (``state_dict_from_jax``) in
fp32, with and without the text projection and under both pooling rules;
``preprocess_image`` against PIL and JAX's ``preprocess_image`` bit for
bit; and the dual tower and the CLIPScore / PickScore scorers on a
``text/ vision/ tokenizer/`` directory the test writes, which both
packages load (in bf16, the JAX loader's default), including the raise
when the text projection's width differs from the vision tower's."""

import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import PIL.Image
import pytest
import torch
from flax import nnx

from fastvideo_tpu.configs.models.encoders.clip import (
    CLIPVisionArchConfig as JVisionArch)
from fastvideo_tpu.models import clip_scoring as jscoring
from fastvideo_tpu.models.encoders import clip as jclip
from fastvideo_tpu.training.rl import rewards as jrewards
from fastvideo_tpu_torch.configs.models.encoders.clip import (
    CLIPTextArchConfig, CLIPVisionArchConfig)
from fastvideo_tpu_torch.models import clip_scoring as tscoring
from fastvideo_tpu_torch.models.encoders import clip as tclip
from fastvideo_tpu_torch.models.loader.jax_params import state_dict_from_jax
from fastvideo_tpu_torch.models.loader.safetensors_io import save_file
from fastvideo_tpu_torch.training.rl import rewards as trewards

sys.path.insert(0, os.path.dirname(__file__))

from test_torch_tokenizer_bpe import write_clip_tokenizer  # noqa: E402
from test_torch_wan_dit import jax_params, numpy_model  # noqa: E402

torch.set_num_threads(2)

VISION = dict(hidden_size=32, intermediate_size=64, num_hidden_layers=2,
              num_attention_heads=4, image_size=28, patch_size=14,
              num_channels=3, hidden_act="quick_gelu", layer_norm_eps=1e-5)
TEXT = dict(vocab_size=96, hidden_size=32, intermediate_size=48,
            num_hidden_layers=2, num_attention_heads=4,
            max_position_embeddings=77, hidden_act="quick_gelu",
            layer_norm_eps=1e-5)


def _vision_pair():
    jmodel = numpy_model(lambda: jclip.CLIPVisionModel(
        JVisionArch(**VISION), param_dtype=jnp.float32, rngs=nnx.Rngs(0)),
        seed=0)
    tmodel = tclip.CLIPVisionModel(CLIPVisionArchConfig(**VISION),
                                   dtype=torch.float32)
    tmodel.load_state_dict(state_dict_from_jax(jax_params(jmodel)),
                           strict=True)
    return jmodel, tmodel


def test_vision_tower_matches_jax():
    """The vision tower on JAX's parameters, fp32: the last hidden state
    within 1e-5 + 1e-5 |JAX| (fp32 rounding through two layers)."""
    jmodel, tmodel = _vision_pair()
    px = np.random.default_rng(1).standard_normal((2, 3, 28, 28)).astype(
        np.float32)
    want = np.asarray(jmodel(jnp.asarray(px)).last_hidden_state)
    with torch.no_grad():
        got = tmodel(torch.from_numpy(px)).last_hidden_state.numpy()
    assert got.shape == (2, 5, 32)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("projection_dim", [0, 24], ids=["pooled", "proj"])
@pytest.mark.parametrize("eos", [2, 95], ids=["eos2_argmax", "first_eos"])
def test_text_tower_matches_jax(projection_dim, eos):
    """The text tower on JAX's parameters, fp32, with and without the
    bias-free projection: pooled at argmax(ids) when eos_token_id is 2,
    else at the first EOS (ids hold it twice); with and without an
    attention mask. Hidden states and pooled output within 1e-5 +
    1e-5 |JAX|."""
    arch = dict(TEXT, eos_token_id=eos, projection_dim=projection_dim)
    jmodel = numpy_model(lambda: jclip.CLIPTextModel(
        jclip.CLIPTextArchConfig(**arch), param_dtype=jnp.float32,
        rngs=nnx.Rngs(0)), seed=2)
    tmodel = tclip.CLIPTextModel(CLIPTextArchConfig(**arch),
                                 dtype=torch.float32)
    tmodel.load_state_dict(state_dict_from_jax(jax_params(jmodel)),
                           strict=True)
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 90, (3, 16))
    ids[0, 5] = ids[0, 9] = eos
    ids[1, 2] = ids[1, 12] = eos
    ids[2, 15] = eos
    mask = (np.arange(16)[None] <= np.array([[9], [12], [15]])).astype(
        np.int64)
    for m in (None, mask):
        jout = jmodel(jnp.asarray(ids),
                      None if m is None else jnp.asarray(m))
        with torch.no_grad():
            tout = tmodel(torch.from_numpy(ids),
                          None if m is None else torch.from_numpy(m))
        np.testing.assert_allclose(tout.last_hidden_state.numpy(),
                                   np.asarray(jout.last_hidden_state),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(tout.pooler_output.numpy(),
                                   np.asarray(jout.pooler_output),
                                   rtol=1e-5, atol=1e-5)
    assert tout.pooler_output.shape == (3, projection_dim or 32)


@pytest.mark.parametrize("hw", [(480, 832), (100, 150), (37, 500)],
                         ids=["480x832", "upscale", "thin"])
def test_resize_and_preprocess_match_pil_and_jax(hw):
    """``resize_bicubic`` equals PIL's ``Image.resize((224, 224))`` bit for
    bit, and ``preprocess_image`` equals JAX's (over PIL) bit for bit."""
    img = np.random.default_rng(hw[0]).integers(0, 256, (*hw, 3),
                                                dtype=np.uint8)
    want = np.asarray(PIL.Image.fromarray(img).convert("RGB").resize(
        (224, 224)))
    assert np.array_equal(tclip.resize_bicubic(img, (224, 224)), want)
    cfg = CLIPVisionArchConfig()
    got = tclip.preprocess_image(img, cfg)
    jwant = jclip.preprocess_image(PIL.Image.fromarray(img), JVisionArch())
    assert got.dtype == jwant.dtype == np.float32
    assert np.array_equal(got, jwant)


def _write_dual_tower(root: str, projection_dim: int, seed: int = 0) -> str:
    """text/, vision/ and tokenizer/ that both packages load: the port
    modules' random fp32 weights under the JAX tree's names (the patch
    weight in HF's conv layout), a BPE tokenizer.json."""
    tok = write_clip_tokenizer(os.path.join(root, "tokenizer"))
    with open(os.path.join(tok, "tokenizer.json")) as fh:
        vocab = json.load(fh)["model"]["vocab"]
    torch.manual_seed(seed)
    text_cfg = dict(TEXT, vocab_size=len(vocab),
                    eos_token_id=vocab["<|endoftext|>"],
                    projection_dim=projection_dim)
    parts = {
        "text": ("CLIPTextModelWithProjection", text_cfg,
                 tclip.CLIPTextModel(CLIPTextArchConfig(**text_cfg))),
        "vision": ("CLIPVisionModelWithProjection", VISION,
                   tclip.CLIPVisionModel(CLIPVisionArchConfig(**VISION))),
    }
    for name, (cls, cfg, model) in parts.items():
        d = os.path.join(root, name)
        os.makedirs(d)
        with open(os.path.join(d, "config.json"), "w") as fh:
            json.dump({"architectures": [cls], **cfg}, fh)
        state = {k: v.detach().contiguous()
                 for k, v in model.state_dict().items()}
        key = "vision_model.embeddings.patch_embedding.weight"
        if key in state:
            p = VISION["patch_size"]
            state[key] = state[key].reshape(-1, 3, p, p).contiguous()
        save_file(state, os.path.join(d, "model.safetensors"))
    return root


def _media(seed: int) -> np.ndarray:
    """[B, C, T, H, W] in about [-0.1, 1.1]: the clip to [0, 1] and the
    truncating uint8 conversion both act."""
    return np.random.default_rng(seed).uniform(
        -0.1, 1.1, (3, 3, 2, 60, 104)).astype(np.float32)


PROMPTS = ["a photo of a cat", "a dog running under a blue sky",
           "It's 日本, café!"]


def test_dual_tower_and_scorers_match_jax(tmp_path, monkeypatch):
    """Text and frame embeddings of the port's ClipDualTower against JAX's
    on one checkpoint, both towers in bf16: frames (fp32 activations on
    bf16 weights, as JAX feeds fp32 pixels) within 1e-6 (measured 9e-8);
    prompts (bf16 activations, rounded at other places by XLA and
    PyTorch) within 1e-2 of the unit-norm embedding (measured 2.4e-3);
    the frame embedding is the unprojected mean of the vision tokens. The
    CLIPScore and PickScore scorers from their environment variables
    within 1e-2 and 100 / 26 times that."""
    root = _write_dual_tower(str(tmp_path / "ckpt"), VISION["hidden_size"])
    jt = jscoring.ClipDualTower(root)
    tt = tscoring.ClipDualTower(root, device="cpu")
    np.testing.assert_allclose(tt.embed_text(PROMPTS),
                               np.asarray(jt.embed_text(PROMPTS),
                                          np.float32), atol=1e-2)
    frames = _media(1)[:, :, 0]
    got = tt.embed_frames_chw(frames)
    np.testing.assert_allclose(got, np.asarray(jt.embed_frames_chw(frames),
                                               np.float32), atol=1e-6)
    assert got.shape == (3, VISION["hidden_size"])
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, rtol=1e-6)
    for env in ("FASTVIDEO_CLIPSCORE_WEIGHTS", "FASTVIDEO_PICKSCORE_WEIGHTS"):
        monkeypatch.setenv(env, root)
    media = _media(2)
    for jcls, tcls, scale in (
            (jrewards.ClipScoreScorer, trewards.ClipScoreScorer, 1.0),
            (jrewards.PickScoreScorer, trewards.PickScoreScorer, 100 / 26)):
        want = jcls()(media, PROMPTS)
        score = tcls(device="cpu")(media, PROMPTS)
        assert score.shape == (3,) and score.dtype == np.float32
        np.testing.assert_allclose(score, want, atol=1e-2 * scale)
    multi = trewards.build_multi_reward_scorer(
        {"clipscore": 1.0, "pickscore": 0.5}, device="cpu")
    out = multi(media, PROMPTS)
    np.testing.assert_allclose(out["avg"], out["clipscore"] +
                               0.5 * out["pickscore"], rtol=1e-6)


def test_unequal_widths_raise_as_jax(tmp_path, monkeypatch):
    """With a text projection of 24 on a vision tower of 32 (as CLIP-L's
    768 against 1024), the scorer's dot product raises in both packages;
    the missing checkpoint raises naming the environment variable."""
    root = _write_dual_tower(str(tmp_path / "ckpt"), 24)
    media = _media(3)
    monkeypatch.setenv("FASTVIDEO_CLIPSCORE_WEIGHTS", root)
    with pytest.raises(ValueError):
        jrewards.ClipScoreScorer()(media, PROMPTS)
    with pytest.raises(ValueError):
        trewards.ClipScoreScorer(device="cpu")(media, PROMPTS)
    monkeypatch.delenv("FASTVIDEO_PICKSCORE_WEIGHTS", raising=False)
    with pytest.raises(FileNotFoundError,
                       match="FASTVIDEO_PICKSCORE_WEIGHTS"):
        trewards.build_multi_reward_scorer({"pickscore": 1.0},
                                           device="cpu")
