"""The port's preprocessing transforms and ImageProcessor against the JAX
package's on the CPU.

Tolerances: the antialiased bilinear resize within 1e-5 of
``jax.image.resize(method="bilinear")`` relative to the largest magnitude
(fp32 on both sides: the same weights, products summed in another order;
XLA's CPU einsum itself sits about 7e-6 of that magnitude from an fp64
product at 720x1280 -> 480x832). Crops, draws and shapes are exact.
"""

import random

import numpy as np
import PIL.Image
import pytest
import torch

from fastvideo_tpu.dataset import transform as jt
from fastvideo_tpu.image_processor import ImageProcessor as JaxProcessor
from fastvideo_tpu_torch.dataset import transform as tt
from fastvideo_tpu_torch.image_processor import ImageProcessor

torch.set_num_threads(2)


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = float(np.abs(want).max())
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"max abs err {err:.3e}, scale {scale:.3e}"


@pytest.mark.parametrize("src,dst", [
    ((1080, 1920), (480, 832)),  # 1080p down to Wan's 480p
    ((720, 1280), (480, 832)),   # 720p: a non-integer scale
    ((30, 44), (48, 70)),        # upscale: the kernel is not widened
    ((33, 47), (33, 47)),        # identity
    ((35, 47), (20, 47)),        # one axis only
])
def test_resize_matches_jax_image_resize(src, dst):
    rng = np.random.default_rng(sum(src))
    clip = rng.uniform(0, 255, (1, 3, *src)).astype(np.float32)
    want = jt.resize(clip, dst)
    _close(tt.resize(clip, dst), want)
    # a tensor comes back a tensor, on its device
    got = tt.resize(torch.from_numpy(clip), dst)
    assert isinstance(got, torch.Tensor)
    _close(got.numpy(), want)


@pytest.mark.parametrize("hw", [(45, 61), (61, 45), (48, 83)])
@pytest.mark.parametrize("top_crop", [False, True])
def test_center_crop_and_resize_match_jax(hw, top_crop):
    rng = np.random.default_rng(hw[0])
    clip = rng.integers(0, 256, (2, 3, *hw)).astype(np.uint8)
    want = jt.center_crop_th_tw(clip, 16, 24, top_crop=top_crop)
    got = tt.center_crop_th_tw(clip, 16, 24, top_crop=top_crop)
    np.testing.assert_array_equal(got, want)
    jf = jt.Compose([jt.CenterCropResizeVideo((16, 24), top_crop=top_crop),
                     jt.Normalize255()])
    tf = tt.Compose([tt.CenterCropResizeVideo((16, 24), top_crop=top_crop),
                     tt.Normalize255()])
    _close(tf(clip), jf(clip))
    assert repr(tt.CenterCropResizeVideo((16, 24))) == \
        repr(jt.CenterCropResizeVideo((16, 24)))


def test_crop_and_normalize():
    clip = np.arange(2 * 3 * 5 * 7, dtype=np.uint8).reshape(2, 3, 5, 7)
    np.testing.assert_array_equal(tt.crop(clip, 1, 2, 3, 4),
                                  jt.crop(clip, 1, 2, 3, 4))
    with pytest.raises(ValueError):
        tt.crop(clip[0], 0, 0, 1, 1)
    np.testing.assert_array_equal(tt.normalize_video(clip),
                                  jt.normalize_video(clip))
    assert torch.equal(tt.normalize_video(torch.from_numpy(clip)),
                       torch.from_numpy(jt.normalize_video(clip)))
    with pytest.raises(ValueError):
        tt.resize(clip, (4,))


def test_temporal_random_crop_draws_as_jax():
    """Both draw from Python's global ``random``: seeded alike, the windows
    are the same, draw for draw."""
    totals = [81, 100, 30, 81, 200, 5, 82]
    random.seed(7)
    want = [jt.TemporalRandomCrop(81)(n) for n in totals]
    random.seed(7)
    got = [tt.TemporalRandomCrop(81)(n) for n in totals]
    assert got == want
    assert len({b for b, _ in got}) > 1


@pytest.mark.parametrize("kind", ["uint8", "float", "gray"])
def test_image_processor_matches_jax(kind):
    rng = np.random.default_rng(3)
    if kind == "uint8":
        img = rng.integers(0, 256, (45, 70, 3)).astype(np.uint8)
    elif kind == "float":
        img = rng.uniform(0, 1, (45, 70, 3)).astype(np.float32)
    else:
        img = rng.integers(0, 256, (45, 70)).astype(np.uint8)
    jp, tp = JaxProcessor(8), ImageProcessor(8)
    assert tp.get_default_height_width(img) == \
        jp.get_default_height_width(img) == (40, 64)
    _close(tp.preprocess(img), jp.preprocess(img))
    _close(tp.preprocess(img, 32, 48), jp.preprocess(img, 32, 48))
    _close(tp.preprocess_video_frame(img), jp.preprocess_video_frame(img))


def test_image_processor_refuses_pil():
    img = PIL.Image.fromarray(np.zeros((16, 16, 3), np.uint8))
    assert JaxProcessor(8).preprocess(img).shape == (1, 3, 16, 16)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1"):
        ImageProcessor(8).preprocess(img)
