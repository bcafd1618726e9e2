"""Video transforms for preprocessing (port of
fastvideo_tpu/dataset/transform.py): aspect-preserving center crop to a
target ratio, bilinear resize, 255-normalize and a temporal random crop.

Clips are [T, C, H, W] numpy arrays or tensors; a tensor is transformed on
its own device, an array on the CPU, and each comes back as it came.

:func:`resize` is ``jax.image.resize(..., method="bilinear")``, whose
antialiasing is on: each axis is a product with a weight matrix whose
columns are a triangle kernel, widened by the scale when the axis shrinks,
normalised per output pixel and zeroed where the sample falls outside the
input (``jax.image.scale_and_translate``'s rule, in fp32). An axis whose
size does not change is left as it is.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def _as_tensor(clip) -> tuple[torch.Tensor, bool]:
    if isinstance(clip, torch.Tensor):
        return clip, False
    return torch.from_numpy(np.ascontiguousarray(clip)), True


def crop(clip, i: int, j: int, h: int, w: int):
    """clip [T, C, H, W] -> spatial crop."""
    if clip.ndim != 4:
        raise ValueError("clip should be a 4D array [T, C, H, W]")
    return clip[..., i:i + h, j:j + w]


def resize_weights(in_size: int, out_size: int,
                   device: torch.device | str = "cpu") -> torch.Tensor:
    """[in_size, out_size] fp32 weights of the antialiased bilinear
    resize of one axis (``jax.image.compute_weight_mat`` with the triangle
    kernel and no translation)."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    f32 = dict(dtype=torch.float32, device=device)
    sample = ((torch.arange(out_size, **f32) + 0.5) *
              torch.tensor(inv_scale, **f32) - 0.5)
    x = (sample[None, :] - torch.arange(in_size, **f32)[:, None]).abs() / \
        torch.tensor(kernel_scale, **f32)
    weights = (1 - x.abs()).clamp_min(0)
    total = weights.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    weights = torch.where(total.abs() > eps,
                          weights / torch.where(total != 0, total,
                                                torch.ones_like(total)),
                          torch.zeros_like(weights))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], weights, torch.zeros_like(weights))


def resize(clip, target_size: tuple[int, int]):
    """Antialiased bilinear resize [T, C, H, W] -> [T, C, th, tw], fp32."""
    if len(target_size) != 2:
        raise ValueError("target size should be (height, width)")
    x, was_numpy = _as_tensor(clip)
    x = x.to(torch.float32)
    (h, w), (th, tw) = x.shape[-2:], target_size
    if w != tw:
        x = x @ resize_weights(w, tw, x.device)
    if h != th:
        x = (x.transpose(-1, -2) @ resize_weights(h, th, x.device)
             ).transpose(-1, -2)
    x = x.contiguous()
    return x.numpy() if was_numpy else x


def center_crop_th_tw(clip, th: int, tw: int, top_crop: bool = False):
    """Crop to the target aspect ratio th/tw, centered (or top-aligned)."""
    h, w = clip.shape[-2], clip.shape[-1]
    tr = th / tw
    if h / w > tr:
        new_h, new_w = int(w * tr), w
    else:
        new_h, new_w = h, int(h / tr)
    i = 0 if top_crop else int(round((h - new_h) / 2.0))
    j = int(round((w - new_w) / 2.0))
    return crop(clip, i, j, new_h, new_w)


def normalize_video(clip):
    """uint8 [0, 255] -> float32 [0, 1]."""
    if isinstance(clip, torch.Tensor):
        return clip.to(torch.float32) / 255.0
    return np.asarray(clip, np.float32) / 255.0


class CenterCropResizeVideo:
    """Aspect-ratio center crop then resize to (height, width)."""

    def __init__(self, size: tuple[int, int], top_crop: bool = False):
        if len(size) != 2:
            raise ValueError("size should be (height, width)")
        self.size = tuple(size)
        self.top_crop = top_crop

    def __call__(self, clip):
        cropped = center_crop_th_tw(clip, self.size[0], self.size[1],
                                    top_crop=self.top_crop)
        return resize(cropped, self.size)

    def __repr__(self) -> str:
        return f"{type(self).__name__}(size={self.size})"


class Normalize255:
    def __call__(self, clip):
        return normalize_video(clip)

    def __repr__(self) -> str:
        return type(self).__name__


class TemporalRandomCrop:
    """Pick a random [begin, end) window of ``size`` frames, drawn from
    Python's global ``random`` as the JAX package draws it."""

    def __init__(self, size: int):
        self.size = size

    def __call__(self, total_frames: int) -> tuple[int, int]:
        rand_end = max(0, total_frames - self.size - 1)
        begin = random.randint(0, rand_end)
        return begin, min(begin + self.size, total_frames)


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, clip):
        for t in self.transforms:
            clip = t(clip)
        return clip
