"""Image preprocessing for conditioning inputs (port of
fastvideo_tpu/image_processor.py): uint8 or float [H, W, 3] arrays ->
[-1, 1] float32 images whose sides are multiples of the VAE's scale
factor (center crop to the ratio, then the antialiased bilinear resize).

A PIL image raises: the card's machine has no PIL, and the port reads
images with ``models/loader/image_io.py``.
"""

from __future__ import annotations

import numpy as np

from fastvideo_tpu_torch.dataset.transform import center_crop_th_tw, resize
from fastvideo_tpu_torch.models.loader.image_io import UNPORTED


class ImageProcessor:

    def __init__(self, vae_scale_factor: int = 8):
        self.vae_scale_factor = vae_scale_factor

    @staticmethod
    def _to_array(image) -> np.ndarray:
        """np.ndarray [H, W, 3] (or [H, W]) uint8 / float -> float32
        [H, W, 3]."""
        if hasattr(image, "convert"):
            raise NotImplementedError(
                "ImageProcessor takes uint8 or float arrays; a PIL image "
                f"is not ported. {UNPORTED}")
        image = np.asarray(image)
        if image.ndim == 2:
            image = np.stack([image] * 3, axis=-1)
        if image.dtype == np.uint8:
            image = image.astype(np.float32) / 255.0
        return image.astype(np.float32)

    def get_default_height_width(self, image, height: int | None = None,
                                 width: int | None = None):
        arr = self._to_array(image)
        h = height or arr.shape[0]
        w = width or arr.shape[1]
        f = self.vae_scale_factor
        return h - h % f, w - w % f

    def preprocess(self, image, height: int | None = None,
                   width: int | None = None) -> np.ndarray:
        """-> [1, 3, H, W] float32 in [-1, 1], H and W multiples of the VAE
        scale factor."""
        arr = self._to_array(image)
        h, w = self.get_default_height_width(arr, height, width)
        clip = arr.transpose(2, 0, 1)[None]
        clip = center_crop_th_tw(clip, h, w)
        clip = resize(clip, (h, w))
        return clip * 2.0 - 1.0

    def preprocess_video_frame(self, image, height: int | None = None,
                               width: int | None = None) -> np.ndarray:
        """-> [1, 3, 1, H, W] (a one-frame video)."""
        return self.preprocess(image, height, width)[:, :, None]
