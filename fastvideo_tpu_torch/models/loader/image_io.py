"""Images and frames without PIL or imageio (neither is on the card's
machine): a PNG reader, ``.npy`` images and videos, and Pillow's 8-bit
resampling.

:func:`read_png` decodes 8-bit non-interlaced PNGs in the modes L, LA, RGB,
RGBA and P (colour types 0, 4, 2, 6 and 3): the IDAT stream through
``zlib``, the five scanline filters undone, then converted as PIL's
``Image.open(path).convert("RGB")`` converts (grey replicated, alpha
dropped, palette looked up). :func:`load_image` reads a PNG or a ``.npy``
[H, W, 3] image; :func:`load_video_frames` a ``.npy`` [T, H, W, 3] clip.
JPEG, interlaced or 16-bit PNGs and video containers raise: they wait on
ROADMAP Queue 1.

:func:`resize_bicubic` and :func:`resize_lanczos` give what
``PIL.Image.resize(size, BICUBIC / LANCZOS)`` gives for a uint8 RGB image:
Pillow's separable fixed-point passes (``ImagingResample``), the filter's
support widened by the shrink factor, coefficients normalised and rounded
to 22 fraction bits, a horizontal then a vertical pass, each rounded and
clamped to uint8.
"""

from __future__ import annotations

import math
import struct
import zlib
from collections.abc import Callable

import numpy as np

UNPORTED = ("ROADMAP Queue 1 (JPEG, mp4 and .arrow readers): the card's "
            "machine has neither PIL nor imageio")

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> (mode, channels)
_COLOR_TYPES = {0: ("L", 1), 2: ("RGB", 3), 3: ("P", 1), 4: ("LA", 2),
                6: ("RGBA", 4)}


def _unfilter(raw: bytes, height: int, width: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters (None, Sub, Up, Average, Paeth) of a
    non-interlaced 8-bit image: [height, width * bpp] uint8."""
    stride = width * bpp
    if len(raw) < height * (stride + 1):
        raise ValueError("PNG image data is truncated")
    rows = np.frombuffer(raw, np.uint8)[:height * (stride + 1)].reshape(
        height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:  # Sub: a running sum mod 256 along each channel
            cur = np.cumsum(line.reshape(width, bpp).astype(np.int64),
                            axis=0).astype(np.uint8).reshape(stride)
        elif kind == 2:  # Up
            cur = line + prev
        elif kind in (3, 4):
            # Average and Paeth: each byte depends on the one bpp to its
            # left, so walk the bytes (as Python ints)
            a, b = line.tolist(), prev.tolist()
            c = [0] * stride
            for x in range(stride):
                left = c[x - bpp] if x >= bpp else 0
                if kind == 3:
                    pred = (left + b[x]) >> 1
                else:
                    up, ul = b[x], (b[x - bpp] if x >= bpp else 0)
                    p = left + up - ul
                    pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
                    pred = (left if pa <= pb and pa <= pc else
                            up if pb <= pc else ul)
                c[x] = (a[x] + pred) & 0xFF
            cur = np.asarray(c, np.uint8)
        else:
            raise ValueError(f"PNG filter type {kind} is not one of 0-4")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """An 8-bit non-interlaced PNG as PIL's ``.convert("RGB")`` gives it:
    uint8 [H, W, 3]."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(PNG_SIGNATURE):
        raise NotImplementedError(f"{path}: not a PNG; {UNPORTED}")
    pos, header, palette, idat = len(PNG_SIGNATURE), None, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or interlace or color not in _COLOR_TYPES:
        raise NotImplementedError(
            f"{path}: PNG of bit depth {depth}, colour type {color}, "
            f"interlace {interlace}; the port reads 8-bit non-interlaced L, "
            f"LA, RGB, RGBA and P images. {UNPORTED}")
    mode, channels = _COLOR_TYPES[color]
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height, width,
                       channels).reshape(height, width, channels)
    if mode in ("L", "LA"):
        return np.repeat(pixels[..., :1], 3, axis=-1)
    if mode in ("RGB", "RGBA"):
        return np.ascontiguousarray(pixels[..., :3])
    if palette is None:
        raise ValueError(f"{path}: palette image without PLTE")
    table = np.zeros((256, 3), np.uint8)
    table[:len(palette)] = palette[:256]
    return table[pixels[..., 0]]


def load_image(path: str) -> np.ndarray:
    """A PNG or a ``.npy`` uint8 [H, W, 3] image as uint8 [H, W, 3]."""
    if path.lower().endswith(".npy"):
        img = np.load(path)
        if img.ndim != 3 or img.shape[-1] != 3:
            raise ValueError(f"{path}: a .npy image is [H, W, 3], got "
                             f"{img.shape}")
        return np.asarray(img, np.uint8)
    return read_png(path)


def load_video_frames(path: str) -> np.ndarray:
    """A ``.npy`` clip [T, H, W, 3], as it was saved."""
    if not path.lower().endswith(".npy"):
        raise NotImplementedError(f"{path}: the port reads .npy clips only; "
                               f"{UNPORTED}")
    return np.load(path)


# -- Pillow's 8-bit resample ---------------------------------------------------

# Pillow's fixed-point precision of the 8-bit resample passes
_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    """Pillow's bicubic kernel (a = -0.5), support 2."""
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _sinc(x: float) -> float:
    if x == 0.0:
        return 1.0
    x = x * math.pi
    return math.sin(x) / x


def _lanczos(x: np.ndarray) -> np.ndarray:
    """Pillow's Lanczos kernel, sinc(x) sinc(x / 3) on [-3, 3), with C's
    ``sin`` (``math.sin``) for its values."""
    flat = [(_sinc(v) * _sinc(v / 3) if -3.0 <= v < 3.0 else 0.0)
            for v in np.asarray(x, np.float64).ravel().tolist()]
    return np.asarray(flat, np.float64).reshape(np.shape(x))


# filter -> (kernel, support)
_FILTERS: dict[str, tuple[Callable[[np.ndarray], np.ndarray], float]] = {
    "bicubic": (_bicubic, 2.0),
    "lanczos": (_lanczos, 3.0),
}


def _resample_coeffs(in_size: int, out_size: int, kernel, support: float
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's ``precompute_coeffs`` for the box (0, in_size), with
    ``normalize_coeffs_8bpc``'s rounding: (first source index [out], int
    coefficients [out, ksize]; taps past a row's window are 0)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    # C's (int) truncates toward zero; a negative start is clamped to 0
    xmin = np.maximum(np.trunc(center - support + 0.5), 0).astype(np.int64)
    xmax = np.minimum(np.trunc(center + support + 0.5), in_size).astype(
        np.int64) - xmin
    taps = np.arange(ksize)
    w = kernel((taps[None] + xmin[:, None] - center[:, None] + 0.5) *
               (1.0 / filterscale))
    w = np.where(taps[None] < xmax[:, None], w, 0.0)
    total = np.zeros(out_size)
    for t in range(ksize):  # C's order of the sum
        total = total + w[:, t]
    total = total[:, None]
    w = np.where(total != 0.0, w / np.where(total != 0.0, total, 1.0), w)
    fixed = w * (1 << _PRECISION_BITS)
    kk = np.where(w < 0, np.trunc(-0.5 + fixed), np.trunc(0.5 + fixed))
    return xmin, kk.astype(np.int64)


def _resample_axis(img: np.ndarray, out_size: int, axis: int,
                   filter_name: str) -> np.ndarray:
    """One 8-bit pass of Pillow's resample along ``axis`` (0 rows, 1
    columns) of a uint8 [H, W, C] image: the fixed-point sum from the
    rounding half, then the floor shift and the clamp to [0, 255]."""
    in_size = img.shape[axis]
    xmin, kk = _resample_coeffs(in_size, out_size, *_FILTERS[filter_name])
    idx = np.minimum(xmin[:, None] + np.arange(kk.shape[1])[None],
                     in_size - 1)
    src = np.take(img.astype(np.int64), idx, axis=axis)
    if axis == 0:  # [out, k, W, C]
        acc = np.einsum("okwc,ok->owc", src, kk)
    else:  # [H, out, k, C]
        acc = np.einsum("hokc,ok->hoc", src, kk)
    acc = acc + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize(img: np.ndarray, size: tuple[int, int],
           filter_name: str) -> np.ndarray:
    """Pillow's ``resize`` of a uint8 [H, W, C] image to ``size`` =
    (width, height), as PIL's, with the named filter: the horizontal pass,
    then the vertical one, each only where its size changes."""
    out_w, out_h = size
    out = np.asarray(img, np.uint8)
    if out.shape[1] != out_w:
        out = _resample_axis(out, out_w, 1, filter_name)
    if out.shape[0] != out_h:
        out = _resample_axis(out, out_h, 0, filter_name)
    return out


def resize_bicubic(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``PIL.Image.fromarray(img).resize(size)`` (Pillow's default bicubic
    resample) for a uint8 [H, W, 3] image; ``size`` is (width, height)."""
    return resize(img, size, "bicubic")


def resize_lanczos(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """``PIL.Image.fromarray(img).resize(size, PIL.Image.LANCZOS)`` for a
    uint8 [H, W, 3] image; ``size`` is (width, height)."""
    return resize(img, size, "lanczos")
