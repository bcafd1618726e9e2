"""The port's PNG reader and Pillow resampling against PIL (the sandbox's
Pillow writes the fixtures and gives the expected arrays). Everything here
is exact: uint8 arrays equal bit for bit."""

import os

import numpy as np
import PIL.Image
import pytest

from fastvideo_tpu_torch.models.loader import image_io


def _image(h, w, seed=0):
    rng = np.random.default_rng(seed)
    # smooth ramps plus noise, so that every PNG filter is worth choosing
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 255 / max(w - 1, 1), yy * 255 / max(h - 1, 1),
                     (xx + yy) * 127 / max(h + w - 2, 1)], -1)
    noisy = base + rng.normal(0, 20, (h, w, 3))
    return np.clip(noisy, 0, 255).astype(np.uint8)


def _save(tmp_path, img: PIL.Image.Image, name: str, **kw) -> str:
    path = str(tmp_path / name)
    img.save(path, **kw)
    return path


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
@pytest.mark.parametrize("optimize", [False, True])
def test_png_reader_equals_pil_convert_rgb(tmp_path, mode, optimize):
    rgb = PIL.Image.fromarray(_image(37, 53, seed=1))
    if mode == "P":
        img = rgb.quantize(colors=200)
    elif mode in ("LA", "RGBA"):
        img = rgb.convert(mode[:-1])
        alpha = PIL.Image.fromarray(_image(37, 53, seed=2)[..., 0])
        img.putalpha(alpha)
    else:
        img = rgb.convert(mode)
    assert img.mode == mode
    path = _save(tmp_path, img, f"x_{mode}.png", optimize=optimize)
    want = np.asarray(PIL.Image.open(path).convert("RGB"))
    got = image_io.read_png(path)
    assert got.dtype == np.uint8 and got.shape == (37, 53, 3)
    assert np.array_equal(got, want)
    assert np.array_equal(image_io.load_image(path), want)


def test_png_every_filter_type(tmp_path):
    """A PNG written by hand with each scanline filter in turn (the reader
    must undo None, Sub, Up, Average and Paeth), read by PIL and the port."""
    import struct
    import zlib

    img = _image(10, 9, seed=3)
    h, w = img.shape[:2]
    bpp = 3
    rows, prev = [], np.zeros(w * bpp, np.int32)
    for y in range(h):
        line = img[y].reshape(-1).astype(np.int32)
        kind = y % 5
        left = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if kind == 0:
            pred = np.zeros_like(line)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - ul
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
        rows.append(bytes([kind]) + ((line - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prev = line

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body +
                struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    path = str(tmp_path / "filters.png")
    with open(path, "wb") as fh:
        fh.write(image_io.PNG_SIGNATURE + chunk(
            b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)) +
                 chunk(b"IDAT", zlib.compress(b"".join(rows))) +
                 chunk(b"IEND", b""))
    want = np.asarray(PIL.Image.open(path).convert("RGB"))
    assert np.array_equal(want, img)
    assert np.array_equal(image_io.read_png(path), img)


def test_unported_formats_raise(tmp_path):
    rgb = PIL.Image.fromarray(_image(16, 16))
    jpg = _save(tmp_path, rgb, "x.jpg")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        image_io.load_image(jpg)
    inter = _save(tmp_path, rgb, "x_interlaced.png", interlace=1)
    if PIL.Image.open(inter).info.get("interlace"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            image_io.read_png(inter)
    deep = PIL.Image.fromarray(
        (np.arange(256, dtype=np.uint16).reshape(16, 16) * 250),
        mode="I;16")
    deep_path = _save(tmp_path, deep, "x16.png")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        image_io.read_png(deep_path)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        image_io.load_video_frames(str(tmp_path / "clip.mp4"))


def test_npy_images_and_clips(tmp_path):
    img = _image(12, 20)
    np.save(str(tmp_path / "img.npy"), img)
    assert np.array_equal(image_io.load_image(str(tmp_path / "img.npy")), img)
    clip = np.stack([_image(12, 20, seed=s) for s in range(5)])
    np.save(str(tmp_path / "clip.npy"), clip)
    got = image_io.load_video_frames(str(tmp_path / "clip.npy"))
    assert got.dtype == np.uint8 and np.array_equal(got, clip)
    np.save(str(tmp_path / "bad.npy"), clip)
    with pytest.raises(ValueError, match=r"\[H, W, 3\]"):
        image_io.load_image(str(tmp_path / "bad.npy"))
    with pytest.raises(FileNotFoundError):
        image_io.load_image(str(tmp_path / "missing.png"))


@pytest.mark.parametrize("src,dst", [
    ((37, 53), (480, 832)),    # up, odd source
    ((600, 1000), (480, 832)), # down
    ((481, 833), (480, 832)),  # down by one pixel
    ((64, 64), (31, 97)),      # down in H, up in W, odd targets
    ((45, 80), (45, 33)),      # W only
])
def test_lanczos_equals_pil(src, dst):
    img = _image(*src, seed=4)
    size = (dst[1], dst[0])
    want = np.asarray(PIL.Image.fromarray(img).resize(size,
                                                      PIL.Image.LANCZOS))
    got = image_io.resize_lanczos(img, size)
    assert got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("src", [(37, 53), (300, 500)])
def test_bicubic_equals_pil(src):
    img = _image(*src, seed=5)
    want = np.asarray(PIL.Image.fromarray(img).resize((224, 224)))
    assert np.array_equal(image_io.resize_bicubic(img, (224, 224)), want)
