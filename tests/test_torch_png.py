"""The port's PNG codec (``ml_stable_diffusion_torch/utils/png.py``) against
Pillow: ``write_png``'s files decode in Pillow to the same pixels;
``read_png`` decodes files of colour types 0, 2, 3, 4 and 6 under each of
the five row filters (written here, and by Pillow itself) to Pillow's
pixels; ``to_grey`` is Pillow's ``convert("L")`` and ``to_tensor`` is
``utils/image.py:pil_to_tensor`` bit for bit; other files raise."""

import torch_threads  # noqa: F401  (first: caps torch's CPU threads)

import struct
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from ml_stable_diffusion_torch.utils import png
from ml_stable_diffusion_torch.utils.image import pil_to_tensor

#: colour type -> (Pillow mode, samples a pixel)
MODES = {0: ("L", 1), 2: ("RGB", 3), 3: ("P", 1), 4: ("LA", 2), 6: ("RGBA", 4)}


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered(rows: np.ndarray, filters, bpp: int) -> bytes:
    """(H, stride) uint8 scanlines -> the IDAT payload, row y under filter
    ``filters[y]`` (the PNG spec's definitions, vectorised)."""
    out = bytearray()
    prior = np.zeros(rows.shape[1], np.int32)
    for y, ftype in enumerate(filters):
        x = rows[y].astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        pred = [0, left, prior, (left + prior) // 2, _paeth(left, prior, upleft)][ftype]
        out.append(ftype)
        out += ((x - pred) % 256).astype(np.uint8).tobytes()
        prior = x
    return bytes(out)


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def write_test_png(path, samples, ctype, filters, palette=None, interlace=0, depth=8,
                   extra=()):
    """(H, W, C) uint8 samples as a PNG of colour type ``ctype``."""
    H, W, C = samples.shape
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, interlace))
    if palette is not None:
        body += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    for kind, data in extra:
        body += _chunk(kind, data)
    # two IDAT chunks: the stream may be split anywhere
    data = zlib.compress(_filtered(samples.reshape(H, W * C), filters, C))
    body += _chunk(b"IDAT", data[:len(data) // 2]) + _chunk(b"IDAT", data[len(data) // 2:])
    path.write_bytes(png.SIGNATURE + body + _chunk(b"IEND", b""))
    return path


def _samples(rng, H, W, ctype):
    """Pixels with smooth and noisy parts, so that every filter has work."""
    C = MODES[ctype][1]
    y, x = np.mgrid[0:H, 0:W]
    base = ((3 * x + 5 * y)[..., None] + 40 * np.arange(C)) % 256
    noise = rng.randint(0, 256, (H, W, C))
    s = np.where(rng.rand(H, W, 1) < 0.3, noise, base).astype(np.uint8)
    if ctype == 3:
        s = s % 7
    return s


def _check_against_pillow(path):
    px = png.read_png(path)
    with Image.open(path) as im:
        np.testing.assert_array_equal(png.to_rgba(px), np.asarray(im.convert("RGBA")))
        np.testing.assert_array_equal(png.to_grey(px)[..., 0], np.asarray(im.convert("L")))
    return px


@pytest.mark.parametrize("ctype", sorted(MODES))
@pytest.mark.parametrize("ftype", range(5))
def test_read_png_every_type_and_filter(tmp_path, ctype, ftype):
    rng = np.random.RandomState(ctype * 5 + ftype)
    s = _samples(rng, 13, 17, ctype)
    palette = rng.randint(0, 256, (7, 3)) if ctype == 3 else None
    path = write_test_png(tmp_path / "f.png", s, ctype, [ftype] * 13, palette)
    px = _check_against_pillow(path)
    assert px.shape == (13, 17, 3 if ctype == 3 else MODES[ctype][1])


@pytest.mark.parametrize("mode", ["L", "RGB", "P", "LA", "RGBA"])
def test_read_png_pillow_written(tmp_path, mode):
    """Pillow's own encoder picks a filter a row."""
    rng = np.random.RandomState(3)
    rgb = _samples(rng, 40, 56, 2)
    im = Image.fromarray(rgb)
    im = im.quantize(32) if mode == "P" else im.convert(mode)
    if mode in ("LA", "RGBA"):
        im.putalpha(Image.fromarray(rng.randint(0, 256, (40, 56)).astype(np.uint8)))
    im.save(tmp_path / "p.png")
    _check_against_pillow(tmp_path / "p.png")


@settings(max_examples=25, deadline=None)
@given(h=st.integers(1, 24), w=st.integers(1, 24), ctype=st.sampled_from(sorted(MODES)),
       seed=st.integers(0, 2**16))
def test_read_png_random_sizes(tmp_path_factory, h, w, ctype, seed):
    rng = np.random.RandomState(seed)
    s = _samples(rng, h, w, ctype)
    palette = rng.randint(0, 256, (7, 3)) if ctype == 3 else None
    path = write_test_png(tmp_path_factory.mktemp("h") / "r.png", s, ctype,
                          list(rng.randint(0, 5, h)), palette)
    _check_against_pillow(path)


@pytest.mark.parametrize("hw", [(1, 1), (31, 7), (64, 64)])
def test_write_png_decodes_in_pillow(tmp_path, hw):
    a = np.random.RandomState(hw[0]).randint(0, 256, (*hw, 3)).astype(np.uint8)
    path = png.write_png(tmp_path / "w.png", a)
    with Image.open(path) as im:
        assert im.mode == "RGB"
        np.testing.assert_array_equal(np.asarray(im), a)
    np.testing.assert_array_equal(png.read_png(path), a)


def test_grey_rule_is_pillows():
    """Every corner of the cube and 200k random colours."""
    rng = np.random.RandomState(0)
    corners = np.array(np.meshgrid(*[[0, 1, 127, 128, 254, 255]] * 3)).reshape(3, -1).T
    c = np.concatenate([rng.randint(0, 256, (200_000, 3)), corners])
    c = c.astype(np.uint8)[:, None, :]
    np.testing.assert_array_equal(png.to_grey(c)[..., 0],
                                  np.asarray(Image.fromarray(c, "RGB").convert("L")))


@pytest.mark.parametrize("value_range", [(-1.0, 1.0), (0.0, 1.0), (0, 1)])
@pytest.mark.parametrize("mode", ["RGBA", "LA", "RGB", "P"])
def test_to_tensor_is_pil_to_tensor(tmp_path, mode, value_range):
    """At the image's own size, transparent pixels zeroed; a mask through
    ``convert("L")`` too."""
    rng = np.random.RandomState(1)
    im = Image.fromarray(_samples(rng, 24, 20, 2))
    im = im.quantize(64) if mode == "P" else im.convert(mode)  # 8-bit indices
    if "A" in mode:
        alpha = rng.randint(0, 256, (24, 20)).astype(np.uint8)
        alpha[::3] = 0
        im.putalpha(Image.fromarray(alpha))
    im.save(tmp_path / "i.png")
    px = png.read_png(tmp_path / "i.png")
    with Image.open(tmp_path / "i.png") as ref:
        want = pil_to_tensor(ref, size=(24, 20), value_range=value_range)
        want_grey = pil_to_tensor(ref.convert("L"), size=(24, 20), value_range=value_range)
    got = png.to_tensor(px, value_range)
    assert got.dtype == want.dtype and got.shape == want.shape == (1, 24, 20, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(png.to_tensor(png.to_grey(px), value_range), want_grey)


def test_unsupported_files_raise(tmp_path):
    rng = np.random.RandomState(2)
    cases = {}
    Image.fromarray(rng.randint(0, 65535, (8, 8)).astype(np.uint16)).save(tmp_path / "i16.png")
    cases["16-bit"] = tmp_path / "i16.png"
    Image.fromarray(rng.randint(0, 2, (8, 8)).astype(bool)).save(tmp_path / "b1.png")
    cases["1-bit"] = tmp_path / "b1.png"
    q = Image.fromarray(rng.randint(0, 256, (8, 8, 3)).astype(np.uint8)).quantize(64)
    q.save(tmp_path / "trns.png", transparency=0)  # 8-bit indices
    cases["palette with tRNS"] = tmp_path / "trns.png"
    cases["interlaced"] = write_test_png(tmp_path / "adam7.png", _samples(rng, 8, 8, 2), 2,
                                         [0] * 8, interlace=1)
    Image.fromarray(rng.randint(0, 256, (8, 8, 3)).astype(np.uint8)).save(tmp_path / "j.jpg")
    cases["JPEG"] = tmp_path / "j.jpg"
    for what, path in cases.items():
        with pytest.raises(ValueError, match="Pillow"):
            png.read_png(path)
    # a damaged file: a CRC that does not match
    good = png.write_png(tmp_path / "g.png", np.zeros((2, 2, 3), np.uint8)).read_bytes()
    (tmp_path / "crc.png").write_bytes(good[:-5] + bytes([good[-5] ^ 1]) + good[-4:])
    with pytest.raises(ValueError, match="CRC"):
        png.read_png(tmp_path / "crc.png")
