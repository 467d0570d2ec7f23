"""The port's host image codecs against PIL: the C JPEG decoder
(`dataset.jpeg`, libjpeg-turbo's arithmetic) and the C LANCZOS resampler
of the crop shim (`dataset.shims`, Pillow's arithmetic). Both are held to
the same bits as PIL, on the committed fixtures (and their manifest's
hashes, which the card checks without PIL) and on seeded images encoded
here; and the crop shim against the JAX package's."""

import io
import json
import struct

import numpy as np
import pytest
from PIL import Image

from latentsplat_tpu.dataset.shims import rescale_and_crop as jax_rescale_and_crop
from latentsplat_tpu_torch import host_build
from latentsplat_tpu_torch.dataset.jpeg import CorruptJPEGError, decode_jpeg, jpeg_size
from latentsplat_tpu_torch.dataset.shims import _rescale_image, rescale_and_crop

from tests.torch_jpeg_tools import (
    CO3D_FRAMES,
    FIXTURE_DIR,
    PROGRESSIVE,
    RE10K_FRAMES,
    crop_shim_hash,
    encode_baseline,
    fixture_bytes,
    pil_decode,
    pil_encode,
    sha256,
    smooth_frame,
)
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

FRAMES = sorted({**RE10K_FRAMES, **CO3D_FRAMES})
MANIFEST = json.loads((FIXTURE_DIR / "manifest.json").read_text())


# -- the decoder -----------------------------------------------------------------


@pytest.mark.parametrize("name", FRAMES)
def test_decoder_matches_pil_on_fixture(name):
    data = fixture_bytes(name)
    ours = decode_jpeg(data)
    assert ours.dtype == np.uint8 and ours.shape == (*MANIFEST[name]["size"], 3)
    np.testing.assert_array_equal(ours, pil_decode(data))


@pytest.mark.parametrize("name", FRAMES)
def test_manifest_hashes(name):
    entry = MANIFEST[name]
    ours = decode_jpeg(fixture_bytes(name))
    assert sha256(ours) == entry["port_sha256"] == entry["pil_sha256"]
    assert crop_shim_hash(ours) == entry["crop_sha256"]


def _noise_or_smooth(kind, h, w, seed):
    if kind == "noise":
        return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    return smooth_frame(h, w, seed)


PIL_CASES = [
    *[(f"{sub}-q{q}", dict(quality=q, subsampling=sub)) for sub in (0, 1, 2) for q in (50, 95)],
    ("optimize", dict(quality=85, optimize=True)),
    ("restart-blocks", dict(quality=90, restart_marker_blocks=3)),
    ("restart-rows", dict(quality=90, subsampling=1, restart_marker_rows=1)),
    ("gray", dict(quality=90, gray=True)),
    ("16-bit-tables", dict(qtables=[[300 + i for i in range(64)], [2 + i for i in range(64)]])),
]


@pytest.mark.parametrize("kind", ["smooth", "noise"])
@pytest.mark.parametrize("shape", [(360, 640), (333, 517), (17, 9)])
@pytest.mark.parametrize("case", PIL_CASES, ids=[c[0] for c in PIL_CASES])
def test_decoder_matches_pil(case, shape, kind):
    rgb = _noise_or_smooth(kind, *shape, seed=shape[0] + len(case[0]))
    data = pil_encode(rgb, **case[1])
    np.testing.assert_array_equal(decode_jpeg(data), pil_decode(data))


@pytest.mark.parametrize("sampling", [
    ((1, 2), (1, 1), (1, 1)),   # 4:4:0
    ((2, 2), (2, 1), (2, 1)),   # chroma halved vertically in a 2x2 MCU
    ((2, 2), (1, 2), (1, 2)),   # chroma halved horizontally in a 2x2 MCU
    ((1, 1), (1, 1), (1, 1)),
])
@pytest.mark.parametrize("shape", [(120, 200), (37, 61)])
def test_decoder_matches_pil_on_other_samplings(sampling, shape):
    # PIL writes 4:4:4, 4:2:2 and 4:2:0 only; these come from the numpy encoder.
    data = encode_baseline(smooth_frame(*shape, seed=3), sampling, quality=80)
    np.testing.assert_array_equal(decode_jpeg(data), pil_decode(data))


def test_header():
    assert jpeg_size(fixture_bytes("co3d_large.jpg")) == (336, 451, 3)
    assert jpeg_size(fixture_bytes("co3d_gray.jpg")) == (300, 400, 1)


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def _with_adobe_rgb(data: bytes) -> bytes:
    """A YCbCr file relabelled as RGB-coded: JFIF APP0 dropped, Adobe APP14
    with transform 0 inserted."""
    (app0_len,) = struct.unpack(">H", data[4:6])
    assert data[2:4] == b"\xff\xe0"
    adobe = _segment(0xEE, b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0]))
    return data[:2] + adobe + data[4 + app0_len :]


def _sof(marker: int, precision: int = 8, components: int = 3) -> bytes:
    body = struct.pack(">BHHB", precision, 8, 8, components) + b"".join(
        bytes([i + 1, 0x11, 0]) for i in range(components))
    return b"\xff\xd8" + _segment(marker, body) + b"\xff\xd9"


def _dht(counts: list) -> bytes:
    """A file whose one DC table has these code counts per length."""
    counts = counts + [0] * (16 - len(counts))
    return b"\xff\xd8" + _segment(0xC4, bytes([0x00, *counts]) + bytes(sum(counts))) + b"\xff\xd9"


@pytest.mark.parametrize("data, message, damaged", [
    (lambda: fixture_bytes(PROGRESSIVE), "SOF2", False),
    (lambda: _sof(0xC9), "SOF9", False),
    (lambda: _sof(0xC3), "SOF3", False),
    (lambda: b"\xff\xd8" + _segment(0xCC, b"\x00\x10") + _sof(0xC0)[2:], "DAC", False),
    (lambda: _sof(0xC0, precision=12), "12-bit", False),
    (lambda: _sof(0xC0, components=4), "CMYK", False),
    (lambda: pil_encode(smooth_frame(32, 48, 1), quality=90, gray=False, subsampling=0)[:100], "truncated", True),
    (lambda: b"GIF89a", "SOI", True),
    # More codes of a length than it has: the table must be refused before
    # it is filled (255 codes of 1 bit would index far past it).
    (lambda: _dht([3]), "DHT", True),
    (lambda: _dht([255, 1]), "DHT", True),
    (lambda: _dht([1, 1, 2]), "DHT", True),   # an all-ones code (111), as libjpeg refuses
    (lambda: _sof(0xC0)[:-2] + b"\xff\xda\x00\x02", "SOS", True),   # an empty scan header
], ids=["progressive", "arithmetic", "lossless", "DAC", "12-bit", "CMYK", "truncated", "not-jpeg",
        "dht-overfull", "dht-far-overfull", "dht-all-ones", "sos-empty"])
def test_unsupported_input_raises_naming_the_marker(data, message, damaged):
    # A damaged file (PIL raises OSError) raises CorruptJPEGError, which the
    # CO3D reader skips; a valid file of another mode raises ValueError.
    with pytest.raises(ValueError, match=message) as raised:
        decode_jpeg(data())
    assert isinstance(raised.value, CorruptJPEGError) == damaged


def test_valid_dht_is_taken():
    # The fullest valid table of each length up to 16 bits: one code short
    # of all ones, as the JPEG standard's tables are built.
    with pytest.raises(CorruptJPEGError, match="no frame header"):
        decode_jpeg(_dht([1] * 16))


def test_adobe_rgb_and_cmyk_from_pil_raise():
    data = _with_adobe_rgb(pil_encode(smooth_frame(32, 48, 1), quality=90, subsampling=0))
    with pytest.raises(ValueError, match="APP14"):
        decode_jpeg(data)
    cmyk = Image.fromarray(smooth_frame(32, 48, 2)).convert("CMYK")
    buf = io.BytesIO()
    cmyk.save(buf, "JPEG")
    with pytest.raises(ValueError, match="CMYK"):
        decode_jpeg(buf.getvalue())


def test_missing_compiler_raises(monkeypatch):
    monkeypatch.setenv("CC", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="C compiler"):
        host_build._compiler()


# -- the resampler and the crop shim ------------------------------------------------


@pytest.mark.parametrize("src, dst", [
    ((360, 640), (256, 455)),   # RE10k: the shorter side to 256
    ((300, 400), (256, 341)),   # CO3D-like frames
    ((336, 451), (300, 400)),   # a sequence's larger frame to its smallest size
    ((451, 336), (341, 256)),
    ((100, 120), (256, 307)),   # upscaling
    ((360, 640), (360, 455)),   # one axis only
    ((360, 640), (256, 640)),
])
@pytest.mark.parametrize("kind", ["smooth", "noise"])
def test_lanczos_matches_pil(src, dst, kind):
    rgb = _noise_or_smooth(kind, *src, seed=src[1])
    ref = np.asarray(Image.fromarray(rgb).resize((dst[1], dst[0]), Image.LANCZOS))
    np.testing.assert_array_equal(_rescale_image(rgb, dst), ref)
    # A window of the output has the bits of the whole resize.
    row, col = (dst[0] - dst[0] // 2) // 2, (dst[1] - dst[1] // 3) // 2
    window = _rescale_image(rgb, dst, (row, col, dst[0] // 2, dst[1] // 3))
    np.testing.assert_array_equal(window, ref[row : row + dst[0] // 2, col : col + dst[1] // 3])


def test_float_round_trip_is_lossless_for_every_level():
    # The JAX crop shim resizes float images as clip(x * 255) -> uint8; the
    # port keeps the decoder's uint8. For x = k / 255 both are k.
    levels = np.arange(256, dtype=np.uint8)
    image = levels.astype(np.float32) / 255.0
    assert image.dtype == np.float32
    np.testing.assert_array_equal(np.clip(image * 255.0, 0, 255).astype(np.uint8), levels)


@pytest.mark.parametrize("name, shape", [("re10k_0.jpg", (256, 256)), ("co3d_large.jpg", (256, 256)),
                                         ("re10k_3.jpg", (180, 320)), ("co3d_444.jpg", (64, 64))])
def test_crop_shim_matches_jax(name, shape):
    rgb = decode_jpeg(fixture_bytes(name))
    images = np.stack([rgb, rgb[::-1].copy()])
    intrinsics = np.tile(np.asarray([[0.8, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32), (2, 1, 1))
    ours, ours_k = rescale_and_crop(images, intrinsics, shape)
    theirs, theirs_k = jax_rescale_and_crop(images.astype(np.float32) / 255.0, intrinsics, shape)
    assert ours.dtype == theirs.dtype == np.float32 and ours.shape == (2, *shape, 3)
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours_k, theirs_k)


def test_rescale_refuses_float_images():
    with pytest.raises(ValueError, match="uint8"):
        _rescale_image(np.zeros((8, 8, 3), np.float32), (4, 4))
