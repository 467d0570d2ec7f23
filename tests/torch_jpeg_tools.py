"""JPEG test material for the port's decoder and crop shim.

  * `smooth_frame` - a seeded smooth RGB frame: a render of the synthetic
    dataset's blob scenes at any size;
  * `encode_baseline` - a small baseline JPEG encoder in numpy for any
    sampling factors, 4:4:0 included (PIL writes 4:4:4, 4:2:2 and 4:2:0
    only), with PIL's quantization and Huffman tables at the given quality;
  * `write_fixtures` - the committed files of tests/torch_fixtures/jpeg and
    their manifest.json. Regenerate with

        python -m tests.torch_jpeg_tools

The fixtures are made with PIL; the manifest holds, for each file, the
sha256 of PIL's decode, of the port's decode and of the port's crop shim at
256x256, so that a machine without PIL checks the port against them.
"""

from __future__ import annotations

import hashlib
import io
import json
import struct
from pathlib import Path

import numpy as np

FIXTURE_DIR = Path(__file__).resolve().parent / "torch_fixtures" / "jpeg"

_NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])


def smooth_frame(h: int, w: int, seed: int) -> np.ndarray:
    """uint8 (h, w, 3): one view of a synthetic blob scene, rendered at h x w."""
    from latentsplat_tpu_torch.dataset.synthetic import DatasetSynthetic, render_blob_scene
    from latentsplat_tpu_torch.dataset.types import DatasetSyntheticCfg

    ds = DatasetSynthetic(DatasetSyntheticCfg(num_frames=8, seed=seed // 8), "test", None)
    means, colors, radii, extrinsics, intrinsics = ds._scene(seed % 8)
    intr = intrinsics[0].copy()
    intr[0, 0] *= h / w   # square pixels at a wide aspect
    image = render_blob_scene(means, colors, radii, extrinsics[seed % 8], intr, (h, w))
    return (image * 255.0 + 0.5).astype(np.uint8)


def _segments(data: bytes):
    """(marker, body) of each segment before the first SOS."""
    pos = 2
    while pos < len(data):
        marker = data[pos + 1]
        (length,) = struct.unpack(">H", data[pos + 2 : pos + 4])
        yield marker, data[pos + 4 : pos + 2 + length]
        if marker == 0xDA:
            return
        pos += 2 + length


def _pil_tables(quality: int):
    """PIL's quantization tables (zigzag order) and Huffman tables
    ((class, index) -> (counts, symbols)) at `quality`."""
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.zeros((16, 16, 3), np.uint8)).save(buf, "JPEG", quality=quality, subsampling=0)
    qt, ht = {}, {}
    for marker, body in _segments(buf.getvalue()):
        pos = 0
        if marker == 0xDB:
            while pos < len(body):
                qt[body[pos] & 15] = list(body[pos + 1 : pos + 65])
                pos += 65
        elif marker == 0xC4:
            while pos < len(body):
                counts = list(body[pos + 1 : pos + 17])
                n = sum(counts)
                ht[(body[pos] >> 4, body[pos] & 15)] = (counts, list(body[pos + 17 : pos + 17 + n]))
                pos += 17 + n
    return qt, ht


def _codes(counts, symbols):
    """symbol -> (code, length) of a canonical Huffman table."""
    out, code, k = {}, 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            out[symbols[k]] = (code, length)
            code, k = code + 1, k + 1
        code <<= 1
    return out


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code: int, length: int):
        self.acc = (self.acc << length) | code
        self.n += length
        while self.n >= 8:
            byte = (self.acc >> (self.n - 8)) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
            self.n -= 8
        self.acc &= (1 << self.n) - 1

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _magnitude(v: int):
    s = int(abs(v)).bit_length()
    return s, (v if v >= 0 else v + (1 << s) - 1)


def encode_baseline(rgb: np.ndarray, sampling, quality: int = 90) -> bytes:
    """uint8 (h, w, 3) -> a baseline JFIF file whose components Y, Cb, Cr
    have the sampling factors `sampling` ((h, v) each)."""
    h, w, _ = rgb.shape
    qt, ht = _pil_tables(quality)
    x = rgb.astype(np.float64)
    ycc = np.stack([
        0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2],
        -0.168736 * x[..., 0] - 0.331264 * x[..., 1] + 0.5 * x[..., 2] + 128,
        0.5 * x[..., 0] - 0.418688 * x[..., 1] - 0.081312 * x[..., 2] + 128,
    ], -1)
    hmax, vmax = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    ycc = np.pad(ycc, ((0, mcuy * 8 * vmax - h), (0, mcux * 8 * hmax - w), (0, 0)), mode="edge")
    u = np.arange(8)
    dct = np.sqrt(2 / 8) * np.cos((2 * u[None, :] + 1) * u[:, None] * np.pi / 16)
    dct[0] /= np.sqrt(2)

    planes = []
    for c, (hs, vs) in enumerate(sampling):
        fy, fx = vmax // vs, hmax // hs
        p = ycc[..., c]
        p = p.reshape(p.shape[0] // fy, fy, p.shape[1] // fx, fx).mean(axis=(1, 3))
        planes.append(p - 128.0)

    tables = [(0, 0, 0), (1, 1, 1), (1, 1, 1)]   # (quant, dc, ac) of each component
    dc_codes = {i: _codes(*ht[(0, i)]) for i in (0, 1)}
    ac_codes = {i: _codes(*ht[(1, i)]) for i in (0, 1)}
    bits = _BitWriter()
    pred = [0, 0, 0]
    for my in range(mcuy):
        for mx in range(mcux):
            for c, (hs, vs) in enumerate(sampling):
                tq, td, ta = tables[c]
                q = np.zeros(64)
                q[_NATURAL] = qt[tq]
                for by in range(vs):
                    for bx in range(hs):
                        r0, c0 = (my * vs + by) * 8, (mx * hs + bx) * 8
                        coef = dct @ planes[c][r0 : r0 + 8, c0 : c0 + 8] @ dct.T
                        zz = np.round(coef.reshape(64)[_NATURAL] / q[_NATURAL]).astype(int)
                        s, v = _magnitude(zz[0] - pred[c])
                        pred[c] = zz[0]
                        bits.put(*dc_codes[td][s])
                        if s:
                            bits.put(v, s)
                        run = 0
                        for k in range(1, 64):
                            if zz[k] == 0:
                                run += 1
                                continue
                            while run > 15:
                                bits.put(*ac_codes[ta][0xF0])
                                run -= 16
                            s, v = _magnitude(zz[k])
                            bits.put(*ac_codes[ta][(run << 4) | s])
                            bits.put(v, s)
                            run = 0
                        if run:
                            bits.put(*ac_codes[ta][0x00])
    bits.flush()

    def segment(marker: int, body: bytes) -> bytes:
        return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body

    out = b"\xff\xd8" + segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    out += segment(0xDB, b"".join(bytes([i]) + bytes(qt[i]) for i in (0, 1)))
    out += segment(0xC0, struct.pack(">BHHB", 8, h, w, 3) + b"".join(
        bytes([c + 1, (hs << 4) | vs, tables[c][0]]) for c, (hs, vs) in enumerate(sampling)))
    out += segment(0xC4, b"".join(bytes([(k << 4) | i]) + bytes(ht[(k, i)][0]) + bytes(ht[(k, i)][1])
                                  for k in (0, 1) for i in (0, 1)))
    out += segment(0xDA, bytes([3]) + b"".join(bytes([c + 1, (tables[c][1] << 4) | tables[c][2]])
                                               for c in range(3)) + b"\x00\x3f\x00")
    return out + bytes(bits.out) + b"\xff\xd9"


def pil_encode(rgb: np.ndarray, **kwargs) -> bytes:
    """PIL's JPEG of `rgb` (grayscale with gray=True)."""
    from PIL import Image

    gray = kwargs.pop("gray", False)
    image = Image.fromarray(rgb)
    if gray:
        image = image.convert("L")
    buf = io.BytesIO()
    image.save(buf, "JPEG", **kwargs)
    return buf.getvalue()


def pil_decode(data: bytes) -> np.ndarray:
    """uint8 (h, w, 3): PIL's decode, converted to RGB as the JAX CO3D reader does."""
    from PIL import Image

    with Image.open(io.BytesIO(data)) as image:
        return np.asarray(image.convert("RGB"))


def sha256(array: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(array).tobytes()).hexdigest()


def crop_shim_hash(rgb: np.ndarray) -> str:
    """sha256 of the port's crop shim output (float32) of one frame at 256x256."""
    from latentsplat_tpu_torch.dataset.shims import rescale_and_crop

    images, _ = rescale_and_crop(rgb[None], np.eye(3, dtype=np.float32)[None], (256, 256))
    return sha256(images)


# name -> (mode, height, width, seed, how it is written)
RE10K_FRAMES = {
    "re10k_0.jpg": ("4:2:0 q90", 360, 640, 0, dict(quality=90)),
    "re10k_1.jpg": ("4:2:0 q85", 360, 640, 1, dict(quality=85)),
    "re10k_2.jpg": ("4:2:0 q95", 360, 640, 2, dict(quality=95)),
    "re10k_3.jpg": ("4:2:0 q90 optimize", 360, 640, 3, dict(quality=90, optimize=True)),
    "re10k_4.jpg": ("4:2:0 q90 restart every 4 MCUs", 360, 640, 4, dict(quality=90, restart_marker_blocks=4)),
    "re10k_5.jpg": ("4:2:0 q88", 360, 640, 5, dict(quality=88)),
}
CO3D_FRAMES = {
    "co3d_444.jpg": ("4:4:4 q90", 300, 400, 8, dict(quality=90, subsampling=0)),
    "co3d_422.jpg": ("4:2:2 q90", 300, 400, 9, dict(quality=90, subsampling=1)),
    "co3d_gray.jpg": ("grayscale q90", 300, 400, 10, dict(quality=90, gray=True)),
    "co3d_440.jpg": ("4:4:0 q90 (numpy encoder)", 300, 400, 11, None),
    "co3d_large.jpg": ("4:2:0 q90, a larger size", 336, 451, 12, dict(quality=90)),
}
PROGRESSIVE = "progressive.jpg"


def fixture_bytes(name: str) -> bytes:
    return (FIXTURE_DIR / name).read_bytes()


def _synthetic_cameras(scene: int, frames: int) -> np.ndarray:
    """The synthetic dataset's camera-to-world extrinsics (frames, 4, 4) of one scene."""
    from latentsplat_tpu_torch.dataset.synthetic import DatasetSynthetic
    from latentsplat_tpu_torch.dataset.types import DatasetSyntheticCfg

    return DatasetSynthetic(DatasetSyntheticCfg(num_frames=frames), "test", None)._scene(scene)[3]


def write_re10k_root(root: Path, scenes: int = 2, frames: int = 48) -> list[str]:
    """An RE10k root: train/ and test/, each with 000000.torch (`scenes`
    scenes of `frames` frames, the JPEG bytes cycled from the 640x360
    fixtures, 18-float camera rows from the synthetic dataset's cameras) and
    index.json. Returns the scene keys of the test stage."""
    import torch

    jpegs = [fixture_bytes(name) for name in sorted(RE10K_FRAMES)]
    keys = []
    for stage in ("train", "test"):
        chunk = []
        for s in range(scenes):
            w2c = np.linalg.inv(_synthetic_cameras(s, frames))
            intrinsics = np.tile(np.asarray([1.2 * 360 / 640, 1.2, 0.5, 0.5, 0.0, 0.0], np.float32), (frames, 1))
            cameras = np.concatenate([intrinsics, w2c[:, :3].reshape(frames, 12)], axis=1).astype(np.float32)
            chunk.append({
                "key": f"{stage}_{s:04d}",
                "url": f"fixture://{stage}/{s}",
                "timestamps": torch.arange(frames),
                "cameras": torch.from_numpy(cameras),
                "images": [torch.from_numpy(np.frombuffer(jpegs[(s + i) % len(jpegs)], np.uint8).copy())
                           for i in range(frames)],
            })
        (root / stage).mkdir(parents=True, exist_ok=True)
        torch.save(chunk, root / stage / "000000.torch")
        (root / stage / "index.json").write_text(json.dumps({c["key"]: "000000.torch" for c in chunk}))
        keys = [c["key"] for c in chunk]
    return keys


def write_co3d_tree(root: Path, sequences: int = 2, frames: int = 48, category: str = "hydrant") -> Path:
    """A CO3D tree: <category>/frame_annotations.jgz (PyTorch3D-convention
    R, T, NDC focal length and principal point from the synthetic dataset's
    cameras) and the images, copied from the CO3D-like fixtures (frame 5 of
    each sequence at a larger size); and split.json listing every frame.
    Returns the split's path."""
    import gzip

    names = ["co3d_444.jpg", "co3d_422.jpg", "co3d_gray.jpg", "co3d_440.jpg"]
    annotations, split = [], []
    for s in range(sequences):
        seq = f"{s:03d}_fixture"
        (root / category / seq / "images").mkdir(parents=True, exist_ok=True)
        c2w = _synthetic_cameras(s, frames)
        for i in range(frames):
            name = "co3d_large.jpg" if i == 5 else names[(s + i) % len(names)]
            rel = f"{category}/{seq}/images/frame{i:06d}.jpg"
            (root / rel).write_bytes(fixture_bytes(name))
            w2c = np.linalg.inv(c2w[i].astype(np.float64))
            R, T = w2c[:3, :3].T.copy(), w2c[:3, 3].copy()
            R[:, :2] *= -1
            T[:2] *= -1
            annotations.append({
                "sequence_name": seq, "frame_number": i,
                "image": {"size": CO3D_FRAMES[name][1:3], "path": rel},
                "viewpoint": {"R": R.tolist(), "T": T.tolist(), "focal_length": [2.4, 2.4],
                              "principal_point": [0.0, 0.0], "intrinsics_format": "ndc_isotropic"},
            })
            split.append([seq, i, rel])
    with gzip.open(root / category / "frame_annotations.jgz", "wt") as f:
        json.dump(annotations, f)
    (root / "split.json").write_text(json.dumps(split))
    return root / "split.json"


def write_fixtures(directory: Path = FIXTURE_DIR) -> dict:
    from latentsplat_tpu_torch.dataset.jpeg import decode_jpeg

    directory.mkdir(parents=True, exist_ok=True)
    manifest = {}
    for name, (mode, h, w, seed, how) in {**RE10K_FRAMES, **CO3D_FRAMES}.items():
        rgb = smooth_frame(h, w, seed)
        data = encode_baseline(rgb, ((1, 2), (1, 1), (1, 1))) if how is None else pil_encode(rgb, **how)
        (directory / name).write_bytes(data)
        ours = decode_jpeg(data)
        manifest[name] = {"mode": mode, "size": [h, w], "pil_sha256": sha256(pil_decode(data)),
                          "port_sha256": sha256(ours), "crop_sha256": crop_shim_hash(ours)}
    (directory / PROGRESSIVE).write_bytes(pil_encode(smooth_frame(64, 96, 13), quality=90, progressive=True))
    manifest[PROGRESSIVE] = {"mode": "progressive q90", "size": [64, 96], "error": "SOF2"}
    (directory / "manifest.json").write_text(json.dumps(manifest, indent=1) + "\n")
    return manifest


if __name__ == "__main__":
    for name, entry in write_fixtures().items():
        print(name, entry)
