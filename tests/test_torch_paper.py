"""The port's paper tooling (latentsplat_tpu_torch.paper) and its BILINEAR
`resize` against the JAX package's: the LaTeX tables character for
character, and every figure generator's PNG pixel for pixel. The JAX
package draws labels with PIL's DejaVu font and the port with its bitmap
font, so the JAX side runs with the port's `draw_label` patched in; the
rest of each figure (layout, resizes, placeholders) is its own."""

import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import latentsplat_tpu.paper.common as jax_common
from latentsplat_tpu.misc.image_io import save_image as jax_save_image
from latentsplat_tpu.paper import (
    generate_ablation_image_comparison as j_ablation,
    generate_benchmark_table as j_benchmark,
    generate_comparison_table as j_comparison,
    generate_feature_image as j_feature,
    generate_image_comparison as j_image,
    generate_teaser as j_teaser,
)
from latentsplat_tpu.paper.table import make_latex_table as j_make_latex_table
from latentsplat_tpu.visualization.layout import resize as j_resize
from latentsplat_tpu_torch.misc.image_io import load_image
from latentsplat_tpu_torch.paper import (
    generate_ablation_image_comparison,
    generate_benchmark_table,
    generate_comparison_table,
    generate_feature_image,
    generate_image_comparison,
    generate_teaser,
)
from latentsplat_tpu_torch.paper.common import comparison_grid, plain_grid
from latentsplat_tpu_torch.paper.table import make_latex_table
from latentsplat_tpu_torch.visualization.annotation import draw_label
from latentsplat_tpu_torch.visualization.layout import resize
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

TABLE_CASES = {
    "ranks_and_arrows": ({"Ours": [25.0, 0.12], "Baseline": [23.1, 0.15]}, ["PSNR", "LPIPS"], [2, 3], [1, -1]),
    "missing_values": ({"A": [1.0, None], "B": [2.0, 3.0]}, ["m1", "m2"], [1, 1], [1, -1]),
    "ties_share_rank": ({"A": [1.004], "B": [1.001]}, ["m"], [2], [1]),
    "unranked_column": ({"A": [3.0, 0.5], "B": [2.0, float("nan")], "C": [2.0, 0.7]}, ["x", "y"], [0, 2], [0, 1]),
}


@pytest.mark.parametrize("case", sorted(TABLE_CASES))
def test_make_latex_table_matches_jax(case):
    args = TABLE_CASES[case]
    assert make_latex_table(*args) == j_make_latex_table(*args)


@pytest.mark.parametrize("shape", [(16, 16), (37, 53), (256, 256), (13, 29), (60, 10)])
def test_resize_gives_pil_bits(shape):
    rng = np.random.default_rng(sum(shape))
    image = rng.uniform(-0.1, 1.1, (48, 40, 3)).astype(np.float32)
    np.testing.assert_array_equal(resize(image, shape=shape), j_resize(image, shape=shape))
    np.testing.assert_array_equal(resize(image, width=shape[1]), j_resize(image, width=shape[1]))
    np.testing.assert_array_equal(resize(image[..., :1], height=shape[0]), j_resize(image[..., :1], height=shape[0]))


def test_resize_matches_pil_directly():
    pixels = np.random.default_rng(5).integers(0, 256, (33, 47, 3), dtype=np.uint8)
    ref = np.asarray(Image.fromarray(pixels).resize((20, 71), Image.BILINEAR), np.float32) / 255.0
    np.testing.assert_array_equal(resize(pixels.astype(np.float32) / 255.0, shape=(71, 20)), ref)
    with pytest.raises(ValueError, match="exactly one"):
        resize(pixels, shape=(4, 4), width=4)


@pytest.fixture
def jax_labels(monkeypatch):
    """The JAX figures drawn with the port's label font."""
    monkeypatch.setattr(jax_common, "draw_label", draw_label)


def test_grids_match_jax(jax_labels):
    rng = np.random.default_rng(0)
    img = rng.random((32, 32, 3)).astype(np.float32)
    small = rng.random((20, 24, 3)).astype(np.float32)
    rows = [[img, small, img, None], [None, img, small, img]]
    np.testing.assert_array_equal(
        comparison_grid(rows, ["GT", "Ours"], image_size=32, font_size=10),
        jax_common.comparison_grid(rows, ["GT", "Ours"], image_size=32, font_size=10),
    )
    np.testing.assert_array_equal(
        plain_grid([[small, None]], ["A", "B"], image_size=16, font_size=10),
        jax_common.plain_grid([[small, None]], ["A", "B"], image_size=16, font_size=10),
    )


def make_method_dir(root: Path, name: str, seed: int = 0) -> Path:
    """The test-output layout of tests/test_paper.py, plus an uncertainty kind."""
    d = root / name
    rng = np.random.default_rng(seed)
    for kind in ("color", "context", "uncertainty"):
        for idx in (3, 7, 12):
            jax_save_image(rng.random((24, 20, 3)).astype(np.float32), d / "s1" / "3_7" / kind / f"{idx:0>6}.png")
    return d


def assert_same_png(ours: Path, theirs: Path) -> None:
    np.testing.assert_array_equal(load_image(ours), load_image(theirs))


FIGURES = {
    "image_comparison": (generate_image_comparison, j_image, lambda d, e: [
        "methods=[{name: Ours, path: %s}, {name: Other, path: %s}]" % (d, e),
        "rows=[{scene: s1, ctx_key: '3_7', index: 12}, {scene: s1, ctx_key: '3_7', index: 5}]",
        f"context_path={d}", "image_size=16",
    ]),
    "ablation": (generate_ablation_image_comparison, j_ablation, lambda d, e: [
        "methods=[{name: A, path: %s}, {name: B, path: %s}]" % (d, e),
        "rows=[{scene: s1, ctx_key: '3_7', index: 7}]", "image_size=16",
    ]),
    "teaser": (generate_teaser, j_teaser, lambda d, e: [
        f"method_path={d}", f"context_path={e}",
        "rows=[{scene: s1, ctx_key: '3_7', indices: [3, 7, 12, 4]}]", "image_size=16",
    ]),
    "feature_image": (generate_feature_image, j_feature, lambda d, e: [
        f"method_path={d}", f"gt_path={e}",
        "modalities=[{name: Color, kind: color}, {name: Uncertainty, kind: uncertainty}, {name: Depth, kind: depth}]",
        "rows=[{scene: s1, ctx_key: '3_7', index: 12}]", "image_size=24",
    ]),
}


@pytest.mark.parametrize("figure", sorted(FIGURES))
def test_figure_cli_matches_jax(tmp_path, jax_labels, figure):
    ours_cli, theirs_cli, args = FIGURES[figure]
    d, e = make_method_dir(tmp_path, "ours", 0), make_method_dir(tmp_path, "other", 1)
    ours_cli.main(args(d, e) + [f"output_path={tmp_path / 'ours.png'}"])
    theirs_cli.main(args(d, e) + [f"output_path={tmp_path / 'theirs.png'}"])
    assert_same_png(tmp_path / "ours.png", tmp_path / "theirs.png")


def test_comparison_table_cli_matches_jax(tmp_path):
    metrics = {"psnr": {"ours": 25.0, "base": 24.0}, "ssim": {"ours": 0.8, "base": 0.7},
               "lpips": {"ours": 0.1, "base": 0.2}}
    (tmp_path / "metrics.mean.json").write_text(json.dumps(metrics))
    args = [f"metrics_path={tmp_path / 'metrics.mean.json'}", "methods=[{name: Ours, key: ours}, {name: Base, key: base}]"]
    generate_comparison_table.main(args + [f"output_path={tmp_path / 'ours.tex'}"])
    j_comparison.main(args + [f"output_path={tmp_path / 'theirs.tex'}"])
    assert (tmp_path / "ours.tex").read_text() == (tmp_path / "theirs.tex").read_text()
    assert "\\textbf{25.00}" in (tmp_path / "ours.tex").read_text()


def test_benchmark_table_cli_matches_jax(tmp_path):
    d = tmp_path / "m"
    d.mkdir()
    (d / "benchmark.json").write_text(json.dumps({"encoder": [0.1, 0.2], "decoder": [0.05]}))
    (d / "peak_memory.json").write_text(json.dumps({"cuda:0": 8e9, "cuda:1": 6e9}))
    args = ["methods=[{name: Ours, path: %s}, {name: Missing, path: %s}]" % (d, tmp_path / "none")]
    generate_benchmark_table.main(args + [f"output_path={tmp_path / 'ours.tex'}"])
    j_benchmark.main(args + [f"output_path={tmp_path / 'theirs.tex'}"])
    text = (tmp_path / "ours.tex").read_text()
    assert text == (tmp_path / "theirs.tex").read_text()
    assert "0.1500" in text and "8.00" in text and "--" in text


def filtered_png(image: np.ndarray, kind: int) -> bytes:
    """An 8-bit RGB PNG whose every row uses filter `kind`."""
    import struct
    import zlib

    h, w, _ = image.shape
    img = image.astype(np.int32)
    rows = []
    for y in range(h):
        prev = img[y - 1] if y else np.zeros_like(img[0])
        left = np.concatenate([np.zeros((1, 3), np.int32), img[y, :-1]])
        up_left = np.concatenate([np.zeros((1, 3), np.int32), prev[:-1]])
        if kind == 3:
            pred = (left + prev) // 2
        elif kind == 4:
            p = left + prev - up_left
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, up_left))
        else:
            pred = [np.zeros_like(left), left, prev][kind]
        rows.append(bytes([kind]) + ((img[y] - pred) % 256).astype(np.uint8).tobytes())

    def chunk(tag, body):
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(rows))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_png_reader_undoes_every_row_filter(kind):
    # Frames written by other tools (PIL picks a filter per row) load as
    # PIL reads them.
    import io

    from latentsplat_tpu_torch.misc.image_io import decode_png

    image = np.random.default_rng(kind).integers(0, 256, (9, 13, 3), dtype=np.uint8)
    data = filtered_png(image, kind)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), image)
    np.testing.assert_array_equal(decode_png(data), image)
