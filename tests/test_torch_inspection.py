"""The port's model-inspection modules against the JAX package's:
`render_orthographic` (the tiled route against JAX's dense one),
`covariance_to_scale_rotation`, the PLY export, the drawing helpers and
colors, the 3D validation views, the encoder panels and
`capture_attention`, and the render_uncertainty and
visualize_epipolar_lines scripts. Labels are drawn with different fonts
(PIL's DejaVu in the JAX package, a bitmap font in the port), so images
are compared without labels, or with the port's `add_label` patched into
both, and label layouts by their shapes.
"""

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import latentsplat_tpu.model.encoder.visualization as jax_encvis
import latentsplat_tpu.visualization.drawing.cameras as jax_cameras
from latentsplat_tpu.config import load_config as jax_load_config
from latentsplat_tpu.model.encoder.epipolar_sampler import sample_epipolar_features as jax_sample
from latentsplat_tpu.model.latentsplat import LatentSplat as JaxLatentSplat
from latentsplat_tpu.model.ply_export import export_ply as jax_export_ply
from latentsplat_tpu.model.ply_export import load_ply as jax_load_ply
from latentsplat_tpu.ops.gaussians import covariance_to_scale_rotation as jax_cov_to_sr
from latentsplat_tpu.ops.rasterize.api import render_orthographic as jax_render_orthographic
from latentsplat_tpu.visualization import colors as jax_colors
from latentsplat_tpu.visualization import validation_in_3d as jax_v3d
from latentsplat_tpu.visualization.drawing import coordinate_conversion as jax_conv
from latentsplat_tpu.visualization.drawing.lines import draw_lines as jax_draw_lines
from latentsplat_tpu.visualization.drawing.points import draw_points as jax_draw_points
from latentsplat_tpu_torch.config import load_config
from latentsplat_tpu_torch.model.encoder import visualization as encvis
from latentsplat_tpu_torch.model.encoder.epipolar_sampler import sample_epipolar_features
from latentsplat_tpu_torch.model.latentsplat import LatentSplat
from latentsplat_tpu_torch.model.ply_export import export_ply, load_ply
from latentsplat_tpu_torch.model.types import Gaussians
from latentsplat_tpu_torch.ops.gaussians import build_covariance, covariance_to_scale_rotation, symmetric_eigh_3x3
from latentsplat_tpu_torch.ops.rasterize.api import render_orthographic
from latentsplat_tpu_torch.ops.rasterize.kernels import duplicate_with_keys_reference
from latentsplat_tpu_torch.ops.rasterize.tiled import MAX_TILES_PER_GAUSSIAN, covering_cap, tile_rects
from latentsplat_tpu_torch.visualization import colors, validation_in_3d
from latentsplat_tpu_torch.visualization.annotation import add_label
from latentsplat_tpu_torch.visualization.drawing import cameras, coordinate_conversion
from latentsplat_tpu_torch.visualization.drawing.lines import draw_lines
from latentsplat_tpu_torch.visualization.drawing.points import draw_points
from latentsplat_tpu_torch.weights import params_from_jax

from tests.test_torch_data import TINY
from tests.test_torch_rasterize import BIG, BIG_TILES, make_scene, project_both
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

# The JAX package's tiled-versus-dense tolerance (tests/test_rasterize.py:132-134).
RENDER_ATOL = 2e-4


def random_rotations(rng, n):
    q = rng.standard_normal((n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def random_gaussians(seed, n, n_wide=0, spread=1.0, n_sh=4):
    """Gaussians in the cube [-spread, spread]^3; the first `n_wide` are
    wide enough to span many tiles of a whole-scene projection."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-spread, spread, (1, n, 3))
    scales = rng.uniform(0.01, 0.05, (n, 3)) * spread
    scales[:n_wide] = rng.uniform(0.25, 0.4, (n_wide, 3)) * spread
    covs = build_covariance(torch.from_numpy(scales), torch.from_numpy(random_rotations(rng, n))).numpy()[None]
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return {
        "means": f32(means), "covariances": f32(covs),
        "opacities": f32(rng.uniform(0.3, 0.95, (1, n))),
        "color_harmonics": f32(rng.uniform(-0.5, 0.5, (1, n, 3, n_sh))),
    }


def as_port(g):
    return Gaussians(**{k: torch.from_numpy(v) for k, v in g.items()})


def as_jax(g):
    return SimpleNamespace(**{k: jnp.asarray(v) for k, v in g.items()})


# -- render_orthographic ---------------------------------------------------------


def record_caps(monkeypatch):
    """The cap of each tiled view render."""
    import latentsplat_tpu_torch.ops.rasterize.api as api

    caps = []
    composite_tiled = api.composite_tiled

    def spy(sg, image_shape, background, cap, *args, **kwargs):
        caps.append(cap)
        return composite_tiled(sg, image_shape, background, cap, *args, **kwargs)

    monkeypatch.setattr(api, "composite_tiled", spy)
    return caps


@pytest.mark.parametrize("size", [64, 128])
def test_render_orthographic_matches_jax_dense(size, monkeypatch):
    # A camera on the cube's -z face looking down +z; wide Gaussians span
    # more than the main path's 9 tiles (and, at 128², more than the 32 an
    # int32 slot mask holds). The port renders through the tiled route
    # (the kernels' plain versions on the CPU), JAX through its dense one.
    g = random_gaussians(0, 300, n_wide=4)
    ext = np.eye(4, dtype=np.float32)[None]
    ext[0, 2, 3] = -1.2
    width = np.array([2.4], np.float32)
    near, far = np.zeros(1, np.float32), np.array([2.4], np.float32)
    feature_sh = np.random.default_rng(1).uniform(-0.5, 0.5, (1, 300, 4, 1)).astype(np.float32)
    args = (ext, width, width * 0.8, near, far)
    theirs = jax_render_orthographic(
        *map(jnp.asarray, args), (size, size), jnp.full((1, 3), 0.25), jnp.asarray(g["means"]),
        jnp.asarray(g["covariances"]), jnp.asarray(g["opacities"]),
        gaussian_color_sh=jnp.asarray(g["color_harmonics"]), gaussian_feature_sh=jnp.asarray(feature_sh),
        fov_degrees=10.0,
    )
    caps = record_caps(monkeypatch)
    ours = render_orthographic(
        *map(torch.from_numpy, args), (size, size), torch.full((1, 3), 0.25),
        torch.from_numpy(g["means"]), torch.from_numpy(g["covariances"]), torch.from_numpy(g["opacities"]),
        gaussian_color_sh=torch.from_numpy(g["color_harmonics"]), gaussian_feature_sh=torch.from_numpy(feature_sh),
        fov_degrees=10.0,
    )
    assert len(caps) == 1 and caps[0] > (9 if size == 64 else 32), caps
    for name in ("color", "feature", "mask", "depth"):
        np.testing.assert_allclose(getattr(ours, name).numpy(), np.asarray(getattr(theirs, name)),
                                   atol=RENDER_ATOL, err_msg=name)


def test_covering_cap_raises_beyond_the_mask():
    # A Gaussian over the whole 144² image spans 81 tiles, more than 64.
    g = random_gaussians(2, 20, n_wide=20)
    ext = np.eye(4, dtype=np.float32)[None]
    ext[0, 2, 3] = -1.2
    args = [torch.from_numpy(x) for x in (ext, np.array([0.6], np.float32), np.array([0.6], np.float32),
                                          np.zeros(1, np.float32), np.array([2.4], np.float32))]
    with pytest.raises(ValueError, match=f"spans 81 tiles .* holds {MAX_TILES_PER_GAUSSIAN}"):
        render_orthographic(*args, (144, 144), torch.zeros((1, 3)), torch.from_numpy(g["means"]),
                            torch.from_numpy(g["covariances"]), torch.from_numpy(g["opacities"]),
                            gaussian_color_sh=torch.from_numpy(g["color_harmonics"]), fov_degrees=10.0)


def test_main_path_bits_unchanged_by_the_wide_mask():
    # At the main path's cap of 9 the mask stays int32, and its bits are the
    # low bits of the int64 mask of a wider cap: the same cull, slot by slot.
    # The plain duplicate_with_keys gives the same pairs from either dtype.
    _, t_sg = project_both(make_scene(3, 300, n_dead=20, n_wide=10), BIG)
    counts, base, nx, mask = tile_rects(t_sg, BIG_TILES, BIG_TILES, 9)
    assert mask.dtype == torch.int32
    w_counts, w_base, w_nx, w_mask = tile_rects(t_sg, BIG_TILES, BIG_TILES, 40)
    assert w_mask.dtype == torch.int64 and int(w_counts.max()) > 9
    low = w_mask & 0x1FF
    live = low != 0
    assert torch.equal(mask.long(), low)
    assert torch.equal(counts, torch.tensor([bin(int(m)).count("1") for m in low], dtype=torch.int32))
    assert torch.equal(base[live], w_base[live]) and torch.equal(nx[live], w_nx[live])
    ids, keys = duplicate_with_keys_reference(counts, mask, base, nx, t_sg.depth, BIG_TILES, 9)
    ids64, keys64 = duplicate_with_keys_reference(counts, mask.long(), base, nx, t_sg.depth, BIG_TILES, 9)
    assert torch.equal(ids, ids64) and torch.equal(keys, keys64)


def test_covering_cap_keeps_every_slot():
    # With the covering cap, every slot that survives the cull is kept: the
    # masks equal those of the widest cap the mask holds.
    _, t_sg = project_both(make_scene(3, 300, n_dead=20, n_wide=10), BIG)
    cap = covering_cap(t_sg, (BIG, BIG))
    assert 9 < cap <= BIG_TILES**2
    mask = tile_rects(t_sg, BIG_TILES, BIG_TILES, cap)[3]
    widest = tile_rects(t_sg, BIG_TILES, BIG_TILES, MAX_TILES_PER_GAUSSIAN)[3]
    assert torch.equal(mask.long(), widest)
    assert not torch.equal(tile_rects(t_sg, BIG_TILES, BIG_TILES, cap - 1)[3].long(), widest)


# -- covariance_to_scale_rotation and the PLY export -------------------------------


def random_covariances(seed, n):
    rng = np.random.default_rng(seed)
    q = random_rotations(rng, n)
    # A tenth of the rotations near half-turns, where the trace alone
    # recovers the quaternion poorly.
    q[: n // 10, 3] *= 1e-3
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    scales = np.exp(rng.uniform(-3.0, 1.0, (n, 3)))
    return build_covariance(torch.from_numpy(scales), torch.from_numpy(q)).float().numpy()


def test_covariance_to_scale_rotation_rebuilds_the_covariance():
    cov = random_covariances(0, 2000)
    scales, quats = covariance_to_scale_rotation(torch.from_numpy(cov))
    rebuilt = build_covariance(scales, quats).numpy()
    rel = np.abs(rebuilt - cov).max(axis=(1, 2)) / np.abs(cov).max(axis=(1, 2))
    assert rel.max() < 1e-5, rel.max()
    np.testing.assert_allclose(np.linalg.norm(quats.numpy(), axis=-1), 1.0, atol=1e-6)
    # Scales in eigh's ascending order, as the JAX package's, to float32
    # eigh's accuracy: 1e-5 of each covariance's largest scale.
    jax_scales = np.asarray(jax_cov_to_sr(jnp.asarray(cov))[0])
    err = np.abs(scales.numpy() - jax_scales).max(axis=-1) / jax_scales.max(axis=-1)
    assert err.max() < 1e-5, err.max()


def test_symmetric_eigh_3x3_matches_eigh():
    cov = random_covariances(1, 500)
    cov[:5] = np.diag([2.0, 2.0, 0.5]).astype(np.float32)      # repeated eigenvalues
    cov[5] = 0.0
    values, vectors = symmetric_eigh_3x3(torch.from_numpy(cov))
    expected = np.linalg.eigvalsh(cov.astype(np.float64))
    scale = np.abs(expected).max(axis=-1, keepdims=True) + 1e-30
    np.testing.assert_allclose(values.numpy() / scale, expected / scale, atol=1e-6)
    v = vectors.double().numpy()
    np.testing.assert_allclose(v.transpose(0, 2, 1) @ v, np.broadcast_to(np.eye(3), v.shape), atol=1e-6)
    np.testing.assert_allclose((cov @ v - v * values.numpy()[:, None, :]) / scale[..., None], 0.0, atol=1e-6)


def ply_inputs(seed, n=500):
    rng = np.random.default_rng(seed)
    angle = rng.uniform(-0.5, 0.5)
    ext = np.eye(4, dtype=np.float32)
    ext[:3, :3] = [[np.cos(angle), 0, np.sin(angle)], [0, 1, 0], [-np.sin(angle), 0, np.cos(angle)]]
    ext[:3, 3] = rng.uniform(-1, 1, 3)
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return (ext, f32(rng.normal(size=(n, 3)) * 2), f32(np.exp(rng.uniform(-4, 0, (n, 3)))),
            f32(random_rotations(rng, n)), f32(rng.normal(size=(n, 3, 4))), f32(rng.uniform(0, 1, n)))


def rebuilt_covariances(columns):
    scales = np.exp(np.stack([columns[f"scale_{i}"] for i in range(3)], axis=-1)).astype(np.float64)
    w, x, y, z = (columns[f"rot_{i}"].astype(np.float64) for i in range(4))
    return build_covariance(torch.from_numpy(scales), torch.from_numpy(np.stack([x, y, z, w], axis=-1))).numpy()


def test_export_ply_matches_jax(tmp_path):
    inputs = ply_inputs(0)
    jax_export_ply(*inputs, tmp_path / "jax.ply")
    export_ply(*[torch.from_numpy(x) for x in inputs], tmp_path / "port.ply")
    header = lambda p: p.read_bytes().split(b"end_header\n")[0]  # noqa: E731
    assert header(tmp_path / "jax.ply") == header(tmp_path / "port.ply")
    ours, theirs = load_ply(tmp_path / "port.ply"), jax_load_ply(tmp_path / "jax.ply")
    assert list(ours) == list(theirs)
    for name in ours:
        if not name.startswith("rot_"):
            np.testing.assert_allclose(ours[name], theirs[name], atol=1e-6, rtol=1e-6, err_msg=name)
    rel = np.abs(rebuilt_covariances(ours) - rebuilt_covariances(theirs)).max(axis=(1, 2))
    assert (rel / rebuilt_covariances(theirs).max(axis=(1, 2)) < 1e-5).all()
    # load_ply reads back exactly what was written.
    data = (tmp_path / "port.ply").read_bytes().split(b"end_header\n")[1]
    np.testing.assert_array_equal(np.stack(list(ours.values()), axis=1).tobytes(), data)


def test_export_gaussians_ply_matches_jax(tmp_path):
    g = random_gaussians(3, 200)
    ext = np.eye(4, dtype=np.float32)[None, None]
    jax_encvis.export_gaussians_ply(as_jax(g), {"extrinsics": jnp.asarray(ext)}, tmp_path / "jax.ply")
    encvis.export_gaussians_ply(as_port(g), {"extrinsics": torch.from_numpy(ext)}, tmp_path / "port.ply")
    ours, theirs = load_ply(tmp_path / "port.ply"), jax_load_ply(tmp_path / "jax.ply")
    for name in ("x", "y", "z", "f_dc_0", "f_dc_1", "f_dc_2", "opacity"):
        np.testing.assert_allclose(ours[name], theirs[name], atol=1e-6, err_msg=name)
    # Eigen-decompositions differ in order and signs: compare what they rebuild.
    theirs_cov, ours_cov = rebuilt_covariances(theirs), rebuilt_covariances(ours)
    scale = np.abs(theirs_cov).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(ours_cov / scale, theirs_cov / scale, atol=1e-4)


# -- drawing and colors ----------------------------------------------------------


def test_distinct_colors_match_jax():
    for i in range(30):
        np.testing.assert_allclose(colors.get_distinct_color(i), jax_colors.get_distinct_color(i), atol=1e-6)


def test_coordinate_conversions_match_jax():
    xy = np.random.default_rng(0).uniform(-1, 2, (7, 2)).astype(np.float32)
    ours = coordinate_conversion.generate_conversions((30, 40), (-1.0, 2.0), (0.5, 1.5))
    theirs = jax_conv.generate_conversions((30, 40), (-1.0, 2.0), (0.5, 1.5))
    for name in ("world_to_pixel", "pixel_to_world"):
        np.testing.assert_allclose(getattr(ours, name)(torch.from_numpy(xy)).numpy(), getattr(theirs, name)(xy),
                                   atol=1e-6, err_msg=name)


@pytest.mark.parametrize("per_entity_color", [False, True])
def test_draw_points_and_lines_match_jax(per_entity_color):
    rng = np.random.default_rng(1)
    image = rng.uniform(0, 1, (24, 36, 3)).astype(np.float32)
    n = 5
    a, b = rng.uniform(-0.1, 1.1, (n, 2)), rng.uniform(-0.1, 1.1, (n, 2))
    color = rng.uniform(0, 1, (n, 3)) if per_entity_color else np.array([0.2, 0.9, 0.4])
    ours = draw_points(torch.from_numpy(image), a, color, radius=2.5).numpy()
    np.testing.assert_allclose(ours, jax_draw_points(image, a, color, radius=2.5), atol=1e-6)
    ours = draw_lines(torch.from_numpy(image), a, b, color, radius=1.5, supersample=3).numpy()
    np.testing.assert_allclose(ours, jax_draw_lines(image, a, b, color, radius=1.5, supersample=3), atol=1e-6)


def test_drawing_in_bands_matches_one_pass(monkeypatch):
    # The distance field is evaluated a band of rows at a time; a band of
    # one row gives the same image.
    import latentsplat_tpu_torch.visualization.drawing.rendering as rendering

    rng = np.random.default_rng(2)
    image = torch.from_numpy(rng.uniform(0, 1, (20, 16, 3)).astype(np.float32))
    a, b = rng.uniform(0, 1, (9, 2)), rng.uniform(0, 1, (9, 2))
    whole = draw_lines(image, a, b, [1.0, 0.0, 0.0])
    monkeypatch.setattr(rendering, "SAMPLE_BUDGET", 1)
    assert torch.equal(draw_lines(image, a, b, [1.0, 0.0, 0.0]), whole)


def camera_rig(seed, n):
    rng = np.random.default_rng(seed)
    ext = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        a = rng.uniform(-0.4, 0.4)
        ext[i, :3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
        ext[i, :3, 3] = rng.uniform(-0.5, 0.5, 3)
    intr = np.tile(np.array([[0.9, 0, 0.5], [0, 0.9, 0.5], [0, 0, 1]], np.float32), (n, 1, 1))
    return ext, intr, np.full(n, 0.5, np.float32), np.full(n, 3.0, np.float32)


def test_camera_geometry_matches_jax():
    ext, intr, near, far = camera_rig(0, 4)
    t = [torch.from_numpy(x) for x in (ext, intr, near, far)]
    np.testing.assert_allclose(cameras.unproject_frustum_corners(t[0], t[1], t[2]).numpy(),
                               jax_cameras.unproject_frustum_corners(ext, intr, near), atol=1e-6)
    for ours, theirs in zip(cameras.compute_aabb(*t), jax_cameras.compute_aabb(ext, intr, near, far)):
        np.testing.assert_allclose(ours.numpy(), theirs, atol=1e-6)


def strip_label(image, resolution):
    """The image part of add_label(image): its last rows, first columns."""
    return image[-resolution:, :resolution]


def test_render_cameras_matches_jax():
    ext, intr, near, far = camera_rig(1, 5)

    def batch(convert):
        views = lambda s: {"extrinsics": convert(ext[None, s]), "intrinsics": convert(intr[None, s]),  # noqa: E731
                           "near": convert(near[None, s]), "far": convert(far[None, s])}
        return {"context": views(slice(0, 2)), "target": views(slice(2, 5))}

    ours = validation_in_3d.render_cameras(batch(torch.from_numpy), 64)
    theirs = jax_v3d.render_cameras(batch(np.asarray), 64)
    assert len(ours) == len(theirs) == 3
    for i, (o, t) in enumerate(zip(ours, theirs)):
        # float32 inverses of the intrinsics (LAPACK's and torch's) move the
        # frustum corners by an ulp: ~1e-5 px at line edges.
        np.testing.assert_allclose(strip_label(o, 64), strip_label(t, 64), atol=1e-4, err_msg=str(i))
        label = add_label(np.zeros((64, 64, 3), np.float32), f"{'XYZ'[(i + 1) % 3]}{'XYZ'[(i + 2) % 3]} Projection")
        assert o.shape == label.shape


@pytest.mark.parametrize("draw_label", [False, True])
def test_render_projections_matches_jax(draw_label):
    g = random_gaussians(4, 400, n_wide=3, spread=2.0)
    g["means"][0, :, 2] *= 0.5          # a flatter scene: the projections differ
    ours = validation_in_3d.render_projections(as_port(g), 64, draw_label=draw_label, extra_label="x")
    theirs = jax_v3d.render_projections(as_jax(g), 64, draw_label=draw_label, extra_label="x")
    if not draw_label:
        assert ours.shape == theirs.shape == (1, 3, 64, 64, 3)
        np.testing.assert_allclose(ours, theirs, atol=RENDER_ATOL)
        return
    for axis in range(3):
        labeled = add_label(np.zeros((64, 64, 3)), f"{'XYZ'[(axis + 1) % 3]}{'XYZ'[(axis + 2) % 3]} Projection x")
        assert ours.shape[2:4] == labeled.shape[:2]
        np.testing.assert_allclose(strip_label(ours[0, axis], 64), np.clip(strip_label(theirs[0, axis], 64), 0, 1),
                                   atol=RENDER_ATOL)


# -- encoder panels --------------------------------------------------------------


def panel_context(seed, v=2, h=8, w=8):
    rng = np.random.default_rng(seed)
    ext = np.tile(np.eye(4, dtype=np.float32), (1, v, 1, 1))
    ext[0, 1, 0, 3] = 0.5
    intr = np.tile(np.array([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]], np.float32), (1, v, 1, 1))
    return {"image": rng.uniform(0, 1, (1, v, h, w, 3)).astype(np.float32), "extrinsics": ext,
            "intrinsics": intr, "near": np.full((1, v), 0.5, np.float32), "far": np.full((1, v), 20.0, np.float32)}


@pytest.fixture
def same_labels(monkeypatch):
    # One font for both packages' panels, so that their layouts are equal.
    monkeypatch.setattr(jax_encvis, "add_label", add_label)


def test_encoder_panels_match_jax(same_labels):
    v, h, w, s = 2, 8, 8, 4
    ctx = panel_context(0, v, h, w)
    jctx = {k: jnp.asarray(x) for k, x in ctx.items()}
    tctx = {k: torch.from_numpy(x) for k, x in ctx.items()}
    keys = ("extrinsics", "intrinsics", "near", "far")
    jsampling = jax_sample(jctx["image"], *[jctx[k] for k in keys], s)
    tsampling = sample_epipolar_features(tctx["image"], *[tctx[k] for k in keys], s)
    for name in ("xy_sample_near", "xy_sample_far"):
        np.testing.assert_allclose(getattr(tsampling, name).numpy(), np.asarray(getattr(jsampling, name)), atol=1e-6)

    rng = np.random.default_rng(1)
    g = v * h * w
    gaussians = {"means": rng.normal(size=(1, g, 3)).astype(np.float32),
                 "opacities": rng.uniform(size=(1, g)).astype(np.float32),
                 "color_harmonics": rng.uniform(size=(1, g, 3, 1)).astype(np.float32),
                 "covariances": random_covariances(2, g)[None]}
    pdf = rng.uniform(size=(1, v, h * w, s)).astype(np.float32)
    attention = rng.uniform(size=(2, 2, h * w, s)).astype(np.float32)
    mono = rng.uniform(size=(1, v, h, w)) > 0.5
    pairs = [
        (encvis.visualize_epipolar_samples(tctx, tsampling, num_rays=4),
         jax_encvis.visualize_epipolar_samples(jctx, jsampling, num_rays=4)),
        (encvis.visualize_depth(tctx, as_port(gaussians), 1), jax_encvis.visualize_depth(jctx, as_jax(gaussians), 1)),
        (encvis.visualize_overlaps(tctx, tsampling, is_monocular=torch.from_numpy(mono)),
         jax_encvis.visualize_overlaps(jctx, jsampling, is_monocular=mono)),
        (encvis.visualize_gaussians(tctx, as_port(gaussians), 1),
         jax_encvis.visualize_gaussians(jctx, as_jax(gaussians), 1)),
        (encvis.visualize_probabilities(tctx, tsampling, torch.from_numpy(pdf), num_rays=4),
         jax_encvis.visualize_probabilities(jctx, jsampling, pdf, num_rays=4)),
        (encvis.visualize_attention_maps(tctx, tsampling, torch.from_numpy(attention), num_rays=4),
         jax_encvis.visualize_attention_maps(jctx, jsampling, attention, num_rays=4)),
        (encvis.visualize_epipolar_color_samples(tctx, num_rays=4, num_samples=s),
         jax_encvis.visualize_epipolar_color_samples(jctx, num_rays=4, num_samples=s)),
    ]
    for i, (ours, theirs) in enumerate(pairs):
        assert ours.shape == np.asarray(theirs).shape, i
        np.testing.assert_allclose(ours, np.asarray(theirs), atol=1e-5, err_msg=str(i))


# -- capture_attention on the tiny model -----------------------------------------


def random_leaves(params, rng):
    def leaf(path, x):
        keys = [p.key for p in path]
        shape = np.shape(x)
        if keys[-1] == "kernel":
            return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        if keys[-1] == "scale":
            return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def tiny_models(overrides=()):
    """The tiny trainer configuration's generator in both packages, with the
    same random weights."""
    import sys
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from __graft_entry__ import _arc_batch

    jcfg = jax_load_config(None, TINY + list(overrides))
    jmodel = JaxLatentSplat(jcfg.model, (0.0, 0.0, 0.0))
    batch = _arc_batch(1, 2, 1, 32, 32)
    shapes = jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), batch)["generator"])
    params = random_leaves(shapes, np.random.default_rng(7))
    model = LatentSplat(load_config(None, TINY + list(overrides)).model).eval()
    model.load_state_dict(params_from_jax(params, model), strict=True)
    return jmodel, params, model, batch


def jax_softmaxes(tree, path=()):
    """Attention weights of every Attention module in a flax intermediates
    tree, rebuilt from its captured projections: {dotted path: (b, h, n, m)}."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict) and ("to_qkv" in value or "to_q" in value):
            if "to_qkv" in value:
                q, k, _ = np.split(np.asarray(value["to_qkv"]["__call__"][0]), 3, axis=-1)
            else:
                q = np.asarray(value["to_q"]["__call__"][0])
                k, _ = np.split(np.asarray(value["to_kv"]["__call__"][0]), 2, axis=-1)
            out[".".join((*path, key))] = (q, k)
        elif isinstance(value, dict):
            out.update(jax_softmaxes(value, (*path, key)))
    return out


def test_capture_attention_matches_jax(monkeypatch):
    # The epipolar transformer's keys encode each sample's triangulated
    # depth at 2^9 cycles; as in test_torch_slice, the JAX side's depths are
    # replayed into the port so that the weights agree to float32 rounding.
    import latentsplat_tpu.model.encoder.epipolar_transformer as jax_et
    import latentsplat_tpu_torch.model.encoder.epipolar_transformer as port_et

    jmodel, params, model, batch = tiny_models()
    captured = {}
    jax_get_depth = jax_et.get_depth

    def keep_depth(*args):
        captured["depth"] = np.asarray(jax_get_depth(*args))
        return jax_get_depth(*args)

    monkeypatch.setattr(jax_et, "get_depth", keep_depth)
    context = jax.tree_util.tree_map(jnp.asarray, batch["context"])
    tree = jax_encvis.capture_attention(jmodel.encoder, params["encoder"], context)
    monkeypatch.setattr(port_et, "get_depth", lambda *args: torch.from_numpy(captured["depth"]))
    ours = encvis.capture_attention(model.encoder, {k: torch.from_numpy(np.asarray(x)) for k, x in batch["context"].items()})

    theirs = jax_softmaxes(tree)
    assert set(ours["attention"]) == set(theirs) and len(theirs) == 2, (set(ours["attention"]), set(theirs))
    for path, (q, k) in theirs.items():
        weights = ours["attention"][path]
        heads = weights.shape[1]
        split = lambda t: t.reshape(*t.shape[:2], heads, -1).transpose(0, 2, 1, 3)  # noqa: E731
        dots = np.einsum("bhid,bhjd->bhij", split(q), split(k)) * (q.shape[-1] // heads) ** -0.5
        expected = np.exp(dots - dots.max(-1, keepdims=True))
        expected /= expected.sum(-1, keepdims=True)
        np.testing.assert_allclose(weights.numpy(), expected, atol=1e-5, err_msg=path)
    sampling = ours["sampling"]
    assert sampling.xy_sample.shape[:2] == (1, 2) and ours["gaussians"].means.shape[0] == 1
    np.testing.assert_allclose(ours["gaussians"].means.numpy(), np.asarray(tree["__call__"][0].means), atol=1e-4)


def test_capture_attention_prefix_and_hooks_removed():
    _, _, model, batch = tiny_models()
    context = {k: torch.from_numpy(np.asarray(x)) for k, x in batch["context"].items()}
    out = encvis.capture_attention(model.encoder, context, prefix="epipolar_transformer.transformer.attn")
    assert list(out["attention"]) == ["epipolar_transformer.transformer.attn_0"]
    assert all(not m._forward_hooks for m in model.encoder.modules())


# -- the scripts -----------------------------------------------------------------


def capture_saves(monkeypatch, module, root):
    """Keep the images a script saves, by path under `root`, in place of writing PNGs."""
    saved = {}

    def save(image, path):
        saved[str(Path(path).relative_to(root))] = np.asarray(image, np.float32)

    monkeypatch.setattr(module, "save_image", save)
    return saved


def test_visualize_epipolar_lines_matches_jax(tmp_path, monkeypatch):
    import latentsplat_tpu.scripts.visualize_epipolar_lines as jax_script
    from latentsplat_tpu_torch.scripts import visualize_epipolar_lines as script

    theirs, ours = capture_saves(monkeypatch, jax_script, tmp_path), capture_saves(monkeypatch, script, tmp_path)
    argv = TINY + [f"output_path={tmp_path}", "num_rays=5"]
    jax_script.main(argv)
    script.main(argv, device="cpu")
    assert sorted(ours) == sorted(theirs) and len(ours) == 4
    for name in ours:
        np.testing.assert_allclose(ours[name], theirs[name], atol=2e-3, err_msg=name)


def test_scripts_need_a_card_unless_asked_for_the_cpu():
    from latentsplat_tpu_torch.scripts import render_uncertainty, visualize_epipolar_lines

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for script in (render_uncertainty, visualize_epipolar_lines):
        with pytest.raises(SystemExit, match="no CUDA device"):
            script.main(TINY)


def capture_calls(monkeypatch, module, name):
    """Record the first argument of every call of `module.name`."""
    calls = []
    original = getattr(module, name)

    def spy(x, *args, **kwargs):
        calls.append(np.array(x))
        return original(x, *args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def test_render_uncertainty_matches_jax(tmp_path, monkeypatch):
    # Each PNG is [color render | PCA of the feature means | std heat map].
    # The color panel is compared as saved; the PCA and the heat map
    # normalize by quantiles and by min and max, which amplify float32
    # rounding (and the PCA's components rotate where singular values are
    # close), so their inputs, the rendered feature means and stds, are
    # compared, and the two functions themselves on the same input in
    # test_pca_and_uncertainty_maps_match_jax. The JAX side's triangulated
    # sample depths are replayed into the port, scene by scene, as in
    # test_capture_attention_matches_jax.
    import latentsplat_tpu.model.encoder.epipolar_transformer as jax_et
    import latentsplat_tpu.scripts.render_uncertainty as jax_script
    import latentsplat_tpu_torch.model.encoder.epipolar_transformer as port_et
    from latentsplat_tpu.training.checkpointing import save_checkpoint as jax_save_checkpoint
    from latentsplat_tpu_torch.scripts import render_uncertainty as script

    depths = []
    jax_get_depth = jax_et.get_depth

    def keep_depth(*args):
        depth = jax_get_depth(*args)
        jax.debug.callback(lambda d: depths.append(np.array(d)), depth)   # the encoder runs jitted
        return depth

    monkeypatch.setattr(jax_et, "get_depth", keep_depth)
    monkeypatch.setattr(port_et, "get_depth", lambda *args: torch.from_numpy(depths.pop(0)))

    _, params, model, _ = tiny_models(["model.variational=gaussians"])
    jax_save_checkpoint({"params_gen": params}, tmp_path / "jax", 0)
    torch.save({"step": 0, "generator": model.state_dict()}, tmp_path / "port.ckpt")
    out = tmp_path / "out"
    theirs, ours = capture_saves(monkeypatch, jax_script, out), capture_saves(monkeypatch, script, out)
    inputs = {(side, name): capture_calls(monkeypatch, module, name)
              for side, module in (("jax", jax_script), ("port", script))
              for name in ("pca_rgb", "uncertainty_map")}
    common = TINY + ["model.variational=gaussians", f"output_dir={tmp_path}", f"output_path={out}"]
    jax_script.main(common + [f"checkpointing.load={tmp_path / 'jax' / 'step_00000000'}"])
    scenes = {name.split("/")[0] for name in theirs}
    assert len(depths) == len(scenes)
    script.main(common + [f"checkpointing.load={tmp_path / 'port.ckpt'}"], device="cpu")
    assert sorted(ours) == sorted(theirs) and ours and not depths
    for name in ours:
        o, t = ours[name], theirs[name]
        assert o.shape == t.shape, name
        w = (o.shape[1] - 16) // 3
        np.testing.assert_allclose(o[:, :w], t[:, :w], atol=2e-3, err_msg=name)
    # The std is sqrt(1 - mask) where the render is not variational, which
    # magnifies the mask's rounding where it nears 1: the variances are
    # compared.
    for name, power in (("pca_rgb", 1), ("uncertainty_map", 2)):
        pairs = list(zip(inputs["port", name], inputs["jax", name]))
        assert len(pairs) == len(ours)
        for o, t in pairs:
            np.testing.assert_allclose(o**power, t**power, atol=2e-3, err_msg=name)


def test_pca_and_uncertainty_maps_match_jax():
    import latentsplat_tpu.scripts.render_uncertainty as jax_script
    from latentsplat_tpu_torch.scripts import render_uncertainty as script

    rng = np.random.default_rng(0)
    features = rng.normal(size=(12, 10, 6)).astype(np.float32)
    ours, theirs = script.pca_rgb(features), jax_script.pca_rgb(features)
    # The principal components' signs are the SVD's: a flipped one maps
    # its channel c to 1 - c.
    for c in range(3):
        a, b = ours[..., c], theirs[..., c]
        assert min(np.abs(a - b).max(), np.abs(a - (1 - b)).max()) <= 1e-6, c
    std = rng.uniform(0, 1, (12, 10, 6)).astype(np.float32)
    np.testing.assert_allclose(script.uncertainty_map(std), jax_script.uncertainty_map(std), atol=1e-6)
