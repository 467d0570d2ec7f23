"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
only torch and the port, so it also runs where JAX is not installed (the
shared tests/conftest.py imports JAX, hence --noconftest):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Each kernel is held to its plain version here and nowhere else: chip_smoke.py
runs this file first, then times the kernels and runs the whole program.
Every limit below is the one place its value is set.
"""

import collections

import numpy as np
import pytest
import torch

from latentsplat_tpu_torch import cuda_build
from latentsplat_tpu_torch.cuda_build import launched
from latentsplat_tpu_torch.ops.gaussians import build_covariance
from latentsplat_tpu_torch.ops.rasterize import kernels
from latentsplat_tpu_torch.ops.rasterize.camera import project_gaussians_to_screen
from latentsplat_tpu_torch.ops.rasterize.dense import composite_dense
from latentsplat_tpu_torch.ops.rasterize.tiled import (
    CULL_MARGIN,
    FAST_CULL_MARGIN,
    composite_tiled,
    depth_code_bits,
    pack_attributes,
    precision_knobs,
    quantize_attributes,
    sort_pairs,
    tile_pairs,
    tile_rects,
    tile_rects_reference,
)

pytestmark = pytest.mark.cuda

CAP = 9
# composite_forward against its plain version: the same operations in the
# same rounding order on the same device, so T and each channel within
# float32 rounding of the same sums (channels relative to their largest
# value where they carry depths).
KERNEL_ATOL = 1e-5
# composite_backward sums each pair's partials over the tile in its own
# order and recovers T with one reciprocal, the plain version sums in
# torch.sum's order and divides: float32 rounding of ~256-term sums, 1e-4
# of each gradient column's largest value.
BACKWARD_RTOL = 1e-4
# A fast-family gradient row is rounded to bfloat16 when it is written; a
# row whose float32 sum the kernel takes in another order than the plain
# version may round the other way: one bfloat16 step, at most 2^-7 of the
# value.
BF16_STEP = 2.0**-7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def screen_gaussians(seed, n, size, device, n_channels=4, n_wide=0, n_dead=0):
    """Projected random Gaussians in front of a camera at the origin."""
    g = torch.Generator().manual_seed(seed)
    z = torch.rand(n, generator=g) * 4 + 2
    xy = (torch.rand(n, 2, generator=g) * 1.2 - 0.6) * z[:, None]
    means = torch.cat([xy, z[:, None]], dim=1)
    scales = torch.rand(n, 3, generator=g) * 0.2 + 0.05
    scales[:n_wide] *= 12.0
    means[n - n_dead :, 2] *= -1.0
    quats = torch.nn.functional.normalize(torch.randn(n, 4, generator=g), dim=-1)
    covs = build_covariance(scales, quats)
    opacities = torch.rand(n, generator=g) * 0.65 + 0.3
    channels = torch.rand(n, n_channels, generator=g)
    intrinsics = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]])
    sg = project_gaussians_to_screen(
        means, covs, opacities, channels, torch.eye(4), intrinsics, (size, size)
    )
    return type(sg)(**{k: v.to(device) for k, v in vars(sg).items()})


@pytest.mark.parametrize("size", [32, 64, 256])
def test_duplicate_with_keys_matches_reference(cuda, size):
    tiles = size // 16
    sg = screen_gaussians(size, 20000, size, cuda, n_wide=200, n_dead=500)
    counts, base, nx, mask = tile_rects(sg, tiles, tiles, CAP)
    before = launched("duplicate_with_keys")
    gids, keys, _ = kernels.duplicate_with_keys(counts, mask, base, nx, sg.depth, tiles, CAP)
    ref_gids, ref_keys = kernels.duplicate_with_keys_reference(counts, mask, base, nx, sg.depth, tiles, CAP)
    torch.cuda.synchronize()
    assert launched("duplicate_with_keys") == before + 1
    assert torch.equal(gids, ref_gids) and torch.equal(keys, ref_keys)


@pytest.mark.parametrize("n", [1, 255, 5000])
def test_duplicate_with_keys_full_masks(cuda, n):
    # Masks of up to 32 slots: a block's pairs overflow its shared staging
    # and are written in rounds; ragged ends at every 16-byte alignment.
    rng = np.random.default_rng(n)
    bits = rng.random((n, 32)) < rng.choice([0.05, 0.5, 1.0], (n, 1))
    bits[: n // 3] = True
    mask = torch.from_numpy((bits * (1 << np.arange(32, dtype=np.uint64))).sum(1).astype(np.uint32).view(np.int32))
    counts = torch.from_numpy(bits.sum(1).astype(np.int32))
    nx = torch.from_numpy(rng.integers(1, 9, n).astype(np.int32))
    base = torch.from_numpy(rng.integers(0, 4096, n).astype(np.int32))
    depth = torch.from_numpy(rng.uniform(0.1, 100.0, n).astype(np.float32))
    args = [x.to(cuda) for x in (counts, mask, base, nx, depth)]
    gids, keys, _ = kernels.duplicate_with_keys(*args, 64, 32)
    ref_gids, ref_keys = kernels.duplicate_with_keys_reference(*args, 64, 32)
    torch.cuda.synchronize()
    assert torch.equal(gids, ref_gids) and torch.equal(keys, ref_keys)


@pytest.mark.parametrize("cap", [40, 64])
def test_duplicate_with_keys_64_bit_masks(cuda, cap):
    # The int64-mask instantiation, at caps above what an int32 mask holds:
    # on the rects of wide splats (tile_rects at that cap), and on random
    # masks with the top slots set, written in rounds.
    sg = screen_gaussians(cap, 20000, 256, cuda, n_wide=2000, n_dead=500)
    counts, base, nx, mask = tile_rects(sg, 16, 16, cap)
    assert mask.dtype == torch.int64 and int(counts.max()) > 32
    before = launched("duplicate_with_keys")
    gids, keys, _ = kernels.duplicate_with_keys(counts, mask, base, nx, sg.depth, 16, cap)
    ref_gids, ref_keys = kernels.duplicate_with_keys_reference(counts, mask, base, nx, sg.depth, 16, cap)
    torch.cuda.synchronize()
    assert launched("duplicate_with_keys") == before + 1
    assert torch.equal(gids, ref_gids) and torch.equal(keys, ref_keys)

    n = 5000
    rng = np.random.default_rng(cap)
    bits = rng.random((n, cap)) < rng.choice([0.05, 0.5, 1.0], (n, 1))
    bits[: n // 3] = True
    weights = np.zeros(64, np.uint64)
    weights[:cap] = 1 << np.arange(cap, dtype=np.uint64)
    mask = torch.from_numpy((np.pad(bits, ((0, 0), (0, 64 - cap))) * weights).sum(1, dtype=np.uint64).view(np.int64))
    counts = torch.from_numpy(bits.sum(1).astype(np.int32))
    nx = torch.from_numpy(rng.integers(1, 9, n).astype(np.int32))
    base = torch.from_numpy(rng.integers(0, 4096, n).astype(np.int32))
    depth = torch.from_numpy(rng.uniform(0.1, 100.0, n).astype(np.float32))
    args = [x.to(cuda) for x in (counts, mask, base, nx, depth)]
    gids, keys, _ = kernels.duplicate_with_keys(*args, 64, cap)
    ref_gids, ref_keys = kernels.duplicate_with_keys_reference(*args, 64, cap)
    torch.cuda.synchronize()
    assert torch.equal(gids, ref_gids) and torch.equal(keys, ref_keys)


def test_duplicate_with_keys_refuses_a_cap_beyond_the_mask(cuda):
    sg = screen_gaussians(3, 100, 64, cuda)
    counts, base, nx, mask = tile_rects(sg, 4, 4, CAP)
    with pytest.raises(ValueError, match="holds 32 slots, cap is 40"):
        kernels.duplicate_with_keys(counts, mask, base, nx, sg.depth, 4, 40)


# Conics given to the first rows of every item of a cull pass, all wide
# splats: a degenerate (rank 1) and a zero conic, a NaN and an infinite one.
SPECIAL_CONICS = ((1.0, 1.0, 1.0), (0.0, 0.0, 0.0), (float("nan"), 0.5, 1.0), (float("inf"), 0.0, float("inf")))


def cull_pass(seed, n, shape, device, items=1, n_wide=0, n_dead=0):
    """A pass of `items` views (each camera shifted sideways) of n projected
    Gaussians at `shape`; the first n_wide are wide, the last n_dead behind
    the cameras, and rows 0-3 of every item get SPECIAL_CONICS."""
    g = torch.Generator().manual_seed(seed)
    z = torch.rand(n, generator=g) * 4 + 2
    xy = (torch.rand(n, 2, generator=g) * 1.2 - 0.6) * z[:, None]
    means = torch.cat([xy, z[:, None]], dim=1)
    scales = torch.rand(n, 3, generator=g) * 0.2 + 0.05
    scales[:n_wide] *= 12.0
    means[:n_wide, :2] *= 0.2
    means[n - n_dead :, 2] *= -1.0
    quats = torch.nn.functional.normalize(torch.randn(n, 4, generator=g), dim=-1)
    extrinsics = torch.eye(4).repeat(items, 1, 1)
    extrinsics[:, 0, 3] = torch.linspace(-0.3, 0.3, items)
    sg = project_gaussians_to_screen(
        means, build_covariance(scales, quats), torch.rand(n, generator=g) * 0.65 + 0.3, torch.rand(items, n, 1),
        extrinsics, torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]]).expand(items, 3, 3), shape,
    )
    sg.conic[:, : len(SPECIAL_CONICS)] = torch.tensor(SPECIAL_CONICS)
    assert (sg.radius[:, : len(SPECIAL_CONICS)] > 0).all()
    return type(sg)(**{k: v.to(device) for k, v in vars(sg).items()})


def assert_cull_matches_reference(sg, tiles_x, tiles_y, cap=CAP, margin=CULL_MARGIN):
    """The kernel's four outputs equal the plain version's bit for bit, in
    one launch; returns the kernel's outputs."""
    before = launched("tile_cull")
    out = tile_rects(sg, tiles_x, tiles_y, cap, margin)
    ref = tile_rects_reference(sg, tiles_x, tiles_y, cap, margin)
    torch.cuda.synchronize()
    assert launched("tile_cull") == before + 1
    for name, a, b in zip(("counts", "base", "nx", "mask"), out, ref):
        assert a.dtype == b.dtype and torch.equal(a, b), f"{name}: {int((a != b).sum())} rows differ"
    return out


@pytest.mark.parametrize("margin", [CULL_MARGIN, FAST_CULL_MARGIN])
@pytest.mark.parametrize("cap", [1, 9, 32, 33, 64])
def test_tile_cull_matches_reference(cuda, cap, margin):
    # Int32 masks up to 32 slots, int64 above; dead rows and the special
    # conics in each of 3 items; rects of wide splats beyond every cap.
    sg = cull_pass(cap, 20000, (256, 256), cuda, items=3, n_wide=2000, n_dead=500)
    counts, base, nx, mask = assert_cull_matches_reference(sg, 16, 16, cap, margin)
    assert mask.dtype == (torch.int32 if cap <= 32 else torch.int64)
    assert int(counts.max()) == cap and (base == 3 * 256).sum() >= 3 * 500


@pytest.mark.parametrize("shape", [(128, 256), (256, 128)])
def test_tile_cull_non_square_grids(cuda, shape):
    # 16 x 8 and 8 x 16 tiles: rows and columns of the rect decode apart.
    sg = cull_pass(7, 20000, shape, cuda, items=2, n_wide=500, n_dead=100)
    assert_cull_matches_reference(sg, shape[1] // 16, shape[0] // 16)
    assert_cull_matches_reference(sg, shape[1] // 16, shape[0] // 16, 40, FAST_CULL_MARGIN)


@pytest.mark.parametrize("n", [30, 8], ids=["video", "train"])
def test_tile_cull_video_pass(cuda, n):
    # A pass of bench_render's 393,216 Gaussians: the video cell's 30 views,
    # and the train step's 2 scenes x 4 target views.
    from latentsplat_tpu_torch.scripts.bench_render import make_scene

    scene = make_scene(0, n_views=n, device=cuda)
    g = scene["gaussian_means"].shape[1]
    s = 1.0 / scene["near"][0]
    ext = scene["extrinsics"][0].clone()
    ext[:, :3, 3] *= s[:, None]
    sg = project_gaussians_to_screen(
        scene["gaussian_means"][0] * s[:, None, None], scene["gaussian_covariances"][0] * (s * s)[:, None, None, None],
        scene["gaussian_opacities"][0].expand(n, -1), torch.zeros(n, g, 1, device=cuda), ext,
        scene["intrinsics"][0], (256, 256),
    )
    counts = assert_cull_matches_reference(sg, 16, 16)[0]
    assert counts.shape == (n * g,) and int(counts.sum()) > n * g // 2


def test_tile_cull_one_launch_a_render_pass(cuda):
    # A render call of 3 views is one pass: one cull, one duplication.
    from latentsplat_tpu_torch.scripts.bench_render import make_scene, render_scene

    scene = make_scene(1, side=64, n_views=3, device=cuda)
    before = {k: launched(k) for k in ("tile_cull", "duplicate_with_keys")}
    render_scene(scene, 256)
    torch.cuda.synchronize()
    assert {k: launched(k) - n for k, n in before.items()} == {"tile_cull": 1, "duplicate_with_keys": 1}


def test_tile_cull_checks_inputs(cuda):
    sg = cull_pass(8, 100, (64, 64), cuda)
    with pytest.raises(ValueError, match="mean2d must be float32"):
        tile_rects(type(sg)(**{**vars(sg), "mean2d": sg.mean2d.double()}), 4, 4)
    with pytest.raises(ValueError, match="all be on the CPU or all on CUDA"):
        tile_rects(type(sg)(**{**vars(sg), "radius": sg.radius.cpu()}), 4, 4)
    # A misaligned view of mean2d is copied for the kernel's float2 loads.
    wide = torch.cat([torch.zeros(1, 1, device=cuda), sg.mean2d.reshape(1, -1)], dim=1)
    assert_cull_matches_reference(type(sg)(**{**vars(sg), "mean2d": wide[0, 1:].reshape(sg.mean2d.shape)}), 4, 4)


# -- shade_project ------------------------------------------------------------


SCREEN_FIELDS = ("mean2d", "conic", "depth", "radius", "opacity", "channels", "extent")


def circle_cameras(n):
    """n cameras on a circle of radius 3 around the origin, looking at it
    (a co3d-like inward circle): (extrinsics (n, 4, 4), intrinsics)."""
    from latentsplat_tpu_torch.dataset.synthetic import _look_at

    angles = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    ext = np.stack([_look_at(np.array([3 * np.cos(a), 0.4 * np.sin(3 * a), 3 * np.sin(a)], np.float32),
                             np.zeros(3, np.float32)) for a in angles])
    intr = np.tile(np.asarray([[0.9, 0.0, 0.5], [0.0, 0.9, 0.5], [0.0, 0.0, 1.0]], np.float32), (n, 1, 1))
    return torch.from_numpy(ext.astype(np.float32)), torch.from_numpy(intr)


def shade_inputs(seed, cameras, scenes, views, n, device, start=0, items=None, color_k=25, feature=(4, 9),
                 scale_invariant=True, layout="circle", payload=False):
    """`shade`'s arguments for the pass of `items` items from `start` of
    `scenes` scenes of `views` views each (cameras (ext, intr), one a view)
    over n Gaussians a scene: a ball around the origin ("circle") or a
    frustum down +z ("forward"). Rows 0-6 of every scene are the edge
    cases: a mean in front of item 0's near plane and one behind its
    camera, a rank-1 and a zero covariance, opacities under 1/255 and at
    0, and a mean far outside the guard band; row 7 sits on item 0's
    camera (a zero view direction). color_k 0 or feature None leaves that
    table out; `payload` gives each item a 3-channel payload instead."""
    g = torch.Generator().manual_seed(seed)
    if layout == "circle":
        means = torch.nn.functional.normalize(torch.randn(scenes, n, 3, generator=g), dim=-1)
        means = means * torch.rand(scenes, n, 1, generator=g) ** (1 / 3)
    else:
        z = torch.rand(scenes, n, generator=g) * 4 + 2
        xy = (torch.rand(scenes, n, 2, generator=g) * 1.2 - 0.6) * z[..., None]
        means = torch.cat([xy, z[..., None]], dim=-1)
    scales = torch.rand(scenes, n, 3, generator=g) * 0.05 + 0.01
    quats = torch.nn.functional.normalize(torch.randn(scenes, n, 4, generator=g), dim=-1)
    opacities = torch.rand(scenes, n, generator=g) * 0.7 + 0.3
    ext, intr = cameras
    ext, intr = ext[:views].repeat(scenes, 1, 1), intr[:views].repeat(scenes, 1, 1)
    cam0 = ext[0, :3, 3]
    means[:, 0] = cam0 + 0.1 * ext[0, :3, 2]                 # in front of item 0's near plane (scaled)
    means[:, 1] = cam0 - 2.0 * ext[0, :3, 2]                 # behind item 0's camera
    scales[:, 2] = torch.tensor([2.0, 1e-6, 1e-6])           # rank 1: |rho| clamps at 0.99
    scales[:, 3] = 0.0                                       # zero covariance: the blur alone
    opacities[:, 4] = 1.0 / 255.0 - 1e-4
    opacities[:, 5] = 0.0
    means[:, 6] = cam0 + ext[0, :3, 2] + 40.0 * ext[0, :3, 0]   # far outside item 0's guard band
    means[:, 7] = cam0
    covs = build_covariance(scales.reshape(-1, 3), quats.reshape(-1, 4)).reshape(scenes, n, 3, 3)
    tables = {}
    if color_k and not payload:
        tables["color"] = torch.randn(scenes, n, 3, color_k, generator=g) * 0.3
    if feature is not None and not payload:
        tables["feature"] = torch.randn(scenes, n, *feature, generator=g) * 0.3
    items = scenes * views - start if items is None else items
    near = torch.rand(scenes * views, generator=g) * 0.5 + 0.5
    per_item = [x[start : start + items] for x in (ext, intr, near)]
    item_payload = torch.randn(items, n, 3, generator=g) if payload else None
    on = lambda x: x.to(device) if x is not None else None  # noqa: E731
    return (on(means), on(covs), on(opacities), {k: on(v) for k, v in tables.items()}, *map(on, per_item), start,
            views, on(item_payload), scale_invariant)


def assert_shade_matches_reference(inputs, image_shape, use_sh=True):
    """`shade` on the card (one shade_project launch) against the plain
    shade: every field the same bits, the same dtypes and shapes."""
    from latentsplat_tpu_torch.ops.rasterize import shade

    before = launched("shade_project")
    with torch.no_grad():
        got = shade.shade(*inputs, use_sh, image_shape)
        want = shade.shade_reference(*inputs, use_sh, image_shape)
    torch.cuda.synchronize()
    assert launched("shade_project") == before + 1
    for name in SCREEN_FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype == torch.float32 and a.shape == b.shape, name
        differ = a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)
        assert not differ.any(), f"{name}: {int(differ.sum())} values differ, e.g. {a[differ][:4]} / {b[differ][:4]}"
    return got


@pytest.mark.parametrize("scale_invariant", [True, False])
def test_shade_project_co3d_circle(cuda, scale_invariant):
    # 30 views on an inward circle, color SH of degree 4, 4 feature
    # channels of degree 2 (the video cell's pass), with the edge rows.
    inputs = shade_inputs(0, circle_cameras(30), 1, 30, 40000, cuda, scale_invariant=scale_invariant)
    sg = assert_shade_matches_reference(inputs, (256, 256))
    live = sg.radius > 0
    assert 0.2 < float(live.float().mean()) < 1.0
    assert not live[0, 0] and not live[0, 1] and not live[:, 4:6].any() and not live[0, 6]


@pytest.mark.parametrize("scale_invariant", [True, False])
def test_shade_project_forward_facing(cuda, scale_invariant):
    # A re10k-like pass: 3 views on entry.arc_cameras' arc, Gaussians in a
    # frustum in front of them, 128 x 256 pixels.
    from latentsplat_tpu_torch.entry import arc_cameras

    cameras = tuple(torch.from_numpy(x) for x in arc_cameras(3))
    inputs = shade_inputs(1, cameras, 1, 3, 30000, cuda, scale_invariant=scale_invariant, layout="forward")
    sg = assert_shade_matches_reference(inputs, (128, 256))
    assert float((sg.radius > 0).float().mean()) > 0.5


@pytest.mark.parametrize("start, items", [(0, 8), (2, 5), (3, 1), (4, 4)])
def test_shade_project_pass_spanning_scenes(cuda, start, items):
    # 2 scenes x 4 views; a pass of items [start, start + items): item n
    # reads scene (start + n) // 4's rows, one or both scenes a pass.
    inputs = shade_inputs(2, circle_cameras(4), 2, 4, 5000, cuda, start=start, items=items)
    assert_shade_matches_reference(inputs, (64, 64))


@pytest.mark.parametrize("scale_invariant", [True, False])
def test_shade_project_payload_path(cuda, scale_invariant):
    # render_depth's path: each item's payload handed on as it is, the
    # projection computed in the kernel.
    inputs = shade_inputs(3, circle_cameras(6), 2, 3, 5000, cuda, payload=True, scale_invariant=scale_invariant)
    sg = assert_shade_matches_reference(inputs, (64, 64), use_sh=False)
    assert sg.channels is inputs[9]


@pytest.mark.parametrize("color_k, feature", [(25, (4, 9)), (16, (12, 4)), (1, (1, 25)), (0, (4, 9)),
                                              (25, None), (10, (3, 2)), (9, (5, 1))])
def test_shade_project_sh_degrees(cuda, color_k, feature):
    # Each table from degree 0 to 4, one or both, coefficient counts that
    # are not squares (the extra terms unused), 1 to 12 feature channels.
    inputs = shade_inputs(4, circle_cameras(5), 1, 5, 3000, cuda, color_k=color_k, feature=feature)
    sg = assert_shade_matches_reference(inputs, (64, 64))
    assert sg.channels.shape[-1] == (3 if color_k else 0) + (feature[0] if feature else 0)


@pytest.mark.parametrize("n_views", [30, 3], ids=["video", "serve"])
def test_shade_project_video_pass(cuda, n_views):
    # bench_render's scene, n_views of its 393,216 Gaussians in one pass:
    # the video cell's 30 views, and a serve request's 3 target views.
    from latentsplat_tpu_torch.scripts.bench_render import make_scene, shade_inputs as bench_shade_inputs

    assert_shade_matches_reference(bench_shade_inputs(make_scene(0, n_views=n_views, device=cuda)), (256, 256))


def test_shade_project_one_launch_a_render_pass(cuda):
    # A no-grad render call of 3 views is one pass: one shade_project
    # launch beside one duplicate_with_keys. Under autograd the plain shade
    # runs (no launch), and the render's outputs are the same bits.
    from latentsplat_tpu_torch.scripts.bench_render import make_scene, render_scene

    scene = make_scene(2, side=64, n_views=3, device=cuda)
    before = {k: launched(k) for k in ("shade_project", "duplicate_with_keys")}
    shaded = render_scene(scene, 256)
    torch.cuda.synchronize()
    assert {k: launched(k) - n for k, n in before.items()} == {"shade_project": 1, "duplicate_with_keys": 1}

    from latentsplat_tpu_torch.ops.rasterize.api import render

    leaves = {k: v.clone().requires_grad_() for k, v in scene.items() if k.startswith("gaussian_")}
    before = {k: launched(k) for k in ("shade_project", "duplicate_with_keys")}
    plain = render(scene["extrinsics"], scene["intrinsics"], scene["near"], scene["far"], (256, 256),
                   scene["background_color"], *(leaves[k] for k in ("gaussian_means", "gaussian_covariances",
                   "gaussian_opacities", "gaussian_color_sh", "gaussian_feature_sh")))
    (plain.color.sum() + plain.feature.sum()).backward()
    torch.cuda.synchronize()
    assert {k: launched(k) - n for k, n in before.items()} == {"shade_project": 0, "duplicate_with_keys": 1}
    for name in ("color", "feature", "mask", "depth", "num_pairs"):
        assert torch.equal(getattr(shaded, name), getattr(plain, name).detach()), name
    assert all(torch.isfinite(v.grad).all() for v in leaves.values())


def test_shade_project_checks_inputs(cuda):
    from latentsplat_tpu_torch.ops.rasterize.shade import shade, shade_project

    inputs = shade_inputs(5, circle_cameras(3), 1, 3, 200, cuda)
    means, covs, opacities, tables, ext, intr, near, start, views, payload, si = inputs
    with pytest.raises(ValueError, match="means must be float32"):
        shade_project(means.double(), *inputs[1:], (64, 64))
    with pytest.raises(ValueError, match="all be on the CPU or all on CUDA"):
        shade_project(means, covs, opacities.cpu(), *inputs[3:], (64, 64))
    with pytest.raises(ValueError, match="exceed 4"):
        shade_project(means, covs, opacities, {"color": torch.zeros(1, 200, 3, 36, device=cuda)}, *inputs[4:],
                      (64, 64))
    with pytest.raises(ValueError, match="items 2 .. 4 of 1 scenes of 3 views"):
        shade_project(*inputs[:7], 2, views, payload, si, (64, 64))
    with pytest.raises(ValueError, match="no SH table and no payload"):
        shade_project(means, covs, opacities, {}, *inputs[4:], (64, 64))
    # On the card without gradient `shade` always takes the kernel, which
    # raises on what it does not take; a table too wide for a block's
    # shared memory fails at launch. Nothing launches.
    before = launched("shade_project")
    with torch.no_grad():
        for dtype in (torch.float64, torch.bfloat16):
            with pytest.raises(ValueError, match="color SH must be float32"):
                shade(means, covs, opacities, {"color": tables["color"].to(dtype)}, *inputs[4:], True, (64, 64))
        with pytest.raises(ValueError, match="exceed 4"):
            shade(means, covs, opacities, {"color": torch.zeros(1, 200, 3, 36, device=cuda)}, *inputs[4:], True,
                  (64, 64))
        with pytest.raises(RuntimeError, match="shade_project: CUDA error 1 "):
            shade(means, covs, opacities, {"feature": torch.zeros(1, 200, 200, 25, device=cuda)}, *inputs[4:],
                  True, (64, 64))
    assert launched("shade_project") == before


@pytest.mark.parametrize("scale_invariant", [True, False])
def test_shade_project_dc_payload(cuda, scale_invariant):
    # use_sh=False (render_orthographic's): each item's scene's DC
    # coefficients handed to the kernel as a payload, the projection
    # computed in it.
    inputs = shade_inputs(6, circle_cameras(4), 2, 4, 3000, cuda, start=1, items=6, color_k=1, feature=(4, 1),
                          scale_invariant=scale_invariant)
    sg = assert_shade_matches_reference(inputs, (64, 64), use_sh=False)
    assert sg.channels.shape[-1] == 7


@pytest.mark.parametrize("size, n_channels", [(32, 4), (256, 4), (256, 7), (256, 11)])   # + depth: 5, 8, 12
def test_composite_forward_matches_reference(cuda, size, n_channels):
    # Same operations in the same rounding order on the same device.
    tiles = size // 16
    sg = screen_gaussians(size + 1, 20000, size, cuda, n_channels=n_channels)
    counts, base, nx, mask = tile_rects(sg, tiles, tiles, CAP)
    gids, keys, _ = kernels.duplicate_with_keys(counts, mask, base, nx, sg.depth, tiles, CAP)
    gids, ranges, _ = sort_pairs(gids, keys, tiles * tiles)
    attrs = pack_attributes(sg)
    before = launched("composite_forward")
    out = kernels.composite_forward(gids, ranges, attrs, tiles, (size, size))
    ref = kernels.composite_forward_reference(gids, ranges, attrs, tiles, (size, size))
    torch.cuda.synchronize()
    assert launched("composite_forward") == before + 1
    assert (ref[1] < kernels.TRANSMITTANCE_MIN).any(), "scene never saturates"
    torch.testing.assert_close(out[0], ref[0], atol=KERNEL_ATOL, rtol=0)
    torch.testing.assert_close(out[1], ref[1], atol=KERNEL_ATOL, rtol=0)
    assert torch.equal(out[2], ref[2])


def test_composite_forward_four_channels_matches_reference(cuda):
    # render_depth's payload: 3 equal depth channels + the expected depth,
    # values up to ~6 (camera-space z).
    size, tiles = 64, 4
    sg = screen_gaussians(size + 3, 20000, size, cuda, n_channels=3)
    sg.channels = sg.depth[:, None].expand(-1, 3).contiguous()
    counts, base, nx, mask = tile_rects(sg, tiles, tiles, CAP)
    gids, keys, _ = kernels.duplicate_with_keys(counts, mask, base, nx, sg.depth, tiles, CAP)
    gids, ranges, _ = sort_pairs(gids, keys, tiles * tiles)
    attrs = pack_attributes(sg)
    assert attrs.shape[1] == 6 + 4
    before = launched("composite_forward", channels=4)
    out = kernels.composite_forward(gids, ranges, attrs, tiles, (size, size))
    ref = kernels.composite_forward_reference(gids, ranges, attrs, tiles, (size, size))
    torch.cuda.synchronize()
    assert launched("composite_forward", channels=4) == before + 1
    scale = ref[0].abs().amax(dim=(2, 3), keepdim=True)
    assert ((out[0] - ref[0]).abs() / scale).max().item() <= KERNEL_ATOL
    torch.testing.assert_close(out[1], ref[1], atol=KERNEL_ATOL, rtol=0)
    assert torch.equal(out[2], ref[2])


@pytest.mark.parametrize("mode", ["depth", "disparity", "relative_disparity", "log"])
def test_render_depth_tiled_matches_dense(cuda, mode):
    # The depth tolerance of tests/test_rasterize.py, relative to the
    # largest value; the tiled path launches the 4-channel compositor.
    from latentsplat_tpu_torch.ops.rasterize.api import render_depth

    g = torch.Generator().manual_seed(9)
    n = 3000
    z = torch.rand(n, generator=g) * 4 + 2
    means = torch.cat([(torch.rand(n, 2, generator=g) * 1.2 - 0.6) * z[:, None], z[:, None]], dim=1)
    covs = build_covariance(torch.rand(n, 3, generator=g) * 0.1 + 0.02,
                            torch.nn.functional.normalize(torch.randn(n, 4, generator=g), dim=-1))
    opacities = torch.rand(n, generator=g) * 0.65 + 0.3
    ext = torch.eye(4).expand(1, 2, 4, 4).clone()
    ext[0, 1, :3, 3] = torch.tensor([0.2, -0.1, 0.3])
    intr = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]]).expand(1, 2, 3, 3)
    args = [x.to(cuda) for x in (ext, intr, torch.ones(1, 2), torch.full((1, 2), 100.0))]
    gaussians = [x[None].to(cuda) for x in (means, covs, opacities)]
    before = launched("composite_forward", channels=4)
    tiled = render_depth(*args, (64, 64), *gaussians, mode=mode)
    assert launched("composite_forward", channels=4) == before + 1     # both views in one pass
    dense = render_depth(*args, (64, 64), *gaussians, mode=mode, backend="dense")
    assert torch.isfinite(tiled).all()
    assert ((tiled - dense).abs().max() / dense.abs().max()).item() <= 2e-3


def conic_rows(rng, n, sigma=(0.5, 6.0), opacity=(0.3, 0.99), lo=-4.0, hi=36.0):
    """(n, 11) attribute rows (x, y, conic a/b/c, opacity, 5 channels, the
    last a depth of up to 30) of random Gaussians over a 32x32 image."""
    sx, sy = rng.uniform(*sigma, n), rng.uniform(*sigma, n)
    rho = rng.uniform(-0.9, 0.9, n)
    det = (sx * sy) ** 2 * (1 - rho**2)
    rows = np.column_stack([
        rng.uniform(lo, hi, n), rng.uniform(lo, hi, n),
        sy * sy / det, -rho * sx * sy / det, sx * sx / det, rng.uniform(*opacity, n),
        rng.uniform(0, 1, (n, 4)), rng.uniform(1, 30, n),
    ])
    return rows.astype(np.float32)


def forward_case(case):
    """Attribute rows and the tiles left without pairs, for one edge case of
    composite_forward on a 32x32 image (2x2 tiles)."""
    rng = np.random.default_rng(len(case))
    if case == "empty_tiles":
        return conic_rows(rng, 300), {1, 2}
    if case == "never_saturates":
        return conic_rows(rng, 40, opacity=(0.02, 0.08)), set()
    if case == "low_opacity":      # every other pair below 1/255: an empty box
        rows = conic_rows(rng, 200)
        rows[::2, 5] = rng.uniform(0.0, 0.0039, 100)
        return rows, set()
    if case == "non_pd_conic":     # indefinite and negative conics: no cull
        rows = conic_rows(rng, 120, opacity=(0.05, 0.3))
        rows[::3, 2:5] = rng.uniform(-0.05, 0.05, (40, 3))
        rows[::3, 3] = 0.2
        return rows, set()
    if case == "one_block":        # each footprint meets one 4x8 warp block
        rows = conic_rows(rng, 2048, opacity=(0.3, 0.99))
        block = rng.integers(0, 32, 2048)         # 4 x 8 blocks of 4x8 pixels
        rows[:, 0] = (block % 4) * 8 + 3.5 + rng.uniform(-0.4, 0.4, 2048)
        rows[:, 1] = (block // 4) * 4 + 1.5 + rng.uniform(-0.2, 0.2, 2048)
        rows[:, 2:5] = [8.0, 0.0, 8.0]
        return rows, set()
    raise ValueError(case)


@pytest.mark.parametrize("case", ["empty_tiles", "never_saturates", "low_opacity", "non_pd_conic", "one_block"])
def test_composite_forward_edge_cases(cuda, case):
    # Every tile gets every pair, in row order, except the empty ones. The
    # warps' footprint cull must leave the plain version's result: last
    # exactly, channels and T to float rounding of the same operations.
    rows, empty = forward_case(case)
    g = rows.shape[0]
    per_tile = [0 if t in empty else g for t in range(4)]
    ranges = torch.tensor(np.concatenate([[0], np.cumsum(per_tile)]), dtype=torch.int32, device=cuda)
    gids = torch.cat([torch.arange(n, dtype=torch.int32) for n in per_tile]).to(cuda)
    attrs = torch.from_numpy(rows).to(cuda)
    args = (gids, ranges, attrs, 2, (32, 32))
    out = kernels.composite_forward(*args)
    ref = kernels.composite_forward_reference(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(out[0], ref[0], atol=KERNEL_ATOL, rtol=0)
    torch.testing.assert_close(out[1], ref[1], atol=KERNEL_ATOL, rtol=0)
    assert torch.equal(out[2], ref[2])
    t_tiles = kernels.tile(out[1], 2, 2)
    if case == "empty_tiles":
        for t in empty:
            assert (t_tiles[t] == 1.0).all() and (kernels.tile(out[2], 2, 2)[t] == ranges[t]).all()
        assert (t_tiles[0] < kernels.TRANSMITTANCE_MIN).any()
    elif case == "never_saturates":
        assert (out[1] >= kernels.TRANSMITTANCE_MIN).all() and (out[1] < 0.9).any()
    elif case == "low_opacity":
        # The faint pairs never contribute: the same image without them.
        keep = torch.arange(1, g, 2, device=cuda)
        kept_ids = torch.cat([keep.to(torch.int32) for _ in range(4)])
        kept_ranges = torch.arange(0, 4 * keep.numel() + 1, keep.numel(), dtype=torch.int32, device=cuda)
        alone = kernels.composite_forward(kept_ids, kept_ranges, attrs, 2, (32, 32))
        torch.testing.assert_close(alone[0], out[0], atol=0, rtol=0)
    elif case == "non_pd_conic":
        # The non-positive-definite pairs do composite somewhere.
        boxes = kernels.footprint_box_reference(attrs)
        assert torch.isinf(boxes[::3]).all()
        faded = attrs.clone()
        faded[::3, 5] = 0.0
        assert not torch.equal(kernels.composite_forward(gids, ranges, faded, 2, (32, 32))[0], out[0])
    elif case == "one_block":
        box = kernels.footprint_box_reference(attrs)
        bx, by = (attrs[:, 0] // 8) * 8, (attrs[:, 1] // 4) * 4
        assert ((box[:, 0] > bx - 1) & (box[:, 1] < bx + 8) & (box[:, 2] > by - 1) & (box[:, 3] < by + 4)).all()
        assert (out[1] < kernels.TRANSMITTANCE_MIN).any() and (out[1] == 1.0).any()


def test_tiled_forward_matches_dense_oracle(cuda):
    # Tolerances of tests/test_rasterize.py's tiled-vs-dense test.
    sg = screen_gaussians(5, 300, 32, cuda)
    bg = torch.tensor([0.1, 0.2, 0.3, 0.4], device=cuda)
    d_img, d_mask, d_depth = composite_dense(sg, (32, 32), bg, tile_size=16)
    img, mask, depth, _ = composite_tiled(sg, (32, 32), bg)
    torch.testing.assert_close(img, d_img, atol=2e-4, rtol=0)
    torch.testing.assert_close(mask, d_mask, atol=2e-4, rtol=0)
    torch.testing.assert_close(depth, d_depth, atol=2e-3, rtol=0)


def backward_inputs(seed, size, device, n=20000, n_channels=4):
    """Sorted pairs, the forward kernel's outputs and seeded cotangents."""
    tiles = size // 16
    sg = screen_gaussians(seed, n, size, device, n_channels=n_channels)
    counts, base, nx, mask = tile_rects(sg, tiles, tiles, CAP)
    gids, keys, _ = kernels.duplicate_with_keys(counts, mask, base, nx, sg.depth, tiles, CAP)
    gids, ranges, order = sort_pairs(gids, keys, tiles * tiles)
    attrs = pack_attributes(sg)
    out, t_final, last = kernels.composite_forward(gids, ranges, attrs, tiles, (size, size))
    g = torch.Generator(device=device).manual_seed(seed)
    g_out = torch.randn(out.shape, generator=g, device=device)
    g_t = torch.randn(t_final.shape, generator=g, device=device)
    return tiles, counts, gids, ranges, order, attrs, last, t_final, g_out, g_t


@pytest.mark.parametrize("n_channels", [4, 7, 3, 11])   # + depth: the 5-, 8-, 4- and 12-channel instantiations
@pytest.mark.parametrize("size", [32, 64, 256])
def test_composite_backward_matches_reference(cuda, size, n_channels):
    # The kernel sums each pair's partials over the tile in its exchange
    # order, the plain version in torch.sum's order, and takes one
    # reciprocal where the plain version divides twice: agreement to
    # float32 rounding, 1e-4 of each gradient column's largest value.
    tiles, _, gids, ranges, order, attrs, last, t_final, g_out, g_t = backward_inputs(
        size + 2, size, cuda, n_channels=n_channels
    )
    args = (gids, ranges, order, attrs, tiles, (size, size), last, t_final, g_out, g_t)
    before = launched("composite_backward")
    d = kernels.composite_backward(*args)
    ref = kernels.composite_backward_reference(*args)
    torch.cuda.synchronize()
    assert launched("composite_backward") == before + 1
    assert d.shape == (gids.shape[0], 7 + n_channels)
    scale = ref.abs().amax(dim=0).clamp(min=1e-12)
    assert ((d - ref).abs() / scale).max().item() <= BACKWARD_RTOL
    # Rows of pairs that no pixel composited are zero in both.
    assert torch.equal(d[ref.abs().sum(dim=1) == 0], ref[ref.abs().sum(dim=1) == 0])
    # Same kernel, same inputs: the same bits (no atomics).
    assert torch.equal(d, kernels.composite_backward(*args))


def test_composite_backward_zero_rows_and_empty_tiles(cuda):
    # Only the first 4 of 16 tiles keep their pairs, and opaque splats leave
    # pairs past every pixel's `last`: torch.empty's contents must survive
    # in no row.
    size = 64
    tiles, _, gids, ranges, order, attrs, _, _, g_out, g_t = backward_inputs(11, size, cuda, n=3000)
    kept = int(ranges[4])
    ranges = torch.clamp(ranges, max=kept)
    gids = gids[:kept].contiguous()
    order = torch.argsort(torch.argsort(order[:kept]))    # a permutation of the kept pairs
    attrs = attrs.clone()
    attrs[:, 5] = 0.999
    _, t_final, last = kernels.composite_forward(gids, ranges, attrs, tiles, (size, size))
    args = (gids, ranges, order, attrs, tiles, (size, size), last, t_final, g_out, g_t)
    ref = kernels.composite_backward_reference(*args)
    zero = ref.abs().sum(dim=1) == 0
    assert zero.any()
    scale = ref.abs().amax(dim=0).clamp(min=1e-12)
    for _ in range(2):
        d = kernels.composite_backward(*args)
        assert torch.isfinite(d).all() and (d[zero] == 0).all()
        assert ((d - ref).abs() / scale).max().item() <= BACKWARD_RTOL


@pytest.mark.parametrize("row", [11, 14, 10, 18])
def test_reduce_pairs_matches_reference_synthetic(cuda, row):
    # Dead Gaussians and Gaussians at the cap, rows straight from a seed.
    # The kernel adds each segment in slot order, as index_add_ on the CPU
    # does: the same bits.
    rng = np.random.default_rng(row)
    counts = rng.integers(0, CAP + 1, 5000).astype(np.int32)
    counts[:50] = 0
    counts[50:100] = CAP
    counts[-1] = 0
    offsets = torch.cumsum(torch.from_numpy(counts).long(), dim=0)
    d_rows = torch.from_numpy(rng.standard_normal((int(counts.sum()), row)).astype(np.float32))
    out = kernels.reduce_pairs(d_rows.to(cuda), offsets.to(cuda))
    ref = kernels.reduce_pairs_reference(d_rows, offsets)
    assert torch.equal(out.cpu(), ref)
    assert (out[:50] == 0).all() and (out[-1] == 0).all()


def test_reduce_pairs_matches_reference(cuda):
    # On the rows composite_backward writes at flagship-like density.
    tiles, counts, gids, ranges, order, attrs, last, t_final, g_out, g_t = backward_inputs(7, 256, cuda)
    d = kernels.composite_backward(gids, ranges, order, attrs, tiles, (256, 256), last, t_final, g_out, g_t)
    offsets = torch.cumsum(counts, dim=0, dtype=torch.int64)
    before = launched("reduce_pairs")
    out = kernels.reduce_pairs(d, offsets)
    ref = kernels.reduce_pairs_reference(d.cpu(), offsets.cpu())
    torch.cuda.synchronize()
    assert launched("reduce_pairs") == before + 1
    assert (counts == 0).any() and (counts == CAP).any() and torch.equal(out.cpu(), ref)
    assert torch.equal(out, kernels.reduce_pairs(d, offsets))


def test_tiled_gradients_match_dense_oracle(cuda):
    # Tolerance of tests/test_rasterize.py's gradient test: normalised by
    # each leaf's largest gradient, atol 5e-3.
    g = torch.Generator().manual_seed(3)
    n = 40
    z = torch.rand(n, generator=g) * 4 + 2
    xy = (torch.rand(n, 2, generator=g) * 1.2 - 0.6) * z[:, None]
    leaves = [
        torch.cat([xy, z[:, None]], dim=1),
        build_covariance(torch.rand(n, 3, generator=g) * 0.2 + 0.05,
                         torch.nn.functional.normalize(torch.randn(n, 4, generator=g), dim=-1)),
        torch.rand(n, generator=g) * 0.65 + 0.3,
        torch.rand(n, 4, generator=g),
    ]
    leaves = [x.to(cuda).requires_grad_() for x in leaves]
    target = torch.rand(4, 32, 32, generator=g).to(cuda)
    bg = torch.tensor([0.5, 0.1, 0.0, 0.2], device=cuda)
    intrinsics = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]], device=cuda)

    def grads(backend):
        sg = project_gaussians_to_screen(*leaves, torch.eye(4, device=cuda), intrinsics, (32, 32))
        if backend == "dense":
            img, mask, depth = composite_dense(sg, (32, 32), bg, tile_size=16)
        else:
            img, mask, depth, _ = composite_tiled(sg, (32, 32), bg)
        loss = ((img - target) ** 2).mean() + mask.mean() + 1e-3 * depth.mean()
        return torch.autograd.grad(loss, leaves)

    # Every rasterizer kernel of composite_tiled runs.
    before = {k: launched(k) for k in ("tile_cull", "duplicate_with_keys", "composite_forward", "composite_backward",
                                       "reduce_pairs")}
    tiled = grads("tiled")
    assert all(launched(k) > n for k, n in before.items())
    for gt, gd in zip(tiled, grads("dense")):
        scale = gd.abs().max() + 1e-8
        torch.testing.assert_close(gt / scale, gd / scale, atol=5e-3, rtol=0)


def test_wrappers_check_inputs(cuda):
    sg = screen_gaussians(6, 100, 32, cuda)
    counts, base, nx, mask = tile_rects(sg, 2, 2, CAP)
    with pytest.raises(ValueError):
        kernels.duplicate_with_keys(counts.long(), mask, base, nx, sg.depth, 2, CAP)
    with pytest.raises(ValueError):
        kernels.duplicate_with_keys(counts, mask.cpu(), base, nx, sg.depth, 2, CAP)
    gids, keys, _ = kernels.duplicate_with_keys(counts, mask, base, nx, sg.depth, 2, CAP)
    gids, ranges, _ = sort_pairs(gids, keys, 4)
    attrs = pack_attributes(sg)
    with pytest.raises(ValueError):   # 3 channels: no instantiation
        kernels.composite_forward(gids, ranges, attrs[:, :9].contiguous(), 2, (32, 32))
    with pytest.raises(ValueError):
        kernels.composite_forward(gids, ranges, attrs.t(), 2, (32, 32))
    out, t_final, last = kernels.composite_forward(gids, ranges, attrs, 2, (32, 32))
    assert np.isfinite(out.cpu().numpy()).all()
    order = torch.arange(gids.shape[0], device=cuda)
    with pytest.raises(ValueError):   # cotangent of the wrong shape
        kernels.composite_backward(gids, ranges, order, attrs, 2, (32, 32), last, t_final, out[:, :1], t_final)
    with pytest.raises(ValueError):   # a CPU tensor among CUDA ones
        kernels.composite_backward(gids, ranges, order, attrs, 2, (32, 32), last, t_final.cpu(), out, t_final)
    with pytest.raises(ValueError):   # order of the wrong length
        kernels.composite_backward(gids, ranges, order[1:], attrs, 2, (32, 32), last, t_final, out, t_final)
    with pytest.raises(ValueError):   # order on the CPU
        kernels.composite_backward(gids, ranges, order.cpu(), attrs, 2, (32, 32), last, t_final, out, t_final)
    with pytest.raises(ValueError):   # int32 order
        kernels.composite_backward(gids, ranges, gids, attrs, 2, (32, 32), last, t_final, out, t_final)
    offsets = torch.cumsum(counts, dim=0, dtype=torch.int64)
    d = torch.zeros((gids.shape[0], attrs.shape[1]), device=cuda)
    with pytest.raises(ValueError):   # int32 offsets
        kernels.reduce_pairs(d, offsets.int())
    with pytest.raises(ValueError):   # offsets on the CPU
        kernels.reduce_pairs(d, offsets.cpu())
    with pytest.raises(ValueError):   # a row length with no instantiation
        kernels.reduce_pairs(d[:, :9].contiguous(), offsets)


# -- the fast family (model.decoder.precision "fast", "fast_nocoef" and the
# diagnostic precisions with a per-pair knob) --------------------------------

FORWARD_VARIANTS = {"coef": {"coef": True}, "fast": {"f16_xy": True, "bf16_mm": True},
                    "f16_xy": {"f16_xy": True}, "bf16_mm": {"bf16_mm": True}}
BACKWARD_VARIANTS = {"fast": {"f16_xy": True, "bf16_mm": True, "bf16_grads": True}, "f16_xy": {"f16_xy": True},
                     "bf16_mm": {"bf16_mm": True}, "bf16_grads": {"bf16_grads": True}}


def fast_inputs(seed, size, device, n_channels):
    """Pairs and attribute rows as composite_tiled prepares them at "fast";
    some tile spans 6 scan blocks or more, so that the backward's split
    walk (bf16_mm) runs several blocks a tile."""
    tiles = size // 16
    sg = screen_gaussians(seed, 20000, size, device, n_channels=n_channels)
    gids, ranges, order, _, _ = tile_pairs(sg, (size, size), CAP, "fast")
    attrs = quantize_attributes(pack_attributes(sg), precision_knobs("fast"), depth_code_bits(tiles * tiles)[1])
    starts, stops = ranges[:-1].long(), ranges[1:].long()
    assert int(((stops - 1) // kernels.SCAN_BLOCK - starts // kernels.SCAN_BLOCK + 1).max()) >= 6
    return tiles, gids, ranges, order, attrs


@pytest.mark.parametrize("n_channels", [4, 7, 11])   # + depth: the 5-, 8- and 12-channel instantiations
@pytest.mark.parametrize("variant", list(FORWARD_VARIANTS))
def test_composite_forward_fast_variants_match_reference(cuda, variant, n_channels):
    # Explicitly rounded in the plain version's order: `last` and the block
    # state exactly, T and channels to 1e-5 (of each channel's largest value).
    size = 64
    tiles, gids, ranges, _, attrs = fast_inputs(size + 5, size, cuda, n_channels)
    knobs = FORWARD_VARIANTS[variant]
    blocks = ref_blocks = None
    if knobs.get("bf16_mm"):
        blocks = kernels.block_state(ranges, gids.shape[0], tiles * tiles)
        blocks[1].zero_()
        ref_blocks = (blocks[0], torch.zeros_like(blocks[1]))
    before = launched("composite_forward", variant, n_channels + 1)
    out = kernels.composite_forward(gids, ranges, attrs, tiles, (size, size), **knobs, blocks=blocks)
    ref = kernels.composite_forward_reference(gids, ranges, attrs, tiles, (size, size), **knobs, blocks=ref_blocks)
    torch.cuda.synchronize()
    assert launched("composite_forward", variant, n_channels + 1) == before + 1
    assert (ref[1] < kernels.TRANSMITTANCE_MIN).any(), "scene never saturates"
    scale = ref[0].abs().amax(dim=(2, 3), keepdim=True)
    assert ((out[0] - ref[0]).abs() / scale).max().item() <= KERNEL_ATOL
    torch.testing.assert_close(out[1], ref[1], atol=KERNEL_ATOL, rtol=0)
    assert torch.equal(out[2], ref[2])
    if blocks is not None:
        assert (blocks[1][..., 1] != 0).any() and torch.equal(blocks[1], ref_blocks[1])


@pytest.mark.parametrize("n_channels", [4, 7, 11])
@pytest.mark.parametrize("variant", list(BACKWARD_VARIANTS))
def test_composite_backward_fast_variants_match_reference(cuda, variant, n_channels):
    # 1e-4 of each column's largest value as the exact kernel; a row rounded
    # to bfloat16 may round the other way where the two float32 sums
    # differ, so with bf16_grads also one bfloat16 step (at most 2^-7 of
    # the value).
    size = 64
    tiles, gids, ranges, order, attrs = fast_inputs(size + 6, size, cuda, n_channels)
    knobs = BACKWARD_VARIANTS[variant]
    mm = knobs.get("bf16_mm", False)
    blocks = kernels.block_state(ranges, gids.shape[0], tiles * tiles) if mm else None
    out, t_final, last = kernels.composite_forward(gids, ranges, attrs, tiles, (size, size),
                                                   f16_xy=knobs.get("f16_xy", False), bf16_mm=mm, blocks=blocks)
    g = torch.Generator(device=cuda).manual_seed(size)
    g_out = torch.randn(out.shape, generator=g, device=cuda)
    g_t = torch.randn(t_final.shape, generator=g, device=cuda)
    args = (gids, ranges, order, attrs, tiles, (size, size), last, t_final, g_out, g_t)
    before = launched("composite_backward", variant, n_channels + 1)
    d = kernels.composite_backward(*args, **knobs, blocks=blocks)
    ref = kernels.composite_backward_reference(*args, **knobs, blocks=blocks)
    torch.cuda.synchronize()
    assert launched("composite_backward", variant, n_channels + 1) == before + 1
    bound = BACKWARD_RTOL * ref.abs().amax(dim=0).clamp(min=1e-12)
    if knobs.get("bf16_grads"):
        bound = bound + BF16_STEP * ref.abs()
    assert ((d - ref).abs() <= bound).all()
    assert torch.equal(d, kernels.composite_backward(*args, **knobs, blocks=blocks))


def test_split_walk_takes_bf16_mm_only(cuda):
    # The backward's C entry point needs the block state and the split
    # walk's suffix scratch under bf16_mm, and refuses a call without them;
    # without bf16_mm it walks each tile serially and needs neither. The
    # wrapper counts one launch per call either way.
    size = 64
    tiles, gids, ranges, order, attrs = fast_inputs(size + 7, size, cuda, 7)
    blocks = kernels.block_state(ranges, gids.shape[0], tiles * tiles)
    out, t_final, last = kernels.composite_forward(gids, ranges, attrs, tiles, (size, size), f16_xy=True,
                                                   bf16_mm=True, blocks=blocks)
    g = torch.Generator(device=cuda).manual_seed(3)
    g_out = torch.randn(out.shape, generator=g, device=cuda)
    g_t = torch.randn(t_final.shape, generator=g, device=cuda)
    args = (gids, ranges, order, attrs, tiles, (size, size), last, t_final, g_out, g_t)
    lib = kernels.load_library()
    d_rows = torch.empty((gids.shape[0], attrs.shape[1]), device=cuda)
    pointers = (1, tiles * tiles, gids.data_ptr(), ranges.data_ptr(), order.data_ptr(), attrs.data_ptr(), tiles, size,
                size, last.data_ptr(), t_final.data_ptr(), g_out.data_ptr(), g_t.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    serial = kernels._knob_bits(True, False, True)
    assert lib.composite_backward_fast(8, serial, *pointers, None, None, 0, None, d_rows.data_ptr(), stream) == 0
    torch.cuda.synchronize()
    assert torch.equal(d_rows, kernels.composite_backward(*args, f16_xy=True, bf16_grads=True))
    split = kernels._knob_bits(True, True, True)
    assert lib.composite_backward_fast(8, split, *pointers, blocks[0].data_ptr(), blocks[1].data_ptr(), 0, None,
                                       d_rows.data_ptr(), stream) != 0
    before = launched("composite_backward", "fast", 8)
    kernels.composite_backward(*args, f16_xy=True, bf16_mm=True, bf16_grads=True, blocks=blocks)
    assert launched("composite_backward", "fast", 8) == before + 1


def test_fast_render_runs_the_fast_variants(cuda):
    # Serving at "fast" takes the coefficient layout; a differentiated
    # render the fast forward and backward; nothing falls back to the exact
    # kernels, and a channel count without a fast instantiation raises.
    size = 64
    sg = screen_gaussians(11, 5000, size, cuda, n_channels=7)
    bg = torch.rand(7, generator=torch.Generator().manual_seed(0)).to(cuda)
    exact_before = (launched("composite_forward", "exact", 8), launched("composite_backward", "exact", 8))
    before = launched("composite_forward", "coef", 8)
    with torch.no_grad():
        served = composite_tiled(sg, (size, size), bg, precision="fast")
    assert launched("composite_forward", "coef", 8) == before + 1
    cpu = type(sg)(**{k: v.cpu() for k, v in vars(sg).items()})
    with torch.no_grad():
        plain = composite_tiled(cpu, (size, size), bg.cpu(), precision="fast")
    for a, b in zip(served[:3], plain[:3]):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=0)
    opacity = sg.opacity.clone().requires_grad_(True)
    trained = type(sg)(**{**vars(sg), "opacity": opacity})
    before = (launched("composite_forward", "fast", 8), launched("composite_backward", "fast", 8))
    img, mask, _, _ = composite_tiled(trained, (size, size), bg, precision="fast")
    (img.square().sum() + mask.sum()).backward()
    assert (launched("composite_forward", "fast", 8), launched("composite_backward", "fast", 8)) == (
        before[0] + 1, before[1] + 1)
    assert torch.isfinite(opacity.grad).all()
    assert (launched("composite_forward", "exact", 8), launched("composite_backward", "exact", 8)) == exact_before
    four = screen_gaussians(12, 500, size, cuda, n_channels=3)
    with pytest.raises(ValueError, match="built for"), torch.no_grad():
        composite_tiled(four, (size, size), torch.zeros(3, device=cuda), precision="fast")


# -- passes: the (scene, view) items of a render call in one launch ----------------


PASS_GAUSSIANS = 20000


def synthetic_pass(seed, size, device, n_channels, n_items):
    """Screen Gaussians of a pass of `n_items` views of PASS_GAUSSIANS random
    Gaussians from cameras that differ (items first)."""
    g = torch.Generator().manual_seed(seed)
    n = PASS_GAUSSIANS
    z = torch.rand(n, generator=g) * 4 + 2
    means = torch.cat([(torch.rand(n, 2, generator=g) * 1.2 - 0.6) * z[:, None], z[:, None]], dim=1)
    covs = build_covariance(torch.rand(n, 3, generator=g) * 0.2 + 0.05,
                            torch.nn.functional.normalize(torch.randn(n, 4, generator=g), dim=-1))
    ext = torch.eye(4).repeat(n_items, 1, 1)
    ext[:, 0, 3] = torch.linspace(-0.6, 0.6, n_items)
    ext[:, 2, 3] = torch.linspace(0.0, 1.0, n_items)
    intr = torch.tensor([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]]).expand(n_items, 3, 3)
    sg = project_gaussians_to_screen(means.expand(n_items, n, 3), covs.expand(n_items, n, 3, 3),
                                     (torch.rand(n, generator=g) * 0.65 + 0.3).expand(n_items, n),
                                     torch.rand(n_items, n, n_channels, generator=g), ext, intr, (size, size))
    return type(sg)(**{k: v.to(device) for k, v in vars(sg).items()})


def bench_pass(seed, size, device, n_channels, n_items):
    """Screen Gaussians of the main path's pass: `n_items` views of
    bench_render's scene (393,216 Gaussians, as the flagship encoder emits)
    shaded as `render` shades them, with the shade's 3 color and 4 feature
    channels (n_channels 7), their first 3 replaced by each Gaussian's
    camera-space depth (3: render_depth's payload), or 4 more random ones
    (11: variational latents' mean and log-variance features)."""
    from latentsplat_tpu_torch.ops.rasterize.shade import shade
    from latentsplat_tpu_torch.scripts.bench_render import make_scene, shade_inputs as bench_shade_inputs

    with torch.no_grad():
        sg = shade(*bench_shade_inputs(make_scene(seed, n_views=n_items, device=device)), True, (size, size))
    if n_channels == 3:
        sg.channels = sg.depth[..., None].expand(*sg.depth.shape, 3).contiguous()
    elif n_channels == 11:
        extra = torch.rand((*sg.depth.shape, 4), generator=torch.Generator(device=device).manual_seed(seed),
                           device=device)
        sg.channels = torch.cat([sg.channels, extra], dim=-1)
    assert sg.channels.shape[-1] == n_channels
    return sg


def pass_inputs(seed, size, device, n_channels, precision="exact", n_items=4, scene="synthetic"):
    """A pass of `n_items` views (each its own pair count) of a `scene`
    ("synthetic": `synthetic_pass`, "bench": `bench_pass`), prepared as
    composite_tiled prepares them at `precision`: the screen Gaussians
    (items first), the sorted pairs, the quantized attribute rows."""
    sg = (bench_pass if scene == "bench" else synthetic_pass)(seed, size, device, n_channels, n_items)
    tiles = size // 16
    gids, ranges, order, counts, pairs = tile_pairs(sg, (size, size), CAP, precision)
    attrs = quantize_attributes(pack_attributes(sg), precision_knobs(precision), depth_code_bits(tiles * tiles)[1],
                                n_items)
    assert len(set(pairs.tolist())) == n_items, pairs
    return sg, tiles, gids, ranges, order, counts, attrs


def assert_pass_pairs_match_reference(sg, tiles, gids, ranges):
    """duplicate_with_keys on a pass against its plain version (the same
    ids and keys, each item's total its tile cull count), then the sort of
    the plain version's pairs: the kernel path's sorted `gids` and tile
    `ranges` (tile_pairs at exact)."""
    n_items = sg.radius.shape[0]
    counts, base, nx, mask = tile_rects(sg, tiles, tiles, CAP)
    depth = sg.depth.reshape(-1).contiguous()
    before = launched("duplicate_with_keys")
    got_gids, got_keys, pairs = kernels.duplicate_with_keys(counts, mask, base, nx, depth, tiles, CAP, n_items)
    ref_gids, ref_keys = kernels.duplicate_with_keys_reference(counts, mask, base, nx, depth, tiles, CAP)
    torch.cuda.synchronize()
    assert launched("duplicate_with_keys") == before + 1
    assert torch.equal(got_gids, ref_gids) and torch.equal(got_keys, ref_keys)
    assert pairs.tolist() == counts.reshape(n_items, -1).sum(dim=1).tolist()
    ref_sorted, ref_ranges, _ = sort_pairs(ref_gids, ref_keys, n_items * tiles * tiles)
    assert torch.equal(ref_sorted, gids) and torch.equal(ref_ranges, ranges)


# The main path's pass (bench_pass: 4 target views at 256x256) at the
# flagship's 8 channels, render_depth's 4 (exact only) and variational
# latents' 12: (variant, channels without the depth).
MAIN_PASS_CASES = [("exact", 7), ("coef", 7), ("fast", 7), ("exact", 3), ("exact", 11), ("coef", 11), ("fast", 11)]


@pytest.mark.parametrize("variant, scene, size, n_channels",
                         [pytest.param(v, "synthetic", 64, 7, id=v) for v in ("exact", "coef", "fast")]
                         + [pytest.param(v, "bench", 256, c, id=f"bench-{c + 1}-{v}") for v, c in MAIN_PASS_CASES])
def test_pass_of_views_matches_reference(cuda, variant, scene, size, n_channels):
    # A pass of 4 views: every kernel and variant against its plain version
    # on the pass, under the bounds of the one-view tests above; at exact
    # also duplicate_with_keys and the sort.
    precision = "exact" if variant == "exact" else "fast"
    sg, tiles, gids, ranges, order, counts, attrs = pass_inputs(size + 8, size, cuda, n_channels, precision,
                                                                scene=scene)
    if variant == "exact":
        assert_pass_pairs_match_reference(sg, tiles, gids, ranges)
    knobs = {"exact": {}, "coef": {"coef": True}, "fast": {"f16_xy": True, "bf16_mm": True}}[variant]
    blocks = ref_blocks = None
    if variant == "fast":
        blocks = kernels.block_state(ranges, gids.shape[0], tiles * tiles)
        blocks[1].zero_()
        ref_blocks = (blocks[0], torch.zeros_like(blocks[1]))
    args = (gids, ranges, attrs, tiles, (size, size))
    before = launched("composite_forward", variant, n_channels + 1)
    out = kernels.composite_forward(*args, **knobs, blocks=blocks)
    ref = kernels.composite_forward_reference(*args, **knobs, blocks=ref_blocks)
    torch.cuda.synchronize()
    assert launched("composite_forward", variant, n_channels + 1) == before + 1
    assert out[0].shape == (4, n_channels + 1, size, size) and out[2].shape == (4, size, size)
    scale = ref[0].abs().amax(dim=(2, 3), keepdim=True)
    assert ((out[0] - ref[0]).abs() / scale).max().item() <= KERNEL_ATOL
    torch.testing.assert_close(out[1], ref[1], atol=KERNEL_ATOL, rtol=0)
    assert torch.equal(out[2], ref[2])
    if blocks is not None:
        assert (blocks[1][..., 1] != 0).any() and torch.equal(blocks[1], ref_blocks[1])
    if variant == "coef":
        return
    g = torch.Generator(device=cuda).manual_seed(size)
    g_out = torch.randn(out[0].shape, generator=g, device=cuda)
    g_t = torch.randn(out[1].shape, generator=g, device=cuda)
    bwd = {"exact": {}, "fast": {"f16_xy": True, "bf16_mm": True, "bf16_grads": True}}[variant]
    bargs = (gids, ranges, order, attrs, tiles, (size, size), out[2], out[1], g_out, g_t)
    before = launched("composite_backward", variant, n_channels + 1)
    d = kernels.composite_backward(*bargs, **bwd, blocks=blocks)
    d_ref = kernels.composite_backward_reference(*bargs, **bwd, blocks=blocks)
    torch.cuda.synchronize()
    assert launched("composite_backward", variant, n_channels + 1) == before + 1
    bound = BACKWARD_RTOL * d_ref.abs().amax(dim=0).clamp(min=1e-12)
    if variant == "fast":
        bound = bound + BF16_STEP * d_ref.abs()
    assert ((d - d_ref).abs() <= bound).all()
    assert torch.equal(d, kernels.composite_backward(*bargs, **bwd, blocks=blocks))
    offsets = torch.cumsum(counts, dim=0, dtype=torch.int64)
    assert torch.equal(kernels.reduce_pairs(d, offsets).cpu(), kernels.reduce_pairs_reference(d.cpu(), offsets.cpu()))


@pytest.mark.parametrize("variant", ["exact", "coef", "fast"])
def test_pass_of_views_equals_one_view_launches(cuda, variant):
    # Each item of a pass gets the bits of a launch over that item alone:
    # the forward's outputs (`last` less the item's first pair), the block
    # state's entries and the backward's rows.
    size = 64
    precision = "exact" if variant == "exact" else "fast"
    sg, tiles, gids, ranges, order, counts, attrs = pass_inputs(size + 9, size, cuda, 7, precision)
    knobs = {"exact": {}, "coef": {"coef": True}, "fast": {"f16_xy": True, "bf16_mm": True}}[variant]
    mm = variant == "fast"
    blocks = kernels.block_state(ranges, gids.shape[0], tiles * tiles) if mm else None
    out = kernels.composite_forward(gids, ranges, attrs, tiles, (size, size), **knobs, blocks=blocks)
    g = torch.Generator(device=cuda).manual_seed(1)
    g_out = torch.randn(out[0].shape, generator=g, device=cuda)
    g_t = torch.randn(out[1].shape, generator=g, device=cuda)
    bwd = {"exact": {}, "coef": None, "fast": {"f16_xy": True, "bf16_mm": True, "bf16_grads": True}}[variant]
    if bwd is not None:
        rows = kernels.composite_backward(gids, ranges, order, attrs, tiles, (size, size), out[2], out[1], g_out, g_t,
                                          **bwd, blocks=blocks)
        sorted_rows = rows[order]
    per_item = attrs.shape[0] // 4
    for n in range(4):
        item = type(sg)(**{k: v[n] for k, v in vars(sg).items()})
        i_gids, i_ranges, i_order, _, _ = tile_pairs(item, (size, size), CAP, precision)
        lo, hi = int(ranges[n * tiles * tiles]), int(ranges[(n + 1) * tiles * tiles])
        assert torch.equal(i_gids, gids[lo:hi] - n * per_item)
        assert torch.equal(i_ranges, ranges[n * tiles * tiles : (n + 1) * tiles * tiles + 1] - lo)
        i_attrs = attrs[n * per_item : (n + 1) * per_item]
        i_blocks = kernels.block_state(i_ranges, i_gids.shape[0], tiles * tiles) if mm else None
        i_out = kernels.composite_forward(i_gids, i_ranges, i_attrs, tiles, (size, size), **knobs, blocks=i_blocks)
        assert torch.equal(i_out[0][0], out[0][n]) and torch.equal(i_out[1][0], out[1][n])
        assert torch.equal(i_out[2][0], out[2][n] - lo)
        if bwd is not None:
            i_rows = kernels.composite_backward(i_gids, i_ranges, i_order, i_attrs, tiles, (size, size), i_out[2],
                                                i_out[1], g_out[n : n + 1].contiguous(), g_t[n : n + 1].contiguous(),
                                                **bwd, blocks=i_blocks)
            assert torch.equal(i_rows[i_order], sorted_rows[lo:hi])


CAMERA_KEYS = ("extrinsics", "intrinsics", "near", "far")
RENDER_OUTPUTS = ("color", "feature", "mask", "depth")


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("grad", [False, True], ids=["serve", "train"])
def test_render_pass_equals_one_item_a_pass(cuda, monkeypatch, grad, precision):
    # bench_render's scene at 256x256 rendered in one pass against one item
    # a pass (api.PASS_ROWS patched to 1). Without gradient its 64 views:
    # one launch of each forward kernel against 64, the same bits. With
    # gradient a train render of 2 scenes x 4 views (the second scene's
    # opacities scaled by 0.9; the plain shade, no shade_project): the
    # forward the same bits, each input's gradient within BACKWARD_RTOL of
    # its largest value (at fast also one bfloat16 step of the value), the
    # one-item passes summing a scene's gradient over its views in another
    # order.
    from latentsplat_tpu_torch.ops.rasterize import api
    from latentsplat_tpu_torch.scripts.bench_render import make_scene

    scene = make_scene(0, n_views=8 if grad else 64, device=cuda)
    if grad:
        scene = {k: torch.cat([v[:, :4], v[:, 4:]]) if k in CAMERA_KEYS
                 else torch.cat([v, v * 0.9 if k == "gaussian_opacities" else v]) for k, v in scene.items()}
    items = scene["near"].numel()
    kernel_names = ("shade_project", "tile_cull", "duplicate_with_keys", "composite_forward")
    runs = []
    for rows in (api.PASS_ROWS, 1):
        monkeypatch.setattr(api, "PASS_ROWS", rows)
        inputs = {k: v.clone().requires_grad_(grad and k not in ("near", "far")) for k, v in scene.items()}
        before = {k: launched(k) for k in kernel_names}
        with torch.set_grad_enabled(grad):
            out = api.render(*(inputs[k] for k in CAMERA_KEYS), (256, 256), *(inputs[k] for k in (
                "background_color", "gaussian_means", "gaussian_covariances", "gaussian_opacities",
                "gaussian_color_sh", "gaussian_feature_sh")), precision=precision)
        torch.cuda.synchronize()
        launches = {k: launched(k) - n for k, n in before.items()}
        grads = {}
        if grad:
            g = torch.Generator(device=cuda).manual_seed(5)
            loss = sum((getattr(out, k) * torch.randn(getattr(out, k).shape, generator=g, device=cuda)).sum()
                       for k in RENDER_OUTPUTS)
            leaves = [k for k, v in inputs.items() if v.requires_grad]
            grads = dict(zip(leaves, torch.autograd.grad(loss, [inputs[k] for k in leaves])))
        runs.append(({k: getattr(out, k).detach() for k in (*RENDER_OUTPUTS, "num_pairs")}, launches, grads))
    (one, one_launches, g_one), (per, per_launches, g_per) = runs
    for k in one:
        assert torch.equal(one[k], per[k]), k
    shaded = 0 if grad else 1
    assert one_launches == {k: 1 if k != "shade_project" else shaded for k in kernel_names}
    assert per_launches == {k: items if k != "shade_project" else shaded * items for k in kernel_names}
    for k, want in g_per.items():
        bound = BACKWARD_RTOL * want.abs().max().clamp(min=1e-30)
        if precision == "fast":
            bound = bound + BF16_STEP * want.abs()
        assert ((g_one[k] - want).abs() <= bound).all(), k


# -- group_norm_silu (ops/group_norm.py) --------------------------------------------

# Tolerances against float64: the kernel and PyTorch's float32 group norm
# both round x - mean and the product with rstd gamma once each (~1e-7 of
# values of a few units) and SiLU's exp (~2 ulp), so the forward is held
# to 1e-5 absolute; dx to 1e-5 of its largest value (per-element work as
# the forward, plus the group sums' rounding, ~1e-7 relative over up to
# 2.6e5 terms); dgamma and dbeta, sums of up to 1.3e5 products over the
# batch and rows in float32 partial sums, to 1e-4 of their largest value.
GN_FORWARD_ATOL = 1e-5
GN_DX_RTOL = 1e-5
GN_PARAM_RTOL = 1e-4
# In bfloat16 the kernel computes as in float32 from the bfloat16 inputs
# (exact in float64) and rounds each output once: at most 2^-8 of the
# value more (8 significant bits, round to nearest). A value just above a
# power of two rounds by nearly that much, so a large bfloat16 case reads
# close to 1 of its limit by construction (0.995 at the video decode's
# top-level norm); the float32 part stays inside the float32 limits.
BF16_ROUNDING = 2.0 ** -8
# The VAE decoder's norms: (channels, side) for each distinct shape.
DECODER_NORMS = [(512, 32), (512, 64), (512, 128), (256, 128), (256, 256), (128, 256)]


def group_norm_case(channels, side, device, seed, layout=torch.channels_last, offset=False, n=2,
                    constant_groups=True, dtype=torch.float32):
    """Inputs of a norm of `channels` (gcd(32, C) groups) in `dtype`: x with
    a mean off zero, two constant groups (zero variance) in sample 0 and one
    whole constant sample, gamma and beta off 1 and 0, and a cotangent."""
    import math

    groups = math.gcd(32, channels)
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, channels, side, side), generator=g) * 1.7 + 0.6
    d = channels // groups
    if constant_groups:
        x[0, :d] = 2.5
        x[0, -d:] = -0.25
        x[-1] = 1.0 if n > 1 else x[-1]
    weight = torch.rand(channels, generator=g) + 0.5
    bias = torch.rand(channels, generator=g) - 0.5
    dy = torch.randn(x.shape, generator=g)
    x = x.to(device, dtype)
    if offset:   # channels-last memory one value past a 16-byte boundary: the kernel's scalar path
        buf = torch.empty(x.numel() + 1, device=device, dtype=dtype)
        view = buf[1:].view(n, side, side, channels).permute(0, 3, 1, 2)
        view.copy_(x)
        x = view
    else:
        x = x.contiguous(memory_format=layout)
    return x, weight.to(device, dtype), bias.to(device, dtype), dy.to(device, dtype), groups


def group_norm_check(x, weight, bias, dy, groups, silu):
    """The kernel's forward and backward (in x's dtype) against nn.GroupNorm
    + F.silu in float64 (one launch each); returns each of (y, dx, dgamma,
    dbeta)'s largest |difference| over its limit (GN_FORWARD_ATOL, or the
    RTOL of its largest value, plus BF16_ROUNDING of each value in
    bfloat16; at most 1 passes), and PyTorch's own float32 path's beside
    them."""
    from latentsplat_tpu_torch.ops.group_norm import group_norm_silu, group_norm_silu_reference

    norm = torch.nn.GroupNorm(groups, x.shape[1], eps=1e-6).to(x.device, x.dtype)
    with torch.no_grad():
        norm.weight.copy_(weight)
        norm.bias.copy_(bias)
    leaves = [x.detach().clone().requires_grad_(), norm.weight, norm.bias]
    before = {k: launched(k) for k in ("group_norm_silu", "group_norm_silu_backward")}
    y = group_norm_silu(leaves[0], norm, silu)
    grads = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert {k: launched(k) - n for k, n in before.items()} == {"group_norm_silu": 1, "group_norm_silu_backward": 1}
    assert y.is_contiguous(memory_format=torch.channels_last) and grads[0].shape == x.shape
    assert y.dtype == x.dtype and all(g.dtype == x.dtype for g in grads)

    def plain(dtype):
        ls = [t.detach().to(dtype).requires_grad_() for t in (x, weight, bias)]
        out = group_norm_silu_reference(*ls, groups, 1e-6, silu)
        return (out.detach(), *torch.autograd.grad(out, ls, dy.to(dtype)))

    want, plain32 = plain(torch.float64), plain(torch.float32)
    rounding = BF16_ROUNDING if x.dtype == torch.bfloat16 else 0.0
    atols = [GN_FORWARD_ATOL] + [rtol * float(w.abs().max()) + 1e-30
                                 for rtol, w in zip((GN_DX_RTOL, GN_PARAM_RTOL, GN_PARAM_RTOL), want[1:])]
    return {side: [float(((a.detach().double() - w).abs() / (rounding * w.abs() + atol)).max())
                   for a, w, atol in zip(got, want, atols)]
            for side, got in (("kernel", (y, *grads)), ("plain32", plain32))}


def assert_group_norm_close(errors):
    assert max(errors["kernel"]) <= 1.0, errors


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("channels,side,n", [(c, s, 2) for c, s in DECODER_NORMS] + [(128, 256, 30)])
def test_group_norm_silu_decoder_shapes(cuda, channels, side, n, silu):
    # Each of the decoder's norms on 2 samples, and its top-level norm at
    # the video cell's 30 views.
    assert_group_norm_close(group_norm_check(*group_norm_case(channels, side, cuda, channels + side, n=n), silu))


@pytest.mark.parametrize("layout", ["contiguous", "channels_last", "offset"])
@pytest.mark.parametrize("silu", [True, False])
def test_group_norm_silu_layouts(cuda, layout, silu):
    # An NCHW input is copied to channels-last first; one 4 bytes off a
    # 16-byte boundary takes the kernel's scalar path.
    memory = {"contiguous": torch.contiguous_format, "channels_last": torch.channels_last}.get(layout)
    case = group_norm_case(128, 48, cuda, 3, layout=memory or torch.channels_last, offset=layout == "offset")
    assert_group_norm_close(group_norm_check(*case, silu))


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("channels", [6, 8, 16, 48, 1536])
def test_group_norm_silu_narrow_and_wide(cuda, channels, silu):
    # gcd(32, C) groups: 6 -> 2 groups of 3 (scalar path), 8 -> 8 of 1, 16
    # -> 16 of 1, 48 -> 16 of 3 (groups straddle float4s); 1536 -> 32 of 48
    # (384 float4 a row: one row a block of 384 threads).
    assert_group_norm_close(group_norm_check(*group_norm_case(channels, 20, cuda, channels, n=3), silu))


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("channels,side,offset,n", [(128, 256, False, 3), (512, 32, False, 3), (48, 20, False, 3),
                                                    (6, 20, False, 3), (128, 48, True, 3), (128, 256, False, 30)])
def test_group_norm_silu_bfloat16(cuda, channels, side, offset, n, silu):
    # The vae:bfloat16 compute dtype launches the kernel too: 8-byte loads
    # of four bfloat16 (the top-level decoder norm, also at the video
    # cell's 30 views, a 512-channel one, 16 groups of 3), and the scalar
    # path (6 channels; 2 bytes off an 8-byte boundary), within the float32
    # limits plus one bfloat16 rounding.
    case = group_norm_case(channels, side, cuda, channels + side, offset=offset, n=n, dtype=torch.bfloat16)
    assert_group_norm_close(group_norm_check(*case, silu))


def test_group_norm_silu_refuses_what_the_kernel_does_not_take(cuda):
    # On the card nothing falls back to nn.GroupNorm: another dtype, a 3-D
    # input or a norm without gamma and beta raises, and launches nothing.
    from latentsplat_tpu_torch.ops.group_norm import group_norm_silu

    before = dict(cuda_build.launches)
    for dtype in (torch.float16, torch.float64):
        norm = torch.nn.GroupNorm(8, 16, eps=1e-6).to(cuda, dtype)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            group_norm_silu(torch.randn((2, 16, 8, 8), device=cuda, dtype=dtype), norm, True)
    norm = torch.nn.GroupNorm(8, 16, eps=1e-6).to(cuda)
    with pytest.raises(ValueError):
        group_norm_silu(torch.randn((2, 16, 8), device=cuda), norm, True)
    with pytest.raises(ValueError):
        group_norm_silu(torch.randn((2, 16, 8, 8), device=cuda), torch.nn.GroupNorm(8, 16, affine=False).to(cuda),
                        False)
    assert dict(cuda_build.launches) == before


def vae_pair(channels, device, seed=0):
    """The port's VAE with skips and the frozen NCHW copy of it
    (perfbench/reference), the same random weights, on the card."""
    from latentsplat_tpu_torch.model.autoencoder.kl import AutoencoderKL, AutoencoderKLCfg
    from perfbench.reference.model.autoencoder import kl as nchw

    torch.manual_seed(seed)
    kwargs = dict(block_out_channels=channels, layers_per_block=2, latent_channels=4, skip_connections=True)
    ours = AutoencoderKL(AutoencoderKLCfg(**kwargs), d_in=3, d_skip_extra=3)
    ref = nchw.AutoencoderKL(nchw.AutoencoderKLCfg(**kwargs), d_in=3, d_skip_extra=3)
    ref.load_state_dict(ours.state_dict())
    return ours.to(device), ref.to(device)


# The decode against the NCHW copy: cuDNN's NHWC and NCHW kernels and the
# two norms sum in other orders, ~1e-7 relative a layer over ~30 layers;
# within this share of the image's root mean square.
VAE_DECODE_RTOL = 1e-5


@pytest.mark.parametrize("views, seed", [(2, 0), (30, 0), (30, 1), (30, 2)])
def test_vae_decode_matches_nchw(cuda, views, seed):
    # The published kl_f8 decoder at 256x256 (2 views, and the video cell's
    # 30 on three seeds of weights and inputs), TF32 off on both sides:
    # within VAE_DECODE_RTOL of the image's rms. One kernel launch for each
    # norm.
    ours, ref = vae_pair([128, 256, 512, 512], cuda, seed)
    g = torch.Generator(device=cuda).manual_seed(seed + 1)
    z = torch.randn((1, views, 32, 32, 4), generator=g, device=cuda)
    skip = torch.randn((1, views, 256, 256, 7), generator=g, device=cuda)
    norms = sum(isinstance(m, torch.nn.GroupNorm) for m in ours.decoder.modules())
    with torch.no_grad():
        before = launched("group_norm_silu")
        out = ours.decode(z, skip)
        torch.cuda.synchronize()
        assert launched("group_norm_silu") == before + norms == before + 30
        want = ref.decode(z, skip)
    rms = float(want.pow(2).mean().sqrt())
    assert float((out - want).abs().max()) <= VAE_DECODE_RTOL * rms


def test_vae_gradients_match_nchw(cuda):
    # A narrow VAE with skips, decode and encode, forward and backward
    # through the kernel against the NCHW copy through nn.GroupNorm: each
    # gradient leaf within 1e-4 of its largest value (float32 sums in other
    # orders; dgamma's are sums of ~1e5 terms), floored at 1e-3 of the
    # largest leaf for leaves that are zero but for rounding (a conv bias
    # before a group norm of one channel a group: float32 noise of ~2e-8
    # of the largest leaf on either side).
    ours, ref = vae_pair([32, 64], cuda)
    grads = []
    for model in (ours, ref):
        g = torch.Generator(device=cuda).manual_seed(2)
        z = torch.randn((2, 2, 32, 32, 4), generator=g, device=cuda).requires_grad_()
        skip = torch.randn((2, 2, 64, 64, 7), generator=g, device=cuda).requires_grad_()
        images = torch.rand((2, 64, 64, 3), generator=g, device=cuda)
        out = model.decode(z, skip)
        loss = (out * torch.randn(out.shape, generator=g, device=cuda)).sum() + model.encode(images).mean.square().sum()
        loss.backward()
        grads.append({"z": z.grad, "skip": skip.grad,
                      **{n: p.grad for n, p in model.named_parameters() if p.grad is not None}})
    floor = 1e-3 * max(float(v.abs().max()) for v in grads[1].values())
    errors = {name: float((grads[0][name] - want).abs().max()) / max(float(want.abs().max()), floor)
              for name, want in grads[1].items()}
    assert max(errors.values()) <= 1e-4, sorted(errors.items(), key=lambda kv: -kv[1])[:5]


# -- residual_add (ops/residual_add.py) and the norm's shift -----------------------

# The decoder's sums: (channels, side) of each distinct shape at the video
# cell's 30 views (32² and 64² at 512, 128² at 512 (the skip sum) and 256,
# 256² at 256 (the skip sum) and 128).
DECODER_SUMS = [(512, 32), (512, 64), (512, 128), (256, 128), (256, 256), (128, 256)]


def residual_case(n, channels, side, device, dtype, seed, layout=torch.channels_last, offset=False):
    """Two operands and two biases (float32 biases for float32 operands,
    bfloat16 for bfloat16, as the `vae:bfloat16` site casts them)."""
    g = torch.Generator(device=device).manual_seed(seed)
    a, b = (torch.randn((n, channels, side, side), generator=g, device=device).to(dtype) for _ in range(2))
    if offset:   # channels-last memory one value past a 16-byte boundary: the scalar path
        views = []
        for t in (a, b):
            buf = torch.empty(t.numel() + 1, device=device, dtype=dtype)
            view = buf[1:].view(n, side, side, channels).permute(0, 3, 1, 2)
            view.copy_(t)
            views.append(view)
        a, b = views
    else:
        a, b = (t.contiguous(memory_format=layout) for t in (a, b))
    bias_a, bias_b = (torch.randn(channels, generator=g, device=device).to(dtype) for _ in range(2))
    return a, bias_a, b, bias_b


def residual_check(a, bias_a, b, bias_b):
    """The kernel against the plain ops, bit for bit, with one launch."""
    from latentsplat_tpu_torch.ops.residual_add import residual_add, residual_add_reference

    before = launched("residual_add")
    out = residual_add(a, bias_a, b, bias_b)
    torch.cuda.synchronize()
    assert launched("residual_add") == before + 1
    assert out.is_contiguous(memory_format=torch.channels_last) and out.dtype == a.dtype
    assert torch.equal(out, residual_add_reference(a, bias_a, b, bias_b))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels,side", DECODER_SUMS)
def test_residual_add_decoder_shapes(cuda, channels, side, dtype):
    residual_check(*residual_case(30, channels, side, cuda, dtype, channels + side))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("layout", ["channels_last", "contiguous", "offset"])
@pytest.mark.parametrize("biases", ["both", "a", "b", "none", "one_operand"])
def test_residual_add_biases_and_layouts(cuda, biases, layout, dtype):
    # Each bias present or absent, and a alone with its bias (the sum that
    # gives a conv_shortcut its input's bias); an NCHW input is copied to
    # channels-last first; one a value off a 16-byte boundary takes the
    # scalar path.
    memory = {"contiguous": torch.contiguous_format}.get(layout, torch.channels_last)
    a, bias_a, b, bias_b = residual_case(2, 128, 24, cuda, dtype, 3, layout=memory, offset=layout == "offset")
    args = {"both": (a, bias_a, b, bias_b), "a": (a, bias_a, b, None), "b": (a, None, b, bias_b),
            "none": (a, None, b, None), "one_operand": (a, bias_a, None, None)}[biases]
    residual_check(*args)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels", [6, 12, 1536, 4098])
def test_residual_add_narrow_and_wide(cuda, channels, dtype):
    # 6 channels: the scalar path (C % 4 and C % 8); 12: float4 loads but
    # the scalar path in bfloat16; 1536 (float32) and 4098 (the scalar
    # path): rows of more vectors than a block's 256 threads, split by
    # grid.y.
    residual_check(*residual_case(3, channels, 9, cuda, dtype, channels))


def test_residual_add_gradients(cuda):
    # dy reaches both operands as it is; each bias gets its per-channel
    # sum, the sum a convolution's backward computes for its bias.
    from latentsplat_tpu_torch.ops.residual_add import residual_add, residual_add_reference

    leaves = [t.detach().requires_grad_() for t in residual_case(2, 128, 24, cuda, torch.float32, 5)]
    dy = torch.randn(leaves[0].shape, device=cuda).contiguous(memory_format=torch.channels_last)
    got = torch.autograd.grad(residual_add(*leaves), leaves, dy)
    assert got[0] is got[2] or torch.equal(got[0], got[2])
    assert torch.equal(got[0], dy) and torch.equal(got[1], dy.sum((0, 2, 3))) and torch.equal(got[3], got[1])
    want = torch.autograd.grad(residual_add_reference(*leaves), leaves, dy)
    for x, y in zip(got, want):
        assert torch.allclose(x, y, rtol=1e-5, atol=1e-5)


def test_residual_add_refuses_what_the_kernel_does_not_take(cuda):
    # Another dtype, operands of other shapes or dtypes, a bias of another
    # length: a ValueError, and no launch.
    from latentsplat_tpu_torch.ops.residual_add import residual_add

    before = dict(cuda_build.launches)
    for dtype in (torch.float16, torch.float64):
        a = torch.randn((2, 8, 4, 4), device=cuda, dtype=dtype)
        with pytest.raises(ValueError, match="float32 or bfloat16"):
            residual_add(a, None, a, None)
    a = torch.randn((2, 8, 4, 4), device=cuda)
    for b in (torch.randn((2, 8, 4, 5), device=cuda), a.to(torch.bfloat16), a[0]):
        with pytest.raises(ValueError):
            residual_add(a, None, b, None)
    with pytest.raises(ValueError):
        residual_add(a, torch.zeros(7, device=cuda), a, None)
    with pytest.raises(ValueError):
        residual_add(a[0], None, a[0], None)
    assert dict(cuda_build.launches) == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels,side,offset", [(c, s, False) for c, s in DECODER_NORMS] + [(128, 48, True)])
def test_group_norm_silu_shift(cuda, channels, side, offset, dtype):
    # The norm of x with a shift against the norm of x + shift made by
    # torch's add (the bias add of the convolution that wrote x), forward
    # and backward, bit for bit; the shift's gradient is dx's per-channel
    # sum. One launch each way, of the "shift" variant.
    from latentsplat_tpu_torch.ops.group_norm import group_norm_silu

    x, weight, bias, dy, groups = group_norm_case(channels, side, cuda, channels + side, offset=offset, dtype=dtype)
    shift = (torch.rand(channels, generator=torch.Generator().manual_seed(side)) - 0.5).to(cuda, dtype)
    norm = torch.nn.GroupNorm(groups, channels, eps=1e-6).to(cuda, dtype)
    with torch.no_grad():
        norm.weight.copy_(weight)
        norm.bias.copy_(bias)
    leaves = [x.detach().clone().requires_grad_(), norm.weight, norm.bias, shift.clone().requires_grad_()]
    before = {k: launched(k, "shift") for k in ("group_norm_silu", "group_norm_silu_backward")}
    y = group_norm_silu(leaves[0], norm, True, shift=leaves[3])
    grads = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert {k: launched(k, "shift") - n for k, n in before.items()} == {
        "group_norm_silu": 1, "group_norm_silu_backward": 1}
    shifted = (x.detach() + shift[:, None, None]).requires_grad_()
    want = group_norm_silu(shifted, norm, True)
    want_grads = torch.autograd.grad(want, [shifted, norm.weight, norm.bias], dy)
    assert torch.equal(y, want)
    for got, ref in zip(grads[:3], want_grads):
        assert torch.equal(got, ref)
    assert grads[3].dtype == dtype and torch.equal(grads[3], want_grads[0].sum((0, 2, 3)))


def biased_flow(monkeypatch):
    """The VAE's data flow as before its convolutions left their biases to
    the next reader: every convolution adds its own bias, the sums are
    torch's adds and the norms take no shift."""
    from latentsplat_tpu_torch.model.autoencoder import kl

    norm = kl.group_norm_silu
    monkeypatch.setattr(kl.BiasLaterConv2d, "forward", torch.nn.Conv2d.forward)
    monkeypatch.setattr(kl, "residual_add", lambda a, bias_a=None, b=None, bias_b=None: a if b is None else a + b)
    monkeypatch.setattr(kl, "group_norm_silu", lambda x, n, silu, shift=None: norm(x, n, silu))


def counted_call(fn):
    """fn() without gradients, synchronized, and the kernel launches it
    made (a Counter)."""
    before = collections.Counter(cuda_build.launches)
    with torch.no_grad():
        out = fn()
    torch.cuda.synchronize()
    return out, cuda_build.launches - before


def deterministic_cudnn(monkeypatch, tf32):
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", tf32)


@pytest.mark.parametrize("dtype,tf32", [(torch.float32, False), (torch.float32, True), (torch.bfloat16, False)])
def test_vae_decode_bias_free_equals_biased(cuda, dtype, tf32, monkeypatch):
    # The published kl_f8 decoder with skips on the video cell's 30 views:
    # its convolutions without their biases, each bias added by the norm or
    # the sum that reads the output, give the bits of the same weights
    # decoded with biased convolutions and torch's adds (cuDNN
    # deterministic, no autotuning; TF32 on as the benchmark runs the
    # program, and off). A skip decode launches residual_add 18 times (14
    # resnets, 4 skip sums) and group_norm_silu with a shift 15 times (every
    # norm2, and mid_resnet_0's norm1 for conv_in's bias), 30 norms in all.
    deterministic_cudnn(monkeypatch, tf32)
    ours, _ = vae_pair([128, 256, 512, 512], cuda, 0)
    ours = ours.to(dtype)
    g = torch.Generator(device=cuda).manual_seed(1)
    z = torch.randn((1, 30, 32, 32, 4), generator=g, device=cuda).to(dtype)
    skip = torch.randn((1, 30, 256, 256, 7), generator=g, device=cuda).to(dtype)
    out, new = counted_call(lambda: ours.decode(z, skip))
    assert {k: launched(k, counts=new) for k in ("residual_add", "group_norm_silu")} == {
        "residual_add": 18, "group_norm_silu": 30}
    assert launched("group_norm_silu", "shift", counts=new) == 15
    biased_flow(monkeypatch)
    want, new = counted_call(lambda: ours.decode(z, skip))
    assert launched("residual_add", counts=new) == 0 and launched("group_norm_silu", "shift", counts=new) == 0
    assert torch.equal(out, want)


def test_vae_encode_and_plain_decode_bias_free_equal_biased(cuda, monkeypatch):
    # The paths a skip decode does not take, bit for bit against the
    # biased flow (TF32 on, cuDNN deterministic), 4 views at 256x256: the
    # decoder without skips (up_1's first block takes the upsample's bias
    # as its norm's shift and its sum's bias; up_2's and up_3's, which have
    # a conv_shortcut, take it in a one-operand sum first) and the encoder
    # (conv_in's bias to down_0's first block, down_0's and down_1's
    # downsample biases to a one-operand sum, down_2's to down_3's first
    # block's norm and sum). Launches: residual_add 14 + 2 decoding and
    # 10 + 2 encoding, group_norm_silu with a shift 14 + 2 and 10 + 2.
    from latentsplat_tpu_torch.model.autoencoder.kl import AutoencoderKL, AutoencoderKLCfg

    deterministic_cudnn(monkeypatch, True)
    torch.manual_seed(2)
    model = AutoencoderKL(AutoencoderKLCfg(skip_connections=False), d_in=3).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(3)
    z = torch.randn((1, 4, 32, 32, 4), generator=g, device=cuda)
    images = torch.rand((1, 4, 256, 256, 3), generator=g, device=cuda)
    got, new = counted_call(lambda: (model.decode(z), model.encode(images).mean))
    assert launched("residual_add", counts=new) == 16 + 12
    assert launched("group_norm_silu", "shift", counts=new) == 16 + 12
    biased_flow(monkeypatch)
    want, new = counted_call(lambda: (model.decode(z), model.encode(images).mean))
    assert launched("residual_add", counts=new) == 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))
