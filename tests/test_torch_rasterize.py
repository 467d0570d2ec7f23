"""Parity of the PyTorch rasterizer (latentsplat_tpu_torch.ops.rasterize)
with the JAX package's.

The plain versions of the two kernels are held against the Pallas kernels
they replace, run in interpret mode; the whole tiled forward against the
dense oracle and the JAX tiled forward. The CUDA kernels themselves are held
against the plain versions on the card in tests/test_torch_cuda.py.
"""

import ctypes
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsplat_tpu.ops.rasterize import composite_dense as j_composite_dense
from latentsplat_tpu.ops.rasterize import project_gaussians_to_screen as j_project
from latentsplat_tpu.ops.rasterize.expand import GW, OUT_BLOCK, expand_by_counts, start_offsets
from latentsplat_tpu.ops.rasterize.pallas_kernels import CHUNK, composite_pairs_fwd, pad_attr_rows
from latentsplat_tpu.ops.rasterize.tiled import _tile_rects as j_tile_rects
from latentsplat_tpu.ops.rasterize.tiled import composite_tiled as j_composite_tiled
from latentsplat_tpu_torch import cuda_build
from latentsplat_tpu_torch.ops.gaussians import build_covariance
from latentsplat_tpu_torch.ops.rasterize import api, kernels, shade, tiled
from latentsplat_tpu_torch.ops.rasterize.camera import project_gaussians_to_screen
from latentsplat_tpu_torch.ops.rasterize.dense import composite_dense
from latentsplat_tpu_torch.ops.rasterize.kernels import (
    composite_forward_reference,
    duplicate_with_keys_reference,
)
from latentsplat_tpu_torch.ops.rasterize.tiled import (
    CULL_MARGIN,
    FAST_CULL_MARGIN,
    composite_tiled,
    pack_attributes,
    sort_pairs,
    tile_rects,
)
from tests.test_torch_render_pass import LEAVES, OUTPUTS, render_fn, run
from tests.test_torch_render_pass import scene as pass_scene
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

H = W = 32
TILES_X = TILES_Y = 2
CAP = 9
INTRINSICS = np.array([[1.0, 0.0, 0.5], [0.0, 1.0, 0.5], [0.0, 0.0, 1.0]], np.float32)
EXTRINSICS = np.eye(4, dtype=np.float32)


def make_scene(seed, n, n_channels=4, n_dead=0, n_wide=0):
    """Numpy Gaussians in front of a camera at the origin looking down +z.
    `n_dead` sit behind the camera; `n_wide` are large enough that their
    tile rects exceed the 9-slot cap."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(2.0, 6.0, n)
    xy = rng.uniform(-0.6, 0.6, (n, 2)) * z[:, None]
    means = np.concatenate([xy, z[:, None]], axis=1)
    scales = rng.uniform(0.05, 0.25, (n, 3))
    if n_wide:
        scales[:n_wide] = rng.uniform(1.5, 3.0, (n_wide, 3))
        means[:n_wide, :2] *= 0.2
    if n_dead:
        means[n - n_dead :, 2] *= -1.0
    quats = rng.standard_normal((n, 4))
    quats /= np.linalg.norm(quats, axis=-1, keepdims=True)
    covs = build_covariance(torch.from_numpy(scales), torch.from_numpy(quats)).numpy()
    opacities = rng.uniform(0.3, 0.95, n)
    channels = rng.uniform(0.0, 1.0, (n, n_channels))
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return f32(means), f32(covs), f32(opacities), f32(channels)


def project_both(scene, size=H):
    j_sg = j_project(*map(jnp.asarray, scene), jnp.asarray(EXTRINSICS), jnp.asarray(INTRINSICS), (size, size))
    t_sg = project_gaussians_to_screen(
        *map(torch.from_numpy, scene), torch.from_numpy(EXTRINSICS),
        torch.from_numpy(INTRINSICS), (size, size),
    )
    return j_sg, t_sg


# Bookkeeping tests run at 64x64 (4x4 tiles), where a wide splat's tile rect
# (up to 16 tiles) exceeds the 9-slot cap.
BIG = 64
BIG_TILES = BIG // 16


class TestProjection:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_matches_jax(self, seed):
        # Elementwise f32 formulas in the same order: agreement to a few ulp
        # (the conic is an inverse of a near-singular matrix for thin splats).
        j_sg, t_sg = project_both(make_scene(seed, 200, n_dead=10, n_wide=5))
        for name in ("mean2d", "depth", "radius", "opacity", "extent"):
            np.testing.assert_allclose(
                getattr(t_sg, name).numpy(), np.asarray(getattr(j_sg, name)), rtol=1e-5, atol=1e-5
            )
        np.testing.assert_allclose(t_sg.conic.numpy(), np.asarray(j_sg.conic), rtol=1e-4, atol=1e-5)


# The cull's cases run at 128x128 (8x8 tiles), where wide splats' rects span
# up to all 64 tiles: every cap up to the int64 mask's 64 slots is reached.
CULL_SIZE = 128
CULL_TILES = CULL_SIZE // 16
# JAX's _tile_rects holds at most 24 slots (its mask rides the expansion as
# an exact float32).
JAX_MAX_CAP = 24
# Rows given special conics, all wide splats: a degenerate (rank 1) and a
# zero conic, a NaN and an infinite one.
SPECIAL_CONICS = {0: (1.0, 1.0, 1.0), 1: (0.0, 0.0, 0.0), 2: (np.nan, 0.5, 1.0), 3: (np.inf, 0.0, np.inf)}


def cull_scene(seed=3):
    """(JAX, port) screen Gaussians at CULL_SIZE: 300 of them, 20 dead
    (behind the camera), 12 wide, the first rows with SPECIAL_CONICS."""
    j_sg, t_sg = project_both(make_scene(seed, 300, n_dead=20, n_wide=12), CULL_SIZE)
    conic = t_sg.conic.numpy().copy()
    for row, value in SPECIAL_CONICS.items():
        conic[row] = value
    assert (t_sg.radius[list(SPECIAL_CONICS)] > 0).all()
    return j_sg.replace(conic=jnp.asarray(conic)), dataclasses.replace(t_sg, conic=torch.from_numpy(conic))


def slot_cull_f64(t_sg, tiles, cap, margin):
    """(G, cap) whether each rect slot of each live Gaussian survives the
    cull, decided in float64 from its float32 tile offsets, and how far
    (relative) its quadratic form's minimum lies from the threshold: an
    evaluation independent of both the JAX and the port's arithmetic."""
    mean, ext = t_sg.mean2d.numpy(), t_sg.extent.numpy()
    ca, cb, cc = (t_sg.conic.numpy()[:, k].astype(np.float64) for k in range(3))

    def tile_index(v):
        return np.clip(np.floor(v / np.float32(16)), 0, tiles - 1)

    tx0, ty0 = tile_index(mean[:, 0] - ext[:, 0]), tile_index(mean[:, 1] - ext[:, 1])
    nx, ny = tile_index(mean[:, 0] + ext[:, 0]) - tx0 + 1, tile_index(mean[:, 1] + ext[:, 1]) - ty0 + 1
    thresh = np.log(255.0 * np.maximum(t_sg.opacity.numpy().astype(np.float64), 1e-12)) + margin
    ca_s, cc_s = np.maximum(ca, 1e-12), np.maximum(cc, 1e-12)

    def q(dx, dy):
        return 0.5 * ca * dx * dx + cb * dx * dy + 0.5 * cc * dy * dy

    bits, gap = np.zeros((len(ca), cap), bool), np.zeros((len(ca), cap))
    with np.errstate(invalid="ignore", divide="ignore"):
        for s in range(cap):
            row = np.floor((s + 0.5) / nx)
            dx0 = ((tx0 + s - row * nx) * np.float32(16) - mean[:, 0]).astype(np.float32).astype(np.float64)
            dy0 = ((ty0 + row) * np.float32(16) - mean[:, 1]).astype(np.float32).astype(np.float64)
            dx1, dy1 = dx0 + 15, dy0 + 15
            q_min = np.minimum(
                np.minimum(q(dx0, np.minimum(np.maximum(-cb * dx0 / cc_s, dy0), dy1)),
                           q(dx1, np.minimum(np.maximum(-cb * dx1 / cc_s, dy0), dy1))),
                np.minimum(q(np.minimum(np.maximum(-cb * dy0 / ca_s, dx0), dx1), dy0),
                           q(np.minimum(np.maximum(-cb * dy1 / ca_s, dx0), dx1), dy1)))
            q_min = np.where((dx0 <= 0) & (dx1 >= 0) & (dy0 <= 0) & (dy1 >= 0), 0.0, q_min)
            bits[:, s] = (s < nx * ny) & (q_min <= thresh) & (t_sg.radius.numpy() > 0)
            gap[:, s] = np.where(s < nx * ny, np.abs(q_min - thresh) / (1.0 + np.abs(thresh)), np.inf)
    return bits, np.nan_to_num(gap, nan=np.inf)


def mask_bits_of(mask, cap):
    """(G, cap) bool: bit s of each mask."""
    m = mask.numpy().astype(np.int64).view(np.uint64)
    return ((m[:, None] >> np.arange(cap, dtype=np.uint64)[None, :]) & np.uint64(1)).astype(bool)


class TestTileRects:
    @pytest.mark.parametrize("margin", [CULL_MARGIN, FAST_CULL_MARGIN])
    @pytest.mark.parametrize("cap", [1, 9, 32, 33, 64])
    def test_matches_jax(self, cap, margin):
        # Integer bookkeeping: exact, against JAX's slots (up to its 24); the
        # slots beyond against a float64 evaluation wherever it decides them
        # clearly. JAX gives empty Gaussians one invalid pair; the port gives
        # them none. Dead rows, degenerate and NaN/inf conics included.
        j_sg, t_sg = cull_scene()
        j_cap = min(cap, JAX_MAX_CAP)
        j_counts, j_base, j_nx, j_mask = map(np.asarray, j_tile_rects(j_sg, CULL_TILES, CULL_TILES, j_cap, margin))
        counts, base, nx, mask = tile_rects(t_sg, CULL_TILES, CULL_TILES, cap, margin)
        assert mask.dtype == (torch.int32 if cap <= 32 else torch.int64)
        bits = mask_bits_of(mask, cap)
        np.testing.assert_array_equal(counts.numpy(), bits.sum(axis=1))
        j_live = j_base < CULL_TILES**2
        live = counts.numpy() > 0
        assert j_live.sum() > 0 and (~live).sum() >= 20
        assert (j_nx[len(SPECIAL_CONICS):12] >= 4).all()   # wide splats span many tiles
        j_bits = mask_bits_of(torch.from_numpy(j_mask.copy()), j_cap)
        np.testing.assert_array_equal(bits[j_live, :j_cap], j_bits[j_live])
        assert not bits[~j_live, :j_cap].any()
        both = live & j_live
        np.testing.assert_array_equal(base.numpy()[both], j_base[both])
        np.testing.assert_array_equal(nx.numpy()[both], j_nx[both])
        assert (counts.numpy()[~live] == 0).all() and (mask.numpy()[~live] == 0).all()
        assert (base.numpy()[~live] == CULL_TILES**2).all() and (nx.numpy()[~live] == 1).all()
        f64_bits, gap = slot_cull_f64(t_sg, CULL_TILES, cap, margin)
        clear = gap > 1e-4
        np.testing.assert_array_equal(bits[clear], f64_bits[clear])
        if cap > JAX_MAX_CAP:
            high = bits[:, JAX_MAX_CAP:]
            assert high.any() and (~high[live]).any()
        # The special rows: the zero conic keeps every slot of its rect; the
        # NaN and infinite ones at most the slot whose box holds the mean.
        assert counts[1] == np.isfinite(gap[1]).sum() > 0
        assert bits[2].sum() <= 1 and bits[3].sum() <= 1

    def test_cpu_path_runs_the_plain_version(self, monkeypatch):
        # On the CPU tile_rects is tile_rects_reference: no kernel library is
        # loaded and no launch is counted.
        def refuse():
            raise AssertionError("the CPU path loaded the kernel library")

        monkeypatch.setattr(cuda_build, "load_library", refuse)
        _, t_sg = cull_scene()
        before = cuda_build.launched("tile_cull")
        for cap in (9, 40):
            got = tile_rects(t_sg, CULL_TILES, CULL_TILES, cap)
            want = tiled.tile_rects_reference(t_sg, CULL_TILES, CULL_TILES, cap)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
        assert cuda_build.launched("tile_cull") == before == 0

    def test_the_library_declares_tile_cull(self):
        # The ctypes signature matches the C entry point, argument by
        # argument: pointers, ints and the float margin.
        argtypes, restype = cuda_build._SIGNATURES["tile_cull"]
        source = (cuda_build.CSRC_DIR / "tile_cull.cu").read_text()
        params = [p.split("//")[0].strip() for p in
                  re.search(r'extern "C" int tile_cull\(([^)]*)\)', source).group(1).split(",")]
        kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
        assert restype is ctypes.c_int and len(argtypes) == len(params) == 16
        assert [a for a in argtypes] == [ctypes.c_void_p if "*" in p else kinds[p.split()[0]] for p in params]


def parent_render(inputs, size):
    """The render of one pass as the port computed it before the shade was
    one kernel: the shade inline (gathered scene rows, view_channels a
    scene, the 1/near scale, the projection), then composite_tiled."""
    b, v = inputs["extrinsics"].shape[:2]
    ext, intr, near = (inputs[k].reshape(b * v, *inputs[k].shape[2:]) for k in ("extrinsics", "intrinsics", "near"))

    def gather(x):
        return x[:, None].expand(b, v, *x.shape[1:]).reshape(b * v, *x.shape[1:])

    means, covs, opacities, background = map(gather, (inputs["gaussian_means"], inputs["gaussian_covariances"],
                                                      inputs["gaussian_opacities"], inputs["background_color"]))
    channels = torch.cat([shade.view_channels(means[s * v : (s + 1) * v], inputs["gaussian_color_sh"][s],
                                              inputs["gaussian_feature_sh"][s], ext[s * v : (s + 1) * v, :3, 3])
                          for s in range(b)])
    fill = torch.zeros(channels.shape[0], channels.shape[-1])
    fill[:, :3] = background[:, :3]
    scale = 1.0 / near
    ext_s = ext.clone()
    ext_s[:, :3, 3] = ext[:, :3, 3] * scale[:, None]
    sg = project_gaussians_to_screen(means * scale[:, None, None], covs * (scale * scale)[:, None, None, None],
                                     opacities, channels, ext_s, intr, (size, size))
    images, masks, depths, pairs = composite_tiled(sg, (size, size), fill)
    images = images.reshape(b, v, -1, size, size)
    return api.RenderOutput(color=images[:, :, :3], feature=images[:, :, 3:], mask=masks.reshape(b, v, size, size),
                            depth=depths.reshape(b, v, size, size), num_pairs=pairs.reshape(b, v))


class TestShade:
    """The render's shade (ops/rasterize/shade.py): the choice between the
    shade_project kernel and the plain shade. The kernel itself is held to
    the plain shade on the card (tests/test_torch_cuda.py)."""

    @pytest.mark.parametrize("grad", [False, True])
    def test_cpu_path_runs_the_plain_shade(self, monkeypatch, grad):
        # On the CPU, with or without gradient, the render shades in
        # PyTorch: no kernel library is loaded and no launch is counted.
        def refuse():
            raise AssertionError("the CPU path loaded the kernel library")

        monkeypatch.setattr(cuda_build, "load_library", refuse)
        before = cuda_build.launched("shade_project")
        outputs, grads = run(render_fn("exact"), False, monkeypatch, grad)
        assert all(torch.isfinite(x).all() for x in outputs)
        assert cuda_build.launched("shade_project") == before == 0
        assert len(grads) == (len(LEAVES) if grad else 0)

    @pytest.mark.parametrize("case", ["no_grad", "grad_without_leaves", "grad", "dc_payload", "float64_tables",
                                      "payload", "payload_grad"])
    def test_the_kernel_runs_where_no_input_needs_a_gradient(self, monkeypatch, case):
        # With every input taken for a CUDA one, `shade` picks the kernel
        # exactly where no input needs a gradient, whatever the dtypes and
        # payload (the kernel raises on what it does not take; use_sh=False
        # hands it the DC coefficients as a payload); the plain shade
        # elsewhere.
        kernel = case not in ("grad", "payload_grad")
        calls = []
        monkeypatch.setattr(kernels, "_on_cuda", lambda *tensors: True)
        monkeypatch.setattr(shade, "shade_project", lambda *args: calls.append(args) or "kernel")
        s = pass_scene()
        tables = {"color": s["gaussian_color_sh"], "feature": s["gaussian_feature_sh"]}
        payload = torch.rand(3, s["gaussian_means"].shape[1], 3) if case.startswith("payload") else None
        if case == "float64_tables":
            tables = {k: v.double() for k, v in tables.items()}
        if case in ("grad", "payload_grad"):
            s["gaussian_means"].requires_grad_()
        use_sh = case not in ("dc_payload", "payload", "payload_grad")
        if case == "dc_payload":
            tables = {k: v[..., :1] for k, v in tables.items()}
        args = (s["gaussian_means"], s["gaussian_covariances"], s["gaussian_opacities"], tables,
                s["extrinsics"][0], s["intrinsics"][0], s["near"][0], 0, 3, payload, True, use_sh, (32, 32))
        with torch.set_grad_enabled(case != "no_grad"):
            out = shade.shade(*args)
        assert (out == "kernel") == kernel and len(calls) == int(kernel)
        if not kernel:
            assert isinstance(out, tiled.ScreenGaussians)
        elif case == "dc_payload":
            # The plain shade's channels of use_sh=False, as they are.
            want = shade.shade_reference(*args).channels
            assert calls[0][9].dtype == want.dtype and torch.equal(calls[0][9], want)
        else:
            assert calls[0][9] is payload and calls[0][3] is tables

    def test_gradients_equal_the_inline_shade(self, monkeypatch):
        # Under autograd the render's outputs and every leaf's gradient are
        # the bits of the shade as it was inline in the render.
        got = run(render_fn("exact"), False, monkeypatch, True)
        want = run(lambda inputs: parent_render(inputs, 32), False, monkeypatch, True)
        for a, b in zip((*got[0], *got[1]), (*want[0], *want[1])):
            assert (a is None) == (b is None) and (a is None or torch.equal(a, b))

    def test_no_grad_outputs_equal_grad_outputs(self, monkeypatch):
        # The shade's choice follows grad mode; the outputs do not.
        no_grad, _ = run(render_fn("exact"), False, monkeypatch, False)
        grad, _ = run(render_fn("exact"), False, monkeypatch, True)
        assert len(no_grad) == len(OUTPUTS) + 1 and all(torch.equal(a, b) for a, b in zip(no_grad, grad))

    def test_the_library_declares_shade_project(self):
        # The ctypes signatures match the C entry points, argument by
        # argument: the ints, then the pointers and the stream.
        kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
        source = (cuda_build.CSRC_DIR / "shade_project.cu").read_text()
        assert source.count('extern "C"') == 1
        argtypes, restype = cuda_build._SIGNATURES["shade_project"]
        params = [p.split("//")[0].strip() for p in
                  re.search(r'extern "C" int shade_project\(([^)]*)\)', source).group(1).split(",")]
        assert restype is ctypes.c_int and len(argtypes) == len(params) == 28
        assert list(argtypes) == [ctypes.c_void_p if "*" in p else kinds[p.split()[0]] for p in params]


def jax_pairs(j_sg, tiles):
    """(gaussian, tile) of every valid pair of the JAX expansion, decoded
    as latentsplat_tpu/ops/rasterize/tiled.py does."""
    counts, base, nx, mask = j_tile_rects(j_sg, tiles, tiles, CAP)
    g = counts.shape[0]
    g_pad = -(-g // GW) * GW
    pad = lambda x: jnp.pad(x, (0, g_pad - g))  # noqa: E731
    counts_p = pad(counts)
    starts, _ = start_offsets(counts_p)
    rows = [pad(jnp.arange(g, dtype=jnp.float32)), pad(base.astype(jnp.float32)),
            pad(nx.astype(jnp.float32)), pad(mask.astype(jnp.float32)), starts,
            counts_p.astype(jnp.float32)]
    stack = jnp.zeros((8, g_pad), jnp.float32).at[:6].set(jnp.stack(rows))
    budget = -(-int(counts.sum()) // OUT_BLOCK) * OUT_BLOCK
    out = np.asarray(expand_by_counts(stack, counts_p, budget, 4, 5, interpret=True))
    gid, base_e, nx_e, mask_e, start_e = (out[i].astype(np.int64) for i in range(5))
    slot = np.arange(budget) - start_e
    pos = np.zeros_like(slot)
    cum = np.zeros_like(slot)
    for b in range(CAP):
        bit = (mask_e >> b) & 1
        pos = np.where((cum == slot) & (bit == 1), b, pos)
        cum = cum + bit
    nx_e = np.maximum(nx_e, 1)
    tile = base_e + (pos % nx_e) + (pos // nx_e) * tiles
    valid = (np.arange(budget) < int(counts.sum())) & (tile < tiles * tiles)
    return sorted(zip(gid[valid].tolist(), tile[valid].tolist()))


class TestDuplicateWithKeys:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_reference_matches_expand_by_counts(self, seed):
        # Integer pair maps: exact, including dead Gaussians and splats
        # wider than the cap.
        j_sg, t_sg = project_both(make_scene(seed, 180, n_dead=15, n_wide=8), BIG)
        counts, base, nx, mask = tile_rects(t_sg, BIG_TILES, BIG_TILES, CAP)
        gids, keys = duplicate_with_keys_reference(counts, mask, base, nx, t_sg.depth, BIG_TILES, CAP)
        ours = sorted(zip(gids.tolist(), (keys >> 32).tolist()))
        assert ours == jax_pairs(j_sg, BIG_TILES)
        # Keys carry the depth bits; pairs are Gaussian-major.
        np.testing.assert_array_equal((keys & 0xFFFFFFFF).numpy(), t_sg.depth[gids.long()].view(torch.int32).numpy())
        assert (np.diff(gids.numpy()) >= 0).all()

    def test_sort_orders_tiles_then_depth(self):
        _, t_sg = project_both(make_scene(4, 120))
        counts, base, nx, mask = tile_rects(t_sg, TILES_X, TILES_Y, CAP)
        gids, keys = duplicate_with_keys_reference(counts, mask, base, nx, t_sg.depth, TILES_X, CAP)
        sorted_gids, ranges, _ = sort_pairs(gids, keys, TILES_X * TILES_Y)
        assert ranges[0] == 0 and ranges[-1] == gids.shape[0]
        for t in range(TILES_X * TILES_Y):
            seg = sorted_gids[ranges[t] : ranges[t + 1]].long()
            assert (np.diff(t_sg.depth[seg].numpy()) >= 0).all()


def hand_built_buffer(seed, n_ch=5):
    """A tile-sorted pair buffer over 4 tiles and two 512-pair chunks: tile 0
    holds enough opaque pairs that its pixels saturate, tile 2 none."""
    rng = np.random.default_rng(seed)
    seg = [420, 300, 0, 150]
    p = sum(seg)
    tile_of = np.repeat(np.arange(4), seg)
    cx = (tile_of % TILES_X) * 16 + 7.5
    cy = (tile_of // TILES_X) * 16 + 7.5
    x = cx + rng.uniform(-10, 10, p)
    y = cy + rng.uniform(-10, 10, p)
    sx, sy = rng.uniform(1.5, 6.0, p), rng.uniform(1.5, 6.0, p)
    rho = rng.uniform(-0.8, 0.8, p)
    det = (sx * sy) ** 2 * (1 - rho**2)
    ca, cb, cc = sy**2 / det, -rho * sx * sy / det, sx**2 / det
    op = np.where(tile_of == 0, rng.uniform(0.6, 0.95, p), rng.uniform(0.05, 0.6, p))
    ch = rng.uniform(0, 1, (p, n_ch))
    attrs = np.concatenate([np.stack([x, y, ca, cb, cc, op], 1), ch], 1).astype(np.float32)
    ranges = np.concatenate([[0], np.cumsum(seg)]).astype(np.int32)
    return attrs, ranges


class TestCompositeForward:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_reference_matches_composite_pairs_fwd(self, seed):
        attrs, ranges = hand_built_buffer(seed)
        n_ch = attrs.shape[1] - 6
        p_pad = -(-attrs.shape[0] // CHUNK) * CHUNK
        buf = np.zeros((pad_attr_rows(attrs.shape[1]), p_pad), np.float32)
        buf[: attrs.shape[1], : attrs.shape[0]] = attrs.T
        j_tiles, _ = composite_pairs_fwd(
            jnp.asarray(buf), jnp.asarray(ranges), n_ch=n_ch, tiles_x=TILES_X,
            tiles_y=TILES_Y, interpret=True,
        )
        j_tiles = np.asarray(j_tiles)
        j_channels = kernels.untile(torch.from_numpy(j_tiles[:, :n_ch]), TILES_X, TILES_Y)[0].numpy()
        j_t = kernels.untile(torch.from_numpy(j_tiles[:, n_ch]), TILES_X, TILES_Y)[0].numpy()

        channels, t, last = (x[0] for x in composite_forward_reference(
            torch.arange(attrs.shape[0], dtype=torch.int32), torch.from_numpy(ranges),
            torch.from_numpy(attrs), TILES_X, (H, W),
        ))
        channels, t = channels.numpy(), t.numpy()
        stopped = t < kernels.TRANSMITTANCE_MIN
        assert stopped.any() and (~stopped).any()
        # Pixels that never saturate: the same front-to-back sum, computed in
        # log space on the JAX side; 2e-5 covers its exp/log1p rounding.
        np.testing.assert_allclose(channels[:, ~stopped], j_channels[:, ~stopped], atol=2e-5)
        np.testing.assert_allclose(t[~stopped], j_t[~stopped], atol=2e-5)
        # Saturated pixels: the port stops each pixel once T < 1e-4, the TPU
        # kernel a whole tile after a 512-pair chunk, so what the TPU adds
        # later is at most 1e-4 * max channel (channels lie in [0, 1]).
        np.testing.assert_allclose(channels[:, stopped], j_channels[:, stopped], atol=1.2e-4)
        np.testing.assert_allclose(t[stopped], j_t[stopped], atol=1.2e-4)
        # Tile 2 is empty: transmittance 1, nothing accumulated, last = start.
        empty = np.s_[16:32, 0:16]
        np.testing.assert_array_equal(t[empty], 1.0)
        assert (last.numpy()[empty] == ranges[2]).all()


class TestTiledForward:
    @pytest.mark.parametrize("n", [1, 7, 64, 300])
    def test_matches_dense_oracle(self, n):
        # Tolerances of tests/test_rasterize.py's tiled-vs-dense test; depth is
        # a sum of z-weighted terms (z up to 6), hence the wider atol.
        scene = make_scene(n, n)
        j_sg, t_sg = project_both(scene)
        bg = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
        d_img, d_mask, d_depth = map(np.asarray, j_composite_dense(j_sg, (H, W), jnp.asarray(bg), tile_size=16))
        img, mask, depth, _ = composite_tiled(t_sg, (H, W), torch.from_numpy(bg))
        np.testing.assert_allclose(img.numpy(), d_img, atol=2e-4)
        np.testing.assert_allclose(mask.numpy(), d_mask, atol=2e-4)
        np.testing.assert_allclose(depth.numpy(), d_depth, atol=2e-3)

    def test_matches_jax_tiled_f32(self):
        scene = make_scene(11, 150, n_dead=5, n_wide=4)
        j_sg, t_sg = project_both(scene)
        bg = np.array([0.3, 0.1, 0.0, 0.2], np.float32)
        j_img, j_mask, j_depth = map(
            np.asarray, j_composite_tiled(j_sg, (H, W), jnp.asarray(bg), pack_channels=False)
        )
        img, mask, depth, _ = composite_tiled(t_sg, (H, W), torch.from_numpy(bg))
        np.testing.assert_allclose(img.numpy(), j_img, atol=2e-4)
        np.testing.assert_allclose(mask.numpy(), j_mask, atol=2e-4)
        np.testing.assert_allclose(depth.numpy(), j_depth, atol=2e-3)

    def test_port_dense_matches_jax_dense(self):
        j_sg, t_sg = project_both(make_scene(5, 100))
        bg = np.array([0.5, 0.1, 0.0, 0.2], np.float32)
        for ours, theirs in zip(
            composite_dense(t_sg, (H, W), torch.from_numpy(bg), tile_size=16),
            j_composite_dense(j_sg, (H, W), jnp.asarray(bg), tile_size=16),
        ):
            np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), atol=2e-5)

