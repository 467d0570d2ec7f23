"""A render call's (scene, view) items in one pass against one item a pass.

`api.render` composites all items of a call in passes (one launch of each
kernel, one sort and one host read a pass on the card); the JAX package
maps over the views inside one program. Each item must get the bits that a
pass of that item alone gives. Here the bound `api.PASS_ROWS` is patched
to 1 to force one item a pass, and everything runs the kernels'
plain versions (the CPU), which are deterministic: forward outputs, pair
counts and the gradients of every render input are compared bit for bit.
The scene: 2 scenes x 3 views at 32x32 (4 tiles, several scan blocks a
tile at "fast"), the views with different pair counts, one view empty.
"""

import numpy as np
import pytest
import torch

from latentsplat_tpu_torch.ops.rasterize import api, kernels
from latentsplat_tpu_torch.ops.rasterize.shade import view_channels
from latentsplat_tpu_torch.ops.rasterize.camera import project_gaussians_to_screen
from latentsplat_tpu_torch.ops.rasterize.tiled import (
    depth_code_bits,
    pack_attributes,
    precision_knobs,
    quantize_attributes,
    tile_pairs,
    tile_rects,
)
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

B, V, G, SIZE = 2, 3, 200, 32
TILES = SIZE // 16
OUTPUTS = ("color", "feature", "mask", "depth")


def scene(seed: int = 0) -> dict:
    """Two scenes of G Gaussians in front of 3 cameras each; scene 1's last
    camera looks away from its Gaussians (no pairs)."""
    rng = np.random.default_rng(seed)

    def t(x):
        return torch.from_numpy(np.asarray(x, np.float32))

    scales = rng.uniform(0.05, 0.2, (B, G, 3))
    ext = np.tile(np.eye(4, dtype=np.float32), (B, V, 1, 1))
    ext[..., 0, 3] = rng.normal(0, 0.3, (B, V))
    ext[1, 2, 0, 3] = 50.0
    return {
        "extrinsics": t(ext),
        "intrinsics": t(np.tile([[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]], (B, V, 1, 1))),
        "near": torch.ones(B, V), "far": torch.full((B, V), 100.0),
        "background_color": t(rng.uniform(0, 1, (B, 3))),
        "gaussian_means": t(rng.normal(0, 0.5, (B, G, 3)) + [0, 0, 4]),
        "gaussian_covariances": t(np.eye(3)[None, None] * (scales**2)[..., None]),
        "gaussian_opacities": t(rng.uniform(0.3, 1, (B, G))),
        "gaussian_color_sh": t(rng.normal(0, 0.3, (B, G, 3, 4))),
        "gaussian_feature_sh": t(rng.normal(0, 0.3, (B, G, 4, 4))),
    }


LEAVES = ("extrinsics", "background_color", "gaussian_means", "gaussian_covariances", "gaussian_opacities",
          "gaussian_color_sh", "gaussian_feature_sh")


def run(fn, one_item: bool, monkeypatch, grad: bool):
    """fn(inputs) -> RenderOutput or tensor with fresh leaves, in one pass or
    one item a pass; returns (outputs, gradients of LEAVES)."""
    with monkeypatch.context() as m:
        if one_item:
            m.setattr(api, "PASS_ROWS", 1)
        inputs = {k: v.clone().requires_grad_(grad and k in LEAVES) for k, v in scene().items()}
        with torch.set_grad_enabled(grad):
            out = fn(inputs)
            tensors = [out] if isinstance(out, torch.Tensor) else [getattr(out, k) for k in OUTPUTS]
            grads = ()
            if grad:
                weights = [torch.linspace(-1, 1, x.numel()).reshape(x.shape) for x in tensors]
                loss = sum((x * w).sum() for x, w in zip(tensors, weights))
                leaves = [inputs[k] for k in LEAVES]
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    pairs = [] if isinstance(out, torch.Tensor) else [out.num_pairs]
    return [x.detach() for x in tensors] + pairs, grads


def assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, y)


def render_fn(precision: str, **kwargs):
    def fn(inputs):
        return api.render(*(inputs[k] for k in ("extrinsics", "intrinsics", "near", "far")), (SIZE, SIZE),
                          *(inputs[k] for k in LEAVES[1:]), precision=precision, **kwargs)
    return fn


def test_the_scene_has_views_of_different_pair_counts_and_an_empty_one(monkeypatch):
    (*_, pairs), _ = run(render_fn("exact"), False, monkeypatch, False)
    assert pairs.shape == (B, V) and pairs[1, 2] == 0
    assert len(set(pairs.reshape(-1).tolist())) == B * V


def test_a_call_is_one_pass_under_the_bound():
    assert api.pass_ranges(B * V, G) == [(0, B * V)]
    # bench_render's 64 views of the flagship's 393,216 Gaussians: one pass.
    assert api.pass_ranges(64, 393216) == [(0, 64)]


@pytest.mark.parametrize("items, gaussians, per_pass", [(6, 10, 1), (7, 3, 3), (5, 1, 5)])
def test_pass_ranges_split_at_the_row_bound(monkeypatch, items, gaussians, per_pass):
    monkeypatch.setattr(api, "PASS_ROWS", per_pass * gaussians)
    ranges = api.pass_ranges(items, gaussians)
    assert ranges[0] == (0, min(per_pass, items)) and ranges[-1][1] == items
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(0 < stop - start <= per_pass for start, stop in ranges)


@pytest.mark.parametrize("precision, grad", [("exact", True), ("fast", True), ("fast", False),
                                             ("exact_bf16_mm", True), ("exact_q12_channels", True)],
                         ids=["exact", "fast", "fast_serving", "exact_bf16_mm", "exact_q12_channels"])
def test_one_pass_equals_one_item_a_pass(monkeypatch, precision, grad):
    # "fast" with gradient composites through the fast forward and backward
    # (scan blocks counted from each item's first pair), without it through
    # the coefficient layout; q12 scales each item's channels by its own
    # largest magnitude.
    one, g_one = run(render_fn(precision), False, monkeypatch, grad)
    per, g_per = run(render_fn(precision), True, monkeypatch, grad)
    assert_same(one, per)
    assert_same(g_one, g_per)
    assert all(g is not None and torch.isfinite(g).all() for g in g_one)


@pytest.mark.parametrize("one_item", [False, True], ids=["one_pass", "one_item_a_pass"])
@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_remat_checkpoints_each_pass(monkeypatch, precision, one_item):
    # The backward renders each pass again: the same bits as one pass
    # without remat, with one pass or with one item a pass.
    plain, g_plain = run(render_fn(precision), False, monkeypatch, True)
    out, g_out = run(render_fn(precision, remat=True), one_item, monkeypatch, True)
    assert_same(out, plain)
    assert_same(g_out, g_plain)


@pytest.mark.parametrize("mode", ["depth", "disparity", "relative_disparity", "log"])
def test_render_depth_one_pass_equals_one_item_a_pass(monkeypatch, mode):
    def fn(inputs):
        return api.render_depth(*(inputs[k] for k in ("extrinsics", "intrinsics", "near", "far")), (SIZE, SIZE),
                                *(inputs[k] for k in ("gaussian_means", "gaussian_covariances", "gaussian_opacities")),
                                mode=mode)

    one, g_one = run(fn, False, monkeypatch, True)
    per, g_per = run(fn, True, monkeypatch, True)
    assert one[0].shape == (B, V, SIZE, SIZE) and torch.isfinite(one[0]).all()
    assert_same(one, per)
    assert_same(g_one, g_per)


def test_render_depth_launches_one_pass(monkeypatch):
    # The plain versions stand in for the kernels: one call of each a pass.
    calls = []
    forward = api.composite_tiled

    def counted(*args, **kwargs):
        calls.append(args[0].radius.shape[:-1])
        return forward(*args, **kwargs)

    monkeypatch.setattr(api, "composite_tiled", counted)
    inputs = scene()
    with torch.no_grad():
        api.render_depth(*(inputs[k] for k in ("extrinsics", "intrinsics", "near", "far")), (SIZE, SIZE),
                         *(inputs[k] for k in ("gaussian_means", "gaussian_covariances", "gaussian_opacities")))
    assert calls == [(B * V,)]


def test_render_orthographic_one_pass_equals_one_item_a_pass(monkeypatch):
    # Two scenes' projections: the covering cap is one read over the pass,
    # the largest rect of either item; every slot is still kept, so the
    # pairs and the image are those of each scene's own cap.
    caps = []
    forward = api.composite_tiled

    def spy(sg, image_shape, background, cap, *args, **kwargs):
        caps.append(cap)
        return forward(sg, image_shape, background, cap, *args, **kwargs)

    monkeypatch.setattr(api, "composite_tiled", spy)

    def fn(inputs):
        ext = inputs["extrinsics"][:, 0].clone()
        ext[:, 2, 3] = -1.5
        width = torch.tensor([2.4, 0.9])
        return api.render_orthographic(
            ext, width, width, torch.zeros(B), torch.full((B,), 3.0), (64, 64), inputs["background_color"],
            inputs["gaussian_means"], inputs["gaussian_covariances"], inputs["gaussian_opacities"],
            inputs["gaussian_color_sh"][..., :1], inputs["gaussian_feature_sh"][..., :1], use_sh=False,
            fov_degrees=10.0)

    one, g_one = run(fn, False, monkeypatch, True)
    one_caps = list(caps)
    per, g_per = run(fn, True, monkeypatch, True)
    assert len(one_caps) == 1 and len(caps) == 1 + B
    assert max(caps[1:]) == one_caps[0] and min(caps[1:]) < one_caps[0]
    assert_same(one, per)
    assert_same(g_one, g_per)


# -- the kernels' plain versions on a pass -------------------------------------


def screen_pass(precision: str = "exact"):
    """Scene 0's 3 views as one pass of screen Gaussians (items first)."""
    s = scene()
    ext, intr = s["extrinsics"][0], s["intrinsics"][0]
    channels = view_channels(s["gaussian_means"][0].expand(V, G, 3), s["gaussian_color_sh"][0],
                             s["gaussian_feature_sh"][0], ext[:, :3, 3])
    return project_gaussians_to_screen(s["gaussian_means"][0].expand(V, G, 3),
                                       s["gaussian_covariances"][0].expand(V, G, 3, 3),
                                       s["gaussian_opacities"][0].expand(V, G), channels, ext, intr, (SIZE, SIZE))


def item(sg, n):
    return type(sg)(**{k: v[n] for k, v in vars(sg).items()})


def test_duplicate_with_keys_on_a_pass_equals_its_items():
    sg = screen_pass()
    counts, base, nx, mask = tile_rects(sg, TILES, TILES)
    gids, keys, pairs = kernels.duplicate_with_keys(counts, mask, base, nx, sg.depth.reshape(-1), TILES, 9, V)
    lo = 0
    for n in range(V):
        i_counts, i_base, i_nx, i_mask = tile_rects(item(sg, n), TILES, TILES)
        i_gids, i_keys, i_pairs = kernels.duplicate_with_keys(i_counts, i_mask, i_base, i_nx, sg.depth[n], TILES, 9)
        hi = lo + int(i_pairs[0])
        assert int(pairs[n]) == hi - lo
        assert torch.equal(gids[lo:hi], i_gids + n * G)
        assert torch.equal(keys[lo:hi], i_keys + ((n * TILES * TILES) << 32))
        lo = hi
    assert lo == gids.shape[0]


@pytest.mark.parametrize("variant", ["exact", "coef", "fast"])
def test_composite_plain_versions_on_a_pass_equal_their_items(variant):
    # composite_forward_reference, block_state, composite_backward_reference
    # and reduce_pairs_reference with N = 3 against 3 one-item calls.
    precision = "exact" if variant == "exact" else "fast"
    knobs = {"exact": {}, "coef": {"coef": True}, "fast": {"f16_xy": True, "bf16_mm": True}}[variant]
    sg = screen_pass(precision)
    code_shift = depth_code_bits(TILES * TILES)[1]
    gids, ranges, order, counts, pairs = tile_pairs(sg, (SIZE, SIZE), 9, precision)
    attrs = quantize_attributes(pack_attributes(sg), precision_knobs(precision), code_shift, V)
    blocks = kernels.block_state(ranges, gids.shape[0], TILES * TILES) if variant == "fast" else None
    out = kernels.composite_forward_reference(gids, ranges, attrs, TILES, (SIZE, SIZE), **knobs, blocks=blocks)
    assert out[0].shape == (V, attrs.shape[1] - 6, SIZE, SIZE) and out[2].shape == (V, SIZE, SIZE)
    rng = np.random.default_rng(1)
    g_out = torch.from_numpy(rng.standard_normal(out[0].shape).astype(np.float32))
    g_t = torch.from_numpy(rng.standard_normal(out[1].shape).astype(np.float32))
    backward = variant != "coef"
    if backward:
        bwd = {"exact": {}, "fast": {"f16_xy": True, "bf16_mm": True, "bf16_grads": True}}[variant]
        rows = kernels.composite_backward_reference(gids, ranges, order, attrs, TILES, (SIZE, SIZE), out[2], out[1],
                                                    g_out, g_t, **bwd, blocks=blocks)
        summed = kernels.reduce_pairs_reference(rows, torch.cumsum(counts, 0, dtype=torch.int64))
    lo = 0
    for n in range(V):
        i_sg = item(sg, n)
        i_gids, i_ranges, i_order, i_counts, _ = tile_pairs(i_sg, (SIZE, SIZE), 9, precision)
        i_attrs = quantize_attributes(pack_attributes(i_sg), precision_knobs(precision), code_shift)
        assert torch.equal(i_attrs, attrs[n * G : (n + 1) * G])
        hi = lo + i_gids.shape[0]
        i_blocks = kernels.block_state(i_ranges, i_gids.shape[0], TILES * TILES) if variant == "fast" else None
        i_out = kernels.composite_forward_reference(i_gids, i_ranges, i_attrs, TILES, (SIZE, SIZE), **knobs,
                                                    blocks=i_blocks)
        assert torch.equal(i_out[0][0], out[0][n]) and torch.equal(i_out[1][0], out[1][n])
        assert torch.equal(i_out[2][0], out[2][n] - lo)
        if backward:
            i_rows = kernels.composite_backward_reference(
                i_gids, i_ranges, i_order, i_attrs, TILES, (SIZE, SIZE), i_out[2], i_out[1], g_out[n : n + 1],
                g_t[n : n + 1], **bwd, blocks=i_blocks)
            assert torch.equal(i_rows[i_order], rows[order][lo:hi])
            i_summed = kernels.reduce_pairs_reference(i_rows, torch.cumsum(i_counts, 0, dtype=torch.int64))
            assert torch.equal(i_summed, summed[n * G : (n + 1) * G])
        lo = hi
    assert pairs.tolist() == [int(x) for x in pairs] and lo == gids.shape[0]


def test_block_state_counts_scan_blocks_from_each_item():
    # Item 1's pairs start mid-block of the pass's array; its tiles' state
    # rows follow item 0's, and their count is that of item 1 alone.
    ranges = torch.tensor([0, 100, 300, 340, 700, 700, 900], dtype=torch.int32)     # 2 items x 3 tiles
    offsets, state = kernels.block_state(ranges, 900, 3)
    first = kernels.block_state(ranges[:4], 340, 3)[0]
    second = kernels.block_state(ranges[3:] - 340, 560, 3)[0]
    assert torch.equal(offsets[:3], first)
    assert torch.equal(offsets[3:] - offsets[3], second)
    assert state.shape == (900 // kernels.SCAN_BLOCK + 2 * 6, kernels.PIX, 2)


@pytest.mark.parametrize("variant", ["exact", "coef", "fast", "bf16_mm"])
def test_longest_first_stepping_equals_full_width_stepping(monkeypatch, variant):
    # The plain versions step a pass's tiles longest first and touch only
    # those that still have pairs (`_longest_first`); stepping every tile
    # in tile order at every step, the straightforward way, gives the same
    # bits: forward outputs, block state and backward rows.
    precision = "exact" if variant in ("exact", "bf16_mm") else "fast"
    knobs = {"exact": {}, "coef": {"coef": True}, "fast": {"f16_xy": True, "bf16_mm": True},
             "bf16_mm": {"bf16_mm": True}}[variant]
    sg = screen_pass(precision)
    gids, ranges, order, _, _ = tile_pairs(sg, (SIZE, SIZE), 9, precision)
    attrs = quantize_attributes(pack_attributes(sg), precision_knobs(precision), depth_code_bits(TILES * TILES)[1], V)
    lengths = ranges[1:].long() - ranges[:-1].long()
    assert 0 < kernels._longest_first(lengths)[1][-1] < lengths.numel() // 2
    rng = np.random.default_rng(2)
    g_out = torch.from_numpy(rng.standard_normal((V, attrs.shape[1] - 6, SIZE, SIZE)).astype(np.float32))
    g_t = torch.from_numpy(rng.standard_normal((V, SIZE, SIZE)).astype(np.float32))

    def composite():
        blocks = kernels.block_state(ranges, gids.shape[0], TILES * TILES) if "bf16_mm" in knobs else None
        if blocks is not None:
            blocks[1].zero_()
        out = kernels.composite_forward_reference(gids, ranges, attrs, TILES, (SIZE, SIZE), **knobs, blocks=blocks)
        if variant == "coef":
            return [*out]
        bwd = dict(knobs, bf16_grads=variant == "fast")
        rows = kernels.composite_backward_reference(gids, ranges, order, attrs, TILES, (SIZE, SIZE), out[2], out[1],
                                                    g_out, g_t, **bwd, blocks=blocks)
        return [*out, rows] + ([blocks[1]] if blocks is not None else [])

    longest_first = composite()

    def full_width(lengths):
        return torch.arange(lengths.numel()), [lengths.numel()] * (int(lengths.max()) if lengths.numel() else 0)

    monkeypatch.setattr(kernels, "_longest_first", full_width)
    assert_same(longest_first, composite())
