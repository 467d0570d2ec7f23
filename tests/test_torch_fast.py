"""The port's fast rasterizer precisions (`model.decoder.precision` "fast",
"fast_nocoef" and the diagnostic precisions) against the JAX package's, on
the CPU.

Each precision's forward through the port's plain kernel versions against
the JAX `composite_tiled` (its Pallas kernels in interpret mode, channels
unpacked as the port keeps them: pack_channels=False); the discriminating
check that the port's fast render lies much nearer JAX's fast render than
JAX's exact render does; gradients at "fast", "fast_nocoef" and
"exact_bf16_grads"; a tiny model's fast forward and generator gradient
against the JAX model's, weights carried across by `params_from_jax`; and
the refusals. Scenes: tests/test_torch_rasterize.py's, 96 Gaussians at
32x32 (64 for the gradients).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsplat_tpu.model.decoder.splatting import DecoderSplattingCfg as JDecoderSplattingCfg
from latentsplat_tpu.model.latentsplat import LatentSplat as JLatentSplat
from latentsplat_tpu.ops.rasterize import tiled as j_tiled
from latentsplat_tpu_torch import config as tconfig
from latentsplat_tpu_torch.model.decoder.splatting import DecoderSplatting, DecoderSplattingCfg
from latentsplat_tpu_torch.model.latentsplat import LatentSplat
from latentsplat_tpu_torch.ops.rasterize.tiled import (
    DIAGNOSTIC_PRECISIONS,
    PRECISIONS,
    composite_tiled,
    depth_code_bits,
    precision_knobs,
)
from latentsplat_tpu_torch.weights import params_from_jax

from tests.test_torch_rasterize import H, make_scene, project_both
from tests.test_torch_step import SIZE, make_views, random_leaves
from tests.test_torch_switches_step import model_cfg
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

FIELDS = ("mean2d", "conic", "opacity", "channels", "depth")
# Port against JAX at the same precision: every rounding is reproduced, so
# what is left is float32 rounding in another order (log space on the JAX
# side, the channel and scan sums) and the coefficient layout's alpha:
# measured 1.2e-7 on the channels, 6.7e-6 on the mask, 9.5e-7 on depths up
# to ~6.
CHANNEL_ATOL, MASK_ATOL, DEPTH_ATOL = 2e-5, 2e-5, 1e-5


@pytest.fixture(scope="module")
def scene():
    j_sg, t_sg = project_both(make_scene(23, 96))
    return j_sg, t_sg, np.zeros(4, np.float32)


@pytest.fixture(scope="module")
def renders(scene):
    """Each precision's (channels, mask, depth) from both packages."""
    j_sg, t_sg, bg = scene
    out = {}
    for precision in PRECISIONS:
        theirs = j_tiled.composite_tiled(j_sg, (H, H), jnp.asarray(bg), pack_channels=False, precision=precision)
        ours = composite_tiled(t_sg, (H, H), torch.from_numpy(bg), precision=precision)
        out[precision] = ([np.asarray(x) for x in theirs], [x.numpy() for x in ours[:3]])
    return out


def test_precision_names_are_the_jax_package_s():
    assert DIAGNOSTIC_PRECISIONS == j_tiled.DIAGNOSTIC_PRECISIONS
    assert PRECISIONS == ("exact", "fast", *j_tiled.DIAGNOSTIC_PRECISIONS)
    for precision in PRECISIONS:
        DecoderSplatting(DecoderSplattingCfg(precision=precision))
        knobs = precision_knobs(precision)
        # The JAX package's own switches, knob by knob.
        assert knobs.wide_cull == (j_tiled._cull_margin(precision) == 6e-2)
        assert knobs.bf16_mm == j_tiled._kernel_fast(precision)
        assert knobs.coef == (precision == "fast")
        on = [f.name for f in dataclasses.fields(knobs) if getattr(knobs, f.name)]
        assert len(on) == {"exact": 0, "fast": 10, "fast_nocoef": 9}.get(precision, 1), (precision, on)
    with pytest.raises(ValueError, match="precision"):
        DecoderSplatting(DecoderSplattingCfg(precision="half"))


@pytest.mark.parametrize("precision", PRECISIONS)
def test_forward_matches_jax(renders, precision):
    (j_img, j_mask, j_depth), (img, mask, depth) = renders[precision]
    np.testing.assert_allclose(img, j_img, atol=CHANNEL_ATOL, rtol=0)
    np.testing.assert_allclose(mask, j_mask, atol=MASK_ATOL, rtol=0)
    np.testing.assert_allclose(depth, j_depth, atol=DEPTH_ATOL, rtol=0)


@pytest.mark.parametrize("precision", ["fast", "exact_bf16_mm"])
def test_port_is_nearer_jax_fast_than_jax_exact_is(renders, precision):
    # A port that composited in float32 would land about as far from JAX's
    # fast render as from its exact one: the bf16 scan and channel terms are
    # most of fast's gap (on this scene 2.9e-4 of its 4.3e-4, on average).
    (j_img, *_), (img, *_) = renders[precision]
    j_exact = renders["exact"][0][0]
    gap = np.abs(j_img - j_exact).mean()
    assert gap > 1e-4
    assert np.abs(img - j_img).mean() <= 0.1 * gap


def test_knobs_that_change_no_color(renders):
    # The cull margin, the depth order and the SH knob (applied by
    # api.render, not here) leave composite_tiled's channels as exact's;
    # the depth value only the depth.
    exact = renders["exact"][1]
    for precision in ("exact_wide_cull", "exact_tie_depth", "exact_bf16_sh", "exact_bf16_grads", "exact_depth_val"):
        ours = renders[precision][1]
        np.testing.assert_allclose(ours[0], exact[0], atol=1e-6, rtol=0, err_msg=precision)
        if precision != "exact_depth_val":
            np.testing.assert_array_equal(ours[2], exact[2], err_msg=precision)
    assert np.abs(renders["exact_depth_val"][1][2] - exact[2]).max() > 0


def loss_weights(shape):
    return np.random.default_rng(5).standard_normal(shape).astype(np.float32)


def jax_gradients(j_sg, precision):
    w = loss_weights((4, H, H))

    def loss(*leaves):
        sg = j_sg.replace(**dict(zip(FIELDS, leaves)))
        img, mask, depth = j_tiled.composite_tiled(sg, (H, H), jnp.zeros(4), pack_channels=False, precision=precision)
        return jnp.sum(img * w) + jnp.sum(mask**2) + 0.1 * jnp.sum(depth)

    return [np.asarray(g) for g in jax.grad(loss, argnums=tuple(range(5)))(*[getattr(j_sg, f) for f in FIELDS])]


def port_gradients(t_sg, precision):
    leaves = [getattr(t_sg, f).clone().requires_grad_(True) for f in FIELDS]
    sg = dataclasses.replace(t_sg, **dict(zip(FIELDS, leaves)))
    img, mask, depth, _ = composite_tiled(sg, (H, H), torch.zeros(4), precision=precision)
    (torch.sum(img * torch.from_numpy(loss_weights((4, H, H)))) + torch.sum(mask**2) + 0.1 * depth.sum()).backward()
    return [leaf.grad.numpy() for leaf in leaves]


@pytest.mark.parametrize("precision", ["fast", "exact_bf16_grads"])
def test_gradients_match_jax(precision):
    # Each element within 1e-4 of its leaf's largest gradient, or one
    # bfloat16 step (at most 2^-7 of the value): the pair rows are rounded
    # to bfloat16, and a float32 row sum taken in another order may round
    # the other way. fast_nocoef shares fast's backward (bit-identical in
    # the JAX package, tests/test_rasterize.py) and must give the same bits.
    j_sg, t_sg = project_both(make_scene(24, 64))
    theirs = jax_gradients(j_sg, precision)
    ours = port_gradients(t_sg, precision)
    for name, a, b in zip(FIELDS, ours, theirs):
        bound = 1e-4 * np.abs(b).max() + 2.0**-7 * np.abs(b)
        assert (np.abs(a - b) <= bound).all(), (name, np.abs(a - b).max(), np.abs(b).max())
    if precision == "fast":
        for a, b in zip(port_gradients(t_sg, "fast_nocoef"), ours):
            np.testing.assert_array_equal(a, b)


def test_depth_code_refusal():
    # Both packages refuse a fast render whose tile count leaves fewer than
    # 16 depth-code bits (32,766 tiles and more); the code widths agree.
    for tiles in (1, 4, 256, 4096, 32765, 32766, 1 << 20):
        assert depth_code_bits(tiles) == j_tiled._depth_code_bits(tiles)
    j_sg, t_sg = project_both(make_scene(3, 4))
    wide = (16, 16 * 32768)
    with pytest.raises(AssertionError, match="depth code"):
        j_tiled.composite_tiled(j_sg, wide, jnp.zeros(4), precision="fast")
    for precision in ("fast", "fast_nocoef"):
        with pytest.raises(ValueError, match="depth code"):
            composite_tiled(t_sg, wide, torch.zeros(4), precision=precision)


# -- a tiny model ----------------------------------------------------------------


@pytest.fixture(scope="module")
def tiny():
    """tests/test_torch_switches_step.py's tiny model with the tiled fast
    decoder, JAX weights drawn from numpy and carried across; a batch of 2
    context views and 1 target view at 32x32; loss weights."""
    jcfg = model_cfg(decoder=JDecoderSplattingCfg(backend="tiled", precision="fast"))
    rng = np.random.default_rng(7)
    batch = {"context": make_views(rng, 2), "target": make_views(rng, 1)}
    jmodel = JLatentSplat(jcfg, (0.0, 0.0, 0.0))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    params = random_leaves(jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), jbatch)), rng)
    model = LatentSplat(tconfig.from_dict(tconfig.ModelCfg, dataclasses.asdict(jcfg)))
    model.load_state_dict(params_from_jax(params["generator"], model), strict=True)
    size = model.scaled_size(model.scale_factor, (SIZE, SIZE))
    weights = (rng.standard_normal((1, 1, *size, 3)).astype(np.float32),
               rng.standard_normal((1, 1, *size, model.autoencoder.d_latent)).astype(np.float32))
    return {"jcfg": jcfg, "jmodel": jmodel, "jbatch": jbatch, "params": params, "model": model, "batch": batch,
            "size": size, "weights": weights}


def jax_render(tiny, jmodel, params_gen):
    gaussians = jmodel.apply_encoder(params_gen, tiny["jbatch"]["context"], 0, None, deterministic=True).mode()
    t = tiny["jbatch"]["target"]
    out = jmodel.decoder(gaussians, t["extrinsics"], t["intrinsics"], t["near"], t["far"], tiny["size"])
    wc, wf = tiny["weights"]
    return jnp.sum(out.color * wc) + jnp.sum(out.feature_posterior.mean * wf) + jnp.sum(out.mask), out


def test_tiny_model_fast_forward_and_gradient(tiny):
    # The encoder's float32 rounding (convolutions in other orders) reaches
    # the render, and now and then a bfloat16 term rounds the other way:
    # measured 1.6e-4 at most on the colors, 2.4e-6 on average (JAX's own
    # fast render lies 2.0e-4 on average from its exact one, whose channels
    # the JAX decoder packs in bfloat16 by default). Gradients: each leaf
    # within 1e-3 of its largest value (measured 8.7e-5).
    model, (wc, wf) = tiny["model"], tiny["weights"]
    (j_loss, j_out), j_grads = jax.jit(jax.value_and_grad(
        lambda p: jax_render(tiny, tiny["jmodel"], p), has_aux=True))(tiny["params"]["generator"])

    batch = {k: {n: torch.from_numpy(a) for n, a in v.items()} for k, v in tiny["batch"].items()}
    assert model.decoder.cfg.precision == "fast"
    gaussians = model.encoder(batch["context"], 0, deterministic=True).mode()
    t = batch["target"]
    out = model.decoder(gaussians, t["extrinsics"], t["intrinsics"], t["near"], t["far"], tiny["size"])
    loss = ((out.color * torch.from_numpy(wc)).sum() + (out.feature_posterior.mean * torch.from_numpy(wf)).sum()
            + out.mask.sum())
    loss.backward()

    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=1e-5)
    for name, atol in (("color", 1e-3), ("mask", 1e-4), ("depth", 2e-3)):
        ours, theirs = getattr(out, name).detach().numpy(), np.asarray(getattr(j_out, name))
        np.testing.assert_allclose(ours, theirs, atol=atol, rtol=0, err_msg=name)
    ours, theirs = out.color.detach().numpy(), np.asarray(j_out.color)
    assert np.abs(ours - theirs).mean() <= 2e-5
    grads = params_from_jax(j_grads, model)
    named = [(n, p) for n, p in model.named_parameters() if p.grad is not None]
    assert len(named) > 10
    for name, p in named:
        theirs = grads[name].numpy()
        assert np.abs(p.grad.numpy() - theirs).max() <= 1e-3 * np.abs(theirs).max(), name
