"""The model's remaining switches, module by module, against the JAX package
on the CPU: the VAE encoder (`AutoencoderKL.encode`) at a narrow width and
at kl_f8's four-block layout, carried over inside the whole generator tree;
the ViT and ensemble backbones; the `variational: latents` render (mean and
logvar packed into 12 composited channels) tiled against dense and against
the JAX decoder; the switch values that parse and those that raise; and a
resume from a checkpoint without the VAE encoder. The switches inside the
train step are in tests/test_torch_switches_step.py, `encode_latents` in
tests/test_torch_switches_latents.py.
"""

import dataclasses
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from latentsplat_tpu.model.decoder.splatting import DecoderSplatting as JDecoderSplatting
from latentsplat_tpu.model.decoder.splatting import DecoderSplattingCfg as JDecoderSplattingCfg
from latentsplat_tpu.model.encoder import backbone as jbackbone
from latentsplat_tpu.model.latentsplat import LatentSplat as JLatentSplat
from latentsplat_tpu.model.types import VariationalGaussians as JVariationalGaussians
from latentsplat_tpu.ops.distributions import DiagonalGaussian as JDiagonalGaussian
from latentsplat_tpu_torch import config as tconfig
from latentsplat_tpu_torch import weights
from latentsplat_tpu_torch.model.decoder.splatting import DecoderSplatting, DecoderSplattingCfg
from latentsplat_tpu_torch.model.encoder.backbone import BackboneCfg, get_backbone
from latentsplat_tpu_torch.model.latentsplat import LatentSplat
from latentsplat_tpu_torch.model.types import VariationalGaussians
from latentsplat_tpu_torch.ops.distributions import DiagonalGaussian
from latentsplat_tpu_torch.training import step as tstep
from latentsplat_tpu_torch.training.checkpointing import save_checkpoint
from latentsplat_tpu_torch.training.trainer import Trainer
from latentsplat_tpu_torch.weights import params_from_jax

from tests.test_torch_rasterize import INTRINSICS, make_scene
from tests.test_torch_step import make_views, random_leaves
from tests.test_torch_trainer import GAN
from tests.test_train_step_quick import _full_cfgs
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

SIZE = 32


def assert_close_to_scale(ours, theirs, tol, msg=""):
    """|ours - theirs| <= tol * max|theirs| everywhere."""
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    theirs = np.asarray(theirs)
    assert ours.shape == theirs.shape, (ours.shape, theirs.shape, msg)
    scale = np.abs(theirs).max()
    err = np.abs(ours - theirs).max()
    assert err <= tol * scale, (msg, err, scale)


# -- the VAE encoder -----------------------------------------------------------------


@pytest.mark.parametrize("layout", ["narrow", "kl_f8"])
def test_vae_encode_matches_jax(layout):
    # The whole JAX generator tree, VAE encoder and quant_conv included,
    # carries into the port with nothing dropped (weights.UNPORTED is empty),
    # and both packages encode the same images to the same posterior:
    # float32 rounding of the same convolutions, 1e-5 of each moment's
    # largest value.
    model_cfg, _ = _full_cfgs()
    if layout == "kl_f8":
        model_cfg = dataclasses.replace(model_cfg, autoencoder=dataclasses.replace(
            model_cfg.autoencoder, block_out_channels=[16, 32, 64, 64], layers_per_block=2, latent_channels=4,
        ), supersampling_factor=8)
    rng = np.random.default_rng(11)
    batch = {"context": make_views(rng, 2), "target": make_views(rng, 2)}
    jmodel = JLatentSplat(model_cfg, (0.0, 0.0, 0.0))
    jbatch = jax.tree_util.tree_map(jnp.asarray, batch)
    params = random_leaves(jax.eval_shape(lambda: jmodel.init_params(jax.random.PRNGKey(0), jbatch)), rng)
    assert weights.UNPORTED == ()
    model = LatentSplat(tconfig.from_dict(tconfig.ModelCfg, dataclasses.asdict(model_cfg)))
    model.load_state_dict(params_from_jax(params["generator"], model), strict=True)
    assert any(n.startswith("autoencoder.encoder.down_0_downsample") for n, _ in model.named_parameters())

    images = batch["target"]["image"]
    theirs = jmodel.ae_encode(params["generator"], jnp.asarray(images))
    with torch.no_grad():
        ours = model.autoencoder.encode(torch.from_numpy(images))
    downscale = 2 ** (len(model_cfg.autoencoder.block_out_channels) - 1)
    assert tuple(ours.mean.shape) == (1, 2, SIZE // downscale, SIZE // downscale, model_cfg.autoencoder.latent_channels)
    assert_close_to_scale(ours.mean, theirs.mean, 1e-5, "mean")
    assert_close_to_scale(ours.logvar, theirs.logvar, 1e-5, "logvar")


# -- the ViT and ensemble backbones ---------------------------------------------------


BACKBONES = {
    "vit": (jbackbone.BackboneVitCfg(model="dino_vits8"), {"name": "vit", "model": "dino_vits8"}),
    "vit_repeat": (jbackbone.BackboneVitCfg(model="dino_vits8", upscale_mode="repeat"),
                   {"name": "vit", "model": "dino_vits8", "upscale_mode": "repeat"}),
    "ensemble": (
        jbackbone.BackboneEnsembleCfg(components=[
            jbackbone.BackboneDinoCfg(model="dino_vits8"), jbackbone.BackboneResnetCfg(model="resnet18", num_layers=2),
        ]),
        [{"name": "dino", "model": "dino_vits8"}, {"name": "resnet", "model": "resnet18", "num_layers": 2}],
    ),
}


@pytest.mark.parametrize("name", sorted(BACKBONES))
def test_backbone_matches_jax(name):
    # Random JAX leaves mapped with params_from_jax (the trunk is `vit`, the
    # MLPs 768 wide; an ensemble's members are component_i, and a list of
    # configs is an ensemble); 12 transformer layers in float32: 1e-4 of the
    # output's largest value.
    jcfg, raw = BACKBONES[name]
    d_out, scale = 16, Fraction(1, 1)
    jmodule = jbackbone.get_backbone(jcfg, 3, d_out, scale)
    x = np.random.default_rng(5).uniform(0, 1, (2, SIZE, SIZE, 3)).astype(np.float32)
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    params = random_leaves(shapes, np.random.default_rng(6))
    theirs = jmodule.apply({"params": params}, jnp.asarray(x))

    module = get_backbone(tconfig.from_dict(BackboneCfg, raw), 3, d_out, scale)
    module.load_state_dict(params_from_jax(params, module), strict=True)
    if name.startswith("vit"):
        assert module.Dense_0.out_features == 768 and hasattr(module, "vit")
    with torch.no_grad():
        ours = module(torch.from_numpy(x))
    assert tuple(ours.shape) == (2, SIZE, SIZE, d_out)
    assert_close_to_scale(ours, theirs, 1e-4, name)


def test_backbone_configs_parse_like_jax():
    from latentsplat_tpu.config import load_config as jax_load_config

    vit = "model.encoder.backbone={name: vit, model: dino_vits8}"
    ensemble = ("model.encoder.backbone={name: ensemble, components: [{name: dino, model: dino_vits8}, "
                "{name: resnet, model: resnet18}]}")
    for override in (vit, ensemble):
        ours = tconfig.load_config("re10k", [override]).model.encoder.backbone
        theirs = jax_load_config("re10k", [override]).model.encoder.backbone
        assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    as_list = tconfig.load_config(
        "re10k", ["model.encoder.backbone=[{name: dino, model: dino_vits8}, {name: resnet, model: resnet18}]"]
    ).model.encoder.backbone
    assert [type(c).__name__ for c in as_list] == ["BackboneDinoCfg", "BackboneResnetCfg"]
    assert type(get_backbone(as_list, 3, 8, Fraction(1, 1))).__name__ == "BackboneEnsemble"


# -- variational: latents -----------------------------------------------------------------


def latent_gaussians(seed, n=600, c=4):
    """VariationalGaussians (port and JAX) over numpy values, one scene:
    DC color SH and a feature posterior whose logvars span [-4, 1]."""
    means, covs, opacities, _ = make_scene(seed, n)
    rng = np.random.default_rng(seed + 1)
    color = rng.uniform(-0.5, 0.5, (1, n, 3, 1)).astype(np.float32)
    mean = rng.uniform(-0.5, 0.5, (1, n, c, 1)).astype(np.float32)
    logvar = rng.uniform(-4.0, 1.0, (1, n, c, 1)).astype(np.float32)
    arrays = (means[None], covs[None], opacities[None], color)
    ours = VariationalGaussians(*map(torch.from_numpy, arrays),
                                DiagonalGaussian(torch.from_numpy(mean), torch.from_numpy(logvar)))
    theirs = JVariationalGaussians(*map(jnp.asarray, arrays), JDiagonalGaussian(jnp.asarray(mean), jnp.asarray(logvar)))
    return ours, theirs


def test_latents_render_twelve_channels_tiled_dense_and_jax():
    # flatten() packs mean and logvar along the channel axis (8 feature
    # channels), so with color and the expected depth the compositor runs
    # at 12 channels, rows of 18. The decoder reads the rendered channels
    # back as the posterior's mean and logvar. Tiled (plain kernel
    # versions) against dense within 2e-4, the render tolerance of
    # tests/test_torch_rasterize.py; the dense render against the JAX
    # decoder's within 1e-5.
    ours, theirs = latent_gaussians(3)
    flat = ours.flatten()
    assert tuple(flat.feature_harmonics.shape) == (1, 600, 8, 1)
    np.testing.assert_array_equal(flat.feature_harmonics.numpy(), np.asarray(theirs.flatten().feature_harmonics))
    ext = torch.eye(4)[None, None].repeat(1, 2, 1, 1)
    ext[0, 1, 0, 3] = 0.1
    intr = torch.from_numpy(INTRINSICS)[None, None].repeat(1, 2, 1, 1)
    near, far = torch.full((1, 2), 1.0), torch.full((1, 2), 100.0)
    cams = (ext, intr, near, far, (SIZE, SIZE))

    calls = []
    from latentsplat_tpu_torch.ops.rasterize import tiled

    forward = tiled.composite_forward

    def counted(gids, ranges, attrs, *args, **kwargs):
        calls.append(attrs.shape[1])
        return forward(gids, ranges, attrs, *args, **kwargs)

    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tiled, "composite_forward", counted)
        for backend in ("tiled", "dense"):
            decoder = DecoderSplatting(DecoderSplattingCfg(backend=backend), variational=True)
            out[backend] = decoder(flat, *cams)
    assert calls == [18]            # both views in one pass
    jdecoder = JDecoderSplatting(JDecoderSplattingCfg(backend="dense"), variational=True)
    jout = jdecoder(theirs.flatten(), *(jnp.asarray(x.numpy()) for x in cams[:4]), (SIZE, SIZE))
    for key in ("mean", "logvar"):
        dense = getattr(out["dense"].feature_posterior, key)
        tiled_value = getattr(out["tiled"].feature_posterior, key)
        assert tuple(dense.shape) == (1, 2, SIZE, SIZE, 4)
        np.testing.assert_allclose(tiled_value.numpy(), dense.numpy(), atol=2e-4, err_msg=key)
        np.testing.assert_allclose(dense.numpy(), np.asarray(getattr(jout.feature_posterior, key)), atol=1e-5,
                                   err_msg=key)
    np.testing.assert_allclose(out["tiled"].color.numpy(), out["dense"].color.numpy(), atol=2e-4)
    np.testing.assert_allclose(out["dense"].color.numpy(), np.asarray(jout.color), atol=1e-5)


# -- switch values ----------------------------------------------------------------------------


class Cfg:
    def __init__(self, remat_policy="nothing", compute_dtype="float32"):
        self.remat_policy = remat_policy
        self.compute_dtype = compute_dtype


@pytest.mark.parametrize("policy, modes", [
    ("nothing", ("full", "full", "full")),
    ("dots", ("dots", "dots", "dots")),
    ("vae:off,lpips:dots", ("full", "off", "dots")),
    ("encoder:dots", ("dots", "full", "full")),
])
def test_remat_policy_parses_like_jax(policy, modes):
    # The JAX _remat's reading: a global value, or per site, where an
    # unnamed site recomputes fully.
    assert tuple(tstep.remat_mode(Cfg(policy), site) for site in ("encoder", "vae", "lpips")) == modes


@pytest.mark.parametrize("policy, sites", [
    ("float32", ()),
    ("bfloat16", ("encoder", "vae", "lpips", "disc")),
    ("vae:bfloat16,disc:bfloat16", ("vae", "disc")),
])
def test_compute_dtype_parses_like_jax(policy, sites):
    assert tuple(s for s in tstep.MIXED_SITES if tstep.mixed_site(Cfg(compute_dtype=policy), s)) == sites


@pytest.mark.parametrize("switch, value", [
    ("remat_policy", "everything"), ("remat_policy", "vae:sometimes"), ("remat_policy", "decoder:full"),
    ("compute_dtype", "float16"), ("compute_dtype", "vae:float16"), ("compute_dtype", "rasterizer:bfloat16"),
])
def test_switch_values_that_do_not_parse_raise_naming_the_switch(switch, value):
    with pytest.raises(ValueError, match=f"model.{switch}"):
        tstep.check_switches(Cfg(**{switch: value}))


# -- a checkpoint written before the VAE encoder was ported --------------------------------


def test_resume_from_a_checkpoint_without_the_vae_encoder(tmp_path, capsys):
    # It loads: the VAE encoder keeps its seeded weights and its Adam
    # moments start at zero; everything the checkpoint holds is restored.
    cfg = tconfig.load_config(None, GAN + [f"output_dir={tmp_path}"])
    state = Trainer(cfg, tmp_path / "a", device="cpu").init_state()
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(0.25)
    path = save_checkpoint(state, tmp_path / "ckpt", 9)
    saved = torch.load(path, weights_only=True)
    old = ("autoencoder.encoder.", "autoencoder.quant_conv.")
    dropped = [k for k in saved["generator"] if k.startswith(old)]
    assert dropped
    saved["generator"] = {k: v for k, v in saved["generator"].items() if not k.startswith(old)}
    for key in ("mu", "nu"):
        saved["opt_gen"]["autoencoder"][key] = {
            k: v for k, v in saved["opt_gen"]["autoencoder"][key].items() if not k.startswith(old)}
    torch.save(saved, path)

    trainer = Trainer(
        tconfig.load_config(None, GAN + [f"checkpointing.load={path}", "checkpointing.resume=true"]),
        tmp_path / "b", device="cpu",
    )
    fresh = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    restored = trainer.init_state()
    assert trainer.step == 9
    assert "no VAE encoder" in capsys.readouterr().out
    after = restored.model.state_dict()
    for key in dropped:
        assert torch.equal(after[key], fresh[key]), key
    for key, value in saved["generator"].items():
        assert torch.equal(after[key], value), key
    moments = restored.opt_gen.state["autoencoder"]["mu"]
    assert all(not moments[k].any() for k in dropped)
    # Test mode renders with the checkpoint's generator weights the same way.
    assert trainer._generator(saved["generator"]) is trainer.model
    # A checkpoint that lacks any other generator key still refuses to load.
    saved["generator"].pop("encoder.to_gaussians.bias")
    torch.save(saved, path)
    with pytest.raises(RuntimeError, match="to_gaussians.bias"):
        Trainer(
            tconfig.load_config(None, GAN + [f"checkpointing.load={path}", "checkpointing.resume=true"]),
            tmp_path / "c", device="cpu",
        ).init_state()
