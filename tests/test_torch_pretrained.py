"""The port's converters of released reference weights against the JAX
package's: each seeded reference-layout state dict goes (a) through the
JAX converter and `weights.params_from_jax`, and (b) through the port's
converter; both must give the same port state dict, bit for bit. A port
module carrying converted weights is held against its reference-layout
torch mirror (tests/test_pretrained.py) within 1e-5. The convert_checkpoint
command is held against the JAX command and served by `main` in test mode.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import latentsplat_tpu.training.pretrained as jax_pretrained
from latentsplat_tpu_torch.config import load_config
from latentsplat_tpu_torch.entry import SMALL_OVERRIDES, like_trained
from latentsplat_tpu_torch.evaluation.metrics import DISTSNet
from latentsplat_tpu_torch.loss.lpips import LPIPS
from latentsplat_tpu_torch.model.autoencoder.kl import AttnBlock, AutoencoderKL, AutoencoderKLCfg, ResnetBlock
from latentsplat_tpu_torch.model.discriminator.patch_gan import DiscriminatorPatchGan
from latentsplat_tpu_torch.model.encoder.backbone import DinoViT, ViTBlock
from latentsplat_tpu_torch.model.latentsplat import LatentSplat
from latentsplat_tpu_torch.training import pretrained
from latentsplat_tpu_torch.training.pretrained import reference_state_dict
from latentsplat_tpu_torch.weights import params_from_jax

from tests.test_pretrained import (
    TorchAttn,
    TorchDinoBlock,
    TorchDISTS,
    TorchMiniDino,
    TorchResnet,
    TorchTinyVAE,
    _torch_like_encoder_sd,
    make_torch_patchgan,
)
from tests.test_torch_data import TINY
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

ATOL = 1e-5


def assert_same_state(ours, theirs):
    """Same keys, same bits."""
    assert set(ours) == set(theirs), set(ours) ^ set(theirs)
    for key in theirs:
        assert ours[key].dtype == theirs[key].dtype == torch.float32, key
        assert torch.equal(ours[key].contiguous(), theirs[key]), key


def both_routes(sd, jax_convert, port_convert, module):
    """(port converter output, JAX converter output through params_from_jax)."""
    ours = {k: v.float() for k, v in port_convert({k: torch.as_tensor(v) for k, v in sd.items()}).items()}
    theirs = params_from_jax(jax_convert({k: np.asarray(v) for k, v in sd.items()}), module)
    assert_same_state(ours, theirs)
    return ours


def loaded(module, converted):
    return pretrained.load_into(module, converted)


# -- the VAE ----------------------------------------------------------------------


def test_resnet_block():
    torch.manual_seed(0)
    mirror = TorchResnet(8, 16).eval()
    sd = {f"r.{k}": v for k, v in mirror.state_dict().items()}
    ours = ResnetBlock(8, 16)
    converted = both_routes(sd, lambda s: jax_pretrained._resnet(s, "r"), lambda s: pretrained._resnet(s, "r"), ours)
    x = torch.randn(2, 8, 6, 6)
    with torch.no_grad():
        np.testing.assert_allclose(loaded(ours, converted)(x).numpy(), mirror(x).numpy(), atol=ATOL)


@pytest.mark.parametrize("legacy_names", [False, True])
def test_attention_block(legacy_names):
    # Diffusers' current Linear names, or its legacy 1x1-conv names.
    torch.manual_seed(1)
    mirror = TorchAttn(8).eval()
    sd = {f"a.{k}": v for k, v in mirror.state_dict().items()}
    if legacy_names:
        rename = {"to_q": "query", "to_k": "key", "to_v": "value", "to_out.0": "proj_attn"}
        sd = {
            ".".join(["a", rename[k[2:].rsplit(".", 1)[0]], k.rsplit(".", 1)[1]]) if k[2:].rsplit(".", 1)[0] in rename
            else k: (v[:, :, None, None] if v.dim() == 2 else v)
            for k, v in sd.items()
        }
        assert "a.query.weight" in sd and sd["a.query.weight"].dim() == 4
    ours = AttnBlock(8)
    converted = both_routes(sd, lambda s: jax_pretrained._attn(s, "a"), lambda s: pretrained._attn(s, "a"), ours)
    x = torch.randn(1, 8, 4, 4)
    with torch.no_grad():
        np.testing.assert_allclose(loaded(ours, converted)(x).numpy(), mirror(x).numpy(), atol=ATOL)


def test_autoencoder_kl():
    torch.manual_seed(2)
    mirror = TorchTinyVAE().eval()
    cfg = AutoencoderKLCfg(block_out_channels=[8, 16], layers_per_block=1, latent_channels=4)
    ours = AutoencoderKL(cfg, d_in=3, d_skip_extra=0)
    converted = both_routes(
        mirror.state_dict(),
        lambda s: jax_pretrained.convert_autoencoder_kl(s, num_blocks=2, layers_per_block=1),
        lambda s: pretrained.convert_autoencoder_kl(s, num_blocks=2, layers_per_block=1),
        ours,
    )
    loaded(ours, converted)
    image = torch.rand(1, 3, 16, 16)
    z = torch.randn(1, 4, 8, 8)
    with torch.no_grad():
        posterior = ours.encode(image.permute(0, 2, 3, 1))
        moments = torch.cat([posterior.mean, posterior.logvar], dim=-1).permute(0, 3, 1, 2)
        np.testing.assert_allclose(moments.numpy(), mirror.encode_moments(2 * image - 1).numpy(), atol=ATOL)
        decoded = ours.decode(z.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        np.testing.assert_allclose((2 * decoded - 1).numpy(), mirror.decode(z).numpy(), atol=ATOL)


# -- discriminator, LPIPS, DINO, DISTS --------------------------------------------


def test_patch_gan_discriminator():
    torch.manual_seed(3)
    mirror = make_torch_patchgan()
    mirror.train()   # batch statistics, as the port's BatchNorm
    cfg = load_config("re10k", ["model.discriminator.base_dim=8"]).model.discriminator
    ours = DiscriminatorPatchGan(cfg)
    converted = both_routes(mirror.state_dict(), jax_pretrained.convert_discriminator_patch_gan,
                            pretrained.convert_discriminator_patch_gan, ours)
    x = torch.randn(2, 3, 32, 32)
    with torch.no_grad():
        np.testing.assert_allclose(loaded(ours, converted)(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2).numpy(),
                                   mirror.main(x).numpy(), atol=ATOL)


def lpips_state_dict(rng, naming):
    sd = {}
    shapes_in = [3, 64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512]
    shapes_out = [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512]
    for idx, ci, co in zip(pretrained._VGG16_CONV_IDS, shapes_in, shapes_out):
        sd[f"{naming}.{idx}.weight"] = torch.from_numpy(rng.normal(size=(co, ci, 3, 3)).astype(np.float32) * 0.05)
        sd[f"{naming}.{idx}.bias"] = torch.from_numpy(rng.normal(size=(co,)).astype(np.float32) * 0.05)
    for i, ch in enumerate([64, 128, 256, 512, 512]):
        sd[f"lins.{i}.model.1.weight"] = torch.from_numpy(np.abs(rng.normal(size=(1, ch, 1, 1))).astype(np.float32))
    return sd


@pytest.mark.parametrize("naming", ["net.slices", "net.features", "features"])
def test_lpips_vgg(naming):
    sd = lpips_state_dict(np.random.default_rng(0), naming)
    ours = LPIPS()
    converted = both_routes(sd, jax_pretrained.convert_lpips_vgg, pretrained.convert_lpips_vgg, ours)
    loaded(ours, converted)
    a, b = torch.rand(1, 32, 32, 3), torch.rand(1, 32, 32, 3)
    with torch.no_grad():
        assert float(ours(a, b)[0]) > 0 and abs(float(ours(a, a)[0])) < 1e-6


def test_dino_block():
    dim, heads = 16, 4
    torch.manual_seed(4)
    mirror = TorchDinoBlock(dim, heads).eval()
    sd = {f"blocks.0.{k}": v for k, v in mirror.state_dict().items()}
    sd.update({"cls_token": torch.zeros(1, 1, dim), "pos_embed": torch.zeros(1, 785, dim),
               "patch_embed.proj.weight": torch.zeros(dim, 3, 8, 8), "patch_embed.proj.bias": torch.zeros(dim),
               "norm.weight": torch.ones(dim), "norm.bias": torch.zeros(dim)})
    ours = ViTBlock(dim, heads)
    block = lambda tree: {k[len("block_0."):]: v for k, v in tree.items() if k.startswith("block_0.")}  # noqa: E731
    converted = both_routes(sd, lambda s: jax_pretrained.convert_dino_vit(s, heads)["block_0"],
                            lambda s: block(pretrained.convert_dino_vit(s, heads)), ours)
    x = torch.randn(1, 10, dim)
    with torch.no_grad():
        np.testing.assert_allclose(loaded(ours, converted)(x).numpy(), mirror(x).numpy(), atol=ATOL)


@pytest.mark.parametrize("qkv_bias", [True, False])
def test_dino_trunk(qkv_bias):
    # A dino_vitb8-shaped trunk at toy width, at a 64x64 input, so that the
    # +0.1-fudged bicubic position-embedding interpolation is on the path.
    patch, dim, depth, heads = 8, 16, 2, 4
    torch.manual_seed(5)
    mirror = TorchMiniDino(patch, dim, depth, heads).eval()
    sd = dict(mirror.state_dict())
    if not qkv_bias:
        for i in range(depth):
            del sd[f"blocks.{i}.attn.qkv.bias"]
            mirror.blocks[i].attn.qkv.bias.data.zero_()
    ours = DinoViT(patch, dim, depth, heads)
    converted = both_routes(sd, lambda s: jax_pretrained.convert_dino_vit(s, heads),
                            lambda s: pretrained.convert_dino_vit(s, heads), ours)
    x = torch.rand(1, 3, 64, 64)
    with torch.no_grad():
        np.testing.assert_allclose(loaded(ours, converted)(x.permute(0, 2, 3, 1)).numpy(), mirror(x).numpy(),
                                   atol=ATOL)


def test_dists():
    torch.manual_seed(0)
    mirror = TorchDISTS()
    with torch.no_grad():
        for m in mirror.modules():
            if isinstance(m, torch.nn.Conv2d):
                m.weight *= 0.3
    ours = DISTSNet()
    converted = both_routes(mirror.state_dict(), jax_pretrained.convert_dists, pretrained.convert_dists, ours)
    loaded(ours, converted)
    rng = np.random.default_rng(0)
    x = rng.uniform(size=(2, 64, 64, 3)).astype(np.float32)
    y = np.clip(x + 0.2 * rng.standard_normal(x.shape), 0, 1).astype(np.float32)
    with torch.no_grad():
        theirs = mirror(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(y).permute(0, 3, 1, 2)).numpy()
        np.testing.assert_allclose(ours(torch.from_numpy(x), torch.from_numpy(y)).numpy(), theirs, atol=ATOL)


@pytest.mark.parametrize("cin,cout,k", [(6, 6, 4), (8, 5, 2), (3, 7, 8)])
def test_conv_transpose_goes_over_unflipped(cin, cout, k):
    # The JAX route flips the kernel twice (conv_transpose_kernel, then
    # params_from_jax): the port takes the torch weight as it is, and its
    # ConvTranspose2d matches the reference's.
    torch.manual_seed(k)
    mirror = torch.nn.ConvTranspose2d(cin, cout, k, stride=k).eval()
    sd = {f"upscaler.{n}": v for n, v in mirror.state_dict().items()}
    holder = torch.nn.Module()
    holder.upscaler = torch.nn.ConvTranspose2d(cin, cout, k, stride=k)
    converted = both_routes(sd, lambda s: {"upscaler": jax_pretrained._conv_transpose(s, "upscaler")},
                            lambda s: pretrained._layer(s, "upscaler", "upscaler"), holder)
    assert torch.equal(converted["upscaler.weight"], mirror.weight)
    x = torch.randn(2, cin, 5, 6)
    with torch.no_grad():
        np.testing.assert_allclose(loaded(holder, converted).upscaler(x).numpy(), mirror(x).numpy(), atol=ATOL)


# -- merging and the load helpers -------------------------------------------------


def test_merge_params_checks_keys_and_shapes():
    target = {"a.weight": torch.zeros(2, 3), "a.bias": torch.zeros(2)}
    merged = pretrained.merge_params(target, {"a.bias": torch.ones(2, dtype=torch.float64)})
    assert merged["a.bias"].dtype == torch.float32 and torch.equal(merged["a.bias"], torch.ones(2))
    assert merged["a.weight"] is target["a.weight"]
    with pytest.raises(KeyError, match="encoder.b.weight"):
        pretrained.merge_params(target, {"b.weight": torch.zeros(1)}, "encoder")
    with pytest.raises(ValueError, match=r"shape mismatch at encoder.a.weight: target \(2, 3\), got \(3, 2\)"):
        pretrained.merge_params(target, {"a.weight": torch.zeros(3, 2)}, "encoder")


def test_load_pretrained_helpers(tmp_path):
    torch.manual_seed(6)
    # A LatentSplat whose VAE has the tiny mirror's widths and whose trunk is
    # a 2-block dino_vits8-wide DINO.
    cfg = load_config("re10k", SMALL_OVERRIDES + [
        "model.autoencoder.block_out_channels=[8, 16]", "model.autoencoder.layers_per_block=1",
        "model.autoencoder.skip_connections=false", "model.supersampling_factor=2",
    ])
    model = LatentSplat(cfg.model)
    vae = TorchTinyVAE()
    torch.save(vae.state_dict(), tmp_path / "vae.pt")
    pretrained.load_pretrained_autoencoder(model, tmp_path / "vae.pt", num_blocks=2, layers_per_block=1)
    expected = pretrained.convert_autoencoder_kl(vae.state_dict(), num_blocks=2, layers_per_block=1)
    assert all(torch.equal(model.autoencoder.state_dict()[k], v) for k, v in expected.items())

    dino = TorchMiniDino(8, 384, 12, 6)
    torch.save({"state_dict": dino.state_dict()}, tmp_path / "dino.pth")
    pretrained.load_pretrained_dino(model, tmp_path / "dino.pth", num_heads=6)
    expected = pretrained.convert_dino_vit(dino.state_dict(), 6)
    assert all(torch.equal(model.encoder.backbone.dino.state_dict()[k], v) for k, v in expected.items())

    mirror = make_torch_patchgan(base=64)
    torch.save(mirror.state_dict(), tmp_path / "disc.pt")
    disc = pretrained.load_pretrained_discriminator(DiscriminatorPatchGan(cfg.model.discriminator),
                                                    tmp_path / "disc.pt")
    assert torch.equal(disc.conv_out.weight, mirror.main[11].weight)

    sd = lpips_state_dict(np.random.default_rng(1), "net.slices")
    torch.save(sd, tmp_path / "lpips.pth")
    lpips = pretrained.load_pretrained_lpips(LPIPS(), tmp_path / "lpips.pth")
    assert torch.equal(lpips.lin_4.weight, sd["lins.4.model.1.weight"])


def test_a_pickled_checkpoint_needs_trust(tmp_path):
    # A Lightning .ckpt carries more than tensors; an object that
    # weights_only=True refuses is read only when trusted.
    torch.save({"state_dict": {"w": torch.ones(2)}, "hyper_parameters": Path("cfg.yaml")}, tmp_path / "run.ckpt")
    with pytest.raises(ValueError, match="trust_pickle"):
        pretrained.load_torch_state_dict(tmp_path / "run.ckpt")
    assert torch.equal(pretrained.load_torch_state_dict(tmp_path / "run.ckpt", trust_pickle=True)["w"], torch.ones(2))


# -- whole latentSplat checkpoints ------------------------------------------------

# The JAX package's encoder-conversion test configuration (a dino_vits8
# trunk, one epipolar and one self-attention layer), with a tiny VAE
# (four blocks of 8 channels, skip connections) and PatchGAN.
ENCODER_OVERRIDES = [
    "dataset.image_shape=[32,32]",
    "model.encoder.backbone={name: dino, model: dino_vits8}",
    "model.encoder.d_backbone=64",
    "model.encoder.d_feature=32",
    "model.encoder.num_monocular_samples=4",
    "model.encoder.gaussians_per_pixel=1",
    "model.encoder.epipolar_transformer.num_samples=4",
    "model.encoder.epipolar_transformer.num_layers=1",
    "model.encoder.epipolar_transformer.num_heads=2",
    "model.encoder.epipolar_transformer.d_dot=8",
    "model.encoder.epipolar_transformer.d_mlp=16",
    "model.encoder.epipolar_transformer.self_attention.num_layers=1",
    "model.encoder.epipolar_transformer.self_attention.num_heads=2",
    "model.encoder.epipolar_transformer.self_attention.d_token=32",
    "model.encoder.epipolar_transformer.self_attention.d_dot=8",
    "model.encoder.epipolar_transformer.self_attention.d_mlp=16",
    "model.autoencoder.block_out_channels=[8, 8, 8, 8]",
    "model.discriminator.base_dim=8",
]


@pytest.fixture(scope="module")
def encoder_model():
    torch.manual_seed(7)
    return LatentSplat(load_config("re10k", ENCODER_OVERRIDES).model)


def test_latentsplat_encoder(encoder_model):
    # The JAX tests' independent construction of the reference layout.
    encoder = encoder_model.encoder
    sd = _torch_like_encoder_sd(
        d_backbone=64, d_feature=32, n_heads=6, vit_dim=384, vit_depth=12, et_layers=1, sa_layers=1,
        sa_d_token=32, sa_d_mlp=16, et_inner=16, sa_inner=16, d_mlp=16, num_octaves=10, sa_octaves=10,
        downscale=4, patch=8, sa_patch=4, d_gaussians=encoder.to_gaussians.weight.shape[0],
        d_depth=encoder.depth_predictor.projection.weight.shape[0],
    )
    converted = both_routes(sd, lambda s: jax_pretrained.convert_latentsplat_encoder(s, num_heads=6),
                            lambda s: pretrained.convert_latentsplat_encoder(s, num_heads=6), encoder)
    state = encoder.state_dict()
    pretrained.merge_params(state, converted)
    # Every encoder tensor comes from the file.
    assert set(state) == set(converted)


def reference_checkpoint(model, discriminator):
    """The released layout of `model` and `discriminator`
    (`pretrained.reference_state_dict`)."""
    return reference_state_dict(model.state_dict(), discriminator.state_dict())


def test_latentsplat_checkpoint(encoder_model):
    # The round trip through the released layout gives back every tensor;
    # the JAX converter maps the same file to the same tensors.
    cfg = load_config("re10k", ENCODER_OVERRIDES)
    torch.manual_seed(8)
    discriminator = DiscriminatorPatchGan(cfg.model.discriminator)
    like_trained(encoder_model, peaked_depth=False)
    ref = reference_checkpoint(encoder_model, discriminator)
    sd = pretrained.RecordingStateDict(ref)
    ours = pretrained.convert_latentsplat_checkpoint(sd, num_heads=6)
    unread = set(ref) - sd.read
    assert unread and all(k.endswith(("running_mean", "running_var", "num_batches_tracked")) for k in unread)
    assert_same_state({k: v.float() for k, v in ours["generator"].items()}, encoder_model.state_dict())
    assert_same_state(ours["discriminator"], discriminator.state_dict())
    theirs = jax_pretrained.convert_latentsplat_checkpoint({k: v.numpy() for k, v in ref.items()}, num_heads=6)
    assert_same_state(ours["generator"], params_from_jax(theirs["generator"], encoder_model))
    assert_same_state(ours["discriminator"], params_from_jax(theirs["discriminator"], discriminator))


# -- the command ------------------------------------------------------------------

# The tiny trainer configuration with a 2-block DINO trunk, a tiny VAE with
# skip connections and a PatchGAN: what a released checkpoint holds.
CLI_OVERRIDES = TINY + [
    "model.encoder.backbone={name: dino, model: dino_vits8}",
    "model.autoencoder={name: kl, model: kl_f8, block_out_channels: [8, 8, 8, 8], skip_connections: true}",
    "model.supersampling_factor=8",
    "model.discriminator={name: patch_gan, model: kl_f8, base_dim: 8}",
]


def test_convert_checkpoint_serves_the_released_model(tmp_path):
    from latentsplat_tpu.scripts.convert_checkpoint import main as jax_convert_main
    from latentsplat_tpu.training.checkpointing import load_checkpoint as jax_load_checkpoint
    from latentsplat_tpu_torch.main import main as run_main
    from latentsplat_tpu_torch.scripts.convert_checkpoint import main as convert_main

    cfg = load_config(None, CLI_OVERRIDES)
    torch.manual_seed(9)
    model = like_trained(LatentSplat(cfg.model), peaked_depth=False)
    discriminator = DiscriminatorPatchGan(cfg.model.discriminator)
    ref = reference_checkpoint(model, discriminator)
    torch.save({"state_dict": ref, "global_step": 123, "epoch": 4}, tmp_path / "released.ckpt")

    counts = convert_main([str(tmp_path / "released.ckpt"), str(tmp_path / "converted"), *CLI_OVERRIDES])
    assert counts["read"] == len(ref) and counts["unmapped"] == 0 and counts["seeded"] == 0
    assert counts["mapped"] + counts["batch_norm_statistics"] == len(ref)
    converted = torch.load(tmp_path / "converted", weights_only=True)
    assert_same_state(converted["generator"], model.state_dict())
    assert_same_state(converted["discriminator"], discriminator.state_dict())

    # The JAX command's output, carried over by params_from_jax.
    jax_convert_main([str(tmp_path / "released.ckpt"), str(tmp_path / "jax_converted")])
    restored = jax_load_checkpoint(tmp_path / "jax_converted")
    theirs = params_from_jax(restored["params_gen"], model)
    assert_same_state({k: converted["generator"][k] for k in theirs}, theirs)
    assert set(theirs) == set(converted["generator"])
    assert_same_state(converted["discriminator"], params_from_jax(restored["params_disc"], discriminator))

    # main serves it in test mode, with the PNGs of the model's own checkpoint.
    torch.save({"step": 0, "generator": model.state_dict()}, tmp_path / "own")
    index = tmp_path / "index.json"
    index.write_text(json.dumps({"synthetic_0000": {"context": [0, 6], "target": [2, 4]}}))
    common = [*CLI_OVERRIDES, f"dataset.view_sampler={{name: evaluation, index_path: {index}}}", "mode=test"]
    pngs = {}
    for name in ("own", "converted"):
        run_main([*common, f"output_dir={tmp_path / name}_run", f"test.output_path={tmp_path / name}_test",
                  f"checkpointing.load={tmp_path / name}"], device="cpu")
        pngs[name] = {p.relative_to(tmp_path / f"{name}_test"): p.read_bytes()
                      for p in sorted((tmp_path / f"{name}_test").rglob("*.png"))}
    assert len(pngs["own"]) == 2 and pngs["own"] == pngs["converted"]
