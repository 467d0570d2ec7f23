"""The VAE in channels-last memory (model/autoencoder/kl.py) against the
NCHW code it replaced, on the CPU.

The NCHW side is `perfbench/reference/model/autoencoder/kl.py`, a frozen
copy of the module as it was before channels-last: NCHW views of the NHWC
inputs, nn.GroupNorm then F.silu, an upsample by two repeat_interleave
calls. Both run plain on the CPU (the group norm kernel is the card's;
tests/test_torch_cuda.py holds it there), in float64: a channels-last
convolution or group norm sums in another order than an NCHW one, which
in float32 moves the decode by ~1.2e-6 of its root mean square; in float64
that noise is ~1e-15 (~1e-12 on a gradient leaf that is zero but for
rounding, held to a floor below), so a tolerance of 1e-10 (of the output's
root mean square, of each gradient leaf's largest value) leaves room for
it alone.
The float32 path is the card's: tests/test_torch_cuda.py holds the decode
there against the same copy.
"""

import ctypes
import re

import pytest
import torch
import torch.nn.functional as F
from torch import nn

from latentsplat_tpu_torch import cuda_build
from latentsplat_tpu_torch.model.autoencoder.kl import AutoencoderKL, AutoencoderKLCfg, Upsample
from latentsplat_tpu_torch.ops import group_norm as gn
from perfbench.reference.model.autoencoder import kl as nchw
from tests.torch_threads import one_intra_op_thread  # noqa: F401 (autouse)

TOL = 1e-10
# Narrow nets: 16 channels give 16 groups of 1, 48 give 16 groups of 3
# (gcd(32, C) groups).
CHANNELS = [16, 48]


def pair(seed: int = 0):
    """The port's VAE with skips and the frozen NCHW copy, the same weights
    (random, with non-trivial norm affines)."""
    torch.manual_seed(seed)
    kwargs = dict(block_out_channels=CHANNELS, layers_per_block=1, latent_channels=4, skip_connections=True)
    ours = AutoencoderKL(AutoencoderKLCfg(**kwargs), d_in=3, d_skip_extra=3)
    with torch.no_grad():
        for m in ours.modules():
            if isinstance(m, nn.GroupNorm):
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.3, 0.3)
    ref = nchw.AutoencoderKL(nchw.AutoencoderKLCfg(**kwargs), d_in=3, d_skip_extra=3)
    ref.load_state_dict(ours.state_dict())
    return ours.double(), ref.double()


def inputs(seed: int = 1):
    g = torch.Generator().manual_seed(seed)
    z = torch.randn((2, 3, 4, 5, 4), generator=g, dtype=torch.float64)     # (batch, views, h', w', latent)
    skip = torch.randn((2, 3, 8, 10, 7), generator=g, dtype=torch.float64)  # 4 latent + 3 color channels
    return z, skip


def close(a: torch.Tensor, b: torch.Tensor, scale: float) -> float:
    return float((a - b).abs().max()) / scale


def test_decode_matches_nchw():
    ours, ref = pair()
    z, skip = inputs()
    out, want = ours.decode(z, skip), ref.decode(z, skip)
    assert out.shape == want.shape == (2, 3, 8, 10, 3)
    rms = float(want.detach().pow(2).mean().sqrt())
    assert close(out, want, rms) <= TOL


def test_decode_gradients_match_nchw():
    ours, ref = pair()
    grads = []
    for model in (ours, ref):
        z, skip = (t.requires_grad_() for t in inputs())
        out = model.decode(z, skip)
        cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(2), dtype=torch.float64)
        (out * cot).sum().backward()
        grads.append({"z": z.grad, "skip": skip.grad, **{n: p.grad for n, p in model.named_parameters()
                                                          if p.grad is not None}})
    assert grads[0].keys() == grads[1].keys()
    assert any(k.endswith("norm1.weight") for k in grads[0])
    # A leaf whose gradient is zero but for rounding (the attention's key
    # bias, which the softmax ignores; a conv bias before a group norm of
    # one channel a group) is normalised by 1e-4 of the largest
    # leaf's largest value.
    floor = 1e-4 * max(float(g.abs().max()) for g in grads[1].values())
    for name, g in grads[1].items():
        assert close(grads[0][name], g, max(float(g.abs().max()), floor)) <= TOL, name


def test_encode_matches_nchw():
    ours, ref = pair()
    images = torch.rand((2, 16, 12, 3), generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    a, b = ours.encode(images), ref.encode(images)
    for x, y in ((a.mean, b.mean), (a.logvar, b.logvar)):
        assert close(x, y, float(y.detach().pow(2).mean().sqrt())) <= TOL


def test_decoder_stays_channels_last():
    """Every convolution of encode and decode takes channels-last memory,
    and decode_hidden gives it: nothing is transposed on the way."""
    ours, _ = pair()
    z, skip = inputs()
    seen = []
    hooks = [m.register_forward_pre_hook(lambda m, args: seen.append(
        args[0].is_contiguous(memory_format=torch.channels_last))) for m in ours.modules()
        if isinstance(m, nn.Conv2d)]
    hidden = ours.decode_hidden(z, skip)
    ours.encode(torch.rand((1, 16, 12, 3), dtype=torch.float64))
    for h in hooks:
        h.remove()
    assert len(seen) == sum(isinstance(m, nn.Conv2d) for m in ours.modules()) - 1   # but conv_out
    assert all(seen)
    assert hidden.is_contiguous(memory_format=torch.channels_last)
    assert ours.decode_out(hidden, z.shape[:-3]).is_contiguous()


@pytest.mark.parametrize("layout", [torch.contiguous_format, torch.channels_last])
def test_upsample_repeats_bit_for_bit(layout):
    x = torch.randn((2, 6, 5, 7)).contiguous(memory_format=layout)
    up = Upsample(6)
    up.conv = nn.Identity()
    assert torch.equal(up(x), x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3))


def test_state_dict_unchanged():
    ours, ref = pair()
    a, b = ours.state_dict(), ref.state_dict()
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape for k in a)


@pytest.mark.parametrize("silu", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_group_norm_silu_is_plain_on_the_cpu(silu, dtype, monkeypatch):
    # A CPU tensor runs nn.GroupNorm + F.silu; no kernel library is loaded
    # and no launch is counted.
    def refuse():
        raise AssertionError("the CPU path loaded the kernel library")

    monkeypatch.setattr(cuda_build, "load_library", refuse)
    norm = nn.GroupNorm(4, 12, eps=1e-6).to(dtype)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5)
        norm.bias.uniform_(-0.5, 0.5)
    x = torch.randn((2, 12, 5, 3)).to(dtype).contiguous(memory_format=torch.channels_last)
    want = norm(x)
    want = F.silu(want) if silu else want
    before = dict(cuda_build.launches)
    assert torch.equal(gn.group_norm_silu(x, norm, silu), want)
    assert dict(cuda_build.launches) == before


@pytest.mark.parametrize("name", ["group_norm_silu_forward", "group_norm_silu_backward"])
def test_the_library_declares_group_norm_silu(name):
    # The ctypes signature matches the C entry point, argument by argument:
    # pointers, ints (the dtype flag among them) and the float eps.
    argtypes, restype = cuda_build._SIGNATURES[name]
    source = (cuda_build.CSRC_DIR / "group_norm_silu.cu").read_text()
    params = [p.strip() for p in re.search(rf'extern "C" int {name}\(([^)]*)\)', source).group(1).split(",")]
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    assert restype is ctypes.c_int and len(argtypes) == len(params)
    assert list(argtypes) == [ctypes.c_void_p if "*" in p else kinds[p.split()[0]] for p in params]
    assert "int is_bf16" in params and len(gn.KERNEL_DTYPES) == 2


@pytest.mark.parametrize("n,hw,c,want", [
    (30, 256 * 256, 128, 69),     # the video decode's top level: 69 chunks of 950 rows
    (3, 32 * 32, 512, 32),        # each chunk at least 16384 values
    (1, 1, 4, 1),
    (2, 10, 3, 1),
])
def test_chunks(n, hw, c, want):
    assert gn.chunks_for(n, hw, c) == want


def biased_flow(monkeypatch):
    """The VAE's data flow as before its convolutions left their biases to
    the next reader: every convolution adds its own bias, the sums are
    plain adds and the norms take no shift."""
    from latentsplat_tpu_torch.model.autoencoder import kl

    norm = kl.group_norm_silu
    monkeypatch.setattr(kl.BiasLaterConv2d, "forward", nn.Conv2d.forward)
    monkeypatch.setattr(kl, "residual_add", lambda a, bias_a=None, b=None, bias_b=None: a if b is None else a + b)
    monkeypatch.setattr(kl, "group_norm_silu", lambda x, n, silu, shift=None: norm(x, n, silu))


def decode_and_encode_grads(model):
    """The decode's and the encode's outputs and every gradient leaf of a
    seeded loss on both."""
    z, skip = (t.requires_grad_() for t in inputs())
    out = model.decode(z, skip) if model.cfg.skip_connections else model.decode(z)
    moments = model.encode(torch.rand((2, 16, 12, 3), generator=torch.Generator().manual_seed(3),
                                      dtype=torch.float64))
    g = torch.Generator().manual_seed(2)
    loss = (out * torch.randn(out.shape, generator=g, dtype=torch.float64)).sum() + moments.mean.square().sum()
    loss.backward()
    grads = {"z": z.grad, **{n: p.grad for n, p in model.named_parameters() if p.grad is not None}}
    if skip.grad is not None:
        grads["skip"] = skip.grad
    return {"decode": out.detach(), "encode": moments.mean.detach()}, grads


@pytest.mark.parametrize("skip_connections", [True, False])
def test_bias_free_flow_equals_biased_flow(skip_connections, monkeypatch):
    # In float64 the two flows differ by rounding alone (~1e-16 a layer):
    # the outputs, and every gradient leaf, each conv bias's among them,
    # within 1e-12 of its largest value, floored at 1e-3 of the largest
    # leaf's (a conv bias before a group norm of one channel a group has a
    # gradient of rounding alone, ~1e-14 against ~6 for the largest leaf).
    # Without skips, the decoder's upsample biases go through the
    # conv_shortcut path (a one-operand sum) and the norm of a block
    # without one.
    ours, _ = pair()
    if not skip_connections:
        ours.cfg.skip_connections = False
        ours.decoder.cfg.skip_connections = False
    got, got_grads = decode_and_encode_grads(ours)
    ours.zero_grad(set_to_none=True)
    biased_flow(monkeypatch)
    want, want_grads = decode_and_encode_grads(ours)
    for k in want:
        assert close(got[k], want[k], float(want[k].abs().max())) <= 1e-12, k
    assert got_grads.keys() == want_grads.keys()
    assert sum(k.endswith("conv1.bias") for k in want_grads) >= 4
    floor = 1e-3 * max(float(g.abs().max()) for g in want_grads.values())
    for name, g in want_grads.items():
        assert close(got_grads[name], g, max(float(g.abs().max()), floor)) <= 1e-12, name


@pytest.mark.parametrize("skip_connections", [True, False])
def test_gradients_under_a_flop_counter(skip_connections):
    # FlopCounterMode tracks modules with multi-grad hooks on their
    # positional tensor inputs, which torch.autograd.grad refuses for a
    # leaf: a conv bias handed to a block must not be one of them.
    from torch.utils.flop_counter import FlopCounterMode

    ours, _ = pair()
    ours.cfg.skip_connections = ours.decoder.cfg.skip_connections = skip_connections
    z, skip = inputs()
    params = [p for p in ours.parameters()]
    with FlopCounterMode(display=False) as counter:
        out = ours.decode(z, skip if skip_connections else None).sum() + ours.encode(
            torch.rand((1, 16, 12, 3), dtype=torch.float64)).mean.sum()
        grads = torch.autograd.grad(out, params, allow_unused=True)
    assert counter.get_total_flops() > 0 and sum(g is not None for g in grads) > len(params) // 2


def test_skip_conv_pre_hook_reads_the_resized_skip():
    # The last skip conv is still called as a module: its forward pre-hook
    # fires once a decode, on the skip tensor resized to full size.
    ours, _ = pair()
    z, skip = inputs()
    decoder = ours.decoder
    seen = []
    last = getattr(decoder, f"skip_conv_{len(decoder.cfg.block_out_channels) - 1}")
    handle = last.register_forward_pre_hook(lambda module, args: seen.append(args[0]))
    ours.decode(z, skip)
    handle.remove()
    flat = skip.reshape(-1, *skip.shape[-3:]).permute(0, 3, 1, 2)
    want = F.interpolate(flat, size=flat.shape[-2:], mode="bilinear", align_corners=True)
    assert len(seen) == 1 and torch.equal(seen[0], want)


def test_bias_later_convs_are_conv2d_modules():
    # The convolutions that leave their bias to the next reader are
    # nn.Conv2d modules still: each holds its weight and bias.
    from latentsplat_tpu_torch.model.autoencoder.kl import BiasLaterConv2d

    ours, _ = pair()
    later = [n for n, m in ours.named_modules() if isinstance(m, BiasLaterConv2d)]
    assert all(isinstance(m, nn.Conv2d) and m.bias is not None for m in ours.modules() if isinstance(m, BiasLaterConv2d))
    assert sorted(n.rsplit(".", 1)[-1] for n in later if "resnet" not in n) == sorted(
        ["conv_in", "conv_in", "conv", "conv", *[f"skip_conv_{i}" for i in range(2)]])
    assert not any(isinstance(m, BiasLaterConv2d) for m in (ours.quant_conv, ours.post_quant_conv,
                                                            ours.decoder.conv_out, ours.encoder.conv_out))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("bias_a,b,bias_b", [(True, True, True), (False, True, True), (True, True, False),
                                             (False, True, False), (True, False, False)])
def test_residual_add_is_plain_on_the_cpu(dtype, bias_a, b, bias_b, monkeypatch):
    # A CPU tensor runs (a + bias_a) + (b + bias_b) in torch's ops; no
    # kernel library is loaded and no launch is counted.
    from latentsplat_tpu_torch.ops.residual_add import residual_add

    def refuse():
        raise AssertionError("the CPU path loaded the kernel library")

    monkeypatch.setattr(cuda_build, "load_library", refuse)
    g = torch.Generator().manual_seed(4)
    a_t, b_t = (torch.randn((2, 6, 5, 3), generator=g).to(dtype).contiguous(memory_format=torch.channels_last)
                for _ in range(2))
    ba, bb = (torch.randn(6, generator=g).to(dtype) for _ in range(2))
    args = (a_t, ba if bias_a else None, b_t if b else None, bb if bias_b else None)
    want = a_t + ba[:, None, None] if bias_a else a_t
    if b:
        want = want + (b_t + bb[:, None, None] if bias_b else b_t)
    before = dict(cuda_build.launches)
    assert torch.equal(residual_add(*args), want)
    assert dict(cuda_build.launches) == before


@pytest.mark.parametrize("needs", ["all", "operands", "biases"])
def test_residual_add_backward(needs, monkeypatch):
    # The card's autograd Function with its launch replaced by the plain
    # version, in float32 (the kernel's biases): dy to both operands as it
    # is, its per-channel sum to each bias (torch sums a broadcast's
    # gradient in another order: 1e-6 of the sum).
    from latentsplat_tpu_torch.ops import residual_add as ra

    monkeypatch.setattr(ra, "forward", ra.residual_add_reference)
    g = torch.Generator().manual_seed(5)
    a, b = (torch.randn((2, 6, 5, 3), generator=g) for _ in range(2))
    ba, bb = (torch.randn(6, generator=g) for _ in range(2))
    leaves = [a, ba, b, bb]
    for i, t in enumerate(leaves):
        t.requires_grad_(needs == "all" or (needs == "operands") == (i % 2 == 0))
    out = ra._ResidualAdd.apply(*leaves)
    assert torch.equal(out, ra.residual_add_reference(a, ba, b, bb))
    dy = torch.randn(out.shape, generator=g)
    want = torch.autograd.grad(ra.residual_add_reference(*leaves), [t for t in leaves if t.requires_grad], dy)
    got = torch.autograd.grad(out, [t for t in leaves if t.requires_grad], dy)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype and torch.allclose(x, y, rtol=1e-6, atol=0)


def test_the_library_declares_residual_add():
    # The ctypes signature matches the C entry point, argument by argument.
    from latentsplat_tpu_torch.ops import residual_add as ra

    argtypes, restype = cuda_build._SIGNATURES["residual_add"]
    source = (cuda_build.CSRC_DIR / "residual_add.cu").read_text()
    params = [p.strip() for p in re.search(r'extern "C" int residual_add\(([^)]*)\)', source).group(1).split(",")]
    kinds = {"int": ctypes.c_int, "float": ctypes.c_float}
    assert restype is ctypes.c_int and len(argtypes) == len(params)
    assert list(argtypes) == [ctypes.c_void_p if "*" in p else kinds[p.split()[0]] for p in params]
    assert "int is_bf16" in params and len(ra.KERNEL_DTYPES) == 2
    assert "residual_add" in cuda_build.KERNELS
