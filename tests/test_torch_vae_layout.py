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
