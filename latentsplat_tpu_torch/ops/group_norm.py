"""Group normalisation with SiLU after it where asked: the norms of the
VAE (model/autoencoder/kl.py), over channels-last (NHWC) tensors.

`group_norm_silu(x, norm, silu, shift)` takes the logical (N, C, H, W)
tensor, the `nn.GroupNorm` that holds gamma and beta and, where given, a
per-channel shift: the norm of x + shift, for an x written by a
convolution run without its bias (the shift), as model/autoencoder/kl.py
runs them. A CUDA tensor goes through the `group_norm_silu` kernel
(csrc/group_norm_silu.cu): one launch of the forward (statistics, their
merge, the normalisation with its SiLU) and one of the backward, counted
(`cuda_build.launched`) as "group_norm_silu" and
"group_norm_silu_backward", of variant "shift" where a shift is given
(the kernel adds it to each x it reads, rounded as PyTorch's `add_` of
the bias rounds; the shift's gradient is the per-channel sum of dx). The
kernel reads and writes float32 or bfloat16 (the `vae:bfloat16` compute
dtype) and computes in float32; any other dtype, or a shape it does not
take, raises. Its output is channels-last whatever the input's layout;
the backward keeps the input (not shifted) and the (sample, group) mean
and rstd, not the normalised tensor. A CPU tensor runs the plain version,
`group_norm_silu_reference`, on x + shift.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..cuda_build import launch

# A forward or backward pass splits each sample's rows into chunks: enough
# blocks to fill the card (~2048 over the batch), none with fewer than
# MIN_CHUNK_VALUES values to stream.
TARGET_BLOCKS = 2048
MIN_CHUNK_VALUES = 16384
# The dtypes the kernel reads and writes: the flag it is launched with.
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def chunks_for(n: int, hw: int, c: int) -> int:
    """Row chunks a sample of `hw` rows of `c` channels is split into."""
    rows_min = math.ceil(MIN_CHUNK_VALUES / c)
    return max(1, min(math.ceil(TARGET_BLOCKS / n), math.ceil(hw / rows_min)))


def group_norm_silu_reference(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float, silu: bool
) -> torch.Tensor:
    """Plain version: F.group_norm, then F.silu where asked."""
    y = F.group_norm(x, groups, weight, bias, eps)
    return F.silu(y) if silu else y


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def forward(
    x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float, silu: bool,
    shift: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the forward kernel on a float32 or bfloat16 CUDA x (N,
    C, H, W) in channels-last memory, float32 weight, bias and shift (or
    None): y in x's dtype and channels-last memory, and the float32 (N,
    groups) mean and rstd of x + shift."""
    n, c, h, w = x.shape
    chunks = chunks_for(n, h * w, c)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    partials = torch.empty((n, chunks, groups, 3), dtype=torch.float32, device=x.device)
    mean, rstd = (torch.empty((n, groups), dtype=torch.float32, device=x.device) for _ in range(2))
    launch(
        "group_norm_silu_forward", n, h * w, c, groups, chunks, eps, int(silu), KERNEL_DTYPES[x.dtype], x.data_ptr(),
        None if shift is None else shift.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(),
        partials.data_ptr(), mean.data_ptr(), rstd.data_ptr(), _stream(x.device), kernel="group_norm_silu",
        variant="exact" if shift is None else "shift",
    )
    return y, mean, rstd


def backward(
    x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, mean: torch.Tensor,
    rstd: torch.Tensor, groups: int, silu: bool, shift: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One launch of the backward kernel (x and dy channels-last, of one
    dtype; weight, bias, mean, rstd and shift (or None) float32): dx, the
    gradient of x + shift, in x's dtype and channels-last memory, and the
    float32 dgamma and dbeta."""
    n, c, h, w = x.shape
    chunks = chunks_for(n, h * w, c)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    partials = torch.empty((n, chunks, 2, c), dtype=torch.float32, device=x.device)
    sums = torch.empty((n, 2, c), dtype=torch.float32, device=x.device)
    coef = torch.empty((n, groups, 2), dtype=torch.float32, device=x.device)
    launch(
        "group_norm_silu_backward", n, h * w, c, groups, chunks, int(silu), KERNEL_DTYPES[x.dtype], x.data_ptr(),
        None if shift is None else shift.data_ptr(), dy.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
        weight.data_ptr(), bias.data_ptr(), dx.data_ptr(), partials.data_ptr(), sums.data_ptr(), coef.data_ptr(),
        _stream(x.device), kernel="group_norm_silu_backward", variant="exact" if shift is None else "shift",
    )
    dgamma, dbeta = sums.sum(0)
    return dx, dgamma, dbeta


class _GroupNormSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, shift, groups: int, eps: float, silu: bool):
        x = x.detach().contiguous(memory_format=torch.channels_last)
        gamma, beta = (t.detach().float().contiguous() for t in (weight, bias))
        shift32 = None if shift is None else shift.detach().float().contiguous()
        y, mean, rstd = forward(x, gamma, beta, groups, eps, silu, shift32)
        ctx.save_for_backward(x, gamma, beta, shift32, mean, rstd)
        ctx.groups, ctx.silu, ctx.param_dtype = groups, silu, weight.dtype
        ctx.shift_dtype = None if shift is None else shift.dtype
        return y

    @staticmethod
    def backward(ctx, dy):
        x, gamma, beta, shift, mean, rstd = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous(memory_format=torch.channels_last)
        dx, dgamma, dbeta = backward(x, dy, gamma, beta, mean, rstd, ctx.groups, ctx.silu, shift)
        # The shift's gradient: what the convolution's backward reduced for
        # its bias.
        dshift = dx.sum((0, 2, 3)).to(ctx.shift_dtype) if ctx.needs_input_grad[3] else None
        return dx, dgamma.to(ctx.param_dtype), dbeta.to(ctx.param_dtype), dshift, None, None, None


def group_norm_silu(x: torch.Tensor, norm: nn.GroupNorm, silu: bool, shift: torch.Tensor | None = None
                    ) -> torch.Tensor:
    """`norm(x + shift)` (shift (C,) broadcast over N, H and W; x where it
    is None), then F.silu where `silu`: x (N, C, H, W), any layout."""
    if x.device.type != "cuda":
        if shift is not None:
            x = x + shift[:, None, None]
        return group_norm_silu_reference(x, norm.weight, norm.bias, norm.num_groups, norm.eps, silu)
    if x.dim() != 4 or x.dtype not in KERNEL_DTYPES or norm.weight is None or norm.bias is None:
        raise ValueError(
            f"group_norm_silu takes a float32 or bfloat16 (N, C, H, W) tensor and an affine norm on the card, "
            f"not {x.dtype} {tuple(x.shape)} (affine: {norm.affine})")
    if shift is not None and shift.shape != (x.shape[1],):
        raise ValueError(f"group_norm_silu: a shift of shape {tuple(shift.shape)} for {x.shape[1]} channels")
    return _GroupNormSiLU.apply(x, norm.weight, norm.bias, shift, norm.num_groups, norm.eps, silu)
