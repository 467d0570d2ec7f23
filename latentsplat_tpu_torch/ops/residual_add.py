"""The VAE's residual and skip sums with the biases of the convolutions
that wrote their operands (model/autoencoder/kl.py runs those without
their bias).

`residual_add(a, bias_a, b, bias_b)` is `(a + bias_a) + (b + bias_b)` over
logical (N, C, H, W) tensors, each bias (C,) broadcast over N, H and W or
None, and b None too (then `a + bias_a`). A CUDA tensor goes through the
`residual_add` kernel (csrc/residual_add.cu): one launch, counted
(`cuda_build.launched`) as "residual_add", which rounds as the unfused
ops do (each biased operand as PyTorch's `add_` of the bias, then the
sum) and writes channels-last memory whatever the inputs' layout. It
reads and writes float32 or bfloat16; another dtype, or operands of
another shape or dtype than each other, raises. The backward hands the
upstream gradient to both operands as it is and gives each bias its
per-channel sum, reduced once where both biases take it. A CPU tensor runs
the plain version, `residual_add_reference`.
"""

from __future__ import annotations

import torch

from ..cuda_build import launch

# The dtypes the kernel reads and writes: the flag it is launched with.
KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _biased(t: torch.Tensor, bias: torch.Tensor | None) -> torch.Tensor:
    return t if bias is None else t + bias[:, None, None]


def residual_add_reference(a: torch.Tensor, bias_a: torch.Tensor | None = None, b: torch.Tensor | None = None,
                           bias_b: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version: the bias adds, then the sum."""
    out = _biased(a, bias_a)
    return out if b is None else out + _biased(b, bias_b)


def forward(a: torch.Tensor, bias_a: torch.Tensor | None, b: torch.Tensor | None,
            bias_b: torch.Tensor | None) -> torch.Tensor:
    """One launch of the kernel on float32 or bfloat16 CUDA tensors a and b
    (or None) of one shape and dtype in channels-last memory, float32
    biases (or None): the sum in a's dtype and channels-last memory."""
    n, c, h, w = a.shape
    out = torch.empty_like(a, memory_format=torch.channels_last)
    pointers = [None if t is None else t.data_ptr() for t in (a, bias_a, b, bias_b)]
    launch("residual_add", n * h * w, c, KERNEL_DTYPES[a.dtype], *pointers, out.data_ptr(),
           torch.cuda.current_stream(a.device).cuda_stream, kernel="residual_add")
    return out


class _ResidualAdd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, bias_a, b, bias_b):
        layout = [None if t is None else t.detach().contiguous(memory_format=torch.channels_last) for t in (a, b)]
        biases = [None if t is None else t.detach().float().contiguous() for t in (bias_a, bias_b)]
        ctx.bias_dtypes = [None if t is None else t.dtype for t in (bias_a, bias_b)]
        return forward(layout[0], biases[0], layout[1], biases[1])

    @staticmethod
    def backward(ctx, dy):
        need = ctx.needs_input_grad
        dbias = dy.sum((0, 2, 3)) if need[1] or need[3] else None
        return (dy if need[0] else None, dbias.to(ctx.bias_dtypes[0]) if need[1] else None,
                dy if need[2] else None, dbias.to(ctx.bias_dtypes[1]) if need[3] else None)


def residual_add(a: torch.Tensor, bias_a: torch.Tensor | None = None, b: torch.Tensor | None = None,
                 bias_b: torch.Tensor | None = None) -> torch.Tensor:
    """`(a + bias_a) + (b + bias_b)`, each bias (C,) or None, b or None: a
    and b (N, C, H, W), any layout."""
    if a.device.type != "cuda":
        return residual_add_reference(a, bias_a, b, bias_b)
    if a.dim() != 4 or a.dtype not in KERNEL_DTYPES:
        raise ValueError(f"residual_add takes float32 or bfloat16 (N, C, H, W) tensors on the card, "
                         f"not {a.dtype} {tuple(a.shape)}")
    if b is not None and (b.shape != a.shape or b.dtype != a.dtype or b.device != a.device):
        raise ValueError(f"residual_add: operands {a.dtype} {tuple(a.shape)} and {b.dtype} {tuple(b.shape)} "
                         f"on {a.device} and {b.device}")
    for bias in (bias_a, bias_b):
        if bias is not None and (bias.shape != (a.shape[1],) or bias.device != a.device):
            raise ValueError(f"residual_add: a bias of shape {tuple(bias.shape)} on {bias.device} for "
                             f"{a.shape[1]} channels on {a.device}")
    return _ResidualAdd.apply(a, bias_a, b, bias_b)
