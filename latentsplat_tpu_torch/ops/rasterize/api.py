"""Rendering API (counterpart of `render` and `render_depth` in
latentsplat_tpu/ops/rasterize/api.py).

Per view: SH colors (+0.5, clamped at 0) and SH features (+0.5, no clamp)
evaluated towards the camera, or their DC coefficients as they are with
`use_sh=False`; the scene pre-normalized by 1/near when `scale_invariant`;
EWA projection, then the tiled (CUDA) or dense (oracle) compositor. Views
and scenes run in a Python loop and share the Gaussians. With `remat` each
view's render is checkpointed (non-reentrant): the backward renders the
view again, the kernels included, instead of keeping its pair buffers. `render_depth`
composites each view's camera-space depth (or its disparity, relative
disparity or log) as a 3-channel color. `render_orthographic` is not
ported yet.
"""

from __future__ import annotations

from math import isqrt
from typing import Literal, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ...geometry.conversions import depth_to_relative_disparity
from ...geometry.projection import homogenize_points, invert_se3
from ..sh import eval_sh
from .camera import project_gaussians_to_screen
from .dense import composite_dense
from .tiled import composite_tiled
from .types import RenderOutput

DepthRenderingMode = Literal["depth", "disparity", "relative_disparity", "log"]


def view_channels(
    means: torch.Tensor, color_sh: Optional[torch.Tensor],
    feature_sh: Optional[torch.Tensor], camera: torch.Tensor, use_sh: bool = True,
) -> torch.Tensor:
    """Per-Gaussian composited payload for one camera position: (G, C).
    Without `use_sh` the DC coefficients are the payload as they are."""
    if not use_sh:
        return torch.cat([sh[..., 0] for sh in (color_sh, feature_sh) if sh is not None], dim=-1)
    direction = means - camera[None, :]
    direction = direction / (torch.linalg.norm(direction, dim=-1, keepdim=True) + 1e-12)
    parts = []
    if color_sh is not None:
        degree = isqrt(color_sh.shape[-1]) - 1
        parts.append(torch.clamp(eval_sh(degree, color_sh, direction) + 0.5, min=0.0))
    if feature_sh is not None:
        degree = isqrt(feature_sh.shape[-1]) - 1
        parts.append(eval_sh(degree, feature_sh, direction) + 0.5)
    return torch.cat(parts, dim=-1)


def render(
    extrinsics: torch.Tensor,            # (B, V, 4, 4)
    intrinsics: torch.Tensor,            # (B, V, 3, 3)
    near: torch.Tensor,                  # (B, V)
    far: torch.Tensor,                   # (B, V)
    image_shape: tuple[int, int],
    background_color: torch.Tensor,      # (B, 3)
    gaussian_means: torch.Tensor,        # (B, G, 3)
    gaussian_covariances: torch.Tensor,  # (B, G, 3, 3)
    gaussian_opacities: torch.Tensor,    # (B, G)
    gaussian_color_sh: Optional[torch.Tensor] = None,    # (B, G, 3, d_sh)
    gaussian_feature_sh: Optional[torch.Tensor] = None,  # (B, G, C, d_sh)
    scale_invariant: bool = True,
    use_sh: bool = True,
    backend: str = "tiled",
    max_tiles_per_gaussian: int = 9,
    remat: bool = False,
) -> RenderOutput:
    """Returns color (B, V, 3, H, W), feature (B, V, C, H, W), mask and
    depth (B, V, H, W). With `scale_invariant` the depth stays in the
    1/near-normalized space."""
    assert gaussian_color_sh is not None or gaussian_feature_sh is not None
    if not use_sh:
        assert all(sh is None or sh.shape[-1] == 1 for sh in (gaussian_color_sh, gaussian_feature_sh))
    n_color = 3 if gaussian_color_sh is not None else 0

    def render_view(means, covs, opacities, color_sh, feature_sh, ext, intr, near_ij, background_color):
        channels = view_channels(means, color_sh, feature_sh, ext[:3, 3], use_sh)
        background = torch.zeros(channels.shape[-1], device=channels.device)
        background[:n_color] = background_color[:n_color]
        if scale_invariant:
            s = 1.0 / near_ij
            ext_s = ext.clone()
            ext_s[:3, 3] = ext[:3, 3] * s
            means_s, covs_s = means * s, covs * (s * s)
        else:
            ext_s, means_s, covs_s = ext, means, covs
        sg = project_gaussians_to_screen(means_s, covs_s, opacities, channels, ext_s, intr, image_shape)
        if backend == "dense":
            return (*composite_dense(sg, image_shape, background), 0)
        if backend == "tiled":
            return composite_tiled(sg, image_shape, background, max_tiles_per_gaussian)
        raise ValueError(f"unknown backend {backend!r}")

    if remat and torch.is_grad_enabled():
        def body(*args):
            return checkpoint(render_view, *args, use_reentrant=False)
    else:
        body = render_view
    b, v = extrinsics.shape[:2]
    images, masks, depths, pairs = [], [], [], []
    for i in range(b):
        color_sh = gaussian_color_sh[i] if n_color else None
        feature_sh = gaussian_feature_sh[i] if gaussian_feature_sh is not None else None
        for j in range(v):
            image, mask, depth, num_pairs = body(
                gaussian_means[i], gaussian_covariances[i], gaussian_opacities[i], color_sh, feature_sh,
                extrinsics[i, j], intrinsics[i, j], near[i, j], background_color[i],
            )
            images.append(image)
            masks.append(mask)
            depths.append(depth)
            pairs.append(num_pairs)

    h, w = image_shape
    images = torch.stack(images).reshape(b, v, -1, h, w)
    feature = images[:, :, n_color:] if images.shape[2] > n_color else None
    return RenderOutput(
        color=images[:, :, :n_color] if n_color else None,
        feature=feature,
        mask=torch.stack(masks).reshape(b, v, h, w),
        depth=torch.stack(depths).reshape(b, v, h, w),
        num_pairs=torch.tensor(pairs).reshape(b, v),
    )


def render_depth(
    extrinsics: torch.Tensor,            # (B, V, 4, 4)
    intrinsics: torch.Tensor,            # (B, V, 3, 3)
    near: torch.Tensor,                  # (B, V)
    far: torch.Tensor,                   # (B, V)
    image_shape: tuple[int, int],
    gaussian_means: torch.Tensor,        # (B, G, 3)
    gaussian_covariances: torch.Tensor,  # (B, G, 3, 3)
    gaussian_opacities: torch.Tensor,    # (B, G)
    scale_invariant: bool = True,
    mode: DepthRenderingMode = "depth",
    backend: str = "tiled",
) -> torch.Tensor:
    """Depth (B, V, H, W): each Gaussian's camera-space z in the view (its
    inverse, relative disparity or log with `mode`) composited as a
    3-channel DC color on a zero background, averaged over the channels.

    Each (scene, view) is rendered as a scene of one view with its own
    payload, as in the JAX package, which flattens (B, V) into scenes; here
    the scene's Gaussians are sliced for it, not copied.
    """
    b, v = extrinsics.shape[:2]
    w2c = invert_se3(extrinsics)                                   # (B, V, 4, 4)
    cam_points = torch.einsum("bvij,bgj->bvgi", w2c, homogenize_points(gaussian_means))
    fake_color = cam_points[..., 2]                                # (B, V, G)
    if mode == "disparity":
        fake_color = 1.0 / fake_color
    elif mode == "relative_disparity":
        fake_color = depth_to_relative_disparity(fake_color, near[:, :, None], far[:, :, None])
    elif mode == "log":
        fake_color = torch.log(torch.clamp(fake_color, min=torch.minimum(near, far)[:, :, None]))
    elif mode != "depth":
        raise ValueError(f"unknown depth rendering mode {mode!r}")

    g = gaussian_means.shape[1]
    views = []
    for i in range(b):
        for j in range(v):
            views.append(render(
                extrinsics[i : i + 1, j : j + 1], intrinsics[i : i + 1, j : j + 1],
                near[i : i + 1, j : j + 1], far[i : i + 1, j : j + 1], image_shape,
                fake_color.new_zeros((1, 3)), gaussian_means[i : i + 1],
                gaussian_covariances[i : i + 1], gaussian_opacities[i : i + 1],
                gaussian_color_sh=fake_color[i, j].reshape(1, g, 1, 1).expand(1, g, 3, 1),
                scale_invariant=scale_invariant, use_sh=False, backend=backend,
            ).color[0, 0])                                         # (3, H, W)
    h, w = image_shape
    return torch.stack(views).mean(dim=1).reshape(b, v, h, w)
