"""3D views of a prediction (counterpart of
latentsplat_tpu/visualization/validation_in_3d.py): the Gaussians seen
along each world axis through `render_orthographic` (on the tiled
kernels), and the context (white) and target (red) camera rigs."""

from __future__ import annotations

import numpy as np
import torch

from ..ops.rasterize.api import render_orthographic
from .annotation import add_label
from .drawing.cameras import compute_equal_aabb_with_margin, draw_cameras


def render_projections(
    gaussians,                 # model.types.Gaussians, batched
    resolution: int,
    margin: float = 0.1,
    draw_label: bool = True,
    extra_label: str = "",
) -> np.ndarray:               # (b, 3, h', w', 3)
    """One image per axis: the camera looks along it from the scene's
    bounding cube (the same cube for every scene, as in the JAX package),
    with a 10-degree field of view."""
    means = gaussians.means
    b = means.shape[0]
    device = means.device
    scene_minima, scene_maxima = compute_equal_aabb_with_margin(
        means.min(dim=1).values, means.max(dim=1).values, margin=margin
    )
    extents = scene_maxima - scene_minima

    projections = []
    for look_axis in range(3):
        right_axis = (look_axis + 1) % 3
        down_axis = (look_axis + 2) % 3
        extrinsics = torch.zeros((b, 4, 4), dtype=torch.float32, device=device)
        extrinsics[:, right_axis, 0] = 1
        extrinsics[:, down_axis, 1] = 1
        extrinsics[:, look_axis, 2] = 1
        for axis in (right_axis, down_axis):
            extrinsics[:, axis, 3] = 0.5 * (scene_minima[:, axis] + scene_maxima[:, axis])
        extrinsics[:, look_axis, 3] = scene_minima[:, look_axis]
        extrinsics[:, 3, 3] = 1

        far = extents[:, look_axis]
        out = render_orthographic(
            extrinsics, extents[:, right_axis], extents[:, down_axis], torch.zeros_like(far), far,
            (resolution, resolution), torch.zeros((b, 3), device=device),
            gaussians.means, gaussians.covariances, gaussians.opacities,
            gaussian_color_sh=gaussians.color_harmonics, fov_degrees=10.0,
        )
        images = out.color[:, 0].permute(0, 2, 3, 1).cpu().numpy()
        if draw_label:
            label = f"{'XYZ'[right_axis]}{'XYZ'[down_axis]} Projection {extra_label}"
            images = np.stack([add_label(np.clip(x, 0, 1), label) for x in images])
        projections.append(images)

    h = max(p.shape[1] for p in projections)
    w = max(p.shape[2] for p in projections)
    padded = [
        np.pad(p, ((0, 0), (0, h - p.shape[1]), (0, w - p.shape[2]), (0, 0)), constant_values=1.0)
        for p in projections
    ]
    return np.stack(padded, axis=1)


def render_cameras(batch: dict, resolution: int) -> list[np.ndarray]:
    """The first scene's context (white) and target (red) cameras."""
    context, target = batch["context"], batch["target"]
    num_context = context["extrinsics"].shape[1]
    num_target = target["extrinsics"].shape[1]
    device = context["extrinsics"].device
    color = torch.ones((num_context + num_target, 3), device=device)
    color[num_context:, 1:] = 0

    def both(key):
        return torch.cat([context[key][0], target[key][0]])

    return draw_cameras(
        resolution, both("extrinsics"), both("intrinsics"), color, both("near"), both("far")
    )
