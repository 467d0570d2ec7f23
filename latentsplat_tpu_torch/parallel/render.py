"""View-parallel rendering over devices (counterpart of
latentsplat_tpu/parallel/render.py).

Test-time and serving workloads render many target views of one scene.
Views are independent and the Gaussians are shared, so the views split
over devices: each device renders a contiguous shard of the view axis
against its own copy of the Gaussians, and the shards are concatenated on
the first device. No collective is needed.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..ops.rasterize.api import render
from ..ops.rasterize.types import RenderOutput

CAMERA_KEYS = ("extrinsics", "intrinsics", "near", "far")
GAUSSIAN_KEYS = (
    "background_color", "gaussian_means", "gaussian_covariances", "gaussian_opacities",
    "gaussian_color_sh", "gaussian_feature_sh",
)


def make_view_parallel_render(devices: Sequence, image_shape: tuple[int, int], **render_kwargs):
    """Returns render_fn(camera_batch, gaussians_batch) -> RenderOutput with
    the view axis (axis 1 of the camera arrays) split over `devices`.

    camera_batch: dict(extrinsics (B, V, 4, 4), intrinsics (B, V, 3, 3),
                       near (B, V), far (B, V))
    gaussians_batch: dict(background_color (B, 3), gaussian_means (B, G, 3),
                          gaussian_covariances, gaussian_opacities,
                          gaussian_color_sh, gaussian_feature_sh)
    V must be divisible by the number of devices (a device may appear more
    than once). Each shard's render runs on its device; the images land on
    devices[0]."""
    devices = [torch.device(d) for d in devices]

    def render_fn(cameras: dict, gaussians: dict) -> RenderOutput:
        v = cameras["extrinsics"].shape[1]
        if v % len(devices):
            raise ValueError(f"{v} views do not split over {len(devices)} devices")
        per = v // len(devices)
        shards = []
        for i, device in enumerate(devices):
            cams = {k: cameras[k][:, i * per : (i + 1) * per].to(device) for k in CAMERA_KEYS}
            gauss = {k: None if gaussians.get(k) is None else gaussians[k].to(device) for k in GAUSSIAN_KEYS}
            shards.append(render(
                cams["extrinsics"], cams["intrinsics"], cams["near"], cams["far"], image_shape,
                **gauss, **render_kwargs,
            ))

        def cat(name):
            # On the first shard's device: devices[0], or the host for the
            # pair counts that `render` keeps there.
            parts = [getattr(s, name) for s in shards]
            return None if parts[0] is None else torch.cat([p.to(parts[0].device) for p in parts], dim=1)

        return RenderOutput(**{name: cat(name) for name in ("color", "feature", "mask", "depth", "num_pairs")})

    return render_fn
