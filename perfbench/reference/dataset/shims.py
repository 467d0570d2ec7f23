"""The patch and bounds shims on device tensors (NHWC images)."""

from __future__ import annotations

import torch


def apply_patch_shim(batch: dict, patch_size: int) -> dict:
    """Center-crop images to a multiple of patch_size."""

    def per_views(views):
        h, w = views["image"].shape[-3:-1]
        assert h % 2 == 0 and w % 2 == 0
        h_new = (h // patch_size) * patch_size
        w_new = (w // patch_size) * patch_size
        row = (h - h_new) // 2
        col = (w - w_new) // 2
        image = views["image"][..., row : row + h_new, col : col + w_new, :]
        scale = views["intrinsics"].new_tensor(
            [[w / w_new, 1.0, 1.0], [1.0, h / h_new, 1.0], [1.0, 1.0, 1.0]]
        )
        return {**views, "image": image, "intrinsics": views["intrinsics"] * scale}

    return {**batch, "context": per_views(batch["context"]), "target": per_views(batch["target"])}


def compute_depth_for_disparity(
    extrinsics: torch.Tensor, intrinsics: torch.Tensor, image_shape: tuple[int, int],
    disparity: float, delta_min: float = 1e-6,
) -> torch.Tensor:
    """Depth at which the largest context baseline subtends `disparity` pixels."""
    origins = extrinsics[..., :3, 3]
    deltas = torch.linalg.norm(origins[:, None] - origins[:, :, None], dim=-1)
    baselines = deltas.clamp(min=delta_min).amax(dim=(1, 2))
    h, w = image_shape
    sizes = torch.stack([(1.0 / w) / intrinsics[..., 0, 0], (1.0 / h) / intrinsics[..., 1, 1]], dim=-1)
    return baselines / (disparity * sizes.mean(dim=(1, 2)))


def apply_bounds_shim(batch: dict, near_disparity: float, far_disparity: float) -> dict:
    """Near/far from disparity heuristics over the context baselines."""
    context, target = batch["context"], batch["target"]
    b, cv = context["image"].shape[:2]
    tv = target["image"].shape[1]
    hw = tuple(context["image"].shape[-3:-1])
    near = compute_depth_for_disparity(context["extrinsics"], context["intrinsics"], hw, near_disparity)
    far = compute_depth_for_disparity(context["extrinsics"], context["intrinsics"], hw, far_disparity)
    return {
        **batch,
        "context": {**context, "near": near[:, None].expand(b, cv), "far": far[:, None].expand(b, cv)},
        "target": {**target, "near": near[:, None].expand(b, tv), "far": far[:, None].expand(b, tv)},
    }
