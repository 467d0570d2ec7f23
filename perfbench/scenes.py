"""The traffic generator: one scene (or one training batch) per request,
made on the device from (seed, request index).

A configuration's `scene` block fixes the camera layout of its dataset:
  * "forward" (RealEstate10k): two context cameras a baseline of 1 apart
    (the dataset's make_baseline_1), both looking at a focus point a few
    baselines ahead, the second displaced sideways and forwards in a random
    direction; targets lie between them (the bounded view sampler);
  * "circle" (CO3D, cameras_are_circular): cameras on a circle about the
    object, looking at its center, the two context views `gap` frames
    apart of an orbit of `orbit_frames` frames, the radius set so that
    their baseline is 1; targets between them.
A traffic mix's `targets` block places the targets: "between" draws each
at a uniform fraction of the way from the first context camera to the
second (sorted); "interpolate" puts `count` views on the path with
cosine-eased times, as Trainer.render_video's interpolation does
(t = (cos(pi (s + 1)) + 1) / 2 over s evenly in [0, 1]). Images are
uniform noise in [0, 1].

The probabilistic render's noise (`noise`) has the shapes the model
draws: depth uniforms (b, v, h w, surfaces, gaussians per pixel), the
Gaussians' feature normals (b, v h w spp, latent channels, feature SH
coefficients) and the latent normals (b, targets, h, w, latent channels).
"""

from __future__ import annotations

import math

import torch

from .weights import seeded

# Stream numbers of a run's draws: weights below REQUEST_STREAM.
REQUEST_STREAM = 1 << 20


def look_at(position: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Camera-to-world (n, 4, 4), OpenCV axes (x right, y down, z forward),
    of cameras at `position` (n, 3) looking at `target` (n, 3)."""
    z = target - position
    z = z / z.norm(dim=-1, keepdim=True)
    up = torch.tensor([0.0, -1.0, 0.0], device=position.device).expand_as(z)
    x = torch.linalg.cross(up, z)
    x = x / (x.norm(dim=-1, keepdim=True) + 1e-9)
    y = torch.linalg.cross(z, x)
    ext = torch.eye(4, device=position.device).repeat(position.shape[0], 1, 1)
    ext[:, :3, 0], ext[:, :3, 1], ext[:, :3, 2], ext[:, :3, 3] = x, y, z, position
    return ext


def _uniform(g: torch.Generator, device, *shape) -> torch.Tensor:
    return torch.rand(shape, generator=g, device=device)


def target_times(targets: dict, g: torch.Generator, device) -> torch.Tensor:
    """(count,) fractions of the way from context view 0 to view 1."""
    count = targets["count"]
    if targets["placement"] == "between":
        return torch.sort(_uniform(g, device, count)).values
    if targets["placement"] == "interpolate":
        s = torch.linspace(0.0, 1.0, count, device=device)
        return (torch.cos(math.pi * (s + 1.0)) + 1.0) / 2.0
    raise ValueError(f"unknown target placement {targets['placement']!r}")


def cameras(scene: dict, times: torch.Tensor, g: torch.Generator, device) -> torch.Tensor:
    """Extrinsics (2 + len(times), 4, 4): the two context views, then one
    view at each fraction of `times` along the way between them."""
    t = torch.cat([torch.tensor([0.0, 1.0], device=device), times])
    if scene["layout"] == "forward":
        lo, hi = scene["focus_distance"]
        focus = torch.stack([(_uniform(g, device) - 0.5) * 0.5, (_uniform(g, device) - 0.5) * 0.2,
                             lo + (hi - lo) * _uniform(g, device)]).reshape(1, 3)
        angle = math.radians(scene["baseline_angle_deg"]) * (2.0 * _uniform(g, device) - 1.0)
        step = torch.stack([torch.cos(angle), 0.1 * (2.0 * _uniform(g, device) - 1.0), torch.sin(angle)]).reshape(1, 3)
        step = step / step.norm()
        position = t[:, None] * step
        return look_at(position, focus.expand_as(position))
    if scene["layout"] == "circle":
        lo, hi = scene["context_gap_frames"]
        gap = lo + torch.floor(_uniform(g, device) * (hi - lo + 1))
        span = 2.0 * math.pi * gap / scene["orbit_frames"]
        radius = 1.0 / (2.0 * torch.sin(span / 2.0))
        start = 2.0 * math.pi * _uniform(g, device)
        angle = start + span * t
        height = (scene["height"] * radius).expand_as(angle)
        position = torch.stack([radius * torch.cos(angle), height, radius * torch.sin(angle)], dim=-1)
        return look_at(position, torch.zeros_like(position))
    raise ValueError(f"unknown camera layout {scene['layout']!r}")


def _views(ext: torch.Tensor, scene: dict, image_shape, b: int, g, device) -> dict:
    v = ext.shape[0]
    h, w = image_shape
    f = scene["focal"]
    intr = torch.tensor([[f, 0.0, 0.5], [0.0, f, 0.5], [0.0, 0.0, 1.0]], device=device)
    return {
        "extrinsics": ext[None].expand(b, v, 4, 4).contiguous(),
        "intrinsics": intr.expand(b, v, 3, 3).contiguous(),
        "image": _uniform(g, device, b, v, h, w, 3),
        "near": torch.full((b, v), float(scene["near"]), device=device),
        "far": torch.full((b, v), float(scene["far"]), device=device),
    }


def make_batch(config: dict, traffic: dict, seed: int, index: int, device) -> dict:
    """Request (or step) `index`'s batch: {"context", "target"} views of
    traffic["scenes"] scenes, each with its own cameras."""
    g = seeded(seed, REQUEST_STREAM + index, device)
    scene = config["scene"]
    image_shape = tuple(config["model_input"]["image_shape"])
    context, target = [], []
    for _ in range(traffic["scenes"]):
        times = target_times(traffic["targets"], g, device)
        ext = cameras(scene, times, g, device)
        context.append(_views(ext[:2], scene, image_shape, 1, g, device))
        target.append(_views(ext[2:], scene, image_shape, 1, g, device))

    def cat(views):
        return {k: torch.cat([x[k] for x in views]) for k in views[0]}

    return {"context": cat(context), "target": cat(target)}


def render_shape(config: dict) -> tuple[int, int]:
    """The render's size: the image's times supersampling over the VAE's
    downscale (2 ** (number of blocks - 1))."""
    model = config["model"]
    scale = model["supersampling_factor"] / 2 ** (len(model["autoencoder"]["block_out_channels"]) - 1)
    return tuple(int(s * scale) for s in config["model_input"]["image_shape"])


def make_noise(config: dict, traffic: dict, seed: int, index: int, device) -> dict:
    """Request `index`'s noise for the probabilistic render or the step."""
    g = seeded(seed, REQUEST_STREAM + index, device)
    g.manual_seed(g.initial_seed() ^ 0x5EED)
    enc = config["model"]["encoder"]
    b = traffic["scenes"]
    h, w = render_shape(config)
    spp, srf = enc["gaussians_per_pixel"], enc["num_surfaces"]
    c = config["model"]["autoencoder"]["latent_channels"]
    sh = (enc["gaussian_adapter"]["feature_sh_degree"] + 1) ** 2
    v = traffic["context_views"]
    n = traffic["targets"]["count"]
    return {
        "depth": torch.rand((b, v, h * w, srf, spp), generator=g, device=device),
        "gaussians": torch.randn((b, v * h * w * srf * spp, c, sh), generator=g, device=device),
        "latent": torch.randn((b, n, h, w, c), generator=g, device=device),
    }


def make_request(config: dict, traffic: dict, seed: int, index: int, device) -> tuple[dict, dict]:
    """(batch, noise) of request or step `index`."""
    return (make_batch(config, traffic, seed, index, device), make_noise(config, traffic, seed, index, device))
