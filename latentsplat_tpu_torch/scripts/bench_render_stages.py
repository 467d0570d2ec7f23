"""The render's stages at the train shape (the port's counterpart of the
repository's root bench_render_stages.py):

    python -m latentsplat_tpu_torch.scripts.bench_render_stages

The flagship re10k model at 256x256 (weights from seed 0) encodes
`entry.arc_batch(2, 2, 4, 256, 256)`'s context views once; on its sampled
Gaussians, each stage is timed as the median of ITERS calls after one
warm-up (host clock between synchronizes), without gradients:

  render_full_fwd            the render of all 2 x 4 target views
  project_sh_one_view        SH evaluation and projection of scene 0's view 0
  composite_tiled_one_view   that view's tile cull, duplication
                             (duplicate_with_keys), sort and compositing
                             (composite_forward)

Then `pass_stages` splits the render of scene 0's 4 views, one pass, by
stage, each stage run alone on the pass's inputs (the same timing):
SH terms, projection, tile cull, `duplicate_with_keys` (its wrapper, the
host read included), the sort, the attribute rows and `composite_forward`.
scripts/trace_render.py calls it at bench_render's 64 views.

bench_render_stages.py's count_pair_overflow_one_view has no counterpart:
the port sizes each view's pair buffer from the counted total, so there is
no static budget to overflow; one line says so. Prints "<stage>: <ms> ms"
lines after the card's name and power limit, then "pass of <n> views,
<stage>: <ms> ms" lines. Trailing key=value arguments
override the config (tests pass a narrow model). The command line runs on
the card; `main(argv, device="cpu")` on the CPU.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..entry import arc_batch, flagship_model, to_tensors
from ..ops.rasterize import kernels, tiled
from ..ops.rasterize.camera import project_gaussians_to_screen
from ..ops.rasterize.api import render
from ..ops.rasterize.shade import view_channels
from ..ops.rasterize.tiled import composite_tiled
from . import resolve_device
from .measure import device_name, screen_view, timed_ms

ITERS = 3
SIZE = 256
BATCH = 2
V_TARGET = 4


def pass_stages(scene: dict, size: int, precision: str, iters: int, device: torch.device) -> dict:
    """{stage: ms} of scene 0's views rendered as one pass at `precision`
    (no gradient): each stage timed alone (`timed_ms`), in order, on the
    outputs of the stages before it."""
    knobs = tiled.precision_knobs(precision)
    tiles = size // kernels.TILE
    n = scene["extrinsics"].shape[1]
    ext, intr, near = scene["extrinsics"][0], scene["intrinsics"][0], scene["near"][0]
    means = scene["gaussian_means"][0].expand(n, -1, -1)
    sh = [scene[k][0] for k in ("gaussian_color_sh", "gaussian_feature_sh")]
    if knobs.bf16_sh:
        sh = [x.to(torch.bfloat16).float() for x in sh]
    scale = 1.0 / near
    ext_s = ext.clone()
    ext_s[:, :3, 3] = ext[:, :3, 3] * scale[:, None]
    margin = tiled.FAST_CULL_MARGIN if knobs.wide_cull else tiled.CULL_MARGIN
    code_shift = tiled.depth_code_bits(tiles * tiles)[1]
    state: dict = {}

    def sh_terms(_):
        state["channels"] = view_channels(means, *sh, ext[:, :3, 3])

    def project(_):
        state["sg"] = project_gaussians_to_screen(
            means * scale[:, None, None], scene["gaussian_covariances"][0] * (scale * scale)[:, None, None, None],
            scene["gaussian_opacities"][0].expand(n, -1), state["channels"], ext_s, intr, (size, size))

    def tile_cull(_):
        state["rects"] = tiled.tile_rects(state["sg"], tiles, tiles, 9, margin)

    def duplicate_with_keys(_):
        depth = state["sg"].depth.reshape(-1)
        depth = tiled.truncated_depth(depth, code_shift) if knobs.tie_depth else depth.contiguous()
        counts, base, nx, mask = state["rects"]
        state["pairs"] = kernels.duplicate_with_keys(counts, mask, base, nx, depth, tiles, 9, n)

    def sort(_):
        state["sorted"] = tiled.sort_pairs(*state["pairs"][:2], n * tiles * tiles)

    def pack(_):
        state["attrs"] = tiled.quantize_attributes(tiled.pack_attributes(state["sg"]), knobs, code_shift, n)

    def composite_forward(_):
        gids, ranges, _ = state["sorted"]
        kernels.composite_forward(gids, ranges, state["attrs"], tiles, (size, size), f16_xy=knobs.f16_xy,
                                  bf16_mm=knobs.bf16_mm, coef=knobs.coef)

    stages = (sh_terms, project, tile_cull, duplicate_with_keys, sort, pack, composite_forward)
    with torch.no_grad():
        return {fn.__name__: timed_ms(fn, iters, device) for fn in stages}


def main(argv=None, device=None) -> dict:
    """Returns {stage: ms}."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--size", type=int, default=SIZE)
    parser.add_argument("--iters", type=int, default=ITERS)
    parser.add_argument("overrides", nargs="*", help="config overrides key=value")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])
    device = resolve_device(device, "bench_render_stages")
    size = args.size
    cfg, model = flagship_model([f"dataset.image_shape=[{size},{size}]", *args.overrides], device)
    batch = to_tensors(arc_batch(BATCH, 2, V_TARGET, size, size), device)
    generator = torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        gaussians = model.encoder(batch["context"], 0, deterministic=False, generator=generator).sample(generator)
    print(f"device: {device_name(device)}")
    print(f"G per scene = {gaussians.means.shape[1]}")
    tgt = batch["target"]
    cap = cfg.model.decoder.max_tiles_per_gaussian
    n_views = BATCH * V_TARGET
    out = {}

    def full(_):
        render(tgt["extrinsics"], tgt["intrinsics"], tgt["near"], tgt["far"], (size, size),
               torch.zeros((BATCH, 3), device=device), gaussians.means, gaussians.covariances, gaussians.opacities,
               gaussians.color_harmonics, gaussians.feature_harmonics, max_tiles_per_gaussian=cap)

    scene = {"extrinsics": tgt["extrinsics"], "intrinsics": tgt["intrinsics"], "near": tgt["near"],
             "gaussian_means": gaussians.means, "gaussian_covariances": gaussians.covariances,
             "gaussian_opacities": gaussians.opacities, "gaussian_color_sh": gaussians.color_harmonics,
             "gaussian_feature_sh": gaussians.feature_harmonics}

    def project(_=None):   # scene 0's view 0
        return screen_view(scene, size, 0)

    with torch.no_grad():
        out["render_full_fwd"] = timed_ms(full, args.iters, device)
        print(f"render_full_fwd: {out['render_full_fwd']:.1f} ms ({out['render_full_fwd'] / n_views:.1f}/view)")
        out["project_sh_one_view"] = timed_ms(project, args.iters, device)
        print(f"project_sh_one_view: {out['project_sh_one_view']:.2f} ms")
        print("count_pair_overflow_one_view: no counterpart (the port sizes each view's pair buffer from its "
              "counted total: there is no static pair budget to overflow)")
        sg = project()
        background = torch.zeros(sg.channels.shape[-1], device=device)
        out["composite_tiled_one_view"] = timed_ms(lambda _: composite_tiled(sg, (size, size), background, cap),
                                                   args.iters, device)
        print(f"composite_tiled_one_view (incl duplication+sort+kernel): {out['composite_tiled_one_view']:.2f} ms")
    for name, ms in pass_stages(scene, size, "exact", args.iters, device).items():
        out[f"pass_{name}"] = ms
        print(f"pass of {V_TARGET} views, {name}: {ms:.2f} ms")
    return out


if __name__ == "__main__":
    main()
