"""Feature PCA and uncertainty maps of a variational model's renders
(counterpart of latentsplat_tpu/scripts/render_uncertainty.py):

    python -m latentsplat_tpu_torch.scripts.render_uncertainty +experiment=re10k \\
        checkpointing.load=outputs/<run>/checkpoints/step_00200000 \\
        output_path=outputs/uncertainty

For every scene of the test loader, the context is encoded
deterministically, the Gaussians' feature mode is splatted to each target
view with colors and features, and each view is written as one PNG of
three panels: the color render, a PCA of the rendered feature means to
RGB, and the posterior's per-pixel std (mean over channels) as a turbo
heat map, to <output_path>/<scene>/<view>.png. Encoding and rendering run
on the card (the tiled kernels); the PCA runs in numpy on the host, as in
the JAX package, so its SVD's signs are numpy's. `main(argv,
device="cpu")` runs on the CPU.
"""

from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

from ..config import load_config
from ..misc.image_io import save_image
from ..visualization.color_map import apply_color_map
from ..visualization.layout import hcat
from . import resolve_device


def pca_rgb(features: np.ndarray) -> np.ndarray:
    """(h, w, c) -> (h, w, 3): the first 3 principal components, each
    stretched from its 1st to its 99th percentile onto [0, 1]."""
    h, w, c = features.shape
    flat = features.reshape(-1, c)
    flat = flat - flat.mean(axis=0)
    _, _, vt = np.linalg.svd(flat, full_matrices=False)
    proj = flat @ vt[:3].T
    lo, hi = np.quantile(proj, 0.01, axis=0), np.quantile(proj, 0.99, axis=0)
    proj = (proj - lo) / np.maximum(hi - lo, 1e-9)
    return np.clip(proj.reshape(h, w, 3), 0.0, 1.0)


def uncertainty_map(std: np.ndarray) -> np.ndarray:
    """(h, w, c) posterior std -> turbo heat map of its channel mean."""
    magnitude = std.mean(axis=-1)
    lo, hi = magnitude.min(), magnitude.max()
    return apply_color_map((magnitude - lo) / max(hi - lo, 1e-9))


def main(argv=None, device=None) -> Path:
    """Returns the output directory."""
    argv = argv if argv is not None else sys.argv[1:]
    experiment, overrides = None, []
    output_path = Path("outputs/uncertainty")
    for arg in argv:
        if arg.startswith("+experiment="):
            experiment = arg.split("=", 1)[1]
        elif arg.startswith("output_path="):
            output_path = Path(arg.split("=", 1)[1])
        else:
            overrides.append(arg)
    device = resolve_device(device, "render_uncertainty")

    cfg = load_config(experiment, overrides)
    if cfg.model.variational == "none":
        raise SystemExit("render_uncertainty needs a variational model (model.variational)")
    if cfg.checkpointing.load is None:
        raise SystemExit("render_uncertainty needs checkpointing.load=<checkpoint>")

    from ..training.checkpointing import load_checkpoint, resolve_checkpoint_uri
    from ..training.trainer import Trainer, _closing, strip_batch, to_device

    trainer = Trainer(cfg, output_path, device=device)
    restored = load_checkpoint(resolve_checkpoint_uri(cfg.checkpointing.load), device="cpu")
    model = trainer._generator(restored["generator"])
    with _closing(trainer._loader("test", 1, repeat=False)) as loader, torch.no_grad():
        for batch in loader:
            scene = batch["scene"][0] if isinstance(batch["scene"], list) else batch["scene"]
            shimmed = trainer.data_shim(to_device(strip_batch(batch), trainer.device))
            gaussians = model.encoder(shimmed["context"], 0, deterministic=True)
            target = shimmed["target"]
            size = model.scaled_size(model.scale_factor, target["image"].shape[-3:-1])
            rendered = model.decoder(
                gaussians.mode(), target["extrinsics"], target["intrinsics"],
                target["near"], target["far"], size, return_colors=True, return_features=True,
            )
            posterior = rendered.feature_posterior
            mean = posterior.mean[0].cpu().numpy()
            std = posterior.std[0].cpu().numpy() if posterior.logvar is not None else np.zeros_like(mean)
            color = rendered.color[0].cpu().numpy() if rendered.color is not None else None
            for v in range(mean.shape[0]):
                row = hcat(
                    color[v] if color is not None else pca_rgb(mean[v]),
                    pca_rgb(mean[v]),
                    uncertainty_map(std[v]),
                )
                save_image(row, output_path / scene / f"{v:0>3}.png")
            print(scene)
    trainer.logger.close()
    return output_path


if __name__ == "__main__":
    main()
