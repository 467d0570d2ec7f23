"""Convert a released latentSplat Lightning checkpoint into a port
checkpoint (counterpart of latentsplat_tpu/scripts/convert_checkpoint.py):

    python -m latentsplat_tpu_torch.scripts.convert_checkpoint re10k.ckpt checkpoints/re10k_converted
    python -m latentsplat_tpu_torch.main +experiment=re10k mode=test \\
        checkpointing.load=checkpoints/re10k_converted

The `.ckpt`'s keys follow the reference's module paths (encoder.*,
autoencoder.*, discriminator.*); `training.pretrained` maps them onto the
port's modules. The converted tensors are laid over a generator (and,
where the file has one, a PatchGAN discriminator) built and seeded as the
trainer builds them for the configuration given by the trailing
`+experiment=<name>` and `key=value` arguments (`+experiment=re10k` when
none is given), so the output holds whole state dicts: {"step": 0,
"generator": ..., "discriminator": ...}, one torch.save file. It prints
the tensors read, the tensors mapped, the file's tensors left unmapped
(BatchNorm running statistics apart) and the generator's tensors left at
their seeded values. The file is read
with `weights_only=True`; a checkpoint that needs full unpickling is read
only with --trust-pickle, which says so. Runs on the CPU.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from ..config import load_config
from ..main import parse_args
from ..model.discriminator.patch_gan import DiscriminatorPatchGan
from ..model.latentsplat import LatentSplat
from ..training.pretrained import (
    RecordingStateDict,
    convert_latentsplat_checkpoint,
    load_into,
    load_torch_state_dict,
)


BATCH_NORM_STATISTICS = ("running_mean", "running_var", "num_batches_tracked")


def main(argv=None) -> dict:
    """Returns the counts it prints."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("ckpt", type=Path, help="released .ckpt file")
    parser.add_argument("out", type=Path, help="output checkpoint file")
    parser.add_argument("overrides", nargs="*", help="+experiment=<name> and key=value of the model's configuration")
    parser.add_argument("--num-heads", type=int, default=12,
                        help="attention heads of the encoder's ViT backbone (12 for the shipped dino_vitb8 configs)")
    parser.add_argument("--trust-pickle", action="store_true",
                        help="read a checkpoint that needs full unpickling (runs code stored in the file)")
    args = parser.parse_args(argv)
    start = time.perf_counter()

    experiment, overrides = parse_args(args.overrides or ["+experiment=re10k"])
    cfg = load_config(experiment, overrides)
    if args.trust_pickle:
        print(f"reading {args.ckpt} with weights_only=False (--trust-pickle)")
    sd = RecordingStateDict(load_torch_state_dict(args.ckpt, trust_pickle=args.trust_pickle))
    print(f"read {len(sd)} tensors from {args.ckpt}")
    converted = convert_latentsplat_checkpoint(sd, num_heads=args.num_heads)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(cfg.seed)
        model = LatentSplat(cfg.model, tuple(cfg.dataset.background_color))
    load_into(model, converted["generator"])
    state = {"step": 0, "generator": model.state_dict()}
    if "discriminator" in converted:
        if not cfg.model.discriminator:
            raise SystemExit("the checkpoint has a discriminator, the configuration none")
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(cfg.seed)
            discriminator = DiscriminatorPatchGan(cfg.model.discriminator)
        state["discriminator"] = load_into(discriminator, converted["discriminator"]).state_dict()

    left = set(sd) - sd.read
    running = {k for k in left if k.endswith(BATCH_NORM_STATISTICS)}
    unmapped = sorted(left - running)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(state, args.out)
    counts = {
        "read": len(sd),
        "mapped": len(sd.read),
        "batch_norm_statistics": len(running),
        "unmapped": len(unmapped),
        "seeded": len(state["generator"]) - len(converted["generator"]),
        "seconds": time.perf_counter() - start,
    }
    print(f"mapped {counts['mapped']} of {counts['read']} tensors ({len(running)} BatchNorm running "
          f"statistics, which the port's train-mode BatchNorm does not use; {len(unmapped)} unmapped); "
          f"{counts['seeded']} of {len(state['generator'])} generator tensors keep their seeded values; "
          f"saved {args.out} ({', '.join(k for k in state if k != 'step')}) in {counts['seconds']:.2f} s")
    if unmapped:
        print("unmapped: " + ", ".join(unmapped[:20]) + (" ..." if len(unmapped) > 20 else ""))
    return counts


if __name__ == "__main__":
    main()
