"""A training cell: the program's train step (`make_train_step`) over a new
batch a step, each step's logs read on the host as Trainer.fit reads them.

Set-up builds the one TrainState the window trains and drives it through
the traffic's `checked_steps` first steps, through the same call and feed
as the window, each on its own batch. The reference follows those steps
from the same weights, batches and noise once the window has closed and
the program's state is freed. Compared:
  * `render_q90`: the first step's render (the VAE decoder's skip input at
    full size: the rasterized colour and the sampled features, so the
    encoder and the rasterizer), each target view's 90th percentile of the
    elementwise gap over the reference's root mean square, the worst view;
    read by a forward hook while the step runs. A view that the step did
    not render reads as zeros. (The decoded image is not compared: a sound
    seed read half the control's gap there with its render agreeing,
    PERF.md);
  * `disc_real_gap`: the first step's discriminator loss on the real
    images (the `*/discriminator/real` logs), the gap over the reference's
    magnitude: a loss that no sampled depth reaches, so that it keeps the
    precision's rounding apart from the draws' discontinuities;
  * `grad_gap`: each leaf's first gradient as the optimizer takes it
    (clipped; worked out from Adam's first moment after step one, m / (1 -
    beta1)), the gap between the two norms over the larger of the
    reference's norm of that leaf and of the median leaf; the median leaf's;
  * `change_gap`: each leaf's change over the checked steps, measured
    alike, the median leaf's, leaving out the leaves whose reference
    gradient is under CHANGE_FLOOR of the median leaf's (Adam moves them by
    round-off alone).
The median leaf's and not the worst: the worst is a small leaf whose
gradient is a sum that nearly cancels (the VAE's post_quant_conv bias) or
a difference of hinge-mask counts (the PatchGAN's conv_out bias), which
swings from seed to seed on the program and the reference alike. Each
step's generator and discriminator totals swing with the depth draws as
much as a lower precision moves them, and are not compared (PERF.md).
"""

from __future__ import annotations

import contextlib
import statistics
import time

import torch

from . import harness, models, scenes

SPANS = ("generator_forward", "generator_backward", "generator_update", "discriminator")
LOSSES = ("generator/total", "discriminator/total")
CHANGE_FLOOR = 1e-3
RENDERED = ("render",)
QUANTILE = 0.9


def _step(ctx, state, train_step, index: int, timer=None) -> dict:
    batch, noise = scenes.make_request(ctx.config, ctx.traffic, ctx.seed, index, ctx.device)
    state, logs = train_step(state, batch, ctx.traffic["first_step"] + index, noise=noise, timer=timer)
    return {k: float(v) for k, v in logs.items()}


def _params(state) -> dict:
    named = dict(state.model.named_parameters())
    named.update({f"discriminator.{n}": p for n, p in state.discriminator.named_parameters()})
    return named


def program_gradients(state) -> dict:
    """{leaf: norm of its first clipped gradient} from the program's Adam
    first moments after one step, m / (1 - beta1)."""
    out = {}
    for prefix, opt in (("", state.opt_gen), ("discriminator.", state.opt_disc)):
        for label, group in opt.state.items():
            beta1 = opt.groups[label][1].betas[0]
            for name, mu in group["mu"].items():
                out[prefix + name] = float((mu.double() / (1.0 - beta1)).norm())
    return out


def reference_gradients(state) -> dict:
    """The same, from the reference's optimizers."""
    out = {}
    for prefix, opt in (("", state.opt_gen), ("discriminator.", state.opt_disc)):
        out.update({prefix + n: float(g.double().norm()) for n, g in opt.first_gradients().items()})
    return out


@contextlib.contextmanager
def first_render(model, out: dict):
    """Keeps on the host, one row a target view, what the first call
    through the VAE decoder of `model` takes as its full-size skip input
    (`render`)."""
    decoder = model.autoencoder.decoder
    skip = getattr(decoder, f"skip_conv_{len(decoder.cfg.block_out_channels) - 1}")

    def keep(module, args):
        if "render" not in out:
            out["render"] = args[0].detach().float().cpu()

    handle = skip.register_forward_pre_hook(keep)
    try:
        yield out
    finally:
        handle.remove()


def follow(ctx, state, train_step, gradients, timer=None) -> dict:
    """Drive `state` through the checked steps: each step's losses, the
    first step's render, the first gradients' norms (read by
    `gradients(state)`) and each leaf's change's norm."""
    start = {n: p.detach().clone() for n, p in _params(state).items()}
    logs, first = [], {}
    with first_render(state.model, first):
        logs.append(_step(ctx, state, train_step, 0, timer))
    grads = gradients(state)
    for i in range(1, ctx.traffic["checked_steps"]):
        logs.append(_step(ctx, state, train_step, i, timer))
    change = {n: float((p.detach().double() - start[n].double()).norm()) for n, p in _params(state).items()}
    return {"losses": [[step[k] for k in LOSSES] for step in logs], "logs": logs, "grads": grads,
            "change": change, **first}


def leaf_gaps(value: dict, reference: dict, leaves) -> dict:
    """{leaf: |value - reference| / max(reference, the median leaf's
    reference)} over `leaves`."""
    median = statistics.median(reference[n] for n in reference)
    return {n: abs(value[n] - reference[n]) / max(reference[n], median, 1e-30) for n in leaves}


def median_leaf_gap(value: dict, reference: dict, leaves) -> float:
    return statistics.median(leaf_gaps(value, reference, leaves).values())


def real_loss(logs: dict) -> float:
    """A step's discriminator loss on the real images, over its GAN sites."""
    return sum(v for k, v in logs.items() if k.endswith("/discriminator/real"))


def numbers(program: dict, reference: dict) -> dict:
    """The compared numbers of the program's (or a stand-in's) first steps
    against the reference's."""
    grads = reference["grads"]
    median = statistics.median(grads.values())
    moved = [n for n in grads if grads[n] >= CHANGE_FLOOR * median]
    real = real_loss(reference["logs"][0])
    views = {k: reference[k].shape[0] for k in RENDERED}
    return {
        **{f"{k}_q90": max(harness.view_gaps(program[k], reference[k], views[k], QUANTILE)) for k in RENDERED},
        "disc_real_gap": abs(real_loss(program["logs"][0]) - real) / max(abs(real), 1e-30),
        "grad_gap": median_leaf_gap(program["grads"], grads, grads),
        "change_gap": median_leaf_gap(program["change"], reference["change"], moved),
    }


def compare(ctx, program: dict) -> list:
    harness.reference_precision()
    state, train_step = models.reference_train_state(ctx.config, ctx.traffic["scenes"], ctx.seed, ctx.device)
    reference = follow(ctx, state, train_step, reference_gradients)
    del state, train_step
    return [[name, value, harness.limit(ctx, name)] for name, value in numbers(program, reference).items()]


def run(ctx: harness.Ctx) -> harness.Outcome:
    harness.program_precision(ctx.config)
    harness.stamp(ctx, "imported")
    _, state, train_step = models.program_train_state(ctx.config, ctx.traffic["scenes"], ctx.seed, ctx.device)
    harness.stamp(ctx, "program built")
    checked = follow(ctx, state, train_step, program_gradients)
    harness.sync(ctx.device)
    setup_s = time.perf_counter() - ctx.t_start
    cuda = ctx.device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(ctx.device)

    seconds = harness.window_seconds(ctx)
    steps, failed = 0, 0
    summary: dict = {}
    with harness.traced(ctx, SPANS, summary) as timer:
        start = time.perf_counter()
        while True:
            logs = _step(ctx, state, train_step, ctx.traffic["checked_steps"] + steps, timer)
            steps += 1
            if not all(torch.isfinite(torch.tensor(logs[k])) for k in LOSSES):
                failed += 1
            if time.perf_counter() - start >= seconds:
                break
        window_s = time.perf_counter() - start
    window_peak = torch.cuda.max_memory_allocated(ctx.device) if cuda else 0
    del state, train_step
    if cuda:
        torch.cuda.empty_cache()

    end_to_end = {"setup_s": setup_s, "train_step_s": window_s / steps, "train_peak_gib": window_peak / 2**30}
    if summary:
        summary.update(units=steps, unit_device_s={k: v / steps for k, v in summary["span_device_s"].items()})
    return harness.Outcome(steps, failed, end_to_end, compare(ctx, checked), max(setup_peak, window_peak),
                           summary)
