"""A serving cell: one client in a closed loop sends requests to the
program's `render_full` (probabilistic, as Trainer.test and
Trainer.render_video call it), each request a new scene with its noise.
The cell's throughput, target views of the finished requests over the
window, is reported under the name its traffic file gives (`metric`).

A request's latency runs from its issue (its inputs made and on the
device) to its image, render and depth copied to the host. A request
fails if an output is not finite (checked on the device). The host keeps
the outputs of a sample of the finished requests only, drawn from the
seed as the window goes (the `check_requests` finished ones of least
priority, each request's priority drawn from the seed). After the window
the program is freed and the reference renders the sample from the same
inputs and noise; each output's gap (`compare`), the worst over the
sample's views, decides `correct`.
"""

from __future__ import annotations

import contextlib
import statistics
import time

import numpy as np
import torch

from . import harness, models, scenes
from .reference.ops.rasterize import plain

SPANS = ("encoder", "decoder", "autoencoder_decoder")
OUTPUTS = ("image", "render", "depth")
# Requests 0, 1, ... are the window's; the warm-up's come after any the
# window can reach.
WARM_UP_INDEX = 1 << 19
WARM_UP_REQUESTS = 2
# Per (Gaussian, scene) float32 values read once by the render: mean 3,
# covariance 9, opacity 1; the SH tables are counted from their shapes.
GAUSSIAN_VALUES = 13
QUANTILE = 0.9


def _request(ctx, model, index: int, timer=None):
    """(latency seconds, outputs on the host, whether all are finite) of
    request `index`; its inputs are made before it is issued."""
    from latentsplat_tpu_torch.model.latentsplat import render_full

    batch, noise = scenes.make_request(ctx.config, ctx.traffic, ctx.seed, index, ctx.device)
    harness.sync(ctx.device)
    start = time.perf_counter()
    with torch.profiler.record_function("request") if timer else contextlib.nullcontext():
        out = render_full(model, batch, noise=noise, timer=timer)
        finite = torch.stack([torch.isfinite(out[k]).all() for k in OUTPUTS]).all()
        host = {k: out[k].cpu() for k in OUTPUTS}
    latency = time.perf_counter() - start
    return latency, host, bool(finite)


def _reference(ctx, model, index: int) -> dict:
    from .reference.model.latentsplat import render_full

    batch, noise = scenes.make_request(ctx.config, ctx.traffic, ctx.seed, index, ctx.device)
    out = render_full(model, batch, noise=noise)
    return {k: out[k].cpu() for k in OUTPUTS}


class Sample:
    """The finished requests the reference checks: the `size` of least
    priority, a uniform sample of them drawn from the seed. Only their
    outputs stay on the host."""

    def __init__(self, seed: int, size: int):
        self.priority = torch.rand(WARM_UP_INDEX, generator=torch.Generator().manual_seed(int(seed))).tolist()
        self.size = size
        self.outputs: dict = {}

    def offer(self, index: int, outputs: dict) -> None:
        self.outputs[index] = outputs
        if len(self.outputs) > self.size:
            del self.outputs[max(self.outputs, key=self.priority.__getitem__)]


def compare(ctx, outputs: dict, checked: list[int]) -> tuple[list, dict]:
    """([name, widest relative gap, limit] of each output over the checked
    requests' views, the compositor's work a request), the reference run
    on the device in float32."""
    harness.reference_precision()
    model = models.reference_generator(ctx.config, ctx.seed, ctx.device)
    gaps = {k: 0.0 for k in OUTPUTS}
    views = ctx.traffic["scenes"] * ctx.traffic["targets"]["count"]
    # Each view's 90th percentile of its elementwise gap, over the
    # reference's root mean square: the pixels that sampled another depth
    # bucket on one side (a float32 tie in the inverse-CDF draw) are fewer
    # than a tenth of a view and do not move it; a precision lower than
    # the configuration's moves every pixel (PERF.md, the readings).
    for key in plain.work:
        plain.work[key] = 0
    with torch.no_grad():
        for index in checked:
            ref = _reference(ctx, model, index)
            for k in OUTPUTS:
                gaps[k] = max(gaps[k], *harness.view_gaps(outputs[index][k], ref[k], views, QUANTILE))
    work = {k: v / max(len(checked), 1) for k, v in plain.work.items()}
    work["channels"] = plain.work["channels"]
    return [[f"{k}_q90", gaps[k], harness.limit(ctx, f"{k}_q90")] for k in OUTPUTS], work


def raster_size(ctx) -> dict:
    """A request's render: the bytes it reads once and writes once (each
    scene's Gaussians: mean, covariance, opacity, SH tables; each target
    view's channels, mask and depth) and its (Gaussian, view) rows."""
    enc = ctx.config["model"]["encoder"]
    h, w = scenes.render_shape(ctx.config)
    gaussians = ctx.traffic["context_views"] * h * w * enc["gaussians_per_pixel"] * enc["num_surfaces"]
    ad = enc["gaussian_adapter"]
    latent = ctx.config["model"]["autoencoder"]["latent_channels"]
    sh = 3 * (ad["color_sh_degree"] + 1) ** 2 + latent * (ad["feature_sh_degree"] + 1) ** 2
    views = ctx.traffic["targets"]["count"]
    read = ctx.traffic["scenes"] * gaussians * (GAUSSIAN_VALUES + sh) * 4
    written = ctx.traffic["scenes"] * views * h * w * (3 + latent + 2) * 4
    return {"bytes": float(read + written), "gaussian_views": gaussians * views * ctx.traffic["scenes"]}


def run(ctx: harness.Ctx) -> harness.Outcome:
    harness.program_precision(ctx.config)
    harness.stamp(ctx, "imported")
    _, model = models.program_generator(ctx.config, ctx.seed, ctx.device)
    harness.stamp(ctx, "program built")
    for i in range(WARM_UP_REQUESTS):
        _request(ctx, model, WARM_UP_INDEX + i)
    harness.sync(ctx.device)
    setup_s = time.perf_counter() - ctx.t_start
    setup_peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0

    seconds = harness.window_seconds(ctx)
    latencies, finished = [], 0
    checked = Sample(ctx.seed, ctx.traffic["check_requests"])
    summary: dict = {}
    with harness.traced(ctx, SPANS, summary) as timer:
        start = time.perf_counter()
        index = 0
        while True:
            latency, outputs, finite = _request(ctx, model, index, timer)
            latencies.append(latency)
            if finite:
                finished += 1
                checked.offer(index, outputs)
            del outputs
            index += 1
            if time.perf_counter() - start >= seconds:
                break
        window_s = time.perf_counter() - start
    peak = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    del model
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()

    failed = len(latencies) - finished
    views = ctx.traffic["scenes"] * ctx.traffic["targets"]["count"]
    compared, work = compare(ctx, checked.outputs, sorted(checked.outputs)) if finished else ([], {})
    end_to_end = {
        "setup_s": setup_s,
        ctx.traffic["metric"]: views * finished / window_s,
    }
    if summary:
        n = len(latencies)
        summary.update(
            units=n,
            unit_device_s={k: v / n for k, v in summary["span_device_s"].items()},
            raster_work=dict(work, **raster_size(ctx)),
            latency_p90_s=float(np.percentile(latencies, 90)),
            latency_median_s=statistics.median(latencies),
        )
    return harness.Outcome(len(latencies), failed, end_to_end, compared, max(peak, setup_peak), summary)
