"""The render stage's share of its roofline: the least time the card could
take for a request's render work, over the device time of the program's
`decoder` span a request (splat_ms.serve).

The work is counted by the benchmark on the reference's render of the
checked requests, whatever implements the program's: the compositor's
(pair, pixel) evaluations up to each pixel's stop at EVAL_OPS each and its
composited (pair, pixel) combinations at 2 C + 3 (C the composited
channels with the depth), as PERF.md counts the composite kernels'; a
fixed count per (Gaussian, view) for the SH terms, the projection and the
tile cull; each input byte read once and each output byte written once.
The bound is the larger of the bytes over the memory bandwidth and the
float32 operations over the float32 peak.
"""

EVAL_OPS = 14
# float32 operations per (Gaussian, view): the SH terms (degree-4 color:
# 25 basis values at ~3 operations and 2 per coefficient and channel over 3
# channels; degree-2 features: 9 basis values and 2 per coefficient over 4
# channels), the EWA projection and the 9-slot tile cull.
SH_OPS = 25 * 3 + 2 * 25 * 3 + 9 * 3 + 2 * 9 * 4
PROJECTION_OPS = 150
CULL_OPS = 9 * 40
PEAK_FLOPS_FP32 = 67e12   # NVIDIA H100 SXM, float32 outside the tensor cores
PEAK_BYTES = 3.35e12      # HBM3


def read(summary: dict):
    work = summary.get("raster_work") or {}
    splat = summary.get("unit_device_s", {}).get("decoder")
    if not work.get("evaluations") or not splat:
        return None
    ops = (work["evaluations"] * EVAL_OPS + work["composited"] * (2 * work["channels"] + 3)
           + work["gaussian_views"] * (SH_OPS + PROJECTION_OPS + CULL_OPS))
    bound = max(ops / PEAK_FLOPS_FP32, work["bytes"] / PEAK_BYTES)
    return 100.0 * bound / splat
