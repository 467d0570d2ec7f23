"""The model's matrix-product, convolution and attention FLOPs over the
traced window, as a percent of the H100's dense bfloat16 peak: FLOPs a
unit (counted once on the reference at the cell's shapes, flops/<cell>.json)
times the units the window finished, over its seconds. Against the
bfloat16 peak no reading can pass 100%, and a lower precision shows as a
gain."""

PEAK_FLOPS = 989e12   # NVIDIA H100 SXM, dense bfloat16


def read(summary: dict):
    flops, units, window = summary.get("flops_per_unit"), summary.get("units"), summary.get("window_s")
    if not flops or not units or not window:
        return None
    return 100.0 * flops * units / window / PEAK_FLOPS
