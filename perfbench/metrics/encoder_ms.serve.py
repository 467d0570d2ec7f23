"""Device milliseconds a request spends in the program's `encoder` span
(model/encoder/: backbone, epipolar sampler and transformer, depth
predictor, Gaussian adapter), launches matched by correlation id."""


def read(summary: dict):
    value = summary.get("unit_device_s", {}).get("encoder")
    return value * 1e3 if value else None
