"""Device milliseconds a step spends in the program's `generator_forward`
and `generator_backward` spans (training/step.py::generator_grads: the
encoder, the render, the VAE decode, LPIPS and the discriminator's logits
of the fakes, forward and backward, with the adaptive weight's probes)."""


def read(summary: dict):
    spans = summary.get("unit_device_s", {})
    value = spans.get("generator_forward", 0.0) + spans.get("generator_backward", 0.0)
    return value * 1e3 if value else None
