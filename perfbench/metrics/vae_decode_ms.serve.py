"""Device milliseconds a request spends in the program's
`autoencoder_decoder` span (the feature sample, the 1/8 resize and the
kl_f8 VAE decoder with its skips, model/autoencoder/kl.py)."""


def read(summary: dict):
    value = summary.get("unit_device_s", {}).get("autoencoder_decoder")
    return value * 1e3 if value else None
