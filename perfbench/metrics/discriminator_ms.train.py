"""Device milliseconds a step spends in the program's `discriminator` span
(model/discriminator/patch_gan.py on the fakes and the real images, its
backward and its Adam update)."""


def read(summary: dict):
    value = summary.get("unit_device_s", {}).get("discriminator")
    return value * 1e3 if value else None
