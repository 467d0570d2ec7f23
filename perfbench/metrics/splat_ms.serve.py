"""Device milliseconds a request spends in the program's `decoder` span
(model/decoder/splatting.py -> ops/rasterize/: SH terms, projection, tile
cull, pair duplication, sort, composite)."""


def read(summary: dict):
    value = summary.get("unit_device_s", {}).get("decoder")
    return value * 1e3 if value else None
