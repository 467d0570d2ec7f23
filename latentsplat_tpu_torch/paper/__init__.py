"""Paper tooling: LaTeX tables and figure generators (counterpart of
latentsplat_tpu/paper/) over test runs' outputs. Figures are raster PNGs
composed with `visualization.layout`, as in the JAX package; labels use
the port's bitmap font, so their glyphs differ from the JAX package's.
"""

from .table import make_latex_table

__all__ = ["make_latex_table"]
