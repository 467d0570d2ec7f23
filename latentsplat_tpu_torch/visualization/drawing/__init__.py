from .cameras import draw_cameras
from .lines import draw_lines
from .points import draw_points

__all__ = ["draw_lines", "draw_points", "draw_cameras"]
