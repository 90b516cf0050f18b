from .html3d import plot3d_html
from .plotting import animation_html, plot, save_animation

__all__ = ["animation_html", "plot", "plot3d_html", "save_animation"]
