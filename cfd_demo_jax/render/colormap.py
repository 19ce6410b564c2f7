"""On-device field rendering: colormapped uint8 images.

The reference colormaps on the host every frame from a full deep copy
of the fields (src/app.rs:235-429; index.html:999-1066). Device
design: normalization (min/max reductions) and the blue->red map run
on device under jit, and only the uint8 RGB image crosses to the host
(SURVEY.md section 2.7 "snapshot channel").

Color map (both references): r = 255*norm, g = 0, b = 255*(1-norm)
(src/app.rs:258-260, index.html:1069-1074). Rust overlays obstacle
cells in gray (src/app.rs:263-276). Rows are flipped so y points up
(index.html:1046: cellY uses Ny-1-j).
"""
from __future__ import annotations

import enum
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import Grid
from ..core.masks import cell_mask
from ..ops.vorticity import velocity_magnitude, vorticity


class VisualizationMode(enum.Enum):
    """src/app.rs:504-509 + the JS tracer view."""

    PRESSURE = "pressure"
    VELOCITY = "velocity"
    VORTICITY = "vorticity"


def field_for_mode(u, v, p, mode: VisualizationMode, dx: float, dy: float):
    if mode == VisualizationMode.PRESSURE:
        return p
    if mode == VisualizationMode.VELOCITY:
        return velocity_magnitude(u, v)
    if mode == VisualizationMode.VORTICITY:
        return vorticity(u, v, dx, dy)
    raise ValueError(mode)


def colormap_rgb(field: jnp.ndarray, obstacle: jnp.ndarray | None = None,
                 flip_y: bool = True) -> jnp.ndarray:
    """(ny, nx) scalar field -> (ny, nx, 3) uint8, min-max normalized.

    ``obstacle`` is an optional (ny, nx) bool/float mask drawn gray
    (src/app.rs:263-276: RGB 128,128,128).
    """
    lo = jnp.min(field)
    hi = jnp.max(field)
    norm = (field - lo) / jnp.where(hi == lo, 1.0, hi - lo)
    r = (norm * 255.0).astype(jnp.uint8)
    b = ((1.0 - norm) * 255.0).astype(jnp.uint8)
    g = jnp.zeros_like(r)
    img = jnp.stack([r, g, b], axis=-1)
    if obstacle is not None:
        img = jnp.where((obstacle > 0)[..., None],
                        jnp.uint8(128), img)
    if flip_y:
        img = img[::-1, :, :]
    return img


@partial(jax.jit, static_argnames=("mode", "grid", "with_obstacle", "flip_y"))
def render_field(u, v, p, *, grid: Grid, mode: VisualizationMode,
                 with_obstacle: bool = True, flip_y: bool = True):
    """Fully on-device render; returns a (ny, nx, 3) uint8 device array."""
    field = field_for_mode(u, v, p, mode, grid.dx, grid.dy)
    obstacle = None
    if with_obstacle and grid.obstacles:
        obstacle = jnp.asarray(cell_mask(grid, inclusive=False),
                               jnp.float32)
    return colormap_rgb(field, obstacle, flip_y)


def legend_strip(width: int = 256, height: int = 24) -> np.ndarray:
    """Horizontal blue->red gradient with tick marks
    (index.html:1199-1226). Host-side (static UI furniture)."""
    norm = np.linspace(0.0, 1.0, width, dtype=np.float32)
    r = (norm * 255).astype(np.uint8)
    b = ((1 - norm) * 255).astype(np.uint8)
    img = np.zeros((height, width, 3), np.uint8)
    img[:, :, 0] = r[None, :]
    img[:, :, 2] = b[None, :]
    for i in range(11):
        x = min(int(i / 10 * (width - 1)), width - 1)
        img[height - 5:, x, :] = 0
    return img


def boundary_overlay(img: np.ndarray) -> np.ndarray:
    """Color the domain boundary edges: inlet green, outlet blue,
    walls magenta (index.html:1077-1108)."""
    out = img.copy()
    out[:, 0] = (0, 128, 0)        # inlet (left, green)
    out[:, -1] = (0, 0, 255)       # outlet (right, blue)
    out[0, :] = (255, 0, 255)      # wall (magenta)
    out[-1, :] = (255, 0, 255)
    return out
