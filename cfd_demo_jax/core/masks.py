"""Obstacle mask construction.

The two reference implementations treat internal solid boundaries
differently, and we reproduce both as precomputed float32 mask arrays
(select-to-zero is branch-free):

* Rust (model.rs:232-261): cells whose *center* lies strictly inside
  the cylinder mark **both** adjacent u faces (west i and east i+1) and
  both adjacent v faces (south j and north j+1) in the predictor masks;
  the end-of-substep boundary conditions additionally zero only the
  *west* u face and *south* v face of each obstacle cell
  (model.rs:869-874).

* JS (index.html:377-380, :559-562, :912-929): the predictor and the
  boundary conditions both test the *face position itself* against the
  obstacle (u face at (i*dx, (j+0.5)*dy), v face at ((i+0.5)*dx, j*dy)),
  with distance <= radius (inclusive, index.html:214).

Masks are returned as float32 arrays with 1.0 = solid (zero the
velocity there), matching the array shapes of the fields they apply to.
Rectangular obstacles (Box) are a new capability for BASELINE.json
config 4 (square-obstacle wake) and use the same cell/face rules.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from .config import Box, Cylinder, Grid, Semantics


def _inside(obstacle, x, y, inclusive: bool) -> np.ndarray:
    if isinstance(obstacle, Cylinder):
        d2 = (x - obstacle.center_x) ** 2 + (y - obstacle.center_y) ** 2
        r2 = obstacle.radius ** 2
        return d2 <= r2 if inclusive else d2 < r2
    if isinstance(obstacle, Box):
        ax = np.abs(x - obstacle.center_x)
        ay = np.abs(y - obstacle.center_y)
        if inclusive:
            return (ax <= obstacle.half_w) & (ay <= obstacle.half_h)
        return (ax < obstacle.half_w) & (ay < obstacle.half_h)
    raise TypeError(f"unknown obstacle type: {type(obstacle)}")


def _any_inside(grid: Grid, x, y, inclusive: bool) -> np.ndarray:
    acc = np.zeros(np.broadcast_shapes(np.shape(x), np.shape(y)), dtype=bool)
    for obs in grid.obstacles:
        acc |= _inside(obs, x, y, inclusive)
    return acc


def cell_mask(grid: Grid, inclusive: bool = False) -> np.ndarray:
    """(ny, nx) bool: pressure-cell center inside an obstacle.

    Rust uses strict `<` on the distance (model.rs:243); JS uses `<=`
    (index.html:214).
    """
    xs = (np.arange(grid.nx) + 0.5) * grid.dx
    ys = (np.arange(grid.ny) + 0.5) * grid.dy
    return _any_inside(grid, xs[None, :], ys[:, None], inclusive)


def build_masks(grid: Grid, semantics: Semantics) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Returns (mask_u_star, mask_v_star, mask_u_bc, mask_v_bc) float32.

    mask_*_star zero the predictor output; mask_*_bc zero the velocity
    in apply_boundary_conditions.
    """
    ny, nx = grid.ny, grid.nx
    if semantics == Semantics.RUST:
        cells = cell_mask(grid, inclusive=False)
        mask_u = np.zeros((ny, nx + 1), dtype=bool)
        mask_v = np.zeros((ny + 1, nx), dtype=bool)
        jj, ii = np.nonzero(cells)
        # model.rs:244-256: mark west face (if i>0), east face (if i<nx),
        # south face (if j>0), north face (if j<ny).
        w = ii > 0
        mask_u[jj[w], ii[w]] = True
        e = ii < nx
        mask_u[jj[e], ii[e] + 1] = True
        s = jj > 0
        mask_v[jj[s], ii[s]] = True
        n = jj < ny
        mask_v[jj[n] + 1, ii[n]] = True
        # BCs zero only the west u face / south v face of obstacle cells
        # (model.rs:869-874).
        mask_u_bc = np.zeros((ny, nx + 1), dtype=bool)
        mask_v_bc = np.zeros((ny + 1, nx), dtype=bool)
        mask_u_bc[jj, ii] = True
        mask_v_bc[jj, ii] = True
    else:
        # JS: face-position test, inclusive radius.
        xu = np.arange(nx + 1) * grid.dx
        yu = (np.arange(ny) + 0.5) * grid.dy
        mask_u = _any_inside(grid, xu[None, :], yu[:, None], inclusive=True)
        xv = (np.arange(nx) + 0.5) * grid.dx
        yv = np.arange(ny + 1) * grid.dy
        mask_v = _any_inside(grid, xv[None, :], yv[:, None], inclusive=True)
        mask_u_bc = mask_u
        mask_v_bc = mask_v
    f32 = np.float32
    # v is stored without its implicit-zero top face row (Grid.shape_v);
    # a mask there would only re-zero an already-zero row.
    return (mask_u.astype(f32), mask_v[:ny].astype(f32),
            mask_u_bc.astype(f32), mask_v_bc[:ny].astype(f32))


# ---------------------------------------------------------------------------
# Traced (on-device) mask construction
# ---------------------------------------------------------------------------
#
# Baking mask arrays into the jit program embeds O(ny*nx) constants in
# the HLO (267 MB at 8192^2). The device path computes the same masks
# analytically from
# broadcast iota coordinates inside the fused stencil: a few flops per
# cell, no HBM reads, no constants.

def _inside_traced(obstacle, x, y, inclusive: bool):
    import jax.numpy as jnp
    if isinstance(obstacle, Cylinder):
        d2 = ((x - obstacle.center_x) ** 2 + (y - obstacle.center_y) ** 2)
        r2 = obstacle.radius ** 2
        return d2 <= r2 if inclusive else d2 < r2
    if isinstance(obstacle, Box):
        ax = jnp.abs(x - obstacle.center_x)
        ay = jnp.abs(y - obstacle.center_y)
        if inclusive:
            return (ax <= obstacle.half_w) & (ay <= obstacle.half_h)
        return (ax < obstacle.half_w) & (ay < obstacle.half_h)
    raise TypeError(f"unknown obstacle type: {type(obstacle)}")


def _any_inside_traced(grid: Grid, x, y, inclusive: bool):
    import jax.numpy as jnp
    acc = None
    for obs in grid.obstacles:
        m = _inside_traced(obs, x, y, inclusive)
        acc = m if acc is None else (acc | m)
    return acc


def masks_traced(grid: Grid, semantics: Semantics, dtype,
                 ctx=None, shp_u=None, shp_v=None):
    """(mask_u, mask_v, mask_u_bc, mask_v_bc) as traced bool arrays in
    the storage shapes ((ny, nx+1), (ny, nx), ...). Returns None
    tuple when the scene has no obstacles (callers skip the selects).

    ``ctx`` (ops.stencil.StencilCtx) supplies the index arrays;
    ``shp_u``/``shp_v`` override the u/v shapes the masks are built
    for."""
    import jax.numpy as jnp
    if ctx is None:
        from ..ops.stencil import DEFAULT_CTX
        ctx = DEFAULT_CTX
    if not grid.obstacles:
        return None, None, None, None
    ny, nx = grid.ny, grid.nx
    dx, dy = grid.dx, grid.dy
    if shp_u is None:
        shp_u = (ny, nx + 1)
    if shp_v is None:
        shp_v = (ny, nx)

    def coords(shape, x_off, y_off):
        i = ctx.col_index(shape).astype(dtype)
        j = ctx.row_index(shape).astype(dtype)
        return (i + x_off) * dx, (j + y_off) * dy

    if semantics == Semantics.RUST:
        # Cell-center test marks both adjacent faces (model.rs:232-261).
        xcw, ycw = coords(shp_u, -0.5, 0.5)   # cell west of u face f
        xce, yce = coords(shp_u, 0.5, 0.5)    # cell east of u face f
        iu = ctx.col_index(shp_u)
        in_w = _any_inside_traced(grid, xcw, ycw, False) & (iu >= 1)
        in_e = _any_inside_traced(grid, xce, yce, False) & (iu <= nx - 1)
        mask_u = in_w | (in_e & (iu >= 1))  # cell 0 never marks face 0
        mask_u_bc = in_e & (iu <= nx - 1)   # west face of each inside cell
        xcs, ycs = coords(shp_v, 0.5, -0.5)  # cell south of v face r
        xcn, ycn = coords(shp_v, 0.5, 0.5)   # cell north of v face r
        jv = ctx.row_index(shp_v)
        in_s = _any_inside_traced(grid, xcs, ycs, False) & (jv >= 1)
        in_n = _any_inside_traced(grid, xcn, ycn, False)
        mask_v = in_s | (in_n & (jv >= 1))
        mask_v_bc = in_n
    else:
        # JS: face-position test, inclusive radius
        # (index.html:377-380, :912-929).
        xu, yu = coords(shp_u, 0.0, 0.5)
        mask_u = _any_inside_traced(grid, xu, yu, True)
        xv, yv = coords(shp_v, 0.5, 0.0)
        mask_v = _any_inside_traced(grid, xv, yv, True)
        mask_u_bc, mask_v_bc = mask_u, mask_v
    return mask_u, mask_v, mask_u_bc, mask_v_bc
