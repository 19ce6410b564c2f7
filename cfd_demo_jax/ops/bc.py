"""Velocity boundary conditions.

model.rs:826-875 apply_boundary_conditions / index.html:870-930, applied
at the end of every PISO substep, in this exact order:

1. inlet:  u[j, 0] = profile(y_j)    (uniform or clamped parabolic)
2. outlet: u[j, nx] = u[j, nx-1]     (zero-gradient)
3. no-slip rows: u[0, :] = u[ny-1, :] = 0   (overwrites inlet/outlet
   corners -- order matters and is preserved)
4. v rows: v[0, :] = v[ny, :] = 0
5. obstacle zeroing via the per-semantics BC masks (Rust: west u face /
   south v face of obstacle cells, model.rs:869-874; JS: every face
   whose position is inside, index.html:912-929)
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..core.config import FlowCase, Grid, InletProfile
from .stencil import (DEFAULT_CTX, StencilCtx, apply_solid_mask,
                      col_index, row_index, shifted)


def inlet_profile_column(grid: Grid, profile: InletProfile,
                         inlet_velocity, dtype=jnp.float32) -> jnp.ndarray:
    """Per-row inlet u value (model.rs:833-848). ``inlet_velocity`` may
    be a traced scalar (ramp)."""
    y = (np.arange(grid.ny, dtype=np.float32) + 0.5) * np.float32(grid.dy)
    if profile == InletProfile.UNIFORM:
        return inlet_velocity * jnp.ones((grid.ny,), dtype)
    if profile == InletProfile.PARABOLIC_UPPER:
        # Sudden-expansion inlet: parabola over [ly/2, ly]; the clamp
        # below zeroes the lower half exactly.
        center, radius = 3.0 * grid.ly / 4.0, grid.ly / 4.0
    else:
        center = grid.ly / 2.0
        radius = grid.ly / 2.0
    shape_fn = jnp.asarray(1.0 - ((y - center) / radius) ** 2, dtype)
    # The reference clamps the final value, not the shape (model.rs:842-847).
    return jnp.maximum(inlet_velocity * shape_fn, 0.0)


def inlet_profile_traced(grid: Grid, profile: InletProfile,
                         inlet_velocity, j_rows, dtype):
    """Inlet u as a function of traced row indices (for a non-default
    StencilCtx, where a host-precomputed (ny,) column cannot be
    indexed per-block). Same formula as :func:`inlet_profile_column`;
    the PARABOLIC shape is evaluated in the field dtype rather than
    float64, which can differ by ~1 ulp (tests use tolerances)."""
    y = (j_rows.astype(dtype) + jnp.asarray(0.5, dtype)) * jnp.asarray(
        grid.dy, dtype)
    if profile == InletProfile.UNIFORM:
        return jnp.broadcast_to(jnp.asarray(inlet_velocity, dtype), y.shape)
    if profile == InletProfile.PARABOLIC_UPPER:
        center = jnp.asarray(3.0 * grid.ly / 4.0, dtype)
        radius = jnp.asarray(grid.ly / 4.0, dtype)
    else:
        center = jnp.asarray(grid.ly / 2.0, dtype)
        radius = jnp.asarray(grid.ly / 2.0, dtype)
    shape_fn = 1.0 - ((y - center) / radius) ** 2
    return jnp.maximum(inlet_velocity * shape_fn, 0.0)


def apply_bcs(u: jnp.ndarray, v: jnp.ndarray, grid: Grid,
              profile: InletProfile, inlet_velocity,
              mask_u_bc: jnp.ndarray, mask_v_bc: jnp.ndarray,
              flow_case: FlowCase = FlowCase.CHANNEL,
              ctx: StencilCtx = DEFAULT_CTX):
    """Returns (u, v) with boundary conditions enforced.

    All edge writes are mask-selects over iota predicates (no scatters:
    fusible and GSPMD-safe under row sharding). CHANNEL order
    matches the reference: inlet, outlet copy, then no-slip rows
    overwrite the corners. CAVITY: closed box, top lid row of u moves
    at ``inlet_velocity`` (uniform, or for any non-uniform profile the
    centered parabola applied along x -- PARABOLIC_UPPER is a
    channel-inlet shape with no lid analogue and maps to the same
    centered parabola), all other walls no-slip.
    """
    ny, nx = grid.ny, grid.nx
    cu = ctx.col_index(u.shape)
    ru = ctx.row_index(u.shape)
    rv = ctx.row_index(v.shape)
    cv = ctx.col_index(v.shape)
    if flow_case == FlowCase.CHANNEL:
        if ctx is DEFAULT_CTX:
            inlet_vals = inlet_profile_column(grid, profile, inlet_velocity,
                                              u.dtype)[:, None]
        else:
            inlet_vals = inlet_profile_traced(grid, profile, inlet_velocity,
                                              ru, u.dtype)
        u = jnp.where(cu == 0, inlet_vals, u)
        u = jnp.where(cu == nx, ctx.shifts(u, u.shape)(0, -1), u)  # outlet
        u = jnp.where((ru == 0) | (ru == ny - 1), 0.0, u)       # no-slip rows
        # v top face row j=ny is implicit zero (Grid.shape_v); only the
        # bottom face row needs zeroing.
        v = jnp.where(rv == 0, 0.0, v)
    else:  # CAVITY
        if profile == InletProfile.UNIFORM:
            lid_vals = inlet_velocity
        else:
            # Parabolic lid along x (regularized cavity): zero at the
            # side walls, peak ``inlet_velocity`` at mid-lid. u-face i
            # sits at x = i * dx.
            x = cu.astype(u.dtype) * jnp.asarray(grid.dx, u.dtype)
            half = jnp.asarray(grid.lx / 2.0, u.dtype)
            lid_vals = jnp.maximum(
                inlet_velocity * (1.0 - ((x - half) / half) ** 2), 0.0)
        u = jnp.where(ru == ny - 1, lid_vals, u)        # moving lid
        u = jnp.where(ru == 0, 0.0, u)                  # floor (tangential)
        # No-penetration side walls win at the lid corners.
        u = jnp.where((cu == 0) | (cu == nx), 0.0, u)
        v = jnp.where(rv == 0, 0.0, v)                  # floor (normal)
        v = jnp.where((cv == 0) | (cv == nx - 1), 0.0, v)  # side (tangential)
    u = apply_solid_mask(u, mask_u_bc)
    v = apply_solid_mask(v, mask_v_bc)
    return u, v
