"""Aerodynamic force diagnostics (drag / lift) on internal obstacles.

New capability beyond the reference (TSultanov/cfd-demo computes no
forces; its closest output is the field colormap, src/app.rs:235-429).
A production CFD user needs C_d / C_l and the lift spectrum (Strouhal),
so the framework provides two estimators, both pure jnp -- jit-, scan-
and vmap-compatible, with static slice bounds so they fuse into a
rollout at zero dispatch cost:

* :func:`control_volume_force` -- momentum balance over a rectangular,
  grid-aligned control volume enclosing the obstacle(s):

      F = -d/dt int_V rho u dV  -  oint_S rho u (u.n) dS
          -  oint_S p n dS      +  oint_S mu grad(u).n dS

  (rho = 1; the reference's solver is unit-density with kinematic
  viscosity, model.rs:14-21.) Includes the viscous and unsteady terms,
  so it estimates the TOTAL force; accuracy is set by the CV-face
  discretization (second-order centrals), not by the staircase body
  mask.

* :func:`pressure_force` -- direct staircase surface integral of p
  over the obstacle boundary faces (form drag only; misses skin
  friction, ~20-30% of cylinder drag at Re ~ 100). Cheap and local;
  useful as a cross-check.

Conventions: forces are per unit span (2D), in flow units (rho = 1).
``drag_lift_coefficients`` normalizes by 0.5 * U^2 * D.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax.numpy as jnp

from ..core.config import Grid


class ControlVolume(NamedTuple):
    """Cell-index bounds of a grid-aligned CV: x faces at i0*dx and
    i1*dx, y faces at j0*dy and j1*dy (0 < i0 < i1 < nx etc.)."""

    i0: int
    i1: int
    j0: int
    j1: int


def default_control_volume(grid: Grid, margin: float = 1.5) -> ControlVolume:
    """A CV enclosing every obstacle with ``margin`` x the obstacle's
    radius/half-extent of clearance, clamped one cell inside the
    domain."""
    from ..core.config import Box, Cylinder
    x_lo, x_hi, y_lo, y_hi = [], [], [], []
    for obs in grid.obstacles:
        if isinstance(obs, Cylinder):
            rx = ry = obs.radius
            cx, cy = obs.center_x, obs.center_y
        elif isinstance(obs, Box):
            rx, ry = obs.half_w, obs.half_h
            cx, cy = obs.center_x, obs.center_y
        else:
            raise TypeError(type(obs))
        x_lo.append(cx - (1 + margin) * rx)
        x_hi.append(cx + (1 + margin) * rx)
        y_lo.append(cy - (1 + margin) * ry)
        y_hi.append(cy + (1 + margin) * ry)
    if not x_lo:
        raise ValueError("scene has no obstacles")
    # Bounds keep every stencil read in range: the x-faces use
    # u[:, i1+1] (u has nx+1 columns) and the y-faces use v[j1+1]
    # (v has ny rows in the implicit-top-row layout), so j1 <= ny-2.
    i0 = max(1, int(min(x_lo) / grid.dx))
    i1 = min(grid.nx - 1, int(-(-max(x_hi) // grid.dx)))
    j0 = max(1, int(min(y_lo) / grid.dy))
    j1 = min(grid.ny - 2, int(-(-max(y_hi) // grid.dy)))
    if i1 - i0 < 2 or j1 - j0 < 2:
        raise ValueError(f"degenerate control volume {(i0, i1, j0, j1)}")
    return ControlVolume(i0, i1, j0, j1)


def control_volume_force(u: jnp.ndarray, v: jnp.ndarray, p: jnp.ndarray,
                         nu: float, grid: Grid,
                         cv: Optional[ControlVolume] = None,
                         u_prev: Optional[jnp.ndarray] = None,
                         v_prev: Optional[jnp.ndarray] = None,
                         dt=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(Fx, Fy) on the body inside ``cv`` by momentum balance.

    ``u`` (ny, nx+1) lives on x faces, ``v`` (ny, nx) on y faces in the
    implicit-top-row layout (core/state.py); ``p`` (ny, nx) at centers.
    Pass the previous step's fields + dt to include the unsteady term
    (required for instantaneous forces in shedding flows; the mean over
    a period is unaffected).
    """
    if cv is None:
        cv = default_control_volume(grid)
    i0, i1, j0, j1 = cv
    dx, dy = grid.dx, grid.dy

    def trap(a):
        """Trapezoid end-weights for tangential-direction face sums:
        samples at i0..i1 (or j0..j1) land ON the CV corners, so full
        weights would overcount half a cell at each end."""
        return a.sum() - 0.5 * (a[0] + a[-1])

    js = slice(j0, j1)            # CV-interior cell rows
    # -- x-momentum -------------------------------------------------
    # East/west faces: u is sampled exactly on them.
    uE = u[js, i1]
    uW = u[js, i0]
    pE = 0.5 * (p[js, i1 - 1] + p[js, i1])
    pW = 0.5 * (p[js, i0 - 1] + p[js, i0])
    dudxE = (u[js, i1 + 1] - u[js, i1 - 1]) / (2 * dx)
    dudxW = (u[js, i0 + 1] - u[js, i0 - 1]) / (2 * dx)
    # North/south faces: u averaged to the face, v sampled on it.
    # v row j is the y face at y = j*dy (implicit row ny == 0).
    iu = slice(i0, i1 + 1)
    uN = 0.5 * (u[j1 - 1, iu] + u[j1, iu])
    uS = 0.5 * (u[j0 - 1, iu] + u[j0, iu])
    # v at the u-sample x positions (x = i*dx): average the two
    # adjacent v columns; clamp is unnecessary for 0 < i0 <= i <= i1 < nx.
    vN = 0.5 * (v[j1, i0 - 1:i1] + v[j1, i0:i1 + 1])
    vS = 0.5 * (v[j0, i0 - 1:i1] + v[j0, i0:i1 + 1])
    dudyN = (u[j1, iu] - u[j1 - 1, iu]) / dy
    dudyS = (u[j0, iu] - u[j0 - 1, iu]) / dy

    flux_x = ((uE * uE - uW * uW).sum() * dy
              + trap(uN * vN - uS * vS) * dx)
    press_x = (pE - pW).sum() * dy
    visc_x = nu * ((dudxE - dudxW).sum() * dy
                   + trap(dudyN - dudyS) * dx)
    Fx = -flux_x - press_x + visc_x

    # -- y-momentum -------------------------------------------------
    # North/south faces: v sampled exactly on them.
    ic = slice(i0, i1)
    vNf = v[j1, ic]
    vSf = v[j0, ic]
    pN = 0.5 * (p[j1 - 1, ic] + p[j1, ic])
    pS = 0.5 * (p[j0 - 1, ic] + p[j0, ic])
    dvdyN = (v[j1 + 1, ic] - v[j1 - 1, ic]) / (2 * dy)
    dvdyS = (v[j0 + 1, ic] - v[j0 - 1, ic]) / (2 * dy)
    # East/west faces: v averaged to the face, u sampled on it.
    jv = slice(j0, j1 + 1)
    vE = 0.5 * (v[jv, i1 - 1] + v[jv, i1])
    vW = 0.5 * (v[jv, i0 - 1] + v[jv, i0])
    uEa = 0.5 * (u[j0 - 1:j1, i1] + u[j0:j1 + 1, i1])
    uWa = 0.5 * (u[j0 - 1:j1, i0] + u[j0:j1 + 1, i0])
    dvdxE = (v[jv, i1] - v[jv, i1 - 1]) / dx
    dvdxW = (v[jv, i0] - v[jv, i0 - 1]) / dx

    flux_y = (trap(vE * uEa - vW * uWa) * dy
              + (vNf * vNf - vSf * vSf).sum() * dx)
    press_y = (pN - pS).sum() * dx
    visc_y = nu * (trap(dvdxE - dvdxW) * dy
                   + (dvdyN - dvdyS).sum() * dx)
    Fy = -flux_y - press_y + visc_y

    if u_prev is not None and dt is not None:
        # Unsteady term: -d/dt of CV momentum (one-sided in time).
        du = u[js, i0:i1 + 1] - u_prev[js, i0:i1 + 1]
        Fx = Fx - (du.sum() - 0.5 * (du[:, 0] + du[:, -1]).sum()) \
            * dx * dy / dt
        dv = v[jv, ic] - v_prev[jv, ic]
        Fy = Fy - (dv.sum() - 0.5 * (dv[0, :] + dv[-1, :]).sum()) \
            * dx * dy / dt
    return Fx, Fy


def pressure_force(p: jnp.ndarray, grid: Grid,
                   inclusive: bool = False) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(Fx, Fy) from the staircase surface pressure integral: every
    solid cell face adjacent to a fluid cell contributes p_fluid times
    the inward normal times the face length. Form drag only.

    The solid mask is computed from iota (like core.masks.masks_traced)
    so no O(N^2) constant is baked into the jitted HLO."""
    from ..core.masks import _any_inside_traced
    from jax import lax
    if not grid.obstacles:
        z = jnp.zeros((), p.dtype)
        return z, z
    ny, nx = p.shape
    xs = (lax.broadcasted_iota(jnp.int32, (ny, nx), 1).astype(p.dtype)
          + 0.5) * grid.dx
    ys = (lax.broadcasted_iota(jnp.int32, (ny, nx), 0).astype(p.dtype)
          + 0.5) * grid.dy
    inside = _any_inside_traced(grid, xs, ys, inclusive)
    solid = inside.astype(p.dtype)
    fluid = 1.0 - solid
    dx, dy = grid.dx, grid.dy
    # Face between cell (j, i) [fluid] and (j, i+1) [solid]: pressure
    # pushes in +x on the body; the mirrored pair pushes in -x.
    fx = (p[:, :-1] * fluid[:, :-1] * solid[:, 1:]
          - p[:, 1:] * fluid[:, 1:] * solid[:, :-1]).sum() * dy
    fy = (p[:-1, :] * fluid[:-1, :] * solid[1:, :]
          - p[1:, :] * fluid[1:, :] * solid[:-1, :]).sum() * dx
    return fx, fy


def physical_pressure(p_prev: jnp.ndarray, p: jnp.ndarray,
                      substeps=1) -> jnp.ndarray:
    """The field to integrate forces over: the PER-SUBSTEP increment
    of the stored p.

    The reference's stored p is a monotone accumulator -- every
    corrector round adds the full p' (model.rs:693, :1403), and at
    steady state each substep adds the SAME p' field, so p grows
    linearly in time and its instantaneous value is meaningless (the
    reference's UI hides this behind min-max normalization,
    src/app.rs:237-280; docs/SPEC.md: "p never feeds back into the
    dynamics; only p' does").

    Within ONE substep the corrector-round p' solves telescope to the
    physical pressure P (rounds re-solve the residual divergence, so
    later rounds add ~0), but each SUBSTEP re-creates the advective
    divergence over its own dt_sub and adds a fresh ~P -- the rhs
    div(u*)/dt_sub is dt_sub-independent. The per-step increment is
    therefore ~substeps x P, and ``substeps`` (the count the step
    actually executed, e.g. StepDiagnostics.substeps) must divide it
    back out; JS semantics default to 5-20 substeps, so omitting it
    overstates forces by that factor (tests/test_forces.py pins
    substep-count invariance)."""
    return (p - p_prev) / jnp.asarray(substeps, p.dtype)


def drag_lift_coefficients(Fx, Fy, u_ref: float, length: float):
    """(C_d, C_l) = 2 F / (rho u_ref^2 L), rho = 1."""
    q = 0.5 * u_ref * u_ref * length
    return Fx / q, Fy / q
