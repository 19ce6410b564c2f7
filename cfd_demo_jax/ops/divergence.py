"""Divergence RHS for the pressure-correction Poisson solve.

rhs[j, i] = ((u*[j, i+1] - u*[j, i])/dx + (v*[j+1, i] - v*[j, i])/dy) / dt_sub

over all pressure cells (model.rs:1406-1440 recompute_divergence,
index.html:729-739). v is stored in the implicit-top-row layout
(Grid.shape_v): row j=ny is identically zero, supplied here by the
zero-padding shift.
"""
from __future__ import annotations

import jax.numpy as jnp

from .stencil import DEFAULT_CTX, StencilCtx, shifted


def divergence_rhs(u_star: jnp.ndarray, v_star: jnp.ndarray,
                   dt_sub, dx: float, dy: float,
                   ctx: StencilCtx = DEFAULT_CTX,
                   out_shape=None) -> jnp.ndarray:
    """``out_shape`` defaults to the pressure-cell shape (ny, nx)."""
    out_shape = tuple(out_shape or v_star.shape)
    su = ctx.shifts(u_star, out_shape)
    sv = ctx.shifts(v_star, out_shape)
    du = (su(0, 1) - su(0, 0)) / dx
    dv = (sv(1, 0) - sv(0, 0)) / dy
    return (du + dv) / dt_sub


def divergence(u: jnp.ndarray, v: jnp.ndarray, dx: float, dy: float) -> jnp.ndarray:
    """Plain velocity divergence on cells (diagnostic; used by tests to
    check that the projection drives div(u) toward zero)."""
    return ((u[:, 1:] - u[:, :-1]) / dx
            + (shifted(v, v.shape, 1, 0) - v) / dy)
