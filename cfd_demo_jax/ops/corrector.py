"""Velocity corrector + pressure accumulation.

u[j,i]  = u*[j,i]  - dt_sub * (p'[j,i] - p'[j,i-1]) / dx   (i in [1, nx-1])
v[j,i]  = v*[j,i]  - dt_sub * (p'[j,i] - p'[j-1,i]) / dy   (j in [1, ny-1])
p      += p'                                              (everywhere)

model.rs:1334-1404 apply_corrector / index.html:841-863. Faces outside
the update range keep their u*/v* values (the reference writes u in
place from u_star; our u* equals the pre-corrector u there by
construction). Updates are mask-selects over iota predicates -- no
scatters -- so they fuse into one elementwise pass and partition
correctly under row sharding.
"""
from __future__ import annotations

import jax.numpy as jnp

from .stencil import DEFAULT_CTX, StencilCtx


def correct(u_star: jnp.ndarray, v_star: jnp.ndarray, p: jnp.ndarray,
            p_prime: jnp.ndarray, dt_sub, dx: float, dy: float,
            ctx: StencilCtx = DEFAULT_CTX, nx: int = None):
    """Returns (u, v, p). v in the implicit-top-row layout. ``nx`` is
    taken from the p' shape by default; a ctx over padded common-width
    arrays passes it explicitly."""
    if nx is None:
        nx = p_prime.shape[1]
    spp_u = ctx.shifts(p_prime, u_star.shape)
    # u faces 1..nx-1: p' cell i is east of face i, cell i-1 west.
    ppW = spp_u(0, -1)
    ppE = spp_u(0, 0)
    cu = ctx.col_index(u_star.shape)
    u_upd = u_star - dt_sub * (ppE - ppW) / dx
    u = jnp.where((cu >= 1) & (cu <= nx - 1), u_upd, u_star)
    # v faces 1..ny-1 (row 0 is the bottom boundary face).
    spp_v = ctx.shifts(p_prime, v_star.shape)
    ppS = spp_v(-1, 0)
    rv = ctx.row_index(v_star.shape)
    v_upd = v_star - dt_sub * (spp_v(0, 0) - ppS) / dy
    v = jnp.where(rv >= 1, v_upd, v_star)
    return u, v, p + p_prime
