"""Tracer particles (JS twin: index.html:1472-1543).

The JS keeps a growing JS array of particles, injecting one per inlet
row at init and every 100 steps, advecting by bilinearly interpolated
cell-centered velocity, and culling out-of-domain particles
(index.html:1485-1494). Device design: a fixed-capacity ring
buffer of positions + alive mask (static shapes under jit); injection
overwrites the oldest slots; advection is a vectorized gather.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..core.config import Grid
from .stencil import shifted

TRACER_INJECTION_INTERVAL = 100  # index.html:1531


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TracerState:
    pos: jax.Array     # (capacity, 2) float32 world coordinates
    alive: jax.Array   # (capacity,) bool
    cursor: jax.Array  # int32 ring write position

    @property
    def capacity(self) -> int:
        return self.pos.shape[0]


def init_tracers(grid: Grid, generations: int = 64) -> TracerState:
    """Capacity = ny per injection x ``generations`` ring slots; starts
    with one injected generation (index.html:1475-1483)."""
    cap = grid.ny * generations
    ts = TracerState(
        pos=jnp.zeros((cap, 2), jnp.float32),
        alive=jnp.zeros((cap,), bool),
        cursor=jnp.asarray(0, jnp.int32))
    return inject(ts, grid)


def _inlet_positions(grid: Grid) -> jnp.ndarray:
    y = (np.arange(grid.ny, dtype=np.float32) + 0.5) * np.float32(grid.dy)
    return jnp.asarray(np.stack([np.zeros_like(y), y], axis=1))


def inject(ts: TracerState, grid: Grid) -> TracerState:
    """One tracer per inlet row, overwriting the oldest ring slots
    (index.html:1534-1543)."""
    n = grid.ny
    idx = (ts.cursor + jnp.arange(n, dtype=jnp.int32)) % ts.capacity
    pos = ts.pos.at[idx].set(_inlet_positions(grid))
    alive = ts.alive.at[idx].set(True)
    return TracerState(pos=pos, alive=alive,
                       cursor=(ts.cursor + n) % ts.capacity)


def velocity_at(u: jnp.ndarray, v: jnp.ndarray, pos: jnp.ndarray,
                grid: Grid) -> jnp.ndarray:
    """Bilinear interpolation of the cell-centered velocity
    (index.html:1497-1525): cell indices clamped to [0, n-2], weights
    from the cell-origin offsets."""
    dx, dy = grid.dx, grid.dy
    uc = 0.5 * (u[:, :-1] + u[:, 1:])
    vc = 0.5 * (v + shifted(v, v.shape, 1, 0))
    i = jnp.clip(jnp.floor(pos[:, 0] / dx).astype(jnp.int32), 0, grid.nx - 2)
    j = jnp.clip(jnp.floor(pos[:, 1] / dy).astype(jnp.int32), 0, grid.ny - 2)
    rx = (pos[:, 0] - i.astype(jnp.float32) * dx) / dx
    ry = (pos[:, 1] - j.astype(jnp.float32) * dy) / dy

    def cc(ii, jj):
        return jnp.stack([uc[jj, ii], vc[jj, ii]], axis=-1)

    v00 = cc(i, j)
    v10 = cc(i + 1, j)
    v01 = cc(i, j + 1)
    v11 = cc(i + 1, j + 1)
    wx = rx[:, None]
    wy = ry[:, None]
    return ((1 - wx) * ((1 - wy) * v00 + wy * v01)
            + wx * ((1 - wy) * v10 + wy * v11))


def advect(ts: TracerState, u: jnp.ndarray, v: jnp.ndarray, grid: Grid,
           dt) -> TracerState:
    """pos += dt * vel; cull out-of-domain (index.html:1485-1494)."""
    vel = velocity_at(u, v, ts.pos, grid)
    pos = ts.pos + dt * vel
    in_domain = ((pos[:, 0] >= 0.0) & (pos[:, 0] <= grid.lx)
                 & (pos[:, 1] >= 0.0) & (pos[:, 1] <= grid.ly))
    return TracerState(pos=pos, alive=ts.alive & in_domain,
                       cursor=ts.cursor)


def step_tracers(ts: TracerState, u, v, grid: Grid, dt, step) -> TracerState:
    """Advect + periodic injection, jit-safe (step is traced)."""
    ts = advect(ts, u, v, grid, dt)
    do_inject = (step % TRACER_INJECTION_INTERVAL) == 0
    injected = inject(ts, grid)
    return jax.tree.map(
        lambda a, b: jnp.where(
            jnp.reshape(do_inject, (1,) * a.ndim), b, a) if a.ndim else
        jnp.where(do_inject, b, a),
        ts, injected)


def draw_tracers(img: np.ndarray, ts: TracerState, grid: Grid,
                 color=(255, 0, 0), radius: int = 1) -> np.ndarray:
    """Red dots over a rendered frame (index.html:968-977); host-side.
    The image is y-flipped (row 0 = top)."""
    out = img.copy()
    h, w, _ = out.shape
    pos = np.asarray(ts.pos)
    alive = np.asarray(ts.alive)
    px = np.clip((pos[:, 0] / grid.lx * (w - 1)).astype(int), 0, w - 1)
    py = np.clip(((1.0 - pos[:, 1] / grid.ly) * (h - 1)).astype(int), 0, h - 1)
    for x, y, a in zip(px, py, alive):
        if not a:
            continue
        out[max(0, y - radius):y + radius + 1,
            max(0, x - radius):x + radius + 1] = color
    return out
