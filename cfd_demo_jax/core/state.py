"""Device-resident simulation state.

The reference keeps all fields as mutable Vec<f32> on a background
thread (model.rs:166-214). Here the state is an immutable pytree
advanced by a pure jit-compiled step function with buffer donation, so
updates are in-place in device memory without host round-trips. Runtime scalars
(dt, viscosity, inlet target) live here so they can be hot-swapped
without recompilation (mirroring model.rs:1250-1257 set_parameters).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import Grid, SimulationParams, SolverOptions, Semantics


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class State:
    """All per-simulation arrays and scalars.

    Staggered fields (model.rs:161-165), array layout (rows=y, cols=x):
      u: (ny, nx+1)   horizontal velocity on vertical faces
      v: (ny, nx)     vertical velocity on horizontal faces j=0..ny-1;
          the reference's top face row j=ny is identically zero (BC) and
          is stored implicitly -- see Grid.shape_v and State.v_full
      p: (ny, nx)     pressure at cell centers
      p_prime: (ny, nx) pressure-correction; warm-started across calls
          in Rust semantics (model.rs never clears it), zero-initialized
          per solve in JS semantics (index.html:798).
    """

    u: jax.Array
    v: jax.Array
    p: jax.Array
    p_prime: jax.Array
    u_prev: Optional[jax.Array]  # JS extrapolation (index.html:263-270)
    v_prev: Optional[jax.Array]
    # --- runtime scalars (hot-swappable) ---
    dt: jax.Array          # current time step
    dt_user: jax.Array     # user-requested dt cap (index.html:1334)
    nu: jax.Array          # kinematic viscosity
    target_inlet: jax.Array
    # --- bookkeeping ---
    t: jax.Array           # simulation time
    step: jax.Array        # int32 step counter
    substeps: jax.Array    # int32 current PISO substep count
    res_u: jax.Array
    res_v: jax.Array
    res_p: jax.Array

    @property
    def fields(self):
        return self.u, self.v, self.p

    @property
    def v_full(self) -> jax.Array:
        """v in the reference's (ny+1, nx) shape (explicit zero top row)."""
        zero_row = jnp.zeros((1, self.v.shape[-1]), self.v.dtype)
        return jnp.concatenate([self.v, zero_row], axis=0)


def init_state(grid: Grid, params: SimulationParams, opts: SolverOptions,
               dtype=jnp.float32) -> State:
    """Zero-initialized state (model.rs:219-299, index.html:218-258)."""
    f = lambda x: jnp.asarray(x, dtype)
    js = opts.semantics == Semantics.JS
    # One buffer per field: a step with buffer donation may not receive
    # the same buffer twice.
    zu = lambda: jnp.zeros((grid.ny, grid.nx + 1), dtype)
    zv = lambda: jnp.zeros((grid.ny, grid.nx), dtype)
    return State(
        u=zu(), v=zv(), p=zv(), p_prime=zv(),
        u_prev=zu() if js else None,
        v_prev=zv() if js else None,
        dt=f(params.dt),
        dt_user=f(params.dt),
        nu=f(params.viscosity),
        target_inlet=f(params.target_inlet_velocity),
        t=f(0.0),
        step=jnp.asarray(0, jnp.int32),
        substeps=jnp.asarray(opts.substeps_init, jnp.int32),
        res_u=f(0.0), res_v=f(0.0), res_p=f(0.0),
    )


def set_params(state: State, params: SimulationParams) -> State:
    """Hot-swap runtime scalars (model.rs:1250-1257). Enum changes
    (scheme/solver/profile) are static and require rebuilding the
    compiled step via Scene; the driver handles that transparently."""
    return dataclasses.replace(
        state,
        dt=jnp.asarray(params.dt, state.dt.dtype),
        dt_user=jnp.asarray(params.dt, state.dt.dtype),
        nu=jnp.asarray(params.viscosity, state.nu.dtype),
        target_inlet=jnp.asarray(params.target_inlet_velocity, state.target_inlet.dtype),
    )
