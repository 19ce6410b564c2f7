"""Backward-facing step validation case (apps/backstep.py).

The PARABOLIC_UPPER sudden-expansion inlet is a documented addition
beyond the reference (docs/SPEC.md); the solver core it exercises is
unchanged (model.rs:600-900 semantics, pinned by test_golden.py which
includes a PARABOLIC_UPPER config). Here: the inlet profile shape, and
the physics smoke -- a recirculation bubble forms behind the step and
reattaches at a plausible laminar length on a coarse grid.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cfd_demo_jax import (Grid, InletProfile, Semantics, SimulationParams,
                          make_scene, solver_options_for)
from cfd_demo_jax.apps.backstep import backstep_grid, reattachment_length
from cfd_demo_jax.ops.bc import inlet_profile_column


def test_parabolic_upper_profile_shape():
    grid = Grid(nx=16, ny=64, lx=4.0, ly=1.0, obstacles=())
    col = np.asarray(inlet_profile_column(
        grid, InletProfile.PARABOLIC_UPPER, 1.0))
    y = (np.arange(64) + 0.5) / 64.0
    lower, upper = col[y < 0.5], col[y >= 0.5]
    assert np.all(lower == 0.0), "lower half must be solid-wall zero"
    assert np.all(upper >= 0.0) and upper.max() == col.max()
    # peak at the open channel's center (y = 3/4), zero at both ends
    assert abs(y[np.argmax(col)] - 0.75) < 1.0 / 64
    # near-zero at the wall-adjacent cell centers (not exactly zero:
    # centers sit dy/2 off the walls)
    assert col[-1] < 0.08 and upper[0] < 0.08
    # analytic: 1 - ((y - 3/4) / (1/4))^2 clamped at 0
    ref = np.maximum(1.0 - ((y - 0.75) / 0.25) ** 2, 0.0)
    np.testing.assert_allclose(col, ref.astype(np.float32), atol=1e-6)


def test_reattachment_length_helper():
    grid = Grid(nx=40, ny=8, lx=10.0, ly=1.0, obstacles=())
    u = np.full((8, 41), 0.5, np.float32)
    # reversed flow on faces 4..11 (x = 1.0..2.75); crossing between
    # face 11 (x=2.75, u=-0.2) and face 12 (x=3.0, u=0.5)
    u[1, 4:12] = -0.2
    xr = reattachment_length(u, grid, step_len=0.5)
    expected = (2.75 + 0.25 * 0.2 / 0.7 - 0.5) / 0.5
    assert abs(xr - expected) < 1e-6
    # no recirculation -> nan
    assert np.isnan(reattachment_length(
        np.full((8, 41), 0.5, np.float32), grid, step_len=0.5))


def test_backstep_recirculation_re100():
    """Coarse-grid Re=100 rollout: the bubble reattaches in a plausible
    laminar band. (First-order upwind on 12 cells/step underpredicts
    Armaly's x_r/S ~ 3.0; the fine-grid second-order run on hardware is
    the quantitative validation -- docs/VALIDATION.md.)"""
    nx, ny, lx, sl = 240, 24, 7.5, 0.125
    grid = backstep_grid(nx, ny, lx, sl)
    scene = make_scene(
        grid,
        SimulationParams(dt=0.005, viscosity=2.0 / (3.0 * 100.0),
                         inlet_profile=InletProfile.PARABOLIC_UPPER),
        solver_options_for(Semantics.RUST, early_exit=False))
    from functools import partial
    from cfd_demo_jax.solver.piso import step_fn
    step = partial(step_fn, scene)

    @jax.jit
    def chunk(s):
        return jax.lax.scan(lambda s, _: (step(s)[0], None), s, None,
                            length=1000)[0]

    st = scene.init_state()
    for _ in range(3):
        st = chunk(st)
    u = np.asarray(st.u)
    assert np.isfinite(u).all()
    xr = reattachment_length(u, grid, sl)
    assert 1.4 < xr < 2.6, xr
    # the bubble is real reversed flow, not noise
    assert u[1].min() < -0.01
