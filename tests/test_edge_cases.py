"""Solver edge-case probes (the /verify checklist, pinned as tests)."""
import numpy as np

import jax.numpy as jnp

import cfd_demo_jax as cfd
from cfd_demo_jax import (Cylinder, Grid, Semantics, SimulationParams,
                          solver_options_for)


def _opts():
    return solver_options_for(Semantics.RUST, ramp_up_steps=5,
                              jacobi_iters=10, outer_corrector_rounds=2)


def test_obstacle_fully_outside_domain():
    """An obstacle beyond the domain produces empty masks and the flow
    develops as if unobstructed."""
    grid = Grid(nx=48, ny=24, lx=6.0, ly=3.0,
                obstacles=(Cylinder(100.0, 100.0, 0.5),))
    free = Grid(nx=48, ny=24, lx=6.0, ly=3.0)
    states = []
    for g in (grid, free):
        scene = cfd.make_scene(g, SimulationParams(dt=0.002, viscosity=1e-4),
                               _opts())
        state, _ = cfd.make_run(scene, 10, donate=False)(scene.init_state())
        states.append(state)
    np.testing.assert_array_equal(np.asarray(states[0].u),
                                  np.asarray(states[1].u))
    assert np.isfinite(np.asarray(states[0].u)).all()


def test_tiny_grid():
    """8x6: smaller than any tile; everything stays on the jnp path."""
    grid = Grid(nx=8, ny=6, lx=1.0, ly=0.75)
    scene = cfd.make_scene(grid, SimulationParams(dt=0.001, viscosity=1e-3),
                           _opts())
    state, _ = cfd.make_run(scene, 20, donate=False)(scene.init_state())
    u = np.asarray(state.u)
    assert u.shape == (6, 9) and np.isfinite(u).all()
    assert np.all(u[0] == 0) and np.all(u[-1] == 0)


def test_zero_inlet_keeps_fields_zero():
    grid = Grid(nx=32, ny=16, lx=4.0, ly=2.0,
                obstacles=(Cylinder(1.0, 1.0, 0.3),))
    scene = cfd.make_scene(
        grid, SimulationParams(dt=0.002, viscosity=1e-4,
                               target_inlet_velocity=0.0), _opts())
    state, _ = cfd.make_run(scene, 15, donate=False)(scene.init_state())
    assert float(jnp.max(jnp.abs(state.u))) == 0.0
    assert float(jnp.max(jnp.abs(state.v))) == 0.0
    assert float(state.res_u) == 0.0


def test_bf16_state_runs_but_is_not_parity_grade():
    """bf16 full-state audit: the solver runs end-to-end in bfloat16,
    stays finite, but accumulates O(1e-1) drift vs float32 within tens
    of steps -- far outside the per-step L2 <= 1e-5 parity target, so
    bf16 is a capability, not a parity mode (docs/SPEC.md)."""
    grid = Grid(nx=64, ny=32, lx=6.0, ly=3.0,
                obstacles=(Cylinder(1.5, 1.5, 0.4),))
    scene = cfd.make_scene(
        grid, SimulationParams(dt=0.002, viscosity=1e-4),
        solver_options_for(Semantics.RUST, ramp_up_steps=10,
                           jacobi_iters=20, outer_corrector_rounds=2))
    run = cfd.make_run(scene, 30, donate=False)
    u = {}
    for dt_ in (jnp.float32, jnp.bfloat16):
        st, _ = run(scene.init_state(dtype=dt_))
        arr = np.asarray(st.u, np.float32)
        assert np.isfinite(arr).all()
        u[dt_.__name__] = arr
    diff = np.abs(u["float32"] - u["bfloat16"]).max()
    assert 1e-4 < diff < 1.0, f"audit expectation changed: drift={diff}"
