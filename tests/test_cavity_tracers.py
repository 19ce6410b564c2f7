"""Lid-driven cavity flow case + tracer particles."""
import numpy as np

from cfd_demo_jax import (FlowCase, Grid, Semantics, SimulationParams,
                          cavity_grid, make_run, make_scene, make_step,
                          solver_options_for)
from cfd_demo_jax.ops.divergence import divergence
from cfd_demo_jax.oracle.reference import NumpyModel
from cfd_demo_jax.ops import tracers as trc

from conftest import l2


def cavity_scene(n=32, **overrides):
    grid = cavity_grid(n)
    params = SimulationParams(dt=0.002, viscosity=1e-2,
                              target_inlet_velocity=1.0,
                              flow_case=FlowCase.CAVITY)
    opts = solver_options_for(Semantics.RUST, ramp_up_steps=10, **overrides)
    return make_scene(grid, params, opts)


def test_cavity_matches_oracle():
    scene = cavity_scene(n=20, jacobi_tol=0.0, outer_corrector_tol=0.0,
                         jacobi_iters=10, outer_corrector_rounds=3)
    step = make_step(scene, donate=False)
    oracle = NumpyModel(scene.grid, scene.params, scene.opts)
    state = scene.init_state()
    for k in range(3):
        oracle.update()
        state, _ = step(state)
        for fname in ("u", "v", "p"):
            want = getattr(oracle, fname)
            if fname == "v":
                want = want[:-1]
            err = l2(np.asarray(getattr(state, fname)), want)
            assert err <= 1e-5, f"step {k} {fname} L2={err:.2e}"


def test_cavity_physics():
    scene = cavity_scene(n=32)
    run = make_run(scene, 300, donate=False)
    state, _ = run(scene.init_state())
    u = np.asarray(state.u)
    v = np.asarray(state.v)
    g = scene.grid
    assert np.isfinite(u).all() and np.isfinite(v).all()
    # Lid drives flow: top row at lid speed (after ramp).
    assert abs(u[-1, g.nx // 2] - 1.0) < 1e-5
    # Walls closed: no normal flow.
    assert np.abs(u[:, 0]).max() == 0 and np.abs(u[:, -1]).max() == 0
    assert np.abs(v[0, :]).max() == 0
    # Recirculation: interior u below the lid opposes it somewhere.
    assert u[g.ny // 3, 1:-1].min() < 0
    # Projection keeps divergence small.
    div = np.asarray(divergence(state.u, state.v, g.dx, g.dy))
    assert np.sqrt((div[1:-1, 1:-1] ** 2).mean()) < 0.1


def test_tracers_lifecycle():
    grid = Grid(nx=48, ny=24, lx=4.0, ly=1.5)
    scene = make_scene(grid, SimulationParams(dt=0.002, viscosity=1e-4),
                       solver_options_for(Semantics.RUST, ramp_up_steps=5))
    run = make_run(scene, 50, donate=False)
    state, _ = run(scene.init_state())

    ts = trc.init_tracers(grid, generations=4)
    assert int(ts.alive.sum()) == grid.ny  # one per inlet row
    import jax

    @jax.jit
    def advance(ts, u, v, dt, step):
        return trc.step_tracers(ts, u, v, grid, dt, step)

    for k in range(1, 30):
        ts = advance(ts, state.u, state.v, state.dt, k)
    pos = np.asarray(ts.pos)
    alive = np.asarray(ts.alive)
    assert alive.any()
    # Tracers drift downstream (positive u flow).
    assert pos[alive][:, 0].max() > 0.0
    assert np.isfinite(pos).all()
    # Injection at step multiple of 100 refills a generation.
    ts100 = advance(ts, state.u, state.v, state.dt, 100)
    assert int(ts100.alive.sum()) >= int(ts.alive.sum())

    # Rendering overlay works.
    from cfd_demo_jax.render.colormap import VisualizationMode, render_field
    img = np.asarray(render_field(state.u, state.v, state.p, grid=grid,
                                  mode=VisualizationMode.VELOCITY))
    out = trc.draw_tracers(img, ts, grid)
    assert (out == (255, 0, 0)).all(axis=-1).any()
