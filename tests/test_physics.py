"""Physics sanity checks (SURVEY.md section 4c).

The reference validates the solver only visually through the GUI; these
tests assert the physical invariants the projection method must
satisfy: divergence reduction, inflow development, no-slip walls, and
obstacle blocking.
"""
import numpy as np

from cfd_demo_jax import (Cylinder, Grid, Semantics, SimulationParams,
                          make_run, make_scene, solver_options_for)
from cfd_demo_jax.ops.divergence import divergence


def channel_scene(obstacle=True, **opt_overrides):
    obstacles = (Cylinder(center_x=1.5, center_y=0.75, radius=0.25),) if obstacle else ()
    grid = Grid(nx=48, ny=24, lx=6.0, ly=1.5, obstacles=obstacles)
    params = SimulationParams(dt=0.002, viscosity=1e-4)
    opts = solver_options_for(Semantics.RUST, ramp_up_steps=10,
                              **opt_overrides)
    return make_scene(grid, params, opts)


def test_divergence_after_projection():
    scene = channel_scene()
    run = make_run(scene, 30, donate=False)
    state, diags = run(scene.init_state())
    div = np.asarray(divergence(state.u, state.v, scene.grid.dx,
                                scene.grid.dy))
    # Interior cells away from the obstacle should be nearly
    # divergence-free after the corrector rounds.
    assert np.abs(div[1:-1, 1:-1]).max() < 0.5
    assert np.sqrt(np.mean(div[1:-1, 1:-1] ** 2)) < 0.05


def test_channel_flow_develops():
    scene = channel_scene(obstacle=False)
    run = make_run(scene, 60, donate=False)
    state, _ = run(scene.init_state())
    u = np.asarray(state.u)
    assert np.all(np.isfinite(u))
    # Mid-channel u should be positive and of order the inlet velocity.
    mid = u[scene.grid.ny // 2, scene.grid.nx // 2]
    assert 0.1 < mid < 3.0
    # No-slip rows are exactly zero.
    assert np.abs(u[0, :]).max() == 0.0
    assert np.abs(u[-1, :]).max() == 0.0
    # v bottom face row is zero; the top face row (j=ny) is implicit
    # zero by layout (Grid.shape_v).
    v = np.asarray(state.v)
    assert np.abs(v[0, :]).max() == 0.0


def test_obstacle_blocks_flow():
    scene = channel_scene(obstacle=True)
    run = make_run(scene, 60, donate=False)
    state, _ = run(scene.init_state())
    u = np.asarray(state.u)
    g = scene.grid
    ci = int(1.5 / g.dx)
    cj = int(0.75 / g.dy)
    # u at the obstacle center face must be zero (mask + BCs).
    assert abs(u[cj, ci]) < 1e-6
    # Flow accelerates around the obstacle: above-gap speed exceeds inlet.
    gap = u[cj + int(0.3 / g.dy) + 1:, ci].max()
    assert np.isfinite(gap)


def test_long_rollout_stable():
    scene = channel_scene()
    run = make_run(scene, 200, donate=False)
    state, diags = run(scene.init_state())
    assert np.all(np.isfinite(np.asarray(state.u)))
    assert np.all(np.isfinite(np.asarray(state.p)))
    assert float(state.dt) > 0


def test_float64_pipeline():
    """State dtype is a parameter; the whole step runs in f64 too."""
    import jax
    import jax.numpy as jnp
    from cfd_demo_jax import (Cylinder, Grid, SimulationParams, Semantics,
                              make_scene, make_step, solver_options_for)
    jax.config.update("jax_enable_x64", True)
    try:
        scene = make_scene(
            Grid(nx=32, ny=16, lx=2, ly=1,
                 obstacles=(Cylinder(0.5, 0.5, 0.2),)),
            SimulationParams(dt=0.002, viscosity=1e-4),
            solver_options_for(Semantics.RUST, ramp_up_steps=4))
        st = scene.init_state(dtype=jnp.float64)
        step = make_step(scene, donate=False)
        for _ in range(3):
            st, _ = step(st)
        u = np.asarray(st.u)
        assert u.dtype == np.float64 and np.isfinite(u).all()
    finally:
        jax.config.update("jax_enable_x64", False)


def test_multiple_obstacles():
    from cfd_demo_jax import (Box, Cylinder, Grid, SimulationParams,
                              Semantics, make_scene, make_step,
                              solver_options_for)
    scene = make_scene(
        Grid(nx=64, ny=32, lx=4, ly=2,
             obstacles=(Cylinder(1.0, 1.0, 0.3), Box(2.5, 1.0, 0.2, 0.3))),
        SimulationParams(dt=0.002, viscosity=1e-4),
        solver_options_for(Semantics.RUST, ramp_up_steps=4))
    st = scene.init_state()
    step = make_step(scene, donate=False)
    for _ in range(5):
        st, _ = step(st)
    u = np.asarray(st.u)
    assert np.isfinite(u).all()
    assert u[16, 16] == 0.0  # cylinder center face
    assert u[16, 40] == 0.0  # box center face


# Ghia, Ghia & Shin (1982), Table I/II: lid-driven cavity at Re=100,
# u along the vertical centerline and v along the horizontal one.
# Public-domain benchmark values (their 129x129 stream-function solve).
GHIA_RE100_Y = np.array([0.0547, 0.1016, 0.1719, 0.2813, 0.4531, 0.5,
                         0.6172, 0.7344, 0.8516, 0.9531, 0.9766])
GHIA_RE100_U = np.array([-0.03717, -0.06434, -0.10150, -0.15662, -0.21090,
                         -0.20581, -0.13641, 0.00332, 0.23151, 0.68717,
                         0.84123])
GHIA_RE100_X = np.array([0.0625, 0.0938, 0.1563, 0.2344, 0.5,
                         0.8047, 0.8594, 0.9063, 0.9531, 0.9688])
GHIA_RE100_V = np.array([0.09233, 0.12317, 0.16077, 0.17527, 0.05454,
                         -0.24533, -0.22445, -0.16914, -0.08864, -0.05906])


def test_cavity_ghia_re100():
    """Steady lid-driven cavity at Re=100 vs the Ghia et al. (1982)
    benchmark profiles: 64^2, first-order upwind, 8000 fast-mode steps
    to steady state (residual ~3e-6). Max deviation ~0.04 at this
    resolution (0.02 at 128^2, docs/VALIDATION.md); tolerance 0.06."""
    import cfd_demo_jax as cfd
    from cfd_demo_jax import (FlowCase, Semantics, SimulationParams,
                              cavity_grid, solver_options_for)

    n = 64
    grid = cavity_grid(n)
    params = SimulationParams(dt=3e-3, viscosity=0.01,
                              target_inlet_velocity=1.0,
                              flow_case=FlowCase.CAVITY)
    opts = solver_options_for(
        Semantics.RUST, ramp_up_steps=100, jacobi_tol=0.0,
        jacobi_iters=50, outer_corrector_rounds=0, early_exit=False)
    scene = cfd.make_scene(grid, params, opts)
    state = scene.init_state()
    run = cfd.make_run(scene, 2000, donate=False)
    for _ in range(4):
        state, _ = run(state)
    assert float(state.res_u) < 1e-4, "not at steady state"
    u = np.asarray(state.u)
    v = np.asarray(state.v)
    yc = (np.arange(n) + 0.5) / n
    ui = np.interp(GHIA_RE100_Y, yc, u[:, n // 2])
    assert np.abs(ui - GHIA_RE100_U).max() < 0.06
    xc = (np.arange(n) + 0.5) / n
    vi = np.interp(GHIA_RE100_X, xc, v[n // 2, :])
    assert np.abs(vi - GHIA_RE100_V).max() < 0.06


def test_poiseuille_analytic_profile():
    """Analytic validation: the steady fully developed channel profile.

    With the reference's wall treatment (u = 0 at the outermost row
    CENTERS, model.rs:855-860), the exact steady solution of the
    discrete momentum equation under a uniform pressure gradient is the
    *discrete* parabola u_j ~ j*(ny-1-j) (the 3-point Laplacian
    annihilates it wall-to-wall). At Re = 10 the flow develops within
    a couple of channel heights, so downstream columns must match that
    profile -- a closed-form check no golden file can drift from."""
    from cfd_demo_jax import InletProfile
    ny, nx = 16, 32
    grid = Grid(nx=nx, ny=ny, lx=2.0, ly=1.0, obstacles=())
    params = SimulationParams(dt=0.002, viscosity=0.1,
                              inlet_profile=InletProfile.PARABOLIC)
    opts = solver_options_for(Semantics.RUST, ramp_up_steps=10)
    scene = make_scene(grid, params, opts)
    state, _ = make_run(scene, 400, donate=False)(scene.init_state())
    u = np.asarray(state.u)
    j = np.arange(ny)
    disc = (j * (ny - 1 - j)).astype(np.float64)
    disc /= disc.max()
    for col in (nx // 2, nx - 4):
        prof = u[:, col]
        assert prof.max() > 0.1
        np.testing.assert_allclose(prof / prof.max(), disc, atol=0.01,
                                   err_msg=f"column {col}")
    # And the flow is symmetric about the centerline.
    np.testing.assert_allclose(u[:, nx // 2], u[::-1, nx // 2], atol=1e-3)
