"""Golden tests: the jit-compiled solver vs the scalar NumPy oracle.

BASELINE.json acceptance: per-field L2 error <= 1e-5 vs the CPU
reference, per step. The oracle (cfd_demo_jax.oracle.reference) is an
independent scalar transcription of the reference discretization.

Two layers:

1. ``test_pipeline_fixed_iters`` forces every convergence tolerance to
   zero so both implementations run *identical* iteration counts; every
   field must then agree to float32 accumulation noise. This pins the
   entire discretization (schemes x solvers x semantics).

2. ``test_step_matches_oracle`` uses the reference's real constants.
   The data-dependent early exits sit on float knife edges (the loop
   exits the first time a residual crosses tol, so the deciding value
   is ~tol itself); when two float32 implementations disagree by 1e-8
   there, the *outer corrector round count* can differ by one, which
   shifts the accumulated p by a near-uniform field while leaving the
   velocities (driven by grad p') identical. We therefore assert
   strictly on u, v, dt, substeps, on grad(p) (what feeds back into
   the dynamics), and on p itself after removing the mean difference
   -- pinning absolute pressure up to that documented uniform gauge
   shift (measured <= 2.3e-6 relative, bound 1e-5).
"""
import numpy as np
import pytest

from cfd_demo_jax import (Cylinder, Grid, InletProfile, PressureSolver,
                          Semantics, SimulationParams, VelocityScheme,
                          make_scene, make_step, solver_options_for)
from cfd_demo_jax.oracle.reference import NumpyModel

from conftest import l2


def oracle_field(oracle, name):
    """The oracle keeps the reference's (ny+1, nx) v shape; the device
    layout stores the implicit-zero top row separately (Grid.shape_v)."""
    f = getattr(oracle, name)
    if name == "v":
        assert np.abs(f[-1, :]).max() == 0.0, "oracle v top row not zero"
        return f[:-1]
    return f


def small_grid(obstacle=True):
    obstacles = (Cylinder(center_x=1.0, center_y=0.75, radius=0.3),) if obstacle else ()
    return Grid(nx=24, ny=16, lx=4.0, ly=1.5, obstacles=obstacles)


CONFIGS = [
    ("rust-first-jacobi", Semantics.RUST, VelocityScheme.FIRST, PressureSolver.JACOBI, InletProfile.UNIFORM),
    ("rust-second-jacobi", Semantics.RUST, VelocityScheme.SECOND, PressureSolver.JACOBI, InletProfile.PARABOLIC),
    ("js-first-jacobi", Semantics.JS, VelocityScheme.FIRST, PressureSolver.JACOBI, InletProfile.UNIFORM),
    ("js-second-jacobi", Semantics.JS, VelocityScheme.SECOND, PressureSolver.JACOBI, InletProfile.UNIFORM),
    ("js-quick-jacobi", Semantics.JS, VelocityScheme.QUICK, PressureSolver.JACOBI, InletProfile.PARABOLIC),
    ("rust-first-jacobi-upper", Semantics.RUST, VelocityScheme.FIRST, PressureSolver.JACOBI, InletProfile.PARABOLIC_UPPER),
    ("js-first-sor", Semantics.JS, VelocityScheme.FIRST, PressureSolver.SOR, InletProfile.UNIFORM),
    ("js-first-multigrid", Semantics.JS, VelocityScheme.FIRST, PressureSolver.MULTIGRID, InletProfile.UNIFORM),
]


def _params(scheme, solver, profile):
    return SimulationParams(dt=0.004, viscosity=1e-4,
                            target_inlet_velocity=1.0,
                            velocity_scheme=scheme,
                            inlet_profile=profile,
                            pressure_solver=solver)


@pytest.mark.parametrize("name,sem,scheme,solver,profile", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_pipeline_fixed_iters(name, sem, scheme, solver, profile):
    grid = small_grid()
    params = _params(scheme, solver, profile)
    opts = solver_options_for(
        sem, ramp_up_steps=3,
        jacobi_tol=0.0, outer_corrector_tol=0.0, jacobi_iters=10,
        substeps_adaptive=False, substeps_init=2 if sem == Semantics.JS else 1)
    if sem == Semantics.RUST:
        opts = solver_options_for(
            sem, ramp_up_steps=3, jacobi_tol=0.0, outer_corrector_tol=0.0,
            jacobi_iters=10, outer_corrector_rounds=4)
    scene = make_scene(grid, params, opts)
    step = make_step(scene, donate=False)
    oracle = NumpyModel(grid, params, opts)
    state = scene.init_state()
    for k in range(3):
        oracle.update()
        state, _ = step(state)
        for fname in ("u", "v", "p", "p_prime"):
            got = np.asarray(getattr(state, fname))
            want = oracle_field(oracle, fname)
            err = l2(got, want)
            assert err <= 1e-5, f"{name} step {k}: {fname} L2={err:.3e}"
        assert np.isclose(float(state.dt), float(oracle.dt),
                          rtol=1e-5, atol=1e-8), f"{name} step {k}: dt"


@pytest.mark.parametrize("name,sem,scheme,solver,profile", CONFIGS,
                         ids=[c[0] for c in CONFIGS])
def test_step_matches_oracle(name, sem, scheme, solver, profile):
    grid = small_grid()
    params = _params(scheme, solver, profile)
    opts = solver_options_for(sem, ramp_up_steps=4)
    scene = make_scene(grid, params, opts)
    step = make_step(scene, donate=False)
    oracle = NumpyModel(grid, params, opts)
    state = scene.init_state()

    dx, dy = grid.dx, grid.dy
    for k in range(4):
        oracle.update()
        state, diag = step(state)
        for fname in ("u", "v"):
            want = oracle_field(oracle, fname)
            err = l2(np.asarray(getattr(state, fname)), want)
            scale = max(1.0, float(np.sqrt(np.mean(
                np.asarray(want, np.float64) ** 2))))
            assert err <= 1e-5 * scale, (
                f"{name} step {k}: {fname} L2={err:.3e} (scale {scale:.2e})")
        # p enters the dynamics only through its gradient.
        gp = np.asarray(state.p, np.float64)
        op = np.asarray(oracle.p, np.float64)
        gscale = max(1.0, float(np.sqrt(np.mean(
            (np.diff(op, axis=1) / dx) ** 2))))
        gx = l2(np.diff(gp, axis=1) / dx, np.diff(op, axis=1) / dx)
        gy = l2(np.diff(gp, axis=0) / dy, np.diff(op, axis=0) / dy)
        assert max(gx, gy) <= 1e-4 * gscale, (
            f"{name} step {k}: grad p L2={gx:.2e}/{gy:.2e} (scale {gscale:.2e})")
        # Absolute p, modulo the gauge: the knife-edge round-count
        # shift really is a UNIFORM field -- after removing the mean
        # difference, p meets the same 1e-5 acceptance bound as the
        # velocities (measured worst 2.3e-6 across all configs).
        d = gp - op
        d -= d.mean()
        pscale = max(1.0, float(np.sqrt(np.mean(op ** 2))))
        perr = float(np.sqrt(np.mean(d ** 2)))
        assert perr <= 1e-5 * pscale, (
            f"{name} step {k}: demeaned p L2={perr:.3e} (scale {pscale:.2e})")
        assert np.isclose(float(state.dt), float(oracle.dt),
                          rtol=1e-5, atol=1e-8), f"{name} step {k}: dt"
        assert int(state.substeps) == oracle.substeps, (
            f"{name} step {k}: substeps {int(state.substeps)} vs "
            f"{oracle.substeps}")


def test_masked_mode_matches_early_exit():
    """lax.scan masked updates must equal lax.while_loop early exit."""
    grid = small_grid()
    params = SimulationParams(dt=0.004, viscosity=1e-4)
    s_exact = make_scene(grid, params,
                         solver_options_for(Semantics.RUST, ramp_up_steps=4))
    s_masked = make_scene(grid, params,
                          solver_options_for(Semantics.RUST, ramp_up_steps=4,
                                             early_exit=False))
    step_e = make_step(s_exact, donate=False)
    step_m = make_step(s_masked, donate=False)
    se, sm = s_exact.init_state(), s_masked.init_state()
    for _ in range(3):
        se, _ = step_e(se)
        sm, _ = step_m(sm)
    for fname in ("u", "v", "p", "p_prime"):
        np.testing.assert_allclose(np.asarray(getattr(se, fname)),
                                   np.asarray(getattr(sm, fname)),
                                   rtol=0, atol=1e-7)


def test_js_residual_dt_scaling_matches_oracle():
    """index.html:338-350 dt scaling by pressure residual."""
    grid = small_grid()
    params = SimulationParams(dt=0.004, viscosity=1e-4)
    opts = solver_options_for(Semantics.JS, ramp_up_steps=4,
                              residual_dt_scaling=True,
                              substeps_adaptive=False, substeps_init=2,
                              jacobi_tol=0.0, jacobi_iters=10)
    scene = make_scene(grid, params, opts)
    step = make_step(scene, donate=False)
    oracle = NumpyModel(grid, params, opts)
    state = scene.init_state()
    for k in range(4):
        oracle.update()
        state, _ = step(state)
        assert np.isclose(float(state.dt), float(oracle.dt),
                          rtol=1e-5, atol=1e-9), (
            f"step {k}: dt {float(state.dt)} vs {float(oracle.dt)}")
        err = l2(np.asarray(state.u), oracle_field(oracle, "u"))
        assert err <= 1e-5


def test_cavity_parabolic_lid_matches_oracle():
    """The cavity's parabolic lid (profile applied along x, zero at
    the side walls) is implemented in both the device path and the
    oracle; fixed iteration schedule, per-field L2 <= 1e-5."""
    from cfd_demo_jax import FlowCase

    grid = Grid(nx=24, ny=16, lx=1.5, ly=1.0)
    params = SimulationParams(dt=0.004, viscosity=1e-3,
                              target_inlet_velocity=1.0,
                              velocity_scheme=VelocityScheme.FIRST,
                              inlet_profile=InletProfile.PARABOLIC,
                              pressure_solver=PressureSolver.JACOBI,
                              flow_case=FlowCase.CAVITY)
    opts = solver_options_for(
        Semantics.RUST, ramp_up_steps=3, jacobi_tol=0.0,
        outer_corrector_tol=0.0, jacobi_iters=10,
        outer_corrector_rounds=4)
    scene = make_scene(grid, params, opts)
    step = make_step(scene, donate=False)
    oracle = NumpyModel(grid, params, opts)
    state = scene.init_state()
    for k in range(3):
        oracle.update()
        state, _ = step(state)
        for fname in ("u", "v", "p", "p_prime"):
            got = np.asarray(getattr(state, fname))
            want = oracle_field(oracle, fname)
            assert l2(got, want) <= 1e-5, (k, fname)
    # the lid row really is the parabola, not the uniform scalar
    lid = np.asarray(state.u)[-1]
    assert lid[0] == 0 and lid[-1] == 0
    assert lid.max() > 0.5 * float(state.target_inlet)
    assert not np.allclose(lid[1:-1], lid[1])
