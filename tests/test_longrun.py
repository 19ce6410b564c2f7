"""Long-horizon trajectory comparison vs the oracle.

The per-step golden tests pin single steps; this pins a 12-step
trajectory cumulatively (field-relative bound: float32 differences
compound through ~50 Jacobi iterations x up to 21 corrector rounds per
step, so the bar scales with horizon)."""
import numpy as np

from cfd_demo_jax import (Cylinder, Grid, Semantics, SimulationParams,
                          make_scene, make_step, solver_options_for)
from cfd_demo_jax.oracle.reference import NumpyModel

from conftest import l2


def test_trajectory_follows_oracle():
    grid = Grid(nx=20, ny=12, lx=4.0, ly=1.5,
                obstacles=(Cylinder(1.0, 0.75, 0.3),))
    params = SimulationParams(dt=0.004, viscosity=1e-4)
    opts = solver_options_for(Semantics.RUST, ramp_up_steps=4,
                              jacobi_iters=20, outer_corrector_rounds=5,
                              jacobi_tol=0.0, outer_corrector_tol=0.0)
    scene = make_scene(grid, params, opts)
    step = make_step(scene, donate=False)
    oracle = NumpyModel(grid, params, opts)
    state = scene.init_state()
    for _ in range(12):
        oracle.update()
        state, _ = step(state)
    for fname in ("u", "v"):
        want = getattr(oracle, fname)
        if fname == "v":
            want = want[:-1]
        scale = max(1.0, float(np.sqrt(np.mean(want.astype(np.float64) ** 2))))
        err = l2(np.asarray(getattr(state, fname)), want)
        # cumulative float32 drift over 12 steps x 125 sweeps
        assert err <= 5e-5 * scale, f"{fname}: cumulative L2={err:.3e}"
