"""Golden comparison: the jitted step vs the scalar NumPy oracle.

The fixed-schedule pipeline of tests/test_golden.py as a reusable
harness: every convergence tolerance is zero, so the device step and
the oracle run identical iteration counts and every field must agree
to float32 accumulation noise. Used by the tests on the CPU and by
chip_smoke.py on the accelerator.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from ..core.config import (Cylinder, FlowCase, Grid, PressureSolver,
                           Semantics, SimulationParams, solver_options_for)

# BASELINE.json's accuracy contract: per-field L2 <= 1e-5 vs the CPU
# reference, per step.
GOLDEN_L2 = 1e-5
FIELDS = ("u", "v", "p", "p_prime")
# The solver families the oracle transcribes (MG_PRODUCTION and FDM are
# additions beyond the reference; tests/test_projection.py covers them).
ORACLE_SOLVERS = (PressureSolver.JACOBI, PressureSolver.SOR,
                  PressureSolver.MULTIGRID)


def golden_case(solver: PressureSolver, semantics: Semantics,
                flow_case: FlowCase, nx: int = 24, ny: int = 16):
    """(grid, params, opts) of one fixed-schedule golden configuration
    on an nx x ny grid (the domain stays fixed, so dx follows nx)."""
    if flow_case == FlowCase.CAVITY:
        grid = Grid(nx=nx, ny=ny, lx=1.5, ly=1.0)
        viscosity = 1e-3
    else:
        grid = Grid(nx=nx, ny=ny, lx=4.0, ly=1.5,
                    obstacles=(Cylinder(center_x=1.0, center_y=0.75,
                                        radius=0.3),))
        viscosity = 1e-4
    params = SimulationParams(dt=0.004, viscosity=viscosity,
                              pressure_solver=solver, flow_case=flow_case)
    fixed = dict(ramp_up_steps=3, jacobi_tol=0.0, outer_corrector_tol=0.0,
                 jacobi_iters=10)
    if semantics == Semantics.RUST:
        opts = solver_options_for(semantics, outer_corrector_rounds=4,
                                  **fixed)
    else:
        opts = solver_options_for(semantics, substeps_adaptive=False,
                                  substeps_init=2, **fixed)
    return grid, params, opts


def oracle_field(oracle, name: str) -> np.ndarray:
    """The oracle keeps the reference's (ny+1, nx) v shape; the device
    layout stores the implicit-zero top row separately (Grid.shape_v)."""
    f = getattr(oracle, name)
    if name == "v":
        assert np.abs(f[-1, :]).max() == 0.0, "oracle v top row not zero"
        return f[:-1]
    return f


def field_error(got, want, gauge: bool = False) -> float:
    """RMS difference scaled by max(1, RMS of the oracle field) -- the
    golden contract's L2, relative once a field exceeds unit scale.
    ``gauge`` removes the mean difference first: pressure enters the
    dynamics only through its gradient, and a uniform offset of a few
    ulps of its accumulated magnitude is not a discretization error."""
    want = np.asarray(want, np.float64)
    d = np.asarray(got, np.float64) - want
    if gauge:
        d = d - d.mean()
    scale = max(1.0, float(np.sqrt(np.mean(want ** 2))))
    return float(np.sqrt(np.mean(d ** 2))) / scale


def oracle_errors(grid, params, opts, steps: int = 3
                  ) -> List[Dict[str, float]]:
    """Per step, :func:`field_error` of each field between the jitted
    step (on the default device) and the oracle -- pressures gauge-free
    -- plus the relative dt error. Each must stay <= GOLDEN_L2."""
    from ..solver.piso import make_scene, make_step
    from .reference import NumpyModel

    scene = make_scene(grid, params, opts)
    step = make_step(scene, donate=False)
    oracle = NumpyModel(grid, params, opts)
    state = scene.init_state()
    out = []
    for _ in range(steps):
        oracle.update()
        state, _ = step(state)
        errs = {f: field_error(getattr(state, f), oracle_field(oracle, f),
                               gauge=f in ("p", "p_prime"))
                for f in FIELDS}
        errs["dt_rel"] = abs(float(state.dt) / float(oracle.dt) - 1.0)
        out.append(errs)
    return out
