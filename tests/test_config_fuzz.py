"""Randomized configuration fuzz (deterministic seed).

Sweeps random combinations of scheme x solver x semantics x flow case
x obstacle geometry x odd grid shapes through short rollouts, checking
the invariants every configuration must satisfy: finite fields, exact
no-slip rows, and zero velocity on the BC-masked obstacle faces. The
aim is the corners no hand-written test enumerates (obstacles clipped
by walls, multiple overlapping obstacles, extreme aspect ratios,
non-tile-friendly shapes).
"""
import numpy as np
import pytest

import jax.numpy as jnp

import cfd_demo_jax as cfd
from cfd_demo_jax import (Box, Cylinder, FlowCase, Grid, InletProfile,
                          PressureSolver, Semantics, SimulationParams,
                          VelocityScheme, solver_options_for)

rng = np.random.RandomState(20260817)


def _random_case(k):
    nx = int(rng.choice([17, 24, 33, 40, 48, 56, 64, 96]))
    ny = int(rng.choice([10, 14, 16, 22, 24, 32, 48]))
    lx = float(rng.uniform(2.0, 30.0))
    ly = float(rng.uniform(1.0, 10.0))
    n_obs = int(rng.randint(0, 3))
    obstacles = []
    for _ in range(n_obs):
        cx = float(rng.uniform(-0.2 * lx, 1.1 * lx))   # may clip walls
        cy = float(rng.uniform(-0.2 * ly, 1.1 * ly))
        if rng.rand() < 0.5:
            obstacles.append(Cylinder(cx, cy, float(rng.uniform(0.05, 0.3) * ly)))
        else:
            obstacles.append(Box(cx, cy, float(rng.uniform(0.05, 0.3) * lx),
                                 float(rng.uniform(0.05, 0.3) * ly)))
    flow_case = FlowCase.CAVITY if rng.rand() < 0.2 else FlowCase.CHANNEL
    if flow_case == FlowCase.CAVITY:
        obstacles = []
    grid = Grid(nx=nx, ny=ny, lx=lx, ly=ly, obstacles=tuple(obstacles))
    params = SimulationParams(
        dt=float(rng.uniform(5e-4, 5e-3)),
        viscosity=float(10.0 ** rng.uniform(-5, -1.3)),
        target_inlet_velocity=float(rng.uniform(0.0, 2.0)),
        velocity_scheme=VelocityScheme(rng.choice(["first", "second", "quick"])),
        inlet_profile=InletProfile(rng.choice(["uniform", "parabolic"])),
        pressure_solver=PressureSolver(rng.choice(
            ["jacobi", "sor", "multigrid", "mg-production"])),
        flow_case=flow_case)
    semantics = Semantics.JS if rng.rand() < 0.4 else Semantics.RUST
    rounds = int(rng.choice([0, 1, 3]))
    early_exit = bool(rng.rand() < 0.5)
    # Differentiable mode's documented contract: fixed-trip loops only
    # (make_scene validates early_exit/rounds/adaptive-substeps).
    differentiable = bool(rng.rand() < 0.2) and rounds == 0 \
        and not early_exit and semantics == Semantics.RUST
    opts = solver_options_for(
        semantics, ramp_up_steps=int(rng.randint(1, 20)),
        jacobi_iters=int(rng.randint(3, 20)),
        outer_corrector_rounds=rounds,
        early_exit=early_exit,
        mgp_rtol=float(rng.choice([0.0, 1e-2])),
        # exercised only by SOR scenes; harmless draw otherwise
        sor_ordering=str(rng.choice(["redblack", "redblack",
                                     "lexicographic"])),
        # fixed-trip masked loops everywhere; forward must stay
        # invariant-clean too
        differentiable=differentiable)
    return grid, params, opts


CASES = [_random_case(k) for k in range(24)]


@pytest.mark.parametrize("idx", range(len(CASES)))
def test_random_config(idx):
    grid, params, opts = CASES[idx]
    scene = cfd.make_scene(grid, params, opts)
    steps = 8
    state, diags = cfd.make_run(scene, steps, donate=False)(
        scene.init_state())
    u = np.asarray(state.u)
    v = np.asarray(state.v)
    p = np.asarray(state.p)
    label = (f"case {idx}: {grid.nx}x{grid.ny} {params.velocity_scheme} "
             f"{params.pressure_solver} {opts.semantics} "
             f"{params.flow_case} obs={len(grid.obstacles)}")
    assert np.isfinite(u).all() and np.isfinite(v).all() \
        and np.isfinite(p).all(), label
    # No-slip rows are exact; in the cavity the TOP row is the moving
    # lid (uniform, equal to the ramped lid speed), not a wall.
    assert np.all(u[0] == 0), label
    if params.flow_case == FlowCase.CAVITY:
        # lid row: ramped lid speed (uniform, or the parabolic profile
        # along x -- symmetric, peaked mid-lid); side corners pinned 0
        if params.inlet_profile == InletProfile.UNIFORM:
            assert np.all(u[-1, 1:-1] == u[-1, 1]), label
        else:
            # parabola in x: mirror-symmetric with a strictly interior
            # peak (a regression to a uniform lid fails the strict
            # inequality; an unramped/zero lid is legitimately flat)
            lid = u[-1]
            assert np.allclose(lid, lid[::-1], atol=1e-6), label
            if lid.max() > 0:
                assert lid.max() > lid[1] and lid.max() > lid[-2], label
        assert u[-1, 0] == 0 and u[-1, -1] == 0, label
    else:
        assert np.all(u[-1] == 0), label
    assert np.all(v[0] == 0), label
    # BC-masked obstacle faces end the step at exactly zero.
    mu = scene.mask_u_bc.astype(bool)
    mv = scene.mask_v_bc.astype(bool)[:grid.ny, :]
    assert np.all(u[mu] == 0), label
    assert np.all(v[mv] == 0), label


@pytest.mark.parametrize("name", ["pressure_impl", "substep_impl",
                                  "rounds_impl", "pallas_fuse_k",
                                  "pallas_block_rows", "fdm_precision"])
def test_removed_kernel_options_are_refused(name):
    """The hand-written kernel tier and its routing options are gone:
    every solve is the one XLA program, on every backend."""
    with pytest.raises(TypeError):
        cfd.SolverOptions(**{name: 0})
