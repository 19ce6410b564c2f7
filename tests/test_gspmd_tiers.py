"""The GSPMD tiers of shard.mesh against single-device runs, for every
pressure solver: row-sharded, rows x cols (2-D) and batch-sharded
steps on the 8-device virtual CPU mesh."""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cfd_demo_jax import (Cylinder, Grid, PressureSolver, Semantics,
                          SimulationParams, make_scene, make_step,
                          solver_options_for)
from cfd_demo_jax.shard.mesh import (join_u, make_batch_sharded_step,
                                     make_mesh, make_mesh2d_spatial,
                                     make_sharded_step, make_sharded_step_2d,
                                     shard_batch, shard_state,
                                     shard_state_2d)
from cfd_demo_jax.solver.piso import step_fn

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8,
    reason="needs the 8-device virtual CPU mesh (tests/conftest.py)")

STEPS = 2
FIELDS = ("u", "v", "p", "p_prime")


def _scene(solver):
    grid = Grid(nx=32, ny=32, lx=2.0, ly=2.0,
                obstacles=(Cylinder(0.5, 1.0, 0.2),))
    return make_scene(
        grid, SimulationParams(dt=0.002, viscosity=1e-4,
                               pressure_solver=solver),
        # One short V-cycle keeps the multigrid kit's unrolled program
        # small enough to compile in seconds.
        solver_options_for(Semantics.RUST, ramp_up_steps=4,
                           jacobi_iters=30, outer_corrector_rounds=2,
                           mg_cycles=1, mg_pre_smooth=2, mg_post_smooth=2,
                           mg_coarse_smooth=4, mg_coarsest=8))


def _assert_close(got, want, what):
    # Sharded reductions and matmuls reassociate: agreement to f32
    # accumulation noise, scaled by each field's magnitude.
    for name in FIELDS:
        a = np.asarray(getattr(got, name))
        b = np.asarray(getattr(want, name))
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale,
                                   err_msg=f"{what} field {name}")


def _single(scene, state):
    step = make_step(scene, donate=False)
    for _ in range(STEPS):
        state, _ = step(state)
    return state


SOLVERS = list(PressureSolver)


@pytest.mark.parametrize("solver", SOLVERS, ids=lambda s: s.value)
def test_row_sharded_step_matches_single_device(solver):
    scene = _scene(solver)
    mesh = make_mesh()
    step = make_sharded_step(scene, mesh)
    got = shard_state(scene.init_state(), mesh)
    for _ in range(STEPS):
        got, _ = step(got)
    _assert_close(got, _single(scene, scene.init_state()), "rows")


@pytest.mark.parametrize("solver", SOLVERS, ids=lambda s: s.value)
def test_2d_sharded_step_matches_single_device(solver):
    scene = _scene(solver)
    mesh = make_mesh2d_spatial(2, 4)
    step = make_sharded_step_2d(scene, mesh)
    got = shard_state_2d(scene.init_state(), mesh)
    for _ in range(STEPS):
        got, _ = step(got)
    _assert_close(join_u(got), _single(scene, scene.init_state()), "2-D")


@pytest.mark.parametrize("solver", SOLVERS, ids=lambda s: s.value)
def test_batch_sharded_step_matches_unbatched(solver):
    scene = _scene(solver)
    nus = np.linspace(1e-4, 1e-3, 8).astype(np.float32)
    base = scene.init_state()
    batched = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (len(nus),) + x.shape), base)
    batched = dataclasses.replace(batched, nu=jnp.asarray(nus))
    mesh = make_mesh(axis="b")
    step = make_batch_sharded_step(scene, mesh)
    got = shard_batch(batched, mesh)
    for _ in range(STEPS):
        got, _ = step(got)
    for k in (0, len(nus) - 1):
        want = _single(scene,
                       dataclasses.replace(base, nu=jnp.asarray(nus[k])))
        _assert_close(jax.tree.map(lambda x: x[k], got), want, f"scene {k}")


def test_step_fn_is_the_batched_program():
    """The batch tier shards exactly jax.vmap(step_fn): its first step
    equals the unsharded vmapped step bitwise."""
    scene = _scene(PressureSolver.JACOBI)
    base = scene.init_state()
    batched = jax.tree.map(lambda x: jnp.broadcast_to(x, (8,) + x.shape),
                           base)
    mesh = make_mesh(axis="b")
    got, _ = make_batch_sharded_step(scene, mesh)(shard_batch(batched, mesh))
    want, _ = jax.jit(jax.vmap(partial(step_fn, scene)))(batched)
    np.testing.assert_array_equal(np.asarray(got.u), np.asarray(want.u))
