"""vmap semantics of the step: every scene of a vmapped batch equals an
unbatched run of that scene, for every pressure solver, both
semantics and both early_exit settings.

This pins the two custom_vmap rules of solver/piso.py: the Jacobi
solve runs the masked loop under vmap (each scene freezes at its own
exit), and the substep rule vmaps the whole substep per scene. The
other solvers' early exits are lifted while_loops whose batched
predicate freezes finished scenes, and MG_PRODUCTION switches from its
exact loop to the masked one when it sees a batch.
"""
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cfd_demo_jax import (Cylinder, Grid, PressureSolver, Semantics,
                          SimulationParams, make_run, make_scene,
                          solver_options_for)
from cfd_demo_jax.solver.piso import step_fn

NUS = (1e-4, 6e-4, 3e-3)
STEPS = 3


@pytest.mark.parametrize("early_exit", [True, False],
                         ids=["early_exit", "masked"])
@pytest.mark.parametrize("semantics", list(Semantics), ids=lambda s: s.value)
@pytest.mark.parametrize("solver", list(PressureSolver), ids=lambda s: s.value)
def test_vmapped_scene_equals_unbatched(solver, semantics, early_exit):
    grid = Grid(nx=24, ny=16, lx=4.0, ly=1.5,
                obstacles=(Cylinder(1.0, 0.75, 0.3),))
    scene = make_scene(grid,
                       SimulationParams(dt=0.004, viscosity=NUS[0],
                                        pressure_solver=solver),
                       # One short V-cycle keeps the multigrid kit's
                       # unrolled program quick to compile.
                       solver_options_for(semantics, ramp_up_steps=2,
                                          early_exit=early_exit,
                                          mg_cycles=1, mg_pre_smooth=2,
                                          mg_post_smooth=2,
                                          mg_coarse_smooth=4,
                                          mg_coarsest=8))
    base = scene.init_state()
    batched = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (len(NUS),) + x.shape), base)
    batched = dataclasses.replace(batched, nu=jnp.asarray(NUS, jnp.float32))
    run_b = jax.jit(lambda s: jax.lax.scan(
        lambda c, _: jax.vmap(partial(step_fn, scene))(c), s, None,
        length=STEPS))
    got, got_d = run_b(batched)
    run_1 = make_run(scene, STEPS, donate=False)
    for k, nu in enumerate(NUS):
        want, want_d = run_1(dataclasses.replace(
            base, nu=jnp.asarray(nu, jnp.float32)))
        for f in ("p_iters", "rounds", "substeps"):
            np.testing.assert_array_equal(
                np.asarray(getattr(got_d, f))[:, k],
                np.asarray(getattr(want_d, f)), err_msg=f"scene {k} {f}")
        for f in ("u", "v", "p", "p_prime"):
            np.testing.assert_allclose(
                np.asarray(getattr(got, f))[k], np.asarray(getattr(want, f)),
                rtol=1e-5, atol=1e-6, err_msg=f"scene {k} {f}")
