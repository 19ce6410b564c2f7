"""Multi-device sharding tests on the 8-device virtual CPU mesh.

SURVEY.md section 4d: sharded-vs-unsharded equality validates the
GSPMD halo exchanges without a multi-GPU host.
"""
import numpy as np

import jax

import pytest as _pytest

pytestmark = _pytest.mark.skipif(
    len(jax.devices()) < 8,
    reason="needs the 8-device virtual CPU mesh (tests/conftest.py)")


from cfd_demo_jax import (Cylinder, Grid, Semantics, SimulationParams,
                          make_scene, make_step, solver_options_for)
from cfd_demo_jax.shard.mesh import make_mesh, make_sharded_step, shard_state


def test_sharded_step_matches_single_device():
    assert len(jax.devices()) == 8
    grid = Grid(nx=64, ny=64, lx=4.0, ly=4.0,
                obstacles=(Cylinder(1.0, 2.0, 0.4),))
    params = SimulationParams(dt=0.002, viscosity=1e-4)
    opts = solver_options_for(Semantics.RUST, ramp_up_steps=5)
    scene = make_scene(grid, params, opts)

    step1 = make_step(scene, donate=False)
    s1 = scene.init_state()

    mesh = make_mesh()
    stepN = make_sharded_step(scene, mesh)
    sN = shard_state(scene.init_state(), mesh)

    for _ in range(4):
        s1, _ = step1(s1)
        sN, _ = stepN(sN)

    for name in ("u", "v", "p", "p_prime"):
        a = np.asarray(getattr(s1, name))
        b = np.asarray(getattr(sN, name))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6,
                                   err_msg=f"field {name}")
    assert np.isclose(float(s1.res_p), float(sN.res_p), atol=1e-7)


def test_sharded_second_order_quick():
    """2-wide stencils (SECOND/QUICK) need 2-row halos; GSPMD must get
    them right across shard boundaries."""
    from cfd_demo_jax import VelocityScheme
    grid = Grid(nx=48, ny=64, lx=4.0, ly=4.0)
    mesh = make_mesh()
    for scheme in (VelocityScheme.SECOND, VelocityScheme.QUICK):
        params = SimulationParams(dt=0.002, viscosity=1e-4,
                                  velocity_scheme=scheme)
        opts = solver_options_for(Semantics.JS, ramp_up_steps=5,
                                  substeps_adaptive=False, substeps_init=1)
        scene = make_scene(grid, params, opts)
        s1 = scene.init_state()
        step1 = make_step(scene, donate=False)
        sN = shard_state(scene.init_state(), mesh)
        stepN = make_sharded_step(scene, mesh)
        for _ in range(3):
            s1, _ = step1(s1)
            sN, _ = stepN(sN)
        np.testing.assert_allclose(np.asarray(s1.u), np.asarray(sN.u),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(np.asarray(s1.v), np.asarray(sN.v),
                                   rtol=0, atol=1e-6)


def test_sharded_multigrid_step():
    """The multigrid solver (restrict/prolong now gather-free) must
    also match single-device under GSPMD row sharding."""
    from cfd_demo_jax import PressureSolver
    grid = Grid(nx=48, ny=64, lx=4.0, ly=4.0)
    params = SimulationParams(dt=0.002, viscosity=1e-4,
                              pressure_solver=PressureSolver.MULTIGRID)
    opts = solver_options_for(Semantics.JS, ramp_up_steps=5,
                              substeps_adaptive=False, substeps_init=1)
    scene = make_scene(grid, params, opts)
    s1 = scene.init_state()
    step1 = make_step(scene, donate=False)
    mesh = make_mesh()
    sN = shard_state(scene.init_state(), mesh)
    stepN = make_sharded_step(scene, mesh)
    for _ in range(3):
        s1, _ = step1(s1)
        sN, _ = stepN(sN)
    np.testing.assert_allclose(np.asarray(s1.u), np.asarray(sN.u),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(s1.p), np.asarray(sN.p),
                               rtol=0, atol=1e-5)


def test_sharded_mg_production_step():
    """MG_PRODUCTION (BC-aware V-cycles + divergence-calibrated
    masked-while exit, docs/SPEC.md item 12) under GSPMD row sharding
    must match single-device: every op in the cycle (smoother,
    interior-masked residual, restrict/prolong, bc selects) is built
    from shifted views + iota masks, and the exit reduction is a
    global max."""
    from cfd_demo_jax import PressureSolver
    grid = Grid(nx=48, ny=64, lx=4.0, ly=4.0,
                obstacles=(Cylinder(1.0, 2.0, 0.4),))
    params = SimulationParams(dt=0.002, viscosity=1e-4,
                              pressure_solver=PressureSolver.MG_PRODUCTION)
    opts = solver_options_for(Semantics.RUST, ramp_up_steps=5,
                              outer_corrector_rounds=0)
    scene = make_scene(grid, params, opts)
    s1 = scene.init_state()
    step1 = make_step(scene, donate=False)
    mesh = make_mesh()
    sN = shard_state(scene.init_state(), mesh)
    stepN = make_sharded_step(scene, mesh)
    for _ in range(3):
        s1, _ = step1(s1)
        sN, _ = stepN(sN)
    np.testing.assert_allclose(np.asarray(s1.u), np.asarray(sN.u),
                               rtol=0, atol=1e-6)
    # p accumulates p' over warm-started adaptive solves; the sharded
    # max-reductions reassociate, so allow ~1e-5 relative drift.
    np.testing.assert_allclose(np.asarray(s1.p), np.asarray(sN.p),
                               rtol=0, atol=1e-4)
    # res_p sits at the f32 noise floor of the aligned/FDM correction;
    # GSPMD partitions the FDM eigenbasis matmuls over the sharded row
    # dim, reassociating the contraction, so the exit-cycle residual
    # maxima differ by O(floor) between the two lowerings.
    assert np.isclose(float(s1.res_p), float(sN.res_p), atol=5e-5)


def test_vmap_ensemble():
    """BASELINE config 5: vmap over a batch of scenes (different
    viscosities/inlets) -- the step must be batchable."""
    grid = Grid(nx=32, ny=24, lx=2.0, ly=1.5)
    params = SimulationParams(dt=0.002, viscosity=1e-4)
    # masked iteration mode: while_loop trip counts are per-element.
    opts = solver_options_for(Semantics.RUST, ramp_up_steps=5,
                              early_exit=False)
    scene = make_scene(grid, params, opts)
    from cfd_demo_jax.solver.piso import step_fn
    from functools import partial
    import dataclasses

    base = scene.init_state()
    B = 8
    nus = np.linspace(1e-4, 1e-3, B).astype(np.float32)

    def broadcast(x):
        return jax.numpy.broadcast_to(x, (B,) + x.shape)

    batched = jax.tree.map(broadcast, base)
    batched = dataclasses.replace(batched, nu=jax.numpy.asarray(nus))

    step = jax.jit(jax.vmap(partial(step_fn, scene)))
    for _ in range(3):
        batched, diags = step(batched)
    u = np.asarray(batched.u)
    assert u.shape == (B, grid.ny, grid.nx + 1)
    assert np.isfinite(u).all()
    # Different viscosities must produce different flows.
    assert not np.allclose(u[0], u[-1])

    # Element k of the batch must equal an unbatched run with nu_k.
    params_k = dataclasses.replace(params, viscosity=float(nus[3]))
    scene_k = make_scene(grid, params_k, opts)
    sk = scene_k.init_state()
    step_k = make_step(scene_k, donate=False)
    for _ in range(3):
        sk, _ = step_k(sk)
    np.testing.assert_allclose(u[3], np.asarray(sk.u), rtol=0, atol=1e-6)


def test_gspmd_step_collective_pattern():
    """GSPMD row sharding lowers to neighbor collective-permutes and
    scalar all-reduces only -- XLA never falls back to gathering a
    full field onto every device (which would void the scale-out)."""
    mesh = make_mesh()
    grid = Grid(nx=64, ny=128, lx=4.0, ly=4.0,
                obstacles=(Cylinder(1.0, 2.0, 0.4),))
    scene = make_scene(
        grid, SimulationParams(dt=0.002, viscosity=1e-4),
        solver_options_for(Semantics.RUST, ramp_up_steps=5,
                           jacobi_tol=0.0, jacobi_iters=20,
                           outer_corrector_rounds=0, early_exit=False))
    state = shard_state(scene.init_state(), mesh)
    step = make_sharded_step(scene, mesh)
    txt = step.lower(state).compile().as_text()
    assert txt.count("all-gather") == 0
    assert txt.count("all-to-all") == 0
    assert txt.count("collective-permute") > 0   # halos exist


def test_batch_sharded_ensemble():
    """Serving-style tier: the vmap batch axis sharded over the device
    mesh. Results equal the unsharded batch, and the compiled HLO is
    embarrassingly parallel -- no halo collectives at all."""
    import dataclasses
    import jax.numpy as jnp
    from functools import partial
    from cfd_demo_jax.shard.mesh import (make_batch_sharded_step, make_mesh,
                                         shard_batch)
    from cfd_demo_jax.solver.piso import step_fn

    grid = Grid(nx=32, ny=24, lx=2.0, ly=1.5,
                obstacles=(Cylinder(0.5, 0.75, 0.2),))
    scene = make_scene(
        grid, SimulationParams(dt=0.002, viscosity=1e-4),
        solver_options_for(Semantics.RUST, ramp_up_steps=5,
                           early_exit=False))
    B = 8
    base = scene.init_state()
    batched = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), base)
    batched = dataclasses.replace(
        batched, nu=jnp.asarray(np.linspace(1e-4, 1e-3, B), jnp.float32))

    mesh = make_mesh(axis="b")
    step = make_batch_sharded_step(scene, mesh)
    sharded = shard_batch(batched, mesh)
    ref_step = jax.jit(jax.vmap(partial(step_fn, scene)))
    got, ref = sharded, batched
    for _ in range(3):
        got, gd = step(got)
        ref, rd = ref_step(ref)
    np.testing.assert_array_equal(np.asarray(got.u), np.asarray(ref.u))
    np.testing.assert_array_equal(np.asarray(got.p), np.asarray(ref.p))
    np.testing.assert_array_equal(np.asarray(gd.res_p), np.asarray(rd.res_p))

    txt = step.lower(sharded).compile().as_text()
    assert txt.count("collective-permute") == 0
    assert txt.count("all-gather") == 0
    assert txt.count("all-to-all") == 0


def test_batch_by_rows_2d_mesh():
    """Composed parallelism: ensemble batch over 'b' x grid rows over
    'y' on a 2x4 mesh. Equal to the unsharded batch; halo permutes
    stay scoped (no gathers)."""
    import dataclasses
    import jax.numpy as jnp
    from functools import partial
    from cfd_demo_jax.shard.mesh import make_mesh2d, shard_batch_rows
    from cfd_demo_jax.solver.piso import step_fn

    grid = Grid(nx=32, ny=32, lx=2.0, ly=2.0,
                obstacles=(Cylinder(0.5, 1.0, 0.2),))
    scene = make_scene(
        grid, SimulationParams(dt=0.002, viscosity=1e-4),
        solver_options_for(Semantics.RUST, ramp_up_steps=5,
                           early_exit=False))
    B = 4
    base = scene.init_state()
    batched = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), base)
    batched = dataclasses.replace(
        batched, nu=jnp.asarray(np.linspace(1e-4, 1e-3, B), jnp.float32))
    mesh = make_mesh2d(2, 4)
    placed = shard_batch_rows(batched, mesh)
    step = jax.jit(jax.vmap(partial(step_fn, scene)))
    got, ref = placed, batched
    for _ in range(3):
        got, _ = step(got)
        ref, _ = step(ref)
    np.testing.assert_array_equal(np.asarray(got.u), np.asarray(ref.u))
    np.testing.assert_array_equal(np.asarray(got.p), np.asarray(ref.p))
    txt = step.lower(placed).compile().as_text()
    assert txt.count("all-gather") == 0
    assert txt.count("all-to-all") == 0
    assert txt.count("collective-permute") > 0


def test_vmap_js_semantics_per_element_exact():
    """JS mode under vmap: adaptive substep counts and the
    extrapolated initial guess are per-element state driving a
    batched fori/while loop -- each batch element must match its own
    unbatched run exactly."""
    import dataclasses
    import jax.numpy as jnp
    from functools import partial
    from cfd_demo_jax.solver.piso import step_fn

    grid = Grid(nx=32, ny=24, lx=2.0, ly=1.5,
                obstacles=(Cylinder(0.5, 0.75, 0.2),))
    opts = solver_options_for(Semantics.JS, ramp_up_steps=5,
                              early_exit=False, jacobi_iters=8,
                              substeps_init=2, substeps_adaptive=True,
                              substeps_max=6)
    scene = make_scene(grid, SimulationParams(dt=0.003, viscosity=1e-4),
                       opts)
    B = 4
    nus = np.geomspace(1e-5, 1e-3, B).astype(np.float32)
    base = scene.init_state()
    batched = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (B,) + x.shape), base)
    batched = dataclasses.replace(batched, nu=jnp.asarray(nus))
    vstep = jax.jit(jax.vmap(partial(step_fn, scene)))
    for _ in range(4):
        batched, vd = vstep(batched)
    sstep = jax.jit(partial(step_fn, scene))
    for k in (0, B - 1):
        st = dataclasses.replace(base, nu=jnp.asarray(nus[k]))
        for _ in range(4):
            st, sd = sstep(st)
        np.testing.assert_array_equal(np.asarray(batched.u[k]),
                                      np.asarray(st.u), err_msg=f"u[{k}]")
        np.testing.assert_array_equal(np.asarray(batched.p[k]),
                                      np.asarray(st.p), err_msg=f"p[{k}]")
        assert int(batched.substeps[k]) == int(st.substeps), k


def test_spatial_2d_mesh_matches_single_device():
    """Sixth layout: 2-D rows x cols spatial decomposition
    (make_mesh2d_spatial). u's odd last column is split off at the jit
    boundary (Split2D adapter), so every boundary array divides evenly;
    fields must equal the single-device step bitwise."""
    from cfd_demo_jax.shard.mesh import (join_u, make_mesh2d_spatial,
                                         make_sharded_step_2d,
                                         shard_state_2d)
    grid = Grid(nx=64, ny=64, lx=4.0, ly=4.0,
                obstacles=(Cylinder(1.0, 2.0, 0.4),))
    params = SimulationParams(dt=0.002, viscosity=1e-4)
    opts = solver_options_for(Semantics.RUST, ramp_up_steps=5)
    scene = make_scene(grid, params, opts)

    step1 = make_step(scene, donate=False)
    s1 = scene.init_state()
    for mesh_shape in ((2, 4), (4, 2)):
        mesh = make_mesh2d_spatial(*mesh_shape)
        stepN = make_sharded_step_2d(scene, mesh)
        sN = shard_state_2d(scene.init_state(), mesh)
        r1 = s1
        for _ in range(3):
            r1, _ = step1(r1)
            sN, _ = stepN(sN)
        full = join_u(sN)
        for name in ("u", "v", "p", "p_prime"):
            np.testing.assert_array_equal(
                np.asarray(getattr(r1, name)),
                np.asarray(getattr(full, name)),
                err_msg=f"{mesh_shape} field {name}")


def test_spatial_2d_mesh_collective_pattern():
    """2-D spatial tier communication: column+row halo permutes and
    scalar reductions; no all-to-all, and the only gathers are the
    one-lane u_last re-joins (bounded small count)."""
    from cfd_demo_jax.shard.mesh import (make_mesh2d_spatial,
                                         make_sharded_step_2d,
                                         shard_state_2d)
    grid = Grid(nx=64, ny=64, lx=4.0, ly=4.0,
                obstacles=(Cylinder(1.0, 2.0, 0.4),))
    scene = make_scene(grid, SimulationParams(dt=0.002, viscosity=1e-4),
                       solver_options_for(Semantics.RUST, ramp_up_steps=5))
    mesh = make_mesh2d_spatial(2, 4)
    step = make_sharded_step_2d(scene, mesh)
    txt = step.lower(shard_state_2d(scene.init_state(), mesh)
                     ).compile().as_text()
    assert txt.count("all-to-all") == 0
    assert txt.count("collective-permute") > 0
    assert txt.count("all-gather") <= 6


def test_spatial_2d_mesh_js_semantics():
    """JS semantics (u_prev extrapolation buffers also carry a split
    last column) through the 2-D spatial tier, scan-fused."""
    from cfd_demo_jax.shard.mesh import (join_u, make_mesh2d_spatial,
                                         make_sharded_step_2d,
                                         shard_state_2d)
    from cfd_demo_jax import make_run
    grid = Grid(nx=64, ny=32, lx=4.0, ly=2.0)
    params = SimulationParams(dt=0.002, viscosity=1e-4)
    opts = solver_options_for(Semantics.JS, ramp_up_steps=5,
                              substeps_adaptive=False, substeps_init=1,
                              extrapolate=True)
    scene = make_scene(grid, params, opts)
    ref, _ = make_run(scene, 4, donate=False)(scene.init_state())
    mesh = make_mesh2d_spatial(2, 4)
    run = make_sharded_step_2d(scene, mesh, n_steps=4)
    got, _ = run(shard_state_2d(scene.init_state(), mesh))
    full = join_u(got)
    for name in ("u", "v", "p", "u_prev", "v_prev"):
        np.testing.assert_array_equal(np.asarray(getattr(ref, name)),
                                      np.asarray(getattr(full, name)),
                                      err_msg=name)


def test_elastic_reshard_resume_npz():
    """Elastic resume: a checkpoint written mid-run under the 8-device
    row layout restores onto a 4-device row mesh AND a 2x4 rows x cols
    spatial mesh, and both continuations match the single-device
    trajectory (SURVEY.md section 5 "elastic recovery" -- a superset of
    the reference, which has no persistence at all)."""
    import os
    import tempfile
    from cfd_demo_jax.runtime import checkpoint
    from cfd_demo_jax.shard.mesh import (join_u, make_mesh2d_spatial,
                                         make_sharded_step_2d,
                                         shard_state_2d)

    grid = Grid(nx=64, ny=64, lx=4.0, ly=4.0,
                obstacles=(Cylinder(1.0, 2.0, 0.4),))
    scene = make_scene(grid, SimulationParams(dt=0.002, viscosity=1e-4),
                       solver_options_for(Semantics.RUST, ramp_up_steps=5))

    step1 = make_step(scene, donate=False)
    s1 = scene.init_state()
    mesh8 = make_mesh()
    step8 = make_sharded_step(scene, mesh8)
    s8 = shard_state(scene.init_state(), mesh8)
    for _ in range(3):
        s1, _ = step1(s1)
        s8, _ = step8(s8)

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.npz")
        checkpoint.save(path, s8)

        # single-device continuation = the truth
        ref = s1
        for _ in range(3):
            ref, _ = step1(ref)

        # resume on 4 devices (row layout)
        mesh4 = make_mesh(jax.devices()[:4])
        s4 = checkpoint.load(path, template=scene.init_state(), mesh=mesh4)
        assert s4.u.sharding.mesh.size == 4
        step4 = make_sharded_step(scene, mesh4)
        for _ in range(3):
            s4, _ = step4(s4)
        for name in ("u", "v", "p", "p_prime"):
            np.testing.assert_allclose(
                np.asarray(getattr(ref, name)),
                np.asarray(getattr(s4, name)), rtol=0, atol=1e-6,
                err_msg=f"4-dev resume field {name}")

        # resume on a 2x4 spatial mesh (Split2D jit boundary)
        mesh24 = make_mesh2d_spatial(2, 4)
        s24 = shard_state_2d(
            checkpoint.load(path, template=scene.init_state()), mesh24)
        step24 = make_sharded_step_2d(scene, mesh24)
        for _ in range(3):
            s24, _ = step24(s24)
        full = join_u(s24)
        for name in ("u", "v", "p", "p_prime"):
            np.testing.assert_allclose(
                np.asarray(getattr(ref, name)),
                np.asarray(getattr(full, name)), rtol=0, atol=1e-6,
                err_msg=f"2x4 resume field {name}")


def test_orbax_elastic_restore_into_sharding():
    """load_orbax(mesh=...) restores every field DIRECTLY into the
    target NamedSharding (no host gather) and the resumed sharded run
    matches the unsharded continuation."""
    import os
    import tempfile
    from cfd_demo_jax.runtime import checkpoint
    from jax.sharding import PartitionSpec as P

    grid = Grid(nx=64, ny=64, lx=4.0, ly=4.0,
                obstacles=(Cylinder(1.0, 2.0, 0.4),))
    scene = make_scene(grid, SimulationParams(dt=0.002, viscosity=1e-4),
                       solver_options_for(Semantics.RUST, ramp_up_steps=5))
    step1 = make_step(scene, donate=False)
    st = scene.init_state()
    for _ in range(3):
        st, _ = step1(st)

    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "ck")
        checkpoint.save_orbax(p, st)
        mesh = make_mesh()
        got = checkpoint.load_orbax(p, scene.init_state(), mesh=mesh)

    assert got.u.sharding.mesh.size == len(jax.devices())
    assert got.u.sharding.spec == P("y", None)
    assert got.res_u.sharding.spec == P()
    np.testing.assert_array_equal(np.asarray(st.u), np.asarray(got.u))
    np.testing.assert_array_equal(np.asarray(st.p), np.asarray(got.p))

    ref, _ = step1(st)
    stepN = make_sharded_step(scene, mesh)
    out, _ = stepN(got)
    for name in ("u", "v", "p"):
        np.testing.assert_allclose(
            np.asarray(getattr(ref, name)),
            np.asarray(getattr(out, name)), rtol=0, atol=1e-6,
            err_msg=f"field {name}")
