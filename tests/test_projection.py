"""PressureSolver.MG_PRODUCTION (docs/SPEC.md item 12): BC-aware
multigrid with a divergence-calibrated exit -- a deliberate addition
beyond the reference's solvers, for production projection quality.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cfd_demo_jax import (Cylinder, Grid, PressureSolver, Semantics,
                          SimulationParams, make_scene, make_run,
                          solver_options_for)
from cfd_demo_jax.ops.divergence import divergence
from cfd_demo_jax.ops.poisson import (_apply_pprime_bcs, _mg_residual,
                                      multigrid_production)


def _opts(**kw):
    return solver_options_for(Semantics.RUST, **kw)


def test_solver_reaches_residual_tolerance():
    """Manufactured Poisson problem: cycles run until max|rhs - A p|
    <= tol_r, far below what the parity kit's 3 fixed cycles reach."""
    ny, nx = 96, 128
    dx = dy = 1.0 / nx
    rng = np.random.default_rng(0)
    rhs = jnp.asarray(rng.standard_normal((ny, nx)), jnp.float32)
    pp0 = jnp.zeros((ny, nx), jnp.float32)
    tol_r = 1e-2 * float(jnp.max(jnp.abs(rhs)))
    pp, err, n = jax.jit(
        lambda p, r: multigrid_production(p, r, dx, dy, _opts(), tol_r)
    )(pp0, rhs)
    r = _mg_residual(_apply_pprime_bcs(pp), rhs, dx, dy)
    assert float(err) <= tol_r
    assert float(jnp.max(jnp.abs(r))) <= tol_r * 1.0001
    assert 1 <= int(n) <= 30


def test_warm_start_reuses_previous_solution():
    """A second solve seeded with the first's p' converges in fewer
    cycles (the parity kit zero-inits every solve, index.html:777)."""
    ny, nx = 64, 64
    dx = dy = 1.0 / nx
    rng = np.random.default_rng(1)
    rhs = jnp.asarray(rng.standard_normal((ny, nx)), jnp.float32)
    tol_r = 1e-3 * float(jnp.max(jnp.abs(rhs)))
    # mgp_coarse_stop below the grid so the hierarchy actually cycles
    # (the default 96 would solve 62^2 interior exactly by FDM in one
    # cycle, cold == warm == 1).
    solve = jax.jit(lambda p, r: multigrid_production(
        p, r, dx, dy, _opts(mgp_coarse_stop=16), tol_r))
    pp, _, n_cold = solve(jnp.zeros((ny, nx), jnp.float32), rhs)
    _, _, n_warm = solve(pp, rhs)
    assert int(n_warm) < int(n_cold)


def test_divergence_bound_after_projection():
    """The exit tolerance is calibrated so post-correction
    max|div(u)| <= projection_div_tol away from the obstacle staircase
    and domain edges (where the reference's post-projection BC writes
    re-introduce divergence identically for every solver)."""
    grid = Grid(nx=96, ny=48, lx=6.0, ly=3.0,
                obstacles=(Cylinder(1.5, 1.5, 0.4),))
    div_tol = 1e-3
    results = {}
    for solver in (PressureSolver.MG_PRODUCTION, PressureSolver.JACOBI):
        scene = make_scene(
            grid,
            SimulationParams(dt=0.004, viscosity=1e-3,
                             pressure_solver=solver),
            _opts(projection_div_tol=div_tol))
        st, _ = make_run(scene, 60, donate=False)(scene.init_state())
        dv = np.asarray(divergence(np.asarray(st.u), np.asarray(st.v),
                                   grid.dx, grid.dy))
        yy, xx = np.meshgrid((np.arange(48) + 0.5) * grid.dy,
                             (np.arange(96) + 0.5) * grid.dx,
                             indexing="ij")
        far = np.hypot(xx - 1.5, yy - 1.5) > 0.4 + 3 * grid.dx
        far[:2] = far[-2:] = False
        far[:, :2] = far[:, -2:] = False
        results[solver] = (np.abs(dv[far]).max(), float(st.res_p),
                           float(st.dt))
    mgp_max, res_p, dt = results[PressureSolver.MG_PRODUCTION]
    assert mgp_max <= div_tol * 1.5, results
    assert res_p * dt <= div_tol * 1.0001  # the calibration identity
    # and it genuinely beats the reference schedule on the same scene
    jac_max = results[PressureSolver.JACOBI][0]
    assert mgp_max < jac_max


def test_rtol_exit_bounds_relative_reduction():
    """mgp_rtol > 0 widens the exit to max(abs, rtol * warm-start
    residual): with a far-out-of-reach absolute tol the solve exits on
    the relative criterion in a resolution-independent handful of
    cycles (multigrid contracts the residual ~constant factor/cycle),
    and the final residual really is <= rtol * r0."""
    rng = np.random.default_rng(3)
    cycles = []
    for ny, nx in ((32, 32), (64, 64), (128, 128)):
        dx = dy = 1.0 / nx
        rhs = jnp.asarray(rng.standard_normal((ny, nx)), jnp.float32)
        pp0 = jnp.zeros((ny, nx), jnp.float32)
        r0 = float(jnp.max(jnp.abs(_mg_residual(
            _apply_pprime_bcs(pp0), rhs, dx, dy))))
        pp, err, n = jax.jit(lambda p, r, d=dx: multigrid_production(
            p, r, d, d, _opts(mgp_rtol=1e-2), 1e-30))(pp0, rhs)
        assert float(err) <= 1e-2 * r0 * 1.0001, (ny, nx)
        cycles.append(int(n))
    # Near-resolution-independent cycle count (random rhs gives a few
    # cycles of drift between tiers; the absolute-tol mode by contrast
    # grows ~4x per refinement and hits the 30-cycle cap -- PERF.md).
    assert max(cycles) <= min(cycles) + 4, cycles
    assert max(cycles) < _opts().mgp_max_cycles, cycles


def test_rtol_inactive_when_absolute_dominates():
    """A tiny mgp_rtol leaves the combined threshold equal to the
    absolute tol_r, reproducing the default-mode solve exactly
    (cycle count and bits)."""
    ny, nx = 64, 96
    dx = dy = 1.0 / nx
    rng = np.random.default_rng(4)
    rhs = jnp.asarray(rng.standard_normal((ny, nx)), jnp.float32)
    pp0 = jnp.zeros((ny, nx), jnp.float32)
    tol_r = 1e-2 * float(jnp.max(jnp.abs(rhs)))
    base = jax.jit(lambda p, r: multigrid_production(
        p, r, dx, dy, _opts(), tol_r))(pp0, rhs)
    tiny = jax.jit(lambda p, r: multigrid_production(
        p, r, dx, dy, _opts(mgp_rtol=1e-12), tol_r))(pp0, rhs)
    np.testing.assert_array_equal(np.asarray(base[0]),
                                  np.asarray(tiny[0]))
    assert int(base[2]) == int(tiny[2])


def test_vmap_batch_freezes_per_element():
    """Masked convergence under vmap: each batch element's solve stops
    at its own tolerance crossing (matches unbatched)."""
    ny, nx = 48, 64
    dx = dy = 1.0 / nx
    rng = np.random.default_rng(2)
    rhs = jnp.asarray(rng.standard_normal((3, ny, nx)), jnp.float32)
    rhs = rhs * jnp.asarray([1.0, 5.0, 0.2])[:, None, None]
    tol_r = 1e-2
    solve = lambda r: multigrid_production(
        jnp.zeros((ny, nx), jnp.float32), r, dx, dy, _opts(), tol_r)
    batched = jax.jit(jax.vmap(solve))(rhs)
    for b in range(3):
        single = jax.jit(solve)(rhs[b])
        np.testing.assert_allclose(np.asarray(batched[0][b]),
                                   np.asarray(single[0]), atol=1e-6)
        assert int(batched[2][b]) == int(single[2])


def test_noise_floor_exit_beats_cycle_cap():
    """With an unreachable absolute tolerance (tol_r = 0), the
    f32-noise-floor exit (opts.mgp_floor) stops cycling once the
    residual is within a small multiple of its own rounding noise
    ~eps * (denom * max|p| + max|rhs|), instead of burning the whole
    cycle cap for no accuracy (which is what every solve at 8192^2
    did: the floor sits above the calibrated tol there --
    PERF.md)."""
    ny, nx = 96, 128
    dx = dy = 1.0 / nx
    rng = np.random.default_rng(5)
    rhs = jnp.asarray(rng.standard_normal((ny, nx)), jnp.float32)
    pp0 = jnp.zeros((ny, nx), jnp.float32)
    pp_s, err_s, n_s = jax.jit(lambda p, r: multigrid_production(
        p, r, dx, dy, _opts(mgp_max_cycles=100), 0.0))(pp0, rhs)
    assert int(n_s) < 100  # fired before the cap
    # Disabling it (pre-round-2 behavior) runs to the cap...
    pp_c, err_c, n_c = jax.jit(lambda p, r: multigrid_production(
        p, r, dx, dy, _opts(mgp_max_cycles=100, mgp_floor=0.0),
        0.0))(pp0, rhs)
    assert int(n_c) == 100
    # ...and the extra cycles only chase rounding noise: the floor
    # exit's residual is within a small factor of the cap-bound one
    # (the measured hard floor here is ~1.4x the formula; the exit
    # fires at 4x it).
    assert float(err_s) <= 8.0 * float(err_c)


def test_aligned_contraction_beats_legacy():
    """The aligned cell-centered hierarchy (round-2 redesign,
    opts.mgp_scheme) contracts ~0.1-0.3/cycle where the legacy JS-kit
    vertex transfers stall at ~0.76 on even grids (the coarse boundary
    lands one cell inside the domain -- PERF.md): the same solve
    to the same tolerance needs a small fraction of the cycles, on
    both BC families."""
    from cfd_demo_jax.ops.poisson import _apply_pprime_bcs_cavity
    ny, nx = 128, 128
    dx = dy = 1.0 / nx
    rng = np.random.default_rng(7)
    for bc in (_apply_pprime_bcs, _apply_pprime_bcs_cavity):
        rhs = np.zeros((ny, nx), np.float32)
        rhs[1:-1, 1:-1] = rng.standard_normal((ny - 2, nx - 2))
        if bc is _apply_pprime_bcs_cavity:
            rhs[1:-1, 1:-1] -= rhs[1:-1, 1:-1].mean()
        rhs = jnp.asarray(rhs)
        pp0 = jnp.zeros((ny, nx), jnp.float32)
        tol_r = 1e-3 * float(jnp.max(jnp.abs(rhs)))
        ns = {}
        for scheme in ("aligned", "legacy"):
            pp, err, n = jax.jit(
                lambda p, r, s=scheme: multigrid_production(
                    p, r, dx, dy, _opts(mgp_scheme=s, mgp_max_cycles=60),
                    tol_r))(pp0, rhs)
            ns[scheme] = int(n)
            if scheme == "aligned":
                assert float(err) <= tol_r, bc.__name__
        assert ns["aligned"] <= 10, ns
        assert ns["aligned"] * 3 <= ns["legacy"], (bc.__name__, ns)


def test_aligned_odd_and_anisotropic_sizes():
    """The per-axis odd-size rule (pad when (m+1)/2 is even, aggregate
    otherwise -- ops.poisson._cc_coarse_size) keeps contraction healthy
    on odd and anisotropic grids, where single-rule chains degrade
    (fake-domain padding compounds geometrically, PERF.md)."""
    rng = np.random.default_rng(8)
    for ny, nx in ((131, 211), (97, 129), (129, 255), (126, 254)):
        dx, dy = 1.0 / nx, 1.0 / ny
        rhs = np.zeros((ny, nx), np.float32)
        rhs[1:-1, 1:-1] = rng.standard_normal((ny - 2, nx - 2))
        rhs = jnp.asarray(rhs)
        tol_r = 1e-3 * float(jnp.max(jnp.abs(rhs)))
        pp, err, n = jax.jit(lambda p, r, a=dx, b=dy: multigrid_production(
            p, r, a, b, _opts(mgp_max_cycles=30), tol_r))(
                jnp.zeros((ny, nx), jnp.float32), rhs)
        assert float(err) <= tol_r, (ny, nx, float(err), tol_r)
        assert int(n) <= 12, (ny, nx, int(n))


def test_fdm_solves_interior_exactly():
    """ops.fdm fast diagonalization: the folded-operator residual of
    the direct solve sits at the f32 noise floor for both the channel
    (east-Dirichlet) and cavity (all-Neumann, pseudo-inverse gauge)
    operators, and the correction padded back satisfies the full-array
    residual convention."""
    from cfd_demo_jax.ops.fdm import fdm_solve_interior
    from cfd_demo_jax.ops.poisson import _mgp_aligned_correction
    rng = np.random.default_rng(9)
    ny, nx = 40, 56
    dx, dy = 1.0 / nx, 1.0 / ny
    for east_dirichlet in (True, False):
        r_int = rng.standard_normal((ny - 2, nx - 2)).astype(np.float32)
        if not east_dirichlet:
            r_int -= r_int.mean()
        r_full = jnp.asarray(np.pad(r_int, 1))
        e_full = jax.jit(lambda r, ed=east_dirichlet: _mgp_aligned_correction(
            r, dx, dy, _opts(), ed))(r_full)
        # residual of the folded system via the full-array convention:
        # boundary slaving == mirror/zero folds for these two BCs.
        bc = _apply_pprime_bcs if east_dirichlet else None
        from cfd_demo_jax.ops.poisson import _apply_pprime_bcs_cavity
        bc = bc or _apply_pprime_bcs_cavity
        p = bc(e_full)
        res = _mg_residual(p, r_full, dx, dy)
        floor = 30 * np.finfo(np.float32).eps * (
            (2 / dx**2 + 2 / dy**2) * float(jnp.max(jnp.abs(p)))
            + float(jnp.max(jnp.abs(r_full))))
        assert float(jnp.max(jnp.abs(res))) <= floor, east_dirichlet


def test_fdm_solver_projects_exactly():
    """PressureSolver.FDM (docs/SPEC.md item 13): the direct solve
    drives each substep's pressure residual to the f32 noise floor in
    ONE 'iteration', so post-correction divergence is at least as
    clean as MG_PRODUCTION's calibrated iterate on the same scene."""
    grid = Grid(nx=96, ny=48, lx=6.0, ly=3.0,
                obstacles=(Cylinder(1.5, 1.5, 0.4),))
    results = {}
    for solver in (PressureSolver.FDM, PressureSolver.MG_PRODUCTION):
        scene = make_scene(
            grid,
            SimulationParams(dt=0.004, viscosity=1e-3,
                             pressure_solver=solver),
            _opts(projection_div_tol=1e-3))
        st, diag = make_run(scene, 60, donate=False)(scene.init_state())
        dv = np.asarray(divergence(np.asarray(st.u), np.asarray(st.v),
                                   grid.dx, grid.dy))
        yy, xx = np.meshgrid((np.arange(48) + 0.5) * grid.dy,
                             (np.arange(96) + 0.5) * grid.dx,
                             indexing="ij")
        far = np.hypot(xx - 1.5, yy - 1.5) > 0.4 + 3 * grid.dx
        far[:2] = far[-2:] = False
        far[:, :2] = far[:, -2:] = False
        results[solver] = np.abs(dv[far]).max()
        assert np.isfinite(np.asarray(st.u)).all(), solver
    assert results[PressureSolver.FDM] <= \
        results[PressureSolver.MG_PRODUCTION] * 1.05, results


def test_fdm_large_size_low_modes():
    """Regression (round-2 review): eigenvalues must be computed as
    4 sin^2(theta/2), not 2 - 2 cos(theta) -- the cos form cancels
    catastrophically for low modes at large m (width 8190: lowest
    Dirichlet eigenvalue rounds to exactly 0 in f32 -> inf fields;
    width 2046/4094: O(1) relative error on smooth rhs). A smooth
    low-mode rhs at 2046^2 must solve to within a few multiples of
    the f32 residual-evaluation floor eps*(denom*max|p| + max|rhs|)."""
    from cfd_demo_jax.ops.fdm import _dct_basis, fdm_solve_interior
    _, lam = jax.jit(lambda: _dct_basis(8190, True))()
    assert float(lam[0]) > 0.0
    m, n = 2046, 2048
    dx = 30.0 / n
    yy, xx = np.meshgrid(np.linspace(0, 1, m, dtype=np.float32),
                         np.linspace(0, 1, m, dtype=np.float32),
                         indexing="ij")
    r_int = (np.sin(np.pi * xx) * np.cos(np.pi * yy) + 0.3
             ).astype(np.float32)
    e = jax.jit(lambda r: fdm_solve_interior(r, dx, dx, True, dx))(
        jnp.asarray(r_int))
    full = _apply_pprime_bcs(jnp.pad(e, 1))
    res = _mg_residual(full, jnp.asarray(np.pad(r_int, 1)), dx, dx)
    floor = np.finfo(np.float32).eps * (
        4.0 / dx / dx * float(jnp.max(jnp.abs(e)))
        + float(np.abs(r_int).max()))
    assert float(jnp.max(jnp.abs(res))) <= 12.0 * floor
    # (measured 5.9x after the fix; 2.375 absolute vs the old scheme's
    # smooth-mode failure at the same size)


def test_fdm_solver_vmap_and_grad():
    """FDM is a fixed-shape linear solve: it vmaps (ensemble) and
    differentiates (adjoint = the transposed eigenbasis apply, handled
    by AD) without special casing."""
    import dataclasses

    from cfd_demo_jax import make_step
    grid = Grid(nx=48, ny=32, lx=3.0, ly=2.0,
                obstacles=(Cylinder(1.0, 1.0, 0.3),))
    params = SimulationParams(dt=0.003, viscosity=1e-3,
                              pressure_solver=PressureSolver.FDM)
    opts = _opts(ramp_up_steps=2, outer_corrector_rounds=0,
                 early_exit=False, differentiable=True)
    scene = make_scene(grid, params, opts)
    step = make_step(scene, donate=False, jit=False)
    st0 = scene.init_state()

    def loss(log_nu):
        st = dataclasses.replace(st0, nu=jnp.exp(log_nu))
        for _ in range(3):
            st, _ = step(st)
        return jnp.sum(st.u[:, 1:-1] ** 2)

    g = jax.jit(jax.grad(loss))(jnp.log(jnp.float32(1e-3)))
    assert np.isfinite(float(g)) and float(g) != 0.0

    def one(inlet):
        st, _ = step(dataclasses.replace(st0, target_inlet=inlet))
        return st.u

    us = jax.jit(jax.vmap(one))(jnp.asarray([0.5, 1.0, 1.5], jnp.float32))
    assert np.isfinite(np.asarray(us)).all()


def test_legacy_scheme_still_selectable():
    """mgp_scheme='legacy' keeps the JS-kit vertex hierarchy available
    -- both schemes solve the same system to their exits."""
    ny, nx = 64, 64
    dx = dy = 1.0 / nx
    rng = np.random.default_rng(10)
    rhs = np.zeros((ny, nx), np.float32)
    rhs[1:-1, 1:-1] = rng.standard_normal((ny - 2, nx - 2))
    rhs = jnp.asarray(rhs)
    tol_r = 1e-2 * float(jnp.max(jnp.abs(rhs)))
    outs = {}
    for scheme in ("aligned", "legacy"):
        pp, err, _ = jax.jit(lambda p, r, s=scheme: multigrid_production(
            p, r, dx, dy, _opts(mgp_scheme=s, mgp_max_cycles=120),
            tol_r))(jnp.zeros((ny, nx), jnp.float32), rhs)
        assert float(err) <= tol_r, scheme
        outs[scheme] = np.asarray(pp)
    # Same linear system, same exit criterion: solutions agree to the
    # tolerance scale (gauge-fixed by the east Dirichlet column).
    np.testing.assert_allclose(outs["aligned"], outs["legacy"],
                               atol=5e-2 * float(np.abs(
                                   outs["aligned"]).max()) + 1e-5)


def test_noise_floor_exit_does_not_fire_mid_convergence():
    """With a reachable tolerance the solve must exit by tol, at the
    same cycle count and residual as with the floor disabled (the
    floor sits ~2 decades below any calibrated tolerance at this
    scale)."""
    ny, nx = 96, 128
    dx = dy = 1.0 / nx
    rng = np.random.default_rng(6)
    rhs = jnp.asarray(rng.standard_normal((ny, nx)), jnp.float32)
    pp0 = jnp.zeros((ny, nx), jnp.float32)
    tol_r = 1e-2 * float(jnp.max(jnp.abs(rhs)))
    _, err_a, n_a = jax.jit(lambda p, r: multigrid_production(
        p, r, dx, dy, _opts(), tol_r))(pp0, rhs)
    _, err_b, n_b = jax.jit(lambda p, r: multigrid_production(
        p, r, dx, dy, _opts(mgp_floor=0.0), tol_r))(pp0, rhs)
    assert int(n_a) == int(n_b)
    assert float(err_a) == float(err_b)
    assert float(err_a) <= tol_r


def test_aligned_high_aspect_grid_traces_and_solves():
    """Regression (round-2 review): on extreme-aspect grids the
    aligned hierarchy coarsened the short axis to width 0 while the
    max-side stop rule kept the long axis recursing, crashing the
    transfer stencils at trace time. The short axis now saturates at
    width 1 (identity transfers both ways) and the solve still
    converges to tolerance."""
    ny, nx = 512, 12  # interior 510 x 10; stop=8 forces deep recursion
    dx = dy = 1.0 / ny
    rng = np.random.default_rng(3)
    rhs = jnp.asarray(rng.standard_normal((ny, nx)), jnp.float32)
    tol_r = 1e-2 * float(jnp.max(jnp.abs(rhs)))
    opts = _opts(mgp_coarse_stop=8, mgp_scheme="aligned")
    pp, err, n = jax.jit(lambda p, r: multigrid_production(
        p, r, dx, dy, opts, tol_r))(jnp.zeros((ny, nx), jnp.float32), rhs)
    assert np.isfinite(np.asarray(pp)).all()
    assert float(err) <= tol_r
    r = _mg_residual(_apply_pprime_bcs(pp), rhs, dx, dy)
    assert float(jnp.max(jnp.abs(r))) <= tol_r * 1.0001


def test_fdm_basis_residues_no_int32_overflow():
    """Regression (round-2 review): the DCT basis residues were formed
    as (2i+1)(2k+1) % period with a raw int32 product, which wraps
    from m = 23171 and silently corrupts the eigenbasis. The
    limb-split mulmod must agree with exact integer arithmetic past
    the wrap point."""
    from cfd_demo_jax.ops.fdm import _mulmod_i32
    m = 30000
    period = 2 * (4 * m + 2)
    idx = np.array([0, 1, 12345, 23170, 23171, 29999], np.int64)
    a = 2 * idx + 1
    exact = ((a[:, None] * a[None, :]) % period).astype(np.int32)
    got = jax.jit(lambda x, y: _mulmod_i32(x, y, period))(
        jnp.asarray(a, jnp.int32)[:, None],
        jnp.asarray(a, jnp.int32)[None, :])
    np.testing.assert_array_equal(np.asarray(got), exact)


def test_fdm_width_one_axis_operator():
    """Regression (round-2 review): _t1d's end folds overwrote the
    diagonal instead of composing, so the m = 1 east-Dirichlet operator
    was (1 + h/d)/h^2 instead of (h/d)/h^2 -- the 'exact' FDM bottom of
    a saturated-axis hierarchy then removed only ~half the residual.
    The direct solve on (N, 1) and (1, N) levels must satisfy the SAME
    folded operator the aligned levels smooth (_cc_residual)."""
    from cfd_demo_jax.ops.fdm import _t1d, fdm_solve_interior
    from cfd_demo_jax.ops.poisson import _cc_residual
    # unit values of the composed folds
    h, d = 0.32, 0.9
    np.testing.assert_allclose(_t1d(1, h, True, d), [[(h / d) / h**2]])
    np.testing.assert_allclose(_t1d(1, h, False, 0.0), [[0.0]])
    rng = np.random.default_rng(17)
    for shape in ((8, 1), (1, 8)):
        r = jnp.asarray(rng.standard_normal(shape), jnp.float32)
        e = jax.jit(lambda rr: fdm_solve_interior(
            rr, 0.32, 0.4, True, 0.9))(r)
        res = _cc_residual(e, r, 0.32, 0.4, True, 0.9)
        floor = 64 * np.finfo(np.float32).eps * (
            (2 / 0.32**2 + 2 / 0.4**2) * float(jnp.max(jnp.abs(e)))
            + float(jnp.max(jnp.abs(r))))
        assert float(jnp.max(jnp.abs(res))) <= floor, shape


@pytest.mark.parametrize("east_dirichlet,d_wall", [
    (True, 0.25),    # closed-form Dirichlet basis (d == h)
    (False, 0.25),   # closed-form Neumann basis (cavity gauge)
    (True, 0.6),     # numpy-eigh constants (coarse-level fold)
])
def test_fdm_solve_runs_in_float64(east_dirichlet, d_wall):
    """The direct solve follows its operand's dtype: under x64 a float64
    rhs gets float64 bases and products, and the solution satisfies the
    folded operator to float64 round-off (the float64 reference runs of
    the solver rely on this)."""
    from cfd_demo_jax.ops.fdm import fdm_solve_interior
    from cfd_demo_jax.ops.poisson import _cc_residual
    rng = np.random.default_rng(5)
    r = rng.standard_normal((24, 40))
    if not east_dirichlet:
        r -= r.mean()                # the all-Neumann range
    with jax.enable_x64(True):
        e = jax.jit(lambda rr: fdm_solve_interior(
            rr, 0.25, 0.3, east_dirichlet, d_wall))(jnp.asarray(r))
        assert e.dtype == jnp.float64
        res = _cc_residual(e, jnp.asarray(r), 0.25, 0.3, east_dirichlet,
                           d_wall)
        assert float(jnp.max(jnp.abs(res))) < 1e-11


def test_cc_vcycle_saturated_axis_keeps_metric():
    """Regression (round-2 review): once an axis saturates at width 1
    (identity transfers), the recursion kept doubling its cell size and
    growing d_wall, weakening the folded wall coupling on every coarser
    level. One V-cycle on a saturated-axis hierarchy must contract the
    residual strongly (the coarse levels solve the SAME 1-D-in-x
    operator the fine level smooths)."""
    from cfd_demo_jax.ops.poisson import _cc_residual, _cc_vcycle
    rng = np.random.default_rng(23)
    rhs = jnp.asarray(rng.standard_normal((256, 1)), jnp.float32)
    dx = dy = 1.0 / 256.0
    opts = _opts(mgp_coarse_stop=8, mgp_scheme="aligned")
    e = jax.jit(lambda r: _cc_vcycle(r, dx, dy, opts, True, dx))(rhs)
    res = _cc_residual(e, rhs, dx, dy, True, dx)
    contraction = float(jnp.max(jnp.abs(res)) / jnp.max(jnp.abs(rhs)))
    assert contraction < 0.05, contraction
