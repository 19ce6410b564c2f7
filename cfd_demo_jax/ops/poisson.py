"""Pressure-correction solvers: damped Jacobi, red/black SOR, multigrid.

Jacobi is the reference's hottest loop (model.rs:733-824; 50 iterations
x full grid per corrector round). The formulation is a whole-array
sweep under lax.while_loop (exact early exit, model.rs:816-819) or
lax.scan with masked updates (identical fields, fixed cost,
vmap-friendly). The per-iteration boundary conditions on p'
(model.rs:807-815: Neumann bottom/top/left via row/col copies,
Dirichlet 0 at the outlet column) are row/column writes fused by XLA.

SOR (index.html:741-774) is re-designed as red/black Gauss-Seidel:
the JS in-place lexicographic sweep is inherently sequential; red/black
is its standard parallel form (documented deviation, docs/SPEC.md).
The JS ordering remains available exactly via ``sor_lexicographic``
(wavefront over anti-diagonals; SolverOptions.sor_ordering).

Multigrid (index.html:775-795, kit :1344-1470) is reproduced
structurally: V-cycle with 5 pre/post undamped-Jacobi smooths,
full-weighting restriction with boundary injection, bilinear
prolongation, direct-ish solve (10 smooths) at <=4 cells, 3 V-cycles.
The shape recursion unrolls at trace time (static shapes).
"""
from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .stencil import col_index, every_other, row_index, shifted
from .stencil import iota_masks as _iota_masks

try:  # internal but stable; the public alias is deprecation-gated
    from jax._src.interpreters.batching import BatchTracer as _BatchTracer
except ImportError:  # pragma: no cover - fall back to a name compare
    _BatchTracer = ()


def _apply_pprime_bcs(pp: jnp.ndarray) -> jnp.ndarray:
    """model.rs:807-815 / index.html:820-827: rows first, then columns
    (the corner values depend on this order). Channel flow: Neumann
    bottom/top/left, Dirichlet 0 at the outlet column."""
    ny, nx = pp.shape
    _, r, c = _iota_masks(pp.shape)
    pp = jnp.where(r == 0, shifted(pp, pp.shape, 1, 0), pp)       # bottom
    pp = jnp.where(r == ny - 1, shifted(pp, pp.shape, -1, 0), pp)  # top
    pp = jnp.where(c == 0, shifted(pp, pp.shape, 0, 1), pp)       # left
    pp = jnp.where(c == nx - 1, 0.0, pp)                          # outlet
    return pp


def _apply_pprime_bcs_cavity(pp: jnp.ndarray) -> jnp.ndarray:
    """All-Neumann pressure correction for closed (cavity) flow; the
    pure-Neumann Poisson system is singular so the bottom-left cell is
    pinned to 0 (standard gauge fix; new capability, see FlowCase)."""
    ny, nx = pp.shape
    _, r, c = _iota_masks(pp.shape)
    pp = jnp.where(r == 0, shifted(pp, pp.shape, 1, 0), pp)
    pp = jnp.where(r == ny - 1, shifted(pp, pp.shape, -1, 0), pp)
    pp = jnp.where(c == 0, shifted(pp, pp.shape, 0, 1), pp)
    pp = jnp.where(c == nx - 1, shifted(pp, pp.shape, 0, -1), pp)
    pp = jnp.where((r == 0) & (c == 0), 0.0, pp)
    return pp


def pprime_bc_fn(flow_case):
    from ..core.config import FlowCase
    return (_apply_pprime_bcs if flow_case == FlowCase.CHANNEL
            else _apply_pprime_bcs_cavity)


def _jacobi_sweep(pp, rhs, dx, dy, omega, bc=_apply_pprime_bcs):
    """One damped-Jacobi iteration incl. p' BCs; returns (pp, max_err)."""
    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 / dx2 + 2.0 / dy2
    interior, _, _ = _iota_masks(pp.shape)
    east = shifted(pp, pp.shape, 0, 1)
    west = shifted(pp, pp.shape, 0, -1)
    north = shifted(pp, pp.shape, 1, 0)
    south = shifted(pp, pp.shape, -1, 0)
    update = ((east + west) / dx2 + (north + south) / dy2 - rhs) / denom
    new_val = omega * update + (1.0 - omega) * pp
    err = jnp.max(jnp.where(interior, jnp.abs(new_val - pp), 0.0))
    pp = jnp.where(interior, new_val, pp)
    return bc(pp), err


def jacobi(pp0: jnp.ndarray, rhs: jnp.ndarray, dx: float, dy: float,
           omega: float, tol: float, iters: int,
           early_exit: bool = True,
           bc=_apply_pprime_bcs,
           fixed_trip: bool = False) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Returns (p_prime, max_error_of_last_sweep, iterations_run).

    Matches the reference's do-while structure: at least one sweep runs,
    and the loop exits after the first sweep whose max interior change
    is below ``tol`` (model.rs:748-819). ``fixed_trip`` (requires
    early_exit=False) runs the masked loop as a reverse-differentiable
    lax.scan (SolverOptions.differentiable).
    """
    sweep = partial(_jacobi_sweep, rhs=rhs, dx=dx, dy=dy, omega=omega, bc=bc)

    if early_exit:
        def cond(carry):
            _, err, it = carry
            return jnp.logical_or(it == 0,
                                  jnp.logical_and(it < iters, err >= tol))

        def body(carry):
            pp, _, it = carry
            pp, err = sweep(pp)
            return pp, err, it + 1

        pp, err, it = lax.while_loop(
            cond, body, (pp0, jnp.asarray(jnp.inf, pp0.dtype),
                         jnp.asarray(0, jnp.int32)))
        return pp, err, it

    pp, err, n = _masked_while(sweep, pp0, tol, iters,
                               fixed_trip=fixed_trip)
    return pp, err, n


def jacobi_fixed_adjoint(pp0, rhs, dx, dy, omega, iters, bc, forward):
    """Fixed-schedule (tol == 0) Jacobi solve whose VJP is the exact
    linear transpose of the solve map -- the fast-adjoint path of
    SolverOptions.differentiable.

    The fixed-schedule solve is a LINEAR map of (pp0, rhs):
    p_{k+1} = M p_k + N rhs with M the damped-sweep-and-BC operator
    and N the rhs injection, so p_K = M^K p0 + (sum_j M^j) N rhs and
    the reverse derivative needs NO stored iterates and NO
    differentiable forward. The backward pass runs the transposed
    recursion (pbar <- M^T pbar, rbar += N^T pbar; M^T and N^T via
    jax.linear_transpose of the SINGLE-sweep maps) -- O(1) activation
    memory vs the unrolled scan's O(iters) fields, and the forward may
    be ANY implementation of the same map, whose internals AD never
    touches.

    ``forward``: (pp0, rhs) -> (pp, err). Gradients through ``err``
    (the residual diagnostic, a nonlinear max) are defined as ZERO;
    callers must not route err back into the dynamics (solver/piso
    gates this path on configurations where res_p is diagnostic only).
    Returns (pp, err).
    """
    import jax as _jax

    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 / dx2 + 2.0 / dy2

    def m_op(p):
        """One sweep's p-dependence (rhs = 0), incl. interior select
        and BCs -- mirrors _jacobi_sweep exactly."""
        interior, _, _ = _iota_masks(p.shape)
        east = shifted(p, p.shape, 0, 1)
        west = shifted(p, p.shape, 0, -1)
        north = shifted(p, p.shape, 1, 0)
        south = shifted(p, p.shape, -1, 0)
        update = ((east + west) / dx2 + (north + south) / dy2) / denom
        new_val = omega * update + (1.0 - omega) * p
        return bc(jnp.where(interior, new_val, p))

    def n_op(r):
        """One sweep's rhs-dependence (p = 0)."""
        interior, _, _ = _iota_masks(r.shape)
        return bc(jnp.where(interior, -(omega / denom) * r,
                            jnp.zeros_like(r)))

    @_jax.custom_vjp
    def solve(p0, r):
        return forward(p0, r)

    def fwd(p0, r):
        return solve(p0, r), None  # linear map: no residuals to save

    def bwd(_, ct):
        ct_p = ct[0]
        spec = _jax.ShapeDtypeStruct(ct_p.shape, ct_p.dtype)
        mt = _jax.linear_transpose(m_op, spec)
        nt = _jax.linear_transpose(n_op, spec)

        def body(carry, _):
            pbar, rbar = carry
            rbar = rbar + nt(pbar)[0]
            pbar = mt(pbar)[0]
            return (pbar, rbar), None

        (p0_bar, r_bar), _ = lax.scan(
            body, (ct_p, jnp.zeros_like(ct_p)), None,
            length=max(1, iters))
        return p0_bar, r_bar

    solve.defvjp(fwd, bwd)
    return solve(pp0, rhs)


def fixed_linear_adjoint(iter_fn, iters, forward, pp0, rhs, pre=None):
    """Generic fast adjoint for ANY fixed-schedule solve built by
    iterating a jointly-LINEAR map ``iter_fn(p, r)`` ``iters`` times
    (optionally after a linear ``pre`` applied to pp0) -- the round-3
    generalization of :func:`jacobi_fixed_adjoint` to red/black SOR
    sweeps and fixed-cycle MGP V-cycles, which are
    linear in (p'0, rhs) exactly like the fixed Jacobi schedule.

    p_K = T^K p_in + (sum_j T^j) N rhs with T p = iter_fn(p, 0) and
    N r = iter_fn(0, r), so the reverse derivative is the transposed
    recursion (pbar <- T^T pbar, rbar += N^T pbar via
    jax.linear_transpose of the single-iteration maps): O(1) activation
    memory, and ``forward`` may be ANY implementation of the same map,
    whose internals AD never touches.

    ``forward``: (pp0, rhs) -> (pp, err). Gradients through ``err``
    (a nonlinear max diagnostic) are defined as ZERO, like
    jacobi_fixed_adjoint. Returns (pp, err).
    """
    import jax as _jax

    def m_op(p):
        return iter_fn(p, jnp.zeros_like(p))

    def n_op(r):
        return iter_fn(jnp.zeros_like(r), r)

    @_jax.custom_vjp
    def solve(p0, r):
        return forward(p0, r)

    def fwd(p0, r):
        return solve(p0, r), None  # linear map: no residuals to save

    def bwd(_, ct):
        ct_p = ct[0]
        spec = _jax.ShapeDtypeStruct(ct_p.shape, ct_p.dtype)
        mt = _jax.linear_transpose(m_op, spec)
        nt = _jax.linear_transpose(n_op, spec)

        def body(carry, _):
            pbar, rbar = carry
            rbar = rbar + nt(pbar)[0]
            pbar = mt(pbar)[0]
            return (pbar, rbar), None

        (p0_bar, r_bar), _ = lax.scan(
            body, (ct_p, jnp.zeros_like(ct_p)), None,
            length=max(1, iters))
        if pre is not None:
            p0_bar = _jax.linear_transpose(pre, spec)(p0_bar)[0]
        return p0_bar, r_bar

    solve.defvjp(fwd, bwd)
    return solve(pp0, rhs)


def _exact_while(sweep, pp0, tol, iters, dynamic_tol=False):
    """Exact do-while twin of :func:`_masked_while` for UNBATCHED
    solves: identical fields and trip counts (the masked loop's
    done-freeze is a no-op when the loop can simply stop), but no
    per-iteration full-array freeze selects -- at 8192^2 those selects
    are real HBM passes. Callers must not use this under vmap (the
    lifted while_loop would re-apply the body to converged batch
    elements)."""
    def body(carry):
        pp, _, _, it = carry
        if dynamic_tol:
            pp, err, tol2 = sweep(pp)
            tol_eff = jnp.maximum(jnp.asarray(tol, err.dtype), tol2)
        else:
            pp, err = sweep(pp)
            tol_eff = jnp.asarray(tol, jnp.result_type(pp))
        return pp, err, tol_eff, it + 1

    def cond(carry):
        _, err, tol_eff, it = carry
        return jnp.logical_or(
            it == 0, jnp.logical_and(it < iters, err >= tol_eff))

    f32 = pp0.dtype
    pp, err, _, n = lax.while_loop(
        cond, body, (pp0, jnp.asarray(jnp.inf, f32),
                     jnp.asarray(0.0, f32), jnp.asarray(0, jnp.int32)))
    return pp, err, n


def _masked_while(sweep, pp0, tol, iters, dynamic_tol=False,
                  fixed_trip=False):
    """Masked-update convergence loop.

    Semantically identical to exact early exit, but the per-element
    freezing lives in the *body* (where selects on a `done` flag), so
    under vmap -- where JAX lifts a while_loop condition to any() and
    re-applies the body to every element -- each batch element still
    stops updating exactly when its own residual crosses tol, and the
    whole batch exits once all are done (the 64-scene ensemble relies
    on this).

    ``dynamic_tol``: sweep returns (pp, err, tol_extra) and the exit
    threshold becomes max(tol, tol_extra), re-evaluated each sweep --
    used by MG_PRODUCTION's f32-noise-floor exit, whose floor depends
    on the current solution scale (opts.mgp_floor).

    ``fixed_trip``: run the SAME masked body under a length-``iters``
    lax.scan instead of the while_loop -- fields/err/n are identical
    (converged elements stay frozen by the `done` selects; the loop
    just cannot stop early), but the scan is reverse-mode
    differentiable where lax.while_loop is not
    (SolverOptions.differentiable).
    """
    def body_core(carry):
        pp, err, done, n, it = carry
        if dynamic_tol:
            pp2, err2, tol2 = sweep(pp)
            tol_eff = jnp.maximum(jnp.asarray(tol, err2.dtype), tol2)
        else:
            pp2, err2 = sweep(pp)
            tol_eff = tol
        pp = jnp.where(done, pp, pp2)
        err = jnp.where(done, err, err2)
        n = n + jnp.where(done, 0, 1).astype(jnp.int32)
        done = jnp.logical_or(done, err < tol_eff)
        return pp, err, done, n, it + 1

    carry0 = (pp0, jnp.asarray(jnp.inf, pp0.dtype), jnp.asarray(False),
              jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32))

    if fixed_trip:
        # length max(1, iters): the while_loop's do-while cond (it == 0
        # or ...) always runs the first sweep even at iters == 0 --
        # the scan must too for "fields identical" to hold.
        (pp, err, _, n, _), _ = lax.scan(
            lambda c, _: (body_core(c), None), carry0, None,
            length=max(1, iters))
        return pp, err, n

    def cond(carry):
        _, _, done, _, it = carry
        return jnp.logical_or(it == 0,
                              jnp.logical_and(it < iters,
                                              jnp.logical_not(done)))

    pp, err, _, n, _ = lax.while_loop(cond, body_core, carry0)
    return pp, err, n


# ---------------------------------------------------------------------------
# Red/black SOR
# ---------------------------------------------------------------------------

def _sor_sweep(pp, rhs, dx, dy, omega, red_mask, black_mask,
               bc=_apply_pprime_bcs):
    """One red/black SOR iteration incl. p' BCs; returns (pp, max_err)."""
    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 / dx2 + 2.0 / dy2
    interior, _, _ = _iota_masks(pp.shape)
    old = pp

    def half(pp, mask):
        east = shifted(pp, pp.shape, 0, 1)
        west = shifted(pp, pp.shape, 0, -1)
        north = shifted(pp, pp.shape, 1, 0)
        south = shifted(pp, pp.shape, -1, 0)
        update = ((east + west) / dx2 + (north + south) / dy2 - rhs) / denom
        new_val = (1.0 - omega) * pp + omega * update
        return jnp.where(interior & mask, new_val, pp)

    pp = half(pp, red_mask)
    pp = half(pp, black_mask)
    err = jnp.max(jnp.where(interior, jnp.abs(pp - old), 0.0))
    return bc(pp), err


def _sweep_loop(sweep, pp0, tol, iters, early_exit, fixed_trip):
    """Shared convergence scaffolding: exact do-while early exit, or
    the masked loop (vmap-exact per element) when early_exit=False."""
    if early_exit:
        def cond(carry):
            _, err, it = carry
            return jnp.logical_or(it == 0,
                                  jnp.logical_and(it < iters, err >= tol))

        def body(carry):
            pp, _, it = carry
            pp, err = sweep(pp)
            return pp, err, it + 1

        return lax.while_loop(
            cond, body, (pp0, jnp.asarray(jnp.inf, pp0.dtype),
                         jnp.asarray(0, jnp.int32)))

    return _masked_while(sweep, pp0, tol, iters, fixed_trip=fixed_trip)


def sor(pp0: jnp.ndarray, rhs: jnp.ndarray, dx: float, dy: float,
        omega: float, tol: float, iters: int,
        early_exit: bool = True,
        bc=_apply_pprime_bcs,
        fixed_trip: bool = False) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Red/black SOR (parallel form of index.html:741-774)."""
    _, r, c = _iota_masks(pp0.shape)
    red = (r + c) % 2 == 0
    black = (r + c) % 2 == 1
    sweep = partial(_sor_sweep, rhs=rhs, dx=dx, dy=dy, omega=omega,
                    red_mask=red, black_mask=black, bc=bc)
    return _sweep_loop(sweep, pp0, tol, iters, early_exit, fixed_trip)


def _sor_sweep_lex(pp, rhs, dx, dy, omega, bc=_apply_pprime_bcs):
    """One JS-exact lexicographic SOR sweep (index.html:747-773) as a
    wavefront over anti-diagonals.

    The JS sweep mutates p' in row-major order, so cell (j, i) reads
    already-updated west (j, i-1) and south (j-1, i) neighbors and
    not-yet-updated east/north ones. Both updated neighbors of a cell
    on anti-diagonal d = i + j lie on diagonal d-1 and both stale ones
    on d+1, so processing whole diagonals in increasing d reproduces
    the sequential sweep's dependency structure EXACTLY: each cell
    evaluates the reference's f32 expression over the same operand
    values, and the in-sweep running max|new - old| is an
    order-independent reduction. Agreement with the scalar oracle is
    therefore ulp-level per sweep (~2 ulp/sweep measured; compiler
    fma/contraction choices are the only difference -- the ordering
    deviation itself, the thing docs/SPEC.md item 4 bounds at ~1e-1
    relative per 50-iteration solve, is gone).

    Cost: (nx + ny - 3) masked whole-array updates per sweep -- the
    price of sequential-dependency-exactness. This is a parity mode
    for JS-scale scenes, not a performance path (docs/SPEC.md item 4;
    red/black remains the production ordering).
    """
    F = np.float32
    dx2 = F(dx) * F(dx)
    dy2 = F(dy) * F(dy)
    denom = F(2.0) / dx2 + F(2.0) / dy2
    om = F(omega)
    one_m = F(1.0) - om
    interior, r, c = _iota_masks(pp.shape)
    diag = r + c
    ny, nx = pp.shape
    old = pp

    def body(d, pp):
        east = shifted(pp, pp.shape, 0, 1)
        west = shifted(pp, pp.shape, 0, -1)
        north = shifted(pp, pp.shape, 1, 0)
        south = shifted(pp, pp.shape, -1, 0)
        upd = ((east + west) / dx2 + (north + south) / dy2 - rhs) / denom
        new_val = one_m * pp + om * upd
        return jnp.where(interior & (diag == d), new_val, pp)

    # Interior diagonals span d = 2 .. (ny-2)+(nx-2).
    pp = lax.fori_loop(2, (ny - 2) + (nx - 2) + 1, body, pp)
    err = jnp.max(jnp.where(interior, jnp.abs(pp - old), 0.0))
    return bc(pp), err


def sor_lexicographic(pp0: jnp.ndarray, rhs: jnp.ndarray, dx: float,
                      dy: float, omega: float, tol: float, iters: int,
                      early_exit: bool = True,
                      bc=_apply_pprime_bcs,
                      fixed_trip: bool = False) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """JS-ordering-exact SOR (index.html:741-774) via the wavefront
    sweep above: closes docs/SPEC.md deviation 4 on demand
    (SolverOptions.sor_ordering='lexicographic') instead of only
    bounding it. Matches oracle NumpyModel._sor_lexicographic to a
    few ulps per sweep (tests/test_sor_ordering.py)."""
    sweep = partial(_sor_sweep_lex, rhs=rhs, dx=dx, dy=dy, omega=omega,
                    bc=bc)
    return _sweep_loop(sweep, pp0, tol, iters, early_exit, fixed_trip)


# ---------------------------------------------------------------------------
# Multigrid V-cycle (JS kit, index.html:1344-1470)
# ---------------------------------------------------------------------------

def _mg_smooth(p, rhs, dx, dy, iterations: int):
    """Undamped Jacobi on the interior, no BCs (index.html:1347-1369)."""
    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 / dx2 + 2.0 / dy2
    interior, _, _ = _iota_masks(p.shape)

    # Unrolled python loop: iteration counts are small static ints
    # (5/10), and a lax.scan pays measurable per-trip loop overhead at
    # every one of the V-cycle's ~10 levels.
    for _ in range(iterations):
        update = ((shifted(p, p.shape, 0, 1) + shifted(p, p.shape, 0, -1)) / dx2
                  + (shifted(p, p.shape, 1, 0) + shifted(p, p.shape, -1, 0)) / dy2
                  - rhs) / denom
        p = jnp.where(interior, update, p)
    return p


def _mg_residual(p, rhs, dx, dy):
    """r = rhs - A p on the interior, 0 on the boundary
    (index.html:1430-1441)."""
    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 / dx2 + 2.0 / dy2
    interior, _, _ = _iota_masks(p.shape)
    ap = ((shifted(p, p.shape, 0, 1) + shifted(p, p.shape, 0, -1)) / dx2
          + (shifted(p, p.shape, 1, 0) + shifted(p, p.shape, -1, 0)) / dy2
          - denom * p)
    return jnp.where(interior, rhs - ap, 0.0)


def _mg_restrict(fine: jnp.ndarray, nx_c: int, ny_c: int) -> jnp.ndarray:
    """Full-weighting on the interior, injection on the boundary
    (index.html:1372-1395).

    Formulated with shifted views, stride-2 slices and iota selects --
    no gathers or .at[] scatters -- so it partitions correctly under
    row sharding (like everything else in this module).
    """
    ny_f, nx_f = fine.shape
    sh = lambda dj, di: shifted(fine, fine.shape, dj, di)
    w9 = (fine
          + 0.5 * (sh(0, 1) + sh(0, -1) + sh(1, 0) + sh(-1, 0))
          + 0.25 * (sh(1, 1) + sh(1, -1) + sh(-1, 1) + sh(-1, -1))) / 4.0
    core = every_other(every_other(w9, 0), 1)[:ny_c, :nx_c]
    # Boundary injection (flat-index quirks of the JS resolved to the
    # same-row/col samples; see docs/SPEC.md). 2*(n_c-1) <= n_f-1
    # always, so the stride-2 subsamples need no clamping.
    bot_row = every_other(fine[0:1], 1)[:, :nx_c]
    top_row = every_other(fine[ny_f - 1:ny_f], 1)[:, :nx_c]
    left_col = every_other(fine[:, 0:1], 0)[:ny_c, :]
    right_col = every_other(fine[:, nx_f - 1:nx_f], 0)[:ny_c, :]
    _, r, c = _iota_masks((ny_c, nx_c))
    out = core
    out = jnp.where(r == 0, bot_row, out)
    out = jnp.where(r == ny_c - 1, top_row, out)
    out = jnp.where(c == 0, left_col, out)       # columns last: corners
    out = jnp.where(c == nx_c - 1, right_col, out)  # take column values
    return out


def _mg_prolong(coarse: jnp.ndarray, nx_f: int, ny_f: int) -> jnp.ndarray:
    """Bilinear prolongation (index.html:1398-1421), via repeats and
    clamped shifts (gather-free, shard-safe)."""
    ny_c, nx_c = coarse.shape
    # x: fine col i interpolates coarse cols i//2 and min(i//2+1, last).
    right = shifted(coarse, coarse.shape, 0, 1)
    right = jnp.where(col_index(coarse.shape) == nx_c - 1, coarse, right)
    rep = jnp.repeat(coarse, 2, axis=1)[:, :nx_f]
    rep_r = jnp.repeat(right, 2, axis=1)[:, :nx_f]
    a = (lax.broadcasted_iota(jnp.int32, (ny_c, nx_f), 1) % 2
         ).astype(coarse.dtype) * 0.5
    row = rep * (1 - a) + rep_r * a
    # y: same along rows.
    down = shifted(row, row.shape, 1, 0)
    down = jnp.where(row_index(row.shape) == ny_c - 1, row, down)
    rep_y = jnp.repeat(row, 2, axis=0)[:ny_f, :]
    rep_d = jnp.repeat(down, 2, axis=0)[:ny_f, :]
    b = (lax.broadcasted_iota(jnp.int32, (ny_f, nx_f), 0) % 2
         ).astype(coarse.dtype) * 0.5
    return rep_y * (1 - b) + rep_d * b


def _mg_vcycle(p, rhs, dx, dy, opts):
    ny, nx = p.shape
    p = _mg_smooth(p, rhs, dx, dy, opts.mg_pre_smooth)
    if nx <= opts.mg_coarsest or ny <= opts.mg_coarsest:
        return _mg_smooth(p, rhs, dx, dy, opts.mg_coarse_smooth)
    r = _mg_residual(p, rhs, dx, dy)
    nx_c, ny_c = (nx + 1) // 2, (ny + 1) // 2
    r_c = _mg_restrict(r, nx_c, ny_c)
    e_c = _mg_vcycle(jnp.zeros_like(r_c), r_c, 2 * dx, 2 * dy, opts)
    p = p + _mg_prolong(e_c, nx, ny)
    return _mg_smooth(p, rhs, dx, dy, opts.mg_post_smooth)


# ---------------------------------------------------------------------------
# Production projection (addition beyond the reference, docs/SPEC.md
# item 12): BC-aware multigrid with a divergence-calibrated exit.
# ---------------------------------------------------------------------------

def _mgp_smooth(p, rhs, dx, dy, omega, iterations, bc):
    """Damped-Jacobi smoothing with the reference p' BCs re-applied
    every sweep (_jacobi_sweep) -- unlike the parity kit's interior-
    only undamped sweeps, this smooths the operator the projection
    actually needs, so coarse corrections are not polluted by
    boundary-inconsistent fine values."""
    for _ in range(iterations):
        p, _ = _jacobi_sweep(p, rhs, dx, dy, omega, bc=bc)
    return p


def _mgp_vcycle(p, rhs, dx, dy, opts, bc):
    """One BC-aware V-cycle. The correction e on every coarse level
    satisfies the same homogeneous BC types as p' (Neumann copies /
    Dirichlet-0 outlet / cavity gauge pin), so the SAME bc function
    applies at every level; restriction/prolongation reuse the parity
    kit's shard-safe stencils."""
    ny, nx = p.shape
    omega, nu = opts.jacobi_omega, opts.mgp_smooth
    p = _mgp_smooth(p, rhs, dx, dy, omega, nu, bc)
    if nx <= opts.mg_coarsest or ny <= opts.mg_coarsest:
        return _mgp_smooth(p, rhs, dx, dy, omega,
                           opts.mg_coarse_smooth, bc)
    r = _mg_residual(p, rhs, dx, dy)
    nx_c, ny_c = (nx + 1) // 2, (ny + 1) // 2
    r_c = _mg_restrict(r, nx_c, ny_c)
    e_c = _mgp_vcycle(jnp.zeros_like(r_c), r_c, 2 * dx, 2 * dy, opts, bc)
    p = bc(p + _mg_prolong(e_c, nx, ny))
    return _mgp_smooth(p, rhs, dx, dy, omega, opts.mgp_smooth, bc)


# --- aligned cell-centered hierarchy (opts.mgp_scheme == "aligned") ----
#
# Round-2 finding: the JS-kit vertex transfers ((n+1)//2 coarsening,
# index.html:1372-1421) misalign the top/right boundary on EVEN grid
# sizes -- the coarse boundary point lands at fine index n-2, one cell
# inside the domain, so the coarse correction is pinned to zero at an
# interior point and V-cycle contraction stalls at ~0.76 (dense
# two-grid analysis + measurements in PERF.md). Every production
# scene is even-sized. The aligned hierarchy replaces the coarse
# levels only:
#
#   * unknowns = interior cells; boundary slaving is FOLDED into the
#     stencil (Neumann mirror: diag reduced; outlet: 0-valued ghost).
#     On bc-consistent states the folded fine sweep is identical to
#     _jacobi_sweep + bc, so the finest level keeps the existing
#     full-array smoothers.
#   * cell-centered 2x2-average restriction / bilinear prolongation;
#     odd dims mirror-pad on the west/south (Neumann) sides so no fake
#     domain is ever inserted between the unknowns and the outlet wall.
#   * the outlet fold is distance-aware per level (symmetric FV flux
#     form, diag (1 + h/d)/h^2 with d the tracked center-to-wall
#     distance: d_0 = h, d_{l+1} = d_l + h_l/2).
#   * levels at or below mgp_coarse_stop solve EXACTLY by fast
#     diagonalization (ops.fdm: two small dense matmuls per side),
#     truncating the latency-bound deep levels.
#
# Measured contraction ~0.10-0.15/cycle down to the f32 noise floor
# (vs 0.76 stalled), i.e. 2-3 warm-started cycles per projection.


def _cc_neighbors(p, east_dirichlet):
    """Folded neighbor reads on an interior-unknown array: Neumann
    edges mirror (ghost = self), the outlet east edge reads the
    0-valued Dirichlet ghost (shifted's zero fill)."""
    ny, nx = p.shape
    _, r, c = _iota_masks(p.shape)
    e = shifted(p, p.shape, 0, 1)
    if not east_dirichlet:
        e = jnp.where(c == nx - 1, p, e)
    w = shifted(p, p.shape, 0, -1)
    w = jnp.where(c == 0, p, w)
    n = shifted(p, p.shape, 1, 0)
    n = jnp.where(r == ny - 1, p, n)
    s = shifted(p, p.shape, -1, 0)
    s = jnp.where(r == 0, p, s)
    return e, w, n, s


def _cc_diag(shape, dx, dy, east_dirichlet, d_wall):
    """Per-cell diagonal of -A. Uniform 2/dx^2 + 2/dy^2 except the
    outlet column when the wall sits at d != dx from the last center
    (coarse levels): symmetric FV fold (1 + dx/d)/dx^2 there."""
    denom = 2.0 / (dx * dx) + 2.0 / (dy * dy)
    if not east_dirichlet or d_wall == dx:
        return denom
    _, _, c = _iota_masks(shape)
    extra = (dx / d_wall - 1.0) / (dx * dx)
    return jnp.where(c == shape[1] - 1, denom + extra, denom)


def _cc_residual(p, rhs, dx, dy, east_dirichlet, d_wall):
    dx2, dy2 = dx * dx, dy * dy
    e, w, n, s = _cc_neighbors(p, east_dirichlet)
    dg = _cc_diag(p.shape, dx, dy, east_dirichlet, d_wall)
    return rhs - ((e + w) / dx2 + (n + s) / dy2 - dg * p)


def _cc_sweeps(p, rhs, dx, dy, omega, iters, east_dirichlet, d_wall):
    """Damped-Jacobi sweeps on the folded operator (== _jacobi_sweep +
    bc on bc-consistent full arrays when d_wall == dx)."""
    dx2, dy2 = dx * dx, dy * dy
    dg = _cc_diag(p.shape, dx, dy, east_dirichlet, d_wall)
    for _ in range(iters):
        e, w, n, s = _cc_neighbors(p, east_dirichlet)
        upd = ((e + w) / dx2 + (n + s) / dy2 - rhs) / dg
        p = (1.0 - omega) * p + omega * upd
    return p


def _cc_coarse_size(m: int) -> int:
    """Coarse cell count along one axis. Even m halves exactly; odd m
    picks whichever of (m+1)/2 (mirror-pad a ghost on the west/south
    Neumann side) and (m-1)/2 (first coarse cell aggregates THREE fine
    children) is EVEN -- they are consecutive integers, so one always
    is. This keeps every odd-size treatment isolated between even
    levels: chains like 129 -> 65 -> 33 (pad at every level, fake
    domain compounding geometrically, measured rho -> 0.5-0.8) or
    255 -> 127 -> 63 (aggregate at every level, rho -> 0.5) cannot
    occur; the dense multilevel model measures rho <= 0.27 for every
    size with this rule (PERF.md).

    m == 1 saturates at 1 (restrict/prolong degenerate to the identity
    along that axis): on extreme-aspect grids (min side > the direct-
    FDM route of _mgp_aligned_correction but << max side) the short
    axis bottoms out while the max-side stop rule keeps the long axis
    recursing -- returning 0 here would collapse the axis and crash
    the transfer stencils at trace time."""
    if m <= 1:
        return max(m, 1)
    if m % 2 == 0:
        return m // 2
    return (m + 1) // 2 if ((m + 1) // 2) % 2 == 0 else m // 2


def _pair_lanes(f):
    """(f[:, 0::2], f[:, 1::2]) via the pair reshape; values are
    identical element-for-element to the strided column slices."""
    p = f.reshape(f.shape[0], f.shape[1] // 2, 2)
    return p[:, :, 0], p[:, :, 1]


def _cc_restrict_x(f):
    """Cell-centered averaging restriction along x with the odd-size
    rule of _cc_coarse_size. Column-local (shared bitwise with the
    row-sharded tier, shard.mg_shmap)."""
    nx = f.shape[1]
    if nx % 2 == 0:
        a, b = _pair_lanes(f)
        return 0.5 * (a + b)
    if _cc_coarse_size(nx) == (nx + 1) // 2:  # mirror-pad west
        a, b = _pair_lanes(jnp.concatenate([f[:, :1], f], axis=1))
        return 0.5 * (a + b)
    a, b = _pair_lanes(f[:, 1:])               # aggregate west
    t = 0.5 * (a + b)
    first = (f[:, :1] + f[:, 1:2] + f[:, 2:3]) / 3.0
    return jnp.where(col_index(t.shape) == 0, first, t)


def _cc_restrict_y(f):
    """As _cc_restrict_x, along y."""
    ny = f.shape[0]
    pair_sum = lambda g: 0.5 * (every_other(g, 0) + every_other(g, 0, 1))
    if ny % 2 == 0:
        return pair_sum(f)
    if _cc_coarse_size(ny) == (ny + 1) // 2:   # mirror-pad south
        return pair_sum(jnp.concatenate([f[:1, :], f], axis=0))
    t = pair_sum(f[1:, :])                     # aggregate south
    first = (f[:1, :] + f[1:2, :] + f[2:3, :]) / 3.0
    return jnp.where(row_index(t.shape) == 0, first, t)


def _cc_restrict(fine):
    """Cell-centered averaging restriction, one axis at a time, with
    the per-axis odd-size rule of _cc_coarse_size."""
    return _cc_restrict_y(_cc_restrict_x(fine))


def _cc_prolong_x(coarse, nx_f, east_dirichlet):
    """The x pass of _cc_prolong: interpolate coarse columns to nx_f
    fine columns at COARSE rows."""
    ny_c, nx_c = coarse.shape
    _, r, c = _iota_masks(coarse.shape)
    left = jnp.where(c == 0, coarse, shifted(coarse, coarse.shape, 0, -1))
    rightn = shifted(coarse, coarse.shape, 0, 1)
    if not east_dirichlet:
        rightn = jnp.where(c == nx_c - 1, coarse, rightn)
    # (east_dirichlet: shifted's zero fill IS the 0 ghost)
    if nx_f == nx_c:  # saturated axis (width 1): identity, pairing
        row = coarse  # _cc_restrict_x's mirror-pad identity at m == 1
    elif nx_f == 2 * nx_c + 1:  # aggregate west: first coarse = 3 fine
        lw = jnp.where(c == 1, 0.8 * coarse + 0.2 * left,
                       0.75 * coarse + 0.25 * left)
        rw = 0.75 * coarse + 0.25 * rightn
        pairs = jnp.stack([lw[:, 1:], rw[:, 1:]], axis=2)
        pairs = pairs.reshape(ny_c, 2 * (nx_c - 1))
        head = jnp.concatenate(
            [coarse[:, :1], coarse[:, :1],
             0.6 * coarse[:, :1] + 0.4 * coarse[:, 1:2]], axis=1)
        row = jnp.concatenate([head, pairs], axis=1)
    else:  # even (nx_f == 2 nx_c) or mirror-pad west (nx_f == 2 nx_c - 1)
        even = 0.75 * coarse + 0.25 * left
        odd = 0.75 * coarse + 0.25 * rightn
        row = jnp.stack([even, odd], axis=2).reshape(ny_c, 2 * nx_c)
        row = lax.slice(row, (0, 2 * nx_c - nx_f), (ny_c, 2 * nx_c))
    return row


def _cc_prolong(coarse, ny_f, nx_f, east_dirichlet):
    """Cell-centered bilinear prolongation (linear interpolation in
    cell-center coordinates), per-axis inverse of _cc_restrict's
    even / mirror-pad / aggregate cases. Neumann edges clamp
    (zero-slope error), the outlet edge interpolates toward the
    0-valued ghost; west/south mirror-pad columns/rows are cut; an
    aggregated first coarse cell expands to THREE fine cells with
    center-coordinate weights (c0, c0, 0.6 c0 + 0.4 c1; the next left
    child leans 0.8/0.2)."""
    ny_c, nx_c = coarse.shape
    row = _cc_prolong_x(coarse, nx_f, east_dirichlet)
    if ny_f == ny_c:  # saturated axis (height 1): identity
        return row
    rr = row_index(row.shape)
    dnv = jnp.where(rr == 0, row, shifted(row, row.shape, -1, 0))
    upv = jnp.where(rr == ny_c - 1, row, shifted(row, row.shape, 1, 0))
    if ny_f == 2 * ny_c + 1:  # aggregate south
        lw = jnp.where(rr == 1, 0.8 * row + 0.2 * dnv,
                       0.75 * row + 0.25 * dnv)
        uw = 0.75 * row + 0.25 * upv
        pairs = jnp.stack([lw[1:, :], uw[1:, :]], axis=1)
        pairs = pairs.reshape(2 * (ny_c - 1), row.shape[1])
        head = jnp.concatenate(
            [row[:1, :], row[:1, :],
             0.6 * row[:1, :] + 0.4 * row[1:2, :]], axis=0)
        return jnp.concatenate([head, pairs], axis=0)
    evr = 0.75 * row + 0.25 * dnv
    odr = 0.75 * row + 0.25 * upv
    out = jnp.stack([evr, odr], axis=1).reshape(2 * ny_c, row.shape[1])
    return lax.slice(out, (2 * ny_c - ny_f, 0), (2 * ny_c, row.shape[1]))


def _cc_vcycle(rhs, dx, dy, opts, east_dirichlet, d_wall):
    """Solve A e = rhs from a zero guess at one coarse level;
    recursion unrolls at trace time (static shapes). The FDM stop
    tests the MAX side: the d != h bottom ships numpy-eigh eigenbases
    as O(m^2) jit constants, so an anisotropic chain (which preserves
    aspect ratio) must keep recursing until BOTH sides are small --
    a min-side rule would bake e.g. a 1024^2 constant at the 64x1024
    level of an 8192x512 grid into the compiled program."""
    ny, nx = rhs.shape
    if max(ny, nx) <= opts.mgp_coarse_stop:
        from .fdm import fdm_solve_interior
        return fdm_solve_interior(rhs, dx, dy, east_dirichlet, d_wall)
    omega, nu = opts.jacobi_omega, opts.mgp_smooth
    p = _cc_sweeps(jnp.zeros_like(rhs), rhs, dx, dy, omega, nu,
                   east_dirichlet, d_wall)
    r = _cc_residual(p, rhs, dx, dy, east_dirichlet, d_wall)
    # A saturated axis (width 1: identity transfers, cell centers
    # unchanged) must keep its OWN metric on the coarse level --
    # doubling h / growing d_wall there would weaken the folded wall
    # coupling 2-4x per level while the geometry it describes has not
    # moved (round-2 review).
    x_sat = _cc_coarse_size(nx) == nx
    y_sat = _cc_coarse_size(ny) == ny
    e_c = _cc_vcycle(_cc_restrict(r),
                     dx if x_sat else 2 * dx,
                     dy if y_sat else 2 * dy, opts,
                     east_dirichlet,
                     d_wall if x_sat else d_wall + dx / 2)
    p = p + _cc_prolong(e_c, ny, nx, east_dirichlet)
    return _cc_sweeps(p, rhs, dx, dy, omega, nu, east_dirichlet, d_wall)


def _cc_correction_from_coarse(r_c, ny_int, nx_int, dx, dy, opts,
                               east_dirichlet):
    """Interior-size correction from the FIRST-coarse-level residual
    r_c == _cc_restrict(r_interior). Split out so the row-sharded tier
    (shard.mg_shmap) can restrict in sharded form, all-gather only the
    4x-smaller coarse level, and run this stage replicated -- computing
    the bit-identical correction the single-device cycle computes."""
    e_c = _cc_vcycle(r_c, 2 * dx, 2 * dy, opts, east_dirichlet, 1.5 * dx)
    return _cc_prolong(e_c, ny_int, nx_int, east_dirichlet)


def _mgp_aligned_correction(r_full, dx, dy, opts, east_dirichlet):
    """Full-size correction (zero boundary ring) from a FULL residual
    array (_mg_residual layout: zero ring)."""
    ny, nx = r_full.shape
    r_int = lax.slice(r_full, (1, 1), (ny - 1, nx - 1))
    if min(ny - 2, nx - 2) <= opts.mgp_coarse_stop:
        from .fdm import fdm_solve_interior
        e_int = fdm_solve_interior(r_int, dx, dy, east_dirichlet, dx)
    else:
        e_int = _cc_correction_from_coarse(
            _cc_restrict(r_int), ny - 2, nx - 2, dx, dy, opts,
            east_dirichlet)
    return jnp.pad(e_int, 1)


def _mgp_smooth_res(p, rhs, dx, dy, omega, iterations, bc):
    """(p, r, max|r|) after ``iterations`` damped BC'd sweeps: the
    aligned cycle needs the residual after BOTH smoothing positions
    (restrict input; exit metric)."""
    p = _mgp_smooth(p, rhs, dx, dy, omega, iterations, bc)
    r = _mg_residual(p, rhs, dx, dy)
    return p, r, jnp.max(jnp.abs(r))


def _mgp_vcycle_aligned(p, rhs, dx, dy, opts, bc):
    """One aligned V-cycle on the full (slaved-ring) array; returns
    (p, max|rhs - A p|). Small interiors (<= mgp_coarse_stop) skip
    smoothing entirely: the FDM correction solves the interior system
    exactly, so the first cycle already reaches the f32 floor."""
    east_dirichlet = bc is _apply_pprime_bcs
    ny, nx = p.shape
    small = min(ny - 2, nx - 2) <= opts.mgp_coarse_stop
    omega, nu = opts.jacobi_omega, opts.mgp_smooth
    if small:
        r = _mg_residual(p, rhs, dx, dy)
        p = bc(p + _mgp_aligned_correction(r, dx, dy, opts,
                                           east_dirichlet))
        return p, jnp.max(jnp.abs(_mg_residual(p, rhs, dx, dy)))
    p, r, _ = _mgp_smooth_res(p, rhs, dx, dy, omega, nu, bc)
    p = bc(p + _mgp_aligned_correction(r, dx, dy, opts, east_dirichlet))
    p, _, err = _mgp_smooth_res(p, rhs, dx, dy, omega, nu, bc)
    return p, err


def _mgp_noise_floor(opts, dx, dy, dtype):
    """Per-cycle exit floor for MG_PRODUCTION (opts.mgp_floor): the f32
    evaluation of max|rhs - A p| cannot resolve below
    ~eps * (denom * max|p| + max|rhs|) (measured 1.4-1.8x that formula;
    PERF.md), so cycling past a small multiple of it buys nothing.
    Returns floor(p_abs_max, rhs_abs_max) -> tol_extra, or None when
    disabled. Shared by the single-device solve and the shard_map
    bodies (shard.mg_shmap) so every form exits on the identical
    criterion."""
    f = getattr(opts, "mgp_floor", 0.0)
    if not f:
        return None
    eps = float(jnp.finfo(dtype).eps)
    denom = 2.0 / (dx * dx) + 2.0 / (dy * dy)

    def floor(p_abs_max, rhs_abs_max):
        return jnp.asarray(f * eps, dtype) * (
            jnp.asarray(denom, dtype) * p_abs_max + rhs_abs_max)

    return floor


def multigrid_production(pp0: jnp.ndarray, rhs: jnp.ndarray,
                         dx: float, dy: float, opts, tol_r,
                         bc=_apply_pprime_bcs
                         ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """PressureSolver.MG_PRODUCTION (addition, docs/SPEC.md item 12).

    V-cycles until max|rhs - A p'| <= ``tol_r``; since the corrector
    subtracts dt*grad(p') and rhs = div(u*)/dt, the post-correction
    divergence satisfies max|div(u)| = dt * max|residual|, so
    tol_r = projection_div_tol / dt_sub makes the exit a direct bound
    on the quantity the projection exists to control. Warm-started
    from the previous substep's p' (temporal coherence; the parity kit
    zero-initializes per the JS source, index.html:777).

    Returns (p', max|residual|, cycles_run); vmap-safe via the masked
    convergence loop (each batch element freezes at its own exit).

    ``opts.mgp_rtol`` > 0 widens the exit to
    max(tol_r, rtol * max|rhs - A p'_0|): a relative-reduction
    criterion against the warm-start residual, computed here so the
    single-device solve and the shard_map bodies share the identical
    threshold.
    """
    import dataclasses as _dc
    if (opts.mgp_smooth == 3
            and pp0.shape[-2] * pp0.shape[-1] >= 48_000_000):
        # Size-aware smoothing strength: at >= 48M cells 5 sweeps per
        # position cut the steady adaptive cycle count by more than
        # the extra sweeps cost. Applied only to the untouched default
        # so an explicit mgp_smooth wins.
        opts = _dc.replace(opts, mgp_smooth=5)
    p0 = bc(pp0)
    diff = getattr(opts, "differentiable", False)
    fixed_cycles = getattr(opts, "mgp_fixed_cycles", 0)
    if fixed_cycles > 0:
        return _mgp_fixed(pp0, rhs, dx, dy, opts, bc, fixed_cycles, diff)
    if getattr(opts, "mgp_rtol", 0.0) > 0.0:
        err0 = jnp.max(jnp.abs(_mg_residual(p0, rhs, dx, dy)))
        tol_r = jnp.maximum(jnp.asarray(tol_r, pp0.dtype),
                            opts.mgp_rtol * err0)
    # "auto" is the aligned hierarchy (3-5x fewer cycles than legacy);
    # a caller-supplied bc function has no folded coarse operator, so
    # it runs the legacy vertex hierarchy.
    bc_known = bc in (_apply_pprime_bcs, _apply_pprime_bcs_cavity)
    if getattr(opts, "mgp_scheme", "auto") != "legacy" and bc_known:
        def solve_cycle(p):
            return _mgp_vcycle_aligned(p, rhs, dx, dy, opts, bc)
    else:
        def solve_cycle(p):
            p = _mgp_vcycle(p, rhs, dx, dy, opts, bc)
            return p, jnp.max(jnp.abs(_mg_residual(p, rhs, dx, dy)))

    # Unbatched non-differentiable solves with early_exit take the
    # exact do-while (identical fields/trip counts to the masked loop;
    # no per-cycle full-array freeze selects). vmapped solves keep the
    # masked loop's per-element freeze semantics.
    batched = (isinstance(pp0, _BatchTracer)
               or isinstance(rhs, _BatchTracer)
               or type(pp0).__name__ == "BatchTracer"
               or type(rhs).__name__ == "BatchTracer")
    exact = opts.early_exit and not diff and not batched

    floor = _mgp_noise_floor(opts, dx, dy, pp0.dtype)
    if floor is None:
        if exact:
            return _exact_while(solve_cycle, p0, tol_r, opts.mgp_max_cycles)
        return _masked_while(solve_cycle, p0, tol_r, opts.mgp_max_cycles,
                             fixed_trip=diff)

    rhs_max = jnp.max(jnp.abs(rhs))

    def cycle(p):
        p, err = solve_cycle(p)
        return p, err, floor(jnp.max(jnp.abs(p)), rhs_max)

    if exact:
        return _exact_while(cycle, p0, tol_r, opts.mgp_max_cycles,
                            dynamic_tol=True)
    return _masked_while(cycle, p0, tol_r, opts.mgp_max_cycles,
                         dynamic_tol=True, fixed_trip=diff)


def mgp_implicit_adjoint(pp0: jnp.ndarray, rhs: jnp.ndarray, dx: float,
                         dy: float, opts, tol_r,
                         bc=_apply_pprime_bcs
                         ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """MG_PRODUCTION with the solve-at-convergence (implicit) VJP:
    ``differentiable=True`` covers the production projection's
    ADAPTIVE exit.

    At convergence the solve map is pp = E(A^-1 R rhs) with R the
    interior slice, A the boundary-folded interior operator (symmetric:
    Neumann mirror folds only shrink the diagonal, the Dirichlet outlet
    fold drops a coupling on both sides) and E the linear BC-slaving
    extension e_int -> bc(pad(e_int, 1)). The map is independent of the
    warm start and of HOW the solver got there, so the reverse
    derivative needs neither the iteration trace nor a differentiable
    forward: rbar = R^T A^-1 (E^T ct), i.e. ONE more MGP solve with the
    transposed-slaving cotangent as its right-hand side -- exact
    regardless of the adaptive schedule, O(1) activation memory, and
    the forward runs the full non-differentiable machinery (exact
    while_loop exits) untouched by AD.

    Approximations, both O(solver tolerance): d pp / d pp0 is taken as
    exactly 0 (true at exact convergence), and the backward solve runs
    to its own f32-noise-floor / max-cycles exit. Gradients through the
    ``err`` diagnostic are defined ZERO like every fast-adjoint path
    (callers gate residual_dt_scaling off). Returns (p', err, cycles).
    """
    import dataclasses as _dc

    opts_fwd = _dc.replace(opts, differentiable=False)

    @jax.custom_vjp
    def solve(p0, r, tol):
        return multigrid_production(p0, r, dx, dy, opts_fwd, tol, bc=bc)

    def fwd(p0, r, tol):
        return solve(p0, r, tol), None  # implicit: nothing to save

    def bwd(_, ct):
        ct_p = ct[0]
        ny, nx = ct_p.shape
        spec = jax.ShapeDtypeStruct((ny - 2, nx - 2), ct_p.dtype)
        ext = lambda e: bc(jnp.pad(e, 1))
        w_int = jax.linear_transpose(ext, spec)(ct_p)[0]
        w_full = jnp.pad(w_int, 1)
        if bc is _apply_pprime_bcs_cavity:
            # All-Neumann interior operator is singular with a constant
            # nullspace; range(A) = mean-free interiors. Project the
            # cotangent there so the backward iteration cannot drift
            # along the nullspace (its limit would otherwise depend on
            # the solver schedule). Subtracting the mean realizes the
            # pseudo-inverse exactly: A^+ annihilates the nullspace
            # component of the cotangent, so lam = A^+ w is what the
            # forward's A^+ (cavity gauge) transposes to.
            interior0, _, _ = _iota_masks(w_full.shape)
            n_int = jnp.sum(interior0.astype(w_full.dtype))
            mean = jnp.sum(jnp.where(interior0, w_full, 0.0)) / n_int
            w_full = jnp.where(interior0, w_full - mean, 0.0)
        # A^T = A: solve A lam = E^T ct with the same machinery, from a
        # zero start, to the f32 noise floor (tol 0 + opts.mgp_floor) or
        # the cycle cap -- the gradient analog of "solved exactly".
        lam, _, _ = multigrid_production(jnp.zeros_like(w_full), w_full,
                                         dx, dy, opts_fwd,
                                         jnp.zeros((), ct_p.dtype), bc=bc)
        interior, _, _ = _iota_masks(lam.shape)
        r_bar = jnp.where(interior, lam, 0.0)
        return (jnp.zeros_like(ct_p), r_bar,
                jnp.zeros((), ct_p.dtype))

    solve.defvjp(fwd, bwd)
    return solve(pp0, rhs, jnp.asarray(tol_r, pp0.dtype))


def _mgp_fixed(pp0, rhs, dx, dy, opts, bc, cycles: int, diff: bool):
    """MG_PRODUCTION with a FIXED cycle count (opts.mgp_fixed_cycles):
    a deterministic schedule with no adaptive exit. In differentiable
    mode this is the MGP fast-adjoint path: the fixed-cycle V-cycle
    iteration is LINEAR in (p'0, rhs) -- smoothing sweeps, transfers,
    the FDM bottom solve and the BC folds are all linear maps -- so
    :func:`fixed_linear_adjoint` gives it the exact transposed-recursion
    VJP with O(1) activation memory."""
    bc_known = bc in (_apply_pprime_bcs, _apply_pprime_bcs_cavity)

    def cycle(p, r):
        if bc_known:
            return _mgp_vcycle_aligned(p, r, dx, dy, opts, bc)
        p = _mgp_vcycle(p, r, dx, dy, opts, bc)
        return p, jnp.max(jnp.abs(_mg_residual(p, r, dx, dy)))

    def forward(p0, r):
        p = bc(p0)
        err = jnp.zeros((), p.dtype)
        for _ in range(cycles):
            p, err = cycle(p, r)
        return p, err

    if not diff:
        p, err = forward(pp0, rhs)
        return p, err, jnp.asarray(cycles, jnp.int32)

    p, err = fixed_linear_adjoint(lambda p, r: cycle(p, r)[0], cycles,
                                  forward, pp0, rhs, pre=bc)
    return p, err, jnp.asarray(cycles, jnp.int32)


def multigrid(pp0: jnp.ndarray, rhs: jnp.ndarray, dx: float, dy: float,
              opts) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """3 V-cycles + final residual report (index.html:775-795).

    ``pp0`` is ignored except for shape/dtype: JS zero-initializes
    (index.html:777).
    """
    pp = jnp.zeros_like(pp0)
    for _ in range(opts.mg_cycles):
        pp = _mg_vcycle(pp, rhs, dx, dy, opts)
    r = _mg_residual(pp, rhs, dx, dy)
    err = jnp.max(jnp.abs(r))  # boundary entries are exactly 0
    return pp, err, jnp.asarray(opts.mg_cycles, jnp.int32)
