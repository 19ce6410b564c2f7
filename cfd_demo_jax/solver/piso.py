"""The PISO time-step, fully on-device.

Reference call stack being rebuilt (SURVEY.md section 3.1):
  Model::update (model.rs:304-379)
    -> piso_step (model.rs:529-730)
         predictor -> divergence -> Jacobi -> corrector
         -> up to 20 extra corrector rounds (model.rs:696-724)
         -> boundary conditions (model.rs:826-875)
  JS twin: updateSimulation (index.html:261-363) with extrapolation,
  adaptive substeps and the dt controller (index.html:333-358).

Design: one pure function advances the whole step; the pressure
iterations are lax.while_loop / lax.scan so hundreds of grid sweeps
run per dispatch without leaving the device; dt and the
convergence-controlled loop bounds live in the carry so there is no
host round trip (SURVEY.md section 7 "CFL dt control").
"""
from __future__ import annotations

import dataclasses
import functools
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..core.config import (Grid, PressureSolver, Semantics,
                           SimulationParams, SolverOptions)
from ..core.masks import build_masks
from ..core.state import State, init_state
from ..ops.bc import apply_bcs
from ..ops.corrector import correct
from ..ops.divergence import divergence_rhs
from ..ops.poisson import jacobi, multigrid, sor
from ..ops.predictor import predict


class StepDiagnostics(NamedTuple):
    """Per-step residual record (model.rs:23-32 Residuals), plus the
    step's pressure-solve trip counts: ``p_iters`` sums the iterations
    (Jacobi/SOR sweeps, V-cycles, 1 per FDM solve) of every solve in
    the step, ``rounds`` the Rust outer corrector rounds run
    (model.rs:696-724) over all substeps."""

    step: jnp.ndarray
    t: jnp.ndarray
    dt: jnp.ndarray
    res_u: jnp.ndarray
    res_v: jnp.ndarray
    res_p: jnp.ndarray
    substeps: jnp.ndarray
    p_iters: jnp.ndarray
    rounds: jnp.ndarray


@dataclasses.dataclass(frozen=True)
class Scene:
    """A compiled simulation setup: grid + static numerics.

    Build with :func:`make_scene`. The returned ``step`` closure is the
    single-device jit target; runtime scalars flow through ``State``.
    The device path computes obstacle masks analytically from iota
    (core.masks.masks_traced); the materialized NumPy masks below are
    lazy, for host-side diagnostics only (runtime.trace) -- at 8192^2
    they would cost hundreds of MB of host RAM per scene otherwise.
    """

    grid: Grid
    params: SimulationParams
    opts: SolverOptions

    def init_state(self, dtype=jnp.float32) -> State:
        return init_state(self.grid, self.params, self.opts, dtype)

    @functools.cached_property
    def _masks(self):
        return build_masks(self.grid, self.opts.semantics)

    @property
    def mask_u(self) -> np.ndarray:
        return self._masks[0]

    @property
    def mask_v(self) -> np.ndarray:
        return self._masks[1]

    @property
    def mask_u_bc(self) -> np.ndarray:
        return self._masks[2]

    @property
    def mask_v_bc(self) -> np.ndarray:
        return self._masks[3]


def make_scene(grid: Grid, params: Optional[SimulationParams] = None,
               opts: Optional[SolverOptions] = None) -> Scene:
    opts = opts or SolverOptions()
    if opts.differentiable:
        # Reverse-mode AD needs every loop to be a fixed-trip scan:
        # exact early exits, Rust outer corrector rounds and dynamic
        # substep counts all lower to lax.while_loop, which has no
        # reverse rule (SolverOptions.differentiable docstring).
        bad = []
        solver_kind = (params or SimulationParams()).pressure_solver
        # The adaptive MG_PRODUCTION projection differentiates through
        # the solve-at-convergence VJP (ops.poisson.mgp_implicit_adjoint)
        # whose forward is hidden from AD, so its exact while_loop exits
        # are allowed; every other solver's early exit still lowers to a
        # reverse-underivable while_loop.
        mgp_implicit = (solver_kind == PressureSolver.MG_PRODUCTION
                        and opts.mgp_fixed_cycles == 0
                        and not opts.residual_dt_scaling)
        if opts.early_exit and not mgp_implicit:
            bad.append("early_exit=False")
        if opts.outer_corrector_rounds != 0:
            bad.append("outer_corrector_rounds=0")
        if opts.substeps_adaptive:
            bad.append("a static substep count (substeps_adaptive="
                       "False; the count is unrolled)")
        if bad:
            raise ValueError(
                "SolverOptions.differentiable requires "
                + ", ".join(bad))
    if opts.mgp_scheme not in ("auto", "aligned", "legacy"):
        # A typo must fail loudly, not silently pick a hierarchy.
        raise ValueError(f"mgp_scheme must be auto|aligned|legacy, "
                         f"got {opts.mgp_scheme!r}")
    return Scene(grid=grid, params=params or SimulationParams(),
                 opts=opts)


# ---------------------------------------------------------------------------
# PISO substep
# ---------------------------------------------------------------------------

def _solve_pressure(scene: Scene, pp0, rhs, dt_sub=None):
    g, opts = scene.grid, scene.opts
    solver = scene.params.pressure_solver
    from ..ops.poisson import pprime_bc_fn
    bc = pprime_bc_fn(scene.params.flow_case)
    if solver == PressureSolver.MG_PRODUCTION:
        # Addition (docs/SPEC.md item 12): divergence-calibrated exit.
        # tol_r = div_tol / dt bounds the post-correction max|div(u)|
        # by div_tol; without dt (no caller context) the tol is used
        # in raw residual units.
        from ..ops.poisson import multigrid_production
        tol_r = opts.projection_div_tol
        if dt_sub is not None:
            tol_r = tol_r / dt_sub
        if (opts.differentiable and opts.mgp_fixed_cycles == 0
                and not opts.residual_dt_scaling):
            # Solve-at-convergence VJP (ops.poisson.mgp_implicit_adjoint):
            # the ADAPTIVE production projection differentiates exactly
            # (one transposed solve per backward pass), with the
            # non-differentiable forward machinery -- while_loop
            # exits -- running untouched under the custom VJP. Gated
            # off when res_p feeds the dynamics (JS residual-dt
            # scaling): err gradients are zero by definition on this
            # path, like every fast adjoint.
            from ..ops.poisson import mgp_implicit_adjoint
            return mgp_implicit_adjoint(pp0, rhs, g.dx, g.dy, opts,
                                        tol_r, bc=bc)
        return multigrid_production(pp0, rhs, g.dx, g.dy, opts, tol_r,
                                    bc=bc)
    if solver == PressureSolver.JACOBI:
        def _solve_single(pp0_, rhs_):
            return jacobi(pp0_, rhs_, g.dx, g.dy, opts.jacobi_omega,
                          opts.jacobi_tol, opts.jacobi_iters,
                          early_exit=opts.early_exit, bc=bc,
                          fixed_trip=opts.differentiable)

        if opts.differentiable:
            if opts.jacobi_tol == 0.0 and not opts.residual_dt_scaling:
                # Fast adjoint (ops.poisson.jacobi_fixed_adjoint): the
                # fixed-schedule solve is linear, so the backward pass
                # is ONE transposed application (no stored iterates).
                # Gated off when res_p feeds back into the dynamics
                # (JS residual-dt scaling): err gradients are zero by
                # definition on this path.
                from ..ops.poisson import jacobi_fixed_adjoint
                n_it = opts.jacobi_iters

                def forward(p0, r):
                    pp_, err_, _ = jacobi(
                        p0, r, g.dx, g.dy, opts.jacobi_omega, 0.0,
                        n_it, early_exit=False, bc=bc,
                        fixed_trip=True)
                    return pp_, err_

                pp_out, err_out = jacobi_fixed_adjoint(
                    pp0, rhs, g.dx, g.dy, opts.jacobi_omega, n_it, bc,
                    forward)
                return pp_out, err_out, jnp.asarray(max(1, n_it),
                                                    jnp.int32)
            # jax.custom_batching.custom_vmap blocks reverse-mode AD;
            # differentiable mode takes the plain solve (vmap of it is
            # the same masked fixed-trip scan per element).
            return _solve_single(pp0, rhs)

        # Under vmap (the 64-scene ensemble, SURVEY.md section 2.7) the
        # solve runs the masked loop (ops.poisson._masked_while) for
        # EITHER early_exit flag: single-iteration-granularity freeze
        # per scene, the batch exiting once every scene has converged.
        # Masked iteration is the vmap-correct reading of the
        # reference's per-scene early exit.
        solve = jax.custom_batching.custom_vmap(_solve_single)

        @solve.def_vmap
        def _vmap_rule(axis_size, in_batched, pp0_, rhs_):
            pb, rb = in_batched
            if not pb:
                pp0_ = jnp.broadcast_to(pp0_, (axis_size,) + pp0_.shape)
            if not rb:
                rhs_ = jnp.broadcast_to(rhs_, (axis_size,) + rhs_.shape)
            out = jax.vmap(
                lambda a, b: jacobi(a, b, g.dx, g.dy, opts.jacobi_omega,
                                    opts.jacobi_tol, opts.jacobi_iters,
                                    early_exit=False, bc=bc)
            )(pp0_, rhs_)
            return out, (True, True, True)

        return solve(pp0, rhs)
    if solver == PressureSolver.SOR:
        if opts.sor_ordering == "lexicographic":
            # JS-ordering-exact mode (docs/SPEC.md item 4): the
            # wavefront sweep reproduces the sequential in-place
            # ordering bitwise. Its cost is the (nx+ny) sequential
            # diagonal depth.
            from ..ops.poisson import sor_lexicographic
            return sor_lexicographic(pp0, rhs, g.dx, g.dy,
                                     opts.sor_omega, opts.jacobi_tol,
                                     opts.jacobi_iters,
                                     early_exit=opts.early_exit, bc=bc,
                                     fixed_trip=opts.differentiable)
        if (opts.differentiable and opts.jacobi_tol == 0.0
                and not opts.residual_dt_scaling):
            # Fast adjoint (ops.poisson.fixed_linear_adjoint): the
            # fixed-schedule red/black solve is linear in (p'0, rhs)
            # exactly like the fixed Jacobi schedule -- one transposed
            # sweep recursion, no stored iterates. Same
            # err-gradient-is-zero convention and residual_dt_scaling
            # gate as the Jacobi fast path.
            from ..ops.poisson import (_iota_masks, _sor_sweep,
                                       fixed_linear_adjoint)
            n_it = opts.jacobi_iters

            def sor_iter(p_, r_):
                # masks built INSIDE the map: anything traced closed
                # over here would leak a scan-trace tracer into the
                # transpose jaxpr as a constant
                _, rr_, cc_ = _iota_masks(p_.shape)
                return _sor_sweep(p_, r_, g.dx, g.dy, opts.sor_omega,
                                  (rr_ + cc_) % 2 == 0,
                                  (rr_ + cc_) % 2 == 1, bc)[0]

            def forward(p0, r):
                pp_, err_, _ = sor(p0, r, g.dx, g.dy, opts.sor_omega,
                                   0.0, n_it, early_exit=False,
                                   bc=bc, fixed_trip=True)
                return pp_, err_

            pp_out, err_out = fixed_linear_adjoint(sor_iter, n_it,
                                                   forward, pp0, rhs)
            return pp_out, err_out, jnp.asarray(max(1, n_it), jnp.int32)
        return sor(pp0, rhs, g.dx, g.dy, opts.sor_omega,
                   opts.jacobi_tol, opts.jacobi_iters,
                   early_exit=opts.early_exit, bc=bc,
                   fixed_trip=opts.differentiable)
    if solver == PressureSolver.MULTIGRID:
        return multigrid(pp0, rhs, g.dx, g.dy, opts)
    if solver == PressureSolver.FDM:
        # Exact direct projection (docs/SPEC.md item 13): the folded
        # interior system A p' = rhs solved by fast diagonalization
        # (ops/fdm.py) -- the fixed point every iterative solver here
        # converges to. Warm starts are irrelevant (pp0 ignored); the
        # returned err is the true post-solve residual (f32 noise
        # floor), computed for diagnostics parity with the iterative
        # solvers. Linear + fixed-shape => differentiable and vmappable
        # as-is.
        from ..core.config import FlowCase
        from ..ops.fdm import fdm_solve_interior
        from ..ops.poisson import _mg_residual
        cavity = scene.params.flow_case == FlowCase.CAVITY
        ny, nx = g.ny, g.nx
        # 2-D contract like every solver branch (vmap batches via
        # tracers; bc unpacks a 2-D shape).
        e_int = fdm_solve_interior(rhs[1:ny - 1, 1:nx - 1], g.dx, g.dy,
                                   east_dirichlet=not cavity,
                                   d_wall=g.dx)
        pp = bc(jnp.pad(e_int, 1))
        err = jnp.max(jnp.abs(_mg_residual(pp, rhs, g.dx, g.dy)))
        return pp, err, jnp.ones((), jnp.int32)
    raise ValueError(solver)


def _outer_rounds(scene: Scene, u, v, p, pp, err, dt_sub):
    """Rust-only outer corrector rounds (model.rs:696-724): repeat
    div -> solve -> correct until the pressure residual drops below
    outer_corrector_tol, at most outer_corrector_rounds times. Returns
    (u, v, p, pp, err, solve iterations, rounds run)."""
    g, opts = scene.grid, scene.opts
    rounds = opts.outer_corrector_rounds
    zero = jnp.asarray(0, jnp.int32)
    if rounds == 0:
        return u, v, p, pp, err, zero, zero

    def round_body(u, v, p, pp):
        rhs = divergence_rhs(u, v, dt_sub, g.dx, g.dy)
        pp, err, n = _solve_pressure(scene, pp, rhs, dt_sub)
        u, v, p = correct(u, v, p, pp, dt_sub, g.dx, g.dy)
        return u, v, p, pp, err, n

    if opts.early_exit:
        def cond(carry):
            err, it = carry[4], carry[6]
            return jnp.logical_and(it < rounds,
                                   err >= opts.outer_corrector_tol)

        def body(carry):
            u, v, p, pp, _, iters, it = carry
            u, v, p, pp, err, n = round_body(u, v, p, pp)
            return u, v, p, pp, err, iters + n, it + 1

        u, v, p, pp, err, iters, it = lax.while_loop(
            cond, body, (u, v, p, pp, err, zero, zero))
        return u, v, p, pp, err, iters, it

    # Masked while: per-element freezing in the body keeps vmap
    # semantics exact while the batch exits when all are done
    # (see ops.poisson._masked_while).
    def cond(carry):
        done, it = carry[5], carry[8]
        return jnp.logical_and(it < rounds, jnp.logical_not(done))

    def body(carry):
        u, v, p, pp, err, done, iters, n_run, it = carry
        u2, v2, p2, pp2, err2, n = round_body(u, v, p, pp)
        sel = lambda a, b: jnp.where(done, a, b)
        u, v, p = sel(u, u2), sel(v, v2), sel(p, p2)
        pp, err = sel(pp, pp2), sel(err, err2)
        live = jnp.logical_not(done).astype(jnp.int32)
        iters, n_run = iters + live * n, n_run + live
        done = jnp.logical_or(done, err < opts.outer_corrector_tol)
        return u, v, p, pp, err, done, iters, n_run, it + 1

    u, v, p, pp, err, _, iters, n_run, _ = lax.while_loop(
        cond, body,
        (u, v, p, pp, err, err < opts.outer_corrector_tol, zero, zero,
         zero))
    return u, v, p, pp, err, iters, n_run


def _substep(scene: Scene, u, v, p, p_prime, dt_sub, nu, inlet):
    """predict -> solve -> correct -> outer rounds -> BCs.
    Returns (u, v, p, pp, err, solve iterations, outer rounds)."""
    g, opts = scene.grid, scene.opts
    from ..core.masks import masks_traced
    mask_u, mask_v, mask_u_bc, mask_v_bc = masks_traced(
        g, opts.semantics, u.dtype)
    u_star, v_star = predict(u, v, dt_sub, nu, g.dx, g.dy, g.nx, g.ny,
                             scene.params.velocity_scheme,
                             opts.semantics == Semantics.JS,
                             mask_u, mask_v)
    rhs = divergence_rhs(u_star, v_star, dt_sub, g.dx, g.dy)
    pp0 = (p_prime if opts.semantics == Semantics.RUST
           else jnp.zeros_like(p_prime))
    pp, err, n = _solve_pressure(scene, pp0, rhs, dt_sub)
    u, v, p = correct(u_star, v_star, p, pp, dt_sub, g.dx, g.dy)
    u, v, p, pp, err, n_more, n_rounds = _outer_rounds(
        scene, u, v, p, pp, err, dt_sub)
    u, v = apply_bcs(u, v, g, scene.params.inlet_profile, inlet,
                     mask_u_bc, mask_v_bc, scene.params.flow_case)
    return (u, v, p, pp, err, jnp.asarray(n, jnp.int32) + n_more,
            n_rounds)


def piso_substep(scene: Scene, u, v, p, p_prime, dt_sub, nu, inlet):
    """One PISO substep (model.rs:529-730 / index.html:366-867).

    Returns (u, v, p, p_prime, p_residual, solve iterations, outer
    rounds). Under vmap (the 64-scene
    ensemble) every argument is batched and the whole substep is
    vmapped per scene; the pressure solve's own rule then runs the
    masked convergence loop, so per-scene results match an unbatched
    run (tests/test_sharding.py).
    """
    single = partial(_substep, scene)
    if scene.opts.differentiable:
        # custom_vmap blocks reverse-mode AD; the substep vmaps fine by
        # itself (masked fixed-trip loops).
        return single(u, v, p, p_prime, dt_sub, nu, inlet)
    wrapped = jax.custom_batching.custom_vmap(
        lambda u, v, p, pp, dts, nu, inl: single(u, v, p, pp, dts, nu,
                                                 inl))

    @wrapped.def_vmap
    def _rule(axis_size, in_batched, *args):
        args = [a if b else jnp.broadcast_to(a, (axis_size,)
                                             + jnp.shape(a))
                for a, b in zip(args, in_batched)]
        return jax.vmap(single)(*args), (True,) * 7

    return wrapped(u, v, p, p_prime, dt_sub, nu, inlet)


# ---------------------------------------------------------------------------
# Step-level scalar controls
# ---------------------------------------------------------------------------

def ramped_inlet(opts: SolverOptions, state: State, f32):
    """Inlet ramp (model.rs:311-316 / index.html:277-281)."""
    ramp = jnp.minimum(
        state.step.astype(f32) / float(opts.ramp_up_steps), 1.0)
    return ramp * state.target_inlet


def adapt_substeps(opts: SolverOptions, substeps, res_u, res_v, res_p, f32):
    """JS substep adaptation (index.html:310-317): grow by the error
    ratio above tolerance, halve when well below."""
    error_norm = jnp.maximum(jnp.maximum(res_u, res_v), res_p)
    tol = opts.substep_tolerance
    factor = error_norm / tol
    grown = jnp.minimum(
        jnp.ceil(substeps.astype(f32) * factor),
        float(opts.substeps_max)).astype(jnp.int32)
    shrunk = jnp.maximum(substeps // 2, 1)
    return jnp.where(
        error_norm > tol, grown,
        jnp.where(jnp.logical_and(error_norm < tol / 10.0, substeps > 1),
                  shrunk, substeps))


def dt_control(grid: Grid, opts: SolverOptions, state: State,
               max_vel, res_p):
    """CFL dt control with the 1.1x growth cap (model.rs:877-889 /
    index.html:1326-1341), plus the JS residual-based dt scaling
    (index.html:338-350)."""
    js = opts.semantics == Semantics.JS
    cap = state.dt_user if js else state.dt
    # Safe-where: the masked-out division still runs, and at
    # max_vel == 0 its inf primal would poison reverse-mode cotangents
    # with 0 * inf = NaN (SolverOptions.differentiable); dividing by
    # the guarded value keeps the primal bit-identical.
    safe_vel = jnp.where(max_vel == 0.0, 1.0, max_vel)
    dt_cfl = jnp.where(
        max_vel == 0.0, cap,
        jnp.minimum(opts.cfl * min(grid.dx, grid.dy) / safe_vel, cap))
    if js and opts.residual_dt_scaling:
        ptol = opts.residual_dt_tol
        dt_pressure = jnp.where(res_p > ptol,
                                dt_cfl * (ptol / (res_p + 1e-10)), dt_cfl)
        dt_cfl = jnp.minimum(dt_cfl, dt_pressure)
    return jnp.where(dt_cfl > state.dt,
                     jnp.minimum(dt_cfl, state.dt * opts.dt_growth_cap),
                     dt_cfl)


# ---------------------------------------------------------------------------
# Full outer step
# ---------------------------------------------------------------------------

def step_fn(scene: Scene, state: State) -> Tuple[State, StepDiagnostics]:
    """One Model::update / updateSimulation. Pure; jit/vmap/scan-able."""
    g, opts = scene.grid, scene.opts
    js = opts.semantics == Semantics.JS
    f32 = state.u.dtype

    u_enter, v_enter = state.u, state.v
    u, v = u_enter, v_enter
    # JS extrapolated initial guess (index.html:263-270). NOTE: the JS
    # copies uPrev from the *end-of-step* field (index.html:360-362),
    # which makes its 2u - uPrev a no-op; we restore the intended
    # semantics (u_prev = previous converged field). Set
    # opts.extrapolate=False for the JS's effective behavior. docs/SPEC.md.
    if js and opts.extrapolate:
        nonzero = state.step > 0
        u = jnp.where(nonzero, 2.0 * u - state.u_prev, u)
        v = jnp.where(nonzero, 2.0 * v - state.v_prev, v)
    u_old, v_old = u, v

    inlet = ramped_inlet(opts, state, f32)

    substeps = state.substeps
    # The static-count branches below execute exactly substeps_init
    # substeps regardless of the carried counter (a state resumed from
    # a JS adaptive run can carry substeps != substeps_init); pin
    # dt_sub to the count actually run so the substeps always sum to
    # one full dt of physical time.
    if not opts.substeps_adaptive and (opts.substeps_init == 1
                                       or opts.differentiable):
        substeps = jnp.asarray(opts.substeps_init, substeps.dtype)
    dt_sub = state.dt / substeps.astype(f32)
    # The count this step actually executes -- reported in the
    # diagnostics (physical_pressure divides forces by it) and
    # distinct from both the carried counter (overridden above) and
    # the post-step adapted value.
    executed_substeps = substeps

    def sub_body(i, carry):
        u, v, p, pp, max_res_p, iters, rounds = carry
        u, v, p, pp, err, n, r = piso_substep(scene, u, v, p, pp, dt_sub,
                                              state.nu, inlet)
        # JS tracks the max residual across substeps (index.html:288-293);
        # Rust reports the last substep's residual (model.rs:326).
        max_res_p = jnp.maximum(max_res_p, err) if js else err
        return u, v, p, pp, max_res_p, iters + n, rounds + r

    zero = jnp.asarray(0, jnp.int32)
    carry0 = (u, v, state.p, state.p_prime, jnp.asarray(0.0, f32), zero,
              zero)
    if not opts.substeps_adaptive and opts.substeps_init == 1:
        # Statically one substep (Rust semantics): skip the dynamic
        # fori_loop wrapper so XLA fuses across the substep boundary.
        carry = sub_body(0, carry0)
    elif not opts.substeps_adaptive and opts.differentiable:
        # Static substep count, unrolled: the dynamic fori_loop's
        # traced trip count lowers to while_loop, which has no
        # reverse-mode rule.
        carry = carry0
        for i in range(opts.substeps_init):
            carry = sub_body(i, carry)
    else:
        carry = lax.fori_loop(0, substeps, sub_body, carry0)
    u, v, p, pp, res_p, p_iters, n_rounds = carry

    res_u = jnp.max(jnp.abs(u - u_old))
    res_v = jnp.max(jnp.abs(v - v_old))
    new_step = state.step + 1
    new_t = state.t + state.dt

    # Substep adaptation (index.html:310-317).
    if js and opts.substeps_adaptive:
        substeps = adapt_substeps(opts, substeps, res_u, res_v, res_p, f32)

    # CFL dt control (model.rs:877-889 / index.html:1326-1341).
    max_vel = jnp.maximum(jnp.max(jnp.abs(u)), jnp.max(jnp.abs(v)))
    new_dt = dt_control(g, opts, state, max_vel, res_p)

    new_state = dataclasses.replace(
        state, u=u, v=v, p=p, p_prime=pp,
        u_prev=u_enter if js else None, v_prev=v_enter if js else None,
        dt=new_dt, t=new_t, step=new_step, substeps=substeps,
        res_u=res_u, res_v=res_v, res_p=res_p)
    diag = StepDiagnostics(step=new_step, t=new_t, dt=state.dt,
                           res_u=res_u, res_v=res_v, res_p=res_p,
                           substeps=executed_substeps, p_iters=p_iters,
                           rounds=n_rounds)
    return new_state, diag


def make_step(scene: Scene, donate: bool = True, jit: bool = True):
    """jit-compiled single step: state -> (state, diagnostics).

    ``donate`` hands the input state's buffers to the output, so the
    fields update in place in device memory; pass False to keep using
    the input state after the call."""
    fn = partial(step_fn, scene)
    if not jit:
        return fn
    return jax.jit(fn, donate_argnums=(0,) if donate else ())


def make_run(scene: Scene, n_steps: int, donate: bool = True):
    """n steps fused under lax.scan: state -> (state, stacked diags).

    This is the throughput path: the scan keeps every pressure sweep on
    device and only the (n_steps,)-shaped scalar diagnostics come back.

    With opts.differentiable, each step is rematerialized
    (jax.checkpoint): jax.grad through the rollout stores only the
    per-step State carries and recomputes a step's internals during
    the backward pass, so backward memory is one step's activations
    (~jacobi_iters fields), not the rollout's.
    """
    def body(s, _):
        return step_fn(scene, s)

    if scene.opts.differentiable:
        body = jax.checkpoint(body)

    def run(state: State):
        return lax.scan(body, state, None, length=n_steps)

    return jax.jit(run, donate_argnums=(0,) if donate else ())
