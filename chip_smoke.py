#!/usr/bin/env python
"""Smoke test of the solver on the GPU, through the user entry points.

    python chip_smoke.py              # one GPU: phases reference..ensemble
    python chip_smoke.py --cards 4    # four GPUs: the sharded phases only

One-card phases (full widths; depth cut to a few steps):

  reference  make_scene(default_grid()): the Rust app's 800x264 cylinder
             channel, early-exit Jacobi and up to 20 outer corrector
             rounds, 200 steps through make_run; invariants; the first
             10 steps against the same program on the host CPU.
  oracle     the 24x16 golden grid for every oracle solver family, both
             semantics, both flow cases, against oracle.reference.
  headline   2048^2: fixed 50-sweep Jacobi, MG_PRODUCTION and FDM, 10
             steps each against the host CPU (fields for Jacobi, cycle
             counts for MG) and against a float64 run on the host (MG,
             FDM); one FDM solve against the exact solve and the f32
             noise floor; MG_PRODUCTION's aligned hierarchy at 2048^2
             and 259^2, operator by operator against the host CPU and
             cycle by cycle against a float64 run of the same cycles.
  large      8192^2 fixed 50-sweep Jacobi, 3 steps, on one card.
  ensemble   64 scenes of 256x96 through apps.ensemble's builder,
             scene by scene against unbatched runs on the card.

Four-card phases (--cards 4):

  rows       the GSPMD row-sharded 8192^2 step against one card.
  batch      the batch-sharded 64-scene ensemble against the unsharded
             one.
  Both time one card and four cards alike: one dispatch per step.

Each phase prints one line ``phase <name> {json}`` of what it measured.
Then the card's name and power limit (nvidia-smi), and as the last line
``{"ok": true, "device": {"platform", "kind", "count"}}``. A failing
phase prints its error and the script exits 1 without that line. With
no GPU it exits 2 at once. Every tolerance is explained in PERF.md.
One process drives every card it uses.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

# Early-exit loops decide on a residual near their tolerance; one ulp
# between two lowerings can move one exit by one sweep or round. That
# changes a trip count by one and the fields by about one sweep's
# update, well under 1e-4 of their scale.
EARLY_EXIT_RTOL = 1e-4
EARLY_EXIT_TRIPS = 1
# Fixed schedules run the same arithmetic in another order: fields
# agree to f32 accumulation noise.
FIXED_RTOL = 1e-5
# A full-f32 direct solve at 2048^2 leaves a residual of a few tens of
# eps of its operands' scale (CPU 21, H100 38); TF32 products leave
# about 3,300. The bound sits between them.
FDM_FLOOR_EPS = 100.0
# One elementwise linear operator of the multigrid hierarchy (transfer,
# sweep, residual) on random operands, card vs host CPU: the same sums,
# in another order or with fused multiply-adds. A few ulps (each sits
# <= 7.3e-8 from float64 on the CPU). The bottom FDM solve, a dense
# solve whose low modes carry eps times its conditioning (8.1e-7 from
# float64 on the CPU), is held to FIXED_RTOL like the 2048^2 FDM solve.
OP_RTOL = 1e-6
# MG_PRODUCTION amplifies f32 rounding: V-cycles after the first
# evaluate a residual far below |A p|. The card and the host CPU each
# sit some way from the float64 run of the same cycles or rollout; the
# card's distance may not exceed this factor times the host's.
F32_SPREAD = 2.0
# The FDM rollout differences a p' solved to f32: ten 2048^2 steps turn
# each solve's error into ~350x as much in u, on both devices. The
# card's f32 GEMM (cuBLAS) rounds twice as much as the CPU's, so its
# solves sit 1.7e-6 from exact against the host's 8.8e-7, and its
# rollout 6.2e-4 from float64 against the host's 2.9e-4 (PERF.md). A
# limit set from those readings: the card's own.
FDM_ROLLOUT_VS_F64 = 1e-3

ONE_CARD = ("reference", "oracle", "headline", "large", "ensemble")
FOUR_CARDS = ("rows", "batch")


def rms(x) -> float:
    return float(np.sqrt(np.mean(np.square(np.asarray(x, np.float64)))))


def state_errors(got, want) -> dict:
    """Relative L2 (RMS ratio) of u, v and p. Both velocity components
    are measured against the RMS speed: in a symmetric channel v alone
    is near zero, and a ratio to it would measure nothing. p drops the
    mean difference first (pressure acts through its gradient). The
    differences are taken in float64 numpy."""
    g, w = ({k: np.asarray(getattr(s, k), np.float64) for k in "uvp"}
            for s in (got, want))
    speed = max(np.hypot(rms(w["u"]), rms(w["v"])), 1e-30)
    dp = g["p"] - w["p"]
    return {"u": rms(g["u"] - w["u"]) / speed,
            "v": rms(g["v"] - w["v"]) / speed,
            "p": rms(dp - dp.mean()) / max(rms(w["p"]), 1e-30)}


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def peak_bytes() -> int:
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def host_cpu():
    """The host's CPU backend: the reference the card is compared to."""
    import jax
    return jax.devices("cpu")[0]


def timed(fn, *args):
    """(result, seconds) of one call, compiled beforehand, ended with
    block_until_ready."""
    import jax
    compiled = jax.jit(fn).lower(*args).compile()
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    return out, time.perf_counter() - t0


def invariants(scene, state):
    """Finite fields, no-slip wall rows exactly 0, and the obstacle
    faces the BCs zero exactly 0 (model.rs:869-874)."""
    u, v, p = (np.asarray(x) for x in (state.u, state.v, state.p))
    check(np.isfinite(u).all() and np.isfinite(v).all()
          and np.isfinite(p).all(), "non-finite fields")
    check(not u[0].any() and not u[-1].any(), "u wall rows not zero")
    check(not v[0].any(), "v bottom wall row not zero")
    if scene.grid.obstacles:
        check(not u[scene.mask_u_bc > 0].any(), "u obstacle faces not zero")
        check(not v[scene.mask_v_bc > 0].any(), "v obstacle faces not zero")


def max_div(scene, state) -> float:
    """max|div u| over the far field: cells at least 3 cells from any
    obstacle face and 2 from the domain edge (the projection's target;
    next to a masked face the reference itself leaves divergence)."""
    from cfd_demo_jax.ops.divergence import divergence
    g = scene.grid
    div = np.abs(np.asarray(divergence(state.u, state.v, g.dx, g.dy)))
    near = np.zeros(div.shape, bool)
    if g.obstacles:
        mu, mv = scene.mask_u > 0, scene.mask_v > 0
        near = mu[:, :-1] | mu[:, 1:] | mv
        near[:-1] |= mv[1:]
        for _ in range(3):
            grown = near.copy()
            grown[1:] |= near[:-1]
            grown[:-1] |= near[1:]
            grown[:, 1:] |= near[:, :-1]
            grown[:, :-1] |= near[:, 1:]
            near = grown
    far = ~near
    far[:2] = far[-2:] = False
    far[:, :2] = far[:, -2:] = False
    return float(div[far].max())


def rollout_numbers(scene, state, diags, seconds, n_steps) -> dict:
    g = scene.grid
    return {"steps_per_s": n_steps / seconds,
            "cell_updates_per_s": g.nx * g.ny * n_steps / seconds,
            "max_div_u_far": max_div(scene, state),
            "p_iters_per_step": float(np.mean(np.asarray(diags.p_iters))),
            "rounds_per_step": float(np.mean(np.asarray(diags.rounds))),
            "peak_bytes_in_use": peak_bytes()}


def fast_scene(n: int, solver=None, **over):
    """bench.py's square channel at n^2 with a fixed 50-sweep schedule."""
    import cfd_demo_jax as cfd
    from cfd_demo_jax import (Cylinder, Grid, PressureSolver, Semantics,
                              SimulationParams, solver_options_for)
    grid = Grid(nx=n, ny=n, lx=30.0, ly=30.0,
                obstacles=(Cylinder(7.5, 15.0, 0.75),))
    params = SimulationParams(dt=0.002, viscosity=1e-4,
                              pressure_solver=solver or PressureSolver.JACOBI)
    opts = dict(ramp_up_steps=10, jacobi_tol=0.0, jacobi_iters=50,
                outer_corrector_rounds=0, early_exit=False)
    opts.update(over)
    return cfd.make_scene(grid, params,
                          solver_options_for(Semantics.RUST, **opts))


# ---------------------------------------------------------------------------
# Phases. Each returns the numbers it found and raises on a failed check.
# Sizes are arguments so the tests can run every phase small on the CPU.
# ---------------------------------------------------------------------------

def phase_reference(grid=None, steps=200, compare_steps=10):
    import jax
    import cfd_demo_jax as cfd
    scene = cfd.make_scene(grid or cfd.default_grid())
    state0 = scene.init_state()

    short = cfd.make_run(scene, compare_steps, donate=False)
    card, card_d = jax.block_until_ready(short(state0))
    host, host_d = short(jax.device_put(state0, host_cpu()))
    errs = state_errors(card, host)
    trips = {k: int(np.abs(np.asarray(getattr(card_d, k))
                           - np.asarray(getattr(host_d, k))).max())
             for k in ("p_iters", "rounds")}
    check(max(trips.values()) <= EARLY_EXIT_TRIPS,
          f"trip counts differ from the host CPU by {trips}")
    check(max(errs.values()) <= EARLY_EXIT_RTOL,
          f"fields differ from the host CPU: {errs}")

    run = cfd.make_run(scene, steps)
    (state, diags), secs = timed(run, scene.init_state())
    invariants(scene, state)
    out = rollout_numbers(scene, state, diags, secs, steps)
    out.update(grid=[scene.grid.ny, scene.grid.nx], steps=steps,
               max_rounds=int(np.asarray(diags.rounds).max()),
               vs_cpu_rel_l2=errs, vs_cpu_max_trip_diff=trips)
    return out


def phase_oracle(shape=(24, 16)):
    from cfd_demo_jax import FlowCase, Semantics
    from cfd_demo_jax.oracle.golden import (GOLDEN_L2, ORACLE_SOLVERS,
                                            golden_case, oracle_errors)
    worst = {}
    for solver in ORACLE_SOLVERS:
        for sem in (Semantics.RUST, Semantics.JS):
            for case in (FlowCase.CHANNEL, FlowCase.CAVITY):
                errs = oracle_errors(*golden_case(solver, sem, case, *shape))
                name = f"{solver.value}-{sem.value}-{case.value}"
                worst[name] = max(max(e.values()) for e in errs)
    bad = {k: v for k, v in worst.items() if not v <= GOLDEN_L2}
    check(not bad, f"golden error above {GOLDEN_L2}: {bad}")
    return {"grid": [shape[1], shape[0]], "cases": len(worst),
            "max_l2": max(worst.values()), "per_case_max_l2": worst}


def rel(got, want, scale) -> float:
    """RMS of got - want over the RMS of scale."""
    d = np.asarray(got, np.float64) - np.asarray(want, np.float64)
    return rms(d) / max(rms(scale), 1e-30)


def on_host_f64(fn, *args):
    """fn(*args) jitted on the host CPU in float64, float arguments
    widened: the same program without f32 rounding."""
    import jax

    def wide(a):
        a = np.asarray(a)
        return a.astype(np.float64) if np.issubdtype(a.dtype,
                                                     np.floating) else a

    with jax.enable_x64(True):
        args = jax.device_put(jax.tree.map(wide, args), host_cpu())
        return jax.block_until_ready(jax.jit(fn)(*args))


def exact_solve(r_int, n: int, h: float):
    """The n^2 channel's pressure operator solved exactly in float64
    numpy: fast diagonalization with eigh of the 1-D operators."""
    from cfd_demo_jax.ops.fdm import _t1d
    ly, qy = np.linalg.eigh(_t1d(n - 2, h, False, 0.0))
    lx, qx = np.linalg.eigh(_t1d(n - 2, h, True, h))
    return -(qy @ ((qy.T @ r_int @ qx) / (ly[:, None] + lx[None, :]))
             @ qx.T)


def fdm_check(n: int) -> dict:
    """One FDM solve of the n^2 channel's operator on a seeded rhs: its
    residual in eps * (denom max|e| + max|r|) and its relative L2
    distance to the exact solve, and the host CPU's distance."""
    import jax
    import jax.numpy as jnp
    from cfd_demo_jax.ops.fdm import fdm_solve_interior
    from cfd_demo_jax.ops.poisson import _apply_pprime_bcs, _mg_residual
    h = 30.0 / n
    r_int = np.random.default_rng(0).standard_normal((n - 2, n - 2))
    r = jnp.asarray(np.pad(r_int, 1), jnp.float32)
    exact = exact_solve(np.asarray(r, np.float64)[1:-1, 1:-1], n, h)

    def fdm(r):
        e = fdm_solve_interior(r[1:-1, 1:-1], h, h, east_dirichlet=True,
                               d_wall=h)
        p = _apply_pprime_bcs(jnp.pad(e, 1))
        return e, p, jnp.max(jnp.abs(_mg_residual(p, r, h, h)))

    e, p, res = jax.block_until_ready(jax.jit(fdm)(r))
    host_e = jax.jit(fdm)(jax.device_put(r, host_cpu()))[0]
    scale = (4.0 / h ** 2) * float(jnp.max(jnp.abs(p))) + float(
        jnp.max(jnp.abs(r)))
    return {"max_residual": float(res),
            "eps_multiple": float(res) / (
                float(np.finfo(np.float32).eps) * scale),
            "vs_exact_rel_l2": rel(e, exact, exact),
            "host_cpu_vs_exact_rel_l2": rel(host_e, exact, exact)}


def mg_operator_errors(n: int, opts) -> dict:
    """Card vs host CPU, relative L2, of each linear operator of
    MG_PRODUCTION's aligned hierarchy on the n^2 channel, on random
    operands: the finest level's BC'd smoother and residual; at every
    coarse level the restriction into it, the prolongation out of it,
    and its folded sweeps and residual, or the bottom FDM solve. The
    worst level per operator."""
    import jax
    from cfd_demo_jax.ops import poisson as ps
    from cfd_demo_jax.ops.fdm import fdm_solve_interior
    rng = np.random.default_rng(1)
    rand = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    h, omega, nu = 30.0 / n, opts.jacobi_omega, opts.mgp_smooth
    worst = {}

    def compare(name, fn, *args):
        card = jax.jit(fn)(*args)
        host = jax.jit(fn)(*jax.device_put(args, host_cpu()))
        worst[name] = max(worst.get(name, 0.0), rel(card, host, host))

    compare("smooth", lambda p, r: ps._mgp_smooth(
        p, r, h, h, omega, nu, ps._apply_pprime_bcs), rand(n, n),
        rand(n, n))
    compare("residual", lambda p, r: ps._mg_residual(p, r, h, h),
            rand(n, n), rand(n, n))
    shape, dx, d = (n - 2, n - 2), h, h        # the interior unknowns
    while True:
        fine, shape = shape, tuple(ps._cc_coarse_size(m) for m in shape)
        compare("restrict", ps._cc_restrict, rand(*fine))
        compare("prolong", lambda c, f=fine: ps._cc_prolong(
            c, f[0], f[1], True), rand(*shape))
        d, dx = d + dx / 2, 2 * dx             # as _cc_vcycle recurses
        if max(shape) <= opts.mgp_coarse_stop:
            compare("bottom_fdm", lambda r, dx=dx, d=d: fdm_solve_interior(
                r, dx, dx, True, d), rand(*shape))
            return worst
        compare("sweeps", lambda p, r, dx=dx, d=d: ps._cc_sweeps(
            p, r, dx, dx, omega, nu, True, d), rand(*shape), rand(*shape))
        compare("residual_cc", lambda p, r, dx=dx, d=d: ps._cc_residual(
            p, r, dx, dx, True, d), rand(*shape), rand(*shape))


def mg_check(n: int, cycles: int = 4) -> dict:
    """MG_PRODUCTION's aligned V-cycle on the n^2 channel's operator,
    from zero on a seeded rhs, on the card, on the host CPU and on the
    host in float64 (the same cycles without f32 rounding). Per cycle:
    each f32 iterate's relative L2 distance to the float64 one, the
    card-host gap, and the float64 iterate's distance to the exact
    solve (what the cycles leave unsolved). Plus the per-operator
    card-host comparison of mg_operator_errors."""
    import jax
    import jax.numpy as jnp
    from cfd_demo_jax import Semantics, solver_options_for
    from cfd_demo_jax.ops.poisson import (_apply_pprime_bcs,
                                          _mgp_vcycle_aligned)
    h = 30.0 / n
    opts = solver_options_for(Semantics.RUST)
    r_int = np.random.default_rng(0).standard_normal((n - 2, n - 2))
    r = np.pad(r_int, 1).astype(np.float32)
    exact = exact_solve(r[1:-1, 1:-1].astype(np.float64), n, h)

    def iterates(r):
        p, out = _apply_pprime_bcs(jnp.zeros_like(r)), []
        for _ in range(cycles):
            p, _ = _mgp_vcycle_aligned(p, r, h, h, opts, _apply_pprime_bcs)
            out.append(p[1:-1, 1:-1])
        return jnp.stack(out)

    card = np.asarray(jax.jit(iterates)(jnp.asarray(r)))
    host = np.asarray(jax.jit(iterates)(jax.device_put(r, host_cpu())))
    f64 = np.asarray(on_host_f64(iterates, r))
    per_cycle = [{"card_vs_f64": rel(c, w, w), "host_vs_f64": rel(o, w, w),
                  "card_vs_host": rel(c, o, w),
                  "f64_vs_exact": rel(w, exact, exact)}
                 for c, o, w in zip(card, host, f64)]
    return {"grid": [n, n], "cycles": per_cycle,
            "ops_card_vs_host": mg_operator_errors(n, opts)}


def mg_failures(name: str, mg: dict) -> list:
    """Every operator within OP_RTOL of the host CPU (the bottom solve
    within FIXED_RTOL); the first cycle within FIXED_RTOL of float64 on
    both devices; the last cycle's card no further from float64 than
    F32_SPREAD times the host's."""
    limit = lambda op: FIXED_RTOL if op == "bottom_fdm" else OP_RTOL
    bad = [f"{name} {op}: card vs host CPU {err:.3g} > {limit(op)}"
           for op, err in mg["ops_card_vs_host"].items()
           if not err <= limit(op)]
    first, last = mg["cycles"][0], mg["cycles"][-1]
    for dev in ("card", "host"):
        if not first[f"{dev}_vs_f64"] <= FIXED_RTOL:
            bad.append(f"{name}: one V-cycle on the {dev} differs from "
                       f"float64 by {first[f'{dev}_vs_f64']:.3g}")
    if not last["card_vs_f64"] <= F32_SPREAD * last["host_vs_f64"]:
        bad.append(f"{name}: {len(mg['cycles'])} V-cycles on the card "
                   f"further from float64 than the host CPU: {last}")
    return bad


def phase_headline(n=2048, steps=10, mg_sizes=(2048, 259)):
    """The 2048^2 rollouts, plus the FDM solve check at n and the
    multigrid checks at each of mg_sizes (259: odd interiors, whose
    coarsening pads or aggregates)."""
    import jax
    import cfd_demo_jax as cfd
    from cfd_demo_jax import PressureSolver
    out = {"grid": [n, n], "steps": steps}
    failures = []
    for name, solver in (("jacobi50", PressureSolver.JACOBI),
                         ("mg_production", PressureSolver.MG_PRODUCTION),
                         ("fdm", PressureSolver.FDM)):
        scene = fast_scene(n, solver)
        run = cfd.make_run(scene, steps, donate=False)
        (state, diags), secs = timed(run, scene.init_state())
        invariants(scene, state)
        res = rollout_numbers(scene, state, diags, secs, steps)
        res["res_p_last"] = float(np.asarray(diags.res_p)[-1])
        # The same program on the host CPU. The fixed Jacobi schedule is
        # held to FIXED_RTOL; MG and FDM amplify f32 rounding (PERF.md),
        # so each device is measured against a float64 run instead.
        # (The Jacobi run gates the rest of the step: predictor,
        # divergence, corrector and BCs are the same code.)
        host, host_d = run(jax.device_put(scene.init_state(), host_cpu()))
        res["vs_cpu_rel_l2"] = errs = state_errors(state, host)
        if solver == PressureSolver.JACOBI:
            if not max(errs.values()) <= FIXED_RTOL:
                failures.append(f"{name}: fields differ from the host CPU")
        else:
            f64, _ = on_host_f64(run, scene.init_state())
            card64, host64 = state_errors(state, f64), state_errors(host, f64)
            res["card_vs_f64"], res["host_cpu_vs_f64"] = card64, host64
            limit = (FDM_ROLLOUT_VS_F64 if solver == PressureSolver.FDM
                     else F32_SPREAD * max(host64.values()))
            if not max(card64.values()) <= limit:
                failures.append(f"{name}: card {max(card64.values()):.3g} "
                                f"from float64, limit {limit:.3g}")
        if solver == PressureSolver.MG_PRODUCTION:
            trips = int(np.abs(np.asarray(diags.p_iters)
                               - np.asarray(host_d.p_iters)).max())
            res["vs_cpu_max_trip_diff"] = trips
            if not trips <= EARLY_EXIT_TRIPS:
                failures.append(f"{name}: cycle counts differ from the "
                                f"host CPU by {trips}")
            if not int(np.asarray(diags.p_iters).max()) < \
                    scene.opts.mgp_max_cycles:
                failures.append(f"{name} hit its cycle cap")
        out[name] = res
    out["fdm_solve"] = fdm = fdm_check(n)
    if not (fdm["eps_multiple"] <= FDM_FLOOR_EPS
            and fdm["vs_exact_rel_l2"] <= FIXED_RTOL):
        failures.append("FDM solve above the f32 noise floor")
    for m in mg_sizes:
        out[f"mg_solve_{m}"] = mg = mg_check(m)
        failures += mg_failures(f"mg_solve_{m}", mg)
    check(not failures, f"{failures}; measured {out}")
    return out


def phase_large(n=8192, steps=3):
    import cfd_demo_jax as cfd
    scene = fast_scene(n)
    run = cfd.make_run(scene, steps)
    (state, diags), secs = timed(run, scene.init_state())
    invariants(scene, state)
    out = rollout_numbers(scene, state, diags, secs, steps)
    out.update(grid=[n, n], steps=steps)
    return out


def _ensemble(batch, nx, ny):
    from cfd_demo_jax import Cylinder, Grid, SimulationParams
    from cfd_demo_jax.apps.ensemble import build_ensemble
    grid = Grid(nx=nx, ny=ny, lx=30.0, ly=10.0,
                obstacles=(Cylinder(7.5, 5.0, 0.75),))
    return build_ensemble(grid, SimulationParams(dt=0.004, viscosity=1e-4),
                          batch)


def _scene_state(batched, k):
    import jax
    return jax.tree.map(lambda x: x[k], batched)


def phase_ensemble(batch=64, nx=256, ny=96, steps=20, compare=4):
    import cfd_demo_jax as cfd
    from cfd_demo_jax.apps.ensemble import make_ensemble_run
    scene, batched0 = _ensemble(batch, nx, ny)
    run = make_ensemble_run(scene, steps)
    batched, secs = timed(run, batched0)
    single = cfd.make_run(scene, steps, donate=False)
    worst = 0.0
    for k in np.linspace(0, batch - 1, compare).astype(int):
        ref, _ = single(_scene_state(batched0, int(k)))
        got = _scene_state(batched, int(k))
        invariants(scene, got)
        errs = state_errors(got, ref)
        check(max(errs.values()) <= EARLY_EXIT_RTOL,
              f"scene {k}: batched differs from unbatched: {errs}")
        worst = max(worst, max(errs.values()))
    return {"batch": batch, "grid": [ny, nx], "steps": steps,
            "scene_steps_per_s": batch * steps / secs,
            "cell_updates_per_s": batch * steps * nx * ny / secs,
            "scenes_compared": compare, "max_rel_l2_vs_unbatched": worst,
            "peak_bytes_in_use": peak_bytes()}


def dispatched(step, state, steps: int):
    """(state after ``steps`` calls of ``step``, steps/s of calls 2 on):
    one dispatch per step, the first (compiling) call untimed. The
    sharded phases time one card and four cards this same way."""
    import jax
    state, _ = jax.block_until_ready(step(state))
    t0 = time.perf_counter()
    for _ in range(steps - 1):
        state, _ = step(state)
    state = jax.block_until_ready(state)
    return state, (steps - 1) / (time.perf_counter() - t0)


def phase_rows(n=8192, steps=3, cards=4):
    import jax
    import cfd_demo_jax as cfd
    from cfd_demo_jax.shard.mesh import (make_mesh, make_sharded_step,
                                         shard_state)
    scene = fast_scene(n)
    one, one_rate = dispatched(cfd.make_step(scene, donate=False),
                               scene.init_state(), steps)
    mesh = make_mesh(jax.devices()[:cards])
    got, rate = dispatched(make_sharded_step(scene, mesh),
                           shard_state(scene.init_state(), mesh), steps)
    errs = state_errors(got, one)
    check(max(errs.values()) <= FIXED_RTOL,
          f"row-sharded fields differ from one card: {errs}")
    return {"grid": [n, n], "cards": cards, "steps": steps,
            "sharded_steps_per_s": rate, "one_card_steps_per_s": one_rate,
            "vs_one_card_rel_l2": errs}


def phase_batch(batch=64, nx=256, ny=96, steps=20, cards=4):
    import jax
    from functools import partial
    from cfd_demo_jax.shard.mesh import (make_batch_sharded_step,
                                         make_mesh, shard_batch)
    from cfd_demo_jax.solver.piso import step_fn
    scene, batched0 = _ensemble(batch, nx, ny)
    ref, one_rate = dispatched(jax.jit(jax.vmap(partial(step_fn, scene))),
                               batched0, steps)
    mesh = make_mesh(jax.devices()[:cards], axis="b")
    got, rate = dispatched(make_batch_sharded_step(scene, mesh),
                           shard_batch(batched0, mesh), steps)
    errs = state_errors(got, ref)
    check(max(errs.values()) <= EARLY_EXIT_RTOL,
          f"batch-sharded ensemble differs from unsharded: {errs}")
    return {"batch": batch, "grid": [ny, nx], "cards": cards,
            "steps": steps, "sharded_scene_steps_per_s": batch * rate,
            "one_card_scene_steps_per_s": batch * one_rate,
            "vs_unsharded_rel_l2": errs}


PHASES = {"reference": phase_reference, "oracle": phase_oracle,
          "headline": phase_headline, "large": phase_large,
          "ensemble": phase_ensemble, "rows": phase_rows,
          "batch": phase_batch}


def select_phases(cards: int):
    """Phase names to run: the one-card set, or with --cards 4 the
    four-card set only."""
    return FOUR_CARDS if cards == 4 else ONE_CARD


def result_line(devices) -> str:
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}})


def run_phases(names, phases=PHASES, out=sys.stdout) -> int:
    """Run each phase, print its line; the number of failed phases."""
    failed = 0
    for name in names:
        t0 = time.perf_counter()
        try:
            res = phases[name]()
        except Exception as e:  # noqa: BLE001 -- report, keep going
            failed += 1
            traceback.print_exc()
            print(f"phase {name} FAILED {type(e).__name__}: {e}",
                  file=out, flush=True)
            continue
        res["seconds"] = time.perf_counter() - t0
        print(f"phase {name} {json.dumps(res, default=float)}", file=out,
              flush=True)
    return failed


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip()


def gpu_devices() -> list:
    """The GPUs JAX sees, [] without one. The host CPU backend is the
    reference of several phases, so it is kept beside whatever platform
    the environment selects."""
    plat = os.environ.get("JAX_PLATFORMS", "")
    if plat and "cpu" not in plat.split(","):
        os.environ["JAX_PLATFORMS"] = plat + ",cpu"
    import jax
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        return []
    return gpus if jax.default_backend() == "gpu" else []


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the sharded phases, on four GPUs")
    args = ap.parse_args(argv)
    names = select_phases(args.cards)

    gpus = gpu_devices()
    if not gpus:
        print("chip_smoke: no GPU found", file=sys.stderr)
        return 2
    if len(gpus) < args.cards:
        print(f"chip_smoke: {args.cards} GPUs needed, {len(gpus)} found",
              file=sys.stderr)
        return 2

    from cfd_demo_jax.runtime.compile_cache import enable_compile_cache
    enable_compile_cache()
    if run_phases(names):
        return 1
    print(card_line(), flush=True)
    print(result_line(gpus), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
