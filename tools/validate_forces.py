#!/usr/bin/env python
"""Force validation: cylinder at Re=100 -> mean C_d + Strouhal from
the lift series (docs/VALIDATION.md). Run on the GPU.

    python tools/validate_forces.py [--steps 20000] [--warmup 4000]

Scene: the reference's default channel geometry (800x264, D=1.5 at
(7.5, 5), U=1) with nu = U D / Re. Blockage D/Ly = 0.15 and the
first-order upwind scheme both bias C_d/St high vs unbounded
literature (C_d ~ 1.33, St ~ 0.164 at Re=100); see the VALIDATION
entry for the recorded values.

Forces are computed INSIDE the scan (zero extra dispatches): the
physical pressure is the per-step increment of the stored accumulator
p (ops.forces.physical_pressure), and the unsteady CV term uses the
step-entry fields.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--re", type=float, default=100.0)
    ap.add_argument("--square", action="store_true",
                    help="square obstacle (side 1.5) instead of the cylinder")
    ap.add_argument("--scheme", default="first",
                    help="convection scheme: first|second|quick")
    ap.add_argument("--solver", default="jacobi",
                    help="pressure solver: jacobi|sor|multigrid|"
                         "mg-production (validates the production "
                         "projection reproduces the same physics)")
    ap.add_argument("--grid", default=None, metavar="NXxNY",
                    help="override the 800x264 default (same 30x10 "
                         "domain), e.g. 1600x528 for a D/dx=80 "
                         "grid-convergence point")
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--warmup", type=int, default=4000)
    ap.add_argument("--chunk", type=int, default=2000)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    from functools import partial
    import cfd_demo_jax as cfd
    from cfd_demo_jax import Semantics, SimulationParams, solver_options_for
    from cfd_demo_jax.ops.forces import (control_volume_force,
                                         default_control_volume,
                                         drag_lift_coefficients,
                                         physical_pressure)
    from cfd_demo_jax.solver.piso import step_fn

    grid = cfd.default_grid()              # 800x264, r=0.75 at (7.5, 5)
    if args.grid:
        import dataclasses
        nx, ny = (int(t) for t in args.grid.lower().split("x"))
        grid = dataclasses.replace(grid, nx=nx, ny=ny)
    D, U = 1.5, 1.0
    if args.square:
        from cfd_demo_jax import Box, Grid
        grid = Grid(nx=grid.nx, ny=grid.ny, lx=grid.lx, ly=grid.ly,
                    obstacles=(Box(7.5, 5.0, 0.75, 0.75),))
    nu = U * D / args.re
    from cfd_demo_jax import PressureSolver, VelocityScheme
    scene = cfd.make_scene(
        grid, SimulationParams(dt=0.004, viscosity=nu,
                               velocity_scheme=VelocityScheme(args.scheme),
                               pressure_solver=PressureSolver(args.solver)),
        solver_options_for(Semantics.RUST))
    cv = default_control_volume(grid, margin=1.5)
    print(f"Re={args.re} nu={nu:.4g} cv={cv} "
          f"D/dx={D/grid.dx:.0f} blockage={D/grid.ly:.2f}", flush=True)

    def body(s, _):
        p_prev, u_prev, v_prev = s.p, s.u, s.v
        s2, d = step_fn(scene, s)
        P = physical_pressure(p_prev, s2.p, d.substeps)
        fx, fy = control_volume_force(
            s2.u, s2.v, P, s2.nu, scene.grid, cv,
            u_prev=u_prev, v_prev=v_prev, dt=d.dt)
        return s2, (d.t, d.dt, fx, fy)

    @jax.jit
    def chunk(s):
        return jax.lax.scan(body, s, None, length=args.chunk)

    state = scene.init_state()
    t0 = time.perf_counter()
    # Round UP to whole chunks (one compiled chunk program, no
    # remainder recompile): silently truncating with // would
    # measure a shorter, less-settled series than requested and change
    # the Strouhal bin width.
    n_chunks_w = -(-args.warmup // args.chunk)
    n_chunks_m = -(-args.steps // args.chunk)
    warmup_total = n_chunks_w * args.chunk
    measure_total = n_chunks_m * args.chunk
    if (warmup_total, measure_total) != (args.warmup, args.steps):
        print(f"note: rounding to whole {args.chunk}-step chunks: "
              f"warmup {warmup_total}, measure {measure_total}",
              flush=True)
    for i in range(n_chunks_w):
        state, _ = jax.block_until_ready(chunk(state))
        print(f"warmup {(i + 1) * args.chunk}/{warmup_total} "
              f"({time.perf_counter() - t0:.0f}s)", flush=True)
    ts, dts, fxs, fys = [], [], [], []
    for i in range(n_chunks_m):
        state, (t, dt, fx, fy) = jax.block_until_ready(chunk(state))
        ts.append(np.asarray(t)); dts.append(np.asarray(dt))
        fxs.append(np.asarray(fx)); fys.append(np.asarray(fy))
        print(f"measure {(i + 1) * args.chunk}/{measure_total} "
              f"({time.perf_counter() - t0:.0f}s)", flush=True)
    t = np.concatenate(ts); dt = np.concatenate(dts)
    fx = np.concatenate(fxs); fy = np.concatenate(fys)
    cd, cl = drag_lift_coefficients(fx, fy, U, D)
    assert np.isfinite(cd).all() and np.isfinite(cl).all()

    # Strouhal: dominant frequency of C_l on the (nearly uniform) time
    # grid; drop the mean.
    dt_mean = float(dt.mean())
    clz = cl - cl.mean()
    spec = np.abs(np.fft.rfft(clz * np.hanning(len(clz))))
    freqs = np.fft.rfftfreq(len(clz), d=dt_mean)
    k = 1 + int(spec[1:].argmax())
    # Parabolic interpolation of the log-magnitude peak refines the
    # frequency well below the bin width (the series is ~80 time units,
    # so raw bins are Delta-St ~ 0.02 wide).
    if 1 <= k < len(spec) - 1:
        a, b, c = np.log(spec[k - 1] + 1e-30), np.log(spec[k] + 1e-30), \
            np.log(spec[k + 1] + 1e-30)
        delta = 0.5 * (a - c) / (a - 2 * b + c)
    else:
        delta = 0.0
    f_shed = (k + delta) * (freqs[1] - freqs[0])
    St = f_shed * D / U
    half = len(cd) // 2
    print(f"mean C_d (2nd half) = {cd[half:].mean():.3f}  "
          f"C_l RMS = {np.sqrt((clz[half:] ** 2).mean()):.3f}  "
          f"St = {St:.3f}  (dt_mean {dt_mean:.4g})", flush=True)
    out = {"Re": args.re, "Cd_mean": float(cd[half:].mean()),
           "Cl_rms": float(np.sqrt((clz[half:] ** 2).mean())),
           "St": float(St)}
    print(out, flush=True)


if __name__ == "__main__":
    main()
