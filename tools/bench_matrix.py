#!/usr/bin/env python
"""Bench every grid size x solver combination with scan-fused timing
(run on the GPU): cell-updates/s and ms/step of the fixed-schedule
fast step, ended with block_until_ready. Refuses to run on the CPU.

    python tools/bench_matrix.py [--quick]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def bench_case(n, steps, pressure_solver="jacobi"):
    import jax
    import cfd_demo_jax as cfd
    from cfd_demo_jax import (Cylinder, Grid, PressureSolver, Semantics,
                              SimulationParams, solver_options_for)
    grid = Grid(nx=n, ny=n, lx=30.0, ly=30.0,
                obstacles=(Cylinder(7.5, 15.0, 0.75),))
    params = SimulationParams(dt=0.002, viscosity=1e-4,
                              pressure_solver=PressureSolver(pressure_solver))
    opts = solver_options_for(
        Semantics.RUST, ramp_up_steps=10, jacobi_tol=0.0, jacobi_iters=50,
        outer_corrector_rounds=0, early_exit=False)
    scene = cfd.make_scene(grid, params, opts)
    run = cfd.make_run(scene, steps)
    state, _ = jax.block_until_ready(run(scene.init_state()))
    t0 = time.perf_counter()
    state, _ = jax.block_until_ready(run(state))
    dt = time.perf_counter() - t0
    assert np.isfinite(np.asarray(state.res_u)).all()
    return n * n * steps / dt, dt / steps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="2048^2 only")
    ap.add_argument("--solvers",
                    default="jacobi,sor,multigrid,mg-production,fdm",
                    help="comma list")
    ap.add_argument("--sizes", default="512,1024,2048,4096,8192,16384",
                    help="comma list of grid edges")
    args = ap.parse_args()

    import jax
    from cfd_demo_jax.runtime.compile_cache import enable_compile_cache
    if jax.default_backend() == "cpu":
        print("bench_matrix: no accelerator found", file=sys.stderr)
        return 1
    enable_compile_cache()
    d = jax.devices()[0]
    print(f"device: {d.platform} {d.device_kind} x{len(jax.devices())}")
    steps_for = {512: 400, 1024: 200, 2048: 50, 4096: 20,
                 8192: 10, 16384: 5}
    cases = [(n, steps_for.get(n, 10))
             for n in (int(s) for s in args.sizes.split(","))]
    if args.quick:
        cases = [(2048, 50)]
    print(f"{'grid':>6} {'solver':>14} {'cu/s':>10} {'ms/step':>9}")
    for n, steps in cases:
        for solver in args.solvers.split(","):
            try:
                rate, per = bench_case(n, steps, solver)
                print(f"{n:>6} {solver:>14} {rate/1e9:>9.3f}e9 "
                      f"{per*1e3:>8.2f}", flush=True)
            except Exception as e:
                print(f"{n:>6} {solver:>14}   FAIL "
                      f"{type(e).__name__}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
