#!/usr/bin/env python
"""Headline benchmark: cell-updates/s of one scan-fused rollout.

One cell-update = one pressure cell advanced through one full PISO
substep (predictor + pressure solve + corrector + BCs). Runs on the
accelerator only: with no accelerator it exits non-zero.

Prints the device (platform, device_kind, count) and XLA_FLAGS on one
line, then ONE JSON line: {"metric", "value", "unit", "device"}.

    python bench.py [--n 2048] [--mode fast|reference|production|fdm|sor]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=20,
                    help="steps per timed scan")
    ap.add_argument("--warmup", type=int, default=5)
    ap.add_argument("--mode",
                    choices=["fast", "reference", "production", "fdm",
                             "sor"],
                    default="fast",
                    help="fast: fixed 50-iter Jacobi, 1 substep (deterministic "
                         "cost); reference: full Rust semantics incl. outer "
                         "corrector rounds; production: MG_PRODUCTION "
                         "projection (divergence-calibrated V-cycles, "
                         "docs/SPEC.md item 12); fdm: exact direct "
                         "projection (docs/SPEC.md item 13); sor: fixed "
                         "50-iter red/black SOR")
    ap.add_argument("--mgp-scheme", choices=["auto", "aligned", "legacy"],
                    default="auto",
                    help="production mode only: coarse-hierarchy scheme "
                         "(docs/SPEC.md item 12; auto is aligned)")
    ap.add_argument("--mgp-rtol", type=float, default=0.0,
                    help="production mode only: relative-reduction exit "
                         "(max|r| <= rtol * warm-start residual, combined "
                         "with the absolute div-calibrated tol)")
    args = ap.parse_args()

    import jax
    import cfd_demo_jax as cfd
    from cfd_demo_jax import (Cylinder, Grid, PressureSolver, Semantics,
                              SimulationParams, solver_options_for)
    from cfd_demo_jax.runtime.compile_cache import enable_compile_cache

    if jax.default_backend() == "cpu":
        print("bench.py: no accelerator found; refusing to time the CPU",
              file=sys.stderr)
        return 1
    enable_compile_cache()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    print(f"device: {json.dumps(device)} "
          f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}", flush=True)

    n = args.n
    grid = Grid(nx=n, ny=n, lx=30.0, ly=30.0,
                obstacles=(Cylinder(7.5, 15.0, 0.75),))
    fixed = dict(jacobi_tol=0.0, jacobi_iters=50, outer_corrector_rounds=0,
                 early_exit=False)
    solver, extra = {
        "fast": (PressureSolver.JACOBI, fixed),
        "sor": (PressureSolver.SOR, fixed),
        "production": (PressureSolver.MG_PRODUCTION,
                       dict(outer_corrector_rounds=0,
                            mgp_rtol=args.mgp_rtol,
                            mgp_scheme=args.mgp_scheme)),
        "fdm": (PressureSolver.FDM, dict(outer_corrector_rounds=0)),
        "reference": (PressureSolver.JACOBI, {}),
    }[args.mode]
    params = SimulationParams(dt=0.002, viscosity=1e-4,
                              pressure_solver=solver)
    opts = solver_options_for(Semantics.RUST, ramp_up_steps=10, **extra)
    scene = cfd.make_scene(grid, params, opts)

    state = scene.init_state()
    run_w = cfd.make_run(scene, args.warmup)
    run = cfd.make_run(scene, args.steps)
    state, _ = run_w(state)
    state, _ = jax.block_until_ready(run(state))  # compile + first timed shape
    t0 = time.perf_counter()
    state, _ = jax.block_until_ready(run(state))
    dt = time.perf_counter() - t0

    assert np.isfinite(np.asarray(state.u)).all(), "non-finite fields"
    cell_updates = n * n * args.steps / dt
    result = {
        "metric": f"cell-updates/s at {n}^2 ({args.mode} PISO substep)",
        "value": cell_updates,
        "unit": "cell-updates/s",
        "device": device,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
