"""Drag-coefficient-vs-Reynolds curve from ONE vmapped ensemble.

The showcase of batch parallelism + force diagnostics: B
cylinder scenes spanning a Reynolds range run as a single batched
program (the pure step vmaps for free, SURVEY.md section 2.7), each
scene accumulating its own control-volume drag (ops/forces.py) inside
the scan. One run produces the classic C_d(Re) curve.

    python -m cfd_demo_jax.apps.cd_curve --res 10,20,35,50,75,100,150,200

Expected physics: C_d decreases monotonically over Re = 10..200
(unbounded literature: ~2.8 at Re=10 down to ~1.3 at Re=200); the 15%
channel blockage and first-order upwind shift the curve up but keep
the trend (docs/VALIDATION.md).
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from functools import partial

import numpy as np

from .. import (Grid, Cylinder, Semantics, SimulationParams, make_scene,
                solver_options_for)
from ..solver.piso import step_fn
from ..runtime.compile_cache import enable_compile_cache


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--res", default="10,20,35,50,75,100,150,200",
                    help="comma-separated Reynolds numbers (one scene each)")
    ap.add_argument("--nx", type=int, default=400)
    ap.add_argument("--ny", type=int, default=132)
    ap.add_argument("--settle", type=int, default=4000)
    ap.add_argument("--measure", type=int, default=2000)
    ap.add_argument("--chunk", type=int, default=1000)
    ap.add_argument("--dt", type=float, default=0.004)
    args = ap.parse_args(argv)
    enable_compile_cache()

    import jax
    import jax.numpy as jnp
    from ..ops.forces import (control_volume_force, default_control_volume,
                              drag_lift_coefficients, physical_pressure)

    res = np.array([float(r) for r in args.res.split(",")], np.float32)
    B = len(res)
    D, U = 1.5, 1.0
    nus = (U * D / res).astype(np.float32)

    grid = Grid(nx=args.nx, ny=args.ny, lx=30.0, ly=10.0,
                obstacles=(Cylinder(7.5, 5.0, 0.75),))
    scene = make_scene(
        grid, SimulationParams(dt=args.dt, viscosity=1e-4),
        solver_options_for(Semantics.RUST, early_exit=False))
    cv = default_control_volume(grid)
    base = scene.init_state()
    batched = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                           base)
    batched = dataclasses.replace(batched, nu=jnp.asarray(nus))

    vstep = jax.vmap(partial(step_fn, scene))

    def settle_chunk(s):
        def body(s, _):
            s2, _ = vstep(s)
            return s2, None
        return jax.lax.scan(body, s, None, length=args.chunk)[0]

    def measure_chunk(s):
        """Scan that also accumulates each scene's mean (C_d, C_l)."""
        def body(carry, _):
            s, acc_fx, acc_fy = carry
            p_prev, u_prev, v_prev = s.p, s.u, s.v
            s2, d = vstep(s)
            P = jax.vmap(physical_pressure)(p_prev, s2.p, d.substeps)
            fx, fy = jax.vmap(
                lambda u_, v_, P_, nu_, up_, vp_, dt_:
                    control_volume_force(u_, v_, P_, nu_, grid, cv,
                                         u_prev=up_, v_prev=vp_, dt=dt_)
            )(s2.u, s2.v, P, s2.nu, u_prev, v_prev, d.dt)
            return (s2, acc_fx + fx, acc_fy + fy), None
        z = jnp.zeros((B,), jnp.float32)
        (s, fx_sum, fy_sum), _ = jax.lax.scan(body, (s, z, z), None,
                                              length=args.chunk)
        return s, fx_sum / args.chunk, fy_sum / args.chunk

    settle = jax.jit(settle_chunk)
    measure = jax.jit(measure_chunk)

    t0 = time.perf_counter()
    done = 0
    while done < args.settle:
        batched = settle(batched)
        _ = float(batched.res_u[0])
        done += args.chunk
        print(f"settle {done}/{args.settle} "
              f"({time.perf_counter() - t0:.0f}s)", flush=True)
    fx_means, fy_means = [], []
    done = 0
    while done < args.measure:
        batched, fxm, fym = measure(batched)
        _ = float(batched.res_u[0])
        fx_means.append(np.asarray(fxm))
        fy_means.append(np.asarray(fym))
        done += args.chunk
        print(f"measure {done}/{args.measure} "
              f"({time.perf_counter() - t0:.0f}s)", flush=True)
    fx = np.mean(fx_means, axis=0)
    fy = np.mean(fy_means, axis=0)
    cd, cl = drag_lift_coefficients(fx, fy, U, D)
    assert np.isfinite(cd).all()
    print(f"{'Re':>8} {'C_d':>8} {'C_l_mean':>9}")
    for r, c, l in zip(res, cd, cl):
        print(f"{r:>8.0f} {c:>8.3f} {l:>+9.3f}")
    drop = np.all(np.diff(cd) < 0.15)  # near-monotone decrease
    print("C_d decreases with Re (trend):", bool(drop))
    return 0


if __name__ == "__main__":
    sys.exit(main())
