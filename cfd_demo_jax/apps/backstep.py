"""Backward-facing step: reattachment length vs Reynolds number.

Literature validation case beyond the reference's demos (the solver
core is unchanged -- model.rs:600-900 semantics; the scene composes
the Box obstacle with the PARABOLIC_UPPER sudden-expansion inlet,
docs/SPEC.md addition). Expansion ratio 2: inlet channel occupies the
upper half-height, step height S = H/2; a short solid step
(``--step-len``) makes the lower-left corner a true no-slip wall.

Reynolds convention follows Armaly et al. (1983, J. Fluid Mech. 127):
Re = U_mean * D_h / nu with D_h = 2 * h_inlet = H, U_mean = 2/3 of the
parabola peak. Expected laminar reattachment lengths x_r/S (measured
from the step face): ~3.0 at Re=100, ~5.2 at Re=200, ~8.5 at Re=400
(2-D simulations track the experiment up to Re~400, e.g. Biswas,
Breuer & Durst 2004).

    python -m cfd_demo_jax.apps.backstep --res 100,200,300,400

All Reynolds numbers run as ONE vmapped batch (SURVEY.md section 2.7
batch parallelism), like apps/cd_curve.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from functools import partial

import numpy as np

from .. import (Box, Grid, InletProfile, Semantics, SimulationParams,
                make_scene, solver_options_for)
from ..solver.piso import step_fn
from ..runtime.compile_cache import enable_compile_cache


def backstep_grid(nx: int, ny: int, lx: float, step_len: float) -> Grid:
    """H = 1 channel with a solid step filling the lower-left corner
    (height S = 0.5, length ``step_len``)."""
    return Grid(nx=nx, ny=ny, lx=lx, ly=1.0,
                obstacles=(Box(center_x=step_len / 2.0, center_y=0.25,
                               half_w=step_len / 2.0, half_h=0.25),))


def reattachment_length(u: np.ndarray, grid: Grid, step_len: float) -> float:
    """x_r/S from the bottom-wall shear sign: the last downstream zero
    crossing of u one row above the wall (u[0,:] is the no-slip row, so
    sign(u[1,:]) tracks sign(du/dy|wall)), linearly interpolated."""
    dx = grid.lx / grid.nx
    xs = np.arange(grid.nx + 1) * dx            # u face positions
    row = np.asarray(u[1, :], np.float64)
    after = xs > step_len + dx                  # clear of the step face
    neg = (row < 0) & after
    if not neg.any():
        return float("nan")                     # no recirculation seen
    i = int(np.nonzero(neg)[0][-1])             # last reversed-flow face
    if i + 1 >= row.size:
        return float("nan")                     # bubble reaches outlet
    # zero crossing between faces i and i+1
    x0 = xs[i] + dx * (-row[i]) / (row[i + 1] - row[i])
    S = 0.5
    return (x0 - step_len) / S


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--res", default="100,200,300,400",
                    help="comma-separated Reynolds numbers (one scene each)")
    ap.add_argument("--nx", type=int, default=1200)
    ap.add_argument("--ny", type=int, default=80)
    ap.add_argument("--lx", type=float, default=15.0)
    ap.add_argument("--step-len", type=float, default=0.1)
    ap.add_argument("--steps", type=int, default=20000)
    ap.add_argument("--chunk", type=int, default=2000)
    ap.add_argument("--dt", type=float, default=0.004)
    ap.add_argument("--scheme", choices=["first", "second", "quick"],
                    default="second",
                    help="convection scheme (second-order closes the "
                         "upwind-diffusion gap to the literature, like "
                         "the cylinder-drag validation)")
    args = ap.parse_args(argv)
    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    res = np.array([float(r) for r in args.res.split(",")], np.float32)
    B = len(res)
    # Re = U_mean * H / nu, U_mean = (2/3) * peak; peak = 1.
    nus = (2.0 / (3.0 * res)).astype(np.float32)

    from ..core.config import VelocityScheme
    scheme = {"first": VelocityScheme.FIRST, "second": VelocityScheme.SECOND,
              "quick": VelocityScheme.QUICK}[args.scheme]
    grid = backstep_grid(args.nx, args.ny, args.lx, args.step_len)
    scene = make_scene(
        grid,
        SimulationParams(dt=args.dt, viscosity=1e-4,
                         velocity_scheme=scheme,
                         inlet_profile=InletProfile.PARABOLIC_UPPER),
        solver_options_for(Semantics.RUST, early_exit=False))
    base = scene.init_state()
    batched = jax.tree.map(lambda x: jnp.broadcast_to(x, (B,) + x.shape),
                           base)
    batched = dataclasses.replace(batched, nu=jnp.asarray(nus))

    vstep = jax.vmap(partial(step_fn, scene))

    @jax.jit
    def chunk(s):
        def body(s, _):
            s2, _ = vstep(s)
            return s2, None
        return jax.lax.scan(body, s, None, length=args.chunk)[0]

    t0 = time.perf_counter()
    done, prev_xr = 0, None
    xr = [float("nan")] * B  # reported as-is when --steps <= 0
    while done < args.steps:
        batched = chunk(batched)
        _ = float(batched.res_u[0])
        done += args.chunk
        xr = [reattachment_length(np.asarray(batched.u[b]), grid,
                                  args.step_len) for b in range(B)]
        print(f"step {done}/{args.steps} "
              f"({time.perf_counter() - t0:.0f}s) x_r/S="
              + ",".join(f"{x:.2f}" for x in xr), flush=True)
        if prev_xr is not None and np.allclose(
                xr, prev_xr, atol=0.02, equal_nan=True):
            print("reattachment converged", flush=True)
            break
        prev_xr = xr

    expected = {100: 3.0, 200: 5.2, 300: 6.8, 400: 8.5}
    print(f"{'Re':>8} {'x_r/S':>8} {'Armaly':>8}")
    for r, x in zip(res, xr):
        e = expected.get(int(r))
        print(f"{r:>8.0f} {x:>8.2f} {e if e is not None else '':>8}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
