"""Batched scene ensemble via vmap (BASELINE config 5).

Runs B independent scenes (a viscosity sweep) as one batched program:
the pure step function vmaps for free, and masked-iteration mode keeps
per-element convergence exact (SURVEY.md section 2.7).

    python -m cfd_demo_jax.apps.ensemble --batch 64 --steps 200
"""
from __future__ import annotations

import dataclasses
import sys
import time
from functools import partial

import numpy as np

from .. import Grid, Cylinder, Semantics, make_scene, solver_options_for
from ..solver.piso import step_fn
from .common import base_parser, params_from_args
from ..runtime.compile_cache import enable_compile_cache


def build_ensemble(grid, params, batch: int, nu_range=(1e-5, 1e-2)):
    """(scene, batched state) for a ``batch``-scene viscosity sweep
    (geometric over ``nu_range``) on one grid. Masked iteration
    (early_exit=False): while_loop trip counts are per-element."""
    import jax
    import jax.numpy as jnp

    scene = make_scene(grid, params,
                       solver_options_for(Semantics.RUST, early_exit=False))
    nus = np.geomspace(*nu_range, batch).astype(np.float32)
    base = scene.init_state()
    batched = jax.tree.map(
        lambda x: jnp.broadcast_to(x, (batch,) + x.shape), base)
    return scene, dataclasses.replace(batched, nu=jnp.asarray(nus))


def make_ensemble_run(scene, n_steps: int):
    """jit: batched state -> batched state after ``n_steps`` vmapped
    steps, scan-fused into one dispatch."""
    import jax

    def chunk_fn(s):
        def body(s, _):
            s, _ = jax.vmap(partial(step_fn, scene))(s)
            return s, None
        return jax.lax.scan(body, s, None, length=n_steps)[0]

    return jax.jit(chunk_fn)


def main(argv=None):
    ap = base_parser(__doc__)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--shard-batch", action="store_true",
                    help="shard the batch axis over all devices "
                         "(serving-style data parallelism; the device "
                         "count must divide the batch evenly)")
    ap.add_argument("--nx", type=int, default=256)
    ap.add_argument("--ny", type=int, default=96)
    ap.set_defaults(steps=200, dt=0.004, viscosity=1e-4)
    args = ap.parse_args(argv)
    enable_compile_cache()

    import jax

    grid = Grid(nx=args.nx, ny=args.ny, lx=30.0, ly=10.0,
                obstacles=(Cylinder(7.5, 5.0, 0.75),))
    B = args.batch
    scene, batched = build_ensemble(grid, params_from_args(args), B)

    if args.shard_batch:
        # Serving-style data parallelism: place the batch axis over the
        # devices; GSPMD propagates the sharding through the vmapped
        # scan with ZERO collectives (tests/test_sharding.py).
        from ..shard.mesh import make_mesh, shard_batch
        mesh = make_mesh(axis="b")
        batched = shard_batch(batched, mesh)

    run = make_ensemble_run(scene, args.chunk)
    # First chunk compiles; excluded from throughput.
    t0 = time.perf_counter()
    batched = jax.block_until_ready(run(batched))
    print(f"compile + first chunk: {time.perf_counter() - t0:.1f}s")
    done = args.chunk
    t_total = 0.0
    while done < args.steps:
        t0 = time.perf_counter()
        batched = jax.block_until_ready(run(batched))
        t_total += time.perf_counter() - t0
        done += args.chunk
        print(f"step {done}: {B * args.chunk / (t_total / max(1, (done - args.chunk) // args.chunk)):.1f} "
              f"scene-steps/s")

    u = np.asarray(batched.u)
    assert np.isfinite(u).all()
    timed_steps = done - args.chunk
    if timed_steps > 0 and t_total > 0:
        cu = B * timed_steps * grid.nx * grid.ny / t_total
        print(f"ensemble of {B} scenes x {timed_steps} timed steps: "
              f"{cu:.3e} cell-updates/s aggregate")
    # Spread across the sweep confirms per-element independence.
    print("max|u| per nu decile:",
          np.round([abs(u[k]).max() for k in range(0, B, max(B // 8, 1))], 3))
    return 0


if __name__ == "__main__":
    sys.exit(main())
