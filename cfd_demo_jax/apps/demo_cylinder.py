"""Default demo: channel flow past a cylinder (BASELINE config 1).

The Rust app's default scene (src/app.rs:33-53: 800x264, Lx=30, Ly=10,
r=0.75 cylinder at (7.5, 5)) with the reference Rust semantics.

    python -m cfd_demo_jax.apps.demo_cylinder --steps 500 --out out/
"""
from __future__ import annotations

import sys

from .. import Semantics, default_grid, make_scene, solver_options_for
from ..runtime import checkpoint
from ..runtime.compile_cache import enable_compile_cache
from .common import (base_parser, params_from_args, report_forces,
                     rollout, save_frames)


def main(argv=None):
    ap = base_parser(__doc__)
    ap.add_argument("--nx", type=int, default=800)
    ap.add_argument("--ny", type=int, default=264)
    ap.add_argument("--tracers", action="store_true",
                    help="enable tracer particles (JS twin feature)")
    ap.add_argument("--forces", action="store_true",
                    help="print drag/lift + C_d/C_l at the end "
                         "(ops.forces control-volume balance)")
    args = ap.parse_args(argv)
    enable_compile_cache()

    grid = default_grid()
    if (args.nx, args.ny) != (800, 264):
        import dataclasses
        grid = dataclasses.replace(grid, nx=args.nx, ny=args.ny)
    scene = make_scene(grid, params_from_args(args),
                       solver_options_for(Semantics.RUST))
    state = scene.init_state()
    if args.resume:
        state = checkpoint.load(args.resume, template=state)
        print(f"resumed from {args.resume} at step {int(state.step)}")

    state, _ = rollout(scene, state, args.steps, args.chunk,
                       autosave_path=args.checkpoint,
                       autosave_every=args.autosave_every)
    if args.forces:
        state = report_forces(scene, state, u_ref=args.inlet, length=1.5)

    if args.tracers:
        import jax
        import numpy as np
        from ..ops import tracers as trc
        from ..render.colormap import VisualizationMode, render_field
        from ..render.png import write_png
        from ..ops.tracers import TRACER_INJECTION_INTERVAL
        import jax.numpy as jnp
        ts = trc.init_tracers(grid)
        # Advect through an extra visualization window over the FROZEN
        # final fields, scan-fused into ONE dispatch.
        ks = jnp.arange(1, 2 * TRACER_INJECTION_INTERVAL)
        advance_all = jax.jit(lambda ts, u, v, dt: jax.lax.scan(
            lambda t, k: (trc.step_tracers(t, u, v, grid, dt, k), None),
            ts, ks)[0])
        ts = advance_all(ts, state.u, state.v, state.dt)
        img = np.asarray(render_field(state.u, state.v, state.p,
                                      grid=grid,
                                      mode=VisualizationMode.VELOCITY))
        img = trc.draw_tracers(img, ts, grid)
        import os
        os.makedirs(args.out, exist_ok=True)
        write_png(os.path.join(args.out, "frame_tracers.png"), img)
        print("wrote", os.path.join(args.out, "frame_tracers.png"))

    save_frames(scene, state, args.out, prefix="cylinder")
    if args.checkpoint:
        checkpoint.save(args.checkpoint, state)
        print("checkpoint:", args.checkpoint)
    return 0


if __name__ == "__main__":
    sys.exit(main())
