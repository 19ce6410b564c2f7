"""Lid-driven cavity convergence sweep (BASELINE config 2).

Runs the cavity at one or more resolutions until the velocity residual
plateaus, reports center-line profiles and steps/sec.

    python -m cfd_demo_jax.apps.cavity --n 512 --steps 2000
"""
from __future__ import annotations

import sys

import numpy as np

from .. import FlowCase, Semantics, cavity_grid, make_scene, solver_options_for
from .common import base_parser, params_from_args, rollout, save_frames
from ..runtime.compile_cache import enable_compile_cache


def main(argv=None):
    ap = base_parser(__doc__)
    ap.add_argument("--n", type=int, nargs="+", default=[128],
                    help="cavity resolutions, e.g. --n 512 1024 2048")
    ap.set_defaults(dt=0.002, viscosity=1e-2, inlet=1.0)
    args = ap.parse_args(argv)
    enable_compile_cache()

    for n in args.n:
        scene = make_scene(cavity_grid(n),
                           params_from_args(args, FlowCase.CAVITY),
                           solver_options_for(Semantics.RUST))
        state, rec = rollout(scene, scene.init_state(), args.steps,
                             args.chunk)
        u = np.asarray(state.u)
        v = np.asarray(state.v)
        # Center-line profiles (the standard cavity diagnostic).
        u_center = u[:, n // 2]
        v_center = v[:, n // 2 - 1: n // 2 + 1].mean(axis=1)
        print(f"n={n}: res_u={rec.u:.3e} res_p={rec.p:.3e} "
              f"u_mid={u_center[n // 2]:+.4f} "
              f"u_min={u_center.min():+.4f} v_extent="
              f"[{v_center.min():+.4f}, {v_center.max():+.4f}]")
        save_frames(scene, state, args.out, prefix=f"cavity{n}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
