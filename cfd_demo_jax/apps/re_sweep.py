"""Reynolds-number sweep with long-horizon stability check
(BASELINE config 3).

Re = U * D / nu with D the cylinder diameter (1.5 for the default
scene). Sweeps viscosity to cover Re 100..5000, runs a long rollout,
and reports NaN-free stability + final residuals per Re.

    python -m cfd_demo_jax.apps.re_sweep --re 100 1000 5000 --steps 1000
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np

from .. import Semantics, default_grid, make_scene, solver_options_for
from .common import base_parser, params_from_args, rollout
from ..runtime.compile_cache import enable_compile_cache


def main(argv=None):
    ap = base_parser(__doc__)
    ap.add_argument("--re", type=float, nargs="+",
                    default=[100.0, 500.0, 1000.0, 2000.0, 5000.0])
    ap.add_argument("--nx", type=int, default=400)
    ap.add_argument("--ny", type=int, default=132)
    args = ap.parse_args(argv)
    enable_compile_cache()

    grid = dataclasses.replace(default_grid(), nx=args.nx, ny=args.ny)
    diameter = 2.0 * grid.obstacle.radius
    ok = True
    for re in args.re:
        nu = args.inlet * diameter / re
        params = dataclasses.replace(params_from_args(args), viscosity=nu)
        scene = make_scene(grid, params, solver_options_for(Semantics.RUST))
        state, rec = rollout(scene, scene.init_state(), args.steps,
                             args.chunk)
        u = np.asarray(state.u)
        stable = bool(np.isfinite(u).all()) and abs(u).max() < 100.0
        ok &= stable
        print(f"Re={re:7.0f} nu={nu:.3e}: "
              f"{'STABLE' if stable else 'DIVERGED'} "
              f"max|u|={abs(u).max():.3f} res_p={rec.p:.3e} dt={rec.dt:.2e}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
