"""Flow past a square obstacle: internal solid BCs + wake shedding
(BASELINE config 4).

Records a velocity probe behind the obstacle and estimates the vortex
shedding frequency from its spectrum (Strouhal number).

    python -m cfd_demo_jax.apps.square_obstacle --steps 2000
"""
from __future__ import annotations

import sys

import numpy as np

from .. import Box, Grid, Semantics, make_scene, solver_options_for
from ..runtime.compile_cache import enable_compile_cache
from .common import (base_parser, params_from_args, report_forces,
                     save_frames)


def main(argv=None):
    ap = base_parser(__doc__)
    ap.set_defaults(viscosity=2e-3, dt=0.005, steps=2000)
    ap.add_argument("--nx", type=int, default=400)
    ap.add_argument("--ny", type=int, default=132)
    ap.add_argument("--forces", action="store_true",
                    help="print drag/lift + C_d/C_l at the end (compiles "
                         "one extra single-step program)")
    args = ap.parse_args(argv)
    enable_compile_cache()

    lx, ly = 30.0, 10.0
    grid = Grid(nx=args.nx, ny=args.ny, lx=lx, ly=ly,
                obstacles=(Box(center_x=lx / 4, center_y=ly / 2,
                               half_w=0.75, half_h=0.75),))
    scene = make_scene(grid, params_from_args(args),
                       solver_options_for(Semantics.RUST))
    state = scene.init_state()

    probe_i = int((lx / 4 + 4.0) / grid.dx)
    probe_j = grid.ny // 2

    import jax
    from ..solver.piso import step_fn

    def step_with_probe(s, _):
        s, d = step_fn(scene, s)
        return s, (d.t, s.v[probe_j, probe_i])

    # Chunked dispatch: --chunk steps per scan. Chunk sizes repeat, so
    # at most two compiles.
    chunk_n = max(1, args.chunk)
    runs = {}
    ts_parts, probe_parts = [], []
    done = 0
    while done < args.steps:
        n = min(chunk_n, args.steps - done)
        if n not in runs:
            runs[n] = jax.jit(lambda s, n=n: jax.lax.scan(
                step_with_probe, s, None, length=n))
        state, (t_c, p_c) = runs[n](state)
        ts_parts.append(np.asarray(t_c))
        probe_parts.append(np.asarray(p_c))
        done += n
    probe = np.concatenate(probe_parts)
    ts = np.concatenate(ts_parts)
    assert np.isfinite(probe).all(), "probe diverged"

    # Shedding frequency from the dominant FFT peak of the cross-stream
    # velocity (drop the ramp-up transient).
    tail = probe[len(probe) // 2:]
    tt = ts[len(ts) // 2:]
    tail = tail - tail.mean()
    dt_mean = float(np.mean(np.diff(tt)))
    spec = np.abs(np.fft.rfft(tail * np.hanning(len(tail))))
    freqs = np.fft.rfftfreq(len(tail), d=dt_mean)
    peak = freqs[1:][np.argmax(spec[1:])]
    strouhal = peak * (2 * 0.75) / 1.0
    amp = float(np.std(tail))
    print(f"probe v-amplitude {amp:.4f}, shedding f={peak:.4f} Hz, "
          f"Strouhal={strouhal:.3f}")
    print("shedding detected:", amp > 1e-3)
    if args.forces:
        state = report_forces(scene, state, u_ref=args.inlet,
                              length=2 * 0.75)
    save_frames(scene, state, args.out, prefix="square")
    return 0


if __name__ == "__main__":
    sys.exit(main())
