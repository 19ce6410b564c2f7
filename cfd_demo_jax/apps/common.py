"""Shared CLI plumbing for the demo apps."""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from ..core.config import (FlowCase, InletProfile, PressureSolver,
                           SimulationParams, VelocityScheme)
from ..render.colormap import VisualizationMode, boundary_overlay, render_field
from ..render.png import write_png
from ..runtime.log import Residuals


def base_parser(desc: str) -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=desc)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--chunk", type=int, default=50,
                    help="steps fused per device dispatch (lax.scan)")
    ap.add_argument("--out", default="out", help="output directory")
    ap.add_argument("--dt", type=float, default=0.005)
    ap.add_argument("--viscosity", type=float, default=1e-6)
    ap.add_argument("--inlet", type=float, default=1.0)
    ap.add_argument("--scheme", choices=[s.value for s in VelocityScheme],
                    default="first")
    ap.add_argument("--solver", choices=[s.value for s in PressureSolver],
                    default="jacobi")
    ap.add_argument("--profile", choices=[p.value for p in InletProfile],
                    default="uniform")
    ap.add_argument("--checkpoint", default=None,
                    help="write a resume checkpoint (.npz) at the end")
    ap.add_argument("--resume", default=None, help="checkpoint to resume from")
    ap.add_argument("--autosave-every", type=int, default=0, metavar="N",
                    help="also write --checkpoint atomically every ~N "
                         "steps DURING the rollout (rounded up to chunk "
                         "boundaries; skipped on non-finite residuals so "
                         "the last checkpoint is always good); 0 = off")
    return ap


def params_from_args(args, flow_case=FlowCase.CHANNEL) -> SimulationParams:
    return SimulationParams(
        dt=args.dt, viscosity=args.viscosity,
        target_inlet_velocity=args.inlet,
        velocity_scheme=VelocityScheme(args.scheme),
        inlet_profile=InletProfile(args.profile),
        pressure_solver=PressureSolver(args.solver),
        flow_case=flow_case)


def rollout(scene, state, steps: int, chunk: int, log_every: int = 1,
            autosave_path: str | None = None, autosave_every: int = 0):
    """Scan-fused rollout in chunks; prints a residual line every
    ``log_every``-th chunk (and always the last); returns
    (state, last Residuals).

    With ``autosave_path`` and ``autosave_every`` > 0, writes an atomic
    checkpoint at the first chunk boundary past each cadence mark --
    the preemption story for multi-minute jobs (each chunk is waited
    for before it is timed, so the host copy is consistent). Saves
    skip non-finite residuals: the last checkpoint on disk stays the
    last good state."""
    import jax
    from .. import make_run
    run = None
    rec = None
    done = 0
    i = 0
    last_saved = int(state.step)
    while done < steps:
        n = min(chunk, steps - done)
        if run is None or n != chunk:
            run = make_run(scene, n, donate=False)
        t0 = time.perf_counter()
        state, diags = jax.block_until_ready(run(state))
        wall = time.perf_counter() - t0
        done += n
        i += 1
        rec = Residuals(
            simulation_step=int(state.step), simulation_time=float(state.t),
            dt=float(state.dt), p=float(state.res_p), u=float(state.res_u),
            v=float(state.res_v), step_time=wall / n,
            piso_substeps=int(state.substeps))
        if i % max(log_every, 1) == 0 or done >= steps:
            print(rec.format_line(), f" ({n / wall:.1f} steps/s)")
        if (autosave_path and autosave_every > 0
                and rec.simulation_step - last_saved >= autosave_every
                and np.isfinite([rec.u, rec.v, rec.p]).all()):
            from ..runtime import checkpoint
            tmp = f"{autosave_path}.tmp.npz"
            checkpoint.save(tmp, state)
            os.replace(tmp, autosave_path)
            last_saved = rec.simulation_step
    return state, rec


def save_frames(scene, state, out_dir: str, prefix: str = "frame"):
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for mode in VisualizationMode:
        img = np.asarray(render_field(state.u, state.v, state.p,
                                      grid=scene.grid, mode=mode))
        img = boundary_overlay(img)
        path = os.path.join(out_dir, f"{prefix}_{mode.value}.png")
        write_png(path, img)
        paths.append(path)
    print("wrote", ", ".join(paths))
    return paths


def report_forces(scene, state, u_ref: float, length: float):
    """One extra step to form the physical pressure (per-step increment
    of the stored accumulator p -- ops.forces.physical_pressure), then
    print the control-volume drag/lift and coefficients."""
    from .. import make_step
    from ..ops.forces import (control_volume_force, default_control_volume,
                              drag_lift_coefficients, physical_pressure)
    p_prev, u_prev, v_prev = state.p, state.u, state.v
    state, diag = make_step(scene, donate=False)(state)
    P = physical_pressure(p_prev, state.p, diag.substeps)
    cv = default_control_volume(scene.grid)
    fx, fy = control_volume_force(state.u, state.v, P, state.nu,
                                  scene.grid, cv, u_prev=u_prev,
                                  v_prev=v_prev, dt=diag.dt)
    cd, cl = drag_lift_coefficients(fx, fy, u_ref, length)
    print(f"forces: Fx={float(fx):+.4f} Fy={float(fy):+.4f}  "
          f"C_d={float(cd):.3f} C_l={float(cl):+.3f}  (cv={tuple(cv)})")
    return state
