"""Host driver: background simulation with the reference's control API.

Rebuild of the reference's control/runtime layer (SURVEY.md section
2.2): `Model::run()` spawns a thread wired with three mpsc channels
(model.rs:1282-1332); the UI-side `SimulationControlHandle` offers
stop/pause/resume/set_params/request_snapshot/latest-snapshot-drain/
residual-drain (model.rs:65-117).

Device shape: the worker thread keeps dispatching the jit-compiled
step (device computation runs ahead asynchronously); a snapshot is a
device_get of (u, v, p) -- or, cheaper, an on-device rendered uint8
frame; commands are queue messages processed between steps. Changing
runtime scalars hot-swaps state fields (no recompile); changing
enums (scheme/solver/profile) rebuilds the compiled step once.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import List, Optional

import numpy as np

import jax.numpy as jnp

from ..core.config import SimulationParams
from ..core.state import State, set_params
from ..solver.piso import Scene, make_scene
from .log import ResidualHistory, Residuals


@dataclasses.dataclass
class SimSnapshot:
    """Deep-copied field snapshot (model.rs:36-42)."""

    u: np.ndarray
    v: np.ndarray
    p: np.ndarray
    dt: float
    step: int
    t: float
    paused: bool


class _Command:
    STOP = "stop"
    PAUSE = "pause"
    RESUME = "resume"
    SNAPSHOT = "snapshot"
    FRAME = "frame"
    SET_PARAMS = "set_params"
    SET_OPTS = "set_opts"
    TRACERS = "tracers"
    SAVE = "save"


class SimulationHandle:
    """Control endpoint (model.rs:65-117). Create via ``run()``.

    ``steps_per_loop``: simulation steps fused into one device
    dispatch per control-loop iteration (lax.scan), with every
    diagnostic scalar returned as ONE stacked vector so the loop costs
    a single device read. 1 (default) is the reference's cadence --
    one step, one residual record, per loop. N > 1 amortizes
    per-dispatch overhead N-fold at the cost of command latency <= N
    steps and one residual record (the chunk's last step) per N.
    """

    def __init__(self, scene: Scene, state: Optional[State] = None,
                 tracers: bool = False, forces: bool = False,
                 steps_per_loop: int = 1,
                 autosave_path: Optional[str] = None,
                 autosave_every: int = 1000):
        self._scene = scene
        self._state = state if state is not None else scene.init_state()
        self._steps_per_loop = max(1, int(steps_per_loop))
        self._forces_enabled = forces and bool(scene.grid.obstacles)
        if self._forces_enabled:
            from ..ops.forces import default_control_volume
            try:
                default_control_volume(scene.grid)
            except (ValueError, TypeError):
                # Tiny / wall-clipped / out-of-domain obstacles (or an
                # obstacle type the CV builder doesn't know) leave no
                # valid control volume; degrade to forces-off like the
                # obstacle-free case instead of dying at construction.
                self._forces_enabled = False
        self._tracers_enabled = tracers
        self._tracer_state = None
        if tracers:
            self._init_tracers()
        self._step = self._build_step(scene)
        self._commands: "queue.Queue" = queue.Queue()
        self._snapshots: "queue.Queue" = queue.Queue()
        self._residuals: "queue.Queue" = queue.Queue()
        self._frames: dict = {}     # mode -> (img, step) latest-wins
        self._frame_fns: dict = {}
        self.history = ResidualHistory()
        self._thread: Optional[threading.Thread] = None
        self._stopped = threading.Event()
        self.diverged = False
        self.error: Optional[str] = None  # last sim-thread exception
        self._last_step = int(self._state.step)
        # Step the run began at (0 fresh, checkpoint step on resume):
        # stable under the advancing sim thread, so resume paths can be
        # asserted without racing _last_step.
        self.initial_step = self._last_step
        # Failure recovery (SURVEY.md section 5 -- the reference has no
        # persistence at all): periodic atomic checkpoints written ON
        # the sim thread, skipped once the run diverges so the last
        # good state always survives a NaN blow-up or a preemption.
        self._autosave_path = autosave_path
        self._autosave_every = max(1, int(autosave_every))
        self.autosave_count = 0
        self.last_autosave_step: int = self._last_step
        self._autosave_writer: Optional[threading.Thread] = None
        # Background recompile-and-swap (round 3):
        # enum/opts changes build + AOT-compile the new step OFF the
        # sim thread while the old configuration keeps streaming; the
        # loop swaps when ready. Latest request wins via the
        # generation counter.
        self._build_gen = 0
        self._pending_swap = None
        self._swap_lock = threading.Lock()

    # residual-queue overflow bound (records; ~100 B each). Matches
    # ResidualHistory's spirit: bounded memory over multi-day runs.
    _RESIDUAL_QUEUE_CAP = 100_000

    def _build_step(self, scene: Scene):
        """jit chunk: (state, tracer_state) -> (state', tracer_state',
        scalars), where scalars is ONE stacked f32 device vector
        [step, t, dt, res_u, res_v, res_p, substeps, fx, fy] (fx/fy NaN
        when forces are disabled) -- the control loop pays a single
        device read per iteration regardless of how many diagnostics it
        logs. Forces (control-volume drag/lift) and tracer advection
        are FUSED into the same dispatch; with steps_per_loop > 1 the
        whole chunk is one lax.scan and the last step's scalars are
        reported."""
        import jax
        from jax import lax
        from ..solver.piso import step_fn
        n = self._steps_per_loop
        forces = self._forces_enabled
        tracers = self._tracers_enabled
        grid = scene.grid
        if forces:
            from ..ops.forces import (control_volume_force,
                                      default_control_volume,
                                      physical_pressure)
            cv = default_control_volume(grid)
        if tracers:
            from ..ops import tracers as trc
        f32 = jnp.float32

        def one(s, ts):
            p_prev, u_prev, v_prev = s.p, s.u, s.v
            s2, diag = step_fn(scene, s)
            if forces:
                P = physical_pressure(p_prev, s2.p, diag.substeps)
                fx, fy = control_volume_force(s2.u, s2.v, P, s2.nu,
                                              grid, cv, u_prev=u_prev,
                                              v_prev=v_prev, dt=diag.dt)
                # The stored p is an unbounded accumulator (it grows
                # linearly at steady state and never feeds back into
                # the dynamics -- docs/SPEC.md); rebase it each step so
                # the float32 difference above keeps its mantissa bits
                # over arbitrarily long interactive runs. Semantics-
                # neutral for the flow; the UI's min-max colormap is
                # shift-invariant.
                s2 = dataclasses.replace(s2, p=s2.p - jnp.mean(s2.p))
            else:
                fx = fy = jnp.asarray(jnp.nan, f32)
            if ts is not None:
                ts = trc.step_tracers(ts, s2.u, s2.v, grid, s2.dt,
                                      s2.step)
            scal = jnp.stack([
                jnp.asarray(diag.step, f32), jnp.asarray(diag.t, f32),
                jnp.asarray(diag.dt, f32), jnp.asarray(diag.res_u, f32),
                jnp.asarray(diag.res_v, f32),
                jnp.asarray(diag.res_p, f32),
                jnp.asarray(diag.substeps, f32),
                jnp.asarray(fx, f32), jnp.asarray(fy, f32)])
            return s2, ts, scal

        if n == 1:
            def chunk(s, ts):
                return one(s, ts if tracers else None)
        else:
            def chunk(s, ts):
                def body(carry, _):
                    s, ts = carry
                    s2, ts2, scal = one(s, ts)
                    return (s2, ts2), scal

                (s2, ts2), scals = lax.scan(
                    body, (s, ts if tracers else None), None, length=n)
                return s2, ts2, scals[-1]

        return jax.jit(chunk)

    def _render_frame(self, mode) -> np.ndarray:
        """On-device colormapped frame of the CURRENT state: one jit
        dispatch + one uint8 transfer. The SimSnapshot path moves three
        full f32 fields host-side and re-uploads them to render -- ~8
        device round trips per frame vs this path's 2."""
        fn = self._frame_fns.get(mode)
        if fn is None:
            import jax
            from ..render.colormap import VisualizationMode, render_field
            grid = self._scene.grid
            m = VisualizationMode(mode)
            fn = jax.jit(lambda u, v, p: render_field(
                u, v, p, grid=grid, mode=m))
            self._frame_fns[mode] = fn
        s = self._state
        return np.asarray(fn(s.u, s.v, s.p))

    def _init_tracers(self):
        from ..ops import tracers as trc
        self._tracer_state = trc.init_tracers(self._scene.grid)

    def set_tracers(self, enabled: bool):
        """Enable/disable tracer particles (index.html tracer checkbox).
        Advection is fused into the step dispatch, so toggling rebuilds
        the compiled chunk. Applied ON the sim thread via the command
        queue (like set_params): mutating _tracer_state/_step from the
        caller's thread races the in-flight dispatch (the old
        tracers=True chunk could be called with ts=None)."""
        if self._thread is None or not self._thread.is_alive():
            self._set_tracers_now(bool(enabled))  # pre-start: no race
            return
        self._commands.put((_Command.TRACERS, bool(enabled)))

    def _set_tracers_now(self, enabled: bool):
        if enabled == self._tracers_enabled:
            return
        self._tracers_enabled = enabled
        if enabled and self._tracer_state is None:
            self._init_tracers()
        if not enabled:
            self._tracer_state = None
        self._step = self._build_step(self._scene)

    @property
    def tracer_state(self):
        return self._tracer_state

    # --- lifecycle (model.rs:1282-1332) ---

    def start(self) -> "SimulationHandle":
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="cfd-sim")
        self._thread.start()
        return self

    def _loop(self):
        paused = False
        while not self._stopped.is_set():
            try:
                paused = self._loop_once(paused)
            except Exception as e:  # noqa: BLE001 -- the sim thread
                # must NEVER die silently (a transient device error,
                # a compile failure after a SET_PARAMS rebuild, a
                # render error): record, auto-pause, keep serving
                # commands/snapshots so the UI can show the error.
                self.error = f"{type(e).__name__}: {e}"
                paused = True
                print(f"cfd-demo-jax: sim thread error, auto-paused: "
                      f"{self.error}")
        # Final checkpoint on clean stop (still on the sim thread,
        # before join() returns): a stopped-and-restarted process
        # resumes from the exact last step, not the last cadence hit.
        w = self._autosave_writer
        if w is not None and w.is_alive():
            w.join(timeout=120)  # let an in-flight cadence write land
        if (self._autosave_path is not None and not self.diverged
                and self.last_autosave_step != self._last_step):
            self._save_checkpoint(self._autosave_path)

    def _save_checkpoint(self, path: str, asynchronous: bool = False):
        """Atomic checkpoint of the CURRENT state, initiated on the sim
        thread (autosave cadence, the SAVE command, and the final stop
        save all land here -- never concurrent with a dispatch). Write
        to a temp file then os.replace: a crash or disk-full mid-write
        can never corrupt the previous good checkpoint.

        ``asynchronous`` (the cadence path): the device->host copy
        still happens here, synchronously, so the snapshot is
        consistent -- but the compressed file write (seconds at
        8192^2+) moves to a writer thread so stepping never stalls on
        disk. At most one write is in flight; a cadence hit that finds
        the writer busy is skipped (the next one catches up -- for
        crash recovery, WHICH good step survives matters less than the
        run never blocking). last_autosave_step is claimed up front so
        the skip logic needs no lock."""
        import os
        import jax

        from . import checkpoint

        # Unique tmp per write: if a cadence writer outlives its 120 s
        # join budget, the sync path must not interleave bytes into the
        # SAME tmp file (os.replace is atomic, so with distinct tmps the
        # last replace wins and the published file is always whole).
        # The counter is only ever touched on the sim thread.
        self._tmp_seq = getattr(self, "_tmp_seq", 0) + 1
        tmp = f"{path}.tmp{self._tmp_seq}.npz"  # .npz: np.savez keeps it
        step_now = self._last_step

        host_state = jax.device_get(self._state)

        def write():
            try:
                checkpoint.save(tmp, host_state)
                os.replace(tmp, path)
                self.autosave_count += 1
            except Exception as e:  # noqa: BLE001 -- a full disk must
                # not kill the run; record and keep stepping.
                self.error = f"checkpoint[{path}]: {type(e).__name__}: {e}"
                try:
                    os.remove(tmp)
                except OSError:
                    pass

        # Only the autosave file advances the cadence clock: an
        # on-demand save to a DIFFERENT path must not postpone the next
        # periodic autosave (or suppress the final stop-save).
        if path == self._autosave_path:
            self.last_autosave_step = step_now
        if asynchronous:
            self._autosave_writer = threading.Thread(
                target=write, daemon=True, name="cfd-autosave")
            self._autosave_writer.start()
        else:
            # The SAVE command / final stop save: join any in-flight
            # cadence writer first (same tmp file when the paths match).
            w = self._autosave_writer
            if w is not None and w.is_alive():
                w.join(timeout=120)
            write()

    def _loop_once(self, paused: bool) -> bool:
        """One control-loop iteration; returns the new paused flag."""
        snapshot_sent = False
        frame_modes = []
        # Drain all pending commands (model.rs:1291-1315); duplicate
        # snapshot requests are coalesced; frame requests coalesce
        # PER MODE (concurrent clients may stream different
        # visualizations -- one render each, not first-wins).
        while True:
            try:
                cmd, arg = self._commands.get_nowait()
            except queue.Empty:
                break
            if cmd == _Command.STOP:
                self._stopped.set()
            elif cmd == _Command.PAUSE:
                paused = True
            elif cmd == _Command.RESUME:
                paused = False
                self.error = None  # a successful resume clears it
            elif cmd == _Command.SET_PARAMS:
                self._apply_params(arg)
                self.error = None
            elif cmd == _Command.SET_OPTS:
                self._apply_opts(arg)
                self.error = None
            elif cmd == _Command.TRACERS:
                self._set_tracers_now(arg)
            elif cmd == _Command.SAVE:
                self._save_checkpoint(arg)
            elif cmd == _Command.SNAPSHOT and not snapshot_sent:
                self._snapshots.put(self._snapshot(paused))
                snapshot_sent = True
            elif cmd == _Command.FRAME and arg not in frame_modes:
                frame_modes.append(arg)
        # Install any finished background rebuild AFTER the drain (a
        # just-arrived request bumps the generation first, so a stale
        # build is never installed-then-replaced).
        self._maybe_swap()
        for mode in frame_modes:
            # step tag from the host-tracked counter (an
            # int(state.step) here would be its own device round
            # trip per frame); latest-wins per-mode slot. Skip the
            # render dispatch entirely when the cached frame is
            # already at this step (a paused sim streamed at 20 Hz
            # would otherwise re-render an identical frame per
            # request -- each a device round trip).
            cached = self._frames.get(mode)
            if cached is not None and cached[1] == self._last_step:
                continue
            try:
                img = self._render_frame(mode)
            except Exception as e:  # noqa: BLE001 -- a render failure
                # must neither kill the thread nor pause a healthy
                # sim; freeze the last frame (tagged at this step so
                # the failing render is not retried until the sim
                # advances) and surface the error once.
                self.error = (f"render[{mode}]: "
                              f"{type(e).__name__}: {e}")
                g = self._scene.grid
                img = (cached[0] if cached is not None
                       else np.zeros((g.ny, g.nx, 3), np.uint8))
            self._frames[mode] = (img, self._last_step)
        if self._stopped.is_set() or paused:
            if not self._stopped.is_set():
                time.sleep(0.016)  # model.rs:1322
            return paused
        t0 = time.perf_counter()
        new_state, ts2, scal = self._step(self._state,
                                          self._tracer_state)
        # ONE device read for every diagnostic scalar (each float()
        # of a separate device scalar is its own device round trip).
        # Read BEFORE committing the new state: if the read raises
        # (transient device error) nothing is
        # half-applied -- _last_step, the frame-cache tags and the
        # state stay consistent, and resume retries from the old
        # state.
        (_step_f32, t_sim, dtv, res_u, res_v, res_p, substeps,
         fx, fy) = (float(x) for x in np.asarray(scal))
        self._state = new_state
        if ts2 is not None:
            self._tracer_state = ts2
        # Host-tracked exact counter: the f32 step_i in the stacked
        # vector rounds past 2^24 steps (~58 h interactive); each
        # dispatch advances exactly steps_per_loop.
        self._last_step += self._steps_per_loop
        # Failure detection (SURVEY.md section 5): the reference can
        # and does diverge numerically with nothing noticing; a
        # non-finite residual here auto-pauses instead of burning
        # the device on NaNs.
        import math as _math
        if not (_math.isfinite(res_u) and _math.isfinite(res_v)
                and _math.isfinite(res_p)):
            self.diverged = True
            paused = True
            print("cfd-demo-jax: non-finite residual at step "
                  f"{self._last_step}; simulation auto-paused "
                  "(reduce dt or viscosity gradient)")
        rec = Residuals(
            simulation_step=self._last_step,
            simulation_time=t_sim,
            dt=dtv,
            p=res_p,
            u=res_u,
            v=res_v,
            # per-step wall time (the dispatch covered
            # steps_per_loop steps)
            step_time=(time.perf_counter() - t0)
            / self._steps_per_loop,
            piso_substeps=int(substeps),
            fx=None if not self._forces_enabled else fx,
            fy=None if not self._forces_enabled else fy)
        self.history.push(rec)
        # Bounded like history: with no consumer draining the queue
        # (programmatic use, frame-only web clients) a multi-day run
        # must not leak every record; drop the OLDEST on overflow so
        # get_new_log_messages keeps returning the recent tail.
        while self._residuals.qsize() >= self._RESIDUAL_QUEUE_CAP:
            try:
                self._residuals.get_nowait()
            except queue.Empty:
                break
        self._residuals.put(rec)
        # Autosave AFTER the divergence check: the chunk that produced
        # non-finite residuals set self.diverged above, so its NaN
        # state can never overwrite the last good checkpoint. The file
        # write is async (skip-if-busy); only the consistent
        # device->host copy happens on this thread.
        if (self._autosave_path is not None and not self.diverged
                and self._last_step - self.last_autosave_step
                >= self._autosave_every):
            w = self._autosave_writer
            if w is None or not w.is_alive():
                self._save_checkpoint(self._autosave_path,
                                      asynchronous=True)
        return paused

    def _apply_params(self, params: SimulationParams):
        """model.rs:1250-1257. Scalar changes hot-swap state fields
        immediately (no recompile); enum changes (scheme/solver/
        profile/case-BCs on the same grid) build + compile the new
        step on a BACKGROUND thread and the loop swaps when ready --
        the stream never freezes while the new step compiles (the
        reference hot-swaps instantly because it compiles nothing,
        model.rs:1250-1257; this is the compiled equivalent). Until the
        swap lands, stepping continues under the OLD enums with the NEW
        scalars.

        Exception-safe: a failing rebuild records self.error on the
        builder thread and leaves the running configuration intact."""
        enums_changed = (
            params.velocity_scheme != self._scene.params.velocity_scheme
            or params.pressure_solver != self._scene.params.pressure_solver
            or params.inlet_profile != self._scene.params.inlet_profile
            or params.flow_case != self._scene.params.flow_case)
        self._state = set_params(self._state, params)
        if enums_changed:
            self._launch_rebuild(params, self._scene.opts)

    def _apply_opts(self, opts):
        """SolverOptions replacement (semantics / residual-dt-scaling /
        adaptive-substep switches -- the JS-twin runtime knobs,
        index.html:75,310-317,1295-1297). Always a rebuild; state
        fields carry over, with the JS-only u_prev/v_prev leaves added
        or dropped to match (see _convert_state)."""
        self._launch_rebuild(self._scene.params, opts)

    def _convert_state(self, state: State, scene: Scene) -> State:
        """Adapt a live state's STRUCTURE to a new scene: JS semantics
        carries u_prev/v_prev (extrapolation) and starts its adaptive
        substep count at substeps_init; RUST drops both."""
        from ..core.config import Semantics
        js = scene.opts.semantics == Semantics.JS
        was_js = state.u_prev is not None
        if js == was_js:
            return state
        if js:
            return dataclasses.replace(
                state, u_prev=state.u, v_prev=state.v,
                substeps=jnp.asarray(scene.opts.substeps_init,
                                     state.substeps.dtype))
        return dataclasses.replace(
            state, u_prev=None, v_prev=None,
            substeps=jnp.asarray(scene.opts.substeps_init,
                                 state.substeps.dtype))

    def _launch_rebuild(self, params: SimulationParams, opts):
        """Build + AOT-compile the new configuration off the sim
        thread; deposit (gen-tagged) for _maybe_swap. Latest wins."""
        self._build_gen += 1
        gen = self._build_gen
        grid = self._scene.grid
        tflag = self._tracers_enabled
        state_ref = self._state
        ts_ref = self._tracer_state

        def build():
            try:
                scene = make_scene(grid, params, opts)
                step = self._build_step(scene)
                conv = self._convert_state(state_ref, scene)
                # AOT compile NOW (on this thread) so the sim-thread
                # swap is instant; shapes are grid-fixed, so the live
                # state at swap time matches this lowering.
                compiled = step.lower(conv, ts_ref).compile()
            except Exception as e:  # noqa: BLE001 -- surface, keep old
                self.error = (f"rebuild[{type(e).__name__}]: {e}")
                return
            with self._swap_lock:
                if gen == self._build_gen:
                    self._pending_swap = (gen, scene, compiled, tflag)

        threading.Thread(target=build, daemon=True,
                         name="cfd-rebuild").start()

    def _maybe_swap(self):
        """Install a finished background rebuild (sim thread only)."""
        with self._swap_lock:
            sw = self._pending_swap
            self._pending_swap = None
        if sw is None:
            return
        gen, scene, compiled, tflag = sw
        if gen != self._build_gen:
            return  # superseded by a newer request
        if tflag != self._tracers_enabled:
            # tracers toggled since the build started: the compiled
            # chunk's tracer structure is stale; rebuild for the
            # current flag.
            self._launch_rebuild(scene.params, scene.opts)
            return
        self._state = self._convert_state(self._state, scene)
        self._scene = scene
        self._step = compiled
        self._frame_fns = {}

    def _snapshot(self, paused: bool) -> SimSnapshot:
        s = self._state
        return SimSnapshot(
            u=np.asarray(s.u), v=np.asarray(s.v_full), p=np.asarray(s.p),
            dt=float(s.dt), step=int(s.step), t=float(s.t), paused=paused)

    # --- public control API (model.rs:65-117) ---

    def stop(self):
        self._commands.put((_Command.STOP, None))
        if self._thread is not None:
            # The final stop-save may first join an in-flight cadence
            # writer (<=120 s) and then do a multi-second compressed
            # write at large grids; the join budget must exceed that or
            # the daemon thread dies at process exit with the promised
            # final checkpoint silently lost.
            self._thread.join(timeout=180)

    def pause(self):
        self._commands.put((_Command.PAUSE, None))

    def resume(self):
        self._commands.put((_Command.RESUME, None))

    def set_params(self, params: SimulationParams):
        self._commands.put((_Command.SET_PARAMS, params))

    def set_options(self, opts):
        """Replace the scene's SolverOptions mid-run (semantics switch,
        residual-dt-scaling, adaptive substeps -- the JS-twin runtime
        knobs). Compiles in the background and swaps when ready; fields
        carry over (JS's u_prev/v_prev leaves added/dropped)."""
        self._commands.put((_Command.SET_OPTS, opts))

    def request_snapshot(self):
        self._commands.put((_Command.SNAPSHOT, None))

    def save_checkpoint(self, path: str):
        """Queue an on-demand checkpoint, written ON the sim thread
        between dispatches (atomic; see _save_checkpoint). Use
        runtime.checkpoint.load(path) -- optionally with a target mesh
        for elastic resume -- to restore."""
        self._commands.put((_Command.SAVE, str(path)))

    def get_last_available_snapshot(self) -> Optional[SimSnapshot]:
        """Drain the snapshot queue, keep the latest (model.rs:76-86)."""
        last = None
        while True:
            try:
                last = self._snapshots.get_nowait()
            except queue.Empty:
                return last

    def request_frame(self, mode: str = "velocity"):
        """Queue an on-device-rendered uint8 frame of the current
        fields (see _render_frame; the cheap path for interactive
        streaming -- SimSnapshot remains the full-field API).

        The mode is validated HERE, on the caller's thread: an
        unknown string must fail this call, never the sim thread."""
        from ..render.colormap import VisualizationMode
        self._commands.put((_Command.FRAME, VisualizationMode(mode).value))

    def get_last_available_frame(self, mode: str = "velocity"):
        """Latest (img, step) rendered for ``mode``, or None."""
        return self._frames.get(mode)

    def get_new_log_messages(self) -> List[Residuals]:
        """Drain the residual queue (model.rs:88-98)."""
        out: List[Residuals] = []
        while True:
            try:
                out.append(self._residuals.get_nowait())
            except queue.Empty:
                return out


def run(scene: Scene, state: Optional[State] = None,
        tracers: bool = False, forces: bool = False,
        steps_per_loop: int = 1,
        autosave_path: Optional[str] = None,
        autosave_every: int = 1000) -> SimulationHandle:
    """Model::run equivalent: start stepping on a background thread and
    return the control handle. With ``autosave_path``, an atomic
    checkpoint is written every ``autosave_every`` steps (plus a final
    one on stop), skipped after divergence so the last good state
    always survives."""
    return SimulationHandle(scene, state, tracers=tracers,
                            forces=forces,
                            steps_per_loop=steps_per_loop,
                            autosave_path=autosave_path,
                            autosave_every=autosave_every).start()
