"""Interactive web front-end: the framework's equivalent of the
reference's UI layer (egui desktop app src/app.rs / browser twin
index.html), written from scratch on the stdlib http.server.

Panels mirrored (SURVEY.md section 2.3):
  * simulation view: start/pause/resume/reset, sliders (dt, viscosity,
    inlet), combos (scheme, inlet profile, pressure solver, flow case),
    visualization mode buttons (pressure / velocity / vorticity /
    tracers), residual log + live 3-series residual graph, legend
  * mesh view: feature/max-cell-size sliders, Tesselate button showing
    the rasterized sketch + quadtree mesh overlay

Frames are rendered on device and shipped as PNG; the browser polls.

    python -m cfd_demo_jax.apps.web.server --port 8000
"""
from __future__ import annotations

import argparse
import io
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np

from ... import (FlowCase, Grid, InletProfile, PressureSolver, Semantics,
                 SimulationParams, VelocityScheme, cavity_grid, default_grid,
                 make_scene, solver_options_for)
from ...ops.tracers import draw_tracers
from ...render.colormap import (VisualizationMode, boundary_overlay,
                                legend_strip, render_field)
from ...runtime.driver import SimulationHandle
from .frontend import INDEX_HTML


from ...render.png import png_bytes


class AppState:
    """Server-side session: one simulation handle + mesh view cache."""

    def __init__(self, nx=400, ny=132, chunk=1):
        self.lock = threading.Lock()
        self.nx, self.ny = nx, ny
        self.chunk = chunk  # driver steps_per_loop
        self.autosave_path = None   # --autosave: periodic atomic ckpt
        self.autosave_every = 1000
        self.resume = False         # --resume: restore autosave at start
        self.params = SimulationParams(dt=0.005, viscosity=1e-6,
                                       target_inlet_velocity=1.0)
        # Runtime semantics: the JS twin's
        # adaptive-substep + extrapolation + residual-dt-scaling mode
        # is a live switch (reference: index.html:75,310-317,1295-1297)
        self.semantics = Semantics.RUST
        self.residual_dt_scaling = False
        self.handle: SimulationHandle | None = None
        self.log_lines: list[str] = []
        self.history = {"step": [], "u": [], "v": [], "p": []}
        self.last_forces = None   # (fx, fy) from the newest residual
        self.last_substeps = None  # newest record's PISO substep count

    def grid(self) -> Grid:
        if self.params.flow_case == FlowCase.CAVITY:
            return cavity_grid(min(self.nx, self.ny))
        import dataclasses
        return dataclasses.replace(default_grid(), nx=self.nx, ny=self.ny)

    def solver_opts(self):
        kw = {}
        if self.semantics == Semantics.JS:
            kw["residual_dt_scaling"] = bool(self.residual_dt_scaling)
        return solver_options_for(self.semantics, **kw)

    def start(self):
        self.stop()
        self.last_forces = None
        grid = self.grid()
        scene = make_scene(grid, self.params, self.solver_opts())
        # Normalization captured at START (the run's own U and D);
        # later slider edits must not rescale already-measured forces.
        self._force_norm = None
        if grid.obstacles:
            from cfd_demo_jax.core.config import Cylinder
            obs = grid.obstacles[0]
            D = (2 * obs.radius if isinstance(obs, Cylinder)
                 else 2 * obs.half_h)
            U = max(self.params.target_inlet_velocity, 1e-9)
            self._force_norm = (U, D)
        chunk = self.chunk
        state = None
        # Resume only the FIRST start: later start() calls are user
        # restarts / flow-case switches, where reloading the old
        # checkpoint would silently undo the reset (and a same-shape
        # checkpoint from a different case would be wrong physics).
        if self.resume and self.autosave_path is not None:
            self.resume = False
            import os
            if os.path.exists(self.autosave_path):
                try:
                    from cfd_demo_jax.runtime import checkpoint
                    state = checkpoint.load(self.autosave_path,
                                            template=scene.init_state())
                    if state.u.shape != scene.init_state().u.shape:
                        raise ValueError("grid shape changed")
                    print(f"resumed from {self.autosave_path} at step "
                          f"{int(state.step)}")
                except Exception as e:  # noqa: BLE001 -- a stale or
                    # shape-incompatible checkpoint must not block the
                    # server; start fresh and say so.
                    print(f"autosave resume failed ({e}); starting fresh")
                    state = None
        self.handle = SimulationHandle(
            scene, state, tracers=True, forces=True,
            steps_per_loop=chunk,
            autosave_path=self.autosave_path,
            autosave_every=self.autosave_every).start()

    def stop(self):
        if self.handle is not None:
            self.handle.stop()
            self.handle = None

    def force_report(self):
        """Latest drag/lift + coefficients normalized by the U and D
        captured when the run STARTED (None without obstacles).

        The measured force is the TOTAL over every obstacle inside the
        shared control volume, but D is the first obstacle's length
        scale -- so with multiple obstacles the coefficients would be
        normalized by an arbitrary scale; report raw Fx/Fy only then.
        """
        if self.last_forces is None or not getattr(self, "_force_norm", None):
            return None
        fx, fy = self.last_forces
        if len(self.grid().obstacles) > 1:
            return {"fx": fx, "fy": fy, "cd": None, "cl": None}
        from cfd_demo_jax.ops.forces import drag_lift_coefficients
        U, D = self._force_norm
        cd, cl = drag_lift_coefficients(fx, fy, U, D)
        return {"fx": fx, "fy": fy, "cd": float(cd), "cl": float(cl)}

    def drain_logs(self):
        if self.handle is None:
            return
        for rec in self.handle.get_new_log_messages():
            self.log_lines.append(rec.format_line())
            self.history["step"].append(rec.simulation_step)
            self.history["u"].append(rec.u)
            self.history["v"].append(rec.v)
            self.history["p"].append(rec.p)
            if rec.fx is not None:
                self.last_forces = (rec.fx, rec.fy)
            self.last_substeps = rec.piso_substeps
        self.log_lines = self.log_lines[-200:]
        for k in self.history:
            self.history[k] = self.history[k][-2000:]


def _finite(x):
    """Replace non-finite floats with None recursively: json.dumps
    would emit bare NaN (invalid JSON) and kill the frontend's
    JSON.parse exactly when a divergence is being reported."""
    if isinstance(x, float):
        return x if math.isfinite(x) else None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


APP = AppState()


class Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def _send(self, code, body, ctype="application/json"):
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        url = urlparse(self.path)
        q = {k: v[0] for k, v in parse_qs(url.query).items()}
        if url.path == "/":
            self._send(200, INDEX_HTML.encode(), "text/html")
        elif url.path == "/api/frame":
            self._frame(q)
        elif url.path == "/api/stream":
            self._stream(q)
        elif url.path == "/api/state":
            self._state()
        elif url.path == "/api/legend":
            self._send(200, png_bytes(legend_strip(256, 20)), "image/png")
        elif url.path == "/api/mesh":
            self._mesh(q)
        else:
            self._send(404, b"{}")

    def do_POST(self):
        n = int(self.headers.get("Content-Length", 0))
        payload = json.loads(self.rfile.read(n) or b"{}")
        url = urlparse(self.path)
        if url.path == "/api/mesh":
            # Custom sketch tesselation (beyond the reference's fixed
            # sketch): validation errors come back as 400 + message.
            return self._mesh_custom(payload)
        with APP.lock:
            if url.path == "/api/control":
                self._control(payload)
            elif url.path == "/api/params":
                self._params(payload)
            else:
                return self._send(404, b"{}")
        self._send(200, b'{"ok": true}')

    # ----- handlers -----

    def _control(self, p):
        action = p.get("action")
        if action == "start":
            if APP.handle is None:
                APP.start()
            else:
                APP.handle.resume()
        elif action == "pause" and APP.handle:
            APP.handle.pause()
        elif action == "reset":
            APP.stop()
            APP.log_lines.clear()
            APP.last_forces = None
            for k in APP.history:
                APP.history[k].clear()

    def _params(self, p):
        import dataclasses
        kw = {}
        if "dt" in p:
            kw["dt"] = float(p["dt"])
        if "viscosity" in p:
            kw["viscosity"] = float(p["viscosity"])
        if "inlet" in p:
            kw["target_inlet_velocity"] = float(p["inlet"])
        if "scheme" in p:
            kw["velocity_scheme"] = VelocityScheme(p["scheme"])
        if "profile" in p:
            kw["inlet_profile"] = InletProfile(p["profile"])
        if "solver" in p:
            kw["pressure_solver"] = PressureSolver(p["solver"])
        if "flow_case" in p:
            kw["flow_case"] = FlowCase(p["flow_case"])
        opts_changed = False
        if "semantics" in p:
            sem = Semantics(p["semantics"])
            opts_changed |= sem != APP.semantics
            APP.semantics = sem
        if "residual_dt_scaling" in p:
            rds = bool(p["residual_dt_scaling"])
            opts_changed |= rds != APP.residual_dt_scaling
            APP.residual_dt_scaling = rds
        old_case = APP.params.flow_case
        APP.params = dataclasses.replace(APP.params, **kw)
        if APP.handle is not None and opts_changed \
                and APP.params.flow_case == old_case:
            # Semantics / dt-scaling switch on the live run: compiled
            # in the background, swapped when ready (driver.set_options)
            APP.handle.set_options(APP.solver_opts())
        if APP.handle is not None:
            if APP.params.flow_case != old_case:
                # Different GRID (cavity vs channel), not just a new
                # compiled step: restart. Everything else hot-swaps
                # through the driver (scalars in the carry; enum
                # changes rebuild the jit step on the same state) --
                # the frontend always sends flow_case, so keying on
                # presence instead of change restarted the run (and
                # paid a full recompile) on EVERY Update click.
                APP.start()
            else:
                APP.handle.set_params(APP.params)

    def _frame(self, q):
        # Only the handle READ needs the lock; polling for the first
        # frame (up to 8 s while the step compiles) must not hold it --
        # it would block /api/control//api/params//api/state for the
        # whole wait. The handle's own API is queue-based and
        # safe against a concurrent reset (stale polls just 503).
        with APP.lock:
            h = APP.handle
        if h is None:
            img = np.full((APP.ny, APP.nx, 3), 24, np.uint8)
            return self._send(200, png_bytes(img), "image/png")
        mode = q.get("mode", "velocity")
        try:
            h.request_frame(mode)
        except ValueError:
            return self._send(400, b'{"error": "unknown mode"}')
        fr = None
        # The first render can take seconds while the step is still
        # compiling; poll long enough that the first frame succeeds
        # rather than 503ing.
        for _ in range(800):
            fr = h.get_last_available_frame(mode)
            if fr is not None:
                break
            time.sleep(0.01)
        if fr is None:
            return self._send(503, b"{}")
        self._send(200, self._decorate_png(h, fr[0], q), "image/png")

    @staticmethod
    def _decorate_png(h, img, q) -> bytes:
        """Host-side decoration of a driver-rendered uint8 frame (the
        fields never cross to the host -- see driver._render_frame)."""
        img = boundary_overlay(np.asarray(img))
        if q.get("tracers") == "1" and h.tracer_state is not None:
            img = draw_tracers(img, h.tracer_state, h._scene.grid)
        # upscale 2x for display crispness (nearest)
        img = np.repeat(np.repeat(img, 2, axis=0), 2, axis=1)
        return png_bytes(img)

    def _stream(self, q):
        """Push frames at interactive rate (multipart/x-mixed-replace:
        the browser repaints an <img> per part with zero client JS).
        The reference renders per UI frame (src/app.rs:468-474); the
        250 ms polling path stays as a fallback. New frames are pushed
        as soon as the sim produces a new snapshot, capped at ~20 fps;
        unchanged frames re-send at 1 Hz as a keep-alive."""
        self.send_response(200)
        self.send_header("Content-Type",
                         "multipart/x-mixed-replace; boundary=frame")
        self.send_header("Cache-Control", "no-cache")
        self.end_headers()

        def write_part(png: bytes):
            self.wfile.write(b"--frame\r\nContent-Type: image/png\r\n"
                             + f"Content-Length: {len(png)}\r\n\r\n".encode())
            self.wfile.write(png)
            self.wfile.write(b"\r\n")
            self.wfile.flush()

        last_step = None
        last_emit = 0.0
        mode = q.get("mode", "velocity")
        try:
            while True:
                with APP.lock:
                    h = APP.handle
                if h is None:
                    img = np.full((2 * APP.ny, 2 * APP.nx, 3), 24, np.uint8)
                    write_part(png_bytes(img))
                    last_step = None
                    time.sleep(0.5)
                    continue
                try:
                    h.request_frame(mode)
                except ValueError:
                    return  # unknown mode: end the stream
                fr = h.get_last_available_frame(mode)
                now = time.monotonic()
                if fr is not None and (fr[1] != last_step
                                       or now - last_emit >= 1.0):
                    write_part(self._decorate_png(h, fr[0], q))
                    last_step = fr[1]
                    last_emit = now
                time.sleep(0.05)  # ~20 fps cap
        except (BrokenPipeError, ConnectionResetError, OSError):
            return

    def _state(self):
        with APP.lock:
            APP.drain_logs()
            h = APP.handle
            body = {
                "running": h is not None,
                "error": h.error if h is not None else None,
                "log": APP.log_lines[-40:],
                "history": APP.history,
                "forces": APP.force_report(),
                "params": {
                    "dt": APP.params.dt,
                    "viscosity": APP.params.viscosity,
                    "inlet": APP.params.target_inlet_velocity,
                    "scheme": APP.params.velocity_scheme.value,
                    "profile": APP.params.inlet_profile.value,
                    "solver": APP.params.pressure_solver.value,
                    "flow_case": APP.params.flow_case.value,
                    "semantics": APP.semantics.value,
                    "residual_dt_scaling": APP.residual_dt_scaling,
                },
                "substeps": APP.last_substeps,
            }
        self._send(200, json.dumps(_finite(body)).encode())

    def _mesh(self, q):
        from ...mesh2d import Polygon
        # Clamp to the UI slider ranges: feature_size <= 0 would refine
        # boundary-crossing cells without bound (request-level DoS).
        feature = min(max(float(q.get("feature", 0.2)), 0.01), 0.5)
        max_cell = min(max(float(q.get("max_cell", 1.0)), 0.1), 10.0)
        # Default sketch: 30x10 rect with rotated-square hole
        # (src/views/mesh_view.rs:140-152).
        poly = Polygon.rect(0.0, 0.0, 30.0, 10.0)
        poly.add_hole(Polygon.regular((7.5, 5.0), 1.5, 4, math.pi / 4))
        self._send(200, png_bytes(self._mesh_image(poly, feature, max_cell)),
                   "image/png")

    def _mesh_custom(self, p):
        """Tesselate a user-sketched polygon (+holes). The Polygon
        constructor enforces the reference's validity rules (>=3
        vertices, no self-intersection, holes strictly inside,
        polygon.rs:21-78); violations come back as 400 + message."""
        from ...mesh2d import Polygon
        feature = min(max(float(p.get("feature", 0.2)), 0.01), 0.5)
        max_cell = min(max(float(p.get("max_cell", 1.0)), 0.1), 10.0)
        try:
            outer = [(float(x), float(y)) for x, y in p.get("outer", [])]
            if len(outer) > 64:
                raise ValueError("too many vertices (max 64)")
            poly = Polygon(outer)
            for ring in p.get("holes", [])[:8]:
                # Same vertex cap as the outer ring: Polygon's
                # self-intersection validation is O(N^2) host Python,
                # so an uncapped hole is a request-level DoS.
                if len(ring) > 64:
                    raise ValueError("too many hole vertices (max 64)")
                poly.add_hole(Polygon([(float(x), float(y))
                                       for x, y in ring]))
        except (ValueError, TypeError) as e:
            return self._send(400, json.dumps({"error": str(e)}).encode())
        self._send(200, png_bytes(self._mesh_image(poly, feature, max_cell)),
                   "image/png")

    @staticmethod
    def _mesh_image(poly, feature, max_cell):
        from ...mesh2d import QuadMesh
        from ...utils.raster import rasterize_mesh, rasterize_polygon
        mesh = QuadMesh.from_polygon(poly, feature, max_cell)
        # rasterize_polygon draws in the polygon's tight bounding box;
        # pass the same bounds to the mesh overlay so they align.
        bb = poly.bounding_box()
        bounds = ((bb.cx - bb.half_width, bb.cy - bb.half_height),
                  (bb.cx + bb.half_width, bb.cy + bb.half_height))
        wid = 900
        hei = max(60, min(900, int(round(
            wid * max(bb.half_height, 1e-9) / max(bb.half_width, 1e-9)))))
        img = rasterize_polygon(poly, wid, hei)
        return rasterize_mesh(mesh, background=img, bounds=bounds)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--nx", type=int, default=400)
    ap.add_argument("--ny", type=int, default=132)
    ap.add_argument("--chunk", type=int, default=1,
                    help="simulation steps per device dispatch "
                         "(driver steps_per_loop); 1 is the reference "
                         "cadence")
    ap.add_argument("--autosave", default=None, metavar="PATH",
                    help="write an atomic checkpoint every "
                         "--autosave-every steps (skipped after "
                         "divergence; final save on stop)")
    ap.add_argument("--autosave-every", type=int, default=1000)
    ap.add_argument("--resume", action="store_true",
                    help="restore the --autosave checkpoint at start "
                         "(falls back to a fresh run if missing or "
                         "shape-incompatible)")
    args = ap.parse_args(argv)
    from ...runtime.compile_cache import enable_compile_cache
    enable_compile_cache()
    APP.nx, APP.ny = args.nx, args.ny
    APP.chunk = args.chunk
    APP.autosave_path = args.autosave
    APP.autosave_every = max(1, args.autosave_every)
    APP.resume = args.resume
    server = ThreadingHTTPServer(("127.0.0.1", args.port), Handler)
    print(f"cfd-demo-jax web UI on http://127.0.0.1:{args.port}/")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        APP.stop()
    return 0


if __name__ == "__main__":
    main()
