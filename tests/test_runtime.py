"""Driver / checkpoint / render / raster tests."""
import os
import tempfile
import time

import numpy as np

from cfd_demo_jax import (Cylinder, Grid, Semantics, SimulationParams,
                          VelocityScheme, make_scene, make_step,
                          solver_options_for)
from cfd_demo_jax.render.colormap import (VisualizationMode,
                                          boundary_overlay, colormap_rgb,
                                          legend_strip, render_field)
from cfd_demo_jax.render.png import write_png
from cfd_demo_jax.runtime import checkpoint
from cfd_demo_jax.runtime.driver import run
from cfd_demo_jax.utils.raster import (rasterize_mesh, rasterize_polygon,
                                       rasterize_quadtree)


def scene():
    return make_scene(
        Grid(nx=48, ny=24, lx=4.0, ly=1.5,
             obstacles=(Cylinder(1.0, 0.75, 0.25),)),
        SimulationParams(dt=0.002, viscosity=1e-4),
        solver_options_for(Semantics.RUST, ramp_up_steps=5))


def test_driver_lifecycle():
    sc = scene()
    h = run(sc)
    try:
        deadline = time.time() + 60
        while time.time() < deadline:
            h.request_snapshot()
            snap = h.get_last_available_snapshot()
            if snap is not None and snap.step >= 5:
                break
            time.sleep(0.05)
        assert snap is not None and snap.step >= 5
        assert snap.u.shape == (24, 49)
        assert snap.v.shape == (25, 48)  # reference shape via v_full
        assert np.isfinite(snap.u).all()

        h.pause()
        time.sleep(0.2)
        h.request_snapshot()
        time.sleep(0.2)
        s1 = h.get_last_available_snapshot()
        time.sleep(0.3)
        h.request_snapshot()
        time.sleep(0.2)
        s2 = h.get_last_available_snapshot()
        assert s1 is not None and s2 is not None
        assert s2.step == s1.step  # paused: no progress
        assert s2.paused

        h.set_params(SimulationParams(dt=0.001, viscosity=2e-4))
        h.resume()
        time.sleep(0.3)
        logs = h.get_new_log_messages()
        assert len(logs) > 0
        assert logs[-1].piso_substeps >= 1
    finally:
        h.stop()


def test_driver_chunked_step_equals_per_step():
    """steps_per_loop=N fuses N steps into one dispatch (lax.scan);
    the states and the reported diagnostics must equal N single-step
    dispatches exactly -- with tracers and forces fused in."""
    from cfd_demo_jax.runtime.driver import SimulationHandle
    sc = scene()
    h1 = SimulationHandle(sc, tracers=True, forces=True)
    h3 = SimulationHandle(sc, tracers=True, forces=True,
                          steps_per_loop=3)
    s1, ts1 = h1._state, h1._tracer_state
    for _ in range(3):
        s1, ts1, scal1 = h1._step(s1, ts1)
    s3, ts3, scal3 = h3._step(h3._state, h3._tracer_state)
    for f in ("u", "v", "p", "res_p", "dt", "step"):
        np.testing.assert_array_equal(np.asarray(getattr(s1, f)),
                                      np.asarray(getattr(s3, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(np.asarray(ts1.pos),
                                  np.asarray(ts3.pos))
    np.testing.assert_array_equal(np.asarray(scal1), np.asarray(scal3))


def test_driver_scheme_hot_swap():
    sc = scene()
    h = run(sc)
    try:
        time.sleep(0.3)
        h.set_params(SimulationParams(
            dt=0.002, viscosity=1e-4,
            velocity_scheme=VelocityScheme.SECOND))
        snap = None
        deadline = time.time() + 120  # recompile happens on the worker
        while time.time() < deadline:
            h.request_snapshot()
            time.sleep(0.2)
            got = h.get_last_available_snapshot()
            if got is not None:
                snap = got
                break
        assert snap is not None and np.isfinite(snap.u).all()
    finally:
        h.stop()


def test_checkpoint_roundtrip():
    sc = scene()
    step = make_step(sc, donate=False)
    st = sc.init_state()
    for _ in range(5):
        st, _ = step(st)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.npz")
        checkpoint.save(path, st)
        st2 = checkpoint.load(path, template=sc.init_state())
    np.testing.assert_array_equal(np.asarray(st.u), np.asarray(st2.u))
    np.testing.assert_array_equal(np.asarray(st.p_prime),
                                  np.asarray(st2.p_prime))
    assert int(st2.step) == int(st.step)
    # resumed run continues bit-identically
    a, _ = step(st)
    b, _ = step(st2)
    np.testing.assert_array_equal(np.asarray(a.u), np.asarray(b.u))


def test_render_modes_and_png():
    sc = scene()
    step = make_step(sc, donate=False)
    st = sc.init_state()
    for _ in range(10):
        st, _ = step(st)
    for mode in VisualizationMode:
        img = np.asarray(render_field(st.u, st.v, st.p, grid=sc.grid,
                                      mode=mode))
        assert img.shape == (24, 48, 3) and img.dtype == np.uint8
    img = boundary_overlay(img)
    leg = legend_strip()
    assert leg.shape[2] == 3
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "frame.png")
        write_png(p, img)
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_colormap_constant_field():
    img = np.asarray(colormap_rgb(np.zeros((8, 16), np.float32)))
    assert img.shape == (8, 16, 3)  # no NaNs on degenerate range
    assert (img[..., 0] == 0).all() and (img[..., 2] == 255).all()


def test_rasterizers():
    import math
    from cfd_demo_jax.mesh2d import Polygon, QuadMesh, tesselate
    poly = Polygon.rect(0, 0, 30, 10)
    poly.add_hole(Polygon.regular((7.5, 5.0), 1.5, 4, math.pi / 4))
    img = rasterize_polygon(poly, 300, 100)
    assert img.shape == (100, 300, 3)
    # Fill present, hole not filled at its center.
    assert (img == (173, 216, 230)).all(axis=-1).any()
    qt = tesselate(poly, 0.5, 2.0)
    img2 = rasterize_quadtree(qt, 300, 100)
    assert (img2 == 0).any()
    mesh = QuadMesh.from_quadtree(qt, poly)
    img3 = rasterize_mesh(mesh, background=img)
    # Orange diamonds at hole-boundary intersections.
    assert (img3 == (255, 165, 0)).all(axis=-1).any()


def test_trace_utilities():
    """runtime/trace.py: PhaseTimer spans, phase_timings device
    diagnostics, and the jax.profiler trace context."""
    import tempfile
    from cfd_demo_jax.runtime.trace import (PhaseTimer, phase_timings,
                                            profile_trace)

    import cfd_demo_jax as cfd

    t = PhaseTimer()
    with t.span("a"):
        pass
    with t.span("a"):
        pass
    with t.span("b"):
        pass
    assert t.counts["a"] == 2 and "phase" in t.summary()
    t.reset()
    assert not t.totals

    grid = Grid(nx=32, ny=16, lx=4.0, ly=2.0,
                obstacles=(Cylinder(1.0, 1.0, 0.3),))
    scene = cfd.make_scene(
        grid, SimulationParams(dt=0.002, viscosity=1e-4),
        solver_options_for(Semantics.RUST, ramp_up_steps=5,
                           jacobi_iters=5, outer_corrector_rounds=0))
    state = scene.init_state()
    ms = phase_timings(scene, state, repeats=2)
    assert set(ms) == {"predictor", "divergence", "pressure",
                      "corrector", "bcs"}
    assert all(v >= 0.0 for v in ms.values())

    with tempfile.TemporaryDirectory() as d:
        with profile_trace(d):
            state2, _ = cfd.make_step(scene, donate=False)(state)
        import os
        assert os.listdir(d), "profiler wrote nothing"


def test_driver_survives_step_exception():
    """The sim thread must never die silently: an exception from the
    jitted step records handle.error, auto-pauses, and the thread
    keeps serving commands/snapshots."""
    sc = scene()
    h = run(sc)
    try:
        deadline = time.time() + 60
        while time.time() < deadline and h.history.last() is None:
            time.sleep(0.05)
        assert h.history.last() is not None

        def boom(*a):
            raise RuntimeError("injected step failure")

        h._step = boom
        deadline = time.time() + 30
        while time.time() < deadline and h.error is None:
            time.sleep(0.05)
        assert h.error is not None and "injected step failure" in h.error
        assert h._thread.is_alive()
        # still serves snapshots while auto-paused on the error
        h.request_snapshot()
        deadline = time.time() + 30
        snap = None
        while time.time() < deadline and snap is None:
            snap = h.get_last_available_snapshot()
            time.sleep(0.05)
        assert snap is not None and np.isfinite(snap.u).all()
    finally:
        h.stop()


def test_driver_set_tracers_live_toggle():
    """set_tracers while the sim thread is stepping: applied ON the
    sim thread via the command queue (regression: a caller-thread
    mutation could null _tracer_state under the in-flight tracers=True
    dispatch and auto-pause a healthy run)."""
    sc = scene()
    h = run(sc)  # tracers off
    try:
        deadline = time.time() + 60
        while time.time() < deadline and h._last_step < 3:
            time.sleep(0.02)
        h.set_tracers(True)
        step0 = h._last_step
        deadline = time.time() + 60
        while time.time() < deadline and (h.tracer_state is None
                                          or h._last_step < step0 + 3):
            time.sleep(0.02)
        assert h.tracer_state is not None
        assert h.error is None
        h.set_tracers(False)
        deadline = time.time() + 60
        while time.time() < deadline and h.tracer_state is not None:
            time.sleep(0.02)
        assert h.tracer_state is None
        assert h.error is None
        # still stepping after both rebuilds
        step1 = h._last_step
        deadline = time.time() + 60
        while time.time() < deadline and h._last_step < step1 + 2:
            time.sleep(0.02)
        assert h._last_step >= step1 + 2
    finally:
        h.stop()


def test_driver_autosave_and_on_demand_save():
    """Periodic atomic autosave + the SAVE command + the final save on
    stop (failure-recovery superset of the reference, which has no
    persistence -- SURVEY.md section 5)."""
    sc = scene()
    with tempfile.TemporaryDirectory() as d:
        auto = os.path.join(d, "auto.npz")
        man = os.path.join(d, "manual.npz")
        h = run(sc, autosave_path=auto, autosave_every=2)
        try:
            deadline = time.time() + 60
            while time.time() < deadline and h.autosave_count < 2:
                time.sleep(0.05)
            assert h.autosave_count >= 2
            h.save_checkpoint(man)
            deadline = time.time() + 30
            while time.time() < deadline and not os.path.exists(man):
                time.sleep(0.05)
            assert os.path.exists(man)
        finally:
            h.stop()
        # final save on stop: the checkpoint is at the exact last step
        st = checkpoint.load(auto, template=sc.init_state())
        assert int(st.step) == h._last_step
        assert np.isfinite(np.asarray(st.u)).all()
        assert not os.path.exists(auto + ".tmp.npz")  # atomic rename
        # resumed run continues from the autosave bit-identically
        step = make_step(sc, donate=False)
        a, _ = step(st)
        b, _ = step(checkpoint.load(auto, template=sc.init_state()))
        np.testing.assert_array_equal(np.asarray(a.u), np.asarray(b.u))


def test_driver_autosave_skips_diverged_state():
    """Once the run diverges, autosave must stop: the last checkpoint
    on disk stays the last GOOD state, never the NaN blow-up."""
    import dataclasses as dc

    import jax.numpy as jnp

    sc = scene()
    with tempfile.TemporaryDirectory() as d:
        auto = os.path.join(d, "auto.npz")
        h = run(sc, autosave_path=auto, autosave_every=1)
        try:
            deadline = time.time() + 60
            while time.time() < deadline and h.autosave_count < 1:
                time.sleep(0.05)
            assert h.autosave_count >= 1
            orig = h._step

            def nan_step(s, ts):
                s2, ts2, scal = orig(s, ts)
                return (dc.replace(s2, u=s2.u * jnp.nan), ts2,
                        scal * jnp.nan)

            h._step = nan_step
            deadline = time.time() + 30
            while time.time() < deadline and not h.diverged:
                time.sleep(0.05)
            assert h.diverged
            # let any pre-divergence async writer land (its snapshot is
            # a good state; only post-NaN saves are forbidden)
            w = h._autosave_writer
            if w is not None:
                w.join(timeout=30)
            count_at_div = h.autosave_count
            time.sleep(0.3)
            assert h.autosave_count == count_at_div  # no post-NaN saves
        finally:
            h.stop()
        # diverged: no final stop-save either; checkpoint is finite
        st = checkpoint.load(auto, template=sc.init_state())
        assert np.isfinite(np.asarray(st.u)).all()
        assert np.isfinite(np.asarray(st.p)).all()


def test_driver_set_options_semantics_switch():
    """Round 3 (VERDICT r2 item 5): SolverOptions replacement mid-run
    -- the JS-twin runtime semantics become reachable from a live
    handle. The rebuild compiles in the background and swaps when
    ready; fields carry over with the JS-only u_prev/v_prev leaves
    added (and dropped on the way back)."""
    from cfd_demo_jax import Semantics, solver_options_for

    sc = scene()
    h = run(sc)
    try:
        deadline = time.time() + 60
        while time.time() < deadline and h._last_step < 2:
            time.sleep(0.02)
        h.set_options(solver_options_for(Semantics.JS, ramp_up_steps=5))
        deadline = time.time() + 120
        while time.time() < deadline and \
                h._scene.opts.semantics != Semantics.JS:
            time.sleep(0.05)
        assert h._scene.opts.semantics == Semantics.JS
        assert h.error is None
        # JS state structure: extrapolation fields present; stepping on
        step0 = h._last_step
        deadline = time.time() + 60
        while time.time() < deadline and h._last_step < step0 + 2:
            time.sleep(0.02)
        assert h._last_step >= step0 + 2
        assert h._state.u_prev is not None
        assert np.isfinite(np.asarray(h._state.u)).all()
        # and back to RUST: u_prev dropped, still stepping
        h.set_options(solver_options_for(Semantics.RUST, ramp_up_steps=5))
        deadline = time.time() + 120
        while time.time() < deadline and \
                h._scene.opts.semantics != Semantics.RUST:
            time.sleep(0.05)
        assert h._scene.opts.semantics == Semantics.RUST
        assert h._state.u_prev is None
        assert h.error is None
    finally:
        h.stop()


def test_driver_background_rebuild_does_not_block_stream():
    """An enum change must not stall the control loop: steps keep
    landing between the set_params call and the swap (the old
    configuration streams while the new one compiles)."""
    from cfd_demo_jax import SimulationParams, VelocityScheme

    sc = scene()
    h = run(sc)
    try:
        deadline = time.time() + 60
        while time.time() < deadline and h._last_step < 2:
            time.sleep(0.02)
        old_scene = h._scene
        h.set_params(SimulationParams(
            dt=0.002, viscosity=1e-4,
            velocity_scheme=VelocityScheme.QUICK))
        # stepping continues regardless of which scene is live
        step0 = h._last_step
        deadline = time.time() + 60
        while time.time() < deadline and h._last_step < step0 + 3:
            time.sleep(0.02)
        assert h._last_step >= step0 + 3
        # and the swap eventually lands
        deadline = time.time() + 120
        while time.time() < deadline and h._scene is old_scene:
            time.sleep(0.05)
        assert h._scene.params.velocity_scheme == VelocityScheme.QUICK
        assert h.error is None
        assert np.isfinite(np.asarray(h._state.u)).all()
    finally:
        h.stop()
