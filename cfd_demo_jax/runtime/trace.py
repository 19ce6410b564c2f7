"""Tracing / profiling (SURVEY.md section 5).

The reference instruments every solver phase with ad-hoc
Instant::now() prints (model.rs:537-729) and carries step_time /
substep counts in its Residuals record. Equivalents here:

* ``PhaseTimer``: structured host-side span timing with a summary
  table (the analog of the per-phase prints, but aggregated).
* ``profile_trace``: context manager around jax.profiler.trace for
  device-level traces viewable in TensorBoard/XProf.
* ``phase_timings``: per-phase *device* timings of one PISO step,
  obtained by running each phase as its own jit function with forced
  completion -- under full jit the phases fuse (that is the point), so
  this is an offline diagnostic, not the production path.
"""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict

import jax
import jax.numpy as jnp


class PhaseTimer:
    """Accumulating named-span timer.

    with timer.span("predictor"): ...
    print(timer.summary())
    """

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> str:
        lines = ["phase                    total_s     calls    mean_ms"]
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t, c = self.totals[name], self.counts[name]
            lines.append(f"{name:<22} {t:9.3f} {c:9d} {t / c * 1e3:10.3f}")
        return "\n".join(lines)

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Device-level profiler trace (open with TensorBoard/XProf)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def phase_timings(scene, state, repeats: int = 10) -> Dict[str, float]:
    """Mean per-phase device milliseconds for one PISO substep
    (predictor / divergence / pressure / corrector / bcs), each phase
    jit-compiled separately. Mirrors the reference's phase prints."""
    from ..ops.bc import apply_bcs
    from ..ops.corrector import correct
    from ..ops.divergence import divergence_rhs
    from ..ops.predictor import predict
    from ..core.config import Semantics
    from ..solver.piso import _solve_pressure

    g = scene.grid
    opts = scene.opts
    dt_sub = state.dt
    mask_u = jnp.asarray(scene.mask_u)
    mask_v = jnp.asarray(scene.mask_v)

    fns = {
        "predictor": jax.jit(lambda u, v: predict(
            u, v, dt_sub, state.nu, g.dx, g.dy, g.nx, g.ny,
            scene.params.velocity_scheme,
            opts.semantics == Semantics.JS, mask_u, mask_v)),
        "divergence": jax.jit(lambda u, v: divergence_rhs(
            u, v, dt_sub, g.dx, g.dy)),
        "pressure": jax.jit(lambda pp, rhs: _solve_pressure(
            scene, pp, rhs)[0]),
        "corrector": jax.jit(lambda u, v, p, pp: correct(
            u, v, p, pp, dt_sub, g.dx, g.dy)),
        "bcs": jax.jit(lambda u, v: apply_bcs(
            u, v, g, scene.params.inlet_profile, state.target_inlet,
            jnp.asarray(scene.mask_u_bc), jnp.asarray(scene.mask_v_bc),
            scene.params.flow_case)),
    }
    args = {
        "predictor": (state.u, state.v),
        "divergence": (state.u, state.v),
        "pressure": (state.p_prime,
                     divergence_rhs(state.u, state.v, dt_sub, g.dx, g.dy)),
        "corrector": (state.u, state.v, state.p, state.p_prime),
        "bcs": (state.u, state.v),
    }
    out: Dict[str, float] = {}
    for name, fn in fns.items():
        a = args[name]
        jax.block_until_ready(fn(*a))  # compile
        t0 = time.perf_counter()
        for _ in range(repeats):
            r = fn(*a)
        jax.block_until_ready(r)
        out[name] = (time.perf_counter() - t0) / repeats * 1e3
    return out
