"""Gradient-based inverse problem through the differentiable solver.

Capability beyond the reference (no autodiff exists in the Rust/JS
twins, src/model.rs / index.html): with
``SolverOptions(differentiable=True)`` every convergence loop is a
fixed-trip masked lax.scan and jax.grad flows through whole rollouts,
each step rematerialized (jax.checkpoint) so backward memory stays at
one step's activations.

Demo: viscosity recovery (a minimal data assimilation). A target
velocity field is generated at an unknown nu*, and Adam descends
d/d(nu) of the field-misfit loss -- the gradient of an N-step
Navier-Stokes rollout -- until nu converges to nu*. The same
machinery differentiates drag, energy, or any scalar of the rollout
with respect to viscosity, inlet velocity, or full initial fields.

    python -m cfd_demo_jax.apps.optimize --steps 20 --iters 40
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np

import jax
import jax.numpy as jnp

from .. import (Cylinder, Grid, Semantics, SimulationParams, make_run,
                make_scene, solver_options_for)
from ..runtime.compile_cache import enable_compile_cache


def build(nx, ny, steps, jacobi_iters):
    grid = Grid(nx=nx, ny=ny, lx=8.0, ly=4.0,
                obstacles=(Cylinder(2.0, 2.0, 0.5),))
    params = SimulationParams(dt=0.01, viscosity=0.01)
    opts = solver_options_for(
        Semantics.RUST, ramp_up_steps=5, jacobi_tol=1e-4,
        jacobi_iters=jacobi_iters, outer_corrector_rounds=0,
        early_exit=False, differentiable=True)
    scene = make_scene(grid, params, opts)
    run = make_run(scene, steps, donate=False)
    s0 = scene.init_state()

    def fields(log_nu):
        # Optimize log(nu): keeps nu positive and conditions the step
        # size across the decades a Re sweep spans.
        s = dataclasses.replace(s0, nu=jnp.exp(log_nu))
        s, _ = run(s)
        return s.u, s.v

    return fields


def main(argv=None):
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nx", type=int, default=64)
    ap.add_argument("--ny", type=int, default=32)
    ap.add_argument("--steps", type=int, default=20,
                    help="rollout length the loss differentiates through")
    ap.add_argument("--iters", type=int, default=80,
                    help="Adam iterations")
    ap.add_argument("--jacobi-iters", type=int, default=30)
    ap.add_argument("--nu-true", type=float, default=0.005)
    ap.add_argument("--nu-init", type=float, default=0.02)
    ap.add_argument("--lr", type=float, default=0.12)
    args = ap.parse_args(argv)
    enable_compile_cache()

    import optax

    fields = build(args.nx, args.ny, args.steps, args.jacobi_iters)
    u_t, v_t = fields(jnp.log(jnp.asarray(args.nu_true, jnp.float32)))

    @jax.jit
    def loss_fn(log_nu):
        u, v = fields(log_nu)
        return jnp.mean((u - u_t) ** 2) + jnp.mean((v - v_t) ** 2)

    grad_fn = jax.jit(jax.value_and_grad(loss_fn))
    # Cosine-decayed Adam: near the minimum the f32 loss bottoms out
    # around its own rounding noise, where a constant step wanders.
    opt = optax.adam(optax.cosine_decay_schedule(args.lr, args.iters))
    log_nu = jnp.log(jnp.asarray(args.nu_init, jnp.float32))
    state = opt.init(log_nu)
    best = (float("inf"), float(log_nu))
    print(f"target nu* = {args.nu_true:.6f}, start nu = {args.nu_init:.6f}")
    for it in range(args.iters):
        val, g = grad_fn(log_nu)
        if float(val) < best[0]:
            best = (float(val), float(log_nu))
        updates, state = opt.update(g, state)
        log_nu = optax.apply_updates(log_nu, updates)
        if it % 5 == 0 or it == args.iters - 1:
            print(f"iter {it:3d}: loss {float(val):.3e} "
                  f"nu {float(jnp.exp(log_nu)):.6f}", flush=True)

    nu_hat = float(np.exp(best[1]))
    rel = abs(nu_hat - args.nu_true) / args.nu_true
    print(f"recovered nu = {nu_hat:.6f} (rel err {rel:.2%}, "
          f"loss {best[0]:.3e})")
    return 0 if rel < 0.05 else 1


if __name__ == "__main__":
    sys.exit(main())
