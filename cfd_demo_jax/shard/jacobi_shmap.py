"""shard_map Jacobi pressure solve with explicit ppermute halo exchange.

Two variants over a row-sharded p' (SURVEY.md section 7, "Multi-chip
Jacobi"):

* ``k=1``: one 1-row halo exchange per sweep -- latency-bound at 50
  iterations but minimal redundant compute.
* ``k>1`` (wide halo): exchange K rows once, run K sweeps locally with
  the valid region shrinking into the halo, so only ceil(iters/K)
  exchanges cross the interconnect.

Both produce fields identical to the single-device solver
(tests/test_shmap.py asserts equality on the virtual CPU mesh).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.stencil import shifted
from .halo import exchange_rows, global_row_index


def _pvary(x, axis):
    """Mark a replicated value device-varying over ``axis`` (scan carry
    types must match). jax >= 0.9 renames pvary -> pcast(to='varying')."""
    if hasattr(lax, "pcast"):
        return lax.pcast(x, (axis,), to="varying")
    return lax.pvary(x, (axis,))


def _sweep_ext(ppx, rhsx, gr, gc, ny, nx, dx2, dy2, omega):
    """One damped-Jacobi sweep on a halo-extended block, with the
    reference's per-iteration p' BCs applied via *global* index masks
    (channel flow: Neumann bottom/top/left, outlet column 0)."""
    denom = 2.0 / dx2 + 2.0 / dy2
    east = shifted(ppx, ppx.shape, 0, 1)
    west = shifted(ppx, ppx.shape, 0, -1)
    north = shifted(ppx, ppx.shape, 1, 0)
    south = shifted(ppx, ppx.shape, -1, 0)
    update = ((east + west) / dx2 + (north + south) / dy2 - rhsx) / denom
    new = omega * update + (1.0 - omega) * ppx
    interior = (gr >= 1) & (gr <= ny - 2) & (gc >= 1) & (gc <= nx - 2)
    delta = jnp.where(interior, jnp.abs(new - ppx), 0.0)
    ppx = jnp.where(interior, new, ppx)
    ppx = jnp.where(gr == 0, shifted(ppx, ppx.shape, 1, 0), ppx)
    ppx = jnp.where(gr == ny - 1, shifted(ppx, ppx.shape, -1, 0), ppx)
    ppx = jnp.where(gc == 0, shifted(ppx, ppx.shape, 0, 1), ppx)
    ppx = jnp.where(gc == nx - 1, 0.0, ppx)
    return ppx, delta


def jacobi_shmap(pp: jnp.ndarray, rhs: jnp.ndarray, mesh: Mesh,
                 dx: float, dy: float, omega: float, iters: int,
                 k: int = 1, axis: str = "y"):
    """Fixed-iteration sharded Jacobi. Returns (p', last-sweep max err).

    Requires iters % k == 0 and local_rows >= k.
    """
    ny, nx = pp.shape
    n_shards = mesh.shape[axis]
    local = ny // n_shards
    assert iters % k == 0 and local >= k
    dx2, dy2 = dx * dx, dy * dy

    def shard_fn(pp_loc, rhs_loc):
        gc = lax.broadcasted_iota(jnp.int32, (local + 2 * k, nx), 1)
        gr = global_row_index(local, axis, halo=k)
        # rhs never changes across launches: one halo exchange total.
        rhsx = exchange_rows(rhs_loc, axis, k)

        def launch(carry, _):
            pp_loc, _ = carry
            ppx = exchange_rows(pp_loc, axis, k)

            def body(i, c):
                ppx, _ = c
                ppx, delta = _sweep_ext(ppx, rhsx, gr, gc, ny, nx,
                                        dx2, dy2, omega)
                # Only rows this shard owns count toward the residual;
                # halo rows go stale as the valid region shrinks.
                owned = (gr >= lax.axis_index(axis) * local) & \
                        (gr < (lax.axis_index(axis) + 1) * local)
                err = jnp.max(jnp.where(owned, delta, 0.0))
                return ppx, err

            ppx, err = lax.fori_loop(
                0, k, body,
                (ppx, _pvary(jnp.float32(0.0), axis)))
            return (ppx[k:k + local, :], err), None

        # Initial err must already be device-varying over the mesh axis
        # or the scan carry types mismatch.
        err0 = _pvary(jnp.float32(jnp.inf), axis)
        (pp_loc, err), _ = lax.scan(launch, (pp_loc, err0),
                                    None, length=iters // k)
        return pp_loc, lax.pmax(err, axis)

    fn = jax.shard_map(shard_fn, mesh=mesh,
                       in_specs=(P(axis, None), P(axis, None)),
                       out_specs=(P(axis, None), P()))
    return fn(pp, rhs)
