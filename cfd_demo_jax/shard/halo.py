"""Explicit halo exchange over a row-sharded mesh axis.

Where the GSPMD layouts (shard.mesh) let XLA's SPMD partitioner insert
halo transfers for jnp stencils, this module hand-writes them with
lax.ppermute inside shard_map (SURVEY.md section 2.7) -- the building
block for the shard_map solvers (shard.jacobi_shmap, shard.mg_shmap),
including the wide-halo batched-iteration Jacobi (one exchange per K
iterations instead of per sweep, trading redundant compute for
interconnect latency; SURVEY.md section 7 "Multi-chip Jacobi").

Convention: fields are (local_rows, nx) blocks of a (ny, nx) global
array, contiguous rows per shard, shard 0 owning the bottom rows.
Non-periodic: edge shards receive zero halos (ppermute supplies zeros
for missing pairs), and the domain boundary conditions mask them.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def _perm_up(n: int):
    """shard i -> shard i+1 (data moving toward larger row indices)."""
    return [(i, i + 1) for i in range(n - 1)]


def _perm_down(n: int):
    return [(i + 1, i) for i in range(n - 1)]


def exchange_rows(x: jnp.ndarray, axis: str, width: int) -> jnp.ndarray:
    """Return x extended to (width + local + width) rows with neighbor
    halos; zero rows at the physical domain edges."""
    n = lax.axis_size(axis)
    from_below = lax.ppermute(x[-width:, :], axis, _perm_up(n))
    from_above = lax.ppermute(x[:width, :], axis, _perm_down(n))
    return jnp.concatenate([from_below, x, from_above], axis=0)


def exchange_cols(x: jnp.ndarray, axis: str, width: int) -> jnp.ndarray:
    """Column twin of exchange_rows for a 2-D (rows x cols) spatial
    mesh (SURVEY.md:201 "ghost columns/rows per neighbor"): returns x
    extended to (width + local_cols + width) columns with neighbor
    halos; zero columns at the physical domain edges. Shard 0 owns the
    leftmost columns."""
    n = lax.axis_size(axis)
    from_left = lax.ppermute(x[:, -width:], axis, _perm_up(n))
    from_right = lax.ppermute(x[:, :width], axis, _perm_down(n))
    return jnp.concatenate([from_left, x, from_right], axis=1)


def exchange_rows_cols(x: jnp.ndarray, yaxis: str, xaxis: str,
                       wr: int, wc: int) -> jnp.ndarray:
    """Both-axis halo exchange for the 2-D rows x cols tier: columns
    first, then rows OF THE COLUMN-EXTENDED block -- so the corner
    halos carry the diagonal neighbors' data (the row ppermute forwards
    the column halos it just received)."""
    return exchange_rows(exchange_cols(x, xaxis, wc), yaxis, wr)


def bcast_from_last(x: jnp.ndarray, axis: str) -> jnp.ndarray:
    """Replicate the LAST shard's value to every shard along ``axis``
    with a chain of n-1 ppermutes (gather-free; the payload here is a
    single column, so the chain costs ~nothing). After round r, shards
    n-1-r.. hold the true value; n-1 rounds cover all."""
    n = lax.axis_size(axis)
    idx = lax.axis_index(axis)
    for _ in range(n - 1):
        y = lax.ppermute(x, axis, _perm_down(n))
        x = jnp.where(idx == n - 1, x, y)
    return x


def global_row_index(local_rows: int, axis: str, halo: int = 0):
    """Global row index of each row of a (halo + local + halo) block."""
    shard = lax.axis_index(axis)
    base = shard * local_rows - halo
    return base + lax.broadcasted_iota(jnp.int32,
                                       (local_rows + 2 * halo, 1), 0)


def pmax(x, axis: str):
    return lax.pmax(x, axis)
