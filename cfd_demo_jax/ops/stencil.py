"""Shifted-array stencil helpers.

Instead of the reference's per-lane SIMD loads with scalar tail loops
(model.rs LANES=8 throughout), stencils here are whole-array shifted
views: XLA fuses the pads/slices/selects into a single elementwise
loop, and the SPMD partitioner turns the shifts into halo
exchanges when the arrays are sharded. Out-of-range reads return 0.0;
every consumer masks them out with static index predicates, so the
padding value is never observable.
"""
from __future__ import annotations

import jax.numpy as jnp
from jax import lax

_PAD = 3  # max stencil offset is 2 (QUICK); one extra for shape slack


def shifted(src: jnp.ndarray, out_shape, dj: int, di: int) -> jnp.ndarray:
    """out[j, i] = src[j + dj, i + di], zero where out of bounds.

    Works across the staggered shapes: ``src`` may be any of the u/v/p
    arrays and ``out_shape`` the shape of the field being updated.
    """
    H, W = out_shape
    p = jnp.pad(src, ((_PAD, _PAD), (_PAD, _PAD)))
    return lax.slice(p, (_PAD + dj, _PAD + di), (_PAD + dj + H, _PAD + di + W))


def every_other(x: jnp.ndarray, axis: int, start: int = 0) -> jnp.ndarray:
    """``x[start::2]`` along ``axis``, as a strided ``lax.slice``.

    jnp's strided indexing lowers to a gather. XLA:GPU (JAX 0.9.0, H100)
    returned wrong values for such a gather fused behind the multigrid
    restriction's 9-point stencil; a strided slice compiled correctly,
    and it is also what the SPMD partitioner splits without a gather.
    """
    starts = [0] * x.ndim
    strides = [1] * x.ndim
    starts[axis], strides[axis] = start, 2
    return lax.slice(x, starts, x.shape, strides)


def col_index(shape) -> jnp.ndarray:
    """int32 array of x (i) indices, broadcast to ``shape``."""
    return lax.broadcasted_iota(jnp.int32, shape, dimension=1)


def row_index(shape) -> jnp.ndarray:
    """int32 array of y (j) indices, broadcast to ``shape``."""
    return lax.broadcasted_iota(jnp.int32, shape, dimension=0)


def iota_masks(shape):
    """(interior, row, col) index predicates as traced constants.

    Boundary writes throughout the package are mask-selects rather
    than .at[] scatters: scatters of single rows are both slow and
    mis-partitioned by GSPMD under row sharding (each shard would
    apply a global-row-0 write to its local row 0); selects over
    broadcast iota partition correctly and fuse into the surrounding
    loop.
    """
    r = row_index(shape)
    c = col_index(shape)
    ny, nx = shape
    interior = (r >= 1) & (r <= ny - 2) & (c >= 1) & (c <= nx - 2)
    return interior, r, c


def apply_solid_mask(x, mask):
    """Zero x where the solid mask is set; mask may be a bool array, a
    0/1 float array, or None (no obstacles)."""
    if mask is None:
        return x
    m = mask if mask.dtype == jnp.bool_ else (mask > 0)
    return jnp.where(m, 0.0, x)


class Shifts:
    """Bundle of shifted views of one source array on a target grid.

    ``s(dj, di)`` is cached so repeated offsets trace a single slice.
    """

    def __init__(self, src: jnp.ndarray, out_shape):
        self._src = src
        self._shape = tuple(out_shape)
        self._cache = {}

    def __call__(self, dj: int, di: int) -> jnp.ndarray:
        key = (dj, di)
        if key not in self._cache:
            self._cache[key] = shifted(self._src, self._shape, dj, di)
        return self._cache[key]


class StencilCtx:
    """Shift/index provider behind the stencil ops.

    The schemes/predictor/divergence/corrector expressions are written
    once against this interface; the default instance is the XLA path
    (zero-padded shifted views + broadcast iota), and it is the only
    one in the package.
    """

    def shifts(self, src: jnp.ndarray, out_shape) -> Shifts:
        return Shifts(src, out_shape)

    def col_index(self, shape) -> jnp.ndarray:
        return col_index(shape)

    def row_index(self, shape) -> jnp.ndarray:
        return row_index(shape)


DEFAULT_CTX = StencilCtx()
