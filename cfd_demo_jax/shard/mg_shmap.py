"""shard_map multigrid V-cycle with explicit halo exchange.

Multi-chip form of the JS twin's multigrid kit (ops.poisson, from
index.html:1344-1470): the fine levels run row-sharded with explicit
1-row ppermute halos around every smooth/residual/restrict/prolong
stencil; once a level's rows no longer split evenly over the mesh axis
(gny_level % 2*n_shards != 0), the residual is all-gathered and the
REMAINING recursion runs replicated through the single-device XLA kit
(coarse-grid agglomeration -- the standard parallel-multigrid move:
coarse levels are latency-bound, not bandwidth-bound, so replicating
them costs less than sharding 1-row blocks).

Every sharded stencil reproduces ops.poisson's expressions verbatim
(same operation order, zero-fill halos matching `shifted`'s zero
padding at global edges), so the sharded solve equals the single-device
solve bitwise (tests/test_shmap.py).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.stencil import every_other, shifted
from .halo import exchange_cols, exchange_rows, global_row_index


def _interior(gr, gc, gny, nx):
    return (gr >= 1) & (gr <= gny - 2) & (gc >= 1) & (gc <= nx - 2)


def _smooth_shard(p_loc, rhs_loc, gny, nx, dx, dy, iterations, axis):
    """Interior-only undamped Jacobi (ops.poisson._mg_smooth) on a
    row-sharded block; one 1-row halo exchange per iteration."""
    if iterations == 0:
        return p_loc
    local = p_loc.shape[0]
    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 / dx2 + 2.0 / dy2
    gr = global_row_index(local, axis) + jnp.zeros((1, nx), jnp.int32)
    gc = lax.broadcasted_iota(jnp.int32, (local, nx), 1)
    interior = _interior(gr, gc, gny, nx)
    shape = (local, nx)
    for _ in range(iterations):
        px = exchange_rows(p_loc, axis, 1)
        update = ((shifted(p_loc, shape, 0, 1) + shifted(p_loc, shape, 0, -1))
                  / dx2
                  + (px[2:local + 2, :] + px[0:local, :]) / dy2
                  - rhs_loc) / denom
        p_loc = jnp.where(interior, update, p_loc)
    return p_loc


def _residual_shard(p_loc, rhs_loc, gny, nx, dx, dy, axis):
    """r = rhs - A p on the interior, 0 on the boundary
    (ops.poisson._mg_residual)."""
    local = p_loc.shape[0]
    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 / dx2 + 2.0 / dy2
    gr = global_row_index(local, axis) + jnp.zeros((1, nx), jnp.int32)
    gc = lax.broadcasted_iota(jnp.int32, (local, nx), 1)
    shape = (local, nx)
    px = exchange_rows(p_loc, axis, 1)
    ap = ((shifted(p_loc, shape, 0, 1) + shifted(p_loc, shape, 0, -1)) / dx2
          + (px[2:local + 2, :] + px[0:local, :]) / dy2
          - denom * p_loc)
    return jnp.where(_interior(gr, gc, gny, nx), rhs_loc - ap, 0.0)


def _restrict_shard(fine_loc, gny_f, nx_f, gny_c, nx_c, axis):
    """Full-weighting + boundary injection (ops.poisson._mg_restrict)
    on a row-sharded fine block. Requires even local rows and an even
    global row offset (guaranteed: descent only happens while
    gny % 2*n_shards == 0)."""
    local = fine_loc.shape[0]
    fx = exchange_rows(fine_loc, axis, 1)          # rows off-1 .. off+local
    c = fx[1:local + 1, :]
    up = fx[2:local + 2, :]                        # j+1
    dn = fx[0:local, :]                            # j-1
    shape = (local, nx_f)
    sh = lambda a, di: shifted(a, shape, 0, di)
    w9 = (c
          + 0.5 * (sh(c, 1) + sh(c, -1) + up + dn)
          + 0.25 * (sh(up, 1) + sh(up, -1) + sh(dn, 1) + sh(dn, -1))) / 4.0
    core = every_other(every_other(w9, 0), 1)[:, :nx_c]  # local rows
    loc_c = local // 2
    # Injection rows/cols, sampled from locally available data; the
    # global-row masks keep them dead on shards that don't own them.
    bot_row = every_other(fine_loc[0:1], 1)[:, :nx_c]
    top_row = every_other(fine_loc[local - 1:local], 1)[:, :nx_c]
    left_col = every_other(fine_loc[:, 0:1], 0)[:loc_c, :]
    right_col = every_other(fine_loc[:, nx_f - 1:nx_f], 0)[:loc_c, :]
    gr_c = global_row_index(loc_c, axis) + jnp.zeros((1, nx_c), jnp.int32)
    gc_c = lax.broadcasted_iota(jnp.int32, (loc_c, nx_c), 1)
    out = core
    out = jnp.where(gr_c == 0, bot_row, out)
    out = jnp.where(gr_c == gny_c - 1, top_row, out)
    out = jnp.where(gc_c == 0, left_col, out)       # columns last: corners
    out = jnp.where(gc_c == nx_c - 1, right_col, out)  # take column values
    return out


def _prolong_shard(coarse_loc, gny_c, nx_c, nx_f, axis):
    """Bilinear prolongation (ops.poisson._mg_prolong) of a row-sharded
    coarse block to the 2x-rows fine block."""
    loc_c = coarse_loc.shape[0]
    loc_f = 2 * loc_c
    # x direction (all local): fine col i reads coarse i//2, i//2+1.
    right = shifted(coarse_loc, coarse_loc.shape, 0, 1)
    gc = lax.broadcasted_iota(jnp.int32, coarse_loc.shape, 1)
    right = jnp.where(gc == nx_c - 1, coarse_loc, right)
    rep = jnp.repeat(coarse_loc, 2, axis=1)[:, :nx_f]
    rep_r = jnp.repeat(right, 2, axis=1)[:, :nx_f]
    a = (lax.broadcasted_iota(jnp.int32, (loc_c, nx_f), 1) % 2
         ).astype(coarse_loc.dtype) * 0.5
    row = rep * (1 - a) + rep_r * a
    # y direction: "next" coarse row comes from the 1-row upper halo,
    # clamped to itself at the global top row.
    rowx = exchange_rows(row, axis, 1)
    down = rowx[2:loc_c + 2, :]
    gr_c = global_row_index(loc_c, axis) + jnp.zeros((1, nx_f), jnp.int32)
    down = jnp.where(gr_c == gny_c - 1, row, down)
    rep_y = jnp.repeat(row, 2, axis=0)[:loc_f, :]
    rep_d = jnp.repeat(down, 2, axis=0)[:loc_f, :]
    b = (lax.broadcasted_iota(jnp.int32, (loc_f, nx_f), 0) % 2
         ).astype(coarse_loc.dtype) * 0.5
    return rep_y * (1 - b) + rep_d * b


def _vcycle_shard(p_loc, rhs_loc, gny, nx, dx, dy, n_shards, axis, opts):
    from ..ops.poisson import _mg_prolong, _mg_restrict, _mg_vcycle
    p_loc = _smooth_shard(p_loc, rhs_loc, gny, nx, dx, dy,
                          opts.mg_pre_smooth, axis)
    if nx <= opts.mg_coarsest or gny <= opts.mg_coarsest:
        return _smooth_shard(p_loc, rhs_loc, gny, nx, dx, dy,
                             opts.mg_coarse_smooth, axis)
    r_loc = _residual_shard(p_loc, rhs_loc, gny, nx, dx, dy, axis)
    nx_c, gny_c = (nx + 1) // 2, (gny + 1) // 2
    if gny % (2 * n_shards) == 0:
        r_c = _restrict_shard(r_loc, gny, nx, gny_c, nx_c, axis)
        e_c = _vcycle_shard(jnp.zeros_like(r_c), r_c, gny_c, nx_c,
                            2 * dx, 2 * dy, n_shards, axis, opts)
        p_loc = p_loc + _prolong_shard(e_c, gny_c, nx_c, nx, axis)
    else:
        # Coarse-grid agglomeration: replicate the rest of the cycle.
        r_full = lax.all_gather(r_loc, axis, axis=0, tiled=True)
        r_c = _mg_restrict(r_full, nx_c, gny_c)
        e_c = _mg_vcycle(jnp.zeros_like(r_c), r_c, 2 * dx, 2 * dy, opts)
        e_f = _mg_prolong(e_c, nx, gny)
        local = gny // n_shards
        i0 = lax.axis_index(axis) * local
        p_loc = p_loc + lax.dynamic_slice(e_f, (i0, 0), (local, nx))
    return _smooth_shard(p_loc, rhs_loc, gny, nx, dx, dy,
                         opts.mg_post_smooth, axis)


# ---------------------------------------------------------------------------
# MG_PRODUCTION (docs/SPEC.md item 12) under explicit sharding: BC-aware
# damped smoother + warm start + divergence-calibrated masked-while exit.
# ---------------------------------------------------------------------------


def _bc_shard(p_loc, gny, nx, axis, cavity):
    """The reference p' BCs on a row-sharded block
    (ops.poisson._apply_pprime_bcs / _apply_pprime_bcs_cavity): rows
    first, then columns (corner order). The row-neighbor values come
    from a 1-row halo exchange so the copy works even at 1 local row
    per shard (the deepest sharded levels)."""
    local = p_loc.shape[0]
    shape = (local, nx)
    px = exchange_rows(p_loc, axis, 1)
    north = px[2:local + 2, :]   # global row r+1
    south = px[0:local, :]       # global row r-1
    gr = global_row_index(local, axis) + jnp.zeros((1, nx), jnp.int32)
    gc = lax.broadcasted_iota(jnp.int32, shape, 1)
    p = jnp.where(gr == 0, north, p_loc)
    p = jnp.where(gr == gny - 1, south, p)
    p = jnp.where(gc == 0, shifted(p, shape, 0, 1), p)
    if cavity:
        p = jnp.where(gc == nx - 1, shifted(p, shape, 0, -1), p)
        p = jnp.where((gr == 0) & (gc == 0), 0.0, p)
    else:
        p = jnp.where(gc == nx - 1, 0.0, p)
    return p


def _smooth_mgp_shard(p_loc, rhs_loc, gny, nx, dx, dy, omega, iterations,
                      axis, cavity):
    """Damped Jacobi WITH the p' BCs every sweep
    (ops.poisson._mgp_smooth) on a row-sharded block; one 1-row halo
    exchange per iteration."""
    if iterations == 0:
        return p_loc
    local = p_loc.shape[0]
    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 / dx2 + 2.0 / dy2
    gr = global_row_index(local, axis) + jnp.zeros((1, nx), jnp.int32)
    gc = lax.broadcasted_iota(jnp.int32, (local, nx), 1)
    interior = _interior(gr, gc, gny, nx)
    shape = (local, nx)
    for _ in range(iterations):
        px = exchange_rows(p_loc, axis, 1)
        update = ((shifted(p_loc, shape, 0, 1) + shifted(p_loc, shape, 0, -1))
                  / dx2
                  + (px[2:local + 2, :] + px[0:local, :]) / dy2
                  - rhs_loc) / denom
        new = omega * update + (1.0 - omega) * p_loc
        p_loc = jnp.where(interior, new, p_loc)
        p_loc = _bc_shard(p_loc, gny, nx, axis, cavity)
    return p_loc


def _aligned_restrict_shard(r_loc, gny, nx, axis):
    """_cc_restrict of the interior residual under row sharding. The x
    pass is column-local (ops.poisson._cc_restrict_x, shared bitwise);
    the y pass pairs interior-even rows (global-odd) with their +1
    partner, which sits at most one row into the next shard -- a 1-row
    halo. Each shard owns local//2 contiguous coarse rows, so a tiled
    all_gather reassembles the COARSE level (4x fewer bytes than the
    fine field); the last gathered row is the nonexistent pair
    (gny-1, gny) and is sliced off. Requires even local rows."""
    from ..ops.poisson import _cc_restrict_x
    local = r_loc.shape[0]
    fx = _cc_restrict_x(r_loc[:, 1:nx - 1])
    px = exchange_rows(fx, axis, 1)          # rows off-1 .. off+local
    top = every_other(fx, 0, 1)  # interior-even = global-odd
    bot = every_other(px, 0, 3)  # +1 partners (halo at seam)
    blk = 0.5 * (top + bot)                  # (local//2, nx_c)
    r_c = lax.all_gather(blk, axis, axis=0, tiled=True)
    return lax.slice(r_c, (0, 0), ((gny - 2) // 2, blk.shape[1]))


def _vcycle_mgp_aligned_shard(p_loc, rhs_loc, gny, nx, dx, dy, n_shards,
                              axis, opts, cavity):
    """Aligned MGP V-cycle (ops.poisson._mgp_vcycle_aligned) on
    row-sharded blocks. Fine-level smoothing, the residual and the
    first restriction stay sharded (1-row halos); the coarse hierarchy
    below -- O(N/4) work with an exact FDM bottom -- is agglomerated:
    gathered at coarse size and computed REPLICATED through the very
    same ops.poisson._cc_correction_from_coarse the single-device
    cycle calls, then row-sliced back. Identical arithmetic on
    identical values => bitwise equality with the single-device solve
    (tests/test_shmap.py); one coarse-size all_gather per cycle, and
    the aligned scheme needs only 2-4 cycles (vs the legacy scheme's
    tens -- PERF.md)."""
    from ..ops.poisson import (_cc_correction_from_coarse,
                               _mgp_aligned_correction)
    omega = opts.jacobi_omega
    local = p_loc.shape[0]
    small = min(gny - 2, nx - 2) <= opts.mgp_coarse_stop
    if not small:
        p_loc = _smooth_mgp_shard(p_loc, rhs_loc, gny, nx, dx, dy, omega,
                                  opts.mgp_smooth, axis, cavity)
    r_loc = _residual_shard(p_loc, rhs_loc, gny, nx, dx, dy, axis)
    if small or local % 2:
        # Tiny level (or odd local rows, where the pair split breaks):
        # gather the fine residual -- small by construction for the
        # FDM case, a documented fallback otherwise.
        r_full = lax.all_gather(r_loc, axis, axis=0, tiled=True)
        e_full = _mgp_aligned_correction(r_full, dx, dy, opts,
                                         east_dirichlet=not cavity)
    else:
        r_c = _aligned_restrict_shard(r_loc, gny, nx, axis)
        e_int = _cc_correction_from_coarse(r_c, gny - 2, nx - 2, dx, dy,
                                           opts, not cavity)
        e_full = jnp.pad(e_int, 1)
    i0 = lax.axis_index(axis) * local
    p_loc = _bc_shard(
        p_loc + lax.dynamic_slice(e_full, (i0, 0), (local, nx)),
        gny, nx, axis, cavity)
    if not small:
        p_loc = _smooth_mgp_shard(p_loc, rhs_loc, gny, nx, dx, dy, omega,
                                  opts.mgp_smooth, axis, cavity)
    return p_loc


def _vcycle_mgp_shard(p_loc, rhs_loc, gny, nx, dx, dy, n_shards, axis,
                      opts, cavity):
    """One BC-aware V-cycle (ops.poisson._mgp_vcycle) on row-sharded
    blocks; coarse-grid agglomeration once rows stop splitting evenly
    over the mesh axis (same descent rule as the parity V-cycle).
    opts.mgp_scheme == "aligned" (the default) routes to the aligned
    hierarchy exactly as ops.poisson.multigrid_production does."""
    from ..ops.poisson import (_apply_pprime_bcs, _apply_pprime_bcs_cavity,
                               _mg_prolong, _mg_restrict, _mgp_vcycle)
    if getattr(opts, "mgp_scheme", "auto") != "legacy":
        # "auto" is aligned, as in ops.poisson.multigrid_production.
        return _vcycle_mgp_aligned_shard(p_loc, rhs_loc, gny, nx, dx, dy,
                                         n_shards, axis, opts, cavity)
    omega = opts.jacobi_omega
    p_loc = _smooth_mgp_shard(p_loc, rhs_loc, gny, nx, dx, dy, omega,
                              opts.mgp_smooth, axis, cavity)
    if nx <= opts.mg_coarsest or gny <= opts.mg_coarsest:
        return _smooth_mgp_shard(p_loc, rhs_loc, gny, nx, dx, dy, omega,
                                 opts.mg_coarse_smooth, axis, cavity)
    r_loc = _residual_shard(p_loc, rhs_loc, gny, nx, dx, dy, axis)
    nx_c, gny_c = (nx + 1) // 2, (gny + 1) // 2
    if gny % (2 * n_shards) == 0:
        r_c = _restrict_shard(r_loc, gny, nx, gny_c, nx_c, axis)
        e_c = _vcycle_mgp_shard(jnp.zeros_like(r_c), r_c, gny_c, nx_c,
                                2 * dx, 2 * dy, n_shards, axis, opts,
                                cavity)
        p_loc = _bc_shard(
            p_loc + _prolong_shard(e_c, gny_c, nx_c, nx, axis),
            gny, nx, axis, cavity)
    else:
        bc = _apply_pprime_bcs_cavity if cavity else _apply_pprime_bcs
        r_full = lax.all_gather(r_loc, axis, axis=0, tiled=True)
        r_c = _mg_restrict(r_full, nx_c, gny_c)
        e_c = _mgp_vcycle(jnp.zeros_like(r_c), r_c, 2 * dx, 2 * dy, opts,
                          bc)
        e_f = _mg_prolong(e_c, nx, gny)
        local = gny // n_shards
        i0 = lax.axis_index(axis) * local
        p_loc = _bc_shard(
            p_loc + lax.dynamic_slice(e_f, (i0, 0), (local, nx)),
            gny, nx, axis, cavity)
    return _smooth_mgp_shard(p_loc, rhs_loc, gny, nx, dx, dy, omega,
                             opts.mgp_smooth, axis, cavity)


def mgp_shard_body(pp0_loc: jnp.ndarray, rhs_loc: jnp.ndarray, gny: int,
                   nx: int, axis: str, dx: float, dy: float,
                   n_shards: int, opts, cavity: bool, tol_r):
    """Shard-local MG_PRODUCTION solve (ops.poisson.multigrid_production
    under explicit sharding): warm-started BC-aware V-cycles until the
    globally pmax'd max|rhs - A p'| <= tol_r, at most mgp_max_cycles.
    opts.mgp_rtol > 0 widens tol_r to max(tol_r, rtol * r0) exactly as
    ops.poisson.multigrid_production does, with r0 the globally pmax'd
    warm-start residual. Returns (local p', global max|residual|)."""
    import dataclasses as _dc

    from ..ops.poisson import _masked_while, _mgp_noise_floor

    if opts.mgp_smooth == 3 and gny * nx >= 48_000_000:
        # mirror multigrid_production's size-aware smoothing strength
        # so the tiers keep identical numerics at every size
        opts = _dc.replace(opts, mgp_smooth=5)

    def cycle(p_loc):
        p_loc = _vcycle_mgp_shard(p_loc, rhs_loc, gny, nx, dx, dy,
                                  n_shards, axis, opts, cavity)
        r_loc = _residual_shard(p_loc, rhs_loc, gny, nx, dx, dy, axis)
        # Global reduction: every shard must agree on the exit.
        err = lax.pmax(jnp.max(jnp.abs(r_loc)), axis)
        return p_loc, err

    p0 = _bc_shard(pp0_loc, gny, nx, axis, cavity)
    if getattr(opts, "mgp_rtol", 0.0) > 0.0:
        r0 = _residual_shard(p0, rhs_loc, gny, nx, dx, dy, axis)
        err0 = lax.pmax(jnp.max(jnp.abs(r0)), axis)
        tol_r = jnp.maximum(jnp.asarray(tol_r, pp0_loc.dtype),
                            opts.mgp_rtol * err0)
    floor = _mgp_noise_floor(opts, dx, dy, pp0_loc.dtype)
    if floor is not None:
        # Globally pmax'd scales, so every shard computes the identical
        # floor and fires the exit on the same cycle (same criterion as
        # ops.poisson.multigrid_production).
        rhs_max = lax.pmax(jnp.max(jnp.abs(rhs_loc)), axis)
        inner = cycle

        def cycle(p_loc):  # noqa: F811 -- floor-augmented variant
            p_loc, err = inner(p_loc)
            p_max = lax.pmax(jnp.max(jnp.abs(p_loc)), axis)
            return p_loc, err, floor(p_max, rhs_max)

        p_loc, err, _ = _masked_while(cycle, p0, tol_r,
                                      opts.mgp_max_cycles,
                                      dynamic_tol=True)
        return p_loc, err
    p_loc, err, _ = _masked_while(cycle, p0, tol_r, opts.mgp_max_cycles)
    return p_loc, err


# ---------------------------------------------------------------------------
# MG_PRODUCTION on the 2-D rows x cols mesh (round 4):
# the production projection scaled on BOTH grid axes. Fine-level
# smoothing/residual/restriction run (rows x cols)-sharded with 1-wide
# both-axis ppermute halos; the coarse hierarchy agglomerates exactly
# like the rows tier (gathered at coarse size -- 4x fewer bytes than the
# fine field -- and computed replicated through the very same
# ops.poisson._cc_correction_from_coarse), so identical arithmetic on
# identical values gives equality with the single-device solve
# (tests/test_shmap.py). Implements the aligned hierarchy only (the
# default; the legacy vertex-transfer scheme stays rows-tier/XLA).
# ---------------------------------------------------------------------------


def _gidx2d(shape, yaxis: str, xaxis: str):
    """(global_row, global_col) int32 iotas of a (loc_y, loc_x) block
    on the rows x cols mesh."""
    loc_y, loc_x = shape
    gr = (lax.axis_index(yaxis) * loc_y
          + lax.broadcasted_iota(jnp.int32, shape, 0))
    gc = (lax.axis_index(xaxis) * loc_x
          + lax.broadcasted_iota(jnp.int32, shape, 1))
    return gr, gc


def _bc_shard2d(p_loc, gny, gnx, yaxis, xaxis, cavity):
    """The reference p' BCs on a (rows x cols)-sharded block: rows
    first, then columns (corner order). Every value a boundary write
    reads is LOCAL to the shard that owns the written cell (row 0 reads
    row 1, column 0 reads column 1, ...; loc_y >= 8 and loc_x >= 8 on
    this tier), so no halo exchange is needed -- shifted's zero fill
    only lands where the global-index masks are false."""
    p = p_loc
    gr, gc = _gidx2d(p.shape, yaxis, xaxis)
    p = jnp.where(gr == 0, shifted(p, p.shape, 1, 0), p)
    p = jnp.where(gr == gny - 1, shifted(p, p.shape, -1, 0), p)
    p = jnp.where(gc == 0, shifted(p, p.shape, 0, 1), p)
    if cavity:
        p = jnp.where(gc == gnx - 1, shifted(p, p.shape, 0, -1), p)
        p = jnp.where((gr == 0) & (gc == 0), 0.0, p)
    else:
        p = jnp.where(gc == gnx - 1, 0.0, p)
    return p


def _smooth_mgp_shard2d(p_loc, rhs_loc, gny, gnx, dx, dy, omega,
                        iterations, yaxis, xaxis, cavity):
    """Damped Jacobi WITH the p' BCs every sweep
    (ops.poisson._mgp_smooth) on a (rows x cols)-sharded block; one
    1-wide halo exchange per axis per iteration."""
    if iterations == 0:
        return p_loc
    loc_y, loc_x = p_loc.shape
    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 / dx2 + 2.0 / dy2
    gr, gc = _gidx2d(p_loc.shape, yaxis, xaxis)
    interior = _interior(gr, gc, gny, gnx)
    for _ in range(iterations):
        px = exchange_rows(p_loc, yaxis, 1)
        pc = exchange_cols(p_loc, xaxis, 1)
        update = ((pc[:, 2:loc_x + 2] + pc[:, 0:loc_x]) / dx2
                  + (px[2:loc_y + 2, :] + px[0:loc_y, :]) / dy2
                  - rhs_loc) / denom
        new = omega * update + (1.0 - omega) * p_loc
        p_loc = jnp.where(interior, new, p_loc)
        p_loc = _bc_shard2d(p_loc, gny, gnx, yaxis, xaxis, cavity)
    return p_loc


def _residual_shard2d(p_loc, rhs_loc, gny, gnx, dx, dy, yaxis, xaxis):
    """r = rhs - A p on the interior, 0 on the boundary
    (ops.poisson._mg_residual) on a (rows x cols)-sharded block."""
    loc_y, loc_x = p_loc.shape
    dx2, dy2 = dx * dx, dy * dy
    denom = 2.0 / dx2 + 2.0 / dy2
    gr, gc = _gidx2d(p_loc.shape, yaxis, xaxis)
    px = exchange_rows(p_loc, yaxis, 1)
    pc = exchange_cols(p_loc, xaxis, 1)
    ap = ((pc[:, 2:loc_x + 2] + pc[:, 0:loc_x]) / dx2
          + (px[2:loc_y + 2, :] + px[0:loc_y, :]) / dy2
          - denom * p_loc)
    return jnp.where(_interior(gr, gc, gny, gnx), rhs_loc - ap, 0.0)


def _aligned_restrict_shard2d(r_loc, gny, gnx, yaxis, xaxis):
    """_cc_restrict of the interior residual under rows x cols
    sharding. Both axes pair interior-even entries (global-odd index,
    since shard offsets are even) with their +1 partner, which sits at
    most one row/column into the next shard -- a 1-wide halo per axis.
    Each shard owns a contiguous (loc_y/2, loc_x/2) coarse block, so
    tiled all_gathers on both axes reassemble the COARSE level (4x
    fewer bytes than the fine field); the last gathered row/column is
    the nonexistent pair (gn-1, gn) and is sliced off. Requires even
    local rows AND columns (fall back to the full gather otherwise)."""
    loc_y, loc_x = r_loc.shape
    # x pass: local-odd columns (= global-odd) pair with the +1 column.
    pc = exchange_cols(r_loc, xaxis, 1)        # cols c0-1 .. c0+loc_x
    left = every_other(r_loc, 1, 1)  # global-odd columns
    right = every_other(pc, 1, 3)  # +1 partners (halo at seam)
    fx = 0.5 * (left + right)                  # (loc_y, loc_x/2)
    # y pass on the half-width block.
    px = exchange_rows(fx, yaxis, 1)
    top = every_other(fx, 0, 1)
    bot = every_other(px, 0, 3)
    blk = 0.5 * (top + bot)                    # (loc_y/2, loc_x/2)
    r_c = lax.all_gather(blk, xaxis, axis=1, tiled=True)
    r_c = lax.all_gather(r_c, yaxis, axis=0, tiled=True)
    return lax.slice(r_c, (0, 0), ((gny - 2) // 2, (gnx - 2) // 2))


def _vcycle_mgp_aligned_shard2d(p_loc, rhs_loc, gny, gnx, dx, dy,
                                yaxis, xaxis, opts, cavity):
    """Aligned MGP V-cycle (ops.poisson._mgp_vcycle_aligned) on
    (rows x cols)-sharded blocks: both-axis-sharded smoothing, residual
    and first restriction; the coarse hierarchy below agglomerated and
    computed replicated, then sliced back by (row, col) offset."""
    from ..ops.poisson import (_cc_correction_from_coarse,
                               _mgp_aligned_correction)
    omega = opts.jacobi_omega
    loc_y, loc_x = p_loc.shape
    small = min(gny - 2, gnx - 2) <= opts.mgp_coarse_stop
    if not small:
        p_loc = _smooth_mgp_shard2d(p_loc, rhs_loc, gny, gnx, dx, dy,
                                    omega, opts.mgp_smooth, yaxis, xaxis,
                                    cavity)
    r_loc = _residual_shard2d(p_loc, rhs_loc, gny, gnx, dx, dy,
                              yaxis, xaxis)
    if small or loc_y % 2 or loc_x % 2:
        r_full = lax.all_gather(
            lax.all_gather(r_loc, xaxis, axis=1, tiled=True),
            yaxis, axis=0, tiled=True)
        e_full = _mgp_aligned_correction(r_full, dx, dy, opts,
                                         east_dirichlet=not cavity)
    else:
        r_c = _aligned_restrict_shard2d(r_loc, gny, gnx, yaxis, xaxis)
        e_int = _cc_correction_from_coarse(r_c, gny - 2, gnx - 2, dx, dy,
                                           opts, not cavity)
        e_full = jnp.pad(e_int, 1)
    i0 = lax.axis_index(yaxis) * loc_y
    j0 = lax.axis_index(xaxis) * loc_x
    p_loc = _bc_shard2d(
        p_loc + lax.dynamic_slice(e_full, (i0, j0), (loc_y, loc_x)),
        gny, gnx, yaxis, xaxis, cavity)
    if not small:
        p_loc = _smooth_mgp_shard2d(p_loc, rhs_loc, gny, gnx, dx, dy,
                                    omega, opts.mgp_smooth, yaxis, xaxis,
                                    cavity)
    return p_loc


def mgp_shard_body_2d(pp0_loc: jnp.ndarray, rhs_loc: jnp.ndarray,
                      gny: int, gnx: int, yaxis: str, xaxis: str,
                      dx: float, dy: float, opts, cavity: bool, tol_r):
    """Shard-local MG_PRODUCTION solve on the 2-D rows x cols mesh
    (ops.poisson.multigrid_production under explicit 2-axis sharding):
    warm-started BC-aware aligned V-cycles until the globally (both
    axes) pmax'd max|rhs - A p'| <= tol_r, at most mgp_max_cycles.
    Same rtol widening / f32-noise-floor exit as every other tier, on
    pmax2'd scales so all shards fire the exit on the same cycle.
    Returns (local p', global max|residual|)."""
    import dataclasses as _dc

    from ..ops.poisson import _masked_while, _mgp_noise_floor

    if opts.mgp_smooth == 3 and gny * gnx >= 48_000_000:
        # mirror multigrid_production's size-aware smoothing strength
        opts = _dc.replace(opts, mgp_smooth=5)
    if getattr(opts, "mgp_scheme", "auto") == "legacy":
        raise ValueError("mgp_shard_body_2d implements the aligned "
                         "hierarchy only; legacy runs on the rows tier")

    def pmax2(x):
        return lax.pmax(lax.pmax(x, yaxis), xaxis)

    def cycle(p_loc):
        p_loc = _vcycle_mgp_aligned_shard2d(p_loc, rhs_loc, gny, gnx,
                                            dx, dy, yaxis, xaxis, opts,
                                            cavity)
        r_loc = _residual_shard2d(p_loc, rhs_loc, gny, gnx, dx, dy,
                                  yaxis, xaxis)
        return p_loc, pmax2(jnp.max(jnp.abs(r_loc)))

    p0 = _bc_shard2d(pp0_loc, gny, gnx, yaxis, xaxis, cavity)
    fixed_cycles = getattr(opts, "mgp_fixed_cycles", 0)
    if fixed_cycles > 0:
        # Deterministic fixed schedule (ops.poisson._mgp_fixed twin):
        # exactly ``cycles`` V-cycles, no adaptive exits,
        # so the 2-D tier matches single-device fields for this config
        # instead of silently running the masked adaptive loop.
        p_loc, err = p0, jnp.zeros((), p0.dtype)
        for _ in range(fixed_cycles):
            p_loc, err = cycle(p_loc)
        return p_loc, err
    if getattr(opts, "mgp_rtol", 0.0) > 0.0:
        r0 = _residual_shard2d(p0, rhs_loc, gny, gnx, dx, dy,
                               yaxis, xaxis)
        err0 = pmax2(jnp.max(jnp.abs(r0)))
        tol_r = jnp.maximum(jnp.asarray(tol_r, pp0_loc.dtype),
                            opts.mgp_rtol * err0)
    floor = _mgp_noise_floor(opts, dx, dy, pp0_loc.dtype)
    if floor is not None:
        rhs_max = pmax2(jnp.max(jnp.abs(rhs_loc)))
        inner = cycle

        def cycle(p_loc):  # noqa: F811 -- floor-augmented variant
            p_loc, err = inner(p_loc)
            p_max = pmax2(jnp.max(jnp.abs(p_loc)))
            return p_loc, err, floor(p_max, rhs_max)

        p_loc, err, _ = _masked_while(cycle, p0, tol_r,
                                      opts.mgp_max_cycles,
                                      dynamic_tol=True)
        return p_loc, err
    p_loc, err, _ = _masked_while(cycle, p0, tol_r, opts.mgp_max_cycles)
    return p_loc, err


def mg_shard_body(rhs_loc: jnp.ndarray, gny: int, nx: int, axis: str,
                  dx: float, dy: float, n_shards: int, opts):
    """Shard-local body of the multi-chip multigrid solve: call INSIDE
    shard_map over a row-sharded (gny, nx) rhs. Zero-initializes p'
    like ops.poisson.multigrid (index.html:777). Returns
    (local p', global max |residual|)."""
    pp_loc = jnp.zeros_like(rhs_loc)
    for _ in range(opts.mg_cycles):
        pp_loc = _vcycle_shard(pp_loc, rhs_loc, gny, nx, dx, dy,
                               n_shards, axis, opts)
    r_loc = _residual_shard(pp_loc, rhs_loc, gny, nx, dx, dy, axis)
    err = lax.pmax(jnp.max(jnp.abs(r_loc)), axis)
    return pp_loc, err


def multigrid_shmap(rhs: jnp.ndarray, mesh: Mesh, dx: float, dy: float,
                    opts, axis: str = "y"):
    """Multi-chip multigrid solve of A p' = rhs over a row-sharded
    (ny, nx) rhs; equals ops.poisson.multigrid bitwise. Requires
    ny % n_shards == 0."""
    ny, nx = rhs.shape
    n_shards = mesh.shape[axis]
    if ny % n_shards != 0:
        raise ValueError(f"ny={ny} must divide over {n_shards} shards")

    def shard_fn(rhs_loc):
        return mg_shard_body(rhs_loc, ny, nx, axis, dx, dy, n_shards, opts)

    fn = jax.shard_map(shard_fn, mesh=mesh,
                       in_specs=(P(axis, None),),
                       out_specs=(P(axis, None), P()))
    return fn(rhs)
