"""Device-mesh grid decomposition (SURVEY.md section 2.7).

The reference is single-address-space (its whole "comm stack" is three
mpsc channels and 8-wide SIMD); scale-out is a new capability: the
(ny, nx) field arrays are sharded by *rows* (y) across a mesh axis, so
the x axis stays contiguous on each device.

jit + NamedSharding: XLA's SPMD partitioner (GSPMD) turns every stencil
shift into the 1-2 row halo exchanges automatically and every jnp.max
into a global reduction -- the compiler-generated form of hand-written
NCCL halo code. Three layouts: rows (make_sharded_step), rows x cols
(make_sharded_step_2d) and ensemble batch (make_batch_sharded_step,
also composed with rows via make_mesh2d).
"""
from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.state import State
from ..solver.piso import Scene, step_fn


ROW_AXIS = "y"
COL_AXIS = "x"


def make_mesh(devices: Optional[Sequence] = None, axis: str = ROW_AXIS) -> Mesh:
    """1-D mesh over all (or the given) devices."""
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devices), (axis,))


def make_mesh2d_spatial(n_rows: int, n_cols: int,
                        devices: Optional[Sequence] = None) -> Mesh:
    """2-D SPATIAL device mesh: grid rows over 'y' x grid columns over
    'x' (SURVEY.md:201 "ghost columns/rows per neighbor"). Where the
    1-D row split degenerates at high device counts (halo bytes scale
    with full nx; ny/S row floors), a rows x cols decomposition keeps
    shards square-ish: per-shard halo bytes scale with nx/n_cols +
    ny/n_rows and the row floor applies per row-tier only. GSPMD
    inserts the column halos exactly like the row halos -- every
    stencil is a shifted view, every boundary write an iota
    mask-select, so nothing in the step distinguishes the axes."""
    devices = list(devices) if devices is not None else jax.devices()
    if n_rows * n_cols != len(devices):
        raise ValueError(f"{n_rows}x{n_cols} != {len(devices)} devices")
    return Mesh(np.array(devices).reshape(n_rows, n_cols),
                (ROW_AXIS, COL_AXIS))


def state_shardings(mesh: Mesh, axis: str = ROW_AXIS) -> State:
    """A State-shaped pytree of NamedShardings: fields row-sharded
    (and column-sharded too on a make_mesh2d_spatial mesh), scalars
    replicated."""
    col = COL_AXIS if COL_AXIS in mesh.axis_names else None
    row = NamedSharding(mesh, P(axis, col))
    rep = NamedSharding(mesh, P())
    return State(
        u=row, v=row, p=row, p_prime=row,
        u_prev=row, v_prev=row,
        dt=rep, dt_user=rep, nu=rep, target_inlet=rep,
        t=rep, step=rep, substeps=rep,
        res_u=rep, res_v=rep, res_p=rep)


def _match(shardings: State, state: State) -> State:
    """Drop sharding entries for absent (None) state leaves."""
    return dataclasses.replace(
        shardings,
        u_prev=shardings.u_prev if state.u_prev is not None else None,
        v_prev=shardings.v_prev if state.v_prev is not None else None)


def shard_state(state: State, mesh: Mesh, axis: str = ROW_AXIS) -> State:
    sh = _match(state_shardings(mesh, axis), state)
    return jax.tree.map(lambda x, s: jax.device_put(x, s), state, sh,
                        is_leaf=lambda x: x is None)


def make_sharded_step(scene: Scene, mesh: Mesh, axis: str = ROW_AXIS,
                      donate: bool = False):
    """jit step with GSPMD row decomposition over ``mesh``."""
    example = scene.init_state()
    sh = _match(state_shardings(mesh, axis), example)
    diag_sh = jax.tree.map(lambda _: NamedSharding(mesh, P()),
                           _example_diag())
    fn = partial(step_fn, scene)
    return jax.jit(fn, in_shardings=(sh,), out_shardings=(sh, diag_sh),
                   donate_argnums=(0,) if donate else ())


def _example_diag():
    from ..solver.piso import StepDiagnostics
    return StepDiagnostics(step=0, t=0, dt=0, res_u=0, res_v=0, res_p=0,
                           substeps=0, p_iters=0, rounds=0)


# ---------------------------------------------------------------------------
# 2-D spatial (rows x cols) decomposition
# ---------------------------------------------------------------------------
#
# Explicit in/out shardings must divide array dims evenly, and u has
# nx+1 columns while every other field has nx -- so the 2-D tier splits
# u's LAST column off at the jit boundary (carried column-replicated;
# it is one column of ny floats) and re-joins it inside the program.
# GSPMD handles the uneven (ny, nx+1) intermediate with internal
# padding; only the boundary must be even. Pure layout adapter: fields
# are bitwise those of the unsharded step.


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Split2D:
    """State with u (and u_prev) trimmed to nx columns + the trimmed
    last columns carried separately."""
    core: State
    u_last: jax.Array                      # (ny, 1)
    u_prev_last: Optional[jax.Array]       # JS semantics only


def split_u(state: State) -> Split2D:
    core = dataclasses.replace(
        state, u=state.u[:, :-1],
        u_prev=None if state.u_prev is None else state.u_prev[:, :-1])
    return Split2D(core=core, u_last=state.u[:, -1:],
                   u_prev_last=(None if state.u_prev is None
                                else state.u_prev[:, -1:]))


def join_u(s: Split2D) -> State:
    import jax.numpy as jnp
    return dataclasses.replace(
        s.core, u=jnp.concatenate([s.core.u, s.u_last], axis=1),
        u_prev=(None if s.core.u_prev is None else
                jnp.concatenate([s.core.u_prev, s.u_prev_last], axis=1)))


def _split_shardings(mesh: Mesh, state: State) -> Split2D:
    row_col = NamedSharding(mesh, P(ROW_AXIS, COL_AXIS))
    row = NamedSharding(mesh, P(ROW_AXIS, None))
    core_sh = dataclasses.replace(
        _match(state_shardings(mesh), state),
        u=row_col, v=row_col, p=row_col, p_prime=row_col,
        u_prev=row_col if state.u_prev is not None else None,
        v_prev=row_col if state.v_prev is not None else None)
    return Split2D(core=core_sh, u_last=row,
                   u_prev_last=row if state.u_prev is not None else None)


def shard_state_2d(state: State, mesh: Mesh) -> Split2D:
    """Place a State on a make_mesh2d_spatial mesh in split-u form."""
    s = split_u(state)
    sh = _split_shardings(mesh, state)
    return jax.tree.map(lambda x, sp: jax.device_put(x, sp), s, sh,
                        is_leaf=lambda x: x is None)


def make_sharded_step_2d(scene: Scene, mesh: Mesh, n_steps: int = 1):
    """jit step (or n_steps-scan) with 2-D rows x cols GSPMD
    decomposition: Split2D -> (Split2D, diag). Use shard_state_2d /
    join_u around it. Requires nx % mesh['x'] == 0 and
    ny % mesh['y'] == 0."""
    g = scene.grid
    if g.nx % mesh.shape[COL_AXIS] or g.ny % mesh.shape[ROW_AXIS]:
        raise ValueError(
            f"grid {g.ny}x{g.nx} must divide over the "
            f"{mesh.shape[ROW_AXIS]}x{mesh.shape[COL_AXIS]} mesh")
    example = scene.init_state()
    sh = _split_shardings(mesh, example)
    diag_sh = jax.tree.map(lambda _: NamedSharding(mesh, P()),
                           _example_diag())

    def fn(s: Split2D):
        state = join_u(s)
        if n_steps == 1:
            state, diag = step_fn(scene, state)
        else:
            from jax import lax

            def body(st, _):
                return step_fn(scene, st)

            state, diag = lax.scan(body, state, None, length=n_steps)
        return split_u(state), diag

    return jax.jit(fn, in_shardings=(sh,), out_shardings=(sh, diag_sh))


BATCH_AXIS = "b"


def make_batch_sharded_step(scene: Scene, mesh: Mesh,
                            axis: str = BATCH_AXIS):
    """Scale-out tier for ENSEMBLES: shard the vmap batch axis over the
    device mesh (serving-style data parallelism, SURVEY.md section
    2.7 "batch parallelism"). Each device advances B/n whole scenes;
    the program is embarrassingly parallel -- the compiled HLO contains
    NO halo collectives (tests/test_sharding.py pins this), unlike the
    row-sharded tiers where every stencil exchanges ghosts.

    Build the mesh with ``make_mesh(axis="b")``; batched State leaves
    carry a leading batch dim (see apps/ensemble.py). The batch size
    must divide evenly over the devices."""
    batch = NamedSharding(mesh, P(axis))

    def shard_leaf(_):
        return batch

    example = scene.init_state()
    sh = _match(jax.tree.map(shard_leaf, state_shardings(mesh, axis)),
                example)
    diag_sh = jax.tree.map(lambda _: batch, _example_diag())
    fn = jax.vmap(partial(step_fn, scene))
    return jax.jit(fn, in_shardings=(sh,), out_shardings=(sh, diag_sh))


def shard_batch(batched_state: State, mesh: Mesh,
                axis: str = BATCH_AXIS) -> State:
    """Place a batched State (leading batch dim on every leaf) with the
    batch dimension split over ``mesh[axis]``."""
    batch = NamedSharding(mesh, P(axis))
    return jax.tree.map(
        lambda x: jax.device_put(x, batch) if x is not None else None,
        batched_state, is_leaf=lambda x: x is None)


def make_mesh2d(n_batch: int, n_rows: int,
                devices: Optional[Sequence] = None) -> Mesh:
    """2-D device mesh composing BOTH parallelism axes: ensemble
    scenes over 'b' x grid rows over 'y' (the dp-x-spatial product).
    GSPMD keeps halo collective-permutes scoped to 'y' subgroups and
    residual reductions per batch row; no gathers
    (tests/test_sharding.py pins equality + the collective pattern)."""
    devices = list(devices) if devices is not None else jax.devices()
    if n_batch * n_rows != len(devices):
        raise ValueError(f"{n_batch}x{n_rows} != {len(devices)} devices")
    return Mesh(np.array(devices).reshape(n_batch, n_rows),
                (BATCH_AXIS, ROW_AXIS))


def shard_batch_rows(batched_state: State, mesh: Mesh) -> State:
    """Place a batched State on a make_mesh2d mesh: field leaves
    (B, ny, nx*) split batch-over-'b' and rows-over-'y'; per-scene
    scalar leaves (B,) split over 'b'."""
    field = NamedSharding(mesh, P(BATCH_AXIS, ROW_AXIS, None))
    scal = NamedSharding(mesh, P(BATCH_AXIS))
    return jax.tree.map(
        lambda x: (None if x is None
                   else jax.device_put(x, field if x.ndim == 3 else scal)),
        batched_state, is_leaf=lambda x: x is None)
