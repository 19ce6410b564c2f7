"""Stride-2 picks as strided slices (ops.stencil.every_other), the
restrictions built from them against plain numpy loops, and no gather
left in any solver's step program."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cfd_demo_jax import (Cylinder, Grid, PressureSolver, Semantics,
                          SimulationParams, make_scene, solver_options_for)
from cfd_demo_jax.ops.poisson import (_cc_coarse_size, _cc_restrict,
                                      _mg_restrict)
from cfd_demo_jax.ops.stencil import every_other
from cfd_demo_jax.solver.piso import step_fn


@pytest.mark.parametrize("shape", [(7, 5), (8, 6), (1, 4), (9, 1)])
@pytest.mark.parametrize("axis,start", [(0, 0), (1, 1)])
def test_every_other_is_numpy_stride(shape, axis, start):
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    want = x[start::2] if axis == 0 else x[:, start::2]
    np.testing.assert_array_equal(np.asarray(every_other(jnp.asarray(x),
                                                         axis, start)), want)


def _mg_restrict_loops(f, nx_c, ny_c):
    """index.html:1372-1395 as loops: full weighting inside, injection
    on the boundary rows, then columns (corners take column values)."""
    ny_f, nx_f = f.shape
    pad = np.pad(f.astype(np.float64), 1)
    out = np.zeros((ny_c, nx_c))
    for j in range(ny_c):
        for i in range(nx_c):
            y, x = 2 * j + 1, 2 * i + 1
            w = pad[y - 1:y + 2, x - 1:x + 2]
            out[j, i] = (w[1, 1] + 0.5 * (w[0, 1] + w[2, 1] + w[1, 0]
                                          + w[1, 2])
                         + 0.25 * (w[0, 0] + w[0, 2] + w[2, 0]
                                   + w[2, 2])) / 4.0
    out[0, :] = f[0, 0:2 * nx_c:2]
    out[-1, :] = f[ny_f - 1, 0:2 * nx_c:2]
    out[:, 0] = f[0:2 * ny_c:2, 0]
    out[:, -1] = f[0:2 * ny_c:2, nx_f - 1]
    return out


@pytest.mark.parametrize("ny,nx", [(16, 24), (13, 25), (9, 9), (18, 33)])
def test_mg_restrict_matches_loops(ny, nx):
    f = np.random.default_rng(ny * nx).standard_normal((ny, nx))
    nx_c, ny_c = (nx + 1) // 2, (ny + 1) // 2
    got = jax.jit(_mg_restrict, static_argnums=(1, 2))(
        jnp.asarray(f, jnp.float32), nx_c, ny_c)
    np.testing.assert_allclose(np.asarray(got),
                               _mg_restrict_loops(f, nx_c, ny_c),
                               rtol=1e-6, atol=1e-6)


def _cc_restrict_axis(f):
    """The cell-centered pair average along axis 0 with the odd-size
    rule: even -> pairs; odd -> mirror-pad the first cell or fold the
    first three cells into one, whichever _cc_coarse_size picks."""
    n = f.shape[0]
    if n % 2:
        if _cc_coarse_size(n) == (n + 1) // 2:
            f = np.concatenate([f[:1], f])
        else:
            rest = _cc_restrict_axis(f[1:])
            rest[0] = f[:3].mean(axis=0)
            return rest
    return 0.5 * (f[0::2] + f[1::2])


@pytest.mark.parametrize("ny,nx", [(8, 12), (7, 12), (8, 11), (9, 13)])
def test_cc_restrict_matches_pair_averages(ny, nx):
    f = np.random.default_rng(ny + nx).standard_normal((ny, nx))
    want = _cc_restrict_axis(_cc_restrict_axis(f.T).T)
    got = jax.jit(_cc_restrict)(jnp.asarray(f, jnp.float32))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("semantics", list(Semantics), ids=lambda s: s.value)
@pytest.mark.parametrize("solver", list(PressureSolver), ids=lambda s: s.value)
def test_step_program_has_no_gather(solver, semantics):
    """XLA:GPU mis-fused a gather behind the multigrid stencil; the step
    of every solver lowers with strided slices only."""
    grid = Grid(nx=40, ny=24, lx=4.0, ly=2.4,
                obstacles=(Cylinder(1.0, 1.2, 0.3),))
    scene = make_scene(grid, SimulationParams(pressure_solver=solver),
                       solver_options_for(semantics))
    text = jax.jit(lambda s: step_fn(scene, s)).lower(
        scene.init_state()).as_text()
    assert "gather" not in text and "scatter" not in text
