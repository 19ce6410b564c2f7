"""shard_map halo exchanges and solvers vs the single-device solver."""
import numpy as np
import pytest

import jax

import pytest as _pytest

pytestmark = _pytest.mark.skipif(
    len(jax.devices()) < 8,
    reason="needs the 8-device virtual CPU mesh (tests/conftest.py)")

import jax.numpy as jnp

from cfd_demo_jax.ops.poisson import jacobi
from cfd_demo_jax.shard.halo import exchange_rows
from cfd_demo_jax.shard.jacobi_shmap import jacobi_shmap
from cfd_demo_jax.shard.mesh import make_mesh


def test_exchange_rows():
    mesh = make_mesh()
    n = 8 * len(jax.devices())
    x = jnp.arange(n * 4, dtype=jnp.float32).reshape(n, 4)
    from jax.sharding import PartitionSpec as P

    def f(loc):
        return exchange_rows(loc, "y", 2)

    out = jax.shard_map(f, mesh=mesh, in_specs=P("y", None),
                        out_specs=P("y", None))(x)
    out = np.asarray(out)
    local = n // len(jax.devices())
    blk = out.reshape(len(jax.devices()), local + 4, 4)
    ref = np.asarray(x).reshape(len(jax.devices()), local, 4)
    for s in range(len(jax.devices())):
        np.testing.assert_array_equal(blk[s, 2:-2], ref[s])
        if s > 0:
            np.testing.assert_array_equal(blk[s, :2], ref[s - 1][-2:])
        else:
            np.testing.assert_array_equal(blk[s, :2], 0)
        if s < len(jax.devices()) - 1:
            np.testing.assert_array_equal(blk[s, -2:], ref[s + 1][:2])
        else:
            np.testing.assert_array_equal(blk[s, -2:], 0)


@pytest.mark.parametrize("k", [1, 4, 5])
def test_jacobi_shmap_matches_single_device(k):
    rng = np.random.default_rng(0)
    ny = nx = 64
    dx = dy = 1.0 / nx
    pp = jnp.asarray(rng.standard_normal((ny, nx)) * 0.1, jnp.float32)
    rhs = jnp.asarray(rng.standard_normal((ny, nx)), jnp.float32)
    ref, err_ref, _ = jax.jit(
        lambda p, r: jacobi(p, r, dx, dy, 0.75, 0.0, 20, early_exit=False)
    )(pp, rhs)
    mesh = make_mesh()
    got, err_got = jax.jit(
        lambda p, r: jacobi_shmap(p, r, mesh, dx, dy, 0.75, 20, k=k))(pp, rhs)
    np.testing.assert_allclose(np.asarray(ref), np.asarray(got),
                               rtol=0, atol=1e-6)
    assert np.isclose(float(err_ref), float(err_got), rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("ny,nx", [(128, 64), (96, 96)])
def test_multigrid_shmap_matches_single_device(ny, nx):
    """Sharded V-cycle == single-device multigrid kit. 128x64 descends
    fully sharded (every level divides over 8 shards); 96x96 exercises
    the coarse-grid agglomeration fallback (24 % 16 != 0)."""
    from cfd_demo_jax import Semantics, solver_options_for
    from cfd_demo_jax.ops.poisson import multigrid
    from cfd_demo_jax.shard.mg_shmap import multigrid_shmap
    rng = np.random.default_rng(2)
    dx = dy = 1.0 / nx
    rhs = jnp.asarray(rng.standard_normal((ny, nx)), jnp.float32)
    opts = solver_options_for(Semantics.JS)
    ref, err_ref, _ = jax.jit(
        lambda r: multigrid(jnp.zeros_like(r), r, dx, dy, opts))(rhs)
    mesh = make_mesh()
    got, err_got = jax.jit(
        lambda r: multigrid_shmap(r, mesh, dx, dy, opts))(rhs)
    np.testing.assert_allclose(np.asarray(ref), np.asarray(got),
                               rtol=0, atol=1e-7)
    # The residual operator amplifies 1-ulp field differences by
    # ~4/dx^2, so the scalar gets a correspondingly looser rtol.
    assert np.isclose(float(err_ref), float(err_got), rtol=1e-4, atol=1e-7)


def test_exchange_cols():
    """Column-halo primitive for the 2-D spatial mesh."""
    from cfd_demo_jax.shard.halo import exchange_cols
    from jax.sharding import Mesh, PartitionSpec as P
    n = len(jax.devices())
    mesh = Mesh(np.array(jax.devices()), ("x",))
    cols = 4 * n
    x = jnp.arange(8 * cols, dtype=jnp.float32).reshape(8, cols)

    def f(loc):
        return exchange_cols(loc, "x", 2)

    out = jax.shard_map(f, mesh=mesh, in_specs=P(None, "x"),
                        out_specs=P(None, "x"))(x)
    out = np.asarray(out)
    local = cols // n
    ref = np.asarray(x)
    for s in range(n):
        blk = out[:, s * (local + 4):(s + 1) * (local + 4)]
        np.testing.assert_array_equal(blk[:, 2:-2],
                                      ref[:, s * local:(s + 1) * local])
        if s > 0:
            np.testing.assert_array_equal(
                blk[:, :2], ref[:, s * local - 2:s * local])
        else:
            np.testing.assert_array_equal(blk[:, :2], 0)
        if s < n - 1:
            np.testing.assert_array_equal(
                blk[:, -2:], ref[:, (s + 1) * local:(s + 1) * local + 2])
        else:
            np.testing.assert_array_equal(blk[:, -2:], 0)
