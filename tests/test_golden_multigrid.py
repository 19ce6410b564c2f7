"""Oracle golden for the JS twin's multigrid kit across semantics x
flow case x grid shape (cfd_demo_jax.oracle.golden; see
tests/test_golden_cross.py for Jacobi and SOR). One V-cycle with short
smooths keeps the unrolled program quick to compile; the recursion
depth, transfers and smoothers are the default kit's, and
tests/test_golden.py runs the reference's own 3-cycle schedule."""
import dataclasses

import pytest

from cfd_demo_jax import FlowCase, PressureSolver, Semantics
from cfd_demo_jax.oracle.golden import GOLDEN_L2, golden_case, oracle_errors

SHAPES = [(24, 16), (25, 13)]


@pytest.mark.parametrize("nx,ny", SHAPES, ids=[f"{a}x{b}" for a, b in SHAPES])
@pytest.mark.parametrize("flow_case", list(FlowCase), ids=lambda f: f.value)
@pytest.mark.parametrize("semantics", list(Semantics), ids=lambda s: s.value)
def test_multigrid_matches_oracle(semantics, flow_case, nx, ny):
    grid, params, opts = golden_case(PressureSolver.MULTIGRID, semantics,
                                     flow_case, nx, ny)
    opts = dataclasses.replace(opts, mg_cycles=1, mg_pre_smooth=2,
                               mg_post_smooth=2, mg_coarse_smooth=4)
    errs = oracle_errors(grid, params, opts)
    for k, e in enumerate(errs):
        assert max(e.values()) <= GOLDEN_L2, (k, e)
