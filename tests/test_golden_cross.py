"""Oracle golden across solver x semantics x flow case x grid shape.

The fixed-schedule pipeline (cfd_demo_jax.oracle.golden) on shapes
beyond tests/test_golden.py's 24x16: odd widths, ny % 8 != 0 and wider
grids. Jacobi and red/black SOR here; the multigrid kit, whose scalar
oracle is slow, in tests/test_golden_multigrid.py.
"""
import pytest

from cfd_demo_jax import FlowCase, PressureSolver, Semantics
from cfd_demo_jax.oracle.golden import GOLDEN_L2, golden_case, oracle_errors

SHAPES = [(24, 16), (25, 13), (40, 20), (33, 18)]


@pytest.mark.parametrize("nx,ny", SHAPES, ids=[f"{a}x{b}" for a, b in SHAPES])
@pytest.mark.parametrize("flow_case", list(FlowCase), ids=lambda f: f.value)
@pytest.mark.parametrize("semantics", list(Semantics), ids=lambda s: s.value)
@pytest.mark.parametrize("solver", [PressureSolver.JACOBI, PressureSolver.SOR],
                         ids=lambda s: s.value)
def test_fixed_schedule_matches_oracle(solver, semantics, flow_case, nx, ny):
    errs = oracle_errors(*golden_case(solver, semantics, flow_case, nx, ny))
    for k, e in enumerate(errs):
        assert max(e.values()) <= GOLDEN_L2, (k, e)
