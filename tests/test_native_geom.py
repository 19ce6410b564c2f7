"""Native C++ geometry core vs the pure-Python implementations."""
import math
import time

import numpy as np
import pytest

from cfd_demo_jax.mesh2d import Polygon, QuadMesh, tesselate
from cfd_demo_jax.mesh2d import native

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C++ toolchain / build failed")


def sketch():
    poly = Polygon.rect(0.0, 0.0, 30.0, 10.0)
    poly.add_hole(Polygon.regular((7.5, 5.0), 1.5, 4, math.pi / 4))
    return poly


def _py_contains(poly, pts):
    """Force the NumPy path regardless of batch size."""
    p = np.asarray(pts, np.float64).reshape(-1, 2)
    a = poly.ring
    b = np.roll(poly.ring, -1, axis=0)
    py = p[:, 1][:, None]
    px = p[:, 0][:, None]
    crosses = (a[None, :, 1] > py) != (b[None, :, 1] > py)
    with np.errstate(divide="ignore", invalid="ignore"):
        x_int = a[None, :, 0] + (py - a[None, :, 1]) * (
            (b[None, :, 0] - a[None, :, 0]) / (b[None, :, 1] - a[None, :, 1]))
    inside = ((crosses & (px < x_int)).sum(axis=1) % 2) == 1
    for hole in poly.holes:
        inside &= ~_py_contains(hole, p)
    return inside


def test_contains_points_equivalence(rng):
    poly = sketch()
    pts = rng.uniform([-2, -2], [32, 12], size=(20000, 2))
    want = _py_contains(poly, pts)
    got = native.contains_points(poly, pts)
    np.testing.assert_array_equal(got, want)


def test_tesselate_equivalence():
    poly = sketch()
    qt = tesselate(poly, 0.3, 2.0)
    want = np.array(sorted(
        (l.boundary.cx, l.boundary.cy, l.boundary.half_width,
         l.boundary.half_height) for l in qt.leaves()))
    got = native.tesselate_leaves(poly, 0.3, 2.0)
    got = np.array(sorted(map(tuple, got)))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_adjacency_equivalence():
    poly = sketch()
    qt = tesselate(poly, 0.5, 2.0)
    mesh = QuadMesh.from_quadtree(qt, poly)  # native-backed when available
    n = mesh.num_cells
    xmin = mesh.centers[:, 0] - mesh.half_w
    xmax = mesh.centers[:, 0] + mesh.half_w
    ymin = mesh.centers[:, 1] - mesh.half_h
    ymax = mesh.centers[:, 1] + mesh.half_h
    eps = 1e-6
    for i in range(n):
        east = sorted(j for j in range(n) if j != i
                      and abs(xmin[j] - xmax[i]) < eps
                      and ymin[i] < ymax[j] and ymax[i] > ymin[j])
        assert east == sorted(mesh.cell(i).east.tolist()), i
        south = sorted(j for j in range(n) if j != i
                       and abs(ymax[j] - ymin[i]) < eps
                       and xmin[i] < xmax[j] and xmax[i] > xmin[j])
        assert south == sorted(mesh.cell(i).south.tolist()), i


def test_seg_intersect_parity_with_python(rng):
    """C++ seg_intersect must agree with the Python kit on EVERY input
    -- including near-degenerate configurations where the orientation
    sign is rounding-determined (both use the canonical evaluation
    order + the static error filter) -- and be invariant under
    endpoint/segment argument swaps."""
    from cfd_demo_jax.mesh2d.intersect import segments_intersect

    lib = native.load()

    def cc(p, q, a, b):
        return bool(lib.geom_seg_intersect(p[0], p[1], q[0], q[1],
                                           a[0], a[1], b[0], b[1]))

    cases = []
    # random general-position segments
    for _ in range(300):
        cases.append(tuple(map(tuple, rng.uniform(-2, 2, size=(4, 2)))))
    # near-degenerate: shared endpoints, collinear-with-noise, tangent
    for _ in range(300):
        p = tuple(rng.uniform(-2, 2, size=2))
        d = tuple(rng.uniform(-1, 1, size=2))
        t1, t2 = rng.uniform(0.1, 2.0, size=2)
        eps = rng.choice([0.0, 1e-17, 1e-16, 2.2e-16, 1e-15])
        q = (p[0] + t1 * d[0], p[1] + t1 * d[1])
        a = (p[0] + 0.3 * d[0], p[1] + 0.3 * d[1] + eps)
        b = (p[0] + t2 * d[0] + eps, p[1] + t2 * d[1])
        cases.append((p, q, a, b))
    for p, q, a, b in cases:
        want = segments_intersect(p, q, a, b)
        assert cc(p, q, a, b) == want, (p, q, a, b)
        # swap invariance on both implementations
        assert cc(q, p, b, a) == want, (p, q, a, b)
        assert cc(a, b, p, q) == want, (p, q, a, b)
        assert segments_intersect(b, a, q, p) == want, (p, q, a, b)
