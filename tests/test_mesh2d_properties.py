"""Property-based geometry tests (hypothesis).

The reference's geometry tests are hand-picked cases
(SURVEY.md section 4); these cover the invariants randomly.
"""
import math

import numpy as np
from hypothesis import given, settings, strategies as st

from cfd_demo_jax.mesh2d import Polygon, QuadMesh, segments_intersect, tesselate

pts = st.tuples(st.floats(-10, 10, allow_nan=False, width=32),
                st.floats(-10, 10, allow_nan=False, width=32))


@given(center=pts, radius=st.floats(0.1, 5.0), n=st.integers(3, 12),
       angle=st.floats(0, 2 * math.pi))
@settings(max_examples=50, deadline=None)
def test_regular_polygon_contains_center(center, radius, n, angle):
    p = Polygon.regular(center, radius, n, angle)
    assert p.contains_point(center)
    # A point safely outside the circumradius is outside.
    far = (center[0] + 3 * radius, center[1])
    assert not p.contains_point(far)


@given(a=pts, b=pts, c=pts, d=pts)
@settings(max_examples=100, deadline=None)
def test_segment_intersection_symmetry(a, b, c, d):
    assert segments_intersect(a, b, c, d) == segments_intersect(c, d, a, b)
    # orientation of the segments' own endpoints is irrelevant
    assert segments_intersect(a, b, c, d) == segments_intersect(b, a, d, c)


@given(a=pts, b=pts)
@settings(max_examples=50, deadline=None)
def test_segment_self_intersection(a, b):
    assert segments_intersect(a, b, a, b)


@given(w=st.floats(1.0, 20.0), h=st.floats(1.0, 20.0),
       feature=st.floats(0.2, 2.0), max_cell=st.floats(1.0, 4.0))
@settings(max_examples=25, deadline=None)
def test_quadtree_leaves_tile_bounding_square(w, h, feature, max_cell):
    poly = Polygon.rect(0.0, 0.0, w, h)
    qt = tesselate(poly, feature, max_cell)
    leaves = qt.leaves()
    area = sum(4.0 * l.boundary.half_width * l.boundary.half_height
               for l in leaves)
    sq = poly.bounding_square()
    np.testing.assert_allclose(area, sq.width * sq.height, rtol=1e-9)
    # Leaves don't overlap: total area equals the square's, and each
    # leaf is inside it.
    for l in leaves[:50]:
        assert sq.contains((l.boundary.cx, l.boundary.cy))


@given(w=st.floats(2.0, 10.0), h=st.floats(2.0, 10.0),
       feature=st.floats(0.5, 1.0))
@settings(max_examples=10, deadline=None)
def test_mesh_neighbor_symmetry_random(w, h, feature):
    poly = Polygon.rect(0.0, 0.0, w, h)
    qt = tesselate(poly, feature, 2.0)
    mesh = QuadMesh.from_quadtree(qt, poly)
    for i in range(mesh.num_cells):
        c = mesh.cell(i)
        for jj in c.east:
            assert i in mesh.cell(int(jj)).west
        for jj in c.south:
            assert i in mesh.cell(int(jj)).north
