"""Geometry kit tests: ports of the reference's 32 inline unit tests
(SURVEY.md section 4) plus mesh-construction coverage the reference
lacks.

Sources: polygon tests polygon.rs:235-461, quadtree tests
quad_tree.rs:102-138, intersection tests intersection.rs:132-392.
"""
import math

import numpy as np
import pytest

from cfd_demo_jax.mesh2d import (AABB, InvalidHole, NotEnoughVertices,
                                 Polygon, Quad, QuadMesh, SelfIntersecting,
                                 quad_edge_intersections,
                                 segment_intersection, segments_intersect,
                                 tesselate)

EPS = np.finfo(np.float64).eps


# ---------------------------------------------------------------------------
# Polygon (polygon.rs:235-461)
# ---------------------------------------------------------------------------

class TestPolygon:
    def test_line(self):
        with pytest.raises(NotEnoughVertices):
            Polygon([(0, 0), (1, 1)])

    def test_non_intersecting_polygon(self):
        Polygon([(0, 0), (1, 0), (1, 1), (0, 1)])

    def test_self_intersecting_polygon(self):
        with pytest.raises(SelfIntersecting):
            Polygon([(0, 0), (1, 1), (0, 1), (1, 0)])  # bowtie

    def test_triangle(self):
        Polygon([(0, 0), (1, 0), (0, 1)])

    def test_concave_polygon(self):
        Polygon([(0, 0), (4, 0), (4, 3), (2, 1), (0, 3)])

    def test_complex_self_intersecting_polygon(self):
        # 5-point-star vertex order (polygon.rs:305-320)
        buf = [(-1, -1), (1, -1), (-1, 0), (1, 0), (0, 1)]
        with pytest.raises(SelfIntersecting):
            Polygon(buf, indices=[0, 3, 2, 1, 4])

    def test_point_in_polygon_inside(self):
        p = Polygon([(0, 0), (4, 0), (4, 4), (0, 4)])
        assert p.contains_point((2, 2))

    def test_point_in_polygon_outside(self):
        p = Polygon([(0, 0), (4, 0), (4, 4), (0, 4)])
        assert not p.contains_point((5, 5))

    def test_contains_point_with_hole(self):
        outer = Polygon([(0, 0), (10, 0), (10, 10), (0, 10)])
        outer.add_hole(Polygon([(3, 3), (7, 3), (7, 7), (3, 7)]))
        assert not outer.contains_point((5, 5))     # inside the hole
        assert outer.contains_point((2, 2))         # outer, outside hole
        assert not outer.contains_point((3, 5))     # on the hole edge

    def test_add_valid_hole(self):
        outer = Polygon([(0, 0), (10, 0), (10, 10), (0, 10)])
        outer.add_hole(Polygon([(3, 3), (7, 3), (7, 7), (3, 7)]))

    def test_add_valid_hole2(self):
        outer = Polygon.rect(0, 0, 10, 10)
        outer.add_hole(Polygon.rect(3, 3, 4, 4))

    def test_add_invalid_hole(self):
        outer = Polygon([(0, 0), (10, 0), (10, 10), (0, 10)])
        hole = Polygon([(3, 3), (11, 3), (11, 7), (3, 7)])
        with pytest.raises(InvalidHole):
            outer.add_hole(hole)

    def test_regular_polygon_and_bounds(self):
        p = Polygon.regular((5, 5), 4, 8)
        bb = p.bounding_box()
        assert abs(bb.cx - 5) < 1e-9 and abs(bb.cy - 5) < 1e-9
        sq = p.bounding_square()
        assert abs(sq.half_width - sq.half_height) < 1e-12

    def test_batched_containment_matches_scalar(self):
        p = Polygon([(0, 0), (4, 0), (4, 3), (2, 1), (0, 3)])
        rng = np.random.default_rng(0)
        pts = rng.uniform(-1, 5, size=(200, 2))
        batch = p.contains_points(pts)
        for pt, want in zip(pts, batch):
            assert p.contains_point(tuple(pt)) == bool(want)


# ---------------------------------------------------------------------------
# QuadTree (quad_tree.rs:102-138)
# ---------------------------------------------------------------------------

class TestQuadTree:
    def test_tesselate_rect_one_sub(self):
        polygon = Polygon.rect(0.0, 0.0, 10.0, 10.0)
        cell = tesselate(polygon, 5.0, 5.0)
        assert cell.children is not None
        assert all(child.is_leaf for child in cell.children)

    def test_tesselate_octagon_subdivision(self):
        polygon = Polygon.regular((5.0, 5.0), 4.0, 8)
        cell = tesselate(polygon, 0.5, 5.0)
        assert cell.children is not None


# ---------------------------------------------------------------------------
# Intersection kit (intersection.rs:132-392)
# ---------------------------------------------------------------------------

class TestSegmentIntersection:
    def test_intersecting(self):
        assert segment_intersection((0, 0), (1, 1), (0, 1), (1, 0)) is not None

    def test_non_intersecting_but_lines_do(self):
        assert segment_intersection((0, 0), (.5, .5), (2, 0), (3, -1)) is None

    def test_parallel(self):
        assert segment_intersection((0, 0), (1, 0), (0, 1), (1, 1)) is None

    def test_collinear(self):
        assert segment_intersection((0, 0), (1, 1), (2, 2), (3, 3)) is None

    def test_endpoint(self):
        ip = segment_intersection((0, 0), (1, 1), (1, 1), (2, 0))
        assert ip is not None
        assert abs(ip[0] - 1.0) < EPS and abs(ip[1] - 1.0) < EPS

    def test_overlapping_collinear(self):
        assert segment_intersection((0, 0), (2, 2), (1, 1), (3, 3)) is None

    def test_nearly_parallel(self):
        assert segment_intersection((0, 0), (10, 1e-4), (0, 1), (10, 1.0001)) is None

    def test_exact_intersection(self):
        ip = segment_intersection((0, 0), (2, 2), (0, 2), (2, 0))
        assert abs(ip[0] - 1.0) < EPS and abs(ip[1] - 1.0) < EPS


class TestDoIntersect:
    def test_intersecting_segments(self):
        assert segments_intersect((0, 0), (1, 1), (0, 1), (1, 0))

    def test_non_intersecting_segments(self):
        assert not segments_intersect((0, 0), (.5, .5), (2, 0), (3, -1))

    def test_collinear_but_disjoint(self):
        assert not segments_intersect((0, 0), (1, 1), (2, 2), (3, 3))

    def test_sharing_endpoint(self):
        assert segments_intersect((0, 0), (1, 1), (1, 1), (2, 0))


class TestQuadEdge:
    quad = Quad.rect((0.0, 0.0), 1.0, 1.0)

    def test_no_intersection(self):
        assert quad_edge_intersections(self.quad.vertices, (-3, -3), (-2, -2)) == []

    def test_one_intersection(self):
        pts = quad_edge_intersections(self.quad.vertices, (-2, 0), (0, 0))
        assert len(pts) == 1
        assert abs(pts[0][0] + 1.0) < EPS and abs(pts[0][1]) < EPS

    def test_two_intersections(self):
        pts = sorted(quad_edge_intersections(self.quad.vertices, (-2, 0), (2, 0)))
        assert len(pts) == 2
        assert abs(pts[0][0] + 1.0) < EPS and abs(pts[1][0] - 1.0) < EPS

    def test_through_vertex(self):
        pts = quad_edge_intersections(self.quad.vertices, (-2, -2), (2, 2))
        assert len(pts) == 2
        for expected in [(-1.0, -1.0), (1.0, 1.0)]:
            assert any(abs(p[0] - expected[0]) < EPS
                       and abs(p[1] - expected[1]) < EPS for p in pts)

    def test_along_edge(self):
        pts = sorted(quad_edge_intersections(self.quad.vertices, (-1, 1), (1, 1)))
        assert len(pts) == 2
        assert abs(pts[0][0] + 1.0) < EPS and abs(pts[0][1] - 1.0) < EPS
        assert abs(pts[1][0] - 1.0) < EPS and abs(pts[1][1] - 1.0) < EPS

    def test_inside_quad(self):
        assert quad_edge_intersections(self.quad.vertices, (-.5, -.5), (.5, .5)) == []

    def test_diagonal(self):
        pts = quad_edge_intersections(self.quad.vertices, (-2, -1), (0, 1))
        assert len(pts) == 2
        for expected in [(-1.0, 0.0), (0.0, 1.0)]:
            assert any(abs(p[0] - expected[0]) < EPS
                       and abs(p[1] - expected[1]) < EPS for p in pts)


# ---------------------------------------------------------------------------
# Mesh construction (new coverage; the reference has none for mesh.rs)
# ---------------------------------------------------------------------------

class TestQuadMesh:
    def _mesh(self, feature=0.5, max_cell=5.0):
        # The mesh view's default sketch: 30x10 rect with a rotated
        # square hole (src/views/mesh_view.rs:140-152).
        poly = Polygon.rect(0.0, 0.0, 30.0, 10.0)
        hole = Polygon.regular((7.5, 5.0), 1.5, 4, math.pi / 4.0)
        poly.add_hole(hole)
        qt = tesselate(poly, feature, max_cell)
        return QuadMesh.from_quadtree(qt, poly), poly

    def test_mesh_cells_inside(self):
        mesh, poly = self._mesh()
        assert mesh.num_cells > 0
        # Every kept cell has its center or a corner inside.
        for i in range(mesh.num_cells):
            c = mesh.cell(i)
            pts = [c.center, *c.quad.vertices]
            assert any(poly.contains_point(p) for p in pts)

    def test_neighbor_symmetry(self):
        mesh, _ = self._mesh()
        for i in range(mesh.num_cells):
            c = mesh.cell(i)
            for j in c.east:
                assert i in mesh.cell(int(j)).west, (i, j)
            for j in c.north:
                assert i in mesh.cell(int(j)).south, (i, j)

    def test_neighbors_match_bruteforce(self):
        """The bucketed O(N k) adjacency must equal the reference's
        O(N^2) rule (mesh.rs:110-132)."""
        mesh, _ = self._mesh(feature=1.0)
        n = mesh.num_cells
        xmin = mesh.centers[:, 0] - mesh.half_w
        xmax = mesh.centers[:, 0] + mesh.half_w
        ymin = mesh.centers[:, 1] - mesh.half_h
        ymax = mesh.centers[:, 1] + mesh.half_h
        eps = 1e-6
        for i in range(n):
            east = [j for j in range(n) if j != i
                    and abs(xmin[j] - xmax[i]) < eps
                    and ymin[i] < ymax[j] and ymax[i] > ymin[j]]
            assert sorted(east) == sorted(mesh.cell(i).east.tolist()), i

    def test_intersections_on_hole_boundary(self):
        mesh, poly = self._mesh()
        # Cells crossing the hole edge must record intersection points.
        total = sum(len(mesh.cell(i).intersections)
                    for i in range(mesh.num_cells))
        assert total > 0

    def test_full_bounding_box(self):
        mesh, poly = self._mesh()
        bb = mesh.full_bounding_box()
        sq = poly.bounding_square()
        assert bb.half_width <= sq.half_width + 1e-9
        assert bb.half_height <= sq.half_height + 1e-9


class TestFromPolygon:
    def test_from_polygon_matches_from_quadtree(self):
        import math
        from cfd_demo_jax.mesh2d import tesselate
        poly = Polygon.rect(0.0, 0.0, 30.0, 10.0)
        poly.add_hole(Polygon.regular((7.5, 5.0), 1.5, 4, math.pi / 4))
        fast = QuadMesh.from_polygon(poly, 0.5, 2.0)
        slow = QuadMesh.from_quadtree(tesselate(poly, 0.5, 2.0), poly)
        assert fast.num_cells == slow.num_cells
        np.testing.assert_allclose(np.sort(fast.centers, axis=0),
                                   np.sort(slow.centers, axis=0))

    def test_nested_holes_fall_back_to_python(self):
        """Native path cannot express holes-of-holes (islands); the
        dispatcher must agree with the pure-Python semantics."""
        outer = Polygon.rect(0.0, 0.0, 20.0, 20.0)
        hole = Polygon.rect(5.0, 5.0, 10.0, 10.0)
        island = Polygon.rect(8.0, 8.0, 4.0, 4.0)
        hole.add_hole(island)
        outer.add_hole(hole)
        # island interior counts as inside the outer polygon again
        pts = np.array([[10.0, 10.0],   # inside island -> inside
                        [6.0, 6.0],     # inside hole, outside island -> out
                        [2.0, 2.0],     # plain outer -> inside
                        [25.0, 25.0]])  # outside
        # batch large enough to trigger the native path if it wrongly
        # accepted nested holes
        big = np.tile(pts, (2000, 1))
        got = outer.contains_points(big)[:4]
        assert got.tolist() == [True, False, True, False]
