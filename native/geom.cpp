// Native geometry core for cfd-demo-jax (host-side).
//
// C++ rebuild of the performance-relevant parts of the reference's
// Rust geometry subsystem (/root/reference/src/quad_mesh/*):
//   * batched point-in-polygon with holes (ray casting,
//     polygon.rs:80-105) -- feeds rasterization and mesh filtering
//   * adaptive quadtree tesselation (quad_tree.rs:17-100)
//   * face-adjacency CSR construction (bucketed O(N k) replacement of
//     the O(N^2) scan in mesh.rs:106-132)
//
// Exposed as a C ABI for ctypes; buffers are caller-owned NumPy arrays
// except the variable-size outputs, which are malloc'd here and
// released via geom_free.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <tuple>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

constexpr double kEps = std::numeric_limits<double>::epsilon();

struct Ring {
    const double* xy;  // interleaved x,y
    int64_t n;
};

// Ray-cast containment for one ring (half-open edge rule matching
// polygon.rs:86-93: (a.y > p.y) != (b.y > p.y), strict p.x < x_int).
inline bool ring_contains(const Ring& r, double px, double py) {
    bool inside = false;
    for (int64_t i = 0, j = r.n - 1; i < r.n; j = i++) {
        const double ax = r.xy[2 * j], ay = r.xy[2 * j + 1];
        const double bx = r.xy[2 * i], by = r.xy[2 * i + 1];
        if ((ay > py) != (by > py)) {
            const double x_int = ax + (py - ay) * (bx - ax) / (by - ay);
            if (px < x_int) inside = !inside;
        }
    }
    return inside;
}

struct Poly {
    std::vector<Ring> rings;  // [0] = outer, rest = holes

    bool contains(double px, double py) const {
        if (!ring_contains(rings[0], px, py)) return false;
        for (size_t h = 1; h < rings.size(); ++h)
            if (ring_contains(rings[h], px, py)) return false;
        return true;
    }
};

Poly make_poly(const double* ring_xy, const int64_t* ring_offsets,
               int64_t n_rings) {
    Poly p;
    for (int64_t r = 0; r < n_rings; ++r) {
        int64_t lo = ring_offsets[r], hi = ring_offsets[r + 1];
        p.rings.push_back(Ring{ring_xy + 2 * lo, hi - lo});
    }
    return p;
}

// Segment intersection test (intersection.rs:3-39 semantics).
// Like mesh2d/intersect.py orientation(): the reference's absolute
// epsilon-collinearity misclassifies near-degenerate crosses whose
// rounding error exceeds kEps; the static error filter on the terms'
// magnitudes reports collinear whenever the float sign is not
// trustworthy.
inline int orient(double px, double py, double qx, double qy, double rx,
                  double ry) {
    const double t1 = (qy - py) * (rx - qx);
    const double t2 = (qx - px) * (ry - qy);
    const double v = t1 - t2;
    if (std::fabs(v) <= 4.0 * kEps * (std::fabs(t1) + std::fabs(t2)) + kEps)
        return 0;
    return v > 0.0 ? 1 : 2;
}

inline bool on_seg(double px, double py, double qx, double qy, double rx,
                   double ry) {
    return qx <= std::fmax(px, rx) + kEps && qx >= std::fmin(px, rx) - kEps &&
           qy <= std::fmax(py, ry) + kEps && qy >= std::fmin(py, ry) - kEps;
}

bool seg_intersect(double px, double py, double qx, double qy, double ax,
                   double ay, double bx, double by) {
    // Canonical evaluation order, exactly as the Python kit
    // (mesh2d/intersect.py segments_intersect/_canon): float
    // orientation is only approximate near degenerate configurations,
    // so endpoint-sort each segment then segment-sort before the
    // tests -- the result becomes invariant under endpoint/segment
    // swaps AND identical between this path and the pure-Python
    // fallback.
    if (qx < px || (qx == px && qy < py)) {
        std::swap(px, qx);
        std::swap(py, qy);
    }
    if (bx < ax || (bx == ax && by < ay)) {
        std::swap(ax, bx);
        std::swap(ay, by);
    }
    if (std::tie(ax, ay, bx, by) < std::tie(px, py, qx, qy)) {
        std::swap(px, ax);
        std::swap(py, ay);
        std::swap(qx, bx);
        std::swap(qy, by);
    }
    const int o1 = orient(px, py, qx, qy, ax, ay);
    const int o2 = orient(px, py, qx, qy, bx, by);
    const int o3 = orient(ax, ay, bx, by, px, py);
    const int o4 = orient(ax, ay, bx, by, qx, qy);
    if (o1 != o2 && o3 != o4) return true;
    if (o1 == 0 && on_seg(px, py, ax, ay, qx, qy)) return true;
    if (o2 == 0 && on_seg(px, py, bx, by, qx, qy)) return true;
    if (o3 == 0 && on_seg(ax, ay, px, py, bx, by)) return true;
    if (o4 == 0 && on_seg(ax, ay, qx, qy, bx, by)) return true;
    return false;
}

// Does any polygon/hole edge intersect the axis-aligned box?
bool edges_intersect_box(const Poly& poly, double cx, double cy, double hw,
                         double hh) {
    const double x0 = cx - hw, x1 = cx + hw, y0 = cy - hh, y1 = cy + hh;
    for (const Ring& r : poly.rings) {
        for (int64_t i = 0; i < r.n; ++i) {
            const int64_t j = (i + 1) % r.n;
            const double ax = r.xy[2 * i], ay = r.xy[2 * i + 1];
            const double bx = r.xy[2 * j], by = r.xy[2 * j + 1];
            // cheap reject on the edge's bbox
            if (std::fmax(ax, bx) < x0 || std::fmin(ax, bx) > x1 ||
                std::fmax(ay, by) < y0 || std::fmin(ay, by) > y1)
                continue;
            if (seg_intersect(ax, ay, bx, by, x0, y0, x1, y0) ||
                seg_intersect(ax, ay, bx, by, x1, y0, x1, y1) ||
                seg_intersect(ax, ay, bx, by, x1, y1, x0, y1) ||
                seg_intersect(ax, ay, bx, by, x0, y1, x0, y0))
                return true;
        }
    }
    return false;
}

struct Leaves {
    std::vector<double> data;  // cx, cy, hw, hh quadruples
};

void tesselate_rec(const Poly& poly, double cx, double cy, double hw,
                   double hh, double feature, double max_cell, Leaves* out) {
    // quad_tree.rs:23-33 split criterion.
    const double cell = std::fmin(2.0 * hw, 2.0 * hh);
    const bool crosses = edges_intersect_box(poly, cx, cy, hw, hh);
    if ((cell <= feature || !crosses) && cell <= max_cell) {
        out->data.insert(out->data.end(), {cx, cy, hw, hh});
        return;
    }
    const double qw = hw / 2.0, qh = hh / 2.0;
    tesselate_rec(poly, cx - qw, cy - qh, qw, qh, feature, max_cell, out);
    tesselate_rec(poly, cx + qw, cy - qh, qw, qh, feature, max_cell, out);
    tesselate_rec(poly, cx - qw, cy + qh, qw, qh, feature, max_cell, out);
    tesselate_rec(poly, cx + qw, cy + qh, qw, qh, feature, max_cell, out);
}

}  // namespace

extern "C" {

void geom_free(void* p) { std::free(p); }

// Exposed for cross-implementation parity tests: must agree with
// mesh2d/intersect.py segments_intersect on every input, including
// near-degenerate configurations (both use the canonical evaluation
// order + the static orientation error filter).
int geom_seg_intersect(double px, double py, double qx, double qy,
                       double ax, double ay, double bx, double by) {
    return seg_intersect(px, py, qx, qy, ax, ay, bx, by) ? 1 : 0;
}

// out: n_pts bytes (1 = inside).
void geom_contains_points(const double* ring_xy, const int64_t* ring_offsets,
                          int64_t n_rings, const double* pts_xy,
                          int64_t n_pts, uint8_t* out) {
    const Poly poly = make_poly(ring_xy, ring_offsets, n_rings);
    for (int64_t i = 0; i < n_pts; ++i)
        out[i] = poly.contains(pts_xy[2 * i], pts_xy[2 * i + 1]) ? 1 : 0;
}

// Returns malloc'd array of (cx, cy, hw, hh) quadruples; count in
// *n_leaves. Root square is (cx, cy, half, half).
double* geom_tesselate(const double* ring_xy, const int64_t* ring_offsets,
                       int64_t n_rings, double cx, double cy, double half,
                       double feature, double max_cell, int64_t* n_leaves) {
    const Poly poly = make_poly(ring_xy, ring_offsets, n_rings);
    Leaves leaves;
    tesselate_rec(poly, cx, cy, half, half, feature, max_cell, &leaves);
    *n_leaves = static_cast<int64_t>(leaves.data.size() / 4);
    double* out = static_cast<double*>(
        std::malloc(leaves.data.size() * sizeof(double)));
    std::memcpy(out, leaves.data.data(), leaves.data.size() * sizeof(double));
    return out;
}

// Face adjacency: for each of the 4 faces (E, W, N, S), fill CSR
// offsets (n+1 int64) and return a malloc'd index array (count via
// *n_idx). eps-coincidence rule of mesh.rs:110-132.
int64_t* geom_face_adjacency(const double* centers_xy, const double* half_w,
                             const double* half_h, int64_t n, int face,
                             double eps, int64_t* offsets, int64_t* n_idx) {
    // my_face coordinate and their opposite-face coordinate + overlap
    // interval per cell.
    std::vector<double> mine(n), theirs(n), lo(n), hi(n);
    for (int64_t i = 0; i < n; ++i) {
        const double x = centers_xy[2 * i], y = centers_xy[2 * i + 1];
        const double hw = half_w[i], hh = half_h[i];
        switch (face) {
            case 0: mine[i] = x + hw; theirs[i] = x - hw; lo[i] = y - hh; hi[i] = y + hh; break;  // east
            case 1: mine[i] = x - hw; theirs[i] = x + hw; lo[i] = y - hh; hi[i] = y + hh; break;  // west
            case 2: mine[i] = y + hh; theirs[i] = y - hh; lo[i] = x - hw; hi[i] = x + hw; break;  // north
            default: mine[i] = y - hh; theirs[i] = y + hh; lo[i] = x - hw; hi[i] = x + hw; break; // south
        }
    }
    std::unordered_map<int64_t, std::vector<int64_t>> buckets;
    buckets.reserve(static_cast<size_t>(n) * 2);
    for (int64_t j = 0; j < n; ++j)
        buckets[llround(theirs[j] / eps)].push_back(j);

    std::vector<int64_t> idx;
    idx.reserve(static_cast<size_t>(n) * 2);
    offsets[0] = 0;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t key = llround(mine[i] / eps);
        for (int64_t d = -1; d <= 1; ++d) {
            auto it = buckets.find(key + d);
            if (it == buckets.end()) continue;
            for (int64_t j : it->second) {
                if (j == i) continue;
                if (std::fabs(theirs[j] - mine[i]) < eps && lo[i] < hi[j] &&
                    hi[i] > lo[j])
                    idx.push_back(j);
            }
        }
        offsets[i + 1] = static_cast<int64_t>(idx.size());
    }
    *n_idx = static_cast<int64_t>(idx.size());
    int64_t* out =
        static_cast<int64_t*>(std::malloc(idx.size() * sizeof(int64_t)));
    std::memcpy(out, idx.data(), idx.size() * sizeof(int64_t));
    return out;
}

}  // extern "C"
