// Native setup runtime for wayverb_tpu.
//
// The reference implements its host runtime (voxel octree, inside tests,
// closest-triangle search) in C++ (src/core/spatial_division/*,
// src/cl/voxel.cpp); this library is this project's native equivalent for
// the setup path: a uniform voxel grid accelerator with DDA ray traversal,
// parity-vote inside classification, and point→triangle surface
// assignment.  Exposed as a C ABI for ctypes.
//
// Build: wayverb_tpu/utils/native.py compiles it on first use
// (g++ -O3 -fopenmp -shared -fPIC), keyed on a hash of this file.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct V3 {
    double x, y, z;
};

inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 operator*(V3 a, double s) { return {a.x * s, a.y * s, a.z * s}; }
inline double dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 cross(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}

constexpr double kEpsilon = 1e-9;

// Möller–Trumbore with a small barycentric slack (matches the JAX path so
// edge-crossing rays can't slip between adjacent triangles).
bool ray_tri(V3 orig, V3 dir, const V3* v, double* t_out) {
    const V3 e1 = v[1] - v[0];
    const V3 e2 = v[2] - v[0];
    const V3 pvec = cross(dir, e2);
    const double det = dot(e1, pvec);
    if (std::fabs(det) < kEpsilon) return false;
    const double inv = 1.0 / det;
    const V3 tvec = orig - v[0];
    const double u = dot(tvec, pvec) * inv;
    const double slack = 1e-4;
    if (u < -slack || u > 1.0 + slack) return false;
    const V3 qvec = cross(tvec, e1);
    const double w = dot(dir, qvec) * inv;
    if (w < -slack || u + w > 1.0 + slack) return false;
    const double t = dot(e2, qvec) * inv;
    if (t <= 1e-6) return false;
    *t_out = t;
    return true;
}

struct VoxelGrid {
    V3 lo, hi;
    int side;          // voxels per axis
    V3 voxel_size;
    // CSR: per-voxel triangle index lists
    std::vector<int32_t> offsets;
    std::vector<int32_t> items;
};

inline int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

VoxelGrid build_grid(const double* verts, const int32_t* tris, int num_tris,
                     int side) {
    VoxelGrid g;
    g.side = side;
    g.lo = {1e30, 1e30, 1e30};
    g.hi = {-1e30, -1e30, -1e30};
    auto vert = [&](int i) {
        return V3{verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]};
    };
    for (int t = 0; t < num_tris; ++t) {
        for (int k = 0; k < 3; ++k) {
            const V3 p = vert(tris[3 * t + k]);
            g.lo.x = std::min(g.lo.x, p.x); g.hi.x = std::max(g.hi.x, p.x);
            g.lo.y = std::min(g.lo.y, p.y); g.hi.y = std::max(g.hi.y, p.y);
            g.lo.z = std::min(g.lo.z, p.z); g.hi.z = std::max(g.hi.z, p.z);
        }
    }
    // pad so nothing sits exactly on the outer wall
    const V3 pad = (g.hi - g.lo) * 1e-4 + V3{1e-9, 1e-9, 1e-9};
    g.lo = g.lo - pad;
    g.hi = g.hi + pad;
    g.voxel_size = (g.hi - g.lo) * (1.0 / side);

    const int ncell = side * side * side;
    std::vector<std::vector<int32_t>> cells(ncell);
    for (int t = 0; t < num_tris; ++t) {
        // conservative AABB binning of the triangle
        V3 tlo{1e30, 1e30, 1e30}, thi{-1e30, -1e30, -1e30};
        for (int k = 0; k < 3; ++k) {
            const V3 p = vert(tris[3 * t + k]);
            tlo.x = std::min(tlo.x, p.x); thi.x = std::max(thi.x, p.x);
            tlo.y = std::min(tlo.y, p.y); thi.y = std::max(thi.y, p.y);
            tlo.z = std::min(tlo.z, p.z); thi.z = std::max(thi.z, p.z);
        }
        const int x0 = clampi(int((tlo.x - g.lo.x) / g.voxel_size.x), 0, side - 1);
        const int x1 = clampi(int((thi.x - g.lo.x) / g.voxel_size.x), 0, side - 1);
        const int y0 = clampi(int((tlo.y - g.lo.y) / g.voxel_size.y), 0, side - 1);
        const int y1 = clampi(int((thi.y - g.lo.y) / g.voxel_size.y), 0, side - 1);
        const int z0 = clampi(int((tlo.z - g.lo.z) / g.voxel_size.z), 0, side - 1);
        const int z1 = clampi(int((thi.z - g.lo.z) / g.voxel_size.z), 0, side - 1);
        for (int x = x0; x <= x1; ++x)
            for (int y = y0; y <= y1; ++y)
                for (int z = z0; z <= z1; ++z)
                    cells[(x * side + y) * side + z].push_back(t);
    }
    g.offsets.resize(ncell + 1, 0);
    for (int c = 0; c < ncell; ++c)
        g.offsets[c + 1] = g.offsets[c] + int32_t(cells[c].size());
    g.items.resize(g.offsets[ncell]);
    for (int c = 0; c < ncell; ++c)
        std::copy(cells[c].begin(), cells[c].end(),
                  g.items.begin() + g.offsets[c]);
    return g;
}

// Count ray–scene crossings with voxel DDA traversal.
int count_crossings(const VoxelGrid& g, const double* verts,
                    const int32_t* tris, V3 orig, V3 dir) {
    // enter the grid
    double tmin = 0.0;
    const double big = 1e30;
    {
        double t0 = 0.0, t1 = big;
        const double* o = &orig.x;
        const double* d = &dir.x;
        const double* lo = &g.lo.x;
        const double* hi = &g.hi.x;
        for (int a = 0; a < 3; ++a) {
            if (std::fabs(d[a]) < 1e-15) {
                if (o[a] < lo[a] || o[a] > hi[a]) return 0;
            } else {
                double ta = (lo[a] - o[a]) / d[a];
                double tb = (hi[a] - o[a]) / d[a];
                if (ta > tb) std::swap(ta, tb);
                t0 = std::max(t0, ta);
                t1 = std::min(t1, tb);
            }
        }
        if (t0 > t1) return 0;
        tmin = t0;
    }
    V3 p = orig + dir * (tmin + 1e-12);
    int ix = clampi(int((p.x - g.lo.x) / g.voxel_size.x), 0, g.side - 1);
    int iy = clampi(int((p.y - g.lo.y) / g.voxel_size.y), 0, g.side - 1);
    int iz = clampi(int((p.z - g.lo.z) / g.voxel_size.z), 0, g.side - 1);
    const int sx = dir.x > 0 ? 1 : -1;
    const int sy = dir.y > 0 ? 1 : -1;
    const int sz = dir.z > 0 ? 1 : -1;
    auto boundary = [&](int idx, double lo, double vs, int step) {
        return lo + (idx + (step > 0 ? 1 : 0)) * vs;
    };
    int count = 0;
    std::vector<char> seen;  // dedupe triangles spanning voxels
    seen.assign(g.offsets.size() > 1 ? 0 : 0, 0);
    std::vector<int32_t> hit_tris;
    while (true) {
        const int cell = (ix * g.side + iy) * g.side + iz;
        for (int32_t i = g.offsets[cell]; i < g.offsets[cell + 1]; ++i) {
            const int32_t t = g.items[i];
            bool dup = false;
            for (int32_t h : hit_tris) if (h == t) { dup = true; break; }
            if (dup) continue;
            V3 v[3] = {
                {verts[3 * tris[3 * t] + 0], verts[3 * tris[3 * t] + 1],
                 verts[3 * tris[3 * t] + 2]},
                {verts[3 * tris[3 * t + 1] + 0], verts[3 * tris[3 * t + 1] + 1],
                 verts[3 * tris[3 * t + 1] + 2]},
                {verts[3 * tris[3 * t + 2] + 0], verts[3 * tris[3 * t + 2] + 1],
                 verts[3 * tris[3 * t + 2] + 2]},
            };
            double thit;
            if (ray_tri(orig, dir, v, &thit)) {
                hit_tris.push_back(t);
                ++count;
            }
        }
        // advance DDA
        const double bx = std::fabs(dir.x) < 1e-15 ? big
            : (boundary(ix, g.lo.x, g.voxel_size.x, sx) - orig.x) / dir.x;
        const double by = std::fabs(dir.y) < 1e-15 ? big
            : (boundary(iy, g.lo.y, g.voxel_size.y, sy) - orig.y) / dir.y;
        const double bz = std::fabs(dir.z) < 1e-15 ? big
            : (boundary(iz, g.lo.z, g.voxel_size.z, sz) - orig.z) / dir.z;
        if (bx <= by && bx <= bz) {
            ix += sx;
            if (ix < 0 || ix >= g.side) break;
        } else if (by <= bz) {
            iy += sy;
            if (iy < 0 || iy >= g.side) break;
        } else {
            iz += sz;
            if (iz < 0 || iz >= g.side) break;
        }
    }
    return count;
}

double point_tri_dist_sq(V3 p, const V3* v) {
    const V3 ab = v[1] - v[0];
    const V3 ac = v[2] - v[0];
    const V3 ap = p - v[0];
    const double d1 = dot(ab, ap);
    const double d2 = dot(ac, ap);
    if (d1 <= 0 && d2 <= 0) { const V3 d = p - v[0]; return dot(d, d); }
    const V3 bp = p - v[1];
    const double d3 = dot(ab, bp);
    const double d4 = dot(ac, bp);
    if (d3 >= 0 && d4 <= d3) { const V3 d = p - v[1]; return dot(d, d); }
    const double vc = d1 * d4 - d3 * d2;
    if (vc <= 0 && d1 >= 0 && d3 <= 0) {
        const double t = d1 / (d1 - d3);
        const V3 q = v[0] + ab * t;
        const V3 d = p - q;
        return dot(d, d);
    }
    const V3 cp = p - v[2];
    const double d5 = dot(ab, cp);
    const double d6 = dot(ac, cp);
    if (d6 >= 0 && d5 <= d6) { const V3 d = p - v[2]; return dot(d, d); }
    const double vb = d5 * d2 - d1 * d6;
    if (vb <= 0 && d2 >= 0 && d6 <= 0) {
        const double t = d2 / (d2 - d6);
        const V3 q = v[0] + ac * t;
        const V3 d = p - q;
        return dot(d, d);
    }
    const double va = d3 * d6 - d5 * d4;
    if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
        const double t = (d4 - d3) / ((d4 - d3) + (d5 - d6));
        const V3 q = v[1] + (v[2] - v[1]) * t;
        const V3 d = p - q;
        return dot(d, d);
    }
    const double denom = 1.0 / (va + vb + vc);
    const double s = vb * denom;
    const double t = vc * denom;
    const V3 q = v[0] + ab * s + ac * t;
    const V3 d = p - q;
    return dot(d, d);
}

// deterministic direction table matching the JAX side's convention of 32
// fixed pseudo-random unit vectors (values differ; parity voting is robust
// to the particular directions)
void parity_directions(V3* dirs, int n) {
    uint64_t state = 0x5EED5EED12345ULL;
    auto next = [&]() {
        state ^= state << 13; state ^= state >> 7; state ^= state << 17;
        return double(state >> 11) / double(1ULL << 53);
    };
    for (int i = 0; i < n; ++i) {
        const double z = next() * 2.0 - 1.0;
        const double theta = (next() * 2.0 - 1.0) * M_PI;
        const double t = std::sqrt(std::max(0.0, 1.0 - z * z));
        dirs[i] = {t * std::cos(theta), z, t * std::sin(theta)};
    }
}

}  // namespace

extern "C" {

// points (P,3) f64; verts (V,3) f64; tris (T,3) i32; out (P,) u8
void wv_classify_inside(const double* points, int64_t num_points,
                        const double* verts, const int32_t* tris,
                        int64_t num_tris, int grid_side, uint8_t* out) {
    const VoxelGrid g = build_grid(verts, tris, int(num_tris), grid_side);
    constexpr int kNumDirs = 32;
    V3 dirs[kNumDirs];
    parity_directions(dirs, kNumDirs);
#pragma omp parallel for schedule(dynamic, 64)
    for (int64_t p = 0; p < num_points; ++p) {
        const V3 orig{points[3 * p], points[3 * p + 1], points[3 * p + 2]};
        int votes = 0;
        for (int d = 0; d < kNumDirs; ++d) {
            const int c = count_crossings(g, verts, tris, orig, dirs[d]);
            votes += (c & 1);
        }
        out[p] = votes * 2 > kNumDirs ? 1 : 0;
    }
}

// points (P,3); out (P,) i32 surface index of the closest triangle
void wv_closest_triangle_surface(const double* points, int64_t num_points,
                                 const double* verts, const int32_t* tris,
                                 const int32_t* tri_surfaces,
                                 int64_t num_tris, int32_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t p = 0; p < num_points; ++p) {
        const V3 pt{points[3 * p], points[3 * p + 1], points[3 * p + 2]};
        double best = std::numeric_limits<double>::infinity();
        int32_t best_t = 0;
        for (int64_t t = 0; t < num_tris; ++t) {
            V3 v[3];
            for (int k = 0; k < 3; ++k) {
                const int32_t vi = tris[3 * t + k];
                v[k] = {verts[3 * vi], verts[3 * vi + 1], verts[3 * vi + 2]};
            }
            const double d = point_tri_dist_sq(pt, v);
            if (d < best) { best = d; best_t = int32_t(t); }
        }
        out[p] = tri_surfaces[best_t];
    }
}

int wv_version() { return 1; }

}  // extern "C"
