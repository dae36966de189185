// Native SAH BVH builder for core_tpu_torch (the port's own copy of
// core_tpu's native/bvh_builder.cpp, same algorithm and C interface).
//
// The acceleration structure is built host-side at scene compile time (the
// reference rebuilds its SAH kd-tree per scene update,
// src/yafraycore/kdtree.cc, triKdTree_t; SAH constants costRatio 0.8,
// emptyBonus 0.33).  The numpy builder in core_tpu_torch/geometry/bvh.py
// is fine for small scenes; this C++ implementation handles millions of
// triangles with the same binned-SAH algorithm and the same flat SoA node
// layout the traversal consumes:
//   node_min/node_max [M,3]   child AABBs
//   left [M]   inner: left child id (right = left+1); leaf: ~first_tri
//   count [M]  inner: split axis; leaf: triangle count
//   tri_order [T]  leaf triangles contiguous
//
// Exposed as a C ABI for ctypes (core_tpu_torch/native.py), built with g++
// into build/core_tpu_torch/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Vec3 {
    float x, y, z;
    Vec3() : x(0), y(0), z(0) {}
    Vec3(float a, float b, float c) : x(a), y(b), z(c) {}
};

static inline Vec3 vmin(const Vec3 &a, const Vec3 &b) {
    return Vec3(std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z));
}
static inline Vec3 vmax(const Vec3 &a, const Vec3 &b) {
    return Vec3(std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z));
}

struct AABB {
    Vec3 lo, hi;
    AABB()
        : lo(std::numeric_limits<float>::max(),
             std::numeric_limits<float>::max(),
             std::numeric_limits<float>::max()),
          hi(-std::numeric_limits<float>::max(),
             -std::numeric_limits<float>::max(),
             -std::numeric_limits<float>::max()) {}
    void grow(const AABB &o) { lo = vmin(lo, o.lo); hi = vmax(hi, o.hi); }
    void grow(const Vec3 &p) { lo = vmin(lo, p); hi = vmax(hi, p); }
    float half_area() const {
        float dx = std::max(hi.x - lo.x, 0.f);
        float dy = std::max(hi.y - lo.y, 0.f);
        float dz = std::max(hi.z - lo.z, 0.f);
        return dx * dy + dy * dz + dz * dx;
    }
};

struct Builder {
    const float *verts;
    const int32_t *tris;
    int32_t n_tris;
    int max_leaf;
    int n_bins;

    std::vector<AABB> tri_box;
    std::vector<Vec3> centroid;
    std::vector<int32_t> order;

    float *node_min;
    float *node_max;
    int32_t *left;
    int32_t *count;
    int32_t max_nodes;
    int32_t n_nodes = 0;

    int32_t alloc() {
        if (n_nodes >= max_nodes) return -1;
        return n_nodes++;
    }
};

}  // namespace

extern "C" {

// Returns the number of nodes written, or -1 on overflow/error.
// Layout contract: inner node's right child id == left child id + 1.
int32_t core_tpu_build_bvh(const float *verts, int32_t n_verts,
                           const int32_t *tris, int32_t n_tris,
                           int32_t max_leaf, int32_t n_bins,
                           float *node_min, float *node_max,
                           int32_t *left, int32_t *count,
                           int32_t *tri_order, int32_t max_nodes) {
    if (n_tris <= 0) return -1;
    Builder b;
    b.verts = verts;
    b.tris = tris;
    b.n_tris = n_tris;
    b.max_leaf = std::max(1, (int)max_leaf);
    b.n_bins = std::max(4, (int)n_bins);
    b.node_min = node_min;
    b.node_max = node_max;
    b.left = left;
    b.count = count;
    b.max_nodes = max_nodes;

    b.tri_box.resize(n_tris);
    b.centroid.resize(n_tris);
    b.order.resize(n_tris);
    for (int32_t t = 0; t < n_tris; ++t) {
        AABB box;
        for (int k = 0; k < 3; ++k) {
            int32_t vi = tris[3 * t + k];
            if (vi < 0 || vi >= n_verts) return -1;
            box.grow(Vec3(verts[3 * vi], verts[3 * vi + 1],
                          verts[3 * vi + 2]));
        }
        b.tri_box[t] = box;
        b.centroid[t] = Vec3(0.5f * (box.lo.x + box.hi.x),
                             0.5f * (box.lo.y + box.hi.y),
                             0.5f * (box.lo.z + box.hi.z));
        b.order[t] = t;
    }

    // iterative build with an explicit stack so children are allocated as
    // contiguous pairs (right = left + 1), matching the device traversal
    struct Item { int32_t node, lo, hi; };
    std::vector<Item> stack;
    int32_t root = b.alloc();
    if (root < 0) return -1;
    stack.push_back({root, 0, n_tris});

    while (!stack.empty()) {
        Item it = stack.back();
        stack.pop_back();
        int32_t lo = it.lo, hi = it.hi, node = it.node;
        AABB bounds;
        for (int32_t i = lo; i < hi; ++i) bounds.grow(b.tri_box[b.order[i]]);
        node_min[3 * node + 0] = bounds.lo.x;
        node_min[3 * node + 1] = bounds.lo.y;
        node_min[3 * node + 2] = bounds.lo.z;
        node_max[3 * node + 0] = bounds.hi.x;
        node_max[3 * node + 1] = bounds.hi.y;
        node_max[3 * node + 2] = bounds.hi.z;

        int32_t n = hi - lo;
        if (n <= b.max_leaf) {
            left[node] = ~lo;
            count[node] = n;
            continue;
        }
        AABB cb;
        for (int32_t i = lo; i < hi; ++i) cb.grow(b.centroid[b.order[i]]);
        float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y,
                        cb.hi.z - cb.lo.z};
        int axis = 0;
        if (ext[1] > ext[axis]) axis = 1;
        if (ext[2] > ext[axis]) axis = 2;

        int32_t mid = lo + n / 2;
        if (ext[axis] >= 1e-12f) {
            const float clo = axis == 0 ? cb.lo.x
                                        : (axis == 1 ? cb.lo.y : cb.lo.z);
            const float scale = b.n_bins * (1.0f - 1e-6f) / ext[axis];
            std::vector<int> cnt(b.n_bins, 0);
            std::vector<AABB> bb(b.n_bins);
            std::vector<int> bin_of(n);
            for (int32_t i = lo; i < hi; ++i) {
                const Vec3 &c = b.centroid[b.order[i]];
                float cv = axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
                int bin = (int)((cv - clo) * scale);
                if (bin < 0) bin = 0;
                if (bin >= b.n_bins) bin = b.n_bins - 1;
                bin_of[i - lo] = bin;
                cnt[bin]++;
                bb[bin].grow(b.tri_box[b.order[i]]);
            }
            std::vector<float> larea(b.n_bins), rarea(b.n_bins);
            std::vector<int> lcnt(b.n_bins), rcnt(b.n_bins);
            AABB acc;
            int c_acc = 0;
            for (int bin = 0; bin < b.n_bins; ++bin) {
                acc.grow(bb[bin]);
                c_acc += cnt[bin];
                larea[bin] = acc.half_area();
                lcnt[bin] = c_acc;
            }
            acc = AABB();
            c_acc = 0;
            for (int bin = b.n_bins - 1; bin >= 0; --bin) {
                acc.grow(bb[bin]);
                c_acc += cnt[bin];
                rarea[bin] = acc.half_area();
                rcnt[bin] = c_acc;
            }
            int best = -1;
            float best_cost = std::numeric_limits<float>::max();
            for (int bin = 0; bin < b.n_bins - 1; ++bin) {
                if (lcnt[bin] == 0 || rcnt[bin + 1] == 0) continue;
                float cost = larea[bin] * lcnt[bin]
                             + rarea[bin + 1] * rcnt[bin + 1];
                if (cost < best_cost) {
                    best_cost = cost;
                    best = bin;
                }
            }
            if (best >= 0) {
                std::vector<int32_t> lpart, rpart;
                lpart.reserve(n);
                rpart.reserve(n);
                for (int32_t i = lo; i < hi; ++i) {
                    if (bin_of[i - lo] <= best) lpart.push_back(b.order[i]);
                    else rpart.push_back(b.order[i]);
                }
                if (!lpart.empty() && !rpart.empty()) {
                    std::memcpy(&b.order[lo], lpart.data(),
                                lpart.size() * sizeof(int32_t));
                    std::memcpy(&b.order[lo + lpart.size()], rpart.data(),
                                rpart.size() * sizeof(int32_t));
                    mid = lo + (int32_t)lpart.size();
                }
            }
        }

        int32_t lchild = b.alloc();
        int32_t rchild = b.alloc();
        if (lchild < 0 || rchild < 0) return -1;
        left[node] = lchild;
        count[node] = axis;
        // push right first so left is processed next (cache locality)
        stack.push_back({rchild, mid, hi});
        stack.push_back({lchild, lo, mid});
    }

    std::memcpy(tri_order, b.order.data(), n_tris * sizeof(int32_t));
    return b.n_nodes;
}

}  // extern "C"
