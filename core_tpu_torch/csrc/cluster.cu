// Cluster intersection kernels for Hopper (sm_90a), plain C interface.
//
// Five kernels, each the port of one Pallas TPU kernel of core_tpu:
//
//   cti_cluster_closest_hit <- core_tpu/geometry/cluster_intersect.py:_kernel
//   cti_cluster_any_hit     <- core_tpu/geometry/cluster_intersect.py:_any_kernel
//   cti_cluster_any_hit_nee <- core_tpu/geometry/cluster_intersect.py:_any_nee_kernel
//   cti_grouped_closest_hit <- core_tpu/geometry/cluster_intersect.py:_grouped_kernel
//   cti_grouped_any_hit     <- core_tpu/geometry/cluster_intersect.py:_grouped_any_kernel
//
// Their plain PyTorch versions are closest_hit_flat_torch,
// any_hit_flat_torch, any_hit_nee_flat_torch, closest_hit_grouped_torch and
// any_hit_grouped_torch in geometry/cluster_intersect.py, which compute the
// same functions.  Like intersect.cu this file is compiled with
// --fmad=false, so every product is rounded on its own as in the plain
// versions, and kernel and plain version agree bit for bit.
//
// Data.  The flat accel (ClusterAccel, scenes of fewer than 1,024
// clusters): aabb [C, 8].  The grouped accel (GroupedAccel): g_aabb [G, 8],
// o_aabb [G, group/8, 8] (octet-union boxes), c_aabb [G, group, 8].  Both:
// tris [C, leaf, 9] (v0, e1, e2), tri_id [C, leaf] and count [C] (a
// cluster's triangles come first).  Boxes are bmin xyz, bmax xyz, 2 pad
// floats.  Exclusions compare the triangle id (tri_id), not the slot.
// Every gate is the slab test of cluster_intersect.py:_slab_test (same
// eps-guarded reciprocal, same min/max order), applied by each ray to its
// own boxes with its own cap.
//
// All five are cooperative walks.  What bounds them on this card is not
// the float work (~25 operations per slab test, 56-64 per triangle test;
// the triangle tables, 2.7 MB at 73.6k triangles and ~38 MB at 1M, sit in
// the 50 MB L2) but how a warp meets it.  Walked one ray (or one lane of K
// directions) per thread, a warp serialises over the union of the clusters
// its threads pass, and while one thread tests a cluster's 128-256
// triangles, reading 10 scattered words per triangle, the threads that did
// not pass it wait -- worst for incoherent rays (kernel 7's glossy chain,
// kernel 8's bundles); and a lane holding K=16 directions in registers (150
// registers) leaves 12 warps on an SM.  So:
//   - one thread per ray.  Kernel 6 puts a lane's K rays on neighbouring
//     threads (thread i: direction i % K of lane i / K), so a warp holds
//     rays of few origins; kernel 8's rays arrive re-bucketed by
//     _nee_bucket_key (octahedral direction bin major, origin Morton cell
//     minor); kernels 4, 5 and 7 take the rays as they come (camera and
//     shadow rays in 32x32 pixel blocks);
//   - a walk -- kernels 4, 5 and 6: the block of 128 threads (one body,
//     flat_walk, with the gate's cap and the test as parameters); kernels
//     7 and 8: one warp -- gates each
//     level with every thread's own slab test and takes the OR of the
//     gates: the flat walk 32 cluster boxes at a time, staged in shared
//     memory; the grouped walk the group box (read-only cache), then the
//     group's octet and cluster boxes, staged in shared memory, skipping a
//     level no ray of the warp passes;
//   - each cluster some thread passes is copied once into shared memory
//     with cp.async (16-byte pieces; a cluster's [leaf, 9] block is
//     contiguous), double-buffered so the next one loads while this one is
//     tested;
//   - the test is triangle-parallel in each warp: the warp takes its rays
//     that passed, one by one, and its 32 lanes test 32 triangles at a
//     time, so a warp whose rays pass few clusters makes few tests.  Any
//     hit (warp_test) stops a ray at its first occluder, and the walk ends
//     when all its rays are done.  Closest hit (warp_closest) takes a warp
//     arg-min over (t, slot) of the triangles with t < the ray's best t at
//     the cluster's start: the smallest t and, among equal t, the lowest
//     slot, which is what the sequential `t < best t` loop keeps; when
//     most of the warp's rays pass, each walks the staged triangles in its
//     own lane instead (cheaper then, and the same loop);
//   - a dead ray (0 < tcap <= tmin) never starts: no t lies in (tmin,
//     tcap).
// Only a ray's own gates decide which triangles it is tested against, so
// the bits are those of the plain versions: a triangle tested under a box
// the ray's gate rejected could win at a box edge where the plain version
// does not test it.  The OR of the gates only decides what is staged.
// The closest-hit gates follow the plain versions' replay: kernel 7 gates
// the group box with min(tcap, best t on entering the group), the octet
// box with the best t on entering the octet, each cluster box with the
// best t now; kernel 4 gates its 32 cluster boxes of a ballot with the
// best t at the ballot.  Best t only falls, so those cluster gates are a
// superset of the gates at test time: their OR picks what is staged, and
// just before a ray is tested against a staged cluster it takes its gate
// again with its current best t (the box is in shared memory), which is
// the gate of the sequential walk.  The visit order stays the build order
// (groups, octets, clusters): a near-to-far order would change which of
// two triangles at equal t wins.  Kernels 7 and 8 keep a body
// each: one body with the cap and the test as parameters ran kernel 8
// ~1% slower than its own.  Kernels 4, 5 and 6 share flat_walk: timed in
// turns against a body of kernel 4's own, it cost none of the three more
// than its spread (PERF.md).  Kernel 6 keeps the
// shared-origin test's expression tree (origin terms m1, w, qvec, tnum,
// then det, un, vn) for each ray.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kOctet = 8;
constexpr float kBig = 3.0e38f;
constexpr int kStaticSmem = 48 * 1024;

struct Ray {
  float ox, oy, oz;
  float ix, iy, iz;  // eps-guarded reciprocal direction
  float tmin;
};

__device__ __forceinline__ float inv_dir(float d) {
  const float eps = 1e-20f;
  return 1.0f / (fabsf(d) < eps ? (d < 0.f ? -eps : eps) : d);
}

// cluster_intersect.py:_slab_test against box b (8 floats; global memory
// through the read-only cache, or shared memory)
template <bool kShared>
__device__ __forceinline__ bool slab(const float* __restrict__ b,
                                     const Ray& r, float tcap) {
  float b0, b1, b2, b3, b4, b5;
  if (kShared) {
    b0 = b[0]; b1 = b[1]; b2 = b[2]; b3 = b[3]; b4 = b[4]; b5 = b[5];
  } else {
    b0 = __ldg(b + 0); b1 = __ldg(b + 1); b2 = __ldg(b + 2);
    b3 = __ldg(b + 3); b4 = __ldg(b + 4); b5 = __ldg(b + 5);
  }
  const float q0x = (b0 - r.ox) * r.ix;
  const float q1x = (b3 - r.ox) * r.ix;
  const float q0y = (b1 - r.oy) * r.iy;
  const float q1y = (b4 - r.oy) * r.iy;
  const float q0z = (b2 - r.oz) * r.iz;
  const float q1z = (b5 - r.oz) * r.iz;
  const float tn = fmaxf(fmaxf(fminf(q0x, q1x), fminf(q0y, q1y)),
                         fmaxf(fminf(q0z, q1z), r.tmin));
  const float tf = fminf(fminf(fmaxf(q0x, q1x), fmaxf(q0y, q1y)),
                         fminf(fmaxf(q0z, q1z), tcap));
  return tn <= tf;
}

// The triangles of both accels.
struct Tris {
  const float* __restrict__ tris;
  const int* __restrict__ tri_id;
  const int* __restrict__ count;
  int leaf;
};

struct RayIn {
  const float* __restrict__ ox;
  const float* __restrict__ oy;
  const float* __restrict__ oz;
  const float* __restrict__ dx;
  const float* __restrict__ dy;
  const float* __restrict__ dz;
  const float* __restrict__ tmin;
  const float* __restrict__ tmax;
  const int* __restrict__ ex0;
  const int* __restrict__ ex1;
};

// One thread's ray, read from the SoA inputs.
struct Lane {
  Ray r;
  float dx, dy, dz, tcap;
  int ex0, ex1;
};

__device__ __forceinline__ Lane load_lane(const RayIn& in, int i) {
  Lane l;
  l.dx = in.dx[i];
  l.dy = in.dy[i];
  l.dz = in.dz[i];
  l.r = Ray{in.ox[i], in.oy[i], in.oz[i], inv_dir(l.dx), inv_dir(l.dy),
            inv_dir(l.dz), in.tmin[i]};
  const float tmax = in.tmax[i];
  l.tcap = tmax > 0.f ? tmax : kBig;
  l.ex0 = in.ex0 ? in.ex0[i] : -2;
  l.ex1 = in.ex1 ? in.ex1[i] : -2;
  return l;
}

struct Best {
  float t, u, v;
  int prim;
};

// The closest-hit Moller-Trumbore test of triangle q (9 floats, v0 e1 e2)
// with id `id` (cluster_intersect.py:_mt_closest's arithmetic): true when
// the hit is accepted with t < bt, and then its t, u and v.
__device__ __forceinline__ bool closest_test(const float* q, int id,
                                             const Lane& l, float bt,
                                             float& t, float& u, float& v) {
  const float v0x = q[0], v0y = q[1], v0z = q[2];
  const float e1x = q[3], e1y = q[4], e1z = q[5];
  const float e2x = q[6], e2y = q[7], e2z = q[8];
  const float dx = l.dx, dy = l.dy, dz = l.dz;
  // pvec = d x e2
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool det_ok = fabsf(det) > 1e-12f;
  const float inv_det = 1.0f / (det_ok ? det : 1.0f);
  const float tx = l.r.ox - v0x;
  const float ty = l.r.oy - v0y;
  const float tz = l.r.oz - v0z;
  u = (tx * px + ty * py + tz * pz) * inv_det;
  // qvec = tvec x e1
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  v = (dx * qx + dy * qy + dz * qz) * inv_det;
  t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return det_ok && u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f &&
         t > l.r.tmin && t < l.tcap && t < bt && id != l.ex0 && id != l.ex1;
}

// Moller-Trumbore over cnt staged triangles (rows of 9 floats and ids in
// shared memory) in order, keeping t < best t.
__device__ __forceinline__ void closest_loop(const float* tri,
                                             const int* ids, int cnt,
                                             const Lane& l, Best& b) {
  for (int k = 0; k < cnt; ++k) {
    float t, u, v;
    if (closest_test(tri + k * 9, ids[k], l, b.t, t, u, v)) {
      b.t = t;
      b.prim = ids[k];
      b.u = u;
      b.v = v;
    }
  }
}

// The division-free, sign-folded any-hit test of triangle q (9 floats, v0
// e1 e2) with id `id` (cluster_intersect.py:_mt_any's arithmetic).
__device__ __forceinline__ bool occludes(const float* q, int id,
                                         const Lane& l) {
  const float v0x = q[0], v0y = q[1], v0z = q[2];
  const float e1x = q[3], e1y = q[4], e1z = q[5];
  const float e2x = q[6], e2y = q[7], e2z = q[8];
  const float dx = l.dx, dy = l.dy, dz = l.dz;
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float s = det < 0.f ? -1.f : 1.f;
  const float dd = fabsf(det);
  const float tx = l.r.ox - v0x;
  const float ty = l.r.oy - v0y;
  const float tz = l.r.oz - v0z;
  const float un = (tx * px + ty * py + tz * pz) * s;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float vn = (dx * qx + dy * qy + dz * qz) * s;
  const float tn = (e2x * qx + e2y * qy + e2z * qz) * s;
  return dd > 1e-12f && un >= 0.f && vn >= 0.f && un + vn <= dd &&
         tn > l.r.tmin * dd && tn < l.tcap * dd && id != l.ex0 &&
         id != l.ex1;
}

// The shared-origin test of kernel 6 (cluster_intersect.py:_mt_nee's
// arithmetic): the origin terms, then the direction's dot products.
__device__ __forceinline__ bool occludes_nee(const float* q, const Lane& l) {
  const float v0x = q[0], v0y = q[1], v0z = q[2];
  const float e1x = q[3], e1y = q[4], e1z = q[5];
  const float e2x = q[6], e2y = q[7], e2z = q[8];
  const float tx = l.r.ox - v0x;
  const float ty = l.r.oy - v0y;
  const float tz = l.r.oz - v0z;
  // m1 = e2 x e1  (det = d . m1)
  const float m1x = e2y * e1z - e2z * e1y;
  const float m1y = e2z * e1x - e2x * e1z;
  const float m1z = e2x * e1y - e2y * e1x;
  // w = e2 x tvec  (u_num = d . w)
  const float wx = e2y * tz - e2z * ty;
  const float wy = e2z * tx - e2x * tz;
  const float wz = e2x * ty - e2y * tx;
  // qvec = tvec x e1  (v_num = d . qvec; t_num = e2 . qvec)
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float tnum = e2x * qx + e2y * qy + e2z * qz;
  const float dx = l.dx, dy = l.dy, dz = l.dz;
  const float det = dx * m1x + dy * m1y + dz * m1z;
  const float s = det < 0.f ? -1.f : 1.f;
  const float dd = fabsf(det);
  const float un = (dx * wx + dy * wy + dz * wz) * s;
  const float vn = (dx * qx + dy * qy + dz * qz) * s;
  const float tn = tnum * s;
  return dd > 1e-12f && un >= 0.f && vn >= 0.f && un + vn <= dd &&
         tn > l.r.tmin * dd && tn < l.tcap * dd;
}

__device__ __forceinline__ void store_best(const Best& b, int i,
                                           float* __restrict__ t_out,
                                           int* __restrict__ prim_out,
                                           float* __restrict__ u_out,
                                           float* __restrict__ v_out) {
  t_out[i] = b.prim < 0 ? -1.f : b.t;
  prim_out[i] = b.prim;
  u_out[i] = b.u;
  v_out[i] = b.v;
}

// Every thread of the block copies part of the flat accel's [C, 8] boxes
// into shared memory.
__device__ __forceinline__ void stage_boxes(float* s_box,
                                            const float* __restrict__ aabb,
                                            int n_clusters) {
  for (int j = threadIdx.x; j < n_clusters * 8; j += blockDim.x) {
    s_box[j] = aabb[j];
  }
  __syncthreads();
}

// ---- the cooperative staged sweep of kernels 6 and 8 ----

// A walk: the threads that gate together and share the staged clusters,
// one warp (W = 1) or the whole block of W warps.
template <int W>
struct Walk {
  static constexpr int kSize = 32 * W;
  __device__ static int rank() { return threadIdx.x % kSize; }
  __device__ static void sync() {
    if constexpr (W == 1) {
      __syncwarp();
    } else {
      __syncthreads();
    }
  }
  __device__ static bool any(bool p) {
    if constexpr (W == 1) {
      return __any_sync(0xffffffffu, p);
    } else {
      return __syncthreads_or(p) != 0;
    }
  }
  // also orders the walk's shared-memory reads before later writes
  __device__ static bool all(bool p) {
    if constexpr (W == 1) {
      __syncwarp();
      return __all_sync(0xffffffffu, p);
    } else {
      return __syncthreads_and(p) != 0;
    }
  }
  // OR of every thread's bits over a block walk; s_or holds 2*W words,
  // par alternates
  __device__ static uint32_t or_bits(uint32_t m, uint32_t* s_or, int& par) {
    static_assert(W > 1, "a warp walk ORs with __reduce_or_sync");
    m = __reduce_or_sync(0xffffffffu, m);
    if ((threadIdx.x & 31) == 0) s_or[par * W + (threadIdx.x >> 5)] = m;
    __syncthreads();
    uint32_t u = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) u |= s_or[par * W + w];
    par ^= 1;
    return u;
  }
};

// One staged cluster: its triangles' rows of 9 floats and their ids.
struct Stage {
  const float* tri;
  const int* id;
};

// The walk's two staging buffers, each `leaf` rows and ids.
struct Buffers {
  float* tri;
  int* id;
  int leaf;
  __device__ float* tri_of(int b) const { return tri + b * leaf * 9; }
  __device__ int* id_of(int b) const { return id + b * leaf; }
};

// Start the asynchronous copy (cp.async) of cluster c's cnt triangles and
// ids into buffer b, spread over the walk's threads.  With vec (leaf % 4 ==
// 0, so every cluster's block is 16-byte aligned) in 16-byte pieces,
// rounded up inside the cluster's block; else word by word.
template <int W>
__device__ __forceinline__ void stage_cluster(const Tris& a, int c, int cnt,
                                              const Buffers& buf, int b,
                                              bool vec) {
  const float* tp = a.tris + static_cast<size_t>(c) * a.leaf * 9;
  const int* ip = a.tri_id + static_cast<size_t>(c) * a.leaf;
  float* st = buf.tri_of(b);
  int* si = buf.id_of(b);
  if (vec) {
    const int nf = (cnt * 9 + 3) >> 2;
    const int ni = (cnt + 3) >> 2;
    for (int j = Walk<W>::rank(); j < nf + ni; j += Walk<W>::kSize) {
      if (j < nf) {
        __pipeline_memcpy_async(st + 4 * j, tp + 4 * j, 16);
      } else {
        __pipeline_memcpy_async(si + 4 * (j - nf), ip + 4 * (j - nf), 16);
      }
    }
  } else {
    const int nf = cnt * 9;
    for (int j = Walk<W>::rank(); j < nf + cnt; j += Walk<W>::kSize) {
      if (j < nf) {
        __pipeline_memcpy_async(st + j, tp + j, 4);
      } else {
        __pipeline_memcpy_async(si + (j - nf), ip + (j - nf), 4);
      }
    }
  }
}

// The clusters base + j, for the set bits j of u (the OR of the walk's
// gates), in order: each is staged while the one before it is tested, and
// test(stage, cnt, j) runs in every thread of the walk (it applies the
// thread's own gate and sets `done` at the thread's first occluder).
// Returns true as soon as every thread of the walk is done.
template <int W, class Test>
__device__ __forceinline__ bool staged_sweep(const Tris& a, uint32_t u,
                                             int base, const Buffers& buf,
                                             bool vec, const bool& done,
                                             Test&& test) {
  int cnt = __ldg(a.count + base + __ffs(u) - 1);
  stage_cluster<W>(a, base + __ffs(u) - 1, cnt, buf, 0, vec);
  __pipeline_commit();
  for (int b = 0; u; b ^= 1) {
    const int j = __ffs(u) - 1;
    u &= u - 1;
    int next_cnt = 0;
    if (u) {
      next_cnt = __ldg(a.count + base + __ffs(u) - 1);
      stage_cluster<W>(a, base + __ffs(u) - 1, next_cnt, buf, b ^ 1, vec);
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);
    Walk<W>::sync();
    test(Stage{buf.tri_of(b), buf.id_of(b)}, cnt, j);
    if (Walk<W>::all(done)) {
      __pipeline_wait_prior(0);
      return true;
    }
    cnt = next_cnt;
  }
  return false;
}

constexpr unsigned kFull = 0xffffffffu;

// Lane q's ray (the fields the triangle tests read), in every lane of the
// warp.
__device__ __forceinline__ Lane shfl_lane(const Lane& l, int q) {
  Lane r;
  r.r.ox = __shfl_sync(kFull, l.r.ox, q);
  r.r.oy = __shfl_sync(kFull, l.r.oy, q);
  r.r.oz = __shfl_sync(kFull, l.r.oz, q);
  r.r.tmin = __shfl_sync(kFull, l.r.tmin, q);
  r.dx = __shfl_sync(kFull, l.dx, q);
  r.dy = __shfl_sync(kFull, l.dy, q);
  r.dz = __shfl_sync(kFull, l.dz, q);
  r.tcap = __shfl_sync(kFull, l.tcap, q);
  r.ex0 = __shfl_sync(kFull, l.ex0, q);
  r.ex1 = __shfl_sync(kFull, l.ex1, q);
  return r;
}

// The test of a staged cluster, triangle-parallel in each warp: the warp
// takes the rays of its lanes that pass (their own gates passed, not yet
// done) one by one, each broadcast from its lane, and its 32 lanes test 32
// of the cluster's triangles at a time with occ(row, id, ray); a ray stops
// at its first occluder, which its own lane records.  A warp with few
// passing rays so makes few tests, where a thread per ray would walk every
// triangle while the others wait.
template <class Occ>
__device__ __forceinline__ void warp_test(Stage s, int cnt, bool pass,
                                          const Lane& l, bool& hit,
                                          bool& done, Occ occ) {
  const int lane = threadIdx.x & 31;
  for (uint32_t m = __ballot_sync(kFull, pass); m; m &= m - 1) {
    const int q = __ffs(m) - 1;
    const Lane r = shfl_lane(l, q);
    for (int t0 = 0; t0 < cnt; t0 += 32) {
      const int t = t0 + lane;
      const bool h = t < cnt && occ(s.tri + t * 9, s.id[t], r);
      if (__any_sync(kFull, h)) {
        if (lane == q) {
          hit = true;
          done = true;
        }
        break;
      }
    }
  }
}

// The closest-hit test of a staged cluster, triangle-parallel in each warp:
// the warp takes the rays of its lanes that pass one by one, each broadcast
// from its lane with its best t at the cluster's start, and its 32 lanes
// test 32 of the cluster's triangles at a time (closest_test).  A warp
// arg-min over (t, slot) keeps the smallest t and, among equal t, the
// lowest slot: the triangle that the sequential `t < best t` loop keeps.
// The ray's own lane takes t, prim, u and v from the winning lane.  When
// most of the warp's rays pass, each instead walks the staged triangles in
// order in its own lane (closest_loop, broadcast reads): that costs cnt
// tests, the triangle-parallel test popc * ceil(cnt / 32) and about a
// third more for the broadcasts and the arg-min (24 of 32 rays on a full
// cluster; measured against 16, 28 and never on kernels 7 and 4, PERF.md).
__device__ __forceinline__ void warp_closest(Stage s, int cnt, bool pass,
                                             const Lane& l, Best& b) {
  constexpr int kNoSlot = 0x7fffffff;
  const int lane = threadIdx.x & 31;
  const uint32_t passing = __ballot_sync(kFull, pass);
  if (4 * __popc(passing) * ((cnt + 31) >> 5) >= 3 * cnt) {
    if (pass) closest_loop(s.tri, s.id, cnt, l, b);
    return;
  }
  for (uint32_t m = passing; m; m &= m - 1) {
    const int q = __ffs(m) - 1;
    const Lane r = shfl_lane(l, q);
    // this lane's best over its slots lane, lane + 32, ...: they rise, so
    // the strict t < wt keeps the lowest slot of equal t
    float wt = __shfl_sync(kFull, b.t, q), wu = 0.f, wv = 0.f;
    int ws = kNoSlot, wp = -1;
    for (int k = lane; k < cnt; k += 32) {
      float t, u, v;
      if (closest_test(s.tri + k * 9, s.id[k], r, wt, t, u, v)) {
        wt = t;
        wu = u;
        wv = v;
        ws = k;
        wp = s.id[k];
      }
    }
#pragma unroll
    for (int off = 16; off; off >>= 1) {
      const float ot = __shfl_xor_sync(kFull, wt, off);
      const int os = __shfl_xor_sync(kFull, ws, off);
      if (ot < wt || (ot == wt && os < ws)) {
        wt = ot;
        ws = os;
      }
    }
    if (ws != kNoSlot) {  // the same in every lane
      const int src = ws & 31;
      const float hu = __shfl_sync(kFull, wu, src);
      const float hv = __shfl_sync(kFull, wv, src);
      const int hp = __shfl_sync(kFull, wp, src);
      if (lane == q) {
        b.t = wt;
        b.u = hu;
        b.v = hv;
        b.prim = hp;
      }
    }
  }
}

// ---- flat walk (kernels 4-6) ----

constexpr int kWarps = kBlock / 32;
constexpr int kGateBits = 32;  // cluster gates per ballot

// floats of shared memory of the flat walk: the boxes, and two staging
// buffers of leaf rows of 9 floats and an id
__host__ __device__ int flat_walk_floats(int n_clusters, int leaf) {
  return n_clusters * 8 + 2 * leaf * 10;
}

// The flat walk of kernels 4, 5 and 6; the block is the walk.  Each thread
// takes one ray -- load(l, done) fills it and returns the index of its
// output, or -1 for none, and sets done for none or a dead ray -- and gates
// it, 32 cluster boxes at a time, with cap(l), its cap at the ballot; the
// clusters in the OR of the block's gates are staged in order, and
// test(stage, cnt, pass, box, l, done) runs in every thread of the block
// (pass: the thread's ballot gate of the cluster, and not done; box: the
// cluster's box in shared memory).  The walk ends when every thread is
// done.  Returns load's index.  smem: flat_walk_floats.
template <class Load, class Cap, class Test>
__device__ __forceinline__ int flat_walk(const float* __restrict__ aabb,
                                         int n_clusters, const Tris& a,
                                         float* smem, uint32_t* s_or,
                                         Load load, Cap cap, Test test) {
  using B = Walk<kWarps>;
  float* s_box = smem;
  stage_boxes(s_box, aabb, n_clusters);
  float* s_tri = s_box + n_clusters * 8;
  const Buffers buf{s_tri, reinterpret_cast<int*>(s_tri + 2 * a.leaf * 9),
                    a.leaf};
  Lane l{};
  bool done = true;
  const int out = load(l, done);
  uint32_t gate = 0;
  int c0 = 0;
  auto sweep = [&](Stage s, int cnt, int j) {
    test(s, cnt, !done && ((gate >> j) & 1u), s_box + (c0 + j) * 8, l, done);
  };
  const bool vec = (a.leaf & 3) == 0;
  int par = 0;
  if (!B::all(done)) {
    for (; c0 < n_clusters; c0 += kGateBits) {
      gate = 0;
      if (!done) {
        const float c = cap(l);
        const int m = min(kGateBits, n_clusters - c0);
        for (int j = 0; j < m; ++j) {
          gate |= static_cast<uint32_t>(
                      slab<true>(s_box + (c0 + j) * 8, l.r, c))
                  << j;
        }
      }
      const uint32_t u = B::or_bits(gate, s_or, par);
      if (u && staged_sweep<kWarps>(a, u, c0, buf, vec, done, sweep)) {
        break;
      }
    }
  }
  return out;
}

// Thread i's ray of kernels 4 and 5, in input order.
__device__ __forceinline__ int load_ray(const RayIn& in, int n, Lane& l,
                                        bool& done) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return -1;
  l = load_lane(in, i);
  // a dead ray (0 < tmax <= tmin) has no t in (tmin, tmax) to hit
  const float tmax = in.tmax[i];
  done = tmax > 0.f && tmax <= l.r.tmin;
  return i;
}

// The any-hit test of kernels 5 and 6 for flat_walk: warp_test with
// occ(row, id, ray), recording the thread's hit.
template <class Occ>
__device__ __forceinline__ auto any_test(bool& hit, Occ occ) {
  return [&hit, occ](Stage s, int cnt, bool pass, const float*,
                     const Lane& l, bool& done) {
    warp_test(s, cnt, pass, l, hit, done, occ);
  };
}

// Kernel 4: flat_walk with closest-hit gates.  Each thread gates its ray
// with cap = min(tmax cap, best t) at the ballot, and takes its gate again
// with its best t now just before its test (warp_closest; see the header).
__global__ void __launch_bounds__(kBlock) cluster_closest_hit_kernel(
    const float* __restrict__ aabb, int n_clusters, Tris a, RayIn in,
    float* __restrict__ t_out, int* __restrict__ prim_out,
    float* __restrict__ u_out, float* __restrict__ v_out, int n) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint32_t s_or[2 * kWarps];
  Best b{kBig, 0.f, 0.f, -1};
  const int i = flat_walk(
      aabb, n_clusters, a, smem, s_or,
      [&](Lane& l, bool& done) { return load_ray(in, n, l, done); },
      [&](const Lane& l) { return fminf(l.tcap, b.t); },
      [&](Stage s, int cnt, bool pass, const float* box, const Lane& l,
          bool&) {
        warp_closest(s, cnt, pass && slab<true>(box, l.r, fminf(l.tcap, b.t)),
                     l, b);
      });
  if (i >= 0) store_best(b, i, t_out, prim_out, u_out, v_out);
}

// Kernel 5: one ray per thread, in input order.
__global__ void __launch_bounds__(kBlock) cluster_any_hit_kernel(
    const float* __restrict__ aabb, int n_clusters, Tris a, RayIn in,
    uint8_t* __restrict__ hit_out, int n) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint32_t s_or[2 * kWarps];
  bool hit = false;
  const int i = flat_walk(
      aabb, n_clusters, a, smem, s_or,
      [&](Lane& l, bool& done) { return load_ray(in, n, l, done); },
      [](const Lane& l) { return l.tcap; },
      any_test(hit, [](const float* q, int id, const Lane& r) {
        return occludes(q, id, r);
      }));
  if (i >= 0) hit_out[i] = hit;
}

// A NEE bundle of K*n shadow rays: per lane [n] the shared origin, tmin
// and exclusions; per ray [K*n] (sample-major: ray k*n + lane) the
// direction and cap.
struct NeeRays {
  const float* __restrict__ ox;
  const float* __restrict__ oy;
  const float* __restrict__ oz;
  const float* __restrict__ tmin;
  const int* __restrict__ ex0;
  const int* __restrict__ ex1;
  const float* __restrict__ dx;
  const float* __restrict__ dy;
  const float* __restrict__ dz;
  const float* __restrict__ tcap;
};

// Kernel 6: thread i takes direction i % K of lane i / K, so a lane's K
// rays sit on neighbouring threads.
__global__ void __launch_bounds__(kBlock) cluster_any_hit_nee_kernel(
    const float* __restrict__ aabb, int n_clusters, Tris a, NeeRays rays,
    uint8_t* __restrict__ hit_out, int n, int K) {
  extern __shared__ __align__(16) float smem[];
  __shared__ uint32_t s_or[2 * kWarps];
  bool hit = false;
  const int out = flat_walk(
      aabb, n_clusters, a, smem, s_or,
      [&](Lane& l, bool& done) {
        const int i = blockIdx.x * kBlock + threadIdx.x;
        const int lane = i / K;
        if (lane >= n) return -1;
        const int r = (i - lane * K) * n + lane;
        l.dx = rays.dx[r];
        l.dy = rays.dy[r];
        l.dz = rays.dz[r];
        l.r = Ray{rays.ox[lane], rays.oy[lane], rays.oz[lane], inv_dir(l.dx),
                  inv_dir(l.dy), inv_dir(l.dz), rays.tmin[lane]};
        const float c = rays.tcap[r];
        l.tcap = c > 0.f ? c : kBig;
        l.ex0 = rays.ex0 ? rays.ex0[lane] : -2;
        l.ex1 = rays.ex1 ? rays.ex1[lane] : -2;
        // a dead ray (0 < tcap <= tmin) has no t in (tmin, tcap) to hit
        done = c > 0.f && c <= l.r.tmin;
        return r;
      },
      [](const Lane& l) { return l.tcap; },
      any_test(hit, [](const float* q, int id, const Lane& r) {
        return id != r.ex0 && id != r.ex1 && occludes_nee(q, r);
      }));
  if (out >= 0) hit_out[out] = hit;
}

// ---- grouped walk (kernels 7-8) ----

struct Groups {
  const float* __restrict__ g_aabb;
  const float* __restrict__ o_aabb;
  const float* __restrict__ c_aabb;
  int n_groups, group;
};

// floats of shared memory per walk: the group's octet and cluster boxes,
// and two staging buffers of leaf rows of 9 floats and an id
__host__ __device__ int grouped_walk_floats(int group, int leaf) {
  return (group / kOctet + group) * 8 + 2 * leaf * 10;
}

// Kernel 7: each warp is a walk, with its own grouped_walk_floats of
// smem, as in kernel 8.  Every thread gates its own ray with cap =
// min(tmax cap, best t): the group box on entering the group; then, the
// group's octet and cluster boxes staged in shared memory, each octet box on
// entering the octet and its 8 cluster boxes there; a level no ray of the
// warp passes is skipped.  Best t only falls during the octet's sweep, so
// those cluster gates are a superset: their OR picks the clusters staged,
// and each ray takes its gate again, with its best t now, just before its
// test (see the header).
__global__ void __launch_bounds__(kBlock) grouped_closest_hit_kernel(
    Groups g, Tris a, RayIn in, float* __restrict__ t_out,
    int* __restrict__ prim_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int n) {
  using B = Walk<1>;
  extern __shared__ __align__(16) float smem[];
  const int n_oct = g.group / kOctet;
  const int box_f = (n_oct + g.group) * 8;
  float* s_obox = smem + (threadIdx.x / B::kSize) *
                             grouped_walk_floats(g.group, a.leaf);
  const float* s_cbox = s_obox + n_oct * 8;
  const Buffers buf{s_obox + box_f,
                    reinterpret_cast<int*>(s_obox + box_f + 2 * a.leaf * 9),
                    a.leaf};
  const int i = blockIdx.x * kBlock + threadIdx.x;
  Lane l{};
  bool done = true;
  if (i < n) {
    l = load_lane(in, i);
    // a dead ray (0 < tmax <= tmin) has no t in (tmin, tmax) to hit
    const float tmax = in.tmax[i];
    done = tmax > 0.f && tmax <= l.r.tmin;
  }
  Best b{kBig, 0.f, 0.f, -1};
  const bool vec = (a.leaf & 3) == 0;
  const int n_groups = B::all(done) ? 0 : g.n_groups;
  for (int gi = 0; gi < n_groups; ++gi) {
    const bool pg =
        !done && slab<false>(g.g_aabb + gi * 8, l.r, fminf(l.tcap, b.t));
    if (!B::any(pg)) continue;
    // the group's octet boxes, then its cluster boxes, into shared memory
    B::sync();
    const float4* ob = reinterpret_cast<const float4*>(
        g.o_aabb + static_cast<size_t>(gi) * n_oct * 8);
    const float4* cb = reinterpret_cast<const float4*>(
        g.c_aabb + static_cast<size_t>(gi) * g.group * 8);
    float4* so = reinterpret_cast<float4*>(s_obox);
    for (int j = B::rank(); j < box_f / 4; j += B::kSize) {
      so[j] = j < n_oct * 2 ? __ldg(ob + j) : __ldg(cb + (j - n_oct * 2));
    }
    B::sync();
    for (int oc = 0; oc < n_oct; ++oc) {
      const bool po =
          pg && slab<true>(s_obox + oc * 8, l.r, fminf(l.tcap, b.t));
      if (!B::any(po)) continue;
      const float* cbox = s_cbox + oc * kOctet * 8;
      uint32_t gate = 0;
      if (po) {
        for (int j = 0; j < kOctet; ++j) {
          gate |= static_cast<uint32_t>(
                      slab<true>(cbox + j * 8, l.r, fminf(l.tcap, b.t)))
                  << j;
        }
      }
      const uint32_t u = __reduce_or_sync(kFull, gate);
      if (u) {
        staged_sweep<1>(a, u, (gi * n_oct + oc) * kOctet, buf, vec, done,
                        [&](Stage s, int cnt, int j) {
                          warp_closest(
                              s, cnt,
                              ((gate >> j) & 1u) &&
                                  slab<true>(cbox + j * 8, l.r,
                                             fminf(l.tcap, b.t)),
                              l, b);
                        });
      }
    }
  }
  if (i < n) store_best(b, i, t_out, prim_out, u_out, v_out);
}

// Kernel 8: the same walk with the ray's own cap; a ray stops at its first
// occluder.
__global__ void __launch_bounds__(kBlock) grouped_any_hit_kernel(
    Groups g, Tris a, RayIn in, uint8_t* __restrict__ hit_out, int n) {
  using B = Walk<1>;
  extern __shared__ __align__(16) float smem[];
  const int n_oct = g.group / kOctet;
  const int box_f = (n_oct + g.group) * 8;
  float* s_obox = smem + (threadIdx.x / B::kSize) *
                             grouped_walk_floats(g.group, a.leaf);
  const float* s_cbox = s_obox + n_oct * 8;
  const Buffers buf{s_obox + box_f,
                    reinterpret_cast<int*>(s_obox + box_f + 2 * a.leaf * 9),
                    a.leaf};
  const int i = blockIdx.x * kBlock + threadIdx.x;
  Lane l{};
  bool done = true;
  if (i < n) {
    l = load_lane(in, i);
    const float tmax = in.tmax[i];
    // a dead ray (0 < tmax <= tmin) has no t in (tmin, tmax) to hit
    done = tmax > 0.f && tmax <= l.r.tmin;
  }
  bool hit = false;
  uint32_t gate = 0;
  auto test = [&](Stage s, int cnt, int j) {
    warp_test(s, cnt, !done && ((gate >> j) & 1u), l, hit, done,
              [](const float* q, int id, const Lane& r) {
                return occludes(q, id, r);
              });
  };
  const bool vec = (a.leaf & 3) == 0;
  bool finished = B::all(done);
  for (int gi = 0; gi < g.n_groups && !finished; ++gi) {
    const bool pg = !done && slab<false>(g.g_aabb + gi * 8, l.r, l.tcap);
    if (!B::any(pg)) continue;
    // the group's octet boxes, then its cluster boxes, into shared memory
    B::sync();
    const float4* ob = reinterpret_cast<const float4*>(
        g.o_aabb + static_cast<size_t>(gi) * n_oct * 8);
    const float4* cb = reinterpret_cast<const float4*>(
        g.c_aabb + static_cast<size_t>(gi) * g.group * 8);
    float4* so = reinterpret_cast<float4*>(s_obox);
    for (int j = B::rank(); j < box_f / 4; j += B::kSize) {
      so[j] = j < n_oct * 2 ? __ldg(ob + j) : __ldg(cb + (j - n_oct * 2));
    }
    B::sync();
    for (int oc = 0; oc < n_oct && !finished; ++oc) {
      const bool po = pg && !done && slab<true>(s_obox + oc * 8, l.r, l.tcap);
      if (!B::any(po)) continue;
      gate = 0;
      if (po) {
        for (int j = 0; j < kOctet; ++j) {
          gate |= static_cast<uint32_t>(slab<true>(
                      s_cbox + (oc * kOctet + j) * 8, l.r, l.tcap))
                  << j;
        }
      }
      const uint32_t u = __reduce_or_sync(0xffffffffu, gate);
      if (u) {
        finished = staged_sweep<1>(a, u, (gi * n_oct + oc) * kOctet, buf, vec,
                                   done, test);
      }
    }
  }
  if (i < n) hit_out[i] = hit;
}

int grid_of(int n, int block) { return (n + block - 1) / block; }

size_t flat_walk_bytes(int n_clusters, int leaf) {
  return static_cast<size_t>(flat_walk_floats(n_clusters, leaf)) *
         sizeof(float);
}

size_t grouped_walk_bytes(int group, int leaf) {
  return static_cast<size_t>(kWarps) * grouped_walk_floats(group, leaf) *
         sizeof(float);
}

// Dynamic shared memory above the 48 KB default must be asked for, up to
// the 227 KB a block can have.
template <class Kernel>
cudaError_t allow_smem(Kernel* kernel, size_t bytes) {
  if (bytes <= static_cast<size_t>(kStaticSmem)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

extern "C" {

// All return cudaGetLastError() after the launch (0 = success).  ex0/ex1
// may be null (no exclusion).  The flat kernels stage the [n_clusters, 8]
// boxes in shared memory (the flat path has fewer than 1,024 clusters).
// All five read the triangle tables in 16-byte pieces when leaf % 4 == 0:
// tris and tri_id must then be 16-byte aligned.

int cti_cluster_closest_hit(const float* aabb, const float* tris,
                            const int* tri_id, const int* count,
                            int n_clusters, int leaf, const float* ox,
                            const float* oy, const float* oz, const float* dx,
                            const float* dy, const float* dz,
                            const float* tmin, const float* tmax,
                            const int* ex0, const int* ex1, float* t_out,
                            int* prim_out, float* u_out, float* v_out, int n,
                            void* stream) {
  const Tris a{tris, tri_id, count, leaf};
  const RayIn in{ox, oy, oz, dx, dy, dz, tmin, tmax, ex0, ex1};
  const size_t smem = flat_walk_bytes(n_clusters, leaf);
  const cudaError_t e = allow_smem(cluster_closest_hit_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cluster_closest_hit_kernel<<<grid_of(n, kBlock), kBlock, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      aabb, n_clusters, a, in, t_out, prim_out, u_out, v_out, n);
  return static_cast<int>(cudaGetLastError());
}

// hit_out: [n] bytes, 1 = occluded.
int cti_cluster_any_hit(const float* aabb, const float* tris,
                        const int* tri_id, const int* count, int n_clusters,
                        int leaf, const float* ox, const float* oy,
                        const float* oz, const float* dx, const float* dy,
                        const float* dz, const float* tmin, const float* tmax,
                        const int* ex0, const int* ex1, uint8_t* hit_out,
                        int n, void* stream) {
  const Tris a{tris, tri_id, count, leaf};
  const RayIn in{ox, oy, oz, dx, dy, dz, tmin, tmax, ex0, ex1};
  const size_t smem = flat_walk_bytes(n_clusters, leaf);
  const cudaError_t e = allow_smem(cluster_any_hit_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cluster_any_hit_kernel<<<grid_of(n, kBlock), kBlock, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      aabb, n_clusters, a, in, hit_out, n);
  return static_cast<int>(cudaGetLastError());
}

// A bundle of K shadow rays per lane: ox..ex1 [n] per lane; dx, dy, dz,
// tcap [K*n] sample-major (ray k*n + lane).  hit_out: [K*n] bytes,
// sample-major.
int cti_cluster_any_hit_nee(const float* aabb, const float* tris,
                            const int* tri_id, const int* count,
                            int n_clusters, int leaf, const float* ox,
                            const float* oy, const float* oz,
                            const float* tmin, const int* ex0,
                            const int* ex1, const float* dx, const float* dy,
                            const float* dz, const float* tcap,
                            uint8_t* hit_out, int n, int K, void* stream) {
  const Tris a{tris, tri_id, count, leaf};
  const NeeRays rays{ox, oy, oz, tmin, ex0, ex1, dx, dy, dz, tcap};
  const int total = K * n;
  const size_t smem = flat_walk_bytes(n_clusters, leaf);
  const cudaError_t e = allow_smem(cluster_any_hit_nee_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cluster_any_hit_nee_kernel<<<grid_of(total, kBlock), kBlock, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      aabb, n_clusters, a, rays, hit_out, n, K);
  return static_cast<int>(cudaGetLastError());
}

// group must be a multiple of 8; the boxes must be 16-byte aligned.
int cti_grouped_closest_hit(const float* g_aabb, const float* o_aabb,
                            const float* c_aabb, const float* tris,
                            const int* tri_id, const int* count, int n_groups,
                            int group, int leaf, const float* ox,
                            const float* oy, const float* oz, const float* dx,
                            const float* dy, const float* dz,
                            const float* tmin, const float* tmax,
                            const int* ex0, const int* ex1, float* t_out,
                            int* prim_out, float* u_out, float* v_out, int n,
                            void* stream) {
  const Groups g{g_aabb, o_aabb, c_aabb, n_groups, group};
  const Tris a{tris, tri_id, count, leaf};
  const RayIn in{ox, oy, oz, dx, dy, dz, tmin, tmax, ex0, ex1};
  const size_t smem = grouped_walk_bytes(group, leaf);
  const cudaError_t e = allow_smem(grouped_closest_hit_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  grouped_closest_hit_kernel<<<grid_of(n, kBlock), kBlock, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      g, a, in, t_out, prim_out, u_out, v_out, n);
  return static_cast<int>(cudaGetLastError());
}

// hit_out: [n] bytes, 1 = occluded.  The boxes must be 16-byte aligned.
int cti_grouped_any_hit(const float* g_aabb, const float* o_aabb,
                        const float* c_aabb, const float* tris,
                        const int* tri_id, const int* count, int n_groups,
                        int group, int leaf, const float* ox, const float* oy,
                        const float* oz, const float* dx, const float* dy,
                        const float* dz, const float* tmin, const float* tmax,
                        const int* ex0, const int* ex1, uint8_t* hit_out,
                        int n, void* stream) {
  const Groups g{g_aabb, o_aabb, c_aabb, n_groups, group};
  const Tris a{tris, tri_id, count, leaf};
  const RayIn in{ox, oy, oz, dx, dy, dz, tmin, tmax, ex0, ex1};
  const size_t smem = grouped_walk_bytes(group, leaf);
  const cudaError_t e = allow_smem(grouped_any_hit_kernel, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  grouped_any_hit_kernel<<<grid_of(n, kBlock), kBlock, smem,
                           static_cast<cudaStream_t>(stream)>>>(g, a, in,
                                                                hit_out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
