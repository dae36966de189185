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
// same functions in the same visit order.  Like intersect.cu this file is
// compiled with --fmad=false, so every product is rounded on its own as in
// the plain versions, and kernel and plain version agree bit for bit.
//
// Data.  The flat accel (ClusterAccel, scenes of fewer than 1,024
// clusters): aabb [C, 8].  The grouped accel (GroupedAccel): g_aabb [G, 8],
// o_aabb [G, group/8, 8] (octet-union boxes), c_aabb [G, group, 8].  Both:
// tris [C, leaf, 9] (v0, e1, e2), tri_id [C, leaf] and count [C] (a
// cluster's triangles come first).  Boxes are bmin xyz, bmax xyz, 2 pad
// floats.  Exclusions compare the triangle id (tri_id), not the slot.
//
// Design.  One thread per ray (per shading-point lane for the NEE bundle).
// The thread walks the clusters in build order -- flat: all of them, their
// boxes staged in shared memory (at most 1,023 x 32 B); grouped: groups,
// octets, clusters, boxes read through the read-only cache -- gates each
// level with the slab test of cluster_intersect.py:_slab_test (same
// eps-guarded reciprocal, same min/max order), and runs Moller-Trumbore
// over a passing cluster's triangles, read from global memory.
//   closest hit: the gates use tcap = min(tmax cap, best t) at the moment
//                they are tested, so everything behind the first hit is
//                culled; a hit is kept only if t < best t (strict: ties keep
//                the first triangle visited).
//   any hit:     the gates use the ray's cap; the division-free, sign-folded
//                test; the thread stops at its first hit (the TPU
//                approximates that with lanes dropping out of the gates).
//   NEE bundle:  K directions per thread in registers, each gated with its
//                own cap while it has no hit; a cluster that any direction
//                passes has its origin-only terms computed once per
//                triangle, then the det/un/vn tests of the passing
//                directions (_any_nee_kernel, :376-427).
// On the TPU the walk is a lockstep sweep of 1024-ray tiles with DMA'd
// triangle blocks (and, grouped, per-tile group orders); none of that is
// carried over.
//
// What bounds them on the H100: operations.  Each triangle test is ~57
// float operations (the NEE bundle: 35 per lane and triangle plus 29 per
// direction) against ~40 bytes of ray I/O per lane, and the triangle tables
// (2.7 MB for the 73.6k-triangle scene, ~38 MB at 1M) fit the 50 MB L2.  So
// the kernels are bound by FLOPs and by divergence: threads of a warp that
// walk different clusters serialise.  The design does nothing more about
// that yet than rely on coherent input order (camera rays in 32x32 pixel
// blocks; grouped NEE rays re-bucketed by direction and origin before the
// launch); shared-memory triangle staging and per-warp ordering are left
// for a later change.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kOctet = 8;
constexpr float kBig = 3.0e38f;

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

// Moller-Trumbore over cluster c's triangles, keeping t < best t.
__device__ __forceinline__ void cluster_closest(const Tris& a, int c,
                                                const Lane& l, Best& b) {
  const int cnt = __ldg(a.count + c);
  const float* tp = a.tris + static_cast<size_t>(c) * a.leaf * 9;
  const int* ip = a.tri_id + static_cast<size_t>(c) * a.leaf;
  const float dx = l.dx, dy = l.dy, dz = l.dz;
  for (int k = 0; k < cnt; ++k) {
    const float* q = tp + k * 9;
    const float v0x = __ldg(q + 0), v0y = __ldg(q + 1), v0z = __ldg(q + 2);
    const float e1x = __ldg(q + 3), e1y = __ldg(q + 4), e1z = __ldg(q + 5);
    const float e2x = __ldg(q + 6), e2y = __ldg(q + 7), e2z = __ldg(q + 8);
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
    const float u = (tx * px + ty * py + tz * pz) * inv_det;
    // qvec = tvec x e1
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
    const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
    const int id = __ldg(ip + k);
    const bool ok = det_ok && u >= 0.f && u <= 1.f && v >= 0.f &&
                    u + v <= 1.f && t > l.r.tmin && t < l.tcap && t < b.t &&
                    id != l.ex0 && id != l.ex1;
    if (ok) {
      b.t = t;
      b.prim = id;
      b.u = u;
      b.v = v;
    }
  }
}

// true when any triangle of cluster c occludes the ray in (tmin, tcap)
__device__ __forceinline__ bool cluster_any(const Tris& a, int c,
                                            const Lane& l) {
  const int cnt = __ldg(a.count + c);
  const float* tp = a.tris + static_cast<size_t>(c) * a.leaf * 9;
  const int* ip = a.tri_id + static_cast<size_t>(c) * a.leaf;
  const float dx = l.dx, dy = l.dy, dz = l.dz;
  for (int k = 0; k < cnt; ++k) {
    const float* q = tp + k * 9;
    const float v0x = __ldg(q + 0), v0y = __ldg(q + 1), v0z = __ldg(q + 2);
    const float e1x = __ldg(q + 3), e1y = __ldg(q + 4), e1z = __ldg(q + 5);
    const float e2x = __ldg(q + 6), e2y = __ldg(q + 7), e2z = __ldg(q + 8);
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
    const int id = __ldg(ip + k);
    if (dd > 1e-12f && un >= 0.f && vn >= 0.f && un + vn <= dd &&
        tn > l.r.tmin * dd && tn < l.tcap * dd && id != l.ex0 &&
        id != l.ex1) {
      return true;
    }
  }
  return false;
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

// ---- flat sweep (kernels 4-6) ----

__global__ void __launch_bounds__(kBlock) cluster_closest_hit_kernel(
    const float* __restrict__ aabb, int n_clusters, Tris a, RayIn in,
    float* __restrict__ t_out, int* __restrict__ prim_out,
    float* __restrict__ u_out, float* __restrict__ v_out, int n) {
  extern __shared__ float s_box[];
  stage_boxes(s_box, aabb, n_clusters);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Lane l = load_lane(in, i);
  Best b{kBig, 0.f, 0.f, -1};
  for (int c = 0; c < n_clusters; ++c) {
    if (slab<true>(s_box + c * 8, l.r, fminf(l.tcap, b.t))) {
      cluster_closest(a, c, l, b);
    }
  }
  store_best(b, i, t_out, prim_out, u_out, v_out);
}

__global__ void __launch_bounds__(kBlock) cluster_any_hit_kernel(
    const float* __restrict__ aabb, int n_clusters, Tris a, RayIn in,
    uint8_t* __restrict__ hit_out, int n) {
  extern __shared__ float s_box[];
  stage_boxes(s_box, aabb, n_clusters);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Lane l = load_lane(in, i);
  uint8_t hit = 0;
  for (int c = 0; c < n_clusters; ++c) {
    if (slab<true>(s_box + c * 8, l.r, l.tcap) && cluster_any(a, c, l)) {
      hit = 1;
      break;
    }
  }
  hit_out[i] = hit;
}

template <int K>
struct NeeDirs {
  const float* dx[K];
  const float* dy[K];
  const float* dz[K];
  const float* tcap[K];
};

template <int K>
__global__ void __launch_bounds__(kBlock) cluster_any_hit_nee_kernel(
    const float* __restrict__ aabb, int n_clusters, Tris a,
    const float* __restrict__ ox_, const float* __restrict__ oy_,
    const float* __restrict__ oz_, const float* __restrict__ tmin_,
    const int* __restrict__ ex0_, const int* __restrict__ ex1_,
    NeeDirs<K> rays, uint8_t* __restrict__ hit_out, int n) {
  extern __shared__ float s_box[];
  stage_boxes(s_box, aabb, n_clusters);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float ox = ox_[i], oy = oy_[i], oz = oz_[i], tmin = tmin_[i];
  const int ex0 = ex0_ ? ex0_[i] : -2;
  const int ex1 = ex1_ ? ex1_[i] : -2;
  float dx[K], dy[K], dz[K], tc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    dx[k] = rays.dx[k][i];
    dy[k] = rays.dy[k][i];
    dz[k] = rays.dz[k][i];
    const float c = rays.tcap[k][i];
    tc[k] = c > 0.f ? c : kBig;
  }
  const uint32_t full = static_cast<uint32_t>((1ull << K) - 1ull);
  uint32_t mask = 0u;  // bit k: direction k is occluded
  for (int c = 0; c < n_clusters && mask != full; ++c) {
    // per-direction gates of the directions still live (:376-382)
    uint32_t gate = 0u;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const Ray r{ox, oy, oz, inv_dir(dx[k]), inv_dir(dy[k]), inv_dir(dz[k]),
                  tmin};
      const bool pass =
          !((mask >> k) & 1u) && slab<true>(s_box + c * 8, r, tc[k]);
      gate |= static_cast<uint32_t>(pass) << k;
    }
    if (!gate) continue;
    const int cnt = __ldg(a.count + c);
    const float* tp = a.tris + static_cast<size_t>(c) * a.leaf * 9;
    const int* ip = a.tri_id + static_cast<size_t>(c) * a.leaf;
    for (int j = 0; j < cnt; ++j) {
      const float* q = tp + j * 9;
      const float v0x = __ldg(q + 0), v0y = __ldg(q + 1), v0z = __ldg(q + 2);
      const float e1x = __ldg(q + 3), e1y = __ldg(q + 4), e1z = __ldg(q + 5);
      const float e2x = __ldg(q + 6), e2y = __ldg(q + 7), e2z = __ldg(q + 8);
      const int id = __ldg(ip + j);
      if (id == ex0 || id == ex1) continue;
      // origin-shared terms (:400-412)
      const float tx = ox - v0x;
      const float ty = oy - v0y;
      const float tz = oz - v0z;
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
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (!((gate >> k) & 1u)) continue;
        const float det = dx[k] * m1x + dy[k] * m1y + dz[k] * m1z;
        const float s = det < 0.f ? -1.f : 1.f;
        const float dd = fabsf(det);
        const float un = (dx[k] * wx + dy[k] * wy + dz[k] * wz) * s;
        const float vn = (dx[k] * qx + dy[k] * qy + dz[k] * qz) * s;
        const float tn = tnum * s;
        const bool ok = dd > 1e-12f && un >= 0.f && vn >= 0.f &&
                        un + vn <= dd && tn > tmin * dd && tn < tc[k] * dd;
        mask |= static_cast<uint32_t>(ok) << k;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    hit_out[static_cast<size_t>(k) * n + i] =
        static_cast<uint8_t>((mask >> k) & 1u);
  }
}

template <int K>
int launch_cluster_nee(const float* aabb, int n_clusters, const Tris& a,
                       const float* ox, const float* oy, const float* oz,
                       const float* tmin, const int* ex0, const int* ex1,
                       const void* const* dir_ptrs, uint8_t* hit, int n,
                       cudaStream_t stream) {
  NeeDirs<K> rays;
  for (int k = 0; k < K; ++k) {
    rays.dx[k] = static_cast<const float*>(dir_ptrs[k]);
    rays.dy[k] = static_cast<const float*>(dir_ptrs[K + k]);
    rays.dz[k] = static_cast<const float*>(dir_ptrs[2 * K + k]);
    rays.tcap[k] = static_cast<const float*>(dir_ptrs[3 * K + k]);
  }
  const int grid = (n + kBlock - 1) / kBlock;
  const size_t smem = static_cast<size_t>(n_clusters) * 8 * sizeof(float);
  cluster_any_hit_nee_kernel<K><<<grid, kBlock, smem, stream>>>(
      aabb, n_clusters, a, ox, oy, oz, tmin, ex0, ex1, rays, hit, n);
  return static_cast<int>(cudaGetLastError());
}

// ---- grouped walk (kernels 7-8) ----

struct Groups {
  const float* __restrict__ g_aabb;
  const float* __restrict__ o_aabb;
  const float* __restrict__ c_aabb;
  int n_groups, group;
};

__global__ void __launch_bounds__(kBlock) grouped_closest_hit_kernel(
    Groups g, Tris a, RayIn in, float* __restrict__ t_out,
    int* __restrict__ prim_out, float* __restrict__ u_out,
    float* __restrict__ v_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Lane l = load_lane(in, i);
  const int n_oct = g.group / kOctet;
  Best b{kBig, 0.f, 0.f, -1};
  for (int gi = 0; gi < g.n_groups; ++gi) {
    if (!slab<false>(g.g_aabb + gi * 8, l.r, fminf(l.tcap, b.t))) continue;
    for (int oc = 0; oc < n_oct; ++oc) {
      const int o = gi * n_oct + oc;
      if (!slab<false>(g.o_aabb + o * 8, l.r, fminf(l.tcap, b.t))) continue;
      for (int j = 0; j < kOctet; ++j) {
        const int c = o * kOctet + j;
        if (slab<false>(g.c_aabb + c * 8, l.r, fminf(l.tcap, b.t))) {
          cluster_closest(a, c, l, b);
        }
      }
    }
  }
  store_best(b, i, t_out, prim_out, u_out, v_out);
}

__global__ void __launch_bounds__(kBlock) grouped_any_hit_kernel(
    Groups g, Tris a, RayIn in, uint8_t* __restrict__ hit_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Lane l = load_lane(in, i);
  const int n_oct = g.group / kOctet;
  uint8_t hit = 0;
  for (int gi = 0; gi < g.n_groups && !hit; ++gi) {
    if (!slab<false>(g.g_aabb + gi * 8, l.r, l.tcap)) continue;
    for (int oc = 0; oc < n_oct && !hit; ++oc) {
      const int o = gi * n_oct + oc;
      if (!slab<false>(g.o_aabb + o * 8, l.r, l.tcap)) continue;
      for (int j = 0; j < kOctet; ++j) {
        const int c = o * kOctet + j;
        if (slab<false>(g.c_aabb + c * 8, l.r, l.tcap) &&
            cluster_any(a, c, l)) {
          hit = 1;
          break;
        }
      }
    }
  }
  hit_out[i] = hit;
}

int grid_of(int n) { return (n + kBlock - 1) / kBlock; }

size_t box_bytes(int n_clusters) {
  return static_cast<size_t>(n_clusters) * 8 * sizeof(float);
}

}  // namespace

extern "C" {

// All return cudaGetLastError() after the launch (0 = success).  ex0/ex1
// may be null (no exclusion).  The flat kernels stage the [n_clusters, 8]
// boxes in shared memory, so n_clusters must stay under 1,536 (48 KB; the
// flat path has fewer than 1,024).

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
  cluster_closest_hit_kernel<<<grid_of(n), kBlock, box_bytes(n_clusters),
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
  cluster_any_hit_kernel<<<grid_of(n), kBlock, box_bytes(n_clusters),
                           static_cast<cudaStream_t>(stream)>>>(
      aabb, n_clusters, a, in, hit_out, n);
  return static_cast<int>(cudaGetLastError());
}

// dir_ptrs: 4*K device pointers, K each of dx, dy, dz, tcap ([n] float32).
// hit_out: [K*n] bytes, sample-major.  K must be 2, 4, 8, 16 or 32.
int cti_cluster_any_hit_nee(const float* aabb, const float* tris,
                            const int* tri_id, const int* count,
                            int n_clusters, int leaf, const float* ox,
                            const float* oy, const float* oz,
                            const float* tmin, const int* ex0,
                            const int* ex1, int K,
                            const void* const* dir_ptrs, uint8_t* hit_out,
                            int n, void* stream) {
  const Tris a{tris, tri_id, count, leaf};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 2:
      return launch_cluster_nee<2>(aabb, n_clusters, a, ox, oy, oz, tmin,
                                   ex0, ex1, dir_ptrs, hit_out, n, s);
    case 4:
      return launch_cluster_nee<4>(aabb, n_clusters, a, ox, oy, oz, tmin,
                                   ex0, ex1, dir_ptrs, hit_out, n, s);
    case 8:
      return launch_cluster_nee<8>(aabb, n_clusters, a, ox, oy, oz, tmin,
                                   ex0, ex1, dir_ptrs, hit_out, n, s);
    case 16:
      return launch_cluster_nee<16>(aabb, n_clusters, a, ox, oy, oz, tmin,
                                    ex0, ex1, dir_ptrs, hit_out, n, s);
    case 32:
      return launch_cluster_nee<32>(aabb, n_clusters, a, ox, oy, oz, tmin,
                                    ex0, ex1, dir_ptrs, hit_out, n, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// group must be a multiple of 8.
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
  grouped_closest_hit_kernel<<<grid_of(n), kBlock, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      g, a, in, t_out, prim_out, u_out, v_out, n);
  return static_cast<int>(cudaGetLastError());
}

// hit_out: [n] bytes, 1 = occluded.
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
  grouped_any_hit_kernel<<<grid_of(n), kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(g, a, in,
                                                                hit_out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
