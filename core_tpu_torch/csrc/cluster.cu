// Grouped-cluster intersection kernels for Hopper (sm_90a), plain C interface.
//
// Two kernels, each the port of one Pallas TPU kernel of core_tpu:
//
//   cti_grouped_closest_hit <- core_tpu/geometry/cluster_intersect.py:_grouped_kernel
//   cti_grouped_any_hit     <- core_tpu/geometry/cluster_intersect.py:_grouped_any_kernel
//
// Their plain PyTorch versions are closest_hit_grouped_torch and
// any_hit_grouped_torch in geometry/cluster_intersect.py, which compute the
// same functions in the same visit order.  Like intersect.cu this file is
// compiled with --fmad=false, so every product is rounded on its own as in
// the plain versions, and kernel and plain version agree bit for bit.
//
// Data (GroupedAccel): g_aabb [G, 8], o_aabb [G, group/8, 8] (octet-union
// boxes), c_aabb [G, group, 8], tris [C, leaf, 9] (v0, e1, e2), tri_id
// [C, leaf] and count [C] (a cluster's triangles come first).  Boxes are
// bmin xyz, bmax xyz, 2 pad floats.
//
// Design.  One thread per ray.  The thread walks the groups in build order
// (group_clusters sorts groups and, inside each group, clusters near to far
// from the camera), gates each level -- group, octet, cluster -- with the
// slab test of cluster_intersect.py:_slab_test (same eps-guarded
// reciprocal, same min/max order), and runs Moller-Trumbore over a passing
// cluster's triangles, read from global memory through the read-only cache.
//   closest hit: the gates use tcap = min(tmax cap, best t) at the moment
//                they are tested, so everything behind the first hit is
//                culled; a hit is kept only if t < best t (strict: ties keep
//                the first triangle visited).
//   any hit:     the gates use the ray's cap; the division-free, sign-folded
//                test of _grouped_any_kernel; the thread stops at its first
//                hit (the TPU approximates that with a per-tile done flag
//                and lanes dropping out of the gates).
// On the TPU the walk is a lockstep sweep of 1024-ray tiles with per-tile
// group orders and DMA'd triangle blocks; none of that is carried over.
//
// What bounds them on the H100: operations.  A camera ray of the 1M-triangle
// scene passes a few clusters of <= 128 triangles, a grazing shadow ray many;
// each test is ~57 float operations against 40 bytes of ray I/O, and the
// whole triangle table (~38 MB) fits the 50 MB L2.  So the kernels are bound
// by FLOPs and by divergence: threads of a warp that walk different clusters
// serialise.  The design does nothing more about that yet than rely on
// coherent input order (camera rays in 32x32 pixel blocks, NEE rays
// re-bucketed by direction and origin before the launch); shared-memory
// staging and per-warp ordering are left for a later change.
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

// cluster_intersect.py:_slab_test against box b (8 floats)
__device__ __forceinline__ bool slab(const float* __restrict__ b,
                                     const Ray& r, float tcap) {
  const float q0x = (__ldg(b + 0) - r.ox) * r.ix;
  const float q1x = (__ldg(b + 3) - r.ox) * r.ix;
  const float q0y = (__ldg(b + 1) - r.oy) * r.iy;
  const float q1y = (__ldg(b + 4) - r.oy) * r.iy;
  const float q0z = (__ldg(b + 2) - r.oz) * r.iz;
  const float q1z = (__ldg(b + 5) - r.oz) * r.iz;
  const float tn = fmaxf(fmaxf(fminf(q0x, q1x), fminf(q0y, q1y)),
                         fmaxf(fminf(q0z, q1z), r.tmin));
  const float tf = fminf(fminf(fmaxf(q0x, q1x), fmaxf(q0y, q1y)),
                         fminf(fmaxf(q0z, q1z), tcap));
  return tn <= tf;
}

struct Accel {
  const float* __restrict__ g_aabb;
  const float* __restrict__ o_aabb;
  const float* __restrict__ c_aabb;
  const float* __restrict__ tris;
  const int* __restrict__ tri_id;
  const int* __restrict__ count;
  int n_groups, group, leaf;
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

__global__ void __launch_bounds__(kBlock) grouped_closest_hit_kernel(
    Accel a, RayIn in, float* __restrict__ t_out, int* __restrict__ prim_out,
    float* __restrict__ u_out, float* __restrict__ v_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float dx = in.dx[i], dy = in.dy[i], dz = in.dz[i];
  const Ray r{in.ox[i], in.oy[i], in.oz[i],
              inv_dir(dx), inv_dir(dy), inv_dir(dz), in.tmin[i]};
  const float tmax = in.tmax[i];
  const float tcap = tmax > 0.f ? tmax : kBig;
  const int ex0 = in.ex0 ? in.ex0[i] : -2;
  const int ex1 = in.ex1 ? in.ex1[i] : -2;
  const int n_oct = a.group / kOctet;
  float bt = kBig, bu = 0.f, bv = 0.f;
  int bp = -1;
  for (int g = 0; g < a.n_groups; ++g) {
    if (!slab(a.g_aabb + g * 8, r, fminf(tcap, bt))) continue;
    for (int oc = 0; oc < n_oct; ++oc) {
      const int o = g * n_oct + oc;
      if (!slab(a.o_aabb + o * 8, r, fminf(tcap, bt))) continue;
      for (int j = 0; j < kOctet; ++j) {
        const int c = o * kOctet + j;
        if (!slab(a.c_aabb + c * 8, r, fminf(tcap, bt))) continue;
        const int cnt = __ldg(a.count + c);
        const float* tp = a.tris + static_cast<size_t>(c) * a.leaf * 9;
        const int* ip = a.tri_id + static_cast<size_t>(c) * a.leaf;
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
          const float tx = r.ox - v0x;
          const float ty = r.oy - v0y;
          const float tz = r.oz - v0z;
          const float u = (tx * px + ty * py + tz * pz) * inv_det;
          // qvec = tvec x e1
          const float qx = ty * e1z - tz * e1y;
          const float qy = tz * e1x - tx * e1z;
          const float qz = tx * e1y - ty * e1x;
          const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
          const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
          const int id = __ldg(ip + k);
          const bool ok = det_ok && u >= 0.f && u <= 1.f && v >= 0.f &&
                          u + v <= 1.f && t > r.tmin && t < tcap && t < bt &&
                          id != ex0 && id != ex1;
          if (ok) {
            bt = t;
            bp = id;
            bu = u;
            bv = v;
          }
        }
      }
    }
  }
  t_out[i] = bp < 0 ? -1.f : bt;
  prim_out[i] = bp;
  u_out[i] = bu;
  v_out[i] = bv;
}

// true when any triangle of cluster c occludes the ray in (tmin, tcap)
__device__ __forceinline__ bool cluster_any(const Accel& a, int c,
                                            const Ray& r, float dx, float dy,
                                            float dz, float tcap, int ex0,
                                            int ex1) {
  const int cnt = __ldg(a.count + c);
  const float* tp = a.tris + static_cast<size_t>(c) * a.leaf * 9;
  const int* ip = a.tri_id + static_cast<size_t>(c) * a.leaf;
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
    const float tx = r.ox - v0x;
    const float ty = r.oy - v0y;
    const float tz = r.oz - v0z;
    const float un = (tx * px + ty * py + tz * pz) * s;
    const float qx = ty * e1z - tz * e1y;
    const float qy = tz * e1x - tx * e1z;
    const float qz = tx * e1y - ty * e1x;
    const float vn = (dx * qx + dy * qy + dz * qz) * s;
    const float tn = (e2x * qx + e2y * qy + e2z * qz) * s;
    const int id = __ldg(ip + k);
    if (dd > 1e-12f && un >= 0.f && vn >= 0.f && un + vn <= dd &&
        tn > r.tmin * dd && tn < tcap * dd && id != ex0 && id != ex1) {
      return true;
    }
  }
  return false;
}

__global__ void __launch_bounds__(kBlock) grouped_any_hit_kernel(
    Accel a, RayIn in, uint8_t* __restrict__ hit_out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float dx = in.dx[i], dy = in.dy[i], dz = in.dz[i];
  const Ray r{in.ox[i], in.oy[i], in.oz[i],
              inv_dir(dx), inv_dir(dy), inv_dir(dz), in.tmin[i]};
  const float tmax = in.tmax[i];
  const float tcap = tmax > 0.f ? tmax : kBig;
  const int ex0 = in.ex0 ? in.ex0[i] : -2;
  const int ex1 = in.ex1 ? in.ex1[i] : -2;
  const int n_oct = a.group / kOctet;
  uint8_t hit = 0;
  for (int g = 0; g < a.n_groups && !hit; ++g) {
    if (!slab(a.g_aabb + g * 8, r, tcap)) continue;
    for (int oc = 0; oc < n_oct && !hit; ++oc) {
      const int o = g * n_oct + oc;
      if (!slab(a.o_aabb + o * 8, r, tcap)) continue;
      for (int j = 0; j < kOctet; ++j) {
        const int c = o * kOctet + j;
        if (slab(a.c_aabb + c * 8, r, tcap) &&
            cluster_any(a, c, r, dx, dy, dz, tcap, ex0, ex1)) {
          hit = 1;
          break;
        }
      }
    }
  }
  hit_out[i] = hit;
}

}  // namespace

extern "C" {

// Both return cudaGetLastError() after the launch (0 = success).  group
// must be a multiple of 8; ex0/ex1 may be null (no exclusion).
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
  const Accel a{g_aabb, o_aabb, c_aabb, tris, tri_id, count,
                n_groups, group, leaf};
  const RayIn in{ox, oy, oz, dx, dy, dz, tmin, tmax, ex0, ex1};
  const int grid = (n + kBlock - 1) / kBlock;
  grouped_closest_hit_kernel<<<grid, kBlock, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      a, in, t_out, prim_out, u_out, v_out, n);
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
  const Accel a{g_aabb, o_aabb, c_aabb, tris, tri_id, count,
                n_groups, group, leaf};
  const RayIn in{ox, oy, oz, dx, dy, dz, tmin, tmax, ex0, ex1};
  const int grid = (n + kBlock - 1) / kBlock;
  grouped_any_hit_kernel<<<grid, kBlock, 0,
                           static_cast<cudaStream_t>(stream)>>>(a, in,
                                                                hit_out, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
