// Ray-triangle intersection kernels for Hopper (sm_90a), plain C interface.
//
// Three kernels, each the port of one Pallas TPU kernel of core_tpu:
//
//   cti_closest_hit  <- core_tpu/geometry/pallas_intersect.py:_intersect_kernel
//   cti_any_hit      <- core_tpu/geometry/pallas_intersect.py:_any_hit_kernel
//   cti_any_hit_nee  <- core_tpu/geometry/pallas_intersect.py:_any_hit_nee_kernel
//
// Each computes what its TPU kernel computes: the same Möller-Trumbore
// acceptance tests, the same exclusion and tcap rules and, at the wrapper,
// the same output layout.  Their plain PyTorch versions are in
// geometry/intersect.py and write the arithmetic in the same order.
//
// Parity note: this file is compiled with --fmad=false, so no multiply-add
// is contracted into an FMA and every product is rounded on its own, as in
// the plain versions.  That lets kernel and plain version be held to
// identical prim and occlusion bits.  A later change may turn contraction on
// under a measured tolerance.
//
// Design.  One thread per ray (closest hit, any hit) or per live
// shading-point lane (NEE bundle, below); ray components arrive as
// separate contiguous [N] arrays, and the ragged tail is masked rather than
// padded to a tile.
// The [T, 9] triangle table (v0, e1, e2) is staged through shared memory in
// chunks of kTriChunk rows (9 KB; 12 KB for the NEE bundle), so any T runs
// without the >48 KB opt-in; every thread of a warp reads the same row,
// which shared memory broadcasts.  The any-hit kernel stops testing a lane
// at its first occluder; the thread keeps taking part in the staging
// barriers.
//
// The NEE bundle (kernel 2) is built for the launches the path tracer
// makes.  Each bounce gives NEE only to the lanes whose path is alive, and
// every other lane gets dead caps (0 < tcap <= tmin, common._shadow_tcap):
// about half the lanes of a Cornell bounce launch.  A dead ray can never
// be occluded (for dd > 0, tcap * dd <= tmin * dd after rounding, so no tn
// passes both tests), so it is done from the start, and a lane is done
// once each of its rays is occluded or dead.  Dead and live lanes mix
// inside a warp (lanes are in path and pixel order), and a warp runs as
// long as its slowest thread, so the block compacts its live lanes first:
// a ballot and a scan of the warps' counts in shared memory give each live
// lane its rank, and thread j takes the j-th live lane of the block (its
// origin, K directions and caps, exclusions) and writes that lane's bits;
// a lane with no live ray writes its zeros itself.  Warps with no live
// lane skip the triangle loop (they still stage), and a block stops
// staging once none of its lanes is working.  There is no host sync and no
// device-memory intermediate.  Each staged triangle's lane-independent
// term m1 = e2 x e1 is computed once, at staging, into rows of 12 floats
// (v0, e1, e2, m1; three 16-byte loads), with the same arithmetic, and the
// sign fold flips sign bits (det = -0 or NaN flip where the product would
// not, but there dd > 1e-12 fails), so the bits stay those of the plain
// version; the flip measured 0-4% faster than the product (PERF.md).  On
// the Cornell bounce launches what is left follows the busy warps of each
// block, ceil(live lanes / 32) of 4, more than the live lanes (PERF.md).
//
// What bounds them on the H100: the Cornell box has 36 triangles, so a ray
// costs ~36 * ~60 flops and 40 bytes of I/O; at the main path's 0.5M-lane
// launches the kernels are bound by launch latency and the tail of a short
// grid, not by FLOPs or bytes.  At the brute path's 4,096-triangle limit a
// ray costs ~230k flops, and the kernels are bound by operations.  The
// design keeps each launch a single pass over the rays with no
// intermediate in device memory, which is what the plain version (dozens
// of [N, T] tensors) cannot do.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kTriChunk = 256;
constexpr int kNeeRow = 12;   // v0, e1, e2, m1
constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void stage_tris(float* s_tri,
                                           const float* __restrict__ tri,
                                           int base, int count) {
  __syncthreads();  // the previous chunk has been consumed by every thread
  for (int j = threadIdx.x; j < count * 9; j += blockDim.x) {
    s_tri[j] = tri[base * 9 + j];
  }
  __syncthreads();
}

// Closest hit: per ray, the triangle with the smallest t that passes
// |det| > 1e-12, u, v in range, tmin < t < tcap and is not excluded; ties go
// to the lowest index (strict t < best).  Miss: prim = -1, t = -1, u = v = 0.
__global__ void __launch_bounds__(kBlock) closest_hit_kernel(
    const float* __restrict__ tri, int n_tris,
    const float* __restrict__ ox_, const float* __restrict__ oy_,
    const float* __restrict__ oz_, const float* __restrict__ dx_,
    const float* __restrict__ dy_, const float* __restrict__ dz_,
    const float* __restrict__ tmin_, const float* __restrict__ tmax_,
    const int* __restrict__ ex0_, const int* __restrict__ ex1_,
    float* __restrict__ t_out, int* __restrict__ prim_out,
    float* __restrict__ u_out, float* __restrict__ v_out, int n) {
  __shared__ float s_tri[kTriChunk * 9];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tmin = 0.f, tcap = 0.f;
  int ex0 = -2, ex1 = -2;
  if (live) {
    ox = ox_[i]; oy = oy_[i]; oz = oz_[i];
    dx = dx_[i]; dy = dy_[i]; dz = dz_[i];
    tmin = tmin_[i];
    const float tmax = tmax_[i];
    tcap = tmax > 0.f ? tmax : kBig;
    if (ex0_) ex0 = ex0_[i];
    if (ex1_) ex1 = ex1_[i];
  }
  float bt = kBig, bu = 0.f, bv = 0.f;
  int bp = -1;
  for (int base = 0; base < n_tris; base += kTriChunk) {
    const int count = min(kTriChunk, n_tris - base);
    stage_tris(s_tri, tri, base, count);
    if (!live) continue;
    for (int j = 0; j < count; ++j) {
      const float* r = s_tri + j * 9;
      const float v0x = r[0], v0y = r[1], v0z = r[2];
      const float e1x = r[3], e1y = r[4], e1z = r[5];
      const float e2x = r[6], e2y = r[7], e2z = r[8];
      // pvec = d x e2
      const float px = dy * e2z - dz * e2y;
      const float py = dz * e2x - dx * e2z;
      const float pz = dx * e2y - dy * e2x;
      const float det = e1x * px + e1y * py + e1z * pz;
      const bool det_ok = fabsf(det) > 1e-12f;
      const float inv_det = 1.0f / (det_ok ? det : 1.0f);
      const float tx = ox - v0x;
      const float ty = oy - v0y;
      const float tz = oz - v0z;
      const float u = (tx * px + ty * py + tz * pz) * inv_det;
      // qvec = tvec x e1
      const float qx = ty * e1z - tz * e1y;
      const float qy = tz * e1x - tx * e1z;
      const float qz = tx * e1y - ty * e1x;
      const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
      const float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
      const int idx = base + j;
      const bool ok = det_ok && u >= 0.f && u <= 1.f && v >= 0.f &&
                      u + v <= 1.f && t > tmin && t < tcap && t < bt &&
                      idx != ex0 && idx != ex1;
      if (ok) {
        bt = t;
        bp = idx;
        bu = u;
        bv = v;
      }
    }
  }
  if (live) {
    t_out[i] = bp < 0 ? -1.f : bt;
    prim_out[i] = bp;
    u_out[i] = bu;
    v_out[i] = bv;
  }
}

// Occlusion of one ray per lane: the division-free, sign-folded test of
// _any_hit_kernel (pallas_intersect.py:148-166); the exclusions compare the
// triangle index.
__global__ void __launch_bounds__(kBlock) any_hit_kernel(
    const float* __restrict__ tri, int n_tris,
    const float* __restrict__ ox_, const float* __restrict__ oy_,
    const float* __restrict__ oz_, const float* __restrict__ dx_,
    const float* __restrict__ dy_, const float* __restrict__ dz_,
    const float* __restrict__ tmin_, const float* __restrict__ tmax_,
    const int* __restrict__ ex0_, const int* __restrict__ ex1_,
    uint8_t* __restrict__ hit_out, int n) {
  __shared__ float s_tri[kTriChunk * 9];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float tmin = 0.f, tcap = 0.f;
  int ex0 = -2, ex1 = -2;
  if (live) {
    ox = ox_[i]; oy = oy_[i]; oz = oz_[i];
    dx = dx_[i]; dy = dy_[i]; dz = dz_[i];
    tmin = tmin_[i];
    const float tmax = tmax_[i];
    tcap = tmax > 0.f ? tmax : kBig;
    if (ex0_) ex0 = ex0_[i];
    if (ex1_) ex1 = ex1_[i];
  }
  bool hit = false;
  for (int base = 0; base < n_tris; base += kTriChunk) {
    const int count = min(kTriChunk, n_tris - base);
    stage_tris(s_tri, tri, base, count);
    if (!live || hit) continue;
    for (int j = 0; j < count; ++j) {
      const float* r = s_tri + j * 9;
      const float v0x = r[0], v0y = r[1], v0z = r[2];
      const float e1x = r[3], e1y = r[4], e1z = r[5];
      const float e2x = r[6], e2y = r[7], e2z = r[8];
      const float px = dy * e2z - dz * e2y;
      const float py = dz * e2x - dx * e2z;
      const float pz = dx * e2y - dy * e2x;
      const float det = e1x * px + e1y * py + e1z * pz;
      const float s = det < 0.f ? -1.f : 1.f;
      const float dd = fabsf(det);
      const float tx = ox - v0x;
      const float ty = oy - v0y;
      const float tz = oz - v0z;
      const float un = (tx * px + ty * py + tz * pz) * s;
      const float qx = ty * e1z - tz * e1y;
      const float qy = tz * e1x - tx * e1z;
      const float qz = tx * e1y - ty * e1x;
      const float vn = (dx * qx + dy * qy + dz * qz) * s;
      const float tn = (e2x * qx + e2y * qy + e2z * qz) * s;
      const int idx = base + j;
      if (dd > 1e-12f && un >= 0.f && vn >= 0.f && un + vn <= dd &&
          tn > tmin * dd && tn < tcap * dd && idx != ex0 && idx != ex1) {
        hit = true;
        break;
      }
    }
  }
  if (live) hit_out[i] = static_cast<uint8_t>(hit);
}

// K shadow rays per lane sharing one origin (all 2 * light_samples MIS
// shadow rays of a shading point start at its position).  The origin-only
// terms are computed once per triangle and reused for the K directions,
// which stay in registers; the test is division-free and sign-folded.
template <int K>
struct NeeDirs {
  const float* dx[K];
  const float* dy[K];
  const float* dz[K];
  const float* tcap[K];
};

// Rows base .. base + count - 1 of the [T, 9] table into shared rows of
// kNeeRow floats: v0, e1, e2 and m1 = e2 x e1 (det = d . m1).
__device__ __forceinline__ void stage_nee_tris(float* s_tri,
                                               const float* __restrict__ tri,
                                               int base, int count) {
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const float* g = tri + (base + j) * 9;
    const float e1x = g[3], e1y = g[4], e1z = g[5];
    const float e2x = g[6], e2y = g[7], e2z = g[8];
    float4* r = reinterpret_cast<float4*>(s_tri + j * kNeeRow);
    r[0] = make_float4(g[0], g[1], g[2], e1x);
    r[1] = make_float4(e1y, e1z, e2x, e2y);
    r[2] = make_float4(e2z, e2y * e1z - e2z * e1y, e2z * e1x - e2x * e1z,
                       e2x * e1y - e2y * e1x);
  }
}

template <int K>
__global__ void __launch_bounds__(kBlock) any_hit_nee_kernel(
    const float* __restrict__ tri, int n_tris,
    const float* __restrict__ ox_, const float* __restrict__ oy_,
    const float* __restrict__ oz_, const float* __restrict__ tmin_,
    const int* __restrict__ ex0_, const int* __restrict__ ex1_,
    NeeDirs<K> rays, uint8_t* __restrict__ hit_out, int n) {
  __shared__ __align__(16) float s_tri[kTriChunk * kNeeRow];
  __shared__ int s_lane[kBlock];
  __shared__ int s_count[kBlock / 32];
  // this thread's own lane is live unless every ray is dead (0 < tcap <=
  // tmin); a lane with no live ray is occluded on none
  const int i = blockIdx.x * kBlock + threadIdx.x;
  bool live = false;
  if (i < n) {
    const float tmin = tmin_[i];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float c = rays.tcap[k][i];
      live |= !(c > 0.f && c <= tmin);
    }
    if (!live) {
#pragma unroll
      for (int k = 0; k < K; ++k) hit_out[static_cast<size_t>(k) * n + i] = 0;
    }
  }
  // the live lanes' ranks in the block, in lane order
  const int wl = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const uint32_t bal = __ballot_sync(kFull, live);
  if (wl == 0) s_count[warp] = __popc(bal);
  __syncthreads();
  int rank = 0, n_live = 0;
#pragma unroll
  for (int w = 0; w < kBlock / 32; ++w) {
    const int c = s_count[w];
    rank += w < warp ? c : 0;
    n_live += c;
  }
  if (live) s_lane[rank + __popc(bal & ((1u << wl) - 1u))] = i;
  __syncthreads();
  // thread j takes the j-th live lane
  const int li = threadIdx.x < n_live ? s_lane[threadIdx.x] : -1;
  float ox = 0.f, oy = 0.f, oz = 0.f, tmin = 0.f;
  int ex0 = -2, ex1 = -2;
  float dx[K], dy[K], dz[K], tc[K];
  uint32_t dead = 0u;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    dx[k] = dy[k] = dz[k] = tc[k] = 0.f;
  }
  if (li >= 0) {
    ox = ox_[li]; oy = oy_[li]; oz = oz_[li];
    tmin = tmin_[li];
    if (ex0_) ex0 = ex0_[li];
    if (ex1_) ex1 = ex1_[li];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      dx[k] = rays.dx[k][li];
      dy[k] = rays.dy[k][li];
      dz[k] = rays.dz[k][li];
      const float c = rays.tcap[k][li];
      tc[k] = c > 0.f ? c : kBig;
      dead |= static_cast<uint32_t>(c > 0.f && c <= tmin) << k;
    }
  }
  const uint32_t full = static_cast<uint32_t>((1ull << K) - 1ull);
  uint32_t mask = dead;  // the rays that are done: dead or occluded
  bool working = li >= 0;
  for (int base = 0; base < n_tris; base += kTriChunk) {
    // every thread has consumed the previous chunk; stop when no lane of
    // the block is working
    if (!__syncthreads_or(working)) break;
    const int count = min(kTriChunk, n_tris - base);
    stage_nee_tris(s_tri, tri, base, count);
    __syncthreads();
    if (!working) continue;
    for (int j = 0; j < count; ++j) {
      const float4* r = reinterpret_cast<const float4*>(s_tri + j * kNeeRow);
      const float4 r0 = r[0], r1 = r[1], r2 = r[2];
      const float v0x = r0.x, v0y = r0.y, v0z = r0.z;
      const float e1x = r0.w, e1y = r1.x, e1z = r1.y;
      const float e2x = r1.z, e2y = r1.w, e2z = r2.x;
      // m1 = e2 x e1, staged  (det = d . m1)
      const float m1x = r2.y, m1y = r2.z, m1z = r2.w;
      // origin-shared terms
      const float tx = ox - v0x;
      const float ty = oy - v0y;
      const float tz = oz - v0z;
      // w = e2 x tvec  (u_num = d . w)
      const float wx = e2y * tz - e2z * ty;
      const float wy = e2z * tx - e2x * tz;
      const float wz = e2x * ty - e2y * tx;
      // qvec = tvec x e1  (v_num = d . qvec; t_num = e2 . qvec)
      const float qx = ty * e1z - tz * e1y;
      const float qy = tz * e1x - tx * e1z;
      const float qz = tx * e1y - ty * e1x;
      const float tnum = e2x * qx + e2y * qy + e2z * qz;
      const int idx = base + j;
      const bool not_excl = idx != ex0 && idx != ex1;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float det = dx[k] * m1x + dy[k] * m1y + dz[k] * m1z;
        // the sign fold as a sign-bit flip: the same bits as a product
        // with s = det < 0 ? -1 : 1 wherever dd > 1e-12 can pass
        const uint32_t sb = __float_as_uint(det) & 0x80000000u;
        const float dd = fabsf(det);
        const float un = __uint_as_float(
            __float_as_uint(dx[k] * wx + dy[k] * wy + dz[k] * wz) ^ sb);
        const float vn = __uint_as_float(
            __float_as_uint(dx[k] * qx + dy[k] * qy + dz[k] * qz) ^ sb);
        const float tn = __uint_as_float(__float_as_uint(tnum) ^ sb);
        const bool ok = dd > 1e-12f && un >= 0.f && vn >= 0.f &&
                        un + vn <= dd && tn > tmin * dd &&
                        tn < tc[k] * dd && not_excl;
        mask |= static_cast<uint32_t>(ok) << k;
      }
      if (mask == full) break;  // every ray of the lane is done
    }
    working = mask != full;
  }
  if (li >= 0) {
    const uint32_t hit = mask & ~dead;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      hit_out[static_cast<size_t>(k) * n + li] =
          static_cast<uint8_t>((hit >> k) & 1u);
    }
  }
}

template <int K>
int launch_nee(const float* tri, int n_tris, const float* ox, const float* oy,
               const float* oz, const float* tmin, const int* ex0,
               const int* ex1, const void* const* dir_ptrs, uint8_t* hit,
               int n, cudaStream_t stream) {
  NeeDirs<K> rays;
  for (int k = 0; k < K; ++k) {
    rays.dx[k] = static_cast<const float*>(dir_ptrs[k]);
    rays.dy[k] = static_cast<const float*>(dir_ptrs[K + k]);
    rays.dz[k] = static_cast<const float*>(dir_ptrs[2 * K + k]);
    rays.tcap[k] = static_cast<const float*>(dir_ptrs[3 * K + k]);
  }
  const int grid = (n + kBlock - 1) / kBlock;
  any_hit_nee_kernel<K><<<grid, kBlock, 0, stream>>>(
      tri, n_tris, ox, oy, oz, tmin, ex0, ex1, rays, hit, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Returns cudaGetLastError() after the launch (0 = success).
int cti_closest_hit(const float* tri, int n_tris, const float* ox,
                    const float* oy, const float* oz, const float* dx,
                    const float* dy, const float* dz, const float* tmin,
                    const float* tmax, const int* ex0, const int* ex1,
                    float* t_out, int* prim_out, float* u_out, float* v_out,
                    int n, void* stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  closest_hit_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      tri, n_tris, ox, oy, oz, dx, dy, dz, tmin, tmax, ex0, ex1, t_out,
      prim_out, u_out, v_out, n);
  return static_cast<int>(cudaGetLastError());
}

// hit_out: [n] bytes, 1 = occluded.
int cti_any_hit(const float* tri, int n_tris, const float* ox,
                const float* oy, const float* oz, const float* dx,
                const float* dy, const float* dz, const float* tmin,
                const float* tmax, const int* ex0, const int* ex1,
                uint8_t* hit_out, int n, void* stream) {
  const int grid = (n + kBlock - 1) / kBlock;
  any_hit_kernel<<<grid, kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      tri, n_tris, ox, oy, oz, dx, dy, dz, tmin, tmax, ex0, ex1, hit_out, n);
  return static_cast<int>(cudaGetLastError());
}

// dir_ptrs: 4*K device pointers, K each of dx, dy, dz, tcap ([n] float32).
// hit_out: [K*n] bytes, sample-major.  K must be 2, 4, 8, 16 or 32.
int cti_any_hit_nee(const float* tri, int n_tris, const float* ox,
                    const float* oy, const float* oz, const float* tmin,
                    const int* ex0, const int* ex1, int K,
                    const void* const* dir_ptrs, uint8_t* hit_out, int n,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 2:
      return launch_nee<2>(tri, n_tris, ox, oy, oz, tmin, ex0, ex1, dir_ptrs,
                           hit_out, n, s);
    case 4:
      return launch_nee<4>(tri, n_tris, ox, oy, oz, tmin, ex0, ex1, dir_ptrs,
                           hit_out, n, s);
    case 8:
      return launch_nee<8>(tri, n_tris, ox, oy, oz, tmin, ex0, ex1, dir_ptrs,
                           hit_out, n, s);
    case 16:
      return launch_nee<16>(tri, n_tris, ox, oy, oz, tmin, ex0, ex1,
                            dir_ptrs, hit_out, n, s);
    case 32:
      return launch_nee<32>(tri, n_tris, ox, oy, oz, tmin, ex0, ex1,
                            dir_ptrs, hit_out, n, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* cti_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
