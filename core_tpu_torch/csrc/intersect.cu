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
// Design.  One thread per ray (closest hit, any hit) or per shading-point
// lane (NEE bundle); ray components arrive as separate contiguous [N]
// arrays, and the ragged tail is masked with a `live` flag rather than
// padded to a tile.
// The [T, 9] triangle table (v0, e1, e2) is staged through shared memory in
// chunks of kTriChunk rows (9 KB), so any T runs without the >48 KB opt-in;
// every thread of a warp reads the same row, which shared memory broadcasts.
// The occlusion kernels stop testing a lane at its first occluder (the
// any-hit kernel) or once all its K rays are occluded (the NEE bundle); the
// thread keeps taking part in the staging barriers.
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
constexpr float kBig = 3.0e38f;

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

template <int K>
__global__ void __launch_bounds__(kBlock) any_hit_nee_kernel(
    const float* __restrict__ tri, int n_tris,
    const float* __restrict__ ox_, const float* __restrict__ oy_,
    const float* __restrict__ oz_, const float* __restrict__ tmin_,
    const int* __restrict__ ex0_, const int* __restrict__ ex1_,
    NeeDirs<K> rays, uint8_t* __restrict__ hit_out, int n) {
  __shared__ float s_tri[kTriChunk * 9];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < n;
  float ox = 0.f, oy = 0.f, oz = 0.f, tmin = 0.f;
  int ex0 = -2, ex1 = -2;
  float dx[K], dy[K], dz[K], tc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    dx[k] = dy[k] = dz[k] = tc[k] = 0.f;
  }
  if (live) {
    ox = ox_[i]; oy = oy_[i]; oz = oz_[i];
    tmin = tmin_[i];
    if (ex0_) ex0 = ex0_[i];
    if (ex1_) ex1 = ex1_[i];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      dx[k] = rays.dx[k][i];
      dy[k] = rays.dy[k][i];
      dz[k] = rays.dz[k][i];
      const float c = rays.tcap[k][i];
      tc[k] = c > 0.f ? c : kBig;
    }
  }
  const uint32_t full = static_cast<uint32_t>((1ull << K) - 1ull);
  uint32_t mask = 0u;
  for (int base = 0; base < n_tris; base += kTriChunk) {
    const int count = min(kTriChunk, n_tris - base);
    stage_tris(s_tri, tri, base, count);
    if (!live || mask == full) continue;
    for (int j = 0; j < count; ++j) {
      const float* r = s_tri + j * 9;
      const float v0x = r[0], v0y = r[1], v0z = r[2];
      const float e1x = r[3], e1y = r[4], e1z = r[5];
      const float e2x = r[6], e2y = r[7], e2z = r[8];
      // origin-shared terms
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
      const int idx = base + j;
      const bool not_excl = idx != ex0 && idx != ex1;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float det = dx[k] * m1x + dy[k] * m1y + dz[k] * m1z;
        const float s = det < 0.f ? -1.f : 1.f;
        const float dd = fabsf(det);
        const float un = (dx[k] * wx + dy[k] * wy + dz[k] * wz) * s;
        const float vn = (dx[k] * qx + dy[k] * qy + dz[k] * qz) * s;
        const float tn = tnum * s;
        const bool ok = dd > 1e-12f && un >= 0.f && vn >= 0.f &&
                        un + vn <= dd && tn > tmin * dd &&
                        tn < tc[k] * dd && not_excl;
        mask |= static_cast<uint32_t>(ok) << k;
      }
      if (mask == full) break;  // every ray of the lane is occluded
    }
  }
  if (live) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      hit_out[static_cast<size_t>(k) * n + i] =
          static_cast<uint8_t>((mask >> k) & 1u);
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
