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
// What bounds them on the H100: the Cornell box has 36 triangles, so a ray
// costs ~36 * ~60 operations and 40 bytes of I/O; at the main path's
// 0.5M-lane launches the kernels are bound by launch latency and the tail
// of a short grid, not by operations or bytes.  At the brute path's limit
// of 4,096 triangles (the dirac scene's 1,634) a ray costs up to ~230k
// operations, and the kernels are bound by operations: each test is ~56
// counted operations, and with --fmad=false each is an instruction of its
// own, so a kernel can reach at most about half of the bound computed at
// the card's 67 TFLOP/s (which counts an FMA as two).  Each launch is a
// single pass over the rays with no intermediate in device memory, which
// is what the plain versions (dozens of [N, T] tensors) cannot do.
//
// Common design.  Ray components arrive as separate contiguous [N] arrays,
// and the ragged tail is masked rather than padded to a tile.  The [T, 9]
// triangle table (v0, e1, e2) is staged through shared memory in chunks of
// kTriChunk rows, each row widened to kRow = 12 floats so that a test
// reads it with three 16-byte loads instead of nine 4-byte ones.  Kernels 1
// and 3 copy the chunks with cp.async, double-buffered (staged_walk): the
// next chunk is in flight while this one is tested.  Kernel 2 computes a
// lane-independent term into the spare floats at staging.
//
// A dead ray (0 < tcap <= tmin, the integrators' cap for an inactive lane
// or a sub-bias light distance) can never be accepted: for dd > 0, rounding
// keeps tcap * dd <= tmin * dd, so no tn passes both tests, and likewise
// no t lies in (tmin, tcap).  Every kernel finishes its dead rays at the
// start (no hit, t = -1 for a closest hit) and tests no row for them.
//
// Kernel 2 (the NEE bundle: K shadow rays per lane from one origin) is
// built for the launches the path tracer makes.  Each bounce gives NEE only
// to the lanes whose path is alive, and every other lane gets dead caps:
// about half the lanes of a Cornell bounce launch.  A lane is done once
// each of its rays is occluded or dead.  Dead and live lanes mix inside a
// warp (lanes are in path and pixel order), and a warp runs as long as its
// slowest thread, so the block compacts its live lanes first: a ballot and
// a scan of the warps' counts in shared memory give each live lane its
// rank, and thread j takes the j-th live lane of the block (its origin, K
// directions and caps, exclusions) and writes that lane's bits; a lane
// with no live ray writes its zeros itself.  Warps with no live lane skip
// the triangle loop (they still stage), and a block stops staging once
// none of its lanes is working.  Each staged triangle's lane-independent
// term m1 = e2 x e1 is computed once, at staging, into the spare floats of
// its row, with the same arithmetic, and the sign fold flips sign bits
// (fold), so the bits stay those of the plain version; the flip measured
// ~1% faster than the product (PERF.md).  On the Cornell bounce launches
// what is left follows the busy warps of each block, ceil(live lanes / 32)
// of 4, more than the live lanes (PERF.md).
//
// Kernel 3 (any hit, one ray per lane).  Its launches carry many dead rays
// (the dirac scene's glossy-chain shadow wavefronts: 93-95%), clustered in
// the image (sky, and the pixels that see no glossy surface), and a live
// ray stops at its first occluder, so the rays of one warp finish at very
// different rows while an unoccluded ray walks all T.  So:
//   - thread j of block b (of G) takes ray j G + (b + j) mod G: block b
//     draws one ray from each of the kAnyBlock stretches of G rays of the
//     wavefront, at a position that moves with j (on a wavefront in image
//     order, a diagonal across the image), so the live rays spread evenly
//     over the blocks and SMs.  Contiguous blocks, and 32-ray segments
//     dealt out by a stride, a multiplicative hash or the same diagonal,
//     measured slower (PERF.md).  Only the caps are read for every ray,
//     uncoalesced; the rest only for live rays;
//   - the block compacts its live rays (a ballot and a scan of the warps'
//     counts in shared memory give each its rank) and deals them
//     round-robin over its warps (rank r to warp r % W, slot r / W), into
//     ray slots in shared memory.  A dead ray's own thread writes its 0; a
//     block with no live ray exits at once, and a block stops staging once
//     none of its rays is working;
//   - the test is triangle-parallel (any_chunk): in each step a lane holds
//     kAnyRows staged rows in registers (row t0 + lane, ...) and the warp
//     tests every working ray of its slots against the 32 kAnyRows rows,
//     each ray read from its slot by a broadcast load; a ray is done at the
//     first step in which a lane finds an occluder (__any_sync).  No lane
//     waits on another's ray, and each row is read once per step, not once
//     per ray.  The result is an OR over rows, so the order of the tests
//     does not change a bit.
// The test is _any_hit_kernel's, in its order (det = e1 . (d x e2)): kernel
// 2's det = d . m1 would round differently.
//
// Kernel 1 (closest hit, one ray per thread, block of kClosestBlock).  The
// exact test takes inv_det = 1 / det and three products by it before any
// rejection, and few rows pass the range tests for a given ray.  So a
// division-free pre-test runs first, on the sign-folded numerators of
// kernel 3 (un, vn, tn: the same products and sums that the exact test
// multiplies by inv_det, times s = sign(det); dd = |det|), and only a row
// that passes it runs the exact arithmetic, with the same operations in the
// same order, which decides.  The pre-test is
//   dd > 1e-12,  un >= -dd 2^-18,  vn >= -dd 2^-18,
//   un + vn <= dd (1 + 2^-18),  tn > tlo,  tn < pc dd,
// with, per ray, tlo = 0 and pc = c (1 + 2^-18) for c = min(tcap, best t)
// when tmin >= 0 and c >= 2^-60, else tlo = -inf and pc = +inf.  It never
// rejects a row that the exact test accepts, so the accepted rows, and the
// t, u, v bits, are those of the exact loop.  Why, for an accepted row
// (each step in float32, round to nearest, no flush to zero):
//   - r = fl(1/dd) is within 2^-22 of 1/dd relatively for every finite dd
//     > 1e-12 (2^-24 while r is normal; r is subnormal only for dd > 2^126,
//     where 1/dd >= 2^-128 and the absolute error is <= 2^-150), and u =
//     fl(un r), v = fl(vn r), t = fl(tn r) (a product by 1/det = s r is the
//     product of the sign-folded numerator by r).  A product that falls
//     below 2^-126 is off by at most 2^-150.
//   - u >= 0: if un < 0, u is negative or, when |un r| <= 2^-150, -0, which
//     passes; then |un| < dd 2^-149, far inside dd 2^-18 (dd 2^-18 is exact:
//     dd > 1e-12 keeps it normal).  Likewise v.
//   - u + v <= 1 after rounding means u + v <= 1 + 2^-24, so un + vn <=
//     dd ((u + v)(1 + 2^-23) + 2^-149) / (1 - 2^-22) < dd (1 + 2^-21), and
//     rounded sums and products keep fl(un + vn) < fl(dd (1 + 2^-18)); a
//     right side that overflows to inf passes.
//   - t > tmin >= 0 needs t > 0, so tn > 0 = tlo.  For tmin < 0 (or NaN)
//     tlo = -inf and pc = inf test nothing but tn not -inf or NaN, where t
//     is -inf or NaN and fails the exact test anyway.
//   - t < c, t normal: tn < c dd (1 + 2^-23) / (1 - 2^-22) < c dd (1 +
//     2^-21) <= fl(fl(c (1 + 2^-18)) dd); c >= 2^-60 and dd > 2^-40 keep
//     the right side normal, and an overflow to inf passes.  t subnormal:
//     tn < 2^-124 dd, far below it.  An accepted t is > tmin >= 0, so c > 0.
//   - dd = inf: r = 0, so t = 0 or NaN, accepted only for tmin < 0, where
//     the pre-test passes every finite un, vn, tn.  NaN fails both tests.
// The exclusions are tested on the exact path only.  The cuda tests aim
// rays at edges, vertices, tmin and tcap and at |det| near 1e-12.
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTriChunk = 256;  // rows of a staged chunk
constexpr int kRow = 12;        // floats of a staged row: v0, e1, e2, 3 more
constexpr float kBig = 3.0e38f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kBlock = 128;          // kernel 2
constexpr int kClosestBlock = 128;   // kernel 1
constexpr int kAnyBlock = 256;       // kernel 3
constexpr int kAnyWarps = kAnyBlock / 32;
constexpr int kAnyRows = 4;          // kernel 3: staged rows a lane tests
// kernel 1's pre-test: the slack and the least cap it filters on
constexpr float kHi = 1.0f + 0x1p-18f;
constexpr float kNegSlack = -0x1p-18f;
constexpr float kMinCap = 0x1p-60f;

// Bytes of dynamic shared memory of kernels 1 and 3: a buffer of min(T,
// kTriChunk) rows, two when the table takes more than one chunk.
size_t staged_bytes(int n_tris) {
  const int rows = n_tris < kTriChunk ? n_tris : kTriChunk;
  return static_cast<size_t>(n_tris > kTriChunk ? 2 : 1) * rows * kRow *
         sizeof(float);
}

// Start the asynchronous copy (cp.async, 4-byte pieces) of rows base ..
// base + count - 1 of the [T, 9] table into rows of kRow floats at s,
// spread over the block; neighbouring threads read neighbouring words.
__device__ __forceinline__ void stage_rows(float* s,
                                           const float* __restrict__ tri,
                                           int base, int count) {
  const float* g = tri + static_cast<size_t>(base) * 9;
  for (int j = threadIdx.x; j < count * 9; j += blockDim.x) {
    const int r = j / 9;
    __pipeline_memcpy_async(s + r * kRow + (j - r * 9), g + j, 4);
  }
}

// The walk of kernels 1 and 3 over the table: chunk c + 1 is copied while
// chunk c is tested; test(rows, base, count) runs in every thread of the
// block for each chunk.  The walk ends early once working() is false in
// every thread of the block.  smem: staged_bytes(n_tris).
template <class Working, class Test>
__device__ __forceinline__ void staged_walk(const float* __restrict__ tri,
                                            int n_tris, float* smem,
                                            Working working, Test test) {
  const int n_chunks = (n_tris + kTriChunk - 1) / kTriChunk;
  if (n_chunks == 0) return;
  stage_rows(smem, tri, 0, min(kTriChunk, n_tris));
  __pipeline_commit();
  for (int c = 0; c < n_chunks; ++c) {
    // every thread is done with chunk c - 1, whose buffer takes chunk c + 1
    if (!__syncthreads_or(working())) break;
    const int base = c * kTriChunk;
    if (c + 1 < n_chunks) {
      stage_rows(smem + ((c + 1) & 1) * kTriChunk * kRow, tri,
                 base + kTriChunk, min(kTriChunk, n_tris - base - kTriChunk));
    }
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    test(smem + (c & 1) * kTriChunk * kRow, base,
         min(kTriChunk, n_tris - base));
  }
  __pipeline_wait_prior(0);
}

struct Tri {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z;
};

// A staged row: three 16-byte shared loads.
__device__ __forceinline__ Tri load_row(const float* s) {
  const float4* r = reinterpret_cast<const float4*>(s);
  const float4 a = r[0], b = r[1], c = r[2];
  return Tri{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x};
}

// x times s = (det < 0 ? -1 : 1), as a flip of the sign bit sb of det: the
// same bits as the product wherever dd > 1e-12 can pass (det = -0 or NaN
// flips where the product would not, but there that test fails).
__device__ __forceinline__ float fold(float x, uint32_t sb) {
  return __uint_as_float(__float_as_uint(x) ^ sb);
}

// One ray of kernel 1 or 3.
struct Ray {
  float ox, oy, oz, dx, dy, dz, tmin, tcap;
  int ex0, ex1;
};

// Ray i of the SoA inputs.
__device__ __forceinline__ Ray load_ray(
    int i, const float* __restrict__ ox, const float* __restrict__ oy,
    const float* __restrict__ oz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tmin, const float* __restrict__ tmax,
    const int* __restrict__ ex0, const int* __restrict__ ex1) {
  Ray r;
  r.ox = ox[i]; r.oy = oy[i]; r.oz = oz[i];
  r.dx = dx[i]; r.dy = dy[i]; r.dz = dz[i];
  r.tmin = tmin[i];
  const float m = tmax[i];
  r.tcap = m > 0.f ? m : kBig;
  r.ex0 = ex0 ? ex0[i] : -2;
  r.ex1 = ex1 ? ex1[i] : -2;
  return r;
}

// The numerators of a test in _any_hit_kernel's order
// (pallas_intersect.py:148-166) and _intersect_kernel's: pvec = d x e2,
// det = e1 . pvec, tvec = o - v0, qvec = tvec x e1; un = tvec . pvec, vn =
// d . qvec, tn = e2 . qvec, unfolded.
struct Num {
  float det, un, vn, tn;
};

__device__ __forceinline__ Num numerators(const Tri& q, const Ray& r) {
  const float px = r.dy * q.e2z - r.dz * q.e2y;
  const float py = r.dz * q.e2x - r.dx * q.e2z;
  const float pz = r.dx * q.e2y - r.dy * q.e2x;
  const float det = q.e1x * px + q.e1y * py + q.e1z * pz;
  const float tx = r.ox - q.v0x;
  const float ty = r.oy - q.v0y;
  const float tz = r.oz - q.v0z;
  const float un = tx * px + ty * py + tz * pz;
  const float qx = ty * q.e1z - tz * q.e1y;
  const float qy = tz * q.e1x - tx * q.e1z;
  const float qz = tx * q.e1y - ty * q.e1x;
  const float vn = r.dx * qx + r.dy * qy + r.dz * qz;
  const float tn = q.e2x * qx + q.e2y * qy + q.e2z * qz;
  return Num{det, un, vn, tn};
}

// ---- kernel 1: closest hit ----

// Kernel 1's pre-test cap pc of a ray with lower bound tlo (0 for tmin >=
// 0, else -inf) whose cap is c = min(tcap, best t) (see the header).
__device__ __forceinline__ float pre_cap(float tlo, float c) {
  return tlo == 0.f && c >= kMinCap ? c * kHi : CUDART_INF_F;
}

// Closest hit: per ray, the triangle with the smallest t that passes
// |det| > 1e-12, u, v in range, tmin < t < tcap and is not excluded; ties go
// to the lowest index (strict t < best).  Miss: prim = -1, t = -1, u = v = 0.
__global__ void __launch_bounds__(kClosestBlock) closest_hit_kernel(
    const float* __restrict__ tri, int n_tris,
    const float* __restrict__ ox_, const float* __restrict__ oy_,
    const float* __restrict__ oz_, const float* __restrict__ dx_,
    const float* __restrict__ dy_, const float* __restrict__ dz_,
    const float* __restrict__ tmin_, const float* __restrict__ tmax_,
    const int* __restrict__ ex0_, const int* __restrict__ ex1_,
    float* __restrict__ t_out, int* __restrict__ prim_out,
    float* __restrict__ u_out, float* __restrict__ v_out, int n) {
  extern __shared__ float4 smem4[];
  const int i = blockIdx.x * kClosestBlock + threadIdx.x;
  Ray r{};
  bool working = false;
  float tlo = -CUDART_INF_F;
  if (i < n) {
    r = load_ray(i, ox_, oy_, oz_, dx_, dy_, dz_, tmin_, tmax_, ex0_, ex1_);
    // no t lies in (tmin, tcap) when tcap <= tmin (a dead ray)
    working = !(r.tcap <= r.tmin);
    if (r.tmin >= 0.f) tlo = 0.f;
  }
  float pc = pre_cap(tlo, r.tcap);
  float bt = kBig, bu = 0.f, bv = 0.f;
  int bp = -1;
  staged_walk(
      tri, n_tris, reinterpret_cast<float*>(smem4),
      [&] { return working; },
      [&](const float* s, int base, int count) {
        if (!working) return;
        for (int j = 0; j < count; ++j) {
          const Num m = numerators(load_row(s + j * kRow), r);
          const uint32_t sb = __float_as_uint(m.det) & 0x80000000u;
          const float dd = fabsf(m.det);
          const float un = fold(m.un, sb);
          const float vn = fold(m.vn, sb);
          const float tn = fold(m.tn, sb);
          const float ns = dd * kNegSlack;
          if (dd > 1e-12f && un >= ns && vn >= ns && un + vn <= dd * kHi &&
              tn > tlo && tn < pc * dd) {
            // the exact test (pallas_intersect.py:_intersect_kernel);
            // |det| > 1e-12 has passed, so inv_det = 1 / det
            const float inv_det = 1.0f / m.det;
            const float u = m.un * inv_det;
            const float v = m.vn * inv_det;
            const float t = m.tn * inv_det;
            const int idx = base + j;
            if (u >= 0.f && u <= 1.f && v >= 0.f && u + v <= 1.f &&
                t > r.tmin && t < r.tcap && t < bt && idx != r.ex0 &&
                idx != r.ex1) {
              bt = t;
              bp = idx;
              bu = u;
              bv = v;
              pc = pre_cap(tlo, bt);
            }
          }
        }
      });
  if (i < n) {
    t_out[i] = bp < 0 ? -1.f : bt;
    prim_out[i] = bp;
    u_out[i] = bu;
    v_out[i] = bv;
  }
}

// ---- kernel 3: any hit ----

// The division-free, sign-folded test of _any_hit_kernel
// (pallas_intersect.py:148-166) of row q, triangle idx; the exclusions
// compare the triangle index.
__device__ __forceinline__ bool occludes(const Tri& q, int idx,
                                         const Ray& r) {
  const Num m = numerators(q, r);
  const uint32_t sb = __float_as_uint(m.det) & 0x80000000u;
  const float dd = fabsf(m.det);
  const float un = fold(m.un, sb);
  const float vn = fold(m.vn, sb);
  const float tn = fold(m.tn, sb);
  return dd > 1e-12f && un >= 0.f && vn >= 0.f && un + vn <= dd &&
         tn > r.tmin * dd && tn < r.tcap * dd && idx != r.ex0 &&
         idx != r.ex1;
}

// A ray slot of kernel 3: three float4 in shared memory (the ray, and in
// the last one its input index).
__device__ __forceinline__ Ray load_slot(const float4* p) {
  const float4 a = p[0], b = p[1], c = p[2];
  return Ray{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, __float_as_int(c.x),
             __float_as_int(c.y)};
}

// One warp's test of a staged chunk (rows base .. base + count - 1), in
// steps of 32 kAnyRows rows: the lanes load their rows, then every working
// ray of the warp's slots (bits of `working`) is tested against all of
// them; a ray found occluded moves from `working` to `hits`.
__device__ __forceinline__ void any_chunk(const float* s, int base,
                                          int count, const float4* slots,
                                          uint32_t& working,
                                          uint32_t& hits) {
  const int lane = threadIdx.x & 31;
  for (int t0 = 0; t0 < count && working; t0 += 32 * kAnyRows) {
    Tri q[kAnyRows];
    bool in[kAnyRows];
#pragma unroll
    for (int k = 0; k < kAnyRows; ++k) {
      const int t = t0 + 32 * k + lane;
      in[k] = t < count;
      q[k] = load_row(s + (in[k] ? t : 0) * kRow);
    }
    uint32_t done = 0;
    for (uint32_t w = working; w; w &= w - 1) {
      const int j = __ffs(w) - 1;
      const Ray r = load_slot(slots + 3 * j);
      bool h = false;
#pragma unroll
      for (int k = 0; k < kAnyRows; ++k) {
        h |= in[k] && occludes(q[k], base + t0 + 32 * k + lane, r);
      }
      if (__any_sync(kFull, h)) done |= 1u << j;
    }
    working &= ~done;
    hits |= done;
  }
}

// Occlusion of one ray per lane (see the header for the design).
__global__ void __launch_bounds__(kAnyBlock) any_hit_kernel(
    const float* __restrict__ tri, int n_tris,
    const float* __restrict__ ox_, const float* __restrict__ oy_,
    const float* __restrict__ oz_, const float* __restrict__ dx_,
    const float* __restrict__ dy_, const float* __restrict__ dz_,
    const float* __restrict__ tmin_, const float* __restrict__ tmax_,
    const int* __restrict__ ex0_, const int* __restrict__ ex1_,
    uint8_t* __restrict__ hit_out, int n) {
  extern __shared__ float4 smem4[];
  __shared__ float4 s_slot[3 * kAnyBlock];
  __shared__ int s_count[kAnyWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // this thread's own ray (a dead one is not occluded): thread j of block b
  // takes ray j G + (b + j) mod G of the G kAnyBlock rays
  const int i = threadIdx.x * gridDim.x +
                (blockIdx.x + threadIdx.x) % gridDim.x;
  bool live = false;
  Ray r{};
  if (i < n) {
    const float tmax = tmax_[i];
    live = !(tmax > 0.f && tmax <= tmin_[i]);
    if (live) {
      r = load_ray(i, ox_, oy_, oz_, dx_, dy_, dz_, tmin_, tmax_, ex0_, ex1_);
    } else {
      hit_out[i] = 0;
    }
  }
  // the live rays' ranks in the block, in lane order
  const uint32_t bal = __ballot_sync(kFull, live);
  if (lane == 0) s_count[warp] = __popc(bal);
  __syncthreads();
  int rank = 0, n_live = 0;
#pragma unroll
  for (int w = 0; w < kAnyWarps; ++w) {
    const int c = s_count[w];
    rank += w < warp ? c : 0;
    n_live += c;
  }
  if (n_live == 0) return;  // the same in every thread of the block
  rank += __popc(bal & ((1u << lane) - 1u));
  // rank k goes to warp k % W, slot k / W
  if (live) {
    float4* p = s_slot + 3 * ((rank % kAnyWarps) * 32 + rank / kAnyWarps);
    p[0] = make_float4(r.ox, r.oy, r.oz, r.dx);
    p[1] = make_float4(r.dy, r.dz, r.tmin, r.tcap);
    p[2] = make_float4(__int_as_float(r.ex0), __int_as_float(r.ex1),
                       __int_as_float(i), 0.f);
  }
  __syncthreads();
  // this warp's slots 0 .. cnt - 1 hold rays
  const int cnt = (n_live - warp + kAnyWarps - 1) / kAnyWarps;
  const float4* slots = s_slot + 3 * 32 * warp;
  uint32_t working = cnt == 32 ? kFull : (1u << cnt) - 1u;
  uint32_t hits = 0;
  staged_walk(tri, n_tris, reinterpret_cast<float*>(smem4),
              [&] { return working != 0u; },
              [&](const float* s, int base, int count) {
                any_chunk(s, base, count, slots, working, hits);
              });
  if (lane < cnt) {
    hit_out[__float_as_int(slots[3 * lane + 2].z)] =
        static_cast<uint8_t>((hits >> lane) & 1u);
  }
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
// kRow floats: v0, e1, e2 and m1 = e2 x e1 (det = d . m1).
__device__ __forceinline__ void stage_nee_tris(float* s_tri,
                                               const float* __restrict__ tri,
                                               int base, int count) {
  for (int j = threadIdx.x; j < count; j += blockDim.x) {
    const float* g = tri + (base + j) * 9;
    const float e1x = g[3], e1y = g[4], e1z = g[5];
    const float e2x = g[6], e2y = g[7], e2z = g[8];
    float4* r = reinterpret_cast<float4*>(s_tri + j * kRow);
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
  __shared__ __align__(16) float s_tri[kTriChunk * kRow];
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
      const float4* r = reinterpret_cast<const float4*>(s_tri + j * kRow);
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
        const uint32_t sb = __float_as_uint(det) & 0x80000000u;
        const float dd = fabsf(det);
        const float un = fold(dx[k] * wx + dy[k] * wy + dz[k] * wz, sb);
        const float vn = fold(dx[k] * qx + dy[k] * qy + dz[k] * qz, sb);
        const float tn = fold(tnum, sb);
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
  const int grid = (n + kClosestBlock - 1) / kClosestBlock;
  closest_hit_kernel<<<grid, kClosestBlock, staged_bytes(n_tris),
                       static_cast<cudaStream_t>(stream)>>>(
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
  const int grid = (n + kAnyBlock - 1) / kAnyBlock;
  any_hit_kernel<<<grid, kAnyBlock, staged_bytes(n_tris),
                   static_cast<cudaStream_t>(stream)>>>(
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
