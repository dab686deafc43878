// What the composite forward (`rasterize_fwd.cu`) and backward
// (`rasterize_bwd.cu`) share: the composite's constants, the map from a
// thread to its pixel, the per-warp cull mask of a staged pair, the
// two-stage ring of staged pairs filled with cp.async, and the walk of a
// warp over the pairs its mask bit keeps.
//
// A block of 256 threads owns one 16 × 16 tile.  Warp w owns the compact
// 8 × 4 sub-tile at column (w % 2)·8 and row (w / 2)·4 of the tile, lane l
// the pixel (l % 8, l / 8) of it, so a small ellipse reaches few warps.
//
// The cull mask (`subtile_mask`; its plain version is
// `kernels/rasterizer.py::subtile_mask_ref`): bit w is set when the pair's
// a_raw >= 1/255 region can reach a pixel centre of warp w's sub-tile.  A
// (pixel, pair) outside every set bit is one the composite skips anyway
// (sigma < 0 or a_raw < 1/255), so walking only the kept pairs gives the
// same outputs as walking them all.  For a positive-definite conic
// (a > 0, det = a c - b^2 > 0) the region sigma <= L, L = ln(255 o), is an
// ellipse about the mean with half-extents sqrt(2 L c / det) in x and
// sqrt(2 L a / det) in y.  Margins, so that every (pixel, pair) the
// kernel's fp32 arithmetic lets through is inside the widened box:
//   * sigma's rounding.  The kernel's sigma^ (dx = fx - mx rounded,
//     0.5 (a dx^2 + c dy^2) + b dx dy, FMA-contracted or not) is within
//     3.5 eps (a dx^2 + c dy^2) of the exact form at its own dx, dy
//     (eps = 2^-24; |b dx dy| <= (a dx^2 + c dy^2) / 2 when det > 0).  So
//     sigma^ <= L' implies (1/2) d^T (C - 7 eps diag(a, c)) d <= L': the
//     extents are those of the conic with its diagonal shrunk by kCullDiag
//     = 1e-4, far above 7 eps = 4.2e-7.
//   * det's rounding.  a' c' - b^2 loses up to ~2 eps (a' c' + b^2) to
//     cancellation, so det is taken kCullDet = 1e-5 of that lower; a
//     needle whose det does not survive this gets all bits.
//   * the level.  o e^(-sigma^) >= fl(1/255) needs sigma^ <= ln(255 o)
//     + 1e-6: the kernels' exponential (`composite_exp`, __expf:
//     ex2.approx of x log2(e), within ~2 ulp plus the rounding of the
//     product, below 8e-7 of itself where sigma^ <= ln(255) + 1), the
//     product and 1/255 within half an ulp each; logf(255 o) is within
//     ~1.2e-7 (|L| + 1) of ln(255 o).  The level is raised by kCullLevel
//     (|L| + 1), kCullLevel = 1e-4.
//   * the extents.  sqrtf and the division add a few ulp: each extent is
//     widened by kCullExtent = 1e-4 of itself plus kCullPad = 1e-2 px.
//   * the box test.  It compares fl(X0 - mx) and fl(mx - X1) with the
//     extent, X0 and X1 the sub-tile's first and last pixel centres.
//     Rounding is monotone, so a pixel centre fx in [X0, X1] with
//     |fl(fx - mx)| <= extent makes both tests pass: no margin is needed.
// A pair with a non-PD conic, o < 1/255, a non-finite value or an extent
// beyond kCullHuge gets all 8 bits: those pairs are not culled.
//
// The raised level lv = L + kCullLevel (|L| + 1) is kept with the staged
// pair: the kernels skip a pixel whose sigma^ > lv before the exponential,
// which that pixel's a_raw test would fail (the level margin above), so the
// skip changes no output.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace raster {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;   // threads per block, one per pixel
constexpr int kWarps = kPix / 32;
constexpr int kSubW = 8;              // a warp's sub-tile: 8 wide, 4 high
constexpr int kSubH = 4;
constexpr int kAttr = 10;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaClamp = 0.999f;
constexpr float kTEps = 1e-4f;
constexpr unsigned kFull = 0xffffffffu;

constexpr float kCullDiag = 1e-4f;
constexpr float kCullDet = 1e-5f;
constexpr float kCullLevel = 1e-4f;
constexpr float kCullExtent = 1e-4f;
constexpr float kCullPad = 1e-2f;
constexpr float kCullHuge = 1e6f;
constexpr unsigned kAllWarps = (1u << kWarps) - 1;

// Thread `tid`'s pixel in its tile: warp w's sub-tile, lane l's place in it.
__device__ __forceinline__ int pixel_x(int tid) {
  return ((tid >> 5) & 1) * kSubW + (tid & 7);
}
__device__ __forceinline__ int pixel_y(int tid) {
  return ((tid >> 5) >> 1) * kSubH + ((tid & 31) >> 3);
}

// The raised level of opacity o: sigma^ > cull_level(o) fails a_raw's test.
__device__ __forceinline__ float cull_level(float o) {
  const float level = logf(255.0f * o);
  return level + kCullLevel * (fabsf(level) + 1.0f);
}

// The warps whose sub-tile the pair's a_raw >= 1/255 region can reach;
// (x0, y0) is the tile's first pixel centre, lv = cull_level(o).
__device__ __forceinline__ unsigned subtile_mask(float mx, float my, float a,
                                                 float b, float c, float o,
                                                 float lv, float x0,
                                                 float y0) {
  const float ap = a * (1.0f - kCullDiag);
  const float cp = c * (1.0f - kCullDiag);
  const float det = ap * cp - b * b;
  const float det_lo = det - kCullDet * (ap * cp + b * b);
  if (!(ap > 0.0f && cp > 0.0f && det_lo > 0.0f && o >= kAlphaMin))
    return kAllWarps;
  const float ex =
      sqrtf(2.0f * lv * cp / det_lo) * (1.0f + kCullExtent) + kCullPad;
  const float ey =
      sqrtf(2.0f * lv * ap / det_lo) * (1.0f + kCullExtent) + kCullPad;
  if (!(ex <= kCullHuge && ey <= kCullHuge && fabsf(mx) <= kCullHuge &&
        fabsf(my) <= kCullHuge))
    return kAllWarps;
  unsigned mask = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const float sx0 = x0 + static_cast<float>((w & 1) * kSubW);
    const float sy0 = y0 + static_cast<float>((w >> 1) * kSubH);
    const float sx1 = sx0 + static_cast<float>(kSubW - 1);
    const float sy1 = sy0 + static_cast<float>(kSubH - 1);
    if (sx0 - mx <= ex && mx - sx1 <= ex && sy0 - my <= ey && my - sy1 <= ey)
      mask |= 1u << w;
  }
  return mask;
}

// ---- the ring of staged pairs ----------------------------------------------

// One batch of N staged pairs: geometry as two vectors, so an evaluation
// reads 16 + 8 bytes, and the payload, read only by a pair that composites.
template <int N>
struct Stage {
  float4 geo[N];        // mean x, mean y, conic a, conic b
  float4 geo1[N];       // conic c, opacity, raised level lv, unused
  float4 pay[N];        // r, g, b, depth
  unsigned mask[N];     // the warps that walk the pair
};

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts the copy of Gaussian `id`'s 40-byte row (8-byte aligned) into
// slot j of `st`.
template <int N>
__device__ __forceinline__ void stage_row(Stage<N>& st, int j,
                                          const float* __restrict__ table,
                                          int id) {
  const float* row = table + static_cast<size_t>(id) * kAttr;
  cp_async8(&st.geo[j].x, row);
  cp_async8(&st.geo[j].z, row + 2);
  cp_async8(&st.geo1[j].x, row + 4);
  cp_async8(&st.pay[j].x, row + 6);
  cp_async8(&st.pay[j].z, row + 8);
}

// After the thread's own copies into slot j have landed: its raised level
// and cull mask.
template <int N>
__device__ __forceinline__ void stage_mask(Stage<N>& st, int j, float x0,
                                           float y0) {
  const float4 g = st.geo[j];
  const float c = st.geo1[j].x, o = st.geo1[j].y;
  const float lv = cull_level(o);
  st.geo1[j].z = lv;
  st.mask[j] = subtile_mask(g.x, g.y, g.z, g.w, c, o, lv, x0, y0);
}

// The composite's exponential, __expf (ex2.approx).  Both kernels take the
// same one, so the backward recomputes the forward's stopping set.
__device__ __forceinline__ float composite_exp(float x) { return __expf(x); }

// A warp's walk over the first n pairs of a stage, in pair order, visiting
// only those whose mask holds the warp's bit.  `next` gives the next such
// pair, or -1 at the end of the stage or once every lane is `done` (checked
// when a window of 32 pairs is opened).
struct Walk {
  int win = -32;
  unsigned bits = 0;

  template <int N>
  __device__ __forceinline__ int next(const Stage<N>& st, int n,
                                      unsigned wbit, int lane, bool done) {
    while (bits == 0) {
      win += 32;
      if (win >= n || __all_sync(kFull, done)) return -1;
      const int j = win + lane;
      bits = __ballot_sync(kFull, j < n && (st.mask[j] & wbit));
    }
    const int j = win + __ffs(bits) - 1;
    bits &= bits - 1;
    return j;
  }
};

}  // namespace raster
