// Alpha-composite backward of the 3D Gaussian-splat rasterizer, for Hopper
// (sm_90a), with a plain C interface (built by nvcc alone, bound by ctypes).
//
// Replaces the Pallas TPU kernel `_bwd_kernel` of
// vist3a_tpu/kernels/rasterizer.py (line 568, launched through
// `_composite_bwd_part` at line 716, the VJP of `_composite`).  The TPU
// kernel walks the same bit-packed visit list as its forward, per 128-pair
// chunk turning the transmittance into a log-space prefix sum (a triangular
// matmul) and the per-pair sums over the 256 pixels into MXU products.
// Here the data are the forward's own (rasterize_fwd.cu): the
// (tile, depth)-sorted pair stream `gid`, the tile segment starts `bounds`,
// the (G, 10) table gathered inside the kernel through `gid`, the forward's
// six output planes `out` and their cotangent `gout` (6 × H × W each:
// r, g, b, depth, alpha, T_final).  Output: `dpair`, (P, 10) fp32, the
// gradient of every pair's row of the table (mean x, mean y, conic a, b, c,
// opacity, r, g, b, depth); the caller reduces it per Gaussian.
//
// The walk is front to back, as the forward's: a thread owns a pixel and
// recomputes T pair by pair with the forward's arithmetic, so it takes the
// forward's stopping set exactly (a pair with sigma < 0 or a_raw < 1/255
// is skipped; the first pair with T (1 - alpha) < 1e-4 stops the pixel and
// is not composited).  The suffix Σ_{j>i} w_j gp_j that d alpha_i needs is
// the total, read from the saved output, minus the running prefix — the
// TPU kernel's `o_total − q_incl` — plus the T_final cotangent g_T·T_N:
//   gp_i     = g_rgb · rgb_i + g_depth · depth_i + g_alpha
//   dalpha_i = gp_i T_{i−1} − (Σ_c g_c out_c − Σ_{j≤i} w_j gp_j + g_T T_N)
//              / (1 − alpha_i),   zero where a_raw ≥ 0.999 (the clamp)
//   dsigma   = −alpha dalpha,  dopacity = (alpha / opacity) dalpha,
//   d conic  = dsigma (dx²/2, dx dy, dy²/2),
//   d mean   = −dsigma (a dx + b dy, c dy + b dx),
//   d rgb, d depth = g_c w_i.
//
// Layout: one block of 256 threads per 16 × 16 tile, one pixel a thread, as
// the forward.  Pairs are staged 64 at a time in shared memory; for each
// pair the 10 gradients are summed over the block's pixels in a fixed order
// — a butterfly of warp shuffles (skipped when no lane of the warp
// composited the pair), then the 8 warps' partial sums in warp order — so
// the result is the same bits on every run.  Each pair belongs to one tile,
// so no two blocks write one row: no atomics.  The block leaves its segment
// when all its pixels have stopped; the rows it never reached stay zero
// (the caller passes a zeroed dpair).
//
// What bounds it on the card: per (pixel, evaluated pair) the forward's 14
// fp32 operations, and per composited pair ~45 more (the gradient
// formulas) plus a 10-value warp reduction; the bytes are one id and one
// 40-byte row read and one 40-byte gradient row written per pair walked,
// and the two 6-plane images.  Operations at the fp32 rate (67 TFLOP/s)
// bound it.  Simple and right first: no double buffering, no warp-level
// culling of pairs outside a warp's pixels.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o librasterize_bwd.so rasterize_bwd.cu

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;   // threads per block, one per pixel
constexpr int kWarps = kPix / 32;
constexpr int kBatch = 64;            // pairs staged per round
constexpr int kAttr = 10;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaClamp = 0.999f;
constexpr float kTEps = 1e-4f;

__global__ void __launch_bounds__(kPix)
composite_bwd_kernel(const int* __restrict__ gid,
                     const int* __restrict__ bounds,
                     const float* __restrict__ table,
                     const float* __restrict__ out,
                     const float* __restrict__ gout,
                     float* __restrict__ dpair, int ntx, int width,
                     int height) {
  __shared__ float s_attr[kAttr][kBatch];
  __shared__ float s_part[kWarps][kBatch][kAttr];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int ty = tile / ntx;
  const int tx = tile - ty * ntx;
  const int px = tx * kTile + (tid % kTile);
  const int py = ty * kTile + (tid / kTile);
  const bool inside = px < width && py < height;
  const float fx = static_cast<float>(px) + 0.5f;
  const float fy = static_cast<float>(py) + 0.5f;
  const int start = bounds[tile];
  const int end = bounds[tile + 1];

  float g[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  float o_total = 0.f, g_tn = 0.f;
  if (inside) {
    const size_t plane = static_cast<size_t>(width) * height;
    const size_t p = static_cast<size_t>(py) * width + px;
#pragma unroll
    for (int c = 0; c < 6; ++c) g[c] = gout[c * plane + p];
#pragma unroll
    for (int c = 0; c < 5; ++c) o_total += g[c] * out[c * plane + p];
    g_tn = g[5] * out[5 * plane + p];
  }

  float trans = 1.0f;
  float prefix = 0.0f;        // Σ w_j gp_j over the pairs composited so far
  bool done = !inside;

  for (int base = start; base < end; base += kBatch) {
    // Every thread reaches this barrier, which also keeps the previous
    // batch's shared memory until all threads are through it.
    if (__syncthreads_count(done) == kPix) break;
    const int i = base + tid;
    if (tid < kBatch && i < end) {
      const float* row = table + static_cast<size_t>(gid[i]) * kAttr;
#pragma unroll
      for (int k = 0; k < kAttr; ++k) s_attr[k][tid] = row[k];
    }
    __syncthreads();
    const int n = min(kBatch, end - base);
    for (int j = 0; j < n; ++j) {
      float c[kAttr];
#pragma unroll
      for (int k = 0; k < kAttr; ++k) c[k] = 0.f;
      bool active = false;
      if (!done) {
        const float dx = fx - s_attr[0][j];
        const float dy = fy - s_attr[1][j];
        const float sigma =
            0.5f * (s_attr[2][j] * dx * dx + s_attr[4][j] * dy * dy) +
            s_attr[3][j] * dx * dy;
        const float a_raw = s_attr[5][j] * expf(-sigma);
        if (sigma >= 0.0f && a_raw >= kAlphaMin) {
          const float alpha = fminf(a_raw, kAlphaClamp);
          const float t_next = trans * (1.0f - alpha);
          if (t_next < kTEps) {
            done = true;
          } else {
            active = true;
            const float w = alpha * trans;
            const float gp = g[0] * s_attr[6][j] + g[1] * s_attr[7][j] +
                             g[2] * s_attr[8][j] + g[3] * s_attr[9][j] + g[4];
            prefix += w * gp;
            if (a_raw < kAlphaClamp) {
              const float dalpha =
                  gp * trans - (o_total - prefix + g_tn) / (1.0f - alpha);
              const float dsig = -alpha * dalpha;
              const float ca = s_attr[2][j], cb = s_attr[3][j],
                          cc = s_attr[4][j];
              c[0] = -dsig * (ca * dx + cb * dy);
              c[1] = -dsig * (cc * dy + cb * dx);
              c[2] = 0.5f * dsig * dx * dx;
              c[3] = dsig * dx * dy;
              c[4] = 0.5f * dsig * dy * dy;
              c[5] = alpha / fmaxf(s_attr[5][j], 1e-12f) * dalpha;
            }
            c[6] = g[0] * w;
            c[7] = g[1] * w;
            c[8] = g[2] * w;
            c[9] = g[3] * w;
            trans = t_next;
          }
        }
      }
      if (__any_sync(0xffffffffu, active)) {
#pragma unroll
        for (int k = 0; k < kAttr; ++k) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            c[k] += __shfl_xor_sync(0xffffffffu, c[k], off);
        }
      }
      if (lane == 0) {
#pragma unroll
        for (int k = 0; k < kAttr; ++k) s_part[warp][j][k] = c[k];
      }
    }
    __syncthreads();
    for (int e = tid; e < n * kAttr; e += kPix) {
      const int j = e / kAttr, k = e % kAttr;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += s_part[w][j][k];
      dpair[static_cast<size_t>(base + j) * kAttr + k] = sum;
    }
  }
}

}  // namespace

// Launches one block per tile on `stream`; returns cudaGetLastError().
// dpair must be zeroed by the caller: rows past a tile's stopping point are
// not written.
extern "C" int rasterize_composite_bwd(const void* gid, const void* bounds,
                                       const void* table, const void* out,
                                       const void* gout, void* dpair,
                                       int n_tiles, int ntx, int width,
                                       int height, void* stream) {
  if (n_tiles <= 0) return 0;
  composite_bwd_kernel<<<n_tiles, kPix, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(gid), static_cast<const int*>(bounds),
      static_cast<const float*>(table), static_cast<const float*>(out),
      static_cast<const float*>(gout), static_cast<float*>(dpair), ntx,
      width, height);
  return static_cast<int>(cudaGetLastError());
}
