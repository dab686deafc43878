// Alpha-composite forward of the 3D Gaussian-splat rasterizer, for Hopper
// (sm_90a), with a plain C interface (built by nvcc alone, bound by ctypes).
//
// Replaces the Pallas TPU kernel `_fwd_kernel` of
// vist3a_tpu/kernels/rasterizer.py (line 531, launched through
// `_composite_fwd_part` at line 678).  The TPU kernel walks a bit-packed
// visit list of 128-pair chunks, computes alpha for 256 pixels x 128 pairs on
// the vector unit, turns the front-to-back transmittance into a log-space
// prefix sum (a triangular matmul) and accumulates with one MXU product per
// chunk, carrying T across chunks in VMEM.  None of that is needed here:
// a thread owns a pixel and multiplies T pair by pair, in order.
//
// Inputs: the (tile, depth)-sorted pair stream `gid` (P int32 Gaussian ids),
// the tile segment starts `bounds` (n_tiles + 1 int32), and the per-Gaussian
// table `table` (G x 10 fp32: mean x, mean y, conic a, b, c, opacity already
// masked by validity, r, g, b, depth).  Output: six fp32 planes of H x W —
// r, g, b, accumulated depth, alpha (sum of weights) and T_final.
//
// Rules (those of the JAX package and of `composite_ref`): pixel centres at
// +0.5; sigma = 0.5 (a dx^2 + c dy^2) + b dx dy, a_raw = o exp(-sigma); a
// pair is skipped when sigma < 0 or a_raw < 1/255, before the clamp
// alpha = min(0.999, a_raw); the pixel stops for good at the first pair with
// T (1 - alpha) < 1e-4, and that pair is not composited.
//
// What bounds it on the card: per (pixel, evaluated pair) 14 fp32
// operations (one of them an exponential), and 13 more per composited
// pair, outside the tensor cores; the bytes are one 4-byte id per pair
// that a tile walks and one 40-byte row per Gaussian.  At the orbit views
// of a 448^2 decode a tile walks thousands of pairs for 256 pixels, so the
// operations (67 TFLOP/s fp32) bound it, not HBM.  Design, simple
// and right first: one block of 256 threads per 16 x 16 tile, one pixel a
// thread.  The block stages 256 pairs at a time in shared memory (ids read
// coalesced, rows gathered inside the kernel, so no per-pair attribute
// table is ever written to device memory), every thread composites its
// pixel over them in order, and the block leaves its segment as soon as all
// its pixels have stopped (__syncthreads_count).  No double buffering, no
// warp-level culling of pairs: that is later work.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;
constexpr int kPix = kTile * kTile;   // threads per block, one per pixel
constexpr int kBatch = kPix;          // pairs staged per round
constexpr int kAttr = 10;
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaClamp = 0.999f;
constexpr float kTEps = 1e-4f;

__global__ void __launch_bounds__(kPix)
composite_fwd_kernel(const int* __restrict__ gid,
                     const int* __restrict__ bounds,
                     const float* __restrict__ table,
                     float* __restrict__ out, int ntx, int width,
                     int height) {
  __shared__ float s_attr[kAttr][kBatch];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int ty = tile / ntx;
  const int tx = tile - ty * ntx;
  const int px = tx * kTile + (tid % kTile);
  const int py = ty * kTile + (tid / kTile);
  const bool inside = px < width && py < height;
  const float fx = static_cast<float>(px) + 0.5f;
  const float fy = static_cast<float>(py) + 0.5f;
  const int start = bounds[tile];
  const int end = bounds[tile + 1];

  float trans = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f, acc_a = 0.0f;
  bool done = !inside;

  for (int base = start; base < end; base += kBatch) {
    // Every thread reaches this barrier, which also keeps the last batch in
    // shared memory until all threads are through it.
    if (__syncthreads_count(done) == kPix) break;
    const int i = base + tid;
    if (i < end) {
      const float* row = table + static_cast<size_t>(gid[i]) * kAttr;
#pragma unroll
      for (int k = 0; k < kAttr; ++k) s_attr[k][tid] = row[k];
    }
    __syncthreads();
    const int n = min(kBatch, end - base);
    for (int j = 0; j < n && !done; ++j) {
      const float dx = fx - s_attr[0][j];
      const float dy = fy - s_attr[1][j];
      const float sigma =
          0.5f * (s_attr[2][j] * dx * dx + s_attr[4][j] * dy * dy) +
          s_attr[3][j] * dx * dy;
      const float a_raw = s_attr[5][j] * expf(-sigma);
      if (!(sigma >= 0.0f && a_raw >= kAlphaMin)) continue;
      const float alpha = fminf(a_raw, kAlphaClamp);
      const float t_next = trans * (1.0f - alpha);
      if (t_next < kTEps) {
        done = true;
        break;
      }
      const float w = alpha * trans;
      acc_r += w * s_attr[6][j];
      acc_g += w * s_attr[7][j];
      acc_b += w * s_attr[8][j];
      acc_d += w * s_attr[9][j];
      acc_a += w;
      trans = t_next;
    }
  }

  if (inside) {
    const size_t plane = static_cast<size_t>(width) * height;
    const size_t p = static_cast<size_t>(py) * width + px;
    out[p] = acc_r;
    out[plane + p] = acc_g;
    out[2 * plane + p] = acc_b;
    out[3 * plane + p] = acc_d;
    out[4 * plane + p] = acc_a;
    out[5 * plane + p] = trans;
  }
}

}  // namespace

// Launches one block per tile on `stream`; returns cudaGetLastError().
extern "C" int rasterize_composite_fwd(const void* gid, const void* bounds,
                                       const void* table, void* out,
                                       int n_tiles, int ntx, int width,
                                       int height, void* stream) {
  if (n_tiles <= 0) return 0;
  composite_fwd_kernel<<<n_tiles, kPix, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(gid), static_cast<const int*>(bounds),
      static_cast<const float*>(table), static_cast<float*>(out), ntx, width,
      height);
  return static_cast<int>(cudaGetLastError());
}
