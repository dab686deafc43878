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
// table `table` (G x 10 fp32, 8-byte aligned: mean x, mean y, conic a, b,
// c, opacity already masked by validity, r, g, b, depth).  Output: six fp32
// planes of H x W — r, g, b, accumulated depth, alpha (sum of weights) and
// T_final.
//
// Rules (those of the JAX package and of `composite_ref`): pixel centres at
// +0.5; sigma = 0.5 (a dx^2 + c dy^2) + b dx dy, a_raw = o exp(-sigma); a
// pair is skipped when sigma < 0 or a_raw < 1/255, before the clamp
// alpha = min(0.999, a_raw); the pixel stops for good at the first pair with
// T (1 - alpha) < 1e-4, and that pair is not composited.
//
// What bounds it on the card: the work no implementation avoids is 27 fp32
// operations per composited (pixel, pair), a few percent of the (pixel,
// pair)s a tile walks, so the bytes (one id per pair walked, one 40-byte
// row per Gaussian, the six planes) bound it.  What costs the time is
// walking the pairs that a pixel does not composite, the gather of their
// rows and the sequential dependence of each pixel's walk.  What the
// design does (raster_common.cuh holds the parts the backward shares):
//   * one block of 256 threads per 16 x 16 tile, one pixel a thread; each
//     warp owns an 8 x 4 sub-tile, and each staged pair carries a mask of
//     the warps its a_raw >= 1/255 region can reach (exact and
//     conservative, computed once by the thread that stages it), so a warp
//     walks only its pairs: a ballot over its bit per 32 pairs, then __ffs;
//   * pairs are staged 256 at a time in a two-stage ring: the ids of batch
//     k + 2 are loaded into registers and the rows of batch k + 1 copied
//     with cp.async while batch k is composited, so the dependent gather
//     (id, then row) is off the critical path;
//   * an evaluation reads its geometry as two 16-byte shared loads (the
//     second also holds the pair's raised level, beyond which a_raw
//     < 1/255); only a pair that composites reads its payload;
//   * a warp whose 32 pixels have stopped stops walking; the block leaves
//     its segment once all 256 have (__syncthreads_count);
//   * __launch_bounds__(256, 6): at most 40 registers, so six blocks fit
//     an SM and the 784 tiles of a 448^2 view run in one wave; the r, g,
//     b and depth sums live in shared memory, so nothing spills.
// The arithmetic per (pixel, pair) is the simple kernel's but for the
// exponential, __expf in place of expf (within ~1e-6 of itself; the
// backward takes the same one).

#include "raster_common.cuh"

namespace {

using namespace raster;

constexpr int kBatch = 256;     // pairs staged per round
static_assert(kBatch % 32 == 0 && kBatch <= kPix, "kBatch");
constexpr int kMinBlocks = 6;   // blocks an SM: at most 40 registers

__global__ void __launch_bounds__(kPix, kMinBlocks)
composite_fwd_kernel(const int* __restrict__ gid,
                     const int* __restrict__ bounds,
                     const float* __restrict__ table,
                     float* __restrict__ out, int ntx, int width,
                     int height) {
  __shared__ Stage<kBatch> ring[2];
  const int tile = blockIdx.x;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const unsigned wbit = 1u << warp;
  const int ty = tile / ntx;
  const int tx = tile - ty * ntx;
  const int px = tx * kTile + pixel_x(tid);
  const int py = ty * kTile + pixel_y(tid);
  const bool inside = px < width && py < height;
  const float fx = static_cast<float>(px) + 0.5f;
  const float fy = static_cast<float>(py) + 0.5f;
  const float x0 = static_cast<float>(tx * kTile) + 0.5f;
  const float y0 = static_cast<float>(ty * kTile) + 0.5f;
  const int start = bounds[tile];
  const int end = bounds[tile + 1];

  float trans = 1.0f;
  float acc_a = 0.0f;
  // This thread's r, g, b and depth sums, in shared memory: they change only
  // where a pair composites, and held in registers they would spill.
  __shared__ float4 s_acc[kPix];
  s_acc[tid] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  bool done = !inside;

  // Prologue: batch 0's rows in flight, batch 1's ids in registers.
  const bool stager = tid < kBatch;
  if (stager && start + tid < end)
    stage_row(ring[0], tid, table, gid[start + tid]);
  cp_async_commit();
  int id_next = stager && start + kBatch + tid < end
                    ? gid[start + kBatch + tid] : 0;

  int s = 0;
  for (int base = start; base < end; base += kBatch, s ^= 1) {
    Stage<kBatch>& st = ring[s];
    cp_async_wait_all();
    if (stager && base + tid < end) stage_mask(st, tid, x0, y0);
    // Batch k (rows and masks) is visible to all; every warp is through
    // batch k - 1, whose slot the next copies overwrite.
    if (__syncthreads_count(done) == kPix) break;
    if (stager && base + kBatch + tid < end)
      stage_row(ring[s ^ 1], tid, table, id_next);
    cp_async_commit();
    const int i2 = base + 2 * kBatch + tid;
    id_next = stager && i2 < end ? gid[i2] : 0;

    const int n = min(kBatch, end - base);
    Walk walk;
    for (int j; (j = walk.next(st, n, wbit, lane, done)) >= 0;) {
      if (done) continue;
      const float4 g = st.geo[j];
      const float4 g1 = st.geo1[j];
      const float dx = fx - g.x;
      const float dy = fy - g.y;
      const float sigma = 0.5f * (g.z * dx * dx + g1.x * dy * dy) +
                          g.w * dx * dy;
      // beyond the raised level a_raw < 1/255 for certain: no exponential
      if (!(sigma >= 0.0f && sigma <= g1.z)) continue;
      const float a_raw = g1.y * composite_exp(-sigma);
      if (!(a_raw >= kAlphaMin)) continue;
      const float alpha = fminf(a_raw, kAlphaClamp);
      const float t_next = trans * (1.0f - alpha);
      if (t_next < kTEps) {
        done = true;
        continue;
      }
      const float4 c = st.pay[j];
      const float w = alpha * trans;
      float4 acc = s_acc[tid];
      acc.x += w * c.x;
      acc.y += w * c.y;
      acc.z += w * c.z;
      acc.w += w * c.w;
      s_acc[tid] = acc;
      acc_a += w;
      trans = t_next;
    }
  }

  if (inside) {
    const size_t plane = static_cast<size_t>(width) * height;
    const size_t p = static_cast<size_t>(py) * width + px;
    const float4 acc = s_acc[tid];
    out[p] = acc.x;
    out[plane + p] = acc.y;
    out[2 * plane + p] = acc.z;
    out[3 * plane + p] = acc.w;
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
