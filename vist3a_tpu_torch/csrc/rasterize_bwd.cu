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
// the (G, 10) table (8-byte aligned) gathered inside the kernel through
// `gid`, the forward's six output planes `out` and their cotangent `gout`
// (6 × H × W each: r, g, b, depth, alpha, T_final).  Output: `dpair`,
// (P, 10) fp32, the gradient of every pair's row of the table (mean x,
// mean y, conic a, b, c, opacity, r, g, b, depth); the caller reduces it
// per Gaussian.
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
// What bounds it on the card: the work no implementation avoids is, per
// composited (pixel, pair), the evaluation and ~56 fp32 operations of the
// gradient and its share of the sum over the tile's pixels; composited
// (pixel, pair)s are a few percent of those walked, so the bytes (ids,
// rows and gradient rows of the pairs walked, the two 6-plane images)
// bound it.  What costs the time is the walk, as in the forward, and the
// gradient of every (warp, pair) some lane composites, which a cull cannot
// remove.  What the design does (raster_common.cuh holds the parts the
// forward shares):
//   * the forward's layout: a block per 16 × 16 tile, a warp per 8 × 4
//     sub-tile, each staged pair's cull mask and raised level, the walk of
//     a warp over its pairs only, the two-stage cp.async ring (128 pairs a
//     stage here) and the warp and block early exits;
//   * the sum over a warp's 32 pixels as a reduce-scatter: a lane keeps its
//     10 contributions to 2 consecutive pairs of its warp's walk that some
//     lane composited (a pair no lane composited is not reduced), and the
//     20 values are halved at lane offsets 16, 8, 4, 2 and 1 until each
//     lane holds one sum (`reduce_scatter`: 21 shuffles, ~10.5 a pair,
//     where a butterfly per value takes 50).  Each step adds the same two
//     values as that butterfly, so the sums are its bits;
//   * the lane holding a value of pair j writes it to part[warp][j] and
//     lane 0 flags the pair in act[warp]; the 8 warps' flagged partials
//     are then summed in warp order.  The order is fixed, so the result is
//     the same bits on every run; each pair belongs to one tile, so no two
//     blocks write one row: no atomics.  The rows a block never reaches
//     stay zero (the caller passes a zeroed dpair);
//   * 1/o is staged with the pair; the colour and depth cotangents live in
//     shared memory; __launch_bounds__(256, 3): at most 80 registers, no
//     spills, three blocks an SM;
//   * the forward's exponential (__expf), and dα's division as __fdividef
//     (within 2 ulp; 1 − α lies in [0.001, 1]).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o librasterize_bwd.so rasterize_bwd.cu

#include "raster_common.cuh"

namespace {

using namespace raster;

constexpr int kBatch = 128;     // pairs staged per round
static_assert(kBatch % 32 == 0 && kBatch <= kPix, "kBatch");
constexpr int kMinBlocks = 3;   // blocks an SM: at most 80 registers
constexpr int kGroup = 2;       // pairs a warp reduces at once
constexpr int kValues = kGroup * kAttr;
constexpr int kWords = kBatch / 32;
static_assert(kValues <= 32, "a group's values must fit the warp's lanes");

// One step of the reduce-scatter of M values at lane offset OFF: the lanes
// with that bit set keep the upper floor(M/2) values (the lower ceil(M/2)
// positions, the last one padding when M is odd), the others the lower
// ceil(M/2), each adding what its partner sends; then the next offset.
// `idx` is the index of the value in v[0], `cnt` how many of v[] are real.
template <int M, int OFF>
__device__ __forceinline__ void scatter(float* v, int lane, int& idx,
                                        int& cnt) {
  if constexpr (OFF > 0) {
    constexpr int kLo = (M + 1) / 2;
    const bool hi = lane & OFF;
#pragma unroll
    for (int i = 0; i < kLo; ++i) {
      const float upper = i + kLo < M ? v[i + kLo] : 0.f;
      const float send = hi ? v[i] : upper;
      const float keep = hi ? upper : v[i];
      v[i] = keep + __shfl_xor_sync(kFull, send, OFF);
    }
    if (hi) {
      idx += kLo;
      cnt -= kLo;
    } else {
      cnt = min(cnt, kLo);
    }
    scatter<kLo, OFF / 2>(v, lane, idx, cnt);
  }
}

// The sums over the warp's 32 lanes of each lane's v[0 .. kValues), one
// value a lane: halved at lane offsets 16, 8, 4, 2 and 1 (a group of 2
// pairs, 20 values: 10 + 5 + 3 + 2 + 1 = 21 shuffles, ~10.5 a pair, where a
// butterfly per value takes 50).  Each step adds the same two values as
// that butterfly, so the sums are its bits.  Returns the index of the value
// whose sum the lane holds in v[0], or -1 (a lane left with padding).
__device__ __forceinline__ int reduce_scatter(float* v, int lane) {
  int idx = 0, cnt = kValues;
  scatter<kValues, 16>(v, lane, idx, cnt);
  return cnt > 0 ? idx : -1;
}

struct Smem {
  Stage<kBatch> ring[2];
  float part[kWarps][kBatch][kAttr];  // each warp's sums over its pixels
  unsigned act[kWarps][kWords];       // which of them the warp wrote
};
// 2 × 6,656 + 40,960 + 128 bytes: over the 48 KiB a launch gets without
// asking, so the entry below raises the limit; with s_g's 4 KiB, three
// blocks fit an SM's 228 KiB.
static_assert(sizeof(Smem) == 54400, "shared memory a block");

__global__ void __launch_bounds__(kPix, kMinBlocks)
composite_bwd_kernel(const int* __restrict__ gid,
                     const int* __restrict__ bounds,
                     const float* __restrict__ table,
                     const float* __restrict__ out,
                     const float* __restrict__ gout,
                     float* __restrict__ dpair, int ntx, int width,
                     int height) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
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

  // This thread's colour and depth cotangents, in shared memory: read only
  // where a pair composites, and held in registers they would spill.
  __shared__ float4 s_g[kPix];
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
  s_g[tid] = make_float4(g[0], g[1], g[2], g[3]);
  const float g_alpha = g[4];

  float trans = 1.0f;
  float prefix = 0.0f;        // Σ w_j gp_j over the pairs composited so far
  bool done = !inside;

  // Prologue: batch 0's rows in flight, batch 1's ids in registers.
  const bool stager = tid < kBatch;
  if (stager && start + tid < end)
    stage_row(sm.ring[0], tid, table, gid[start + tid]);
  cp_async_commit();
  int id_next = stager && start + kBatch + tid < end
                    ? gid[start + kBatch + tid] : 0;

  int s = 0;
  for (int base = start; base < end; base += kBatch, s ^= 1) {
    Stage<kBatch>& st = sm.ring[s];
    cp_async_wait_all();
    if (stager && base + tid < end) {
      stage_mask(st, tid, x0, y0);
      st.geo1[tid].w = 1.0f / fmaxf(st.geo1[tid].y, 1e-12f);   // 1 / o
    }
    // Batch k is visible to all; every thread is through batch k - 1 and
    // its cross-warp sum, whose shared memory is reused below.
    if (__syncthreads_count(done) == kPix) break;
    if (stager && base + kBatch + tid < end)
      stage_row(sm.ring[s ^ 1], tid, table, id_next);
    cp_async_commit();
    const int i2 = base + 2 * kBatch + tid;
    id_next = stager && i2 < end ? gid[i2] : 0;
    if (lane < kWords) sm.act[warp][lane] = 0u;
    __syncwarp();

    const int n = min(kBatch, end - base);
    // This lane's pixel against pair j: its 10 contributions into c
    // (zeros where it does not composite), the pixel's T, prefix and stop
    // carried as the forward does; whether it composited.  A pixel beyond
    // the pair's raised level skips the exponential (its a_raw < 1/255).
    auto eval = [&](int j, float* c) -> bool {
#pragma unroll
      for (int k = 0; k < kAttr; ++k) c[k] = 0.f;
      if (done) return false;
      const float4 ge = st.geo[j];
      const float4 ge1 = st.geo1[j];
      const float dx = fx - ge.x;
      const float dy = fy - ge.y;
      const float sigma =
          0.5f * (ge.z * dx * dx + ge1.x * dy * dy) + ge.w * dx * dy;
      if (!(sigma >= 0.0f && sigma <= ge1.z)) return false;
      const float a_raw = ge1.y * composite_exp(-sigma);
      if (!(a_raw >= kAlphaMin)) return false;
      const float alpha = fminf(a_raw, kAlphaClamp);
      const float t_next = trans * (1.0f - alpha);
      if (t_next < kTEps) {
        done = true;
        return false;
      }
      const float4 col = st.pay[j];
      const float w = alpha * trans;
      const float4 gc = s_g[tid];
      const float gp = gc.x * col.x + gc.y * col.y + gc.z * col.z +
                       gc.w * col.w + g_alpha;
      prefix += w * gp;
      if (a_raw < kAlphaClamp) {
        const float dalpha =
            gp * trans - __fdividef(o_total - prefix + g_tn, 1.0f - alpha);
        const float dsig = -alpha * dalpha;
        c[0] = -dsig * (ge.z * dx + ge.w * dy);
        c[1] = -dsig * (ge1.x * dy + ge.w * dx);
        c[2] = 0.5f * dsig * dx * dx;
        c[3] = dsig * dx * dy;
        c[4] = 0.5f * dsig * dy * dy;
        c[5] = alpha * ge1.w * dalpha;
      }
      c[6] = gc.x * w;
      c[7] = gc.y * w;
      c[8] = gc.z * w;
      c[9] = gc.w * w;
      trans = t_next;
      return true;
    };
    Walk walk;
    bool more = true;
    while (more) {
      // c[q·10 ...]: this lane's contributions to the q-th pair of the
      // group that some lane of the warp composited; lane q holds its index.
      float c[kValues];
      int my_j = -1;
#pragma unroll
      for (int q = 0; q < kGroup; ++q) {
        int j = -1;
        if (more) {
          while ((j = walk.next(st, n, wbit, lane, done)) >= 0)
            if (__ballot_sync(kFull, eval(j, c + q * kAttr))) break;
        }
        if (j < 0) {
          more = false;
#pragma unroll
          for (int k = 0; k < kAttr; ++k) c[q * kAttr + k] = 0.f;
          continue;
        }
        if (lane == q) my_j = j;
        if (lane == 0) sm.act[warp][j >> 5] |= 1u << (j & 31);
      }
      if (__shfl_sync(kFull, my_j, 0) < 0) break;   // an empty group
      const int v = reduce_scatter(c, lane);
      const int jw = __shfl_sync(kFull, my_j, max(v, 0) / kAttr);
      if (v >= 0 && jw >= 0) sm.part[warp][jw][v % kAttr] = c[0];
    }
    __syncthreads();
    for (int e = tid; e < n * kAttr; e += kPix) {
      const int j = e / kAttr, k = e - j * kAttr;
      const unsigned bit = 1u << (j & 31);
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        if (sm.act[w][j >> 5] & bit) sum += sm.part[w][j][k];
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
  static const cudaError_t attr = cudaFuncSetAttribute(
      composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(Smem)));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  composite_bwd_kernel<<<n_tiles, kPix, sizeof(Smem),
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(gid), static_cast<const int*>(bounds),
      static_cast<const float*>(table), static_cast<const float*>(out),
      static_cast<const float*>(gout), static_cast<float*>(dpair), ntx,
      width, height);
  return static_cast<int>(cudaGetLastError());
}
