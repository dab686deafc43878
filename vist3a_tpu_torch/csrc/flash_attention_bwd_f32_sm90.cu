// Flash-attention backward in fp32 for Hopper (sm_90a) on the TF32 tensor
// cores with the 3×TF32 split: dQ, dK and dV of non-causal
// O = softmax(scale·QKᵀ)·V over (B, N, H, d) fp32 tensors, d ≤ 64 a
// multiple of 4.
//
// Replaces the transposed layout's VJP in vist3a_tpu/kernels/
// flash_attention.py in fp32 (kernel 4): _flash_core_t's backward,
// _dq_kernel_t (:397, call :530) and _dkv_kernel_t (:429, call :546) — the
// stitching-distillation step's student attention, (13, 1029, 16, 64) for
// the ViT blocks and frame attention, (1, 13377, 16, 64) for the global
// attention at 13 views and (1, 21609, 16, 64) at 21.
//
// What it computes, as the plain version does, from the forward's q, k, v,
// LSE and dO, with δ = rowsum(dO∘O) taken outside:
//   P  = exp2(s·scale·log2e − LSE·log2e)   (LSE·log2e handed in)
//   dV = Pᵀ·dO,   dS = P∘(dO·Vᵀ − δ),   dQ = scale·dS·K,   dK = scale·dSᵀ·Q,
// every product as three TF32 products (3×TF32, `sm90.cuh`: a·b ≈
// a_big·b_big + a_big·b_small + a_small·b_big in fp32 accumulators, about
// fp32's accuracy), P and dS in fp32, dQ, dK, dV stored in fp32.  Two
// kernels and no atomics, like the two pallas_calls, so two runs give the
// same bits.
//
// What bounds it on an H100 SXM: 10·B·N²·H·d FLOP of fp32-accurate products
// (four products of 2·N²·d and the recomputed S), each three TF32 products
// at 495 TFLOP/s dense, so 165 TFLOP/s — 1.83e12 FLOP, 11.1 ms at
// (1, 13377, 16, 64), 4.78e12, 29.0 ms at (1, 21609, 16, 64) — against
// 0.44 and 0.71 GB (0.13 and 0.21 ms): operations.  (The FFMA kernels this
// replaces had the 67 TFLOP/s of the CUDA cores as their ceiling.)  This
// design does seven products a tile pair (S and dP in both kernels).
//   * The entry first writes the split planes (2, B·H, n_pad, 64) of Q, dO,
//     K and V into the wrapper's scratch (`tf32_split_planes_kernel`, one
//     pass over each), so the tensor cores read pre-split tiles; P and dS
//     are split in registers.
//   * tf32 wgmma has no transpose bits, so its shared-memory operands are
//     K-major.  The score products (Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ; S = Q·Kᵀ,
//     dP = dO·Vᵀ) take every operand as stored and run on wgmma
//     m64n64k8.  The accumulating products (dV += Pᵀ·dO, dK += dSᵀ·Q,
//     dQ += dS·K) would need Qᵀ, dOᵀ and Kᵀ tiles beside the natural ones,
//     and the shared memory does not hold a two-stage ring of those four
//     planes: they run on mma.sync m16n8k8 (tf32), whose B fragments are
//     read from the natural planes already in shared memory, in place.
//   * A P or dS accumulator holds keys (or queries) 2t and 2t + 1 of each
//     group of eight, where a tf32 A fragment takes t and t + 4: the
//     fragment's column t is taken as 2t and t + 4 as 2t + 1, and the B
//     fragments are read from those rows, so no shuffle is needed.
//   * dK/dV kernel, keys as M: a block owns a 128-key tile as two consumer
//     warpgroups of 64 keys (plus a producer warpgroup whose one thread
//     issues TMA loads; setmaxnreg 40 / 232).  K's A fragments are read
//     from the caller's k (L1-resident) and split for every query tile, as
//     the forward's Q fragments are; V's planes are
//     resident in shared memory (64 KB); 64-query stages of Q's and dO's
//     planes (64 KB) and their LSE·log2e and δ run in a two-stage ring.
//     dK and dV accumulate in fp32 registers, 64 a thread; each tile's
//     product is summed from zero on the tensor cores and added there in
//     fp32 (summed on the tensor cores across tiles, the gradients drifted
//     by ~1e-4 of themselves over 13,377 rows, above their limit).
//   * dQ kernel: a block owns a 128-query tile (two warpgroups of 64); Q's
//     A fragments split from q for every tile, dO's planes resident (64 KB),
//     64-key stages
//     of K's and V's planes (64 KB) in a two-stage ring; dQ += dS·K reads
//     K's planes in place.
//   * Ragged edges: the planes are zero beyond N, and the wrapper pads
//     LSE·log2e with +∞ and δ with 0 to a multiple of 128 rows, so a padded
//     query row has P = 0 and dS = 0 in both kernels; padded keys are
//     masked to P = 0 in the dQ kernel and never stored by the dK/dV kernel.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_bwd_f32_sm90.so \
//        flash_attention_bwd_f32_sm90.cu

#include <math.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

// The correction products of each 3×TF32 product: 2 (a_big·b_small and
// a_small·b_big; `sm90.cuh::product3_rs`, `mma_acc` below).
constexpr int kCorrections = 2;

constexpr int kThreads = 384;          // producer warpgroup + 2 consumers
constexpr int kStages = 2;             // of either kernel's ring
constexpr int kHalf64 = 64 * 128;      // 32 columns of a 64-row fp32 tile
constexpr int kPlane64 = 2 * kHalf64;  // one 64 × 64 plane tile
constexpr int kHalf128 = 128 * 128;    // 32 columns of a 128-row tile
constexpr int kPlane128 = 2 * kHalf128;
constexpr int kStage = 4 * kPlane64;   // two tensors' planes, 64 rows
// dK/dV kernel: V's planes (128 keys); per stage Q's and dO's planes (64
// queries) and their LSE·log2e and δ
constexpr int kDkvStats = 2 * kPlane128 + kStages * kStage;
constexpr int kDkvBars = kDkvStats + kStages * 2 * 64 * 4;
constexpr int kDkvSmem = kDkvBars + 8 * (1 + 2 * kStages) + 1024;
// dQ kernel: dO's planes (128 queries); per stage K's and V's planes (64)
constexpr int kDqBars = 2 * kPlane128 + kStages * kStage;
constexpr int kDqSmem = kDqBars + 8 * (1 + 2 * kStages) + 1024;
constexpr float kLog2e = 1.4426950408889634f;

struct BwdParams {
  const float* q;        // raw q and k, for the registers' A fragments
  const float* k;
  const float* lse2;     // (B, H, nq_pad): LSE·log2e, +∞ beyond n_q
  const float* delta;    // (B, H, nq_pad): rowsum(dO∘O), 0 beyond n_q
  float* dq;
  float* dk;
  float* dv;
  int n_q, n_k, heads, d, nq_pad, nk_pad;
  long long q_sb, q_sn, q_sh, k_sb, k_sn, k_sh;
  long long dq_sb, dq_sn, dq_sh;
  long long dk_sb, dk_sn, dk_sh;
  long long dv_sb, dv_sn, dv_sh;
  float scale, scale_log2;
};

// acc += X·Y on mma.sync, one warp's 16 rows: X (16 × 64) is a score-
// shaped accumulator (element i: row g + 8·((i/2) & 1), column 8·(i/4) + 2t
// + (i & 1)), split here; Y (64 × 64) is a 64-row tile's planes in shared
// memory (big at `tile`, small one plane on).  acc has X's layout over
// Y's 64 columns.  The tile's product is summed from zero on the tensor
// cores and added to acc in fp32: summed there across tiles, the
// gradients drift by ~1e-4 of themselves over 13,377 rows.
__device__ __forceinline__ void mma_acc(float (&acc)[32], const float (&x)[32],
                                        const uint8_t* tile, int g, int t) {
  float part[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) part[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t ab[4], as[4];
    tf32_split(x[4 * kk], ab[0], as[0]);
    tf32_split(x[4 * kk + 2], ab[1], as[1]);
    tf32_split(x[4 * kk + 1], ab[2], as[2]);
    tf32_split(x[4 * kk + 3], ab[3], as[3]);
    const int r = 8 * kk + 2 * t;   // the rows of Y for columns t, t + 4
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      const uint32_t o0 = sw128_f32(64, r, 8 * nb + g);
      const uint32_t o1 = sw128_f32(64, r + 1, 8 * nb + g);
      const uint32_t bb0 = *reinterpret_cast<const uint32_t*>(tile + o0);
      const uint32_t bb1 = *reinterpret_cast<const uint32_t*>(tile + o1);
      const uint32_t bs0 =
          *reinterpret_cast<const uint32_t*>(tile + kPlane64 + o0);
      const uint32_t bs1 =
          *reinterpret_cast<const uint32_t*>(tile + kPlane64 + o1);
      mma_tf32(&part[4 * nb], ab, bb0, bb1);
      if (kCorrections >= 1) mma_tf32(&part[4 * nb], ab, bs0, bs1);
      if (kCorrections >= 2) mma_tf32(&part[4 * nb], as, bb0, bb1);
    }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] += part[i];
}

// Stores a 64 × 64 fp32 accumulator (rows row, row + 8 of this thread)
// times `mul`, rows < n_rows and columns < d.
__device__ __forceinline__ void store_rows(float* base, long long stride_n,
                                           int row, int n_rows, int d,
                                           const float (&acc)[32], float mul,
                                           int t) {
#pragma unroll
  for (int i = 0; i < 32; i += 4) {
    const int col = 2 * i + 2 * t;
    if (col >= d) continue;
    if (row < n_rows)
      *reinterpret_cast<float2*>(base + row * stride_n + col) =
          make_float2(acc[i] * mul, acc[i + 1] * mul);
    if (row + 8 < n_rows)
      *reinterpret_cast<float2*>(base + (row + 8) * stride_n + col) =
          make_float2(acc[i + 2] * mul, acc[i + 3] * mul);
  }
}

// K-major operand: 8-deep slice kk of the rows at byte `row_off` of a
// plane tile whose 32-column halves are `half_bytes` apart.
__device__ __forceinline__ uint64_t kmajor(const uint8_t* tile, int half_bytes,
                                           int row_off, int kk) {
  return desc_sw128(tile, (kk / 4) * half_bytes + row_off + (kk % 4) * 32, 0,
                    1024);
}

// Loads both planes of rows row0 .. row0 + 64·NBoxes − 1 of one tensor's
// planes (2-D map; plane 1 `plane_rows` rows after plane 0) into a
// [plane][half][64·NBoxes][32] tile.
template <int NBoxes>
__device__ __forceinline__ void load_planes(uint8_t* dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int row0,
                                            int plane_rows) {
#pragma unroll
  for (int pl = 0; pl < 2; ++pl)
#pragma unroll
    for (int half = 0; half < 2; ++half)
#pragma unroll
      for (int rb = 0; rb < NBoxes; ++rb)
        tma_load_2d(dst + (pl * 2 + half) * NBoxes * kHalf64 + rb * kHalf64,
                    map, bar, half * 32, pl * plane_rows + row0 + rb * 64);
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_f32_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                                  const __grid_constant__ CUtensorMap tv,
                                  const __grid_constant__ CUtensorMap tdo,
                                  const BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* v_s = smem;                             // V's planes, 128 keys
  uint8_t* stage_s = smem + 2 * kPlane128;         // [stage]: Q, dO planes
  // [stage][2][64]: LSE·log2e, δ
  float* stats_s = reinterpret_cast<float*>(smem + kDkvStats);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kDkvBars);
  uint64_t* v_full = bars;
  uint64_t* full = bars + 1;                       // [stage]
  uint64_t* empty = full + kStages;                // [stage]

  const int wg = threadIdx.x / 128;
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * p.heads + h;
  const int key0 = blockIdx.x * 128;
  const int n_qtiles = (p.n_q + 63) / 64;

  if (threadIdx.x == 0) {
    mbar_init(v_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      const int heads_all = gridDim.y * gridDim.z;
      mbar_expect_tx(v_full, 2 * kPlane128);
      load_planes<2>(v_s, &tv, v_full, bh * p.nk_pad + key0,
                     heads_all * p.nk_pad);
      for (int i = 0; i < n_qtiles; ++i) {
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        uint8_t* st = stage_s + s * kStage;
        float* stats = stats_s + s * 128;
        const int row = bh * p.nq_pad + i * 64;
        mbar_expect_tx(&full[s], kStage + 2 * 64 * 4);
        load_planes<1>(st, &tq, &full[s], row, heads_all * p.nq_pad);
        load_planes<1>(st + 2 * kPlane64, &tdo, &full[s], row,
                       heads_all * p.nq_pad);
        bulk_load(stats, p.lse2 + row, 64 * 4, &full[s]);
        bulk_load(stats + 64, p.delta + row, 64 * 4, &full[s]);
      }
    }
  } else {
    reg_alloc<232>();
    const int cw = wg - 1;                 // keys key0 + 64·cw ..
    const int ct = threadIdx.x - 128 * wg;
    const int warp = ct >> 5, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3;
    const int krow = key0 + cw * 64 + warp * 16 + g;   // keys krow, krow + 8
    const int a_off = cw * 64 * 128;       // this warpgroup's rows of V
    const float c = p.scale_log2;

    const float* kp = p.k + b * p.k_sb + h * p.k_sh;
    float dk[32], dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(v_full, 0);
    for (int it = 0; it < n_qtiles; ++it) {
      const int s = it % kStages;
      const uint8_t* q_t = stage_s + s * kStage;
      const uint8_t* do_t = q_t + 2 * kPlane64;
      const float* lse_t = stats_s + s * 128;
      const float* dl_t = lse_t + 64;
      mbar_wait(&full[s], (it / kStages) & 1);

      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: 64 keys × 64 queries, depth 64 (the
      // first product overwrites the accumulators).
      uint32_t kb[8][4], ks[8][4];
      load_a_split(kb, ks, kp, p.k_sn, krow, p.n_k, p.d, t);
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        product3_rs<kCorrections>(st, kb[kk], ks[kk],
                                  kmajor(q_t, kHalf64, 0, kk),
                                  kmajor(q_t + kPlane64, kHalf64, 0, kk),
                                  kk > 0);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        product3_ss<kCorrections>(
            dpt, kmajor(v_s, kHalf128, a_off, kk),
            kmajor(v_s + kPlane128, kHalf128, a_off, kk),
            kmajor(do_t, kHalf64, 0, kk),
            kmajor(do_t + kPlane64, kHalf64, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // Accumulator i: query 8·(i/4) + 2t + (i & 1) of the tile.
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 2 * (i & ~3) + 2 * t + (i & 1);
        st[i] = exp2f(fmaf(st[i], c, -lse_t[col]));   // padded row: 0
        dpt[i] = st[i] * (dpt[i] - dl_t[col]);
      }

      // dV += Pᵀ·dO and dK += dSᵀ·Q: depth = the tile's 64 queries.
      mma_acc(dv, st, do_t, g, t);
      mma_acc(dk, dpt, q_t, g, t);
      mbar_arrive(&empty[s]);
    }

    store_rows(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_sn, krow, p.n_k, p.d,
               dk, p.scale, t);
    store_rows(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_sn, krow, p.n_k, p.d,
               dv, 1.f, t);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_f32_sm90_kernel(const __grid_constant__ CUtensorMap tk,
                                 const __grid_constant__ CUtensorMap tv,
                                 const __grid_constant__ CUtensorMap tdo,
                                 const BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* do_s = smem;                            // dO's planes, 128 rows
  uint8_t* stage_s = smem + 2 * kPlane128;         // [stage]: K, V planes
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kDqBars);
  uint64_t* do_full = bars;
  uint64_t* full = bars + 1;                       // [stage]
  uint64_t* empty = full + kStages;                // [stage]

  const int wg = threadIdx.x / 128;
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * p.heads + h;
  const int q0 = blockIdx.x * 128;
  const int n_ktiles = (p.n_k + 63) / 64;

  if (threadIdx.x == 0) {
    mbar_init(do_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      const int heads_all = gridDim.y * gridDim.z;
      mbar_expect_tx(do_full, 2 * kPlane128);
      load_planes<2>(do_s, &tdo, do_full, bh * p.nq_pad + q0,
                     heads_all * p.nq_pad);
      for (int j = 0; j < n_ktiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        uint8_t* st = stage_s + s * kStage;
        const int row = bh * p.nk_pad + j * 64;
        mbar_expect_tx(&full[s], kStage);
        load_planes<1>(st, &tk, &full[s], row, heads_all * p.nk_pad);
        load_planes<1>(st + 2 * kPlane64, &tv, &full[s], row,
                       heads_all * p.nk_pad);
      }
    }
  } else {
    reg_alloc<232>();
    const int cw = wg - 1;                 // queries q0 + 64·cw ..
    const int ct = threadIdx.x - 128 * wg;
    const int warp = ct >> 5, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3;
    const int qrow = q0 + cw * 64 + warp * 16 + g;    // rows qrow, qrow + 8
    const int a_off = cw * 64 * 128;       // this warpgroup's rows of dO
    const float c = p.scale_log2;
    // rows < nq_pad (a multiple of 128): padded rows read +∞ and 0
    const long long stat = (long long)bh * p.nq_pad + qrow;
    const float lse0 = p.lse2[stat], lse1 = p.lse2[stat + 8];
    const float dl0 = p.delta[stat], dl1 = p.delta[stat + 8];

    const float* qp = p.q + b * p.q_sb + h * p.q_sh;
    float dq[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[i] = 0.f;

    mbar_wait(do_full, 0);
    for (int j = 0; j < n_ktiles; ++j) {
      const int s = j % kStages;
      const uint8_t* k_t = stage_s + s * kStage;
      const uint8_t* v_t = k_t + 2 * kPlane64;
      mbar_wait(&full[s], (j / kStages) & 1);

      // S = Q·Kᵀ and dP = dO·Vᵀ: 64 queries × 64 keys, depth 64 (the first
      // product overwrites the accumulators).
      uint32_t qb[8][4], qs[8][4];
      load_a_split(qb, qs, qp, p.q_sn, qrow, p.n_q, p.d, t);
      float sacc[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        product3_rs<kCorrections>(sacc, qb[kk], qs[kk],
                                  kmajor(k_t, kHalf64, 0, kk),
                                  kmajor(k_t + kPlane64, kHalf64, 0, kk),
                                  kk > 0);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        product3_ss<kCorrections>(
            dp, kmajor(do_s, kHalf128, a_off, kk),
            kmajor(do_s + kPlane128, kHalf128, a_off, kk),
            kmajor(v_t, kHalf64, 0, kk),
            kmajor(v_t + kPlane64, kHalf64, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(dp);

      // Accumulator i: key 8·(i/4) + 2t + (i & 1), row qrow + 8·((i/2) & 1).
      const int key0 = j * 64;
      const bool ragged = key0 + 64 > p.n_k;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const bool hi = (i / 2) & 1;
        float pr = exp2f(fmaf(sacc[i], c, -(hi ? lse1 : lse0)));
        if (ragged && key0 + 2 * (i & ~3) + 2 * t + (i & 1) >= p.n_k) pr = 0.f;
        dp[i] = pr * (dp[i] - (hi ? dl1 : dl0));
      }

      // dQ += dS·K: depth = the tile's 64 keys, K's planes read in place.
      mma_acc(dq, dp, k_t, g, t);
      mbar_arrive(&empty[s]);
    }

    store_rows(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_sn, qrow, p.n_q, p.d,
               dq, p.scale, t);
  }
}

int set_smem(const void* kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

// fp32 q, k, v, dO (B, N, H, head_dim), head_dim ≤ 64 a multiple of 4, with
// element strides (s_b, s_n, s_h, 1), each a multiple of 4 and the start
// 16-byte aligned; lse2 = LSE·log2(e) and δ as fp32 (B, H, nq_pad), padded
// with +∞ and 0; nq_pad and nk_pad multiples of 128 at least n_q and n_k;
// `planes` scratch of 2·batch·heads·64·(2·nq_pad + 2·nk_pad) floats,
// 16-byte aligned.  Fills the scratch with the split planes of Q, dO, K
// and V, then writes fp32 dQ, dK, dV.  Returns 0 on success, the first CUDA
// runtime error of the six launches, cudaErrorInvalidValue for another
// head_dim, a scale not > 0 or a bad pad, or 10000 + the CUresult of a
// refused tensor map.
extern "C" int flash_attention_bwd_f32_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse2, const void* delta, void* planes, void* dq, void* dk,
    void* dv, int batch, int n_q, int n_k, int heads, int head_dim,
    int nq_pad, int nk_pad, long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh, long long v_sb,
    long long v_sn, long long v_sh, long long do_sb, long long do_sn,
    long long do_sh, long long dq_sb, long long dq_sn, long long dq_sh,
    long long dk_sb, long long dk_sn, long long dk_sh, long long dv_sb,
    long long dv_sn, long long dv_sh, float scale, void* stream) {
  if (head_dim <= 0 || head_dim > 64 || head_dim % 4 || !(scale > 0.f)
      || n_q <= 0 || n_k <= 0 || nq_pad % 128 || nq_pad < n_q
      || nk_pad % 128 || nk_pad < n_k)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long heads_all = static_cast<long long>(batch) * heads;
  const long long q_plane = heads_all * nq_pad * 64;
  const long long k_plane = heads_all * nk_pad * 64;
  float* q_planes = static_cast<float*>(planes);
  float* do_planes = q_planes + 2 * q_plane;
  float* k_planes = do_planes + 2 * q_plane;
  float* v_planes = k_planes + 2 * k_plane;
  CUtensorMap tq, tdo, tk, tv;
  int err = sm90_host::encode_f32_rows(&tq, q_planes, 64,
                                       2 * heads_all * nq_pad, 64 * 4);
  if (!err)
    err = sm90_host::encode_f32_rows(&tdo, do_planes, 64,
                                     2 * heads_all * nq_pad, 64 * 4);
  if (!err)
    err = sm90_host::encode_f32_rows(&tk, k_planes, 64,
                                     2 * heads_all * nk_pad, 64 * 4);
  if (!err)
    err = sm90_host::encode_f32_rows(&tv, v_planes, 64,
                                     2 * heads_all * nk_pad, 64 * 4);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const struct {
    const void* x;
    float* planes;
    int n, n_pad;
    long long sb, sn, sh, plane;
  } splits[4] = {{q, q_planes, n_q, nq_pad, q_sb, q_sn, q_sh, q_plane},
                 {dout, do_planes, n_q, nq_pad, do_sb, do_sn, do_sh, q_plane},
                 {k, k_planes, n_k, nk_pad, k_sb, k_sn, k_sh, k_plane},
                 {v, v_planes, n_k, nk_pad, v_sb, v_sn, v_sh, k_plane}};
  for (const auto& sp : splits) {
    sm90::tf32_split_planes_kernel<<<dim3(sp.n_pad / 16, static_cast<unsigned>(
                                         heads_all)), 256, 0, s>>>(
        static_cast<const float*>(sp.x), sp.planes, sp.n, sp.n_pad, heads,
        head_dim, sp.sb, sp.sn, sp.sh, sp.plane);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
  }
  BwdParams p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.lse2 = static_cast<const float*>(lse2);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  p.n_q = n_q;
  p.n_k = n_k;
  p.heads = heads;
  p.d = head_dim;
  p.nq_pad = nq_pad;
  p.nk_pad = nk_pad;
  p.q_sb = q_sb; p.q_sn = q_sn; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sn = k_sn; p.k_sh = k_sh;
  p.dq_sb = dq_sb; p.dq_sn = dq_sn; p.dq_sh = dq_sh;
  p.dk_sb = dk_sb; p.dk_sn = dk_sn; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_sn = dv_sn; p.dv_sh = dv_sh;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  err = set_smem(reinterpret_cast<const void*>(flash_bwd_dkv_f32_sm90_kernel),
                 kDkvSmem);
  if (!err)
    err = set_smem(reinterpret_cast<const void*>(flash_bwd_dq_f32_sm90_kernel),
                   kDqSmem);
  if (err) return err;
  flash_bwd_dkv_f32_sm90_kernel<<<dim3(nk_pad / 128, heads, batch), kThreads,
                                  kDkvSmem, s>>>(tq, tv, tdo, p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  flash_bwd_dq_f32_sm90_kernel<<<dim3((n_q + 127) / 128, heads, batch),
                                 kThreads, kDqSmem, s>>>(tk, tv, tdo, p);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory a block of the dK/dV kernel (dq = 0) or of the
// dQ kernel (dq = 1) takes at head_dim (≤ 64, a multiple of 4; 0 for
// another), for the build log.
extern "C" int flash_attention_bwd_f32_sm90_smem(int head_dim, int dq) {
  if (head_dim <= 0 || head_dim > 64 || head_dim % 4) return 0;
  return dq ? kDqSmem : kDkvSmem;
}
