// Flash-attention backward for Hopper (sm_90a) on wgmma and TMA: dQ, dK and
// dV of non-causal O = softmax(scale·QKᵀ)·V over (B, N, H, D) bf16, D = 64
// or 128.
//
// Replaces the two layouts' VJPs in vist3a_tpu/kernels/flash_attention.py,
// each two pallas_calls, for their bf16 calls at head_dim 64 and 128:
//   * the natural layout's _flash_bwd → _flash_bwd_impl, _dq_kernel (:571,
//     call :696) and _dkv_kernel (:608, call :716) — the Wan DiT's
//     self-attention in the VDM step, (1, 4096, 12, 128) in the SFT branch
//     and (6, 4096, 12, 128) in the rollout's re-evaluation;
//   * the transposed layout's _flash_core_t VJP, _dq_kernel_t (:397, call
//     :530) and _dkv_kernel_t (:429, call :546) in bf16 (kernel 4b) — the
//     stitched decoder's attention in the VDM step's reward branch,
//     (13, 1029, 16, 64) for the ViT blocks and frame attention and
//     (1, 13377, 16, 64) for the global attention, 56 calls a step.
// flash_attention_bwd.cu keeps fp32 and the other bf16 head dims.
//
// What it computes, as flash_attention_bwd.cu's bf16 kernels do, from the
// forward's q, k, v, LSE and dO, with δ = rowsum(dO∘O) taken outside:
//   P  = exp2(s·scale·log2e − LSE·log2e)   (LSE·log2e handed in, see below)
//   dV = Pᵀ·dO,   dS = P∘(dO·Vᵀ − δ),   dQ = scale·dS·K,   dK = scale·dSᵀ·Q,
// with P and dS rounded to bf16 before the products that take them, fp32
// accumulators, and dQ, dK, dV stored in bf16.  Two kernels and no atomics,
// like the two pallas_calls, so two runs give the same bits.
//
// What bounds it on an H100 SXM: the products, charged as 10·B·N²·H·D FLOP
// (four products of 2·N²·D and the recomputed S) at 989 TFLOP/s — 1.55e12,
// 1.56 ms at (6, 4096, 12, 128), and 1.83e12, 1.85 ms at (1, 13377, 16, 64)
// — against 0.15 and 0.16 GB (45 and 49 µs).  This design does seven
// products a tile pair (S and dP in both kernels), 1.4× that; at D = 64 the
// exp2 of P weighs twice as much against the products as at D = 128.
//   * dK/dV kernel, keys as the M dimension: a block owns a 128-key tile as
//     two consumer warpgroups of 64 keys (plus a producer warpgroup, as in
//     the forward), with K and V resident and 64-query tiles of Q and dO,
//     and the LSE and δ of those rows, in a ring of stages, loaded by TMA.
//     Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ are wgmma m64n64k16 with both operands in
//     shared memory, K-major, D / 16 steps deep; Pᵀ and dSᵀ = Pᵀ∘(dPᵀ − δ)
//     are formed in registers and re-packed to bf16 A fragments; dV += Pᵀ·dO
//     and dK += dSᵀ·Q are wgmma m64nDk16 with A from registers and B (dO, Q)
//     read through the transpose-B bit: no transposed tile is built.  The
//     dK and dV accumulators are D / 2 + D / 2 fp32 registers a consumer
//     thread.
//   * dQ kernel: a block owns a 128-query tile (two warpgroups of 64) with
//     Q and dO resident and loops over 128-key tiles of K and V in a ring
//     of stages: S = Q·Kᵀ and dP = dO·Vᵀ from shared memory, then
//     dQ += dS·K with dS from registers and K through the transpose-B bit.
//   * Ragged edges: rows beyond N arrive from TMA as zeros.  The wrapper
//     pads LSE·log2e with +∞ and δ with 0 to a multiple of 128 rows, so a
//     padded query row has P = 0 and dS = 0 in both kernels; padded keys
//     are masked to P = 0 in the dQ kernel and are never stored by the dK/dV
//     kernel.  Rows beyond N are not written.
// At D = 64 a third stage in either ring, 128-query stages in the dK/dV
// kernel (m64n128 products for Sᵀ and dPᵀ) and an exp2 that flushes
// subnormals were each measured no faster on the card (PERF.md §6).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_bwd_sm90.so \
//        flash_attention_bwd_sm90.cu

#include <math.h>

#include "sm90.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 384;          // producer warpgroup + 2 consumers
constexpr int kStages = 2;             // of either kernel's ring
constexpr int kBoxBytes = 64 * 64 * 2;  // one TMA box: 64 rows × 64 columns
constexpr int kHalf128 = 128 * 128;     // 64 columns of a 128-row tile
constexpr int kHalf64 = 64 * 128;       // 64 columns of a 64-row tile
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory at head dim D.
template <int D>
struct BwdLayout {
  static constexpr int kHalves = D / 64;
  static constexpr int kTile128 = 128 * D * 2;   // [half][row][64]
  static constexpr int kTile64 = 64 * D * 2;
  // dK/dV kernel: K, V resident; per stage Q, dO (64 rows), LSE·log2e, δ
  static constexpr int kDkvStage = 2 * kTile64;
  static constexpr int kDkvStats = 2 * kTile128 + kStages * kDkvStage;
  static constexpr int kDkvBars = kDkvStats + kStages * 2 * 64 * 4;
  static constexpr int kDkvSmem = kDkvBars + 8 * (1 + 2 * kStages) + 1024;
  // dQ kernel: Q, dO resident (128 rows); per stage K, V (128 rows)
  static constexpr int kDqStage = 2 * kTile128;
  static constexpr int kDqBars = 2 * kTile128 + kStages * kDqStage;
  static constexpr int kDqSmem = kDqBars + 8 * (1 + 2 * kStages) + 1024;
};

struct BwdParams {
  const float* lse2;     // (B, H, n_q_pad): LSE·log2e, +∞ beyond n_q
  const float* delta;    // (B, H, n_q_pad): rowsum(dO∘O), 0 beyond n_q
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int n_q, n_k, heads, n_q_pad;
  long long dq_sb, dq_sn, dq_sh;
  long long dk_sb, dk_sn, dk_sh;
  long long dv_sb, dv_sn, dv_sh;
  float scale, scale_log2;
};

// Rows row0 .. row0 + 64·NBoxes − 1 of head h, batch b, every 64-column
// half; the halves lie 64·NBoxes rows apart.
template <int NHalves, int NBoxes>
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row0, int h,
                                          int b) {
#pragma unroll
  for (int half = 0; half < NHalves; ++half)
#pragma unroll
    for (int rb = 0; rb < NBoxes; ++rb)
      tma_load_4d(dst + half * NBoxes * kBoxBytes + rb * kBoxBytes, map, bar,
                  half * 64, row0 + rb * 64, h, b);
}

// Stores a 64 × N fp32 accumulator (rows row0 + 16·warp + g (+8)) times
// `mul` as bf16, rows < n_rows.
template <int NAcc>
__device__ __forceinline__ void store_rows(bf16* base, long long stride_n,
                                           int row, int n_rows,
                                           const float (&acc)[NAcc],
                                           float mul, int t) {
#pragma unroll
  for (int i = 0; i < NAcc; i += 4) {
    const int col = 2 * i + 2 * t;
    if (row < n_rows)
      *reinterpret_cast<uint32_t*>(base + row * stride_n + col) =
          pack_bf16(acc[i] * mul, acc[i + 1] * mul);
    if (row + 8 < n_rows)
      *reinterpret_cast<uint32_t*>(base + (row + 8) * stride_n + col) =
          pack_bf16(acc[i + 2] * mul, acc[i + 3] * mul);
  }
}

// K-major operand: 16-deep slice kk of the rows at byte `row_off` of a tile
// whose halves are `half_bytes` apart.
__device__ __forceinline__ uint64_t kmajor(const uint8_t* tile, int half_bytes,
                                           int row_off, int kk) {
  return desc_sw128(tile, (kk / 4) * half_bytes + row_off + (kk % 4) * 32, 0,
                    1024);
}

// MN-major operand (trans-b): rows 16kk .. 16kk + 15 as the product's depth.
__device__ __forceinline__ uint64_t mnmajor(const uint8_t* tile, int half_bytes,
                                            int kk) {
  return desc_sw128(tile, kk * 2048, half_bytes, 1024);
}

// Packs accumulator blocks 2kk, 2kk + 1 (16 columns) into A fragments.
template <int KS>
__device__ __forceinline__ void repack(uint32_t (&f)[KS][4],
                                       const float (&x)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    f[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);
    f[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    f[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    f[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const __grid_constant__ CUtensorMap tdo,
                              const BwdParams p) {
  using L = BwdLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + L::kTile128;
  uint8_t* stage_s = smem + 2 * L::kTile128;       // [stage]: Q, dO
  // [stage][2][64]: LSE·log2e, δ
  float* stats_s = reinterpret_cast<float*>(smem + L::kDkvStats);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kDkvBars);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;                       // [stage]
  uint64_t* empty = full + kStages;                // [stage]

  const int wg = threadIdx.x / 128;
  const int h = blockIdx.y, b = blockIdx.z;
  const int key0 = blockIdx.x * 128;
  const int n_qtiles = (p.n_q + 63) / 64;
  const long long bh = (long long)b * p.heads + h;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
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
      mbar_expect_tx(kv_full, 2 * L::kTile128);
      load_rows<L::kHalves, 2>(k_s, &tk, kv_full, key0, h, b);
      load_rows<L::kHalves, 2>(v_s, &tv, kv_full, key0, h, b);
      for (int i = 0; i < n_qtiles; ++i) {
        const int s = i % kStages;
        mbar_wait(&empty[s], ((i / kStages) & 1) ^ 1);
        uint8_t* st = stage_s + s * L::kDkvStage;
        float* stats = stats_s + s * 128;
        mbar_expect_tx(&full[s], L::kDkvStage + 2 * 64 * 4);
        load_rows<L::kHalves, 1>(st, &tq, &full[s], i * 64, h, b);
        load_rows<L::kHalves, 1>(st + L::kTile64, &tdo, &full[s], i * 64, h,
                                 b);
        bulk_load(stats, p.lse2 + bh * p.n_q_pad + i * 64, 64 * 4, &full[s]);
        bulk_load(stats + 64, p.delta + bh * p.n_q_pad + i * 64, 64 * 4,
                  &full[s]);
      }
    }
  } else {
    reg_alloc<232>();
    const int cw = wg - 1;                 // keys key0 + 64·cw ..
    const int ct = threadIdx.x - 128 * wg;
    const int warp = ct >> 5, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3;
    const int krow = key0 + cw * 64 + warp * 16 + g;   // keys krow, krow + 8
    const int a_off = cw * 64 * 128;       // this warpgroup's rows of K, V
    const float c = p.scale_log2;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_qtiles; ++it) {
      const int s = it % kStages;
      const uint8_t* q_t = stage_s + s * L::kDkvStage;
      const uint8_t* do_t = q_t + L::kTile64;
      const float* lse_t = stats_s + s * 128;
      const float* dl_t = lse_t + 64;
      mbar_wait(&full[s], (it / kStages) & 1);

      // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ: 64 keys × 64 queries, depth D (the first
      // step overwrites the accumulators).
      float st[32], dpt[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(st, kmajor(k_s, kHalf128, a_off, kk),
                     kmajor(q_t, kHalf64, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(dpt, kmajor(v_s, kHalf128, a_off, kk),
                     kmajor(do_t, kHalf64, 0, kk), kk > 0);
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
      uint32_t pf[4][4], dsf[4][4];
      repack<4>(pf, st);
      repack<4>(dsf, dpt);

      // dV += Pᵀ·dO and dK += dSᵀ·Q: depth = the tile's 64 queries.
      wgmma_fence();
      fence_regs(dv);
      fence_regs(dk);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dv, pf[kk], mnmajor(do_t, kHalf64, kk), 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(dk, dsf[kk], mnmajor(q_t, kHalf64, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      mbar_arrive(&empty[s]);
    }

    store_rows(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_sn, krow, p.n_k, dk,
               p.scale, t);
    store_rows(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_sn, krow, p.n_k, dv,
               1.f, t);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tdo,
                             const BwdParams p) {
  using L = BwdLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;
  uint8_t* do_s = smem + L::kTile128;
  uint8_t* stage_s = smem + 2 * L::kTile128;       // [stage]: K, V
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kDqBars);
  uint64_t* qdo_full = bars;
  uint64_t* full = bars + 1;                       // [stage]
  uint64_t* empty = full + kStages;                // [stage]

  const int wg = threadIdx.x / 128;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * 128;
  const int n_ktiles = (p.n_k + 127) / 128;
  const long long bh = (long long)b * p.heads + h;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
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
      mbar_expect_tx(qdo_full, 2 * L::kTile128);
      load_rows<L::kHalves, 2>(q_s, &tq, qdo_full, q0, h, b);
      load_rows<L::kHalves, 2>(do_s, &tdo, qdo_full, q0, h, b);
      for (int j = 0; j < n_ktiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        uint8_t* st = stage_s + s * L::kDqStage;
        mbar_expect_tx(&full[s], L::kDqStage);
        load_rows<L::kHalves, 2>(st, &tk, &full[s], j * 128, h, b);
        load_rows<L::kHalves, 2>(st + L::kTile128, &tv, &full[s], j * 128, h,
                                 b);
      }
    }
  } else {
    reg_alloc<232>();
    const int cw = wg - 1;                 // queries q0 + 64·cw ..
    const int ct = threadIdx.x - 128 * wg;
    const int warp = ct >> 5, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3;
    const int qrow = q0 + cw * 64 + warp * 16 + g;    // rows qrow, qrow + 8
    const int a_off = cw * 64 * 128;
    const float c = p.scale_log2;
    // rows < n_q_pad (a multiple of 128): padded rows read +∞ and 0
    const float lse0 = p.lse2[bh * p.n_q_pad + qrow];
    const float lse1 = p.lse2[bh * p.n_q_pad + qrow + 8];
    const float dl0 = p.delta[bh * p.n_q_pad + qrow];
    const float dl1 = p.delta[bh * p.n_q_pad + qrow + 8];

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    mbar_wait(qdo_full, 0);
    for (int j = 0; j < n_ktiles; ++j) {
      const int s = j % kStages;
      const uint8_t* k_t = stage_s + s * L::kDqStage;
      const uint8_t* v_t = k_t + L::kTile128;
      mbar_wait(&full[s], (j / kStages) & 1);

      // S = Q·Kᵀ and dP = dO·Vᵀ: 64 queries × 128 keys, depth D (the
      // first step overwrites the accumulators).
      float sacc[64], dp[64];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n128(sacc, kmajor(q_s, kHalf128, a_off, kk),
                      kmajor(k_t, kHalf128, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n128(dp, kmajor(do_s, kHalf128, a_off, kk),
                      kmajor(v_t, kHalf128, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      fence_regs(dp);

      // Accumulator i: key 8·(i/4) + 2t + (i & 1), row qrow + 8·((i/2) & 1).
      const int key0 = j * 128;
      const bool ragged = key0 + 128 > p.n_k;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const bool hi = (i / 2) & 1;
        float pr = exp2f(fmaf(sacc[i], c, -(hi ? lse1 : lse0)));
        if (ragged && key0 + 2 * (i & ~3) + 2 * t + (i & 1) >= p.n_k) pr = 0.f;
        dp[i] = pr * (dp[i] - (hi ? dl1 : dl0));
      }
      uint32_t dsf[8][4];
      repack<8>(dsf, dp);

      // dQ += dS·K: depth = the tile's 128 keys, K read MN-major.
      wgmma_fence();
      fence_regs(dq);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs(dq, dsf[kk], mnmajor(k_t, kHalf128, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      mbar_arrive(&empty[s]);
    }

    store_rows(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_sn, qrow, p.n_q, dq,
               p.scale, t);
  }
}

int set_smem(const void* kernel, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

template <int D>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, const CUtensorMap& tdo, const BwdParams& p,
           int batch, cudaStream_t s) {
  using L = BwdLayout<D>;
  const auto dkv = flash_bwd_dkv_sm90_kernel<D>;
  const auto dq = flash_bwd_dq_sm90_kernel<D>;
  int err = set_smem(reinterpret_cast<const void*>(dkv), L::kDkvSmem);
  if (!err) err = set_smem(reinterpret_cast<const void*>(dq), L::kDqSmem);
  if (err) return err;
  dkv<<<dim3((p.n_k + 127) / 128, p.heads, batch), kThreads, L::kDkvSmem,
        s>>>(tq, tk, tv, tdo, p);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  dq<<<dim3((p.n_q + 127) / 128, p.heads, batch), kThreads, L::kDqSmem,
       s>>>(tq, tk, tv, tdo, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v, dO (B, N, H, D), D = 64 or 128, with element strides (s_b,
// s_n, s_h, 1), each a multiple of 8 and the start 16-byte aligned; lse2 =
// LSE·log2(e) and δ as fp32 (B, H, n_q_pad), n_q_pad a multiple of 128 at
// least n_q, padded with +∞ and 0; writes bf16 dQ, dK, dV.  Returns 0 on
// success, the first CUDA runtime error of the two launches,
// cudaErrorInvalidValue for another head_dim, a scale not > 0 or a bad
// n_q_pad, or 10000 + the CUresult of a refused tensor map.
extern "C" int flash_attention_bwd_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse2, const void* delta, void* dq, void* dk, void* dv,
    int batch, int n_q, int n_k, int heads, int head_dim, int n_q_pad,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn,
    long long v_sh, long long do_sb, long long do_sn, long long do_sh,
    long long dq_sb, long long dq_sn, long long dq_sh, long long dk_sb,
    long long dk_sn, long long dk_sh, long long dv_sb, long long dv_sn,
    long long dv_sh, float scale, void* stream) {
  if ((head_dim != 64 && head_dim != 128) || !(scale > 0.f) || n_q <= 0
      || n_k <= 0 || n_q_pad % 128 || n_q_pad < n_q)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv, tdo;
  int err = sm90_host::encode_bnhd(&tq, q, batch, n_q, heads, head_dim, q_sb,
                                   q_sn, q_sh, 64);
  if (!err)
    err = sm90_host::encode_bnhd(&tk, k, batch, n_k, heads, head_dim, k_sb,
                                 k_sn, k_sh, 64);
  if (!err)
    err = sm90_host::encode_bnhd(&tv, v, batch, n_k, heads, head_dim, v_sb,
                                 v_sn, v_sh, 64);
  if (!err)
    err = sm90_host::encode_bnhd(&tdo, dout, batch, n_q, heads, head_dim,
                                 do_sb, do_sn, do_sh, 64);
  if (err) return err;
  BwdParams p;
  p.lse2 = static_cast<const float*>(lse2);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.n_q = n_q;
  p.n_k = n_k;
  p.heads = heads;
  p.n_q_pad = n_q_pad;
  p.dq_sb = dq_sb; p.dq_sn = dq_sn; p.dq_sh = dq_sh;
  p.dk_sb = dk_sb; p.dk_sn = dk_sn; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_sn = dv_sn; p.dv_sh = dv_sh;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return head_dim == 64 ? launch<64>(tq, tk, tv, tdo, p, batch, s)
                        : launch<128>(tq, tk, tv, tdo, p, batch, s);
}

// The dynamic shared memory a block of the dK/dV kernel (dq = 0) or of the
// dQ kernel (dq = 1) takes at head_dim (64 or 128; 0 for another), for the
// build log.
extern "C" int flash_attention_bwd_sm90_smem(int head_dim, int dq) {
  if (head_dim == 64)
    return dq ? BwdLayout<64>::kDqSmem : BwdLayout<64>::kDkvSmem;
  if (head_dim == 128)
    return dq ? BwdLayout<128>::kDqSmem : BwdLayout<128>::kDkvSmem;
  return 0;
}
