// Flash-attention forward in fp32 for Hopper (sm_90a) on the TF32 tensor
// cores with the 3×TF32 split: non-causal softmax(scale·QKᵀ)·V over
// (B, N, H, d) fp32 tensors, d ≤ 64 a multiple of 4, with an optional
// per-key validity (handed in as a padded 0/−∞ bias row).
//
// Replaces vist3a_tpu/kernels/flash_attention.py's transposed-layout forward
// in fp32: flash_attention(layout="transposed") → _flash_fwd_t →
// _fwd_kernel_t / _fwd_kernel_t_onmax (:187, :245; call :329), and its
// masked form (flash_attention_masked, :756).  The JAX stitching-
// distillation step runs it in fp32: the student's and the teacher's ViT
// blocks and frame attention at (13, 1029, 16, 64), the global attention
// at (1, 13377, 16, 64) for 13 views and (1, 21609, 16, 64) for 21.
//
// What it computes, as the plain version does: the fp32 scores Q·Kᵀ scaled
// in fp32, an online softmax in base 2 with the running max floored at
// −1e30, fp32 accumulators, O in fp32 with the caller's strides, and the
// natural-log LSE in fp32, shape (B, H, N_q).  A dead key adds exactly
// nothing; a row with no live key gives O = 0 and LSE = −1e30·ln 2.
//
// Accuracy: both products run on the TF32 tensor cores as three products
// each (3×TF32): every operand x is split as big = tf32(x) and small =
// tf32(x − big) (`sm90.cuh`), and a·b is a_big·b_big + a_big·b_small +
// a_small·b_big summed in the fp32 accumulators — about fp32's accuracy
// (the dropped a_small·b_small is 2⁻²² of a·b), where one TF32 product
// would keep about three digits and move the LSE by ~1e-4.
//
// What bounds it on an H100 SXM: 4·B·N²·H·d FLOP of fp32-accurate products,
// each three TF32 products at 495 TFLOP/s dense, so 165 TFLOP/s — 7.33e11
// FLOP, 4.44 ms at (1, 13377, 16, 64) and 1.91e12 FLOP, 11.6 ms at
// (1, 21609, 16, 64) — against 0.22 and 0.35 GB of Q, K, V, O and LSE
// (66 and 106 µs): operations.  (The FFMA kernel this replaces had the
// 67 TFLOP/s of the CUDA cores as its ceiling: 10.9 and 28.6 ms.)  The
// design:
//   * the wrapper hands scratch for K's split planes (2, B·H, n_pad, 64) and
//     Vᵀ's (2, B·H, 64, n_pad); the entry fills them first (one pass over K
//     and V each, `tf32_split_planes_kernel` and `tf32_split_planes_t_kernel`
//     below), so the tensor cores read pre-split tiles and the main loop
//     splits only P;
//   * a block owns a 128-row query tile of one (b, h): two consumer
//     warpgroups of 64 rows and a producer warpgroup whose one thread
//     issues TMA loads; setmaxnreg gives the producer 40 registers and the
//     consumers 232.  Each consumer reads its Q rows straight from the
//     caller's q (any strides; L1-resident after the first tile) and splits
//     them into the A fragments of S = Q·Kᵀ (64 registers a thread) anew
//     for every key tile: held in registers across tiles, they were
//     overwritten (ptxas gave the P·V group's A fragments the same
//     registers, a fault seen on the card from the second tile on);
//   * tf32 wgmma has no transpose bits: both shared-memory operands are
//     K-major.  S = Q·Kᵀ reads K's planes as stored ([key][d]); O += P·V
//     reads Vᵀ's ([d][key]), which is why V is transposed by the pass;
//   * 64-key stages of K (big, small) and Vᵀ (big, small), 64 KB, in a
//     two-stage ring on mbarriers (K and V of a stage on barriers of their
//     own), so the next tile's loads run under this tile's products;
//   * each tile's products start from zeroed accumulators, and O sums the
//     tiles' P·V in fp32 FMAs (O·alpha + P·V): the tensor cores' fp32 sums
//     lose low bits at each step, and over the 209 tiles of 13,377 keys O
//     drifted by ~1e-4 of itself, five times its limit;
//   * P leaves the score accumulators as the A fragments of P·V without a
//     shuffle: a thread holds keys 2t and 2t + 1 of each group of eight,
//     where a tf32 A fragment takes keys t and t + 4, so Vᵀ's planes hold
//     each group of eight keys in the order 0, 2, 4, 6, 1, 3, 5, 7 and the
//     fragment's column t is key 2t, column t + 4 key 2t + 1;
//   * masked (`Masked`): the wrapper's `key_bias` row (0 live, −∞ dead and
//     beyond N_k, padded to 128-key tiles) and a byte a 128-key tile; the
//     producer copies each 64-key stage's 256 bytes of bias beside K, on
//     K's barrier, and the consumers add it where the tile's byte is set.
//     Unmasked, the padded keys (zero rows, score 0) are masked to −∞ on
//     the last tile only;
//   * rows beyond N_q are computed and not stored; columns from d are zero
//     in the planes and in the Q fragments, and not stored.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_fwd_f32_sm90.so \
//        flash_attention_fwd_f32_sm90.cu

#include <math.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

// The correction products of each 3×TF32 product: 2 (a_big·b_small and
// a_small·b_big; `sm90.cuh::product3_rs`).
constexpr int kCorrections = 2;

constexpr int kConsumers = 2;          // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kBlockQ = 64 * kConsumers;
constexpr int kBlockK = 64;            // keys a stage
constexpr int kStages = 2;
constexpr int kHalf = 64 * 128;        // 32 columns of a 64-row fp32 tile
constexpr int kPlane = 2 * kHalf;      // one 64 × 64 plane tile
constexpr int kKStage = 2 * kPlane;    // K big, K small
constexpr int kVStage = 2 * kPlane;    // Vᵀ big, Vᵀ small
constexpr int kBias = kStages * (kKStage + kVStage);   // [stage][64] fp32
constexpr int kBars = kBias + kStages * kBlockK * 4;
constexpr int kSmem = kBars + 8 * (3 * kStages) + 1024;
constexpr float kNegBig = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

struct FwdParams {
  const float* q;
  const float* key_bias;  // (≥ n_pad,) 0 / −∞, or null: unmasked
  const uint8_t* tile_masked;  // a byte a 128-key tile
  float* o;
  float* lse;            // (B, H, n_q) contiguous
  int n_q, n_k, heads, d, n_pad;
  long long q_sb, q_sn, q_sh, o_sb, o_sn, o_sh;
  float scale_log2;
};

// o = o·alpha + pv for a score-shaped accumulator (rows of elements
// i % 4 < 2 take alpha0, the others alpha1).
__device__ __forceinline__ void add_tile(float (&o)[32], const float (&pv)[32],
                                         float alpha0, float alpha1) {
#pragma unroll
  for (int i = 0; i < 32; i += 4) {
    o[i] = fmaf(o[i], alpha0, pv[i]);
    o[i + 1] = fmaf(o[i + 1], alpha0, pv[i + 1]);
    o[i + 2] = fmaf(o[i + 2], alpha1, pv[i + 2]);
    o[i + 3] = fmaf(o[i + 3], alpha1, pv[i + 3]);
  }
}

// Vᵀ's split planes: (2, B·H, 64, n_pad), row d of head (b, h) holding
// keys 0 .. n_pad − 1, each group of eight in the order 0, 2, 4, 6, 1, 3,
// 5, 7; keys from N and rows from d are zeros.  A block transposes 64 keys
// of one head through shared memory; grid (n_pad / 64, B·H).
__global__ void __launch_bounds__(256)
    tf32_split_planes_t_kernel(const float* __restrict__ x, float* planes,
                               int n, int n_pad, int heads, int d,
                               long long sb, long long sn, long long sh,
                               long long plane_stride) {
  __shared__ float tile[64][65];
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int n0 = blockIdx.x * 64;
  for (int idx = threadIdx.x; idx < 64 * 16; idx += 256) {
    const int r = idx >> 4, c = (idx & 15) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (n0 + r < n && c < d)
      v = *reinterpret_cast<const float4*>(x + b * sb + (n0 + r) * sn
                                           + h * sh + c);
    tile[r][c] = v.x;
    tile[r][c + 1] = v.y;
    tile[r][c + 2] = v.z;
    tile[r][c + 3] = v.w;
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 64 * 16; idx += 256) {
    const int dr = idx >> 4, c = (idx & 15) * 4;
    float big[4], small[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int np = c + j, w = np & 7;
      const float e = tile[(np & ~7) + (w < 4 ? 2 * w : 2 * (w - 4) + 1)][dr];
      big[j] = tf32_round(e);
      small[j] = tf32_round(e - big[j]);
    }
    float* dst = planes + ((long long)bh * 64 + dr) * n_pad + n0 + c;
    *reinterpret_cast<float4*>(dst) =
        make_float4(big[0], big[1], big[2], big[3]);
    *reinterpret_cast<float4*>(dst + plane_stride) =
        make_float4(small[0], small[1], small[2], small[3]);
  }
}

template <bool Masked>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_f32_sm90_kernel(const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tvt,
                              const FwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* k_s = smem;                                   // [stage]
  uint8_t* v_s = smem + kStages * kKStage;               // [stage]
  float* bias_s = reinterpret_cast<float*>(smem + kBias);  // [stage]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kBars);
  uint64_t* k_full = bars;                               // [stage]
  uint64_t* v_full = k_full + kStages;                   // [stage]
  uint64_t* empty = v_full + kStages;                    // [stage]

  const int wg = threadIdx.x / 128;
  const int h = blockIdx.y, b = blockIdx.z;
  const int bh = b * p.heads + h;
  const int q0 = blockIdx.x * kBlockQ;
  const int n_tiles = (p.n_k + kBlockK - 1) / kBlockK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], kConsumers * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      const int heads_all = gridDim.y * gridDim.z;
      const int k_row = bh * p.n_pad, k_plane = heads_all * p.n_pad;
      const int v_row = bh * 64, v_plane = heads_all * 64;
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        uint8_t* kt = k_s + s * kKStage;
        uint8_t* vt = v_s + s * kVStage;
        mbar_expect_tx(&k_full[s], kKStage + (Masked ? kBlockK * 4 : 0));
#pragma unroll
        for (int pl = 0; pl < 2; ++pl)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            tma_load_2d(kt + pl * kPlane + half * kHalf, &tk, &k_full[s],
                        half * 32, pl * k_plane + k_row + j * kBlockK);
        if constexpr (Masked)
          bulk_load(bias_s + s * kBlockK, p.key_bias + j * kBlockK,
                    kBlockK * 4, &k_full[s]);
        mbar_expect_tx(&v_full[s], kVStage);
#pragma unroll
        for (int pl = 0; pl < 2; ++pl)
#pragma unroll
          for (int half = 0; half < 2; ++half)
            tma_load_2d(vt + pl * kPlane + half * kHalf, &tvt, &v_full[s],
                        j * kBlockK + half * 32, pl * v_plane + v_row);
      }
    }
  } else {
    reg_alloc<232>();
    const int cw = wg - 1;                 // consumer warpgroup: rows 64·cw
    const int ct = threadIdx.x - 128 * wg;
    const int warp = ct >> 5, lane = ct & 31;
    const int g = lane >> 2, t = lane & 3;
    const int row0 = q0 + cw * 64 + warp * 16 + g;   // rows row0, row0 + 8
    const float c = p.scale_log2;

    const float* qp = p.q + b * p.q_sb + h * p.q_sh;

    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float m0 = kNegBig, m1 = kNegBig;  // running max (base 2, scaled)
    float l0 = 0.f, l1 = 0.f;          // this thread's share of the sum

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t ph = (j / kStages) & 1;
      const uint8_t* kt = k_s + s * kKStage;
      const uint8_t* vt = v_s + s * kVStage;

      // Q's A fragments, split anew for every tile (see load_a_split)
      uint32_t qb[8][4], qs[8][4];
      load_a_split(qb, qs, qp, p.q_sn, row0, p.n_q, p.d, t);
      // S = Q·Kᵀ: 64 rows × 64 keys, depth 64 in steps of 8 (the first
      // product overwrites the accumulators).
      float sacc[32];
      mbar_wait(&k_full[s], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t off = (kk / 4) * kHalf + (kk % 4) * 32;
        product3_rs<kCorrections>(sacc, qb[kk], qs[kk],
                                  desc_sw128(kt, off, 0, 1024),
                                  desc_sw128(kt + kPlane, off, 0, 1024),
                                  kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);

      // Accumulator i of a thread: key 8·(i/4) + 2t + (i & 1), row
      // row0 + 8·((i/2) & 1).
      if constexpr (Masked) {
        if (p.tile_masked[j >> 1]) {
          const float* bias = bias_s + s * kBlockK;
#pragma unroll
          for (int i = 0; i < 32; i += 4) {
            const float2 bb =
                *reinterpret_cast<const float2*>(bias + 2 * i + 2 * t);
            sacc[i] += bb.x;
            sacc[i + 1] += bb.y;
            sacc[i + 2] += bb.x;
            sacc[i + 3] += bb.y;
          }
        }
      } else {
        // keys beyond N_k (zero rows) get −∞
        const int key0 = j * kBlockK;
        if (key0 + kBlockK > p.n_k) {
#pragma unroll
          for (int i = 0; i < 32; ++i)
            if (key0 + 8 * (i / 4) + 2 * t + (i & 1) >= p.n_k)
              sacc[i] = -INFINITY;
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        mx0 = fmaxf(mx0, fmaxf(sacc[i], sacc[i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sacc[i + 2], sacc[i + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0 * c), mn1 = fmaxf(m1, mx1 * c);
      const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int i = 0; i < 32; i += 4) {
        sacc[i] = exp2f(fmaf(sacc[i], c, -mn0));      // −∞ → 0
        sacc[i + 1] = exp2f(fmaf(sacc[i + 1], c, -mn0));
        sacc[i + 2] = exp2f(fmaf(sacc[i + 2], c, -mn1));
        sacc[i + 3] = exp2f(fmaf(sacc[i + 3], c, -mn1));
        rs0 += sacc[i] + sacc[i + 1];
        rs1 += sacc[i + 2] + sacc[i + 3];
      }
      l0 = l0 * alpha0 + rs0;
      l1 = l1 * alpha1 + rs1;
      // P as split A fragments: column t of k-step kk is key 8kk + 2t,
      // column t + 4 key 8kk + 2t + 1 (Vᵀ's planes hold the keys so).
      uint32_t pb[8][4], ps[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        tf32_split(sacc[4 * kk], pb[kk][0], ps[kk][0]);
        tf32_split(sacc[4 * kk + 2], pb[kk][1], ps[kk][1]);
        tf32_split(sacc[4 * kk + 1], pb[kk][2], ps[kk][2]);
        tf32_split(sacc[4 * kk + 3], pb[kk][3], ps[kk][3]);
      }

      // This tile's P·V (Vᵀ's planes as the K-major B operand) in fresh
      // accumulators, then O = O·alpha + P·V in fp32: summed on the tensor
      // cores across tiles, O drifts by ~1e-4 of itself over 13,377 keys.
      float pv[32];
      mbar_wait(&v_full[s], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t off = (kk / 4) * kHalf + (kk % 4) * 32;
        product3_rs<kCorrections>(pv, pb[kk], ps[kk],
                                  desc_sw128(vt, off, 0, 1024),
                                  desc_sw128(vt + kPlane, off, 0, 1024),
                                  kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(pv);
      mbar_arrive(&empty[s]);
      add_tile(o, pv, alpha0, alpha1);
    }

    // The four threads of a quad hold partial sums of the same two rows.
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float safe0 = l0 == 0.f ? 1.f : l0;
    const float safe1 = l1 == 0.f ? 1.f : l1;
    const float inv0 = 1.f / safe0, inv1 = 1.f / safe1;
    float* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int i = 0; i < 32; i += 4) {
      const int col = 2 * i + 2 * t;       // 8·(i/4) + 2t
      if (col >= p.d) continue;
      if (row0 < p.n_q)
        *reinterpret_cast<float2*>(ob + row0 * p.o_sn + col) =
            make_float2(o[i] * inv0, o[i + 1] * inv0);
      if (row0 + 8 < p.n_q)
        *reinterpret_cast<float2*>(ob + (row0 + 8) * p.o_sn + col) =
            make_float2(o[i + 2] * inv1, o[i + 3] * inv1);
    }
    if (t == 0) {
      float* lb = p.lse + (long long)bh * p.n_q;
      if (row0 < p.n_q) lb[row0] = (m0 + log2f(safe0)) * kLn2;
      if (row0 + 8 < p.n_q) lb[row0 + 8] = (m1 + log2f(safe1)) * kLn2;
    }
  }
}

template <bool Masked>
int launch(const CUtensorMap& tk, const CUtensorMap& tvt, const FwdParams& p,
           int batch, cudaStream_t stream) {
  const auto kernel = flash_fwd_f32_sm90_kernel<Masked>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((p.n_q + kBlockQ - 1) / kBlockQ, p.heads, batch);
  kernel<<<grid, kThreads, kSmem, stream>>>(tk, tvt, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fp32 q, k, v (B, N, H, head_dim), head_dim ≤ 64 a multiple of 4, with
// element strides (s_b, s_n, s_h, 1), each a multiple of 4 and the start
// 16-byte aligned; key_bias null (unmasked) or an fp32 row of 0 (live key)
// and −∞ (dead key, and every key from n_k on) over at least n_pad keys,
// 16-byte aligned, with tile_masked a byte for each 128-key tile, 1 where
// its bias holds a −∞ (null when key_bias is); k_planes and vt_planes
// scratch of 2·batch·heads·64·n_pad floats each, n_pad a multiple of 64 at
// least n_k, 16-byte aligned.  Fills the scratch with K's and Vᵀ's split
// planes, then writes fp32 o and the LSE (B, H, n_q).  Returns 0 on
// success, the first CUDA runtime error of the three launches,
// cudaErrorInvalidValue for another head_dim, a scale not > 0, a bad n_pad
// or only one of key_bias and tile_masked, or 10000 + the CUresult of a
// refused tensor map.
extern "C" int flash_attention_fwd_f32_sm90(
    const void* q, const void* k, const void* v, const void* key_bias,
    const void* tile_masked, void* k_planes, void* vt_planes, void* o,
    void* lse, int batch, int n_q, int n_k, int heads, int head_dim,
    int n_pad, long long q_sb, long long q_sn, long long q_sh,
    long long k_sb, long long k_sn, long long k_sh, long long v_sb,
    long long v_sn, long long v_sh, long long o_sb, long long o_sn,
    long long o_sh, float scale, void* stream) {
  if (head_dim <= 0 || head_dim > 64 || head_dim % 4 || !(scale > 0.f)
      || n_q <= 0 || n_k <= 0 || n_pad % 64 || n_pad < n_k
      || (key_bias == nullptr) != (tile_masked == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long heads_all = static_cast<long long>(batch) * heads;
  const long long plane = heads_all * 64 * n_pad;
  CUtensorMap tk, tvt;
  int err = sm90_host::encode_f32_rows(&tk, k_planes, 64, 2 * heads_all * n_pad,
                                       64 * 4);
  if (!err)
    err = sm90_host::encode_f32_rows(&tvt, vt_planes, n_pad,
                                     2 * heads_all * 64, n_pad * 4LL);
  if (err) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 bh_grid(n_pad / 16, static_cast<unsigned>(heads_all));
  sm90::tf32_split_planes_kernel<<<bh_grid, 256, 0, s>>>(
      static_cast<const float*>(k), static_cast<float*>(k_planes), n_k, n_pad,
      heads, head_dim, k_sb, k_sn, k_sh, plane);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  tf32_split_planes_t_kernel<<<dim3(n_pad / 64, static_cast<unsigned>(
                                   heads_all)), 256, 0, s>>>(
      static_cast<const float*>(v), static_cast<float*>(vt_planes), n_k,
      n_pad, heads, head_dim, v_sb, v_sn, v_sh, plane);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  FwdParams p;
  p.q = static_cast<const float*>(q);
  p.key_bias = static_cast<const float*>(key_bias);
  p.tile_masked = static_cast<const uint8_t*>(tile_masked);
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.n_q = n_q;
  p.n_k = n_k;
  p.heads = heads;
  p.d = head_dim;
  p.n_pad = n_pad;
  p.q_sb = q_sb; p.q_sn = q_sn; p.q_sh = q_sh;
  p.o_sb = o_sb; p.o_sn = o_sn; p.o_sh = o_sh;
  p.scale_log2 = scale * kLog2e;
  return key_bias != nullptr ? launch<true>(tk, tvt, p, batch, s)
                             : launch<false>(tk, tvt, p, batch, s);
}

// The dynamic shared memory a block of the forward takes at head_dim (≤ 64,
// a multiple of 4; 0 for another), for the build log.
extern "C" int flash_attention_fwd_f32_sm90_smem(int head_dim) {
  return head_dim > 0 && head_dim <= 64 && head_dim % 4 == 0 ? kSmem : 0;
}
