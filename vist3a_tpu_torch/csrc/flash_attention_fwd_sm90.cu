// Flash-attention forward for Hopper (sm_90a) on wgmma and TMA: non-causal
// softmax(scale·QKᵀ)·V over (B, N, H, D) bf16 tensors, D = 64 or 128, with
// an optional per-key validity (handed in as a padded 0/−∞ bias row).
//
// Replaces three Pallas entries of vist3a_tpu/kernels/flash_attention.py,
// all their bf16 calls at head_dim 64 and 128:
//   * flash_attention(layout="natural") → _flash_fwd → _fwd_kernel (:78,
//     pallas_call :142), which the JAX package runs for an unmasked call
//     with head_dim 128 — the Wan DiT's self-attention, 1500 launches of
//     (2, 4096, 12, 128) in a text→3DGS request;
//   * flash_attention(layout="transposed") → _flash_fwd_t → _fwd_kernel_t /
//     _fwd_kernel_t_onmax (:187, :245; call :329), unmasked at head_dim 64
//     — the stitched decoder's ViT blocks (13, 1029, 16, 64) and, in the
//     VDM step, its frame and global attention;
//   * flash_attention_masked (:756) → _flash_fwd_t(kv_bias=…), the same with
//     a key-validity row — every inference request's frame (13, 1040, 16,
//     64) and global (1, 13520, 16, 64) attention, whose 11 dead keys end
//     each 1,040-key frame, so dead keys sit inside tiles.
// The mma.sync kernel of flash_attention_fwd.cu keeps the other head dims
// (40, 72-120) and fp32.
//
// What it computes, as that kernel and the plain version do: the fp32
// scores Q·Kᵀ scaled in fp32 (not q pre-scaled in bf16), an online softmax
// in base 2 with the running max floored at −1e30, P rounded to bf16 before
// the P·V product, fp32 accumulators, O stored in bf16 with the caller's
// strides, and the natural-log LSE in fp32, shape (B, H, N_q).  A dead key
// adds exactly nothing (its score is −∞, so P = 0); a row with no live key
// gives O = 0 and LSE = −1e30·ln 2 (the `safe_l` rule).
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): the
// products, 4·B·N²·H·D FLOP — 2.06e11 at (2, 4096, 12, 128), 0.208 ms, and
// 7.4e11 at the global (1, 13520, 16, 64), 0.749 ms — against 101 and 111 MB
// of Q, K, V, O and LSE (30 and 33 µs).  At D = 64 the softmax weighs twice
// as much against the products (one exp2 per 2·D FLOP of the two products):
// a 64 × 128 score tile takes the SM's exp2 units about as long as its two
// products take the tensor cores.  The design (FA3's shape):
//   * a block owns a 128-row query tile of one (b, h): two consumer
//     warpgroups of 64 rows each and one producer warpgroup, of which one
//     thread issues the loads; the producer gives registers back with
//     setmaxnreg (40), the consumers take them (232);
//   * Q, K and V arrive through TMA from 4-D tensor maps (d, n, h, b) built
//     from the tensors' own strides, so strided views (the DiT's and the
//     stitched decoder's q, k, v are views into a fused qkv) are read in
//     place; a row is D / 64 boxes of 64 columns with the 128-byte swizzle
//     that wgmma descriptors read; rows beyond N arrive as zeros;
//   * K and V tiles of 128 keys sit in a ring of stages on mbarriers (K and
//     V of a stage on barriers of their own), so the loads of the next tiles
//     run under the products of this one;
//   * S = Q·Kᵀ is wgmma m64n128k16 with both operands in shared memory,
//     K-major; O += P·V takes P from registers (the score accumulators
//     re-packed to bf16 A fragments, which have the same layout) and V from
//     shared memory with the transpose-B bit (m64nDk16), so no transposed
//     tile exists;
//   * masked (`Masked`): the wrapper hands the key validity as an fp32 row
//     of 0 (live) and −∞ (dead, and every key beyond N_k), padded to whole
//     128-key tiles, and a byte a tile that says whether the tile holds a
//     dead key; the producer copies a tile's 512 bytes of bias into the
//     stage beside K, on K's barrier, and the consumers add it to the
//     scores of the tiles whose byte is set — in the global attention 13
//     of 106 tiles, in the frame attention the last of 9 — so a tile of
//     live keys costs what it costs unmasked.  Unmasked, keys beyond N_k
//     (zeros from TMA, score 0, not −∞) are masked to −∞ on the last tile
//     only, and no bias is read;
//   * rows beyond N_q are computed and not stored.
// At D = 64, where shared memory and registers would allow more, three
// consumer warpgroups, four stages and an exp2 that flushes subnormals
// were each measured no faster on the card (PERF.md §6).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_fwd_sm90.so \
//        flash_attention_fwd_sm90.cu

#include <math.h>

#include "sm90.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;         // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (1 + kConsumers);   // + the producer
constexpr int kBlockQ = 64 * kConsumers;
constexpr int kBlockK = 128;          // keys per K / V tile (and bias row)
constexpr int kStages = 2;
constexpr int kBoxBytes = 64 * 64 * 2;           // one TMA box, 64 × 64
constexpr int kQHalf = kBlockQ * 128;            // 64 columns of a Q tile
constexpr int kKVHalf = kBlockK * 128;           // 64 columns of a K/V tile
constexpr float kNegBig = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory at head dim D: Q, the K and V ring, the ring's bias rows,
// the barriers.
template <int D>
struct FwdLayout {
  static constexpr int kHalves = D / 64;
  static constexpr int kQBytes = kHalves * kQHalf;
  static constexpr int kKVBytes = kHalves * kKVHalf;
  static constexpr int kTiles = kQBytes + 2 * kStages * kKVBytes;
  static constexpr int kBias = kTiles;                // [stage][kBlockK] fp32
  static constexpr int kBars = kBias + kStages * kBlockK * 4;
  static constexpr int kSmem = kBars + 8 * (1 + 3 * kStages) + 1024;
};

struct FwdParams {
  const float* key_bias;  // (n_tiles · kBlockK,) 0 / −∞, or null: unmasked
  const uint8_t* tile_masked;  // (n_tiles,): 1 where the tile has −∞ bias
  bf16* o;
  float* lse;            // (B, H, n_q) contiguous
  int n_q, n_k, heads;
  long long o_sb, o_sn, o_sh;
  float scale_log2;      // softmax scale · log2(e), > 0
};

// Rows row0 .. row0 + 64·NBoxes − 1 of head h, batch b, every 64-column
// half; the halves lie `half_bytes` apart.
template <int NHalves, int NBoxes>
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int half_bytes,
                                          int row0, int h, int b) {
#pragma unroll
  for (int half = 0; half < NHalves; ++half)
#pragma unroll
    for (int rb = 0; rb < NBoxes; ++rb)
      tma_load_4d(dst + half * half_bytes + rb * kBoxBytes, map, bar,
                  half * 64, row0 + rb * 64, h, b);
}

template <int D, bool Masked>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const FwdParams p) {
  using L = FwdLayout<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;
  uint8_t* k_s = smem + L::kQBytes;                      // [stage]
  uint8_t* v_s = k_s + kStages * L::kKVBytes;            // [stage]
  float* bias_s = reinterpret_cast<float*>(smem + L::kBias);  // [stage]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;                           // [stage]
  uint64_t* v_full = k_full + kStages;                   // [stage]
  uint64_t* empty = v_full + kStages;                    // [stage]

  const int wg = threadIdx.x / 128;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * kBlockQ;
  const int n_tiles = (p.n_k + kBlockK - 1) / kBlockK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
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
      mbar_expect_tx(q_full, L::kQBytes);
      load_rows<L::kHalves, kConsumers>(q_s, &tq, q_full, kQHalf, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], L::kKVBytes + (Masked ? kBlockK * 4 : 0));
        load_rows<L::kHalves, 2>(k_s + s * L::kKVBytes, &tk, &k_full[s],
                                 kKVHalf, j * kBlockK, h, b);
        if constexpr (Masked)
          bulk_load(bias_s + s * kBlockK, p.key_bias + j * kBlockK,
                    kBlockK * 4, &k_full[s]);
        mbar_expect_tx(&v_full[s], L::kKVBytes);
        load_rows<L::kHalves, 2>(v_s + s * L::kKVBytes, &tv, &v_full[s],
                                 kKVHalf, j * kBlockK, h, b);
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

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = kNegBig, m1 = kNegBig;  // running max (base 2, scaled)
    float l0 = 0.f, l1 = 0.f;          // this thread's share of the sum

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t ph = (j / kStages) & 1;
      const uint8_t* kt = k_s + s * L::kKVBytes;
      const uint8_t* vt = v_s + s * L::kKVBytes;

      // S = Q·Kᵀ: 64 rows × 128 keys, depth D in steps of 16 (the first
      // overwrites the accumulators, so they need no initial value).
      float sacc[64];
      mbar_wait(&k_full[s], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;
        wgmma_ss_n128(sacc,
                      desc_sw128(q_s, (kk / 4) * kQHalf + cw * 64 * 128
                                 + col, 0, 1024),
                      desc_sw128(kt, (kk / 4) * kKVHalf + col, 0, 1024),
                      kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);

      // Accumulator i of a thread: key 8·(i/4) + 2t + (i & 1), row
      // row0 + 8·((i/2) & 1).
      if constexpr (Masked) {
        // the tile's bias, where it has a dead key: 0 for a live key, −∞
        // for a dead one or one beyond N_k
        if (p.tile_masked[j]) {
          const float* bias = bias_s + s * kBlockK;
#pragma unroll
          for (int i = 0; i < 64; i += 4) {
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
          for (int i = 0; i < 64; ++i)
            if (key0 + 8 * (i / 4) + 2 * t + (i & 1) >= p.n_k)
              sacc[i] = -INFINITY;
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int i = 0; i < 64; i += 4) {
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
      for (int i = 0; i < 64; i += 4) {
        sacc[i] = exp2f(fmaf(sacc[i], c, -mn0));      // −∞ → 0
        sacc[i + 1] = exp2f(fmaf(sacc[i + 1], c, -mn0));
        sacc[i + 2] = exp2f(fmaf(sacc[i + 2], c, -mn1));
        sacc[i + 3] = exp2f(fmaf(sacc[i + 3], c, -mn1));
        rs0 += sacc[i] + sacc[i + 1];
        rs1 += sacc[i + 2] + sacc[i + 3];
      }
      l0 = l0 * alpha0 + rs0;
      l1 = l1 * alpha1 + rs1;
#pragma unroll
      for (int i = 0; i < D / 2; i += 4) {
        o[i] *= alpha0;
        o[i + 1] *= alpha0;
        o[i + 2] *= alpha1;
        o[i + 3] *= alpha1;
      }
      // P as bf16 A fragments: keys [16kk, 16kk + 16) are the accumulators
      // of n8 blocks 2kk and 2kk + 1.
      uint32_t pf[8][4];
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pf[kk][0] = pack_bf16(sacc[8 * kk], sacc[8 * kk + 1]);
        pf[kk][1] = pack_bf16(sacc[8 * kk + 2], sacc[8 * kk + 3]);
        pf[kk][2] = pack_bf16(sacc[8 * kk + 4], sacc[8 * kk + 5]);
        pf[kk][3] = pack_bf16(sacc[8 * kk + 6], sacc[8 * kk + 7]);
      }

      // O += P·V: V read MN-major (its D columns are the product's N).
      mbar_wait(&v_full[s], ph);
      wgmma_fence();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs(o, pf[kk], desc_sw128(vt, kk * 2048, kKVHalf, 1024), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(&empty[s]);
    }

    // The four threads of a quad hold partial sums of the same two rows.
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float safe0 = l0 == 0.f ? 1.f : l0;
    const float safe1 = l1 == 0.f ? 1.f : l1;
    const float inv0 = 1.f / safe0, inv1 = 1.f / safe1;
    bf16* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
    for (int i = 0; i < D / 2; i += 4) {
      const int col = 2 * i + 2 * t;       // 8·(i/4) + 2t
      if (row0 < p.n_q)
        *reinterpret_cast<uint32_t*>(ob + row0 * p.o_sn + col) =
            pack_bf16(o[i] * inv0, o[i + 1] * inv0);
      if (row0 + 8 < p.n_q)
        *reinterpret_cast<uint32_t*>(ob + (row0 + 8) * p.o_sn + col) =
            pack_bf16(o[i + 2] * inv1, o[i + 3] * inv1);
    }
    if (t == 0) {
      float* lb = p.lse + ((long long)b * p.heads + h) * p.n_q;
      if (row0 < p.n_q) lb[row0] = (m0 + log2f(safe0)) * kLn2;
      if (row0 + 8 < p.n_q) lb[row0 + 8] = (m1 + log2f(safe1)) * kLn2;
    }
  }
}

template <int D, bool Masked>
int launch(const CUtensorMap& tq, const CUtensorMap& tk,
           const CUtensorMap& tv, const FwdParams& p, int batch,
           cudaStream_t stream) {
  using L = FwdLayout<D>;
  const auto kernel = flash_fwd_sm90_kernel<D, Masked>;
  const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((p.n_q + kBlockQ - 1) / kBlockQ, p.heads, batch);
  kernel<<<grid, kThreads, L::kSmem, stream>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v (B, N, H, D), D = 64 or 128, with element strides (s_b, s_n,
// s_h, 1), each a multiple of 8 and the start 16-byte aligned; key_bias
// null (unmasked) or an fp32 row of 0 (live key) and −∞ (dead key, and
// every key from n_k on) over ceil(n_k / 128)·128 keys, 16-byte aligned,
// with tile_masked a byte for each 128-key tile, 1 where its bias holds a
// −∞ (null when key_bias is); writes bf16 o and the fp32 LSE (B, H, n_q).
// Returns 0 on success, the CUDA runtime error of the launch,
// cudaErrorInvalidValue for another head_dim, a scale not > 0 or only one
// of key_bias and tile_masked, or 10000 + the CUresult of a refused tensor
// map.
extern "C" int flash_attention_fwd_sm90(
    const void* q, const void* k, const void* v, const void* key_bias,
    const void* tile_masked, void* o, void* lse, int batch, int n_q,
    int n_k, int heads, int head_dim,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn,
    long long v_sh, long long o_sb, long long o_sn, long long o_sh,
    float scale, void* stream) {
  if ((head_dim != 64 && head_dim != 128) || !(scale > 0.f) || n_q <= 0
      || n_k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int err = sm90_host::encode_bnhd(&tq, q, batch, n_q, heads, head_dim, q_sb,
                                   q_sn, q_sh, 64);
  if (!err)
    err = sm90_host::encode_bnhd(&tk, k, batch, n_k, heads, head_dim, k_sb,
                                 k_sn, k_sh, 64);
  if (!err)
    err = sm90_host::encode_bnhd(&tv, v, batch, n_k, heads, head_dim, v_sb,
                                 v_sn, v_sh, 64);
  if (err) return err;
  FwdParams p;
  p.key_bias = static_cast<const float*>(key_bias);
  p.tile_masked = static_cast<const uint8_t*>(tile_masked);
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.n_q = n_q;
  p.n_k = n_k;
  p.heads = heads;
  p.o_sb = o_sb; p.o_sn = o_sn; p.o_sh = o_sh;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if ((key_bias == nullptr) != (tile_masked == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool masked = key_bias != nullptr;
  if (head_dim == 64)
    return masked ? launch<64, true>(tq, tk, tv, p, batch, s)
                  : launch<64, false>(tq, tk, tv, p, batch, s);
  return masked ? launch<128, true>(tq, tk, tv, p, batch, s)
                : launch<128, false>(tq, tk, tv, p, batch, s);
}

// The dynamic shared memory a block of the forward takes at head_dim (64 or
// 128; 0 for another), for the build log.
extern "C" int flash_attention_fwd_sm90_smem(int head_dim) {
  return head_dim == 64 ? FwdLayout<64>::kSmem
         : head_dim == 128 ? FwdLayout<128>::kSmem : 0;
}
