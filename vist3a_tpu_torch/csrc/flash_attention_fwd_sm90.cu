// Flash-attention forward for Hopper (sm_90a) on wgmma and TMA: non-causal
// softmax(scale·QKᵀ)·V over (B, N, H, 128) bf16 tensors, unmasked.
//
// Replaces the natural-layout Pallas entry of
// vist3a_tpu/kernels/flash_attention.py: flash_attention(layout="natural")
// → _flash_fwd → _fwd_kernel (:78, pallas_call :142), which the JAX package
// runs for an unmasked call with head_dim 128 — the Wan DiT's
// self-attention, 1500 launches of (2, 4096, 12, 128) in a text→3DGS
// request.  The wrapper sends it bf16, unmasked, head_dim-128 calls; the
// mma.sync kernel of flash_attention_fwd.cu keeps every other call.
//
// What it computes, as that kernel and the plain version do: the fp32
// scores Q·Kᵀ scaled in fp32 (not q pre-scaled in bf16), an online softmax
// in base 2 with the running max floored at −1e30, P rounded to bf16 before
// the P·V product, fp32 accumulators, O stored in bf16 with the caller's
// strides, and the natural-log LSE in fp32, shape (B, H, N_q).
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s): the
// products, 4·B·N²·H·D FLOP — 2.06e11 at (2, 4096, 12, 128), 0.208 ms,
// against 101 MB of Q, K, V, O and LSE (30 µs).  The design (FA3's shape):
//   * a block owns a 128-row query tile of one (b, h): two consumer
//     warpgroups of 64 rows each and one producer warpgroup, of which one
//     thread issues the loads; the producer gives registers back with
//     setmaxnreg (40), the consumers take them (232);
//   * Q, K and V arrive through TMA from 4-D tensor maps (d, n, h, b) built
//     from the tensors' own strides, so strided views (the DiT's q, k, v are
//     views into its fused qkv) are read in place; a 128-column row is two
//     64-column boxes with the 128-byte swizzle that wgmma descriptors read;
//     rows beyond N arrive as zeros;
//   * K and V tiles of 128 keys sit in a ring of two stages on mbarriers
//     (K and V of a stage on barriers of their own), so the loads of the
//     next tiles run under the products of this one: Q 32 KB + 2 × 64 KB;
//   * S = Q·Kᵀ is wgmma m64n128k16 with both operands in shared memory,
//     K-major; O += P·V takes P from registers (the score accumulators
//     re-packed to bf16 A fragments, which have the same layout) and V from
//     shared memory with the transpose-B bit, so no transposed tile exists;
//   * keys beyond N_k (zeros from TMA, score 0, not −∞) are masked to −∞
//     on the last tile; rows beyond N_q are computed and not stored.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_fwd_sm90.so \
//        flash_attention_fwd_sm90.cu

#include <math.h>

#include "sm90.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int kD = 128;
constexpr int kBlockQ = 128;          // two consumer warpgroups of 64 rows
constexpr int kBlockK = 128;          // keys per K / V tile
constexpr int kStages = 2;
constexpr int kThreads = 384;         // producer warpgroup + 2 consumers
constexpr int kTileBytes = kBlockK * kD * 2;     // 32 KB: [half][row][64]
constexpr int kHalfBytes = kTileBytes / 2;       // one 64-column half
constexpr int kBoxBytes = 64 * 64 * 2;           // one TMA box, 64 × 64
constexpr int kSmemTiles = (1 + 2 * kStages) * kTileBytes;
constexpr int kSmem = kSmemTiles + 64 + 1024;    // barriers, alignment slack
constexpr float kNegBig = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

struct FwdParams {
  bf16* o;
  float* lse;            // (B, H, n_q) contiguous
  int n_q, n_k, heads;
  long long o_sb, o_sn, o_sh;
  float scale_log2;      // softmax scale · log2(e), > 0
};

// A 128-row tile (rows row0 .. row0+127 of head h, batch b) as four boxes.
__device__ __forceinline__ void load_tile(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int row0, int h,
                                          int b) {
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int rb = 0; rb < 2; ++rb)
      tma_load_4d(dst + half * kHalfBytes + rb * kBoxBytes, map, bar,
                  half * 64, row0 + rb * 64, h, b);
}

__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const FwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* q_s = smem;
  uint8_t* k_s = smem + kTileBytes;                      // [stage]
  uint8_t* v_s = k_s + kStages * kTileBytes;             // [stage]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + kSmemTiles);
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
      mbar_init(&empty[s], 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    // Producer: one thread keeps the ring full.
    reg_dealloc<40>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, kTileBytes);
      load_tile(q_s, &tq, q_full, q0, h, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        mbar_wait(&empty[s], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&k_full[s], kTileBytes);
        load_tile(k_s + s * kTileBytes, &tk, &k_full[s], j * kBlockK, h, b);
        mbar_expect_tx(&v_full[s], kTileBytes);
        load_tile(v_s + s * kTileBytes, &tv, &v_full[s], j * kBlockK, h, b);
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

    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.f;
    float m0 = kNegBig, m1 = kNegBig;  // running max (base 2, scaled)
    float l0 = 0.f, l1 = 0.f;          // this thread's share of the sum

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t ph = (j / kStages) & 1;
      const uint8_t* kt = k_s + s * kTileBytes;
      const uint8_t* vt = v_s + s * kTileBytes;

      // S = Q·Kᵀ: 64 rows × 128 keys, depth 128 in 8 steps of 16 (the first
      // overwrites the accumulators, so they need no initial value).
      float sacc[64];
      mbar_wait(&k_full[s], ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        const uint32_t off = (kk / 4) * kHalfBytes + (kk % 4) * 32;
        wgmma_ss_n128(sacc, desc_sw128(q_s, off + cw * 64 * 128, 0, 1024),
                      desc_sw128(kt, off, 0, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);

      // Accumulator i of a thread: key 8·(i/4) + 2t + (i & 1), row
      // row0 + 8·((i/2) & 1).  Keys beyond N_k (zero rows) get −∞.
      const int key0 = j * kBlockK;
      if (key0 + kBlockK > p.n_k) {
#pragma unroll
        for (int i = 0; i < 64; ++i)
          if (key0 + 8 * (i / 4) + 2 * t + (i & 1) >= p.n_k) sacc[i] = -INFINITY;
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
      for (int i = 0; i < 64; i += 4) {
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

      // O += P·V: V read MN-major (its 128 columns are the product's N).
      mbar_wait(&v_full[s], ph);
      wgmma_fence();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_rs_n128(o, pf[kk], desc_sw128(vt, kk * 2048, kHalfBytes, 1024),
                      1);
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
    for (int i = 0; i < 64; i += 4) {
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

}  // namespace

// bf16 q, k, v (B, N, H, 128) with element strides (s_b, s_n, s_h, 1), each
// a multiple of 8 and the start 16-byte aligned; writes bf16 o and the fp32
// LSE (B, H, n_q).  Returns 0 on success, the CUDA runtime error of the
// launch, cudaErrorInvalidValue for a head_dim other than 128 or a scale
// not > 0, or 10000 + the CUresult of a refused tensor map.
extern "C" int flash_attention_fwd_sm90(
    const void* q, const void* k, const void* v, void* o, void* lse,
    int batch, int n_q, int n_k, int heads, int head_dim, long long q_sb,
    long long q_sn, long long q_sh, long long k_sb, long long k_sn,
    long long k_sh, long long v_sb, long long v_sn, long long v_sh,
    long long o_sb, long long o_sn, long long o_sh, float scale,
    void* stream) {
  if (head_dim != kD || !(scale > 0.f) || n_q <= 0 || n_k <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int err = sm90_host::encode_bnhd(&tq, q, batch, n_q, heads, q_sb, q_sn,
                                   q_sh, 64);
  if (!err)
    err = sm90_host::encode_bnhd(&tk, k, batch, n_k, heads, k_sb, k_sn, k_sh,
                                 64);
  if (!err)
    err = sm90_host::encode_bnhd(&tv, v, batch, n_k, heads, v_sb, v_sn, v_sh,
                                 64);
  if (err) return err;
  FwdParams p;
  p.o = static_cast<bf16*>(o);
  p.lse = static_cast<float*>(lse);
  p.n_q = n_q;
  p.n_k = n_k;
  p.heads = heads;
  p.o_sb = o_sb; p.o_sn = o_sn; p.o_sh = o_sh;
  p.scale_log2 = scale * kLog2e;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((n_q + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_fwd_sm90_kernel<<<grid, kThreads, kSmem,
                          static_cast<cudaStream_t>(stream)>>>(tq, tk, tv, p);
  return static_cast<int>(cudaGetLastError());
}
