// Flash-attention forward for Hopper (sm_90a): non-causal softmax(scale·QKᵀ)·V
// over (B, N, H, D) bf16 tensors, with an optional per-key validity vector.
//
// Replaces two Pallas entries of vist3a_tpu/kernels/flash_attention.py:
//   * flash_attention(layout="transposed") → _flash_fwd_t → _fwd_kernel_t and
//     its online-max fallback _fwd_kernel_t_onmax (the unmasked forward);
//   * flash_attention_masked → _fwd_t_masked_part → _flash_fwd_t(kv_bias=…),
//     the same two kernels with a key-bias row (the masked forward).
// What it must reproduce: O in the input dtype, the per-row natural-log
// log-sum-exp (LSE, fp32, shape (B, H, N_q)), masked keys that add exactly
// nothing, and a row with no live key giving O = 0 (the `safe_l` rule: an
// empty row divides by 1, and its LSE is the finite sentinel −1e30·ln 2).
// None of the TPU devices carry over: no Cauchy–Schwarz bound-max row, no
// bias-feature rows for mask and denominator, no ones-row in V, no (D, N)
// transposes and no lax.cond to an online-max kernel.  Hopper runs the plain
// online softmax in base 2, with the running max and sum in fp32 registers.
//
// What bounds it on an H100 SXM (989 TFLOP/s dense bf16, 3.35 TB/s HBM):
//   global attention  B=1,  N=13520, H=16, D=64: 4·B·N²·H·D = 7.49e11 FLOP
//     against 111 MB of Q, K, V and O (each read or written once), so it is
//     compute-bound: 0.757 ms at the tensor-core peak against 33 µs of bytes;
//   frame attention   B=13, N=1040: 5.8e10 FLOP, ViT blocks B=13, N=1029:
//     5.6e10 FLOP — about 57 µs each at the peak, against 55 MB (16 µs), so
//     also compute-bound (≈ 1000 FLOP per byte, above the ridge of ≈ 295).
// The simple design here: one block of 4 warps owns a 64-row query tile of
// one (b, h); each warp holds its 16 query rows as mma.sync A fragments in
// registers for the whole key loop.  K and V tiles of 64 keys are staged in
// shared memory (K row-major, V transposed so that both B operands are
// 32-bit shared loads), with rows padded by 8 elements against bank
// conflicts.  QKᵀ and PV run on mma.sync m16n8k16 (bf16 in, fp32 out); P is
// re-packed from the score accumulators into A fragments without touching
// shared memory.  Loads are not overlapped with the tensor-core work (no
// cp.async, TMA, wgmma or warp specialisation): that is where the gap to the
// bound lies, and it is work for a later change.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_fwd.so flash_attention_fwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;        // query rows per block, 16 per warp
constexpr int kBlockK = 64;        // keys per shared-memory tile
constexpr int kThreads = 128;      // 4 warps
constexpr float kNegBig = -1e30f;  // finite "minus infinity" of the running max
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const uint8_t* key_valid;  // (n_k,) 0/1, or nullptr for all keys live
  __nv_bfloat16* o;
  float* lse;                // (B, H, n_q) contiguous
  int n_q, n_k, heads, d;
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long o_sb, o_sn, o_sh;
  float scale_log2;          // softmax scale · log2(e)
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[16x8] += A[16x16] · B[16x8], bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_16816(float (&c)[4], uint32_t a0,
                                          uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base,
                                              long long stride_n, int row,
                                              int n_rows, int col, int d) {
  if (row >= n_rows || col >= d) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + row * stride_n + col);
}

// DP: head_dim rounded up to the mma depth of 16 (zero-filled beyond d).
template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const Params p) {
  constexpr int KS = DP + 8;        // K tile row stride (elements)
  constexpr int VS = kBlockK + 8;   // Vᵀ tile row stride (elements)
  constexpr int CH = DP / 8;        // 16-byte chunks per row
  constexpr int NT = kBlockK / 8;   // score n-tiles per key tile
  constexpr int KQ = DP / 16;       // k-steps of the QKᵀ product
  constexpr int ND = DP / 8;        // output n-tiles
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockK * KS];
  __shared__ __align__(16) __nv_bfloat16 vt_s[DP * VS];
  __shared__ bool live_s[kBlockK];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;   // mma fragment row group / column pair
  const int b = blockIdx.z, h = blockIdx.y;
  const int row0 = blockIdx.x * kBlockQ + warp * 16 + g;  // rows row0, row0+8

  const __nv_bfloat16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;

  // Q as A fragments, held for the whole key loop.
  uint32_t qf[KQ][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = load_pair(qb, p.q_sn, row0, p.n_q, c, p.d);
    qf[kk][1] = load_pair(qb, p.q_sn, row0 + 8, p.n_q, c, p.d);
    qf[kk][2] = load_pair(qb, p.q_sn, row0, p.n_q, c + 8, p.d);
    qf[kk][3] = load_pair(qb, p.q_sn, row0 + 8, p.n_q, c + 8, p.d);
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegBig, m1 = kNegBig;   // running max (base 2), rows row0, row0+8
  float l0 = 0.f, l1 = 0.f;           // this thread's share of the running sum

  const int n_tiles = (p.n_k + kBlockK - 1) / kBlockK;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int key0 = tile * kBlockK;
    // K rows: consecutive threads read consecutive 16-byte chunks of a row.
    for (int i = tid; i < kBlockK * CH; i += kThreads) {
      const int r = i / CH, col = (i % CH) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (key0 + r < p.n_k && col < p.d)
        val = *reinterpret_cast<const uint4*>(kb + (key0 + r) * p.k_sn + col);
      *reinterpret_cast<uint4*>(k_s + r * KS + col) = val;
    }
    // V transposed: consecutive threads take consecutive keys of one chunk,
    // so the 2-byte shared stores of a warp land on consecutive addresses.
    for (int i = tid; i < kBlockK * CH; i += kThreads) {
      const int r = i % kBlockK, col = (i / kBlockK) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (key0 + r < p.n_k && col < p.d)
        val = *reinterpret_cast<const uint4*>(vb + (key0 + r) * p.v_sn + col);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt_s[(col + j) * VS + r] = e[j];
    }
    if (tid < kBlockK) {
      const int key = key0 + tid;
      live_s[tid] = key < p.n_k && (p.key_valid == nullptr || p.key_valid[key]);
    }
    __syncthreads();

    // S = Q·Kᵀ for this warp's 16 rows × 64 keys.
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* krow = k_s + (8 * j + g) * KS + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
        mma_16816(s[j], qf[kk][0], qf[kk][1], qf[kk][2], qf[kk][3], b0, b1);
      }
    }

    // Scale to base 2, mask, and take the tile's row max.
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool live = live_s[8 * j + 2 * t + e];
        s[j][e] = live ? s[j][e] * p.scale_log2 : -INFINITY;
        s[j][2 + e] = live ? s[j][2 + e] * p.scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float alpha0 = exp2f(m0 - mn0), alpha1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;

    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = exp2f(s[j][0] - mn0);   // masked: exp2(−inf) = 0
      s[j][1] = exp2f(s[j][1] - mn0);
      s[j][2] = exp2f(s[j][2] - mn1);
      s[j][3] = exp2f(s[j][3] - mn1);
      rs0 += s[j][0] + s[j][1];
      rs1 += s[j][2] + s[j][3];
    }
    l0 = l0 * alpha0 + rs0;
    l1 = l1 * alpha1 + rs1;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha0;
      acc[n][1] *= alpha0;
      acc[n][2] *= alpha1;
      acc[n][3] *= alpha1;
    }

    // O += P·V: the score accumulators of n-tiles 2kk, 2kk+1 are exactly the
    // A fragment of keys [16kk, 16kk+16).
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const __nv_bfloat16* vrow = vt_s + (8 * n + g) * VS + kk * 16 + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(vrow);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(vrow + 8);
        mma_16816(acc[n], a0, a1, a2, a3, b0, b1);
      }
    }
    __syncthreads();
  }

  // The four threads of a quad hold the partial sums of the same two rows.
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float safe0 = l0 == 0.f ? 1.f : l0;
  const float safe1 = l1 == 0.f ? 1.f : l1;
  const float inv0 = 1.f / safe0, inv1 = 1.f / safe1;

  __nv_bfloat16* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    const int col = 8 * n + 2 * t;
    if (col >= p.d) continue;
    if (row0 < p.n_q)
      *reinterpret_cast<uint32_t*>(ob + row0 * p.o_sn + col) =
          pack_bf16(acc[n][0] * inv0, acc[n][1] * inv0);
    if (row0 + 8 < p.n_q)
      *reinterpret_cast<uint32_t*>(ob + (row0 + 8) * p.o_sn + col) =
          pack_bf16(acc[n][2] * inv1, acc[n][3] * inv1);
  }
  if (t == 0) {
    float* lb = p.lse + ((long long)b * p.heads + h) * p.n_q;
    if (row0 < p.n_q) lb[row0] = (m0 + log2f(safe0)) * kLn2;
    if (row0 + 8 < p.n_q) lb[row0 + 8] = (m1 + log2f(safe1)) * kLn2;
  }
}

template <int DP>
void launch(const Params& p, int batch, cudaStream_t stream) {
  const dim3 grid((p.n_q + kBlockQ - 1) / kBlockQ, p.heads, batch);
  flash_fwd_kernel<DP><<<grid, kThreads, 0, stream>>>(p);
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for a head_dim the kernel does not take.
extern "C" int flash_attention_fwd_bf16(
    const void* q, const void* k, const void* v, const void* key_valid,
    void* o, void* lse, int batch, int n_q, int n_k, int heads, int head_dim,
    long long q_sb, long long q_sn, long long q_sh, long long k_sb,
    long long k_sn, long long k_sh, long long v_sb, long long v_sn,
    long long v_sh, long long o_sb, long long o_sn, long long o_sh,
    float scale, void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.key_valid = static_cast<const uint8_t*>(key_valid);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.lse = static_cast<float*>(lse);
  p.n_q = n_q;
  p.n_k = n_k;
  p.heads = heads;
  p.d = head_dim;
  p.q_sb = q_sb; p.q_sn = q_sn; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sn = k_sn; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sn = v_sn; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_sn = o_sn; p.o_sh = o_sh;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((head_dim + 15) / 16 * 16) {
    case 16: launch<16>(p, batch, s); break;
    case 32: launch<32>(p, batch, s); break;
    case 48: launch<48>(p, batch, s); break;
    case 64: launch<64>(p, batch, s); break;
    case 80: launch<80>(p, batch, s); break;
    case 96: launch<96>(p, batch, s); break;
    case 112: launch<112>(p, batch, s); break;
    case 128: launch<128>(p, batch, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
