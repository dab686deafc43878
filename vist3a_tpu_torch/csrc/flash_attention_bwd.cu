// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of non-causal
// O = softmax(scale·QKᵀ)·V over (B, N, H, D) bf16 tensors (D ≤ 64 and
// D ≤ 128 instantiations), for the bf16 head dims that the wgmma kernels
// (flash_attention_bwd_sm90.cu) do not take; fp32 calls go to
// flash_attention_bwd_f32_sm90.cu.
//
// Replaces, at those head dims, the VJPs of the two Pallas layouts in
// vist3a_tpu/kernels/flash_attention.py:
//   * the transposed layout, `_flash_core_t_bwd` → `_flash_bwd_t_impl`, its
//     two pallas_calls `_dq_kernel_t` (dQ) and `_dkv_kernel_t` (dK and dV);
//   * the natural layout, `_flash_bwd` → `_flash_bwd_impl`, its
//     pallas_calls `_dq_kernel` and `_dkv_kernel`.
//
// What it computes, from the forward's q, k, v, its natural-log LSE
// (B, H, N_q) and dO, with δ = rowsum(dO∘O) (B, H, N_q) taken outside, as
// the JAX package takes it outside its kernels:
//   P  = exp2(s·scale·log2e − LSE·log2e)   (exact in [0, 1]: no running max)
//   dV = Pᵀ·dO,   dS = P∘(dO·Vᵀ − δ),   dQ = scale·dS·K,   dK = scale·dSᵀ·Q.
// The TPU's devices do not carry over: no bias-feature rows folding LSE and
// δ into the products, no hi/lo bf16 splits, no (D, N) layout or 1024-wide
// blocks.  Here LSE and δ are fp32 values in shared memory or registers.
//
// Two kernels per instantiation and no atomics, like the two pallas_calls,
// so two runs agree bit for bit: a dK/dV kernel owns a 64-key tile of one
// (b, h) and loops over the query tiles, accumulating dK and dV in
// registers; a dQ kernel owns a 64-query tile and loops over the key tiles.
// Each recomputes P from the LSE.  Ragged edges: rows beyond N load as
// zeros, a padded query row has LSE +inf (P = 0, δ = 0), a padded key has
// P = 0, so neither contributes, and neither is written.
//
// The five products run on the tensor cores, mma.sync m16n8k16 with bf16
// operands and fp32 accumulators, as the bf16 forward does.  What the TPU
// kernels compute is kept: P and dS are rounded to bf16 before the products
// that take them (`_dkv_kernel`, `_dq_kernel` and their transposed twins
// cast `p` and `ds` to the input dtype), the accumulators are fp32 and dQ,
// dK, dV are stored in bf16.  The JAX natural kernels also round
// q·scale·log2e and v·scale to bf16 before the products; here the fp32
// scores are scaled, one rounding fewer, as in the forward.  4 warps, each
// owning 16 rows of the block's 64-row tile: S and dP (16 × 64) are mma
// products against row-major tiles in shared memory, then P and dS are
// re-packed from the accumulators into A fragments in registers (no
// shared-memory round trip) for the accumulating products, whose B operands
// are transposed tiles (Kᵀ for dQ; Qᵀ and dOᵀ for dK, dV).  Rows are padded
// by 8 elements, so the 32-bit fragment loads of a warp hit 32 distinct
// banks.  Loads are not overlapped with the tensor-core work (no cp.async,
// TMA, wgmma or warp specialisation).
//
// What bounds it on an H100 SXM: operations, 10·N²·D·H·B FLOP (4 products
// of 2·N²·D and the recomputed S) at the bf16 tensor-core rate (989
// TFLOP/s): (2, 333, 3, 96) is 6.4e8 FLOP, 0.65 µs.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_bwd.so flash_attention_bwd.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // queries or keys per tile
constexpr int kThreads = 128;      // 4 warps
constexpr float kLog2e = 1.4426950408889634f;

using bf16 = __nv_bfloat16;
constexpr int kTS = kTile + 8;     // row stride of a transposed (D × 64) tile

struct ParamsBf16 {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* dout;
  const float* lse;     // (B, H, n_q) contiguous, natural log
  const float* delta;   // (B, H, n_q) contiguous, rowsum(dO∘O) in fp32
  bf16* dq;
  bf16* dk;
  bf16* dv;
  int n_q, n_k, heads, d;
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long do_sb, do_sn, do_sh;
  long long dq_sb, dq_sn, dq_sh;
  long long dk_sb, dk_sn, dk_sh;
  long long dv_sb, dv_sn, dv_sh;
  float scale;
  float scale_log2;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[16x8] += A[16x16] · B[16x8], bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [row0, row0 + 64) of an (N, d) bf16 slice into a 64 × (DP + 8) tile,
// zero beyond n_rows and d, 16 bytes a thread.
template <int DP>
__device__ __forceinline__ void load_rows_bf16(bf16* dst, const bf16* src,
                                               long long stride_n, int row0,
                                               int n_rows, int d) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < kTile * CH; i += kThreads) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows && c < d)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride_n + c);
    *reinterpret_cast<uint4*>(dst + r * (DP + 8) + c) = val;
  }
}

// The same rows transposed into a DP × kTS tile, dst[c][r]: consecutive
// threads take consecutive rows of one 8-column chunk, so a warp's 2-byte
// shared stores land on consecutive addresses.
template <int DP>
__device__ __forceinline__ void load_cols_bf16(bf16* dst, const bf16* src,
                                               long long stride_n, int row0,
                                               int n_rows, int d) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < kTile * CH; i += kThreads) {
    const int r = i % kTile, c = (i / kTile) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_rows && c < d)
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride_n + c);
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * kTS + r] = e[j];
  }
}

// The A fragment of rows [16w, 16w + 16) and columns [16kk, 16kk + 16) of a
// row-major 64 × (DP + 8) tile.
template <int DP>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const bf16* tile,
                                       int warp, int g, int t, int kk) {
  const bf16* r0 = tile + (16 * warp + g) * (DP + 8) + 16 * kk + 2 * t;
  const bf16* r1 = r0 + 8 * (DP + 8);
  a[0] = ld32(r0);
  a[1] = ld32(r1);
  a[2] = ld32(r0 + 8);
  a[3] = ld32(r1 + 8);
}

// B fragment halves of rows 8j + g of a row-major 64 × (DP + 8) tile at
// k-step kk (the rows are the product's columns: X·tileᵀ).
template <int DP>
__device__ __forceinline__ const bf16* b_row(const bf16* tile, int j, int g,
                                             int t) {
  return tile + (8 * j + g) * (DP + 8) + 2 * t;
}

// acc[n] += F · X over the tile's 64 rows of X: F the 16 × 64 bf16 A
// fragments of P or dS, X (64 × DP) given transposed (DP × kTS).
template <int DP>
__device__ __forceinline__ void accumulate(float (&acc)[DP / 8][4],
                                           const uint32_t (&f)[4][4],
                                           const bf16* xt, int g, int t) {
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const bf16* row = xt + (8 * n + g) * kTS + 2 * t;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      mma_16816(acc[n], f[kk], ld32(row + 16 * kk), ld32(row + 16 * kk + 8));
  }
}

// Puts the C fragment x (16 rows × columns 8j .. 8j+7) into the A
// fragments f (16 rows × 64 columns, k-step j / 2), rounded to bf16.
__device__ __forceinline__ void repack(uint32_t (&f)[4][4],
                                       const float (&x)[4], int j) {
  const int h = (j & 1) * 2;
  f[j >> 1][h] = pack_bf16(x[0], x[1]);
  f[j >> 1][h + 1] = pack_bf16(x[2], x[3]);
}

// Stores acc (rows row and row + 8, DP columns) · mul as bf16.
template <int DP>
__device__ __forceinline__ void store_acc(bf16* base, long long stride_n,
                                          int row, int n_rows, int d,
                                          const float (&acc)[DP / 8][4],
                                          float mul, int t) {
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (col >= d) continue;
    if (row < n_rows)
      *reinterpret_cast<uint32_t*>(base + row * stride_n + col) =
          pack_bf16(acc[n][0] * mul, acc[n][1] * mul);
    if (row + 8 < n_rows)
      *reinterpret_cast<uint32_t*>(base + (row + 8) * stride_n + col) =
          pack_bf16(acc[n][2] * mul, acc[n][3] * mul);
  }
}

// Shared memory of the two bf16 kernels (bytes).
template <int DP>
constexpr int dkv_smem_bf16() {   // K, V, Q, dO row-major; Qᵀ, dOᵀ; LSE, δ
  return (4 * kTile * (DP + 8) + 2 * DP * kTS) * 2 + 2 * kTile * 4;
}
template <int DP>
constexpr int dq_smem_bf16() {    // K, V row-major; Kᵀ
  return (2 * kTile * (DP + 8) + DP * kTS) * 2;
}

// dK and dV of one 64-key tile: warp w owns keys 16w .. 16w+15, the rows of
// Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ, whose columns are the tile's 64 queries.
template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkv_bf16_kernel(const ParamsBf16 p) {
  constexpr int RS = DP + 8;
  constexpr int KQ = DP / 16;
  constexpr int ND = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kTile * RS;
  bf16* q_s = v_s + kTile * RS;
  bf16* do_s = q_s + kTile * RS;
  bf16* qt_s = do_s + kTile * RS;
  bf16* dot_s = qt_s + DP * kTS;
  float* lse_s = reinterpret_cast<float*>(dot_s + DP * kTS);
  float* dl_s = lse_s + kTile;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int key0 = blockIdx.x * kTile;
  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* dob = p.dout + b * p.do_sb + h * p.do_sh;
  const long long bh = (long long)b * p.heads + h;
  const float* lse_b = p.lse + bh * p.n_q;
  const float* delta_b = p.delta + bh * p.n_q;

  load_rows_bf16<DP>(k_s, p.k + b * p.k_sb + h * p.k_sh, p.k_sn, key0,
                     p.n_k, p.d);
  load_rows_bf16<DP>(v_s, p.v + b * p.v_sb + h * p.v_sh, p.v_sn, key0,
                     p.n_k, p.d);
  const int krow = key0 + 16 * warp + g;            // keys krow, krow + 8
  const bool live0 = krow < p.n_k, live1 = krow + 8 < p.n_k;
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
    dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
  }

  const int n_qtiles = (p.n_q + kTile - 1) / kTile;
  for (int tile = 0; tile < n_qtiles; ++tile) {
    const int q0 = tile * kTile;
    load_rows_bf16<DP>(q_s, qb, p.q_sn, q0, p.n_q, p.d);
    load_rows_bf16<DP>(do_s, dob, p.do_sn, q0, p.n_q, p.d);
    load_cols_bf16<DP>(qt_s, qb, p.q_sn, q0, p.n_q, p.d);
    load_cols_bf16<DP>(dot_s, dob, p.do_sn, q0, p.n_q, p.d);
    if (tid < kTile) {
      const bool live = q0 + tid < p.n_q;
      lse_s[tid] = live ? lse_b[q0 + tid] * kLog2e : INFINITY;
      dl_s[tid] = live ? delta_b[q0 + tid] : 0.f;
    }
    __syncthreads();

    uint32_t pf[4][4], dsf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {             // queries 8j .. 8j+7
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* qrow = b_row<DP>(q_s, j, g, t);
      const bf16* dorow = b_row<DP>(do_s, j, g, t);
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        uint32_t a[4];
        a_frag<DP>(a, k_s, warp, g, t, kk);
        mma_16816(s, a, ld32(qrow + 16 * kk), ld32(qrow + 16 * kk + 8));
        a_frag<DP>(a, v_s, warp, g, t, kk);
        mma_16816(dp, a, ld32(dorow + 16 * kk), ld32(dorow + 16 * kk + 8));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + 2 * t + (e & 1);
        const bool live = e < 2 ? live0 : live1;
        s[e] = live ? exp2f(s[e] * p.scale_log2 - lse_s[c]) : 0.f;
        dp[e] = s[e] * (dp[e] - dl_s[c]);
      }
      repack(pf, s, j);
      repack(dsf, dp, j);
    }
    accumulate<DP>(dv, pf, dot_s, g, t);      // dV += Pᵀ·dO
    accumulate<DP>(dk, dsf, qt_s, g, t);      // dK += dSᵀ·Q
    __syncthreads();
  }

  store_acc<DP>(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_sn, krow, p.n_k, p.d,
                dk, p.scale, t);
  store_acc<DP>(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_sn, krow, p.n_k, p.d,
                dv, 1.f, t);
}

// dQ of one 64-query tile: warp w owns queries 16w .. 16w+15, the rows of
// S = Q·Kᵀ and dP = dO·Vᵀ, whose columns are the tile's 64 keys.
template <int DP>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_bf16_kernel(const ParamsBf16 p) {
  constexpr int RS = DP + 8;
  constexpr int KQ = DP / 16;
  constexpr int ND = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);
  bf16* v_s = k_s + kTile * RS;
  bf16* kt_s = v_s + kTile * RS;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const bf16* kb = p.k + b * p.k_sb + h * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + h * p.v_sh;
  const long long bh = (long long)b * p.heads + h;

  // Q and dO of the tile as A fragments, held for the whole key loop
  // (staged through the K and V buffers).
  load_rows_bf16<DP>(k_s, p.q + b * p.q_sb + h * p.q_sh, p.q_sn, q0, p.n_q,
                     p.d);
  load_rows_bf16<DP>(v_s, p.dout + b * p.do_sb + h * p.do_sh, p.do_sn, q0,
                     p.n_q, p.d);
  __syncthreads();
  uint32_t qf[KQ][4], dof[KQ][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) {
    a_frag<DP>(qf[kk], k_s, warp, g, t, kk);
    a_frag<DP>(dof[kk], v_s, warp, g, t, kk);
  }
  const int qrow = q0 + 16 * warp + g;              // queries qrow, qrow + 8
  const float lse0 = qrow < p.n_q ? p.lse[bh * p.n_q + qrow] * kLog2e
                                  : INFINITY;
  const float lse1 = qrow + 8 < p.n_q
                         ? p.lse[bh * p.n_q + qrow + 8] * kLog2e
                         : INFINITY;
  const float dl0 = qrow < p.n_q ? p.delta[bh * p.n_q + qrow] : 0.f;
  const float dl1 = qrow + 8 < p.n_q ? p.delta[bh * p.n_q + qrow + 8] : 0.f;
  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  __syncthreads();

  const int n_ktiles = (p.n_k + kTile - 1) / kTile;
  for (int tile = 0; tile < n_ktiles; ++tile) {
    const int key0 = tile * kTile;
    load_rows_bf16<DP>(k_s, kb, p.k_sn, key0, p.n_k, p.d);
    load_rows_bf16<DP>(v_s, vb, p.v_sn, key0, p.n_k, p.d);
    load_cols_bf16<DP>(kt_s, kb, p.k_sn, key0, p.n_k, p.d);
    __syncthreads();

    uint32_t dsf[4][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {             // keys 8j .. 8j+7
      float s[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* krow = b_row<DP>(k_s, j, g, t);
      const bf16* vrow = b_row<DP>(v_s, j, g, t);
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        mma_16816(s, qf[kk], ld32(krow + 16 * kk), ld32(krow + 16 * kk + 8));
        mma_16816(dp, dof[kk], ld32(vrow + 16 * kk),
                  ld32(vrow + 16 * kk + 8));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool live = key0 + 8 * j + 2 * t + (e & 1) < p.n_k;
        const float pr =
            live ? exp2f(s[e] * p.scale_log2 - (e < 2 ? lse0 : lse1)) : 0.f;
        dp[e] = pr * (dp[e] - (e < 2 ? dl0 : dl1));
      }
      repack(dsf, dp, j);
    }
    accumulate<DP>(acc, dsf, kt_s, g, t);     // dQ += dS·K
    __syncthreads();
  }

  store_acc<DP>(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_sn, qrow, p.n_q, p.d,
                acc, p.scale, t);
}

template <int DP>
int launch_bf16(const ParamsBf16& p, int batch, cudaStream_t s) {
  constexpr int dkv = dkv_smem_bf16<DP>(), dq = dq_smem_bf16<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_bf16_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, dkv);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_bf16_kernel<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_bf16_kernel<DP>
      <<<dim3((p.n_k + kTile - 1) / kTile, p.heads, batch), kThreads, dkv,
         s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_bf16_kernel<DP>
      <<<dim3((p.n_q + kTile - 1) / kTile, p.heads, batch), kThreads, dq,
         s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q, k, v, dO (strided, unit last stride, 16-byte aligned rows), LSE
// and δ (B, H, n_q) contiguous fp32; writes bf16 dQ, dK, dV.  head_dim ≤ 64
// runs the D = 64 instantiation (the transposed TPU entry's), ≤ 128 the
// D = 128 one (the natural entry's).  Returns the first CUDA error of the
// two launches (0 on success), or cudaErrorInvalidValue for a head_dim the
// kernels do not take.
extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    int batch, int n_q, int n_k, int heads, int head_dim, long long q_sb,
    long long q_sn, long long q_sh, long long k_sb, long long k_sn,
    long long k_sh, long long v_sb, long long v_sn, long long v_sh,
    long long do_sb, long long do_sn, long long do_sh, long long dq_sb,
    long long dq_sn, long long dq_sh, long long dk_sb, long long dk_sn,
    long long dk_sh, long long dv_sb, long long dv_sn, long long dv_sh,
    float scale, void* stream) {
  if (head_dim <= 0 || head_dim > 128 || head_dim % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  ParamsBf16 p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.n_q = n_q;
  p.n_k = n_k;
  p.heads = heads;
  p.d = head_dim;
  p.q_sb = q_sb; p.q_sn = q_sn; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sn = k_sn; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sn = v_sn; p.v_sh = v_sh;
  p.do_sb = do_sb; p.do_sn = do_sn; p.do_sh = do_sh;
  p.dq_sb = dq_sb; p.dq_sn = dq_sn; p.dq_sh = dq_sh;
  p.dk_sb = dk_sb; p.dk_sn = dk_sn; p.dk_sh = dk_sh;
  p.dv_sb = dv_sb; p.dv_sn = dv_sn; p.dv_sh = dv_sh;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return head_dim <= 64 ? launch_bf16<64>(p, batch, s)
                        : launch_bf16<128>(p, batch, s);
}
