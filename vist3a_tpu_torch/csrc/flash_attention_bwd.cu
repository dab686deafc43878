// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of non-causal
// O = softmax(scale·QKᵀ)·V over fp32 (B, N, H, D) tensors, D ≤ 64.
//
// Replaces the VJP of the transposed-layout Pallas kernel in
// vist3a_tpu/kernels/flash_attention.py: `_flash_core_t_bwd` →
// `_flash_bwd_t_impl`, its two pallas_calls `_dq_kernel_t` (dQ) and
// `_dkv_kernel_t` (dK and dV).  The JAX training step reaches it on fp32
// q, k, v in every differentiable trunk attention (ViT and frame blocks
// (13, 1029, 16, 64), global blocks (1, S·1029, 16, 64)).
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
// Two kernels and no atomics, like the two pallas_calls, so two runs agree
// bit for bit: `flash_bwd_dkv_kernel` owns a 64-key tile of one (b, h) and
// loops over the query tiles, accumulating dK and dV in registers;
// `flash_bwd_dq_kernel` owns a 64-query tile and loops over the key tiles.
// Each recomputes P from the LSE.
//
// Products are exact fp32 FFMAs from shared-memory tiles (the path is fp32:
// single-pass TF32 keeps ~3 digits and would differ from the JAX step by
// ~1e-3; 3×TF32 on mma.sync is the later speed-up).  128 threads, thread
// (ty, tx) = (tid / 16, tid % 16): the score-like products (S, dP) give it
// rows ty + 8r (r < 8) against columns tx + 16c (c < 4) of a 64 × 64 tile;
// the accumulating products give it those 8 rows × head-dim columns
// 4tx .. 4tx+3.  P and dS pass through shared memory as [column][8ty + r],
// so each thread's 8 rows are two float4 reads, and only the warp that
// wrote them reads them back.  Ragged edges: rows beyond N load as zeros,
// a padded query row has LSE +inf (P = 0, δ = 0), a padded key has P = 0,
// so neither contributes, and neither is written.
//
// What bounds it on an H100 SXM: operations, 10·N²·D·H·B FLOP at the fp32
// rate outside the tensor cores (67 TFLOP/s): the global attention at
// S = 13, (1, 13377, 16, 64), is 1.83e12 FLOP, 27.3 ms, against 0.33 GB of
// q, k, v, O, dO, LSE, dQ, dK, dV (98 µs); S = 21, (1, 21609, 16, 64), is
// 4.78e12 FLOP, 71.4 ms; the ViT and frame blocks, (13, 1029, 16, 64), are
// 1.41e11 FLOP, 2.1 ms.  The simple design here issues its shared-memory
// loads in line with the FFMAs and runs two blocks of 4 warps on an SM;
// overlapping the loads (cp.async, TMA) and 3×TF32 tensor-core products are
// where the gap to the bound lies.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libflash_attention_bwd.so flash_attention_bwd.cu

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kD = 64;             // head dim the kernels are built for
constexpr int kTile = 64;          // queries or keys per tile
constexpr int kThreads = 128;      // 4 warps
constexpr int kLd = kD + 4;        // row stride (floats) of a 64 × D tile
constexpr int kLdP = kTile + 4;    // row stride of a P or dS tile
constexpr int kTileFloats = kTile * kLd;
constexpr int kDkvSmem = (4 * kTileFloats + 2 * kTile * kLdP) * 4;  // 104,448
constexpr int kDqSmem = (4 * kTileFloats + kTile * kLdP) * 4;       //  87,040
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;     // (B, H, n_q) contiguous, natural log
  const float* delta;   // (B, H, n_q) contiguous, rowsum(dO∘O)
  float* dq;
  float* dk;
  float* dv;
  int n_q, n_k, heads, d;
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long do_sb, do_sn, do_sh;
  long long dq_sb, dq_sn, dq_sh;
  long long dk_sb, dk_sn, dk_sh;
  long long dv_sb, dv_sn, dv_sh;
  float scale;          // softmax scale
  float scale_log2;     // scale · log2(e)
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Rows [row0, row0 + 64) of an (N, d) slice with row stride stride_n into a
// 64 × kLd tile, zero beyond n_rows and d; consecutive threads read
// consecutive 16-byte chunks of a row.
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          long long stride_n, int row0,
                                          int n_rows, int d) {
  for (int i = threadIdx.x; i < kTile * (kD / 4); i += kThreads) {
    const int r = i / (kD / 4), c = (i % (kD / 4)) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows && c < d) val = ld4(src + (row0 + r) * stride_n + c);
    *reinterpret_cast<float4*>(dst + r * kLd + c) = val;
  }
}

// s[r][c] = Σ_e a[ty + 8r][e] · b[tx + 16c][e] over the 64 (padded) columns.
__device__ __forceinline__ void dot_rows(float (&s)[8][4], const float* a_s,
                                         const float* b_s, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 8; ++r) s[r][0] = s[r][1] = s[r][2] = s[r][3] = 0.f;
#pragma unroll 4
  for (int e = 0; e < kD; e += 4) {
    float4 bb[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) bb[c] = ld4(b_s + (tx + 16 * c) * kLd + e);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float4 aa = ld4(a_s + (ty + 8 * r) * kLd + e);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = fmaf(aa.x, bb[c].x, s[r][c]);
        s[r][c] = fmaf(aa.y, bb[c].y, s[r][c]);
        s[r][c] = fmaf(aa.z, bb[c].z, s[r][c]);
        s[r][c] = fmaf(aa.w, bb[c].w, s[r][c]);
      }
    }
  }
}

// Writes t[r][c] to tile[(tx + 16c) · kLdP + 8ty + r]: column-major by this
// thread's rows, so a reader of rows 8ty .. 8ty+7 takes two float4.
__device__ __forceinline__ void store_by_column(float* tile,
                                                const float (&t)[8][4],
                                                int ty, int tx) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    float4* row = reinterpret_cast<float4*>(tile + (tx + 16 * c) * kLdP
                                            + 8 * ty);
    row[0] = make_float4(t[0][c], t[1][c], t[2][c], t[3][c]);
    row[1] = make_float4(t[4][c], t[5][c], t[6][c], t[7][c]);
  }
}

// acc[r][0..3] += w[r] · x for the 8 values w = tile[j][8ty .. 8ty+7].
__device__ __forceinline__ void axpy_rows(float (&acc)[8][4],
                                          const float* w_row,
                                          const float4 x) {
  const float4 wa = ld4(w_row), wb = ld4(w_row + 4);
  const float w[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    acc[r][0] = fmaf(w[r], x.x, acc[r][0]);
    acc[r][1] = fmaf(w[r], x.y, acc[r][1]);
    acc[r][2] = fmaf(w[r], x.z, acc[r][2]);
    acc[r][3] = fmaf(w[r], x.w, acc[r][3]);
  }
}

__device__ __forceinline__ void store_rows(float* base, long long stride_n,
                                           int row0, int n_rows, int d,
                                           const float (&acc)[8][4], float mul,
                                           int ty, int tx) {
  if (4 * tx >= d) return;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = row0 + ty + 8 * r;
    if (row < n_rows)
      *reinterpret_cast<float4*>(base + row * stride_n + 4 * tx) =
          make_float4(acc[r][0] * mul, acc[r][1] * mul, acc[r][2] * mul,
                      acc[r][3] * mul);
  }
}

// dK and dV of one 64-key tile: thread rows are keys, its columns queries.
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkv_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;
  float* v_s = k_s + kTileFloats;
  float* q_s = v_s + kTileFloats;
  float* do_s = q_s + kTileFloats;
  float* p_s = do_s + kTileFloats;        // P[query][8ty + r]
  float* ds_s = p_s + kTile * kLdP;       // dS[query][8ty + r]
  __shared__ float lse_s[kTile], delta_s[kTile];

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.z, h = blockIdx.y;
  const int key0 = blockIdx.x * kTile;
  const float* qb = p.q + b * p.q_sb + h * p.q_sh;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  const float* dob = p.dout + b * p.do_sb + h * p.do_sh;
  const long long bh = (long long)b * p.heads + h;
  const float* lse_b = p.lse + bh * p.n_q;
  const float* delta_b = p.delta + bh * p.n_q;

  load_tile(k_s, kb, p.k_sn, key0, p.n_k, p.d);
  load_tile(v_s, vb, p.v_sn, key0, p.n_k, p.d);
  bool key_live[8];
  float dk[8][4], dv[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    key_live[r] = key0 + ty + 8 * r < p.n_k;
    dk[r][0] = dk[r][1] = dk[r][2] = dk[r][3] = 0.f;
    dv[r][0] = dv[r][1] = dv[r][2] = dv[r][3] = 0.f;
  }

  const int n_tiles = (p.n_q + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int q0 = tile * kTile;
    load_tile(q_s, qb, p.q_sn, q0, p.n_q, p.d);
    load_tile(do_s, dob, p.do_sn, q0, p.n_q, p.d);
    if (tid < kTile) {
      const bool live = q0 + tid < p.n_q;
      lse_s[tid] = live ? lse_b[q0 + tid] * kLog2e : INFINITY;
      delta_s[tid] = live ? delta_b[q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[8][4], dp[8][4];
    dot_rows(s, k_s, q_s, ty, tx);          // Sᵀ: keys × queries
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        s[r][c] = key_live[r]
                      ? exp2f(s[r][c] * p.scale_log2 - lse_s[tx + 16 * c])
                      : 0.f;
    store_by_column(p_s, s, ty, tx);
    dot_rows(dp, v_s, do_s, ty, tx);        // dPᵀ = V·dOᵀ
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dp[r][c] = s[r][c] * (dp[r][c] - delta_s[tx + 16 * c]);
    store_by_column(ds_s, dp, ty, tx);
    __syncwarp();

    // dV += Pᵀ·dO and dK += dSᵀ·Q over the tile's queries, in query order.
#pragma unroll 2
    for (int i = 0; i < kTile; ++i) {
      axpy_rows(dv, p_s + i * kLdP + 8 * ty, ld4(do_s + i * kLd + 4 * tx));
      axpy_rows(dk, ds_s + i * kLdP + 8 * ty, ld4(q_s + i * kLd + 4 * tx));
    }
    __syncthreads();
  }

  store_rows(p.dk + b * p.dk_sb + h * p.dk_sh, p.dk_sn, key0, p.n_k, p.d, dk,
             p.scale, ty, tx);
  store_rows(p.dv + b * p.dv_sb + h * p.dv_sh, p.dv_sn, key0, p.n_k, p.d, dv,
             1.f, ty, tx);
}

// dQ of one 64-query tile: thread rows are queries, its columns keys.
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_kernel(const Params p) {
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;
  float* do_s = q_s + kTileFloats;
  float* k_s = do_s + kTileFloats;
  float* v_s = k_s + kTileFloats;
  float* ds_s = v_s + kTileFloats;        // dS[key][8ty + r]

  const int tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kTile;
  const float* kb = p.k + b * p.k_sb + h * p.k_sh;
  const float* vb = p.v + b * p.v_sb + h * p.v_sh;
  const long long bh = (long long)b * p.heads + h;

  load_tile(q_s, p.q + b * p.q_sb + h * p.q_sh, p.q_sn, q0, p.n_q, p.d);
  load_tile(do_s, p.dout + b * p.do_sb + h * p.do_sh, p.do_sn, q0, p.n_q,
            p.d);
  float lse2[8], delta[8], dq[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = q0 + ty + 8 * r;
    lse2[r] = row < p.n_q ? p.lse[bh * p.n_q + row] * kLog2e : INFINITY;
    delta[r] = row < p.n_q ? p.delta[bh * p.n_q + row] : 0.f;
    dq[r][0] = dq[r][1] = dq[r][2] = dq[r][3] = 0.f;
  }

  const int n_tiles = (p.n_k + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int key0 = tile * kTile;
    load_tile(k_s, kb, p.k_sn, key0, p.n_k, p.d);
    load_tile(v_s, vb, p.v_sn, key0, p.n_k, p.d);
    __syncthreads();

    float s[8][4], dp[8][4];
    dot_rows(s, q_s, k_s, ty, tx);          // S: queries × keys
    dot_rows(dp, do_s, v_s, ty, tx);        // dP = dO·Vᵀ
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool live = key0 + tx + 16 * c < p.n_k;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float pr = live ? exp2f(s[r][c] * p.scale_log2 - lse2[r]) : 0.f;
        dp[r][c] = pr * (dp[r][c] - delta[r]);
      }
    }
    store_by_column(ds_s, dp, ty, tx);
    __syncwarp();

    // dQ += dS·K over the tile's keys, in key order.
#pragma unroll 4
    for (int j = 0; j < kTile; ++j)
      axpy_rows(dq, ds_s + j * kLdP + 8 * ty, ld4(k_s + j * kLd + 4 * tx));
    __syncthreads();
  }

  store_rows(p.dq + b * p.dq_sb + h * p.dq_sh, p.dq_sn, q0, p.n_q, p.d, dq,
             p.scale, ty, tx);
}

}  // namespace

// fp32 q, k, v, dO (strided, unit last stride), LSE and δ (B, H, n_q)
// contiguous; writes dQ, dK, dV.  Returns the first CUDA error of the two
// launches (0 on success), or cudaErrorInvalidValue for a head_dim the
// kernels do not take.
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, void* dk, void* dv,
    int batch, int n_q, int n_k, int heads, int head_dim, long long q_sb,
    long long q_sn, long long q_sh, long long k_sb, long long k_sn,
    long long k_sh, long long v_sb, long long v_sn, long long v_sh,
    long long do_sb, long long do_sn, long long do_sh, long long dq_sb,
    long long dq_sn, long long dq_sh, long long dk_sb, long long dk_sn,
    long long dk_sh, long long dv_sb, long long dv_sn, long long dv_sh,
    float scale, void* stream) {
  if (head_dim <= 0 || head_dim > kD || head_dim % 4)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.dout = static_cast<const float*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<float*>(dq);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
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

  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDkvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(flash_bwd_dq_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dkv_kernel<<<dim3((n_k + kTile - 1) / kTile, heads, batch),
                         kThreads, kDkvSmem, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_bwd_dq_kernel<<<dim3((n_q + kTile - 1) / kTile, heads, batch),
                        kThreads, kDqSmem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
