// The Wan DiT's q/k prologue for Hopper (sm_90a): the pass between an
// attention layer's input products and the attention, in one kernel.
//
// For a token row of the bias-free product x (rows, parts·d), part i of d
// columns becomes
//   y_i = x_i + bias_i                          (every part)
//   y_i = y_i · rsqrt(mean(y_i²) + eps) · scale_i   (the first `norms` parts)
//   y_i = RoPE(y_i)                             (those parts, with tables)
// and is written contiguous (rows, d), i.e. (B, N, H, Dh), all in bf16 (the
// DiT's dtype on the card).  The DiT's
// self-attention hands it the fused QKV product (parts 3: q and k normed and
// rotated, v with its bias only), its cross-attention the q product over
// the latent tokens and the k product over the text tokens (parts 1, no
// tables).  The RMS statistic spans all heads of a part (the full inner
// width), so one block owns one row and reduces it within the block.
//
// It replaces no TPU kernel: on the TPU, XLA fused this chain of
// `vist3a_tpu/nn/wan_dit.py::attention` by itself.  On the card PyTorch ran
// it as ~35 separate elementwise, reduce and copy launches a layer, each
// round trip of a (B, N, d) plane through device memory (~116 planes a
// 14B block).  Here every element is read once and written once: the bound
// is bytes, 6 planes a self-attention call ((2, 4096, 5120) bf16: 503 MB,
// 0.150 ms at 3.35 TB/s; 1.3B (2, 4096, 1536): 151 MB, 0.045 ms), 2 for
// the cross-attention's q (0.050 ms at 14B) and 2 small ones for its k.
//
// Rounding points (those of the port's plain version, which are the JAX
// package's): the bias is added in fp32 to the product as stored and rounded
// once to bf16; the mean of squares is taken in fp32 over the full width
// (only the order of its sum differs from PyTorch's); y·rsqrt(ms + eps) and
// then ·scale in fp32, rounded to bf16; RoPE reads that value back, rotates
// each consecutive (even, odd) pair in fp32 (xr·c − xi·s, xr·s + xi·c, each
// product rounded) and rounds.  The
// intrinsics (__fmul_rn, __fadd_rn, __fsub_rn) keep nvcc from contracting a
// product and a sum into one FMA, which would round once where PyTorch
// rounds twice.
//
// Design: a thread owns 8 consecutive columns of each part (one 16-byte
// load of bf16), so a block has d/8 threads rounded up to whole warps (640
// at 14B, 192 at 1.3B).  Pass 1 reads the row, stores the bias-only part
// (v) at once and sums the normed parts' squares; after the block's
// reduction, pass 2 reads the normed parts again, from L1 or L2 (the row's
// q and k are 20 KB at 14B), and scales, rotates and stores them.  Holding
// nothing across the barrier keeps registers few, so several blocks share
// an SM and one's loads overlap another's reduction.  The RoPE tables
// (N, Dh/2) fp32 are read as 4 (cos, sin) pairs a thread; every head of a
// row reads the same 256 bytes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libqk_prologue.so qk_prologue.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kVec = 8;            // columns of one part a thread owns
constexpr int kMaxParts = 3;
constexpr int kMaxNorms = 2;
constexpr int kMaxThreads = 1024;  // so d ≤ 8192

struct Params {
  const bf16* x;                   // (rows, parts·d)
  const bf16* bias[kMaxParts];     // (d,) each
  const bf16* scale[kMaxNorms];    // (d,) each
  const float* cos;                // (n_tok, head_dim/2), or nullptr
  const float* sin;
  bf16* out[kMaxParts];            // (rows, d) each
  int d, head_dim, n_tok, parts, norms;
  float eps, inv_d;
};

__device__ __forceinline__ void load8(const bf16* p, float v[kVec]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(bf16* p, const float v[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < kVec / 2; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// round to bf16 and read back as fp32
__device__ __forceinline__ float rounded(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// one (even, odd) pair of RoPE: xr·c − xi·s, xr·s + xi·c, each product and
// sum rounded on its own
__device__ __forceinline__ void rotate(float& xr, float& xi, float c, float s) {
  const float r = __fsub_rn(__fmul_rn(xr, c), __fmul_rn(xi, s));
  xi = __fadd_rn(__fmul_rn(xr, s), __fmul_rn(xi, c));
  xr = r;
}

// y = x + bias, rounded to bf16
__device__ __forceinline__ void biased(const bf16* x, const bf16* bias,
                                       float y[kVec]) {
  float b[kVec];
  load8(x, y);
  load8(bias, b);
#pragma unroll
  for (int e = 0; e < kVec; ++e) y[e] = rounded(__fadd_rn(y[e], b[e]));
}

__global__ void __launch_bounds__(kMaxThreads)
qk_prologue_kernel(const Params p) {
  __shared__ float partial[kMaxNorms][kMaxThreads / 32];
  const int row = blockIdx.x;
  const int col = threadIdx.x * kVec;
  const bool live = col < p.d;
  const bf16* x = p.x + (long long)row * p.parts * p.d;
  float y[kVec];

  // pass 1: the parts with a bias only are stored now, the normed parts'
  // squares summed over this thread's columns
  float ss[kMaxNorms] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kMaxParts; ++i) {
    if (i < p.parts && live) {
      biased(x + i * p.d + col, p.bias[i] + col, y);
      if (i >= p.norms) {
        store8(p.out[i] + (long long)row * p.d + col, y);
      } else {
        const int j = i < kMaxNorms ? i : 0;   // norms ≤ kMaxNorms: i = j
#pragma unroll
        for (int e = 0; e < kVec; ++e) ss[j] = __fadd_rn(ss[j], __fmul_rn(y[e], y[e]));
      }
    }
  }

  // the rows' sums of squares within each warp, then over the warps
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kMaxNorms; ++j) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss[j] = __fadd_rn(ss[j], __shfl_xor_sync(0xffffffffu, ss[j], off));
    if (lane == 0) partial[j][warp] = ss[j];
  }
  __syncthreads();
  if (!live) return;

  // pass 2: the normed parts again (their columns were just read: L1 or L2
  // serves them, not device memory), scaled, rotated and stored
#pragma unroll
  for (int j = 0; j < kMaxNorms; ++j) {
    if (j >= p.norms) continue;
    float t = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t = __fadd_rn(t, partial[j][w]);
    const float inv_rms = rsqrtf(__fadd_rn(__fmul_rn(t, p.inv_d), p.eps));
    float sc[kVec];
    biased(x + j * p.d + col, p.bias[j] + col, y);
    load8(p.scale[j] + col, sc);
#pragma unroll
    for (int e = 0; e < kVec; ++e) y[e] = rounded(__fmul_rn(__fmul_rn(y[e], inv_rms), sc[e]));
    if (p.cos != nullptr) {
      const int half = p.head_dim / 2;
      const long long at = (long long)(row % p.n_tok) * half + (col % p.head_dim) / 2;
      const float4 c = __ldg(reinterpret_cast<const float4*>(p.cos + at));
      const float4 s = __ldg(reinterpret_cast<const float4*>(p.sin + at));
      rotate(y[0], y[1], c.x, s.x);
      rotate(y[2], y[3], c.y, s.y);
      rotate(y[4], y[5], c.z, s.z);
      rotate(y[6], y[7], c.w, s.w);
    }
    store8(p.out[j] + (long long)row * p.d + col, y);
  }
}

}  // namespace

// x (rows, parts·d); biases of `parts` parts; scales of the first `norms`
// parts; cos/sin (n_tok, head_dim/2) fp32 or null; outputs (rows, d) each;
// all but the tables bf16.  The wrapper (`vist3a_tpu_torch/kernels/
// qk_prologue.py`) checks shapes, dtypes, contiguity and 16-byte alignment.
// Returns the launch's CUDA error.
extern "C" int qk_prologue(const void* x, const void* bias_q,
                           const void* bias_k, const void* bias_v,
                           const void* scale_q, const void* scale_k,
                           const float* cos, const float* sin, void* out_q,
                           void* out_k, void* out_v, int rows, int n_tok,
                           int d, int head_dim, int parts, int norms,
                           float eps, void* stream) {
  if (parts < 1 || parts > kMaxParts || norms < 1 || norms > kMaxNorms ||
      norms > parts || d % kVec || d / kVec > kMaxThreads || head_dim % kVec ||
      rows < 1 || n_tok < 1)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.bias[0] = static_cast<const bf16*>(bias_q);
  p.bias[1] = static_cast<const bf16*>(bias_k);
  p.bias[2] = static_cast<const bf16*>(bias_v);
  p.scale[0] = static_cast<const bf16*>(scale_q);
  p.scale[1] = static_cast<const bf16*>(scale_k);
  p.cos = cos;
  p.sin = sin;
  p.out[0] = static_cast<bf16*>(out_q);
  p.out[1] = static_cast<bf16*>(out_k);
  p.out[2] = static_cast<bf16*>(out_v);
  p.d = d;
  p.head_dim = head_dim;
  p.n_tok = n_tok;
  p.parts = parts;
  p.norms = norms;
  p.eps = eps;
  p.inv_d = 1.0f / (float)d;
  const int threads = (d / kVec + 31) / 32 * 32;
  qk_prologue_kernel<<<rows, threads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
