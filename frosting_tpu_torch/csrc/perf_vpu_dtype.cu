// Arithmetic-rate probes P1 and P2: a chain of dependent multiply-adds and a
// chain of dependent exponentials, each in float32 and in bfloat16.
//
// Replaces the two Pallas kernels of scripts/perf_vpu_dtype.py (the FMA
// chain at :64 and the exp chain at :89), which measured the TPU's vector
// unit by dtype. Here they measure what the blend kernels pay for on
// Hopper: FP32 FMA issue (fmaf) beside packed bf16x2 FMA (__hfma2), and the
// SFU's exp (expf, as csrc/blend_common.cuh uses it) beside h2exp on bf16
// pairs.
//
// Both are bound by operations, not bytes: each element is read once and
// written once, and between the two its chain runs in registers. One
// thread takes one float32 element or one bf16 pair; the chains are fully
// unrolled and each step depends on the last, so that the compiler can
// neither drop nor reorder a step. The chains are those of the TPU script:
//   P1: y = x; 400 times y = y * 0.25 + x   (0.25 y is exact, so an FMA
//       rounds as the plain version's multiply-then-add does)
//   P2: y = x; 40 times y = exp(0.25 y)

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kFmaReps = 400;
constexpr int kExpReps = 40;
constexpr int kThreads = 256;

__global__ void chain_fma_f32_kernel(const float* __restrict__ x,
                                     float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float xi = x[i];
  float y = xi;
#pragma unroll
  for (int r = 0; r < kFmaReps; ++r) y = fmaf(y, 0.25f, xi);
  out[i] = y;
}

__global__ void chain_fma_bf16_kernel(const __nv_bfloat162* __restrict__ x,
                                      __nv_bfloat162* __restrict__ out,
                                      int n_pairs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pairs) return;
  const __nv_bfloat162 xi = x[i];
  const __nv_bfloat162 quarter = __float2bfloat162_rn(0.25f);
  __nv_bfloat162 y = xi;
#pragma unroll
  for (int r = 0; r < kFmaReps; ++r) y = __hfma2(y, quarter, xi);
  out[i] = y;
}

__global__ void chain_exp_f32_kernel(const float* __restrict__ x,
                                     float* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float y = x[i];
#pragma unroll
  for (int r = 0; r < kExpReps; ++r) y = expf(__fmul_rn(0.25f, y));
  out[i] = y;
}

__global__ void chain_exp_bf16_kernel(const __nv_bfloat162* __restrict__ x,
                                      __nv_bfloat162* __restrict__ out,
                                      int n_pairs) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pairs) return;
  const __nv_bfloat162 quarter = __float2bfloat162_rn(0.25f);
  __nv_bfloat162 y = x[i];
#pragma unroll
  for (int r = 0; r < kExpReps; ++r) y = h2exp(__hmul2(y, quarter));
  out[i] = y;
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

// Each launcher takes the input and output device pointers, the element
// count (pairs for bf16) and the stream; it launches on that stream, does
// not synchronise, and returns cudaGetLastError().

extern "C" int chain_fma_f32_launch(const float* x, float* out, int n,
                                    void* stream) {
  if (n <= 0) return 0;
  chain_fma_f32_kernel<<<blocks_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(x, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int chain_fma_bf16_launch(const void* x, void* out, int n_pairs,
                                     void* stream) {
  if (n_pairs <= 0) return 0;
  chain_fma_bf16_kernel<<<blocks_for(n_pairs), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat162*>(x), static_cast<__nv_bfloat162*>(out),
      n_pairs);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int chain_exp_f32_launch(const float* x, float* out, int n,
                                    void* stream) {
  if (n <= 0) return 0;
  chain_exp_f32_kernel<<<blocks_for(n), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(x, out, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int chain_exp_bf16_launch(const void* x, void* out, int n_pairs,
                                     void* stream) {
  if (n_pairs <= 0) return 0;
  chain_exp_bf16_kernel<<<blocks_for(n_pairs), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat162*>(x), static_cast<__nv_bfloat162*>(out),
      n_pairs);
  return static_cast<int>(cudaGetLastError());
}
