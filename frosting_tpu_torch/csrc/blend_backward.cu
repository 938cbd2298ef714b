// Backward alpha blend: per-instance gradient rows of a loss whose cotangent
// on the forward's [4, H, W] result is given. One block per pixel tile, one
// thread per pixel, as the forward kernel (blend_forward.cu).
//
// Replaces frosting_tpu/raster/blend_pallas.py::blend_backward_pallas (the
// TPU kernel _backward_kernel / _backward_one_tile, math in
// chunk_math.backward_chunk). Same semantics as the plain PyTorch version
// frosting_tpu_torch/raster/blend_torch.py::blend_backward_torch: a
// forward-order re-walk of the tile's run with the forward's exact stop test,
// carrying T and the prefix g . C_prefix of each pixel. For a contributing
// pair, with u = g . colour, w = alpha * T and gS = g . C_total - g . C_prefix
// (the prefix inclusive of this pair),
//   dalpha = u * T - gS / (1 - alpha) - g_T * T_final / (1 - alpha),
//   dpower = dalpha * alpha where the pair is live and alpha is unclamped.
// The nine per-instance sums over the tile's pixels are dpower, dpower * dx,
// dpower * dy, dpower * dx^2, dpower * dy^2, dpower * dx * dy and w * g
// (three channels); the row is then dmean2d = -(conic . (sx, sy)), dconic =
// (-sxx / 2, -sxy, -syy / 2), dopacity = sum dpower / op (op = 0 guarded) and
// dcolour = sum w * g.
//
// Each instance lies in exactly one tile, so the block that owns the tile
// owns the instance's output row: no global atomics. Per instance, each warp
// sums its 32 pixels' nine terms with shuffles (skipped when no pixel of the
// warp contributes) and writes them to its own slot in shared memory; after
// each batch the per-warp partials are summed in warp order. The result is
// deterministic. Instances past every pixel's stop keep the zero rows the
// caller allocates.
//
// Bound: operations, not bytes. Per evaluated (instance, pixel) pair the
// forward's 12 flops and one exp, about 30 more flops and one reciprocal on
// the SFU; bytes are the fields gathered per instance, out and g_out read
// once and the [M, 9] rows written once. Shared memory: 9 x kBatch fields
// plus n_warps x 9 x kBatch partials, 39 KB at kBatch 64 and 32x16 tiles.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (frosting_tpu_torch/_build.py). Plain C interface, bound with ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kWidth = 9;  // fields per Gaussian, raster/config.py
constexpr int kBatch = 64;  // instances staged in shared memory per step
constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void blend_backward_kernel(
    const float* __restrict__ fields,       // [N + 1, 9]
    const int* __restrict__ inst_gauss,     // [M]
    const int* __restrict__ tile_ranges,    // [n_tiles, 2]
    const float* __restrict__ out,          // [4, H, W] forward result
    const float* __restrict__ g_out,        // [4, H, W] cotangent
    float* __restrict__ grads,              // [M, 9], zero on entry
    int width, int height, int tiles_x, int tile_w) {
  // [9][kBatch] fields, then [n_warps][9][kBatch] per-warp partial sums
  extern __shared__ float smem[];
  const int nthreads = blockDim.x;
  const int n_warps = nthreads / 32;
  float* sf = smem;
  float* part = smem + kWidth * kBatch;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  float* warp_part = part + (tid >> 5) * kWidth * kBatch;
  const int tile = blockIdx.x;
  const int x = (tile % tiles_x) * tile_w + tid % tile_w;
  const int y = (tile / tiles_x) * (nthreads / tile_w) + tid / tile_w;
  const bool inside = x < width && y < height;
  const float px = static_cast<float>(x);
  const float py = static_cast<float>(y);
  const int start = tile_ranges[2 * tile];
  const int end = tile_ranges[2 * tile + 1];

  float g_r = 0.0f, g_g = 0.0f, g_b = 0.0f;
  float gc_total = 0.0f;  // g . C_total
  float g_tfinal = 0.0f;  // g_T * T_final
  if (inside) {
    const size_t plane = static_cast<size_t>(width) * height;
    const size_t p = static_cast<size_t>(y) * width + x;
    g_r = g_out[p];
    g_g = g_out[plane + p];
    g_b = g_out[2 * plane + p];
    gc_total = g_r * out[p] + g_g * out[plane + p] + g_b * out[2 * plane + p];
    g_tfinal = g_out[3 * plane + p] * out[3 * plane + p];
  }

  float t = 1.0f;
  float gc_pre = 0.0f;  // g . C_prefix, inclusive of the current pair
  bool done = !inside;
  for (int base = start; base < end; base += kBatch) {
    // Also the barrier that keeps the previous batch's fields and sums in
    // shared memory until every thread has finished with them.
    if (__syncthreads_count(done) == nthreads) break;
    const int count = min(kBatch, end - base);
    if (tid < count) {
      const float* f = fields + static_cast<size_t>(inst_gauss[base + tid]) * kWidth;
#pragma unroll
      for (int c = 0; c < kWidth; ++c) sf[c * kBatch + tid] = f[c];
    }
    for (int e = tid; e < n_warps * kWidth * kBatch; e += nthreads) part[e] = 0.0f;
    __syncthreads();

    for (int j = 0; j < count; ++j) {
      if (__all_sync(kFullMask, done)) break;  // warp-uniform
      float v[kWidth];
#pragma unroll
      for (int c = 0; c < kWidth; ++c) v[c] = 0.0f;
      bool hit = false;
      if (!done) {
        // the forward's expressions, in its order, so that both stop at the
        // same Gaussian
        const float dx = sf[0 * kBatch + j] - px;
        const float dy = sf[1 * kBatch + j] - py;
        const float ca = sf[2 * kBatch + j];
        const float cb = sf[3 * kBatch + j];
        const float cc = sf[4 * kBatch + j];
        const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
        if (power <= 0.0f) {
          const float raw = sf[5 * kBatch + j] * expf(power);
          if (raw >= kAlphaCutoff) {
            const float alpha = fminf(kAlphaClamp, raw);
            const float t_next = t * (1.0f - alpha);
            if (t_next < kTransmittanceEps) {
              done = true;
            } else {
              const float w = alpha * t;
              const float u = g_r * sf[6 * kBatch + j] + g_g * sf[7 * kBatch + j] +
                              g_b * sf[8 * kBatch + j];
              gc_pre += u * w;
              const float inv = 1.0f / (1.0f - alpha);
              const float dalpha = u * t - (gc_total - gc_pre) * inv - g_tfinal * inv;
              const float dp = raw < kAlphaClamp ? dalpha * alpha : 0.0f;
              v[0] = dp;
              v[1] = dp * dx;
              v[2] = dp * dy;
              v[3] = dp * dx * dx;
              v[4] = dp * dy * dy;
              v[5] = dp * dx * dy;
              v[6] = w * g_r;
              v[7] = w * g_g;
              v[8] = w * g_b;
              hit = true;
              t = t_next;
            }
          }
        }
      }
      if (__any_sync(kFullMask, hit)) {
#pragma unroll
        for (int c = 0; c < kWidth; ++c) {
#pragma unroll
          for (int off = 16; off > 0; off >>= 1) {
            v[c] += __shfl_xor_sync(kFullMask, v[c], off);
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < kWidth; ++c) warp_part[c * kBatch + j] = v[c];
        }
      }
    }
    __syncthreads();

    // Sum the warps' partials in warp order into warp 0's slots: each
    // (term, instance) slot is read and written by one thread only.
    for (int e = tid; e < kWidth * count; e += nthreads) {
      const int slot = (e / count) * kBatch + e % count;
      float s = part[slot];
      for (int w = 1; w < n_warps; ++w) s += part[w * kWidth * kBatch + slot];
      part[slot] = s;
    }
    __syncthreads();

    if (tid < count) {
      const float s0 = part[0 * kBatch + tid];
      const float sx = part[1 * kBatch + tid];
      const float sy = part[2 * kBatch + tid];
      const float sxx = part[3 * kBatch + tid];
      const float syy = part[4 * kBatch + tid];
      const float sxy = part[5 * kBatch + tid];
      const float ca = sf[2 * kBatch + tid];
      const float cb = sf[3 * kBatch + tid];
      const float cc = sf[4 * kBatch + tid];
      const float op = sf[5 * kBatch + tid];
      float* row = grads + static_cast<size_t>(base + tid) * kWidth;
      row[0] = -(ca * sx + cb * sy);
      row[1] = -(cc * sy + cb * sx);
      row[2] = -0.5f * sxx;
      row[3] = -sxy;
      row[4] = -0.5f * syy;
      row[5] = s0 / (op == 0.0f ? 1.0f : op);
      row[6] = part[6 * kBatch + tid];
      row[7] = part[7 * kBatch + tid];
      row[8] = part[8 * kBatch + tid];
    }
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns the first CUDA error
// (0 if none). tile_w * tile_h must be a multiple of 32.
extern "C" int blend_backward_launch(
    const float* fields, const int* inst_gauss, const int* tile_ranges,
    const float* out, const float* g_out, float* grads, int width, int height,
    int tiles_x, int n_tiles, int tile_w, int tile_h, void* stream) {
  const int nthreads = tile_w * tile_h;
  const size_t smem =
      static_cast<size_t>(kWidth) * kBatch * (1 + nthreads / 32) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        blend_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  blend_backward_kernel<<<n_tiles, nthreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      fields, inst_gauss, tile_ranges, out, g_out, grads, width, height,
      tiles_x, tile_w);
  return static_cast<int>(cudaGetLastError());
}
