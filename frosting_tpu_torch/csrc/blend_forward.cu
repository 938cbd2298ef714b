// Forward alpha blend of depth-ordered Gaussian instances, one block per
// pixel tile, one thread per pixel (the renderCUDA pattern).
//
// Replaces frosting_tpu/raster/blend_pallas.py::blend_forward_pallas (the
// TPU kernel _forward_kernel / _forward_one_tile, math in
// chunk_math.forward_chunk). Same semantics as the plain PyTorch version
// frosting_tpu_torch/raster/blend_torch.py::blend_forward_torch:
//   alpha = min(0.99, op * exp(power)), skipped where power > 0 or the raw
//   value is below 1/255; a pixel stops at the first Gaussian with
//   T * (1 - alpha) < 1e-4, which does not contribute; t_final is T after
//   the last contributing Gaussian.
//
// Bound: FP32 and SFU (exp) throughput over the (instance, pixel) pairs, not
// bytes. Each instance's 9 floats (36 B) are read once per tile into shared
// memory and reused by every pixel of the tile (512 at 32x16). The block
// stages instances in batches of blockDim, gathering through inst_gauss
// straight from the per-Gaussian rows, and leaves the walk as soon as every
// pixel of the tile is done (__syncthreads_count). It writes [4, H, W]
// directly and masks pixels past the image edge.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (frosting_tpu_torch/_build.py). Plain C interface, bound with ctypes.

#include <cuda_runtime.h>

namespace {

constexpr int kWidth = 9;  // fields per Gaussian, raster/config.py
constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;

__global__ void blend_forward_kernel(
    const float* __restrict__ fields,       // [N + 1, 9]
    const int* __restrict__ inst_gauss,     // [M]
    const int* __restrict__ tile_ranges,    // [n_tiles, 2]
    float* __restrict__ out,                // [4, H, W]
    int width, int height, int tiles_x, int tile_w) {
  extern __shared__ float smem[];  // [9][blockDim.x], one row per field
  const int nthreads = blockDim.x;
  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int x = (tile % tiles_x) * tile_w + tid % tile_w;
  const int y = (tile / tiles_x) * (nthreads / tile_w) + tid / tile_w;
  const bool inside = x < width && y < height;
  const float px = static_cast<float>(x);
  const float py = static_cast<float>(y);
  const int start = tile_ranges[2 * tile];
  const int end = tile_ranges[2 * tile + 1];

  float t = 1.0f;
  float r = 0.0f, g = 0.0f, b = 0.0f;
  bool done = !inside;
  for (int base = start; base < end; base += nthreads) {
    // Also the barrier that keeps the previous batch in shared memory until
    // every thread has finished with it.
    if (__syncthreads_count(done) == nthreads) break;
    const int i = base + tid;
    if (i < end) {
      const float* f = fields + static_cast<size_t>(inst_gauss[i]) * kWidth;
#pragma unroll
      for (int c = 0; c < kWidth; ++c) smem[c * nthreads + tid] = f[c];
    }
    __syncthreads();
    const int count = min(nthreads, end - base);
    for (int j = 0; !done && j < count; ++j) {
      const float dx = smem[0 * nthreads + j] - px;
      const float dy = smem[1 * nthreads + j] - py;
      const float ca = smem[2 * nthreads + j];
      const float cb = smem[3 * nthreads + j];
      const float cc = smem[4 * nthreads + j];
      const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
      if (power > 0.0f) continue;
      const float raw = smem[5 * nthreads + j] * expf(power);
      if (raw < kAlphaCutoff) continue;
      const float alpha = fminf(kAlphaClamp, raw);
      const float t_next = t * (1.0f - alpha);
      if (t_next < kTransmittanceEps) {
        done = true;
        break;
      }
      const float w = alpha * t;
      r += w * smem[6 * nthreads + j];
      g += w * smem[7 * nthreads + j];
      b += w * smem[8 * nthreads + j];
      t = t_next;
    }
  }
  if (inside) {
    const size_t plane = static_cast<size_t>(width) * height;
    const size_t p = static_cast<size_t>(y) * width + x;
    out[p] = r;
    out[plane + p] = g;
    out[2 * plane + p] = b;
    out[3 * plane + p] = t;
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int blend_forward_launch(
    const float* fields, const int* inst_gauss, const int* tile_ranges,
    float* out, int width, int height, int tiles_x, int n_tiles, int tile_w,
    int tile_h, void* stream) {
  const int nthreads = tile_w * tile_h;
  const size_t smem = static_cast<size_t>(kWidth) * nthreads * sizeof(float);
  blend_forward_kernel<<<n_tiles, nthreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      fields, inst_gauss, tile_ranges, out, width, height, tiles_x, tile_w);
  return static_cast<int>(cudaGetLastError());
}
