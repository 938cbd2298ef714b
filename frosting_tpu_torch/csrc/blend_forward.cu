// Forward alpha blend of depth-ordered Gaussian instances: one block per
// pixel tile, one thread per pixel, each warp an 8x4 pixel patch
// (blend_common.cuh).
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
// Bound: FP32 and SFU (exp) instruction throughput over the (instance,
// pixel) pairs a walk has to evaluate, not bytes: each instance's 36 B is
// read once per tile and reused by the tile's 512 pixels. The pairs that
// matter are few: at 1080p most of a tile's pixels lie outside a Gaussian's
// alpha >= 1/255 footprint.
// So the design spends its instructions on live pairs:
//   * each warp covers a compact 8x4 patch, and each staged instance carries
//     its footprint box as a mask of the tile's warps (blend_common.cuh
//     warp_mask); a warp whose patch misses the box skips the instance
//     unevaluated. Exact: a pair outside the box is below the cutoff, which
//     the walk skips anyway. A warp reads 32 masks at once and walks the set
//     bits of their ballot, so a skipped instance costs it no instruction
//     of its own;
//   * instances are staged as 12-float records, read as three float4
//     broadcasts, in batches of 256; the next batch's gather (cp.async) is
//     in flight while the current one is walked;
//   * tiles are taken heaviest first (tile_order: the run lengths sorted
//     descending), so that the longest runs do not land in the last wave;
//   * the block leaves the walk as soon as every pixel is done
//     (__syncthreads_count), a warp as soon as its 32 pixels are.
// It writes [4, H, W] directly and masks pixels past the image edge.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (frosting_tpu_torch/_build.py). Plain C interface, bound with ctypes.

#include <cuda_runtime.h>

#include <algorithm>

#include "blend_common.cuh"

namespace {

using namespace blend;

// Instances staged per step, one per thread of the first kBatch: larger
// batches waste more of the gather when a tile stops early.
constexpr int kBatch = 256;

__global__ void __launch_bounds__(1024) blend_forward_kernel(
    const float* __restrict__ fields,       // [N + 1, 9]
    const int* __restrict__ inst_gauss,     // [M]
    const int* __restrict__ tile_ranges,    // [n_tiles, 2]
    const int* __restrict__ tile_order,     // [n_tiles] heaviest first
    float* __restrict__ out,                // [4, H, W]
    int width, int height, int tiles_x, int tile_w, int tile_h) {
  // [2][batch][12] staged instances, then [2][batch] warp masks
  extern __shared__ float4 smem4[];
  const int nthreads = blockDim.x;
  const int batch = min(nthreads, kBatch);
  float* fbuf = reinterpret_cast<float*>(smem4);
  unsigned* mbuf = reinterpret_cast<unsigned*>(fbuf + 2 * batch * kStride);
  const int tid = threadIdx.x;
  const int tile = tile_order[blockIdx.x];
  const Pixel p = tile_pixel(tile, tiles_x, tile_w, tile_h);
  const bool inside = p.x < width && p.y < height;
  const float px = static_cast<float>(p.x);
  const float py = static_cast<float>(p.y);
  const int start = tile_ranges[2 * tile];
  const int end = tile_ranges[2 * tile + 1];

  stage(fbuf, fields, inst_gauss, start, min(batch, end - start), tid);
  cp_async_commit();

  float t = 1.0f;
  float r = 0.0f, g = 0.0f, b = 0.0f;
  bool done = !inside;
  int cur = 0;
  for (int base = start; base < end; base += batch, cur ^= 1) {
    cp_async_wait_all();
    // Also the barrier after which the batch is visible to all, and after
    // which the other buffer, walked in the previous step, may be refilled.
    if (__syncthreads_count(done) == nthreads) break;
    const int count = min(batch, end - base);
    const float* fb = fbuf + cur * batch * kStride;
    unsigned* mb = mbuf + cur * batch;
    if (tid < count) {
      mb[tid] = warp_mask(fb + tid * kStride, p.tx0, p.ty0, p.patches_x,
                          p.patches_y);
    }
    const int next = base + batch;
    if (next < end) {
      stage(fbuf + (cur ^ 1) * batch * kStride, fields, inst_gauss, next,
            min(batch, end - next), tid);
    }
    cp_async_commit();
    __syncthreads();

    bool warp_done = __all_sync(kFullMask, done);
    for (int j0 = 0; j0 < count && !warp_done; j0 += 32) {
      // the next 32 instances that this warp's patch meets, as bits
      unsigned bits = __ballot_sync(kFullMask, warp_meets(mb, j0 + p.lane,
                                                          count, p.warp));
      for (; bits && !warp_done; bits &= bits - 1) {
        const int j = j0 + __ffs(bits) - 1;
        const float4* rec = reinterpret_cast<const float4*>(fb + j * kStride);
        if (!done) {
          const float4 f0 = rec[0];
          const float4 f1 = rec[1];
          float dx, dy, raw, alpha, t_next;
          if (pair_alpha(f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, px, py, dx, dy,
                         raw, alpha)) {
            if (stops(t, alpha, t_next)) {
              done = true;
            } else {
              const float w = alpha * t;
              r += w * f1.z;
              g += w * f1.w;
              b += w * rec[2].x;
              t = t_next;
            }
          }
        }
        warp_done = __all_sync(kFullMask, done);
      }
    }
  }
  cp_async_wait_all();
  if (inside) {
    const size_t plane = static_cast<size_t>(width) * height;
    const size_t q = static_cast<size_t>(p.y) * width + p.x;
    out[q] = r;
    out[plane + q] = g;
    out[2 * plane + q] = b;
    out[3 * plane + q] = t;
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns the first CUDA error
// (0 if none). tile_w must be a multiple of 8, tile_h of 4, and the tile at
// most 1024 pixels.
extern "C" int blend_forward_launch(
    const float* fields, const int* inst_gauss, const int* tile_ranges,
    const int* tile_order, float* out, int width, int height, int tiles_x,
    int n_tiles, int tile_w, int tile_h, void* stream) {
  const int nthreads = tile_w * tile_h;
  if (tile_w % kPatchW || tile_h % kPatchH || nthreads > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(std::min(nthreads, kBatch)) * 2 *
                      (kStride * sizeof(float) + sizeof(unsigned));
  const cudaError_t err = cudaFuncSetAttribute(
      blend_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  blend_forward_kernel<<<n_tiles, nthreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      fields, inst_gauss, tile_ranges, tile_order, out, width, height,
      tiles_x, tile_w, tile_h);
  return static_cast<int>(cudaGetLastError());
}
