// Backward alpha blend: per-instance gradient rows of a loss whose cotangent
// on the forward's [4, H, W] result is given. One block per pixel tile, one
// thread per pixel, each warp an 8x4 pixel patch, as the forward kernel
// (blend_forward.cu, blend_common.cuh).
//
// Replaces frosting_tpu/raster/blend_pallas.py::blend_backward_pallas (the
// TPU kernel _backward_kernel / _backward_one_tile, math in
// chunk_math.backward_chunk). Same semantics as the plain PyTorch version
// frosting_tpu_torch/raster/blend_torch.py::blend_backward_torch: a
// forward-order re-walk of the tile's run with the forward's exact
// expressions and stop test, carrying T and the prefix g . C_prefix of each
// pixel. For a contributing pair, with u = g . colour, w = alpha * T and
// gS = g . C_total - g . C_prefix (the prefix inclusive of this pair),
//   dalpha = u * T - gS / (1 - alpha) - g_T * T_final / (1 - alpha),
//   dpower = dalpha * alpha where the pair is live and alpha is unclamped.
// Each instance's row needs nine sums over the tile's pixels: the moments
// of dpower against the tile-centred basis (1, x, y, x^2, y^2, xy) and the
// colour sums g^T w; the row is then dmean2d = -(conic . (sx, sy)), dconic
// = (-sxx / 2, -sxy, -syy / 2), dopacity = sum dpower / op (op = 0 guarded)
// and dcolour = sum w * g, with the moments expanded around the
// tile-centred mean (chunk_math.py's moment product).
//
// Bound: operations, not bytes. Per evaluated pair the forward's math and
// about 30 more flops and one reciprocal; bytes are the gathered fields,
// out and g_out read once and the [M, 9] rows written once. What bounded
// the first design on this card was not the pair math but the per-instance
// reductions: 45 shuffles and adds per (warp, instance) for nine butterfly
// sums, in every warp, for every instance of the tile. The design:
//   * footprint boxes (blend_common.cuh warp_mask): a warp whose 8x4 patch
//     misses an instance's alpha >= 1/255 box skips it unevaluated (exact),
//     walking the set bits of a ballot of 32 instances' masks at a time;
//   * the warp's sums on the tensor cores: lanes write dpower and w of up to
//     8 instances that some lane of the warp contributes to into a per-warp
//     slab in shared memory, and one group of mma.sync m16n8k8 TF32
//     products computes the 6 moments (basis x dpower) and 3 colour sums
//     (g x w) of the 8 instances at once. The
//     basis values are integers of at most 9 significant bits, exact in
//     TF32; dpower is split into two TF32 parts (two passes), g and w into
//     two each (three passes: hi hi, hi lo, lo hi), so the sums keep FP32
//     accuracy (blend_torch.py moment_rows_tf32 is the plain form). About
//     20 mma per 8 instances in place of 8 x 90 shuffles and adds; the
//     warp's colour cotangents wait in shared memory, pre-split;
//   * the per-warp sums, zeroed per batch, are added across warps in warp
//     order: the rows are deterministic, bitwise;
//   * 12-float staged records read as float4 broadcasts, double-buffered
//     cp.async gathers, heaviest tiles first, as the forward.
// Each instance lies in exactly one tile, so the block that owns the tile
// owns the instance's output row: no global atomics. Instances past every
// pixel's stop keep the zero rows the caller allocates.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler
// -fPIC (frosting_tpu_torch/_build.py). Plain C interface, bound with ctypes.

#include <cuda_runtime.h>

#include "blend_common.cuh"

namespace {

using namespace blend;

// Instances staged per step. The per-warp sums take 16 x 9 x kBatch floats:
// at 64 two blocks fit an SM; larger batches also fit but did not run
// faster on the H100.
constexpr int kBatch = 64;
constexpr int kGroup = 8;     // instances per tensor-core product (mma N)
constexpr int kSlabRow = 36;  // 32 pixels + 4: conflict-free fragment loads
constexpr int kSlab = 2 * kGroup * kSlabRow;  // dpower and w, per warp
// The warp's colour cotangent split into TF32 parts, [hi, lo][r, g, b][36]:
// the colour rows of the products' A, read at each flush (held in
// registers, they made the kernel spill).
constexpr int kGtab = 2 * 3 * kSlabRow;

// Shared memory of a block of n_warps warps, in floats.
constexpr size_t smem_floats(int n_warps) {
  return 2 * kBatch * kStride      // staged instances, double-buffered
         + 2 * kBatch              // warp masks, double-buffered
         + n_warps * kWidth * kBatch  // per-warp sums
         + kWidth * kBatch         // the sums across warps
         + n_warps * kSlab         // per-warp slabs
         + n_warps * kGtab;        // per-warp colour cotangents
}

// float -> the nearest TF32 value (ties away from zero), as bits with the
// low 13 mantissa bits clear (blend_torch.py round_tf32).
__device__ __forceinline__ unsigned tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32(x);
  lo = tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// d += A (16x8, row-major) . B (8x8, column-major), TF32 in, FP32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], unsigned a0,
                                         unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Row r of the tile-centred basis (1, x, y, x^2, y^2, xy; 0 past row 5) is
// basis_x(r, x) * basis_y(r, y).
__device__ __forceinline__ float basis_x(int r, float x) {
  return r == 1 || r == 5 ? x : r == 3 ? x * x : r < 6 ? 1.0f : 0.0f;
}

__device__ __forceinline__ float basis_y(int r, float y) {
  return r == 2 || r == 5 ? y : r == 4 ? y * y : 1.0f;
}

__global__ void __launch_bounds__(1024) blend_backward_kernel(
    const float* __restrict__ fields,       // [N + 1, 9]
    const int* __restrict__ inst_gauss,     // [M]
    const int* __restrict__ tile_ranges,    // [n_tiles, 2]
    const int* __restrict__ tile_order,     // [n_tiles] heaviest first
    const float* __restrict__ out,          // [4, H, W] forward result
    const float* __restrict__ g_out,        // [4, H, W] cotangent
    float* __restrict__ grads,              // [M, 9], zero on entry
    int width, int height, int tiles_x, int tile_w, int tile_h) {
  extern __shared__ float4 smem4[];
  const int nthreads = blockDim.x;
  const int n_warps = nthreads >> 5;
  float* fbuf = reinterpret_cast<float*>(smem4);           // [2][kBatch][12]
  unsigned* mbuf = reinterpret_cast<unsigned*>(fbuf + 2 * kBatch * kStride);
  float* part = reinterpret_cast<float*>(mbuf + 2 * kBatch);  // [w][9][kBatch]
  float* sums = part + n_warps * kWidth * kBatch;           // [9][kBatch]
  float* slab = sums + kWidth * kBatch;
  const int tid = threadIdx.x;
  const int tile = tile_order[blockIdx.x];
  const Pixel p = tile_pixel(tile, tiles_x, tile_w, tile_h);
  const int lane = p.lane;
  float* slab_dp = slab + p.warp * kSlab;  // [kGroup][kSlabRow]
  float* slab_w = slab_dp + kGroup * kSlabRow;
  float* gtab = slab + n_warps * kSlab + p.warp * kGtab;
  float* warp_part = part + p.warp * kWidth * kBatch;
  const bool inside = p.x < width && p.y < height;
  const float px = static_cast<float>(p.x);
  const float py = static_cast<float>(p.y);
  const int start = tile_ranges[2 * tile];
  const int end = tile_ranges[2 * tile + 1];

  stage(fbuf, fields, inst_gauss, start, min(kBatch, end - start), tid);
  cp_async_commit();

  float g_r = 0.0f, g_g = 0.0f, g_b = 0.0f;
  float gc_total = 0.0f;  // g . C_total
  float g_tfinal = 0.0f;  // g_T * T_final
  if (inside) {
    const size_t plane = static_cast<size_t>(width) * height;
    const size_t q = static_cast<size_t>(p.y) * width + p.x;
    g_r = g_out[q];
    g_g = g_out[plane + q];
    g_b = g_out[2 * plane + q];
    gc_total = g_r * out[q] + g_g * out[plane + q] + g_b * out[2 * plane + q];
    g_tfinal = g_out[3 * plane + q] * out[3 * plane + q];
  }

  // mma fragments: group = lane / 4 is a row of A and a column (instance
  // slot) of B; quad = lane % 4 a column of A and a row of B. The pixels of
  // k-step ks are lanes ks * 8 + quad and ks * 8 + quad + 4, at patch
  // offsets (quad, ks) and (quad + 4, ks). A's rows 0..5 are the basis
  // (against dpower), rows 8..10 the colour cotangent (against w), split
  // into TF32 parts in the warp's gtab.
  const int group = lane >> 2;
  const int quad = lane & 3;
  const float xo = static_cast<float>(p.x - lane % kPatchW + quad - p.tx0) -
                   0.5f * tile_w;  // tile-centred x of pixel quad
  const float yo0 = static_cast<float>(p.y - lane / kPatchW - p.ty0) -
                    0.5f * tile_h;  // tile-centred y of patch row 0
  const float bx0 = basis_x(group, xo);
  const float bx1 = basis_x(group, xo + 4.0f);
  {  // each lane its own pixel's cotangent; read at flushes, after __syncwarp
    unsigned hi, lo;
    split_tf32(g_r, hi, lo);
    gtab[0 * kSlabRow + lane] = __uint_as_float(hi);
    gtab[3 * kSlabRow + lane] = __uint_as_float(lo);
    split_tf32(g_g, hi, lo);
    gtab[1 * kSlabRow + lane] = __uint_as_float(hi);
    gtab[4 * kSlabRow + lane] = __uint_as_float(lo);
    split_tf32(g_b, hi, lo);
    gtab[2 * kSlabRow + lane] = __uint_as_float(hi);
    gtab[5 * kSlabRow + lane] = __uint_as_float(lo);
  }
  const bool gcol = group < 3;
  const int gk = (gcol ? group : 0) * kSlabRow + quad;

  // Sums of the slab's first n instance slots, written to the warp's sums
  // at the slots' batch indices (slot_j: lane s holds slot s's index).
  auto flush = [&](int n, int slot_j) {
    __syncwarp();
    float d[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const int k = group * kSlabRow + ks * 8 + quad;
      unsigned dp_hi0, dp_lo0, dp_hi1, dp_lo1, w_hi0, w_lo0, w_hi1, w_lo1;
      split_tf32(slab_dp[k], dp_hi0, dp_lo0);
      split_tf32(slab_dp[k + 4], dp_hi1, dp_lo1);
      split_tf32(slab_w[k], w_hi0, w_lo0);
      split_tf32(slab_w[k + 4], w_hi1, w_lo1);
      const float by = basis_y(group, yo0 + ks);
      const unsigned b0 = __float_as_uint(bx0 * by);
      const unsigned b1 = __float_as_uint(bx1 * by);
      mma_tf32(d, b0, 0u, b1, 0u, dp_hi0, dp_hi1);
      mma_tf32(d, b0, 0u, b1, 0u, dp_lo0, dp_lo1);
      const float* gt = gtab + gk + ks * 8;
      const unsigned gh0 = gcol ? __float_as_uint(gt[0]) : 0u;
      const unsigned gh1 = gcol ? __float_as_uint(gt[4]) : 0u;
      const unsigned gl0 = gcol ? __float_as_uint(gt[3 * kSlabRow]) : 0u;
      const unsigned gl1 = gcol ? __float_as_uint(gt[3 * kSlabRow + 4]) : 0u;
      mma_tf32(d, 0u, gh0, 0u, gh1, w_hi0, w_hi1);
      mma_tf32(d, 0u, gh0, 0u, gh1, w_lo0, w_lo1);
      mma_tf32(d, 0u, gl0, 0u, gl1, w_hi0, w_hi1);
    }
    __syncwarp();
    // d[0], d[1]: row group, slots 2 quad and 2 quad + 1; d[2], d[3]: row
    // group + 8
    const int ja = __shfl_sync(kFullMask, slot_j, 2 * quad);
    const int jb = __shfl_sync(kFullMask, slot_j, 2 * quad + 1);
    if (group < 6) {
      if (2 * quad < n) warp_part[group * kBatch + ja] = d[0];
      if (2 * quad + 1 < n) warp_part[group * kBatch + jb] = d[1];
    }
    if (group < 3) {
      if (2 * quad < n) warp_part[(6 + group) * kBatch + ja] = d[2];
      if (2 * quad + 1 < n) warp_part[(6 + group) * kBatch + jb] = d[3];
    }
  };

  float t = 1.0f;
  float gc_pre = 0.0f;  // g . C_prefix, inclusive of the current pair
  bool done = !inside;
  int cur = 0;
  for (int base = start; base < end; base += kBatch, cur ^= 1) {
    cp_async_wait_all();
    // Also the barrier after which the batch is visible to all, and after
    // which the previous batch's buffers may be reused.
    if (__syncthreads_count(done) == nthreads) break;
    const int count = min(kBatch, end - base);
    const float* fb = fbuf + cur * kBatch * kStride;
    unsigned* mb = mbuf + cur * kBatch;
    if (tid < count) {
      mb[tid] = warp_mask(fb + tid * kStride, p.tx0, p.ty0, p.patches_x,
                          p.patches_y);
    }
    const int next = base + kBatch;
    if (next < end) {
      stage(fbuf + (cur ^ 1) * kBatch * kStride, fields, inst_gauss, next,
            min(kBatch, end - next), tid);
    }
    cp_async_commit();
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int e = tid; e < n_warps * kWidth * kBatch / 4; e += nthreads) {
      reinterpret_cast<float4*>(part)[e] = zero;
    }
    __syncthreads();

    int slot = 0, slot_j = 0;
    bool warp_done = __all_sync(kFullMask, done);
    for (int j0 = 0; j0 < count && !warp_done; j0 += 32) {
      // the next 32 instances that this warp's patch meets, as bits
      unsigned bits = __ballot_sync(kFullMask, warp_meets(mb, j0 + lane,
                                                          count, p.warp));
      for (; bits && !warp_done; bits &= bits - 1) {
        const int j = j0 + __ffs(bits) - 1;
        float dp = 0.0f, w = 0.0f;
        bool hit = false;
        if (!done) {
          const float4* rec = reinterpret_cast<const float4*>(fb + j * kStride);
          const float4 f0 = rec[0];
          const float4 f1 = rec[1];
          float dx, dy, raw, alpha, t_next;
          if (pair_alpha(f0.x, f0.y, f0.z, f0.w, f1.x, f1.y, px, py, dx, dy,
                         raw, alpha)) {
            if (stops(t, alpha, t_next)) {
              done = true;
            } else {
              w = alpha * t;
              const float u = g_r * f1.z + g_g * f1.w + g_b * rec[2].x;
              gc_pre += u * w;
              const float inv = inv_one_minus(alpha);
              const float dalpha =
                  u * t - (gc_total - gc_pre) * inv - g_tfinal * inv;
              dp = raw < kAlphaClamp ? dalpha * alpha : 0.0f;
              t = t_next;
              hit = true;
            }
          }
        }
        // an instance no lane contributes to keeps this warp's zero sums
        if (__any_sync(kFullMask, hit)) {
          slab_dp[slot * kSlabRow + lane] = dp;
          slab_w[slot * kSlabRow + lane] = w;
          if (lane == slot) slot_j = j;
          if (++slot == kGroup) {
            flush(kGroup, slot_j);
            slot = 0;
          }
        }
        warp_done = __all_sync(kFullMask, done);
      }
    }
    if (slot > 0) flush(slot, slot_j);
    __syncthreads();

    // Sum the warps' sums in warp order: each (term, instance) is read and
    // written by one thread.
    for (int e = tid; e < kWidth * count; e += nthreads) {
      const int c = e / count;
      const int j = e - c * count;
      float s = 0.0f;
      for (int w = 0; w < n_warps; ++w) s += part[(w * kWidth + c) * kBatch + j];
      sums[c * kBatch + j] = s;
    }
    __syncthreads();

    if (tid < count) {
      const float* f = fb + tid * kStride;
      const float mxc = f[0] - (p.tx0 + 0.5f * tile_w);
      const float myc = f[1] - (p.ty0 + 0.5f * tile_h);
      const float m0 = sums[0 * kBatch + tid];
      const float m_x = sums[1 * kBatch + tid];
      const float m_y = sums[2 * kBatch + tid];
      const float m_xx = sums[3 * kBatch + tid];
      const float m_yy = sums[4 * kBatch + tid];
      const float m_xy = sums[5 * kBatch + tid];
      // sums against dx = mx - x: the moments expanded around mxc
      const float sx = mxc * m0 - m_x;
      const float sy = myc * m0 - m_y;
      const float sxx = mxc * mxc * m0 - 2.0f * mxc * m_x + m_xx;
      const float syy = myc * myc * m0 - 2.0f * myc * m_y + m_yy;
      const float sxy = mxc * myc * m0 - mxc * m_y - myc * m_x + m_xy;
      const float ca = f[2], cb = f[3], cc = f[4], op = f[5];
      float* row = grads + static_cast<size_t>(base + tid) * kWidth;
      row[0] = -(ca * sx + cb * sy);
      row[1] = -(cc * sy + cb * sx);
      row[2] = -0.5f * sxx;
      row[3] = -sxy;
      row[4] = -0.5f * syy;
      row[5] = m0 / (op == 0.0f ? 1.0f : op);
      row[6] = sums[6 * kBatch + tid];
      row[7] = sums[7 * kBatch + tid];
      row[8] = sums[8 * kBatch + tid];
    }
  }
  cp_async_wait_all();
}

}  // namespace

// Launches on `stream` without synchronising; returns the first CUDA error
// (0 if none). tile_w must be a multiple of 8, tile_h of 4, and the tile at
// most 1024 pixels.
extern "C" int blend_backward_launch(
    const float* fields, const int* inst_gauss, const int* tile_ranges,
    const int* tile_order, const float* out, const float* g_out,
    float* grads, int width, int height, int tiles_x, int n_tiles,
    int tile_w, int tile_h, void* stream) {
  const int nthreads = tile_w * tile_h;
  if (tile_w % kPatchW || tile_h % kPatchH || nthreads > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = smem_floats(nthreads / 32) * sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(
      blend_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  blend_backward_kernel<<<n_tiles, nthreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      fields, inst_gauss, tile_ranges, tile_order, out, g_out, grads, width,
      height, tiles_x, tile_w, tile_h);
  return static_cast<int>(cudaGetLastError());
}
