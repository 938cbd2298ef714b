// What the forward (blend_forward.cu) and backward (blend_backward.cu) blend
// kernels share: the constants, the per-pair forward expression, the stop
// test, the per-instance footprint box as a mask of the tile's warps, the
// staged-instance layout and the asynchronous gather into shared memory.
//
// The backward re-walks each pixel with the forward's exact expressions so
// that both stop at the same Gaussian: any change to them is made here, once,
// for both. The power and the stop test are written with round-to-nearest
// intrinsics, so that no fused multiply-add changes their rounding: they
// round as the plain PyTorch versions (raster/blend_torch.py) do.
//
// Layout of a tile: tile_w x tile_h pixels, one thread each; warp w covers
// the 8x4 pixel patch (w % patches_x, w / patches_x) of the tile, lane l the
// pixel (l % 8, l / 8) of its patch, so that a warp's lanes meet the same
// Gaussians.

#pragma once

#include <cuda_runtime.h>

namespace blend {

constexpr int kWidth = 9;   // fields per Gaussian, raster/config.py
constexpr int kStride = 12;  // floats per staged instance: three float4
constexpr float kAlphaClamp = 0.99f;
constexpr float kAlphaCutoff = 1.0f / 255.0f;
constexpr float kTransmittanceEps = 1e-4f;
// The footprint box's padding beyond the alpha = 1/255 ellipse, in pixels
// (blend_torch.py BOX_PAD, BOX_PAD_REL).
constexpr float kBoxPad = 1.0f;
constexpr float kBoxPadRel = 1.0f / 64.0f;
// A conic with det <= kBoxMinDetRel * a c gets the whole tile: above it,
// det's rounding (about 2^-23 a c) moves r by under 1e-3 of itself, well
// inside kBoxPadRel (blend_torch.py BOX_MIN_DET_REL).
constexpr float kBoxMinDetRel = 1e-4f;
constexpr int kPatchW = 8;
constexpr int kPatchH = 4;
constexpr unsigned kFullMask = 0xffffffffu;

// Evaluates one (instance, pixel) pair: dx, dy and, unless the pair is
// skipped (power > 0 or op * exp(power) < 1/255, returning false), raw =
// op * exp(power) and alpha = min(0.99, raw).
__device__ __forceinline__ bool pair_alpha(float mx, float my, float ca,
                                           float cb, float cc, float op,
                                           float px, float py, float& dx,
                                           float& dy, float& raw,
                                           float& alpha) {
  dx = __fsub_rn(mx, px);
  dy = __fsub_rn(my, py);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                               __fmul_rn(__fmul_rn(cc, dy), dy));
  const float power =
      __fsub_rn(__fmul_rn(-0.5f, quad), __fmul_rn(__fmul_rn(cb, dx), dy));
  if (power > 0.0f) return false;
  raw = __fmul_rn(op, expf(power));
  if (raw < kAlphaCutoff) return false;
  alpha = fminf(kAlphaClamp, raw);
  return true;
}

// The stop test: a pixel stops at the first Gaussian with T * (1 - alpha) <
// 1e-4, which does not contribute. Sets t_next = T * (1 - alpha).
__device__ __forceinline__ bool stops(float t, float alpha, float& t_next) {
  t_next = __fmul_rn(t, __fsub_rn(1.0f, alpha));
  return t_next < kTransmittanceEps;
}

// 1 / (1 - alpha) for the backward's dalpha, by the fast approximate
// division (within 2 ulp; 1 - alpha >= 0.01): it decides no stop.
__device__ __forceinline__ float inv_one_minus(float alpha) {
  return __fdividef(1.0f, 1.0f - alpha);
}

// The footprint box (blend_torch.py instance_boxes_torch) as the mask of
// the tile's warps whose patch it meets. With L = ln(255 op) and det = a c
// - b^2, op * exp(power) >= 1/255 only inside the ellipse power >= -L,
// which reaches rx = sqrt(2 L c / det) and ry = sqrt(2 L a / det) from the
// mean; the box adds kBoxPad + kBoxPadRel * r. L <= 0, a conic that is not
// positive definite or too ill-conditioned for det's rounding (det <=
// kBoxMinDetRel * a c: long, thin footprints) or a box that is not finite
// gives every warp. det is rounded as the plain version rounds it (no
// fused multiply-add). A warp outside the mask would find raw < 1/255 at
// each of its pixels, which the walk skips without touching T or any sum:
// skipping it is exact.
__device__ __forceinline__ unsigned warp_mask(const float* f, int tx0,
                                              int ty0, int patches_x,
                                              int patches_y) {
  const int n_warps = patches_x * patches_y;
  const unsigned all = n_warps == 32 ? kFullMask : (1u << n_warps) - 1u;
  const float mx = f[0], my = f[1], ca = f[2], cb = f[3], cc = f[4];
  const float big = logf(255.0f * f[5]);
  const float ac = __fmul_rn(ca, cc);
  const float det = __fsub_rn(ac, __fmul_rn(cb, cb));
  if (!(big > 0.0f && ca > 0.0f && det > 0.0f &&
        det > __fmul_rn(kBoxMinDetRel, ac))) {
    return all;
  }
  const float rx = sqrtf(2.0f * big * cc / det);
  const float ry = sqrtf(2.0f * big * ca / det);
  const float x0 = mx - rx - (kBoxPad + kBoxPadRel * rx);
  const float x1 = mx + rx + (kBoxPad + kBoxPadRel * rx);
  const float y0 = my - ry - (kBoxPad + kBoxPadRel * ry);
  const float y1 = my + ry + (kBoxPad + kBoxPadRel * ry);
  if (!(isfinite(x0) && isfinite(x1) && isfinite(y0) && isfinite(y1))) {
    return all;
  }
  // patch column i holds x in [tx0 + 8 i, tx0 + 8 i + 7]: it meets the box
  // when (x0 - tx0 - 7) / 8 <= i <= (x1 - tx0) / 8; clamped in float first
  const float i0 = fmaxf(ceilf((x0 - tx0 - (kPatchW - 1)) / kPatchW), 0.0f);
  const float i1 = fminf(floorf((x1 - tx0) / kPatchW), patches_x - 1.0f);
  const float j0 = fmaxf(ceilf((y0 - ty0 - (kPatchH - 1)) / kPatchH), 0.0f);
  const float j1 = fminf(floorf((y1 - ty0) / kPatchH), patches_y - 1.0f);
  if (i0 > i1 || j0 > j1) return 0u;
  const int c0 = static_cast<int>(i0), c1 = static_cast<int>(i1);
  const unsigned cols = ((1u << (c1 - c0 + 1)) - 1u) << c0;
  unsigned mask = 0u;
  for (int j = static_cast<int>(j0); j <= static_cast<int>(j1); ++j) {
    mask |= cols << (j * patches_x);
  }
  return mask;
}

// Whether staged instance j (of count) has warp's bit in its mask.
__device__ __forceinline__ bool warp_meets(const unsigned* masks, int j,
                                           int count, int warp) {
  return j < count && ((masks[j] >> warp) & 1u);
}

// One 4-byte asynchronous copy from device memory into shared memory.
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts the gather of instances [base, base + count) into buf ([count][12]
// floats: the 9 fields, 3 unused), one instance per thread; the caller
// commits the group. Rows of 9 floats are 4-byte aligned only, hence 4-byte
// copies.
__device__ __forceinline__ void stage(float* buf, const float* fields,
                                      const int* inst_gauss, int base,
                                      int count, int tid) {
  if (tid < count) {
    const float* f =
        fields + static_cast<size_t>(inst_gauss[base + tid]) * kWidth;
    float* dst = buf + tid * kStride;
#pragma unroll
    for (int c = 0; c < kWidth; ++c) cp_async4(dst + c, f + c);
  }
}

// The pixel of this thread and its tile's origin.
struct Pixel {
  int tx0, ty0, x, y, warp, lane, patches_x, patches_y;
};

__device__ __forceinline__ Pixel tile_pixel(int tile, int tiles_x, int tile_w,
                                            int tile_h) {
  Pixel p;
  p.tx0 = (tile % tiles_x) * tile_w;
  p.ty0 = (tile / tiles_x) * tile_h;
  p.warp = threadIdx.x >> 5;
  p.lane = threadIdx.x & 31;
  p.patches_x = tile_w / kPatchW;
  p.patches_y = tile_h / kPatchH;
  p.x = p.tx0 + (p.warp % p.patches_x) * kPatchW + (p.lane % kPatchW);
  p.y = p.ty0 + (p.warp / p.patches_x) * kPatchH + (p.lane / kPatchW);
  return p;
}

}  // namespace blend
