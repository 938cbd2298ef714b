// Scan probes P3 and P4: the inclusive product scan along a row of 128
// float32 values and the product of the scanned row, in two forms each.
//
// Replaces the two Pallas kernels of scripts/perf_scan_variants.py: `timed`
// (:76; 30 rounds of incl = cumprod(y), acc += prod(incl), y = 0.999 y +
// 1e-4 over [512, 128]) and `once` (:116; incl and prod(incl) once). On the
// TPU they compared lane shifts by concatenation with shifts by
// pltpu.roll; here the same two forms are shared-memory round trips and
// warp shuffles.
//
// What bounds them on this card. P3 needs 1.77e7 FP32 operations and 256
// KB (0.26 us at 67 TFLOP/s), P4 moves 514 KB (0.16 us at 3.35 TB/s): both
// bounds lie under the ~1 us of an empty launch. Above that floor P3 is
// bound by latency and by its cross-lane steps. Each round is a chain of
// dependent steps, but the rounds are not a chain: round r scans y_r, the
// update applied r times to x element by element, and only the 30
// additions into acc are ordered, so P3 runs the rounds in parallel. Once
// the latency is hidden, the count of shuffles and shared-memory accesses
// is the limit, not the FP32 rate: each issues at most one warp-wide
// instruction per clock per SM. Tensor cores, TMA and cp.async have
// nothing to do here: the work is FP32 products in a fixed order on 256 KB.
//
// Layout: a row is held by a segment of L lanes (a warp holds 32 / L
// segments), each lane V = 128 / L values: value i = L j + l sits in
// register j of lane l. A Hillis-Steele step with s >= L, and a tree level
// with h >= L, then stays in one lane's registers; only s, h < L cross
// lanes:
//   scan "roll": log2(L) steps rotate each register across the segment
//     (__shfl_sync from lane (l - s) mod L, the register below where the
//     rotation wraps): log2(L) V shuffles per warp of 32 / L rows;
//   scan "concat": the same steps as a store of the row to shared memory
//     and a load shifted by s (1.0 before the row's start): twice as many
//     accesses;
//   prod "roll": the tree's log2(L) cross-lane levels as a butterfly
//     (__shfl_xor_sync); "concat": the same levels through shared memory.
// That is 4 log2(L) shuffles per row and round for roll/roll (+ log2(L) L
// / 32 for the tree), twice that for concat/concat: 25 shuffles at L = 32,
// one warp per row. P3 uses L = 4 (V = 32): 8.25 shuffles per row and
// round for roll/roll, 16.5 accesses for concat/concat; P4 uses L = 16
// (V = 8): 18 and 36. The lanes are SCAN_REPS_LANES and SCAN_ONCE_LANES
// at compile time; scan_ab.py builds other values to compare (on an H100,
// 8 and 16 lanes were slower for P3, 4, 8 and 32 for P4: PERF.md).
//
// P3, one block per row: its threads first fill a shared table of y_r
// (thread t carries element t through the updates, __fmul_rn then
// __fadd_rn as the plain version rounds), then every segment of every warp
// scans and multiplies one round's row out of that table, in place, and
// writes its product to shared memory; one thread adds the 30 products in
// round order from 0.0f. Writing and reading the table costs 8 accesses a
// row and round, so roll/roll moves 16.25 warp-wide operations through the
// shuffle and shared-memory pipes a row and round: 512 x 30 x 16.25 / 132
// SMs, 1,891 clocks, 0.95 us at 1.98 GHz; concat/concat 24.5, 1.44 us
// (bench/perf_scan_variants.py::pipe_ops). Filling the table (one load of
// x, 29 dependent updates) and the 30 ordered additions add latency that
// the rounds cannot hide.
// P4, one warp per block, one row per segment: each load and store of a
// register touches 32 / L rows, L values each (two 64-byte runs at L = 16);
// its time is the latency of one load, the scan and one store.
//
// Both scans multiply y[i] * y[i - s] for s = 1, 2, ..., 64, the order of
// frosting_tpu/raster/chunk_math.py::cumprod_incl, and both products the
// halving tree's pairs x[i] * x[i + h], the order of tree_prod: so the four
// variants give bitwise-equal results, and equal the plain PyTorch version
// that repeats that order (bench/perf_scan_variants.py).

#include <cuda_runtime.h>

#ifndef SCAN_REPS_LANES
#define SCAN_REPS_LANES 4
#endif
#ifndef SCAN_ONCE_LANES
#define SCAN_ONCE_LANES 16
#endif

namespace {

constexpr int kK = 128;    // values per row
constexpr int kReps = 30;  // rounds of P3
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRepsLanes = SCAN_REPS_LANES;
constexpr int kOnceLanes = SCAN_ONCE_LANES;

template <int L>
struct Layout {
  static_assert(L >= 2 && L <= 32 && (L & (L - 1)) == 0, "lanes: a power of two");
  static constexpr int kVals = kK / L;  // registers per lane
  static constexpr int kSegs = 32 / L;  // rows (P4) or rounds (P3) per warp
  // a segment's row in shared memory, padded so that the segments of a
  // warp fall on distinct banks
  static constexpr int kStride = kK + L;
  // P3: the rounds rounded up to whole warps, and the warps of a block
  static constexpr int kSlots = (kReps + kSegs - 1) / kSegs * kSegs;
  static constexpr int kWarps = kSlots / kSegs;
};

// The loops over the steps s and the tree's levels h recurse on a template
// parameter, so that every register index is a constant: a loop whose
// bounds follow an outer loop's counter is not always unrolled, and an
// array indexed at run time lives in local memory.

// The steps s = S, 2S, ..., 64 of the scan (S >= L): whole registers,
// highest first so that each product reads the value before the step.
template <int L, int S = L>
__device__ __forceinline__ void scan_in_lane(float (&v)[Layout<L>::kVals]) {
  if constexpr (S < kK) {
#pragma unroll
    for (int j = Layout<L>::kVals - 1; j >= S / L; --j) {
      v[j] = __fmul_rn(v[j], v[j - S / L]);
    }
    scan_in_lane<L, 2 * S>(v);
  }
}

// Hillis-Steele inclusive product scan of the segment's row; the steps
// s < L through shared memory (`row`: the segment's kStride floats).
template <int L, int S = 1>
__device__ __forceinline__ void scan_concat(float (&v)[Layout<L>::kVals],
                                            float* row, int l) {
  if constexpr (S < L) {
#pragma unroll
    for (int j = 0; j < Layout<L>::kVals; ++j) row[L * j + l] = v[j];
    __syncwarp();
#pragma unroll
    for (int j = 0; j < Layout<L>::kVals; ++j) {
      const int i = L * j + l;
      v[j] = __fmul_rn(v[j], i >= S ? row[i - S] : 1.0f);
    }
    __syncwarp();
    scan_concat<L, 2 * S>(v, row, l);
  } else {
    scan_in_lane<L>(v);
  }
}

// The same scan with register rotations across the segment.
template <int L, int S = 1>
__device__ __forceinline__ void scan_roll(float (&v)[Layout<L>::kVals], int l) {
  if constexpr (S < L) {
    // value L j + l - S: register j of lane l - S, or, where the rotation
    // wrapped (l < S), register j - 1 of lane l - S + L (1.0 for j = 0)
    float below = 1.0f;
#pragma unroll
    for (int j = 0; j < Layout<L>::kVals; ++j) {
      const float t = __shfl_sync(kFull, v[j], (l - S) & (L - 1), L);
      v[j] = __fmul_rn(v[j], l >= S ? t : below);
      below = t;
    }
    scan_roll<L, 2 * S>(v, l);
  } else {
    scan_in_lane<L>(v);
  }
}

// The halving tree's levels h = H, H / 2, ..., L within each lane: x[i] *
// x[i + h] for i < h; returns x[l] after the level h = L.
template <int L, int H = kK / 2>
__device__ __forceinline__ float tree_in_lane(float (&b)[Layout<L>::kVals]) {
  if constexpr (H >= L) {
#pragma unroll
    for (int j = 0; j < H / L; ++j) b[j] = __fmul_rn(b[j], b[j + H / L]);
    return tree_in_lane<L, H / 2>(b);
  } else {
    return b[0];
  }
}

template <int L>
__device__ __forceinline__ float prod_lane(const float (&v)[Layout<L>::kVals]) {
  float b[Layout<L>::kVals];
#pragma unroll
  for (int j = 0; j < Layout<L>::kVals; ++j) b[j] = v[j];
  return tree_in_lane<L>(b);
}

// Product of the row: the tree's levels h < L through shared memory; lane
// 0 of the segment holds the result.
template <int L>
__device__ __forceinline__ float prod_concat(const float (&v)[Layout<L>::kVals],
                                             float* row, int l) {
  float b = prod_lane<L>(v);
#pragma unroll
  for (int h = L / 2; h >= 1; h >>= 1) {
    row[l] = b;
    __syncwarp();
    if (l < h) b = __fmul_rn(b, row[l + h]);
    __syncwarp();
  }
  return b;
}

// The same levels as a butterfly: every lane of the segment holds the
// result (lane l multiplies x[l] by x[l ^ h]: for l < h the tree's pair).
template <int L>
__device__ __forceinline__ float prod_roll(const float (&v)[Layout<L>::kVals]) {
  float b = prod_lane<L>(v);
#pragma unroll
  for (int h = L / 2; h >= 1; h >>= 1) b = __fmul_rn(b, __shfl_xor_sync(kFull, b, h));
  return b;
}

template <int L, bool kRollScan, bool kRollProd>
__device__ __forceinline__ float scan_and_prod(float (&v)[Layout<L>::kVals],
                                               float* row, int l) {
  if (kRollScan) {
    scan_roll<L>(v, l);
  } else {
    scan_concat<L>(v, row, l);
  }
  return kRollProd ? prod_roll<L>(v) : prod_concat<L>(v, row, l);
}

// P3: acc[r] = sum over 30 rounds of prod(cumprod(y)), y = 0.999 y + 1e-4
// after each round. One block per row; segment k takes round k (the slots
// past the 30th repeat y_29 and are not added).
template <bool kRollScan, bool kRollProd>
__global__ void __launch_bounds__(32 * Layout<kRepsLanes>::kWarps)
scan_reps_kernel(const float* __restrict__ x, float* __restrict__ acc_out) {
  constexpr int L = kRepsLanes;
  using Lay = Layout<L>;
  static_assert(32 * Lay::kWarps >= kK, "a thread per element fills the table");
  __shared__ float ys[Lay::kSlots][Lay::kStride];
  __shared__ float prods[Lay::kSlots];
  const int t = threadIdx.x;
  if (t < kK) {
    float y = x[static_cast<long long>(blockIdx.x) * kK + t];
#pragma unroll
    for (int k = 0; k < Lay::kSlots; ++k) {
      ys[k][t] = y;
      if (k + 1 < kReps) y = __fadd_rn(__fmul_rn(y, 0.999f), 1e-4f);
    }
  }
  __syncthreads();
  const int slot = t / L;
  const int l = t % L;
  float v[Lay::kVals];
#pragma unroll
  for (int j = 0; j < Lay::kVals; ++j) v[j] = ys[slot][L * j + l];
  const float p = scan_and_prod<L, kRollScan, kRollProd>(v, ys[slot], l);
  if (l == 0) prods[slot] = p;
  __syncthreads();
  if (t == 0) {
    float acc = 0.0f;
#pragma unroll
    for (int r = 0; r < kReps; ++r) acc = __fadd_rn(acc, prods[r]);
    acc_out[blockIdx.x] = acc;
  }
}

// P4: incl = cumprod(x) and prod(incl), once. One warp per block, one row
// per segment; a segment past the last row scans ones and stores nothing.
template <bool kRollScan, bool kRollProd>
__global__ void __launch_bounds__(32)
scan_once_kernel(const float* __restrict__ x, float* __restrict__ incl_out,
                 float* __restrict__ prod_out, int rows) {
  constexpr int L = kOnceLanes;
  using Lay = Layout<L>;
  __shared__ float seg_rows[Lay::kSegs][Lay::kStride];
  const int k = threadIdx.x / L;
  const int l = threadIdx.x % L;
  const int row = blockIdx.x * Lay::kSegs + k;
  const bool live = row < rows;
  const float* src = x + static_cast<long long>(row) * kK;
  float v[Lay::kVals];
#pragma unroll
  for (int j = 0; j < Lay::kVals; ++j) v[j] = live ? src[L * j + l] : 1.0f;
  const float p = scan_and_prod<L, kRollScan, kRollProd>(v, seg_rows[k], l);
  if (live) {
    float* dst = incl_out + static_cast<long long>(row) * kK;
#pragma unroll
    for (int j = 0; j < Lay::kVals; ++j) dst[L * j + l] = v[j];
    if (l == 0) prod_out[row] = p;
  }
}

__global__ void empty_kernel() {}

}  // namespace

// Launchers: device pointers, the row count (rows of 128 floats), the
// variant (roll_scan, roll_prod: 0 concat, 1 roll) and the stream. Each
// launches on that stream, does not synchronise, and returns
// cudaGetLastError().

extern "C" int scan_reps_launch(const float* x, float* acc_out, int rows,
                                int roll_scan, int roll_prod, void* stream) {
  if (rows <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(rows), block(32 * Layout<kRepsLanes>::kWarps);
  if (roll_scan && roll_prod) {
    scan_reps_kernel<true, true><<<grid, block, 0, s>>>(x, acc_out);
  } else if (roll_scan) {
    scan_reps_kernel<true, false><<<grid, block, 0, s>>>(x, acc_out);
  } else if (roll_prod) {
    scan_reps_kernel<false, true><<<grid, block, 0, s>>>(x, acc_out);
  } else {
    scan_reps_kernel<false, false><<<grid, block, 0, s>>>(x, acc_out);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int scan_once_launch(const float* x, float* incl_out,
                                float* prod_out, int rows, int roll_scan,
                                int roll_prod, void* stream) {
  if (rows <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  constexpr int kSegs = Layout<kOnceLanes>::kSegs;
  const dim3 grid((rows + kSegs - 1) / kSegs), block(32);
  if (roll_scan && roll_prod) {
    scan_once_kernel<true, true><<<grid, block, 0, s>>>(x, incl_out, prod_out, rows);
  } else if (roll_scan) {
    scan_once_kernel<true, false><<<grid, block, 0, s>>>(x, incl_out, prod_out, rows);
  } else if (roll_prod) {
    scan_once_kernel<false, true><<<grid, block, 0, s>>>(x, incl_out, prod_out, rows);
  } else {
    scan_once_kernel<false, false><<<grid, block, 0, s>>>(x, incl_out, prod_out, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

// One launch of an empty kernel: the floor under any launch's time.
extern "C" int empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
