// Scan probes P3 and P4: the inclusive product scan along a row of 128
// float32 values and the product of the scanned row, in two forms each.
//
// Replaces the two Pallas kernels of scripts/perf_scan_variants.py: `timed`
// (:76; 30 rounds of incl = cumprod(y), acc += prod(incl), y = 0.999 y +
// 1e-4 over [512, 128]) and `once` (:116; incl and prod(incl) once). On the
// TPU they compared lane shifts by concatenation with shifts by
// pltpu.roll. Here one warp takes one row, each lane four values: value i
// = 32 j + lane sits in register j of its lane. The forms:
//   scan "concat": each Hillis-Steele step writes the row to shared memory
//     and reads it back shifted by s (1.0 before the row's start);
//   scan "roll": steps s < 32 rotate each register across the warp
//     (__shfl_sync from lane (lane - s) mod 32), taking the value from the
//     register below where the rotation wraps; s = 32 and 64 shift whole
//     registers;
//   prod "concat": the halving tree x[i] * x[i + h] through shared memory;
//   prod "roll": the same halving tree as a butterfly (__shfl_xor_sync).
// Both scans multiply y[i] * y[i - s] for s = 1, 2, ..., 64, the order of
// frosting_tpu/raster/chunk_math.py::cumprod_incl, and both products the
// halving tree's pairs, the order of tree_prod: so the four variants give
// bitwise-equal results, and equal the plain PyTorch version that repeats
// that order (bench/perf_scan_variants.py).
//
// P3 is bound by nothing the card can feel: about 2e7 FP32 operations and
// 256 KB read per launch, well under the time of one launch. P4 reads 256
// KB and writes 258 KB. Both measure the launch and the warp's latency.

#include <cuda_runtime.h>

namespace {

constexpr int kK = 128;            // values per row
constexpr int kPerLane = kK / 32;  // registers per lane
constexpr int kReps = 30;          // rounds of P3
constexpr int kWarps = 4;          // rows per block
constexpr unsigned kFull = 0xffffffffu;

// Hillis-Steele inclusive product scan of the warp's row, through shared
// memory (`row`: the warp's 128 floats).
__device__ __forceinline__ void scan_concat(float (&v)[kPerLane], float* row,
                                            int lane) {
#pragma unroll
  for (int s = 1; s < kK; s <<= 1) {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) row[32 * j + lane] = v[j];
    __syncwarp();
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const int i = 32 * j + lane;
      v[j] = __fmul_rn(v[j], i >= s ? row[i - s] : 1.0f);
    }
    __syncwarp();
  }
}

// The same scan with register rotations across the warp.
__device__ __forceinline__ void scan_roll(float (&v)[kPerLane], int lane) {
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    float t[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      t[j] = __shfl_sync(kFull, v[j], (lane - s) & 31);
    }
    // value 32 j + lane - s: register j of lane - s, or, where the rotation
    // wrapped (lane < s), register j - 1 of lane - s + 32
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      const float prev = lane >= s ? t[j] : (j > 0 ? t[j - 1] : 1.0f);
      v[j] = __fmul_rn(v[j], prev);
    }
  }
  // s = 32 and s = 64: whole registers, highest first so each step reads
  // the values before it
#pragma unroll
  for (int j = kPerLane - 1; j >= 1; --j) v[j] = __fmul_rn(v[j], v[j - 1]);
#pragma unroll
  for (int j = kPerLane - 1; j >= 2; --j) v[j] = __fmul_rn(v[j], v[j - 2]);
}

// The halving tree's first two levels, within each lane: x[i] * x[i + 64],
// then x[i] * x[i + 32], for i = lane.
__device__ __forceinline__ float prod_lane(const float (&v)[kPerLane]) {
  return __fmul_rn(__fmul_rn(v[0], v[2]), __fmul_rn(v[1], v[3]));
}

// Product of the row: the halving tree through shared memory; lane 0 holds
// the result.
__device__ __forceinline__ float prod_concat(const float (&v)[kPerLane],
                                             float* row, int lane) {
  float b = prod_lane(v);
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) {
    row[lane] = b;
    __syncwarp();
    if (lane < h) b = __fmul_rn(b, row[lane + h]);
    __syncwarp();
  }
  return b;
}

// The same tree as a butterfly: every lane holds the result.
__device__ __forceinline__ float prod_roll(const float (&v)[kPerLane]) {
  float b = prod_lane(v);
#pragma unroll
  for (int h = 16; h >= 1; h >>= 1) b = __fmul_rn(b, __shfl_xor_sync(kFull, b, h));
  return b;
}

template <bool kRollScan, bool kRollProd>
__device__ __forceinline__ float scan_and_prod(float (&v)[kPerLane],
                                               float* row, int lane) {
  if (kRollScan) {
    scan_roll(v, lane);
  } else {
    scan_concat(v, row, lane);
  }
  return kRollProd ? prod_roll(v) : prod_concat(v, row, lane);
}

// P3: acc[r] = sum over 30 rounds of prod(cumprod(y)), y = 0.999 y + 1e-4
// after each round (multiply, then add, each rounded, as the plain version).
template <bool kRollScan, bool kRollProd>
__global__ void scan_reps_kernel(const float* __restrict__ x,
                                 float* __restrict__ acc_out, int rows) {
  __shared__ float rows_smem[kWarps][kK];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= rows) return;  // the whole warp leaves together
  float y[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) y[j] = x[r * kK + 32 * j + lane];
  float acc = 0.0f;
  for (int rep = 0; rep < kReps; ++rep) {
    float incl[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) incl[j] = y[j];
    acc = __fadd_rn(acc,
                    scan_and_prod<kRollScan, kRollProd>(incl, rows_smem[warp], lane));
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      y[j] = __fadd_rn(__fmul_rn(y[j], 0.999f), 1e-4f);
    }
  }
  if (lane == 0) acc_out[r] = acc;
}

// P4: incl = cumprod(x) and prod(incl), once.
template <bool kRollScan, bool kRollProd>
__global__ void scan_once_kernel(const float* __restrict__ x,
                                 float* __restrict__ incl_out,
                                 float* __restrict__ prod_out, int rows) {
  __shared__ float rows_smem[kWarps][kK];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r = blockIdx.x * kWarps + warp;
  if (r >= rows) return;
  float v[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) v[j] = x[r * kK + 32 * j + lane];
  const float p = scan_and_prod<kRollScan, kRollProd>(v, rows_smem[warp], lane);
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) incl_out[r * kK + 32 * j + lane] = v[j];
  if (lane == 0) prod_out[r] = p;
}

__global__ void empty_kernel() {}

int blocks_for(int rows) { return (rows + kWarps - 1) / kWarps; }

}  // namespace

// Launchers: device pointers, the row count (rows of 128 floats), the
// variant (roll_scan, roll_prod: 0 concat, 1 roll) and the stream. Each
// launches on that stream, does not synchronise, and returns
// cudaGetLastError().

extern "C" int scan_reps_launch(const float* x, float* acc_out, int rows,
                                int roll_scan, int roll_prod, void* stream) {
  if (rows <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_for(rows)), block(32 * kWarps);
  if (roll_scan && roll_prod) {
    scan_reps_kernel<true, true><<<grid, block, 0, s>>>(x, acc_out, rows);
  } else if (roll_scan) {
    scan_reps_kernel<true, false><<<grid, block, 0, s>>>(x, acc_out, rows);
  } else if (roll_prod) {
    scan_reps_kernel<false, true><<<grid, block, 0, s>>>(x, acc_out, rows);
  } else {
    scan_reps_kernel<false, false><<<grid, block, 0, s>>>(x, acc_out, rows);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int scan_once_launch(const float* x, float* incl_out,
                                float* prod_out, int rows, int roll_scan,
                                int roll_prod, void* stream) {
  if (rows <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks_for(rows)), block(32 * kWarps);
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
