// Server-side vote count over the packed one-bit wire + Eq.-13 estimate.
//
// Replaces the Pallas kernel bit_aggregate_2d (_kernel) of
// src/repro/kernels/bit_aggregate.py. The TPU kernel walked the client axis
// as a sequential grid dimension, carrying f32 partial counts in its output
// block. Blocks here run in parallel and carry nothing, so each block owns
// 128 byte columns (1024 coordinates) and splits the client axis over its
// 8 row slices: thread (x, y) counts rows y, y+8, ... of column x with
// coalesced byte loads into 8 int32 counters (never uint8: a uint8 count
// wraps past 255 clients), the 8 partial counts meet in shared memory, and
// thread (x, y) finalizes coordinate 8x+y.
//
// Bound: bytes. It reads M * P wire bytes and b, and writes 8P floats; the
// per-bit counting is a handful of integer operations per byte.
//
// Finalize: theta = ((2 N - M) * (1/M)) * b in f32, one rounding per
// operation. That is the reference's (2N - M) / M * b as XLA compiles it
// (it folds the division by the constant M into a multiply by its f32
// reciprocal); the wrapper passes that reciprocal in.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 128;  // byte columns per block
constexpr int kRows = 8;    // client-row slices per block

__global__ void bit_aggregate_kernel(const uint8_t* __restrict__ packed,
                                     const float* __restrict__ b,
                                     float* __restrict__ out, int64_t m, int64_t p,
                                     float m_f, float recip_m) {
  __shared__ int partial[kRows][8][kCols];
  const int x = threadIdx.x;
  const int y = threadIdx.y;
  const int64_t col = (int64_t)blockIdx.x * kCols + x;
  int cnt[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (col < p) {
#pragma unroll 4
    for (int64_t r = y; r < m; r += kRows) {
      const uint32_t v = packed[r * p + col];
#pragma unroll
      for (int k = 0; k < 8; ++k) cnt[k] += (v >> k) & 1u;
    }
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) partial[y][k][x] = cnt[k];
  __syncthreads();
  if (col >= p) return;
  int n = 0;
#pragma unroll
  for (int s = 0; s < kRows; ++s) n += partial[s][y][x];
  const float num = __fsub_rn(__fmul_rn(2.0f, (float)n), m_f);
  const int64_t i = 8 * col + y;
  out[i] = __fmul_rn(__fmul_rn(num, recip_m), b[i]);
}

}  // namespace

// packed: (m, p) u8; b: (8p,) f32; out: (8p,) f32; recip_m = f32(1) / f32(m).
extern "C" int probit_bit_aggregate(const uint8_t* packed, const float* b, float* out,
                                    int64_t m, int64_t p, float recip_m,
                                    cudaStream_t stream) {
  if (p == 0) return 0;
  const dim3 block(kCols, kRows);
  const unsigned grid = (unsigned)((p + kCols - 1) / kCols);
  bit_aggregate_kernel<<<grid, block, 0, stream>>>(packed, b, out, m, p, (float)m, recip_m);
  return (int)cudaGetLastError();
}
