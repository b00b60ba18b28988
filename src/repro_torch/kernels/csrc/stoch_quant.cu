// Fused Eq.-5 one-bit quantize + 8:1 bit pack, with and without error feedback.
//
// Replaces the Pallas kernels of src/repro/kernels/stoch_quant.py:
//   stoch_quant_pack_2d (_kernel)     -> probit_stoch_quant_pack
//   stoch_quant_ef_2d   (_ef_kernel)  -> probit_stoch_quant_ef
//
// The TPU kernels took one client's (rows, 1024) view and were vmapped over
// the cohort, and the campaign engine vmapped that again over its (cell,
// seed) elements; here one launch covers all R = E * M rows of a group of
// E elements of M clients each. Each thread reads 8 consecutive coordinates
// (two 16-byte loads per operand) and writes one packed byte, LSB first.
// The range b is shared by the M clients of an element, so it is one
// (d_pad,) row per element, read once per byte column rather than an
// (R, d_pad) operand: row r reads b's row r / M.
//
// Bound: bytes. Per coordinate B1 reads delta, u (8 B, plus b shared
// across clients) and writes 1/8 B; B2 also reads the residual and writes
// the new one. There is no reuse to exploit, so the design is a plain
// coalesced stream.
//
// Arithmetic follows repro_torch.core.quantizer.binarize_prob bit for bit:
// p = 0.5 + (0.5 * clip(d, -b, b)) / b, or 0.5 where b <= 0, with the
// _rn intrinsics so nvcc cannot contract or reorder anything.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ bool eq5_bit(float d, float b, float u) {
  float p = 0.5f;
  if (b > 0.f) {
    float c = fminf(fmaxf(d, -b), b);
    p = __fadd_rn(0.5f, __fdiv_rn(__fmul_rn(0.5f, c), b));
  }
  return u < p;
}

__device__ __forceinline__ void load8(const float* __restrict__ p, float v[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 c = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
}

__device__ __forceinline__ void store8(float* __restrict__ p, const float v[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// The 8 range values of output byte i: byte column i % row_bytes of the
// b row of i's element.
__device__ __forceinline__ const float* b_at(const float* __restrict__ b, int64_t i, int64_t row_bytes,
                                             int64_t rows_per_element) {
  const int64_t row = i / row_bytes;
  return b + 8 * ((row / rows_per_element) * row_bytes + (i - row * row_bytes));
}

// One thread per output byte; grid-stride over the R * d_pad/8 bytes.
__global__ void stoch_quant_pack_kernel(const float* __restrict__ delta,
                                        const float* __restrict__ b,
                                        const float* __restrict__ u,
                                        uint8_t* __restrict__ out,
                                        int64_t n_bytes, int64_t row_bytes,
                                        int64_t rows_per_element) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n_bytes;
       i += (int64_t)gridDim.x * blockDim.x) {
    float dv[8], bv[8], uv[8];
    load8(delta + 8 * i, dv);
    load8(u + 8 * i, uv);
    load8(b_at(b, i, row_bytes, rows_per_element), bv);
    uint32_t byte = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) byte |= (uint32_t)eq5_bit(dv[k], bv[k], uv[k]) << k;
    out[i] = (uint8_t)byte;
  }
}

// EF variant: eff = delta + residual; pack Eq.-5 bits of eff; r' = eff - (c ? b : -b).
__global__ void stoch_quant_ef_kernel(const float* __restrict__ delta,
                                      const float* __restrict__ residual,
                                      const float* __restrict__ b,
                                      const float* __restrict__ u,
                                      uint8_t* __restrict__ out,
                                      float* __restrict__ new_residual,
                                      int64_t n_bytes, int64_t row_bytes,
                                      int64_t rows_per_element) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n_bytes;
       i += (int64_t)gridDim.x * blockDim.x) {
    float dv[8], rv[8], bv[8], uv[8];
    load8(delta + 8 * i, dv);
    load8(residual + 8 * i, rv);
    load8(u + 8 * i, uv);
    load8(b_at(b, i, row_bytes, rows_per_element), bv);
    uint32_t byte = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float eff = __fadd_rn(dv[k], rv[k]);
      const bool bit = eq5_bit(eff, bv[k], uv[k]);
      byte |= (uint32_t)bit << k;
      rv[k] = __fsub_rn(eff, bit ? bv[k] : -bv[k]);
    }
    out[i] = (uint8_t)byte;
    store8(new_residual + 8 * i, rv);
  }
}

int grid_for(int64_t n) {
  int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = 132 * 16;  // enough resident blocks to fill every SM
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : (int)blocks;
}

}  // namespace

// delta, u: (m, d_pad) f32; b: (m / rows_per_element, d_pad) f32, one row per
// element of rows_per_element rows; out: (m, d_pad/8) u8. d_pad % 8 == 0,
// rows_per_element divides m, all pointers 16-byte aligned. Returns the
// cudaError_t of the launch.
extern "C" int probit_stoch_quant_pack(const float* delta, const float* b, const float* u,
                                       uint8_t* out, int64_t m, int64_t d_pad,
                                       int64_t rows_per_element, cudaStream_t stream) {
  const int64_t row_bytes = d_pad / 8;
  const int64_t n_bytes = m * row_bytes;
  if (n_bytes == 0) return 0;
  if (rows_per_element < 1 || m % rows_per_element) return (int)cudaErrorInvalidValue;
  stoch_quant_pack_kernel<<<grid_for(n_bytes), kThreads, 0, stream>>>(
      delta, b, u, out, n_bytes, row_bytes, rows_per_element);
  return (int)cudaGetLastError();
}

// As above plus residual (m, d_pad) f32 in and new_residual (m, d_pad) f32 out.
extern "C" int probit_stoch_quant_ef(const float* delta, const float* residual,
                                     const float* b, const float* u, uint8_t* out,
                                     float* new_residual, int64_t m, int64_t d_pad,
                                     int64_t rows_per_element, cudaStream_t stream) {
  const int64_t row_bytes = d_pad / 8;
  const int64_t n_bytes = m * row_bytes;
  if (n_bytes == 0) return 0;
  if (rows_per_element < 1 || m % rows_per_element) return (int)cudaErrorInvalidValue;
  stoch_quant_ef_kernel<<<grid_for(n_bytes), kThreads, 0, stream>>>(
      delta, residual, b, u, out, new_residual, n_bytes, row_bytes, rows_per_element);
  return (int)cudaGetLastError();
}
