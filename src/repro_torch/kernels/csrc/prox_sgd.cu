// Fused prox-regularized SGD + momentum step (paper Eq. 4 local solver).
//
// Replaces the Pallas kernel prox_sgd_2d (_kernel) of
// src/repro/kernels/prox_sgd.py. The TPU kernel ran one client's
// (rows, 1024) view inside a vmap; here one launch updates the whole
// (M, d) cohort. The global model w0 is one (d,) row shared by every
// client (or a full (M, d) operand), so it stays in L2 instead of being
// streamed M times:
//
//   g  = grad + lam * (w - w0)
//   m' = mu * m + g
//   w' = w - eta * m'
//
// Bound: bytes (reads w, grad, m and w0, writes w' and m'; 6 flops per
// element). A plain grid-stride stream of coalesced 4-byte accesses, rows
// on grid.y: d is not a multiple of 4 at the model's width, so rows are
// not 16-byte aligned for vector loads.
//
// Every operation uses a _rn intrinsic, so nvcc cannot contract a*b+c into
// a fused multiply-add; the result equals repro_torch.kernels.ref.prox_sgd_ref,
// which PyTorch computes one rounded operation at a time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void prox_sgd_kernel(const float* __restrict__ w, const float* __restrict__ w0,
                                const float* __restrict__ grad,
                                const float* __restrict__ mom, float* __restrict__ w_out,
                                float* __restrict__ m_out, float eta, float lam, float mu,
                                int64_t rows, int64_t d, int64_t w0_row_stride) {
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    for (int64_t c = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; c < d;
         c += (int64_t)gridDim.x * blockDim.x) {
      const int64_t i = r * d + c;
      const float wv = w[i];
      const float w0v = w0[r * w0_row_stride + c];
      const float g = __fadd_rn(grad[i], __fmul_rn(lam, __fsub_rn(wv, w0v)));
      const float nm = __fadd_rn(__fmul_rn(mu, mom[i]), g);
      m_out[i] = nm;
      w_out[i] = __fsub_rn(wv, __fmul_rn(eta, nm));
    }
  }
}

}  // namespace

// w, grad, mom, w_out, m_out: (rows, d) f32; w0: (d,) with w0_row_stride = 0 (one row
// shared by the cohort) or (rows, d) with w0_row_stride = d.
extern "C" int probit_prox_sgd(const float* w, const float* w0, const float* grad,
                               const float* mom, float* w_out, float* m_out, float eta,
                               float lam, float mu, int64_t rows, int64_t d,
                               int64_t w0_row_stride, cudaStream_t stream) {
  if (rows == 0 || d == 0) return 0;
  int64_t bx = (d + kThreads - 1) / kThreads;
  if (bx > 64) bx = 64;
  const int64_t by = rows < 65535 ? rows : 65535;
  prox_sgd_kernel<<<dim3((unsigned)bx, (unsigned)by), kThreads, 0, stream>>>(
      w, w0, grad, mom, w_out, m_out, eta, lam, mu, rows, d, w0_row_stride);
  return (int)cudaGetLastError();
}
