// Fused prox-regularized SGD + momentum step (paper Eq. 4 local solver).
//
// Replaces the Pallas kernel prox_sgd_2d (_kernel) of
// src/repro/kernels/prox_sgd.py. The TPU kernel ran one client's
// (rows, 1024) view inside a vmap (and the campaign engine vmapped that
// over its (cell, seed) elements); here one launch updates all R rows of a
// group of E elements of R / E client rows each, every value as
//
//   g  = grad + lam * (w - w0)
//   m' = mu * m + g
//   w' = w - eta * m'
//
// Bound: bytes (reads w, grad, m and w0, writes w' and m'; 6 flops per
// value). Element e has its own global model w0, row e of an (E, d)
// operand shared by its R / E rows, and its own (eta, lam, mu), row e of an
// (E, 3) f32 array in device memory (or one row for all, coeff_stride 0).
// With one row per element (R / E = 1) w0 is a full (R, d) operand.
//
// Design, for a cohort whose arrays are each larger than the 50 MB L2:
// - Work units are a column tile of `tile` floats times a group of
//   `group_rows` client rows of one element: a unit never straddles two
//   elements, so a CTA stages its unit's slice of the element's w0 row in
//   shared memory once and streams every row of the group against it, with
//   the element's coefficients.
// - Units are numbered tile first: the CTAs resident at one time work on
//   neighbouring tiles of the same rows, so each array is read and written
//   as one contiguous band, row after row.
// - The wrapper (kernels/prox_sgd.py: launch_geometry) launches one CTA a
//   unit of 2,048 to 4,096 elements and lets the hardware deal units to SMs
//   as CTAs finish; on the H100 that streamed faster than long units (w0
//   staged once for many rows) and than a persistent grid of whole waves
//   (PERF.md, b4_sweep). The CTAs walk the units grid-stride, so a launch
//   may also take fewer CTAs than units.
// - Elements move 16 bytes at a time. Row r starts at element r * d, which
//   is 16-byte aligned only for some r when d % 4 != 0, so each row segment
//   is a scalar head (0-3 elements) up to the first 16-byte boundary, a
//   float4 body and a scalar tail. w0 comes from shared memory at each
//   element's own column, so its alignment does not matter. A thread keeps
//   kBatch float4 slots of loads in flight before it computes and stores.
//   With `vector` = 0 (arrays whose addresses differ mod 16 bytes) every
//   element takes the scalar path.
// - Streams are loaded and stored with the evict-first hint (.cs), so that
//   they pass through L2 without pushing w0 out.
// - Updates may be in place (w_out == w, m_out == mom): every element is
//   read before it is written, by the same thread, and by no other thread.
//   No pointer is __restrict__.
//
// Every operation uses a _rn intrinsic, so nvcc cannot contract a*b+c into
// a fused multiply-add; the result equals repro_torch.kernels.ref.prox_sgd_ref,
// which PyTorch computes one rounded operation at a time.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 4;          // float4 slots a thread loads before it stores
constexpr int kMaxTileLog2 = 13;   // 8,192 floats of w0 (32 KB) in shared memory

struct Coeffs {
  float eta, lam, mu;
};

__device__ __forceinline__ Coeffs coeffs_of(const float* coeffs, int64_t element, int64_t stride) {
  const float* c = coeffs + element * stride;
  return Coeffs{__ldg(c), __ldg(c + 1), __ldg(c + 2)};
}

// (w', m') of one element; writes m' into *m and returns w'.
__device__ __forceinline__ float step(float w, float w0, float g, float& m, Coeffs c) {
  const float gt = __fadd_rn(g, __fmul_rn(c.lam, __fsub_rn(w, w0)));
  m = __fadd_rn(__fmul_rn(c.mu, m), gt);
  return __fsub_rn(w, __fmul_rn(c.eta, m));
}

template <bool kSharedW0>
__global__ void __launch_bounds__(kThreads)
prox_sgd_kernel(const float* w, const float* w0, const float* grad, const float* mom, float* w_out,
                float* m_out, const float* coeff_rows, int64_t coeff_stride, int64_t rows_per_element,
                int64_t d, int tile_log2, int64_t group_rows, int tiles, int groups, int units, int vector,
                int phase) {
  // tiles a row, row groups an element and units of the launch come from
  // the host (each below 2**31): a CTA of the MLP's shape runs one unit, and
  // a 64-bit division in its prologue is a measurable part of its time.
  extern __shared__ float s_w0[];
  const int64_t tile = int64_t{1} << tile_log2;
  const int vpr_log2 = tile_log2 - 2;  // float4 slots of a row segment, log2
  const int scalar_log2 = vector ? 3 : tile_log2;  // scalar positions of a row segment, log2

  // A CTA's units mostly share an element: its coefficients are loaded when
  // the element changes, and one run (q < groups throughout) divides once.
  int64_t coeffs_element = -1;
  Coeffs coeffs{};
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int q = u / tiles;  // row group of the whole launch
    const int64_t c0 = (int64_t)(u - q * tiles) << tile_log2;
    const int element = q < groups ? 0 : q / groups;
    const int64_t first = (int64_t)(q - element * groups) * group_rows;  // within the element
    const int64_t r0 = (int64_t)element * rows_per_element + first;
    const int len = (int)min(tile, d - c0);
    const int64_t nr = min(group_rows, rows_per_element - first);
    if (element != coeffs_element) {
      coeffs = coeffs_of(coeff_rows, element, coeff_stride);
      coeffs_element = element;
    }
    if (kSharedW0) {
      __syncthreads();  // the previous unit has read its slice
      for (int k = threadIdx.x; k < len; k += kThreads) s_w0[k] = __ldg(w0 + (int64_t)element * d + c0 + k);
      __syncthreads();
    }
    // Row r of the unit starts at flat element e = (r0 + r) * d + c0; its
    // head runs to the first element whose address is a multiple of 16 bytes.
    auto head = [&](int64_t r) -> int {
      if (!vector) return len;
      const int64_t e = (r0 + r) * d + c0 + phase;
      return min((int)((4 - (e & 3)) & 3), len);
    };

    if (vector) {
      const int64_t total = nr << vpr_log2;
      const int64_t vmask = (int64_t{1} << vpr_log2) - 1;
      for (int64_t i0 = threadIdx.x; i0 < total; i0 += kThreads * kBatch) {
        float4 wv[kBatch], gv[kBatch], mv[kBatch], zv[kBatch];
        int64_t off[kBatch];
        int col[kBatch];
        bool ok[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int64_t i = i0 + (int64_t)j * kThreads;
          const int64_t r = i >> vpr_log2;
          const int h = head(r);
          col[j] = h + 4 * (int)(i & vmask);
          ok[j] = i < total && col[j] + 4 <= len;
          off[j] = (r0 + r) * d + c0 + col[j];
          if (ok[j]) {
            wv[j] = __ldcs(reinterpret_cast<const float4*>(w + off[j]));
            gv[j] = __ldcs(reinterpret_cast<const float4*>(grad + off[j]));
            mv[j] = __ldcs(reinterpret_cast<const float4*>(mom + off[j]));
            if (!kSharedW0) zv[j] = __ldcs(reinterpret_cast<const float4*>(w0 + off[j]));
          }
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          if (!ok[j]) continue;
          if (kSharedW0) {
            const float* z = s_w0 + col[j];
            zv[j] = make_float4(z[0], z[1], z[2], z[3]);
          }
          float4 nw;
          nw.x = step(wv[j].x, zv[j].x, gv[j].x, mv[j].x, coeffs);
          nw.y = step(wv[j].y, zv[j].y, gv[j].y, mv[j].y, coeffs);
          nw.z = step(wv[j].z, zv[j].z, gv[j].z, mv[j].z, coeffs);
          nw.w = step(wv[j].w, zv[j].w, gv[j].w, mv[j].w, coeffs);
          __stcs(reinterpret_cast<float4*>(m_out + off[j]), mv[j]);
          __stcs(reinterpret_cast<float4*>(w_out + off[j]), nw);
        }
      }
    }

    // Scalar positions: the head [0, h) and the tail after the last whole
    // float4 of each row segment (every column when vector == 0).
    const int64_t total_s = nr << scalar_log2;
    const int64_t smask = (int64_t{1} << scalar_log2) - 1;
    for (int64_t i = threadIdx.x; i < total_s; i += kThreads) {
      const int64_t r = i >> scalar_log2;
      const int k = (int)(i & smask);
      const int h = head(r);
      const int col = k < h ? k : h + ((len - h) & ~3) + (k - h);
      if (col >= len) continue;
      const int64_t off = (r0 + r) * d + c0 + col;
      float m = mom[off];
      const float z = kSharedW0 ? s_w0[col] : w0[off];
      const float nw = step(w[off], z, grad[off], m, coeffs);
      m_out[off] = m;
      w_out[off] = nw;
    }
  }
}

int tile_log2_of(int64_t tile) {
  int lg = 0;
  while ((int64_t{1} << lg) < tile) ++lg;
  return (int64_t{1} << lg) == tile && lg >= 2 && lg <= kMaxTileLog2 ? lg : -1;
}

}  // namespace

// SMs of the current device and resident CTAs per SM of the kernel with a
// `tile`-float shared w0 slice (shared_w0 != 0) or with a full w0 operand:
// out[0] = SMs, out[1] = CTAs per SM.
extern "C" int probit_prox_sgd_occupancy(int64_t tile, int64_t shared_w0, int64_t* out) {
  const int lg = tile_log2_of(tile);
  if (lg < 0) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = shared_w0 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, prox_sgd_kernel<true>, kThreads,
                                                                     (size_t)tile * sizeof(float))
                    : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, prox_sgd_kernel<false>, kThreads, 0);
  }
  out[0] = sms;
  out[1] = blocks;
  return (int)err;
}

// w, grad, mom, w_out, m_out: (rows, d) f32, E = rows / rows_per_element
// elements of rows_per_element rows each; w0: (E, d), element e's global
// model (staged in shared memory when rows_per_element > 1; read as a full
// (rows, d) operand when it is 1); coeffs: (E, 3) f32 (eta, lam, mu) rows
// in device memory, coeff_stride 3, or one row for all, coeff_stride 0.
// w_out may be w and m_out may be mom. Geometry: `tile` columns (a power of
// two, 4 to 8,192) by `group_rows` rows of one element a unit, `ctas` CTAs.
// `vector` != 0 needs every (rows, d) operand at the same address mod 16
// bytes.
extern "C" int probit_prox_sgd(const float* w, const float* w0, const float* grad, const float* mom,
                               float* w_out, float* m_out, const float* coeffs, int64_t coeff_stride,
                               int64_t rows, int64_t d, int64_t rows_per_element, int64_t tile,
                               int64_t group_rows, int64_t ctas, int64_t vector, cudaStream_t stream) {
  if (rows == 0 || d == 0) return 0;
  const int lg = tile_log2_of(tile);
  const bool shared = rows_per_element > 1;
  if (lg < 0 || group_rows < 1 || ctas < 1 || ctas > 0x7fffffff || rows_per_element < 1 ||
      rows % rows_per_element || (coeff_stride != 0 && coeff_stride != 3))
    return (int)cudaErrorInvalidValue;
  const int64_t tiles = (d + tile - 1) >> lg;
  const int64_t groups = (rows_per_element + group_rows - 1) / group_rows;
  const int64_t units = tiles * (rows / rows_per_element) * groups;
  if (units > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const uintptr_t a = reinterpret_cast<uintptr_t>(w);
  if (vector) {
    const uintptr_t ptrs[] = {reinterpret_cast<uintptr_t>(grad), reinterpret_cast<uintptr_t>(mom),
                              reinterpret_cast<uintptr_t>(w_out), reinterpret_cast<uintptr_t>(m_out),
                              shared ? a : reinterpret_cast<uintptr_t>(w0)};
    for (uintptr_t p : ptrs)
      if ((p & 15) != (a & 15)) return (int)cudaErrorInvalidValue;
    if (a & 3) return (int)cudaErrorInvalidValue;
  }
  const int phase = (int)((a >> 2) & 3);
  if (shared) {
    prox_sgd_kernel<true><<<(unsigned)ctas, kThreads, (size_t)tile * sizeof(float), stream>>>(
        w, w0, grad, mom, w_out, m_out, coeffs, coeff_stride, rows_per_element, d, lg, group_rows, (int)tiles,
        (int)groups, (int)units, (int)(vector != 0), phase);
  } else {
    prox_sgd_kernel<false><<<(unsigned)ctas, kThreads, 0, stream>>>(
        w, w0, grad, mom, w_out, m_out, coeffs, coeff_stride, rows_per_element, d, lg, group_rows, (int)tiles,
        (int)groups, (int)units, (int)(vector != 0), phase);
  }
  return (int)cudaGetLastError();
}
