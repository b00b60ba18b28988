// Server-side vote count over the packed one-bit wire + Eq.-13 estimate (B3).
//
// Replaces the Pallas kernel bit_aggregate_2d of
// src/repro/kernels/bit_aggregate.py (_kernel, pallas_call at line 89). The
// TPU kernel walked (client tile, column tile) blocks in order and carried
// f32 partial counts across the sequential client axis; it counted 8
// clients' votes with one popcount after an octet bit-transpose.
//
// Bound: bytes. The inputs need M * P wire bytes read, n floats of b read
// and n floats written, and one vote add per coordinate per client. At the
// card's 3.35 TB/s that is M * P / 3.35e12 s, while the adds, done here 32
// coordinates to a logic instruction, need a small fraction of that.
//
// Design, for what held the one-block-per-column-tile kernel back:
// * Too few bytes in flight at large M: the launch is (column tiles x
//   client slabs). A column tile is 128 wire bytes (1024 coordinates), one
//   4-byte word per lane, so a warp reads 128 contiguous bytes of a row. A
//   thread-block cluster of `kCluster` blocks (1, 2, 4 or 8) shares one
//   tile; each of its kWarps warps is a row stream that reads rows s, s + S,
//   s + 2S, ... (s = rank * kWarps + warp, S = kCluster * kWarps), 16 rows
//   at a time with all 16 loads issued before any is used. The wrapper
//   doubles the cluster while a stream would take more than 96 rows
//   (launch_geometry): at small M the launch and a block's fixed latency
//   (one round of loads, the cluster barriers), not the bytes, bound the
//   time, and more blocks a tile only add to it.
// * Integer issue: each group of 16 words goes through a Harley-Seal
//   carry-save adder tree (15 full adders, two 3-input logic instructions
//   each) into bit-sliced counters of weight 1, 2, 4 and 8, which carries
//   out one word of weight 16. Only that word is spread into eight
//   byte-lane counters (shift, and, add). In the sm_90a build a full
//   16-row group of one thread (64 wire bytes) takes 140 instructions (16
//   loads, 38 3-input logic, 7 shifts, the rest address and loop
//   arithmetic; chip_smoke.py prints the count from cuobjdump), 2.2 a
//   byte, under the ~5 integer operations the card issues for each byte it
//   reads. A byte lane holds 255 carries (4080
//   rows); before it wraps, and at the end, the counters flush into int32
//   counts in shared memory, so no count wraps for any M < 2^24.
// * The slabs meet exactly and in a fixed order: each block sums its warps
//   with shared-memory int32 atomics (integer addition is exact in any
//   order), the cluster synchronizes, and block `rank` sums the cluster's
//   counts for its 1024 / kCluster coordinates over distributed shared
//   memory and writes their estimates. One launch, no scratch in device
//   memory.
// * b and theta_hat have the true length n: wire bits at or beyond n are
//   counted but never written, and column tiles wholly at or beyond n are
//   not read.
// * A campaign group of E elements, each with its own M clients, range b
//   and estimate (the reference vmaps the kernel over them), is one launch:
//   the grid's second dimension is the element, which offsets the wire, b
//   and theta_hat to its own (M, P), (n,) and (n,) slices. A cluster lies
//   within one element, so counts never cross elements, and every element
//   has the same M (a group pads its cohorts to one size).
//
// Finalize: theta = ((2 N - M) * (1/M)) * b in f32, one rounding per
// operation. That is the reference's (2N - M) / M * b as XLA compiles it
// (it folds the division by the constant M into a multiply by its f32
// reciprocal); the wrapper passes that reciprocal in.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;                       // row streams per block
constexpr int kThreads = 32 * kWarps;
constexpr int kTileBytes = 128;                 // one 4-byte word per lane
constexpr int kTileCoords = 8 * kTileBytes;     // 1024
constexpr int kGroup = 16;                      // rows per carry-save step
constexpr int kFlushGroups = 255;               // carries a byte lane holds
constexpr int kSlots = kTileCoords + kTileCoords / 32;

// Shared-memory slot of tile coordinate c, padded by one word every 32 so
// that a warp writing coordinate 32 * lane + k (fixed k) and a warp reading
// 32 consecutive coordinates both hit 32 different banks.
__device__ __forceinline__ int slot(int c) { return c + (c >> 5); }

// Full adder on 32 bit positions at once: a + b + c = 2 * hi + lo.
__device__ __forceinline__ void csa(uint32_t& hi, uint32_t& lo, uint32_t a, uint32_t b, uint32_t c) {
  const uint32_t u = a ^ b;
  hi = (a & b) | (u & c);
  lo = u ^ c;
}

// Adds 16 words into the bit-sliced counters (ones, twos, fours, eights)
// and returns the carry word of weight 16.
__device__ __forceinline__ uint32_t add16(const uint32_t (&x)[kGroup], uint32_t& ones, uint32_t& twos,
                                          uint32_t& fours, uint32_t& eights) {
  uint32_t twos_a, twos_b, fours_a, fours_b, eights_a, eights_b, sixteens;
  csa(twos_a, ones, ones, x[0], x[1]);
  csa(twos_b, ones, ones, x[2], x[3]);
  csa(fours_a, twos, twos, twos_a, twos_b);
  csa(twos_a, ones, ones, x[4], x[5]);
  csa(twos_b, ones, ones, x[6], x[7]);
  csa(fours_b, twos, twos, twos_a, twos_b);
  csa(eights_a, fours, fours, fours_a, fours_b);
  csa(twos_a, ones, ones, x[8], x[9]);
  csa(twos_b, ones, ones, x[10], x[11]);
  csa(fours_a, twos, twos, twos_a, twos_b);
  csa(twos_a, ones, ones, x[12], x[13]);
  csa(twos_b, ones, ones, x[14], x[15]);
  csa(fours_b, twos, twos, twos_a, twos_b);
  csa(eights_b, fours, fours, fours_a, fours_b);
  csa(sixteens, eights, eights, eights_a, eights_b);
  return sixteens;
}

// The 4 wire bytes at `at` as one little-endian word, of which the first
// `valid` (>= 1) are read and the rest are 0. kAligned: rows start on 4-byte
// boundaries and P % 4 == 0, so the whole word is in the row and one load.
template <bool kAligned>
__device__ __forceinline__ uint32_t load_word(const uint8_t* __restrict__ at, int64_t valid) {
  if (kAligned) return __ldg(reinterpret_cast<const uint32_t*>(at));
  uint32_t w = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < valid) w |= (uint32_t)__ldg(at + j) << (8 * j);
  return w;
}

template <int kCluster, bool kAligned>
__global__ void __launch_bounds__(kThreads, 8)
bit_aggregate_kernel(const uint8_t* __restrict__ packed, const float* __restrict__ b,
                     float* __restrict__ out, int64_t m, int64_t p, int64_t n, float m_f,
                     float recip_m) {
  constexpr int kPerRank = kTileCoords / kCluster;  // coordinates this block finalizes
  constexpr int kOwn = kPerRank / kThreads;         // ... per thread
  __shared__ int counts[kSlots];
  const int64_t element = blockIdx.y;
  packed += element * m * p;
  b += element * n;
  out += element * n;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int64_t tile = blockIdx.x / kCluster;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t pw = (n + 7) / 8;
  const int64_t col = tile * kTileBytes + 4 * lane;
  const int first = rank * kPerRank + threadIdx.x;

  // b for the coordinates this thread finalizes, loaded before the count so
  // that its latency hides behind it.
  float bv[kOwn];
#pragma unroll
  for (int k = 0; k < kOwn; ++k) {
    const int64_t i = tile * kTileCoords + first + k * kThreads;
    bv[k] = i < n ? b[i] : 0.0f;
  }
  for (int i = threadIdx.x; i < kSlots; i += kThreads) counts[i] = 0;
  __syncthreads();

  uint32_t ones = 0, twos = 0, fours = 0, eights = 0;
  uint32_t lanes[8] = {0, 0, 0, 0, 0, 0, 0, 0};  // byte j of lanes[q]: carries of bit 8j+q
  // Adds this thread's counts to the block's; the byte lanes count 16 each.
  auto flush = [&](bool last) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int bit = 8 * j + q;
        int v = (int)((lanes[q] >> (8 * j)) & 0xFFu) << 4;
        if (last)
          v += (int)(((ones >> bit) & 1u) | (((twos >> bit) & 1u) << 1) | (((fours >> bit) & 1u) << 2) |
                     (((eights >> bit) & 1u) << 3));
        atomicAdd(&counts[slot(32 * lane + bit)], v);
      }
    }
  };

  // Row indices fit in 32 bits (m < 2^24); the row pointer advances by
  // `step` bytes, so a row costs one load and one 64-bit add.
  constexpr int kStride = kCluster * kWarps;
  const int rows = (int)m;
  const int64_t step = kStride * p;
  const int64_t valid = pw - col;  // wire bytes of this thread's word that hold coordinates < n
  const int s = rank * kWarps + warp;
  const uint8_t* row = packed + s * p + col;
  int groups = 0;
  for (int r0 = s; r0 < rows; r0 += kGroup * kStride, row += kGroup * step) {
    uint32_t x[kGroup];
    const uint8_t* at = row;
    if (rows - r0 > (kGroup - 1) * kStride) {  // all 16 rows exist
#pragma unroll
      for (int i = 0; i < kGroup; ++i, at += step) x[i] = valid > 0 ? load_word<kAligned>(at, valid) : 0u;
    } else {
#pragma unroll
      for (int i = 0; i < kGroup; ++i, at += step)
        x[i] = valid > 0 && i * kStride < rows - r0 ? load_word<kAligned>(at, valid) : 0u;
    }
    const uint32_t sixteens = add16(x, ones, twos, fours, eights);
#pragma unroll
    for (int q = 0; q < 8; ++q) lanes[q] += (sixteens >> q) & 0x01010101u;
    if (++groups == kFlushGroups) {
      flush(false);
#pragma unroll
      for (int q = 0; q < 8; ++q) lanes[q] = 0;
      groups = 0;
    }
  }
  flush(true);
  __syncthreads();
  cluster.sync();  // every block's counts are complete and visible

  int total[kOwn];
#pragma unroll
  for (int k = 0; k < kOwn; ++k) {
    total[k] = 0;
#pragma unroll
    for (int r = 0; r < kCluster; ++r) total[k] += cluster.map_shared_rank(&counts[0], r)[slot(first + k * kThreads)];
  }
  // This block is done reading the cluster's counts: arrive now, so that
  // the barrier overlaps the stores, and wait before leaving, since other
  // blocks may still read this block's counts.
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
#pragma unroll
  for (int k = 0; k < kOwn; ++k) {
    const int64_t i = tile * kTileCoords + first + k * kThreads;
    if (i < n) {
      const float num = __fsub_rn(__fmul_rn(2.0f, (float)total[k]), m_f);
      out[i] = __fmul_rn(__fmul_rn(num, recip_m), bv[k]);
    }
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__global__ void empty_kernel() {}

cudaLaunchConfig_t config(int64_t blocks, int64_t elements, int cluster, cudaStream_t stream,
                          cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, (unsigned)elements);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int kCluster>
cudaError_t launch(const uint8_t* packed, const float* b, float* out, int64_t m, int64_t p, int64_t n,
                   float recip_m, int64_t tiles, int64_t elements, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(tiles * kCluster, elements, kCluster, stream, &attr);
  const bool aligned = p % 4 == 0 && reinterpret_cast<uintptr_t>(packed) % 4 == 0;
  if (aligned)
    return cudaLaunchKernelEx(&cfg, bit_aggregate_kernel<kCluster, true>, packed, b, out, m, p, n,
                              (float)m, recip_m);
  return cudaLaunchKernelEx(&cfg, bit_aggregate_kernel<kCluster, false>, packed, b, out, m, p, n,
                            (float)m, recip_m);
}

}  // namespace

// packed: (elements, m, p) u8; b, out: (elements, n) f32 with 0 < n <= 8p;
// recip_m = f32(1) / f32(m); tiles: column tiles of kTileBytes wire bytes,
// ceil(ceil(n / 8) / kTileBytes); cluster: blocks per column tile, 1, 2, 4
// or 8 (both from launch_geometry); elements: 1 to 65,535.
extern "C" int probit_bit_aggregate(const uint8_t* packed, const float* b, float* out, int64_t m,
                                    int64_t p, int64_t n, float recip_m, int64_t tiles,
                                    int64_t cluster, int64_t elements, cudaStream_t stream) {
  if (tiles * kTileBytes < (n + 7) / 8 || elements < 1 || elements > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  switch (cluster) {
    case 1: err = launch<1>(packed, b, out, m, p, n, recip_m, tiles, elements, stream); break;
    case 2: err = launch<2>(packed, b, out, m, p, n, recip_m, tiles, elements, stream); break;
    case 4: err = launch<4>(packed, b, out, m, p, n, recip_m, tiles, elements, stream); break;
    case 8: err = launch<8>(packed, b, out, m, p, n, recip_m, tiles, elements, stream); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// An empty kernel launched like probit_bit_aggregate: `blocks` blocks of the
// same size in clusters of `cluster`. Its time is the floor under B3's.
extern "C" int probit_bit_aggregate_empty(int64_t blocks, int64_t cluster, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = config(blocks, 1, (int)cluster, stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, empty_kernel);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
