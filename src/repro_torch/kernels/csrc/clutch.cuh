// Device helpers shared by the Clutch kernels for Hopper (sm_90a).
//
// Words are 32-bit bit-planes: bit i of word w is element 32 * w + i.
// Every source that includes this header is its own library (one nvcc
// each); the build hashes this header with each source.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace clutch {

// The block size of every one-thread-per-word kernel.
constexpr int BLOCK = 256;

__device__ __forceinline__ uint32_t maj3(uint32_t a, uint32_t b, uint32_t c) {
  return (a & b) | (b & c) | (a & c);
}

// Algorithm 1 over lt = idx[0:c], le = idx[c:2c]; `col` points at the
// thread's word of row 0, rows are `W` words apart.  acc = row(lt[0]);
// acc = maj3(acc, row(lt[j]), row(le[j])) for j = 1..c-1: 2c-1 gathered
// rows, le[0] is never read.
__device__ __forceinline__ uint32_t merge(const uint32_t* __restrict__ col,
                                          const int* idx, int c, long long W) {
  uint32_t acc = __ldg(col + idx[0] * W);
  for (int j = 1; j < c; ++j)
    acc = maj3(acc, __ldg(col + idx[j] * W), __ldg(col + idx[c + j] * W));
  return acc;
}

// Copy n row indices into shared memory, clamped to [0, R) so that no
// index can read outside the LUT.  The caller synchronises after it.
__device__ __forceinline__ void stage(int* dst, const int32_t* src, int n,
                                      int R) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    dst[i] = min(max(src[i], 0), R - 1);
}

// Add the popcount of every thread's `word` to *cnt: a warp reduction, a
// block reduction, then one 64-bit atomicAdd per block (an exact integer,
// so the order of the atomics does not matter).  Every thread of a block
// of BLOCK threads calls it.
__device__ __forceinline__ void add_block_popcount(
    uint32_t word, unsigned long long* cnt) {
  const unsigned n = __reduce_add_sync(0xffffffffu, (unsigned)__popc(word));
  __shared__ unsigned warp_sum[BLOCK / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sum[warp] = n;
  __syncthreads();
  if (warp == 0) {
    unsigned v = lane < (int)(blockDim.x >> 5) ? warp_sum[lane] : 0u;
    v = __reduce_add_sync(0xffffffffu, v);
    if (lane == 0 && v) atomicAdd(cnt, (unsigned long long)v);
  }
}

}  // namespace clutch
