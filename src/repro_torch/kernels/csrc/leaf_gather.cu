// GBDT leaf aggregation, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/leaf_gather.py :: leaf_gather
// (_kernel): pred[b] = sum_t leaves[t, addr[b, t]].
//
// Lane-wise gathers are slow on a TPU, so it expanded each address into a
// one-hot row and contracted it with the leaf table on the MXU, 2^depth
// multiplies per term.  Hopper gathers directly.  One warp per instance:
// its lanes stride over the trees (t = lane, lane + 32, ...), read the
// instance's address row coalesced, and gather leaves[t * L + addr] from
// the leaf table, which stays in L2 (1000 x 64 x 4 B = 256 KB).  An
// address outside [0, L) -- the -1 padding, or one no leaf matches --
// adds nothing, as it matched no column of the TPU's one-hot.  The warp
// then sums its lanes with a fixed __shfl_xor_sync tree: no float
// atomics, so two launches give bit-equal results.
//
// Bound: the address matrix read once from device memory, B * T * 4
// bytes, plus the table and the B outputs; the T adds per instance are
// far below the float32 rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_BLOCK = 8;

__global__ void leaf_gather_kernel(const int32_t* __restrict__ addrs,
                                   const float* __restrict__ leaves, int B,
                                   int T, int L, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long b = (long long)blockIdx.x * WARPS_PER_BLOCK +
                      (threadIdx.x >> 5);
  if (b >= B) return;  // warp-uniform: the whole warp leaves together
  const int32_t* row = addrs + b * T;
  float sum = 0.0f;
  for (int t = lane; t < T; t += 32) {
    const int a = __ldg(row + t);
    if ((unsigned)a < (unsigned)L) sum += __ldg(leaves + (long long)t * L + a);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) out[b] = sum;
}

}  // namespace

extern "C" {

// addrs [B, T] int32; leaves [T, L] float32; out [B] float32.
int leaf_gather_launch(const void* addrs, const void* leaves, int B, int T,
                       int L, void* out, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  const int blocks = (B + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK;
  leaf_gather_kernel<<<blocks, WARPS_PER_BLOCK * 32, 0,
                       (cudaStream_t)stream>>>(
      (const int32_t*)addrs, (const float*)leaves, B, T, L, (float*)out);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
