// Clutch chunk merge (Algorithm 1) over packed LUT planes, for Hopper
// (sm_90a).
//
// Replaces two TPU kernels of src/repro/kernels/clutch_merge.py:
//   * clutch_merge (_kernel): one [R, W] LUT, one scalar's [C] indices;
//   * clutch_merge_banked (_banked_kernel): [B, R, W] LUTs, per-bank [B, C]
//     indices.
// Both run on merge_kernel below, the unbanked merge being B = 1.
//
// The TPU loaded an (R, BW) tile of the whole LUT into VMEM and gathered
// rows from it with dynamic sublane slices.  Here the block stages only
// its bank's 2C indices in shared memory (clamped to [0, R)) and each
// thread reads the 2C-1 rows it needs straight from device memory, one
// coalesced word per row, and folds them with MAJ3 in a register: no row
// the scalar does not name is ever read.  Grid (word block, bank), one
// thread per word.
//
// Bound: the distinct rows the indices name, at most (2C-1) * B * W * 4
// bytes read, plus B * W * 4 written; a handful of logic operations per
// row word is far below the issue rate, so it is bound by bytes.

#include "clutch.cuh"

namespace {

using clutch::BLOCK;
using clutch::merge;
using clutch::stage;

__global__ void merge_kernel(const uint32_t* __restrict__ lut,
                             const int32_t* __restrict__ lt,
                             const int32_t* __restrict__ le, int c, int R,
                             int W, uint32_t* __restrict__ out) {
  extern __shared__ int s_idx[];  // lt then le, c each
  const long long b = blockIdx.y;
  stage(s_idx, lt + b * c, c, R);
  stage(s_idx + c, le + b * c, c, R);
  __syncthreads();
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  out[b * W + w] = merge(lut + b * R * W + w, s_idx, c, W);
}

}  // namespace

extern "C" {

// lut [B, R, W] words; lt, le [B, c] int32; out [B, W] words.
int merge_launch(const void* lut, const void* lt, const void* le, int c,
                 int B, int R, int W, void* out, void* stream) {
  if (B <= 0 || W <= 0) return (int)cudaSuccess;
  if (c < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((W + BLOCK - 1) / BLOCK, B);
  merge_kernel<<<grid, BLOCK, 2 * c * sizeof(int), (cudaStream_t)stream>>>(
      (const uint32_t*)lut, (const int32_t*)lt, (const int32_t*)le, c, R, W,
      (uint32_t*)out);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
