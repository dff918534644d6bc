// Bit-serial borrow-chain comparison (the paper's baseline), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/bitserial_cmp.py ::
// bitserial_cmp (_kernel): a < B over binary bit-planes, LSB plane first,
// borrow = maj3(not_a_i, plane_i, borrow) for i = 0..n_bits-1, where
// not_a_i is all ones when bit i of a is 0.
//
// The TPU took the n_bits not_a words as an array operand.  Here a and
// n_bits travel by value and each thread derives not_a_i from a's bits,
// so the kernel reads nothing but the planes; the padding planes past
// n_bits are never read.  One thread per word walks down the n_bits
// planes, each read once, coalesced along w.
//
// Bound: n_bits * W * 4 bytes of planes read plus W * 4 written; every
// plane word is read whatever a is, which is the cost Clutch's 2C-1 rows
// avoid.

#include "clutch.cuh"

namespace {

using clutch::BLOCK;
using clutch::maj3;

__global__ void bitserial_kernel(const uint32_t* __restrict__ planes, int W,
                                 uint32_t a, int n_bits,
                                 uint32_t* __restrict__ out) {
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  uint32_t borrow = 0;
  for (int i = 0; i < n_bits; ++i) {
    const uint32_t not_a = ((a >> i) & 1u) ? 0u : 0xffffffffu;
    borrow = maj3(not_a, __ldg(planes + (long long)i * W + w), borrow);
  }
  out[w] = borrow;
}

}  // namespace

extern "C" {

// planes [n_pad, W] words, n_pad >= n_bits; a the scalar; out [W] words.
int bitserial_launch(const void* planes, int W, unsigned a, int n_bits,
                     void* out, void* stream) {
  if (W <= 0) return (int)cudaSuccess;
  if (n_bits < 1 || n_bits > 32) return (int)cudaErrorInvalidValue;
  bitserial_kernel<<<(W + BLOCK - 1) / BLOCK, BLOCK, 0,
                     (cudaStream_t)stream>>>(
      (const uint32_t*)planes, W, a, n_bits, (uint32_t*)out);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
