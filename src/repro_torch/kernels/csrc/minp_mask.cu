// Min-p logit mask by chunked monotonic compare, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/minp_mask.py:47 :: minp_mask
// (_kernel :25): out[b, v] = x where m(x) >= m(tau_b), else fill, with
// m the order-preserving uint32 image of a float32 (flip every bit of a
// negative value, only the sign bit of a positive one) and the compare
// evaluated as the Clutch recurrence over chunks of m, LSB chunk first:
//
//   acc_j = lt_j | (le_j & acc_{j-1}),   lt_j = tc_j < xc_j,  le_j = tc_j <= xc_j
//   keep  = acc_last | (xu == tu)
//
// acc_j is "tau < x" on the low bits up to chunk j, so keep is m(x) >= m(tau)
// and the result is bit-equal to the TPU kernel, -0.0 and NaN included
// (-0.0 maps just below +0.0; +NaN above +inf; -NaN below -inf).  The
// recurrence is written out as the TPU kernel has it; its integer work
// (about 6 operations per element and chunk) stays under the byte bound.
//
// The TPU kernel tiled [B, V] into (8, 1024) VMEM blocks.  Here one block
// row serves one batch row: its tau is loaded once and its chunk images
// kept in registers; each thread streams VEC_PER_THREAD float4s of the row
// (loads issued before any compute), and the first block of the row also
// takes the up-to-3 elements before the first 16-byte boundary and after
// the last, so any V works.  The wrapper passes 16-byte aligned bases, so
// a row's input and output share their alignment.
//
// Bound: bytes.  Each logit is read once and written once, 2 * B * V * 4
// bytes plus the B taus over 3.35 TB/s: 4.9 us at [8, 256000], 78 us at
// [128, 256000].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC_PER_THREAD = 4;
constexpr int MAX_CHUNKS = 8;

__device__ __forceinline__ uint32_t monotonic(float x) {
  const uint32_t b = __float_as_uint(x);
  // negative: b ^ 0xFFFFFFFF; positive (sign clear): b ^ 0x80000000
  return b ^ ((uint32_t)((int32_t)b >> 31) | 0x80000000u);
}

struct Chunks {
  int n;
  int shift[MAX_CHUNKS];
  uint32_t mask[MAX_CHUNKS];
  uint32_t tc[MAX_CHUNKS];  // tau's chunk images
};

__device__ __forceinline__ bool keep(uint32_t xu, uint32_t tu,
                                     const Chunks& c) {
  bool acc = false;  // the first step reduces to acc = lt
#pragma unroll
  for (int j = 0; j < MAX_CHUNKS; ++j) {
    if (j < c.n) {
      const uint32_t xc = (xu >> c.shift[j]) & c.mask[j];
      acc = (c.tc[j] < xc) | ((c.tc[j] <= xc) & acc);
    }
  }
  return acc | (xu == tu);
}

__device__ __forceinline__ float masked(float x, uint32_t tu, const Chunks& c,
                                        float fill) {
  return keep(monotonic(x), tu, c) ? x : fill;
}

// widths: chunk k's width in bits 8k..8k+7, LSB chunk first; they sum to 32.
__global__ void minp_mask_kernel(const float* __restrict__ logits,
                                 const float* __restrict__ tau, int V,
                                 unsigned long long widths, int n_chunks,
                                 float fill, float* __restrict__ out) {
  const long long row = blockIdx.y;
  const uint32_t tu = monotonic(__ldg(tau + row));
  Chunks c;
  c.n = n_chunks;
  int shift = 0;
#pragma unroll
  for (int j = 0; j < MAX_CHUNKS; ++j) {
    const int k = (int)((widths >> (8 * j)) & 0xFFu);
    c.shift[j] = shift < 32 ? shift : 0;
    c.mask[j] = k >= 32 ? 0xFFFFFFFFu : ((1u << k) - 1u);
    c.tc[j] = (tu >> c.shift[j]) & c.mask[j];
    shift += k;
  }

  const float* x = logits + row * V;
  float* o = out + row * V;
  // elements before the first 16-byte boundary of the row, then float4s
  int head = (int)(((16u - ((uintptr_t)x & 15u)) & 15u) >> 2);
  if (head > V) head = V;
  const int nvec = (V - head) >> 2;
  const int tail = V - head - 4 * nvec;
  const float4* xv = reinterpret_cast<const float4*>(x + head);
  float4* ov = reinterpret_cast<float4*>(o + head);

  const int base = blockIdx.x * THREADS * VEC_PER_THREAD + threadIdx.x;
  float4 v[VEC_PER_THREAD];
#pragma unroll
  for (int i = 0; i < VEC_PER_THREAD; ++i) {
    const int idx = base + i * THREADS;
    if (idx < nvec) v[i] = __ldcs(xv + idx);
  }
#pragma unroll
  for (int i = 0; i < VEC_PER_THREAD; ++i) {
    const int idx = base + i * THREADS;
    if (idx < nvec) {
      float4 r;
      r.x = masked(v[i].x, tu, c, fill);
      r.y = masked(v[i].y, tu, c, fill);
      r.z = masked(v[i].z, tu, c, fill);
      r.w = masked(v[i].w, tu, c, fill);
      __stcs(ov + idx, r);
    }
  }
  if (blockIdx.x == 0) {
    const int t = threadIdx.x;
    if (t < head) o[t] = masked(x[t], tu, c, fill);
    if (t >= 4 && t < 4 + tail) {
      const int e = head + 4 * nvec + (t - 4);
      o[e] = masked(x[e], tu, c, fill);
    }
  }
}

}  // namespace

extern "C" {

// logits [B, V] float32 and out [B, V] float32, both 16-byte aligned;
// tau [B] float32; widths / n_chunks as in minp_mask_kernel.
int minp_mask_launch(const void* logits, const void* tau, int B, int V,
                     unsigned long long widths, int n_chunks, float fill,
                     void* out, void* stream) {
  if (B <= 0 || V <= 0) return (int)cudaSuccess;
  const int per_block = THREADS * VEC_PER_THREAD;
  const int nvec = V / 4;  // no fewer than any row's float4 count
  const int tiles = (nvec + per_block - 1) / per_block;
  const dim3 grid((unsigned)(tiles > 0 ? tiles : 1), (unsigned)B);
  minp_mask_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)logits, (const float*)tau, V, widths, n_chunks, fill,
      (float*)out);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
