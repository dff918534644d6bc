// RMS normalisation of rows, fused, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference package leaves its norm
// (src/repro/models/layers.py :: rmsnorm) to XLA, and the port's plain
// version (kernels/ref.py :: rmsnorm_ref) is ten PyTorch operations, each
// a launch: at a decode step of a model's 61 norms (Jamba2 Mini's 16 layers)
// about 550 of its launches, which the host, not the card, paid for.  This
// kernel is one launch a norm:
//
//   y = x * rsqrt(mean(x^2) + eps) * (1 + scale)
//
// in float32, rounded once to y's dtype; x and y [T, G, d] (T rows of G
// groups of d, e.g. a token's B and C side by side, G = 2), x's rows at
// ld elements apart, y contiguous; scale [G, d].
//
// Bound on this card: bytes (x read, y written, 2 bytes an element in
// bf16).  A warp a (row, group): each lane sums the squares of its
// elements, five shuffles join them, and the lanes scale and store their
// elements (read again, from L1).  Eight warps a block.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, typename S>
__global__ void __launch_bounds__(THREADS)
rmsnorm_kernel(const T* __restrict__ x, const S* __restrict__ scale,
               T* __restrict__ y, long long rows, long long ld, int groups,
               int d, float eps) {
  const long long r = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  const long long t = r / groups;
  const int g = (int)(r - t * groups);
  const T* xr = x + t * ld + (long long)g * d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = load_f(xr + i);
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float inv = rsqrtf(ss / (float)d + eps);
  const S* sr = scale + (long long)g * d;
  T* yr = y + r * d;
  for (int i = lane; i < d; i += 32)
    store_f(yr + i, load_f(xr + i) * inv * (1.f + load_f(sr + i)));
}

template <typename T, typename S>
void launch(const void* x, const void* scale, void* y, long long rows,
            long long ld, int groups, int d, float eps, cudaStream_t s) {
  const long long blocks = (rows + WARPS - 1) / WARPS;
  rmsnorm_kernel<T, S><<<(unsigned)blocks, THREADS, 0, s>>>(
      (const T*)x, (const S*)scale, (T*)y, rows, ld, groups, d, eps);
}

}  // namespace

extern "C" {

// x [T, G, d] (rows at ld elements, a row's G groups of d contiguous) and
// y [T, G, d] contiguous in float32 (bf16 == 0) or bfloat16 (1); scale
// [G, d] in float32 (scale_bf16 == 0) or bfloat16 (1).  Launches on
// `stream`; allocates nothing.
int rmsnorm_launch(const void* x, const void* scale, void* y, long long tokens,
                   long long ld, int groups, int d, float eps, int bf16,
                   int scale_bf16, void* stream) {
  const long long rows = tokens * groups;
  if (rows <= 0 || d <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  using B16 = __nv_bfloat16;
  if (bf16 && scale_bf16)
    launch<B16, B16>(x, scale, y, rows, ld, groups, d, eps, s);
  else if (bf16)
    launch<B16, float>(x, scale, y, rows, ld, groups, d, eps, s);
  else if (scale_bf16)
    launch<float, B16>(x, scale, y, rows, ld, groups, d, eps, s);
  else
    launch<float, float>(x, scale, y, rows, ld, groups, d, eps, s);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
