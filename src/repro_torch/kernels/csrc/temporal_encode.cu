// Temporal-coding LUT planes for one k-bit chunk, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/temporal_encode.py ::
// temporal_encode (_kernel): plane r, bit i of word w is (r < v[w, i]).
//
// The TPU reduced the 32 values of a word with a shift-sum over the lane
// axis.  Here that reduction is one warp instruction: lane i holds
// v[w, i] and __ballot_sync(~0u, r < v) is exactly word [r, w] in the
// little-endian packing.  A warp owns 32 consecutive words: it loads
// their 32 x 32 values with coalesced 128-byte loads (value j of lane i
// is v[w0 + j, i]), then per plane issues 32 ballots and keeps ballot j
// in lane j, so each plane's 32 words leave in one coalesced store.
//
// Bound on this card: the bytes written, R * W * 4, plus the W * 128
// bytes of values read once; one ballot per output word is far below
// the issue rate.  The TPU's block rule (8 rows x 512 words) does not
// carry over: a block is 8 warps (256 words) by ROWS_PER_BLOCK planes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS_PER_BLOCK = 8;
constexpr int ROWS_PER_BLOCK = 16;

__global__ void temporal_encode_kernel(const int32_t* __restrict__ vals,
                                       int W, int R,
                                       uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * WARPS_PER_BLOCK + (threadIdx.x >> 5);
  const long long w0 = (long long)warp * 32;
  if (w0 >= W) return;  // warp-uniform: the whole warp leaves together
  int v[32];
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const long long w = w0 + j;
    v[j] = (w < W) ? vals[w * 32 + lane] : 0;
  }
  const int r0 = blockIdx.y * ROWS_PER_BLOCK;
  const int r1 = min(R, r0 + ROWS_PER_BLOCK);
  const bool store = w0 + lane < W;
  for (int r = r0; r < r1; ++r) {
    uint32_t mine = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const uint32_t word = __ballot_sync(0xffffffffu, r < v[j]);
      if (lane == j) mine = word;
    }
    if (store) out[(long long)r * W + w0 + lane] = mine;
  }
}

}  // namespace

extern "C" {

// vals: [W, 32] int32 chunk values in [0, 2^k); out: [R, W] words,
// R = 2^k - 1.  Launches on `stream`; allocates nothing.
int temporal_encode_launch(const void* vals, int W, int R, void* out,
                           void* stream) {
  if (W <= 0 || R <= 0) return (int)cudaSuccess;
  const int warps = (W + 31) / 32;
  dim3 grid((warps + WARPS_PER_BLOCK - 1) / WARPS_PER_BLOCK,
            (R + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  temporal_encode_kernel<<<grid, WARPS_PER_BLOCK * 32, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)vals, W, R, (uint32_t*)out);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
