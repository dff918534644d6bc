// Temporal-coding LUT planes for one k-bit chunk, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/temporal_encode.py ::
// temporal_encode (_kernel): plane r, bit i of word w is (r < v[w, i]).
//
// Bound on this card: bytes.  The W * 128 bytes of values are read once
// and the R * W * 4 bytes of planes written once (R = 2^k - 1); at the
// table path's shape (W = 2^19, k = 4) that is 98.6 MB, 0.0294 ms at
// 3.35 TB/s.  The design keeps the instruction count per output word
// below what that rate allows and keeps loads in flight:
//
//   * A persistent grid (the blocks that fit on the SMs at once) walks
//     over tiles of 32 words; each warp owns every (grid * warps)-th
//     tile.  While a warp encodes one tile, the next tile's 4 KB of
//     values are on their way into the warp's second shared-memory
//     buffer: cp.async, 16 bytes a lane, zero-filled past W.
//   * Bit-sliced planes.  Lane i reads value i of word j (conflict-free)
//     and k ballots turn the 32 values of word j into its k bit-slices
//     b[0..k-1] (bit i of b[q] = bit q of v[w, i]); lane j keeps word j's.
//     Each lane then computes all R planes of its own word with bitwise
//     ops on the slices, 32 elements at a time: the planes of the low
//     L = min(k, 5) bits come from the recursion
//         [v > r] = hi | [v_lo > r]                  for r <  2^l,
//         [v > r] = hi & [v_lo > r - 2^l]            for r >= 2^l,
//     one op per plane, held in 31 registers; each value h of the high
//     k - L bits adds gt_h = [v_hi > h] and eq_h = [v_hi == h], and then
//     plane h * 2^L + r_lo is gt_h | (eq_h & low[r_lo]), one op.  That is
//     k ballots per word and about one op per plane word, where one
//     ballot per plane word (the previous design) cost about four.
//   * k is a template parameter (1..16), so R is a compile-time
//     constant, the slicing and the low planes unroll, and each value is
//     read once whatever k is.
//   * Values are clamped into [0, 2^k - 1] first, which leaves every
//     plane as the plain version has it for any int32 value: a negative
//     value sets no plane, one of 2^k or more sets all.
//   * Planes leave with streaming stores (__stcs), one coalesced 128 B
//     row segment per warp and plane.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;              // warps per block
constexpr int TILE_INTS = 32 * 32;    // one tile: 32 words x 32 values
constexpr int CHUNKS = TILE_INTS / 4 / 32;  // 16-byte copies per lane

__device__ __forceinline__ void load_tile(int* dst, const int32_t* vals,
                                          long long tile, int W, int lane) {
  const long long w0 = tile * 32;
#pragma unroll
  for (int m = 0; m < CHUNKS; ++m) {
    const int q = lane + 32 * m;           // 16-byte chunk of the tile
    const bool ok = w0 + q / 8 < W;        // 8 chunks per word
    const int32_t* src = ok ? vals + w0 * 32 + q * 4 : vals;
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst + q * 4);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(s), "l"(src), "r"(ok ? 16 : 0) : "memory");
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int K>
__global__ void __launch_bounds__(WARPS * 32)
temporal_encode_kernel(const int32_t* __restrict__ vals, int W,
                       uint32_t* __restrict__ out) {
  constexpr int R = (1 << K) - 1;
  constexpr int L = K < 5 ? K : 5;       // bits of the register planes
  constexpr int H = K - L;               // bits walked at run time
  __shared__ __align__(16) int buf[WARPS][2][TILE_INTS];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tiles = (W + 31) / 32;
  const long long step = (long long)gridDim.x * WARPS;
  long long t = (long long)blockIdx.x * WARPS + warp;
  int cur = 0;
  if (t < tiles) load_tile(buf[warp][0], vals, t, W, lane);
  commit();
  for (; t < tiles; t += step, cur ^= 1) {
    if (t + step < tiles) load_tile(buf[warp][cur ^ 1], vals, t + step, W, lane);
    commit();
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncwarp();
    const int* v = buf[warp][cur];

    // bit-slices of this lane's word (word j of the tile for lane j)
    uint32_t b[K];
#pragma unroll
    for (int q = 0; q < K; ++q) b[q] = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int x = min(max(v[j * 32 + lane], 0), R);
      const bool mine = lane == j;
#pragma unroll
      for (int q = 0; q < K; ++q) {
        const uint32_t s = __ballot_sync(0xffffffffu, (x >> q) & 1);
        b[q] = mine ? s : b[q];
      }
    }
    __syncwarp();   // every lane is done with this buffer before its refill

    // planes of the low L bits: low[r] = [v_lo > r], r < 2^L - 1
    uint32_t low[(1 << L) - 1];
    low[0] = b[0];
#pragma unroll
    for (int l = 1; l < L; ++l) {       // trip counts fixed, so that
      const int n = (1 << l) - 1;       // low[] stays in registers
#pragma unroll
      for (int r = 0; r < 15; ++r)
        if (r < n) low[n + 1 + r] = b[l] & low[r];
      low[n] = b[l];
#pragma unroll
      for (int r = 0; r < 15; ++r)
        if (r < n) low[r] = b[l] | low[r];
    }

    const long long w = t * 32 + lane;
    const bool store = w < W;
    uint32_t* col = out + w;
    for (int h = 0; h < (1 << H); ++h) {
      uint32_t gt = 0, eq = 0xffffffffu;   // [v_hi > h], [v_hi == h]
#pragma unroll
      for (int q = H - 1; q >= 0; --q) {
        const uint32_t bq = b[L + q];
        if ((h >> q) & 1) {
          eq &= bq;
        } else {
          gt |= eq & bq;
          eq &= ~bq;
        }
      }
      const long long r0 = (long long)h << L;
      if (store) {
#pragma unroll
        for (int r = 0; r < (1 << L) - 1; ++r)
          __stcs(col + (r0 + r) * W, gt | (eq & low[r]));
        if (h + 1 < (1 << H))   // plane 2^k - 1 does not exist
          __stcs(col + (r0 + (1 << L) - 1) * W, gt);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int K>
int launch(const void* vals, int W, void* out, cudaStream_t stream) {
  static int max_blocks = 0;   // per SM, for this instantiation
  if (max_blocks == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &max_blocks, temporal_encode_kernel<K>, WARPS * 32, 0);
    if (e != cudaSuccess) return (int)e;
    if (max_blocks < 1) return (int)cudaErrorInvalidConfiguration;
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const long long tiles = (W + 31) / 32;
  const long long need = (tiles + WARPS - 1) / WARPS;
  const int grid = (int)(need < (long long)sms * max_blocks
                             ? need : (long long)sms * max_blocks);
  temporal_encode_kernel<K><<<grid, WARPS * 32, 0, stream>>>(
      (const int32_t*)vals, W, (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// vals: [W, 32] int32 chunk values, 16-byte aligned; out: [2^k - 1, W]
// words, 1 <= k <= 16.  Launches on `stream`; allocates nothing.
int temporal_encode_launch(const void* vals, int W, int k, void* out,
                           void* stream) {
  if (W <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: return launch<1>(vals, W, out, s);
    case 2: return launch<2>(vals, W, out, s);
    case 3: return launch<3>(vals, W, out, s);
    case 4: return launch<4>(vals, W, out, s);
    case 5: return launch<5>(vals, W, out, s);
    case 6: return launch<6>(vals, W, out, s);
    case 7: return launch<7>(vals, W, out, s);
    case 8: return launch<8>(vals, W, out, s);
    case 9: return launch<9>(vals, W, out, s);
    case 10: return launch<10>(vals, W, out, s);
    case 11: return launch<11>(vals, W, out, s);
    case 12: return launch<12>(vals, W, out, s);
    case 13: return launch<13>(vals, W, out, s);
    case 14: return launch<14>(vals, W, out, s);
    case 15: return launch<15>(vals, W, out, s);
    case 16: return launch<16>(vals, W, out, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
