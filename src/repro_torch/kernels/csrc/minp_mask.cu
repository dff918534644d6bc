// Min-p logit mask by monotonic compare, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/minp_mask.py:47 :: minp_mask
// (_kernel :25): out[b, v] = x where m(x) >= m(tau_b), else fill, with
// m the order-preserving uint32 image of a float32 (flip every bit of a
// negative value, only the sign bit of a positive one).
//
// The TPU kernel evaluates the compare as the Clutch recurrence over
// chunks of m, LSB chunk first:
//
//   acc_j = lt_j | (le_j & acc_{j-1}),   lt_j = tc_j < xc_j,  le_j = tc_j <= xc_j
//   keep  = acc_last | (xu == tu)
//
// By induction acc_j is "tau < x" on the bits of chunks 0..j, whatever
// the widths, so for any chunking whose widths sum to 32, acc_last is
// m(tau) < m(x) and keep is m(x) >= m(tau): one unsigned compare.  This
// kernel evaluates that compare and does not read the chunking (the
// wrapper still checks it); the plain version keeps the recurrence, so
// every check holds the one against the other.  The result is bit-equal
// to the TPU kernel, -0.0 and NaN included (-0.0 maps just below +0.0;
// +NaN above +inf; -NaN below -inf).
//
// Bound on this card: bytes.  Each logit is read once and written once,
// 2 * B * V * 4 bytes plus the B taus over 3.35 TB/s: 4.9 us at
// [8, 256000], 78 us at [128, 256000].  About 5 integer operations per
// element remain (the map, the compare, the select), far below the rate.
// The design keeps loads in flight while it stores:
//
//   * Tiles of TILE float4s (16 KB of logits), each inside one row, so a
//     tile has one tau.  A persistent grid (BLOCKS_PER_SM blocks on each
//     SM) walks them in order; the flat tile index is 64-bit, so any B
//     works.  At the LM path's [8, 256000] the 504 tiles fit the grid
//     in one wave, every load issued at once; at [128, 256000] each
//     block walks about 15 tiles.
//   * Registers double-buffered: a block issues the next tile's loads
//     (and its tau) before it masks and stores the current tile.
//   * The tile size, blocks per SM and the plain (cached) loads and
//     stores are those that timed best at both shapes; at [8, 256000] the
//     kernel runs within a few percent of y.copy_(x) over the same bytes,
//     about half of which is an empty launch's own time (PERF.md).
//   * Rows off the 16-byte grid (V % 4 != 0): the first tile of a row also
//     takes the up-to-3 elements before the row's first 16-byte boundary
//     and after its last.  The wrapper passes 16-byte aligned bases, so a
//     row's input and output share their alignment.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 4;                 // float4s per thread and tile
constexpr int TILE = THREADS * VEC;    // float4s per tile
constexpr int BLOCKS_PER_SM = 4;

__device__ __forceinline__ uint32_t monotonic(float x) {
  const uint32_t b = __float_as_uint(x);
  // negative: b ^ 0xFFFFFFFF; positive (sign clear): b ^ 0x80000000
  return b ^ ((uint32_t)((int32_t)b >> 31) | 0x80000000u);
}

__device__ __forceinline__ float masked(float x, uint32_t tu, float fill) {
  return monotonic(x) >= tu ? x : fill;
}

// One tile: tile j of row `row`; the row's bases, its float4 body (after
// `head` leading elements, `tail` trailing ones) and its tau's image.
struct Tile {
  const float* x;
  float* o;
  int head, nvec, tail, j;
  uint32_t tu;
};

__device__ __forceinline__ Tile locate(const float* __restrict__ logits,
                                       const float* __restrict__ tau,
                                       float* __restrict__ out, long long row,
                                       int j, int V) {
  Tile s;
  s.x = logits + row * V;
  s.o = out + row * V;
  const int head = (int)(((16u - ((uintptr_t)s.x & 15u)) & 15u) >> 2);
  s.head = head < V ? head : V;
  s.nvec = (V - s.head) >> 2;
  s.tail = V - s.head - 4 * s.nvec;
  s.j = j;
  s.tu = monotonic(__ldg(tau + row));
  return s;
}

__device__ __forceinline__ void load(const Tile& s, float4 (&v)[VEC]) {
  const float4* xv = reinterpret_cast<const float4*>(s.x + s.head);
  const int base = s.j * TILE + threadIdx.x;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int idx = base + i * THREADS;
    if (idx < s.nvec) v[i] = __ldg(xv + idx);
  }
}

__device__ __forceinline__ void store(const Tile& s, const float4 (&v)[VEC],
                                      float fill) {
  float4* ov = reinterpret_cast<float4*>(s.o + s.head);
  const int base = s.j * TILE + threadIdx.x;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const int idx = base + i * THREADS;
    if (idx < s.nvec) {
      float4 r;
      r.x = masked(v[i].x, s.tu, fill);
      r.y = masked(v[i].y, s.tu, fill);
      r.z = masked(v[i].z, s.tu, fill);
      r.w = masked(v[i].w, s.tu, fill);
      ov[idx] = r;
    }
  }
  if (s.j == 0) {
    const int t = threadIdx.x;
    if (t < s.head) s.o[t] = masked(s.x[t], s.tu, fill);
    if (t >= 4 && t < 4 + s.tail) {
      const int e = s.head + 4 * s.nvec + (t - 4);
      s.o[e] = masked(s.x[e], s.tu, fill);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
minp_mask_kernel(const float* __restrict__ logits,
                 const float* __restrict__ tau, int V, int tiles_per_row,
                 long long n_tiles, float fill, float* __restrict__ out) {
  long long t = blockIdx.x;
  if (t >= n_tiles) return;
  // tile t is tile j of row `row`; a step of the grid moves both
  const long long step = gridDim.x;
  long long row = t / tiles_per_row;
  int j = (int)(t - row * tiles_per_row);
  const long long drow = step / tiles_per_row;
  const int dj = (int)(step - drow * tiles_per_row);

  Tile cur = locate(logits, tau, out, row, j, V);
  float4 a[VEC];
  load(cur, a);
  for (;;) {
    t += step;
    row += drow;
    j += dj;
    if (j >= tiles_per_row) {
      j -= tiles_per_row;
      ++row;
    }
    const bool more = t < n_tiles;
    Tile nxt;
    float4 b[VEC];
    if (more) {                     // the next tile's loads go out first
      nxt = locate(logits, tau, out, row, j, V);
      load(nxt, b);
    }
    store(cur, a, fill);
    if (!more) break;
    cur = nxt;
#pragma unroll
    for (int i = 0; i < VEC; ++i) a[i] = b[i];
  }
}

}  // namespace

extern "C" {

// logits [B, V] float32 and out [B, V] float32, both 16-byte aligned;
// tau [B] float32.  Launches on `stream`; allocates nothing.
int minp_mask_launch(const void* logits, const void* tau, int B, int V,
                     float fill, void* out, void* stream) {
  if (B <= 0 || V <= 0) return (int)cudaSuccess;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const int nvec = V / 4;  // no fewer than any row's float4 count
  const int tiles_per_row = nvec > 0 ? (nvec + TILE - 1) / TILE : 1;
  const long long n_tiles = (long long)B * tiles_per_row;
  const long long cap = (long long)sms * BLOCKS_PER_SM;
  const int grid = (int)(n_tiles < cap ? n_tiles : cap);
  minp_mask_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)logits, (const float*)tau, V, tiles_per_row, n_tiles,
      fill, (float*)out);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
