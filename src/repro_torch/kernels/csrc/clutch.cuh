// Device helpers shared by the Clutch kernels for Hopper (sm_90a).
//
// Words are 32-bit bit-planes: bit i of word w is element 32 * w + i.
// Every source that includes this header is its own library (one nvcc
// each); the build hashes this header with each source.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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


// ------------------------------------------------------------------ //
// The row gather of merge_kernel and compound_kernel
// ------------------------------------------------------------------ //
//
// A block owns a tile of TILE words of every row; each of its BLOCK
// threads owns QUAD of them.  Where W % 4 == 0 and the LUT is 16-byte
// aligned (VEC4) they are four consecutive words, one 16-byte
// ld.global.nc.v4 a row, a warp's load covering 512 contiguous bytes;
// otherwise words tid + BLOCK * q, four 4-byte loads a row, each
// coalesced across the warp.  (Two or one words a thread, or eight,
// measured slower: PERF.md.)  Loads past W read a word inside
// the row (clamped) and are dropped at the store.

constexpr int QUAD = 4;
constexpr int TILE = BLOCK * QUAD;

struct Quad {
  uint32_t w[QUAD];
};

__device__ __forceinline__ Quad maj3(const Quad& a, const Quad& b,
                                     const Quad& c) {
  Quad r;
#pragma unroll
  for (int q = 0; q < QUAD; ++q) r.w[q] = maj3(a.w[q], b.w[q], c.w[q]);
  return r;
}

__device__ __forceinline__ Quad operator&(const Quad& a, const Quad& b) {
  Quad r;
#pragma unroll
  for (int q = 0; q < QUAD; ++q) r.w[q] = a.w[q] & b.w[q];
  return r;
}

__device__ __forceinline__ Quad operator|(const Quad& a, const Quad& b) {
  Quad r;
#pragma unroll
  for (int q = 0; q < QUAD; ++q) r.w[q] = a.w[q] | b.w[q];
  return r;
}

// The thread's words of one tile: loads from the rows of one [R, W]
// block (a shard or a bank), the store of the result.
template <bool VEC4>
struct Rows {
  const uint32_t* base;   // row 0 of the block
  long long W;
  int w;                  // the thread's first word
  int off[QUAD];          // its words' offsets in a row, clamped into it

  __device__ __forceinline__ Rows(const uint32_t* rows, long long W_,
                                  int w0)
      : base(rows), W(W_), w(w0 + (VEC4 ? QUAD : 1) * (int)threadIdx.x) {
#pragma unroll
    for (int q = 0; q < QUAD; ++q)
      off[q] = VEC4 ? (int)min((long long)w, W - QUAD) + q
                    : (int)min((long long)(w + BLOCK * q), W - 1);
  }

  __device__ __forceinline__ int word(int q) const {
    return VEC4 ? w + q : w + BLOCK * q;
  }

  __device__ __forceinline__ Quad load(int r) const {
    Quad v;
    const uint32_t* row = base + r * W;
    if constexpr (VEC4) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(row + off[0]));
      v.w[0] = x.x; v.w[1] = x.y; v.w[2] = x.z; v.w[3] = x.w;
    } else {
#pragma unroll
      for (int q = 0; q < QUAD; ++q) v.w[q] = __ldg(row + off[q]);
    }
    return v;
  }

  // Store the valid words of v at out (row 0 of the block's output);
  // words past W are zeroed in v, so a popcount of v counts the tile.
  __device__ __forceinline__ void store(uint32_t* out, Quad& v) const {
#pragma unroll
    for (int q = 0; q < QUAD; ++q)
      if (word(q) >= W) v.w[q] = 0;
    if constexpr (VEC4) {
      if (w < W)
        __stcs(reinterpret_cast<uint4*>(out + w),
               make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]));
    } else {
#pragma unroll
      for (int q = 0; q < QUAD; ++q)
        if (word(q) < W) __stcs(out + word(q), v.w[q]);
    }
  }
};

// Row indices of one merge side, read through the read-only cache and
// clamped to [0, R).
struct GlobalIdx {
  const int32_t* p;
  int R;
  __device__ __forceinline__ int operator()(int j) const {
    return min(max(__ldg(p + j), 0), R - 1);
  }
};

// Algorithm 1 over one side, lt(j) and le(j) for j < c, on the thread's
// words: the same result as merge() above.  The steps go in groups of
// GROUP: a group's 2 * GROUP row loads are all issued before its MAJ3s,
// so up to C = 5 every load of the side is in flight at once (C > 0
// fixes c at compile time and the groups unroll completely; C = 0 takes
// any c).  A row repeated inside the side (the constant rows of
// boundary substitutions) is requested again and served by the L2:
// DRAM reads each distinct row once.  Larger groups (fewer blocks fit
// an SM), and skipping repeated rows on predicates, each measured
// slower (PERF.md).
constexpr int GROUP = 4;

template <int C, bool VEC4, class Idx>
__device__ __forceinline__ Quad merge_side(const Idx& lt, const Idx& le,
                                           int c_any,
                                           const Rows<VEC4>& rows) {
  const int c = C ? C : c_any;
  Quad acc = rows.load(lt(0));
#pragma unroll
  for (int j1 = 1; j1 < c; j1 += GROUP) {
    Quad vl[GROUP], ve[GROUP];
#pragma unroll
    for (int g = 0; g < GROUP; ++g) {
      if (j1 + g < c) {
        vl[g] = rows.load(lt(j1 + g));
        ve[g] = rows.load(le(j1 + g));
      }
    }
#pragma unroll
    for (int g = 0; g < GROUP; ++g)
      if (j1 + g < c) acc = maj3(acc, vl[g], ve[g]);
  }
  return acc;
}

// Add n (each thread's count) to *cnt: a warp reduction, a block
// reduction, one 64-bit atomicAdd per block.  Every thread of a block of
// BLOCK threads calls it; it may be called again by the same block.
__device__ __forceinline__ void add_block_count(unsigned n,
                                                unsigned long long* cnt) {
  __shared__ unsigned warp_sum[BLOCK / 32];
  n = __reduce_add_sync(0xffffffffu, n);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();             // a previous call has read warp_sum
  if (lane == 0) warp_sum[warp] = n;
  __syncthreads();
  if (warp == 0) {
    unsigned v = lane < BLOCK / 32 ? warp_sum[lane] : 0u;
    v = __reduce_add_sync(0xffffffffu, v);
    if (lane == 0 && v) atomicAdd(cnt, (unsigned long long)v);
  }
}

// Launch f(std::integral_constant<int, C>) for the chunk counts whose
// fixed loop measured faster on the paths (C = 1, 5 and 8: 1-5 %,
// PERF.md), C = 0 (any c) for the rest.
template <class F>
int by_chunks(int c, F&& f) {
  switch (c) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 5: return f(std::integral_constant<int, 5>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return f(std::integral_constant<int, 0>{});
  }
}

// The persistent grid of a gather kernel: as many blocks as fit on every
// SM at once, at most one a tile.  *cap (the caller's, one per kernel,
// 0 at first) keeps that count, so the occupancy is asked once.
template <class K>
cudaError_t persistent_grid(K kernel, long long tiles, int* cap,
                            int* grid) {
  if (*cap == 0) {
    int dev = 0, sms = 0, occ = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel, BLOCK,
                                                        0);
    if (e != cudaSuccess) return e;
    if (occ < 1) return cudaErrorInvalidConfiguration;
    *cap = occ * sms;
  }
  *grid = (int)(tiles < *cap ? tiles : *cap);
  return cudaSuccess;
}

}  // namespace clutch
