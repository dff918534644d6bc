// GBDT leaf aggregation, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/leaf_gather.py:41 ::
// leaf_gather (_kernel): pred[b] = sum_t leaves[t, addr[b, t]], where an
// address outside [0, L) -- the -1 padding, or one no leaf matches --
// adds nothing, as it matched no column of the TPU's one-hot.
//
// Lane-wise gathers are slow on a TPU, so it expanded each address into a
// one-hot row and contracted it with the leaf table on the MXU, 2^depth
// multiplies per term.  Hopper gathers directly.
//
// Bound on this card: bytes.  The address matrix is read once from device
// memory, B * T * 4 bytes (262 MB at [65536, 1000]: 78 us at 3.35 TB/s),
// plus the leaf table and the B outputs; the T adds per instance are far
// below the float32 rate.  To stream the addresses at that rate an SM
// needs tens of KB of loads in flight, and the gathers must not spread
// over many cache lines.  The design:
//
//   * One lane per instance.  A block of ROWS lanes owns ROWS instances
//     and walks the trees in tiles of TT: the tile's addresses
//     [ROWS x TT] (32 KB, one 128-byte segment of each row) go into a
//     ring of STAGES buffers in shared memory with cp.async, the next
//     tile in flight while the block sums the current one.
//   * The tiles are swizzled as TMA's 128-byte swizzle does (16-byte
//     chunk c of 128-byte line l at c ^ (l mod 8)), so the one 16-byte
//     read per lane of 4 trees of its instance, across 32 rows, hits
//     every bank once per 8 lanes.
//   * A gather instruction serves one tree for all 32 lanes, so it reads
//     at most L * 4 bytes: with L <= MAX_STAGED_L the tile's leaf rows
//     [TT x L] are staged beside its addresses (at most 2 distinct words
//     per bank); a larger L reads the table (in L2) through L1.
//   * Rows 16-byte aligned (T % 4 == 0 and an aligned base) are copied 16
//     bytes a lane; other rows 4 bytes a lane, into the same layout.
//   * Each lane keeps 8 partial sums, one per tree t mod 8, and adds them
//     in a fixed tree at the end: no float atomics, and the order depends
//     only on T, so two launches, and the routes, give bit-equal results.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int ROWS = WARPS * 32;        // instances per block, one lane each
constexpr int TT = 32;                  // trees per tile
constexpr int STAGES = 2;
constexpr int MAX_STAGED_L = 64;
constexpr int ADDR_WORDS = ROWS * TT;           // one tile's addresses
constexpr int LEAF_WORDS = TT * MAX_STAGED_L;   // one tile's leaf rows

template <bool STAGED>
constexpr int smem_bytes() {
  return STAGES * (ADDR_WORDS + (STAGED ? LEAF_WORDS : 0)) * 4;
}

// word o = r * TT + e of a tile, swizzled: the 16-byte chunk within its
// 128-byte line is XORed with the line's index mod 8
__device__ __forceinline__ int swz(int o) {
  return o ^ (((o >> 5) & 7) << 2);
}

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src, bool ok) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(ok ? 4 : 0) : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Issue tile k's copies into stage buffers abuf / lbuf (one group).
// Rows past B and trees past T are zero-filled; they are never summed.
template <bool VEC, bool STAGED>
__device__ __forceinline__ void issue(int* abuf, float* lbuf,
                                      const int32_t* __restrict__ addrs,
                                      const float* __restrict__ leaves,
                                      long long b0, int B, int T, int L,
                                      int k) {
  const int t0 = k * TT;
  const int nt = min(TT, T - t0);
  if (VEC) {
#pragma unroll
    for (int m = 0; m < ADDR_WORDS / 4 / ROWS; ++m) {
      const int q = threadIdx.x + ROWS * m;   // 16-byte chunk of the tile
      const int r = q / (TT / 4), e = (q % (TT / 4)) * 4;
      const bool ok = b0 + r < B && e < nt;
      const int32_t* src = ok ? addrs + (b0 + r) * T + t0 + e : addrs;
      cp16(abuf + swz(r * TT + e), src, ok);
    }
  } else {
#pragma unroll 8
    for (int m = 0; m < ADDR_WORDS / ROWS; ++m) {
      const int q = threadIdx.x + ROWS * m;   // word of the tile
      const int r = q / TT, e = q % TT;
      const bool ok = b0 + r < B && e < nt;
      const int32_t* src = ok ? addrs + (b0 + r) * T + t0 + e : addrs;
      cp4(abuf + swz(r * TT + e), src, ok);
    }
  }
  if (STAGED) {
    const float* src = leaves + (long long)t0 * L;
    for (int i = threadIdx.x; i < nt * L; i += ROWS)
      cp4(lbuf + i, src + i, true);
  }
  commit();
}

template <bool STAGED>
__device__ __forceinline__ void add(float& sum, const float* lv, int tt,
                                    int a, int L) {
  if ((unsigned)a < (unsigned)L)
    sum += STAGED ? lv[tt * L + a] : __ldg(lv + tt * L + a);
}

template <bool VEC, bool STAGED>
__global__ void __launch_bounds__(ROWS)
leaf_gather_kernel(const int32_t* __restrict__ addrs,
                   const float* __restrict__ leaves, int B, int T, int L,
                   float* __restrict__ out) {
  extern __shared__ __align__(16) int smem[];
  const long long b0 = (long long)blockIdx.x * ROWS;
  const int r = threadIdx.x;
  const int tiles = (T + TT - 1) / TT;
  auto abuf = [&](int s) { return smem + s * ADDR_WORDS; };
  auto lbuf = [&](int s) {
    return reinterpret_cast<float*>(smem + STAGES * ADDR_WORDS) +
           s * LEAF_WORDS;
  };

  float sum[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) sum[i] = 0.0f;

#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < tiles)
      issue<VEC, STAGED>(abuf(k), lbuf(k), addrs, leaves, b0, B, T, L, k);
    else
      commit();
  }
  for (int k = 0; k < tiles; ++k) {
    // tile k + STAGES - 1 goes into the buffer tile k - 1 used, which
    // every thread left at the barrier ending the previous trip
    const int kn = k + STAGES - 1;
    if (kn < tiles)
      issue<VEC, STAGED>(abuf(kn % STAGES), lbuf(kn % STAGES), addrs, leaves,
                         b0, B, T, L, kn);
    else
      commit();
    asm volatile("cp.async.wait_group %0;\n" :: "n"(STAGES - 1) : "memory");
    __syncthreads();

    const int* row = abuf(k % STAGES);
    const float* lv = STAGED ? lbuf(k % STAGES) : leaves + (long long)k * TT * L;
    const int nt = min(TT, T - k * TT);
    if (nt == TT) {
#pragma unroll
      for (int c = 0; c < TT / 4; ++c) {
        const int4 a = *reinterpret_cast<const int4*>(row + swz(r * TT + 4 * c));
        const int h = 4 * (c & 1);       // tree 4c + i is tree h + i mod 8
        add<STAGED>(sum[h + 0], lv, 4 * c + 0, a.x, L);
        add<STAGED>(sum[h + 1], lv, 4 * c + 1, a.y, L);
        add<STAGED>(sum[h + 2], lv, 4 * c + 2, a.z, L);
        add<STAGED>(sum[h + 3], lv, 4 * c + 3, a.w, L);
      }
    } else {                             // the last tile of ragged T
#pragma unroll
      for (int c = 0; c < TT / 4; ++c) {  // unrolled: sum[] stays in
        const int e = 4 * c;              // registers
        if (e < nt) {
          const int4 a = *reinterpret_cast<const int4*>(row + swz(r * TT + e));
          const int h = 4 * (c & 1);
          add<STAGED>(sum[h + 0], lv, e + 0, a.x, L);
          if (e + 1 < nt) add<STAGED>(sum[h + 1], lv, e + 1, a.y, L);
          if (e + 2 < nt) add<STAGED>(sum[h + 2], lv, e + 2, a.z, L);
          if (e + 3 < nt) add<STAGED>(sum[h + 3], lv, e + 3, a.w, L);
        }
      }
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  if (b0 + r < B)
    out[b0 + r] = ((sum[0] + sum[1]) + (sum[2] + sum[3])) +
                  ((sum[4] + sum[5]) + (sum[6] + sum[7]));
}

template <bool VEC, bool STAGED>
int launch(const void* addrs, const void* leaves, int B, int T, int L,
           void* out, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<STAGED>();
  static bool ready = false;   // per instantiation: above 48 KB, opt in
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        leaf_gather_kernel<VEC, STAGED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const int blocks = (int)(((long long)B + ROWS - 1) / ROWS);
  leaf_gather_kernel<VEC, STAGED><<<blocks, ROWS, bytes, stream>>>(
      (const int32_t*)addrs, (const float*)leaves, B, T, L, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// addrs [B, T] int32 (16-byte aligned rows if vec); leaves [T, L]
// float32; out [B] float32.  staged needs L <= 64 (the wrapper's route,
// leaf_gather.route).  Launches on `stream`; allocates nothing.
int leaf_gather_launch(const void* addrs, const void* leaves, int B, int T,
                       int L, int vec, int staged, void* out, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (staged && L > MAX_STAGED_L) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (vec)
    return staged ? launch<true, true>(addrs, leaves, B, T, L, out, s)
                  : launch<true, false>(addrs, leaves, B, T, L, out, s);
  return staged ? launch<false, true>(addrs, leaves, B, T, L, out, s)
                : launch<false, false>(addrs, leaves, B, T, L, out, s);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
