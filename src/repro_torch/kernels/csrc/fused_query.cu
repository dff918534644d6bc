// Fused Clutch predicates, range count and GBDT leaf bits, for Hopper
// (sm_90a).
//
// Replaces four TPU kernels of src/repro/kernels/fused_query.py:
//   * fused_predicate_banked (_predicate_kernel) and
//     fused_compound_banked (_compound_kernel): both run on
//     compound_kernel below, the predicate being the one-term case;
//   * fused_range_count (_kernel): range_count_kernel below;
//   * gbdt_leafbits_banked (_leafbits_kernel): leafbits_kernel below.
//
// Algorithm 1 merge of one side (clutch.cuh :: merge): acc = row(lt[0]);
// for j = 1..C-1: acc = maj3(acc, row(lt[j]), row(le[j])) -- 2C-1
// gathered rows; le[0] is never read.  A range is the gt-side merge on
// the normal planes AND the lt-side merge on the complement planes.
//
// compound_kernel: a persistent grid (as many blocks as fit on the SMs)
// walks (shard, word tile) by a 64-bit index; a block's thread owns four
// words of the tile (clutch.cuh :: Rows: one 16-byte load a row where
// W % 4 == 0 and the LUT is 16-byte aligned, else four 4-byte loads).
// Per range it folds both sides (clutch.cuh :: merge_side: row loads
// issued in groups of four steps before their MAJ3s, the chunk count C
// a template for C in {1, 5, 8}) and ANDs them; per term it joins
// the ranges with the term's AND or OR, and the term with the result
// through its connective (the result starts all ones, so the first
// term's AND is the term itself).  The term program has one int32 per
// term (its range count, its AND/OR, its connective) and any length: it
// rides in the launch's parameters (__grid_constant__) up to PROG_PARAM
// terms, beyond that it is read from device memory.  The row indices,
// any number of them, are read through the read-only cache (staging
// them in shared memory timed 2 % faster on a predicate and no faster on
// a compound: PERF.md).  Each thread counts its words'
// bits; a block adds its count to cnt[s] once per shard it visits (one
// 64-bit atomicAdd: an exact integer, so the order of the atomics does
// not matter).  The TPU carried the count along its sequential grid axis
// and sized blocks to 4 MiB of VMEM; neither carries over.
// Bound: the distinct rows the indices name, S * W * 4 bytes each, plus
// the bitmap written, S * W * 4; a handful of logic operations per row
// word is far below the issue rate, so it is bound by bytes.  At the
// table path's shapes it runs at about the speed of x.amax(dim=0) over
// the same rows laid out contiguously (PERF.md).
//
// range_count_kernel: one range over two separate [R, W] LUTs, the
// gt-side on `lut`, the lt-side on `lut_c`; otherwise compound_kernel's
// one-range case with one shard, and the same popcount reduction.
// Bound: 2 * (2C-1) * W * 4 bytes of rows read plus W * 4 written.
//
// leafbits_kernel: out[b, w] = OR_f merge(f) & mask[f, w].  The DRAM
// bound is the bitmap written (B * W * 4) plus the indices read
// (B * F * 2C * 4); at the GBDT path's shape (65,536 instances, LUT
// [264, 256], 28 features, one chunk) 82 MB, 0.0245 ms.  The work on
// chip is the LUT rows: F of them per output word.  Read from L2 for
// every instance (the previous design) that was 3.76 GB.  Here a block
// owns a slice of S = 64 words and stages lut[:, slice] in shared memory
// once (cp.async, every copy in flight); its warps then walk groups of
// LEAF_GROUP instances, each lane folding two words of every instance of
// the group.  A warp stages its group's row indices
// (clamped, as clutch::stage does) in shared memory, LEAF_SLOTS per
// instance at a time, instance-minor, so one 16-byte broadcast read
// gives four instances' rows; the next group's indices are already
// loading into registers while this one folds.  Features with no node in
// the slice are skipped (live-feature bits built once per block); a
// slice with none (padding words) writes zeros and stops.
// What bounds it then is on-chip: per instance, live feature and 32
// words, one row read from shared memory, a quarter of a 16-byte index
// read, two AND-ORs; the load/store unit and the issue slots, not DRAM
// (PERF.md has the measured split).
// Rows follow the LUT's height R: they are staged when R * 64 words and
// the index buffers fit a block's shared memory (R <= 777); a taller LUT
// (a plan with wide chunks) has its rows read from global memory by the
// same kernel.  The wrapper chooses by shape before the launch
// (fused_query.py :: leafbits_layout).
//
// Indices are clamped into [0, R) while staged or read, so no index can
// read outside the LUT; the Python wrappers reject out-of-range host indices
// before launch.
//
// leafsum_kernel (gbdt_leafbits_sum) replaces no TPU kernel: the reference
// sums an instance's leaves on the host (apps/gbdt.py :: assemble_leaves,
// NumPy's float32 .sum(-1)), and so did the port until the host's gather-sum
// and the copy of every leaf address held 72-88 % of a bulk predict call
// (PERF.md).  From leafbits_kernel's bitmap [B, W] it decodes tree t's
// address, sum_d bit(t * D + d) << (D - 1 - d), gathers leaves[t, addr] and
// sums the T values with NumPy's pairwise float32 sum, the same additions in
// the same tree, so the result is assemble_leaves' to the bit: the trees
// split at n / 2 rounded down to a multiple of 8 until a block holds at
// most 128; a block of 8 or more starts eight accumulators at its first
// eight values, adds every eighth value into each in order, combines them
// ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7)) and adds its tail of
// n % 8 in order; a block below 8 (T < 8 only) adds left to right from 0.
// NumPy takes a row longer than its buffer (8,192 values by default) a
// buffer at a time, adding each buffer's pairwise sum to the total from 0;
// here the buffers' sums are added left to right and the total to 0 at
// the end, which differs from that only in the sign of an intermediate
// zero, which the final 0 + erases.  No multiply is involved, so nothing
// can fuse.  The host turns T and the buffer into the program of blocks
// (each block's length and the joins after it, fused_query.py ::
// sum_program) and the launch carries it in its parameters.
// Bound: the bitmap read once (B * ceil(T * D / 32) * 4 bytes: 49 MB at
// 65,536 instances of 1000 trees of depth 6, 15 us) plus B floats written;
// the table (256 KB there) is read from L2.  A block owns up to
// SUM_MAX_PER instances and walks the program's leaf blocks once, staging
// each block's rows of the table in shared memory (128 trees of 64 leaves:
// 32 KB) so the table crosses L2 once a block; a group of eight lanes
// takes an instance, lane j its accumulator r_j, and the combine runs
// through __shfl_xor_sync in that order (float addition commutes, so every
// lane holds the same bits); the tail and the joins are the same on all
// eight lanes, and lane 0 keeps the instance's stack of pending block sums
// in shared memory.  Tables of more than 64 leaves a tree are read through
// L1 instead of staged (as leaf_gather's route does).

#include <algorithm>

#include "clutch.cuh"

namespace {

using clutch::BLOCK;
using clutch::GlobalIdx;
using clutch::Quad;
using clutch::QUAD;
using clutch::TILE;
using clutch::add_block_count;
using clutch::add_block_popcount;
using clutch::merge;
using clutch::merge_side;
using clutch::stage;

// Term program codes, one per term (fused_query.py :: compound_program):
// the term's range count << 2 | TERM_OR | CONN_OR
constexpr int TERM_OR = 1;       // the term ORs its ranges (else ANDs)
constexpr int CONN_OR = 2;       // the term joins the result by OR
constexpr int PROG_PARAM = 768;  // codes carried in the launch parameters

struct Program {
  int n_terms;
  const int32_t* dev;            // the codes in device memory, or null
  int32_t code[PROG_PARAM];      // the codes, when n_terms <= PROG_PARAM
};

template <int C, bool VEC4>
__global__ void __launch_bounds__(BLOCK)
compound_kernel(const uint32_t* __restrict__ lut,
                const int32_t* __restrict__ idx, int c, int S, int R, int W,
                const __grid_constant__ Program prog,
                uint32_t* __restrict__ bm,
                unsigned long long* __restrict__ cnt) {
  const int cc = C ? C : c;
  auto side = [&](const clutch::Rows<VEC4>& rows, int o) {
    return merge_side<C, VEC4>(GlobalIdx{idx + o, R},
                               GlobalIdx{idx + o + cc, R}, cc, rows);
  };
  const long long tiles = ((long long)W + TILE - 1) / TILE;
  const long long n = tiles * S;
  long long shard = -1;
  unsigned count = 0;          // this thread's bits of `shard`
  for (long long t = blockIdx.x; t < n; t += gridDim.x) {
    const long long s = t / tiles;
    if (s != shard) {          // uniform: the tile index is the block's
      if (shard >= 0) add_block_count(count, cnt + shard);
      shard = s;
      count = 0;
    }
    const clutch::Rows<VEC4> rows(lut + s * R * W, W,
                                  (int)(t - s * tiles) * TILE);
    Quad acc;
#pragma unroll
    for (int q = 0; q < QUAD; ++q) acc.w[q] = ~0u;
    int r0 = 0;                // the term's first range
    for (int k = 0; k < prog.n_terms; ++k) {
      const int code = prog.dev ? __ldg(prog.dev + k) : prog.code[k];
      const int nr = code >> 2;
      Quad tb{};
      for (int j = 0; j < nr; ++j) {
        const int o = (r0 + j) * 4 * cc;
        const Quad rng = side(rows, o) & side(rows, o + 2 * cc);
        tb = j == 0 ? rng : (code & TERM_OR) ? (tb | rng) : (tb & rng);
      }
      acc = (code & CONN_OR) ? (acc | tb) : (acc & tb);
      r0 += nr;
    }
    rows.store(bm + s * W, acc);
#pragma unroll
    for (int q = 0; q < QUAD; ++q) count += __popc(acc.w[q]);
  }
  if (shard >= 0) add_block_count(count, cnt + shard);
}

template <int C, bool VEC4>
int compound_run(const void* lut, const void* idx, int c, int S, int R,
                 int W, const Program& prog, void* bm, void* cnt,
                 cudaStream_t stream) {
  auto kernel = compound_kernel<C, VEC4>;
  static int cap = 0;
  int grid = 0;
  cudaError_t e = clutch::persistent_grid(
      kernel, ((long long)W + TILE - 1) / TILE * S, &cap, &grid);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, BLOCK, 0, stream>>>(
      (const uint32_t*)lut, (const int32_t*)idx, c, S, R, W, prog,
      (uint32_t*)bm, (unsigned long long*)cnt);
  return (int)cudaGetLastError();
}

__global__ void range_count_kernel(const uint32_t* __restrict__ lut,
                                   const uint32_t* __restrict__ lut_c,
                                   const int32_t* __restrict__ idx, int c,
                                   int R, int W, uint32_t* __restrict__ bm,
                                   unsigned long long* __restrict__ cnt) {
  extern __shared__ int s_idx[];
  stage(s_idx, idx, 4 * c, R);
  __syncthreads();
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t acc = 0;
  if (w < W) {
    acc = merge(lut + w, s_idx, c, W) & merge(lut_c + w, s_idx + 2 * c, c, W);
    bm[w] = acc;
  }
  add_block_popcount(acc, cnt);
}

constexpr int LEAF_WARPS = 8;    // warps per block
constexpr int LEAF_GROUP = 16;   // instances a warp folds at once
constexpr int LEAF_SLOTS = 64;   // index slots per instance staged at once
constexpr int LEAF_LOADS = LEAF_GROUP * LEAF_SLOTS / 32;  // a lane's share
constexpr int LEAF_LIVE = 192;   // words of live-feature bits: F <= 6144
constexpr int LEAF_WPL = 2;      // words per lane: a slice of 64 words

template <bool SMEM_ROWS>
__global__ void __launch_bounds__(LEAF_WARPS * 32, 2)
leafbits_kernel(const uint32_t* __restrict__ lut,
                const uint32_t* __restrict__ masks,
                const int32_t* __restrict__ idx, int c, int F, int B, int R,
                int W, int per_block, uint32_t* __restrict__ out) {
  constexpr int WPL = LEAF_WPL, S = 32 * WPL;
  extern __shared__ __align__(16) uint32_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int s0 = blockIdx.x * S;
  int w[WPL], gcol[WPL];           // this lane's words, clamped for loads
#pragma unroll
  for (int q = 0; q < WPL; ++q) {
    w[q] = s0 + lane + 32 * q;
    gcol[q] = min(w[q], W - 1);
  }
  uint32_t* live_s = smem + (SMEM_ROWS ? R * S : 0) +
                     LEAF_WARPS * LEAF_GROUP * LEAF_SLOTS;
  const int b_first = blockIdx.y * per_block;
  const int b_end = min(B, b_first + per_block);

  // Which features have a node in this slice (bit f of live_s).  A slice
  // with none (padding words) has an all-zero output and stops here.
  for (int i = threadIdx.x; i < LEAF_LIVE; i += blockDim.x) live_s[i] = 0;
  __syncthreads();
  bool any = false;
  for (int e = threadIdx.x; e < F * S; e += blockDim.x) {
    const int x = s0 + e % S, f = e / S;
    if (x < W && __ldg(masks + (long long)f * W + x)) {
      atomicOr(live_s + f / 32, 1u << (f % 32));
      any = true;
    }
  }
  if (!__syncthreads_or(any)) {
    for (long long e = threadIdx.x; e < (long long)(b_end - b_first) * S;
         e += blockDim.x) {
      const int x = s0 + (int)(e % S);
      if (x < W) __stcs(out + (b_first + e / S) * W + x, 0u);
    }
    return;
  }
  if constexpr (SMEM_ROWS) {   // every copy in flight at once
    if (W % 4 == 0 && ((uintptr_t)lut & 15) == 0) {   // 16 bytes a copy
      for (int e = threadIdx.x; e < R * S / 4; e += blockDim.x) {
        const int x = s0 + 4 * (e % (S / 4));
        const uint32_t* src =
            x < W ? lut + (long long)(e / (S / 4)) * W + x : lut;
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"((unsigned)__cvta_generic_to_shared(smem + 4 * e)),
                        "l"(src), "r"(x < W ? 16 : 0) : "memory");
      }
    } else {
      for (int e = threadIdx.x; e < R * S; e += blockDim.x) {
        const int x = s0 + e % S;
        const uint32_t* src = x < W ? lut + (long long)(e / S) * W + x : lut;
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"((unsigned)__cvta_generic_to_shared(smem + e)),
                        "l"(src), "r"(x < W ? 4 : 0) : "memory");
      }
    }
    asm volatile("cp.async.commit_group;\n"
                 "cp.async.wait_group 0;\n" ::: "memory");
  }
  __syncthreads();
  auto row = [&](int r, int q) -> uint32_t {
    if constexpr (SMEM_ROWS)
      return smem[r * S + lane + 32 * q];
    else
      return __ldg(lut + (long long)r * W + gcol[q]);
  };

  int* idx_s = reinterpret_cast<int*>(smem + (SMEM_ROWS ? R * S : 0)) +
               warp * LEAF_GROUP * LEAF_SLOTS;
  const int n = F * 2 * c;
  const int fc = max(1, LEAF_SLOTS / (2 * c));   // features per staging
  const int n_chunks = (F + fc - 1) / fc;
  const int b_lo = b_first + warp * LEAF_GROUP;
  constexpr int GSTEP = LEAF_WARPS * LEAF_GROUP;
  const int groups = b_lo < b_end ? (b_end - b_lo + GSTEP - 1) / GSTEP : 0;
  const int steps = groups * n_chunks;

  // The warp walks (group, feature chunk) steps.  The row indices of the
  // next step are loaded into registers (every load in flight at once)
  // while this step folds, so their latency hides behind the fold.
  int v[LEAF_LOADS];
  auto load = [&](int st) {
    const int g0 = b_lo + (st / n_chunks) * GSTEP;
    const int f0 = (st % n_chunks) * fc;
    const int total = LEAF_GROUP * min(fc, F - f0) * 2 * c;
#pragma unroll
    for (int u = 0; u < LEAF_LOADS; ++u) {
      const int e = lane + 32 * u;   // instance e % 16 of slot e / 16
      const int b = min(g0 + e % LEAF_GROUP, B - 1);
      v[u] = e < total ? __ldg(idx + (long long)b * n + f0 * 2 * c +
                               e / LEAF_GROUP)
                       : 0;
    }
  };
  if (steps > 0) load(0);

  uint32_t acc[LEAF_GROUP][WPL];
  for (int st = 0; st < steps; ++st) {
    const int g0 = b_lo + (st / n_chunks) * GSTEP;
    const int f0 = (st % n_chunks) * fc;
    const int nf = min(fc, F - f0);
    if (f0 == 0) {
#pragma unroll
      for (int i = 0; i < LEAF_GROUP; ++i)
#pragma unroll
        for (int q = 0; q < WPL; ++q) acc[i][q] = 0;
    }
    __syncwarp();   // the previous step's indices have been read
#pragma unroll
    for (int u = 0; u < LEAF_LOADS; ++u)
      idx_s[lane + 32 * u] = min(max(v[u], 0), R - 1);
    __syncwarp();
    if (st + 1 < steps) load(st + 1);

    // the chunk's live features, f0 .. f0 + nf - 1 (nf <= 32)
    const int lw = f0 / 32;
    uint32_t todo = __funnelshift_r(
        live_s[lw], lw + 1 < LEAF_LIVE ? live_s[lw + 1] : 0u, f0 % 32);
    if (nf < 32) todo &= (1u << nf) - 1;
    auto mask_of = [&](int f, uint32_t* m) {
#pragma unroll
      for (int q = 0; q < WPL; ++q)
        m[q] = w[q] < W ? __ldg(masks + (long long)(f0 + f) * W + gcol[q])
                        : 0u;
    };
    uint32_t m_next[WPL];   // masks of the next live feature, loaded ahead
    if (todo) mask_of(__ffs(todo) - 1, m_next);
    while (todo) {
      const int f = __ffs(todo) - 1;
      todo &= todo - 1;
      uint32_t m[WPL];
#pragma unroll
      for (int q = 0; q < WPL; ++q) m[q] = m_next[q];
      if (todo) mask_of(__ffs(todo) - 1, m_next);
      const int* fs = idx_s + f * 2 * c * LEAF_GROUP;
#pragma unroll
      for (int i4 = 0; i4 < LEAF_GROUP; i4 += 4) {
        uint32_t cmp[4][WPL];
        const int4 r = *reinterpret_cast<const int4*>(fs + i4);
        const int r0[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int q = 0; q < WPL; ++q) cmp[t][q] = row(r0[t], q);
        for (int j = 1; j < c; ++j) {
          const int4 a = *reinterpret_cast<const int4*>(
              fs + j * LEAF_GROUP + i4);
          const int4 d = *reinterpret_cast<const int4*>(
              fs + (c + j) * LEAF_GROUP + i4);
          const int lt[4] = {a.x, a.y, a.z, a.w};
          const int le[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int q = 0; q < WPL; ++q)
              cmp[t][q] = clutch::maj3(cmp[t][q], row(lt[t], q),
                                       row(le[t], q));
        }
#pragma unroll
        for (int t = 0; t < 4; ++t)
#pragma unroll
          for (int q = 0; q < WPL; ++q) acc[i4 + t][q] |= cmp[t][q] & m[q];
      }
    }
    if (f0 + nf == F) {
#pragma unroll
      for (int i = 0; i < LEAF_GROUP; ++i)
#pragma unroll
        for (int q = 0; q < WPL; ++q)
          if (g0 + i < b_end && w[q] < W)
            __stcs(out + (long long)(g0 + i) * W + w[q], acc[i][q]);
    }
  }
}

template <bool SMEM_ROWS>
int leafbits_run(const void* lut, const void* masks, const void* idx, int c,
                 int F, int B, int R, int W, void* out,
                 cudaStream_t stream) {
  auto kernel = leafbits_kernel<SMEM_ROWS>;
  const int smem = (SMEM_ROWS ? R * 32 * LEAF_WPL : 0) * 4 +
                   (LEAF_WARPS * LEAF_GROUP * LEAF_SLOTS + LEAF_LIVE) * 4;
  static int opted_in = 48 << 10, occ_smem = -1, occ = 0;
  cudaError_t e = cudaSuccess;
  if (smem > opted_in) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem;
  }
  if (smem != occ_smem) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, kernel, LEAF_WARPS * 32, smem);
    if (e != cudaSuccess) return (int)e;
    if (occ < 1) return (int)cudaErrorInvalidConfiguration;
    occ_smem = smem;
  }
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  // about four waves of blocks: enough to even out slices of unequal
  // work, few enough that staging the LUT slice stays a small part of a
  // block's time
  const int gx = (W + 32 * LEAF_WPL - 1) / (32 * LEAF_WPL);
  const long long target = 4LL * sms * occ;
  const long long gy0 = std::max(1LL, (target + gx - 1) / gx);
  long long per = (B + gy0 - 1) / gy0;
  per = (per + LEAF_GROUP - 1) / LEAF_GROUP * LEAF_GROUP;
  const dim3 grid(gx, (unsigned)((B + per - 1) / per));
  kernel<<<grid, LEAF_WARPS * 32, smem, stream>>>(
      (const uint32_t*)lut, (const uint32_t*)masks, (const int32_t*)idx, c,
      F, B, R, W, (int)per, (uint32_t*)out);
  return (int)cudaGetLastError();
}

constexpr int SUM_THREADS = 256;                 // 32 groups of 8 lanes
constexpr int SUM_GROUPS = SUM_THREADS / 8;
constexpr int SUM_BLOCK = 128;                   // NumPy's PW_BLOCKSIZE
constexpr int SUM_STAGED_L = 64;                 // most leaves staged a tree
constexpr int SUM_MAX_PER = 256;                 // most instances a block
constexpr int SUM_PROG = 1024;                   // leaf blocks a program
constexpr int SUM_STACK = 16;                    // pending block sums

// The order of the sum, in evaluation order: per leaf block its length |
// the joins that follow it << 8 (each join adds the top two sums of the
// stack, the deeper one first).
struct SumProgram {
  int n_blocks, stack, max_len;
  int16_t code[SUM_PROG];
};

template <bool STAGED>
__global__ void __launch_bounds__(SUM_THREADS)
leafsum_kernel(const uint32_t* __restrict__ bm,
               const float* __restrict__ leaves, int B, int W, int D, int L,
               int per, const __grid_constant__ SumProgram prog,
               float* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  float* stk = sm + (STAGED ? prog.max_len * L : 0);   // [stack][per]
  const int j = threadIdx.x & 7, g = threadIdx.x >> 3;
  const int b_first = blockIdx.x * per;
  const int n_here = min(per, B - b_first);
  const int rounds = (n_here + SUM_GROUPS - 1) / SUM_GROUPS;
  const uint32_t dmask = (1u << D) - 1;
  const bool vec = (L & 3) == 0 && ((uintptr_t)leaves & 15) == 0;
  int t0 = 0, sp = 0;
  for (int k = 0; k < prog.n_blocks; ++k) {
    const int n = prog.code[k] & 0xff, joins = prog.code[k] >> 8;
    const float* lv = leaves + (long long)t0 * L;
    if constexpr (STAGED) {
      __syncthreads();   // the previous leaf block has been read
      if (vec) {
        for (int e = threadIdx.x; e < n * L / 4; e += SUM_THREADS)
          reinterpret_cast<float4*>(sm)[e] =
              __ldg(reinterpret_cast<const float4*>(lv) + e);
      } else {
        for (int e = threadIdx.x; e < n * L; e += SUM_THREADS)
          sm[e] = __ldg(lv + e);
      }
      __syncthreads();
      lv = sm;
    }
    for (int r = 0; r < rounds; ++r) {
      const int i_loc = r * SUM_GROUPS + g;   // < per: per % 32 == 0
      const uint32_t* row =
          bm + (long long)(b_first + min(i_loc, n_here - 1)) * W;
      auto leaf = [&](int i) -> float {       // tree t0 + i
        const long long bit = (long long)(t0 + i) * D;
        const int w = (int)(bit >> 5), sh = (int)(bit & 31);
        const uint32_t lo = __ldg(row + w);
        const uint32_t hi = sh + D > 32 ? __ldg(row + w + 1) : 0u;
        const int a = (int)(__brev(__funnelshift_r(lo, hi, sh) & dmask) >>
                            (32 - D));
        return STAGED ? lv[i * L + a] : __ldg(lv + (long long)i * L + a);
      };
      float s;
      if (n < 8) {
        s = 0.0f;
        for (int i = 0; i < n; ++i) s += leaf(i);
      } else {
        const int m = n - n % 8;
        s = leaf(j);
        for (int i = 8; i < m; i += 8) s += leaf(i + j);
        s += __shfl_xor_sync(0xffffffffu, s, 1);
        s += __shfl_xor_sync(0xffffffffu, s, 2);
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        for (int i = m; i < n; ++i) s += leaf(i);
      }
      if (j == 0) {
        float* st = stk + i_loc;
        for (int q = 1; q <= joins; ++q) s = st[(sp - q) * per] + s;
        st[(sp - joins) * per] = s;
      }
    }
    sp += 1 - joins;
    t0 += n;
  }
  for (int r = 0; r < rounds; ++r) {
    const int i_loc = r * SUM_GROUPS + g;
    if (j == 0 && i_loc < n_here) out[b_first + i_loc] = 0.0f + stk[i_loc];
  }
}

template <bool STAGED>
int leafsum_run(const void* bm, const void* leaves, int B, int W, int D,
                int L, const SumProgram& prog, void* out,
                cudaStream_t stream) {
  auto kernel = leafsum_kernel<STAGED>;
  auto smem_of = [&](int per) {
    return (STAGED ? prog.max_len * L : 0) * 4 + prog.stack * per * 4;
  };
  static int opted_in = 48 << 10, occ_smem = -1, occ = 0, sms = 0;
  const int smem_max = smem_of(SUM_MAX_PER);
  cudaError_t e = cudaSuccess;
  if (smem_max > opted_in) {
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_max);
    if (e != cudaSuccess) return (int)e;
    opted_in = smem_max;
  }
  if (smem_max != occ_smem) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, kernel,
                                                      SUM_THREADS, smem_max);
    if (e != cudaSuccess) return (int)e;
    if (occ < 1) return (int)cudaErrorInvalidConfiguration;
    occ_smem = smem_max;
  }
  if (sms == 0) {
    int dev = 0;
    e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  // one wave of blocks, each staging the table once: the instances are
  // spread over every block slot, 32 at a time
  const long long slots = (long long)sms * occ;
  long long per = (B + slots - 1) / slots;
  per = std::min<long long>(SUM_MAX_PER, (per + SUM_GROUPS - 1) /
                                             SUM_GROUPS * SUM_GROUPS);
  kernel<<<(unsigned)((B + per - 1) / per), SUM_THREADS, smem_of((int)per),
           stream>>>((const uint32_t*)bm, (const float*)leaves, B, W, D, L,
                     (int)per, prog, (float*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// lut [S, R, W] words; idx [n_idx] int32, per range (gt_lt, gt_le, lt_lt,
// lt_le) of c entries each, the ranges in term order; codes [n_terms]
// int32 on the host, the term program (copied into the launch when
// n_terms <= PROG_PARAM), and codes_dev the same codes in device memory
// (read when it is longer); vec4: 16-byte row loads (W % 4 == 0, lut
// 16-byte aligned); bm [S, W] words out; cnt [S] uint64, zeroed by the
// caller, accumulated here.
int compound_launch(const void* lut, const void* idx, int n_idx, int c,
                    int S, int R, int W, int n_terms, const void* codes,
                    const void* codes_dev, int vec4, void* bm, void* cnt,
                    void* stream) {
  if (S <= 0 || W <= 0) return (int)cudaSuccess;
  long long n_ranges = 0;
  for (int k = 0; k < n_terms; ++k) {
    const int nr = ((const int32_t*)codes)[k] >> 2;
    if (nr < 1) return (int)cudaErrorInvalidValue;
    n_ranges += nr;
  }
  if (c < 1 || R < 1 || n_terms < 1 || n_idx != n_ranges * 4 * c ||
      (n_terms > PROG_PARAM && codes_dev == nullptr) ||
      (vec4 && (W % 4 != 0 || ((uintptr_t)lut & 15) != 0)))
    return (int)cudaErrorInvalidValue;
  Program prog;
  prog.n_terms = n_terms;
  prog.dev = nullptr;
  if (n_terms <= PROG_PARAM)
    for (int k = 0; k < n_terms; ++k)
      prog.code[k] = ((const int32_t*)codes)[k];
  else
    prog.dev = (const int32_t*)codes_dev;
  cudaStream_t s = (cudaStream_t)stream;
  return clutch::by_chunks(c, [&](auto kc) {
    constexpr int C = decltype(kc)::value;
    return vec4 ? compound_run<C, true>(lut, idx, c, S, R, W, prog, bm,
                                        cnt, s)
                : compound_run<C, false>(lut, idx, c, S, R, W, prog, bm,
                                         cnt, s);
  });
}

// lut, lut_c [R, W] words; idx [4c] int32 (gt_lt, gt_le, lt_lt, lt_le);
// bm [W] words out; cnt [1] uint64, zeroed by the caller.
int range_count_launch(const void* lut, const void* lut_c, const void* idx,
                       int c, int R, int W, void* bm, void* cnt,
                       void* stream) {
  if (W <= 0) return (int)cudaSuccess;
  range_count_kernel<<<(W + BLOCK - 1) / BLOCK, BLOCK, 4 * c * sizeof(int),
                       (cudaStream_t)stream>>>(
      (const uint32_t*)lut, (const uint32_t*)lut_c, (const int32_t*)idx, c,
      R, W, (uint32_t*)bm, (unsigned long long*)cnt);
  return (int)cudaGetLastError();
}

// lut [R, W], masks [F_pad, W] words; idx [B, F * 2c] int32; out [B, W].
// smem_rows: stage the LUT's rows in shared memory, else read them from
// global memory.
int leafbits_launch(const void* lut, const void* masks, const void* idx,
                    int c, int F, int B, int R, int W, int smem_rows,
                    void* out, void* stream) {
  if (B == 0 || W == 0) return (int)cudaSuccess;
  if (c < 1 || 2 * c > LEAF_SLOTS || F < 1 || F > 32 * LEAF_LIVE)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return smem_rows
             ? leafbits_run<true>(lut, masks, idx, c, F, B, R, W, out, s)
             : leafbits_run<false>(lut, masks, idx, c, F, B, R, W, out, s);
}

// bm [B, W] words (node t * D + d at word / bit (t * D + d) / 32, % 32),
// leaves [T, L] float32; codes [n_blocks] int16 on the host, the program
// (fused_query.py :: sum_program): per leaf block its length | the joins
// after it << 8; out [B] float32.
int leafsum_launch(const void* bm, const void* leaves, int B, int W, int T,
                   int D, int L, int n_blocks, const void* codes, void* out,
                   void* stream) {
  if (B == 0) return (int)cudaSuccess;
  if (T < 0 || D < 1 || D > 30 || L < (1 << D) ||
      (long long)T * D > 32LL * W || n_blocks < 1 || n_blocks > SUM_PROG)
    return (int)cudaErrorInvalidValue;
  SumProgram prog;
  prog.n_blocks = n_blocks;
  prog.stack = prog.max_len = 0;
  long long trees = 0;
  int sp = 0;
  for (int k = 0; k < n_blocks; ++k) {   // a program the kernel can run
    const int code = ((const int16_t*)codes)[k];
    const int n = code & 0xff, joins = code >> 8;
    if (code < 0 || n > SUM_BLOCK || joins > sp)
      return (int)cudaErrorInvalidValue;
    prog.code[k] = (int16_t)code;
    prog.max_len = std::max(prog.max_len, n);
    prog.stack = std::max(prog.stack, ++sp);
    sp -= joins;
    trees += n;
  }
  if (sp != 1 || trees != T || prog.stack > SUM_STACK)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return L <= SUM_STAGED_L
             ? leafsum_run<true>(bm, leaves, B, W, D, L, prog, out, s)
             : leafsum_run<false>(bm, leaves, B, W, D, L, prog, out, s);
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
