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

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
