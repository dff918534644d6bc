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
// compound_kernel: one thread per (shard, word).  The block stages the
// row indices in shared memory; each thread gathers its rows (coalesced
// along w), folds MAJ3, the terms' AND/OR and the connectives in
// registers, writes its bitmap word and adds __popc to the shard count:
// warp reduction, block reduction, one atomicAdd per block into cnt[s]
// (an exact integer, so the order of the atomics does not matter).  The
// TPU carried the count along its sequential grid axis and sized blocks
// to 4 MiB of VMEM; neither carries over.
// Bound: the gathered rows, nr * 2 * (2C-1) * S * W * 4 bytes (distinct
// rows only), plus the bitmap written, S * W * 4.
//
// range_count_kernel: one range over two separate [R, W] LUTs, the
// gt-side on `lut`, the lt-side on `lut_c`; otherwise compound_kernel's
// one-range case with one shard, and the same popcount reduction.
// Bound: 2 * (2C-1) * W * 4 bytes of rows read plus W * 4 written.
//
// leafbits_kernel: grid (instance, word block), one thread per word; the
// block stages the instance's F * 2C indices in shared memory and the
// thread loops over features: acc |= merge(f) & mask[f].  The LUT and
// the masks are shared by every instance and stay in L2; the DRAM bound
// is the bitmap written (B * W * 4) plus the indices read (B * F * 2C * 4).
//
// Indices are clamped into [0, R) while staged, so no index can read
// outside the LUT; the Python wrappers reject out-of-range host indices
// before launch.

#include "clutch.cuh"

namespace {

using clutch::BLOCK;
using clutch::add_block_popcount;
using clutch::merge;
using clutch::stage;

constexpr int MAX_TERMS = 32;

struct Terms {
  int n_terms;
  int ranges[MAX_TERMS];  // ranges per term
  uint32_t term_disj;     // bit t: term t ORs its ranges (else ANDs)
  uint32_t conn_disj;     // bit t: connective after term t is OR
};

__global__ void compound_kernel(const uint32_t* __restrict__ lut,
                                const int32_t* __restrict__ idx, int n_idx,
                                int c, int R, int W, Terms terms,
                                uint32_t* __restrict__ bm,
                                unsigned long long* __restrict__ cnt) {
  extern __shared__ int s_idx[];
  stage(s_idx, idx, n_idx, R);
  __syncthreads();
  const int s = blockIdx.y;
  const long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  uint32_t acc = 0;
  if (w < W) {
    const uint32_t* col = lut + (long long)s * R * W + w;
    int off = 0;
    for (int t = 0; t < terms.n_terms; ++t) {
      const bool disj = (terms.term_disj >> t) & 1u;
      uint32_t tb = 0;
      for (int k = 0; k < terms.ranges[t]; ++k) {
        const uint32_t rng = merge(col, s_idx + off, c, W) &
                             merge(col, s_idx + off + 2 * c, c, W);
        off += 4 * c;
        tb = (k == 0) ? rng : (disj ? (tb | rng) : (tb & rng));
      }
      if (t == 0)
        acc = tb;
      else
        acc = ((terms.conn_disj >> (t - 1)) & 1u) ? (acc | tb) : (acc & tb);
    }
    bm[(long long)s * W + w] = acc;
  }
  add_block_popcount(acc, cnt + s);
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

__global__ void leafbits_kernel(const uint32_t* __restrict__ lut,
                                const uint32_t* __restrict__ masks,
                                const int32_t* __restrict__ idx, int c, int F,
                                int R, int W, uint32_t* __restrict__ out) {
  extern __shared__ int s_idx[];
  const long long b = blockIdx.x;
  const int n = F * 2 * c;
  stage(s_idx, idx + b * n, n, R);
  __syncthreads();
  const long long w = (long long)blockIdx.y * blockDim.x + threadIdx.x;
  if (w >= W) return;
  uint32_t acc = 0;
  for (int f = 0; f < F; ++f)
    acc |= merge(lut + w, s_idx + f * 2 * c, c, W) &
           __ldg(masks + (long long)f * W + w);
  out[b * W + w] = acc;
}

}  // namespace

extern "C" {

// lut [S, R, W] words; idx [n_idx] int32, per range (gt_lt, gt_le, lt_lt,
// lt_le) of c entries each; term_ranges [n_terms] host ints; bm [S, W]
// words out; cnt [S] uint64, zeroed by the caller, accumulated here.
int compound_launch(const void* lut, const void* idx, int n_idx, int c,
                    int S, int R, int W, int n_terms, const void* term_ranges,
                    unsigned term_disj, unsigned conn_disj, void* bm,
                    void* cnt, void* stream) {
  if (n_terms < 1 || n_terms > MAX_TERMS) return (int)cudaErrorInvalidValue;
  Terms terms{};
  terms.n_terms = n_terms;
  for (int t = 0; t < n_terms; ++t)
    terms.ranges[t] = ((const int*)term_ranges)[t];
  terms.term_disj = term_disj;
  terms.conn_disj = conn_disj;
  dim3 grid((W + BLOCK - 1) / BLOCK, S);
  compound_kernel<<<grid, BLOCK, n_idx * sizeof(int),
                    (cudaStream_t)stream>>>(
      (const uint32_t*)lut, (const int32_t*)idx, n_idx, c, R, W, terms,
      (uint32_t*)bm, (unsigned long long*)cnt);
  return (int)cudaGetLastError();
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
int leafbits_launch(const void* lut, const void* masks, const void* idx,
                    int c, int F, int B, int R, int W, void* out,
                    void* stream) {
  if (B == 0) return (int)cudaSuccess;
  const int threads = W < BLOCK ? ((W + 31) / 32) * 32 : BLOCK;
  dim3 grid(B, (W + threads - 1) / threads);
  leafbits_kernel<<<grid, threads, F * 2 * c * sizeof(int),
                    (cudaStream_t)stream>>>(
      (const uint32_t*)lut, (const uint32_t*)masks, (const int32_t*)idx, c,
      F, R, W, (uint32_t*)out);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
