// Clutch chunk merge (Algorithm 1) over packed LUT planes, for Hopper
// (sm_90a).
//
// Replaces two TPU kernels of src/repro/kernels/clutch_merge.py:
//   * clutch_merge (_kernel): one [R, W] LUT, one scalar's [C] indices;
//   * clutch_merge_banked (_banked_kernel): [B, R, W] LUTs, per-bank [B, C]
//     indices.
// Both run on merge_kernel below, the unbanked merge being B = 1.
//
// The TPU loaded an (R, BW) tile of the whole LUT into VMEM and gathered
// rows from it with dynamic sublane slices.  Here a persistent grid (as
// many blocks as fit on the SMs) walks (bank, word tile) by a 64-bit
// index, so any number of banks works.  A block reads its bank's 2C
// indices through the read-only cache (the same for every thread;
// clamped to [0, R)) and each thread gathers the rows it needs for its
// four words of the tile straight from device memory and folds them
// with MAJ3 in registers (clutch.cuh :: merge_side: row loads issued in
// groups of four steps before their MAJ3s, so up to C = 5 all 2C-1 are
// in flight at once; C a template for C in {1, 5, 8}; one 16-byte
// load a row where W % 4 == 0 and the LUT is 16-byte aligned, else four
// 4-byte loads): no row the scalar does not name is read, and a row
// the indices repeat (the constant rows of boundary substitutions; an
// always-true bank names one row C times) comes from DRAM once.
//
// Bound: the distinct rows the indices name, at most (2C-1) * B * W * 4
// bytes read, plus B * W * 4 written; a handful of logic operations per
// row word is far below the issue rate, so it is bound by bytes.

#include "clutch.cuh"

namespace {

using clutch::BLOCK;
using clutch::GlobalIdx;
using clutch::TILE;

template <int C, bool VEC4>
__global__ void __launch_bounds__(BLOCK)
merge_kernel(const uint32_t* __restrict__ lut,
             const int32_t* __restrict__ lt, const int32_t* __restrict__ le,
             int c, int B, int R, int W, uint32_t* __restrict__ out) {
  const int cc = C ? C : c;
  const long long tiles = ((long long)W + TILE - 1) / TILE;
  const long long n = tiles * B;
  for (long long t = blockIdx.x; t < n; t += gridDim.x) {
    const long long b = t / tiles;
    const clutch::Rows<VEC4> rows(lut + b * R * W, W,
                                  (int)(t - b * tiles) * TILE);
    clutch::Quad acc = clutch::merge_side<C, VEC4>(
        GlobalIdx{lt + b * cc, R}, GlobalIdx{le + b * cc, R}, cc, rows);
    rows.store(out + b * W, acc);
  }
}

template <int C, bool VEC4>
int merge_run(const void* lut, const void* lt, const void* le, int c, int B,
              int R, int W, void* out, cudaStream_t stream) {
  auto kernel = merge_kernel<C, VEC4>;
  static int cap = 0;
  int grid = 0;
  cudaError_t e = clutch::persistent_grid(
      kernel, ((long long)W + TILE - 1) / TILE * B, &cap, &grid);
  if (e != cudaSuccess) return (int)e;
  kernel<<<grid, BLOCK, 0, stream>>>(
      (const uint32_t*)lut, (const int32_t*)lt, (const int32_t*)le, c, B, R,
      W, (uint32_t*)out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// lut [B, R, W] words; lt, le [B, c] int32; vec4: 16-byte row loads
// (W % 4 == 0, lut 16-byte aligned); out [B, W] words.
int merge_launch(const void* lut, const void* lt, const void* le, int c,
                 int B, int R, int W, int vec4, void* out, void* stream) {
  if (B <= 0 || W <= 0) return (int)cudaSuccess;
  if (c < 1 || R < 1 ||
      (vec4 && (W % 4 != 0 || ((uintptr_t)lut & 15) != 0)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  return clutch::by_chunks(c, [&](auto kc) {
    constexpr int C = decltype(kc)::value;
    return vec4 ? merge_run<C, true>(lut, lt, le, c, B, R, W, out, s)
                : merge_run<C, false>(lut, lt, le, c, B, R, W, out, s);
  });
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
