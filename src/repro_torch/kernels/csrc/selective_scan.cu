// Mamba-1's selective scan, fused, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference package scans with lax.scan in XLA
// (src/repro/models/ssm.py :: mamba_block), and the port's plain version
// (kernels/ref.py :: selective_scan_ref) loops over time in Python over
// [B, S, din, N] float32 tensors of exp(delta A) and delta x B.  This kernel
// computes, for each sequence b and channel d, in one pass over time:
//
//   delta_t = softplus(dt_t + dt_bias)
//   h_t     = exp(delta_t A) h_{t-1} + delta_t x_t B_t,   A = -exp(A_log)  [N]
//   y_t     = (h_t . C_t + D x_t) silu(z_t)
//
// and writes y (in the activations' dtype) and the final h (float32).
// Nothing of size [B, S, din, N] exists: h lives in registers.
//
// Bound on this card.  Bytes, at the least: x, dt and z read once and y
// written once (2 bytes each in bf16), B and C once a token, the state read
// (when given) and written once in float32: at a 4,999-token prefill of din
// 8,192, 328 MB, 98 us; at a decode step of 128 rows, 134 MB, 40 us.  The
// recurrence is sequential in t, so a batch-1 prefill has only din * N =
// 131,072 (channel, state) pairs to spread over the card, each paying an
// exp on the special-function units every step (16 an SM a clock): a long
// prefill runs nearer that rate than its bytes.
//
// Design:
//   * Four threads a channel, N / 4 = 4 states each in registers.  A block
//     is 64 channels of one sequence (256 threads); the grid is (din / 64,
//     B): 128 blocks for a batch-1 prefill at din 8,192 (two warps a
//     scheduler), 16,384 for a decode step of 128 rows.
//   * Time in chunks of CHUNK steps (16; 1 for sequences shorter than
//     that, a decode step): the block stages a chunk in shared memory, in
//     coalesced rows of 64 channels, and there computes in parallel all of
//     a step's work that does not depend on h: delta = softplus(dt +
//     dt_bias), delta x, D x and silu(z).  The sequential part of a step is
//     then four exp2s and eight FMAs a thread, each thread's part of
//     h . C stored to shared memory; steps after a sequence's last pass h
//     through (delta = 0).  The chunk's y is then summed from the four
//     parts, gated and written in coalesced rows.  The next chunk's loads
//     go out into registers before a chunk is scanned, so their latency
//     hides behind the scan.
//   * exp(delta A) as exp2(delta * A log2(e)), A log2(e) computed once;
//     softplus as torch's (above 20 the input passes through, else
//     log1p(exp(x))).
//   * Input rows are (b * S + t) * ld: each input's row stride ld (in
//     elements) lets x, dt, z, B and C be column slices of wider tensors.
//     A_log, D and the dt bias are read in their own dtype (float32 or
//     bfloat16), so a model with bf16 parameters needs no cast a call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int N_STATE = 16;            // Mamba-1's d_state
constexpr int SPLIT = 4;               // threads a channel
constexpr int PER = N_STATE / SPLIT;   // states a thread
constexpr int CH = 64;                 // channels a block
constexpr int THREADS = SPLIT * CH;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float load_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float softplus(float v) {
  return v > 20.f ? v : log1pf(expf(v));
}

// A chunk's inputs in flight in registers: thread tid holds elements
// r * THREADS + tid of the chunk's [CHUNK, CH] x, dt and z and of its
// [CHUNK, N_STATE] B and C.
template <int CHUNK>
struct Staged {
  static constexpr int ROWS = (CHUNK * CH + THREADS - 1) / THREADS;
  static constexpr int BC = (CHUNK * N_STATE + THREADS - 1) / THREADS;
  float x[ROWS], dt[ROWS], z[ROWS], b[BC], c[BC];
};

template <typename T, int CHUNK>
__device__ __forceinline__ void fetch(
    Staged<CHUNK>& st, const T* __restrict__ x, const T* __restrict__ dt,
    const T* __restrict__ z, const T* __restrict__ bm,
    const T* __restrict__ cm, long long ld_x, long long ld_dt,
    long long ld_z, long long ld_b, long long ld_c, long long row0, int t0,
    int seqlen, int c0, int nch) {
#pragma unroll
  for (int r = 0; r < Staged<CHUNK>::ROWS; ++r) {
    const int e = r * THREADS + threadIdx.x;
    const int tt = e / CH, cc = e - tt * CH;
    const bool ok = e < CHUNK * CH && t0 + tt < seqlen && cc < nch;
    const long long row = row0 + t0 + tt;
    st.x[r] = ok ? load_f(x + row * ld_x + c0 + cc) : 0.f;
    st.dt[r] = ok ? load_f(dt + row * ld_dt + c0 + cc) : 0.f;
    st.z[r] = ok ? load_f(z + row * ld_z + c0 + cc) : 0.f;
  }
#pragma unroll
  for (int r = 0; r < Staged<CHUNK>::BC; ++r) {
    const int e = r * THREADS + threadIdx.x;
    const int tt = e / N_STATE, n = e - tt * N_STATE;
    const bool ok = e < CHUNK * N_STATE && t0 + tt < seqlen;
    const long long row = row0 + t0 + tt;
    st.b[r] = ok ? load_f(bm + row * ld_b + n) : 0.f;
    st.c[r] = ok ? load_f(cm + row * ld_c + n) : 0.f;
  }
}

template <typename T, typename P, int CHUNK>
__global__ void __launch_bounds__(THREADS)
selective_scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                      const T* __restrict__ z, const T* __restrict__ bm,
                      const T* __restrict__ cm, long long ld_x,
                      long long ld_dt, long long ld_z, long long ld_b,
                      long long ld_c, const P* __restrict__ a_log,
                      const P* __restrict__ dvec,
                      const P* __restrict__ dt_bias,
                      const float* __restrict__ state_in,
                      T* __restrict__ y, float* __restrict__ state_out,
                      int seqlen, int din) {
  // a step's work that does not depend on h, for the chunk's steps
  __shared__ float s_delta[CHUNK][CH];  // softplus(dt + dt_bias); 0 past S
  __shared__ float s_dx[CHUNK][CH];     // delta * x
  __shared__ float s_skip[CHUNK][CH];   // D * x
  __shared__ float s_gate[CHUNK][CH];   // silu(z)
  // each thread's part of h . C, summed over a channel's threads after
  // the chunk's scan
  __shared__ float4 s_part[CHUNK][CH];
  __shared__ float s_b[CHUNK][N_STATE];
  __shared__ float s_c[CHUNK][N_STATE];
  __shared__ float s_bias[CH], s_d[CH];
  static_assert(SPLIT == 4, "s_part holds a channel's four parts");

  const int seq = blockIdx.y;
  const int c0 = blockIdx.x * CH;
  const int tid = threadIdx.x;
  const int ch = tid / SPLIT, q = tid % SPLIT;
  const int c = c0 + ch;
  const bool live = c < din;
  const int nch = min(CH, din - c0);
  float* part = reinterpret_cast<float*>(s_part);

  if (tid < CH) {
    s_bias[tid] = tid < nch ? load_f(dt_bias + c0 + tid) : 0.f;
    s_d[tid] = tid < nch ? load_f(dvec + c0 + tid) : 0.f;
  }
  // a thread past din scans zeros and stores nothing
  float a2[PER], h[PER];
  const long long hbase = ((long long)seq * din + c) * N_STATE + q * PER;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    a2[k] = live ? -expf(load_f(a_log + (long long)c * N_STATE + q * PER +
                                k)) * LOG2E
                 : 0.f;
    h[k] = (live && state_in != nullptr) ? state_in[hbase + k] : 0.f;
  }
  const long long row0 = (long long)seq * seqlen;
  const int chunks = (seqlen + CHUNK - 1) / CHUNK;

  // chunk k's y from its parts, out to device memory in coalesced rows
  auto store_y = [&](int k) {
    const int t0 = k * CHUNK;
#pragma unroll
    for (int r = 0; r < Staged<CHUNK>::ROWS; ++r) {
      const int e = r * THREADS + tid;
      const int tt = e / CH, cc = e - tt * CH;
      if (e < CHUNK * CH && t0 + tt < seqlen && cc < nch) {
        const float4 p = s_part[tt][cc];
        store_f(y + (row0 + t0 + tt) * (long long)din + c0 + cc,
                ((p.x + p.y) + (p.z + p.w) + s_skip[tt][cc]) *
                    s_gate[tt][cc]);
      }
    }
  };

  Staged<CHUNK> st;
  fetch(st, x, dt, z, bm, cm, ld_x, ld_dt, ld_z, ld_b, ld_c, row0, 0, seqlen,
        c0, nch);
  for (int k = 0; k < chunks; ++k) {
    __syncthreads();  // chunk k - 1 scanned: its parts are in s_part
    if (k > 0) {
      store_y(k - 1);
      __syncthreads();  // and read: s_* free for chunk k
    }
#pragma unroll
    for (int r = 0; r < Staged<CHUNK>::ROWS; ++r) {
      const int e = r * THREADS + tid;
      if (e < CHUNK * CH) {
        const int tt = e / CH, cc = e - tt * CH;
        const bool ok = k * CHUNK + tt < seqlen && cc < nch;
        const float delta = ok ? softplus(st.dt[r] + s_bias[cc]) : 0.f;
        s_delta[tt][cc] = delta;
        s_dx[tt][cc] = delta * st.x[r];
        s_skip[tt][cc] = s_d[cc] * st.x[r];
        s_gate[tt][cc] = st.z[r] / (1.f + expf(-st.z[r]));
      }
    }
#pragma unroll
    for (int r = 0; r < Staged<CHUNK>::BC; ++r) {
      const int e = r * THREADS + tid;
      if (e < CHUNK * N_STATE) {
        s_b[e / N_STATE][e % N_STATE] = st.b[r];
        s_c[e / N_STATE][e % N_STATE] = st.c[r];
      }
    }
    __syncthreads();
    // the next chunk's loads are in flight while this one is scanned
    if (k + 1 < chunks)
      fetch(st, x, dt, z, bm, cm, ld_x, ld_dt, ld_z, ld_b, ld_c, row0,
            (k + 1) * CHUNK, seqlen, c0, nch);
    // the sequential part: h's FMA is a step's only dependence on the
    // last, so the unrolled steps overlap
#pragma unroll 8
    for (int tt = 0; tt < CHUNK; ++tt) {
      const float delta = s_delta[tt][ch], dx = s_dx[tt][ch];
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int n = q * PER + j;
        h[j] = fmaf(exp2f(delta * a2[j]), h[j], dx * s_b[tt][n]);
        acc = fmaf(h[j], s_c[tt][n], acc);
      }
      part[(tt * CH + ch) * SPLIT + q] = acc;
    }
  }
  __syncthreads();
  if (chunks > 0) store_y(chunks - 1);
  if (live) {
#pragma unroll
    for (int k = 0; k < PER; ++k) state_out[hbase + k] = h[k];
  }
}

template <typename T, typename P, int CHUNK>
void launch(const void* x, const void* dt, const void* z, const void* b,
            const void* c, long long ld_x, long long ld_dt, long long ld_z,
            long long ld_b, long long ld_c, const void* a_log, const void* d,
            const void* dt_bias, const void* state_in, void* y,
            void* state_out, int batch, int seqlen, int din,
            cudaStream_t stream) {
  const dim3 grid((din + CH - 1) / CH, batch);
  selective_scan_kernel<T, P, CHUNK><<<grid, THREADS, 0, stream>>>(
      (const T*)x, (const T*)dt, (const T*)z, (const T*)b, (const T*)c, ld_x,
      ld_dt, ld_z, ld_b, ld_c, (const P*)a_log, (const P*)d,
      (const P*)dt_bias, (const float*)state_in, (T*)y, (float*)state_out,
      seqlen, din);
}

// the instantiation for the activations' dtype, the parameters' and the
// sequence's length: a long sequence in chunks of 16 steps, a short one
// (a decode step) a step at a time, with no chunk's padding to stage
template <typename T, typename P>
void launch_for(bool long_seq, const void* x, const void* dt, const void* z,
                const void* b, const void* c, long long ld_x, long long ld_dt,
                long long ld_z, long long ld_b, long long ld_c,
                const void* a_log, const void* d, const void* dt_bias,
                const void* state_in, void* y, void* state_out, int batch,
                int seqlen, int din, cudaStream_t stream) {
  if (long_seq)
    launch<T, P, 16>(x, dt, z, b, c, ld_x, ld_dt, ld_z, ld_b, ld_c, a_log, d,
                     dt_bias, state_in, y, state_out, batch, seqlen, din,
                     stream);
  else
    launch<T, P, 1>(x, dt, z, b, c, ld_x, ld_dt, ld_z, ld_b, ld_c, a_log, d,
                    dt_bias, state_in, y, state_out, batch, seqlen, din,
                    stream);
}

}  // namespace

extern "C" {

// x, dt, z [B, S, din] and b, c [B, S, 16] in float32 (bf16 == 0) or
// bfloat16 (bf16 == 1), row (b * S + t) at that row times its ld elements;
// a_log [din, 16], d and dt_bias [din] in float32 (params_bf16 == 0) or
// bfloat16 (1); state_in [B, din, 16] float32 or NULL (zeros); y [B, S,
// din] (the inputs' dtype) and state_out [B, din, 16] float32 contiguous.
// Launches on `stream`; allocates nothing.
int selective_scan_launch(const void* x, const void* dt, const void* z,
                          const void* b, const void* c, long long ld_x,
                          long long ld_dt, long long ld_z, long long ld_b,
                          long long ld_c, const void* a_log, const void* d,
                          const void* dt_bias, const void* state_in, void* y,
                          void* state_out, int batch, int seqlen, int din,
                          int bf16, int params_bf16, void* stream) {
  if (batch <= 0 || din <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const bool long_seq = seqlen >= 16;
  using B16 = __nv_bfloat16;
  if (bf16 && params_bf16)
    launch_for<B16, B16>(long_seq, x, dt, z, b, c, ld_x, ld_dt, ld_z, ld_b,
                         ld_c, a_log, d, dt_bias, state_in, y, state_out,
                         batch, seqlen, din, s);
  else if (bf16)
    launch_for<B16, float>(long_seq, x, dt, z, b, c, ld_x, ld_dt, ld_z, ld_b,
                           ld_c, a_log, d, dt_bias, state_in, y, state_out,
                           batch, seqlen, din, s);
  else if (params_bf16)
    launch_for<float, B16>(long_seq, x, dt, z, b, c, ld_x, ld_dt, ld_z, ld_b,
                           ld_c, a_log, d, dt_bias, state_in, y, state_out,
                           batch, seqlen, din, s);
  else
    launch_for<float, float>(long_seq, x, dt, z, b, c, ld_x, ld_dt, ld_z,
                             ld_b, ld_c, a_log, d, dt_bias, state_in, y,
                             state_out, batch, seqlen, din, s);
  return (int)cudaGetLastError();
}

const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
