// The row-sweep long-pair probe for Hopper: the counterpart of
// experiments/r3_lp_bisect.py's row kernel (its `build`, variants c_empty,
// c_noscan, c_full), driven by libssa_tpu_torch/experiments/r3_lp_bisect.py.
//
// One pair, SW, swept row by row by one block: thread t owns the n / 1024
// consecutive columns t * C .. t * C + C - 1, with their H (the row above)
// and F (vertical gap) in registers and their subject codes too. A row:
//   f[j]    = max(f[j] - R, h[j] - Q)
//   hnof[j] = max(h[j-1] + sub(q[i], s[j]), f[j], 0)      (h[-1] = 0)
//   e[j]    = max_{k < j} hnof[k] - Q - (j - 1 - k) R     (lazy E)
//   h[j]    = max(hnof[j], e[j]);  best = max(best, h[j])
// The lazy E is a block-wide inclusive prefix max of y[k] = hnof[k] + k R:
// a thread's C columns in sequence, the warp's totals by __shfl_up_sync,
// the 32 warps' totals through shared memory. h[j-1] of a thread's first
// column comes from the lane before it (__shfl_up_sync, or shared memory
// across warps). Two __syncthreads a row. Exact in int32 for n * R and the
// scores below 2**30.
//
// Variants (VARIANT, a template argument): FULL is the SW score above;
// NOSCAN sets e[j] = hnof[j-1] - Q (no prefix max: wrong scores, timed
// only); EMPTY adds 1 to each h a row, behind the same barriers, and
// returns 0, as the TPU probe's c_empty does (timed only). The launch runs
// `copies` blocks, each the whole pair, so one block measures one SM and
// `copies` = the SM count measures the card.
//
// What bounds it: one SM, and the two block barriers and the scan's
// latency a row; the TPU kernel's doubling scan over the lanes becomes the
// prefix max.
#include <cuda_runtime.h>
#include <stdint.h>

namespace lprs {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int ALPHA = 32;
constexpr int NEG = -(1 << 30);
constexpr unsigned FULL = 0xffffffffu;
enum Variant { FULL_SW = 0, NOSCAN = 1, EMPTY = 2 };

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// q (m,), s (n,) codes; matrix (32, 32) int32; out (copies,) int32: the
// best H (FULL, NOSCAN; 0 for EMPTY). n = C * THREADS.
template <int C, int V>
__global__ void __launch_bounds__(THREADS) rowsweep_kernel(const uint8_t* __restrict__ q, int m,
                                                           const uint8_t* __restrict__ s,
                                                           const int32_t* __restrict__ matrix,
                                                           int Q, int R, int32_t* __restrict__ out) {
  __shared__ int32_t mat[ALPHA * ALPHA];
  __shared__ int32_t wtot[2][WARPS];  // per warp: inclusive max of y
  __shared__ int32_t wlast[2][WARPS]; // per warp: the last lane's last h
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int k = t; k < ALPHA * ALPHA; k += THREADS) mat[k] = matrix[k];
  int h[C], f[C], code[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    h[c] = 0;
    f[c] = NEG;
    code[c] = s[t * C + c];
  }
  int best = 0;
  __syncthreads();
  const int j0 = t * C;
  for (int i = 0; i < m; ++i) {
    const int p = i & 1;
    if constexpr (V == EMPTY) {  // the loop, its barriers and a carried h
#pragma unroll
      for (int c = 0; c < C; ++c) h[c] += 1;
      if (lane == 31) wlast[p][warp] = h[C - 1];
      __syncthreads();
      if (lane == 0) h[0] = imax(h[0], wlast[p][(warp + WARPS - 1) % WARPS]);
      __syncthreads();
      continue;
    }
    const int32_t* row = mat + q[i] * ALPHA;
    // h[j-1] of the first column: the previous thread's last h (row above).
    int left = __shfl_up_sync(FULL, h[C - 1], 1);
    if (lane == 31) wlast[p][warp] = h[C - 1];
    int hnof[C], y[C];
    int run = NEG;
#pragma unroll
    for (int c = 0; c < C; ++c) f[c] = imax(f[c] - R, h[c] - Q);
    __syncthreads();  // wlast written
    if (lane == 0) left = warp > 0 ? wlast[p][warp - 1] : 0;
    if (t == 0) left = 0;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int diag = c == 0 ? left : h[c - 1];
      hnof[c] = imax(imax(diag + row[code[c]], f[c]), 0);
      y[c] = hnof[c] + (j0 + c) * R;
      run = imax(run, y[c]);
      y[c] = run;  // the thread's inclusive prefix
    }
    int excl;  // max of y over the columns before this thread's
    if constexpr (V == FULL_SW) {
      int incl = run;
#pragma unroll
      for (int d = 1; d < 32; d *= 2) {
        const int o = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl = imax(incl, o);
      }
      if (lane == 31) wtot[p][warp] = incl;
      excl = __shfl_up_sync(FULL, incl, 1);
      if (lane == 0) excl = NEG;
      __syncthreads();  // wtot written
      int before = lane < warp ? wtot[p][lane] : NEG;  // the warps before this one
#pragma unroll
      for (int d = 16; d > 0; d /= 2) before = imax(before, __shfl_xor_sync(FULL, before, d));
      excl = imax(excl, before);
    } else {
      // NOSCAN: e[j] = hnof[j-1] - Q; the first column's from the thread before.
      excl = __shfl_up_sync(FULL, hnof[C - 1] + (j0 + C - 1) * R, 1);
      if (lane == 31) wtot[p][warp] = hnof[C - 1] + (j0 + C - 1) * R;
      __syncthreads();
      if (lane == 0) excl = warp > 0 ? wtot[p][warp - 1] : NEG;
      if (t == 0) excl = NEG;
    }
    // dsc[j] = prefix max of y up to j, less j R; e[j] = dsc[j-1] - Q.
    int prev = excl;  // the prefix up to column j0 - 1
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int j = j0 + c;
      const int e = (j == 0 || prev == NEG) ? NEG : prev - (j - 1) * R - Q;
      h[c] = imax(hnof[c], e);
      best = imax(best, h[c]);
      prev = V == FULL_SW ? imax(prev, y[c]) : hnof[c] + j * R;
    }
  }
  __syncthreads();  // the last row's reads of wtot are done
#pragma unroll
  for (int d = 16; d > 0; d /= 2) best = imax(best, __shfl_down_sync(FULL, best, d));
  if (lane == 0) wtot[0][warp] = best;
  __syncthreads();
  if (t == 0) {
    for (int w = 1; w < WARPS; ++w) best = imax(best, wtot[0][w]);
    out[blockIdx.x] = best;
  }
}

template <int C>
static int launch(int variant, const uint8_t* q, int m, const uint8_t* s, const int32_t* mat,
                  int Q, int R, int32_t* out, int copies, cudaStream_t st) {
  switch (variant) {
    case FULL_SW: rowsweep_kernel<C, FULL_SW><<<copies, THREADS, 0, st>>>(q, m, s, mat, Q, R, out); break;
    case NOSCAN: rowsweep_kernel<C, NOSCAN><<<copies, THREADS, 0, st>>>(q, m, s, mat, Q, R, out); break;
    case EMPTY: rowsweep_kernel<C, EMPTY><<<copies, THREADS, 0, st>>>(q, m, s, mat, Q, R, out); break;
    default: return -1;
  }
  return 0;
}

}  // namespace lprs

extern "C" {

// Threads a block: n must be 1024, 4096 or 16384 (1, 4 or 16 columns a thread).
int lprs_threads() { return lprs::THREADS; }

// Enqueue `copies` blocks of the row sweep on `stream`. Returns
// cudaGetLastError(), or -1 for an unsupported variant or column count.
int lprs_rowsweep(int variant, const void* q, int m, const void* s, int n, const void* matrix,
                  int Q, int R, void* out, int copies, void* stream) {
  const uint8_t* qq = (const uint8_t*)q;
  const uint8_t* ss = (const uint8_t*)s;
  const int32_t* mm = (const int32_t*)matrix;
  int32_t* oo = (int32_t*)out;
  cudaStream_t st = (cudaStream_t)stream;
  int rc;
  switch (n / lprs::THREADS) {
    case 1: rc = lprs::launch<1>(variant, qq, m, ss, mm, Q, R, oo, copies, st); break;
    case 4: rc = lprs::launch<4>(variant, qq, m, ss, mm, Q, R, oo, copies, st); break;
    case 16: rc = lprs::launch<16>(variant, qq, m, ss, mm, Q, R, oo, copies, st); break;
    default: return -1;
  }
  if (n % lprs::THREADS != 0 || rc != 0) return -1;
  return (int)cudaGetLastError();
}

}  // extern "C"
