// K1: inter-sequence Smith-Waterman / Needleman-Wunsch scoring for Hopper.
//
// Replaces libssa_tpu/ops/interseq_pallas.py::_kernel (the Pallas TPU kernel
// built by _build and called through interseq_scores_pallas). It computes
// what libssa_tpu/ops/interseq.py::interseq_scores computes, hi/lo included:
// one query against B subjects, one subject per lane, Gotoh affine gaps,
// SW running max or the NW cell (m_real, length) captured, and the exact
// running max/min of H over valid steps and real rows when track_range.
//
// What bounds it on this card: integer issue. A DP cell is about nine
// instructions (three VIADDMNMX, two adds, a max, a shared-memory profile
// read; nvcc fuses max(x + b, c) into DPX on its own); device memory sees
// one subject byte per lane and column, plus one H/F pair per lane and
// column at a strip edge. So the kernel is as fast as the number of warps
// an SM keeps in flight and the instructions a cell costs. Two things cut
// the warps in flight: registers (a row guard on every cell and runtime
// strip roles cost 156 a thread, 3 blocks of 128 an SM) and the grid (one
// query's 8192 lanes make 64 blocks of 128 lanes for 132 SMs). The serial
// F chain stays: a thread's S rows are independent work for the scheduler,
// and every lazy-F scan measured slower on this card.
//
// What the design does about it:
//  * The query runs in strips of S rows (32 in int32, 16 in int64) whose H
//    and E live in registers; F is one scalar carried down the strip. The
//    column step is a template on the strip's role: FIRST takes its top
//    boundary from the formula, MIDDLE reads and writes the edge with no
//    row guard and no runtime role tests, and the last strip keeps the row
//    guard only when rows % S != 0 (so hi/lo and the NW capture see real
//    rows only).
//  * Part A (warps = 1): one thread per (pair, subject lane), a block is 128
//    lanes of one (query, chunk) pair, every thread walks all strips of its
//    lane; strip edges go through a global scratch laid out (pair, 2,
//    n_pad, B), so a warp's reads and writes coalesce. At most 128
//    registers a thread (__launch_bounds__(128, 4)): four blocks an SM. The
//    grid's y axis covers every pair of a stack group. This is the kernel
//    for filled launches (the flagship, multi-query search).
//  * Part B (warps = W > 1), for launches with too few lanes to fill 132
//    SMs: a block is 32 subject lanes and W warps down the query; warp w
//    runs strips w, w + W, ... of the same lanes, CHUNK columns a step,
//    one step behind warp w - 1. The bottom H and outgoing F of a strip pass
//    to the next warp through a two-slot ring in shared memory; only the
//    wrap from warp W - 1 back to warp 0 (query longer than W strips) goes
//    through the global scratch. Steps are separated by __syncthreads: the
//    warps run in lockstep anyway, one barrier orders the ring, the codes
//    ring and the wrap's global writes at once, and a step is a few
//    thousand instructions a warp. Each warp stages its own strip's profile
//    (S x 32) into its own slice, behind __syncwarp only. The block's
//    subject codes come in CHUNK-column slices through cp.async into a ring
//    of W + 1 slots that all W warps read. SW's best and track_range's hi
//    and lo are reduced across the warps through shared memory at the end;
//    NW's cell comes from the warp that holds row m_real - 1.
//  * The strip's profile rows sit in shared memory as [row][symbol]: lanes
//    reading the same symbol broadcast, different symbols hit different
//    banks.
//  * A lane stops at its own subject length. Cells past it are never
//    computed: they touch neither the score nor hi/lo.
//  * Templated on the score type (int32, int64) and on local / track_range.
//
// Every routine but the launch is __host__ __device__, so that a host C++
// compiler builds it too (k1_interseq_host below): the host launch runs
// Part B's steps warp by warp in the same lockstep, with the same rings,
// wrap, per-warp profile slices and cross-warp reduction, and the kernel
// logic is tested on a machine without a GPU.
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define K1_HD __host__ __device__ __forceinline__
#else
#include <vector>
#define K1_HD inline
#endif

namespace k1 {

constexpr int ALPHA = 32;      // padded alphabet: one profile row per query row
constexpr int LANES = 128;     // Part A: subject lanes (threads) a block
constexpr int WARP = 32;       // Part B: subject lanes a block
constexpr int CHUNK = 8;       // Part B: columns a pipeline step
constexpr int MAX_WARPS = 16;  // Part B: warps down the query a block

template <typename T> struct Traits;
template <> struct Traits<int32_t> {
  static constexpr int32_t neg = -(1 << 30);
  static constexpr int strip = 32;
};
template <> struct Traits<int64_t> {
  static constexpr int64_t neg = -(1LL << 62);
  static constexpr int strip = 16;
};

template <typename T> K1_HD T mx(T a, T b) { return a > b ? a : b; }
template <typename T> K1_HD T mn(T a, T b) { return a < b ? a : b; }

struct Args {
  const int32_t* profiles;  // (n_queries, m, ALPHA)
  int m;
  const int8_t* codes;      // (g, n_pad, B)
  const int32_t* lengths;   // (g, B)
  int n_pad, B;
  const int32_t* iq;        // (P,) query of each pair
  const int32_t* ic;        // (P,) chunk of each pair
  const int32_t* m_reals;   // (n_queries,)
  int P;
  int64_t gap_q, gap_r;
  int warps;                // 1: Part A; 2 .. MAX_WARPS: Part B
  void* scores;             // (P, B) of T
  void* hi;
  void* lo;
  void* scratch;            // (P, 2, n_pad, B) of T; unused when rows <= S W
};

template <typename T> struct LaneState {
  T best, hi, lo, nw;
};

// One lane's registers inside a strip: H and E of its S rows at the last
// column stepped, and H[r0][t] of that column (the next column's diagonal).
template <typename T, int S> struct Strip {
  T H[S], E[S];
  T diag_top;
};

template <typename T>
K1_HD LaneState<T> lane_init(int mr, T Q, T R) {
  LaneState<T> st;
  st.best = 0;
  st.hi = 0;
  st.lo = 0;
  st.nw = -(Q + (T)(mr - 1) * R);  // NW score against an empty subject
  return st;
}

// Column 0 of rows r0+1 .. r0+S (1-based) and H[r0][0].
template <typename T, int S, bool LOCAL>
K1_HD void strip_init(Strip<T, S>& z, int r0, T Q, T R) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
    z.H[s] = LOCAL ? (T)0 : -(Q + (T)(r0 + s) * R);  // H[i][0]
    z.E[s] = Traits<T>::neg;
  }
  z.diag_top = (LOCAL || r0 == 0) ? (T)0 : -(Q + (T)(r0 - 1) * R);
}

// Columns t0+1 .. t0+n (1-based, n >= 1) of one lane's strip, rows r0+1 ..
// r0+S. prof: the strip's profile, (S, ALPHA). col[i * cs]: the code of
// column t0+1+i. in[i * is] and in[i * is + ifo]: H of the row above the
// strip and F into its first row at that column (not read by FIRST).
// out[i * os] and out[i * os + ofo]: the strip's last-row H and outgoing F
// (not written by LAST); SAME writes them over `in` instead, one column
// behind the reads (Part A's scratch). real: the strip's real rows, read
// under GUARD only.
template <typename T, int S, bool LOCAL, bool TRACK, bool SAME, bool FIRST,
          bool LAST, bool GUARD>
K1_HD void columns(Strip<T, S>& z, LaneState<T>& st, const T* prof,
                   const int8_t* col, int cs, T* in, int is, int ifo, T* out,
                   int os, int ofo, int t0, int n, int real, T Q, T R) {
  T best = st.best, hi = st.hi, lo = st.lo;
  int c_next = *col;
  T h_next = 0, f_next = 0;
  if (!FIRST) {
    h_next = in[0];
    f_next = in[ifo];
  }
  for (int i = 0; i < n; ++i) {
    const int c = c_next;
    T htop, f;
    if (FIRST) {
      htop = LOCAL ? (T)0 : -(Q + (T)(t0 + i) * R);  // H[0][t+1]
      f = htop - Q;                                  // F[1][t+1]
    } else {
      htop = h_next;  // H[r0][t+1]
      f = f_next;     // F[r0+1][t+1]
    }
    if (i + 1 < n) {
      col += cs;
      c_next = *col;
      if (!FIRST) {
        h_next = in[is];
        f_next = in[is + ifo];
      }
    }
    T diag = z.diag_top;
    z.diag_top = htop;
    const T* pc = prof + c;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const T e = mx(z.E[s] - R, z.H[s] - Q);
      T h = mx(mx(diag + pc[s * ALPHA], e), f);
      if (LOCAL) h = mx(h, (T)0);
      diag = z.H[s];
      z.H[s] = h;
      z.E[s] = e;
      if (!GUARD || s < real) {
        if (LOCAL) {
          best = mx(best, h);
        } else if (TRACK) {
          hi = mx(hi, h);
          lo = mn(lo, h);
        }
      }
      f = mx(f - R, h - Q);
    }
    if (!LAST) {
      if (SAME) {
        in[0] = z.H[S - 1];
        in[ifo] = f;
      } else {
        out[0] = z.H[S - 1];
        out[ofo] = f;
        out += os;
      }
    }
    in += is;
  }
  st.best = best;
  st.hi = hi;
  st.lo = lo;
}

// The role dispatch: one instantiation of `columns` per strip role.
template <typename T, int S, bool LOCAL, bool TRACK, bool SAME>
K1_HD void columns_as(bool first, bool last, bool guard, Strip<T, S>& z,
                      LaneState<T>& st, const T* prof, const int8_t* col,
                      int cs, T* in, int is, int ifo, T* out, int os, int ofo,
                      int t0, int n, int real, T Q, T R) {
#define K1_COLUMNS(F, L, G)                                                  \
  columns<T, S, LOCAL, TRACK, SAME, F, L, G>(z, st, prof, col, cs, in, is,   \
                                             ifo, out, os, ofo, t0, n, real, \
                                             Q, R)
  if (!last) {
    if (first)
      K1_COLUMNS(true, false, false);
    else
      K1_COLUMNS(false, false, false);
  } else if (guard) {
    if (first)
      K1_COLUMNS(true, true, true);
    else
      K1_COLUMNS(false, true, true);
  } else {
    if (first)
      K1_COLUMNS(true, true, false);
    else
      K1_COLUMNS(false, true, false);
  }
#undef K1_COLUMNS
}

// H[m_real][len], from the strip that holds row m_real - 1.
template <typename T, int S>
K1_HD void capture_nw(const Strip<T, S>& z, LaneState<T>& st, int r0, int mr) {
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (r0 + s == mr - 1) st.nw = z.H[s];
}

template <typename T, bool LOCAL, bool TRACK>
K1_HD void lane_finish(const Args& a, size_t o, const LaneState<T>& st) {
  T score = LOCAL ? st.best : st.nw;
  ((T*)a.scores)[o] = score;
  ((T*)a.hi)[o] = (TRACK && !LOCAL) ? st.hi : score;
  ((T*)a.lo)[o] = (TRACK && !LOCAL) ? st.lo : (T)0;
}

// Entry k of the strip at r0's profile, [row][symbol]; rows past m score 0
// (the last strip's guard keeps them out of every result).
template <typename T>
K1_HD T prof_entry(const int32_t* qprof, int m, int r0, int k) {
  const int row = r0 + k / ALPHA;
  return row < m ? (T)qprof[(size_t)row * ALPHA + k % ALPHA] : (T)0;
}

// -- Part B: the warp pipeline --------------------------------------------

// Part B's shared memory, carved from one dynamic allocation.
template <typename T> struct Pipe {
  T* ring;        // (W - 1 boundaries, 2 slots, 2 planes H/F, CHUNK, WARP)
  T* prof;        // (W, S, ALPHA); the cross-warp reduction reuses it
  int8_t* codes;  // (W + 1 slots, CHUNK, WARP)
};

template <typename T> K1_HD size_t pipe_bytes(int W) {
  constexpr int S = Traits<T>::strip;
  return sizeof(T) * ((size_t)(W - 1) * 4 * CHUNK * WARP + (size_t)W * S * ALPHA) +
         (size_t)(W + 1) * CHUNK * WARP;
}

template <typename T> K1_HD Pipe<T> pipe_at(unsigned char* base, int W) {
  constexpr int S = Traits<T>::strip;
  Pipe<T> sm;
  sm.ring = (T*)base;
  sm.prof = sm.ring + (size_t)(W - 1) * 4 * CHUNK * WARP;
  sm.codes = (int8_t*)(sm.prof + (size_t)W * S * ALPHA);
  return sm;
}

// Plane (0: H, 1: F) of slot `slot` at the boundary below warp `bnd`.
template <typename T>
K1_HD T* ring_at(const Pipe<T>& sm, int bnd, int slot, int plane) {
  return sm.ring + ((size_t)(bnd * 2 + slot) * 2 + plane) * CHUNK * WARP;
}

// A block's schedule. Work item u (0 .. total - 1) is chunk u % nce of
// pass u / nce; warp w runs item tau - w at step tau, on strip pass W + w.
// nce = max(nc, W) so that warp 0 reads a wrapped chunk at least one step
// after warp W - 1 wrote it (items with chunk >= nc hold no columns).
struct Sched {
  int W, nc, nce, nstrips, total, steps;
};

K1_HD Sched sched_of(int W, int maxlen, int rows, int S) {
  Sched s;
  s.W = W;
  s.nc = (maxlen + CHUNK - 1) / CHUNK;
  s.nce = s.nc > W ? s.nc : W;
  s.nstrips = (rows + S - 1) / S;
  s.total = (s.nstrips + W - 1) / W * s.nce;
  s.steps = s.nc ? s.total + W - 1 : 0;
  return s;
}

struct Work {
  bool on;
  int u, j, k;  // item, chunk, strip
};

K1_HD Work work_of(const Sched& s, int tau, int w) {
  Work wk;
  wk.u = tau - w;
  wk.on = wk.u >= 0 && wk.u < s.total;
  wk.j = wk.on ? wk.u % s.nce : 0;
  wk.k = wk.on ? wk.u / s.nce * s.W + w : 0;
  wk.on = wk.on && wk.k < s.nstrips && wk.j < s.nc;
  return wk;
}

// One 4-byte piece of a codes slice: cp.async on the card.
K1_HD void copy4(int8_t* dst, const int8_t* src) {
#ifdef __CUDA_ARCH__
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
#else
  memcpy(dst, src, 4);
#endif
}

// Wait for this thread's cp.async copies.
K1_HD void copies_done() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Thread tid of nth stages the codes of chunk j (columns j CHUNK ..) of the
// block's lanes into `slot`: 4-byte cp.async pieces where B and the codes
// pointer allow (`words`), else byte by byte.
K1_HD void stage_codes(int8_t* slot, const int8_t* src, int j, int n_pad,
                       int B, int lanes, bool words, int tid, int nth) {
  const int t0 = j * CHUNK;
  const int ncols = mn(CHUNK, n_pad - t0);
  if (words) {
    for (int k = tid; k < ncols * (WARP / 4); k += nth) {
      const int t = k / (WARP / 4), l = 4 * (k % (WARP / 4));
      if (l < lanes) copy4(slot + t * WARP + l, src + (size_t)(t0 + t) * B + l);
    }
  } else {
    for (int k = tid; k < ncols * WARP; k += nth) {
      const int t = k / WARP, l = k % WARP;
      if (l < lanes) slot[t * WARP + l] = src[(size_t)(t0 + t) * B + l];
    }
  }
}

// Lane `lane` of warp w stages its share of the profile of strip r0.
template <typename T>
K1_HD void stage_prof(T* dst, const int32_t* qprof, int m, int r0, int lane) {
  constexpr int S = Traits<T>::strip;
  for (int k = lane; k < S * ALPHA; k += WARP)
    dst[k] = prof_entry<T>(qprof, m, r0, k);
}

// The wrap's scratch H plane at lane b of pair p (F follows n_pad B later).
template <typename T> K1_HD T* scratch_at(const Args& a, int p, int b) {
  return (T*)a.scratch + (size_t)p * 2 * a.n_pad * a.B + b;
}

// Lane `lane` (subject b of pair p) of warp w at a step with work wk: its
// columns of chunk wk.j of strip wk.k.
template <typename T, bool LOCAL, bool TRACK>
K1_HD void pipe_lane(const Args& a, const Pipe<T>& sm, const Sched& s,
                     const Work& wk, int w, int lane, int p, int b, int len,
                     int rows, int mr, Strip<T, Traits<T>::strip>& z,
                     LaneState<T>& st, T Q, T R) {
  constexpr int S = Traits<T>::strip;
  const int r0 = wk.k * S;
  if (wk.j == 0) strip_init<T, S, LOCAL>(z, r0, Q, R);
  const int t0 = wk.j * CHUNK;
  const int n = mn(CHUNK, len - t0);
  if (n <= 0) return;
  const bool first = wk.k == 0, last = wk.k == s.nstrips - 1;
  const int slot = wk.u & 1;
  // A ring slot: H then F, CHUNK x WARP each. The wrap's scratch: planes
  // n_pad B apart, B a column.
  const int plane = a.n_pad * a.B;
  T* in = nullptr;
  T* out = nullptr;
  int is = WARP, ifo = CHUNK * WARP, os = WARP, ofo = CHUNK * WARP;
  if (!first) {
    if (w > 0) {
      in = ring_at(sm, w - 1, slot, 0) + lane;
    } else {  // the wrap: warp W - 1's strip of the previous pass
      in = scratch_at<T>(a, p, b) + (size_t)t0 * a.B;
      is = a.B;
      ifo = plane;
    }
  }
  if (!last) {
    if (w < s.W - 1) {
      out = ring_at(sm, w, slot, 0) + lane;
    } else {
      out = scratch_at<T>(a, p, b) + (size_t)t0 * a.B;
      os = a.B;
      ofo = plane;
    }
  }
  const int8_t* col = sm.codes + (size_t)(wk.u % (s.W + 1)) * CHUNK * WARP + lane;
  columns_as<T, S, LOCAL, TRACK, false>(first, last, last && rows % S != 0, z, st,
                                        sm.prof + (size_t)w * S * ALPHA, col, WARP,
                                        in, is, ifo, out, os, ofo, t0, n, rows - r0,
                                        Q, R);
  if (!LOCAL && last && t0 + n == len) capture_nw(z, st, r0, mr);
}

// The cross-warp reduction: each warp's partials in, warp 0's lanes out.
template <typename T>
K1_HD void red_put(T* red, int W, int w, int lane, const LaneState<T>& st) {
  red[(size_t)(0 * W + w) * WARP + lane] = st.best;
  red[(size_t)(1 * W + w) * WARP + lane] = st.hi;
  red[(size_t)(2 * W + w) * WARP + lane] = st.lo;
  red[(size_t)(3 * W + w) * WARP + lane] = st.nw;
}

template <typename T>
K1_HD LaneState<T> red_get(const T* red, int W, int lane, int tail) {
  LaneState<T> st;
  st.best = red[lane];
  st.hi = red[(size_t)W * WARP + lane];
  st.lo = red[(size_t)2 * W * WARP + lane];
  for (int w = 1; w < W; ++w) {
    st.best = mx(st.best, red[(size_t)w * WARP + lane]);
    st.hi = mx(st.hi, red[(size_t)(W + w) * WARP + lane]);
    st.lo = mn(st.lo, red[(size_t)(2 * W + w) * WARP + lane]);
  }
  st.nw = red[(size_t)(3 * W + tail) * WARP + lane];
  return st;
}

// What a lane of either part needs of its pair.
struct PairLane {
  int q, c, mr, rows, len;
  bool ok;
};

template <bool LOCAL>
K1_HD PairLane pair_lane(const Args& a, int p, int b) {
  PairLane pl;
  pl.q = a.iq[p];
  pl.c = a.ic[p];
  pl.mr = a.m_reals[pl.q];
  pl.rows = LOCAL ? a.m : pl.mr;
  pl.ok = b < a.B;
  pl.len = pl.ok ? a.lengths[(size_t)pl.c * a.B + b] : 0;
  return pl;
}

#ifdef __CUDACC__

template <typename T, bool LOCAL, bool TRACK>
__global__ void __launch_bounds__(LANES, 4) k1_lanes(Args a) {
  constexpr int S = Traits<T>::strip;
  __shared__ T prof[S * ALPHA];
  const int p = blockIdx.y;
  const int b = blockIdx.x * LANES + threadIdx.x;
  const PairLane pl = pair_lane<LOCAL>(a, p, b);
  const T Q = (T)a.gap_q, R = (T)a.gap_r;
  LaneState<T> st = lane_init<T>(pl.mr, Q, R);
  const int8_t* col = a.codes + (size_t)pl.c * a.n_pad * a.B + b;
  T* scr = pl.rows > S ? scratch_at<T>(a, p, b) : nullptr;
  const int32_t* qprof = a.profiles + (size_t)pl.q * a.m * ALPHA;
  Strip<T, S> z;
  for (int r0 = 0; r0 < pl.rows; r0 += S) {
    __syncthreads();
    for (int k = threadIdx.x; k < S * ALPHA; k += LANES)
      prof[k] = prof_entry<T>(qprof, a.m, r0, k);
    __syncthreads();
    if (pl.len > 0) {
      const bool last = r0 + S >= pl.rows;
      strip_init<T, S, LOCAL>(z, r0, Q, R);
      columns_as<T, S, LOCAL, TRACK, true>(
          r0 == 0, last, last && pl.rows % S != 0, z, st, prof, col, a.B, scr,
          a.B, a.n_pad * a.B, nullptr, 0, 0, 0, pl.len, pl.rows - r0, Q, R);
      if (!LOCAL && last) capture_nw(z, st, r0, pl.mr);
    }
  }
  if (pl.ok) lane_finish<T, LOCAL, TRACK>(a, (size_t)p * a.B + b, st);
}

template <typename T, bool LOCAL, bool TRACK>
__global__ void __launch_bounds__(WARP * MAX_WARPS, 1) k1_pipe(Args a) {
  constexpr int S = Traits<T>::strip;
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = a.warps;
  const int w = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const Pipe<T> sm = pipe_at<T>(smem, W);
  const int p = blockIdx.y;
  const int b0 = blockIdx.x * WARP, b = b0 + lane;
  const PairLane pl = pair_lane<LOCAL>(a, p, b);
  const T Q = (T)a.gap_q, R = (T)a.gap_r;
  const Sched s = sched_of(W, __reduce_max_sync(0xffffffffu, pl.len), pl.rows, S);
  const int32_t* qprof = a.profiles + (size_t)pl.q * a.m * ALPHA;
  const int8_t* src = a.codes + (size_t)pl.c * a.n_pad * a.B + b0;
  const int lanes = mn(WARP, a.B - b0);
  const bool words = a.B % 4 == 0 && (uintptr_t)a.codes % 4 == 0;
  LaneState<T> st = lane_init<T>(pl.mr, Q, R);
  Strip<T, S> z;
  if (s.steps) {
    stage_codes(sm.codes, src, 0, a.n_pad, a.B, lanes, words, threadIdx.x, blockDim.x);
    copies_done();
    __syncthreads();
  }
  for (int tau = 0; tau < s.steps; ++tau) {
    const int u1 = tau + 1;
    if (u1 < s.total && u1 % s.nce < s.nc)
      stage_codes(sm.codes + (size_t)(u1 % (W + 1)) * CHUNK * WARP, src, u1 % s.nce,
                  a.n_pad, a.B, lanes, words, threadIdx.x, blockDim.x);
    const Work wk = work_of(s, tau, w);
    if (wk.on) {
      if (wk.j == 0) {
        __syncwarp();
        stage_prof<T>(sm.prof + (size_t)w * S * ALPHA, qprof, a.m, wk.k * S, lane);
        __syncwarp();
      }
      pipe_lane<T, LOCAL, TRACK>(a, sm, s, wk, w, lane, p, b, pl.len, pl.rows, pl.mr,
                                 z, st, Q, R);
    }
    copies_done();
    __syncthreads();
  }
  red_put<T>(sm.prof, W, w, lane, st);
  __syncthreads();
  if (w == 0 && pl.ok)
    lane_finish<T, LOCAL, TRACK>(a, (size_t)p * a.B + b,
                                 red_get<T>(sm.prof, W, lane, (s.nstrips - 1) % W));
}

template <typename T, bool LOCAL, bool TRACK>
static int launch(const Args& a, cudaStream_t stream) {
  if (a.warps == 1) {
    dim3 grid((a.B + LANES - 1) / LANES, a.P);
    k1_lanes<T, LOCAL, TRACK><<<grid, LANES, 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  const size_t bytes = pipe_bytes<T>(a.warps);
  const int rc = (int)cudaFuncSetAttribute(
      k1_pipe<T, LOCAL, TRACK>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != 0) return rc;
  dim3 grid((a.B + WARP - 1) / WARP, a.P);
  k1_pipe<T, LOCAL, TRACK><<<grid, WARP * a.warps, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// out: registers a thread, local bytes a thread, resident blocks an SM,
// dynamic shared bytes a block.
template <typename T, bool LOCAL, bool TRACK>
static int attrs(int warps, int* out) {
  cudaFuncAttributes fa;
  const void* fn = warps == 1 ? (const void*)k1_lanes<T, LOCAL, TRACK>
                              : (const void*)k1_pipe<T, LOCAL, TRACK>;
  const int threads = warps == 1 ? LANES : WARP * warps;
  const size_t bytes = warps == 1 ? 0 : pipe_bytes<T>(warps);
  int rc = (int)cudaFuncGetAttributes(&fa, fn);
  if (rc == 0 && warps > 1)
    rc = (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
  int blocks = 0;
  if (rc == 0)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, bytes);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = blocks;
  out[3] = (int)bytes;
  return rc;
}

#else  // host build: the same routines, lane by lane and warp by warp

template <typename T, bool LOCAL, bool TRACK>
static void host_lanes(const Args& a) {
  constexpr int S = Traits<T>::strip;
  std::vector<T> prof(S * ALPHA);
  std::vector<LaneState<T>> st(a.B);
  std::vector<Strip<T, S>> z(a.B);
  const T Q = (T)a.gap_q, R = (T)a.gap_r;
  for (int p = 0; p < a.P; ++p) {
    const PairLane p0 = pair_lane<LOCAL>(a, p, 0);
    for (int b = 0; b < a.B; ++b) st[b] = lane_init<T>(p0.mr, Q, R);
    const int32_t* qprof = a.profiles + (size_t)p0.q * a.m * ALPHA;
    for (int r0 = 0; r0 < p0.rows; r0 += S) {
      for (int k = 0; k < S * ALPHA; ++k) prof[k] = prof_entry<T>(qprof, a.m, r0, k);
      const bool last = r0 + S >= p0.rows;
      for (int b = 0; b < a.B; ++b) {
        const PairLane pl = pair_lane<LOCAL>(a, p, b);
        if (pl.len == 0) continue;
        T* scr = pl.rows > S ? scratch_at<T>(a, p, b) : nullptr;
        strip_init<T, S, LOCAL>(z[b], r0, Q, R);
        columns_as<T, S, LOCAL, TRACK, true>(
            r0 == 0, last, last && pl.rows % S != 0, z[b], st[b], prof.data(),
            a.codes + (size_t)pl.c * a.n_pad * a.B + b, a.B, scr, a.B,
            a.n_pad * a.B, nullptr, 0, 0, 0, pl.len, pl.rows - r0, Q, R);
        if (!LOCAL && last) capture_nw(z[b], st[b], r0, pl.mr);
      }
    }
    for (int b = 0; b < a.B; ++b)
      lane_finish<T, LOCAL, TRACK>(a, (size_t)p * a.B + b, st[b]);
  }
}

// Part B's block in lockstep: at each step every warp's lanes run, then the
// step's barrier is the loop's next turn.
template <typename T, bool LOCAL, bool TRACK>
static void host_pipe(const Args& a) {
  constexpr int S = Traits<T>::strip;
  const int W = a.warps;
  std::vector<unsigned char> smem(pipe_bytes<T>(W));
  const Pipe<T> sm = pipe_at<T>(smem.data(), W);
  std::vector<LaneState<T>> st(W * WARP);
  std::vector<Strip<T, S>> z(W * WARP);
  const T Q = (T)a.gap_q, R = (T)a.gap_r;
  const bool words = a.B % 4 == 0 && (uintptr_t)a.codes % 4 == 0;
  for (int p = 0; p < a.P; ++p) {
    for (int b0 = 0; b0 < a.B; b0 += WARP) {
      PairLane pl[WARP];
      int maxlen = 0;
      for (int l = 0; l < WARP; ++l) {
        pl[l] = pair_lane<LOCAL>(a, p, b0 + l);
        maxlen = pl[l].len > maxlen ? pl[l].len : maxlen;
      }
      const Sched s = sched_of(W, maxlen, pl[0].rows, S);
      const int32_t* qprof = a.profiles + (size_t)pl[0].q * a.m * ALPHA;
      const int8_t* src = a.codes + (size_t)pl[0].c * a.n_pad * a.B + b0;
      const int lanes = mn(WARP, a.B - b0);
      for (int i = 0; i < W * WARP; ++i) st[i] = lane_init<T>(pl[0].mr, Q, R);
      if (s.steps) stage_codes(sm.codes, src, 0, a.n_pad, a.B, lanes, words, 0, 1);
      for (int tau = 0; tau < s.steps; ++tau) {
        const int u1 = tau + 1;
        if (u1 < s.total && u1 % s.nce < s.nc)
          stage_codes(sm.codes + (size_t)(u1 % (W + 1)) * CHUNK * WARP, src, u1 % s.nce,
                      a.n_pad, a.B, lanes, words, 0, 1);
        for (int w = 0; w < W; ++w) {
          const Work wk = work_of(s, tau, w);
          if (!wk.on) continue;
          if (wk.j == 0)
            for (int l = 0; l < WARP; ++l)
              stage_prof<T>(sm.prof + (size_t)w * S * ALPHA, qprof, a.m, wk.k * S, l);
          for (int l = 0; l < WARP; ++l)
            pipe_lane<T, LOCAL, TRACK>(a, sm, s, wk, w, l, p, b0 + l, pl[l].len,
                                       pl[l].rows, pl[l].mr, z[w * WARP + l],
                                       st[w * WARP + l], Q, R);
        }
      }
      for (int w = 0; w < W; ++w)
        for (int l = 0; l < WARP; ++l) red_put<T>(sm.prof, W, w, l, st[w * WARP + l]);
      for (int l = 0; l < WARP; ++l)
        if (pl[l].ok)
          lane_finish<T, LOCAL, TRACK>(a, (size_t)p * a.B + b0 + l,
                                       red_get<T>(sm.prof, W, l, (s.nstrips - 1) % W));
    }
  }
}

template <typename T, bool LOCAL, bool TRACK>
static int launch(const Args& a, void*) {
  if (a.warps == 1)
    host_lanes<T, LOCAL, TRACK>(a);
  else
    host_pipe<T, LOCAL, TRACK>(a);
  return 0;
}

#endif

template <typename Stream>
static int dispatch(const Args& a, int local, int track, int wide,
                    Stream stream) {
  if (a.warps < 1 || a.warps > MAX_WARPS) return 1;  // cudaErrorInvalidValue
  if (wide) {
    if (local)
      return track ? launch<int64_t, true, true>(a, stream)
                   : launch<int64_t, true, false>(a, stream);
    return track ? launch<int64_t, false, true>(a, stream)
                 : launch<int64_t, false, false>(a, stream);
  }
  if (local)
    return track ? launch<int32_t, true, true>(a, stream)
                 : launch<int32_t, true, false>(a, stream);
  return track ? launch<int32_t, false, true>(a, stream)
               : launch<int32_t, false, false>(a, stream);
}

static Args make_args(const void* profiles, int m, const void* codes,
                      const void* lengths, int n_pad, int B, const void* iq,
                      const void* ic, const void* m_reals, int P,
                      long long gap_q, long long gap_r, int warps,
                      void* scores, void* hi, void* lo, void* scratch) {
  Args a;
  a.profiles = (const int32_t*)profiles;
  a.m = m;
  a.codes = (const int8_t*)codes;
  a.lengths = (const int32_t*)lengths;
  a.n_pad = n_pad;
  a.B = B;
  a.iq = (const int32_t*)iq;
  a.ic = (const int32_t*)ic;
  a.m_reals = (const int32_t*)m_reals;
  a.P = P;
  a.gap_q = gap_q;
  a.gap_r = gap_r;
  a.warps = warps;
  a.scores = scores;
  a.hi = hi;
  a.lo = lo;
  a.scratch = scratch;
  return a;
}

}  // namespace k1

extern "C" {

// Query rows per strip: the scratch is needed only above this many rows
// times the warps down the query.
int k1_strip_rows(int wide) {
  return wide ? k1::Traits<int64_t>::strip : k1::Traits<int32_t>::strip;
}

// The most warps down the query a Part B block takes.
int k1_max_warps(void) { return k1::MAX_WARPS; }

#ifdef __CUDACC__
// Enqueue K1 on `stream` over P pairs with `warps` warps down the query (1:
// Part A); returns the CUDA error of the launch (0 when it was taken).
int k1_interseq(const void* profiles, int m, const void* codes,
                const void* lengths, int n_pad, int B, const void* iq,
                const void* ic, const void* m_reals, int P, long long gap_q,
                long long gap_r, int local, int track, int wide, int warps,
                void* scores, void* hi, void* lo, void* scratch, void* stream) {
  k1::Args a = k1::make_args(profiles, m, codes, lengths, n_pad, B, iq, ic,
                             m_reals, P, gap_q, gap_r, warps, scores, hi, lo,
                             scratch);
  return k1::dispatch(a, local, track, wide, (cudaStream_t)stream);
}

// The instantiation's registers a thread, local bytes a thread, resident
// blocks an SM and dynamic shared bytes at `warps` into out[0..3]; returns
// the CUDA error.
int k1_attrs(int local, int track, int wide, int warps, int* out) {
  if (warps < 1 || warps > k1::MAX_WARPS) return 1;
  if (wide) {
    if (local)
      return track ? k1::attrs<int64_t, true, true>(warps, out)
                   : k1::attrs<int64_t, true, false>(warps, out);
    return track ? k1::attrs<int64_t, false, true>(warps, out)
                 : k1::attrs<int64_t, false, false>(warps, out);
  }
  if (local)
    return track ? k1::attrs<int32_t, true, true>(warps, out)
                 : k1::attrs<int32_t, true, false>(warps, out);
  return track ? k1::attrs<int32_t, false, true>(warps, out)
               : k1::attrs<int32_t, false, false>(warps, out);
}
#else
// The same computation on the host; returns 0, or 1 for a warps count out
// of range.
int k1_interseq_host(const void* profiles, int m, const void* codes,
                     const void* lengths, int n_pad, int B, const void* iq,
                     const void* ic, const void* m_reals, int P,
                     long long gap_q, long long gap_r, int local, int track,
                     int wide, int warps, void* scores, void* hi, void* lo,
                     void* scratch) {
  k1::Args a = k1::make_args(profiles, m, codes, lengths, n_pad, B, iq, ic,
                             m_reals, P, gap_q, gap_r, warps, scores, hi, lo,
                             scratch);
  return k1::dispatch(a, local, track, wide, (void*)nullptr);
}
#endif

}  // extern "C"
