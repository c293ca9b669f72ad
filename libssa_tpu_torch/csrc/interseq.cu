// K1: inter-sequence Smith-Waterman / Needleman-Wunsch scoring for Hopper.
//
// Replaces libssa_tpu/ops/interseq_pallas.py::_kernel (the Pallas TPU kernel
// built by _build and called through interseq_scores_pallas). It computes
// what libssa_tpu/ops/interseq.py::interseq_scores computes, hi/lo included:
// one query against B subjects, one subject per lane, Gotoh affine gaps,
// SW running max or the NW cell (m_real, length) captured, and the exact
// running max/min of H over valid steps and real rows when track_range.
//
// What bounds it on this card: integer ALU issue. Every DP cell costs about
// ten dependent 32-bit add/max operations and one shared-memory profile
// read, while device memory sees only one subject byte per lane and column,
// plus one H/F pair per lane and column at the edge of each query strip.
//
// What the design does about it:
//  * One thread per (pair, subject lane); a block is 128 lanes of one
//    (query, chunk) pair, so the whole block shares one query profile. The
//    grid's y axis covers every pair of a stack group, so a single launch
//    fills all 132 SMs even where one chunk's 8192 lanes make 64 blocks.
//  * The query runs in strips of S rows whose H and E live in registers.
//    Inside a strip a thread walks its own subject's columns with F as one
//    scalar carried down the strip: the plain Gotoh recurrence, no lazy-F
//    scan. Between strips each lane keeps its last-row H and next-row F per
//    column in a scratch laid out (pair, 2, n_pad, B), so a warp's reads and
//    writes coalesce. Any query length runs; there is no fallback.
//  * The strip's profile rows sit in shared memory as [row][symbol]: lanes
//    reading the same symbol broadcast, different symbols hit different
//    banks.
//  * A lane stops at its own subject length. Cells past it are never
//    computed: they touch neither the score nor hi/lo.
//  * Templated on the score type (int32, int64) and on local / track_range.
//
// The per-lane strip routine is __host__ __device__ so that a host C++
// compiler can build it too (k1_interseq_host below) and the strip logic can
// be tested on a machine without a GPU.
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define K1_HD __host__ __device__ __forceinline__
#else
#include <vector>
#define K1_HD inline
#endif

namespace k1 {

constexpr int ALPHA = 32;   // padded alphabet: one profile row per query row
constexpr int LANES = 128;  // threads (subject lanes) per block

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
  void* scores;             // (P, B) of T
  void* hi;
  void* lo;
  void* scratch;            // (P, 2, n_pad, B) of T; unused when rows <= S
};

template <typename T> struct LaneState {
  T best, hi, lo, nw;
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

// Rows r0+1 .. r0+S (1-based) of one lane, over its columns 1 .. len.
// prof: the strip's profile, (S, ALPHA). col, scrH, scrF: this lane's
// subject codes and scratch planes, B elements per column.
template <typename T, int S, bool LOCAL, bool TRACK>
K1_HD void strip(const T* prof, const int8_t* col, T* scrH, T* scrF, int B,
                 int len, int r0, int rows, int mr, T Q, T R,
                 LaneState<T>& st) {
  const bool first = r0 == 0;
  const bool last = r0 + S >= rows;
  T Hc[S], Ec[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    Hc[s] = LOCAL ? (T)0 : -(Q + (T)(r0 + s) * R);  // H[i][0]
    Ec[s] = Traits<T>::neg;
  }
  T diag_top = (LOCAL || first) ? (T)0 : -(Q + (T)(r0 - 1) * R);  // H[r0][0]
  T best = st.best, hi = st.hi, lo = st.lo;

  int c_next = col[0];
  T h_next = 0, f_next = 0;
  if (!first) {
    h_next = scrH[0];
    f_next = scrF[0];
  }
  for (int t = 0; t < len; ++t) {
    const int c = c_next;
    T htop, f;
    if (first) {
      htop = LOCAL ? (T)0 : -(Q + (T)t * R);  // H[0][t+1]
      f = htop - Q;                           // F[1][t+1]
    } else {
      htop = h_next;  // H[r0][t+1]
      f = f_next;     // F[r0+1][t+1]
    }
    if (t + 1 < len) {
      const size_t o = (size_t)(t + 1) * B;
      c_next = col[o];
      if (!first) {
        h_next = scrH[o];
        f_next = scrF[o];
      }
    }
    T diag = diag_top;
    diag_top = htop;
    const T* pc = prof + c;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const T e = mx(Ec[s] - R, Hc[s] - Q);
      T h = mx(mx(diag + pc[s * ALPHA], e), f);
      if (LOCAL) h = mx(h, (T)0);
      diag = Hc[s];
      Hc[s] = h;
      Ec[s] = e;
      if (r0 + s < rows) {
        if (LOCAL) {
          best = mx(best, h);
        } else if (TRACK) {
          hi = mx(hi, h);
          lo = mn(lo, h);
        }
      }
      f = mx(f - R, h - Q);
    }
    if (!last) {
      const size_t o = (size_t)t * B;
      scrH[o] = Hc[S - 1];
      scrF[o] = f;
    }
  }
  st.best = best;
  st.hi = hi;
  st.lo = lo;
  if (!LOCAL && r0 <= mr - 1 && mr - 1 < r0 + S) {
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (r0 + s == mr - 1) st.nw = Hc[s];  // H[m_real][len]
  }
}

template <typename T, bool LOCAL, bool TRACK>
K1_HD void lane_finish(const Args& a, size_t o, const LaneState<T>& st) {
  T score = LOCAL ? st.best : st.nw;
  ((T*)a.scores)[o] = score;
  ((T*)a.hi)[o] = (TRACK && !LOCAL) ? st.hi : score;
  ((T*)a.lo)[o] = (TRACK && !LOCAL) ? st.lo : (T)0;
}

#ifdef __CUDACC__

template <typename T, bool LOCAL, bool TRACK>
__global__ void __launch_bounds__(LANES) interseq_kernel(Args a) {
  constexpr int S = Traits<T>::strip;
  __shared__ T prof[S * ALPHA];
  const int p = blockIdx.y;
  const int b = blockIdx.x * LANES + threadIdx.x;
  const int q = a.iq[p];
  const int c = a.ic[p];
  const int mr = a.m_reals[q];
  const int rows = LOCAL ? a.m : mr;
  const bool lane_ok = b < a.B;
  const int len = lane_ok ? a.lengths[(size_t)c * a.B + b] : 0;
  const T Q = (T)a.gap_q, R = (T)a.gap_r;
  LaneState<T> st = lane_init<T>(mr, Q, R);
  const int8_t* col = a.codes + (size_t)c * a.n_pad * a.B + b;
  T* scrH = nullptr;
  T* scrF = nullptr;
  if (rows > S) {
    scrH = (T*)a.scratch + (size_t)p * 2 * a.n_pad * a.B + b;
    scrF = scrH + (size_t)a.n_pad * a.B;
  }
  const int32_t* qprof = a.profiles + (size_t)q * a.m * ALPHA;
  for (int r0 = 0; r0 < rows; r0 += S) {
    __syncthreads();
    for (int k = threadIdx.x; k < S * ALPHA; k += LANES) {
      const int row = r0 + k / ALPHA;
      prof[k] = row < a.m ? (T)qprof[(size_t)row * ALPHA + k % ALPHA] : (T)0;
    }
    __syncthreads();
    if (len > 0)
      strip<T, S, LOCAL, TRACK>(prof, col, scrH, scrF, a.B, len, r0, rows, mr,
                                Q, R, st);
  }
  if (lane_ok) lane_finish<T, LOCAL, TRACK>(a, (size_t)p * a.B + b, st);
}

template <typename T, bool LOCAL, bool TRACK>
static void launch(const Args& a, cudaStream_t stream) {
  dim3 grid((a.B + LANES - 1) / LANES, a.P);
  interseq_kernel<T, LOCAL, TRACK><<<grid, LANES, 0, stream>>>(a);
}

#else  // host build of the same strip routine, for tests without a GPU

template <typename T, bool LOCAL, bool TRACK>
static void launch(const Args& a, void*) {
  constexpr int S = Traits<T>::strip;
  std::vector<T> prof(S * ALPHA);
  std::vector<LaneState<T>> st(a.B);
  for (int p = 0; p < a.P; ++p) {
    const int q = a.iq[p], c = a.ic[p], mr = a.m_reals[q];
    const int rows = LOCAL ? a.m : mr;
    const T Q = (T)a.gap_q, R = (T)a.gap_r;
    for (int b = 0; b < a.B; ++b) st[b] = lane_init<T>(mr, Q, R);
    const int32_t* qprof = a.profiles + (size_t)q * a.m * ALPHA;
    for (int r0 = 0; r0 < rows; r0 += S) {
      for (int k = 0; k < S * ALPHA; ++k) {
        const int row = r0 + k / ALPHA;
        prof[k] = row < a.m ? (T)qprof[(size_t)row * ALPHA + k % ALPHA] : (T)0;
      }
      for (int b = 0; b < a.B; ++b) {
        const int len = a.lengths[(size_t)c * a.B + b];
        if (len == 0) continue;
        T* scrH = nullptr;
        T* scrF = nullptr;
        if (rows > S) {
          scrH = (T*)a.scratch + (size_t)p * 2 * a.n_pad * a.B + b;
          scrF = scrH + (size_t)a.n_pad * a.B;
        }
        strip<T, S, LOCAL, TRACK>(prof.data(),
                                  a.codes + (size_t)c * a.n_pad * a.B + b,
                                  scrH, scrF, a.B, len, r0, rows, mr, Q, R,
                                  st[b]);
      }
    }
    for (int b = 0; b < a.B; ++b)
      lane_finish<T, LOCAL, TRACK>(a, (size_t)p * a.B + b, st[b]);
  }
}

#endif

template <typename Stream>
static void dispatch(const Args& a, int local, int track, int wide,
                     Stream stream) {
  if (wide) {
    if (local)
      track ? launch<int64_t, true, true>(a, stream)
            : launch<int64_t, true, false>(a, stream);
    else
      track ? launch<int64_t, false, true>(a, stream)
            : launch<int64_t, false, false>(a, stream);
  } else {
    if (local)
      track ? launch<int32_t, true, true>(a, stream)
            : launch<int32_t, true, false>(a, stream);
    else
      track ? launch<int32_t, false, true>(a, stream)
            : launch<int32_t, false, false>(a, stream);
  }
}

static Args make_args(const void* profiles, int m, const void* codes,
                      const void* lengths, int n_pad, int B, const void* iq,
                      const void* ic, const void* m_reals, int P,
                      long long gap_q, long long gap_r, void* scores, void* hi,
                      void* lo, void* scratch) {
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
  a.scores = scores;
  a.hi = hi;
  a.lo = lo;
  a.scratch = scratch;
  return a;
}

}  // namespace k1

extern "C" {

// Query rows per strip: the scratch is needed only above this many rows.
int k1_strip_rows(int wide) {
  return wide ? k1::Traits<int64_t>::strip : k1::Traits<int32_t>::strip;
}

#ifdef __CUDACC__
// Enqueue K1 on `stream` over P pairs; returns cudaGetLastError().
int k1_interseq(const void* profiles, int m, const void* codes,
                const void* lengths, int n_pad, int B, const void* iq,
                const void* ic, const void* m_reals, int P, long long gap_q,
                long long gap_r, int local, int track, int wide, void* scores,
                void* hi, void* lo, void* scratch, void* stream) {
  k1::Args a = k1::make_args(profiles, m, codes, lengths, n_pad, B, iq, ic,
                             m_reals, P, gap_q, gap_r, scores, hi, lo,
                             scratch);
  k1::dispatch(a, local, track, wide, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
#else
// The same computation on the host, lane by lane; returns 0.
int k1_interseq_host(const void* profiles, int m, const void* codes,
                     const void* lengths, int n_pad, int B, const void* iq,
                     const void* ic, const void* m_reals, int P,
                     long long gap_q, long long gap_r, int local, int track,
                     int wide, void* scores, void* hi, void* lo,
                     void* scratch) {
  k1::Args a = k1::make_args(profiles, m, codes, lengths, n_pad, B, iq, ic,
                             m_reals, P, gap_q, gap_r, scores, hi, lo,
                             scratch);
  k1::dispatch(a, local, track, wide, (void*)nullptr);
  return 0;
}
#endif

}  // extern "C"
