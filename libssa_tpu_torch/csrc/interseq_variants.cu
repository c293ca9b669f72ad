// K1's lazy-F design variants for Hopper: the counterparts of the TPU probes
// experiments/f_scan_probe.py (build, :176), v6_probe.py (build, :111),
// v7_probe.py (build, :88), v8_probe.py (build, :91) and
// r2_kernel_golf.py (build_var, :142).
//
// Each probe computes K1's own function, SW only: the scores of one query
// (an (m, 32) profile) against B subjects, and differs from the others only
// in how the vertical gap F runs down the query axis. This file keeps K1's
// layout (csrc/interseq.cu): one thread per subject lane, 128 lanes a
// block, the strip's profile rows in shared memory as [row][symbol], the
// query in strips of S rows whose H and E live in registers, a strip-edge
// scratch of H and F per column laid out (2, n_pad, B), a lane stopping at
// its own length. Only the column step changes, by template parameter:
//
//  * F, how F is computed:
//    - SEQ: K1's chain, h = max(diag + s, e, f, 0); f = max(f - R, h - Q):
//      4 dependent operations a row. The baseline inside this harness.
//    - SCAN: Hnof = max(diag + s, e, 0) for all S rows (independent across
//      rows), then D, a max-plus Hillis-Steele scan over the S registers with
//      -d R folded into pass d, for the passes d = 1, 2, 4, ... < S that the
//      bitmask PASSES names; F[j] = max(D[j-1] - Q, carry - j R) and
//      H = max(Hnof, F). NARROW: pass d touches rows >= d only (v7's
//      narrowing slices); else every row, with a NEG add below d (the TPU's
//      masked roll, v0/v1). The NEG is a kernel argument, so nvcc cannot
//      fold the masked rows away.
//    - CHUNK: rows in chunks of CH, D confined to a chunk (a scan, or a
//      serial max chain with SERIAL), an exact carry between chunks:
//      carry = max(D[CH-1] - Q, carry - CH R) (v8, golf; the JAX kernel's
//      libssa_tpu/ops/interseq_pallas.py:212).
//    - TWOLEVEL: confined 8-row scans (or serial chains), an exclusive scan
//      of the 8-row block maxima across the strip, the combine (v2, v4, v4s).
//    - NONE: H = Hnof, no F at all (v3): wrong by design, timed only.
//  * A_HNOF: the running max reads Hnof, not H (golf's a8nof). Exact for SW:
//    every F[j] <= (the column's max H above j) - Q, so a column's max of H
//    is a max of Hnof.
//  * A_ROWS: 1 running-max register, or 8 independent ones (golf's a8).
//  * UNROLL: columns a loop trip (golf's u4, fw4, a8nof4).
//  * IL: independent subjects a thread, interleaved (v6's IL lane groups):
//    a block covers IL x 128 lanes.
//  * T: v6's T-batched gather. With T = 8 the codes are laid out
//    (n_pad / 8, B, 8): a lane loads the codes of 8 columns in one 8-byte
//    load, then steps those 8 columns (a profile row of 8 columns held in
//    registers ahead of time would take 8 S registers).
//  * LO: v6's running min of H, written as lo.
//
// Every row of a strip is computed: rows past m read a profile score of
// NEG, so with every |H| below 2^30 (the wrapper checks) they stay below the
// strip's real rows and never raise the running max; no row guard a cell.
// The strip-edge carry is K1's: a strip's F for the next strip's row 0,
// max(D[S-1] - Q, carry - S R), equals K1's scrF, and diag for row 0 comes
// from the scratch H. Lazy F is exact only where Q >= R (the wrapper checks).
//
// What bounds it on this card: integer issue and the dependent chains. K1
// carries F as one scalar down its 32 rows (4 dependent operations a row);
// a scan makes Hnof independent across rows and leaves log2 S passes of 1
// DPX max a row, at the price of more registers (Hnof and D beside H and E)
// and more operations a cell. Which trade wins is what these variants
// measure. Timed-only cuts (passes missing) still feed every pass they run
// into the output, so nvcc cannot drop them.
//
// The column step and the strip routine are __host__ __device__: without
// __CUDACC__ the file exposes k1v_run_host, so a host C++ compiler builds
// every instantiation for tests without a GPU. K1V_PART=n builds only the
// instantiations of part n (the list below), so the variants build as
// several libraries in parallel.
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define K1V_HD __host__ __device__ __forceinline__
#else
#include <vector>
#define K1V_HD inline
#endif

#ifndef K1V_PART
#define K1V_PART -1  // every part (the host build)
#endif

namespace k1v {

constexpr int ALPHA = 32;   // padded alphabet: one profile row per query row
constexpr int LANES = 128;  // threads a block
constexpr int32_t NEG = -(1 << 30);

enum { SEQ = 0, SCAN = 1, CHUNK = 2, TWOLEVEL = 3, NONE = 4 };

// One row of the list: (index, part, S, F, PASSES, NARROW, CH, SERIAL,
// A_HNOF, A_ROWS, UNROLL, IL, T, LO). libssa_tpu_torch/experiments/
// _interseq_variants.py holds the same list (INSTANCES), checked by
// k1v_describe in the tests.
#define K1V_VARIANTS(X)                                  \
  X(0, 0, 32, SEQ, 0, 0, 0, 0, 0, 1, 1, 1, 1, 0)         \
  X(1, 0, 32, SCAN, 31, 0, 0, 0, 0, 1, 1, 1, 1, 0)       \
  X(2, 0, 32, TWOLEVEL, 0, 0, 0, 0, 0, 1, 1, 1, 1, 0)    \
  X(3, 0, 32, TWOLEVEL, 0, 0, 0, 1, 0, 1, 1, 1, 1, 0)    \
  X(4, 0, 32, NONE, 0, 0, 0, 0, 0, 1, 1, 1, 1, 0)        \
  X(5, 0, 32, SCAN, 0, 0, 0, 0, 0, 1, 1, 1, 1, 0)        \
  X(6, 0, 32, SCAN, 1, 0, 0, 0, 0, 1, 1, 1, 1, 0)        \
  X(7, 0, 32, SCAN, 3, 0, 0, 0, 0, 1, 1, 1, 1, 0)        \
  X(8, 0, 32, SCAN, 15, 0, 0, 0, 0, 1, 1, 1, 1, 0)       \
  X(9, 0, 32, SCAN, 7, 0, 0, 0, 0, 1, 1, 1, 1, 0)        \
  X(10, 0, 32, SCAN, 24, 0, 0, 0, 0, 1, 1, 1, 1, 0)      \
  X(11, 0, 32, SCAN, 8, 0, 0, 0, 0, 1, 1, 1, 1, 0)       \
  X(12, 1, 32, SCAN, 31, 0, 0, 0, 0, 1, 1, 1, 8, 0)      \
  X(13, 1, 32, SCAN, 31, 0, 0, 0, 0, 1, 1, 1, 1, 1)      \
  X(14, 1, 32, SCAN, 31, 0, 0, 0, 0, 1, 1, 1, 8, 1)      \
  X(15, 2, 32, SCAN, 31, 0, 0, 0, 0, 1, 1, 2, 1, 0)      \
  X(16, 2, 32, SCAN, 31, 0, 0, 0, 0, 1, 1, 2, 8, 0)      \
  X(17, 3, 32, SCAN, 31, 0, 0, 0, 0, 1, 1, 2, 1, 1)      \
  X(18, 3, 32, SCAN, 31, 0, 0, 0, 0, 1, 1, 2, 8, 1)      \
  X(19, 1, 32, SCAN, 31, 1, 0, 0, 0, 1, 1, 1, 1, 0)      \
  X(20, 4, 32, CHUNK, 0, 0, 8, 0, 0, 1, 1, 1, 1, 0)      \
  X(21, 4, 32, CHUNK, 0, 0, 16, 0, 0, 1, 1, 1, 1, 0)     \
  X(22, 4, 32, CHUNK, 0, 0, 32, 0, 0, 1, 1, 1, 1, 0)     \
  X(23, 4, 32, CHUNK, 0, 0, 8, 0, 0, 1, 4, 1, 1, 0)      \
  X(24, 4, 32, CHUNK, 0, 0, 8, 0, 1, 1, 2, 1, 1, 0)      \
  X(25, 4, 32, CHUNK, 0, 0, 8, 0, 1, 1, 4, 1, 1, 0)      \
  X(26, 4, 32, CHUNK, 0, 0, 8, 0, 0, 8, 2, 1, 1, 0)      \
  X(27, 4, 32, CHUNK, 0, 0, 8, 0, 1, 8, 2, 1, 1, 0)      \
  X(28, 4, 32, CHUNK, 0, 0, 8, 0, 1, 8, 4, 1, 1, 0)

#define K1V_COUNT_ONE(...) +1
constexpr int COUNT = 0 K1V_VARIANTS(K1V_COUNT_ONE);
constexpr int FIELDS = 13;  // every field of a row but its index

template <int S_, int F_, int PASSES_, int NARROW_, int CH_, int SERIAL_,
          int A_HNOF_, int A_ROWS_, int UNROLL_, int IL_, int T_, int LO_>
struct Cfg {
  static constexpr int S = S_, F = F_, PASSES = PASSES_, CH = CH_;
  static constexpr int A_ROWS = A_ROWS_, IL = IL_, T = T_;
  static constexpr bool NARROW = NARROW_, SERIAL = SERIAL_, A_HNOF = A_HNOF_,
                        LO = LO_;
  // Columns a trip of the main loop: a T-group holds T columns.
  static constexpr int U = UNROLL_ > T_ ? UNROLL_ : T_;
  static_assert(S % 8 == 0 && (F != CHUNK || (CH >= 2 && S % CH == 0)),
                "strip and chunk sizes");
  static_assert(A_ROWS == 1 || A_ROWS == 8, "A_ROWS is 1 or 8");
  static_assert((T == 1 || T == 8) && (IL == 1 || IL == 2), "T, IL");
  static_assert(U % T == 0 && U <= 8, "UNROLL with T = 8 is 8");
};

template <typename T> K1V_HD T mx(T a, T b) { return a > b ? a : b; }
template <typename T> K1V_HD T mn(T a, T b) { return a < b ? a : b; }

struct Args {
  const int32_t* profile;  // (m, ALPHA)
  int m;
  const int8_t* codes;     // (n_pad, B), or (n_pad / 8, B, 8) with T = 8
  const int32_t* lengths;  // (B,)
  int n_pad, B;
  int32_t Q, R, neg;
  int32_t* scores;         // (B,)
  int32_t* hi;
  int32_t* lo;
  int32_t* scratch;        // (2, n_pad, B); unused when m <= S
};

// One subject lane's state across its strips.
template <class V> struct Lane {
  int32_t H[V::S], E[V::S];
  int32_t acc[V::A_ROWS];
  int32_t lo;
  int32_t diag_top, h_next, f_next;
  int c;        // T == 1: the code of the next column to step
  uint64_t c8;  // T == 8: the codes of the next group of 8 columns
  const int8_t* col;
  int32_t* scrH;
  int32_t* scrF;
  int len;
};

template <class V>
K1V_HD void take(Lane<V>& L, int s, int32_t hnof, int32_t h) {
  int32_t& a = L.acc[s % V::A_ROWS];
  a = mx(a, V::A_HNOF ? hnof : h);
  if (V::LO) L.lo = mn(L.lo, h);
}

// Passes d = 1, 2, 4, ... < BLK named by PASSES, confined to blocks of BLK
// rows: D[s] = max(D[s], D[s - d] - d R) for s % BLK >= d. Descending s, so
// D[s - d] is still the previous pass's value.
template <int S, int BLK, int PASSES>
K1V_HD void confined_scan(int32_t* D, int32_t R) {
#pragma unroll
  for (int d = 1; d < BLK; d *= 2) {
    if (!(PASSES & d)) continue;
    const int32_t dR = d * R;
#pragma unroll
    for (int s = S - 1; s >= 0; --s)
      if (s % BLK >= d) D[s] = mx(D[s], D[s - d] - dR);
  }
}

// The same passes over the whole strip in the TPU's masked form: rows below
// d take max(D[s], neg - d R).
template <int S, int PASSES>
K1V_HD void masked_scan(int32_t* D, int32_t R, int32_t neg) {
#pragma unroll
  for (int d = 1; d < S; d *= 2) {
    if (!(PASSES & d)) continue;
    const int32_t dR = d * R;
#pragma unroll
    for (int s = S - 1; s >= 0; --s)
      D[s] = mx(D[s], (s >= d ? D[s - d] : neg) - dR);
  }
}

// A serial max chain confined to blocks of BLK rows.
template <int S, int BLK>
K1V_HD void serial_scan(int32_t* D, int32_t R) {
#pragma unroll
  for (int s = 0; s < S; ++s)
    if (s % BLK) D[s] = mx(D[s - 1] - R, D[s]);
}

// F from D and the carry into rows j0 .. j0 + N - 1 (j0 a constant once the
// callers' loops unroll), H and the running max; returns the F entering
// row j0 + N.
template <class V, int N>
K1V_HD int32_t apply_f(Lane<V>& L, const int32_t* Hn, const int32_t* D,
                       int32_t carry, int32_t Q, int32_t R, int j0) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int s = j0 + j;
    const int32_t f = j == 0 ? carry : mx(D[s - 1] - Q, carry - j * R);
    const int32_t h = mx(Hn[s], f);
    L.H[s] = h;
    take(L, s, Hn[s], h);
  }
  return mx(D[j0 + N - 1] - Q, carry - N * R);
}

// One column of the strip: H, E and the running max updated; returns the F
// entering the next strip's row 0 (0 for NONE).
template <class V>
K1V_HD int32_t cells(Lane<V>& L, const int32_t* pc, int32_t diag,
                     int32_t carry, int32_t Q, int32_t R, int32_t neg) {
  constexpr int S = V::S;
  if constexpr (V::F == SEQ) {
    int32_t f = carry;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int32_t e = mx(L.E[s] - R, L.H[s] - Q);
      const int32_t h = mx(mx(mx(diag + pc[s * ALPHA], e), f), 0);
      diag = L.H[s];
      L.H[s] = h;
      L.E[s] = e;
      take(L, s, h, h);
      f = mx(f - R, h - Q);
    }
    return f;
  } else {
    int32_t Hn[S], D[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int32_t e = mx(L.E[s] - R, L.H[s] - Q);
      Hn[s] = mx(mx(diag + pc[s * ALPHA], e), 0);
      diag = L.H[s];
      L.E[s] = e;
      D[s] = Hn[s];
    }
    if constexpr (V::F == NONE) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        L.H[s] = Hn[s];
        take(L, s, Hn[s], Hn[s]);
      }
      return 0;
    } else if constexpr (V::F == SCAN) {
      if constexpr (V::NARROW)
        confined_scan<S, S, V::PASSES>(D, R);
      else
        masked_scan<S, V::PASSES>(D, R, neg);
      return apply_f<V, S>(L, Hn, D, carry, Q, R, 0);
    } else if constexpr (V::F == CHUNK) {
      if constexpr (V::SERIAL)
        serial_scan<S, V::CH>(D, R);
      else
        confined_scan<S, V::CH, V::CH - 1>(D, R);
      int32_t c = carry;
#pragma unroll
      for (int k = 0; k < S / V::CH; ++k)
        c = apply_f<V, V::CH>(L, Hn, D, c, Q, R, k * V::CH);
      return c;
    } else {  // TWOLEVEL
      constexpr int NB = S / 8;
      if constexpr (V::SERIAL)
        serial_scan<S, 8>(D, R);
      else
        confined_scan<S, 8, 7>(D, R);
      // P[b]: the decayed max at row 8 b - 1 of every row above block b.
      int32_t P[NB];
      P[0] = neg;
#pragma unroll
      for (int b = 1; b < NB; ++b) P[b] = D[8 * b - 1];
#pragma unroll
      for (int d = 1; d < NB; d *= 2) {
#pragma unroll
        for (int b = NB - 1; b >= d; --b) P[b] = mx(P[b], P[b - d] - 8 * d * R);
      }
#pragma unroll
      for (int b = 1; b < NB; ++b) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          D[8 * b + j] = mx(D[8 * b + j], P[b] - (j + 1) * R);
      }
      return apply_f<V, S>(L, Hn, D, carry, Q, R, 0);
    }
  }
}


// One column t of one lane: the scratch of column t + 1 prefetched, the
// cells stepped, this strip's last row and F out to the scratch.
template <class V>
K1V_HD void column(Lane<V>& L, const int32_t* prof, int c, int t, bool first,
                   bool last, int B, int32_t Q, int32_t R, int32_t neg) {
  // H[r0][t + 1] and F[r0 + 1][t + 1]: 0 and -Q above the first strip.
  const int32_t htop = L.h_next, carry = L.f_next;
  if (!first && t + 1 < L.len) {
    const size_t o = (size_t)(t + 1) * B;
    L.h_next = L.scrH[o];
    if (V::F != NONE) L.f_next = L.scrF[o];
  }
  const int32_t diag = L.diag_top;
  L.diag_top = htop;
  const int32_t f_out = cells<V>(L, prof + c, diag, carry, Q, R, neg);
  if (!last) {
    const size_t o = (size_t)t * B;
    L.scrH[o] = L.H[V::S - 1];
    if (V::F != NONE) L.scrF[o] = f_out;
  }
}

// The 8 codes of group g of a lane's T = 8 layout.
template <class V> K1V_HD uint64_t codes8(const Lane<V>& L, int g, int B) {
  return *(const uint64_t*)(L.col + (size_t)g * B * 8);
}

// Rows r0 + 1 .. r0 + S (1-based) of the IL lanes of one thread, each over
// its own columns: U columns a trip while every lane has them, then each
// lane's remaining columns alone.
template <class V>
K1V_HD void strip(Lane<V>* L, const int32_t* prof, int B, int r0, int m,
                  int32_t Q, int32_t R, int32_t neg) {
  constexpr int S = V::S, IL = V::IL, U = V::U;
  const bool first = r0 == 0, last = r0 + S >= m;
  int common = L[0].len;
#pragma unroll
  for (int k = 0; k < IL; ++k) {
    common = mn(common, L[k].len);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      L[k].H[s] = 0;
      L[k].E[s] = NEG;
    }
    L[k].diag_top = 0;
    L[k].h_next = 0;
    L[k].f_next = -Q;
    if (L[k].len > 0) {
      if (V::T == 8)
        L[k].c8 = codes8(L[k], 0, B);
      else
        L[k].c = L[k].col[0];
      if (!first) {
        L[k].h_next = L[k].scrH[0];
        if (V::F != NONE) L[k].f_next = L[k].scrF[0];
      }
    }
  }
  int t = 0;
#pragma unroll 1
  for (; t + U <= common; t += U) {
    uint64_t w[IL];
#pragma unroll
    for (int k = 0; k < IL; ++k) {
      w[k] = L[k].c8;
      if (V::T == 8 && t + 8 < L[k].len) L[k].c8 = codes8(L[k], (t >> 3) + 1, B);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int k = 0; k < IL; ++k) {
        int c;
        if (V::T == 8) {
          c = (int)((w[k] >> (8 * (u & 7))) & 0xff);
        } else {
          c = L[k].c;
          if (t + u + 1 < L[k].len) L[k].c = L[k].col[(size_t)(t + u + 1) * B];
        }
        column<V>(L[k], prof, c, t + u, first, last, B, Q, R, neg);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < IL; ++k) {
#pragma unroll 1
    for (int tt = t; tt < L[k].len; ++tt) {
      int c;
      if (V::T == 8) {
        c = L[k].col[(size_t)(tt >> 3) * B * 8 + (tt & 7)];
      } else {
        c = L[k].c;
        if (tt + 1 < L[k].len) L[k].c = L[k].col[(size_t)(tt + 1) * B];
      }
      column<V>(L[k], prof, c, tt, first, last, B, Q, R, neg);
    }
  }
}

template <class V> K1V_HD void lane_init(Lane<V>& L, const Args& a, int b) {
  L.len = b < a.B ? a.lengths[b] : 0;
  L.col = a.codes + (size_t)b * V::T;  // T = 8: (n_pad / 8, B, 8)
  L.scrH = L.scrF = nullptr;
  if (a.m > V::S) {
    L.scrH = a.scratch + b;
    L.scrF = L.scrH + (size_t)a.n_pad * a.B;
  }
#pragma unroll
  for (int i = 0; i < V::A_ROWS; ++i) L.acc[i] = 0;
  L.lo = 0;
  L.c = 0;
  L.c8 = 0;
}

template <class V> K1V_HD void lane_finish(const Lane<V>& L, const Args& a, int b) {
  if (b >= a.B) return;
  int32_t best = L.acc[0];
#pragma unroll
  for (int i = 1; i < V::A_ROWS; ++i) best = mx(best, L.acc[i]);
  a.scores[b] = best;
  a.hi[b] = best;
  a.lo[b] = V::LO ? L.lo : 0;
}

// The strip's profile rows, [row][symbol]; rows past m score NEG.
K1V_HD int32_t prof_entry(const Args& a, int r0, int k) {
  const int row = r0 + k / ALPHA;
  return row < a.m ? a.profile[(size_t)row * ALPHA + k % ALPHA] : NEG;
}

#ifdef __CUDACC__

template <class V>
__global__ void __launch_bounds__(LANES) k1v_kernel(Args a) {
  __shared__ int32_t prof[V::S * ALPHA];
  Lane<V> L[V::IL];
  const int b0 = blockIdx.x * LANES * V::IL + threadIdx.x;
#pragma unroll
  for (int k = 0; k < V::IL; ++k) lane_init<V>(L[k], a, b0 + k * LANES);
  for (int r0 = 0; r0 < a.m; r0 += V::S) {
    __syncthreads();
    for (int k = threadIdx.x; k < V::S * ALPHA; k += LANES) prof[k] = prof_entry(a, r0, k);
    __syncthreads();
    strip<V>(L, prof, a.B, r0, a.m, a.Q, a.R, a.neg);
  }
#pragma unroll
  for (int k = 0; k < V::IL; ++k) lane_finish<V>(L[k], a, b0 + k * LANES);
}

template <class V> static int launch(const Args& a, cudaStream_t stream) {
  const int per_block = LANES * V::IL;
  k1v_kernel<V><<<(a.B + per_block - 1) / per_block, LANES, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <class V> static int attrs(int* out) {
  cudaFuncAttributes fa;
  const int rc = (int)cudaFuncGetAttributes(&fa, k1v_kernel<V>);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  return rc;
}

#else  // host build of the same strip routine, for tests without a GPU

template <class V> static int launch(const Args& a, void*) {
  std::vector<int32_t> prof(V::S * ALPHA);
  const int per_block = LANES * V::IL;
  for (int base = 0; base < a.B; base += per_block) {
    for (int tid = 0; tid < LANES; ++tid) {
      Lane<V> L[V::IL];
      for (int k = 0; k < V::IL; ++k) lane_init<V>(L[k], a, base + tid + k * LANES);
      for (int r0 = 0; r0 < a.m; r0 += V::S) {
        for (int k = 0; k < V::S * ALPHA; ++k) prof[k] = prof_entry(a, r0, k);
        strip<V>(L, prof.data(), a.B, r0, a.m, a.Q, a.R, a.neg);
      }
      for (int k = 0; k < V::IL; ++k) lane_finish<V>(L[k], a, base + tid + k * LANES);
    }
  }
  return 0;
}

#endif

constexpr bool in_part(int part) { return K1V_PART < 0 || part == K1V_PART; }

template <int PART, class V, typename Stream>
int launch_in_part(const Args& a, Stream stream) {
  if constexpr (in_part(PART))
    return launch<V>(a, stream);
  else
    return -1;
}

#define K1V_CFG(S, F, P, N, CH, SE, AH, AR, U, IL, T, LO) \
  Cfg<S, F, P, N, CH, SE, AH, AR, U, IL, T, LO>

template <typename Stream>
int run(int idx, const Args& a, Stream stream) {
  switch (idx) {
#define K1V_RUN_CASE(idx, part, ...) \
  case idx:                          \
    return launch_in_part<part, K1V_CFG(__VA_ARGS__)>(a, stream);
    K1V_VARIANTS(K1V_RUN_CASE)
#undef K1V_RUN_CASE
    default:
      return -1;
  }
}

constexpr int ROWS[][FIELDS + 1] = {
#define K1V_ROW(...) {__VA_ARGS__},
    K1V_VARIANTS(K1V_ROW)
#undef K1V_ROW
};

#ifdef __CUDACC__
template <int PART, class V> int attrs_in_part(int* out) {
  if constexpr (in_part(PART))
    return attrs<V>(out);
  else
    return -1;
}

int attrs_of(int idx, int* out) {
  switch (idx) {
#define K1V_ATTR_CASE(idx, part, ...) \
  case idx:                           \
    return attrs_in_part<part, K1V_CFG(__VA_ARGS__)>(out);
    K1V_VARIANTS(K1V_ATTR_CASE)
#undef K1V_ATTR_CASE
    default:
      return -1;
  }
}
#endif

static Args make_args(const void* profile, int m, const void* codes,
                      const void* lengths, int n_pad, int B, int Q, int R,
                      void* scores, void* hi, void* lo, void* scratch) {
  Args a;
  a.profile = (const int32_t*)profile;
  a.m = m;
  a.codes = (const int8_t*)codes;
  a.lengths = (const int32_t*)lengths;
  a.n_pad = n_pad;
  a.B = B;
  a.Q = Q;
  a.R = R;
  a.neg = NEG;
  a.scores = (int32_t*)scores;
  a.hi = (int32_t*)hi;
  a.lo = (int32_t*)lo;
  a.scratch = (int32_t*)scratch;
  return a;
}

}  // namespace k1v

extern "C" {

// The number of instantiations in the list, in every part.
int k1v_count() { return k1v::COUNT; }

// The fields of instantiation idx (its list row but the index) into
// out[0 .. 12]; returns 0, or -1 for no such index.
int k1v_describe(int idx, int* out) {
  if (idx < 0 || idx >= k1v::COUNT) return -1;
  for (int i = 0; i < k1v::FIELDS; ++i) out[i] = k1v::ROWS[idx][i + 1];
  return 0;
}

#ifdef __CUDACC__
// Enqueue instantiation idx on `stream`; returns cudaGetLastError(), or -1
// where this library's part does not hold idx.
int k1v_run(int idx, const void* profile, int m, const void* codes,
            const void* lengths, int n_pad, int B, int Q, int R, void* scores,
            void* hi, void* lo, void* scratch, void* stream) {
  const k1v::Args a = k1v::make_args(profile, m, codes, lengths, n_pad, B, Q, R,
                                     scores, hi, lo, scratch);
  return k1v::run(idx, a, (cudaStream_t)stream);
}

// ptxas's registers a thread and local (spill) bytes of instantiation idx
// into out[0], out[1]; returns the CUDA error, or -1 as k1v_run.
int k1v_attrs(int idx, int* out) { return k1v::attrs_of(idx, out); }
#else
// The same computation on the host, lane by lane; returns 0, or -1 for no
// such index.
int k1v_run_host(int idx, const void* profile, int m, const void* codes,
                 const void* lengths, int n_pad, int B, int Q, int R,
                 void* scores, void* hi, void* lo, void* scratch) {
  const k1v::Args a = k1v::make_args(profile, m, codes, lengths, n_pad, B, Q, R,
                                     scores, hi, lo, scratch);
  return k1v::run(idx, a, (void*)nullptr);
}
#endif

}  // extern "C"
