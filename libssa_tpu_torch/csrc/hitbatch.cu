// The tracebacks of a search's top-k hits, solved together on the card.
//
// Replaces no TPU kernel: the JAX package fills each hit's DP on the host
// (libssa_tpu/search/aligner.py: fill_matrices, then oracle._traceback_from),
// one hit after another. The port did the same until those fills became the
// largest block of a single query's latency: ten hits of about 361 x 361
// cells take about 120 ms of NumPy rows and a Python walk, while the card,
// which found the hits, waits. One launch takes every hit of a call (the
// wrapper is ops/hit_cuda.py) and writes each hit's score, coordinates and
// ops; the host fetches them in one copy.
//
// Semantics are exactly aligner.align_pair's below aligner.MATRIX_CELL_LIMIT
// (score form, gap(L) = Q + R (L - 1)): H = max(H[i-1][j-1] + sub, E, F),
// floored at 0 for SW, E[i][j] = max(E[i][j-1] - R, H[i][j-1] - Q) and F
// the same down a column (fill_matrices' prefix-max E gives these values);
// H on row 0 and column 0 is 0 for SW and -(Q + (k-1) R) for NW, E and F
// start unopened. A cell's direction byte holds the walk's decisions, not
// its values: bits 0-1 H's source (0 the diagonal, 1 F, 2 E, 3 the local
// stop at H == 0, tested first), bit 2 F == H[i-1][j] - Q (F closes), bit 3
// E == H[i][j-1] - Q (E closes), so a tie prefers the diagonal, then F,
// then E, and a gap's walk closes as soon as it can, as _traceback_from
// does. The SW end cell is H.argmax() in row-major order: the highest H,
// then the smallest row, then the smallest column; a hit whose every cell
// is 0 ends at (0, 0) with no ops. NW ends at (m, n) and walks the edges
// as D (column 0) and I (row 0).
//
// What bounds it on this card: a hit is one small DP, and only the cells of
// one anti-diagonal are independent, so its fill is a chain of steps, each
// a short chain of dependent integer operations and shuffles: latency, not
// the issue rate or device memory, sets its time. Its bytes are few: one
// direction byte a cell written once and read once by the walk (about 5.9
// MB for ten hits of 767 x 767, which stay in the 50 MB L2), the codes
// read once.
//
// The design (csrc/leafbatch.cu's, which a Myers-Miller pass's leaves run;
// this file keeps its own copy because the two differ in every cell: min-cost
// against max-score form, the leaves' boundary opens against the local floor
// and the argmax end cell):
//  * One warp (one block) a hit; hits run side by side on the SMs.
//  * A stripe is 32 consecutive rows, lane t holds row r0 + t + 1, and at
//    step k lane t computes column j = k - t + 1 (the anti-diagonal
//    wavefront). Lane t takes H and F of the cell above from lane t-1's
//    previous step by __shfl_up_sync and keeps the one before as the
//    diagonal; E and the left H stay in its registers.
//  * Between stripes, the rows' H and F go through a global carry row of
//    n + 1 entries a hit: lane 31 stores its row in place, and lane 0 of the
//    next stripe reads it, 32 columns a chunk, a chunk ahead, loaded by all
//    32 lanes at once and passed to lane 0 by __shfl_sync. Lane 31 writes
//    column x at step x + 30, after every load of it (at most at step
//    x - 33); a __syncwarp at each chunk orders the two.
//  * Each lane keeps its row's substitution scores in a profile in shared
//    memory ([symbol][lane]: every lane reads its own bank), rebuilt a stripe.
//  * A lane gathers its last 8 direction bytes in a 64-bit register and
//    stores them at once (row-major, each row padded to 8 bytes).
//  * SW: each lane keeps its row's highest H and the first column reaching
//    it; a butterfly of shuffles at each stripe's end takes the highest,
//    then the earliest row, and a stripe replaces the running end cell only
//    with a strictly higher H. NW: the score is the lane of row m's last H.
//  * After a __syncwarp, lane 0 walks the hit back, writes its ops from the
//    end of the hit's slot, so they come out in order, and its six header
//    words.
//  * Templated on the DP type (int32 where the wrapper's bound shows that no
//    value of the launch's hits can overflow, else int64) and on SW or NW.
//
// The cell update, the lane's step, the chunk loads and the walk are
// __host__ __device__, and a host C++ compiler builds the whole file
// (hb_hit_batch_host below runs each hit's stripes step by step, the 32
// lanes in the lock-step of a warp, passing values between lanes as the
// shuffles do), so the recurrence, the skew, the carry, the end cell and
// the walk are tested on a machine with no GPU.
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define HB_HD __host__ __device__ __forceinline__
#else
#include <vector>
#define HB_HD inline
#endif

namespace hb {

constexpr int ALPHA = 32;   // padded alphabet
constexpr int WARP = 32;    // lanes (rows) a stripe
constexpr int PACK = 8;     // direction bytes a lane stores at once
constexpr int HEADER = 6;   // int64 words a hit: score, q_begin, q_end, s_begin, s_end, ops

// One hit, as the wrapper lays out its table: seven 64-bit words.
struct Hit {
  int64_t q_off, m;   // query window into the code buffer, m >= 1
  int64_t s_off, n;   // subject window, n >= 1
  int64_t dir_off;    // bytes: m rows of dir_stride(n) direction bytes
  int64_t carry_off;  // elements of T: H and F rows, n + 1 each
  int64_t ops_off;    // bytes into the ops region: a slot of m + n
};
static_assert(sizeof(Hit) == 7 * 8, "the wrapper writes 7 words a hit");

struct Args {
  const uint8_t* codes;  // query and subject codes, < ALPHA
  const Hit* hits;
  int64_t count;         // hits
  const int32_t* sub;    // (ALPHA, ALPHA) substitution scores
  int64_t Q, R;          // gap open (the first residue's cost), extend
  uint8_t* dir;          // direction bytes, scratch
  void* carry;           // of T, scratch
  int64_t* out;          // (count, HEADER) words, then the ops region
};

HB_HD int64_t dir_stride(int64_t n) { return (n + PACK - 1) / PACK * PACK; }

// The unopened E and F: below every value of a hit by more than R.
template <typename T> HB_HD T neg() { return -((T)1 << (sizeof(T) * 8 - 4)); }

template <typename T> HB_HD T max2(T a, T b) { return a < b ? b : a; }

// H on row 0 or column 0 at index k.
template <typename T, bool LOCAL>
HB_HD T edge(int k, T Q, T R) {
  return (LOCAL || k == 0) ? (T)0 : -(Q + R * (T)(k - 1));
}

// Where one hit's data lie.
template <typename T>
struct View {
  const uint8_t* q;
  const uint8_t* s;
  uint8_t* dir;
  T* ch;  // H of the carry row, columns 0 .. n
  T* cf;  // F of the carry row
  int64_t* hdr;
  uint8_t* slot_end;
};

template <typename T>
HB_HD View<T> view(const Args& a, const Hit& f, int64_t b) {
  View<T> v;
  v.q = a.codes + f.q_off;
  v.s = a.codes + f.s_off;
  v.dir = a.dir + f.dir_off;
  v.ch = (T*)a.carry + f.carry_off;
  v.cf = v.ch + f.n + 1;
  v.hdr = a.out + HEADER * b;
  v.slot_end = (uint8_t*)(a.out + HEADER * a.count) + f.ops_off + f.m + f.n;
  return v;
}

// One cell of the fill: H, E and F of (i, j) from H[i-1][j-1], H and F of
// (i-1, j), H and E of (i, j-1) and the score w. Returns the direction byte.
template <typename T, bool LOCAL>
HB_HD uint32_t cell(T h_diag, T h_up, T f_up, T h_left, T e_left, T w, T Q, T R, T& h,
                    T& f, T& e) {
  const T open_f = h_up - Q;
  const T fv = max2<T>(f_up - R, open_f);
  const T open_e = h_left - Q;
  const T ev = max2<T>(e_left - R, open_e);
  const T cand = h_diag + w;
  T hv = max2<T>(cand, max2<T>(fv, ev));
  if (LOCAL) hv = max2<T>(hv, (T)0);
  const uint32_t src = (LOCAL && hv == 0) ? 3u : (hv == cand) ? 0u : (hv == fv) ? 1u : 2u;
  h = hv;
  f = fv;
  e = ev;
  return src | ((uint32_t)(fv == open_f) << 2) | ((uint32_t)(ev == open_e) << 3);
}

// Row 0 at column j: H[0][j] and F unopened.
template <typename T, bool LOCAL>
HB_HD void init_top(const View<T>& v, int j, T Q, T R) {
  v.ch[j] = edge<T, LOCAL>(j, Q, R);
  v.cf[j] = neg<T>();
}

// Lane t's column of the shared profile, for its row's query code.
HB_HD void fill_profile(int32_t* prof, const int32_t* sub, int code, int t) {
  for (int c = 0; c < ALPHA; ++c) prof[c * WARP + t] = sub[code * ALPHA + c];
}

// A hit's sizes and gaps as the fill uses them (the wrapper keeps m + n
// below 2**31).
template <typename T>
struct Dims {
  int m, n;
  T Q, R;
};

template <typename T>
struct Lane {
  int i;         // 1-based row; past m where the lane has none
  T diag;        // H[i-1][j-1]: the next cell's diagonal
  T left, e;     // H and E of the lane's last cell, (i, j-1)
  T f;           // F of the lane's last cell, for lane t + 1
  T w;           // the score of the lane's next cell
  T best;        // SW: the row's highest H so far (0: none above 0)
  int bj;        // and the first column reaching it
  uint64_t buf;  // the lane's last direction bytes, newest highest
  uint8_t* row;  // the lane's row of direction bytes
};

// Lane t at the start of the stripe holding row i: the left boundary
// H[i][0], above it H[i-1][0], and E unopened.
template <typename T, bool LOCAL>
HB_HD Lane<T> lane_start(const Hit& f, const View<T>& v, const int32_t* prof, int t, int i,
                         const Dims<T>& z) {
  Lane<T> L;
  L.i = i;
  L.diag = edge<T, LOCAL>(i - 1, z.Q, z.R);
  L.left = edge<T, LOCAL>(i, z.Q, z.R);
  L.e = neg<T>();
  L.f = 0;
  L.w = i <= f.m ? (T)prof[v.s[0] * WARP + t] : (T)0;
  L.best = 0;
  L.bj = 0;
  L.buf = 0;
  L.row = v.dir + (int64_t)(i - 1) * dir_stride(f.n);
  return L;
}

HB_HD void store8(uint8_t* p, uint64_t x) {
#ifdef __CUDA_ARCH__
  *(uint64_t*)p = x;
#else
  memcpy(p, &x, 8);
#endif
}

// Lane t at step k: the cell (i, k - t + 1), with H and F of the cell above
// it (up_h, up_f). GUARD: the cell may lie outside the hit (the stripe's
// first and last WARP - 1 steps, or a stripe with rows past m); without it
// every lane's cell lies inside.
template <bool GUARD, bool LOCAL, typename T>
HB_HD void lane_step(Lane<T>& L, int t, int k, T up_h, T up_f, const Dims<T>& z,
                     const View<T>& v, const int32_t* prof) {
  const int j = k - t + 1;
  if (GUARD && (L.i > z.m || j < 1 || j > z.n)) return;
  const T w = L.w;
  if (j < z.n) L.w = (T)prof[v.s[j] * WARP + t];  // the next column's, off the chain
  T h, f, e;
  const uint32_t b = cell<T, LOCAL>(L.diag, up_h, up_f, L.left, L.e, w, z.Q, z.R, h, f, e);
  L.diag = up_h;
  L.left = h;
  L.e = e;
  L.f = f;
  if (LOCAL && h > L.best) {
    L.best = h;
    L.bj = j;
  }
  L.buf = (L.buf >> 8) | ((uint64_t)b << 56);
  const int r = j & (PACK - 1);
  if (j == z.n && r) L.buf >>= 8 * (PACK - r);  // the row's last bytes to the bottom
  if (r == 0 || j == z.n) store8(L.row + ((j - 1) & ~(PACK - 1)), L.buf);
  if (t == WARP - 1 && L.i < z.m) {  // a stripe follows: it reads this row
    v.ch[j] = h;
    v.cf[j] = f;
  }
}

// The stripe's steps: [0, WARP - 1) and [n, n + WARP - 1) guarded, and
// between them unguarded where every lane has a row.
HB_HD int steady_end(int r0, int m, int n) { return r0 + WARP <= m ? n : 0; }

// H and F of the carry row at column `col`, where it lies in the hit.
template <typename T>
HB_HD void load_chunk(const View<T>& v, int n, int col, T& h, T& f) {
  if (col <= n) {
    h = v.ch[col];
    f = v.cf[col];
  }
}

// The SW end cell so far (score, row, column) and a stripe's candidate:
// the candidate wins with a higher score, or an equal one in an earlier
// row (within a stripe; across stripes the running cell keeps ties).
template <typename T>
struct End {
  T score;
  int i, j;
};

template <typename T>
HB_HD bool better(const End<T>& a, const End<T>& b) {
  return a.score > b.score || (a.score == b.score && a.i < b.i);
}

// The walk back from the end cell (ei, ej) in state H, as _traceback_from;
// writes the ops backwards from v.slot_end and the hit's header.
template <typename T, bool LOCAL>
HB_HD void walk(const Hit& f, const View<T>& v, int64_t ei, int64_t ej, T score) {
  const int64_t stride = dir_stride(f.n);
  uint8_t* end = v.slot_end;
  int64_t i = ei, j = ej, pos = 0;
  int state = 0;  // 0 = H, 1 = F (a gap in the subject), 2 = E (in the query)
  while (i > 0 || j > 0) {
    if (state == 0) {
      if (i == 0 || j == 0) {  // an edge: SW stops, NW walks it
        if (LOCAL) break;
        if (j == 0) {
          end[-1 - pos++] = 'D';
          --i;
        } else {
          end[-1 - pos++] = 'I';
          --j;
        }
        continue;
      }
      const uint32_t src = v.dir[(i - 1) * stride + (j - 1)] & 3;
      if (src == 3) break;
      if (src == 0) {
        end[-1 - pos++] = 'M';
        --i;
        --j;
      } else {
        state = (int)src;
      }
    } else if (state == 1) {
      const uint32_t b = v.dir[(i - 1) * stride + (j - 1)];
      end[-1 - pos++] = 'D';
      --i;
      if ((b >> 2) & 1) state = 0;
    } else {
      const uint32_t b = v.dir[(i - 1) * stride + (j - 1)];
      end[-1 - pos++] = 'I';
      --j;
      if ((b >> 3) & 1) state = 0;
    }
  }
  v.hdr[0] = (int64_t)score;
  v.hdr[1] = i;
  v.hdr[2] = ei;
  v.hdr[3] = j;
  v.hdr[4] = ej;
  v.hdr[5] = pos;
}

#ifdef __CUDACC__

constexpr unsigned FULL = 0xffffffffu;

// One step of lane t's warp: every 32 steps the next chunk of the carry row,
// then the shuffles, then the lane's cell.
template <bool GUARD, bool LOCAL, typename T>
__device__ __forceinline__ void warp_step(Lane<T>& L, int t, int k, T& cur_h, T& cur_f,
                                          T& nxt_h, T& nxt_f, const Dims<T>& z,
                                          const View<T>& v, const int32_t* prof) {
  if (k && (k & (WARP - 1)) == 0) {
    __syncwarp();
    cur_h = nxt_h;
    cur_f = nxt_f;
    load_chunk(v, z.n, k + 1 + WARP + t, nxt_h, nxt_f);
  }
  T up_h = __shfl_up_sync(FULL, L.left, 1);
  T up_f = __shfl_up_sync(FULL, L.f, 1);
  const T top_h = __shfl_sync(FULL, cur_h, k & (WARP - 1));
  const T top_f = __shfl_sync(FULL, cur_f, k & (WARP - 1));
  if (t == 0) {
    up_h = top_h;
    up_f = top_f;
  }
  lane_step<GUARD, LOCAL>(L, t, k, up_h, up_f, z, v, prof);
}

template <typename T, bool LOCAL>
__global__ void __launch_bounds__(WARP) hit_kernel(Args a) {
  __shared__ int32_t prof[ALPHA * WARP];
  const Hit f = a.hits[blockIdx.x];
  const View<T> v = view<T>(a, f, blockIdx.x);
  const int t = threadIdx.x;
  const Dims<T> z{(int)f.m, (int)f.n, (T)a.Q, (T)a.R};
  for (int j = t; j <= z.n; j += WARP) init_top<T, LOCAL>(v, j, z.Q, z.R);
  __syncwarp();
  End<T> run{(T)0, 0, 0};
  T last = 0;
  for (int r0 = 0; r0 < z.m; r0 += WARP) {
    const int i = r0 + t + 1;
    fill_profile(prof, a.sub, i <= z.m ? v.q[i - 1] : 0, t);
    Lane<T> L = lane_start<T, LOCAL>(f, v, prof, t, i, z);
    T cur_h = 0, cur_f = 0, nxt_h = 0, nxt_f = 0;
    load_chunk(v, z.n, 1 + t, cur_h, cur_f);
    load_chunk(v, z.n, 1 + WARP + t, nxt_h, nxt_f);
    const int steps = z.n + WARP - 1, mid = steady_end(r0, z.m, z.n);
    int k = 0;
    for (; k < WARP - 1; ++k)
      warp_step<true, LOCAL>(L, t, k, cur_h, cur_f, nxt_h, nxt_f, z, v, prof);
    for (; k < mid; ++k)
      warp_step<false, LOCAL>(L, t, k, cur_h, cur_f, nxt_h, nxt_f, z, v, prof);
    for (; k < steps; ++k)
      warp_step<true, LOCAL>(L, t, k, cur_h, cur_f, nxt_h, nxt_f, z, v, prof);
    __syncwarp();
    if (LOCAL) {
      End<T> c{L.best, L.i, L.bj};
      for (int off = WARP / 2; off; off >>= 1) {
        const End<T> o{__shfl_xor_sync(FULL, c.score, off), __shfl_xor_sync(FULL, c.i, off),
                       __shfl_xor_sync(FULL, c.j, off)};
        if (better(o, c)) c = o;
      }
      if (c.score > run.score) run = c;
    } else {
      last = __shfl_sync(FULL, L.left, (z.m - 1) & (WARP - 1));
    }
  }
  __syncwarp();
  if (t == 0) {
    if (LOCAL)
      walk<T, LOCAL>(f, v, run.i, run.j, run.score);
    else
      walk<T, LOCAL>(f, v, f.m, f.n, last);
  }
}

template <typename T, bool LOCAL>
static int launch(const Args& a, cudaStream_t stream) {
  hit_kernel<T, LOCAL><<<(unsigned)a.count, WARP, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
static int attrs(int* out) {
  cudaFuncAttributes fa;
  const int rc = (int)cudaFuncGetAttributes(&fa, (const void*)hit_kernel<T, true>);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  return rc;
}

#else  // host build: hits in turn, each stripe's steps in order, lanes in lock-step

template <typename T, bool LOCAL>
static void hit_host(const Args& a, int64_t b) {
  const Hit f = a.hits[b];
  const View<T> v = view<T>(a, f, b);
  const Dims<T> z{(int)f.m, (int)f.n, (T)a.Q, (T)a.R};
  std::vector<int32_t> prof(ALPHA * WARP);
  for (int j = 0; j <= z.n; ++j) init_top<T, LOCAL>(v, j, z.Q, z.R);
  End<T> run{(T)0, 0, 0};
  T last = 0;
  for (int r0 = 0; r0 < z.m; r0 += WARP) {
    Lane<T> L[WARP];
    T cur_h[WARP] = {}, cur_f[WARP] = {}, nxt_h[WARP] = {}, nxt_f[WARP] = {};
    for (int t = 0; t < WARP; ++t) {
      const int i = r0 + t + 1;
      fill_profile(prof.data(), a.sub, i <= z.m ? v.q[i - 1] : 0, t);
      L[t] = lane_start<T, LOCAL>(f, v, prof.data(), t, i, z);
      load_chunk(v, z.n, 1 + t, cur_h[t], cur_f[t]);
      load_chunk(v, z.n, 1 + WARP + t, nxt_h[t], nxt_f[t]);
    }
    const int steps = z.n + WARP - 1, mid = steady_end(r0, z.m, z.n);
    for (int k = 0; k < steps; ++k) {
      if (k && (k & (WARP - 1)) == 0) {
        for (int t = 0; t < WARP; ++t) {
          cur_h[t] = nxt_h[t];
          cur_f[t] = nxt_f[t];
          load_chunk(v, z.n, k + 1 + WARP + t, nxt_h[t], nxt_f[t]);
        }
      }
      T up_h[WARP], up_f[WARP];  // every lane's shuffles, before any lane steps
      for (int t = 0; t < WARP; ++t) {
        up_h[t] = t ? L[t - 1].left : cur_h[k & (WARP - 1)];
        up_f[t] = t ? L[t - 1].f : cur_f[k & (WARP - 1)];
      }
      const bool guard = k < WARP - 1 || k >= mid;
      for (int t = 0; t < WARP; ++t) {
        if (guard)
          lane_step<true, LOCAL>(L[t], t, k, up_h[t], up_f[t], z, v, prof.data());
        else
          lane_step<false, LOCAL>(L[t], t, k, up_h[t], up_f[t], z, v, prof.data());
      }
    }
    if (LOCAL) {  // the butterfly's result: the best lane, ties to the earliest row
      End<T> c{L[0].best, L[0].i, L[0].bj};
      for (int t = 1; t < WARP; ++t) {
        const End<T> o{L[t].best, L[t].i, L[t].bj};
        if (better(o, c)) c = o;
      }
      if (c.score > run.score) run = c;
    } else {
      last = L[(z.m - 1) & (WARP - 1)].left;
    }
  }
  if (LOCAL)
    walk<T, LOCAL>(f, v, run.i, run.j, run.score);
  else
    walk<T, LOCAL>(f, v, f.m, f.n, last);
}

#endif

}  // namespace hb

extern "C" {

// 64-bit words a hit in the table the caller builds, and a hit's header.
int hb_hit_words() { return (int)(sizeof(hb::Hit) / 8); }
int hb_header_words() { return hb::HEADER; }

// Direction bytes a row of a hit of n columns.
long long hb_dir_stride(long long n) { return (long long)hb::dir_stride(n); }

#ifdef __CUDACC__
// Enqueue the hits on `stream`, one warp each. Returns cudaGetLastError(),
// or -1 for no hits.
int hb_hit_batch(const void* codes, const void* hits, long long count, const void* sub,
                 long long Q, long long R, void* dir, void* carry, void* out, int wide,
                 int local, void* stream) {
  if (count < 1) return -1;
  const hb::Args a{(const uint8_t*)codes, (const hb::Hit*)hits, count, (const int32_t*)sub,
                   Q, R, (uint8_t*)dir, carry, (int64_t*)out};
  cudaStream_t s = (cudaStream_t)stream;
  if (wide) return local ? hb::launch<int64_t, true>(a, s) : hb::launch<int64_t, false>(a, s);
  return local ? hb::launch<int32_t, true>(a, s) : hb::launch<int32_t, false>(a, s);
}

// out: registers and local bytes a thread of the int32 or int64 SW kernel.
int hb_attrs(int wide, int* out) {
  return wide ? hb::attrs<int64_t>(out) : hb::attrs<int32_t>(out);
}
#else
// The same computation on the host; returns 0, or -1 for no hits.
int hb_hit_batch_host(const void* codes, const void* hits, long long count, const void* sub,
                      long long Q, long long R, void* dir, void* carry, void* out, int wide,
                      int local) {
  if (count < 1) return -1;
  const hb::Args a{(const uint8_t*)codes, (const hb::Hit*)hits, count, (const int32_t*)sub,
                   Q, R, (uint8_t*)dir, carry, (int64_t*)out};
  for (long long b = 0; b < count; ++b) {
    if (wide)
      local ? hb::hit_host<int64_t, true>(a, b) : hb::hit_host<int64_t, false>(a, b);
    else
      local ? hb::hit_host<int32_t, true>(a, b) : hb::hit_host<int32_t, false>(a, b);
  }
  return 0;
}
#endif

}  // extern "C"
