// K3: the SW / NW score of one whole (possibly genome-scale) pair, for Hopper.
//
// Replaces libssa_tpu/ops/longpair_pallas.py::_kernel (the Pallas TPU kernel
// built by _build and called through longpair_score_pallas). It computes what
// libssa_tpu/ops/longpair.py::longpair_score returns: for query codes q (m)
// and subject codes s (n), m, n >= 1, Gotoh affine gaps (Q >= R >= 0) and a
// 32x32 substitution matrix, the SW max of H over all cells floored at 0, or
// the NW cell H[m][n] under the boundaries H[i][0] = -(Q + (i-1) R),
// H[0][j] = -(Q + (j-1) R), H[0][0] = 0. Exact in int32 or int64; the
// wrapper picks int64 where the a-priori bound on |H| reaches 2**31 - 1.
//
// What bounds it on this card: one pair has little parallelism. Only the
// cells of one anti-diagonal are independent, so the stripes of the pair
// form one chain, and a warp's step is a chain of dependent integer
// operations and shuffles that one warp issues in order: the step's
// instruction count and latencies, and the pipeline's fill (each stripe
// starts some steps behind the one above), not the card's issue rate or
// memory, set the time. Device memory sees one H/F pair per column at each
// group edge. The earlier design (one warp a block, polling and publishing
// its own stripe edge through global memory, one step a loop trip with a
// column guard, a first-stripe branch and the profile read on its path)
// spent 55-57% of its time at 16,384^2 on the edge; this one is K2's design
// (csrc/ring_block.cu) cut down to one pair, with one change: no compute
// warp touches global memory in its step. Where the last compute warp stored
// the group edge itself, as K2's does, K3 took 1.2-1.35x as long on an H100
// (the segment barrier appears to wait on that warp's outstanding global
// stores), so the writer warp moves that row to global memory (PERF.md).
//
// The design:
//  * Thread b of a warp owns CH consecutive query rows, with their H and E in
//    registers; at step t it computes its CH cells of column j = t - b. F runs
//    down the CH rows as one scalar. Band b gets band b-1's bottom H, leaving
//    F and the column's subject code by __shfl_up_sync.
//  * A warp is a stripe of 32*CH rows. A block holds W compute warps
//    (1 .. MAX_WARPS) on W consecutive stripes, a group: compute warp w of
//    group g owns stripe g*W + w. A warp whose stripe lies past the query
//    (only in the last group) computes nothing but meets every barrier.
//    Beside them the block has two helper warps, a reader and a writer, that
//    take every global-memory wait and fence off the compute warps' path.
//  * Compute warp w reads its top row from ring w in shared memory, EDGE
//    columns of H and F (edge_get): ring 0 holds the group's top row, which
//    the reader fills; ring w > 0 holds warp w-1's bottom row, which lane 31
//    of warp w-1 writes (edge_put); ring W holds the last warp's bottom row,
//    which the writer copies out. The block keeps a lockstep by segments:
//    one barrier every SEG steps of the block's clock, and compute warp w
//    runs LAG steps behind warp w-1. Lane 31 writes column c at its warp's
//    step c + 31, and the next warp loads the segment [t, t + SEG) right
//    after the barrier at its own step t: with LAG >= SEG + 31 every column
//    of it was written before that barrier. Until the next barrier the
//    writer reaches column t + LAG + SEG - 32, so a ring of EDGE > LAG + SEG
//    - 32 columns is never overwritten unread. The schedule bounds the
//    writer's lead exactly, so the rings need no flag back from their
//    readers, no poll and no fence.
//  * Group 0's top row is closed-form, and its reader writes it into ring 0:
//    H[0][j+1] = -(Q + j R) in NW, 0 in SW, and F entering row 1 = H - Q. So
//    the compute warps have no first-stripe branch, and group 0 polls
//    nothing and reads no global row.
//  * A segment's SEG steps are unrolled, and in the steady part of a stripe
//    (every lane's column inside the pair) they carry no column guard; the
//    SW running max tests a row against m only in the warp whose stripe
//    holds row m-1 (TAIL). Each lane takes its next column's code from
//    lane-1 a step early and reads that column's profile entries then, off
//    the step's path; each compute warp loads the next segment's subject
//    codes a segment ahead.
//  * Between blocks: every CHUNK steps the writer warp copies the columns
//    of ring W written before the barrier to the group's global ring slot
//    g mod RING, fences (each lane its own stores, then __syncwarp) and
//    publishes their count with a release store; the rest after the final
//    barrier. Ring W outlasts it: between two copies lane 31 writes at most
//    CHUNK + SEG columns. The reader warp of group g+1 polls that count with
//    acquire loads and, from the barrier at each multiple of CHUNK, copies
//    the top row's next CHUNK columns, from SEG on, from the global ring into
//    ring 0, a segment before compute warp 0 reads them. RING >= 2
//    suffices: group g+2's writer stores slot g mod RING at column j only
//    after its last warp, and so its warp 0, computed column j, which needs
//    group g+1's last warp past column j (through group g+1's publish and
//    group g+2's reader), which needs group g+1's warp 0 past column j,
//    whose reader had copied column j out of slot g mod RING before.
//  * Groups are taken in ticket order (atomicAdd on a counter zeroed per
//    launch), not by blockIdx: a running block only ever waits on one that
//    started before it, so no block order can deadlock.
//  * SW: a running max per lane (real rows only), a warp reduce and one
//    atomicMax a warp. NW: the lane owning row m-1 writes its H after the
//    last column.
//  * Shared memory is dynamic, sized per launch: each compute warp's
//    profile, CH x 32 symbols x 32 lanes of int32 ([row][symbol][lane]: every
//    lane reads its own bank), then the W + 1 rings.
//  * Templated on the score type (int32, int64), on CH (4, 8) and on local;
//    W is a launch argument.
//
// The per-lane column update, the schedule and the shared-ring handoff are
// __host__ __device__, and a host C++ compiler builds the whole file
// (k3_longpair_host below runs the groups in ticket order and, in each, the
// segments of the block's clock: the reader, the writer's count, then the
// compute warps one by one, the 32 lanes of a warp in lock-step as a warp
// runs them; it checks that every handoff, the writer's copies included,
// reads a column written before the segment's barrier), so the
// recurrence, boundaries, skew and schedule are tested on a machine with no
// GPU.
//
// Stage switches for timing probes (libssa_tpu_torch/experiments/
// r3_banded_bisect.py, the counterpart of experiments/r3_banded_bisect.py).
// All are off by default, and the default build is the production K3. A
// build with any of them on gives wrong scores and is timed only; every one
// terminates, since no poll is left waiting on a count a cut stopped
// publishing:
//   K3_PROBE_NO_WAIT     no poll on the group above (the reader warp copies
//                        whatever the global ring holds);
//   K3_PROBE_NO_PUBLISH  the above, and no fence or progress release store
//                        (the writer warp);
//   K3_PROBE_NO_EDGE     the above, and no group-edge stores to the global
//                        ring (the writer warp's copies);
//   K3_PROBE_NO_PROFILE  a constant substitution row, no shared-memory read;
//   K3_PROBE_NO_SHUFFLE  no boundary shuffles: a lane takes its own values;
//   K3_PROBE_STEADY      no column guard in any segment (a compute warp
//                        writes only shared rings, whose slots wrap, so
//                        nothing writes out of bounds).
#if defined(K3_PROBE_NO_EDGE) && !defined(K3_PROBE_NO_PUBLISH)
#define K3_PROBE_NO_PUBLISH
#endif
#if defined(K3_PROBE_NO_PUBLISH) && !defined(K3_PROBE_NO_WAIT)
#define K3_PROBE_NO_WAIT
#endif
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <type_traits>
#define K3_HD __host__ __device__ __forceinline__
#else
#include <algorithm>
#include <vector>
#define K3_HD inline
#endif

namespace k3 {

constexpr int ALPHA = 32;         // padded alphabet
constexpr int WARP = 32;          // lanes (bands) per stripe
constexpr int SEG = 8;            // steps between the lockstep's barriers
constexpr int LAG = 5 * SEG;      // steps compute warp w runs behind warp w-1
constexpr int CHUNK = 32;         // top-row columns the reader copies, and the
                                  // writer publishes, at once
constexpr int EDGE = 128;         // columns of a shared ring
constexpr int RING = 2;           // group-edge row buffers, in global memory
constexpr int MAX_WARPS = 8;      // compute warps (stripes) a block
constexpr int HELPERS = 2;        // and its reader and writer warps
constexpr int MAX_SMEM = 232448;  // dynamic shared bytes a block may have
constexpr long long WAIT_LIMIT_CYCLES = 40LL * 1000 * 1000 * 1000;  // ~20 s
static_assert(LAG % SEG == 0 && LAG >= SEG + WARP - 1,
              "a segment's columns are written a barrier before they are read");
static_assert(CHUNK % SEG == 0 && EDGE >= 3 * CHUNK && EDGE > LAG + SEG - WARP &&
              (EDGE & (EDGE - 1)) == 0, "a ring outlasts its readers");

template <typename T> K3_HD T mx(T a, T b) { return a > b ? a : b; }

struct Args {
  const uint8_t* q;       // (m,) query codes, < ALPHA
  int64_t m;
  const uint8_t* s;       // (n,) subject codes, < ALPHA
  int n;
  const int32_t* matrix;  // (ALPHA, ALPHA)
  int64_t gap_q, gap_r;
  int64_t stripes;        // ceil(m / (WARP * CH))
  int warps;              // W: stripes (compute warps) a block
  void* bufH;             // (RING, n) of T: group-edge H rows
  void* bufF;             // (RING, n) of T: group-edge F rows
  int* progress;          // (groups,) columns published; zero at launch
  int* ticket;            // group counter; zero at launch
  void* result;           // (1,) of T; zero at launch
};

// Dynamic shared bytes of a block: W profiles, then W + 1 rings of H and F.
K3_HD size_t smem_bytes(int W, int ch, size_t item) {
  return (size_t)W * ch * ALPHA * WARP * sizeof(int32_t) + (size_t)(W + 1) * 2 * EDGE * item;
}

// Where compute warp `warp` of the block on group g stands.
struct Stripe {
  int64_t ks;      // the stripe
  bool active;     // the stripe lies in the query
  bool feed;       // a stripe below reads its bottom row
  int warps;       // active compute warps of the block: its clock runs for them
};

K3_HD Stripe stripe_of(const Args& a, int64_t g, int warp) {
  const int W = a.warps;
  Stripe S;
  S.ks = g * W + warp;
  S.active = S.ks < a.stripes;
  S.feed = S.ks + 1 < a.stripes;
  const int64_t left = a.stripes - g * W;
  S.warps = (int)(left < W ? left : W);
  return S;
}

// Group g's row of the global ring (plane 0: H, 1: F), slot g mod RING: its
// last compute warp stores it, group g+1's reader copies it.
template <typename T> K3_HD T* group_row(const Args& a, int64_t g, int plane) {
  return (T*)(plane ? a.bufF : a.bufH) + (size_t)(g % RING) * a.n;
}

// Steps of the block's clock: its last active warp's, LAG per warp behind.
K3_HD int block_steps(int warps, int n) { return LAG * (warps - 1) + n + WARP - 1; }

// Columns of compute warp W-1's bottom row stored before the barrier at the
// block's clock clk (lane 31 stores column j at clock j + 31 + LAG*(W-1)):
// what the writer publishes there.
K3_HD int stored_before(int clk, int W, int n) {
  const int c = clk - (WARP - 1) - LAG * (W - 1);
  return c < 0 ? 0 : c < n ? c : n;
}

// Group 0's top row at column col: H[0][col+1] and the F entering row 1.
template <typename T, bool LOCAL> K3_HD void top_row(int col, T Q, T R, T& h, T& f) {
  h = LOCAL ? (T)0 : -(Q + (T)col * R);
  f = h - Q;
}

// A shared ring, written by edge_put and read by edge_get: H at [slot], F at
// [EDGE + slot], slot = column mod EDGE.
template <typename T> K3_HD void edge_put(T* edge, int col, T h, T f) {
  edge[col & (EDGE - 1)] = h;
  edge[EDGE + (col & (EDGE - 1))] = f;
}

template <typename T> K3_HD void edge_get(const T* edge, int col, T& h, T& f) {
  h = edge[col & (EDGE - 1)];
  f = edge[EDGE + (col & (EDGE - 1))];
}

// One band: CH query rows r0 .. r0+CH-1 (0-based).
template <typename T, int CH> struct Lane {
  T H[CH], E[CH];  // H and E of the band's rows at the last column done
  T diag_top;      // H of the row above the band, one column to the left
  T best;          // SW: max H over the band's real rows
  int64_t r0;
};

template <typename T, int CH, bool LOCAL>
K3_HD void lane_init(Lane<T, CH>& L, int64_t r0, T Q, T R) {
  L.r0 = r0;
  for (int s = 0; s < CH; ++s) {
    L.H[s] = LOCAL ? (T)0 : -(Q + (T)(r0 + s) * R);  // H[r0+s+1][0]
    L.E[s] = L.H[s] - Q + R;  // so that E[.][1] comes out as H[.][0] - Q
  }
  L.diag_top = (LOCAL || r0 == 0) ? (T)0 : -(Q + (T)(r0 - 1) * R);  // H[r0][0]
  L.best = 0;
}

// One column of the band. htop: H of the row above at this column; f: F
// entering the band's first row; pc[s]: sub(q[r0+s], column code). TAIL: the
// band may hold rows past m, which the SW max must skip. Returns the F
// leaving the band's last row; its H is L.H[CH-1].
template <typename T, int CH, bool LOCAL, bool TAIL>
K3_HD T lane_column(Lane<T, CH>& L, const int32_t* pc, T htop, T f, int64_t m, T Q, T R) {
  T diag = L.diag_top;
  L.diag_top = htop;
#pragma unroll
  for (int s = 0; s < CH; ++s) {
    const T e = mx(L.E[s] - R, L.H[s] - Q);
#ifdef K3_PROBE_NO_PROFILE
    T h = mx(mx(diag + (T)(s - 2), e), f);  // a constant substitution row
#else
    T h = mx(mx(diag + (T)pc[s], e), f);
#endif
    if (LOCAL) h = mx(h, (T)0);
    diag = L.H[s];
    L.H[s] = h;
    L.E[s] = e;
    if (LOCAL && (!TAIL || L.r0 + s < m)) L.best = mx(L.best, h);
    f = mx(f - R, h - Q);
  }
  return f;
}

// NW: the band holding row m-1 writes its H (call after column n-1).
template <typename T, int CH>
K3_HD void lane_capture(const Lane<T, CH>& L, int64_t m, T* out) {
  if (L.r0 <= m - 1 && m - 1 < L.r0 + CH) {
#pragma unroll
    for (int s = 0; s < CH; ++s)
      if (L.r0 + s == m - 1) *out = L.H[s];
  }
}

template <int CH>
K3_HD void load_profile(int32_t* prof, const Args& a, int64_t r0, int lane) {
  for (int s = 0; s < CH; ++s) {
    const int64_t row = r0 + s;
    const int qc = row < a.m ? a.q[row] : ALPHA - 1;
    for (int c = 0; c < ALPHA; ++c)
      prof[(s * ALPHA + c) * WARP + lane] = a.matrix[qc * ALPHA + c];
  }
}

// A lane's profile entries for the column of code c: sub(q[r0+s], c).
template <int CH>
K3_HD void profile_row(int32_t* pc, const int32_t* prof, int c, int lane) {
#pragma unroll
  for (int s = 0; s < CH; ++s) {
#ifdef K3_PROBE_NO_PROFILE
    pc[s] = 0;
#else
    pc[s] = prof[(s * ALPHA + c) * WARP + lane];
#endif
  }
}

#ifdef __CUDACC__

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ void atomic_max(int32_t* p, int32_t v) { atomicMax(p, v); }
__device__ __forceinline__ void atomic_max(int64_t* p, int64_t v) {
  atomicMax((long long*)p, (long long)v);
}

// The block-wide barrier, met by compute and helper warps at their own call
// sites.
__device__ __forceinline__ void block_sync() { asm volatile("bar.sync 0;" ::: "memory"); }

// The reader warp: ring 0 gets the group's top row, CHUNK columns at a time,
// a segment before compute warp 0 reads them: closed-form for group 0, else
// from the previous group's global ring once its writer has published them.
template <typename T, bool LOCAL>
__device__ void reader(const Args& a, int64_t g, T* top, int clocks) {
  const int lane = threadIdx.x % WARP, n = a.n;
  const T Q = (T)a.gap_q, R = (T)a.gap_r;
  const bool first = g == 0;
  const T* srcH = first ? nullptr : group_row<T>(a, g - 1, 0);
  const T* srcF = first ? nullptr : group_row<T>(a, g - 1, 1);
  const int* above = a.progress + (first ? 0 : g - 1);
  int seen = 0;  // the count last read from `above`
  auto fill = [&](int c0, int c1) {  // columns [c0, c1) of the top row, c1 - c0 <= WARP
    const int col = c0 + lane;
    if (first) {
      T h, f;
      top_row<T, LOCAL>(col, Q, R, h, f);
      if (col < c1 && col < n) edge_put(top, col, h, f);
      return;
    }
#ifndef K3_PROBE_NO_WAIT
    const int need = min(c1, n);
    if (seen < need) {
      const long long t0 = clock64();
      while ((seen = ld_acquire(above)) < need) {
        __nanosleep(32);
        // The group above started before this one and publishes every
        // CHUNK steps: a wait of seconds is a fault. Fail the launch rather
        // than hang the card.
        if (clock64() - t0 > WAIT_LIMIT_CYCLES) __trap();
      }
    }
#endif
    if (col < c1 && col < n) edge_put(top, col, srcH[col], srcF[col]);
  };
  fill(0, SEG);
  for (int clk = 0; clk < clocks; clk += SEG) {
    block_sync();
    // Read by compute warp 0 from the barrier at clk + SEG on.
    if (clk % CHUNK == 0 && clk + SEG < n) fill(clk + SEG, clk + SEG + CHUNK);
  }
  block_sync();
}

// The writer warp: at every CHUNK steps' barrier, the last compute warp's
// bottom-row columns stored in ring W before it go to the global ring, and
// their count is fenced and released for the next group's reader; the rest
// after the final barrier. The compute warps never wait on global memory.
template <typename T>
__device__ void writer(const Args& a, int64_t g, bool feeds, const T* edge, int clocks) {
  const int lane = threadIdx.x % WARP, W = a.warps, n = a.n;
  T* outH = group_row<T>(a, g, 0);
  T* outF = group_row<T>(a, g, 1);
  int done = 0;
  auto flush = [&](int c) {  // columns [done, c), then publish c
#ifndef K3_PROBE_NO_EDGE
    for (int col = done + lane; col < c; col += WARP) {
      T h, f;
      edge_get(edge, col, h, f);
      outH[col] = h;
      outF[col] = f;
    }
#endif
#ifndef K3_PROBE_NO_PUBLISH
    __threadfence();
    __syncwarp();
    if (lane == 0) st_release(a.progress + g, c);
#endif
    done = c;
  };
  for (int clk = 0; clk < clocks; clk += SEG) {
    block_sync();
    if (feeds && clk % CHUNK == 0) {
      const int c = stored_before(clk, W, n);
      if (c > done) flush(c);
    }
  }
  block_sync();
  if (feeds && done < n) flush(n);
}

// Compute warp `warp` of the block on group g.
template <typename T, int CH, bool LOCAL>
__device__ void compute(const Args& a, int64_t g, int warp, unsigned char* smem, T* rings,
                        int clocks) {
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x % WARP, n = a.n;
  const Stripe S = stripe_of(a, g, warp);
  const int64_t r0 = (S.ks * WARP + lane) * CH;
  int32_t* prof = (int32_t*)smem + (size_t)warp * CH * ALPHA * WARP;
  const T* ring_in = rings + (size_t)warp * 2 * EDGE;
  T* ring_out = rings + (size_t)(warp + 1) * 2 * EDGE;  // ring W: the writer's

  const T Q = (T)a.gap_q, R = (T)a.gap_r;
  const int64_t m = a.m;
  Lane<T, CH> L;
  int nS = 0;  // lanes < SEG: the code of a column of the next segment
  if (S.active) {
    load_profile<CH>(prof, a, r0, lane);
    lane_init<T, CH, LOCAL>(L, r0, Q, R);
    if (lane < SEG && lane < n) nS = a.s[lane];
  }
  __syncwarp();

  T hb = 0, fb = 0;  // the last column's bottom H and leaving F
  T chH = 0, chF = 0;
  int chS = 0;       // lanes < SEG: a column of the current segment
  int cur = 0;       // the code of this lane's column at this step
  int32_t pc[CH];    // its profile entries, loaded a step ahead
  const int steps = n + WARP - 1;

  // Step t, the u-th of its segment. GUARD: some lane's column may lie
  // outside the pair; TAIL: the stripe may hold rows past m.
  auto step = [&](const int t, const int u, auto guard, auto tail) {
    constexpr bool GUARD = decltype(guard)::value, TAIL = decltype(tail)::value;
    const int j = t - lane;
    // Column j's top boundary from lane-1's step t-1; the code of column j+1,
    // this lane's next, is lane-1's now.
#ifdef K3_PROBE_NO_SHUFFLE
    T htop = hb, f = fb;
    int nxt = cur;
#else
    T htop = __shfl_up_sync(FULL, hb, 1);
    T f = __shfl_up_sync(FULL, fb, 1);
    int nxt = __shfl_up_sync(FULL, cur, 1);
#endif
    const int u1 = (u + 1) % SEG;
    const T h0 = __shfl_sync(FULL, chH, u);
    const T f0 = __shfl_sync(FULL, chF, u);
    const int n0 = __shfl_sync(FULL, u1 ? chS : nS, u1);
    if (lane == 0) {
      htop = h0;
      f = f0;
      nxt = n0;
    }
    int32_t pn[CH];  // the next step's profile entries, read off this step's path
    profile_row<CH>(pn, prof, nxt, lane);
    if (!GUARD || (j >= 0 && j < n)) {
      fb = lane_column<T, CH, LOCAL, TAIL>(L, pc, htop, f, m, Q, R);
      hb = L.H[CH - 1];
      if (S.feed && lane == WARP - 1) edge_put(ring_out, j, hb, fb);
    }
    cur = nxt;
#pragma unroll
    for (int r = 0; r < CH; ++r) pc[r] = pn[r];
  };
  // SEG steps from t0, unrolled: in the steady part of the stripe every
  // lane's column lies in the pair, so no step needs a guard.
  auto segment = [&](const int t0, auto tail) {
#ifndef K3_PROBE_STEADY
    if (!(t0 >= WARP - 1 && t0 + SEG <= n)) {
#pragma unroll
      for (int u = 0; u < SEG; ++u)
        if (t0 + u < steps) step(t0 + u, u, std::true_type(), tail);
      return;
    }
#endif
#pragma unroll
    for (int u = 0; u < SEG; ++u) step(t0 + u, u, std::false_type(), tail);
  };

  for (int clk = 0; clk < clocks; clk += SEG) {
    block_sync();
    const int t0 = clk - warp * LAG;  // this warp's step; t0 % SEG == 0
    if (!S.active || t0 < 0 || t0 >= steps) continue;  // warp-uniform
    if (t0 < n) {  // the next segment of the top row
      const int col = t0 + lane;
      if (lane < SEG) {
        chS = nS;
        if (col < n) edge_get(ring_in, col, chH, chF);
        if (col + SEG < n) nS = a.s[col + SEG];
      }
      if (t0 == 0) {  // lane 0's first column
        cur = __shfl_sync(FULL, chS, 0);
        profile_row<CH>(pc, prof, cur, lane);
      }
    }
    if (S.feed)
      segment(t0, std::false_type());
    else
      segment(t0, std::true_type());
  }
  block_sync();
  if (!S.active) return;
  if (LOCAL) {
    T best = L.best;
#pragma unroll
    for (int d = WARP / 2; d > 0; d /= 2) best = mx(best, __shfl_down_sync(FULL, best, d));
    if (lane == 0) atomic_max((T*)a.result, best);
  } else {
    lane_capture<T, CH>(L, m, (T*)a.result);
  }
}

template <typename T, int CH, bool LOCAL>
__global__ void __launch_bounds__((MAX_WARPS + HELPERS) * WARP) longpair_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ticket;
  const int W = a.warps;
  const int warp = threadIdx.x / WARP;
  if (threadIdx.x == 0) ticket = atomicAdd(a.ticket, 1);
  __syncthreads();
  const int64_t g = ticket;
  const int clocks = block_steps(stripe_of(a, g, 0).warps, a.n);
  T* rings = (T*)(smem + (size_t)W * CH * ALPHA * WARP * sizeof(int32_t));
  if (warp < W) {
    compute<T, CH, LOCAL>(a, g, warp, smem, rings, clocks);
  } else if (warp == W) {
    reader<T, LOCAL>(a, g, rings, clocks);
  } else {
    const Stripe last = stripe_of(a, g, W - 1);
    writer<T>(a, g, last.active && last.feed, rings + (size_t)W * 2 * EDGE, clocks);
  }
}

template <typename T, int CH, bool LOCAL>
static int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes(a.warps, CH, sizeof(T));
  const int rc = (int)cudaFuncSetAttribute(
      longpair_kernel<T, CH, LOCAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != 0) return rc;
  const int64_t groups = (a.stripes + a.warps - 1) / a.warps;
  longpair_kernel<T, CH, LOCAL><<<(unsigned)groups, (a.warps + HELPERS) * WARP, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// out: registers a thread, local bytes a thread, resident blocks an SM at
// `warps`, dynamic shared bytes a block.
template <typename T, int CH, bool LOCAL>
static int attrs(int warps, int* out) {
  const void* fn = (const void*)longpair_kernel<T, CH, LOCAL>;
  const size_t bytes = smem_bytes(warps, CH, sizeof(T));
  cudaFuncAttributes fa;
  int rc = (int)cudaFuncGetAttributes(&fa, fn);
  if (rc == 0)
    rc = (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  int blocks = 0;
  if (rc == 0)
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                            (warps + HELPERS) * WARP, bytes);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  out[2] = blocks;
  out[3] = (int)bytes;
  return rc;
}

#else  // host build: groups in ticket order, segments in order, warps in turn

// One compute warp's state between steps.
template <typename T, int CH> struct HostWarp {
  Stripe S;
  Lane<T, CH> L[WARP];
  T hb[WARP], fb[WARP];     // each lane's last bottom H and leaving F
  int cur[WARP];            // each lane's code at this step
  T chH[WARP], chF[WARP];   // lanes < SEG: the current segment of the top row
  int chS[WARP], nS[WARP];  // and its codes, and the next segment's
};

// Returns 0, or -2 where a handoff (a compute warp's top row, or the
// writer's copy of the last warp's bottom row) would read a column not
// written before the segment's barrier: a schedule that races on the card.
template <typename T, int CH, bool LOCAL>
static int launch(const Args& a, void*) {
  const T Q = (T)a.gap_q, R = (T)a.gap_r;
  const int W = a.warps, n = a.n;
  const int64_t groups = (a.stripes + W - 1) / W;
  std::vector<int32_t> prof((size_t)W * CH * ALPHA * WARP);
  std::vector<T> rings((size_t)(W + 1) * 2 * EDGE);
  // Per ring slot: the column last written there and the segment it was in.
  std::vector<int> tag_col((size_t)(W + 1) * EDGE), tag_seg((size_t)(W + 1) * EDGE);
  std::vector<HostWarp<T, CH>> ws(W);
  T result = 0;
  for (int64_t g = 0; g < groups; ++g) {
    T* outH = group_row<T>(a, g, 0);
    T* outF = group_row<T>(a, g, 1);
    const T* srcH = g ? group_row<T>(a, g - 1, 0) : nullptr;
    const T* srcF = g ? group_row<T>(a, g - 1, 1) : nullptr;
    std::fill(tag_col.begin(), tag_col.end(), -1);
    auto put = [&](int ring, int col, T h, T f, int seg) {
      edge_put(rings.data() + (size_t)ring * 2 * EDGE, col, h, f);
      tag_col[(size_t)ring * EDGE + (col & (EDGE - 1))] = col;
      tag_seg[(size_t)ring * EDGE + (col & (EDGE - 1))] = seg;
    };
    auto fill = [&](int c0, int c1, int seg) {  // the reader: top-row columns [c0, c1)
      for (int col = c0; col < c1 && col < n; ++col) {
        T h, f;
        if (g == 0) {
          top_row<T, LOCAL>(col, Q, R, h, f);
        } else {
          h = srcH[col];
          f = srcF[col];
        }
        put(0, col, h, f, seg);
      }
    };
    for (int w = 0; w < W; ++w) {
      HostWarp<T, CH>& H = ws[w];
      H.S = stripe_of(a, g, w);
      for (int lane = 0; lane < WARP; ++lane) {
        const int64_t r0 = (H.S.ks * WARP + lane) * CH;
        if (H.S.active) {
          load_profile<CH>(prof.data() + (size_t)w * CH * ALPHA * WARP, a, r0, lane);
          lane_init<T, CH, LOCAL>(H.L[lane], r0, Q, R);
        }
        H.hb[lane] = H.fb[lane] = 0;
        H.cur[lane] = H.chS[lane] = 0;
        H.nS[lane] = lane < SEG && lane < n ? a.s[lane] : 0;
      }
    }
    const bool feeds = ws[W - 1].S.active && ws[W - 1].S.feed;
    int done = 0;  // columns the writer copied to the global ring
    // The writer: columns [done, c) of ring W to the global ring.
    auto flush = [&](int c, int seg) {
      for (int col = done; col < c; ++col) {
        const size_t tag = (size_t)W * EDGE + (col & (EDGE - 1));
        if (tag_col[tag] != col || tag_seg[tag] >= seg) return false;
        edge_get(rings.data() + (size_t)W * 2 * EDGE, col, outH[col], outF[col]);
      }
      done = c;
      return true;
    };
    const int steps = n + WARP - 1;
    const int clocks = block_steps(ws[0].S.warps, n);
    const int segs = (clocks + SEG - 1) / SEG;
    fill(0, SEG, -1);
    for (int seg = 0; seg < segs; ++seg) {  // after each barrier:
      const int clk0 = seg * SEG;
      if (clk0 % CHUNK == 0) {
        if (clk0 + SEG < n) fill(clk0 + SEG, clk0 + SEG + CHUNK, seg);  // the reader
        if (feeds && !flush(stored_before(clk0, W, n), seg)) return -2;  // the writer
      }
      for (int w = 0; w < W; ++w) {  // the compute warps
        HostWarp<T, CH>& H = ws[w];
        const int32_t* wprof = prof.data() + (size_t)w * CH * ALPHA * WARP;
        for (int clk = clk0; clk < clocks && clk < clk0 + SEG; ++clk) {
          const int t = clk - w * LAG;
          if (clk == clk0 && H.S.active && t >= 0 && t < n) {
            for (int lane = 0; lane < SEG; ++lane) {
              const int col = t + lane;
              H.chS[lane] = H.nS[lane];
              if (col < n) {
                const size_t tag = (size_t)w * EDGE + (col & (EDGE - 1));
                if (tag_col[tag] != col || tag_seg[tag] >= seg) return -2;
                edge_get(rings.data() + (size_t)w * 2 * EDGE, col, H.chH[lane], H.chF[lane]);
              }
              if (col + SEG < n) H.nS[lane] = a.s[col + SEG];
            }
            if (t == 0) H.cur[0] = H.chS[0];
          }
          if (!H.S.active || t < 0 || t >= steps) continue;
          T ph[WARP], pf[WARP];
          int pcur[WARP];
          for (int lane = 0; lane < WARP; ++lane) {  // the previous step's values
            ph[lane] = H.hb[lane];
            pf[lane] = H.fb[lane];
            pcur[lane] = H.cur[lane];
          }
          const int src = t % SEG, src1 = (t + 1) % SEG;
          for (int lane = 0; lane < WARP; ++lane) {
            const int j = t - lane;
            T htop, f;
            int nxt;
            if (lane > 0) {
              htop = ph[lane - 1];
              f = pf[lane - 1];
              nxt = pcur[lane - 1];
            } else {
              htop = H.chH[src];
              f = H.chF[src];
              nxt = src1 ? H.chS[src1] : H.nS[0];
            }
            if (j >= 0 && j < n) {
              int32_t pc[CH];
              profile_row<CH>(pc, wprof, H.cur[lane], lane);
              H.fb[lane] = H.S.feed
                  ? lane_column<T, CH, LOCAL, false>(H.L[lane], pc, htop, f, a.m, Q, R)
                  : lane_column<T, CH, LOCAL, true>(H.L[lane], pc, htop, f, a.m, Q, R);
              H.hb[lane] = H.L[lane].H[CH - 1];
              if (H.S.feed && lane == WARP - 1) put(w + 1, j, H.hb[lane], H.fb[lane], seg);
            }
            H.cur[lane] = nxt;
          }
        }
      }
    }
    if (feeds && !flush(n, segs)) return -2;  // the writer, after the final barrier
    for (int w = 0; w < W; ++w) {
      if (!ws[w].S.active) continue;
      for (int lane = 0; lane < WARP; ++lane) {
        if (LOCAL)
          result = mx(result, ws[w].L[lane].best);
        else
          lane_capture<T, CH>(ws[w].L[lane], a.m, &result);
      }
    }
  }
  *(T*)a.result = result;
  return 0;
}

#endif

template <int CH, typename Stream>
static int dispatch_ch(const Args& a, int local, int wide, Stream stream) {
  if (wide)
    return local ? launch<int64_t, CH, true>(a, stream) : launch<int64_t, CH, false>(a, stream);
  return local ? launch<int32_t, CH, true>(a, stream) : launch<int32_t, CH, false>(a, stream);
}

// False for a warps count out of range or past the shared memory.
static bool fits(int warps, int ch, int wide) {
  return warps >= 1 && warps <= MAX_WARPS &&
         smem_bytes(warps, ch, wide ? 8 : 4) <= (size_t)MAX_SMEM;
}

// Returns the launch's code, or -1 for a band height without an
// instantiation or a warps count out of range or past the shared memory.
template <typename Stream>
static int dispatch(const Args& a, int local, int wide, int ch, Stream stream) {
  if (!fits(a.warps, ch, wide)) return -1;
  switch (ch) {
    case 4: return dispatch_ch<4>(a, local, wide, stream);
    case 8: return dispatch_ch<8>(a, local, wide, stream);
    default: return -1;
  }
}

static Args make_args(const void* q, long long m, const void* s, int n,
                      const void* matrix, long long gap_q, long long gap_r,
                      long long stripes, int warps, void* bufH, void* bufF,
                      void* progress, void* ticket, void* result) {
  Args a;
  a.q = (const uint8_t*)q;
  a.m = m;
  a.s = (const uint8_t*)s;
  a.n = n;
  a.matrix = (const int32_t*)matrix;
  a.gap_q = gap_q;
  a.gap_r = gap_r;
  a.stripes = stripes;
  a.warps = warps;
  a.bufH = bufH;
  a.bufF = bufF;
  a.progress = (int*)progress;
  a.ticket = (int*)ticket;
  a.result = result;
  return a;
}

}  // namespace k3

extern "C" {

// Group-edge row buffers the caller allocates: (RING, n) each for H and F.
int k3_ring_slots() { return k3::RING; }

// Dynamic shared bytes of a block of `warps` compute warps at band height `ch`.
long long k3_smem_bytes(int warps, int ch, int wide) {
  return (long long)k3::smem_bytes(warps, ch, wide ? 8 : 4);
}

#ifdef __CUDACC__
// Enqueue K3 on `stream`: one block of `warps` compute warps (and a reader
// and a writer warp) per group of `warps` stripes of 32 * ch rows; progress
// holds one counter a group. Returns cudaGetLastError() (or the shared-memory
// attribute's error), or -1 for an unsupported ch or warps.
int k3_longpair(const void* q, long long m, const void* s, int n,
                const void* matrix, long long gap_q, long long gap_r, int local,
                int wide, int ch, long long stripes, int warps, void* bufH,
                void* bufF, void* progress, void* ticket, void* result, void* stream) {
  k3::Args a = k3::make_args(q, m, s, n, matrix, gap_q, gap_r, stripes, warps, bufH,
                             bufF, progress, ticket, result);
  return k3::dispatch(a, local, wide, ch, (cudaStream_t)stream);
}

// out: registers a thread, local bytes a thread, resident blocks an SM and
// dynamic shared bytes of one instantiation at `warps`. Returns the CUDA
// error, or -1 for an unsupported ch or warps.
int k3_attrs(int local, int wide, int ch, int warps, int* out) {
  if (!k3::fits(warps, ch, wide)) return -1;
  if (ch == 4) {
    if (wide)
      return local ? k3::attrs<int64_t, 4, true>(warps, out) : k3::attrs<int64_t, 4, false>(warps, out);
    return local ? k3::attrs<int32_t, 4, true>(warps, out) : k3::attrs<int32_t, 4, false>(warps, out);
  }
  if (ch == 8) {
    if (wide)
      return local ? k3::attrs<int64_t, 8, true>(warps, out) : k3::attrs<int64_t, 8, false>(warps, out);
    return local ? k3::attrs<int32_t, 8, true>(warps, out) : k3::attrs<int32_t, 8, false>(warps, out);
  }
  return -1;
}
#else
// The same computation on the host; returns 0, -1 for an unsupported ch or
// warps, or -2 for a handoff that would race on the card.
int k3_longpair_host(const void* q, long long m, const void* s, int n,
                     const void* matrix, long long gap_q, long long gap_r,
                     int local, int wide, int ch, long long stripes, int warps,
                     void* bufH, void* bufF, void* result) {
  k3::Args a = k3::make_args(q, m, s, n, matrix, gap_q, gap_r, stripes, warps, bufH,
                             bufF, nullptr, nullptr, result);
  return k3::dispatch(a, local, wide, ch, (void*)nullptr);
}
#endif

}  // extern "C"
