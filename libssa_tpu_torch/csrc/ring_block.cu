// K2: tiles of a larger SW/NW DP with boundary input and output, for Hopper.
//
// Replaces libssa_tpu/ops/ring_block_pallas.py::_kernel (the Pallas TPU
// kernel built by _build and called through banded_tile). One launch takes a
// list of jobs; each job is one tile (ops/ring_block.py has the contract):
// RB query rows and W subject columns with its own codes, its left H/E
// column (leftH corner first), its top H/F row, and its outputs: the right
// H/E column, the bottom H/F row, and for SW each row's max and the earliest
// column reaching it. Exact in int32 or int64; there is no -inf: a boundary
// without gap state passes E = H - Q + R. Tiles are exact, so the TPU
// kernel's padding artefacts (mid-cell latch, selectable bottom row, select
// tree, f32 window, window-aligned steps) have no counterpart here.
//
// What bounds it on this card: like K3 (csrc/longpair.cu), one tile has
// little parallelism: only the cells of one anti-diagonal are independent,
// so the stripes of a tile form one chain, and a warp's step is a chain of
// dependent integer operations and shuffles that one warp issues in order:
// the step's instruction count and latencies, not the card's issue rate or
// memory, set the time. Device memory sees the boundaries once. The earlier
// design (one warp a block, polling and publishing its own stripe edge, one
// step a loop trip with a column guard and the profile read on its path)
// took about 430 cycles a step; this one about 270 at 4 rows a thread on an
// H100 (experiments/k2_ab.py, k2_bisect.py; PERF.md).
//
// The design:
//  * Thread b of a warp owns CH consecutive rows of its tile, with H and E in
//    registers; at step t it computes its CH cells of column j = t - b. F runs
//    down the CH rows as one scalar. Band b gets band b-1's bottom H, leaving
//    F and the column's subject code by __shfl_up_sync.
//  * A warp is a stripe of 32*CH rows of one tile. A block holds W compute
//    warps (1 .. MAX_WARPS) on W consecutive stripes of one tile, a group:
//    compute warp w of group g owns stripe g*W + w. A warp whose stripe lies
//    past the tile computes nothing but meets every barrier. Beside them the
//    block has two helper warps, a reader and a writer, that take every
//    global-memory wait and fence off the compute warps' path.
//  * Compute warp w reads its top row from ring w in shared memory, EDGE
//    columns of H and F (edge_get): ring 0 holds the group's top row, which
//    the reader fills; ring w > 0 holds warp w-1's bottom row, which lane 31
//    of warp w-1 writes (edge_put). The block keeps a lockstep by segments:
//    one barrier every SEG steps of the block's clock, and compute warp w
//    runs LAG steps behind warp w-1. Lane 31 writes column c at its warp's
//    step c + 31, and the next warp loads the segment [t, t + SEG) right
//    after the barrier at its own step t: with LAG >= SEG + 31 every column
//    of it was written before that barrier. Until the next barrier the
//    writer reaches column t + LAG + SEG - 32, so a ring of EDGE > LAG + SEG
//    - 32 columns is never overwritten unread. Lockstep over progress
//    flags: the schedule bounds the writer's lead exactly, so the small
//    rings need no flag back from their readers, no poll and no fence, and
//    one barrier in SEG steps costs little against a step.
//  * A segment's SEG steps are unrolled, and in the steady part of a stripe
//    (every lane's column inside the tile) they carry no column guard; the
//    last row's bottom stores are compiled only into the warp that holds
//    it. Each lane takes its next column's code from lane-1 a step early and
//    reads that column's profile entries then, off the step's path; each
//    compute warp loads the next segment's subject codes a segment ahead.
//  * Between blocks: lane 31 of the last compute warp stores its bottom row
//    to the tile's global ring slot g mod RING (plain stores, no fence).
//    Every CHUNK steps the writer warp publishes, for the group, how many of
//    those columns were stored before the barrier (a fence and a release
//    store: the barrier orders the stores before the fence, which is
//    cumulative). The reader warp of group g+1 polls that count with
//    acquire loads and, CHUNK steps ahead of compute warp 0, copies the next
//    CHUNK columns of the top row from the global ring into ring 0; group
//    0's reader copies the tile's topH and topF. Each lane starts from the
//    tile's leftH/leftE. RING >= 2 suffices: group g+2's last warp stores
//    slot g mod RING at column j only after its warp 0 computed column j,
//    which needs group g+1 past column j, whose reader had copied column j
//    out of that slot before.
//  * The lane holding the tile's last row writes botH/botF per column; every
//    lane writes its rows' H/E after the last column (rightH/rightE) and, in
//    SW, their maxima, kept in registers with a strict > over columns in
//    order, so the earliest column wins.
//  * Groups of all jobs are taken in one ticket order (atomicAdd on a counter
//    zeroed per launch), job by job and group by group, so group g of a job
//    is ticketed after group g-1 of the same job: a running block only waits
//    on one that has started, and no block order can deadlock.
//  * Shared memory is dynamic, sized per launch: each compute warp's
//    profile, CH x 32 symbols x 32 lanes of int32 ([row][symbol][lane]: every
//    lane reads its own bank), then the W rings.
//  * Templated on the score type (int32, int64), on CH (4, 8) and on local;
//    W is a launch argument.
//
// The per-lane column update, the schedule and the shared-ring handoff are
// __host__ __device__, and a host C++ compiler builds the whole file
// (k2_ring_block_host below runs the groups in ticket order and, in each,
// the segments of the block's clock: the reader, the writer's count, then
// the compute warps one by one, the 32 lanes of a warp in lock-step as a
// warp runs them; it checks that every handoff reads a column written
// before the segment's barrier and that every published column was
// stored), so the recurrence, boundaries, skew and schedule are tested on a
// machine with no GPU.
//
// Timing probes (libssa_tpu_torch/experiments/k2_bisect.py): compile-time
// switches that cut one stage each, every set built into its own library;
// all off in K2 itself. Every cut but NO_FENCE gives wrong outputs.
//   K2_PROBE_NO_WAIT     no poll on the group above (the reader warp);
//   K2_PROBE_NO_FENCE    no __threadfence before the progress release store;
//   K2_PROBE_NO_PUBLISH  the first two, and no progress release store;
//   K2_PROBE_NO_SYNC     no barrier between segments: the warps of a block
//                        drift apart, their handoffs unordered;
//   K2_PROBE_NO_PROFILE  every column takes symbol 0's profile entries.
#include <stddef.h>
#include <stdint.h>

#ifdef K2_PROBE_NO_PUBLISH
#define K2_PROBE_NO_WAIT
#define K2_PROBE_NO_FENCE
#endif

#ifdef __CUDACC__
#include <cuda_runtime.h>

#include <type_traits>
#define K2_HD __host__ __device__ __forceinline__
#else
#include <algorithm>
#include <vector>
#define K2_HD inline
#endif

namespace k2 {

constexpr int ALPHA = 32;         // padded alphabet
constexpr int WARP = 32;          // lanes (bands) per stripe
constexpr int SEG = 8;            // steps between the lockstep's barriers
constexpr int LAG = 5 * SEG;      // steps compute warp w runs behind warp w-1
constexpr int CHUNK = 32;         // top-row columns the reader copies, and the
                                  // writer publishes, at once
constexpr int EDGE = 128;         // columns of a shared ring
constexpr int RING = 2;           // group-edge row buffers per tile, in global memory
constexpr int MAX_WARPS = 8;      // compute warps (stripes) a block
constexpr int HELPERS = 2;        // and its reader and writer warps
constexpr int MAX_SMEM = 232448;  // dynamic shared bytes a block may have
constexpr long long WAIT_LIMIT_CYCLES = 40LL * 1000 * 1000 * 1000;  // ~20 s
static_assert(LAG % SEG == 0 && LAG >= SEG + WARP - 1,
              "a segment's columns are written a barrier before they are read");
static_assert(CHUNK % SEG == 0 && EDGE >= 3 * CHUNK && EDGE > LAG + SEG - WARP &&
              (EDGE & (EDGE - 1)) == 0, "a ring outlasts its readers");

template <typename T> K2_HD T mx(T a, T b) { return a > b ? a : b; }

// One job, as the wrapper lays out its table: sixteen 64-bit words.
struct Job {
  const uint8_t* q;     // (rows,) query codes, < ALPHA
  const uint8_t* s;     // (cols,) subject codes, < ALPHA
  const void* leftH;    // (rows + 1,) of T, corner first
  const void* leftE;    // (rows,) of T
  const void* topH;     // (cols,) of T
  const void* topF;     // (cols,) of T
  void* rightH;         // (rows,) of T out
  void* rightE;         // (rows,) of T out
  void* botH;           // (cols,) of T out
  void* botF;           // (cols,) of T out
  void* rowmax;         // (rows,) of T out, SW
  int32_t* rowarg;      // (rows,) out, SW
  void* ring;           // (2, RING, cols) of T: group-edge H and F rows
  int64_t rows, cols;   // >= 1 each
  int64_t first;        // ticket of the job's group 0
};
static_assert(sizeof(Job) == 16 * 8, "the wrapper writes 16 words a job");

struct Args {
  const Job* jobs;
  const int32_t* group_job;  // (groups,) job of each ticket
  int groups;
  int warps;                 // W: stripes (compute warps) a block
  const int32_t* matrix;     // (ALPHA, ALPHA)
  int64_t gap_q, gap_r;
  int* progress;             // (groups,) columns published; zero at launch
  int* ticket;               // group counter; zero at launch
};

// Dynamic shared bytes of a block: W profiles, then W rings of H and F.
K2_HD size_t smem_bytes(int W, int ch, size_t item) {
  return (size_t)W * ch * ALPHA * WARP * sizeof(int32_t) + (size_t)W * 2 * EDGE * item;
}

// Where warp `warp` of the block on group g of job J stands.
struct Stripe {
  int64_t ks;      // the stripe within the tile
  bool active;     // the stripe lies in the tile
  bool first;      // stripe 0: its top is the tile's topH/topF
  bool feed;       // a stripe below reads its bottom row
  bool to_global;  // ... through the tile's global ring (the block's last warp)
  int warps;       // active compute warps of the block: its clock runs for them
};

template <int CH>
K2_HD Stripe stripe_of(const Job& J, int64_t g, int W, int warp) {
  const int64_t nst = (J.rows + WARP * CH - 1) / (WARP * CH);
  Stripe S;
  S.ks = g * W + warp;
  S.active = S.ks < nst;
  S.first = S.ks == 0;
  S.feed = S.ks + 1 < nst;
  S.to_global = warp == W - 1;
  const int64_t left = nst - g * W;
  S.warps = (int)(left < W ? left : W);
  return S;
}

// Group g's row of the tile's global ring (plane 0: H, 1: F), slot g mod
// RING: its last compute warp stores it, group g+1's reader copies it.
template <typename T> K2_HD T* group_row(const Job& J, int64_t g, int plane) {
  return (T*)J.ring + (size_t)(plane * RING + g % RING) * J.cols;
}

// The top row group g's reader copies: the tile's topH/topF for group 0.
template <typename T> K2_HD const T* group_top(const Job& J, int64_t g, int plane) {
  if (g == 0) return (const T*)(plane ? J.topF : J.topH);
  return group_row<T>(J, g - 1, plane);
}

// Steps of the block's clock: its last active warp's, LAG per warp behind.
K2_HD int block_steps(int warps, int cols) { return LAG * (warps - 1) + cols + WARP - 1; }

// Columns of compute warp W-1's bottom row stored before the barrier at the
// block's clock clk (lane 31 stores column j at clock j + 31 + LAG*(W-1)):
// what the writer publishes there.
K2_HD int stored_before(int clk, int W, int cols) {
  const int c = clk - (WARP - 1) - LAG * (W - 1);
  return c < 0 ? 0 : c < cols ? c : cols;
}

// A shared ring, written by edge_put and read by edge_get: H at [slot], F at
// [EDGE + slot], slot = column mod EDGE.
template <typename T> K2_HD void edge_put(T* edge, int col, T h, T f) {
  edge[col & (EDGE - 1)] = h;
  edge[EDGE + (col & (EDGE - 1))] = f;
}

template <typename T> K2_HD void edge_get(const T* edge, int col, T& h, T& f) {
  h = edge[col & (EDGE - 1)];
  f = edge[EDGE + (col & (EDGE - 1))];
}

// One band: CH rows r0 .. r0+CH-1 (0-based within the tile).
template <typename T, int CH> struct Lane {
  T H[CH], E[CH];  // H and E of the band's rows at the last column done
  T diag_top;      // H of the row above the band, one column to the left
  T hl, fl;        // H and entering F of the tile's last row, if the band has it
  T rmax[CH];      // SW: each row's max H so far
  int rarg[CH];    // SW: the earliest column reaching it
};

template <typename T, int CH>
K2_HD void lane_init(Lane<T, CH>& L, const T* leftH, const T* leftE, int64_t r0,
                     int64_t rows, T Q, T R) {
  // Rows past the tile feed no real row: any finite state serves.
  const T pad = leftH[rows];
  for (int s = 0; s < CH; ++s) {
    const int64_t row = r0 + s;
    L.H[s] = row < rows ? leftH[row + 1] : pad;
    L.E[s] = row < rows ? leftE[row] : pad - Q + R;
    L.rmax[s] = -1;  // SW H >= 0: the first column always sets it
    L.rarg[s] = -1;
  }
  L.diag_top = r0 < rows ? leftH[r0] : pad;
  L.hl = L.fl = 0;
}

// One column j of the band. htop: H of the row above at this column; f: F of
// the band's first row; pc[s * stride]: sub(q[r0+s], column code); slast: the
// tile's last row within the band, or -1. Returns the F leaving the band.
template <typename T, int CH, bool LOCAL>
K2_HD T lane_column(Lane<T, CH>& L, const int32_t* pc, int stride, T htop, T f,
                    T Q, T R, int j, int slast) {
  T diag = L.diag_top;
  L.diag_top = htop;
#pragma unroll
  for (int s = 0; s < CH; ++s) {
    if (s == slast) L.fl = f;
    const T e = mx(L.E[s] - R, L.H[s] - Q);
    T h = mx(mx(diag + (T)pc[s * stride], e), f);
    if (LOCAL) h = mx(h, (T)0);
    diag = L.H[s];
    L.H[s] = h;
    L.E[s] = e;
    if (s == slast) L.hl = h;
    if (LOCAL && h > L.rmax[s]) {
      L.rmax[s] = h;
      L.rarg[s] = j;
    }
    f = mx(f - R, h - Q);
  }
  return f;
}

// After the last column: the band's rows' right edge and, in SW, maxima.
template <typename T, int CH, bool LOCAL>
K2_HD void lane_finish(const Lane<T, CH>& L, const Job& J, int64_t r0) {
#pragma unroll
  for (int s = 0; s < CH; ++s) {
    const int64_t row = r0 + s;
    if (row < J.rows) {
      ((T*)J.rightH)[row] = L.H[s];
      ((T*)J.rightE)[row] = L.E[s];
      if (LOCAL) {
        ((T*)J.rowmax)[row] = L.rmax[s];
        J.rowarg[row] = L.rarg[s];
      }
    }
  }
}

template <int CH>
K2_HD void load_profile(int32_t* prof, const Job& J, const int32_t* matrix, int64_t r0,
                        int lane) {
  for (int s = 0; s < CH; ++s) {
    const int64_t row = r0 + s;
    const int qc = row < J.rows ? J.q[row] : ALPHA - 1;
    for (int c = 0; c < ALPHA; ++c)
      prof[(s * ALPHA + c) * WARP + lane] = matrix[qc * ALPHA + c];
  }
}

// A lane's profile entries for the column of code c: sub(q[r0+s], c).
template <int CH>
K2_HD void profile_row(int32_t* pc, const int32_t* prof, int c, int lane) {
#pragma unroll
  for (int s = 0; s < CH; ++s) pc[s] = prof[(s * ALPHA + c) * WARP + lane];
}

// The tile's last row within the band starting at r0, or -1.
template <int CH>
K2_HD int last_row_in(const Job& J, int64_t r0) {
  const int64_t last = J.rows - 1;
  return (last >= r0 && last < r0 + CH) ? (int)(last - r0) : -1;
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

// The block-wide barrier, met by compute and helper warps at their own call
// sites; seg_sync is the one that starts a segment of the lockstep.
__device__ __forceinline__ void block_sync() { asm volatile("bar.sync 0;" ::: "memory"); }

__device__ __forceinline__ void seg_sync() {
#ifndef K2_PROBE_NO_SYNC
  block_sync();
#endif
}

// The reader warp: ring 0 gets the group's top row CHUNK steps ahead of
// compute warp 0, from the tile's topH/topF (group 0) or the previous
// group's global ring once its writer has published the columns.
template <typename T>
__device__ void reader(const Args& a, const Job& J, int64_t g, int k, T* top, int clocks) {
  const int lane = threadIdx.x % WARP, cols = (int)J.cols;
  const bool first = g == 0;
  const T* srcH = group_top<T>(J, g, 0);
  const T* srcF = group_top<T>(J, g, 1);
  const int* above = a.progress + (k > 0 ? k - 1 : 0);
  int seen = 0;  // the count last read from `above`
  auto fill = [&](int c0) {  // columns [c0, c0 + CHUNK) of the top row
#ifndef K2_PROBE_NO_WAIT
    const int need = min(c0 + CHUNK, cols);
    if (!first && seen < need) {
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
    const int col = c0 + lane;
    if (col < cols) edge_put(top, col, srcH[col], srcF[col]);
  };
  fill(0);
  for (int clk = 0; clk < clocks; clk += SEG) {
    seg_sync();
    // Read by compute warp 0 from the barrier at clk + CHUNK on.
    if (clk % CHUNK == 0 && clk + CHUNK < cols) fill(clk + CHUNK);
  }
  block_sync();
}

// The writer warp: at every CHUNK steps' barrier, the count of the last
// compute warp's bottom-row columns stored before it, fenced and released
// for the next group's reader; all of them after the final barrier.
__device__ void writer(const Args& a, int k, bool feeds, int W, int cols, int clocks) {
  const bool lead = threadIdx.x % WARP == 0;
  int done = 0;
  for (int clk = 0; clk < clocks; clk += SEG) {
    seg_sync();
    const int c = stored_before(clk, W, cols);
    if (clk % CHUNK == 0 && feeds && lead && c > done) {
      done = c;
#ifndef K2_PROBE_NO_FENCE
      __threadfence();
#endif
#ifndef K2_PROBE_NO_PUBLISH
      st_release(a.progress + k, c);
#endif
    }
  }
  block_sync();
  if (feeds && lead) {
#ifndef K2_PROBE_NO_FENCE
    __threadfence();
#endif
#ifndef K2_PROBE_NO_PUBLISH
    st_release(a.progress + k, cols);
#endif
  }
}

// Compute warp `warp` of the block on group g of job J.
template <typename T, int CH, bool LOCAL>
__device__ void compute(const Args& a, const Job& J, int64_t g, int warp, unsigned char* smem,
                        T* rings, int clocks) {
  constexpr unsigned FULL = 0xffffffffu;
  const int W = a.warps, lane = threadIdx.x % WARP, cols = (int)J.cols;
  const Stripe S = stripe_of<CH>(J, g, W, warp);
  const int64_t r0 = (S.ks * WARP + lane) * CH;
  int32_t* prof = (int32_t*)smem + (size_t)warp * CH * ALPHA * WARP;
  const T* ring_in = rings + (size_t)warp * 2 * EDGE;
  T* ring_out = rings + (size_t)(warp + 1) * 2 * EDGE;  // warp < W-1

  const T Q = (T)a.gap_q, R = (T)a.gap_r;
  Lane<T, CH> L;
  int nS = 0;  // lanes < SEG: the code of a column of the next segment
  if (S.active) {
    load_profile<CH>(prof, J, a.matrix, r0, lane);
    lane_init<T, CH>(L, (const T*)J.leftH, (const T*)J.leftE, r0, J.rows, Q, R);
    if (lane < SEG && lane < cols) nS = J.s[lane];
  }
  __syncwarp();
  const int slast = S.feed ? -1 : last_row_in<CH>(J, r0);
  T* outH = group_row<T>(J, g, 0);
  T* outF = group_row<T>(J, g, 1);
  T* botH = (T*)J.botH;
  T* botF = (T*)J.botF;

  T hb = 0, fb = 0;  // the last column's bottom H and leaving F
  T chH = 0, chF = 0;
  int chS = 0;       // lanes < SEG: a column of the current segment
  int cur = 0;       // the code of this lane's column at this step
  int32_t pc[CH];    // its profile entries, loaded a step ahead
  const int steps = cols + WARP - 1;

  // Step t, the u-th of its segment. GUARD: some lane's column may lie
  // outside the tile; LASTW: a lane holds the tile's last row.
  auto step = [&](const int t, const int u, auto guard, auto lastw) {
    constexpr bool GUARD = decltype(guard)::value, LASTW = decltype(lastw)::value;
    const int j = t - lane;
    // Column j's top boundary from lane-1's step t-1; the code of column j+1,
    // this lane's next, is lane-1's now.
    T htop = __shfl_up_sync(FULL, hb, 1);
    T f = __shfl_up_sync(FULL, fb, 1);
    int nxt = __shfl_up_sync(FULL, cur, 1);
    const int u1 = (u + 1) % SEG;
    const T h0 = __shfl_sync(FULL, chH, u);
    const T f0 = __shfl_sync(FULL, chF, u);
    const int n0 = __shfl_sync(FULL, u1 ? chS : nS, u1);
    if (lane == 0) {
      htop = h0;
      f = S.first ? mx(f0 - R, h0 - Q) : f0;  // topF is the row above's F
      nxt = n0;
    }
#ifdef K2_PROBE_NO_PROFILE
    nxt = 0;
#endif
    int32_t pn[CH];  // the next step's profile entries, read off this step's path
    profile_row<CH>(pn, prof, nxt, lane);
    if (!GUARD || (j >= 0 && j < cols)) {
      fb = lane_column<T, CH, LOCAL>(L, pc, 1, htop, f, Q, R, j, LASTW ? slast : -1);
      hb = L.H[CH - 1];
      if (LASTW && slast >= 0) {
        botH[j] = L.hl;
        botF[j] = L.fl;
      }
      if (S.feed && lane == WARP - 1) {
        if (S.to_global) {
          outH[j] = hb;
          outF[j] = fb;
        } else {
          edge_put(ring_out, j, hb, fb);
        }
      }
    }
    cur = nxt;
#pragma unroll
    for (int r = 0; r < CH; ++r) pc[r] = pn[r];
  };
  // SEG steps from t0, unrolled: in the steady part of the stripe every
  // lane's column lies in the tile, so no step needs a guard.
  auto segment = [&](const int t0, auto lastw) {
    if (t0 >= WARP - 1 && t0 + SEG <= cols) {
#pragma unroll
      for (int u = 0; u < SEG; ++u) step(t0 + u, u, std::false_type(), lastw);
    } else {
#pragma unroll
      for (int u = 0; u < SEG; ++u)
        if (t0 + u < steps) step(t0 + u, u, std::true_type(), lastw);
    }
  };

  for (int clk = 0; clk < clocks; clk += SEG) {
    seg_sync();
    const int t0 = clk - warp * LAG;  // this warp's step; block-uniform t0 % SEG == 0
    if (!S.active || t0 < 0 || t0 >= steps) continue;  // warp-uniform
    if (t0 < cols) {  // the next segment of the top row
      const int col = t0 + lane;
      if (lane < SEG) {
        chS = nS;
        if (col < cols) edge_get(ring_in, col, chH, chF);
        if (col + SEG < cols) nS = J.s[col + SEG];
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
  if (S.active) lane_finish<T, CH, LOCAL>(L, J, r0);
}

template <typename T, int CH, bool LOCAL>
__global__ void __launch_bounds__((MAX_WARPS + HELPERS) * WARP) ring_block_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int ticket;
  const int W = a.warps;
  const int warp = threadIdx.x / WARP;
  if (threadIdx.x == 0) ticket = atomicAdd(a.ticket, 1);
  __syncthreads();
  const int k = ticket;
  const Job J = a.jobs[a.group_job[k]];
  const int64_t g = k - J.first;  // group within the job
  const int cols = (int)J.cols;
  const int clocks = block_steps(stripe_of<CH>(J, g, W, 0).warps, cols);
  T* rings = (T*)(smem + (size_t)W * CH * ALPHA * WARP * sizeof(int32_t));
  if (warp < W) {
    compute<T, CH, LOCAL>(a, J, g, warp, smem, rings, clocks);
  } else if (warp == W) {
    reader<T>(a, J, g, k, rings, clocks);
  } else {
    const Stripe last = stripe_of<CH>(J, g, W, W - 1);
    writer(a, k, last.active && last.feed, W, cols, clocks);
  }
}

template <typename T, int CH, bool LOCAL>
static int launch(const Args& a, cudaStream_t stream) {
  const size_t bytes = smem_bytes(a.warps, CH, sizeof(T));
  const int rc = (int)cudaFuncSetAttribute(
      ring_block_kernel<T, CH, LOCAL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (rc != 0) return rc;
  ring_block_kernel<T, CH, LOCAL><<<a.groups, (a.warps + HELPERS) * WARP, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// out: registers a thread, local bytes a thread, resident blocks an SM at
// `warps`, dynamic shared bytes a block.
template <typename T, int CH, bool LOCAL>
static int attrs(int warps, int* out) {
  const void* fn = (const void*)ring_block_kernel<T, CH, LOCAL>;
  const size_t bytes = smem_bytes(warps, CH, sizeof(T));
  cudaFuncAttributes fa;
  int rc = (int)cudaFuncGetAttributes(&fa, fn);
  if (rc == 0)
    rc = (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
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
  int slast[WARP];
  T hb[WARP], fb[WARP];  // each lane's last bottom H and leaving F
  int cur[WARP];         // each lane's code at this step
  T chH[WARP], chF[WARP];  // lanes < SEG: the current segment of the top row
  int chS[WARP], nS[WARP];  // and its codes, and the next segment's
};

// Returns 0, or -2 where a handoff would read a column not written before
// the segment's barrier, or the writer would publish a column not stored:
// a schedule that races on the card.
template <typename T, int CH, bool LOCAL>
static int launch(const Args& a, void*) {
  const T Q = (T)a.gap_q, R = (T)a.gap_r;
  const int W = a.warps;
  std::vector<int32_t> prof((size_t)W * CH * ALPHA * WARP);
  std::vector<T> rings((size_t)W * 2 * EDGE);
  // Per ring slot: the column last written there and the segment it was in.
  std::vector<int> tag_col((size_t)W * EDGE), tag_seg((size_t)W * EDGE);
  std::vector<HostWarp<T, CH>> ws(W);
  for (int k = 0; k < a.groups; ++k) {
    const Job& J = a.jobs[a.group_job[k]];
    const int64_t g = k - J.first;
    const int cols = (int)J.cols;
    T* outH = group_row<T>(J, g, 0);
    T* outF = group_row<T>(J, g, 1);
    const T* srcH = group_top<T>(J, g, 0);
    const T* srcF = group_top<T>(J, g, 1);
    std::fill(tag_col.begin(), tag_col.end(), -1);
    auto put = [&](int ring, int col, T h, T f, int seg) {
      edge_put(rings.data() + (size_t)ring * 2 * EDGE, col, h, f);
      tag_col[(size_t)ring * EDGE + (col & (EDGE - 1))] = col;
      tag_seg[(size_t)ring * EDGE + (col & (EDGE - 1))] = seg;
    };
    auto fill = [&](int c0, int seg) {  // the reader: top-row columns [c0, c0 + CHUNK)
      for (int col = c0; col < c0 + CHUNK && col < cols; ++col)
        put(0, col, srcH[col], srcF[col], seg);
    };
    for (int w = 0; w < W; ++w) {
      HostWarp<T, CH>& H = ws[w];
      H.S = stripe_of<CH>(J, g, W, w);
      for (int lane = 0; lane < WARP; ++lane) {
        const int64_t r0 = (H.S.ks * WARP + lane) * CH;
        if (H.S.active) {
          load_profile<CH>(prof.data() + (size_t)w * CH * ALPHA * WARP, J, a.matrix, r0, lane);
          lane_init<T, CH>(H.L[lane], (const T*)J.leftH, (const T*)J.leftE, r0, J.rows, Q, R);
        }
        H.slast[lane] = H.S.feed ? -1 : last_row_in<CH>(J, r0);
        H.hb[lane] = H.fb[lane] = 0;
        H.cur[lane] = H.chS[lane] = 0;
        H.nS[lane] = lane < SEG && lane < cols ? J.s[lane] : 0;
      }
    }
    const bool feeds = ws[W - 1].S.active && ws[W - 1].S.feed;
    int stored = 0;  // columns the last compute warp stored to the global ring
    const int steps = cols + WARP - 1;
    const int clocks = block_steps(ws[0].S.warps, cols);
    fill(0, -1);
    for (int seg = 0; seg * SEG < clocks; ++seg) {  // after each barrier:
      const int clk0 = seg * SEG;
      if (clk0 % CHUNK == 0) {
        if (clk0 + CHUNK < cols) fill(clk0 + CHUNK, seg);  // the reader
        if (feeds && stored_before(clk0, W, cols) > stored) return -2;  // the writer
      }
      for (int w = 0; w < W; ++w) {  // the compute warps
        HostWarp<T, CH>& H = ws[w];
        const int32_t* wprof = prof.data() + (size_t)w * CH * ALPHA * WARP;
        for (int clk = clk0; clk < clocks && clk < clk0 + SEG; ++clk) {
          const int t = clk - w * LAG;
          if (clk == clk0 && H.S.active && t >= 0 && t < cols) {
            for (int lane = 0; lane < SEG; ++lane) {
              const int col = t + lane;
              H.chS[lane] = H.nS[lane];
              if (col < cols) {
                const size_t tag = (size_t)w * EDGE + (col & (EDGE - 1));
                if (tag_col[tag] != col || tag_seg[tag] >= seg) return -2;
                edge_get(rings.data() + (size_t)w * 2 * EDGE, col, H.chH[lane], H.chF[lane]);
              }
              if (col + SEG < cols) H.nS[lane] = J.s[col + SEG];
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
              f = H.S.first ? mx(H.chF[src] - R, H.chH[src] - Q) : H.chF[src];
              nxt = src1 ? H.chS[src1] : H.nS[0];
            }
            if (j >= 0 && j < cols) {
              int32_t pc[CH];
              profile_row<CH>(pc, wprof, H.cur[lane], lane);
              H.fb[lane] = lane_column<T, CH, LOCAL>(H.L[lane], pc, 1, htop, f, Q, R, j,
                                                     H.slast[lane]);
              H.hb[lane] = H.L[lane].H[CH - 1];
              if (H.slast[lane] >= 0) {
                ((T*)J.botH)[j] = H.L[lane].hl;
                ((T*)J.botF)[j] = H.L[lane].fl;
              }
              if (H.S.feed && lane == WARP - 1) {
                if (H.S.to_global) {
                  outH[j] = H.hb[lane];
                  outF[j] = H.fb[lane];
                  stored = j + 1;
                } else {
                  put(w + 1, j, H.hb[lane], H.fb[lane], seg);
                }
              }
            }
            H.cur[lane] = nxt;
          }
        }
      }
    }
    if (feeds && stored != cols) return -2;  // the writer's last count
    for (int w = 0; w < W; ++w)
      if (ws[w].S.active)
        for (int lane = 0; lane < WARP; ++lane)
          lane_finish<T, CH, LOCAL>(ws[w].L[lane], J, (ws[w].S.ks * WARP + lane) * CH);
  }
  return 0;
}

#endif

template <int CH, typename Stream>
static int dispatch_ch(const Args& a, int local, int wide, Stream stream) {
  if (wide)
    return local ? launch<int64_t, CH, true>(a, stream) : launch<int64_t, CH, false>(a, stream);
  return local ? launch<int32_t, CH, true>(a, stream) : launch<int32_t, CH, false>(a, stream);
}

// Returns the launch's code, or -1 for a band height without an
// instantiation or a warps count out of range or past the shared memory.
template <typename Stream>
static int dispatch(const Args& a, int local, int wide, int ch, Stream stream) {
  if (a.warps < 1 || a.warps > MAX_WARPS ||
      smem_bytes(a.warps, ch, wide ? 8 : 4) > (size_t)MAX_SMEM)
    return -1;
  switch (ch) {
    case 4: return dispatch_ch<4>(a, local, wide, stream);
    case 8: return dispatch_ch<8>(a, local, wide, stream);
    default: return -1;
  }
}

static Args make_args(const void* jobs, const void* group_job, int groups, int warps,
                      const void* matrix, long long gap_q, long long gap_r,
                      void* progress, void* ticket) {
  Args a;
  a.jobs = (const Job*)jobs;
  a.group_job = (const int32_t*)group_job;
  a.groups = groups;
  a.warps = warps;
  a.matrix = (const int32_t*)matrix;
  a.gap_q = gap_q;
  a.gap_r = gap_r;
  a.progress = (int*)progress;
  a.ticket = (int*)ticket;
  return a;
}

}  // namespace k2

extern "C" {

// Group-edge row buffers the caller allocates per tile: (2, RING, cols).
int k2_ring_slots() { return k2::RING; }

// 64-bit words per job in the table the caller builds.
int k2_job_words() { return (int)(sizeof(k2::Job) / 8); }

// Dynamic shared bytes of a block of `warps` warps at band height `ch`.
long long k2_smem_bytes(int warps, int ch, int wide) {
  return (long long)k2::smem_bytes(warps, ch, wide ? 8 : 4);
}

#ifdef __CUDACC__
// Enqueue K2 on `stream`: one block of `warps` warps per group of `warps`
// stripes of 32 * ch rows, over the groups of every job. Returns
// cudaGetLastError() (or the shared-memory attribute's error), or -1 for an
// unsupported ch or warps.
int k2_ring_block(const void* jobs, const void* group_job, int groups, int warps,
                  const void* matrix, long long gap_q, long long gap_r, int local,
                  int wide, int ch, void* progress, void* ticket, void* stream) {
  k2::Args a = k2::make_args(jobs, group_job, groups, warps, matrix, gap_q, gap_r,
                             progress, ticket);
  return k2::dispatch(a, local, wide, ch, (cudaStream_t)stream);
}

// out: registers a thread, local bytes a thread, resident blocks an SM and
// dynamic shared bytes of one instantiation at `warps`. Returns the CUDA
// error, or -1 for an unsupported ch or warps.
int k2_attrs(int local, int wide, int ch, int warps, int* out) {
  if (warps < 1 || warps > k2::MAX_WARPS ||
      k2::smem_bytes(warps, ch, wide ? 8 : 4) > (size_t)k2::MAX_SMEM)
    return -1;
  if (ch == 4) {
    if (wide)
      return local ? k2::attrs<int64_t, 4, true>(warps, out) : k2::attrs<int64_t, 4, false>(warps, out);
    return local ? k2::attrs<int32_t, 4, true>(warps, out) : k2::attrs<int32_t, 4, false>(warps, out);
  }
  if (ch == 8) {
    if (wide)
      return local ? k2::attrs<int64_t, 8, true>(warps, out) : k2::attrs<int64_t, 8, false>(warps, out);
    return local ? k2::attrs<int32_t, 8, true>(warps, out) : k2::attrs<int32_t, 8, false>(warps, out);
  }
  return -1;
}
#else
// The same computation on the host; returns 0, -1 for an unsupported ch or
// warps, or -2 for a handoff that would race on the card.
int k2_ring_block_host(const void* jobs, const void* group_job, int groups, int warps,
                       const void* matrix, long long gap_q, long long gap_r, int local,
                       int wide, int ch) {
  k2::Args a = k2::make_args(jobs, group_job, groups, warps, matrix, gap_q, gap_r, nullptr,
                             nullptr);
  return k2::dispatch(a, local, wide, ch, (void*)nullptr);
}
#endif

}  // extern "C"
