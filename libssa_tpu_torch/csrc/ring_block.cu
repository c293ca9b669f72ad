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
// little parallelism: only the cells of one anti-diagonal are independent.
// Each cell costs about ten dependent integer add/max operations and one
// shared-memory read; device memory sees one H/F pair per column at each
// stripe edge, and the boundaries once. A Myers-Miller level gives a launch
// many tiles, so the stripes of all of them share the card.
//
// The design is K3's stripe pipeline with data boundaries:
//  * Thread b of a warp owns CH consecutive rows of its tile, with H and E in
//    registers; at step t it computes its CH cells of column j = t - b. F runs
//    down the CH rows as one scalar. Band b gets band b-1's bottom H, leaving
//    F and the column's subject code by __shfl_up_sync.
//  * A warp is a stripe of 32*CH rows of one tile. Lane 31 of stripe k writes
//    its bottom row's H and leaving F to the tile's ring slot k mod RING and
//    publishes a progress count every CHUNK columns (fence, release store);
//    stripe k+1 polls with acquire loads. Stripe 0 reads the tile's topH and
//    topF instead. Each lane starts from the tile's leftH/leftE.
//  * The lane holding the tile's last row writes botH/botF per column; every
//    lane writes its rows' H/E after the last column (rightH/rightE) and, in
//    SW, their maxima, kept in registers with a strict > over columns in
//    order, so the earliest column wins.
//  * Stripes of all jobs are taken in one ticket order (atomicAdd on a counter
//    zeroed per launch), job by job and stripe by stripe, so stripe k of a
//    job is ticketed after stripe k-1 of the same job: a running stripe only
//    waits on one that has started, and no block order can deadlock.
//  * Templated on the score type (int32, int64), on CH (4, 8) and on local.
//
// The per-lane column update is __host__ __device__, and a host C++
// compiler builds the whole file (k2_ring_block_host below runs the stripes
// in ticket order, the 32 lanes of each in lock-step as a warp runs them),
// so the recurrence, boundaries and skew are tested on a machine with no GPU.
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define K2_HD __host__ __device__ __forceinline__
#else
#include <vector>
#define K2_HD inline
#endif

namespace k2 {

constexpr int ALPHA = 32;  // padded alphabet
constexpr int WARP = 32;   // lanes (bands) per stripe
constexpr int CHUNK = 32;  // stripe-edge columns published / loaded at once
constexpr int RING = 2;    // stripe-edge row buffers per tile
constexpr long long WAIT_LIMIT_CYCLES = 40LL * 1000 * 1000 * 1000;  // ~20 s

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
  void* ring;           // (2, RING, cols) of T: stripe-edge H and F rows
  int64_t rows, cols;   // >= 1 each
  int64_t first;        // ticket of the job's stripe 0
};
static_assert(sizeof(Job) == 16 * 8, "the wrapper writes 16 words a job");

struct Args {
  const Job* jobs;
  const int32_t* stripe_job;  // (stripes,) job of each ticket
  int stripes;
  const int32_t* matrix;      // (ALPHA, ALPHA)
  int64_t gap_q, gap_r;
  int* progress;              // (stripes,) columns published; zero at launch
  int* ticket;                // stripe counter; zero at launch
};

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

// The tile's last row within the band starting at r0 of stripe ks, or -1.
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

template <typename T, int CH, bool LOCAL>
__global__ void __launch_bounds__(WARP) ring_block_kernel(Args a) {
  __shared__ int32_t prof[CH * ALPHA * WARP];  // [row][symbol][lane]
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x;
  int k = 0;
  if (lane == 0) k = atomicAdd(a.ticket, 1);
  k = __shfl_sync(FULL, k, 0);
  const Job J = a.jobs[a.stripe_job[k]];
  const int64_t ks = k - J.first;  // stripe within the job
  const int64_t nst = (J.rows + WARP * CH - 1) / (WARP * CH);
  const int64_t r0 = (ks * WARP + lane) * CH;
  load_profile<CH>(prof, J, a.matrix, r0, lane);
  __syncwarp();

  const T Q = (T)a.gap_q, R = (T)a.gap_r;
  Lane<T, CH> L;
  lane_init<T, CH>(L, (const T*)J.leftH, (const T*)J.leftE, r0, J.rows, Q, R);
  const int cols = (int)J.cols;
  const bool first = ks == 0;
  const bool feed = ks + 1 < nst;  // a stripe below reads this one
  const int slast = feed ? -1 : last_row_in<CH>(J, r0);
  T* ringH = (T*)J.ring;
  T* ringF = ringH + (size_t)RING * cols;
  T* outH = ringH + (size_t)(ks % RING) * cols;
  T* outF = ringF + (size_t)(ks % RING) * cols;
  const T* srcH = first ? (const T*)J.topH : ringH + (size_t)((ks + RING - 1) % RING) * cols;
  const T* srcF = first ? (const T*)J.topF : ringF + (size_t)((ks + RING - 1) % RING) * cols;
  const int* above = a.progress + (k > 0 ? k - 1 : 0);
  T* botH = (T*)J.botH;
  T* botF = (T*)J.botF;

  T hb = 0, fb = 0;  // the last column's bottom H and leaving F
  int code = 0;      // that column's subject code
  T chH = 0, chF = 0;
  int chS = 0;       // this lane's element of the current chunk
  const int steps = cols + WARP - 1;
  for (int t = 0; t < steps; ++t) {
    const int j = t - lane;
    // Column j's top boundary and code, from lane-1's step t-1.
    T htop = __shfl_up_sync(FULL, hb, 1);
    T f = __shfl_up_sync(FULL, fb, 1);
    int c = __shfl_up_sync(FULL, code, 1);
    if (t % CHUNK == 0 && t < cols) {  // warp-uniform: the next chunk
      const int col = t + lane;
      if (!first) {
        const int need = min(t + CHUNK, cols);
        const long long t0 = clock64();
        while (ld_acquire(above) < need) {
          __nanosleep(32);
          // The stripe above started before this one and publishes every
          // CHUNK columns: a wait of seconds is a fault. Fail the launch
          // rather than hang the card.
          if (clock64() - t0 > WAIT_LIMIT_CYCLES) __trap();
        }
      }
      if (col < cols) {
        chS = J.s[col];
        chH = srcH[col];
        chF = srcF[col];
      }
      __syncwarp();
    }
    const int src = t % CHUNK;
    const int c0 = __shfl_sync(FULL, chS, src);
    const T h0 = __shfl_sync(FULL, chH, src);
    const T f0 = __shfl_sync(FULL, chF, src);
    if (lane == 0) {
      htop = h0;
      f = first ? mx(f0 - R, h0 - Q) : f0;  // topF is the row above's F
      c = c0;
    }
    if (j >= 0 && j < cols) {
      fb = lane_column<T, CH, LOCAL>(L, prof + c * WARP + lane, ALPHA * WARP, htop, f,
                                     Q, R, j, slast);
      hb = L.H[CH - 1];
      code = c;
      if (slast >= 0) {
        botH[j] = L.hl;
        botF[j] = L.fl;
      }
      if (feed && lane == WARP - 1) {
        outH[j] = hb;
        outF[j] = fb;
        if ((j + 1) % CHUNK == 0 || j == cols - 1) {
          __threadfence();
          st_release(a.progress + k, j + 1);
        }
      }
    }
  }
  lane_finish<T, CH, LOCAL>(L, J, r0);
}

template <typename T, int CH, bool LOCAL>
static void launch(const Args& a, cudaStream_t stream) {
  ring_block_kernel<T, CH, LOCAL><<<a.stripes, WARP, 0, stream>>>(a);
}

#else  // host build: stripes in ticket order, lanes in lock-step

template <typename T, int CH, bool LOCAL>
static void launch(const Args& a, void*) {
  const T Q = (T)a.gap_q, R = (T)a.gap_r;
  std::vector<int32_t> prof(CH * ALPHA * WARP);
  for (int k = 0; k < a.stripes; ++k) {
    const Job& J = a.jobs[a.stripe_job[k]];
    const int64_t ks = k - J.first;
    const int64_t nst = (J.rows + WARP * CH - 1) / (WARP * CH);
    const int cols = (int)J.cols;
    const bool first = ks == 0;
    const bool feed = ks + 1 < nst;
    T* ringH = (T*)J.ring;
    T* ringF = ringH + (size_t)RING * cols;
    T* outH = ringH + (size_t)(ks % RING) * cols;
    T* outF = ringF + (size_t)(ks % RING) * cols;
    const T* srcH = first ? (const T*)J.topH : ringH + (size_t)((ks + RING - 1) % RING) * cols;
    const T* srcF = first ? (const T*)J.topF : ringF + (size_t)((ks + RING - 1) % RING) * cols;
    Lane<T, CH> L[WARP];
    int slast[WARP];
    T hb[WARP] = {}, fb[WARP] = {}, ph[WARP], pf[WARP];
    int code[WARP] = {}, pc[WARP];
    for (int lane = 0; lane < WARP; ++lane) {
      const int64_t r0 = (ks * WARP + lane) * CH;
      load_profile<CH>(prof.data(), J, a.matrix, r0, lane);
      lane_init<T, CH>(L[lane], (const T*)J.leftH, (const T*)J.leftE, r0, J.rows, Q, R);
      slast[lane] = feed ? -1 : last_row_in<CH>(J, r0);
    }
    for (int t = 0; t < cols + WARP - 1; ++t) {
      for (int lane = 0; lane < WARP; ++lane) {  // the previous step's values
        ph[lane] = hb[lane];
        pf[lane] = fb[lane];
        pc[lane] = code[lane];
      }
      for (int lane = 0; lane < WARP; ++lane) {
        const int j = t - lane;
        if (j < 0 || j >= cols) continue;
        T htop, f;
        int c;
        if (lane > 0) {
          htop = ph[lane - 1];
          f = pf[lane - 1];
          c = pc[lane - 1];
        } else {
          htop = srcH[t];
          f = first ? mx(srcF[t] - R, srcH[t] - Q) : srcF[t];
          c = J.s[t];
        }
        fb[lane] = lane_column<T, CH, LOCAL>(L[lane], prof.data() + c * WARP + lane,
                                             ALPHA * WARP, htop, f, Q, R, j, slast[lane]);
        hb[lane] = L[lane].H[CH - 1];
        code[lane] = c;
        if (slast[lane] >= 0) {
          ((T*)J.botH)[j] = L[lane].hl;
          ((T*)J.botF)[j] = L[lane].fl;
        }
        if (feed && lane == WARP - 1) {
          outH[j] = hb[lane];
          outF[j] = fb[lane];
        }
      }
    }
    for (int lane = 0; lane < WARP; ++lane)
      lane_finish<T, CH, LOCAL>(L[lane], J, (ks * WARP + lane) * CH);
  }
}

#endif

template <int CH, typename Stream>
static void dispatch_ch(const Args& a, int local, int wide, Stream stream) {
  if (wide)
    local ? launch<int64_t, CH, true>(a, stream) : launch<int64_t, CH, false>(a, stream);
  else
    local ? launch<int32_t, CH, true>(a, stream) : launch<int32_t, CH, false>(a, stream);
}

// Returns 0, or -1 for a band height without an instantiation.
template <typename Stream>
static int dispatch(const Args& a, int local, int wide, int ch, Stream stream) {
  switch (ch) {
    case 4: dispatch_ch<4>(a, local, wide, stream); return 0;
    case 8: dispatch_ch<8>(a, local, wide, stream); return 0;
    default: return -1;
  }
}

static Args make_args(const void* jobs, const void* stripe_job, int stripes,
                      const void* matrix, long long gap_q, long long gap_r,
                      void* progress, void* ticket) {
  Args a;
  a.jobs = (const Job*)jobs;
  a.stripe_job = (const int32_t*)stripe_job;
  a.stripes = stripes;
  a.matrix = (const int32_t*)matrix;
  a.gap_q = gap_q;
  a.gap_r = gap_r;
  a.progress = (int*)progress;
  a.ticket = (int*)ticket;
  return a;
}

}  // namespace k2

extern "C" {

// Stripe-edge row buffers the caller allocates per tile: (2, RING, cols).
int k2_ring_slots() { return k2::RING; }

// 64-bit words per job in the table the caller builds.
int k2_job_words() { return (int)(sizeof(k2::Job) / 8); }

#ifdef __CUDACC__
// Enqueue K2 on `stream`: one block (one warp) per stripe of 32 * ch rows,
// over the stripes of every job. Returns cudaGetLastError(), or -1 for an
// unsupported ch.
int k2_ring_block(const void* jobs, const void* stripe_job, int stripes,
                  const void* matrix, long long gap_q, long long gap_r, int local,
                  int wide, int ch, void* progress, void* ticket, void* stream) {
  k2::Args a = k2::make_args(jobs, stripe_job, stripes, matrix, gap_q, gap_r, progress,
                             ticket);
  if (k2::dispatch(a, local, wide, ch, (cudaStream_t)stream) != 0) return -1;
  return (int)cudaGetLastError();
}
#else
// The same computation on the host; returns 0, or -1 for an unsupported ch.
int k2_ring_block_host(const void* jobs, const void* stripe_job, int stripes,
                       const void* matrix, long long gap_q, long long gap_r,
                       int local, int wide, int ch) {
  k2::Args a = k2::make_args(jobs, stripe_job, stripes, matrix, gap_q, gap_r, nullptr,
                             nullptr);
  return k2::dispatch(a, local, wide, ch, (void*)nullptr);
}
#endif

}  // extern "C"
