// K3: the SW / NW score of one whole (possibly genome-scale) pair, for Hopper.
//
// Replaces libssa_tpu/ops/longpair_pallas.py::_kernel (the Pallas TPU kernel
// built by _build and called through longpair_score_pallas). It computes what
// libssa_tpu/ops/longpair.py::longpair_score returns: for query codes q (m)
// and subject codes s (n), m, n >= 1, Gotoh affine gaps (Q, R) and a 32x32
// substitution matrix, the SW max of H over all cells floored at 0, or the
// NW cell H[m][n] under the boundaries H[i][0] = -(Q + (i-1) R),
// H[0][j] = -(Q + (j-1) R), H[0][0] = 0. Exact in int32 or int64; the
// wrapper picks int64 where the a-priori bound on |H| reaches 2**31 - 1.
//
// What bounds it on this card: one pair has little parallelism. Only the
// cells of one anti-diagonal are independent, so the work is a pipeline
// whose depth is the number of query rows over the rows a thread owns.
// Each cell costs about ten dependent integer add/max operations and one
// shared-memory read; device memory sees one H/F pair per column at each
// stripe edge. Fill and drain of the pipeline (m / CH steps) and the
// latency of the F chain down a thread's rows bound a single pair more
// than the card's issue rate does.
//
// The design (skewed bands on warps, where the TPU kernel put them on
// vector lanes):
//  * Thread b of a warp owns CH consecutive query rows, with their H and E
//    in registers. At step t it computes its CH cells of column j = t - b.
//    F runs down the CH rows as one scalar: the plain Gotoh recurrence.
//  * Band b needs band b-1's bottom-row H and outgoing F at column j (from
//    step t-1), and its bottom-row H at column j-1 (kept from the previous
//    step as the diagonal). Both arrive by __shfl_up_sync, together with
//    the column's subject code, so the code travels down the warp as a
//    shift register and only lane 0 reads the subject.
//  * One warp is a stripe of 32*CH rows. Lane 31 of stripe k writes its
//    bottom row's H and F per column to row buffer k mod RING and publishes
//    a progress count every CHUNK columns (__threadfence, then a release
//    store). Lane 0 of stripe k+1 reads them as its top boundary: the warp
//    polls with acquire loads and loads CHUNK columns at once, coalesced.
//  * Stripes are taken in ticket order (atomicAdd on a counter zeroed per
//    launch), not by blockIdx: a running stripe only ever waits on one that
//    started before it, so the launch cannot deadlock in any block order.
//  * A ring of RING >= 2 row buffers is safe without further flags: stripe
//    k+RING writes column j only after its own top boundary at column j
//    exists, which needs stripe k+1 to have consumed slot k's column j.
//  * The substitution profile of a lane's CH rows sits in shared memory as
//    [row][symbol][lane]: every lane reads its own bank.
//  * SW: a running max per thread (real rows only), a warp reduce and one
//    atomicMax. NW: the thread owning row m-1 writes H at column n-1.
//  * Templated on the score type (int32, int64), on CH and on local.
//
// The per-lane column update is __host__ __device__ so that a host C++
// compiler builds it too (k3_longpair_host below runs the stripes one
// after another, the 32 lanes in lock-step as a warp runs them), and the
// recurrence, boundaries and skew can be tested on a machine without a GPU.
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define K3_HD __host__ __device__ __forceinline__
#else
#include <vector>
#define K3_HD inline
#endif

namespace k3 {

constexpr int ALPHA = 32;  // padded alphabet
constexpr int WARP = 32;   // lanes (bands) per stripe
constexpr int CHUNK = 32;  // stripe-edge columns published / loaded at once
constexpr int RING = 2;    // stripe-edge row buffers
constexpr long long WAIT_LIMIT_CYCLES = 40LL * 1000 * 1000 * 1000;  // ~20 s

template <typename T> K3_HD T mx(T a, T b) { return a > b ? a : b; }

struct Args {
  const uint8_t* q;       // (m,) query codes, < ALPHA
  int64_t m;
  const uint8_t* s;       // (n,) subject codes, < ALPHA
  int n;
  const int32_t* matrix;  // (ALPHA, ALPHA)
  int64_t gap_q, gap_r;
  int stripes;            // ceil(m / (WARP * CH))
  void* bufH;             // (RING, n) of T: stripe-edge H rows
  void* bufF;             // (RING, n) of T: stripe-edge F rows
  int* progress;          // (stripes,) columns published; zero at launch
  int* ticket;            // stripe counter; zero at launch
  void* result;           // (1,) of T; zero at launch
};

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
// entering the band's first row; pc[s * stride]: sub(q[r0+s], column code).
// Returns the F leaving the band's last row; its H is L.H[CH-1].
template <typename T, int CH, bool LOCAL>
K3_HD T lane_column(Lane<T, CH>& L, const int32_t* pc, int stride, T htop, T f,
                    int64_t m, T Q, T R) {
  const bool full = L.r0 + CH <= m;
  T diag = L.diag_top;
  L.diag_top = htop;
#pragma unroll
  for (int s = 0; s < CH; ++s) {
    const T e = mx(L.E[s] - R, L.H[s] - Q);
    T h = mx(mx(diag + (T)pc[s * stride], e), f);
    if (LOCAL) h = mx(h, (T)0);
    diag = L.H[s];
    L.H[s] = h;
    L.E[s] = e;
    if (LOCAL && (full || L.r0 + s < m)) L.best = mx(L.best, h);
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

template <typename T, int CH, bool LOCAL>
__global__ void __launch_bounds__(WARP) longpair_kernel(Args a) {
  __shared__ int32_t prof[CH * ALPHA * WARP];  // [row][symbol][lane]
  constexpr unsigned FULL = 0xffffffffu;
  const int lane = threadIdx.x;
  int k = 0;
  if (lane == 0) k = atomicAdd(a.ticket, 1);
  k = __shfl_sync(FULL, k, 0);
  const int64_t r0 = ((int64_t)k * WARP + lane) * CH;
  for (int s = 0; s < CH; ++s) {
    const int64_t row = r0 + s;
    const int qc = row < a.m ? a.q[row] : ALPHA - 1;
    for (int c = 0; c < ALPHA; ++c)
      prof[(s * ALPHA + c) * WARP + lane] = a.matrix[qc * ALPHA + c];
  }
  __syncwarp();

  const T Q = (T)a.gap_q, R = (T)a.gap_r;
  Lane<T, CH> L;
  lane_init<T, CH, LOCAL>(L, r0, Q, R);
  const int n = a.n;
  const bool first = k == 0;
  const bool feed = k + 1 < a.stripes;  // a stripe below reads this one
  T* outH = (T*)a.bufH + (size_t)(k % RING) * n;
  T* outF = (T*)a.bufF + (size_t)(k % RING) * n;
  const T* inH = (const T*)a.bufH + (size_t)((k + RING - 1) % RING) * n;
  const T* inF = (const T*)a.bufF + (size_t)((k + RING - 1) % RING) * n;
  const int* above = a.progress + (k > 0 ? k - 1 : 0);

  T hb = 0, fb = 0;  // the last column's bottom H and leaving F
  int code = 0;      // that column's subject code
  T chH = 0, chF = 0;
  int chS = 0;       // this lane's element of the current chunk
  const int steps = n + WARP - 1;
  for (int t = 0; t < steps; ++t) {
    const int j = t - lane;
    // Column j's top boundary and code, from lane-1's step t-1.
    T htop = __shfl_up_sync(FULL, hb, 1);
    T f = __shfl_up_sync(FULL, fb, 1);
    int c = __shfl_up_sync(FULL, code, 1);
    if (t % CHUNK == 0 && t < n) {  // warp-uniform: the next chunk
      const int col = t + lane;
      if (!first) {
        const int need = min(t + CHUNK, n);
        const long long t0 = clock64();
        while (ld_acquire(above) < need) {
          __nanosleep(32);
          // The stripe above started before this one and publishes every
          // CHUNK columns: a wait of seconds is a fault. Fail the launch
          // rather than hang the card.
          if (clock64() - t0 > WAIT_LIMIT_CYCLES) __trap();
        }
      }
      if (col < n) {
        chS = a.s[col];
        if (!first) {
          chH = inH[col];
          chF = inF[col];
        }
      }
      __syncwarp();
    }
    const int src = t % CHUNK;
    const int c0 = __shfl_sync(FULL, chS, src);
    if (first) {
      if (lane == 0) {
        htop = LOCAL ? (T)0 : -(Q + (T)t * R);  // H[0][t+1]
        f = htop - Q;                           // F[1][t+1]
        c = c0;
      }
    } else {
      const T h0 = __shfl_sync(FULL, chH, src);
      const T f0 = __shfl_sync(FULL, chF, src);
      if (lane == 0) {
        htop = h0;
        f = f0;
        c = c0;
      }
    }
    if (j >= 0 && j < n) {
      fb = lane_column<T, CH, LOCAL>(L, prof + c * WARP + lane, ALPHA * WARP,
                                     htop, f, a.m, Q, R);
      hb = L.H[CH - 1];
      code = c;
      if (!LOCAL && j == n - 1) lane_capture<T, CH>(L, a.m, (T*)a.result);
      if (feed && lane == WARP - 1) {
        outH[j] = hb;
        outF[j] = fb;
        if ((j + 1) % CHUNK == 0 || j == n - 1) {
          __threadfence();
          st_release(a.progress + k, j + 1);
        }
      }
    }
  }
  if (LOCAL) {
    T best = L.best;
#pragma unroll
    for (int d = WARP / 2; d > 0; d /= 2) best = mx(best, __shfl_down_sync(FULL, best, d));
    if (lane == 0) atomic_max((T*)a.result, best);
  }
}

template <typename T, int CH, bool LOCAL>
static void launch(const Args& a, cudaStream_t stream) {
  longpair_kernel<T, CH, LOCAL><<<a.stripes, WARP, 0, stream>>>(a);
}

#else  // host build: stripes one after another, lanes in lock-step

template <typename T, int CH, bool LOCAL>
static void launch(const Args& a, void*) {
  const int n = a.n;
  const T Q = (T)a.gap_q, R = (T)a.gap_r;
  std::vector<int32_t> prof(CH * ALPHA * WARP);
  T result = 0;
  for (int k = 0; k < a.stripes; ++k) {
    Lane<T, CH> L[WARP];
    T hb[WARP] = {}, fb[WARP] = {}, ph[WARP], pf[WARP];
    int code[WARP] = {}, pc[WARP];
    for (int lane = 0; lane < WARP; ++lane) {
      const int64_t r0 = ((int64_t)k * WARP + lane) * CH;
      for (int s = 0; s < CH; ++s) {
        const int64_t row = r0 + s;
        const int qc = row < a.m ? a.q[row] : ALPHA - 1;
        for (int c = 0; c < ALPHA; ++c)
          prof[(s * ALPHA + c) * WARP + lane] = a.matrix[qc * ALPHA + c];
      }
      lane_init<T, CH, LOCAL>(L[lane], r0, Q, R);
    }
    const bool first = k == 0;
    const bool feed = k + 1 < a.stripes;
    T* outH = (T*)a.bufH + (size_t)(k % RING) * n;
    T* outF = (T*)a.bufF + (size_t)(k % RING) * n;
    const T* inH = (const T*)a.bufH + (size_t)((k + RING - 1) % RING) * n;
    const T* inF = (const T*)a.bufF + (size_t)((k + RING - 1) % RING) * n;
    for (int t = 0; t < n + WARP - 1; ++t) {
      for (int lane = 0; lane < WARP; ++lane) {  // the previous step's values
        ph[lane] = hb[lane];
        pf[lane] = fb[lane];
        pc[lane] = code[lane];
      }
      for (int lane = 0; lane < WARP; ++lane) {
        const int j = t - lane;
        if (j < 0 || j >= n) continue;
        T htop, f;
        int c;
        if (lane > 0) {
          htop = ph[lane - 1];
          f = pf[lane - 1];
          c = pc[lane - 1];
        } else if (first) {
          htop = LOCAL ? (T)0 : -(Q + (T)t * R);
          f = htop - Q;
          c = a.s[t];
        } else {
          htop = inH[t];
          f = inF[t];
          c = a.s[t];
        }
        fb[lane] = lane_column<T, CH, LOCAL>(L[lane], prof.data() + c * WARP + lane,
                                             ALPHA * WARP, htop, f, a.m, Q, R);
        hb[lane] = L[lane].H[CH - 1];
        code[lane] = c;
        if (!LOCAL && j == n - 1) lane_capture<T, CH>(L[lane], a.m, &result);
        if (feed && lane == WARP - 1) {
          outH[j] = hb[lane];
          outF[j] = fb[lane];
        }
      }
    }
    if (LOCAL)
      for (int lane = 0; lane < WARP; ++lane) result = mx(result, L[lane].best);
  }
  *(T*)a.result = result;
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

static Args make_args(const void* q, long long m, const void* s, int n,
                      const void* matrix, long long gap_q, long long gap_r,
                      int stripes, void* bufH, void* bufF, void* progress,
                      void* ticket, void* result) {
  Args a;
  a.q = (const uint8_t*)q;
  a.m = m;
  a.s = (const uint8_t*)s;
  a.n = n;
  a.matrix = (const int32_t*)matrix;
  a.gap_q = gap_q;
  a.gap_r = gap_r;
  a.stripes = stripes;
  a.bufH = bufH;
  a.bufF = bufF;
  a.progress = (int*)progress;
  a.ticket = (int*)ticket;
  a.result = result;
  return a;
}

}  // namespace k3

extern "C" {

// Stripe-edge row buffers the caller allocates: (RING, n) each for H and F.
int k3_ring_slots() { return k3::RING; }

#ifdef __CUDACC__
// Enqueue K3 on `stream`: one block (one warp) per stripe of 32 * ch rows.
// Returns cudaGetLastError(), or -1 for an unsupported ch.
int k3_longpair(const void* q, long long m, const void* s, int n,
                const void* matrix, long long gap_q, long long gap_r, int local,
                int wide, int ch, int stripes, void* bufH, void* bufF,
                void* progress, void* ticket, void* result, void* stream) {
  k3::Args a = k3::make_args(q, m, s, n, matrix, gap_q, gap_r, stripes, bufH,
                             bufF, progress, ticket, result);
  if (k3::dispatch(a, local, wide, ch, (cudaStream_t)stream) != 0) return -1;
  return (int)cudaGetLastError();
}
#else
// The same computation on the host; returns 0, or -1 for an unsupported ch.
int k3_longpair_host(const void* q, long long m, const void* s, int n,
                     const void* matrix, long long gap_q, long long gap_r,
                     int local, int wide, int ch, int stripes, void* bufH,
                     void* bufF, void* result) {
  k3::Args a = k3::make_args(q, m, s, n, matrix, gap_q, gap_r, stripes, bufH,
                             bufF, nullptr, nullptr, result);
  return k3::dispatch(a, local, wide, ch, (void*)nullptr);
}
#endif

}  // extern "C"
