// The leaves of one Myers-Miller frontier pass, solved together on the card.
//
// Replaces no TPU kernel: the JAX package solves every leaf on the host
// (search/hirschberg.py's _ops_leaf, native/leafalign.cpp), one call a leaf.
// The port did the same until the host's leaf fills became the largest block
// of a long pair's traceback: a 16,569 x 16,554 NW pair spends about half its
// time filling 32 leaves of about 518 x 517 cells one after another, while the
// card, which holds the pair's codes already (ops/mm_device.DevicePair), waits.
// One launch takes every leaf of a pass (the wrapper is ops/leaf_cuda.py) and
// writes each leaf's ops; the host fetches them in one copy.
//
// Semantics are exactly csrc/leafalign.cpp's and hirschberg._ops_small's
// (min-cost form, gap(L) = g + h*L): the boundary contract (a vertical run
// down column 0 opens at tb, one up column n at te), E by the row
// recurrence, C preferring the diagonal, then D, then E, the Dopen/Eopen
// flags set on equality with the freshly opened candidate, the te tail scan
// taking the first minimum over k, and the walk starting in state C.
//
// What bounds it on this card: a leaf is one small DP, and only the cells of
// one anti-diagonal are independent, so a leaf's fill is a chain of steps,
// each a short chain of dependent integer operations and shuffles: latency,
// not the issue rate or device memory, sets its time. Its bytes are few: one
// direction byte a cell written once and read once by the walk (about 8.6 MB
// for the pass above, which stays in the 50 MB L2), the codes read once.
//
// The design:
//  * One warp (one block) a leaf; leaves run side by side on the SMs.
//  * A stripe is 32 consecutive rows, lane t holds row r0 + t, and at step k
//    lane t computes column j = k - t + 1 (the anti-diagonal wavefront). Lane
//    t takes C and D of the cell above from lane t-1's previous step by
//    __shfl_up_sync and keeps the one before as the diagonal; E and the left
//    C stay in its registers.
//  * Between stripes, the rows' C and D go through a global carry row of n + 1
//    entries a leaf: lane 31 stores its row in place, and lane 0 of the next
//    stripe reads it, 32 columns a chunk, a chunk ahead, loaded by all 32
//    lanes at once and passed to lane 0 by __shfl_sync. Lane 31 writes column
//    x at step x + 30, after every load of it (at most at step x - 33); a
//    __syncwarp at each chunk orders the two.
//  * Each lane keeps its column's substitution costs in a profile in shared
//    memory ([symbol][lane]: every lane reads its own bank), rebuilt a stripe.
//  * A lane gathers its last 8 direction bytes in a 64-bit register and
//    stores them at once (row-major, each row padded to 8 bytes), so a step
//    stores about 4 words, not 32 bytes.
//  * C's column n goes to the carry too, for the te tail scan. After a
//    __syncwarp, lane 0 walks the leaf back and writes its ops from the end
//    of the leaf's slot, so they come out in order.
//  * Templated on the DP type: int32 where the wrapper's bound shows that no
//    value of the launch's leaves can overflow, else int64.
//
// The cell update, the lane's step, the chunk loads and the walk are
// __host__ __device__, and a host C++ compiler builds the whole file
// (lb_leaf_batch_host below runs each leaf's stripes step by step, the 32
// lanes in the lock-step of a warp, passing values between lanes as the
// shuffles do), so the recurrence, the skew, the carry and the walk are
// tested on a machine with no GPU.
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define LB_HD __host__ __device__ __forceinline__
#else
#include <vector>
#define LB_HD inline
#endif

namespace lb {

constexpr int ALPHA = 32;  // padded alphabet
constexpr int WARP = 32;   // lanes (rows) a stripe
constexpr int PACK = 8;    // direction bytes a lane stores at once

// One leaf, as the wrapper lays out its table: nine 64-bit words.
struct Leaf {
  int64_t q_off, m;   // query window into the code buffer, m >= 1
  int64_t s_off, n;   // subject window, n >= 1
  int64_t tb, te;     // boundary vertical-gap opens
  int64_t dir_off;    // bytes: m rows of dir_stride(n) direction bytes
  int64_t carry_off;  // elements of T: C and D rows (n + 1 each), C's column n (m + 1)
  int64_t ops_off;    // bytes into the ops region: a slot of m + n
};
static_assert(sizeof(Leaf) == 9 * 8, "the wrapper writes 9 words a leaf");

struct Args {
  const uint8_t* q;      // query codes, < ALPHA
  const uint8_t* s;      // subject codes, < ALPHA
  const Leaf* leaves;
  int64_t count;         // leaves
  const int32_t* cost;   // (ALPHA, ALPHA) substitution costs (-score)
  int64_t g, h;          // gap open beyond the first extend, extend
  uint8_t* dir;          // direction bytes, scratch
  void* carry;           // of T, scratch
  uint8_t* out;          // (count,) int32 op counts, then the ops region
};

LB_HD int64_t dir_stride(int64_t n) { return (n + PACK - 1) / PACK * PACK; }

template <typename T> LB_HD T inf() { return (T)1 << (sizeof(T) * 8 - 4); }

// Where one leaf's data lie.
template <typename T>
struct View {
  const uint8_t* q;
  const uint8_t* s;
  uint8_t* dir;
  T* cc;     // C of the carry row, columns 0 .. n
  T* cd;     // D of the carry row
  T* ccoln;  // C[i][n], i = 0 .. m
  uint8_t* slot_end;
};

template <typename T>
LB_HD View<T> view(const Args& a, const Leaf& f) {
  View<T> v;
  v.q = a.q + f.q_off;
  v.s = a.s + f.s_off;
  v.dir = a.dir + f.dir_off;
  v.cc = (T*)a.carry + f.carry_off;
  v.cd = v.cc + f.n + 1;
  v.ccoln = v.cd + f.n + 1;
  v.slot_end = a.out + 4 * a.count + f.ops_off + f.m + f.n;
  return v;
}

// One cell of the fill, leafalign.cpp's update: C, D and E of (i, j) from
// C[i-1][j-1], C and D of (i-1, j), C and E of (i, j-1) and the cost w
// (gh = g + h).
// Returns the direction byte: bits 0-1 C's source (0 diagonal, 1 D, 2 E),
// bit 2 Dopen, bit 3 Eopen.
template <typename T>
LB_HD uint32_t cell(T c_diag, T c_up, T d_up, T c_left, T e_left, T w, T gh, T h,
                    T& c, T& d, T& e) {
  const T open_d = c_up + gh;  // gh = g + h
  const T dv = (d_up + h < open_d) ? d_up + h : open_d;
  const T cand = c_diag + w;
  const T cnof = (dv < cand) ? dv : cand;
  const T open_e = c_left + gh;
  const T ev = (e_left + h < open_e) ? e_left + h : open_e;
  const T cv = (cnof < ev) ? cnof : ev;
  const uint32_t cdir = (cv == cand) ? 0u : (cv == dv) ? 1u : 2u;
  c = cv;
  d = dv;
  e = ev;
  return cdir | ((uint32_t)(dv == open_d) << 2) | ((uint32_t)(ev == open_e) << 3);
}

// Row 0 at column j: C[0][j] (0 at the corner, else g + h*j) and D = C + g.
template <typename T>
LB_HD void init_top(const View<T>& v, int64_t n, int j, T g, T h) {
  const T c = j ? g + h * (T)j : (T)0;
  v.cc[j] = c;
  v.cd[j] = c + g;
  if (j == n) v.ccoln[0] = c;
}

// Lane t's column of the shared profile, for its row's query code.
LB_HD void fill_profile(int32_t* prof, const int32_t* cost, int code, int t) {
  for (int c = 0; c < ALPHA; ++c) prof[c * WARP + t] = cost[code * ALPHA + c];
}

// A leaf's sizes and gaps as the fill uses them (the wrapper keeps m + n
// below 2**31).
template <typename T>
struct Dims {
  int m, n;
  T gh, h;  // g + h, h
};

template <typename T>
struct Lane {
  int i;         // 1-based row; past m where the lane has none
  T diag;        // C[i][j-1] of the row above: the next cell's diagonal
  T left, e;     // C and E of the lane's last cell
  T c, d;        // C and D of the lane's last cell, for lane t + 1
  T w;           // the cost of the lane's next cell
  uint64_t buf;  // the lane's last direction bytes, newest highest
  uint8_t* row;  // the lane's row of direction bytes
};

// Lane t at the start of the stripe holding row i: the left boundary
// C[i][0] = tb + h*i, above it C[i-1][0], and E unopened.
template <typename T>
LB_HD Lane<T> lane_start(const Leaf& f, const View<T>& v, const int32_t* prof, int t,
                         int i, T h) {
  Lane<T> L;
  const T tb = (T)f.tb;
  L.i = i;
  L.diag = i == 1 ? (T)0 : tb + h * (T)(i - 1);
  L.left = tb + h * (T)i;
  L.e = inf<T>();
  L.c = L.d = 0;
  L.w = i <= f.m ? (T)prof[v.s[0] * WARP + t] : (T)0;
  L.buf = 0;
  L.row = v.dir + (int64_t)(i - 1) * dir_stride(f.n);
  return L;
}

LB_HD void store8(uint8_t* p, uint64_t x) {
#ifdef __CUDA_ARCH__
  *(uint64_t*)p = x;
#else
  memcpy(p, &x, 8);
#endif
}

// Lane t at step k: the cell (i, k - t + 1), with C and D of the cell above
// it (up_c, up_d). GUARD: the cell may lie outside the leaf (the stripe's
// first and last WARP - 1 steps, or a stripe with rows past m); without it
// every lane's cell lies inside.
template <bool GUARD, typename T>
LB_HD void lane_step(Lane<T>& L, int t, int k, T up_c, T up_d, const Dims<T>& z,
                     const View<T>& v, const int32_t* prof) {
  const int j = k - t + 1;
  if (GUARD && (L.i > z.m || j < 1 || j > z.n)) return;
  const T w = L.w;
  if (j < z.n) L.w = (T)prof[v.s[j] * WARP + t];  // the next column's, off the chain
  T c, d, e;
  const uint32_t b = cell<T>(L.diag, up_c, up_d, L.left, L.e, w, z.gh, z.h, c, d, e);
  L.diag = up_c;
  L.left = c;
  L.e = e;
  L.c = c;
  L.d = d;
  L.buf = (L.buf >> 8) | ((uint64_t)b << 56);
  const int r = j & (PACK - 1);
  if (j == z.n) {
    v.ccoln[L.i] = c;
    if (r) L.buf >>= 8 * (PACK - r);  // the row's last bytes to the bottom
  }
  if (r == 0 || j == z.n) store8(L.row + ((j - 1) & ~(PACK - 1)), L.buf);
  if (t == WARP - 1 && L.i < z.m) {  // a stripe follows: it reads this row
    v.cc[j] = c;
    v.cd[j] = d;
  }
}

// The stripe's steps: [0, WARP - 1) and [n, n + WARP - 1) guarded, and
// between them unguarded where every lane has a row.
LB_HD int steady_end(int r0, int m, int n) { return r0 + WARP <= m ? n : 0; }

// C and D of the carry row at column `col`, where it lies in the leaf.
template <typename T>
LB_HD void load_chunk(const View<T>& v, int n, int col, T& c, T& d) {
  if (col <= n) {
    c = v.cc[col];
    d = v.cd[col];
  }
}

// The te tail scan and the walk back from (m, n) in state C, as
// leafalign.cpp; writes the ops backwards from v.slot_end and returns their
// count.
template <typename T>
LB_HD int64_t walk(const Leaf& f, const View<T>& v, T h) {
  const int64_t m = f.m, n = f.n, stride = dir_stride(n);
  uint8_t* end = v.slot_end;
  int64_t i = m, j = n, pos = 0;
  T best = inf<T>();
  int64_t kbest = 1;
  for (int64_t k = 1; k <= m; ++k) {  // the first minimum, as np.argmin
    const T tk = v.ccoln[m - k] + (T)f.te + (T)k * h;
    if (tk < best) {
      best = tk;
      kbest = k;
    }
  }
  if (best < v.ccoln[m]) {
    for (int64_t k = 0; k < kbest; ++k) end[-1 - pos++] = 'D';
    i -= kbest;
  }
  int state = 0;  // 0 = C, 1 = D, 2 = E
  while (i > 0 && j > 0) {
    const uint32_t b = v.dir[(i - 1) * stride + (j - 1)];
    if (state == 0) {
      const uint32_t src = b & 3;
      if (src == 0) {
        end[-1 - pos++] = 'M';
        --i;
        --j;
      } else {
        state = (int)src;
      }
    } else if (state == 1) {
      end[-1 - pos++] = 'D';
      --i;
      if ((b >> 2) & 1) state = 0;
    } else {
      end[-1 - pos++] = 'I';
      --j;
      if ((b >> 3) & 1) state = 0;
    }
  }
  while (i-- > 0) end[-1 - pos++] = 'D';
  while (j-- > 0) end[-1 - pos++] = 'I';
  return pos;
}

#ifdef __CUDACC__

constexpr unsigned FULL = 0xffffffffu;

// One step of lane t's warp: every 32 steps the next chunk of the carry row,
// then the shuffles, then the lane's cell.
template <bool GUARD, typename T>
__device__ __forceinline__ void warp_step(Lane<T>& L, int t, int k, T& cur_c, T& cur_d,
                                          T& nxt_c, T& nxt_d, const Dims<T>& z,
                                          const View<T>& v, const int32_t* prof) {
  if (k && (k & (WARP - 1)) == 0) {
    __syncwarp();
    cur_c = nxt_c;
    cur_d = nxt_d;
    load_chunk(v, z.n, k + 1 + WARP + t, nxt_c, nxt_d);
  }
  T up_c = __shfl_up_sync(FULL, L.c, 1);
  T up_d = __shfl_up_sync(FULL, L.d, 1);
  const T top_c = __shfl_sync(FULL, cur_c, k & (WARP - 1));
  const T top_d = __shfl_sync(FULL, cur_d, k & (WARP - 1));
  if (t == 0) {
    up_c = top_c;
    up_d = top_d;
  }
  lane_step<GUARD>(L, t, k, up_c, up_d, z, v, prof);
}

template <typename T>
__global__ void __launch_bounds__(WARP) leaf_kernel(Args a) {
  __shared__ int32_t prof[ALPHA * WARP];
  const Leaf f = a.leaves[blockIdx.x];
  const View<T> v = view<T>(a, f);
  const int t = threadIdx.x;
  const T g = (T)a.g, h = (T)a.h;
  const Dims<T> z{(int)f.m, (int)f.n, g + h, h};
  for (int j = t; j <= z.n; j += WARP) init_top(v, f.n, j, g, h);
  __syncwarp();
  for (int r0 = 0; r0 < z.m; r0 += WARP) {
    const int i = r0 + t + 1;
    fill_profile(prof, a.cost, i <= z.m ? v.q[i - 1] : 0, t);
    Lane<T> L = lane_start(f, v, prof, t, i, h);
    T cur_c = 0, cur_d = 0, nxt_c = 0, nxt_d = 0;
    load_chunk(v, z.n, 1 + t, cur_c, cur_d);
    load_chunk(v, z.n, 1 + WARP + t, nxt_c, nxt_d);
    const int steps = z.n + WARP - 1, mid = steady_end(r0, z.m, z.n);
    int k = 0;
    for (; k < WARP - 1; ++k) warp_step<true>(L, t, k, cur_c, cur_d, nxt_c, nxt_d, z, v, prof);
    for (; k < mid; ++k) warp_step<false>(L, t, k, cur_c, cur_d, nxt_c, nxt_d, z, v, prof);
    for (; k < steps; ++k) warp_step<true>(L, t, k, cur_c, cur_d, nxt_c, nxt_d, z, v, prof);
    __syncwarp();
  }
  if (t == 0) ((int32_t*)a.out)[blockIdx.x] = (int32_t)walk(f, v, h);
}

template <typename T>
static int launch(const Args& a, cudaStream_t stream) {
  leaf_kernel<T><<<(unsigned)a.count, WARP, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
static int attrs(int* out) {
  cudaFuncAttributes fa;
  const int rc = (int)cudaFuncGetAttributes(&fa, (const void*)leaf_kernel<T>);
  out[0] = fa.numRegs;
  out[1] = (int)fa.localSizeBytes;
  return rc;
}

#else  // host build: leaves in turn, each stripe's steps in order, lanes in lock-step

template <typename T>
static void leaf_host(const Args& a, int64_t b) {
  const Leaf f = a.leaves[b];
  const View<T> v = view<T>(a, f);
  const T g = (T)a.g, h = (T)a.h;
  const Dims<T> z{(int)f.m, (int)f.n, g + h, h};
  std::vector<int32_t> prof(ALPHA * WARP);
  for (int j = 0; j <= z.n; ++j) init_top(v, f.n, j, g, h);
  for (int r0 = 0; r0 < z.m; r0 += WARP) {
    Lane<T> L[WARP];
    T cur_c[WARP] = {}, cur_d[WARP] = {}, nxt_c[WARP] = {}, nxt_d[WARP] = {};
    for (int t = 0; t < WARP; ++t) {
      const int i = r0 + t + 1;
      fill_profile(prof.data(), a.cost, i <= z.m ? v.q[i - 1] : 0, t);
      L[t] = lane_start(f, v, prof.data(), t, i, h);
      load_chunk(v, z.n, 1 + t, cur_c[t], cur_d[t]);
      load_chunk(v, z.n, 1 + WARP + t, nxt_c[t], nxt_d[t]);
    }
    const int steps = z.n + WARP - 1, mid = steady_end(r0, z.m, z.n);
    for (int k = 0; k < steps; ++k) {
      if (k && (k & (WARP - 1)) == 0) {
        for (int t = 0; t < WARP; ++t) {
          cur_c[t] = nxt_c[t];
          cur_d[t] = nxt_d[t];
          load_chunk(v, z.n, k + 1 + WARP + t, nxt_c[t], nxt_d[t]);
        }
      }
      T up_c[WARP], up_d[WARP];  // every lane's shuffles, before any lane steps
      for (int t = 0; t < WARP; ++t) {
        up_c[t] = t ? L[t - 1].c : cur_c[k & (WARP - 1)];
        up_d[t] = t ? L[t - 1].d : cur_d[k & (WARP - 1)];
      }
      const bool guard = k < WARP - 1 || k >= mid;
      for (int t = 0; t < WARP; ++t) {
        if (guard)
          lane_step<true>(L[t], t, k, up_c[t], up_d[t], z, v, prof.data());
        else
          lane_step<false>(L[t], t, k, up_c[t], up_d[t], z, v, prof.data());
      }
    }
  }
  ((int32_t*)a.out)[b] = (int32_t)walk(f, v, h);
}

#endif

}  // namespace lb

extern "C" {

// 64-bit words a leaf in the table the caller builds.
int lb_leaf_words() { return (int)(sizeof(lb::Leaf) / 8); }

// Direction bytes a row of a leaf of n columns.
long long lb_dir_stride(long long n) { return (long long)lb::dir_stride(n); }

#ifdef __CUDACC__
// Enqueue the leaves on `stream`, one warp each. Returns cudaGetLastError(),
// or -1 for no leaves.
int lb_leaf_batch(const void* q, const void* s, const void* leaves, long long count,
                  const void* cost, long long g, long long h, void* dir, void* carry,
                  void* out, int wide, void* stream) {
  if (count < 1) return -1;
  const lb::Args a{(const uint8_t*)q, (const uint8_t*)s, (const lb::Leaf*)leaves, count,
                   (const int32_t*)cost, g, h, (uint8_t*)dir, carry, (uint8_t*)out};
  return wide ? lb::launch<int64_t>(a, (cudaStream_t)stream)
              : lb::launch<int32_t>(a, (cudaStream_t)stream);
}

// out: registers and local bytes a thread of the int32 or int64 kernel.
int lb_attrs(int wide, int* out) {
  return wide ? lb::attrs<int64_t>(out) : lb::attrs<int32_t>(out);
}
#else
// The same computation on the host; returns 0, or -1 for no leaves.
int lb_leaf_batch_host(const void* q, const void* s, const void* leaves, long long count,
                       const void* cost, long long g, long long h, void* dir, void* carry,
                       void* out, int wide) {
  if (count < 1) return -1;
  const lb::Args a{(const uint8_t*)q, (const uint8_t*)s, (const lb::Leaf*)leaves, count,
                   (const int32_t*)cost, g, h, (uint8_t*)dir, carry, (uint8_t*)out};
  for (long long b = 0; b < count; ++b) {
    if (wide)
      lb::leaf_host<int64_t>(a, b);
    else
      lb::leaf_host<int32_t>(a, b);
  }
  return 0;
}
#endif

}  // extern "C"
