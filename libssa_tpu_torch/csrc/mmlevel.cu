// A Myers-Miller divide level's staging around K2, on the card.
//
// Replaces no TPU kernel: the JAX package builds a level's boundaries and
// combines its rows with XLA ops (libssa_tpu/ops/mm_device.py). The port did
// the same with about 110 eager PyTorch ops and 11 blocking uploads a level
// (ops/mm_device.DevicePair.bounds and divide_level's t1/t2 combine), and the
// card waited while the host queued each of them. Two small kernels take
// their place (the wrapper is ops/mm_level_cuda.py):
//
//  * the prologue writes K2's left and top boundaries (leftH, leftE, topH,
//    topF) of every tile of a launch from the level's job table: an NW tile's
//    left column opens a vertical gap at its tb, its top row at Q - R, with
//    no gap state on either boundary (E = H - Q + R, F = H - Q + R); an SW
//    tile's boundaries are zeros (ops/ring_block.py has the contract);
//  * the split reads K2's bottom rows (botH, botF) of each node's forward
//    and reverse tile and forms, for j = 0 .. nn,
//      t1[j] = CCf[j] + CCr[nn - j],  t2[j] = DDf[j] + DDr[nn - j] - g,
//    with CC = -botH and DD = -botF shifted by one column, and column 0 of
//    each pass at tb + R * rows. It writes (j1, j2, v1, v2): each row's
//    first minimum and its value, in int64 (a sum of two rows can pass the
//    int32 bound when each row does not), as np.argmin gives them.
//
// What bounds them: a few bytes an element of the level's rows, written
// (prologue) or read (split) once; both are far below K2's time. The
// prologue is a grid of (tiles, slices), each block striding over its
// tile's elements; the split is one block a node, each thread scanning
// every BLOCK-th column and keeping its first minimum, then a tree
// reduction in shared memory that prefers the smaller column on a tie.
//
// The per-thread work and the reduction step are __host__ __device__, and a
// host C++ compiler builds the whole file (the *_host entry points below
// run every block's threads in turn and the tree in the kernel's order), so
// the formulas, the offsets and the tie-break are tested on a machine with
// no GPU.
#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define ML_HD __host__ __device__ __forceinline__
#else
#include <vector>
#define ML_HD inline
#endif

namespace mml {

constexpr int BLOCK = 256;         // prologue threads a block
constexpr int SPLIT_BLOCK = 1024;  // split threads a block (one block a node)
constexpr int64_t NONE = INT64_MAX;

// One tile of a K2 launch, as the wrapper lays out the level's table: six
// 64-bit words. Offsets are elements of the flat boundary and output arrays.
struct Job {
  int64_t left_off;  // leftH: rows + 1 elements from here
  int64_t rows_off;  // leftE: rows elements
  int64_t cols_off;  // topH, topF, botH, botF: cols elements
  int64_t rows, cols;
  int64_t tb;        // the left column's vertical-gap open (NW)
};
static_assert(sizeof(Job) == 6 * 8, "the wrapper writes 6 words a tile");

// H along an NW DP's first column or row at index k: 0 at k = 0, else
// -(opens + R k) (mm_level_cuda.open_edge).
ML_HD int64_t open_edge(int64_t opens, int64_t k, int64_t R) {
  return k == 0 ? 0 : -(opens + R * k);
}

// Thread t of slice y of `spread` writes every (spread * BLOCK)-th element
// of one tile's boundaries: leftH (rows + 1), then leftE (rows), then topH
// and topF together (cols).
template <typename T>
ML_HD void prologue_thread(const Job& b, int y, int spread, int t, int local, int64_t Q,
                           int64_t R, T* leftH, T* leftE, T* topH, T* topF) {
  const int64_t total = 2 * b.rows + 1 + b.cols;
  const int64_t stride = (int64_t)spread * BLOCK;
  const int64_t none = R - Q;  // no gap state: H - Q + R with H = 0 at the origin
  for (int64_t e = (int64_t)y * BLOCK + t; e < total; e += stride) {
    if (e <= b.rows) {
      leftH[b.left_off + e] = (T)(local ? 0 : open_edge(b.tb, e, R));  // H[e][0]
    } else if (e <= 2 * b.rows) {
      const int64_t i = e - b.rows;  // E of row i, 1 .. rows
      leftE[b.rows_off + i - 1] = (T)((local ? 0 : open_edge(b.tb, i, R)) + none);
    } else {
      const int64_t j = e - 2 * b.rows;  // H and F of column j, 1 .. cols
      const int64_t h = local ? 0 : open_edge(Q - R, j, R);
      topH[b.cols_off + j - 1] = (T)h;
      topF[b.cols_off + j - 1] = (T)(h + none);
    }
  }
}

// A row's candidate: its value and column.
struct Best {
  int64_t v, j;
};

// The smaller value, and on a tie the smaller column: np.argmin's first minimum.
ML_HD Best better(Best a, Best b) {
  return (b.v < a.v || (b.v == a.v && b.j < a.j)) ? b : a;
}

// Thread t's first minima of t1 and t2 over columns t, t + nthreads, ...
// of the node whose forward tile is f and reverse tile r.
template <typename T>
ML_HD void split_thread(const Job& f, const Job& r, const T* botH, const T* botF, int64_t g,
                        int64_t R, int t, int nthreads, Best& b1, Best& b2) {
  const int64_t nn = f.cols;
  const int64_t c0f = f.tb + R * f.rows, c0r = r.tb + R * r.rows;  // CC[0] = DD[0]
  b1 = Best{NONE, NONE};
  b2 = Best{NONE, NONE};
  for (int64_t j = t; j <= nn; j += nthreads) {
    const int64_t fi = f.cols_off + j - 1, ri = r.cols_off + nn - j - 1;
    const int64_t hf = j == 0 ? c0f : -(int64_t)botH[fi];
    const int64_t df = j == 0 ? c0f : -(int64_t)botF[fi];
    const int64_t hr = j == nn ? c0r : -(int64_t)botH[ri];
    const int64_t dr = j == nn ? c0r : -(int64_t)botF[ri];
    const int64_t t1 = hf + hr, t2 = df + dr - g;
    if (t1 < b1.v) b1 = Best{t1, j};  // j rises, so the first minimum stays
    if (t2 < b2.v) b2 = Best{t2, j};
  }
}

ML_HD void write_split(int64_t* out, int64_t node, Best b1, Best b2) {
  out[4 * node + 0] = b1.j;
  out[4 * node + 1] = b2.j;
  out[4 * node + 2] = b1.v;
  out[4 * node + 3] = b2.v;
}

#ifdef __CUDACC__

template <typename T>
__global__ void __launch_bounds__(BLOCK) prologue_kernel(const Job* jobs, int local, int64_t Q,
                                                         int64_t R, T* leftH, T* leftE, T* topH,
                                                         T* topF) {
  const Job b = jobs[blockIdx.x];
  prologue_thread<T>(b, (int)blockIdx.y, (int)gridDim.y, (int)threadIdx.x, local, Q, R, leftH,
                     leftE, topH, topF);
}

template <typename T>
__global__ void __launch_bounds__(SPLIT_BLOCK) split_kernel(const Job* jobs, int64_t g, int64_t R,
                                                            const T* botH, const T* botF,
                                                            int64_t* out) {
  __shared__ Best s1[SPLIT_BLOCK], s2[SPLIT_BLOCK];
  const int t = threadIdx.x;
  const int64_t node = blockIdx.x;
  Best b1, b2;
  split_thread<T>(jobs[2 * node], jobs[2 * node + 1], botH, botF, g, R, t, SPLIT_BLOCK, b1, b2);
  s1[t] = b1;
  s2[t] = b2;
  __syncthreads();
  for (int s = SPLIT_BLOCK / 2; s > 0; s >>= 1) {
    if (t < s) {
      s1[t] = better(s1[t], s1[t + s]);
      s2[t] = better(s2[t], s2[t + s]);
    }
    __syncthreads();
  }
  if (t == 0) write_split(out, node, s1[0], s2[0]);
}

#else  // host build: every block's threads in turn, the tree in the kernel's order

template <typename T>
static void prologue_host(const Job* jobs, int64_t count, int spread, int local, int64_t Q,
                          int64_t R, void* leftH, void* leftE, void* topH, void* topF) {
  for (int64_t x = 0; x < count; ++x)
    for (int y = 0; y < spread; ++y)
      for (int t = 0; t < BLOCK; ++t)
        prologue_thread<T>(jobs[x], y, spread, t, local, Q, R, (T*)leftH, (T*)leftE, (T*)topH,
                           (T*)topF);
}

template <typename T>
static void split_host(const Job* jobs, int64_t nodes, int64_t g, int64_t R, const void* botH,
                       const void* botF, int64_t* out) {
  std::vector<Best> s1(SPLIT_BLOCK), s2(SPLIT_BLOCK);
  for (int64_t node = 0; node < nodes; ++node) {
    for (int t = 0; t < SPLIT_BLOCK; ++t)
      split_thread<T>(jobs[2 * node], jobs[2 * node + 1], (const T*)botH, (const T*)botF, g, R,
                      t, SPLIT_BLOCK, s1[t], s2[t]);
    for (int s = SPLIT_BLOCK / 2; s > 0; s >>= 1)
      for (int t = 0; t < s; ++t) {
        s1[t] = better(s1[t], s1[t + s]);
        s2[t] = better(s2[t], s2[t + s]);
      }
    write_split(out, node, s1[0], s2[0]);
  }
}

#endif

}  // namespace mml

extern "C" {

// 64-bit words a tile in the table the caller builds; threads of a
// prologue block and of a split block.
int mml_job_words() { return (int)(sizeof(mml::Job) / 8); }
int mml_block() { return mml::BLOCK; }
int mml_split_block() { return mml::SPLIT_BLOCK; }

#ifdef __CUDACC__
// Enqueue the prologue over `count` tiles on `stream`, `spread` blocks a
// tile. Returns cudaGetLastError(), or -1 for a grid out of range.
int mml_prologue(const void* jobs, long long count, int spread, int local, long long Q,
                 long long R, int wide, void* leftH, void* leftE, void* topH, void* topF,
                 void* stream) {
  if (count < 1 || count > INT32_MAX || spread < 1 || spread > 65535) return -1;
  const dim3 grid((unsigned)count, (unsigned)spread);
  const mml::Job* j = (const mml::Job*)jobs;
  cudaStream_t s = (cudaStream_t)stream;
  if (wide)
    mml::prologue_kernel<int64_t><<<grid, mml::BLOCK, 0, s>>>(
        j, local, Q, R, (int64_t*)leftH, (int64_t*)leftE, (int64_t*)topH, (int64_t*)topF);
  else
    mml::prologue_kernel<int32_t><<<grid, mml::BLOCK, 0, s>>>(
        j, local, Q, R, (int32_t*)leftH, (int32_t*)leftE, (int32_t*)topH, (int32_t*)topF);
  return (int)cudaGetLastError();
}

// Enqueue the split of `nodes` nodes (tiles 2k and 2k + 1 of `jobs`) on
// `stream`, one block a node; out: (nodes, 4) int64. Returns
// cudaGetLastError(), or -1 for a grid out of range.
int mml_split(const void* jobs, long long nodes, long long g, long long R, int wide,
              const void* botH, const void* botF, void* out, void* stream) {
  if (nodes < 1 || nodes > INT32_MAX) return -1;
  const mml::Job* j = (const mml::Job*)jobs;
  cudaStream_t s = (cudaStream_t)stream;
  if (wide)
    mml::split_kernel<int64_t><<<(unsigned)nodes, mml::SPLIT_BLOCK, 0, s>>>(
        j, g, R, (const int64_t*)botH, (const int64_t*)botF, (int64_t*)out);
  else
    mml::split_kernel<int32_t><<<(unsigned)nodes, mml::SPLIT_BLOCK, 0, s>>>(
        j, g, R, (const int32_t*)botH, (const int32_t*)botF, (int64_t*)out);
  return (int)cudaGetLastError();
}
#else
// The same computations on the host; each returns 0, or -1 for no work.
int mml_prologue_host(const void* jobs, long long count, int spread, int local, long long Q,
                      long long R, int wide, void* leftH, void* leftE, void* topH, void* topF) {
  if (count < 1 || spread < 1) return -1;
  const mml::Job* j = (const mml::Job*)jobs;
  if (wide)
    mml::prologue_host<int64_t>(j, count, spread, local, Q, R, leftH, leftE, topH, topF);
  else
    mml::prologue_host<int32_t>(j, count, spread, local, Q, R, leftH, leftE, topH, topF);
  return 0;
}

int mml_split_host(const void* jobs, long long nodes, long long g, long long R, int wide,
                   const void* botH, const void* botF, void* out) {
  if (nodes < 1) return -1;
  const mml::Job* j = (const mml::Job*)jobs;
  if (wide)
    mml::split_host<int64_t>(j, nodes, g, R, botH, botF, (int64_t*)out);
  else
    mml::split_host<int32_t>(j, nodes, g, R, botH, botF, (int64_t*)out);
  return 0;
}
#endif

}  // extern "C"
