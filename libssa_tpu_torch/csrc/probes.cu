// Op-rate probes for Hopper: the counterparts of the TPU probes in
// experiments/ (op_rate_probe.py, r2_rate_probe.py, r2_ilp_probe.py,
// r2_dtype_probe.py, r3_carry_probe.py, r3_roll_probe.py and probe 2 of
// r3_longpair_probe.py). Their Python wrappers are the modules of the same
// names under libssa_tpu_torch/experiments/.
//
// Each TPU probe timed one elementwise op, or one roll, applied many times
// to a tile held in VMEM, and took the slope between two trip counts. Here:
//  * Data is 32-bit words. A word holds one f32 or int32, two bf16 or int16
//    (bf16x2, int16x2: element 0 in the low half) or four int8 / uint8
//    (int8x4, uint8x4: element 0 in the low byte). A packed op is one
//    SIMD-in-word instruction where Hopper has one.
//  * chain_kernel (r2_rate, r2_ilp, r2_dtype): each thread applies op to its
//    words `reps` times, with one dependent accumulator (NS = 1: latency at
//    one warp an SM) or four independent ones (NS = 4: throughput at full
//    occupancy). Elements are independent, so the tile is cut freely.
//  * tile_kernel (op_rate, r2_dtype's rolls, r3_roll, r3_longpair): the tile
//    is cut into lines along the rolled axis; a line of L = G * R words
//    lives in the registers of G lanes of one warp, R a lane. A roll by D
//    along the line renames registers, and moves the words that cross a lane
//    with __shfl_sync. The other axis is independent across lines. The
//    wrapper lays the tile out as lines and back (experiments/_common.py).
//  * carry_kernel (r3_carry): one block of 1024 threads holds an (8, 2048)
//    f32 tile, two columns of 8 rows a thread; a row carried across lanes
//    rolls with __shfl_up_sync within a warp and shared memory across warps.
//
// What bounds them: the issue rate of the op's instruction (or its latency,
// for one chain a thread); memory only at load and store, outside the loop.
// Exactness: f32 products and sums use __fmul_rn / __fadd_rn, which nvcc
// never contracts into an FMA, so every op is rounded as the plain PyTorch
// version rounds it. bf16 ops are single bf16x2 instructions, rounded to
// nearest even.
//
// The per-word ops build for the device under nvcc, and for the host under
// a host C++ compiler, with the DPX and SIMD-in-word intrinsics replaced by
// host functions of their documented semantics: probe_chain_host runs
// chain_kernel's arithmetic there, so the CPU tests can hold it against the
// plain version.
//
// nvcc builds two libraries from this file, in parallel: -DPROBES_CHAIN
// holds probe_chain and its kernels, -DPROBES_TILE probe_tile and
// probe_carry and theirs (the whole file takes twice as long to compile).
// With neither macro, one library holds all three.
#if !defined(PROBES_CHAIN) && !defined(PROBES_TILE)
#define PROBES_CHAIN
#define PROBES_TILE
#endif
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#define PR_HD __device__ __forceinline__
#else
#include <math.h>
#define PR_HD inline
#endif

namespace probes {

enum Type { F32 = 0, BF16X2 = 1, I32 = 2, I16X2 = 3, I8X4 = 4, U8X4 = 5 };

// Ops on (x, b) and the constants c1, c2 (words). ROLL* ops roll x by D
// along its line (tile_kernel only). *_DPX are Hopper's DPX instructions
// (int32 and int16x2 only), each the same function as the op before it.
enum Op {
  ADD = 0,            // x + b
  SUB = 1,            // x - b
  MAX = 2,            // max(x, b)
  WHERE_GT = 3,       // x > b ? x : b
  MAX_ADD = 4,        // max(x + b, b)
  MAX_ADD_DPX = 5,    // __viaddmax(x, b, b)
  SATADD = 6,         // min(x + b, c1)
  MAX3 = 7,           // max(max(x, b), c1)
  MAX3_DPX = 8,       // __vimax3(x, b, c1)
  MAX3_RELU = 9,      // max(max(max(x, b), c1), 0)
  MAX3_RELU_DPX = 10, // __vimax3_relu(x, b, c1)
  DPMIX = 11,         // max(x + b, max(x - c1, x - c2))
  DPMIX_DPX = 12,     // __viaddmax(x, b, __viaddmax(x, -c1, x - c2))
  ADDC = 13,          // x + c1
  MAXMULC = 14,       // max(x, x * c1)
  SELECT = 15,        // x > 0 ? x : x * c1
  MAX3MUL = 16,       // max(x, max(x * c1, x * c2))
  MAXC = 17,          // max(x, c1)
  MAX3ADD = 18,       // max(x, max(x + c1, x + c2))
  MAX3ADD_DPX = 19,   // __vimax3(x, x + c1, x + c2)
  ROLL = 20,          // roll(x)
  ROLL_ADDC = 21,     // roll(x) + c1
  MAX_ROLL_ADDC = 22, // max(x, roll(x) + c1)
  ROLL_ADDB = 23,     // roll(x) + b
  MAX_ROLL_B = 24,    // max(roll(x), b)
  SCAN_MASKED = 25,   // max(x, j >= D ? roll(x) + c1 : c2), j the index in the line
};

// -- host stand-ins for the device intrinsics (documented semantics) --------
#ifndef __CUDACC__
static inline float f_of(uint32_t w) { float f; memcpy(&f, &w, 4); return f; }
static inline uint32_t w_of(float f) { uint32_t w; memcpy(&w, &f, 4); return w; }
static inline float bf2f(uint32_t h) { return f_of((h & 0xffffu) << 16); }
static inline uint32_t f2bf(float f) {  // round to nearest even
  uint32_t u = w_of(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return (u >> 16) | 0x40u;
  u += 0x7fffu + ((u >> 16) & 1u);
  return u >> 16;
}
#endif

// The 16x2 and 8x4 intrinsics as host functions: wrapping adds and
// subtractions, signed or unsigned lane-wise max, min and compares.
#ifndef __CUDACC__
static inline int32_t lane16(uint32_t w, int k) { return (int16_t)(w >> (16 * k)); }
static inline int32_t lane8s(uint32_t w, int k) { return (int8_t)(w >> (8 * k)); }
static inline int32_t lane8u(uint32_t w, int k) { return (uint8_t)(w >> (8 * k)); }
template <class F> static inline uint32_t map16(uint32_t a, uint32_t b, F f) {
  uint32_t r = 0;
  for (int k = 0; k < 2; ++k) r |= ((uint32_t)f(lane16(a, k), lane16(b, k)) & 0xffffu) << (16 * k);
  return r;
}
template <class F> static inline uint32_t map8s(uint32_t a, uint32_t b, F f) {
  uint32_t r = 0;
  for (int k = 0; k < 4; ++k) r |= ((uint32_t)f(lane8s(a, k), lane8s(b, k)) & 0xffu) << (8 * k);
  return r;
}
template <class F> static inline uint32_t map8u(uint32_t a, uint32_t b, F f) {
  uint32_t r = 0;
  for (int k = 0; k < 4; ++k) r |= ((uint32_t)f(lane8u(a, k), lane8u(b, k)) & 0xffu) << (8 * k);
  return r;
}
static inline int imax(int a, int b) { return a > b ? a : b; }
static inline int imin(int a, int b) { return a < b ? a : b; }
static inline uint32_t __vadd2(uint32_t a, uint32_t b) { return map16(a, b, [](int x, int y) { return x + y; }); }
static inline uint32_t __vsub2(uint32_t a, uint32_t b) { return map16(a, b, [](int x, int y) { return x - y; }); }
static inline uint32_t __vmaxs2(uint32_t a, uint32_t b) { return map16(a, b, imax); }
static inline uint32_t __vmins2(uint32_t a, uint32_t b) { return map16(a, b, imin); }
static inline uint32_t __vcmpgts2(uint32_t a, uint32_t b) { return map16(a, b, [](int x, int y) { return x > y ? -1 : 0; }); }
static inline uint32_t __vadd4(uint32_t a, uint32_t b) { return map8u(a, b, [](int x, int y) { return x + y; }); }
static inline uint32_t __vsub4(uint32_t a, uint32_t b) { return map8u(a, b, [](int x, int y) { return x - y; }); }
static inline uint32_t __vmaxs4(uint32_t a, uint32_t b) { return map8s(a, b, imax); }
static inline uint32_t __vmins4(uint32_t a, uint32_t b) { return map8s(a, b, imin); }
static inline uint32_t __vcmpgts4(uint32_t a, uint32_t b) { return map8s(a, b, [](int x, int y) { return x > y ? -1 : 0; }); }
static inline uint32_t __vmaxu4(uint32_t a, uint32_t b) { return map8u(a, b, imax); }
static inline uint32_t __vminu4(uint32_t a, uint32_t b) { return map8u(a, b, imin); }
static inline uint32_t __vcmpgtu4(uint32_t a, uint32_t b) { return map8u(a, b, [](int x, int y) { return x > y ? -1 : 0; }); }
// DPX (CUDA's DPX intrinsics): the add wraps, the max is signed.
static inline int __viaddmax_s32(int a, int b, int c) { return imax((int)((uint32_t)a + (uint32_t)b), c); }
static inline int __vimax3_s32(int a, int b, int c) { return imax(imax(a, b), c); }
static inline int __vimax3_s32_relu(int a, int b, int c) { return imax(imax(imax(a, b), c), 0); }
static inline uint32_t __viaddmax_s16x2(uint32_t a, uint32_t b, uint32_t c) { return __vmaxs2(__vadd2(a, b), c); }
static inline uint32_t __vimax3_s16x2(uint32_t a, uint32_t b, uint32_t c) { return __vmaxs2(__vmaxs2(a, b), c); }
static inline uint32_t __vimax3_s16x2_relu(uint32_t a, uint32_t b, uint32_t c) { return __vmaxs2(__vimax3_s16x2(a, b, c), 0u); }
#endif

// -- the element type of a word ---------------------------------------------
template <int TY> struct W;

template <> struct W<F32> {
#ifdef __CUDACC__
  static PR_HD float f(uint32_t w) { return __uint_as_float(w); }
  static PR_HD uint32_t w(float x) { return __float_as_uint(x); }
  static PR_HD uint32_t add(uint32_t a, uint32_t b) { return w(__fadd_rn(f(a), f(b))); }
  static PR_HD uint32_t sub(uint32_t a, uint32_t b) { return w(__fsub_rn(f(a), f(b))); }
  static PR_HD uint32_t mul(uint32_t a, uint32_t b) { return w(__fmul_rn(f(a), f(b))); }
#else
  static float f(uint32_t x) { return f_of(x); }
  static uint32_t w(float x) { return w_of(x); }
  static uint32_t add(uint32_t a, uint32_t b) { return w(f(a) + f(b)); }
  static uint32_t sub(uint32_t a, uint32_t b) { return w(f(a) - f(b)); }
  static uint32_t mul(uint32_t a, uint32_t b) { return w(f(a) * f(b)); }
#endif
  static PR_HD uint32_t max(uint32_t a, uint32_t b) { return w(fmaxf(f(a), f(b))); }
  static PR_HD uint32_t min(uint32_t a, uint32_t b) { return w(fminf(f(a), f(b))); }
  static PR_HD uint32_t gt_sel(uint32_t a, uint32_t b) { return f(a) > f(b) ? a : b; }
  static PR_HD uint32_t pos_sel(uint32_t a, uint32_t b) { return f(a) > 0.0f ? a : b; }
};

template <> struct W<BF16X2> {
#ifdef __CUDACC__
  static __device__ __forceinline__ __nv_bfloat162 h(uint32_t x) {
    __nv_bfloat162 r;
    memcpy(&r, &x, 4);
    return r;
  }
  static __device__ __forceinline__ uint32_t w(__nv_bfloat162 x) {
    uint32_t r;
    memcpy(&r, &x, 4);
    return r;
  }
  static __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) { return w(__hadd2(h(a), h(b))); }
  static __device__ __forceinline__ uint32_t sub(uint32_t a, uint32_t b) { return w(__hsub2(h(a), h(b))); }
  static __device__ __forceinline__ uint32_t mul(uint32_t a, uint32_t b) { return w(__hmul2(h(a), h(b))); }
  static __device__ __forceinline__ uint32_t max(uint32_t a, uint32_t b) { return w(__hmax2(h(a), h(b))); }
  static __device__ __forceinline__ uint32_t min(uint32_t a, uint32_t b) { return w(__hmin2(h(a), h(b))); }
  static __device__ __forceinline__ uint32_t gt_sel(uint32_t a, uint32_t b) {
    const __nv_bfloat162 x = h(a), y = h(b);
    return w(__halves2bfloat162(__hgt(x.x, y.x) ? x.x : y.x, __hgt(x.y, y.y) ? x.y : y.y));
  }
  static __device__ __forceinline__ uint32_t pos_sel(uint32_t a, uint32_t b) {
    const __nv_bfloat162 x = h(a), y = h(b), z = __float2bfloat162_rn(0.0f);
    return w(__halves2bfloat162(__hgt(x.x, z.x) ? x.x : y.x, __hgt(x.y, z.y) ? x.y : y.y));
  }
#else
  template <class F> static uint32_t map(uint32_t a, uint32_t b, F fn) {
    return f2bf(fn(bf2f(a), bf2f(b))) | (f2bf(fn(bf2f(a >> 16), bf2f(b >> 16))) << 16);
  }
  template <class F> static uint32_t pick(uint32_t a, uint32_t b, F take_a) {
    uint32_t r = 0;
    for (int k = 0; k < 2; ++k) {
      const uint32_t x = (a >> (16 * k)) & 0xffffu, y = (b >> (16 * k)) & 0xffffu;
      r |= (take_a(bf2f(x), bf2f(y)) ? x : y) << (16 * k);
    }
    return r;
  }
  static uint32_t add(uint32_t a, uint32_t b) { return map(a, b, [](float x, float y) { return x + y; }); }
  static uint32_t sub(uint32_t a, uint32_t b) { return map(a, b, [](float x, float y) { return x - y; }); }
  static uint32_t mul(uint32_t a, uint32_t b) { return map(a, b, [](float x, float y) { return x * y; }); }
  static uint32_t max(uint32_t a, uint32_t b) { return map(a, b, [](float x, float y) { return fmaxf(x, y); }); }
  static uint32_t min(uint32_t a, uint32_t b) { return map(a, b, [](float x, float y) { return fminf(x, y); }); }
  static uint32_t gt_sel(uint32_t a, uint32_t b) { return pick(a, b, [](float x, float y) { return x > y; }); }
  static uint32_t pos_sel(uint32_t a, uint32_t b) { return pick(a, b, [](float x, float) { return x > 0.0f; }); }
#endif
};

template <> struct W<I32> {
  static PR_HD uint32_t add(uint32_t a, uint32_t b) { return a + b; }
  static PR_HD uint32_t sub(uint32_t a, uint32_t b) { return a - b; }
  static PR_HD uint32_t max(uint32_t a, uint32_t b) { return (int32_t)a > (int32_t)b ? a : b; }
  static PR_HD uint32_t min(uint32_t a, uint32_t b) { return (int32_t)a < (int32_t)b ? a : b; }
  static PR_HD uint32_t gt_sel(uint32_t a, uint32_t b) { return (int32_t)a > (int32_t)b ? a : b; }
  static PR_HD uint32_t addmax_dpx(uint32_t a, uint32_t b, uint32_t c) {
    return (uint32_t)__viaddmax_s32((int)a, (int)b, (int)c);
  }
  static PR_HD uint32_t max3_dpx(uint32_t a, uint32_t b, uint32_t c) {
    return (uint32_t)__vimax3_s32((int)a, (int)b, (int)c);
  }
  static PR_HD uint32_t max3_relu_dpx(uint32_t a, uint32_t b, uint32_t c) {
    return (uint32_t)__vimax3_s32_relu((int)a, (int)b, (int)c);
  }
};

template <> struct W<I16X2> {
  static PR_HD uint32_t add(uint32_t a, uint32_t b) { return __vadd2(a, b); }
  static PR_HD uint32_t sub(uint32_t a, uint32_t b) { return __vsub2(a, b); }
  static PR_HD uint32_t max(uint32_t a, uint32_t b) { return __vmaxs2(a, b); }
  static PR_HD uint32_t min(uint32_t a, uint32_t b) { return __vmins2(a, b); }
  static PR_HD uint32_t gt_sel(uint32_t a, uint32_t b) {
    const uint32_t m = __vcmpgts2(a, b);
    return (a & m) | (b & ~m);
  }
  static PR_HD uint32_t addmax_dpx(uint32_t a, uint32_t b, uint32_t c) { return __viaddmax_s16x2(a, b, c); }
  static PR_HD uint32_t max3_dpx(uint32_t a, uint32_t b, uint32_t c) { return __vimax3_s16x2(a, b, c); }
  static PR_HD uint32_t max3_relu_dpx(uint32_t a, uint32_t b, uint32_t c) {
    return __vimax3_s16x2_relu(a, b, c);
  }
};

template <> struct W<I8X4> {
  static PR_HD uint32_t add(uint32_t a, uint32_t b) { return __vadd4(a, b); }
  static PR_HD uint32_t sub(uint32_t a, uint32_t b) { return __vsub4(a, b); }
  static PR_HD uint32_t max(uint32_t a, uint32_t b) { return __vmaxs4(a, b); }
  static PR_HD uint32_t min(uint32_t a, uint32_t b) { return __vmins4(a, b); }
  static PR_HD uint32_t gt_sel(uint32_t a, uint32_t b) {
    const uint32_t m = __vcmpgts4(a, b);
    return (a & m) | (b & ~m);
  }
};

template <> struct W<U8X4> {
  static PR_HD uint32_t add(uint32_t a, uint32_t b) { return __vadd4(a, b); }
  static PR_HD uint32_t sub(uint32_t a, uint32_t b) { return __vsub4(a, b); }
  static PR_HD uint32_t max(uint32_t a, uint32_t b) { return __vmaxu4(a, b); }
  static PR_HD uint32_t min(uint32_t a, uint32_t b) { return __vminu4(a, b); }
  static PR_HD uint32_t gt_sel(uint32_t a, uint32_t b) {
    const uint32_t m = __vcmpgtu4(a, b);
    return (a & m) | (b & ~m);
  }
};

// One application of an op that reads no neighbour. The (TY, OP) pairs
// that exist are those that instantiate_chain lists.
template <int TY, int OP>
PR_HD uint32_t apply(uint32_t x, uint32_t b, uint32_t c1, uint32_t c2) {
  typedef W<TY> T;
  if constexpr (OP == ADD) return T::add(x, b);
  else if constexpr (OP == SUB) return T::sub(x, b);
  else if constexpr (OP == MAX) return T::max(x, b);
  else if constexpr (OP == WHERE_GT) return T::gt_sel(x, b);
  else if constexpr (OP == MAX_ADD) return T::max(T::add(x, b), b);
  else if constexpr (OP == MAX_ADD_DPX) return T::addmax_dpx(x, b, b);
  else if constexpr (OP == SATADD) return T::min(T::add(x, b), c1);
  else if constexpr (OP == MAX3) return T::max(T::max(x, b), c1);
  else if constexpr (OP == MAX3_DPX) return T::max3_dpx(x, b, c1);
  else if constexpr (OP == MAX3_RELU) return T::max(T::max(T::max(x, b), c1), 0u);
  else if constexpr (OP == MAX3_RELU_DPX) return T::max3_relu_dpx(x, b, c1);
  else if constexpr (OP == DPMIX) return T::max(T::add(x, b), T::max(T::sub(x, c1), T::sub(x, c2)));
  else if constexpr (OP == DPMIX_DPX)
    return T::addmax_dpx(x, b, T::addmax_dpx(x, T::sub(0u, c1), T::sub(x, c2)));
  else if constexpr (OP == ADDC) return T::add(x, c1);
  else if constexpr (OP == MAXMULC) return T::max(x, T::mul(x, c1));
  else if constexpr (OP == SELECT) return T::pos_sel(x, T::mul(x, c1));
  else if constexpr (OP == MAX3MUL) return T::max(x, T::max(T::mul(x, c1), T::mul(x, c2)));
  else if constexpr (OP == MAXC) return T::max(x, c1);
  else if constexpr (OP == MAX3ADD) return T::max(x, T::max(T::add(x, c1), T::add(x, c2)));
  else if constexpr (OP == MAX3ADD_DPX) return T::max3_dpx(x, T::add(x, c1), T::add(x, c2));
  else return x;
}

#ifdef __CUDACC__
constexpr unsigned FULL = 0xffffffffu;

// -- chain_kernel ------------------------------------------------------------
// An empty asm that claims to change its operands: the compiler can no
// longer treat b and the constants as loop-invariant, so it cannot fold a
// chain of one op (x + b repeated, max(x, b) repeated) into one step. It
// emits no instruction.
__device__ __forceinline__ void opaque(uint32_t& b, uint32_t& c1, uint32_t& c2) {
  asm volatile("" : "+r"(b), "+r"(c1), "+r"(c2));
}

template <int TY, int OP, int NS>
__global__ void chain_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ bv,
                             uint32_t* __restrict__ out, long long n, long long reps,
                             uint32_t c1, uint32_t c2) {
  typedef W<TY> T;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n; i += stride) {
    uint32_t b = bv[i];
    if constexpr (NS == 1) {
      uint32_t x = a[i];
#pragma unroll 8
      for (long long k = 0; k < reps; ++k) {
        opaque(b, c1, c2);
        x = apply<TY, OP>(x, b, c1, c2);
      }
      out[i] = x;
    } else {
      uint32_t x1 = a[i], x2 = T::add(a[i], b), x3 = a[i], x4 = T::add(a[i], b);
      asm volatile("" : "+r"(x3), "+r"(x4));  // four streams, not two the compiler merges
#pragma unroll 4
      for (long long k = 0; k < reps; ++k) {
        opaque(b, c1, c2);
        x1 = apply<TY, OP>(x1, b, c1, c2);
        x2 = apply<TY, OP>(x2, b, c1, c2);
        x3 = apply<TY, OP>(x3, b, c1, c2);
        x4 = apply<TY, OP>(x4, b, c1, c2);
      }
      out[i] = T::max(T::max(x1, x2), T::max(x3, x4));
    }
  }
}

// -- tile_kernel ---------------------------------------------------------------
// Word r of lane g of a line is element e = g * R + r. A roll by D gives
// element e the old element (e - D) mod L: the same lane's register or a
// neighbour lane's, all indices fixed at compile time.
template <int G, int R, int D>
__device__ __forceinline__ void roll(uint32_t (&v)[R], uint32_t (&o)[R], int lane) {
  constexpr int L = G * R;
  const int g = lane % G, base = lane - g;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int src = ((r - D) % L + L) % L;  // element index relative to the lane's first
    const int k = src / R;                  // lane offset, 0 .. G-1 (cyclic)
    const int sr = src % R;
    if (G == 1 || k == 0) {
      o[r] = v[sr];
    } else {
      o[r] = __shfl_sync(FULL, v[sr], base + (g + k) % G);
    }
  }
}

template <int TY, int G, int R, int D, int OP>
__device__ __forceinline__ void tile_step(uint32_t (&v)[R], const uint32_t (&b)[R], int lane,
                                          uint32_t c1, uint32_t c2) {
  typedef W<TY> T;
  if constexpr (OP < ROLL) {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = apply<TY, OP>(v[r], b[r], c1, c2);
  } else {
    uint32_t o[R];
    roll<G, R, D>(v, o, lane);
    const int g = lane % G;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if constexpr (OP == ROLL) v[r] = o[r];
      else if constexpr (OP == ROLL_ADDC) v[r] = T::add(o[r], c1);
      else if constexpr (OP == MAX_ROLL_ADDC) v[r] = T::max(v[r], T::add(o[r], c1));
      else if constexpr (OP == ROLL_ADDB) v[r] = T::add(o[r], b[r]);
      else if constexpr (OP == MAX_ROLL_B) v[r] = T::max(o[r], b[r]);
      else if constexpr (OP == SCAN_MASKED)
        v[r] = T::max(v[r], g * R + r >= D ? T::add(o[r], c1) : c2);
    }
  }
}

template <int OP> __device__ constexpr bool reads_b() {
  return OP == ADD || OP == SUB || OP == MAX || OP == WHERE_GT || OP == MAX_ADD ||
         OP == MAX_ADD_DPX || OP == SATADD || OP == MAX3 || OP == MAX3_DPX ||
         OP == MAX3_RELU || OP == MAX3_RELU_DPX || OP == DPMIX || OP == DPMIX_DPX ||
         OP == ROLL_ADDB || OP == MAX_ROLL_B;
}

// x, b, out: (lines, L) words, L = G * R; every launched warp holds 32 / G
// lines (the wrapper pads nothing: lines * G is a multiple of 32).
template <int TY, int G, int R, int D, int OP>
__global__ void tile_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ bv,
                            uint32_t* __restrict__ out, long long lines, long long apps,
                            uint32_t c1, uint32_t c2) {
  constexpr int L = G * R;
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const long long line = warp * (32 / G) + lane / G;
  if (warp * (32 / G) >= lines) return;  // warp-uniform
  const size_t at = (size_t)line * L + (size_t)(lane % G) * R;
  uint32_t v[R], b[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    v[r] = x[at + r];
    b[r] = reads_b<OP>() ? bv[at + r] : 0u;
  }
  long long k = 0;
  uint32_t z = 0;
  for (; k + 4 <= apps; k += 4) {
    opaque(z, c1, c2);  // no application of a constant op folds across trips
#pragma unroll
    for (int u = 0; u < 4; ++u) tile_step<TY, G, R, D, OP>(v, b, lane, c1, c2);
  }
  for (; k < apps; ++k) tile_step<TY, G, R, D, OP>(v, b, lane, c1, c2);
#pragma unroll
  for (int r = 0; r < R; ++r) out[at + r] = v[r];
}

// -- carry_kernel --------------------------------------------------------------
enum Carry { SINGLE = 0, TUPLE3 = 1, WITH1B = 2, SLICE78 = 3, SUBROLL = 4, LANEROLL1B = 5, IOTA_T = 6 };

// experiments/r3_carry_probe.py's one_chain: n times h = max(h, h * 0.5 - 1).
template <int N> __device__ __forceinline__ float one_chain(float h) {
#pragma unroll
  for (int i = 0; i < N; ++i) h = fmaxf(h, __fsub_rn(__fmul_rn(h, 0.5f), 1.0f));
  return h;
}

// x, out: (copies, 8, 2048) f32; one block of 1024 threads a copy; thread t
// holds columns 2t and 2t + 1, all 8 rows.
template <int V>
__global__ void __launch_bounds__(1024) carry_kernel(const float* __restrict__ x,
                                                     float* __restrict__ out, int trips) {
  constexpr int K = 2048;
  __shared__ float edge[2][32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* xc = x + (size_t)blockIdx.x * 8 * K;
  float* oc = out + (size_t)blockIdx.x * 8 * K;
  float a[2][8], b[2][8], d[2][8], v[2];
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      a[c][r] = xc[r * K + 2 * t + c];
      b[c][r] = a[c][r] + 1.0f;
      d[c][r] = a[c][r] + 2.0f;
    }
    v[c] = a[c][0];
  }
  for (int it = 0; it < trips; ++it) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if constexpr (V == SINGLE) a[c][r] = one_chain<12>(a[c][r]);
        if constexpr (V == TUPLE3) {
          a[c][r] = one_chain<4>(a[c][r]);
          b[c][r] = one_chain<4>(b[c][r]);
          d[c][r] = one_chain<4>(d[c][r]);
        }
        if constexpr (V == WITH1B || V == SLICE78) a[c][r] = one_chain<10>(a[c][r]);
        if constexpr (V == LANEROLL1B) a[c][r] = one_chain<8>(a[c][r]);
        if constexpr (V == IOTA_T) a[c][r] = it < 2 * t + c ? 0.0f : one_chain<10>(a[c][r]);
      }
      if constexpr (V == WITH1B) v[c] = fmaxf(v[c], a[c][0]);
      if constexpr (V == SLICE78) v[c] = fmaxf(v[c], a[c][7]);
      if constexpr (V == SUBROLL) {
#pragma unroll
        for (int dd = 1; dd <= 4; dd *= 2) {  // h = max(h, roll(h, dd, axis 0) - 1)
          float o[8];
#pragma unroll
          for (int r = 0; r < 8; ++r) o[r] = a[c][(r - dd + 8) % 8];
#pragma unroll
          for (int r = 0; r < 8; ++r) a[c][r] = fmaxf(a[c][r], __fsub_rn(o[r], 1.0f));
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) a[c][r] = one_chain<6>(a[c][r]);
      }
    }
    if constexpr (V == LANEROLL1B) {  // v = max(roll(v, 1, axis 1), a[7])
      if (lane == 31) edge[it & 1][warp] = v[1];
      __syncthreads();
      float up = __shfl_up_sync(FULL, v[1], 1);
      if (lane == 0) up = edge[it & 1][(warp + 31) % 32];
      v[1] = fmaxf(v[0], a[1][7]);
      v[0] = fmaxf(up, a[0][7]);
    }
  }
#pragma unroll
  for (int c = 0; c < 2; ++c) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float o = a[c][r];
      if constexpr (V == TUPLE3) o = __fadd_rn(__fadd_rn(a[c][r], b[c][r]), d[c][r]);
      if constexpr (V == WITH1B || V == SLICE78 || V == LANEROLL1B) o = __fadd_rn(a[c][r], v[c]);
      oc[r * K + 2 * t + c] = o;
    }
  }
}

// -- dispatch ------------------------------------------------------------------
typedef void (*Launcher)(int blocks, int threads, cudaStream_t st, const void* x, const void* b,
                         void* out, long long n, long long reps, uint32_t c1, uint32_t c2);

template <int TY, int OP, int NS>
static void launch_chain(int blocks, int threads, cudaStream_t st, const void* x, const void* b,
                         void* out, long long n, long long reps, uint32_t c1, uint32_t c2) {
  chain_kernel<TY, OP, NS><<<blocks, threads, 0, st>>>(
      (const uint32_t*)x, (const uint32_t*)b, (uint32_t*)out, n, reps, c1, c2);
}

template <int TY, int G, int R, int D, int OP>
static void launch_tile(int blocks, int threads, cudaStream_t st, const void* x, const void* b,
                        void* out, long long lines, long long apps, uint32_t c1, uint32_t c2) {
  tile_kernel<TY, G, R, D, OP><<<blocks, threads, 0, st>>>(
      (const uint32_t*)x, (const uint32_t*)b, (uint32_t*)out, lines, apps, c1, c2);
}

struct ChainEntry { int ty, op, ns; Launcher fn; };
struct TileEntry { int ty, g, r, d, op; Launcher fn; };

#ifdef PROBES_CHAIN
#define CH1(TY, OP) {TY, OP, 1, launch_chain<TY, OP, 1>}, {TY, OP, 4, launch_chain<TY, OP, 4>}
// r2_dtype's ops, every type; the rate probes' ops, the types they run in.
#define CH_DTYPE(TY) CH1(TY, ADD), CH1(TY, SUB), CH1(TY, MAX), CH1(TY, WHERE_GT), CH1(TY, SATADD)
#define CH_RATE(TY) CH1(TY, MAX_ADD), CH1(TY, DPMIX)
#define CH_DPX(TY) CH1(TY, MAX3), CH1(TY, MAX3_RELU), CH1(TY, MAX_ADD_DPX), CH1(TY, MAX3_DPX), \
    CH1(TY, MAX3_RELU_DPX), CH1(TY, DPMIX_DPX)

static const ChainEntry CHAINS[] = {
    CH_DTYPE(F32), CH_DTYPE(BF16X2), CH_DTYPE(I32), CH_DTYPE(I16X2), CH_DTYPE(I8X4),
    CH_DTYPE(U8X4), CH_RATE(F32), CH_RATE(BF16X2), CH_RATE(I32), CH_RATE(I16X2),
    CH_DPX(I32), CH_DPX(I16X2),
    // r3_roll_probe's and r3_longpair_probe's elementwise bodies
    CH1(F32, ADDC), CH1(F32, MAXC), CH1(F32, MAX3MUL), CH1(I32, MAX3ADD), CH1(I32, MAX3ADD_DPX),
};
#endif  // PROBES_CHAIN

#ifdef PROBES_TILE
#define TL(TY, G, R, D, OP) {TY, G, R, D, OP, launch_tile<TY, G, R, D, OP>}
#define TL_ROW4(TY) TL(TY, 8, 32, 1, ROLL), TL(TY, 16, 32, 1, ROLL), TL(TY, 8, 32, 1, MAX_ROLL_ADDC)
#define TL_DTYPE(TY) TL(TY, 1, 32, 1, ROLL_ADDB), TL(TY, 1, 32, 2, ROLL_ADDB), \
    TL(TY, 1, 32, 1, MAX_ROLL_B), TL(TY, 8, 32, 1, MAX_ROLL_B)

static const TileEntry TILES[] = {
    // op_rate_probe: (256, 512), lines along axis 0 (L = 256) or axis 1 (L = 512)
    TL_ROW4(F32), TL_ROW4(BF16X2), TL_ROW4(I32), TL_ROW4(I16X2),
    TL(F32, 8, 32, 1, MAXMULC), TL(F32, 8, 32, 1, ADDC), TL(F32, 8, 32, 1, SELECT),
    TL(BF16X2, 8, 32, 1, MAXMULC), TL(BF16X2, 8, 32, 1, ADDC), TL(BF16X2, 8, 32, 1, SELECT),
    // r2_dtype_probe: part A's rolls on (32, 256), part B's max_roll on (256, 2048)
    TL_DTYPE(F32), TL_DTYPE(BF16X2), TL_DTYPE(I32), TL_DTYPE(I16X2), TL_DTYPE(I8X4),
    TL_DTYPE(U8X4),
    // r3_roll_probe and r3_longpair_probe: (8, 2048) f32, lane rolls (L = 2048)
    // and sublane rolls (L = 8)
    TL(F32, 32, 64, 1, MAX_ROLL_ADDC), TL(F32, 32, 64, 8, MAX_ROLL_ADDC),
    TL(F32, 32, 64, 512, MAX_ROLL_ADDC), TL(F32, 32, 64, 4, MAX_ROLL_ADDC),
    TL(F32, 32, 64, 4, SCAN_MASKED), TL(F32, 1, 8, 1, MAX_ROLL_ADDC),
    TL(F32, 32, 64, 1, ROLL_ADDC), TL(F32, 32, 64, 128, ROLL_ADDC),
    TL(F32, 32, 64, 512, ROLL_ADDC), TL(F32, 1, 8, 1, ROLL_ADDC),
};

template <int V>
static void launch_carry(int copies, cudaStream_t st, const float* x, float* out, int trips) {
  carry_kernel<V><<<copies, 1024, 0, st>>>(x, out, trips);
}
#endif  // PROBES_TILE
#endif  // __CUDACC__

// The host build's chain: chain_kernel's arithmetic, one word at a time.
#ifndef __CUDACC__
template <int TY, int OP>
static void host_chain(const uint32_t* a, const uint32_t* b, uint32_t* out, long long n,
                       long long reps, int ns, uint32_t c1, uint32_t c2) {
  typedef W<TY> T;
  for (long long i = 0; i < n; ++i) {
    if (ns == 1) {
      uint32_t x = a[i];
      for (long long k = 0; k < reps; ++k) x = apply<TY, OP>(x, b[i], c1, c2);
      out[i] = x;
    } else {
      uint32_t x[4] = {a[i], T::add(a[i], b[i]), a[i], T::add(a[i], b[i])};
      for (long long k = 0; k < reps; ++k)
        for (int s = 0; s < 4; ++s) x[s] = apply<TY, OP>(x[s], b[i], c1, c2);
      out[i] = T::max(T::max(x[0], x[1]), T::max(x[2], x[3]));
    }
  }
}

typedef void (*HostFn)(const uint32_t*, const uint32_t*, uint32_t*, long long, long long, int,
                       uint32_t, uint32_t);
struct HostEntry { int ty, op; HostFn fn; };
#define HC(TY, OP) {TY, OP, host_chain<TY, OP>}
#define HC_INT(TY) HC(TY, ADD), HC(TY, SUB), HC(TY, MAX), HC(TY, WHERE_GT), HC(TY, MAX_ADD), \
    HC(TY, SATADD), HC(TY, MAX3), HC(TY, MAX3_RELU), HC(TY, DPMIX)
#define HC_DPX(TY) HC(TY, MAX_ADD_DPX), HC(TY, MAX3_DPX), HC(TY, MAX3_RELU_DPX), \
    HC(TY, DPMIX_DPX), HC(TY, MAX3ADD), HC(TY, MAX3ADD_DPX)
#define HC_FLOAT(TY) HC(TY, ADD), HC(TY, SUB), HC(TY, MAX), HC(TY, WHERE_GT), HC(TY, MAX_ADD), \
    HC(TY, SATADD), HC(TY, DPMIX), HC(TY, ADDC), HC(TY, MAXC), HC(TY, MAXMULC), \
    HC(TY, SELECT), HC(TY, MAX3MUL)
static const HostEntry HOSTS[] = {
    HC_FLOAT(F32), HC_FLOAT(BF16X2), HC_INT(I32), HC_INT(I16X2), HC_INT(I8X4), HC_INT(U8X4),
    HC_DPX(I32), HC_DPX(I16X2),
};
#endif

}  // namespace probes

extern "C" {

#ifdef __CUDACC__
#ifdef PROBES_CHAIN
// chain_kernel<ty, op, ns> over n words, `reps` applications each, on
// `blocks` x `threads`. Returns cudaGetLastError(), or -1 for a (ty, op, ns)
// without an instantiation.
int probe_chain(int ty, int op, int ns, const void* x, const void* b, void* out, long long n,
                long long reps, unsigned c1, unsigned c2, int blocks, int threads, void* stream) {
  for (const auto& e : probes::CHAINS)
    if (e.ty == ty && e.op == op && e.ns == ns) {
      e.fn(blocks, threads, (cudaStream_t)stream, x, b, out, n, reps, c1, c2);
      return (int)cudaGetLastError();
    }
  return -1;
}
#endif  // PROBES_CHAIN

#ifdef PROBES_TILE
// tile_kernel<ty, g, r, d, op> over `lines` lines of g * r words, `apps`
// applications. Returns cudaGetLastError(), or -1 without an instantiation.
int probe_tile(int ty, int g, int r, int d, int op, const void* x, const void* b, void* out,
               long long lines, long long apps, unsigned c1, unsigned c2, int blocks,
               int threads, void* stream) {
  for (const auto& e : probes::TILES)
    if (e.ty == ty && e.g == g && e.r == r && e.d == d && e.op == op) {
      e.fn(blocks, threads, (cudaStream_t)stream, x, b, out, lines, apps, c1, c2);
      return (int)cudaGetLastError();
    }
  return -1;
}

// carry_kernel<variant> on `copies` (8, 2048) f32 tiles, `trips` trips.
int probe_carry(int variant, const void* x, void* out, int copies, int trips, void* stream) {
  const float* xf = (const float*)x;
  float* of = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (variant) {
    case probes::SINGLE: probes::launch_carry<probes::SINGLE>(copies, st, xf, of, trips); break;
    case probes::TUPLE3: probes::launch_carry<probes::TUPLE3>(copies, st, xf, of, trips); break;
    case probes::WITH1B: probes::launch_carry<probes::WITH1B>(copies, st, xf, of, trips); break;
    case probes::SLICE78: probes::launch_carry<probes::SLICE78>(copies, st, xf, of, trips); break;
    case probes::SUBROLL: probes::launch_carry<probes::SUBROLL>(copies, st, xf, of, trips); break;
    case probes::LANEROLL1B: probes::launch_carry<probes::LANEROLL1B>(copies, st, xf, of, trips); break;
    case probes::IOTA_T: probes::launch_carry<probes::IOTA_T>(copies, st, xf, of, trips); break;
    default: return -1;
  }
  return (int)cudaGetLastError();
}
#endif  // PROBES_TILE
#else
// chain_kernel's arithmetic on the host. Returns 0, or -1 without an entry.
int probe_chain_host(int ty, int op, int ns, const void* x, const void* b, void* out,
                     long long n, long long reps, unsigned c1, unsigned c2) {
  for (const auto& e : probes::HOSTS)
    if (e.ty == ty && e.op == op) {
      e.fn((const uint32_t*)x, (const uint32_t*)b, (uint32_t*)out, n, reps, ns, c1, c2);
      return 0;
    }
  return -1;
}
#endif

}  // extern "C"
