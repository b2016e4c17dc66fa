// Whole fixed-step srid2 solve of a diagonal-noise SDE with elementwise
// drift and diffusion, for Hopper (sm_90a), bound to PyTorch through a plain
// C interface (ctypes).
//
// Replaces the Pallas TPU kernel torchsde_tpu/ops/srk_fused.py:_kernel (with
// _srid2_step), launched by srk_solve_fused: the strong-order-1.5 stochastic
// Runge-Kutta method srid2 (Roessler 2010, core/tableaus.py:SRID2) from y0
// over n steps t = t0 + s * dt, each step taking its Brownian increment W[s]
// and space-time Levy integral U[s]. f(t, y, p) and g(t, y, p) act on one
// element, p holding the parameter rows' entries at the element's column.
//
// The JAX package traces Python callables into its kernel. CUDA C++ cannot
// take one, so this header is a template over two functors, and
// ops/srk_fused.py writes a short .cu that defines them from C++ expressions
// (Elementwise.cuda_expr), includes this header and instantiates
// TSDE_SRID2_ENTRY_POINTS; ops/_build.py:library_for_source compiles it.
//
// What bounds it. Per element and step it reads W and U and does some 60
// flops of stage arithmetic plus eight f and g evaluations: it moves bytes
// and does little arithmetic. Reading y0, W, U and writing y_T, about
// 2 n B D x 4 bytes, takes 0.64 ms at B 16384, D 128, 128 steps at 3.35 TB/s
// and 2.5 us at B 1024, D 8, where latency and the launch bind instead. In
// bf16 the same bytes halve (0.32 ms), but every one of its ~114
// operations an element-step rounds to bf16: one F2F conversion each,
// issued at 16 a clock an SM, took the one-element-a-thread design to 6.4
// ms there (an H100 80GB HBM3 at 700 W), so the bf16 design below works on
// pairs.
//
// Design. One thread per (b, d) element keeps the state in a register and
// loops over the steps; consecutive threads read consecutive elements of
// W[s] and U[s], and the next step's pair is loaded before this step's
// arithmetic. The parameter entries are read once into registers. The
// tableau is a set of constexpr functions, so once the stage loops unroll
// every coefficient is a constant: zero terms vanish, as _srid2_step skips
// them, and each stage's f and g are evaluated once (F[s], G[s]) where the
// JAX step evaluates them again for every later stage. Step and stage
// times are formed as the JAX kernel forms them (t = t0 + s * dt in the
// state's type, at least float32). float32 and float64 are instantiated so;
// bfloat16 runs the same step on pairs.
//
// bfloat16. The JAX kernel runs on bf16 arrays as XLA runs any bf16
// operation: in float32, rounded to bf16 after every operation, with each
// Python constant rounded to bf16 first (a weak type). Bf16 below is that
// arithmetic as a value type, the reference of the check below: it holds a
// bf16 value widened to float, and each operator computes in float32
// (__fadd_rn and its kind, which nvcc never contracts into an FMA) and
// rounds to bf16. Bf16x2 is the same arithmetic on two elements at once,
// bitwise Bf16's on each half, and is what the bf16 solve runs
// (srid2_kernel_bf16x2, two elements a thread, 4-byte loads and stores of
// W, U, y0 and the result). Its constructor from double rounds through
// float32, as ml_dtypes and PyTorch convert, and is explicit: T(0.1) in an
// expression is JAX's weak 0.1, a bare double literal beside it does not
// compile. Its arithmetic:
//   - a sum, difference or product of two bf16 values is one bf16x2
//     instruction (__hadd2_rn, __hsub2_rn, __hmul2_rn: no conversion, and
//     the _rn forms are never contracted into an HFMA2). It rounds the
//     exact result once, where Bf16 rounds it to float32 and then to bf16;
//     the two agree because a bf16 x bf16 product fits float32's 24 bits
//     (below 2^-149 it is too short to land on a bf16 tie) and a sum only
//     loses bits far below half a bf16 ulp (float32 carries more than twice
//     bf16's 8 bits, so rounding twice is innocuous). tsde_srk_bf16x2_diffs
//     checks each instruction against Bf16 over all 2^32 operand pairs on
//     the card, subnormals, overflow and NaN included (chip_smoke.py);
//     TSDE_BF16X2_ADD, _SUB and _MUL set to 0 put an operation back on the
//     packed-conversion path below;
//   - a quotient and the math functions are computed in float32 on each
//     half and rounded by one packed conversion (cvt.rn.bf16x2.f32, F2FP)
//     for both, instead of two F2F;
//   - the step time is t0 + s * dt in float32, rounded once
//     (srk_fused.py:95-96), and broadcast to both halves;
//   - each half reads its own column's parameter entries, so a pair may
//     straddle two rows (an odd D), and an odd B D leaves the last thread
//     one element: its other half computes on zeros and is not stored.
// Where B D is odd or a pointer is not 4-byte aligned, the pairs are
// loaded and stored as two bf16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace tsde_srk {

// float to the nearest bfloat16 (ties to even), widened back to float, in
// integer arithmetic, so that a constant's rounding folds at compile time.
__host__ __device__ __forceinline__ float round_bf16_bits(float x) {
  uint32_t u;
  memcpy(&u, &x, sizeof u);
  if ((u & 0x7fffffffu) > 0x7f800000u) {
    u = (u | 0x00400000u) & 0xffff0000u;          // a quiet NaN
  } else {
    u = (u + 0x7fffu + ((u >> 16) & 1u)) & 0xffff0000u;
  }
  memcpy(&x, &u, sizeof x);
  return x;
}

struct Bf16 {
  float v;                     // a bfloat16 value, held as float
  __host__ __device__ Bf16() : v(0.0f) {}
  // An already rounded float; a computed float rounded on the converter.
  __host__ __device__ static Bf16 exact(float x) {
    Bf16 b;
    b.v = x;
    return b;
  }
  __device__ static Bf16 round(float x) {
    return exact(__bfloat162float(__float2bfloat16_rn(x)));
  }
};

__device__ __forceinline__ Bf16 operator+(Bf16 a, Bf16 b) {
  return Bf16::round(__fadd_rn(a.v, b.v));
}
__device__ __forceinline__ Bf16 operator-(Bf16 a, Bf16 b) {
  return Bf16::round(__fsub_rn(a.v, b.v));
}
__device__ __forceinline__ Bf16 operator*(Bf16 a, Bf16 b) {
  return Bf16::round(__fmul_rn(a.v, b.v));
}
__device__ __forceinline__ Bf16 operator/(Bf16 a, Bf16 b) {
  return Bf16::round(__fdiv_rn(a.v, b.v));
}

// The bf16x2 instructions the pair type uses, each 1 (the instruction) or
// 0 (float32 and one packed conversion, as / and the math functions).
#ifndef TSDE_BF16X2_ADD
#define TSDE_BF16X2_ADD 1
#endif
#ifndef TSDE_BF16X2_SUB
#define TSDE_BF16X2_SUB 1
#endif
#ifndef TSDE_BF16X2_MUL
#define TSDE_BF16X2_MUL 1
#endif

__host__ __device__ __forceinline__ float bits_float(uint32_t u) {
  float f;
  memcpy(&f, &u, sizeof f);
  return f;
}
__host__ __device__ __forceinline__ uint32_t bf16_raw(__nv_bfloat16 b) {
  uint16_t u;
  memcpy(&u, &b, sizeof u);
  return u;
}

// Two bfloat16 values, lo in the lower 16 bits (the element of the lower
// address), as the 32-bit word a bf16x2 instruction takes.
struct Bf16x2 {
  uint32_t w;
  __host__ __device__ Bf16x2() : w(0u) {}
  // A constant, rounded as Bf16(x) rounds it, in both halves.
  __host__ __device__ explicit Bf16x2(double x) {
    const float r = round_bf16_bits(static_cast<float>(x));
    uint32_t u;
    memcpy(&u, &r, sizeof u);
    w = (u >> 16) * 0x00010001u;
  }
  __host__ __device__ static Bf16x2 of_bits(uint32_t w) {
    Bf16x2 p;
    p.w = w;
    return p;
  }
  __host__ __device__ static Bf16x2 of(__nv_bfloat16 lo, __nv_bfloat16 hi) {
    return of_bits(bf16_raw(lo) | (bf16_raw(hi) << 16));
  }
  __host__ __device__ float lo() const { return bits_float(w << 16); }
  __host__ __device__ float hi() const { return bits_float(w & 0xffff0000u); }
  // Two floats rounded to bf16 (to nearest even) by one conversion.
  __device__ static Bf16x2 pack(float lo, float hi) {
    const __nv_bfloat162 r = __floats2bfloat162_rn(lo, hi);
    uint32_t u;
    memcpy(&u, &r, sizeof u);
    return of_bits(u);
  }
  __device__ __nv_bfloat162 h2() const {
    __nv_bfloat162 r;
    memcpy(&r, &w, sizeof r);
    return r;
  }
  __device__ static Bf16x2 of_h2(__nv_bfloat162 v) {
    uint32_t u;
    memcpy(&u, &v, sizeof u);
    return of_bits(u);
  }
};

__device__ __forceinline__ Bf16x2 operator+(Bf16x2 a, Bf16x2 b) {
#if TSDE_BF16X2_ADD
  return Bf16x2::of_h2(__hadd2_rn(a.h2(), b.h2()));
#else
  return Bf16x2::pack(__fadd_rn(a.lo(), b.lo()), __fadd_rn(a.hi(), b.hi()));
#endif
}
__device__ __forceinline__ Bf16x2 operator-(Bf16x2 a, Bf16x2 b) {
#if TSDE_BF16X2_SUB
  return Bf16x2::of_h2(__hsub2_rn(a.h2(), b.h2()));
#else
  return Bf16x2::pack(__fsub_rn(a.lo(), b.lo()), __fsub_rn(a.hi(), b.hi()));
#endif
}
__device__ __forceinline__ Bf16x2 operator*(Bf16x2 a, Bf16x2 b) {
#if TSDE_BF16X2_MUL
  return Bf16x2::of_h2(__hmul2_rn(a.h2(), b.h2()));
#else
  return Bf16x2::pack(__fmul_rn(a.lo(), b.lo()), __fmul_rn(a.hi(), b.hi()));
#endif
}
__device__ __forceinline__ Bf16x2 operator/(Bf16x2 a, Bf16x2 b) {
  return Bf16x2::pack(__fdiv_rn(a.lo(), b.lo()), __fdiv_rn(a.hi(), b.hi()));
}
__device__ __forceinline__ Bf16x2 operator-(Bf16x2 a) {
  return Bf16x2::of_bits(a.w ^ 0x80008000u);
}

#define TSDE_BF16X2_MATH(name, fn)                                            \
  __device__ __forceinline__ Bf16x2 name(Bf16x2 a) {                          \
    return Bf16x2::pack(fn(a.lo()), fn(a.hi()));                              \
  }
TSDE_BF16X2_MATH(sin, sinf)
TSDE_BF16X2_MATH(cos, cosf)
TSDE_BF16X2_MATH(tan, tanf)
TSDE_BF16X2_MATH(exp, expf)
TSDE_BF16X2_MATH(log, logf)
TSDE_BF16X2_MATH(sqrt, sqrtf)
TSDE_BF16X2_MATH(tanh, tanhf)
TSDE_BF16X2_MATH(fabs, fabsf)
#undef TSDE_BF16X2_MATH

// How a compute type sits in memory: float and double as themselves.
template <typename T>
struct Memory {
  using type = T;
  __device__ static T load(const T* p) { return *p; }
  __device__ static void store(T* p, T v) { *p = v; }
};
// Bf16 (whose solve runs on pairs) as the 16 bits of a bfloat16.
template <>
struct Memory<Bf16> {
  using type = __nv_bfloat16;
};

// A pair of elements e, e + 1 of a bf16 array: one 4-byte access where
// `vec` (e even, the array 4-byte aligned), else two 2-byte ones; without
// `two` (e + 1 past the end) only e, the upper half zero.
__device__ __forceinline__ Bf16x2 load_pair(const __nv_bfloat16* p,
                                            size_t e, bool vec, bool two) {
  if (vec) return Bf16x2::of_bits(*reinterpret_cast<const uint32_t*>(p + e));
  return Bf16x2::of(p[e], two ? p[e + 1] : __nv_bfloat16());
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, size_t e,
                                           bool vec, bool two, Bf16x2 v) {
  if (vec) {
    *reinterpret_cast<uint32_t*>(p + e) = v.w;
    return;
  }
  const __nv_bfloat162 h = v.h2();
  p[e] = h.x;
  if (two) p[e + 1] = h.y;
}

constexpr int STAGES = 4;

// srid2's coefficients (core/tableaus.py:SRID2); j < s throughout.
__host__ __device__ constexpr double c0(int s) {
  return s == 1 ? 1.0 : s == 2 ? 0.5 : 0.0;
}
__host__ __device__ constexpr double c1(int s) {
  return s == 1 ? 0.25 : s == 2 ? 1.0 : s == 3 ? 0.25 : 0.0;
}
__host__ __device__ constexpr double a0(int s, int j) {
  return s == 1 ? 1.0 : s == 2 ? 0.25 : 0.0 * j;
}
__host__ __device__ constexpr double a1(int s, int j) {
  return s == 1 ? 0.25 : (s == 2 && j == 0) ? 1.0
         : (s == 3 && j == 2) ? 0.25 : 0.0;
}
__host__ __device__ constexpr double b0(int s, int j) {
  return s == 2 ? (j == 0 ? 1.0 : 0.5) : 0.0;
}
__host__ __device__ constexpr double b1(int s, int j) {
  return s == 1 ? -0.5 : s == 2 ? (j == 0 ? 1.0 : 0.0)
         : s == 3 ? (j == 0 ? 2.0 : j == 1 ? -1.0 : 0.5) : 0.0;
}
__host__ __device__ constexpr double alpha(int s) {
  return s == 0 ? 1.0 / 6.0 : s == 1 ? 1.0 / 6.0 : s == 2 ? 2.0 / 3.0 : 0.0;
}
__host__ __device__ constexpr double beta1(int s) {
  return s == 0 ? -1.0 : s == 1 ? 4.0 / 3.0 : s == 2 ? 2.0 / 3.0 : 0.0;
}
__host__ __device__ constexpr double beta2(int s) {
  return s == 0 ? 1.0 : s == 1 ? -4.0 / 3.0 : s == 2 ? 1.0 / 3.0 : 0.0;
}
__host__ __device__ constexpr double beta3(int s) {
  return s == 0 ? 2.0 : s == 1 ? -4.0 / 3.0 : s == 2 ? -2.0 / 3.0 : 0.0;
}
__host__ __device__ constexpr double beta4(int s) {
  return s == 0 ? -2.0 : s == 1 ? 5.0 / 3.0 : s == 2 ? -2.0 / 3.0 : 1.0;
}

// Step constants in the state's type, formed as srk_fused._srid2_step forms
// them from the Python float dt.
template <typename T>
struct StepConsts {
  double dt;
  T dtT, rdt, sqrt_dt, rsqrt_dt, three_dt;
};

template <typename T>
__host__ __device__ inline StepConsts<T> step_consts(double dt) {
  StepConsts<T> k;
  k.dt = dt;
  k.dtT = T(dt);
  k.rdt = T(1.0 / dt);
  k.sqrt_dt = T(::sqrt(dt));
  k.rsqrt_dt = T(1.0 / ::sqrt(dt));
  k.three_dt = T(3.0 * dt);
  return k;
}

// Step s's time t0 + s * dt: in the state's type where it is float32 or
// wider; for bf16 in float32, rounded once (to both halves of a pair).
template <typename T>
__device__ __forceinline__ T step_time(double t0, int s,
                                       const StepConsts<T>& k) {
  return T(t0) + T(s) * k.dtT;
}
template <>
__device__ __forceinline__ Bf16x2 step_time<Bf16x2>(
    double t0, int s, const StepConsts<Bf16x2>& k) {
  const float t = __fadd_rn(static_cast<float>(t0),
                            __fmul_rn(static_cast<float>(s),
                                      static_cast<float>(k.dt)));
  return Bf16x2::pack(t, t);
}

// One srid2 step from y at time t, with increment I_k and Levy integral
// I_k0 (_srid2_step).
template <typename T, typename F, typename G, int NP>
__device__ __forceinline__ T srid2_step(const F& f, const G& g,
                                        const T* p, T t,
                                        const StepConsts<T>& k, T y, T I_k,
                                        T I_k0) {
  const T I_kk = (I_k * I_k - k.dtT) * T(0.5);
  const T I_kkk = (I_k * I_k * I_k - k.three_dt * I_k) * T(1.0 / 6.0);
  T Fs[STAGES], Gs[STAGES];
  T y1 = y;
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    T h0 = y, h1 = y;
#pragma unroll
    for (int j = 0; j < s; ++j) {
      if (a0(s, j) != 0.0) h0 = h0 + T(a0(s, j)) * Fs[j] * k.dtT;
      if (b0(s, j) != 0.0) h0 = h0 + T(b0(s, j)) * Gs[j] * I_k0 * k.rdt;
      if (a1(s, j) != 0.0) h1 = h1 + T(a1(s, j)) * Fs[j] * k.dtT;
      if (b1(s, j) != 0.0) h1 = h1 + T(b1(s, j)) * Gs[j] * k.sqrt_dt;
    }
    Fs[s] = f(t + T(c0(s) * k.dt), h0, p);
    Gs[s] = g(t + T(c1(s) * k.dt), h1, p);
    T gw = T(0);
    bool any = false;
    if (beta1(s) != 0.0) { gw = T(beta1(s)) * I_k; any = true; }
    if (beta2(s) != 0.0) {
      const T v = T(beta2(s)) * I_kk * k.rsqrt_dt;
      gw = any ? gw + v : v;
      any = true;
    }
    if (beta3(s) != 0.0) {
      const T v = T(beta3(s)) * I_k0 * k.rdt;
      gw = any ? gw + v : v;
      any = true;
    }
    if (beta4(s) != 0.0) {
      const T v = T(beta4(s)) * I_kkk * k.rdt;
      gw = any ? gw + v : v;
    }
    if (alpha(s) != 0.0) y1 = y1 + T(alpha(s)) * Fs[s] * k.dtT;
    y1 = y1 + Gs[s] * gw;
  }
  return y1;
}

constexpr int NT = 128;   // threads per block, at most

template <typename T, typename F, typename G, int NP>
__global__ void __launch_bounds__(NT) srid2_kernel(
    const typename Memory<T>::type* __restrict__ y0,
    const typename Memory<T>::type* __restrict__ W,
    const typename Memory<T>::type* __restrict__ U,
    const typename Memory<T>::type* __restrict__ params,
    typename Memory<T>::type* __restrict__ out, long long BD, int D, int n,
    double t0, double dt) {
  using Mem = Memory<T>;
  const long long e = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  if (e >= BD) return;
  const int col = static_cast<int>(e % D);
  T p[NP > 0 ? NP : 1];
#pragma unroll
  for (int i = 0; i < NP; ++i) p[i] = Mem::load(params + size_t(i) * D + col);
  const StepConsts<T> k = step_consts<T>(dt);
  const F f{};
  const G g{};
  T y = Mem::load(y0 + e);
  T w = n > 0 ? Mem::load(W + e) : T(0), u = n > 0 ? Mem::load(U + e) : T(0);
  for (int s = 0; s < n; ++s) {
    T w_next = T(0), u_next = T(0);
    if (s + 1 < n) {
      w_next = Mem::load(W + size_t(s + 1) * BD + e);
      u_next = Mem::load(U + size_t(s + 1) * BD + e);
    }
    const T t = step_time<T>(t0, s, k);
    y = srid2_step<T, F, G, NP>(f, g, p, t, k, y, w, u);
    w = w_next;
    u = u_next;
  }
  Mem::store(out + e, y);
}

// The bf16 solve on pairs: thread q takes elements 2q and 2q + 1 of the
// flat (B, D) state (`vec`: B D even and every array 4-byte aligned).
template <typename F, typename G, int NP>
__global__ void __launch_bounds__(NT) srid2_kernel_bf16x2(
    const __nv_bfloat16* __restrict__ y0, const __nv_bfloat16* __restrict__ W,
    const __nv_bfloat16* __restrict__ U,
    const __nv_bfloat16* __restrict__ params, __nv_bfloat16* __restrict__ out,
    long long BD, int D, int n, double t0, double dt, bool vec) {
  const long long q = blockIdx.x * static_cast<long long>(blockDim.x)
                      + threadIdx.x;
  const size_t e = 2 * static_cast<size_t>(q);
  if (static_cast<long long>(e) >= BD) return;
  const bool two = static_cast<long long>(e) + 1 < BD;
  const int c0 = static_cast<int>(e % D);
  const int c1 = two ? static_cast<int>((e + 1) % D) : c0;
  Bf16x2 p[NP > 0 ? NP : 1];
#pragma unroll
  for (int i = 0; i < NP; ++i)
    p[i] = Bf16x2::of(params[size_t(i) * D + c0], params[size_t(i) * D + c1]);
  const StepConsts<Bf16x2> k = step_consts<Bf16x2>(dt);
  const F f{};
  const G g{};
  Bf16x2 y = load_pair(y0, e, vec, two);
  Bf16x2 w, u;
  if (n > 0) {
    w = load_pair(W, e, vec, two);
    u = load_pair(U, e, vec, two);
  }
  for (int s = 0; s < n; ++s) {
    Bf16x2 w_next, u_next;
    if (s + 1 < n) {
      w_next = load_pair(W, size_t(s + 1) * BD + e, vec, two);
      u_next = load_pair(U, size_t(s + 1) * BD + e, vec, two);
    }
    const Bf16x2 t = step_time<Bf16x2>(t0, s, k);
    y = srid2_step<Bf16x2, F, G, NP>(f, g, p, t, k, y, w, u);
    w = w_next;
    u = u_next;
  }
  store_pair(out, e, vec, two, y);
}

// Threads a block: narrower blocks when the `items` (elements, or pairs in
// bf16) would not give each of the 132 SMs two blocks, so a small solve
// still spreads over the card.
inline int block_threads(long long items) {
  return items >= 2LL * 132 * NT ? NT : items >= 2LL * 132 * 64 ? 64 : 32;
}

inline bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 3u) == 0;
}

template <typename T, typename F, typename G, int NP>
int launch(const typename Memory<T>::type* y0,
           const typename Memory<T>::type* W,
           const typename Memory<T>::type* U,
           const typename Memory<T>::type* params,
           typename Memory<T>::type* out, long long BD, int D, int n,
           double t0, double dt, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (BD <= 0) return 0;
  if constexpr (std::is_same<T, Bf16>::value) {
    const long long pairs = (BD + 1) / 2;
    const bool vec = BD % 2 == 0 && aligned4(y0) && aligned4(W) &&
                     aligned4(U) && aligned4(out);
    const int threads = block_threads(pairs);
    const long long blocks = (pairs + threads - 1) / threads;
    srid2_kernel_bf16x2<F, G, NP><<<static_cast<unsigned>(blocks), threads,
                                    0, stream>>>(y0, W, U, params, out, BD, D,
                                                 n, t0, dt, vec);
  } else {
    const int threads = block_threads(BD);
    const long long blocks = (BD + threads - 1) / threads;
    srid2_kernel<T, F, G, NP><<<static_cast<unsigned>(blocks), threads, 0,
                                stream>>>(y0, W, U, params, out, BD, D, n, t0,
                                          dt);
  }
  return static_cast<int>(cudaGetLastError());
}

// The check of the bf16x2 instructions (chip_smoke.py): for op 0-3 (+, -,
// *, /) over every pair of bf16 operands (a, b), a = the block, b over the
// threads two at a time, the number of results that differ from Bf16's
// (float32 rounded to bf16), NaN against NaN counting as equal, into
// counts[2 op] for the instruction (+, -, * only) and counts[2 op + 1] for
// Bf16x2's operator as this build compiles it.
__device__ __forceinline__ bool same_bf16(float x, float y) {
  uint32_t a, b;
  memcpy(&a, &x, sizeof a);
  memcpy(&b, &y, sizeof b);
  return (x != x && y != y) || a == b;
}

__device__ __forceinline__ Bf16 bf16_op(int op, Bf16 a, Bf16 b) {
  return op == 0 ? a + b : op == 1 ? a - b : op == 2 ? a * b : a / b;
}

__device__ __forceinline__ Bf16x2 bf16x2_op(int op, Bf16x2 a, Bf16x2 b) {
  return op == 0 ? a + b : op == 1 ? a - b : op == 2 ? a * b : a / b;
}

__device__ __forceinline__ Bf16x2 bf16x2_instruction(int op, Bf16x2 a,
                                                     Bf16x2 b) {
  return Bf16x2::of_h2(op == 0 ? __hadd2_rn(a.h2(), b.h2())
                       : op == 1 ? __hsub2_rn(a.h2(), b.h2())
                                 : __hmul2_rn(a.h2(), b.h2()));
}

constexpr int CHECK_THREADS = 256;

__global__ void __launch_bounds__(CHECK_THREADS) bf16x2_check_kernel(
    int op, unsigned long long* counts) {
  const uint32_t a16 = blockIdx.x;
  const Bf16x2 a = Bf16x2::of_bits(a16 * 0x00010001u);
  const Bf16 as = Bf16::exact(a.lo());
  unsigned long long bad_ins = 0, bad_op = 0;
  for (uint32_t p = threadIdx.x; p < 32768u; p += CHECK_THREADS) {
    const Bf16x2 b = Bf16x2::of_bits((2 * p) | ((2 * p + 1) << 16));
    const float want_lo = bf16_op(op, as, Bf16::exact(b.lo())).v;
    const float want_hi = bf16_op(op, as, Bf16::exact(b.hi())).v;
    const Bf16x2 got = bf16x2_op(op, a, b);
    bad_op += !same_bf16(got.lo(), want_lo);
    bad_op += !same_bf16(got.hi(), want_hi);
    if (op < 3) {
      const Bf16x2 ins = bf16x2_instruction(op, a, b);
      bad_ins += !same_bf16(ins.lo(), want_lo);
      bad_ins += !same_bf16(ins.hi(), want_hi);
    }
  }
  if (bad_ins) atomicAdd(counts + 2 * op, bad_ins);
  if (bad_op) atomicAdd(counts + 2 * op + 1, bad_op);
}

inline int check_bf16x2(unsigned long long* counts, int device,
                        cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemsetAsync(counts, 0, 8 * sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int op = 0; op < 4; ++op) {
    bf16x2_check_kernel<<<65536, CHECK_THREADS, 0, stream>>>(op, counts);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace tsde_srk

// The C interface of one generated source: the solve in float32, float64
// and bfloat16 for the functors F (drift) and G (diffusion) taking NP
// parameter rows; the bf16x2 check (counts: 8 device integers) and which
// of +, -, * (op 0-2) the build runs as bf16x2 instructions; the CUDA
// error string. All arrays are contiguous
// device arrays: y0 (B, D), W and U (n, B, D), params (NP, D), out (B, D);
// BD = B * D.
#define TSDE_SRID2_ENTRY_POINTS(F, G, NP)                                     \
  extern "C" int tsde_srk_srid2_f32(                                          \
      const float* y0, const float* W, const float* U, const float* params,   \
      float* out, long long BD, int D, int n, double t0, double dt,           \
      int device, cudaStream_t stream) {                                      \
    return tsde_srk::launch<float, F, G, NP>(y0, W, U, params, out, BD, D,    \
                                             n, t0, dt, device, stream);      \
  }                                                                           \
  extern "C" int tsde_srk_srid2_f64(                                          \
      const double* y0, const double* W, const double* U,                     \
      const double* params, double* out, long long BD, int D, int n,          \
      double t0, double dt, int device, cudaStream_t stream) {                \
    return tsde_srk::launch<double, F, G, NP>(y0, W, U, params, out, BD, D,   \
                                              n, t0, dt, device, stream);     \
  }                                                                           \
  extern "C" int tsde_srk_srid2_bf16(                                         \
      const __nv_bfloat16* y0, const __nv_bfloat16* W,                        \
      const __nv_bfloat16* U, const __nv_bfloat16* params,                    \
      __nv_bfloat16* out, long long BD, int D, int n, double t0, double dt,   \
      int device, cudaStream_t stream) {                                      \
    return tsde_srk::launch<tsde_srk::Bf16, F, G, NP>(                        \
        y0, W, U, params, out, BD, D, n, t0, dt, device, stream);             \
  }                                                                           \
  extern "C" int tsde_srk_bf16x2_diffs(unsigned long long* counts,          \
                                       int device, cudaStream_t stream) {     \
    return tsde_srk::check_bf16x2(counts, device, stream);                    \
  }                                                                           \
  extern "C" int tsde_srk_bf16x2_native(int op) {                             \
    return op == 0 ? TSDE_BF16X2_ADD : op == 1 ? TSDE_BF16X2_SUB              \
           : op == 2 ? TSDE_BF16X2_MUL : 0;                                   \
  }                                                                           \
  extern "C" const char* tsde_cuda_error_string(int code) {                   \
    return cudaGetErrorString(static_cast<cudaError_t>(code));                \
  }
