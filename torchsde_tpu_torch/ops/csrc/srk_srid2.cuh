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
// bf16 every one of its ~114 operations an element-step ends in a
// conversion to bf16, and an H100 issues conversions at 16 a clock an SM:
// the bf16 solve is bound by them (6.4 ms at B 16384, D 128, 128 steps, on
// an H100 80GB HBM3 at 700 W), not by its 0.32 ms of bf16 bytes.
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
// state's type, at least float32). float32, float64 and bfloat16 are
// instantiated.
//
// bfloat16. The JAX kernel runs on bf16 arrays as XLA runs any bf16
// operation: in float32, rounded to bf16 after every operation, with each
// Python constant rounded to bf16 first (a weak type). Bf16 below is that
// arithmetic as a value type: it holds a bf16 value widened to float, and
// each operator and math function computes in float32 (__fadd_rn and its
// kind, which nvcc never contracts into an FMA) and rounds to bf16. It is
// not __nv_bfloat16's arithmetic, which rounds a product once where the
// CPU rounds it twice (float32, then bf16). Its constructor from double
// rounds through float32, as ml_dtypes and PyTorch convert, and is
// explicit: T(0.1) in an expression is JAX's weak 0.1, a bare double
// literal beside a Bf16 does not compile. The step time is t0 + s * dt in
// float32, rounded once (srk_fused.py:95-96). W, U, y0, the parameters and
// the result are bf16 in memory (2-byte loads and stores).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

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
  __host__ __device__ explicit Bf16(double x)
      : v(round_bf16_bits(static_cast<float>(x))) {}
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
__device__ __forceinline__ Bf16 operator-(Bf16 a) { return Bf16::exact(-a.v); }

// The math an expression may use on a Bf16: the float32 function, rounded
// (PyTorch's CUDA kernels call the same float functions on bf16 tensors).
#define TSDE_BF16_MATH(name, fn)                                              \
  __device__ __forceinline__ Bf16 name(Bf16 a) { return Bf16::round(fn(a.v)); }
TSDE_BF16_MATH(sin, sinf)
TSDE_BF16_MATH(cos, cosf)
TSDE_BF16_MATH(tan, tanf)
TSDE_BF16_MATH(exp, expf)
TSDE_BF16_MATH(log, logf)
TSDE_BF16_MATH(sqrt, sqrtf)
TSDE_BF16_MATH(tanh, tanhf)
TSDE_BF16_MATH(fabs, fabsf)
#undef TSDE_BF16_MATH

// How a compute type sits in memory: float and double as themselves, Bf16
// as the 16 bits of a bfloat16.
template <typename T>
struct Memory {
  using type = T;
  __device__ static T load(const T* p) { return *p; }
  __device__ static void store(T* p, T v) { *p = v; }
};
template <>
struct Memory<Bf16> {
  using type = __nv_bfloat16;
  __device__ static Bf16 load(const __nv_bfloat16* p) {
    return Bf16::exact(__bfloat162float(*p));
  }
  __device__ static void store(__nv_bfloat16* p, Bf16 v) {
    *p = __float2bfloat16_rn(v.v);             // exact: v is a bf16 value
  }
};

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
// wider; for bf16 in float32, rounded once.
template <typename T>
__device__ __forceinline__ T step_time(double t0, int s,
                                       const StepConsts<T>& k) {
  return T(t0) + T(s) * k.dtT;
}
template <>
__device__ __forceinline__ Bf16 step_time<Bf16>(double t0, int s,
                                                const StepConsts<Bf16>& k) {
  return Bf16::round(__fadd_rn(static_cast<float>(t0),
                               __fmul_rn(static_cast<float>(s),
                                         static_cast<float>(k.dt))));
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
  // Narrower blocks when the elements would not give each of the 132 SMs
  // two blocks, so a small solve still spreads over the card.
  const int threads = BD >= 2LL * 132 * NT ? NT : BD >= 2LL * 132 * 64 ? 64
                                                                      : 32;
  const long long blocks = (BD + threads - 1) / threads;
  srid2_kernel<T, F, G, NP><<<static_cast<unsigned>(blocks), threads, 0,
                              stream>>>(y0, W, U, params, out, BD, D, n, t0,
                                        dt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tsde_srk

// The C interface of one generated source: the solve in float32, float64
// and bfloat16 for the functors F (drift) and G (diffusion) taking NP
// parameter rows, and the CUDA error string. All arrays are contiguous
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
  extern "C" const char* tsde_cuda_error_string(int code) {                   \
    return cudaGetErrorString(static_cast<cudaError_t>(code));                \
  }
