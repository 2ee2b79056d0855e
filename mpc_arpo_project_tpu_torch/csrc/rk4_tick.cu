// One control tick of the continuous plant, for Hopper (sm_90a): the n_sub
// RK4 substeps between two controller updates, for a batch of scenarios.
//
// Replaces the XLA substep scan of the JAX package's continuous loop
//   mpc_arpo_project_tpu/rollout/continuous.py::_tick  (the lax.scan over
//   `substep` and the recomputed first substep after it)
// and computes what its plain torch twin
//   mpc_arpo_project_tpu_torch/ops/rk4_tick.py::rk4_tick_plain
// computes. It has no Pallas counterpart. Per scenario and substep k of tick
// j (global substep gi = j n_sub + k):
//   termination:  |p| < rp  or  (in-track ? py : px) < rp - rtol;
//                 a scenario alive before it and not after records gi
//   success:      alive, gi >= 1, |p - xr| <= dist_tol and
//                 |atan(vy / vx)| 180/pi <= ang_tol (NaN at vx = vy = 0
//                 fails the test, which is why there is no fast math here)
//   plant:        one RK4 step of the planar two-body dynamics with the
//                 input held: the previous tick's control on substep 0 (a
//                 one-substep delay), this tick's after it; the delta-v
//                 model integrates unforced and adds the previous tick's
//                 impulse to the velocity after substep 0
//   noise:        the held draw noise[gi / noise_int_sub] added to p
//   mask:         the new state is kept only where the scenario is alive.
// Outputs: the state at the tick's end, alive, the termination substep,
// success, the state one substep after the tick (what the measurement
// reads: masked by the aliveness after substep 0's check with telemetry,
// by the tick's entry aliveness without it, as the JAX package has it) and,
// with telemetry, the state after every substep.
//
// Design: one thread per scenario, 128-thread blocks. The state, the
// inputs, the held draw and the constants stay in registers for all n_sub
// substeps; a thread reads its scenario once, reads the draw again only
// when gi crosses a multiple of noise_int_sub, and writes its results once
// (plus n_sub states with telemetry). One launch per tick.
//
// What bounds it: a substep is a chain of dependent operations (four
// derivative evaluations, each with a power and two divisions, the RK4
// combination and the checks): ~150 operations a scenario. At B = 1024
// and n_sub = 500 that is ~78 MFLOP, ~1 us at the fp32 peak, and the bytes
// are ~0.1 MB (8 MB with telemetry). So the tick is bound by the latency of
// its 500-substep chain per thread, not by the card's rates; a batch of
// 1024 fills 8 of the 132 SMs and runs about as fast as one warp does.
//
// Arithmetic: every elementwise operation is the twin's, in its order, as
// one rounded operation (no fused multiply-add: __f*_rn / __d*_rn), with
// the constants computed on the host in the working type by
// rk4_tick._kernel_constants. pow, atan and sqrt are CUDA's (IEEE sqrt and
// division, as nvcc compiles without fast math).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlock = 128;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub(double a, double b) { return __dsub_rn(a, b); }

// The order of rk4_tick._kernel_constants, each already in the working type.
template <typename T>
struct Consts {
  T n2, two_n, m_two_n, mu, mu_rt2, rt, half_dt, dt, dt6;
  T rp, back_min, xr0, xr1, dist_tol, ang_tol, deg;
};
constexpr int kConsts = 16;
static_assert(sizeof(Consts<float>) == kConsts * sizeof(float), "Consts");
static_assert(sizeof(Consts<double>) == kConsts * sizeof(double), "Consts");

template <typename T>
struct Args {
  const T* x;                    // (B, 4)
  const unsigned char* alive;    // (B,) bool
  const int* i_term;             // (B,) int32
  const unsigned char* succ;     // (B,) bool
  const T* prev_u;               // (B, 2)
  const T* ctrl;                 // (B, 2)
  const T* draws;                // (n_draws, B, 2)
  T* x_end;                      // (B, 4)
  unsigned char* alive_o;
  int* i_term_o;
  unsigned char* succ_o;
  T* x_first;                    // (B, 4)
  T* x_sub;                      // (n_sub, B, 4) or null
  int B, n_draws, j, n_sub, noise_int_sub, is_delta_v, in_track;
  Consts<T> c;
};

// nonlinear.two_body_deriv's accelerations:
//   ax = 2n vy + n^2 px - mu (R_T + px) / r3 + mu / R_T^2 + u0
//   ay = -2n vx + n^2 py - mu py / r3 + u1,  r3 = ((R_T + px)^2 + py^2)^1.5
template <typename T>
__device__ __forceinline__ void accel(const Consts<T>& c, T px, T py, T vx,
                                      T vy, T u0, T u1, T& ax, T& ay) {
  const T a = add(c.rt, px);
  const T r3 = pow(add(mul(a, a), mul(py, py)), T(1.5));
  ax = add(add(sub(add(mul(c.two_n, vy), mul(c.n2, px)), mul(c.mu, a) / r3),
               c.mu_rt2),
           u0);
  ay = add(sub(add(mul(c.m_two_n, vx), mul(c.n2, py)), mul(c.mu, py) / r3),
           u1);
}

// nonlinear.rk4_step: x + (dt/6) (k1 + 2 k2 + 2 k3 + k4)
template <typename T>
__device__ __forceinline__ void rk4(const Consts<T>& c, const T s[4], T u0,
                                    T u1, T o[4]) {
  T k1[4], k2[4], k3[4], k4[4], t[4];
  k1[0] = s[2];
  k1[1] = s[3];
  accel(c, s[0], s[1], s[2], s[3], u0, u1, k1[2], k1[3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) t[i] = add(s[i], mul(c.half_dt, k1[i]));
  k2[0] = t[2];
  k2[1] = t[3];
  accel(c, t[0], t[1], t[2], t[3], u0, u1, k2[2], k2[3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) t[i] = add(s[i], mul(c.half_dt, k2[i]));
  k3[0] = t[2];
  k3[1] = t[3];
  accel(c, t[0], t[1], t[2], t[3], u0, u1, k3[2], k3[3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) t[i] = add(s[i], mul(c.dt, k3[i]));
  k4[0] = t[2];
  k4[1] = t[3];
  accel(c, t[0], t[1], t[2], t[3], u0, u1, k4[2], k4[3]);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T sum = add(add(add(k1[i], mul(T(2), k2[i])), mul(T(2), k3[i])),
                      k4[i]);
    o[i] = add(s[i], mul(c.dt6, sum));
  }
}

template <typename T>
__device__ __forceinline__ T hypot2(T a, T b) {
  return sqrt(add(mul(a, a), mul(b, b)));
}

template <typename T>
__global__ void __launch_bounds__(kBlock) rk4_tick_kernel(const Args<T> a) {
  const int b = blockIdx.x * kBlock + threadIdx.x;
  if (b >= a.B) return;
  const Consts<T>& c = a.c;
  const size_t B = a.B;
  T s[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) s[i] = a.x[4 * b + i];
  T x0[4] = {s[0], s[1], s[2], s[3]};
  bool alive = a.alive[b] != 0;
  const bool alive0 = alive;
  bool alive_k0 = alive;
  int i_term = a.i_term[b];
  bool succ = a.succ[b] != 0;
  const T pu0 = a.prev_u[2 * b], pu1 = a.prev_u[2 * b + 1];
  const T cu0 = a.ctrl[2 * b], cu1 = a.ctrl[2 * b + 1];
  const int g0 = a.j * a.n_sub;
  int di = g0 / a.noise_int_sub;
  int dr = g0 % a.noise_int_sub;
  T w0 = a.draws[(di * B + b) * 2], w1 = a.draws[(di * B + b) * 2 + 1];
  T first[4] = {s[0], s[1], s[2], s[3]};

  for (int k = 0; k < a.n_sub; ++k) {
    const int gi = g0 + k;
    const T back = a.in_track ? s[1] : s[0];
    const bool term = (hypot2(s[0], s[1]) < c.rp) || (back < c.back_min);
    if (alive && term) i_term = gi;
    alive = alive && !term;
    if (k == 0) alive_k0 = alive;
    if (alive && gi >= 1) {
      const T dist = hypot2(sub(s[0], c.xr0), sub(s[1], c.xr1));
      const T ang = mul(fabs(atan(s[3] / s[2])), c.deg);
      if (dist <= c.dist_tol && ang <= c.ang_tol) succ = true;
    }
    // the first substep is needed for the measurement whenever the
    // scenario entered the tick alive; after it, only while alive
    if (alive || (k == 0 && alive0)) {
      T u0, u1;
      if (a.is_delta_v) {
        u0 = T(0);
        u1 = T(0);
      } else {
        u0 = k == 0 ? pu0 : cu0;
        u1 = k == 0 ? pu1 : cu1;
      }
      T o[4];
      rk4(c, s, u0, u1, o);
      if (a.is_delta_v && k == 0) {
        o[2] = add(o[2], pu0);
        o[3] = add(o[3], pu1);
      }
      o[0] = add(o[0], w0);
      o[1] = add(o[1], w1);
      if (k == 0) {
#pragma unroll
        for (int i = 0; i < 4; ++i) first[i] = o[i];
      }
      if (alive) {
#pragma unroll
        for (int i = 0; i < 4; ++i) s[i] = o[i];
      }
    }
    if (a.x_sub != nullptr) {
#pragma unroll
      for (int i = 0; i < 4; ++i) a.x_sub[(k * B + b) * 4 + i] = s[i];
    }
    if (++dr == a.noise_int_sub) {
      dr = 0;
      if (++di < a.n_draws) {
        w0 = a.draws[(di * B + b) * 2];
        w1 = a.draws[(di * B + b) * 2 + 1];
      }
    }
  }

  const bool keep_first = a.x_sub != nullptr ? alive_k0 : alive0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    a.x_end[4 * b + i] = s[i];
    a.x_first[4 * b + i] = keep_first ? first[i] : x0[i];
  }
  a.alive_o[b] = alive ? 1 : 0;
  a.i_term_o[b] = i_term;
  a.succ_o[b] = succ ? 1 : 0;
}

template <typename T>
int launch(void* const* p, int B, int n_draws, int j, int n_sub,
           int noise_int_sub, int is_delta_v, int in_track,
           const double* consts, void* stream) {
  Args<T> a;
  a.x = static_cast<const T*>(p[0]);
  a.alive = static_cast<const unsigned char*>(p[1]);
  a.i_term = static_cast<const int*>(p[2]);
  a.succ = static_cast<const unsigned char*>(p[3]);
  a.prev_u = static_cast<const T*>(p[4]);
  a.ctrl = static_cast<const T*>(p[5]);
  a.draws = static_cast<const T*>(p[6]);
  a.x_end = static_cast<T*>(p[7]);
  a.alive_o = static_cast<unsigned char*>(p[8]);
  a.i_term_o = static_cast<int*>(p[9]);
  a.succ_o = static_cast<unsigned char*>(p[10]);
  a.x_first = static_cast<T*>(p[11]);
  a.x_sub = static_cast<T*>(p[12]);
  a.B = B;
  a.n_draws = n_draws;
  a.j = j;
  a.n_sub = n_sub;
  a.noise_int_sub = noise_int_sub;
  a.is_delta_v = is_delta_v;
  a.in_track = in_track;
  T* cv = reinterpret_cast<T*>(&a.c);
  for (int i = 0; i < kConsts; ++i) cv[i] = static_cast<T>(consts[i]);
  if (B <= 0) return 0;
  rk4_tick_kernel<T><<<(B + kBlock - 1) / kBlock, kBlock, 0,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define RK4_TICK_ENTRY(NAME, T)                                                \
  extern "C" int NAME(void* p0, void* p1, void* p2, void* p3, void* p4,      \
                      void* p5, void* p6, void* p7, void* p8, void* p9,      \
                      void* p10, void* p11, void* p12, int B, int n_draws,   \
                      int j, int n_sub, int noise_int_sub, int is_delta_v,   \
                      int in_track, const double* consts, void* stream) {    \
    void* const p[13] = {p0, p1, p2, p3, p4, p5, p6, p7, p8, p9, p10, p11,   \
                         p12};                                               \
    return launch<T>(p, B, n_draws, j, n_sub, noise_int_sub, is_delta_v,     \
                     in_track, consts, stream);                              \
  }

RK4_TICK_ENTRY(rk4_tick_f32, float)
RK4_TICK_ENTRY(rk4_tick_f64, double)
