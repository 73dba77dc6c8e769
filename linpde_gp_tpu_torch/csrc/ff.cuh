// Float-float ("double-single") arithmetic for the CUDA kernels.
//
// Device counterpart of linpde_gp_tpu_torch/ops/ff.py (itself a port of
// linpde_gp_tpu/ops/ff.py).  A value is an unevaluated pair (hi, lo) of
// floats with hi + lo accurate to ~eps32^2.  The error-free transforms are
// exact only if no multiply and add are contracted into one FMA, so every
// operation is written with the round-to-nearest intrinsics (__fadd_rn,
// __fsub_rn, __fmul_rn), which the compiler never contracts, even though the
// modules are compiled with contraction on (for the plain and f64 bodies,
// which write their FMAs explicitly).  two_prod uses the exact fmaf(a, b, -p)
// in place of Dekker's split: both give the unique error term, so each
// operation equals its plain version in ops/ff.py bit for bit.
#pragma once

#include <cuda_runtime.h>

namespace lgt {

struct ff32 {
  float hi, lo;
};

__device__ __forceinline__ ff32 two_sum(float a, float b) {
  const float s = __fadd_rn(a, b);
  const float bb = __fsub_rn(s, a);
  return {s, __fadd_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fsub_rn(b, bb))};
}

__device__ __forceinline__ ff32 two_diff(float a, float b) {
  const float s = __fsub_rn(a, b);
  const float bb = __fsub_rn(s, a);
  return {s, __fsub_rn(__fsub_rn(a, __fsub_rn(s, bb)), __fadd_rn(b, bb))};
}

__device__ __forceinline__ ff32 two_prod(float a, float b) {
  const float p = __fmul_rn(a, b);
  return {p, fmaf(a, b, -p)};
}

__device__ __forceinline__ ff32 ff_add(ff32 x, ff32 y) {
  const ff32 s = two_sum(x.hi, y.hi);
  return {s.hi, __fadd_rn(s.lo, __fadd_rn(x.lo, y.lo))};
}

__device__ __forceinline__ ff32 ff_add_const(ff32 x, float c_hi, float c_lo) {
  const ff32 s = two_sum(x.hi, c_hi);
  return {s.hi, __fadd_rn(s.lo, __fadd_rn(x.lo, c_lo))};
}

__device__ __forceinline__ ff32 ff_mul(ff32 x, ff32 y) {
  const ff32 p = two_prod(x.hi, y.hi);
  return {p.hi, __fadd_rn(p.lo, __fadd_rn(__fmul_rn(x.hi, y.lo), __fmul_rn(x.lo, y.hi)))};
}

__device__ __forceinline__ ff32 ff_sqr(ff32 x) {
  const ff32 p = two_prod(x.hi, x.hi);
  return {p.hi, __fadd_rn(p.lo, __fmul_rn(2.0f, __fmul_rn(x.hi, x.lo)))};
}

__device__ __forceinline__ ff32 ff_neg(ff32 x) { return {-x.hi, -x.lo}; }

__device__ __forceinline__ ff32 ff_abs(ff32 x) {
  const float s = x.hi < 0.0f ? -1.0f : 1.0f;
  return {__fmul_rn(x.hi, s), __fmul_rn(x.lo, s)};
}

// x times a constant pre-split on the host into (s_hi, s_lo).
__device__ __forceinline__ ff32 ff_scale(ff32 x, float s_hi, float s_lo) {
  const ff32 p = two_prod(x.hi, s_hi);
  return {p.hi, __fadd_rn(p.lo, __fadd_rn(__fmul_rn(x.hi, s_lo), __fmul_rn(x.lo, s_hi)))};
}

// -- exp ---------------------------------------------------------------------

__host__ __device__ constexpr double inv_factorial(int k) {
  double f = 1.0;
  for (int i = 2; i <= k; ++i) f *= i;
  return 1.0 / f;
}

// ff_const of a double: f32 hi, and the f32 rounding of the remainder.
template <int K>
struct ExpCoeff {
  static constexpr double c = inv_factorial(K);
  static constexpr float hi = static_cast<float>(c);
  static constexpr float lo = static_cast<float>(c - static_cast<double>(hi));
};

constexpr double kLn2 = 0.6931471805599453094172321;
constexpr float kLn2Hi = static_cast<float>(kLn2);
constexpr float kLn2Lo = static_cast<float>(kLn2 - static_cast<double>(kLn2Hi));
constexpr float kLog2e = static_cast<float>(1.4426950408889634073599247);

template <int K>
__device__ __forceinline__ ff32 exp_horner(ff32 acc, ff32 r) {
  acc = ff_add_const(ff_mul(acc, r), ExpCoeff<K>::hi, ExpCoeff<K>::lo);
  if constexpr (K > 0) {
    return exp_horner<K - 1>(acc, r);
  } else {
    return acc;
  }
}

// exp of an ff pair (ff.py::ff_exp): clamp at +-87, x = k ln2 + r with
// k ln2 carried error-free against the split ln2, degree-10 Taylor Horner
// in ff, and an exact 2^k built from exponent bits.
__device__ __forceinline__ ff32 ff_exp(ff32 x) {
  const bool clamped = (x.hi < -87.0f) || (x.hi > 87.0f);
  const float xh = fminf(fmaxf(x.hi, -87.0f), 87.0f);
  const float xl = clamped ? 0.0f : x.lo;
  const float kf = floorf(__fadd_rn(__fmul_rn(xh, kLog2e), 0.5f));
  const ff32 p = two_prod(kf, kLn2Hi);
  const float pe = __fadd_rn(p.lo, __fmul_rn(kf, kLn2Lo));
  const ff32 rs = two_sum(xh, -p.hi);
  const ff32 r = {rs.hi, __fadd_rn(rs.lo, __fsub_rn(xl, pe))};
  const ff32 acc = exp_horner<9>(ff32{ExpCoeff<10>::hi, ExpCoeff<10>::lo}, r);
  const float two_k = __int_as_float((static_cast<int>(kf) + 127) << 23);
  return {__fmul_rn(acc.hi, two_k), __fmul_rn(acc.lo, two_k)};
}

}  // namespace lgt
