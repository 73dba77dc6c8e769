// Pair evaluation of collapsed sum-of-products specs, compiled per spec
// structure, and the row walks of the Gram matvec (matvec_rows for r <= 4
// right-hand-side columns, matmat_rows above), shared by the kernels of
// gram.cuh (K1, K2) and banded.cuh (the banded matvec).
//
// A spec is the collapsed groups of ops/gram.py::_collapse_terms: per pair
// and input dimension a difference d, per distinct (dim, kind, scale) a
// scaled distance t (matern: t = s|d| with envelope exp(-t); expquad:
// t = s d with exp(-t^2); wendland: t = s|d|, cut off above 1), per group a
// nested Horner sweep over its coefficient tensor, times sign(d) on its
// parity dimensions, times the envelope of its dimensions' factors.  The
// plain versions are ops/gram.py::_eval_groups and _eval_groups_ff.
//
// The spec's structure is compiled in: ops/_cuda.py generates, per
// structure, a source that defines lgt::Structure (the factor kinds and
// dimensions, the groups' factors, parities, degrees and coefficient
// offsets, and which groups share an envelope) as constexpr tables and
// includes module.cuh.  eval_pair reads them only in constant expressions,
// through static_for, so the group loop, the Horner sweeps and the kind
// branches are unrolled at compile time and no per-pair code reads the
// structure at run time (device code cannot read those host tables at run
// time at all).  Only the values (factor scales and coefficients, the
// outer scale folded in) arrive at run time, by value as a __grid_constant__
// table read at compile-time offsets.  Groups that share their factors
// share one envelope: exp(-(t_0 + t_1 + ...)), one exp a pair instead of
// one per factor.  Every kernel is templated on the structure and on the
// arithmetic policy: float, float-float pairs of floats (ff.cuh), double.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <utility>

#include "ff.cuh"

namespace lgt {

constexpr int kMaxDims = 4;
constexpr int kMaxFactors = 8;
constexpr int kMaxGroups = 8;
constexpr int kMaxCoeffs = 128;

enum Kind : int { kMatern = 0, kExpQuad = 1, kWendland = 2 };
enum Mode : int { kPlain = 0, kFF = 1, kF64 = 2 };

// The spec's values, in the structure's factor and group order (ops/_cuda.py::
// SpecValues mirrors the layout): factor scales, and the coefficients of
// every group's C-order tensor from its offset, pre-split into f32 hi/lo.
struct SpecValues {
  double fac_scale[kMaxFactors];
  float fac_scale_hi[kMaxFactors];
  float fac_scale_lo[kMaxFactors];
  double coef[kMaxCoeffs];
  float coef_hi[kMaxCoeffs];
  float coef_lo[kMaxCoeffs];
};

// -- compile-time loops -----------------------------------------------------------

template <int I>
struct Int {
  static constexpr int value = I;
};

template <class F, int... I>
__device__ __forceinline__ void static_for_seq(F& f, std::integer_sequence<int, I...>) {
  (f(Int<I>{}), ...);
}

// f(Int<0>{}), ..., f(Int<N - 1>{}): the index is a constant expression in f.
template <int N, class F>
__device__ __forceinline__ void static_for(F f) {
  static_for_seq(f, std::make_integer_sequence<int, N>{});
}

__device__ __forceinline__ float fma_of(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_of(double a, double b, double c) { return __fma_rn(a, b, c); }

// -- arithmetic policies -------------------------------------------------------------

// Unroll of the narrow route's loop over staged columns (matvec_rows), each
// iteration A::kRows pairs: the policy's kUnroll, or LGT_PAIR_UNROLL for
// every policy where the build defines it (k2_probe.py times 1, 2 and 4).
#ifdef LGT_PAIR_UNROLL
#define LGT_UNROLL_OR(u) (LGT_PAIR_UNROLL)
#else
#define LGT_UNROLL_OR(u) (u)
#endif

// The plain body in T (float: "plain" mode, double: "f64" mode).  Horner
// steps and the matvec's accumulation are explicit FMAs.
template <typename T>
struct PlainArith {
  using Real = T;
  using Val = T;
  using Acc = T;   // a matvec row sum
  using Prod = T;  // the multi-column route's product type
  //: Rows per thread of the narrow route: independent pair chains per
  //: staged column (FP32 latency is short, FP64's long and its registers 2x).
  static constexpr int kRows = sizeof(T) == 4 ? 4 : 2;
  //: Staged columns per pair-loop iteration: unrolled 4x, the loop's index,
  //: address and branch work drops from 5.25 to 1.5 instructions a pair
  //: (plain; f64 29 to 13.4), 13 % (plain) and 11 % (f64) off K2 on the H100.
  static constexpr int kUnroll = LGT_UNROLL_OR(4);

  static __device__ __forceinline__ T scale(const SpecValues& s, int f) {
    if constexpr (sizeof(T) == 4) {
      return s.fac_scale_hi[f];
    } else {
      return s.fac_scale[f];
    }
  }
  static __device__ __forceinline__ Val cval(const SpecValues& s, int k) {
    if constexpr (sizeof(T) == 4) {
      return s.coef_hi[k];
    } else {
      return s.coef[k];
    }
  }
  static __device__ __forceinline__ Val diff(T a, T b) { return a - b; }
  static __device__ __forceinline__ Val scaled(Val d, const SpecValues& s, int f) { return scale(s, f) * d; }
  static __device__ __forceinline__ Val scaled_abs(Val d, const SpecValues& s, int f) { return scale(s, f) * fabs(d); }
  static __device__ __forceinline__ Val sqr(Val x) { return x * x; }
  static __device__ __forceinline__ Val add(Val a, Val b) { return a + b; }
  static __device__ __forceinline__ Val mul(Val a, Val b) { return a * b; }
  static __device__ __forceinline__ Val exp_neg(Val x) {
    if constexpr (sizeof(T) == 4) {
      return expf(-x);
    } else {
      return exp(-x);
    }
  }
  static __device__ __forceinline__ Val cut(Val t, Val v) { return t <= T(1) ? v : T(0); }
  static __device__ __forceinline__ Val horner_const(Val acc, Val t, const SpecValues& s, int k) {
    return fma_of(acc, t, cval(s, k));
  }
  static __device__ __forceinline__ Val horner(Val acc, Val t, Val sub) { return fma_of(acc, t, sub); }
  // v * sign(d), sign(0) = 0, by selects
  static __device__ __forceinline__ Val signed_part(Val v, Val d) { return d > T(0) ? v : (d < T(0) ? -v : T(0)); }
  static __device__ __forceinline__ T value(Val v) { return v; }

  static __device__ __forceinline__ Acc acc_zero() { return T(0); }
  static __device__ __forceinline__ void accumulate(Acc& p, Val g, T v, T /*v_lo*/) { p = fma_of(g, v, p); }
  static __device__ __forceinline__ void combine(Acc& a, Acc p) { a += p; }
  static __device__ __forceinline__ Acc load(const T* p, const T* /*p_lo*/, size_t at) { return p[at]; }
  static __device__ __forceinline__ void store(T* out, T* /*out_lo*/, size_t at, Acc a) { out[at] = a; }

  static __device__ __forceinline__ Prod prod_of(Val g) { return g; }
  static __device__ __forceinline__ Prod prod_rhs(T v, T /*v_lo*/) { return v; }
  static __device__ __forceinline__ void store_prod(T* out, T* /*out_lo*/, size_t at, Prod p) { out[at] = p; }
};

// The float-float body ("ff" mode, the JAX package's compensated=True).
struct FFArith {
  using Real = float;
  using Val = ff32;
  using Acc = ff32;
  using Prod = double;
  static constexpr int kRows = 2;
  //: Not unrolled: 386 instructions a pair leave no loop work to save, and
  //: unrolled 4x the ff kernel ran 18 % slower on the H100 (2x: the same).
  static constexpr int kUnroll = LGT_UNROLL_OR(1);

  static __device__ __forceinline__ Val diff(float a, float b) { return two_diff(a, b); }
  static __device__ __forceinline__ Val scaled(Val d, const SpecValues& s, int f) {
    return ff_scale(d, s.fac_scale_hi[f], s.fac_scale_lo[f]);
  }
  static __device__ __forceinline__ Val scaled_abs(Val d, const SpecValues& s, int f) {
    return ff_scale(ff_abs(d), s.fac_scale_hi[f], s.fac_scale_lo[f]);
  }
  static __device__ __forceinline__ Val sqr(Val x) { return ff_sqr(x); }
  static __device__ __forceinline__ Val add(Val a, Val b) { return ff_add(a, b); }
  static __device__ __forceinline__ Val mul(Val a, Val b) { return ff_mul(a, b); }
  static __device__ __forceinline__ Val exp_neg(Val x) { return ff_exp(ff_neg(x)); }
  // The Wendland cut-off reads both planes.
  static __device__ __forceinline__ Val cut(Val t, Val v) {
    const bool inside = (t.hi < 1.0f) || (t.hi == 1.0f && t.lo <= 0.0f);
    return inside ? v : ff32{0.0f, 0.0f};
  }
  static __device__ __forceinline__ Val cval(const SpecValues& s, int k) { return {s.coef_hi[k], s.coef_lo[k]}; }
  static __device__ __forceinline__ Val horner_const(Val acc, Val t, const SpecValues& s, int k) {
    return ff_add_const(ff_mul(acc, t), s.coef_hi[k], s.coef_lo[k]);
  }
  static __device__ __forceinline__ Val horner(Val acc, Val t, Val sub) { return ff_add(ff_mul(acc, t), sub); }
  // v * sign(d.hi), sign(0) = 0
  static __device__ __forceinline__ Val signed_part(Val v, Val d) {
    return d.hi > 0.0f ? v : (d.hi < 0.0f ? ff_neg(v) : ff32{0.0f, 0.0f});
  }
  static __device__ __forceinline__ float value(Val v) { return __fadd_rn(v.hi, v.lo); }

  // The product g * (v + v_lo) and the row sum are carried in ff (14 flops
  // a pair and column): the sums cancel by up to ~5e7 at N = 1e5 (sum |k w|
  // / |sum k w|), and an f32 product-sum, as the TPU's dot did, left the CG
  // operator too coarse to converge there.  The result leaves as the pair
  // (hi, lo) with hi = fl(hi + lo), exact: hi alone is the f32 rounding.
  static __device__ __forceinline__ Acc acc_zero() { return {0.0f, 0.0f}; }
  static __device__ __forceinline__ void accumulate(Acc& p, Val g, float v, float v_lo) {
    p = ff_add(p, ff_mul(g, ff32{v, v_lo}));
  }
  static __device__ __forceinline__ void combine(Acc& a, Acc p) { a = ff_add(a, p); }
  static __device__ __forceinline__ Acc load(const float* p, const float* p_lo, size_t at) { return {p[at], p_lo[at]}; }
  static __device__ __forceinline__ void store(float* out, float* out_lo, size_t at, Acc a) {
    const ff32 n = two_sum(a.hi, a.lo);
    out[at] = n.hi;
    out_lo[at] = n.lo;
  }

  // The multi-column route forms the product and the sum in float64 from
  // hi + lo and v + v_lo (exact to ~eps64): 2 FP64 flops a pair and column
  // against ~20 FP32 flops in ff; the result leaves as its f32 split.
  static __device__ __forceinline__ Prod prod_of(Val g) { return static_cast<double>(g.hi) + g.lo; }
  static __device__ __forceinline__ Prod prod_rhs(float v, float v_lo) { return static_cast<double>(v) + v_lo; }
  static __device__ __forceinline__ void store_prod(float* out, float* out_lo, size_t at, Prod p) {
    const float hi = static_cast<float>(p);
    out[at] = hi;
    out_lo[at] = static_cast<float>(p - static_cast<double>(hi));
  }
};

// -- pair evaluation -------------------------------------------------------------------

// Nested Horner over axis AX of group G's C-order coefficient tensor, whose
// sub-tensor starts at coefficient OFF; ts[i]: the group's variable of
// dimension i.
template <class S, class A, int G, int AX, int OFF>
__device__ __forceinline__ typename A::Val horner(const SpecValues& s, const typename A::Val* ts) {
  using Val = typename A::Val;
  constexpr int n = S::grp_deg[G][AX];
  if constexpr (AX == S::nd - 1) {
    Val acc = A::cval(s, OFF + n - 1);
    static_for<n - 1>([&](auto K) { acc = A::horner_const(acc, ts[AX], s, OFF + n - 2 - decltype(K)::value); });
    return acc;
  } else {
    constexpr int stride = S::grp_stride[G][AX];
    Val acc = horner<S, A, G, AX + 1, OFF + (n - 1) * stride>(s, ts);
    static_for<n - 1>([&](auto K) {
      constexpr int k = n - 2 - decltype(K)::value;
      acc = A::horner(acc, ts[AX], horner<S, A, G, AX + 1, OFF + k * stride>(s, ts));
    });
    return acc;
  }
}

// k(a, b) for one pair of points (coordinates a[nd], b[nd]) of structure S.
template <class S, class A>
__device__ __forceinline__ typename A::Val eval_pair(const SpecValues& s, const typename A::Real* a,
                                                     const typename A::Real* b) {
  using Val = typename A::Val;
  constexpr int ND = S::nd;
  Val d[ND];
  static_for<ND>([&](auto I) {
    constexpr int i = decltype(I)::value;
    d[i] = A::diff(a[i], b[i]);
  });
  Val t[S::nfactors];
  static_for<S::nfactors>([&](auto F) {
    constexpr int f = decltype(F)::value;
    constexpr int dim = S::fac_dim[f];
    if constexpr (S::fac_kind[f] == kExpQuad) {
      t[f] = A::scaled(d[dim], s, f);
    } else {
      t[f] = A::scaled_abs(d[dim], s, f);
    }
  });
  Val total;
  static_for<S::nenv>([&](auto E) {
    constexpr int e = decltype(E)::value;
    constexpr int g0 = S::env_begin[e];
    // The signed polynomials of the groups sharing this envelope.
    Val poly;
    static_for<S::env_begin[e + 1] - g0>([&](auto Gi) {
      constexpr int g = g0 + decltype(Gi)::value;
      Val ts[ND];
      static_for<ND>([&](auto I) {
        constexpr int i = decltype(I)::value;
        constexpr int f = S::grp_fac[g][i];
        ts[i] = t[f];
      });
      Val val = horner<S, A, g, 0, S::grp_off[g]>(s, ts);
      static_for<ND>([&](auto I) {
        constexpr int i = decltype(I)::value;
        if constexpr (S::grp_parity[g][i] != 0) val = A::signed_part(val, d[i]);
      });
      if constexpr (g == g0) {
        poly = val;
      } else {
        poly = A::add(poly, val);
      }
    });
    // The envelope: one exp of the summed exponents, then the cut-offs.
    constexpr int first = S::env_first_exp[e];
    if constexpr (first >= 0) {
      Val arg;
      static_for<ND>([&](auto I) {
        constexpr int i = decltype(I)::value;
        constexpr int f = S::grp_fac[g0][i];
        if constexpr (S::fac_kind[f] != kWendland) {
          Val x = t[f];
          if constexpr (S::fac_kind[f] == kExpQuad) x = A::sqr(x);
          if constexpr (i == first) {
            arg = x;
          } else {
            arg = A::add(arg, x);
          }
        }
      });
      poly = A::mul(poly, A::exp_neg(arg));
    }
    static_for<ND>([&](auto I) {
      constexpr int f = S::grp_fac[g0][decltype(I)::value];
      if constexpr (S::fac_kind[f] == kWendland) poly = A::cut(t[f], poly);
    });
    if constexpr (e == 0) {
      total = poly;
    } else {
      total = A::add(total, poly);
    }
  });
  return total;
}

// -- the narrow route: a few rows per thread, r <= 4 columns -------------------------------

// Replaces, for r <= 4, the body _matvec_body (linpde_gp_tpu/ops/
// pallas_gram.py:348) of K2, _build_pallas_gram_matvec (:393): K(X0, X1) @ V
// without storing K.
//
// What bounds it on the H100: the pair evaluation's instruction issue.  It
// reads O(n0 + n1 r) bytes and evaluates n0 n1 pairs, each once per RC <= 4
// columns.  A heat-spec pair costs, by cuobjdump -sass of the pair loop
// (linpde_gp_tpu_torch/k2_probe.py), 30 instructions of which 27 FP32 and
// one MUFU.EX2 (plain), 66 of which 40 FP64 (f64: libdevice's exp) and 386
// of which 376 FP32 (ff: ff_exp and the ff Horner sweeps): FP32 issue bounds
// plain and ff, the FP64 pipe (half the FP32 rate) f64.  The design against
// that: the structure is compiled in (no table interpretation, which made
// 40-50 % of a run-time-table pair loop's instructions integer index and
// select work in plain and f64), groups that share their factors share one
// exp, FMAs are contracted in plain and f64, each thread takes A::kRows rows
// so that every staged column (a shared-memory broadcast) feeds kRows
// independent pair chains that hide FP64 and MUFU latency, and the plain
// and f64 pair loops are unrolled (A::kUnroll) to shed loop work.  A launch whose row blocks
// give the card fewer than ~4 blocks per SM (the posterior mean's 8,192
// rows) splits its columns over gridDim.z, and a deterministic second pass
// sums the chunks in order (ops/_cuda.py::column_split).
constexpr int kNarrowThreads = 128;  // threads per K2 block
constexpr int kNarrowTile = 128;     // columns staged per pass

// out[i, c0:c0+RC] = sum_{j in [j_begin, j_end)} k(x0_i, x1_j) v[j, c0:c0+RC]
// for the rows i = row0 + q * blockDim.x + threadIdx.x, q < A::kRows, and
// c0 = blockIdx.y * RC.  The block stages kNarrowTile columns at a time (X1
// coordinates, V's rows and, in mode ff, the lo plane v_lo, which may be
// null) in shared memory; each thread walks them with its rows' sums in
// registers (a partial sum per tile, then the running sum), so results are
// deterministic; ragged edges are masked.  Points arrive transposed, (ND, n),
// so neighbouring threads read neighbouring addresses.  out_lo receives the
// lo plane in mode ff.  Every thread of the block must call this with the
// same column range (it synchronizes the block).
template <class S, class A, int RC>
__device__ __forceinline__ void matvec_rows(const SpecValues& s, const typename A::Real* __restrict__ x0t,
                                            const typename A::Real* __restrict__ x1t,
                                            const typename A::Real* __restrict__ v,
                                            const typename A::Real* __restrict__ v_lo,
                                            typename A::Real* __restrict__ out, typename A::Real* __restrict__ out_lo,
                                            int n0, int n1, int r, int row0, int j_begin, int j_end) {
  using T = typename A::Real;
  using Acc = typename A::Acc;
  constexpr int ND = S::nd, RPT = A::kRows, TILE = kNarrowTile;
  constexpr bool kLo = sizeof(Acc) != sizeof(T);  // ff: stage the lo plane of v
  __shared__ T sx[ND][TILE];
  __shared__ T sv[TILE][RC];
  __shared__ T svl[kLo ? TILE : 1][RC];

  const int c0 = blockIdx.y * RC;
  T a[RPT][ND];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int i = row0 + q * blockDim.x + threadIdx.x;
#pragma unroll
    for (int k = 0; k < ND; ++k) a[q][k] = i < n0 ? x0t[static_cast<size_t>(k) * n0 + i] : T(0);
  }
  Acc tot[RPT][RC];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
#pragma unroll
    for (int c = 0; c < RC; ++c) tot[q][c] = A::acc_zero();
  }

  for (int j0 = j_begin; j0 < j_end; j0 += TILE) {
    const int jn = min(TILE, j_end - j0);
    __syncthreads();  // the previous tile is consumed
    for (int k = threadIdx.x; k < jn; k += blockDim.x) {
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) sx[dd][k] = x1t[static_cast<size_t>(dd) * n1 + j0 + k];
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const size_t at = static_cast<size_t>(j0 + k) * r + c0 + c;
        sv[k][c] = c0 + c < r ? v[at] : T(0);
        if constexpr (kLo) svl[k][c] = c0 + c < r && v_lo != nullptr ? v_lo[at] : T(0);
      }
    }
    __syncthreads();

    Acc part[RPT][RC];
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
#pragma unroll
      for (int c = 0; c < RC; ++c) part[q][c] = A::acc_zero();
    }
#pragma unroll(A::kUnroll)
    for (int kk = 0; kk < jn; ++kk) {
      T b[ND], w[RC], wl[RC];
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) b[dd] = sx[dd][kk];
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        w[c] = sv[kk][c];
        wl[c] = kLo ? svl[kLo ? kk : 0][c] : T(0);
      }
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const typename A::Val g = eval_pair<S, A>(s, a[q], b);
#pragma unroll
        for (int c = 0; c < RC; ++c) A::accumulate(part[q][c], g, w[c], wl[c]);
      }
    }
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
#pragma unroll
      for (int c = 0; c < RC; ++c) A::combine(tot[q][c], part[q][c]);
    }
  }
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
    const int i = row0 + q * blockDim.x + threadIdx.x;
    if (i >= n0) continue;
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      if (c0 + c < r) A::store(out, out_lo, static_cast<size_t>(i) * r + c0 + c, tot[q][c]);
    }
  }
}

// The column split's second pass: out[e] = sum_z part[z m + e] over the
// splits z in order (in ff for mode ff), e < m = n0 r.
template <class A>
__global__ void matvec_reduce_kernel(const typename A::Real* __restrict__ part,
                                     const typename A::Real* __restrict__ part_lo, typename A::Real* __restrict__ out,
                                     typename A::Real* __restrict__ out_lo, int splits, size_t m) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= m) return;
  typename A::Acc acc = A::load(part, part_lo, e);
  for (int z = 1; z < splits; ++z) A::combine(acc, A::load(part, part_lo, z * m + e));
  A::store(out, out_lo, e, acc);
}

// -- one block of rows, many columns: the multi-column route ------------------------

// matvec_rows evaluates every pair once per RC <= 4 right-hand-side columns,
// so at r = 256 it would evaluate each pair 64 times.  The TPU bodies
// (pallas_gram.py:348-389, :626-660) evaluate each Gram tile once and
// multiply it by the whole (tile, r) panel; matmat_rows does the same per
// block of RW in {64, 128, 256} columns, so a pair is evaluated ceil(r / RW)
// times, once for r <= 256.
//
// What bounds it on the H100: at RW = 256 the product is 512 flops a pair
// (in FP64 for modes f64 and ff, FP32 for plain) against ~35 (f64) to ~370
// (ff, FP32) for the evaluation, so FP64 FMA throughput, not the evaluation.
constexpr int kMatmatThreads = 256;  // 8 warps
// The FP64-product instantiations at RW = 256 (modes f64 and ff) launch a
// copy of their kernel held to two blocks per SM, at most 128 registers a
// thread: unbounded, the ff one takes 125-144 and runs one block per SM (on
// the H100: banded ff at r = 256 86 -> 52 ms, K2 ff 1443 -> 790 ms at
// 1e5 x 1e5).  The others keep __launch_bounds__(kMatmatThreads) alone (40-80
// registers).  A second argument of 1 is not the same: it tells ptxas one
// block per SM is enough, and it spends registers up to its limit (K2 ff
// RW = 64 58 -> 155, f64 RW = 128 74 -> 114), which cost K2 at r = 64 1.2-1.4x
// and plain at r = 256 1.2x on the H100.  So one kernel with a templated
// minimum does not do, and the bounded copy is a kernel of its own.
template <class A, int RW>
constexpr bool kMatmatTwoBlocks = RW == 256 && sizeof(typename A::Prod) == 8;
constexpr int kMatmatRows = 32;      // output rows per block
constexpr int kMatmatDepth = 32;     // Gram columns (V rows) per tile

template <class A, int ND, int RW>
constexpr size_t matmat_smem_bytes() {
  return sizeof(typename A::Prod) * static_cast<size_t>(kMatmatDepth) * (RW + kMatmatRows) +
         sizeof(typename A::Real) * static_cast<size_t>(kMatmatDepth) * ND;
}

// Dynamic shared memory above 48 KB must be allowed per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

// out[i, c0:c0+RW] = sum_{j in [j_begin, j_end)} k(x0_i, x1_j) v[j, c0:c0+RW]
// for the kMatmatRows rows from blockIdx.x * kMatmatRows, c0 = blockIdx.y * RW,
// launched with kMatmatThreads threads.  Per tile of kMatmatDepth columns the
// block stages the tile's X1 coordinates and V's (depth x RW) panel (as
// A::Prod, the lo plane of an ff right-hand side folded in), evaluates the
// tile's (rows x depth) pairs once each through eval_pair into shared memory
// (as A::Prod: hi + lo in float64 for ff), and each thread accumulates an
// 8 x RW/64 register micro-tile of the output from the two with explicit
// FMAs.  Warp w owns rows (w % 4) * 8 + [0, 8) and columns (w / 4) * RW/2 +
// lane + 32 j: Gram reads are warp broadcasts; V reads and output stores are
// 32 consecutive elements.  No atomics; ragged edges are masked.  Every thread
// of the block must call this with the same column range.
template <class S, class A, int RW>
__device__ __forceinline__ void matmat_rows(const SpecValues& s, const typename A::Real* __restrict__ x0t,
                                            const typename A::Real* __restrict__ x1t,
                                            const typename A::Real* __restrict__ v,
                                            const typename A::Real* __restrict__ v_lo,
                                            typename A::Real* __restrict__ out, typename A::Real* __restrict__ out_lo,
                                            int n0, int n1, int r, int j_begin, int j_end) {
  using T = typename A::Real;
  using P = typename A::Prod;
  constexpr int ND = S::nd;
  constexpr int T0 = kMatmatRows, T1 = kMatmatDepth, TN = RW / 64;
  static_assert(RW % 64 == 0 && T0 == 32 && kMatmatThreads == 256, "warp layout assumes these sizes");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  P* sV = reinterpret_cast<P*>(smem_raw);      // [T1][RW]
  P* sG = sV + T1 * RW;                        // [T1][T0]: rows fastest
  T* sx = reinterpret_cast<T*>(sG + T1 * T0);  // [ND][T1]

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.x * T0;
  const int c0 = blockIdx.y * RW;

  // Evaluation: this thread's row is row0 + lane, its columns warp + 8 q.
  T a[ND];
  const int er = row0 + lane;
#pragma unroll
  for (int k = 0; k < ND; ++k) a[k] = er < n0 ? x0t[static_cast<size_t>(k) * n0 + er] : T(0);

  // Product: rows pr + [0, 8), columns pc + 32 j.
  const int pr = (warp & 3) * 8;
  const int pc = (warp >> 2) * (RW / 2) + lane;
  P acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = P(0);
  }

  for (int j0 = j_begin; j0 < j_end; j0 += T1) {
    const int jn = min(T1, j_end - j0);
    __syncthreads();  // the previous tile is consumed
    if (tid < jn) {
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) sx[dd * T1 + tid] = x1t[static_cast<size_t>(dd) * n1 + j0 + tid];
    }
    for (int e = tid; e < T1 * RW; e += kMatmatThreads) {
      const int k = e / RW, c = e % RW;
      P val = P(0);
      if (k < jn && c0 + c < r) {
        const size_t at = static_cast<size_t>(j0 + k) * r + c0 + c;
        val = A::prod_rhs(v[at], v_lo != nullptr ? v_lo[at] : T(0));
      }
      sV[e] = val;
    }
    __syncthreads();
#pragma unroll 1
    for (int q = 0; q < T1 / 8; ++q) {
      const int k = warp + 8 * q;
      P g = P(0);
      if (k < jn) {
        T b[ND];
#pragma unroll
        for (int dd = 0; dd < ND; ++dd) b[dd] = sx[dd * T1 + k];
        g = A::prod_of(eval_pair<S, A>(s, a, b));
      }
      sG[k * T0 + lane] = g;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < T1; ++k) {
      P g[8], w[TN];
#pragma unroll
      for (int i = 0; i < 8; ++i) g[i] = sG[k * T0 + pr + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) w[j] = sV[k * RW + pc + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fma_of(g[i], w[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + pr + i;
    if (row >= n0) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = c0 + pc + 32 * j;
      if (col < r) A::store_prod(out, out_lo, static_cast<size_t>(row) * r + col, acc[i][j]);
    }
  }
}

}  // namespace lgt
