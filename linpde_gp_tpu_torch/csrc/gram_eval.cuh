// Pair evaluation of collapsed sum-of-products specs, compiled per spec
// structure, and the row walks of the Gram matvec (matvec_rows for r <= 4
// right-hand-side columns, matmat_rows above, sym_walk for r <= 4 on a Gram
// of a point set with itself), shared by the kernels of gram.cuh (K1, K2)
// and banded.cuh (the banded matvec).
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

// The plain body in T (float: "plain" mode, double: "f64" mode).  Horner
// steps and the matvec's accumulation are explicit FMAs.
template <typename T>
struct PlainArith {
  using Real = T;
  using Val = T;
  using Acc = T;  // a matvec row sum
  //: Rows per thread of the narrow route: independent pair chains per
  //: staged column (FP32 latency is short, FP64's long and its registers 2x).
  static constexpr int kRows = sizeof(T) == 4 ? 4 : 2;
  //: Staged columns per pair-loop iteration: unrolled 4x, the loop's index,
  //: address and branch work drops from 5.25 to 1.5 instructions a pair
  //: (plain; f64 29 to 13.4), 13 % (plain) and 11 % (f64) off K2 on the H100.
  static constexpr int kUnroll = 4;

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

  // The multi-column route's product is float64 in every mode (matmat_rows);
  // plain rounds the f64 sum to f32 once, at the end.
  static __device__ __forceinline__ double prod_of(Val g) { return static_cast<double>(g); }
  static __device__ __forceinline__ void store_prod(T* out, T* /*out_lo*/, size_t at, double p) {
    out[at] = static_cast<T>(p);
  }
};

// The float-float body ("ff" mode, the JAX package's compensated=True).
struct FFArith {
  using Real = float;
  using Val = ff32;
  using Acc = ff32;
  static constexpr int kRows = 2;
  //: Not unrolled: 386 instructions a pair leave no loop work to save, and
  //: unrolled 4x the ff kernel ran 18 % slower on the H100 (2x: the same).
  static constexpr int kUnroll = 1;

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
  // hi + lo and the f64 panel v + v_lo (exact to ~eps64); the result leaves
  // as its f32 split.
  static __device__ __forceinline__ double prod_of(Val g) { return static_cast<double>(g.hi) + g.lo; }
  static __device__ __forceinline__ void store_prod(float* out, float* out_lo, size_t at, double p) {
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

// -- the narrow route on a symmetric Gram: each tile pair once ------------------------

// K(X, X) @ V for r <= 4 (the CG's matvec (H k H*)(X, X) p), where
// matvec_rows evaluates every unordered pair twice, once as (i, j) and once
// as (j, i).  Rows and columns are cut into the same tiles of B = the narrow
// route's rows per block; the walk visits each tile pair (I, J), J >= I, of
// the upper triangle once.  A pair g = k(x_i, x_j) of an off-diagonal tile
// adds g v_j to row i, in registers as matvec_rows does, and g v_i to row j:
// each thread forms its rows' share of column j in registers, stashes it in
// shared memory, and its warp sums the stash every kSymStash values (lanes L
// and L + 16 each add 16 of the warp's 32 shares, then one shuffle); the
// four warps' column sums meet once per tile.  A diagonal tile counts each
// pair once: row i takes the columns j >= i, column j the rows i < j.
//
// What bounds it: as matvec_rows, the pair evaluation's FP64 (f64) or FP32
// issue, over n (n + 1) / 2 pairs (whole diagonal tiles: + n B / 2) instead
// of n^2.  A column share costs one more product-sum a pair and, a column
// and thread, one shared store and about two instructions of the warp's sum
// (~4 % of the f64 pair's ~66 instructions).
//
// Schedule (ops/_cuda.py::sym_schedule): the tile pairs in row-major order
// (I, then J = I..nb-1) are cut into one chunk per block of equal numbers of
// pairs (differing by at most one), and a persistent grid of as many blocks
// as fit on the card at once walks them: row block 0 owns nb tile pairs and
// the last one, so whole row blocks per block would leave most of the card
// idle at the end.  A chunk's table entry gives its first (I, J), its pair
// count and the index of its first pair.
//
// Deterministic, no atomics: each tile's column sums go to the pair's own
// slot of the scratch (pair p of (I, J): slot p), and each run of one row
// block inside one chunk writes its row sums to slot pairs + c + I (chunk c;
// c + I differs between runs, since both grow along the walk).
// sym_matvec_reduce_kernel then sums, for each output row j of tile J, the
// row runs of J in chunk order and the column sums of the tiles (I, J), I =
// 0..J, in order.  The scratch, (pairs + chunks + nb - 1) B r values (and
// its lo plane in mode ff; 159 MB at N = 1e5, r = 1, f64), is the wrapper's
// (ops/_cuda.py::_sym_scratch: one buffer a stream, kept and grown, in a
// memory pool of its own, so that no matvec of a CG, nor the next
// regressor's, allocates device memory or splits another block; it grows
// as n^2, so the wrapper refuses one past half the free memory, and
// release_sym_scratch() hands it back between solves).
constexpr int kNarrowWarps = kNarrowThreads / 32;
constexpr int kSymStash = 16;  // column shares a lane stashes per round: kSymStash / RC columns
constexpr int kSymLd = 33;     // stash row stride (doubles or floats): conflict-free rows and columns

constexpr size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// Dynamic shared memory of the symmetric walk: X's coordinates (nd, B) and
// V's rows (B, RC) of the staged column tile (and the lo plane in mode ff),
// each warp's stash (kSymStash, kSymLd) and its column sums of the tile (B RC).
template <class S, class A, int RC>
struct SymSmem {
  using T = typename A::Real;
  using Acc = typename A::Acc;
  static constexpr int B = kNarrowThreads * A::kRows;
  static constexpr bool kLo = sizeof(Acc) != sizeof(T);
  static constexpr size_t sx = 0;
  static constexpr size_t sv = align16(sx + sizeof(T) * S::nd * B);
  static constexpr size_t svl = align16(sv + sizeof(T) * B * RC);
  static constexpr size_t stash = align16(svl + (kLo ? sizeof(T) * B * RC : 0));
  static constexpr size_t wcol = align16(stash + sizeof(Acc) * kNarrowWarps * kSymStash * kSymLd);
  static constexpr size_t bytes = align16(wcol + sizeof(Acc) * kNarrowWarps * B * RC);
};

__device__ __forceinline__ float shfl_down(float x, int d) { return __shfl_down_sync(0xffffffffu, x, d); }
__device__ __forceinline__ double shfl_down(double x, int d) { return __shfl_down_sync(0xffffffffu, x, d); }
__device__ __forceinline__ ff32 shfl_down(ff32 x, int d) { return {shfl_down(x.hi, d), shfl_down(x.lo, d)}; }

// One tile pair: row block I (this thread's rows a, vi, vil; their running
// sums tot) against column tile J from j0.  Adds the rows' sums over the
// tile to tot and writes the tile's column sums to slot `slot`.  Every
// thread of the block calls it (it synchronizes the block).
template <class S, class A, int RC, bool kDiag>
__device__ __forceinline__ void sym_tile(const SpecValues& s, const typename A::Real (&a)[A::kRows][S::nd],
                                         const typename A::Real (&vi)[A::kRows][RC],
                                         const typename A::Real (&vil)[A::kRows][RC],
                                         typename A::Acc (&tot)[A::kRows][RC], const typename A::Real* __restrict__ xt,
                                         const typename A::Real* __restrict__ v,
                                         const typename A::Real* __restrict__ v_lo, typename A::Real* __restrict__ col,
                                         typename A::Real* __restrict__ col_lo, int n, int r, int j0, size_t slot,
                                         unsigned char* smem) {
  using T = typename A::Real;
  using Acc = typename A::Acc;
  using Val = typename A::Val;
  using L = SymSmem<S, A, RC>;
  constexpr int ND = S::nd, RPT = A::kRows, B = L::B, SUB = kSymStash / RC;
  static_assert(kSymStash % RC == 0 && B % SUB == 0, "whole stash rounds a tile");
  T* sx = reinterpret_cast<T*>(smem + L::sx);    // [ND][B]
  T* sv = reinterpret_cast<T*>(smem + L::sv);    // [B][RC]
  T* svl = reinterpret_cast<T*>(smem + L::svl);  // [B][RC], mode ff
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  Acc* stash = reinterpret_cast<Acc*>(smem + L::stash) + warp * kSymStash * kSymLd;  // [o][lane]
  Acc* wcol = reinterpret_cast<Acc*>(smem + L::wcol);                                 // [warp][B RC]

  __syncthreads();  // the previous tile's columns and column sums are consumed
  for (int k = tid; k < B; k += kNarrowThreads) {
    const int j = j0 + k;
    const bool ok = j < n;
#pragma unroll
    for (int dd = 0; dd < ND; ++dd) sx[dd * B + k] = ok ? xt[static_cast<size_t>(dd) * n + j] : T(0);
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const bool okc = ok && c < r;
      const size_t at = static_cast<size_t>(j) * r + c;
      sv[k * RC + c] = okc ? v[at] : T(0);
      if constexpr (L::kLo) svl[k * RC + c] = okc && v_lo != nullptr ? v_lo[at] : T(0);
    }
  }
  __syncthreads();

  Acc part[RPT][RC];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
#pragma unroll
    for (int c = 0; c < RC; ++c) part[q][c] = A::acc_zero();
  }
  for (int k0 = 0; k0 < B; k0 += SUB) {
#pragma unroll(A::kUnroll)
    for (int u = 0; u < SUB; ++u) {
      const int kk = k0 + u;
      T b[ND], w[RC], wl[RC];
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) b[dd] = sx[dd * B + kk];
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        w[c] = sv[kk * RC + c];
        wl[c] = L::kLo ? svl[kk * RC + c] : T(0);
      }
      Acc share[RC];
#pragma unroll
      for (int c = 0; c < RC; ++c) share[c] = A::acc_zero();
#pragma unroll
      for (int q = 0; q < RPT; ++q) {
        const Val g = eval_pair<S, A>(s, a[q], b);
        Val g_row = g, g_col = g;
        if constexpr (kDiag) {
          const int li = q * kNarrowThreads + tid;
          g_row = kk >= li ? g : Val{};
          g_col = kk > li ? g : Val{};
        }
#pragma unroll
        for (int c = 0; c < RC; ++c) {
          A::accumulate(part[q][c], g_row, w[c], wl[c]);
          A::accumulate(share[c], g_col, vi[q][c], vil[q][c]);
        }
      }
#pragma unroll
      for (int c = 0; c < RC; ++c) stash[(u * RC + c) * kSymLd + lane] = share[c];
    }
    __syncwarp();
    // Output o of the round: lanes o and o + 16 each sum 16 lanes' shares.
    const int o = lane & (kSymStash - 1), h = lane >> 4;
    Acc x = stash[o * kSymLd + 16 * h];
#pragma unroll
    for (int m = 1; m < 16; ++m) A::combine(x, stash[o * kSymLd + 16 * h + m]);
    const Acc y = shfl_down(x, 16);
    if (lane < 16) {
      A::combine(x, y);
      wcol[warp * B * RC + k0 * RC + o] = x;
    }
    __syncwarp();  // the stash is read before the next round writes it
  }
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
#pragma unroll
    for (int c = 0; c < RC; ++c) A::combine(tot[q][c], part[q][c]);
  }
  __syncthreads();  // every warp's column sums of the tile are in place
  for (int o = tid; o < B * RC; o += kNarrowThreads) {
    Acc x = wcol[o];
#pragma unroll
    for (int w = 1; w < kNarrowWarps; ++w) A::combine(x, wcol[w * B * RC + o]);
    const int c = o % RC;
    if (c < r) A::store(col, col_lo, (slot * B + o / RC) * r + c, x);
  }
}

// The rows of row block I: coordinates, V's entries (and lo plane), zeros past n.
template <class S, class A, int RC>
__device__ __forceinline__ void sym_rows(const typename A::Real* __restrict__ xt,
                                         const typename A::Real* __restrict__ v,
                                         const typename A::Real* __restrict__ v_lo, int n, int r, int I,
                                         typename A::Real (&a)[A::kRows][S::nd], typename A::Real (&vi)[A::kRows][RC],
                                         typename A::Real (&vil)[A::kRows][RC]) {
  using T = typename A::Real;
#pragma unroll
  for (int q = 0; q < A::kRows; ++q) {
    const int i = (I * A::kRows + q) * kNarrowThreads + threadIdx.x;
    const bool ok = i < n;
#pragma unroll
    for (int dd = 0; dd < S::nd; ++dd) a[q][dd] = ok ? xt[static_cast<size_t>(dd) * n + i] : T(0);
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      const bool okc = ok && c < r;
      vi[q][c] = okc ? v[static_cast<size_t>(i) * r + c] : T(0);
      vil[q][c] = okc && v_lo != nullptr ? v_lo[static_cast<size_t>(i) * r + c] : T(0);
    }
  }
}

// The walk of one chunk (chunks[blockIdx.x] = first I, first J, pairs, first
// pair's index) over the tile pairs of the upper triangle, nb tiles a side;
// column sums to part from slot 0, row sums from row_slots_at values on.
template <class S, class A, int RC>
__device__ __forceinline__ void sym_walk(const SpecValues& s, const typename A::Real* __restrict__ xt,
                                         const typename A::Real* __restrict__ v,
                                         const typename A::Real* __restrict__ v_lo, typename A::Real* __restrict__ part,
                                         typename A::Real* __restrict__ part_lo, const int4* __restrict__ chunks,
                                         int n, int r, int nb, size_t row_slots_at) {
  using T = typename A::Real;
  using Acc = typename A::Acc;
  constexpr int RPT = A::kRows, B = SymSmem<S, A, RC>::B;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int4 ch = chunks[blockIdx.x];
  int I = ch.x, J = ch.y;
  T a[RPT][S::nd], vi[RPT][RC], vil[RPT][RC];
  sym_rows<S, A, RC>(xt, v, v_lo, n, r, I, a, vi, vil);
  Acc tot[RPT][RC];
#pragma unroll
  for (int q = 0; q < RPT; ++q) {
#pragma unroll
    for (int c = 0; c < RC; ++c) tot[q][c] = A::acc_zero();
  }
  for (int k = 0; k < ch.z; ++k) {
    const size_t slot = static_cast<size_t>(ch.w) + k;
    if (J == I) {
      sym_tile<S, A, RC, true>(s, a, vi, vil, tot, xt, v, v_lo, part, part_lo, n, r, J * B, slot, smem_raw);
    } else {
      sym_tile<S, A, RC, false>(s, a, vi, vil, tot, xt, v, v_lo, part, part_lo, n, r, J * B, slot, smem_raw);
    }
    const bool last = k + 1 == ch.z;
    if (++J < nb && !last) continue;
    // The end of a run of row block I: its row sums to slot c + I.
    const size_t run = row_slots_at + (static_cast<size_t>(blockIdx.x) + I) * B * r;
#pragma unroll
    for (int q = 0; q < RPT; ++q) {
      const int l = q * kNarrowThreads + threadIdx.x;
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        if (c < r) A::store(part, part_lo, run + static_cast<size_t>(l) * r + c, tot[q][c]);
        tot[q][c] = A::acc_zero();
      }
    }
    if (J == nb && !last) {
      J = ++I;
      sym_rows<S, A, RC>(xt, v, v_lo, n, r, I, a, vi, vil);
    }
  }
}

// The symmetric walk's second pass: out[j, c] = the row runs of j's tile J
// (chunks rows[J].x..rows[J].y, in order), then the column sums of the
// tiles (I, J), I = 0..J, in order; e = j r + c < n r.
template <class A>
__global__ void sym_matvec_reduce_kernel(const typename A::Real* __restrict__ part,
                                         const typename A::Real* __restrict__ part_lo,
                                         const int2* __restrict__ rows, typename A::Real* __restrict__ out,
                                         typename A::Real* __restrict__ out_lo, int n, int r, int tile, int nb,
                                         size_t row_slots_at) {
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<size_t>(n) * r) return;
  const int j = static_cast<int>(e / r), c = static_cast<int>(e % r), J = j / tile;
  const size_t at = static_cast<size_t>(j - J * tile) * r + c, stride = static_cast<size_t>(tile) * r;
  const int2 run = rows[J];
  typename A::Acc acc = A::load(part, part_lo, row_slots_at + (static_cast<size_t>(run.x) + J) * stride + at);
  for (int q = run.x + 1; q <= run.y; ++q) {
    A::combine(acc, A::load(part, part_lo, row_slots_at + (static_cast<size_t>(q) + J) * stride + at));
  }
  size_t p = J;  // the pair index of (0, J); of (I + 1, J): p + nb - I - 1
#pragma unroll 4
  for (int I = 0; I <= J; ++I) {
    A::combine(acc, A::load(part, part_lo, p * stride + at));
    p += nb - I - 1;
  }
  A::store(out, out_lo, e, acc);
}

// -- one block of rows, many columns: the multi-column route ------------------------

// Replaces, for r > 4 right-hand-side columns, the TPU bodies of K2
// (_matvec_body, linpde_gp_tpu/ops/pallas_gram.py:348) and of the banded
// multi-RHS matvec (_banded_matvec_body, :626): each evaluates a Gram tile
// once and multiplies it by the whole (tile, r) panel of V.  matmat_rows does
// the same per block of kMatmatRows rows and RW in {64, 128, 256} columns, so
// a pair is evaluated ceil(r / RW) times, once for r <= 256, where the narrow
// route (matvec_rows) would evaluate it once per 4 columns.
//
// What bounds it on the H100: per pair, the evaluation (ops/_cuda.py::
// pair_ops: ~23 FP32 instructions in plain, ~33 FP64 in f64, ~363 FP32 in
// ff) and RW multiply-adds of the product, which runs in float64 in every
// mode on the FP64 tensor cores (67 TFLOP/s, NVIDIA's H100 SXM data sheet).
// At 1e5 x 1e5 and r = 256 the product bounds plain and f64 (76 ms) and FP32
// issue of the evaluation bounds ff (104 ms); at r = 64 the evaluation
// bounds f64 (19 ms, FP64 pipe) and ff.  What the design does:
// - The product is mma.sync m16n8k4 f64 (DMMA; wgmma has no f64 type), not
//   a DFMA loop on the FP64 pipe at half that rate whose broadcast shared
//   loads took as many issue slots as its FMAs.  The accumulators stay f64 in
//   registers.  Ragged rows, columns and depth are zero-filled in shared
//   memory; the MMA is never predicated.  (m16n8k8 and k16, timed in an
//   earlier 8-warp layout, ran no faster and spilled.)
// - A block holds 64 rows x RW columns, twice the former 32-row tile, so it
//   streams V's panel for twice the rows: at r = 256 the launch reads
//   1e5 / 64 x 205 MB, mostly from L2.  At RW = 64 it has 8 warps (2 x 4, a
//   warp 32 x 16) and two blocks an SM; from RW = 128 up 16 warps (2 x 8, a
//   warp 32 x RW/8, 32 accumulators a thread at RW = 256) and one block.
//   16 warps took K2 at r = 256 from 236 to 182 ms (f64) on the H100 while
//   X1 was read per pair; with X1 staged, 8 warps match 16 there in plain
//   and f64 and are 9 % slower in ff (k2_probe.py --wide, PERF.md).
// - Each pair is evaluated once per block into shared memory as f64 (G =
//   hi + lo in ff), so the column warps share one evaluation.
// - G and V are double-buffered over depth tiles of 32: one __syncthreads
//   per tile, and each thread evaluates its pairs of tile t + 1 one at a
//   time, each beside a share of the MMA k-steps of tile t, so the FP32 /
//   FP64 pipe and the tensor pipe run together instead of in turns.  At 16
//   warps that loop stays rolled: one evaluation live at a time, no spills.
// - V's tiles arrive by cp.async (16 bytes a thread where r is even, 8
//   otherwise; one source base and stride a thread) into the free buffer
//   while the block works on the other.  V is a float64 panel in every
//   mode: the wrapper (ops/_cuda.py::wide_panel) forms v + v_lo (ff, exact
//   for an ff split) or widens v (plain) once per call, so staging converts
//   nothing.  The X1 coordinates of each tile arrive the same way, two
//   tiles ahead: read per pair from global memory they missed L1 (which
//   shared memory leaves at ~60 KB) and stalled the evaluation; staged,
//   K2 at r = 256 fell from 141 / 164 / 239 to 116 / 151 / 219 ms (plain
//   / f64 / ff) on the H100.
// - What holds it now (k2_probe.py --wide with its skip variants): at
//   r = 256 V's stream into shared memory alone takes ~55 ms, the product
//   and the stream ~108 ms (DMMA at ~70 % of its peak), the evaluation and
//   the stream 58 / 59 / 152 ms (plain / f64 / ff).  Sharing V's tiles
//   between the two blocks of a cluster (multicast bulk copies) and deeper
//   V rings (3-4 stages) were timed and ran no faster.
// - Both shared arrays are padded by 4 doubles a row, so each half-warp's
//   fragment loads (lane 4 g + t reads (k = t, m = g) of G, (k = t, n = g) of
//   V) fall on 16 distinct 8-byte banks.
// - The launch bounds (kMatmatThreads, kMatmatMinBlocks) cap registers at
//   128 a thread; the former copies held to two blocks an SM are gone.
// Deterministic: no atomics, each output's sum runs over the depth tiles in
// order and, inside a tile, in the MMA's fixed order.
constexpr int kMatmatRows = 64;   // output rows per block
constexpr int kMatmatDepth = 32;  // Gram columns (V rows) per depth tile
constexpr int kMatmatPad = 4;     // doubles of padding per shared row

// Threads per block at RW columns, warps in a 2 x (warps / 2) grid: 16
// warps from RW = 128 up (32 f64 accumulators a thread at RW = 256, 128
// registers a thread), else 8.
template <int RW>
constexpr int kMatmatThreads = RW >= 128 ? 512 : 256;
// Blocks per SM that the kernels' __launch_bounds__ hold registers to.
template <int RW>
constexpr int kMatmatMinBlocks = kMatmatThreads<RW> == 256 && RW == 64 ? 2 : 1;

// Two buffers each of V's (depth x RW) tile and G's (depth x rows) tile,
// three of the X1 coordinates of a tile (up to kMaxDims doubles a column).
template <int RW>
constexpr size_t matmat_smem_bytes() {
  return sizeof(double) * static_cast<size_t>(kMatmatDepth) *
         (2 * (RW + kMatmatRows + 2 * kMatmatPad) + 3 * kMaxDims);
}

// Dynamic shared memory above 48 KB must be allowed per kernel.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

// d += a b for a 16 x 4 tile a and a 4 x 8 tile b: mma.sync m16n8k4 f64
// (sm_90).  Lane 4 g + t holds a0 = a[g][t], a1 = a[g + 8][t], b0 = b[t][g]
// and d[i] = d[g + 8 (i / 2)][2 t + i % 2] (CUTLASS's
// SM90_16x8x4_F64F64F64F64_TN: SM80_16x4_Row, SM80_8x4_Row, SM80_16x8_Row).
__device__ __forceinline__ void dmma_16x8x4(double (&d)[4], double a0, double a1, double b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b0));
}

// Asynchronous copy of BYTES (4, 8 or 16) from global to shared memory; of
// the source only src_bytes are read, the rest is zero-filled.
template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
  } else if constexpr (BYTES == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
  } else {
    static_assert(BYTES == 4, "cp.async copies 4, 8 or 16 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
  }
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// Wait until at most N of this thread's newest copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start copying V's rows [j0, j0 + jn), columns [c0, c0 + RW) into sv
// ([kMatmatDepth][RW + kMatmatPad]), zeros for rows >= jn and columns >= r,
// in copies of E doubles (E = 2 where r is even and v 16-byte aligned, else
// 1).  A thread copies one column slot c in rows k0, k0 + step, ...: one
// source base and one stride, the same in every tile.
template <int RW, int E>
__device__ __forceinline__ void stage_v_rows(double* sv, const double* __restrict__ v, int r, int j0, int jn,
                                             int c0) {
  constexpr int THREADS = kMatmatThreads<RW>, PER_ROW = RW / E, STEP = THREADS / PER_ROW;
  constexpr int N = kMatmatDepth / STEP, LDV = RW + kMatmatPad;
  static_assert(THREADS % PER_ROW == 0 && kMatmatDepth % STEP == 0, "whole rows per pass");
  const int k0 = threadIdx.x / PER_ROW, c = E * (threadIdx.x % PER_ROW);
  const bool col_ok = c0 + c < r;
  const double* src = v + (static_cast<size_t>(j0) + k0) * r + c0 + c;
  double* dst = sv + k0 * LDV + c;
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const bool ok = col_ok && k0 + q * STEP < jn;
    cp_async<8 * E>(dst + q * STEP * LDV, ok ? src + static_cast<size_t>(q) * STEP * r : v, ok ? 8 * E : 0);
  }
  cp_async_commit();  // with the X1 coordinates started before it
}

template <int RW>
__device__ __forceinline__ void stage_v(double* sv, const double* __restrict__ v, int r, int j0, int jn, int c0,
                                        bool pairs) {
  if (pairs) {
    stage_v_rows<RW, 2>(sv, v, r, j0, jn, c0);
  } else {
    stage_v_rows<RW, 1>(sv, v, r, j0, jn, c0);
  }
}

// Start copying the X1 coordinates of columns [j0, j0 + jn) into sx
// ([nd][kMatmatDepth]), zeros past jn; the caller commits the group.
template <class S, class A>
__device__ __forceinline__ void stage_x(typename A::Real* sx, const typename A::Real* __restrict__ x1t, int n1,
                                        int j0, int jn) {
  using T = typename A::Real;
  const int k = threadIdx.x % kMatmatDepth, dd = threadIdx.x / kMatmatDepth;
  if (dd < S::nd) {
    const bool ok = k < jn;
    cp_async<sizeof(T)>(sx + dd * kMatmatDepth + k, ok ? x1t + static_cast<size_t>(dd) * n1 + j0 + k : x1t,
                        ok ? static_cast<int>(sizeof(T)) : 0);
  }
}

// G of this thread's row (coordinates a) and column k of a tile whose X1
// coordinates sx holds, as the f64 product operand.
template <class S, class A>
__device__ __forceinline__ double matmat_pair(const SpecValues& s, const typename A::Real* a,
                                              const typename A::Real* sx, int k) {
  typename A::Real b[S::nd];
#pragma unroll
  for (int dd = 0; dd < S::nd; ++dd) b[dd] = sx[dd * kMatmatDepth + k];
  return A::prod_of(eval_pair<S, A>(s, a, b));
}

// out[i, c0:c0+RW] = sum_{j in [j_begin, j_end)} k(x0_i, x1_j) v[j, c0:c0+RW]
// for the kMatmatRows rows from blockIdx.x * kMatmatRows, c0 = blockIdx.y * RW,
// launched with kMatmatThreads<RW> threads and matmat_smem_bytes<RW>() of
// dynamic shared memory; v is the (n1, r) float64 panel.  Every thread of
// the block must call this with the same column range.
template <class S, class A, int RW>
__device__ __forceinline__ void matmat_rows(const SpecValues& s, const typename A::Real* __restrict__ x0t,
                                            const typename A::Real* __restrict__ x1t, const double* __restrict__ v,
                                            typename A::Real* __restrict__ out, typename A::Real* __restrict__ out_lo,
                                            int n0, int n1, int r, int j_begin, int j_end) {
  using T = typename A::Real;
  constexpr int ND = S::nd, BM = kMatmatRows, BK = kMatmatDepth, KSTEPS = BK / 4;  // m16n8k4 k-steps a tile
  constexpr int THREADS = kMatmatThreads<RW>;
  constexpr int KQ = THREADS / BM;      // threads per row in the evaluation
  constexpr int PAIRS = BK / KQ;        // pairs a thread evaluates per depth tile
  constexpr int KPP = KSTEPS / PAIRS;   // MMA k-steps issued beside each pair
  // The pair loop: unrolled at 8 warps (at RW = 64, 5-10 % faster on the
  // H100), rolled at 16, where unrolled it spilled.
  constexpr int UNROLL = THREADS == 256 ? PAIRS : 1;
  constexpr int WN = THREADS / 64;      // warps along the columns
  constexpr int NT = RW / (8 * WN);     // 8-column MMA tiles of a warp
  constexpr int LDV = RW + kMatmatPad, LDG = BM + kMatmatPad;
  static_assert(BM == 64 && THREADS % BM == 0 && BK % KQ == 0 && BK % 4 == 0 && KSTEPS % PAIRS == 0 && NT >= 1 &&
                    NT * 8 * WN == RW,
                "the warp layout assumes these sizes");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* sV = reinterpret_cast<double*>(smem_raw);  // [2][BK][LDV]
  double* sG = sV + 2 * BK * LDV;                     // [2][BK][LDG]: rows fastest
  T* sX = reinterpret_cast<T*>(sG + 2 * BK * LDG);     // [3][ND][BK]: X1 coordinates, two tiles ahead of V
  static_assert(ND <= kMaxDims && ND * BK <= THREADS, "one coordinate a thread");

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BM, c0 = blockIdx.y * RW;
  const bool pairs = r % 2 == 0 && (reinterpret_cast<size_t>(v) & 15) == 0;

  // Evaluation: row erow of the block, columns kq + KQ q of each depth tile
  // (q < PAIRS, evaluated beside the MMA k-steps [q KPP, (q + 1) KPP)); kq
  // is uniform in a warp.
  const int erow = tid % BM, kq = tid / BM;
  T a[ND];
#pragma unroll
  for (int k = 0; k < ND; ++k) a[k] = row0 + erow < n0 ? x0t[static_cast<size_t>(k) * n0 + row0 + erow] : T(0);

  // Product: the warp's rows wm + [0, 32) as two 16-row MMA tiles, columns
  // wn + [0, RW / WN) as NT 8-column tiles.
  const int wm = (warp & 1) * 32, wn = (warp >> 1) * (RW / WN);
  double acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0;
    }
  }

  const int ntiles = j_end > j_begin ? (j_end - j_begin + BK - 1) / BK : 0;
  if (ntiles > 0) {  // tile 0: V's copy in flight; X1 of tiles 0 and 1 in, then G of tile 0
    const int jn = min(BK, j_end - j_begin);
    stage_x<S, A>(sX, x1t, n1, j_begin, jn);
    if (ntiles > 1) stage_x<S, A>(sX + ND * BK, x1t, n1, j_begin + BK, min(BK, j_end - j_begin - BK));
    cp_async_commit();
    stage_v<RW>(sV, v, r, j_begin, jn, c0, pairs);
    cp_async_wait<1>();
    __syncthreads();
#pragma unroll 1
    for (int q = 0; q < PAIRS; ++q) {
      const int k = kq + KQ * q;
      sG[k * LDG + erow] = k < jn ? matmat_pair<S, A>(s, a, sX, k) : 0.0;
    }
  }
  for (int it = 0; it < ntiles; ++it) {
    const int cur = it & 1, nxt = cur ^ 1;
    const int j1 = j_begin + (it + 1) * BK;
    const bool more = it + 1 < ntiles;
    const int jn1 = more ? min(BK, j_end - j1) : 0;
    cp_async_wait<0>();
    __syncthreads();  // tile it's V and G, and X1 of tile it + 1, are in place; tile it - 1's buffers are free
    if (it + 2 < ntiles) {
      const int j2 = j1 + BK;
      stage_x<S, A>(sX + ((it + 2) % 3) * ND * BK, x1t, n1, j2, min(BK, j_end - j2));
    }
    if (more) stage_v<RW>(sV + nxt * BK * LDV, v, r, j1, jn1, c0, pairs);
    const T* sx1 = sX + ((it + 1) % 3) * ND * BK;
    const double* gc = sG + cur * BK * LDG;
    const double* vc = sV + cur * BK * LDV;
    double* gn = sG + nxt * BK * LDG;
#pragma unroll(UNROLL)
    for (int q = 0; q < PAIRS; ++q) {
      // This thread's pair q of tile it + 1, issued beside KPP MMA k-steps of tile it.
      const int k1 = kq + KQ * q;
      const double gv = k1 < jn1 ? matmat_pair<S, A>(s, a, sx1, k1) : 0.0;
#pragma unroll
      for (int kk = 0; kk < KPP; ++kk) {
        const int kr = 4 * (q * KPP + kk) + t;  // this lane's depth row of the k-step
        double af[2][2];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          af[mt][0] = gc[kr * LDG + wm + 16 * mt + g];
          af[mt][1] = gc[kr * LDG + wm + 16 * mt + g + 8];
        }
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const double b0 = vc[kr * LDV + wn + 8 * nt + g];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) dmma_16x8x4(acc[mt][nt], af[mt][0], af[mt][1], b0);
        }
      }
      if (more) gn[k1 * LDG + erow] = gv;
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + wm + 16 * mt + g + 8 * (i >> 1);
      if (row >= n0) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int col = c0 + wn + 8 * nt + 2 * t + (i & 1);
        if (col < r) A::store_prod(out, out_lo, static_cast<size_t>(row) * r + col, acc[mt][nt][i]);
      }
    }
  }
}

}  // namespace lgt
