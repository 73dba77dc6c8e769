// Pair evaluation of collapsed sum-of-products specs and the two row walks
// of the Gram matvec (matvec_rows for r <= 4 right-hand-side columns,
// matmat_rows above), shared by the kernels of gram.cu (K1, K2) and banded.cu
// (the banded matvec).
//
// A spec is the collapsed groups of ops/gram.py::_collapse_terms: per pair
// and input dimension a difference d, per distinct (dim, kind, scale) a
// scaled distance t and one transcendental (matern: t = s|d|, exp(-t);
// expquad: t = s d, exp(-t^2); wendland: t = s|d|, cut off above 1), per
// group a nested Horner sweep over its coefficient tensor times the product
// of its dimensions' transcendentals, times sign(d) on its parity
// dimensions.  The plain versions are ops/gram.py::_eval_groups and
// _eval_groups_ff.  Every kernel is templated on the arithmetic policy:
// float, float-float pairs of floats (ff.cuh), double.
//
// The spec arrives by value as a __grid_constant__ table (kinds, scales,
// parities, per-dimension degrees, coefficients pre-split into f32 hi/lo on
// the host); the wrapper (ops/_cuda.py) raises on a spec beyond the caps.
#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "ff.cuh"

namespace lgt {

constexpr int kMaxDims = 4;
constexpr int kMaxFactors = 8;
constexpr int kMaxGroups = 8;
constexpr int kMaxCoeffs = 128;

enum Kind : int { kMatern = 0, kExpQuad = 1, kWendland = 2 };
enum Mode : int { kPlain = 0, kFF = 1, kF64 = 2 };

// Layout mirrored by ops/_cuda.py::GramSpec (ctypes).
struct GramSpec {
  int ndims, nfactors, ngroups, reserved;
  int fac_dim[kMaxFactors];
  int fac_kind[kMaxFactors];
  double fac_scale[kMaxFactors];
  float fac_scale_hi[kMaxFactors];
  float fac_scale_lo[kMaxFactors];
  int grp_fac[kMaxGroups][kMaxDims];
  int grp_parity[kMaxGroups][kMaxDims];
  int grp_deg[kMaxGroups][kMaxDims];
  int grp_off[kMaxGroups];
  double coef[kMaxCoeffs];
  float coef_hi[kMaxCoeffs];
  float coef_lo[kMaxCoeffs];
};

__device__ __forceinline__ float exp_of(float x) { return expf(x); }
__device__ __forceinline__ double exp_of(double x) { return exp(x); }

// -- arithmetic policies -------------------------------------------------------

// The plain body in T (float: "plain" mode, double: "f64" mode).
template <typename T>
struct PlainArith {
  using Real = T;
  using Val = T;
  using Part = T;  // per-column-tile partial sum of a matvec
  using Acc = T;   // running sum over column tiles

  static __device__ __forceinline__ T scale_of(const GramSpec& s, int f) {
    if constexpr (sizeof(T) == 4) {
      return s.fac_scale_hi[f];
    } else {
      return s.fac_scale[f];
    }
  }
  static __device__ __forceinline__ T coef(const GramSpec& s, int k) {
    if constexpr (sizeof(T) == 4) {
      return s.coef_hi[k];
    } else {
      return s.coef[k];
    }
  }
  static __device__ __forceinline__ Val diff(T a, T b) { return a - b; }
  static __device__ __forceinline__ void factor(const GramSpec& s, int f, Val d, Val& t, Val& e) {
    const int kind = s.fac_kind[f];
    if (kind == kExpQuad) {
      t = scale_of(s, f) * d;
      e = exp_of(-(t * t));
    } else {
      t = scale_of(s, f) * (d < T(0) ? -d : d);
      e = kind == kMatern ? exp_of(-t) : (t <= T(1) ? T(1) : T(0));
    }
  }
  static __device__ __forceinline__ Val zero() { return T(0); }
  static __device__ __forceinline__ Val cval(const GramSpec& s, int k) { return coef(s, k); }
  static __device__ __forceinline__ Val horner_const(Val acc, Val t, const GramSpec& s, int k) {
    return acc * t + coef(s, k);
  }
  static __device__ __forceinline__ Val horner(Val acc, Val t, Val sub) { return acc * t + sub; }
  static __device__ __forceinline__ Val mul(Val a, Val b) { return a * b; }
  static __device__ __forceinline__ Val add(Val a, Val b) { return a + b; }
  static __device__ __forceinline__ T sign(Val d) { return T((d > T(0)) - (d < T(0))); }
  static __device__ __forceinline__ Val times_sign(Val v, T sg) { return v * sg; }
  static __device__ __forceinline__ T value(Val v) { return v; }

  static __device__ __forceinline__ void part_zero(Part& p) { p = T(0); }
  static __device__ __forceinline__ void accumulate(Part& p, Val g, T v, T /*v_lo*/) { p += g * v; }
  static __device__ __forceinline__ void acc_zero(Acc& a) { a = T(0); }
  static __device__ __forceinline__ void combine(Acc& a, const Part& p) { a += p; }
  static __device__ __forceinline__ T finish(const Acc& a) { return a; }

  // The multi-column route (matmat_rows) multiplies staged Gram tiles in T.
  using Prod = T;
  static __device__ __forceinline__ Prod prod_of(Val g) { return g; }
  static __device__ __forceinline__ Prod prod_rhs(T v, T /*v_lo*/) { return v; }
};

// The float-float body ("ff" mode, the JAX package's compensated=True).
struct FFArith {
  using Real = float;
  using Val = ff32;
  using Part = ff32;
  using Acc = ff32;

  static __device__ __forceinline__ Val diff(float a, float b) { return two_diff(a, b); }
  static __device__ __forceinline__ void factor(const GramSpec& s, int f, Val d, Val& t, Val& e) {
    const Val z = ff_scale(d, s.fac_scale_hi[f], s.fac_scale_lo[f]);
    const int kind = s.fac_kind[f];
    if (kind == kExpQuad) {
      t = z;
      e = ff_exp(ff_neg(ff_sqr(z)));
    } else {
      t = ff_abs(z);
      if (kind == kMatern) {
        e = ff_exp(ff_neg(t));
      } else {  // Wendland cut-off reads both planes
        const bool inside = (t.hi < 1.0f) || (t.hi == 1.0f && t.lo <= 0.0f);
        e = {inside ? 1.0f : 0.0f, 0.0f};
      }
    }
  }
  static __device__ __forceinline__ Val zero() { return {0.0f, 0.0f}; }
  static __device__ __forceinline__ Val cval(const GramSpec& s, int k) { return {s.coef_hi[k], s.coef_lo[k]}; }
  static __device__ __forceinline__ Val horner_const(Val acc, Val t, const GramSpec& s, int k) {
    return ff_add_const(ff_mul(acc, t), s.coef_hi[k], s.coef_lo[k]);
  }
  static __device__ __forceinline__ Val horner(Val acc, Val t, Val sub) { return ff_add(ff_mul(acc, t), sub); }
  static __device__ __forceinline__ Val mul(Val a, Val b) { return ff_mul(a, b); }
  static __device__ __forceinline__ Val add(Val a, Val b) { return ff_add(a, b); }
  // sign of the hi plane of the difference, with sign(0) = 0
  static __device__ __forceinline__ float sign(Val d) { return float((d.hi > 0.0f) - (d.hi < 0.0f)); }
  static __device__ __forceinline__ Val times_sign(Val v, float sg) { return {__fmul_rn(v.hi, sg), __fmul_rn(v.lo, sg)}; }
  static __device__ __forceinline__ float value(Val v) { return __fadd_rn(v.hi, v.lo); }

  // The product g * (v + v_lo) and the running sum are carried in ff
  // (~12 flops a pair against ~800 for g): the sums cancel by up to ~5e7
  // at N = 1e5 (sum |k w| / |sum k w|), and an f32 product-sum, as the
  // TPU's dot did, left the CG operator too coarse to converge there.
  static __device__ __forceinline__ void part_zero(Part& p) { p = {0.0f, 0.0f}; }
  static __device__ __forceinline__ void accumulate(Part& p, Val g, float v, float v_lo) {
    p = ff_add(p, ff_mul(g, ff32{v, v_lo}));
  }
  static __device__ __forceinline__ void acc_zero(Acc& a) { a = {0.0f, 0.0f}; }
  static __device__ __forceinline__ void combine(Acc& a, const Part& p) { a = ff_add(a, p); }
  static __device__ __forceinline__ float finish(const Acc& a) { return __fadd_rn(a.hi, a.lo); }

  // The multi-column route forms the product and the sum in float64 from
  // hi + lo and v + v_lo (exact to ~eps64): 2 FP64 flops a pair and column
  // against ~20 FP32 flops in ff, and the output is the f64 product rounded.
  using Prod = double;
  static __device__ __forceinline__ Prod prod_of(Val g) { return static_cast<double>(g.hi) + g.lo; }
  static __device__ __forceinline__ Prod prod_rhs(float v, float v_lo) { return static_cast<double>(v) + v_lo; }
};

// -- pair evaluation -------------------------------------------------------------

// Nested Horner over axis AX of a group's C-order coefficient tensor.
template <class A, int AX, int ND>
struct Horner {
  using Val = typename A::Val;
  static __device__ __forceinline__ Val eval(const GramSpec& s, int off, const int* deg, const Val* ts) {
    const int n = deg[AX];
    if constexpr (AX == ND - 1) {
      Val acc = A::cval(s, off + n - 1);
      for (int k = n - 2; k >= 0; --k) acc = A::horner_const(acc, ts[AX], s, off + k);
      return acc;
    } else {
      int stride = 1;
#pragma unroll
      for (int j = AX + 1; j < ND; ++j) stride *= deg[j];
      Val acc = Horner<A, AX + 1, ND>::eval(s, off + (n - 1) * stride, deg, ts);
      for (int k = n - 2; k >= 0; --k) {
        acc = A::horner(acc, ts[AX], Horner<A, AX + 1, ND>::eval(s, off + k * stride, deg, ts));
      }
      return acc;
    }
  }
};

// k(a, b) for one pair of points (coordinates a[ND], b[ND]).  Factor
// values are computed once per distinct (dim, kind, scale) and picked by
// unrolled selects, so they stay in registers.
template <class A, int ND>
__device__ __forceinline__ typename A::Val eval_pair(const GramSpec& s, const typename A::Real* a,
                                                     const typename A::Real* b) {
  using Val = typename A::Val;
  Val d[ND];
#pragma unroll
  for (int i = 0; i < ND; ++i) d[i] = A::diff(a[i], b[i]);

  Val t[kMaxFactors], e[kMaxFactors];
#pragma unroll
  for (int f = 0; f < kMaxFactors; ++f) {
    t[f] = A::zero();
    e[f] = A::zero();
    if (f < s.nfactors) {
      Val df = d[0];
#pragma unroll
      for (int i = 1; i < ND; ++i) {
        if (s.fac_dim[f] == i) df = d[i];
      }
      A::factor(s, f, df, t[f], e[f]);
    }
  }

  Val acc = A::zero();
  for (int g = 0; g < s.ngroups; ++g) {
    Val ts[ND];
    Val env = A::zero();
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      const int fi = s.grp_fac[g][i];
      Val tf = t[0], ef = e[0];
#pragma unroll
      for (int f = 1; f < kMaxFactors; ++f) {
        if (fi == f) {
          tf = t[f];
          ef = e[f];
        }
      }
      ts[i] = tf;
      env = i == 0 ? ef : A::mul(env, ef);
    }
    Val val = A::mul(Horner<A, 0, ND>::eval(s, s.grp_off[g], s.grp_deg[g], ts), env);
#pragma unroll
    for (int i = 0; i < ND; ++i) {
      if (s.grp_parity[g][i]) val = A::times_sign(val, A::sign(d[i]));
    }
    acc = g == 0 ? val : A::add(acc, val);
  }
  return acc;
}

// -- one block of matvec rows --------------------------------------------------------

// out[i, c0:c0+RC] = sum_{j in [j_begin, j_end)} k(x0_i, x1_j) v[j, c0:c0+RC]
// for the row i = blockIdx.x * blockDim.x + threadIdx.x, c0 = blockIdx.y * RC.
// The block walks the column range in tiles of width blockDim.x, staging
// each tile's X1 coordinates and V rows (and the lo plane of an ff right-hand
// side, v_lo, which may be null) in shared memory: sizeof(T) * blockDim.x *
// (ND + 2 RC) bytes of dynamic shared memory.  The sum stays in registers
// (no atomics: results are deterministic); ragged edges are masked.
// Points arrive transposed, (ND, n), so neighbouring threads read
// neighbouring addresses.  Every thread of the block must call this with
// the same column range (it synchronizes the block).
template <class A, int ND, int RC>
__device__ __forceinline__ void matvec_rows(const GramSpec& s, const typename A::Real* __restrict__ x0t,
                                            const typename A::Real* __restrict__ x1t,
                                            const typename A::Real* __restrict__ v,
                                            const typename A::Real* __restrict__ v_lo,
                                            typename A::Real* __restrict__ out, int n0, int n1, int r, int j_begin,
                                            int j_end) {
  using T = typename A::Real;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile = blockDim.x;
  T* sx = reinterpret_cast<T*>(smem_raw);  // [ND][tile]
  T* sv = sx + ND * tile;                  // [tile][RC]
  T* svl = sv + tile * RC;                 // [tile][RC], lo plane

  const int i = blockIdx.x * tile + threadIdx.x;
  const int c0 = blockIdx.y * RC;
  const bool row_ok = i < n0;
  T a[ND];
#pragma unroll
  for (int k = 0; k < ND; ++k) a[k] = row_ok ? x0t[static_cast<size_t>(k) * n0 + i] : T(0);

  typename A::Acc tot[RC];
#pragma unroll
  for (int c = 0; c < RC; ++c) A::acc_zero(tot[c]);

  for (int j0 = j_begin; j0 < j_end; j0 += tile) {
    const int jn = min(tile, j_end - j0);
    __syncthreads();  // the previous tile is consumed
    const int k = threadIdx.x;
    if (k < jn) {
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) sx[dd * tile + k] = x1t[static_cast<size_t>(dd) * n1 + j0 + k];
#pragma unroll
      for (int c = 0; c < RC; ++c) {
        const size_t at = static_cast<size_t>(j0 + k) * r + c0 + c;
        sv[k * RC + c] = c0 + c < r ? v[at] : T(0);
        svl[k * RC + c] = c0 + c < r && v_lo != nullptr ? v_lo[at] : T(0);
      }
    }
    __syncthreads();

    typename A::Part part[RC];
#pragma unroll
    for (int c = 0; c < RC; ++c) A::part_zero(part[c]);
    for (int kk = 0; kk < jn; ++kk) {
      T b[ND];
#pragma unroll
      for (int dd = 0; dd < ND; ++dd) b[dd] = sx[dd * tile + kk];
      const typename A::Val g = eval_pair<A, ND>(s, a, b);
#pragma unroll
      for (int c = 0; c < RC; ++c) A::accumulate(part[c], g, sv[kk * RC + c], svl[kk * RC + c]);
    }
#pragma unroll
    for (int c = 0; c < RC; ++c) A::combine(tot[c], part[c]);
  }
  if (row_ok) {
#pragma unroll
    for (int c = 0; c < RC; ++c) {
      if (c0 + c < r) out[static_cast<size_t>(i) * r + c0 + c] = A::finish(tot[c]);
    }
  }
}

template <class A, int ND, int RC>
constexpr size_t matvec_smem_bytes(int tile) {
  return sizeof(typename A::Real) * static_cast<size_t>(tile) * (ND + 2 * RC);
}

// -- one block of rows, many columns: the multi-column route ------------------------

// matvec_rows evaluates every pair once per RC <= 4 right-hand-side columns,
// so at r = 256 it evaluates each pair 64 times.  The TPU bodies
// (pallas_gram.py:348-389, :626-660) evaluate each Gram tile once and
// multiply it by the whole (tile, r) panel; matmat_rows does the same per
// block of RW in {64, 128, 256} columns, so a pair is evaluated ceil(r / RW)
// times, once for r <= 256.
//
// What bounds it on the H100: at RW = 256 the product is 512 flops a pair
// (in FP64 for modes f64 and ff, FP32 for plain) against ~60 (f64) to ~800
// (ff, FP32) for the evaluation, so FP64 FMA throughput, not the evaluation.
constexpr int kMatmatThreads = 256;  // 8 warps
constexpr int kMatmatRows = 32;      // output rows per block
constexpr int kMatmatDepth = 32;     // Gram columns (V rows) per tile

__device__ __forceinline__ float fma_of(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_of(double a, double b, double c) { return __fma_rn(a, b, c); }

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
template <class A, int ND, int RW>
__device__ __forceinline__ void matmat_rows(const GramSpec& s, const typename A::Real* __restrict__ x0t,
                                            const typename A::Real* __restrict__ x1t,
                                            const typename A::Real* __restrict__ v,
                                            const typename A::Real* __restrict__ v_lo,
                                            typename A::Real* __restrict__ out, int n0, int n1, int r, int j_begin,
                                            int j_end) {
  using T = typename A::Real;
  using P = typename A::Prod;
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
        g = A::prod_of(eval_pair<A, ND>(s, a, b));
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
      if (col < r) out[static_cast<size_t>(row) * r + col] = static_cast<T>(acc[i][j]);
    }
  }
}

}  // namespace lgt
