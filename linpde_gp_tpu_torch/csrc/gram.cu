// Hand-written Hopper (sm_90a) kernels for sum-of-products kernel Grams.
//
// K1 gram_kernel replaces the TPU kernel _build_pallas_gram / body
// _tile_kernel_body (linpde_gp_tpu/ops/pallas_gram.py:277, :250): the dense
// Gram K(X0, X1) of a collapsed spec.
// K2 gram_matvec_kernel replaces _build_pallas_gram_matvec / body
// _matvec_body (pallas_gram.py:393, :348): K(X0, X1) @ V without storing K.
//
// Both evaluate the collapsed groups of ops/gram.py::_collapse_terms: per
// pair and input dimension a difference d, per distinct (dim, kind, scale)
// a scaled distance t and one transcendental (matern: t = s|d|, exp(-t);
// expquad: t = s d, exp(-t^2); wendland: t = s|d|, cut off above 1), per
// group a nested Horner sweep over its coefficient tensor times the product
// of its dimensions' transcendentals, times sign(d) on its parity
// dimensions.  The plain versions are ops/gram.py::_eval_groups and
// _eval_groups_ff.  Each kernel is one source templated on the arithmetic:
// float, float-float pairs of floats (ff.cuh), double.  The ff K2 takes an
// ff right-hand side (hi and lo planes) and carries each product and the
// row sum in ff.
//
// What bounds them on the H100: arithmetic.  K2 reads O(n0 + n1 r) bytes and
// evaluates n0 n1 pairs: ~60 flops each in the plain bodies, ~800 in the ff
// body (two ff_exp of ~25 ff operations each dominate), so at N = 1e5 it is
// compute-bound by a factor of thousands over bandwidth.  K1 writes n0 n1
// values, 4 or 8 bytes against ~60-800 flops per entry: compute-bound in ff,
// near balance in the plain bodies.  This first version is simple: K1 runs
// one thread per output entry; K2 one thread per output row, each block
// walking every column tile itself with the tile's coordinates and V staged
// in shared memory and the sum kept in registers (no split-K, no atomics:
// results are deterministic).  Ragged edges are masked, nothing is padded.
//
// The spec arrives by value as a __grid_constant__ table (kinds, scales,
// parities, per-dimension degrees, coefficients pre-split into f32 hi/lo on
// the host); the wrapper (ops/_cuda.py) raises on a spec beyond the caps.

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
  using Part = T;  // per-column-tile partial sum of K2
  using Acc = T;   // K2 running sum over column tiles

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

// -- K1: dense Gram ----------------------------------------------------------------

// Points arrive transposed, (ND, n), so neighbouring threads read
// neighbouring addresses.  Thread x runs along columns: coalesced stores.
template <class A, int ND>
__global__ void gram_kernel(const __grid_constant__ GramSpec s, const typename A::Real* __restrict__ x0t,
                            const typename A::Real* __restrict__ x1t, typename A::Real* __restrict__ out, int n0,
                            int n1) {
  using T = typename A::Real;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= n0 || j >= n1) return;
  T a[ND], b[ND];
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    a[k] = x0t[static_cast<size_t>(k) * n0 + i];
    b[k] = x1t[static_cast<size_t>(k) * n1 + j];
  }
  out[static_cast<size_t>(i) * n1 + j] = A::value(eval_pair<A, ND>(s, a, b));
}

// -- K2: gram-free matvec ---------------------------------------------------------

// One thread per output row, blockDim.x rows per block; the block walks
// every column tile of width blockDim.x itself, staging the tile's X1
// coordinates and its V rows (RC right-hand-side columns, from column
// blockIdx.y * RC) in shared memory.  ``v_lo`` (ff body only, may be
// null) is the lo plane of an ff right-hand side.
template <class A, int ND, int RC>
__global__ void gram_matvec_kernel(const __grid_constant__ GramSpec s, const typename A::Real* __restrict__ x0t,
                                   const typename A::Real* __restrict__ x1t, const typename A::Real* __restrict__ v,
                                   const typename A::Real* __restrict__ v_lo, typename A::Real* __restrict__ out,
                                   int n0, int n1, int r) {
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

  for (int j0 = 0; j0 < n1; j0 += tile) {
    const int jn = min(tile, n1 - j0);
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

// -- launch ------------------------------------------------------------------------

template <class A, int ND>
cudaError_t launch_gram(const GramSpec& s, const void* x0t, const void* x1t, void* out, int n0, int n1, int tile,
                        cudaStream_t stream) {
  using T = typename A::Real;
  const dim3 block(tile, tile);
  const dim3 grid((n1 + tile - 1) / tile, (n0 + tile - 1) / tile);
  gram_kernel<A, ND><<<grid, block, 0, stream>>>(s, static_cast<const T*>(x0t), static_cast<const T*>(x1t),
                                                  static_cast<T*>(out), n0, n1);
  return cudaGetLastError();
}

template <class A, int ND, int RC>
void launch_gram_matvec_rc(const GramSpec& s, const void* x0t, const void* x1t, const void* v, const void* v_lo,
                           void* out, int n0, int n1, int r, int tile, cudaStream_t stream) {
  using T = typename A::Real;
  const size_t smem = sizeof(T) * tile * (ND + 2 * RC);
  const dim3 grid((n0 + tile - 1) / tile, (r + RC - 1) / RC);
  gram_matvec_kernel<A, ND, RC><<<grid, dim3(tile), smem, stream>>>(
      s, static_cast<const T*>(x0t), static_cast<const T*>(x1t), static_cast<const T*>(v),
      static_cast<const T*>(v_lo), static_cast<T*>(out), n0, n1, r);
}

template <class A, int ND>
cudaError_t launch_gram_matvec(const GramSpec& s, const void* x0t, const void* x1t, const void* v, const void* v_lo,
                               void* out, int n0, int n1, int r, int tile, cudaStream_t stream) {
  if (r == 1) {
    launch_gram_matvec_rc<A, ND, 1>(s, x0t, x1t, v, v_lo, out, n0, n1, r, tile, stream);
  } else if (r == 2) {
    launch_gram_matvec_rc<A, ND, 2>(s, x0t, x1t, v, v_lo, out, n0, n1, r, tile, stream);
  } else {
    launch_gram_matvec_rc<A, ND, 4>(s, x0t, x1t, v, v_lo, out, n0, n1, r, tile, stream);
  }
  return cudaGetLastError();
}

template <class A>
cudaError_t dispatch_gram(const GramSpec& s, const void* x0t, const void* x1t, void* out, int n0, int n1, int tile,
                          cudaStream_t st) {
  switch (s.ndims) {
    case 1: return launch_gram<A, 1>(s, x0t, x1t, out, n0, n1, tile, st);
    case 2: return launch_gram<A, 2>(s, x0t, x1t, out, n0, n1, tile, st);
    case 3: return launch_gram<A, 3>(s, x0t, x1t, out, n0, n1, tile, st);
    case 4: return launch_gram<A, 4>(s, x0t, x1t, out, n0, n1, tile, st);
    default: return cudaErrorInvalidValue;
  }
}

template <class A>
cudaError_t dispatch_gram_matvec(const GramSpec& s, const void* x0t, const void* x1t, const void* v, const void* v_lo,
                                 void* out, int n0, int n1, int r, int tile, cudaStream_t st) {
  switch (s.ndims) {
    case 1: return launch_gram_matvec<A, 1>(s, x0t, x1t, v, v_lo, out, n0, n1, r, tile, st);
    case 2: return launch_gram_matvec<A, 2>(s, x0t, x1t, v, v_lo, out, n0, n1, r, tile, st);
    case 3: return launch_gram_matvec<A, 3>(s, x0t, x1t, v, v_lo, out, n0, n1, r, tile, st);
    case 4: return launch_gram_matvec<A, 4>(s, x0t, x1t, v, v_lo, out, n0, n1, r, tile, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace lgt

// -- C interface (loaded with ctypes by ops/_cuda.py) --------------------------------

extern "C" {

int lgt_gram(const lgt::GramSpec* spec, int mode, const void* x0t, const void* x1t, void* out, int n0, int n1,
             int tile, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case lgt::kPlain: return lgt::dispatch_gram<lgt::PlainArith<float>>(*spec, x0t, x1t, out, n0, n1, tile, st);
    case lgt::kFF: return lgt::dispatch_gram<lgt::FFArith>(*spec, x0t, x1t, out, n0, n1, tile, st);
    case lgt::kF64: return lgt::dispatch_gram<lgt::PlainArith<double>>(*spec, x0t, x1t, out, n0, n1, tile, st);
    default: return cudaErrorInvalidValue;
  }
}

// v_lo: lo plane of an ff right-hand side (mode kFF only; may be null).
int lgt_gram_matvec(const lgt::GramSpec* spec, int mode, const void* x0t, const void* x1t, const void* v,
                    const void* v_lo, void* out, int n0, int n1, int r, int tile, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (v_lo != nullptr && mode != lgt::kFF) return cudaErrorInvalidValue;
  switch (mode) {
    case lgt::kPlain:
      return lgt::dispatch_gram_matvec<lgt::PlainArith<float>>(*spec, x0t, x1t, v, v_lo, out, n0, n1, r, tile, st);
    case lgt::kFF:
      return lgt::dispatch_gram_matvec<lgt::FFArith>(*spec, x0t, x1t, v, v_lo, out, n0, n1, r, tile, st);
    case lgt::kF64:
      return lgt::dispatch_gram_matvec<lgt::PlainArith<double>>(*spec, x0t, x1t, v, v_lo, out, n0, n1, r, tile, st);
    default: return cudaErrorInvalidValue;
  }
}

const char* lgt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int lgt_spec_size() { return static_cast<int>(sizeof(lgt::GramSpec)); }

}  // extern "C"
