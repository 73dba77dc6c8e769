// Hand-written Hopper (sm_90a) kernels for sum-of-products kernel Grams.
//
// K1 gram_kernel replaces the TPU kernel _build_pallas_gram / body
// _tile_kernel_body (linpde_gp_tpu/ops/pallas_gram.py:277, :250): the dense
// Gram K(X0, X1) of a collapsed spec.
// K2 gram_matvec_kernel replaces _build_pallas_gram_matvec / body
// _matvec_body (pallas_gram.py:393, :348): K(X0, X1) @ V without storing K.
//
// Both evaluate pairs through gram_eval.cuh (shared with banded.cu).  K2
// has two routes.  For r <= 4 right-hand-side columns, gram_matvec_kernel
// (gram_eval.cuh::matvec_rows) gives each thread one output row; its ff body
// takes an ff right-hand side (hi and lo planes) and carries each product and
// the row sum in ff.  For r > 4, gram_matmat_kernel (gram_eval.cuh::
// matmat_rows) evaluates each pair once per block of RW >= 64 columns into
// shared memory and multiplies the tile by V's panel there, as the TPU body
// does; its ff product and sum are float64 from hi + lo and v + v_lo.
//
// What bounds them on the H100: arithmetic.  K2 reads O(n0 + n1 r) bytes and
// evaluates n0 n1 pairs: ~60 flops each in the plain bodies, ~800 in the ff
// body (two ff_exp of ~25 ff operations each dominate), so at N = 1e5 it is
// compute-bound by a factor of thousands over bandwidth.  At r = 256 the
// multi-column route adds 512 product flops a pair: FP64 FMA throughput
// bounds it (gram_eval.cuh).  K1 writes n0 n1 values, 4 or 8 bytes against
// ~60-800 flops per entry: compute-bound in ff, near balance in the plain
// bodies.  This first version is simple: K1 runs one thread per output
// entry; each K2 block walks every column tile itself.

#include "gram_eval.cuh"

namespace lgt {

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

// One thread per output row, blockDim.x rows per block, every block walking
// all n1 columns; RC right-hand-side columns from blockIdx.y * RC.
template <class A, int ND, int RC>
__global__ void gram_matvec_kernel(const __grid_constant__ GramSpec s, const typename A::Real* __restrict__ x0t,
                                   const typename A::Real* __restrict__ x1t, const typename A::Real* __restrict__ v,
                                   const typename A::Real* __restrict__ v_lo, typename A::Real* __restrict__ out,
                                   int n0, int n1, int r) {
  matvec_rows<A, ND, RC>(s, x0t, x1t, v, v_lo, out, n0, n1, r, 0, n1);
}

// The multi-column route: kMatmatRows rows per block, RW columns from
// blockIdx.y * RW.
template <class A, int ND, int RW>
__global__ void __launch_bounds__(kMatmatThreads)
    gram_matmat_kernel(const __grid_constant__ GramSpec s, const typename A::Real* __restrict__ x0t,
                       const typename A::Real* __restrict__ x1t, const typename A::Real* __restrict__ v,
                       const typename A::Real* __restrict__ v_lo, typename A::Real* __restrict__ out, int n0, int n1,
                       int r) {
  matmat_rows<A, ND, RW>(s, x0t, x1t, v, v_lo, out, n0, n1, r, 0, n1);
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
  const size_t smem = matvec_smem_bytes<A, ND, RC>(tile);
  const dim3 grid((n0 + tile - 1) / tile, (r + RC - 1) / RC);
  gram_matvec_kernel<A, ND, RC><<<grid, dim3(tile), smem, stream>>>(
      s, static_cast<const T*>(x0t), static_cast<const T*>(x1t), static_cast<const T*>(v),
      static_cast<const T*>(v_lo), static_cast<T*>(out), n0, n1, r);
}

template <class A, int ND, int RW>
cudaError_t launch_gram_matmat_rw(const GramSpec& s, const void* x0t, const void* x1t, const void* v,
                                  const void* v_lo, void* out, int n0, int n1, int r, cudaStream_t stream) {
  using T = typename A::Real;
  const size_t smem = matmat_smem_bytes<A, ND, RW>();
  const cudaError_t err = allow_smem(gram_matmat_kernel<A, ND, RW>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n0 + kMatmatRows - 1) / kMatmatRows, (r + RW - 1) / RW);
  gram_matmat_kernel<A, ND, RW><<<grid, kMatmatThreads, smem, stream>>>(
      s, static_cast<const T*>(x0t), static_cast<const T*>(x1t), static_cast<const T*>(v),
      static_cast<const T*>(v_lo), static_cast<T*>(out), n0, n1, r);
  return cudaGetLastError();
}

// wide = 0: one row per thread, RC the narrowest of 1, 2, 4 that holds r (r > 4
// in ceil(r / 4) column groups); wide = 1: the multi-column route, RW the
// narrowest of 64, 128, 256 that holds r (256 above it).  The caller
// (ops/_cuda.py) picks the route and counts its launch.
template <class A, int ND>
cudaError_t launch_gram_matvec(const GramSpec& s, const void* x0t, const void* x1t, const void* v, const void* v_lo,
                               void* out, int n0, int n1, int r, int tile, int wide, cudaStream_t stream) {
  if (wide) {
    if (r <= 64) return launch_gram_matmat_rw<A, ND, 64>(s, x0t, x1t, v, v_lo, out, n0, n1, r, stream);
    if (r <= 128) return launch_gram_matmat_rw<A, ND, 128>(s, x0t, x1t, v, v_lo, out, n0, n1, r, stream);
    return launch_gram_matmat_rw<A, ND, 256>(s, x0t, x1t, v, v_lo, out, n0, n1, r, stream);
  }
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
                                 void* out, int n0, int n1, int r, int tile, int wide, cudaStream_t st) {
  switch (s.ndims) {
    case 1: return launch_gram_matvec<A, 1>(s, x0t, x1t, v, v_lo, out, n0, n1, r, tile, wide, st);
    case 2: return launch_gram_matvec<A, 2>(s, x0t, x1t, v, v_lo, out, n0, n1, r, tile, wide, st);
    case 3: return launch_gram_matvec<A, 3>(s, x0t, x1t, v, v_lo, out, n0, n1, r, tile, wide, st);
    case 4: return launch_gram_matvec<A, 4>(s, x0t, x1t, v, v_lo, out, n0, n1, r, tile, wide, st);
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
// wide != 0 takes the multi-column route (tile is not read there).
int lgt_gram_matvec(const lgt::GramSpec* spec, int mode, const void* x0t, const void* x1t, const void* v,
                    const void* v_lo, void* out, int n0, int n1, int r, int tile, int wide, void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (v_lo != nullptr && mode != lgt::kFF) return cudaErrorInvalidValue;
  switch (mode) {
    case lgt::kPlain:
      return lgt::dispatch_gram_matvec<lgt::PlainArith<float>>(*spec, x0t, x1t, v, v_lo, out, n0, n1, r, tile, wide,
                                                               st);
    case lgt::kFF:
      return lgt::dispatch_gram_matvec<lgt::FFArith>(*spec, x0t, x1t, v, v_lo, out, n0, n1, r, tile, wide, st);
    case lgt::kF64:
      return lgt::dispatch_gram_matvec<lgt::PlainArith<double>>(*spec, x0t, x1t, v, v_lo, out, n0, n1, r, tile, wide,
                                                                st);
    default: return cudaErrorInvalidValue;
  }
}

const char* lgt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int lgt_spec_size() { return static_cast<int>(sizeof(lgt::GramSpec)); }

}  // extern "C"
