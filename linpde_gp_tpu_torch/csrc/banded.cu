// Hand-written Hopper (sm_90a) banded Gram matvec for compactly supported
// (Wendland) kernels.
//
// banded_matvec_kernel replaces both TPU kernels of make_banded_matvec in
// linpde_gp_tpu/ops/pallas_gram.py: _build_banded_matvec (:664, body
// _banded_matvec_body :626, the multi-RHS route) and
// _build_banded_panel_matvec (:728, body _banded_panel_body :688, the r = 1
// route).  It computes K(X0, X1) @ V, V of shape (n1, r), for a kernel that
// is exactly zero beyond a radius along input dimension 0.
//
// The host (ops/banded.py) sorts both point sets by dimension 0 and gives
// every block of blockDim.x sorted rows its own column window [lo, hi) in
// sorted columns: all columns within the radius of the block's rows,
// widened by a few ulps so that no pair the f32 bodies evaluate as inside
// is left out.  The TPU needed one uniform band width and a clamped window
// start to keep its grid static; here each block walks only its own window,
// with K2's row-block walk (gram_eval.cuh::matvec_rows): tiles of the
// window's X1 coordinates and V rows staged in shared memory, one thread per
// row, the sum in registers, no atomics.  In ff mode the product and the row
// sum are carried in ff with an ff right-hand side (v, v_lo); the TPU bodies
// summed hi*v and lo*v in f32, which cancels by up to ~5e7 at N = 1e5.
// That walk serves r <= 4.  For r > 4, banded_matmat_kernel walks the same
// window with K2's multi-column route (gram_eval.cuh::matmat_rows): each
// pair once per block of RW >= 64 columns, the product in shared memory.
// Its blocks hold kMatmatRows rows and read the window of the tile-row
// block that contains them (tile is a multiple of kMatmatRows).
//
// What bounds it on the H100: arithmetic, as K2, over band_fraction * n0 * n1
// pairs instead of n0 * n1 (~11.7 % at N = 1e5 and radius 0.05 on [0, 1]).
// Blocks whose windows are narrow finish early; at N = 1e5 the 782 blocks of
// 128 rows keep all 132 SMs busy.

#include "gram_eval.cuh"

namespace lgt {

// win[2 b], win[2 b + 1]: the column window [lo, hi) of row block b.
template <class A, int ND, int RC>
__global__ void banded_matvec_kernel(const __grid_constant__ GramSpec s, const typename A::Real* __restrict__ x0t,
                                     const typename A::Real* __restrict__ x1t,
                                     const typename A::Real* __restrict__ v,
                                     const typename A::Real* __restrict__ v_lo, typename A::Real* __restrict__ out,
                                     const int* __restrict__ win, int n0, int n1, int r) {
  const int lo = win[2 * blockIdx.x];
  const int hi = win[2 * blockIdx.x + 1];
  matvec_rows<A, ND, RC>(s, x0t, x1t, v, v_lo, out, n0, n1, r, lo, hi);
}

template <class A, int ND, int RW>
__global__ void __launch_bounds__(kMatmatThreads)
    banded_matmat_kernel(const __grid_constant__ GramSpec s, const typename A::Real* __restrict__ x0t,
                         const typename A::Real* __restrict__ x1t, const typename A::Real* __restrict__ v,
                         const typename A::Real* __restrict__ v_lo, typename A::Real* __restrict__ out,
                         const int* __restrict__ win, int n0, int n1, int r, int tile) {
  const int b = blockIdx.x * kMatmatRows / tile;
  matmat_rows<A, ND, RW>(s, x0t, x1t, v, v_lo, out, n0, n1, r, win[2 * b], win[2 * b + 1]);
}

template <class A, int ND, int RC>
void launch_banded_rc(const GramSpec& s, const void* x0t, const void* x1t, const void* v, const void* v_lo, void* out,
                      const int* win, int n0, int n1, int r, int tile, cudaStream_t stream) {
  using T = typename A::Real;
  const size_t smem = matvec_smem_bytes<A, ND, RC>(tile);
  const dim3 grid((n0 + tile - 1) / tile, (r + RC - 1) / RC);
  banded_matvec_kernel<A, ND, RC><<<grid, dim3(tile), smem, stream>>>(
      s, static_cast<const T*>(x0t), static_cast<const T*>(x1t), static_cast<const T*>(v),
      static_cast<const T*>(v_lo), static_cast<T*>(out), win, n0, n1, r);
}

template <class A, int ND, int RW>
cudaError_t launch_banded_matmat_rw(const GramSpec& s, const void* x0t, const void* x1t, const void* v,
                                    const void* v_lo, void* out, const int* win, int n0, int n1, int r, int tile,
                                    cudaStream_t stream) {
  using T = typename A::Real;
  const size_t smem = matmat_smem_bytes<A, ND, RW>();
  const cudaError_t err = allow_smem(banded_matmat_kernel<A, ND, RW>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n0 + kMatmatRows - 1) / kMatmatRows, (r + RW - 1) / RW);
  banded_matmat_kernel<A, ND, RW><<<grid, kMatmatThreads, smem, stream>>>(
      s, static_cast<const T*>(x0t), static_cast<const T*>(x1t), static_cast<const T*>(v),
      static_cast<const T*>(v_lo), static_cast<T*>(out), win, n0, n1, r, tile);
  return cudaGetLastError();
}

// wide = 0: the one-row-per-thread walk, RC the narrowest of 1, 2, 4 that
// holds r; wide = 1: the multi-column route, RW the narrowest of 64, 128, 256
// that holds r (256 above it).  The caller (ops/_cuda.py) picks the route.
template <class A, int ND>
cudaError_t launch_banded(const GramSpec& s, const void* x0t, const void* x1t, const void* v, const void* v_lo,
                          void* out, const int* win, int n0, int n1, int r, int tile, int wide, cudaStream_t stream) {
  if (wide) {
    if (tile % kMatmatRows != 0) return cudaErrorInvalidValue;
    if (r <= 64) return launch_banded_matmat_rw<A, ND, 64>(s, x0t, x1t, v, v_lo, out, win, n0, n1, r, tile, stream);
    if (r <= 128) return launch_banded_matmat_rw<A, ND, 128>(s, x0t, x1t, v, v_lo, out, win, n0, n1, r, tile, stream);
    return launch_banded_matmat_rw<A, ND, 256>(s, x0t, x1t, v, v_lo, out, win, n0, n1, r, tile, stream);
  }
  if (r == 1) {
    launch_banded_rc<A, ND, 1>(s, x0t, x1t, v, v_lo, out, win, n0, n1, r, tile, stream);
  } else if (r == 2) {
    launch_banded_rc<A, ND, 2>(s, x0t, x1t, v, v_lo, out, win, n0, n1, r, tile, stream);
  } else {
    launch_banded_rc<A, ND, 4>(s, x0t, x1t, v, v_lo, out, win, n0, n1, r, tile, stream);
  }
  return cudaGetLastError();
}

template <class A>
cudaError_t dispatch_banded(const GramSpec& s, const void* x0t, const void* x1t, const void* v, const void* v_lo,
                            void* out, const int* win, int n0, int n1, int r, int tile, int wide,
                            cudaStream_t st) {
  switch (s.ndims) {
    case 1: return launch_banded<A, 1>(s, x0t, x1t, v, v_lo, out, win, n0, n1, r, tile, wide, st);
    case 2: return launch_banded<A, 2>(s, x0t, x1t, v, v_lo, out, win, n0, n1, r, tile, wide, st);
    case 3: return launch_banded<A, 3>(s, x0t, x1t, v, v_lo, out, win, n0, n1, r, tile, wide, st);
    case 4: return launch_banded<A, 4>(s, x0t, x1t, v, v_lo, out, win, n0, n1, r, tile, wide, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace lgt

extern "C" {

// Points sorted by dimension 0 and transposed, (ndims, n); v (n1, r) in the
// sorted column order; win (ceil(n0 / tile), 2) int32 column windows; v_lo:
// lo plane of an ff right-hand side (mode kFF only; may be null).  wide != 0
// takes the multi-column route and needs tile % kMatmatRows == 0.
int lgt_banded_matvec(const lgt::GramSpec* spec, int mode, const void* x0t, const void* x1t, const void* v,
                      const void* v_lo, void* out, const int* win, int n0, int n1, int r, int tile, int wide,
                      void* stream) {
  const auto st = static_cast<cudaStream_t>(stream);
  if (v_lo != nullptr && mode != lgt::kFF) return cudaErrorInvalidValue;
  switch (mode) {
    case lgt::kPlain:
      return lgt::dispatch_banded<lgt::PlainArith<float>>(*spec, x0t, x1t, v, v_lo, out, win, n0, n1, r, tile, wide,
                                                           st);
    case lgt::kFF:
      return lgt::dispatch_banded<lgt::FFArith>(*spec, x0t, x1t, v, v_lo, out, win, n0, n1, r, tile, wide, st);
    case lgt::kF64:
      return lgt::dispatch_banded<lgt::PlainArith<double>>(*spec, x0t, x1t, v, v_lo, out, win, n0, n1, r, tile, wide,
                                                            st);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
