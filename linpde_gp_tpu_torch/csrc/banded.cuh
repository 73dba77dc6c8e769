// Hand-written Hopper (sm_90a) banded Gram matvec for compactly supported
// (Wendland) kernels, templated on the spec structure S (gram_eval.cuh) and
// instantiated per structure by module.cuh.
//
// banded_matvec_kernel replaces both TPU kernels of make_banded_matvec in
// linpde_gp_tpu/ops/pallas_gram.py: _build_banded_matvec (:664, body
// _banded_matvec_body :626, the multi-RHS route) and
// _build_banded_panel_matvec (:728, body _banded_panel_body :688, the r = 1
// route).  It computes K(X0, X1) @ V, V of shape (n1, r), for a kernel that
// is exactly zero beyond a radius along input dimension 0.
//
// The host (ops/banded.py) sorts both point sets by dimension 0 and gives
// every block of `tile` sorted rows its own column window [lo, hi) in
// sorted columns: all columns within the radius of the block's rows,
// widened by a few ulps so that no pair the f32 bodies evaluate as inside
// is left out.  The TPU needed one uniform band width and a clamped window
// start to keep its grid static; here each block walks only its own window,
// with K2's narrow row walk (gram_eval.cuh::matvec_rows: tile / A::kRows
// threads of A::kRows rows each, tiles of the window's X1 coordinates and V
// rows staged in shared memory, the sums in registers, no atomics).  In ff
// mode the product and the row sum are carried in ff with an ff right-hand
// side (v, v_lo) and the result is the ff pair; the TPU bodies summed hi*v
// and lo*v in f32, which cancels by up to ~5e7 at N = 1e5.  That walk
// serves r <= 4.  For r > 4, banded_matmat_kernel walks the same window with
// K2's multi-column route (gram_eval.cuh::matmat_rows): each pair once per
// block of RW >= 64 columns into shared memory, the product on the FP64
// tensor cores.  Its blocks hold kMatmatRows rows and read the window of the
// tile-row block that contains them (tile is a multiple of kMatmatRows);
// depth tiles start at the window's lo, and the last one is ragged.
//
// What bounds it on the H100: arithmetic, as K2, over band_fraction * n0 * n1
// pairs instead of n0 * n1 (~10 % at N = 1e5 and radius 0.05 on [0, 1]).
// Blocks whose windows are narrow finish early; at N = 1e5 the 782 blocks of
// 128 rows keep all 132 SMs busy.
#pragma once

#include "gram_eval.cuh"

namespace lgt {

// win[2 b], win[2 b + 1]: the column window [lo, hi) of row block b, whose
// `tile` rows the block's tile / A::kRows threads take.
template <class S, class A, int RC>
__global__ void banded_matvec_kernel(const __grid_constant__ SpecValues s, const typename A::Real* __restrict__ x0t,
                                     const typename A::Real* __restrict__ x1t,
                                     const typename A::Real* __restrict__ v,
                                     const typename A::Real* __restrict__ v_lo, typename A::Real* __restrict__ out,
                                     typename A::Real* __restrict__ out_lo, const int* __restrict__ win, int n0,
                                     int n1, int r, int tile) {
  const int lo = win[2 * blockIdx.x];
  const int hi = win[2 * blockIdx.x + 1];
  matvec_rows<S, A, RC>(s, x0t, x1t, v, v_lo, out, out_lo, n0, n1, r, blockIdx.x * tile, lo, hi);
}

// The multi-column route: kMatmatRows rows per block, in the window of the
// tile-row block that holds them; RW columns from blockIdx.y * RW; v is the
// (n1, r) float64 panel.
template <class S, class A, int RW>
__global__ void __launch_bounds__(kMatmatThreads<RW>, kMatmatMinBlocks<RW>)
    banded_matmat_kernel(const __grid_constant__ SpecValues s, const typename A::Real* __restrict__ x0t,
                         const typename A::Real* __restrict__ x1t, const double* __restrict__ v,
                         typename A::Real* __restrict__ out, typename A::Real* __restrict__ out_lo,
                         const int* __restrict__ win, int n0, int n1, int r, int tile) {
  const int b = blockIdx.x * kMatmatRows / tile;
  matmat_rows<S, A, RW>(s, x0t, x1t, v, out, out_lo, n0, n1, r, win[2 * b], win[2 * b + 1]);
}

template <class S, class A, int RC>
cudaError_t launch_banded_rc(const SpecValues& s, const void* x0t, const void* x1t, const void* v, const void* v_lo,
                             void* out, void* out_lo, const int* win, int n0, int n1, int r, int tile,
                             cudaStream_t stream) {
  using T = typename A::Real;
  if (tile % (32 * A::kRows) != 0 || tile / A::kRows > 1024) return cudaErrorInvalidValue;
  const dim3 grid((n0 + tile - 1) / tile, (r + RC - 1) / RC);
  banded_matvec_kernel<S, A, RC><<<grid, tile / A::kRows, 0, stream>>>(
      s, static_cast<const T*>(x0t), static_cast<const T*>(x1t), static_cast<const T*>(v),
      static_cast<const T*>(v_lo), static_cast<T*>(out), static_cast<T*>(out_lo), win, n0, n1, r, tile);
  return cudaGetLastError();
}

template <class S, class A, int RW>
cudaError_t launch_banded_matmat_rw(const SpecValues& s, const void* x0t, const void* x1t, const void* v, void* out,
                                    void* out_lo, const int* win, int n0, int n1, int r, int tile,
                                    cudaStream_t stream) {
  using T = typename A::Real;
  const auto kernel = banded_matmat_kernel<S, A, RW>;
  const size_t smem = matmat_smem_bytes<RW>();
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n0 + kMatmatRows - 1) / kMatmatRows, (r + RW - 1) / RW);
  kernel<<<grid, kMatmatThreads<RW>, smem, stream>>>(s, static_cast<const T*>(x0t), static_cast<const T*>(x1t),
                                                     static_cast<const double*>(v), static_cast<T*>(out),
                                                     static_cast<T*>(out_lo), win, n0, n1, r, tile);
  return cudaGetLastError();
}

// wide = 0: the narrow walk, RC the narrowest of 1, 2, 4 that holds r;
// wide = 1: the multi-column route, RW the narrowest of 64, 128, 256 that
// holds r (256 above it), v the (n1, r) float64 panel and v_lo null; tile
// must be a multiple of kMatmatRows.  The caller (ops/_cuda.py) picks the
// route and checks the tile first.
template <class S, class A>
cudaError_t launch_banded(const SpecValues& s, const void* x0t, const void* x1t, const void* v, const void* v_lo,
                          void* out, void* out_lo, const int* win, int n0, int n1, int r, int tile, int wide,
                          cudaStream_t stream) {
  if (wide) {  // v: the float64 panel, no lo plane
    if (tile % kMatmatRows != 0 || v_lo != nullptr) return cudaErrorInvalidValue;
    if (r <= 64) return launch_banded_matmat_rw<S, A, 64>(s, x0t, x1t, v, out, out_lo, win, n0, n1, r, tile, stream);
    if (r <= 128) {
      return launch_banded_matmat_rw<S, A, 128>(s, x0t, x1t, v, out, out_lo, win, n0, n1, r, tile, stream);
    }
    return launch_banded_matmat_rw<S, A, 256>(s, x0t, x1t, v, out, out_lo, win, n0, n1, r, tile, stream);
  }
  if (r == 1) return launch_banded_rc<S, A, 1>(s, x0t, x1t, v, v_lo, out, out_lo, win, n0, n1, r, tile, stream);
  if (r == 2) return launch_banded_rc<S, A, 2>(s, x0t, x1t, v, v_lo, out, out_lo, win, n0, n1, r, tile, stream);
  return launch_banded_rc<S, A, 4>(s, x0t, x1t, v, v_lo, out, out_lo, win, n0, n1, r, tile, stream);
}

}  // namespace lgt
