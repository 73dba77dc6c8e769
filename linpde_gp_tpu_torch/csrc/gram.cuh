// Hand-written Hopper (sm_90a) kernels for sum-of-products kernel Grams,
// templated on the spec structure S (gram_eval.cuh) and instantiated per
// structure by module.cuh.
//
// K1 gram_kernel replaces the TPU kernel _build_pallas_gram / body
// _tile_kernel_body (linpde_gp_tpu/ops/pallas_gram.py:277, :250): the dense
// Gram K(X0, X1) of a collapsed spec.
// K2 replaces _build_pallas_gram_matvec / body _matvec_body
// (pallas_gram.py:393, :348): K(X0, X1) @ V without storing K.
//
// K2 has two routes.  For r <= 4 right-hand-side columns, gram_matvec_kernel
// (gram_eval.cuh::matvec_rows) gives each thread A::kRows output rows, and
// splits the columns over gridDim.z when the rows alone give too few blocks
// (matvec_reduce_kernel then sums the chunks in a fixed order); its ff body
// takes an ff right-hand side (hi and lo planes), carries each product and
// the row sum in ff and returns the ff pair.  On a Gram of a point set with
// itself (the CG's (H k H*)(X, X) p; ops/_cuda.py::gram_matvec_sym), the
// narrow route is sym_gram_matvec_kernel (gram_eval.cuh::sym_walk), which
// replaces gram_matvec_kernel there: it evaluates each unordered pair once,
// not twice, over equal chunks of the upper triangle's tile pairs on a
// persistent grid, each pair's value added to both of its rows, and
// sym_matvec_reduce_kernel sums the row and column partials from fixed slots
// of a caller's scratch in a fixed order (no atomics: the same bits from
// call to call).  For r > 4, gram_matmat_kernel
// (gram_eval.cuh::matmat_rows) evaluates each pair once per block of RW >= 64
// columns into shared memory and multiplies the tile by V's float64 panel on
// the FP64 tensor cores, as the TPU body multiplies a tile by its panel; its
// ff product and sum are float64 from hi + lo and v + v_lo, returned as their
// f32 split.
//
// What bounds them on the H100: arithmetic (gram_eval.cuh gives the counts
// and what the narrow route's design does about them).  K2 reads O(n0 + n1 r)
// bytes and evaluates n0 n1 pairs (n (n + 1) / 2 on the symmetric route,
// which writes and reads ~n^2 / (2 B) partials besides: 159 MB at N = 1e5,
// f64, r = 1; 15.9 against 30.6 ms on the H100), so at N = 1e5 it is
// compute-bound by a factor of thousands over bandwidth.  K1 writes n0 n1
// values, 4 or 8 bytes against ~35-370 instructions per entry:
// compute-bound.  K1 runs one thread per output entry.
#pragma once

#include "gram_eval.cuh"

namespace lgt {

// -- K1: dense Gram ----------------------------------------------------------------

// Points arrive transposed, (ND, n), so neighbouring threads read
// neighbouring addresses.  Thread x runs along columns: coalesced stores.
template <class S, class A>
__global__ void gram_kernel(const __grid_constant__ SpecValues s, const typename A::Real* __restrict__ x0t,
                            const typename A::Real* __restrict__ x1t, typename A::Real* __restrict__ out, int n0,
                            int n1) {
  using T = typename A::Real;
  constexpr int ND = S::nd;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  const int i = blockIdx.y * blockDim.y + threadIdx.y;
  if (i >= n0 || j >= n1) return;
  T a[ND], b[ND];
#pragma unroll
  for (int k = 0; k < ND; ++k) {
    a[k] = x0t[static_cast<size_t>(k) * n0 + i];
    b[k] = x1t[static_cast<size_t>(k) * n1 + j];
  }
  out[static_cast<size_t>(i) * n1 + j] = A::value(eval_pair<S, A>(s, a, b));
}

// -- K2: gram-free matvec ---------------------------------------------------------

// kNarrowThreads threads, kNarrowThreads * A::kRows rows per block; RC
// right-hand-side columns from blockIdx.y * RC; the columns [z chunk, (z + 1)
// chunk) of split z = blockIdx.z, written to plane z of out (n0 r apart).
template <class S, class A, int RC>
__global__ void __launch_bounds__(kNarrowThreads)
    gram_matvec_kernel(const __grid_constant__ SpecValues s, const typename A::Real* __restrict__ x0t,
                       const typename A::Real* __restrict__ x1t, const typename A::Real* __restrict__ v,
                       const typename A::Real* __restrict__ v_lo, typename A::Real* __restrict__ out,
                       typename A::Real* __restrict__ out_lo, int n0, int n1, int r, int chunk) {
  const int j_begin = blockIdx.z * chunk;
  const int j_end = min(n1, j_begin + chunk);
  const size_t plane = static_cast<size_t>(blockIdx.z) * n0 * r;
  matvec_rows<S, A, RC>(s, x0t, x1t, v, v_lo, out + plane, out_lo == nullptr ? nullptr : out_lo + plane, n0, n1, r,
                        blockIdx.x * kNarrowThreads * A::kRows, j_begin, j_end);
}

// The symmetric narrow route (gram_eval.cuh::sym_walk): a persistent grid,
// one chunk of the upper triangle's tile pairs per block.
template <class S, class A, int RC>
__global__ void __launch_bounds__(kNarrowThreads)
    sym_gram_matvec_kernel(const __grid_constant__ SpecValues s, const typename A::Real* __restrict__ xt,
                           const typename A::Real* __restrict__ v, const typename A::Real* __restrict__ v_lo,
                           typename A::Real* __restrict__ part, typename A::Real* __restrict__ part_lo,
                           const int4* __restrict__ chunks, int n, int r, int nb, size_t row_slots_at) {
  sym_walk<S, A, RC>(s, xt, v, v_lo, part, part_lo, chunks, n, r, nb, row_slots_at);
}

// The multi-column route: kMatmatRows rows per block, RW columns from
// blockIdx.y * RW; v is the (n1, r) float64 panel.
template <class S, class A, int RW>
__global__ void __launch_bounds__(kMatmatThreads<RW>, kMatmatMinBlocks<RW>)
    gram_matmat_kernel(const __grid_constant__ SpecValues s, const typename A::Real* __restrict__ x0t,
                       const typename A::Real* __restrict__ x1t, const double* __restrict__ v,
                       typename A::Real* __restrict__ out, typename A::Real* __restrict__ out_lo, int n0, int n1,
                       int r) {
  matmat_rows<S, A, RW>(s, x0t, x1t, v, out, out_lo, n0, n1, r, 0, n1);
}

// -- launch ------------------------------------------------------------------------

template <class S, class A>
cudaError_t launch_gram(const SpecValues& s, const void* x0t, const void* x1t, void* out, int n0, int n1, int tile,
                        cudaStream_t stream) {
  using T = typename A::Real;
  const dim3 block(tile, tile);
  const dim3 grid((n1 + tile - 1) / tile, (n0 + tile - 1) / tile);
  gram_kernel<S, A><<<grid, block, 0, stream>>>(s, static_cast<const T*>(x0t), static_cast<const T*>(x1t),
                                                 static_cast<T*>(out), n0, n1);
  return cudaGetLastError();
}

// splits > 1: the kernel writes (splits, n0, r) partial sums to scratch
// (and scratch_lo), and matvec_reduce_kernel sums them into out.
template <class S, class A, int RC>
cudaError_t launch_gram_matvec_rc(const SpecValues& s, const void* x0t, const void* x1t, const void* v,
                                  const void* v_lo, void* out, void* out_lo, int n0, int n1, int r, int splits,
                                  int chunk, void* scratch, void* scratch_lo, cudaStream_t stream) {
  using T = typename A::Real;
  const int rows = kNarrowThreads * A::kRows;
  const dim3 grid((n0 + rows - 1) / rows, (r + RC - 1) / RC, splits);
  T* dst = static_cast<T*>(splits > 1 ? scratch : out);
  T* dst_lo = static_cast<T*>(splits > 1 ? scratch_lo : out_lo);
  gram_matvec_kernel<S, A, RC><<<grid, kNarrowThreads, 0, stream>>>(
      s, static_cast<const T*>(x0t), static_cast<const T*>(x1t), static_cast<const T*>(v),
      static_cast<const T*>(v_lo), dst, dst_lo, n0, n1, r, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t m = static_cast<size_t>(n0) * r;
  matvec_reduce_kernel<A><<<static_cast<unsigned>((m + 255) / 256), 256, 0, stream>>>(
      dst, dst_lo, static_cast<T*>(out), static_cast<T*>(out_lo), splits, m);
  return cudaGetLastError();
}

template <class S, class A, int RW>
cudaError_t launch_gram_matmat_rw(const SpecValues& s, const void* x0t, const void* x1t, const void* v, void* out,
                                  void* out_lo, int n0, int n1, int r, cudaStream_t stream) {
  using T = typename A::Real;
  const auto kernel = gram_matmat_kernel<S, A, RW>;
  const size_t smem = matmat_smem_bytes<RW>();
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n0 + kMatmatRows - 1) / kMatmatRows, (r + RW - 1) / RW);
  kernel<<<grid, kMatmatThreads<RW>, smem, stream>>>(s, static_cast<const T*>(x0t), static_cast<const T*>(x1t),
                                                     static_cast<const double*>(v), static_cast<T*>(out),
                                                     static_cast<T*>(out_lo), n0, n1, r);
  return cudaGetLastError();
}

// The symmetric route at RC columns: the walk over `blocks` chunks of the
// `pairs` tile pairs, then the second pass.  scratch (scratch_lo in mode ff):
// (pairs + blocks + nb - 1) tiles of B rows and r columns.
template <class S, class A, int RC>
cudaError_t launch_sym_rc(const SpecValues& s, const void* xt, const void* v, const void* v_lo, void* out,
                          void* out_lo, int n, int r, const int* chunks, const int* rows, int blocks, int pairs,
                          void* scratch, void* scratch_lo, cudaStream_t stream) {
  using T = typename A::Real;
  const auto kernel = sym_gram_matvec_kernel<S, A, RC>;
  constexpr size_t smem = SymSmem<S, A, RC>::bytes;
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  constexpr int tile = SymSmem<S, A, RC>::B;
  const int nb = (n + tile - 1) / tile;
  const size_t row_slots_at = static_cast<size_t>(pairs) * tile * r;
  T* part = static_cast<T*>(scratch);
  T* part_lo = static_cast<T*>(scratch_lo);
  kernel<<<blocks, kNarrowThreads, smem, stream>>>(s, static_cast<const T*>(xt), static_cast<const T*>(v),
                                                  static_cast<const T*>(v_lo), part, part_lo,
                                                  reinterpret_cast<const int4*>(chunks), n, r, nb, row_slots_at);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t m = static_cast<size_t>(n) * r;
  sym_matvec_reduce_kernel<A><<<static_cast<unsigned>((m + 255) / 256), 256, 0, stream>>>(
      part, part_lo, reinterpret_cast<const int2*>(rows), static_cast<T*>(out), static_cast<T*>(out_lo), n, r, tile,
      nb, row_slots_at);
  return cudaGetLastError();
}

// Blocks of the symmetric route at RC columns that one SM holds at once (0
// on an error): the persistent grid is this times the SMs.
template <class S, class A, int RC>
int sym_blocks_per_sm_rc() {
  const auto kernel = sym_gram_matvec_kernel<S, A, RC>;
  constexpr size_t smem = SymSmem<S, A, RC>::bytes;
  int blocks = 0;
  if (allow_smem(kernel, smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kNarrowThreads, smem) != cudaSuccess) {
    return 0;
  }
  return blocks;
}

// RC: the narrowest of 1, 2, 4 that holds r <= 4.
template <class S, class A>
cudaError_t launch_gram_matvec_sym(const SpecValues& s, const void* xt, const void* v, const void* v_lo, void* out,
                                   void* out_lo, int n, int r, const int* chunks, const int* rows, int blocks,
                                   int pairs, void* scratch, void* scratch_lo, cudaStream_t stream) {
  if (r == 1) {
    return launch_sym_rc<S, A, 1>(s, xt, v, v_lo, out, out_lo, n, r, chunks, rows, blocks, pairs, scratch, scratch_lo,
                                  stream);
  }
  if (r == 2) {
    return launch_sym_rc<S, A, 2>(s, xt, v, v_lo, out, out_lo, n, r, chunks, rows, blocks, pairs, scratch, scratch_lo,
                                  stream);
  }
  return launch_sym_rc<S, A, 4>(s, xt, v, v_lo, out, out_lo, n, r, chunks, rows, blocks, pairs, scratch, scratch_lo,
                                stream);
}

template <class S, class A>
int sym_blocks_per_sm(int r) {
  if (r == 1) return sym_blocks_per_sm_rc<S, A, 1>();
  if (r == 2) return sym_blocks_per_sm_rc<S, A, 2>();
  return sym_blocks_per_sm_rc<S, A, 4>();
}

// wide = 0: the narrow route, RC the narrowest of 1, 2, 4 that holds r (r > 4
// in ceil(r / 4) column groups); wide = 1: the multi-column route, RW the
// narrowest of 64, 128, 256 that holds r (256 above it), v the (n1, r)
// float64 panel (ops/_cuda.py::wide_panel) and v_lo null.  The caller
// (ops/_cuda.py) picks the route and the column split, and counts the launch.
template <class S, class A>
cudaError_t launch_gram_matvec(const SpecValues& s, const void* x0t, const void* x1t, const void* v, const void* v_lo,
                               void* out, void* out_lo, int n0, int n1, int r, int wide, int splits, int chunk,
                               void* scratch, void* scratch_lo, cudaStream_t stream) {
  if (wide) {  // v: the float64 panel, no lo plane
    if (v_lo != nullptr) return cudaErrorInvalidValue;
    if (r <= 64) return launch_gram_matmat_rw<S, A, 64>(s, x0t, x1t, v, out, out_lo, n0, n1, r, stream);
    if (r <= 128) return launch_gram_matmat_rw<S, A, 128>(s, x0t, x1t, v, out, out_lo, n0, n1, r, stream);
    return launch_gram_matmat_rw<S, A, 256>(s, x0t, x1t, v, out, out_lo, n0, n1, r, stream);
  }
  if (r == 1) {
    return launch_gram_matvec_rc<S, A, 1>(s, x0t, x1t, v, v_lo, out, out_lo, n0, n1, r, splits, chunk, scratch,
                                          scratch_lo, stream);
  }
  if (r == 2) {
    return launch_gram_matvec_rc<S, A, 2>(s, x0t, x1t, v, v_lo, out, out_lo, n0, n1, r, splits, chunk, scratch,
                                          scratch_lo, stream);
  }
  return launch_gram_matvec_rc<S, A, 4>(s, x0t, x1t, v, v_lo, out, out_lo, n0, n1, r, splits, chunk, scratch,
                                        scratch_lo, stream);
}

}  // namespace lgt
