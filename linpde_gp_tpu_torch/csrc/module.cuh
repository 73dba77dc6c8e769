// The C interface of one spec structure's kernel module, loaded with ctypes
// by ops/_cuda.py.  ops/_cuda.py generates, per spec structure, a source
// that defines lgt::Structure (the constexpr tables gram_eval.cuh reads) and
// then includes this file; nvcc builds it into one shared library.  Every
// entry takes the spec's values (SpecValues, in the structure's order) and
// a mode (kPlain, kFF, kF64), and returns a cudaError_t.
#pragma once

#include "banded.cuh"
#include "gram.cuh"

namespace lgt {

template <template <class> class Launch, class... Args>
int dispatch_mode(int mode, Args... args) {
  switch (mode) {
    case kPlain: return Launch<PlainArith<float>>::run(args...);
    case kFF: return Launch<FFArith>::run(args...);
    case kF64: return Launch<PlainArith<double>>::run(args...);
    default: return cudaErrorInvalidValue;
  }
}

template <class A>
struct GramLaunch {
  static int run(const SpecValues* s, const void* x0t, const void* x1t, void* out, int n0, int n1, int tile,
                 cudaStream_t st) {
    return launch_gram<Structure, A>(*s, x0t, x1t, out, n0, n1, tile, st);
  }
};

template <class A>
struct MatvecLaunch {
  static int run(const SpecValues* s, const void* x0t, const void* x1t, const void* v, const void* v_lo, void* out,
                 void* out_lo, int n0, int n1, int r, int wide, int splits, int chunk, void* scratch,
                 void* scratch_lo, cudaStream_t st) {
    return launch_gram_matvec<Structure, A>(*s, x0t, x1t, v, v_lo, out, out_lo, n0, n1, r, wide, splits, chunk,
                                            scratch, scratch_lo, st);
  }
};

template <class A>
struct SymLaunch {
  static int run(const SpecValues* s, const void* xt, const void* v, const void* v_lo, void* out, void* out_lo, int n,
                 int r, const int* chunks, const int* rows, int blocks, int pairs, void* scratch, void* scratch_lo,
                 cudaStream_t st) {
    return launch_gram_matvec_sym<Structure, A>(*s, xt, v, v_lo, out, out_lo, n, r, chunks, rows, blocks, pairs,
                                                scratch, scratch_lo, st);
  }
};

template <class A>
struct SymBlocks {
  static int run(int r) { return sym_blocks_per_sm<Structure, A>(r); }
};

template <class A>
struct BandedLaunch {
  static int run(const SpecValues* s, const void* x0t, const void* x1t, const void* v, const void* v_lo, void* out,
                 void* out_lo, const int* win, int n0, int n1, int r, int tile, int wide, cudaStream_t st) {
    return launch_banded<Structure, A>(*s, x0t, x1t, v, v_lo, out, out_lo, win, n0, n1, r, tile, wide, st);
  }
};

template <class A>
struct NarrowRows {
  static int run() { return kNarrowThreads * A::kRows; }
};

}  // namespace lgt

extern "C" {

// Points transposed, (ndims, n); out (n0, n1).
int lgt_gram(const lgt::SpecValues* spec, int mode, const void* x0t, const void* x1t, void* out, int n0, int n1,
             int tile, void* stream) {
  return lgt::dispatch_mode<lgt::GramLaunch>(mode, spec, x0t, x1t, out, n0, n1, tile, static_cast<cudaStream_t>(stream));
}

// v (n1, r); v_lo: lo plane of an ff right-hand side (mode kFF only; may be
// null); out (n0, r) and, in mode kFF, out_lo its lo plane (required).
// wide != 0 takes the multi-column route: there v is the (n1, r) float64
// panel in every mode (v + v_lo in kFF) and v_lo null.  The narrow route
// splits the columns into `splits` chunks of `chunk` (scratch, scratch_lo:
// (splits, n0, r), read only if splits > 1).
int lgt_gram_matvec(const lgt::SpecValues* spec, int mode, const void* x0t, const void* x1t, const void* v,
                    const void* v_lo, void* out, void* out_lo, int n0, int n1, int r, int wide, int splits, int chunk,
                    void* scratch, void* scratch_lo, void* stream) {
  if ((v_lo != nullptr && mode != lgt::kFF) || ((mode == lgt::kFF) != (out_lo != nullptr)) || splits < 1 ||
      splits > 65535 || (splits > 1 && scratch == nullptr)) {
    return cudaErrorInvalidValue;
  }
  return lgt::dispatch_mode<lgt::MatvecLaunch>(mode, spec, x0t, x1t, v, v_lo, out, out_lo, n0, n1, r, wide, splits,
                                               chunk, scratch, scratch_lo, static_cast<cudaStream_t>(stream));
}

// K(X, X) @ v on the symmetric narrow route, 1 <= r <= 4: points transposed,
// (ndims, n); v, v_lo, out, out_lo as for lgt_gram_matvec.  chunks (blocks,
// 4) and rows (ceil(n / B), 2) int32: the schedule of ops/_cuda.py::
// sym_schedule over `pairs` tile pairs of B = lgt_narrow_rows(mode) points;
// scratch (and scratch_lo in mode kFF): (pairs + blocks + ceil(n / B) - 1)
// B r values.
int lgt_gram_matvec_sym(const lgt::SpecValues* spec, int mode, const void* xt, const void* v, const void* v_lo,
                        void* out, void* out_lo, int n, int r, const int* chunks, const int* rows, int blocks,
                        int pairs, void* scratch, void* scratch_lo, void* stream) {
  if ((v_lo != nullptr && mode != lgt::kFF) || ((mode == lgt::kFF) != (out_lo != nullptr)) || r < 1 || r > 4 ||
      n < 1 || blocks < 1 || pairs < blocks || scratch == nullptr || ((mode == lgt::kFF) != (scratch_lo != nullptr))) {
    return cudaErrorInvalidValue;
  }
  return lgt::dispatch_mode<lgt::SymLaunch>(mode, spec, xt, v, v_lo, out, out_lo, n, r, chunks, rows, blocks, pairs,
                                            scratch, scratch_lo, static_cast<cudaStream_t>(stream));
}

// Blocks of the symmetric route that one SM holds at once, in a mode at r
// columns (0 on an error).
int lgt_sym_blocks_per_sm(int mode, int r) {
  if (r < 1 || r > 4 || (mode != lgt::kPlain && mode != lgt::kFF && mode != lgt::kF64)) return 0;
  return lgt::dispatch_mode<lgt::SymBlocks>(mode, r);
}

// Points sorted by dimension 0 and transposed, (ndims, n); v (n1, r) in the
// sorted column order; win (ceil(n0 / tile), 2) int32 column windows; v_lo,
// out_lo as for lgt_gram_matvec.  wide != 0 takes the multi-column route (v
// the float64 panel, as for lgt_gram_matvec) and needs tile % kMatmatRows
// == 0; the narrow walk needs tile % (32 kRows) == 0.
int lgt_banded_matvec(const lgt::SpecValues* spec, int mode, const void* x0t, const void* x1t, const void* v,
                      const void* v_lo, void* out, void* out_lo, const int* win, int n0, int n1, int r, int tile,
                      int wide, void* stream) {
  if ((v_lo != nullptr && mode != lgt::kFF) || ((mode == lgt::kFF) != (out_lo != nullptr))) {
    return cudaErrorInvalidValue;
  }
  return lgt::dispatch_mode<lgt::BandedLaunch>(mode, spec, x0t, x1t, v, v_lo, out, out_lo, win, n0, n1, r, tile, wide,
                                               static_cast<cudaStream_t>(stream));
}

// Rows per block of the narrow route in a mode (the column split's unit).
int lgt_narrow_rows(int mode) { return lgt::dispatch_mode<lgt::NarrowRows>(mode); }

// Rows per block of the multi-column route (ops/_cuda.py::MATMAT_ROWS).
int lgt_matmat_rows() { return lgt::kMatmatRows; }

int lgt_structure_dims() { return lgt::Structure::nd; }

const char* lgt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

int lgt_values_size() { return static_cast<int>(sizeof(lgt::SpecValues)); }

}  // extern "C"
