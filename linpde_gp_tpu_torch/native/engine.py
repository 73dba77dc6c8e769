r"""Native (C++/OpenMP) kernel-reduction engine: the port's float64 CPU route.

Port of ``linpde_gp_tpu/native/engine.py`` (the KeOps counterpart of the
reference, which ``pykeops`` plays there).  A kernel formula, the ``(scale,
terms)`` sum-of-products spec that the CUDA kernels also evaluate
(``ops/gram.kernel_term_specs``), is

1. code-generated to specialized C++: polynomial coefficients become
   literals, Horner chains and factor products are unrolled;
2. compiled once per formula with ``g++ -O3 -fopenmp -march=native`` into
   a shared library in the ``build/native/`` directory beside the package
   (git ignores it), named by a hash of the source, the compiler and the
   CPU;
3. loaded through ``ctypes`` and exposed as two reductions: ``gram``
   (``K(X0, X1)``, O(n0 n1) memory) and ``matvec`` (``K(X0, X1) @ V``
   without storing ``K``).

Everything is float64 end to end.  The engine takes numpy arrays or CPU
tensors and returns the caller's type.

Differences from the JAX package: the libraries are built inside the
checkout, not in a per-user temporary directory (the ownership checks
stay: the directory must be the caller's, and a library owned by another
user is rebuilt, never loaded); and a build that fails while g++ is
present raises, where the JAX package returns ``None`` and its routers
fall back to the plain evaluation without a word.  Only a missing
toolchain (:func:`available` false) leaves the plain version in place.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

_LOCK = threading.Lock()
_ENGINES: dict = {}
_GXX = shutil.which("g++")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
#: Libraries built by this process (compiler runs, not cache hits).
builds: list[str] = []


def available() -> bool:
    """True if a host C++ toolchain is present."""
    return _GXX is not None


def _cache_dir() -> Path:
    """The build directory, created 0700 and ownership-verified: a
    directory another user owns could hold a library ``ctypes.CDLL`` would
    load."""
    BUILD_DIR.mkdir(mode=0o700, parents=True, exist_ok=True)
    st = BUILD_DIR.stat()
    if hasattr(os, "getuid") and st.st_uid != os.getuid():
        raise PermissionError(f"native build directory {BUILD_DIR} is owned by uid {st.st_uid}, not this user")
    return BUILD_DIR


def _fmt(x: float) -> str:
    """Full-precision C++ double literal."""
    s = repr(float(x))
    if "e" not in s and "." not in s and "inf" not in s and "nan" not in s:
        s += ".0"
    return s


def _factor_code(name: str, kind: str, s: float, poly, parity: int, pref: float, dvar: str) -> str:
    """C++ statements computing one univariate factor value:
    matern ``pref * P(s|d|) * exp(-s|d|) [* sign(d)]``; wendland
    ``pref * (s|d| <= 1 ? P(s|d|) : 0) [* sign(d)]``; expquad
    ``pref * P(s d) * exp(-(s d)^2)``."""
    lines = []
    if kind in ("matern", "wendland"):
        lines.append(f"      const double t_{name} = {_fmt(s)} * std::fabs({dvar});")
    elif kind == "expquad":
        lines.append(f"      const double t_{name} = {_fmt(s)} * {dvar};")
    else:
        raise ValueError(f"unknown factor kind: {kind!r}")
    tv = f"t_{name}"
    lines.append(f"      double p_{name} = {_fmt(poly[-1])};")
    for c in reversed(poly[:-1]):
        lines.append(f"      p_{name} = p_{name} * {tv} + {_fmt(c)};")
    if kind == "matern":
        expr = f"{_fmt(pref)} * p_{name} * std::exp(-{tv})"
    elif kind == "wendland":
        expr = f"{_fmt(pref)} * ({tv} <= 1.0 ? p_{name} : 0.0)"
    else:
        expr = f"{_fmt(pref)} * p_{name} * std::exp(-({tv} * {tv}))"
    if parity and kind != "expquad":
        expr += f" * sgn({dvar})"
    lines.append(f"      const double f_{name} = {expr};")
    return "\n".join(lines)


def _generate_source(scale: float, terms: tuple, dim: int) -> str:
    """The specialized C++ translation unit for one formula; each distinct
    (coordinate, factor) pair is evaluated once per pair of points."""
    factor_vars: dict = {}
    factor_blocks: list[str] = []
    term_exprs: list[str] = []
    for coeff, factors in terms:
        if len(factors) != dim:
            raise ValueError("inconsistent factor arity across terms")
        prod = [_fmt(coeff)]
        for i, spec in enumerate(factors):
            key = (i, spec)
            if key not in factor_vars:
                factor_vars[key] = name = f"{len(factor_vars)}"
                factor_blocks.append(_factor_code(name, *spec, dvar=f"d{i}"))
            prod.append(f"f_{factor_vars[key]}")
        term_exprs.append(" * ".join(prod))
    diffs = "\n".join(f"      const double d{i} = xi[{i}] - xj[{i}];" for i in range(dim))
    body = "\n".join(factor_blocks)
    acc = "\n        + ".join(term_exprs)
    return f"""// Generated by linpde_gp_tpu_torch.native.engine: do not edit.
#include <cmath>
#include <cstdint>

namespace {{
inline double sgn(double d) {{ return (double)((d > 0.0) - (d < 0.0)); }}

inline double kpair(const double* __restrict xi, const double* __restrict xj) {{
{diffs}
{body}
      return {_fmt(scale)} * ({acc});
}}
}}  // namespace

extern "C" {{

// out[i, j] = k(x0[i], x1[j]); row-major (n0, n1).
void lgt_gram(const double* __restrict x0, const double* __restrict x1,
              int64_t n0, int64_t n1, double* __restrict out) {{
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n0; ++i) {{
    const double* xi = x0 + i * {dim};
    double* row = out + i * n1;
    for (int64_t j = 0; j < n1; ++j) row[j] = kpair(xi, x1 + j * {dim});
  }}
}}

// out[i, r] = sum_j k(x0[i], x1[j]) * v[j, r], without storing k.
void lgt_matvec(const double* __restrict x0, const double* __restrict x1,
                int64_t n0, int64_t n1, int64_t nr,
                const double* __restrict v, double* __restrict out) {{
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n0; ++i) {{
    const double* xi = x0 + i * {dim};
    double* acc = out + i * nr;
    for (int64_t r = 0; r < nr; ++r) acc[r] = 0.0;
    for (int64_t j = 0; j < n1; ++j) {{
      const double kij = kpair(xi, x1 + j * {dim});
      const double* vj = v + j * nr;
      for (int64_t r = 0; r < nr; ++r) acc[r] += kij * vj[r];
    }}
  }}
}}

}}  // extern "C"
"""


@functools.lru_cache(maxsize=None)
def _host() -> str:
    """The compiler and the CPU a library is built for (``-march=native``):
    part of its name, so that a build directory carried to another machine
    is rebuilt there, never loaded."""
    keys = ("model name", "flags", "Features", "CPU implementer", "CPU part")
    cpu = ""
    try:
        with open("/proc/cpuinfo") as fh:
            cpu = "".join(sorted({line for line in fh if line.startswith(keys)}))
    except OSError:
        pass
    return f"{_GXX} {platform.machine()} {cpu}"


def _compile(source: str) -> Path:
    """Compile ``source`` into a cached shared library; return its path.
    Raises ``subprocess.CalledProcessError`` (with the compiler's output)
    if g++ fails."""
    key = hashlib.sha256((_host() + source).encode()).hexdigest()[:24]
    cache = _cache_dir()
    lib_path = cache / f"lgt_{key}.so"
    if lib_path.exists():
        if not hasattr(os, "getuid") or lib_path.stat().st_uid == os.getuid():
            return lib_path
        lib_path.unlink()  # another user's library: rebuild, never load
    src_path = cache / f"lgt_{key}.{os.getpid()}.cpp"
    src_path.write_text(source)
    tmp_path = cache / f"lgt_{key}.so.{os.getpid()}.tmp"
    cmd = [_GXX, "-O3", "-fopenmp", "-shared", "-fPIC", "-std=c++17", "-march=native", str(src_path), "-o",
           str(tmp_path)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    finally:
        src_path.unlink(missing_ok=True)
    os.replace(tmp_path, lib_path)  # atomic against concurrent builds
    builds.append(lib_path.name)
    return lib_path


_PTR = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")


class NativeGramEngine:
    """A compiled, formula-specialized pairwise-kernel reduction."""

    def __init__(self, scale: float, terms: tuple):
        self.dim = len(terms[0][1])
        self._lib = ctypes.CDLL(str(_compile(_generate_source(float(scale), terms, self.dim))))
        self._lib.lgt_gram.argtypes = [_PTR, _PTR, ctypes.c_int64, ctypes.c_int64, _PTR]
        self._lib.lgt_gram.restype = None
        self._lib.lgt_matvec.argtypes = [_PTR, _PTR, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _PTR, _PTR]
        self._lib.lgt_matvec.restype = None

    @staticmethod
    def _array(a) -> np.ndarray:
        if isinstance(a, torch.Tensor):
            if a.device.type != "cpu":
                raise ValueError(f"the native engine takes CPU tensors, got one on {a.device}")
            a = a.detach().numpy()
        return np.ascontiguousarray(a, dtype=np.float64)

    def _points(self, X) -> np.ndarray:
        X = self._array(X)
        X = X.reshape(-1, self.dim) if X.ndim != 1 else X[:, None]
        if X.shape[1] != self.dim:
            raise ValueError(f"expected point dim {self.dim}, got {X.shape[1]}")
        return X

    def gram(self, X0, X1):
        """``K(X0, X1)``, ``(n0, n1)`` float64, as a tensor if ``X0`` is one."""
        x0, x1 = self._points(X0), self._points(X1)
        out = np.empty((x0.shape[0], x1.shape[0]), dtype=np.float64)
        self._lib.lgt_gram(x0, x1, x0.shape[0], x1.shape[0], out)
        return torch.from_numpy(out) if isinstance(X0, torch.Tensor) else out

    def matvec(self, X0, X1, v):
        """``K(X0, X1) @ v`` for ``v`` of shape ``(n1,)`` or ``(n1, r)``,
        float64, as a tensor if ``v`` is one."""
        x0, x1 = self._points(X0), self._points(X1)
        w = self._array(v)
        vector = w.ndim == 1
        w2 = w[:, None] if vector else w
        if w2.shape[0] != x1.shape[0]:
            raise ValueError(f"v has {w2.shape[0]} rows, X1 has {x1.shape[0]} points")
        out = np.empty((x0.shape[0], w2.shape[1]), dtype=np.float64)
        self._lib.lgt_matvec(x0, x1, x0.shape[0], x1.shape[0], w2.shape[1], np.ascontiguousarray(w2), out)
        out = out[:, 0] if vector else out
        return torch.from_numpy(out) if isinstance(v, torch.Tensor) else out


def engine_for_spec(scale: float, terms: tuple) -> NativeGramEngine | None:
    """The engine of a ``(scale, terms)`` spec, built at first use and kept;
    ``None`` without a toolchain.  A failed build raises."""
    if not available():
        return None
    key = (float(scale), terms)
    with _LOCK:
        eng = _ENGINES.get(key)
        if eng is None:
            eng = _ENGINES[key] = NativeGramEngine(scale, terms)
    return eng


def engine_for(kernel) -> NativeGramEngine | None:
    """Engine of a kernel of the sum-of-products family (``None`` for any
    other kernel, or without a toolchain)."""
    from ..ops.gram import kernel_term_specs

    spec = kernel_term_specs(kernel)
    if spec is None:
        return None
    return engine_for_spec(*spec)
