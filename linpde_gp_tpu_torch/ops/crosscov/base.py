"""Process-vector cross-covariances: the ``k L*`` objects of the dense
conditioning engine.

Port of ``linpde_gp_tpu/ops/crosscov/base.py``: one generic
``KernelFunctionalCrossCov`` covers every functional through its
discretization, with the transformed kernel carried symbolically; the
axis layouts of the contraction live in :func:`_contract_functional_axis`.

Routing.  A contraction of a scalar kernel with a sum-of-products spec is
a Gram, assembled by ``ops/gram.gram_matrix`` in mode f64: K1 on CUDA
tensors, its plain version on CPU tensors.  The posterior mean's
``kLa(x) @ w`` takes K2 (``ops/gram.gram_matvec``, r = 1, f64) when the
kernel has a spec, ``argnum == 1``, its outputs are scalar and the
functional has a discretization; an evaluation after an operator, ``Eval(X)
o T``, is unfolded into K2 on ``k T*`` at ``X``, the same function (the
JAX package evaluates such blocks and multiplies).  Every other block
takes ``evaluate(x) @ w``, whose Gram still comes from K1.  A kernel
without a spec, or with array outputs, is evaluated by broadcasting its
own ``_evaluate``, as the JAX package falls back to ``kernel.matrix``.

A (scaled) 1-D half-integer Matérn under a Lebesgue integral on an interval
or a hat-basis projection takes the exact closed forms of
``ops/transforms/integrals_exact.py`` (crosscov and Gram block) before any
discretization, and its ``matvec`` takes ``evaluate @ w`` (the JAX package's
CPU route), never K2 over the quadrature nodes.  A functional with weights
(integrals, projections) is contracted in blocks of its nodes, ``sum_b
W[:, b] @ vals(nodes[b])`` (:data:`NODE_BLOCK_ELEMS`): the JAX package forms
``vals`` at every node at once, which for a 65,536-node integral against
~3e4 observations is 17 GB in float64.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ...config import as_f64, resolve_device
from ...utils.shapes import ShapeType, as_shape, size
from ..functionals.base import (
    CompositeLinearFunctional,
    LinearFunctional,
    ScaledLinearFunctional,
    SumLinearFunctional,
)
from ..kernels.base import CovarianceFunction

#: Entries of one ``vals(nodes[b])`` block of a weighted contraction, per
#: device type: the node block holds about this many values.
NODE_BLOCK_ELEMS = {"cuda": 1 << 25, "cpu": 1 << 16}


def _node_blocks(n_nodes: int, row_size: int, device):
    """Slices of at most ``NODE_BLOCK_ELEMS / row_size`` nodes covering
    ``range(n_nodes)``."""
    step = max(1, NODE_BLOCK_ELEMS.get(torch.device(device).type, 1 << 25) // max(row_size, 1))
    return [slice(s, min(s + step, n_nodes)) for s in range(0, n_nodes, step)]


class ProcessVectorCrossCovariance:
    """Cross-covariance between a random process (free argument) and a
    finite random vector of size ``randvar_size``.

    ``evaluate(x)`` returns ``batch + randproc_output_shape +
    (randvar_size,)``: the randvar axis last, whatever ``reverse`` is.
    """

    def __init__(self, randproc_input_shape, randproc_output_shape, randvar_size: int, reverse: bool = False):
        self._randproc_input_shape = as_shape(randproc_input_shape)
        self._randproc_output_shape = as_shape(randproc_output_shape)
        self._randvar_size = int(randvar_size)
        self._reverse = bool(reverse)

    @property
    def randproc_input_shape(self) -> ShapeType:
        return self._randproc_input_shape

    @property
    def randproc_input_ndim(self) -> int:
        return len(self._randproc_input_shape)

    @property
    def randproc_output_shape(self) -> ShapeType:
        return self._randproc_output_shape

    @property
    def randvar_size(self) -> int:
        return self._randvar_size

    @property
    def reverse(self) -> bool:
        return self._reverse

    def evaluate(self, x) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, x):
        return self.evaluate(as_f64(x))

    def apply_operator(self, op) -> "ProcessVectorCrossCovariance":
        raise NotImplementedError

    def matvec(self, x, w) -> torch.Tensor:
        """``crosscov(x) @ w``; subclasses may avoid forming the
        ``(n_query, randvar_size)`` cross matrix."""
        return self.evaluate(x) @ w

    # -- arithmetic ------------------------------------------------------
    def __add__(self, other):
        if isinstance(other, ProcessVectorCrossCovariance):
            return SumProcessVectorCrossCovariance(self, other)
        return NotImplemented

    def __rmul__(self, other):
        if np.ndim(other) == 0:
            return ScaledProcessVectorCrossCovariance(self, other)
        return NotImplemented

    __mul__ = __rmul__

    def __neg__(self):
        return -1.0 * self


class KernelFunctionalCrossCov(ProcessVectorCrossCovariance):
    """``x -> L_z[k(x, z)]`` (``argnum=1``) or ``x -> L_z[k(z, x)]``
    (``argnum=0``), with ``k`` possibly operator-transformed."""

    def __init__(self, kernel: CovarianceFunction, functional: LinearFunctional, argnum: int = 1):
        assert argnum in (0, 1)
        self._kernel = kernel
        self._functional = functional
        self._argnum = argnum
        proc_output = kernel.output_shape_0 if argnum == 1 else kernel.output_shape_1
        super().__init__(
            randproc_input_shape=kernel.input_shape,
            randproc_output_shape=proc_output,
            randvar_size=functional.output_size,
            reverse=(argnum == 0),
        )

    @property
    def kernel(self) -> CovarianceFunction:
        return self._kernel

    @property
    def functional(self) -> LinearFunctional:
        return self._functional

    @property
    def argnum(self) -> int:
        return self._argnum

    def evaluate(self, x):
        return evaluate_crosscov_contraction(self._kernel, self._functional, self._argnum, as_f64(x))

    def apply_operator(self, op):
        from ..transforms.dispatch import apply_operator_to_kernel

        proc_slot = 1 - self._argnum
        new_kernel = apply_operator_to_kernel(op, self._kernel, argnum=proc_slot)
        return KernelFunctionalCrossCov(new_kernel, self._functional, self._argnum)

    @functools.cached_property
    def _k2(self):
        """``(spec, discretization)`` of the K2 route of :meth:`matvec`, or
        ``None`` (see the module docstring)."""
        from ..gram import kernel_term_specs
        from ..transforms.dispatch import apply_operator_to_kernel

        kernel, functional = self._kernel, self._functional
        if self._argnum != 1 or kernel.output_shape_0 != () or kernel.output_shape_1 != ():
            return None
        if (
            isinstance(functional, CompositeLinearFunctional)
            and functional.linop is None
            and functional.linfuncop is not None
        ):
            kernel = apply_operator_to_kernel(functional.linfuncop, kernel, argnum=1)
            functional = functional.linfunctl
        if isinstance(functional, (ScaledLinearFunctional, SumLinearFunctional, CompositeLinearFunctional)):
            return None
        from ..transforms.integrals_exact import exact_integral_hooks, exact_projection_crosscov

        # An exact closed form is the crosscov itself: evaluate it.
        if (
            exact_integral_hooks(kernel, functional) is not None
            or exact_projection_crosscov(kernel, functional) is not None
        ):
            return None
        spec = kernel_term_specs(kernel)
        if spec is None:
            return None
        try:
            disc = functional.discretization()
        except NotImplementedError:
            return None
        return spec, disc

    @property
    def matvec_route(self) -> str:
        """``"K2"`` if :meth:`matvec` takes the Gram matvec, else
        ``"evaluate @ w"``."""
        return "evaluate @ w" if self._k2 is None else "K2"

    def matvec(self, x, w):
        """``kLa(x) @ w``: K2 at r = 1 where :attr:`matvec_route` says so."""
        from ..gram import gram_matvec

        plan = self._k2
        if plan is None:
            return super().matvec(x, w)
        spec, disc = plan
        x = as_f64(x)
        batch = tuple(x.shape[: x.ndim - self._kernel.input_ndim])
        v = w if disc.weights is None else disc.weights.T @ w
        pts = disc.points.reshape(disc.num_points, -1).to(x.device)
        out = gram_matvec(spec, x.reshape(size(batch), -1), pts, v, "f64")
        return out.reshape(batch + tuple(out.shape[1:]))


class ScaledProcessVectorCrossCovariance(ProcessVectorCrossCovariance):
    def __init__(self, crosscov: ProcessVectorCrossCovariance, scalar):
        if isinstance(crosscov, ScaledProcessVectorCrossCovariance):
            scalar = scalar * crosscov.scalar
            crosscov = crosscov.crosscov
        self.crosscov = crosscov
        self.scalar = float(scalar)
        super().__init__(
            crosscov.randproc_input_shape, crosscov.randproc_output_shape, crosscov.randvar_size, crosscov.reverse
        )

    def evaluate(self, x):
        return self.scalar * self.crosscov.evaluate(x)

    def apply_operator(self, op):
        return ScaledProcessVectorCrossCovariance(self.crosscov.apply_operator(op), self.scalar)

    def matvec(self, x, w):
        return self.scalar * self.crosscov.matvec(x, w)


class SumProcessVectorCrossCovariance(ProcessVectorCrossCovariance):
    def __init__(self, *summands: ProcessVectorCrossCovariance):
        flat = []
        for s in summands:
            if isinstance(s, SumProcessVectorCrossCovariance):
                flat.extend(s.summands)
            else:
                flat.append(s)
        self.summands = tuple(flat)
        first = flat[0]
        super().__init__(first.randproc_input_shape, first.randproc_output_shape, first.randvar_size, first.reverse)

    def evaluate(self, x):
        out = self.summands[0].evaluate(x)
        for s in self.summands[1:]:
            out = out + s.evaluate(x)
        return out

    def apply_operator(self, op):
        return SumProcessVectorCrossCovariance(*(s.apply_operator(op) for s in self.summands))

    def matvec(self, x, w):
        out = self.summands[0].matvec(x, w)
        for s in self.summands[1:]:
            out = out + s.matvec(x, w)
        return out


class LinOpProcessVectorCrossCovariance(ProcessVectorCrossCovariance):
    """``A @ crosscov``: a matrix applied to the randvar axis."""

    def __init__(self, linop, crosscov: ProcessVectorCrossCovariance):
        from ..linalg.linops import aslinop

        self.linop = aslinop(linop)
        self.crosscov = crosscov
        assert self.linop.shape[1] == crosscov.randvar_size
        super().__init__(
            crosscov.randproc_input_shape, crosscov.randproc_output_shape, self.linop.shape[0], crosscov.reverse
        )

    def evaluate(self, x):
        vals = self.crosscov.evaluate(x)  # ... + (m,)
        return vals @ self.linop.todense().T.to(vals)

    def apply_operator(self, op):
        return LinOpProcessVectorCrossCovariance(self.linop, self.crosscov.apply_operator(op))

    def matvec(self, x, w):
        return self.crosscov.matvec(x, self.linop.todense().T.to(w) @ w)


class ZeroProcessVectorCrossCovariance(ProcessVectorCrossCovariance):
    def evaluate(self, x):
        batch = tuple(x.shape[: x.ndim - self.randproc_input_ndim])
        return torch.zeros(batch + self.randproc_output_shape + (self.randvar_size,), dtype=x.dtype, device=x.device)

    def apply_operator(self, op):
        return ZeroProcessVectorCrossCovariance(
            op.output_domain_shape, op.output_codomain_shape, self.randvar_size, self.reverse
        )


class ConcatenatedCrossCovariance(ProcessVectorCrossCovariance):
    """Concatenation along the randvar axis: the ``kLas`` container of the
    conditioning engine."""

    def __init__(self, crosscovs):
        crosscovs = tuple(crosscovs)
        first = crosscovs[0]
        assert all(
            c.randproc_input_shape == first.randproc_input_shape
            and c.randproc_output_shape == first.randproc_output_shape
            for c in crosscovs
        )
        self.crosscovs = crosscovs
        super().__init__(
            first.randproc_input_shape,
            first.randproc_output_shape,
            sum(c.randvar_size for c in crosscovs),
            reverse=False,
        )

    def append(self, crosscov) -> "ConcatenatedCrossCovariance":
        return ConcatenatedCrossCovariance(self.crosscovs + (crosscov,))

    def __iter__(self):
        return iter(self.crosscovs)

    def evaluate(self, x):
        return torch.cat([c.evaluate(x) for c in self.crosscovs], dim=-1)

    def apply_operator(self, op):
        return ConcatenatedCrossCovariance(tuple(c.apply_operator(op) for c in self.crosscovs))

    def matvec(self, x, w):
        out = None
        offset = 0
        for c in self.crosscovs:
            term = c.matvec(x, w[offset:offset + c.randvar_size])
            offset += c.randvar_size
            out = term if out is None else out + term
        return out


# ---------------------------------------------------------------------------
# Contraction engine
# ---------------------------------------------------------------------------
def evaluate_crosscov_contraction(
    kernel: CovarianceFunction, functional: LinearFunctional, argnum: int, x: torch.Tensor
) -> torch.Tensor:
    """Evaluate ``L`` (on kernel slot ``argnum``) against free points ``x``:
    ``batch + proc_output_shape + (L.output_size,)``."""
    # Composite, scaled and sum functionals reduce recursively.
    if isinstance(functional, ScaledLinearFunctional):
        return functional.scalar * evaluate_crosscov_contraction(kernel, functional.linfunctl, argnum, x)
    if isinstance(functional, SumLinearFunctional):
        out = None
        for s in functional.summands:
            term = evaluate_crosscov_contraction(kernel, s, argnum, x)
            out = term if out is None else out + term
        return out
    if isinstance(functional, CompositeLinearFunctional):
        from ..transforms.dispatch import apply_operator_to_kernel

        k = kernel
        if functional.linfuncop is not None:
            k = apply_operator_to_kernel(functional.linfuncop, k, argnum=argnum)
        vals = evaluate_crosscov_contraction(k, functional.linfunctl, argnum, x)
        if functional.linop is not None:
            vals = vals @ functional.linop.todense().T.to(vals)
        return vals

    # The exact closed forms: the Lebesgue crosscov on an interval and the
    # hat-basis projection crosscov of a (scaled) 1-D half-integer Matérn.
    from ..transforms.integrals_exact import exact_integral_hooks, exact_projection_crosscov

    hook = exact_integral_hooks(kernel, functional)
    if hook is not None:
        return hook[0](x)[..., None]
    proj_fn = exact_projection_crosscov(kernel, functional)
    if proj_fn is not None:
        return proj_fn(x)

    from ..gram import gram_matrix, kernel_term_specs

    disc = functional.discretization()
    pts = disc.points.to(x.device)  # (nq,) + domain
    in_ndim = kernel.input_ndim
    batch_ndim = x.ndim - in_ndim
    batch = tuple(x.shape[:batch_ndim])

    # Scalar kernels with a spec: the contraction is a Gram (n, nq), by K1,
    # contracted with the weights a block of nodes at a time.
    if kernel.output_shape_0 == () and kernel.output_shape_1 == () and kernel_term_specs(kernel) is not None:
        x_flat = x.reshape((-1,) + kernel.input_shape)

        def gram_block(p):  # (n, nodes)
            return gram_matrix(kernel, x_flat, p, "f64") if argnum == 1 else gram_matrix(kernel, p, x_flat, "f64").T

        if disc.weights is None:
            G = gram_block(pts)
        else:
            W = disc.weights.to(x)
            G = None
            for b in _node_blocks(disc.num_points, x_flat.shape[0], x.device):
                term = gram_block(pts[b]) @ W[:, b].T
                G = term if G is None else G + term
        return G.reshape(batch + (G.shape[-1],))

    # Broadcast: the free points get a trailing singleton batch axis.
    xx = x[(Ellipsis, None) + (slice(None),) * in_ndim]
    vals = kernel._evaluate(xx, pts) if argnum == 1 else kernel._evaluate(pts, xx)
    # vals: batch + (nq,) + out0 + out1
    out0, out1 = kernel.output_shape_0, kernel.output_shape_1
    proc_out = out0 if argnum == 1 else out1
    func_out = out1 if argnum == 1 else out0
    return _contract_functional_axis(vals, batch_ndim, proc_out, func_out, argnum, disc)


def _contract_functional_axis(vals, batch_ndim, proc_out, func_out, argnum, disc):
    """Contract the ``(nq,) + func_out`` axes of a pairwise evaluation
    ``vals`` of layout ``batch + (nq,) + out0 + out1``, where the functional
    slot's codomain is ``func_out`` and the process slot's ``proc_out``."""
    nq = vals.shape[batch_ndim]
    p, f = len(proc_out), len(func_out)
    b = tuple(range(batch_ndim))
    if argnum == 1:  # layout: batch, nq, proc_out, func_out
        perm = b + tuple(range(batch_ndim + 1, batch_ndim + 1 + p)) + (batch_ndim,) + tuple(
            range(batch_ndim + 1 + p, batch_ndim + 1 + p + f)
        )
    else:  # layout: batch, nq, func_out, proc_out
        perm = b + tuple(range(batch_ndim + 1 + f, batch_ndim + 1 + f + p)) + (batch_ndim,) + tuple(
            range(batch_ndim + 1, batch_ndim + 1 + f)
        )
    vals = vals.permute(perm)  # batch + proc_out + (nq,) + func_out
    lead = tuple(vals.shape[: batch_ndim + p])
    func_size = size(func_out)
    if disc.weights is None:
        if func_out == () or not disc.codomain_first:
            return vals.reshape(lead + (nq * func_size,))  # (nq, func_out) C-order
        vals = torch.movedim(vals.reshape(lead + (nq, func_size)), -1, -2)  # codomain-first: (func_out, nq)
        return vals.reshape(lead + (func_size * nq,))
    return vals.reshape(lead + (nq * func_size,)) @ disc.weights.T.to(vals)


def apply_functional_to_crosscov(functional: LinearFunctional, crosscov: ProcessVectorCrossCovariance):
    """Contract a functional over the free process slot of a crosscov: the
    dense Gram block ``(functional.output_size, crosscov.randvar_size)`` as a
    ``Covariance`` view."""
    from ..linalg.covariance import Covariance

    if isinstance(functional, ScaledLinearFunctional):
        inner = apply_functional_to_crosscov(functional.linfunctl, crosscov)
        return Covariance(functional.scalar * inner.array, inner.shape0, inner.shape1)
    if isinstance(functional, SumLinearFunctional):
        total = None
        for s in functional.summands:
            term = apply_functional_to_crosscov(s, crosscov)
            total = term if total is None else Covariance(total.array + term.array, total.shape0, total.shape1)
        return total
    if isinstance(functional, CompositeLinearFunctional):
        cc = crosscov
        if functional.linfuncop is not None:
            cc = cc.apply_operator(functional.linfuncop)
        inner = apply_functional_to_crosscov(functional.linfunctl, cc)
        if functional.linop is not None:
            mat = functional.linop.todense().to(inner.matrix) @ inner.matrix
            return Covariance(mat, functional.output_shape, (crosscov.randvar_size,))
        return inner

    if isinstance(crosscov, KernelFunctionalCrossCov):
        from ..functionals.integrals import LebesgueIntegral
        from ..transforms.integrals_exact import exact_integral_hooks, exact_projection_gram

        # The exact double integral of matching Matérn integral pairs.
        if (
            isinstance(functional, LebesgueIntegral)
            and isinstance(crosscov.functional, LebesgueIntegral)
            and functional.domain == crosscov.functional.domain
        ):
            hook = exact_integral_hooks(crosscov.kernel, crosscov.functional)
            if hook is not None:
                gram = torch.tensor([[hook[1]]], dtype=torch.float64, device=resolve_device())
                return Covariance(gram, functional.output_shape, (1,))
        # The exact hat x hat double-projection Gram block.
        blk = exact_projection_gram(functional, crosscov)
        if blk is not None:
            return Covariance(blk, functional.output_shape, (crosscov.randvar_size,))

    disc = functional.discretization()
    m = crosscov.randvar_size
    nq = disc.num_points
    proc_size = size(crosscov.randproc_output_shape)
    if disc.weights is None:
        vals = crosscov.evaluate(disc.points)  # (nq,) + proc_out + (m,)
        codomain_first = getattr(functional, "codomain_first", True)
        if crosscov.randproc_output_shape == () or not codomain_first:
            block = vals.reshape(nq * proc_size, m)
        else:
            block = torch.movedim(vals.reshape(nq, proc_size, m), 1, 0).reshape(proc_size * nq, m)
    else:
        # sum_b W[:, b] @ vals(nodes[b]): the weights' columns run point-major.
        block = None
        for b in _node_blocks(nq, m * proc_size, disc.points.device):
            vals = crosscov.evaluate(disc.points[b]).reshape(-1, m)
            term = disc.weights[:, b.start * proc_size:b.stop * proc_size].to(vals) @ vals
            block = term if block is None else block + term
    return Covariance(block, functional.output_shape, (m,))
