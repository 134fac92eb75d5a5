# -*- coding: utf-8 -*-
"""
Differentiable distributed matmuls — the port of
``distributed_dot_product_tpu/ops/ops.py``: three
``torch.autograd.Function``s whose backward is expressed in terms of the
other two products, with the reference's VJP pairings:

- ``RightTransposeMultiplication`` (``matmul_nt``): ``out = A·Bᵀ``;
  ``dA = all(dOut, B)``, ``dB = tn(dOut, A)``;
- ``FullMultiplication`` (``matmul_all``): ``out = A·B``;
  ``dA = nt(dOut, B)``, ``dB = tn(A, dOut)``;
- ``LeftTransposeMultiplication`` (``matmul_tn``): ``out = Aᵀ·B``;
  ``dA = nt(B, dOut)`` (the reference package's corrected operand order;
  the original computed ``nt(dOut, B)``), ``dB = all(A, dOut)``.

``offset`` applies to the forward as well as the backward (the reference
package's fix: the original dropped it on the forward). ``offset``,
``group`` and ``impl`` are configuration, not differentiable; the
``.apply(left, right, offset, group, impl)`` call reads like the
reference's ``.apply(left, right, offset)``.
"""

import torch

from distributed_dot_product_tpu_torch.ops.functions import (
    distributed_matmul_all, distributed_matmul_nt, distributed_matmul_tn,
)

__all__ = [
    'matmul_nt', 'matmul_all', 'matmul_tn',
    'RightTransposeMultiplication', 'FullMultiplication',
    'LeftTransposeMultiplication',
]


class RightTransposeMultiplication(torch.autograd.Function):
    """``A·Bᵀ`` on sequence shards ``(*, T/N, D)`` → ``(*, T/N, T)``."""

    @staticmethod
    def forward(ctx, left, right, offset=32, group=None, impl='allgather'):
        ctx.save_for_backward(left, right)
        ctx.cfg = (offset, group, impl)
        return distributed_matmul_nt(left, right, offset, group=group,
                                     impl=impl)

    @staticmethod
    def backward(ctx, g):
        left, right = ctx.saved_tensors
        offset, group, impl = ctx.cfg
        # out = L·Rᵀ  ⇒  dL = dOut·R,  dR = dOutᵀ·L.
        grad_left = distributed_matmul_all(g, right, offset, group=group,
                                           impl=impl)
        grad_right = distributed_matmul_tn(g, left, group=group)
        return grad_left, grad_right, None, None, None


class FullMultiplication(torch.autograd.Function):
    """``A·B`` on sequence shards ``(*, T/N, T) × (*, T/N, D)`` →
    ``(*, T/N, D)``."""

    @staticmethod
    def forward(ctx, left, right, offset=32, group=None, impl='allgather'):
        ctx.save_for_backward(left, right)
        ctx.cfg = (offset, group, impl)
        return distributed_matmul_all(left, right, offset, group=group,
                                      impl=impl)

    @staticmethod
    def backward(ctx, g):
        left, right = ctx.saved_tensors
        offset, group, impl = ctx.cfg
        # out = L·R  ⇒  dL = dOut·Rᵀ,  dR = Lᵀ·dOut.
        grad_left = distributed_matmul_nt(g, right, offset, group=group,
                                          impl=impl)
        grad_right = distributed_matmul_tn(left, g, group=group)
        return grad_left, grad_right, None, None, None


class LeftTransposeMultiplication(torch.autograd.Function):
    """``Aᵀ·B`` on sequence shards ``(*, T/N, T) × (*, T/N, D)`` →
    ``(*, T/N, D)``; ``offset`` and ``impl`` configure the backward's nt
    and all products (the forward is one reduce-scatter)."""

    @staticmethod
    def forward(ctx, left, right, offset=32, group=None, impl='allgather'):
        ctx.save_for_backward(left, right)
        ctx.cfg = (offset, group, impl)
        return distributed_matmul_tn(left, right, group=group)

    @staticmethod
    def backward(ctx, g):
        left, right = ctx.saved_tensors
        offset, group, impl = ctx.cfg
        # out = Lᵀ·R  ⇒  dL = R·dOutᵀ = nt(R, dOut),  dR = L·dOut.
        grad_left = distributed_matmul_nt(right, g, offset, group=group,
                                          impl=impl)
        grad_right = distributed_matmul_all(left, g, offset, group=group,
                                            impl=impl)
        return grad_left, grad_right, None, None, None


def matmul_nt(left, right, offset=32, group=None, impl='allgather'):
    """Differentiable ``A·Bᵀ`` on sequence shards."""
    return RightTransposeMultiplication.apply(left, right, offset, group,
                                              impl)


def matmul_all(left, right, offset=32, group=None, impl='allgather'):
    """Differentiable ``A·B`` on sequence shards."""
    return FullMultiplication.apply(left, right, offset, group, impl)


def matmul_tn(left, right, offset=32, group=None, impl='allgather'):
    """Differentiable ``Aᵀ·B`` on sequence shards."""
    return LeftTransposeMultiplication.apply(left, right, offset, group,
                                             impl)
