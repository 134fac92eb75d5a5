# -*- coding: utf-8 -*-
"""
Owned dense layer (counterpart of
``distributed_dot_product_tpu/models/dense.py``, float path; the int8
weight path comes with a later slice).

``y = x · Wᵀ (+ b)`` with the weight in PyTorch's ``(out, in)`` layout —
the reference's flax ``kernel`` is ``(in, out)``, so a converted
checkpoint transposes it (see ``convert.py``). As in the reference,
``param_dtype`` (float32 by default) is the dtype parameters are stored
in and ``dtype`` the compute dtype: input, weight and bias are cast to
``dtype`` at each use (``None``: the promotion of the input's and the
parameters' dtypes), so training keeps float32 master weights under bf16
compute, and a model stored at ``param_dtype=dtype`` casts nothing. The
contract is float32 ACCUMULATION at the compute dtype: the product runs
through ``F.linear`` — cuBLAS computes bf16 GEMMs with a float32
accumulator, and a float32 layer is float32 throughout.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from distributed_dot_product_tpu_torch.utils.comm import resolve_device

__all__ = ['OwnedDense', 'default_generator']


def default_generator(generator=None):
    """The CPU ``torch.Generator`` parameters are drawn from: the given
    one, else a fresh one seeded 0 (so an unseeded model is still
    reproducible). Parameters are drawn on the CPU in float32 and then
    moved, so one seed gives the same weights on every device."""
    return generator if generator is not None else \
        torch.Generator().manual_seed(0)


class OwnedDense(nn.Module):
    """``y = x · Wᵀ (+ b)``; ``weight (features, in_features)``,
    ``bias (features,)``, stored at ``param_dtype``, computed at
    ``dtype``. Initialised like flax's ``lecun_normal`` (truncated
    normal, std ``1/√in_features`` after the truncation correction) with
    zero bias, drawn from ``generator``."""

    def __init__(self, in_features, features, use_bias=True, dtype=None,
                 param_dtype=torch.float32, device='cuda', generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.dtype = dtype
        std = math.sqrt(1.0 / in_features) / .87962566103423978
        w = torch.empty(features, in_features)
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=default_generator(generator))
        self.weight = nn.Parameter(w.to(device=dev, dtype=param_dtype))
        self.bias = (nn.Parameter(torch.zeros(features, device=dev,
                                              dtype=param_dtype))
                     if use_bias else None)

    def forward(self, x):
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)
