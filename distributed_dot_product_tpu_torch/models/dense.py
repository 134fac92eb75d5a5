# -*- coding: utf-8 -*-
"""
Owned dense layer — the port of
``distributed_dot_product_tpu/models/dense.py``: ``OwnedDense`` (float
and int8 weights), ``quantized_dot``, ``quantize_kernel``,
``quantize_dense_params`` and ``dense_param_bytes``.

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

int8 weights (``weight_quant='int8'``), the reference's rule bit for bit:
the weight is stored ``weight_q (out, in) int8`` with one float32 scale
per output channel, ``weight_scale (out,)`` (``w ≈ w_q · s_out``,
:func:`quantize_kernel`); each activation row is quantized on the fly
(symmetric, scale ``max(max|x|/127, 1e-20)``, round half to even), the
product runs s8 × s8 → s32, and the s32 result is dequantized as
``(float(y) · s_x) · s_w``. :func:`quantized_dot` is that one body; the
module and the serving engine both call it. On the card the product is
``torch._int_mm`` (cuBLASLt's s8 GEMM, the counterpart of the reference's
``lax.dot_general`` outside any Pallas kernel); on the CPU the same
integer product in int32. The int8 path is an inference path: the int8
tensors are buffers, not parameters, and nothing trains them.
"""

import math

import torch
import torch.nn.functional as F
from torch import nn

from distributed_dot_product_tpu_torch.utils.comm import resolve_device

__all__ = ['OwnedDense', 'default_generator', 'dense_param_bytes',
           'quantize_dense_params', 'quantize_kernel', 'quantized_dot']

# Per-row activation scales share the kernels' eps clamp, so all-zero rows
# stay finite (and quantize to zeros).
_EPS = 1e-20
# torch._int_mm's shape rule on the card (torch 2.11, CUDA 12.8, H100):
# more than 16 rows, and the inner and output widths multiples of 8 (a
# shape outside it raises). The row count is met by padding with zero
# rows, which quantize to zero and are dropped after the product; the
# widths are the model's. The weight goes in as ``weight_q.t()``, a
# column-major (in, out) view, which cuBLASLt takes without a copy.
_INT_MM_MIN_ROWS = 17


def default_generator(generator=None):
    """The CPU ``torch.Generator`` parameters are drawn from: the given
    one, else a fresh one seeded 0 (so an unseeded model is still
    reproducible). Parameters are drawn on the CPU in float32 and then
    moved, so one seed gives the same weights on every device."""
    return generator if generator is not None else \
        torch.Generator().manual_seed(0)


def _int_product(xi, w_q):
    """``xi (rows, in) int8 · w_q (out, in)ᵀ int8 → (rows, out) int32``:
    ``torch._int_mm`` on the card (rows padded up to its minimum with zero
    rows, dropped after), the int32 product on the CPU."""
    if xi.device.type != 'cuda':
        return torch.matmul(xi.to(torch.int32), w_q.to(torch.int32).t())
    rows = xi.shape[0]
    if rows < _INT_MM_MIN_ROWS:
        xi = F.pad(xi, (0, 0, 0, _INT_MM_MIN_ROWS - rows))
    return torch._int_mm(xi, w_q.t())[:rows]


def quantized_dot(x, w_q, w_s):
    """``x (..., in) · (w_q (out, in) int8 · w_s (out,))ᵀ`` — THE int8
    weight product, shared by :class:`OwnedDense` and the serving engine:
    the activation rows quantize symmetrically on the fly (per-row absmax
    scale, eps-clamped, round half to even), the product runs s8 × s8 →
    s32, and both scales dequantize the s32 result,
    ``(float(y) · s_x) · w_s``. Returns float32 (callers cast back)."""
    x32 = x.float()
    sx = torch.clamp_min(x32.abs().amax(dim=-1, keepdim=True) / 127.0, _EPS)
    xi = torch.round(x32 / sx).to(torch.int8)
    lead = xi.shape[:-1]
    y = _int_product(xi.reshape(-1, xi.shape[-1]), w_q)
    y = y.reshape(*lead, w_q.shape[0]).float()
    return y * sx * w_s


def quantize_kernel(weight):
    """Per-OUTPUT-channel symmetric int8 quantization of a ``(out, in)``
    weight: ``(weight_q int8 (out, in), weight_scale float32 (out,))`` with
    ``scale_j = max(max|W[j, :]| / 127, 1e-20)``. Leading axes pass through
    (a layer-stacked ``(L, out, in)`` weight quantizes each layer's
    channels on their own). The reference's ``quantize_kernel`` on its
    ``(in, out)`` kernel, transposed."""
    w32 = torch.as_tensor(weight).float()
    scale = torch.clamp_min(w32.abs().amax(dim=-1) / 127.0, _EPS)
    w_q = torch.round(w32 / scale[..., None]).to(torch.int8)
    return w_q, scale


class OwnedDense(nn.Module):
    """``y = x · Wᵀ (+ b)``; ``bias (features,)``, stored at
    ``param_dtype``, computed at ``dtype``.

    - ``weight_quant=None``: ``weight (features, in_features)``
      initialised like flax's ``lecun_normal`` (truncated normal, std
      ``1/√in_features`` after the truncation correction) with zero bias,
      drawn from ``generator``.
    - ``weight_quant='int8'``: buffers ``weight_q (features, in_features)
      int8`` and ``weight_scale (features,) float32`` (the same float draw
      quantized by :func:`quantize_kernel`, so one seed gives the float
      model and its int8 twin; load real values with
      :func:`quantize_dense_params`). ``weight_scale`` stays float32 under
      a dtype cast of the module. Inference only: the int8 buffers are not
      trained.
    """

    def __init__(self, in_features, features, use_bias=True, dtype=None,
                 param_dtype=torch.float32, weight_quant=None, device='cuda',
                 generator=None):
        super().__init__()
        if weight_quant not in (None, 'int8'):
            raise ValueError(f"weight_quant must be None or 'int8', "
                             f'got {weight_quant!r}')
        dev = resolve_device(device)
        self.dtype = dtype
        self.param_dtype = param_dtype
        self.weight_quant = weight_quant
        std = math.sqrt(1.0 / in_features) / .87962566103423978
        w = torch.empty(features, in_features)
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=default_generator(generator))
        if weight_quant == 'int8':
            self.weight = None
            w_q, w_s = quantize_kernel(w)
            self.register_buffer('weight_q', w_q.to(dev))
            self.register_buffer('weight_scale', w_s.to(dev))
        else:
            self.weight = nn.Parameter(w.to(device=dev, dtype=param_dtype))
        self.bias = (nn.Parameter(torch.zeros(features, device=dev,
                                              dtype=param_dtype))
                     if use_bias else None)

    @property
    def device(self):
        return (self.weight_q if self.weight is None else self.weight).device

    def _apply(self, fn, recurse=True):
        # A dtype cast of the module must not round the scales: they move
        # with the module's device and stay float32.
        scale = self._buffers.get('weight_scale')
        out = super()._apply(fn, recurse)
        if scale is not None:
            self._buffers['weight_scale'] = scale.to(
                self._buffers['weight_scale'].device)
        return out

    def forward(self, x):
        if self.weight_quant == 'int8':
            out = self.dtype or torch.promote_types(x.dtype,
                                                    self.param_dtype)
            y = quantized_dot(x, self.weight_q, self.weight_scale)
            if self.bias is not None:
                y = y + self.bias.float()
            return y.to(out)
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


def quantize_dense_params(params):
    """The int8-weight state dict of a float model: every
    :class:`OwnedDense` weight ``<name>.weight`` becomes
    ``<name>.weight_q`` and ``<name>.weight_scale`` (:func:`quantize_kernel`,
    per output channel; a layer-stacked weight per layer); biases,
    LayerNorm ``scale``/``bias``, the ``embedding`` table, the untied head
    ``lm_head_kernel`` and every other entry pass through. ``params`` is a
    module (its ``OwnedDense`` layers are found by type) or a state dict
    (the reference's key rule, on the port's names: every entry named
    ``weight`` with two or more axes — the port names no other tensor
    so). Load the result into the ``weight_quant='int8'`` twin with
    ``load_state_dict``."""
    if isinstance(params, nn.Module):
        dense = {f'{name}.weight' if name else 'weight'
                 for name, m in params.named_modules()
                 if isinstance(m, OwnedDense) and m.weight is not None}
        params = params.state_dict()
    else:
        dense = {k for k, v in params.items()
                 if k.rsplit('.', 1)[-1] == 'weight'
                 and getattr(v, 'ndim', 0) >= 2}
    out = {}
    for key, value in params.items():
        if key in dense:
            stem = key[:-len('weight')]
            out[stem + 'weight_q'], out[stem + 'weight_scale'] = \
                quantize_kernel(value)
        else:
            out[key] = value
    return out


def dense_param_bytes(params):
    """Total bytes of every tensor in ``params`` — a module (its state
    dict), a mapping, or a (nested) list or tuple of tensors: the
    weights-streamed-per-step column of the quantized-vs-float twins."""
    if isinstance(params, nn.Module):
        params = params.state_dict()
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    if isinstance(params, dict):
        params = list(params.values())
    if isinstance(params, (list, tuple)):
        return sum(dense_param_bytes(p) for p in params)
    return 0
