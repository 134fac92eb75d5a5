# -*- coding: utf-8 -*-
"""
The decode kernel's in-kernel int8 quantization, on the CPU: a numpy twin
written in the kernel's order of operations (``quantize_row`` in
``csrc/flash_decode.cu``: per row ``s = max(max|x| / 127, 1e-20)`` in
float32 with a correctly rounded division, then ``x_i8 = rint(x / s)``,
round half to even, and for q the scale times ``scale * log2(e)`` in
float32) against the port's ``quantize_rows`` and the reference's
``_quantize_rows``, bit for bit, on rows built to catch the edges: .5
ties after the division, all-zero rows, subnormal inputs, the largest
bf16 values of both signs, and seeded unit-normal rows. (On the card,
``chip_smoke.py`` holds the kernel's quantized scores and mirror rows
against ``quantize_rows`` bit for bit.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_dot_product_tpu.ops.pallas_attention import (
    _quantize_rows as jax_quantize_rows,
)
from distributed_dot_product_tpu_torch.ops.flash_attention import (
    _LOG2E, quantize_rows,
)

D = 64


def _kernel_twin(x):
    """``(x_i8, s)`` as the kernel computes them from float32 rows (the
    bf16 inputs widened): every operation a float32 one."""
    x = x.astype(np.float32)
    amax = np.max(np.abs(x), axis=-1, keepdims=True)
    s = np.maximum(amax / np.float32(127.0), np.float32(1e-20))
    assert s.dtype == np.float32
    q = np.rint(x / s)
    return q.astype(np.int8), s


def _bf16(x):
    """Rounds float32 values to bf16 (the inputs the kernel reads)."""
    return torch.from_numpy(np.asarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _rows():
    rng = np.random.default_rng(7)
    rows = [rng.standard_normal((6, D)).astype(np.float32)]
    # .5 ties: with max|x| = 127 the scale is 1 and x / s = x; with max
    # 254 it is 2 and every odd integer halves to a tie.
    ties = np.zeros((3, D), np.float32)
    ties[0, :8] = [127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]
    ties[1, :8] = [254, 1, 3, 5, -1, -3, -5, 7]
    ties[2, :6] = [-127, 126.5, -126.5, 63.5, 0.5, -0.5]
    rows.append(ties)
    rows.append(np.zeros((2, D), np.float32))                # all zero
    tiny = np.zeros((2, D), np.float32)
    tiny[0, :4] = [1e-39, -2e-39, 3e-40, 1e-38]              # subnormals
    tiny[1, :3] = [1e-45, 5e-39, -1e-41]
    rows.append(tiny)
    big = np.full((2, D), 1.0, np.float32)
    big[0, 0] = 3.3895314e38                                 # bf16 max
    big[1, 0] = -3.3895314e38
    big[1, 1:5] = [1e38, -2e37, 7.0, -1e30]
    rows.append(big)
    return _bf16(np.concatenate(rows))


def test_kernel_order_equals_quantize_rows_bit_for_bit():
    x = _rows()
    want_q, want_s = quantize_rows(torch.from_numpy(x).to(torch.bfloat16))
    got_q, got_s = _kernel_twin(x)
    np.testing.assert_array_equal(got_q, want_q.numpy())
    np.testing.assert_array_equal(got_s.view(np.int32),
                                  want_s.numpy().view(np.int32))
    jq, js = jax_quantize_rows(jnp.asarray(x), 1, x.shape[0], D)
    np.testing.assert_array_equal(got_q, np.asarray(jq)[0])
    np.testing.assert_array_equal(got_s.view(np.int32),
                                  np.asarray(js)[0].view(np.int32))


def test_edges_land_where_the_kernel_puts_them():
    """The tie rows round half to even, zero rows stay zero at scale
    1e-20, and the largest values map to +-127."""
    q, s = _kernel_twin(_rows())
    assert list(q[6, :8]) == [127, 0, 2, 2, 0, -2, -2, 4]
    assert list(q[7, :8]) == [127, 0, 2, 2, 0, -2, -2, 4]
    assert not q[9:11].any() and (s[9:11] == np.float32(1e-20)).all()
    assert q[13, 0] == 127 and q[14, 0] == -127


@pytest.mark.parametrize('scale', [1 / 8.0, 1 / np.sqrt(96.0)])
def test_q_scale_is_one_float32_product(scale):
    """q's score scale: the row scale times ``scale * log2(e)`` rounded
    once to float32, as the plain version's tensor product does."""
    x = _rows()
    _, s = _kernel_twin(x)
    want = quantize_rows(torch.from_numpy(x))[1] * (scale * _LOG2E)
    got = s * np.float32(scale * _LOG2E)
    np.testing.assert_array_equal(got.view(np.int32),
                                  want.numpy().view(np.int32))
