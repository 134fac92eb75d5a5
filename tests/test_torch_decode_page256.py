# -*- coding: utf-8 -*-
"""
The paged decode step at page 256, a page size the CUDA kernel takes as a
multiple of its 128-column chunk (a chunk covers half a page): K5p's plain
version (``flash_decode(page_table=...)`` on CPU tensors) against the
reference ``flash_decode(page_table=...)`` in Pallas interpret mode, which
splits at the page, on the same float32 inputs (numpy, seeded). A
scrambled table, mixed fill (mid-generation, empty, frozen, an append on
a page boundary, one on the second half of a page, the last column) and
``-1`` entries past each fill; one new row and verify k = 3. Outputs
within 1e-5 (float32, exp2 in another reduction order), pools bit for
bit on every page but the sink.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_dot_product_tpu.ops.pallas_decode import (
    flash_decode as jax_flash_decode,
)
from distributed_dot_product_tpu_torch.ops.flash_decode import flash_decode

TOL = dict(atol=1e-5, rtol=1e-5)
PS, PPS, D = 256, 2, 8


@pytest.mark.parametrize('k', [1, 3])
def test_page_256_matches_jax(k):
    rng = np.random.default_rng(256 + k)
    b, h, h_kv, pages = 6, 4, 2, 9
    fills = [300, 0, 140, 256, 128, 2 * PS - k]
    active = [True, False, False, True, True, True]
    perm = rng.permutation(pages).tolist()
    table = np.full((b, PPS), -1, np.int32)
    nxt = 0
    for i, (f, a) in enumerate(zip(fills, active)):
        n = -(-(f + (k if a else 0)) // PS)
        table[i, :n] = perm[nxt:nxt + n]
        nxt += n
    vt = np.array([f if a else f - k for f, a in zip(fills, active)],
                  np.int32)
    ap = np.array([f if a else -1 for f, a in zip(fills, active)], np.int32)
    q = rng.standard_normal((b, h, k, D), dtype=np.float32)
    kn = rng.standard_normal((b, h_kv, k, D), dtype=np.float32)
    vn = rng.standard_normal((b, h_kv, k, D), dtype=np.float32)
    kp = rng.standard_normal((pages + 1, h_kv, PS, D), dtype=np.float32)
    vp = rng.standard_normal((pages + 1, h_kv, PS, D), dtype=np.float32)
    want, wk, wv, _, _ = jax_flash_decode(
        *(jnp.asarray(x) for x in (q, kn, vn, kp, vp, vt, ap)),
        page_table=jnp.asarray(table), interpret=True)
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    got, _, _ = flash_decode(*(torch.from_numpy(x) for x in (q, kn, vn)),
                             tk, tv, torch.from_numpy(vt),
                             torch.from_numpy(ap),
                             page_table=torch.from_numpy(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(tk.numpy()[:-1], np.asarray(wk)[:-1])
    np.testing.assert_array_equal(tv.numpy()[:-1], np.asarray(wv)[:-1])
    assert not got[1].any()                         # the empty slot
