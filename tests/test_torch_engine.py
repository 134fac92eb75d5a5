# -*- coding: utf-8 -*-
"""
The port's serving ``KernelEngine`` against the reference engine with
the same weights (``engine_state_from_jax`` of the reference engine's
arrays), slab and paged, float32 on the CPU: the reference runs its
portable step (``decode_impl='xla'``), the port its K5 / K5p plain
versions (``'kernel'``) and its append + attend step (``'plain'``).

Each step's next tokens and finite flags must be equal, and its logits —
read by applying each engine's own projection and head to the same
caches — within 1e-5 relative (float32 matmuls in two BLAS libraries,
exp vs exp2 softmax). Lengths, page tables, refcounts and cache stats
must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_dot_product_tpu.models import decode as jdec
from distributed_dot_product_tpu.serve import KernelEngine as JaxEngine
from distributed_dot_product_tpu_torch.convert import engine_state_from_jax
from distributed_dot_product_tpu_torch.models import decode as tdec
from distributed_dot_product_tpu_torch.serve import (
    KernelEngine, PageCorruptionError,
)

SLOTS, T_MAX, VOCAB, CHUNK, PS = 4, 64, 64, 4, 4


def _pair(mode, impl, heads=2, head_dim=8, **kw):
    paged = dict(cache_mode='paged', page_size=PS) if mode == 'paged' else {}
    shape = dict(slots=SLOTS, t_max=T_MAX, vocab=VOCAB, heads=heads,
                 head_dim=head_dim, prefill_chunk=CHUNK, seed=3)
    je = JaxEngine(decode_impl='xla', **shape, **paged, **kw)
    te = KernelEngine(decode_impl=impl, device='cpu', **shape, **paged, **kw)
    te.load_weights(engine_state_from_jax(
        {name: np.asarray(getattr(je, name))
         for name in ('_embed', '_wq', '_wk', '_wv', '_wo')}))
    return je, te


def _clone(cache):
    return type(cache)(*(x.clone() if isinstance(x, torch.Tensor)
                         else x if x is None else x.copy() for x in cache))


def _logits(je, te, tokens, active):
    """Both engines' logits for one step from their current caches (the
    step's own projection, fused step and head; the caches are left as
    they were)."""
    q, k, v = je._project(jnp.asarray(tokens, jnp.int32))
    _, out = jdec.decode_step(q, je.cache, k, v, slot_mask=jnp.asarray(active),
                              impl='xla')
    want = np.asarray(out.reshape(SLOTS, -1) @ je._wo)
    q, k, v = te._project(torch.as_tensor(tokens, dtype=torch.int64))
    _, out = tdec.decode_step(q, _clone(te.cache), k, v, slot_mask=active,
                              impl=te.decode_impl)
    return (out.reshape(SLOTS, -1) @ te._wo).numpy(), want


def _step_both(je, te, tokens, active, poison=None):
    active = np.asarray(active, bool)
    if te.cache_mode == 'paged':
        # Reserve the step's pages first so the logits read sees them.
        assert je.prepare_step(active).all() and te.prepare_step(active).all()
    got_l, want_l = _logits(je, te, tokens, active)
    np.testing.assert_allclose(got_l[active], want_l[active], rtol=1e-5,
                               atol=1e-5 * np.abs(want_l).max())
    want = je.step(tokens, active, poison)
    got = te.step(tokens, active, poison)
    np.testing.assert_array_equal(got[1], want[1])
    ok = active & want[1]
    np.testing.assert_array_equal(got[0][ok], want[0][ok])
    np.testing.assert_array_equal(te.lengths(), je.lengths())
    return np.where(active, got[0], tokens)


def _same_pool(je, te):
    if je.pool is None:
        return
    np.testing.assert_array_equal(te.pool.table, je.pool.table)
    np.testing.assert_array_equal(te.pool.refcount, je.pool.refcount)
    np.testing.assert_array_equal(te.pool.lengths, je.pool.lengths)
    np.testing.assert_array_equal(te.cache.page_table.numpy(),
                                  np.asarray(je.cache.page_table))
    assert te.cache_stats() == je.cache_stats()


@pytest.mark.parametrize('impl', ['kernel', 'plain'])
@pytest.mark.parametrize('mode', ['slab', 'paged'])
def test_engine_lifecycle_matches_jax(mode, impl):
    """prefill (chunked, padded) → steps with staggered activity → a
    poisoned step → reset and refill → steps again."""
    je, te = _pair(mode, impl)
    rng = np.random.default_rng(4)
    prompts = {0: rng.integers(0, VOCAB, 6), 2: rng.integers(0, VOCAB, 3)}
    for slot, p in prompts.items():
        for start in range(0, len(p) - 1, CHUNK):
            chunk = p[start:min(start + CHUNK, len(p) - 1)]
            je.prefill(slot, chunk)
            te.prefill(slot, chunk)
    np.testing.assert_array_equal(te.lengths(), je.lengths())
    tokens = np.zeros(SLOTS, np.int32)
    tokens[0], tokens[2] = prompts[0][-1], prompts[2][-1]
    for i in range(6):
        active = [True, False, i != 2, False]
        poison = [False, False, i == 4, False]
        tokens = _step_both(je, te, tokens, active, poison)
        _same_pool(je, te)
    for e in (je, te):
        e.reset(0)
        e.prefill(0, [5, 6, 7])
    _same_pool(je, te)
    tokens[0], tokens[1] = 9, 11
    for _ in range(4):
        tokens = _step_both(je, te, tokens, [True, True, True, False])
        _same_pool(je, te)
    assert te.cache_stats() == je.cache_stats()


@pytest.mark.parametrize('head_dim', [8, 32])
def test_prefix_and_fork_match_jax(head_dim):
    """register_prefix + start_with_prefix (a mid-page prefix: shared full
    page, private tail copy), then fork_slot mid-stream: tokens, page
    tables and refcounts equal; the fork's first divergent append copies
    the shared tail page on both sides."""
    je, te = _pair('paged', 'kernel', head_dim=head_dim)
    prefix = np.arange(6, dtype=np.int32) * 7 % VOCAB
    pid = je.register_prefix(prefix)
    assert te.register_prefix(prefix) == pid
    assert te.prefix_length(pid) == je.prefix_length(pid) == 6
    assert te.pinned_pages == je.pinned_pages == 2
    for e in (je, te):
        assert e.start_with_prefix(0, pid)
        e.prefill(0, [3, 4])
    _same_pool(je, te)
    tokens = np.array([9, 0, 0, 0], np.int32)
    for _ in range(3):
        tokens = _step_both(je, te, tokens, [True, False, False, False])
    for e in (je, te):
        assert e.fork_slot(0, 1)
    _same_pool(je, te)
    assert te.cache_stats()['shared_pages'] >= 1
    tokens[1] = tokens[0]
    for _ in range(4):
        tokens = _step_both(je, te, tokens, [True, True, False, False])
        _same_pool(je, te)
    for e in (je, te):
        e.reset(0)
        e.reset(1)
        e.unregister_prefix(pid)
    _same_pool(je, te)
    assert te.cache_stats()['pages_used'] == 0


def test_page_integrity_verdicts_match_jax():
    """A flipped bit on a registered prefix page: the scrub names it, the
    attach refuses it with PageCorruptionError, quarantine withdraws it."""
    je, te = _pair('paged', 'kernel')
    pid = je.register_prefix(np.arange(9, dtype=np.int32))
    te.register_prefix(np.arange(9, dtype=np.int32))
    assert te.verify_prefix(pid) == je.verify_prefix(pid) == []
    page = je._prefix_registry[pid][0][1]
    je.flip_page_bit(page)
    te.flip_page_bit(page)
    assert te.verify_pages() == je.verify_pages() == [page]
    with pytest.raises(PageCorruptionError, match='attach') as exc:
        te.start_with_prefix(0, pid)
    assert exc.value.pages == [page]
    assert te.quarantine_pages([page]) == je.quarantine_pages([page])
    assert te.verify_pages() == [] and te.cache_stats() == je.cache_stats()


def test_engine_surface_and_argument_checks():
    _, te = _pair('paged', 'kernel')
    assert te.capacity_tokens == T_MAX and te.free_pages == te.pool.pages
    assert te.weight_bytes == 4 * (3 * 16 * 16 + 16 * VOCAB)
    assert te.slot_pages(0) == 0
    with pytest.raises(ValueError, match='decode_impl'):
        KernelEngine(2, 8, decode_impl='xla', device='cpu')
    with pytest.raises(ValueError, match='cache_mode'):
        KernelEngine(2, 8, cache_mode='ring', device='cpu')
    with pytest.raises(ValueError, match='page_size'):
        KernelEngine(2, 12, cache_mode='paged', page_size=5, device='cpu')
    with pytest.raises(ValueError, match='prefill_chunk'):
        te.prefill(0, list(range(CHUNK + 1)))
    slab = KernelEngine(2, 8, device='cpu')
    assert slab.cache_stats()['pages'] == 0 and slab.pinned_pages == 0
    with pytest.raises(ValueError, match='paged'):
        slab.register_prefix([1, 2])
