# -*- coding: utf-8 -*-
"""
The multi-rank prefill split of the port (``serve/replica.py``
``PrefillPool`` over an N-rank mesh) against the reference package,
float32 on the CPU, the ranks a gloo group:

- ``_bucket`` is the reference's rule for every prompt length 1..200 at
  1, 2, 4 and 8 shards;
- at 2 and 4 ranks every rank's pages are bit for bit the one-rank
  pool's and the engine's own ``register_prefix`` of the same tokens,
  and within 1e-5 of the reference pool's (its default 8-device mesh):
  prompts of one row, a tail page, a page boundary and three pages
  (buckets smaller than, equal to and larger than the projection chunk);
- a 1x1 ``ReplicaPool`` whose prefill pool spans 2 ranks: the stream
  decoded after the adoption equals a flat prefill's, on every rank.
"""

import types

import numpy as np
import pytest
import torch

from distributed_dot_product_tpu.serve import PrefillPool as JPrefillPool
from distributed_dot_product_tpu_torch.convert import engine_state_from_jax
from distributed_dot_product_tpu_torch.serve import (
    KernelEngine, PrefillPool, Scheduler, ServeConfig, VirtualClock,
)
from distributed_dot_product_tpu_torch.serve.replica import (
    PrefillPool as _PortPool,
)
from distributed_dot_product_tpu_torch.utils.tracing import MetricsRegistry

from torch_dist import GlooGroup
from torch_serving import cyclic_gc_paused  # noqa: E402,F401  autouse

VOCAB = 32
# K/V pages against the reference: float32 GEMMs of two libraries round
# differently, so the pages agree to 1e-5 of the page's largest value
# (test_torch_handoff.py's tolerance).
REL = 1e-5
LENGTHS = (1, 19, 32, 47)


@pytest.fixture(autouse=True)
def _no_retrace_sentinel(monkeypatch):
    monkeypatch.setenv('DDP_TPU_RETRACE_SENTINEL', '0')


@pytest.fixture(scope='module')
def ref():
    """One reference prefill pool (8 shards); its weights are every
    engine's."""
    pool = JPrefillPool(t_max=64, page_size=16, vocab=VOCAB, seed=3)
    state = engine_state_from_jax({
        n: np.asarray(getattr(pool.engine, n))
        for n in ('_embed', '_wq', '_wk', '_wv', '_wo')})
    return pool, {k: np.asarray(v) for k, v in state.items()}


@pytest.fixture(scope='module')
def groups(tmp_path_factory):
    made = {}

    def get(world):
        if world not in made:
            made[world] = GlooGroup(
                world, str(tmp_path_factory.mktemp(f'gloo{world}') / 'store'))
        return made[world]
    yield get
    for g in made.values():
        g.close()


def _prompt(length, salt=0):
    return (((np.arange(length) * 5 + salt) % (VOCAB - 1)) + 1) \
        .astype(np.int32)


def _engine(state):
    eng = KernelEngine(slots=2, t_max=64, vocab=VOCAB, seed=3,
                       cache_mode='paged', page_size=16, decode_impl='kernel',
                       device='cpu')
    eng.load_weights(state)
    return eng


@pytest.mark.parametrize('shards', [1, 2, 4, 8])
def test_bucket_is_the_references(shards):
    port = types.SimpleNamespace(n_shards=shards)
    for n in range(1, 201):
        want = JPrefillPool._bucket(port, n)
        assert _PortPool._bucket(port, n) == want
        assert want % shards == 0 and want >= n


@pytest.mark.parametrize('world', [2, 4])
def test_split_pages_bit_for_bit_and_match_jax(ref, groups, world):
    jpool, state = ref
    prompts = [_prompt(n) for n in LENGTHS]
    ranks = groups(world).run('prefill_split', state, prompts)
    one = PrefillPool(t_max=64, page_size=16, vocab=VOCAB, seed=3,
                      device='cpu')
    one.engine.load_weights(state)
    for i, tokens in enumerate(prompts):
        h = one.build(tokens)
        k1 = one.engine.cache.k_pool[h.pages].numpy()
        v1 = one.engine.cache.v_pool[h.pages].numpy()
        one.release(h)
        eng = _engine(state)
        pages, _ = eng._prefix_registry[eng.register_prefix(tokens)]
        kr = eng.cache.k_pool[pages].numpy()
        vr = eng.cache.v_pool[pages].numpy()
        jh = jpool.build(tokens)
        jk = np.asarray(jpool.engine.cache.k_pool)[jh.pages]
        jv = np.asarray(jpool.engine.cache.v_pool)[jh.pages]
        jpool.release(jh)
        for n_shards, bucket, k, v in (r[i] for r in ranks):
            assert n_shards == world
            assert bucket == JPrefillPool._bucket(
                types.SimpleNamespace(n_shards=world), len(tokens))
            assert np.array_equal(k, k1) and np.array_equal(v, v1)
            assert np.array_equal(k, kr) and np.array_equal(v, vr)
            for got, want in ((k, jk), (v, jv)):
                err = np.abs(got - want).max()
                assert err <= REL * max(np.abs(want).max(), 1e-30), err


def test_replica_pool_on_a_two_rank_mesh_streams_equal(ref, groups):
    _, state = ref
    prompt = list(_prompt(37, 2))
    ranks = groups(2).run('replica_pool_split', state, prompt, 8)
    flat = _engine(state)
    with Scheduler(flat, ServeConfig(watchdog=False, max_new_tokens=8),
                   clock=VirtualClock(), registry=MetricsRegistry(),
                   fault_injector=False) as s:
        r = s.submit(prompt, max_new_tokens=8)
        want = s.run_until_idle()[r.id].tokens
    assert len(want) == 8
    for n_shards, tokens in ranks:
        assert n_shards == 2 and tokens == list(want)


def test_multi_rank_pool_refuses_a_2d_mesh():
    from distributed_dot_product_tpu_torch.parallel.mesh import Mesh
    with pytest.raises(ValueError, match='1-D seq mesh'):
        PrefillPool(t_max=64, page_size=16, vocab=VOCAB, device='cpu',
                    mesh=Mesh(None, 0, 2, data_size=2))
    assert torch.get_num_threads() >= 1
