# -*- coding: utf-8 -*-
"""
Speculative decoding at the port's serving layer (``serve/spec.py``
proposers, the engine's ``verify_step`` / ``rollback``, the scheduler's
spec ticks) against the reference package.

- ``ngram_propose`` equals the reference's on seeded histories and on the
  reference's own cases (the full continuation preferred, the caps);
- the draft proposer's cache follows the committed stream, and
  ``make_draft_engine`` mirrors its target (plus the target's device and
  dtype, the port's one deliberate difference);
- the standing contract: a speculative stream is TOKEN FOR TOKEN the
  non-speculative stream (slab and paged, ngram and draft, both decode
  impls), and equal to the reference scheduler's spec streams on the
  same weights (``convert.engine_state_from_jax``);
- a mixed batch, ``max_new_tokens`` and ``eos``; a tick whose proposals
  were all dropped rolls the draft back; the ``serve.spec.*``
  histograms and the ``spec.*`` events agree; the stuck + NaN fault
  cocktail leaves the streams identical; ``DDP_TPU_SPEC`` and ``'off'``.
"""

import numpy as np
import pytest
import torch

from distributed_dot_product_tpu.serve import (
    KernelEngine as JaxEngine, Scheduler as JaxScheduler,
    ServeConfig as JaxConfig,
)
from distributed_dot_product_tpu.serve.spec import (
    ngram_propose as jax_ngram_propose,
)
from distributed_dot_product_tpu.utils.tracing import (
    MetricsRegistry as JaxRegistry,
)
from distributed_dot_product_tpu_torch.convert import engine_state_from_jax
from distributed_dot_product_tpu_torch.obs.events import (
    EventLog, validate_file,
)
from distributed_dot_product_tpu_torch.serve import (
    KernelEngine, Readiness, RejectedError, Scheduler, ServeConfig,
)
from distributed_dot_product_tpu_torch.serve.spec import (
    DraftEngineProposer, NgramProposer, make_draft_engine, ngram_propose,
)
from distributed_dot_product_tpu_torch.utils.faults import (
    ServeFaultInjector, ServeFaultPlan,
)
from distributed_dot_product_tpu_torch.utils.tracing import MetricsRegistry

VOCAB = 16
TERMINAL = {'completed', 'deadline_expired', 'evicted', 'abandoned',
            'failed_nan', 'rejected'}


# -- n-gram lookahead ----------------------------------------------------

def test_ngram_propose_matches_jax():
    """The reference's cases, then seeded histories (short vocabularies so
    suffixes recur) over k and max_ngram."""
    assert ngram_propose([1, 2, 3, 9, 8, 2, 3], 2) == [9, 8]
    assert ngram_propose([1, 2, 3, 4], 3) == []
    assert ngram_propose([5], 3) == []
    assert ngram_propose([1, 2, 1, 2], 0) == []
    # On a cyclic tail the most recent match truncates at the end of the
    # history: the full continuation wins.
    assert ngram_propose([7] * 10, 4) == [7, 7, 7, 7]
    assert ngram_propose([1, 2, 3, 4] * 4, 4) == [1, 2, 3, 4]
    rng = np.random.default_rng(0)
    for _ in range(300):
        h = rng.integers(0, int(rng.integers(2, 6)),
                         size=int(rng.integers(0, 30))).tolist()
        k, ng = int(rng.integers(0, 6)), int(rng.integers(1, 5))
        assert ngram_propose(h, k, ng) == jax_ngram_propose(h, k, ng), (
            h, k, ng)


def test_ngram_proposer_caps_to_budget():
    p = NgramProposer()
    out = p.propose_batch([(0, [7] * 10, 2), (1, [1, 2, 3, 4], 4)], 4)
    assert out == {0: [7, 7]}        # slot 1: nothing recurs
    with pytest.raises(ValueError):
        NgramProposer(max_ngram=0)


# -- the draft proposer ----------------------------------------------------

def _engine(**kw):
    base = dict(slots=2, t_max=64, vocab=VOCAB, heads=2, head_dim=4,
                prefill_chunk=4, seed=0, device='cpu')
    base.update(kw)
    return KernelEngine(**base)


def test_draft_proposer_cache_tracks_committed_stream():
    """Propose → commit → end_step leaves the draft cache holding exactly
    history[:-1] rows, bit for bit the rows a fresh twin prefilled with
    the committed history holds."""
    target = _engine()
    prop = DraftEngineProposer(make_draft_engine(target))
    hist = [3, 1, 4, 1, 5]
    prop.start(0, hist)
    assert int(prop.engine.lengths()[0]) == len(hist) - 1
    guesses = prop.propose_batch([(0, hist, 3)], 3).get(0, [])
    assert 1 <= len(guesses) <= 3
    committed = [guesses[0], 9]      # one guess accepted, two committed
    prop.commit(0, committed, 1)
    prop.end_step()
    hist = hist + committed
    n = len(hist) - 1
    assert int(prop.engine.lengths()[0]) == n
    twin = make_draft_engine(target)
    DraftEngineProposer(twin).start(0, hist)
    cache, ref = prop.engine.cache, twin.cache
    assert torch.equal(cache.k[0, :, :n], ref.k[0, :, :n])
    assert torch.equal(cache.v[0, :, :n], ref.v[0, :, :n])
    assert not cache.k[0, :, n:].any() and not cache.v[0, :, n:].any()
    # A slot it never drafted for must not roll anything back.
    prop.commit(1, [5], 0)
    prop.end_step()
    assert int(prop.engine.lengths()[1]) == 0
    prop.reset(0)
    assert int(prop.engine.lengths()[0]) == 0


def test_make_draft_engine_defaults_mirror_target():
    target = _engine(slots=3, t_max=32, seed=9, cache_mode='paged',
                     page_size=8, dtype=torch.bfloat16,
                     decode_impl='plain')
    draft = make_draft_engine(target)
    assert (draft.slots, draft.t_max, draft.vocab) == (3, 32, VOCAB)
    assert (draft.heads, draft.head_dim, draft.seed) == (2, 4, 9)
    assert (draft.prefill_chunk, draft.decode_impl) == (4, 'plain')
    assert draft.cache_mode == 'slab'     # the twin never pages
    # The port's one difference: the target's device and dtype.
    assert draft.device == target.device and draft.dtype == torch.bfloat16
    small = make_draft_engine(target, heads=1, head_dim=2, seed=5, vocab=8)
    assert (small.heads, small.head_dim, small.seed, small.vocab) == (
        1, 2, 5, 8)


# -- stream identity ---------------------------------------------------

def _mk_sched(spec, cache_mode, *, decode_impl='kernel', slots=3,
              t_max=64, max_new=12, spec_k=4, injector=None,
              event_log=None, seed=0):
    kw = {}
    if cache_mode == 'paged':
        kw.update(cache_mode='paged', page_size=8, pages=24)
    eng = _engine(slots=slots, t_max=t_max, seed=seed,
                  decode_impl=decode_impl, **kw)
    cfg = ServeConfig(queue_limit=16, max_new_tokens=max_new,
                      watchdog=False, evict_before_reject=False,
                      spec=spec, spec_k=spec_k)
    return Scheduler(eng, cfg, registry=MetricsRegistry(),
                     fault_injector=injector if injector else False,
                     event_log=event_log)


def _prompts(n_req=6, seed=7):
    rng = np.random.RandomState(seed)
    return [[int(x) for x in rng.randint(1, VOCAB, size=rng.randint(2, 12))]
            for _ in range(n_req)]


def _drive(sched, n_req=6, seed=7, interleave=False,
           rejected_error=RejectedError):
    rejected = {}
    for i, p in enumerate(_prompts(n_req, seed)):
        try:
            sched.submit(p, request_id=f'r{i}')
        except rejected_error as e:
            rejected[f'r{i}'] = e.reason.value
        if interleave and i % 3 == 2:
            sched.step()
    results = sched.run_until_idle()
    sched.close()
    return results, rejected


def _streams(results):
    return {rid: (r.status, list(r.tokens)) for rid, r in results.items()}


@pytest.mark.parametrize('decode_impl', ['kernel', 'plain'])
@pytest.mark.parametrize('cache_mode', ['slab', 'paged'])
@pytest.mark.parametrize('spec', ['ngram', 'draft'])
def test_spec_streams_token_identical(spec, cache_mode, decode_impl):
    """Every request's status and FULL token stream match the non-spec
    run exactly, in fewer decode ticks."""
    base_s = _mk_sched(None, cache_mode, decode_impl=decode_impl)
    base, _ = _drive(base_s)
    sched = _mk_sched(spec, cache_mode, decode_impl=decode_impl)
    got, _ = _drive(sched)
    assert _streams(got) == _streams(base)
    ticks = [s.registry.snapshot()['counters']['serve.decode_steps']
             for s in (base_s, sched)]
    assert ticks[1] < ticks[0], ticks


@pytest.mark.parametrize('cache_mode', ['slab', 'paged'])
@pytest.mark.parametrize('spec', ['ngram', 'draft'])
def test_spec_streams_equal_jax_scheduler(spec, cache_mode):
    """The port's spec streams equal the reference scheduler's spec
    streams on the same weights (and so the reference's non-spec ones)."""
    kw = dict(slots=3, t_max=64, vocab=VOCAB, heads=2, head_dim=4,
              prefill_chunk=4, seed=0)
    if cache_mode == 'paged':
        kw.update(cache_mode='paged', page_size=8, pages=24)
    je = JaxEngine(decode_impl='xla', **kw)
    te = KernelEngine(device='cpu', **kw)
    te.load_weights(engine_state_from_jax(
        {name: np.asarray(getattr(je, name))
         for name in ('_embed', '_wq', '_wk', '_wv', '_wo')}))
    cfg = dict(queue_limit=16, max_new_tokens=12, watchdog=False,
               evict_before_reject=False, spec=spec, spec_k=4)
    jsched = JaxScheduler(je, JaxConfig(**cfg), registry=JaxRegistry(),
                          fault_injector=False)
    tsched = Scheduler(te, ServeConfig(**cfg), registry=MetricsRegistry(),
                       fault_injector=False)
    if spec == 'draft':
        # The draft twins hold the same weights too (each package seeds
        # its own generator).
        tsched._proposer.engine.load_weights(engine_state_from_jax(
            {name: np.asarray(getattr(jsched._proposer.engine, name))
             for name in ('_embed', '_wq', '_wk', '_wv', '_wo')}))
    for i, p in enumerate(_prompts()):
        jsched.submit(p, request_id=f'r{i}')
        tsched.submit(p, request_id=f'r{i}')
    want = _streams(jsched.run_until_idle())
    jsched.close()
    got = _streams(tsched.run_until_idle())
    tsched.close()
    assert got == want


@pytest.mark.parametrize('page_size', [2, 4])
def test_verify_width_capped_at_the_engine_kernel_split(page_size):
    """spec_k = 4 asks for verify width 5; a paged engine's decode kernel
    takes at most a page of rows, so the scheduler caps the proposals at
    page_size - 1 and every verify tick fits the kernel (impl='kernel',
    which raises past the page) — streams still the non-spec ones. A
    slab engine's cap is the K split, min(128, t_max)."""
    assert _engine(t_max=64).max_verify_rows == 64
    assert _engine(t_max=256).max_verify_rows == 128
    runs = {}
    for spec in (None, 'ngram'):
        eng = _engine(slots=3, t_max=64, cache_mode='paged',
                      page_size=page_size, pages=96, decode_impl='kernel')
        assert eng.max_verify_rows == page_size
        widths = []
        inner = eng.verify_step

        def verify_step(tokens, *a, **kw):
            widths.append(np.shape(tokens)[1])
            return inner(tokens, *a, **kw)
        eng.verify_step = verify_step
        sched = Scheduler(eng, ServeConfig(
            queue_limit=16, max_new_tokens=12, watchdog=False,
            evict_before_reject=False, spec=spec, spec_k=4),
            registry=MetricsRegistry(), fault_injector=False)
        for i, p in enumerate(_prompts()):
            sched.submit([1, 2, 3] * 3 + p, request_id=f'r{i}')
        runs[spec] = _streams(sched.run_until_idle())
        sched.close()
        if spec:
            hist = sched.registry.snapshot()['histograms']
            assert widths and set(widths) == {page_size}
            assert hist['serve.spec.proposed_per_step']['max'] \
                == page_size - 1
    assert runs['ngram'] == runs[None]


def test_spec_mixed_batch_with_non_spec_slot():
    """A slot whose history never recurs rides the same verify tick with
    counts = 1 (no proposals); both streams still match their non-spec
    twins."""
    prompts = {'cyc': [1, 2, 3] * 3, 'rnd': [9, 4, 11, 2, 7]}
    runs = {}
    for spec in (None, 'ngram'):
        sched = _mk_sched(spec, 'slab', slots=2, max_new=16)
        for rid, p in prompts.items():
            sched.submit(p, request_id=rid)
        runs[spec] = _streams(sched.run_until_idle())
        sched.close()
    assert runs['ngram'] == runs[None]


def test_spec_respects_max_new_tokens_and_eos():
    """A verify commit never overshoots the token budget, and an EOS
    inside the accepted prefix truncates the commit exactly where the
    sequential stream stops."""
    base_s = _mk_sched(None, 'slab', slots=1, max_new=7)
    base_s.submit([1, 2, 3] * 3, request_id='r0')
    base = base_s.run_until_idle()
    base_s.close()
    eos = base['r0'].tokens[3]
    for eos_id in (None, eos):
        runs = {}
        for spec in (None, 'ngram'):
            sched = _mk_sched(spec, 'slab', slots=1, max_new=7)
            sched.cfg.eos_id = eos_id
            sched.submit([1, 2, 3] * 3, request_id='r0')
            runs[spec] = sched.run_until_idle()['r0']
            sched.close()
        assert runs['ngram'].tokens == runs[None].tokens
        assert runs['ngram'].status == runs[None].status
        assert len(runs['ngram'].tokens) <= 7
    assert runs['ngram'].tokens[-1] == eos     # stopped at the EOS


def test_plain_tick_after_dropped_proposals_rolls_back_draft():
    """A tick where the proposer drafted but EVERY proposal was dropped
    rides the plain one-token step, and the draft still gets its
    commit/end_step, so the rows it appended roll back: between ticks the
    draft cache of an active slot holds exactly prompt + produced - 1
    rows."""
    class DropAll(DraftEngineProposer):
        def propose_batch(self, requests, k):
            super().propose_batch(requests, k)   # the draft engine steps
            return {}                            # ...all guesses dropped

    target = _engine(t_max=24)
    prop = DropAll(make_draft_engine(target))
    synced = []

    def draft_in_sync(s):
        lens = np.asarray(prop.engine.lengths())
        for slot in s._slots:
            if slot.state.name == 'ACTIVE' and slot.request is not None:
                expected = len(slot.request.prompt) + slot.produced - 1
                assert lens[slot.index] == expected, (slot.index, lens)
                synced.append(slot.index)

    cfg = dict(queue_limit=8, max_new_tokens=12, watchdog=False)
    sched = Scheduler(target, ServeConfig(spec_k=3, **cfg),
                      registry=MetricsRegistry(), proposer=prop,
                      on_tick=draft_in_sync)
    base_s = Scheduler(_engine(t_max=24), ServeConfig(**cfg),
                       registry=MetricsRegistry())
    rng = np.random.RandomState(3)
    prompts = [[int(x) for x in rng.randint(1, VOCAB, size=5)]
               for _ in range(4)]
    for s in (sched, base_s):
        for i, p in enumerate(prompts):
            s.submit(p, request_id=f'r{i}')
    got = _streams(sched.run_until_idle())
    base = _streams(base_s.run_until_idle())
    sched.close()
    base_s.close()
    assert synced and got == base


def test_paged_exhaustion_drops_proposals_and_rolls_back_draft():
    """When the pool cannot hold a slot's verify width, ``_propose`` drops
    its proposals (the slot rides the tick as a plain decode, nobody is
    preempted for spec) and the draft is rolled back to the committed
    stream; the streams equal the non-spec run's. The exhaustion is
    simulated: every verify-width reservation fails."""
    def run(spec):
        eng = _engine(slots=2, cache_mode='paged', page_size=8, pages=16)
        sched = Scheduler(eng, ServeConfig(
            queue_limit=8, max_new_tokens=20, watchdog=False, spec=spec,
            spec_k=4), registry=MetricsRegistry())
        if spec is not None:
            propose, reserve = sched._propose, eng.reserve_rows
            state = {'in_propose': False, 'refused': 0}

            def refusing(slot, rows):
                if state['in_propose']:
                    state['refused'] += 1
                    return False
                return reserve(slot, rows)

            def proposing(lens):
                state['in_propose'] = True
                try:
                    return propose(lens)
                finally:
                    state['in_propose'] = False
            eng.reserve_rows, sched._propose = refusing, proposing
            sched.refused = state
        draft = getattr(sched._proposer, 'engine', None)
        in_sync = []

        def check(s):
            if draft is None:
                return
            lens = np.asarray(draft.lengths())
            for slot in s._slots:
                if slot.state.name == 'ACTIVE':
                    want = len(slot.request.prompt) + slot.produced - 1
                    assert lens[slot.index] == want
                    in_sync.append(slot.index)
        sched.on_tick = check
        for i, p in enumerate(([1, 2, 3] * 4 + [1], [4, 5] * 6 + [4])):
            sched.submit(p, request_id=f'r{i}')
        res = _streams(sched.run_until_idle())
        sched.close()
        return sched, res, in_sync

    base_s, base, _ = run(None)
    sched, got, in_sync = run('draft')
    assert got == base and in_sync
    assert sched.refused['refused'] > 0
    snap = sched.registry.snapshot()
    assert snap['counters'].get('serve.cache_preempted', 0) == 0
    assert sched.registry.histogram('serve.spec.proposed_per_step',
                                    buckets=()).summary()['count'] == 0


def test_spec_histograms_and_events_agree(tmp_path):
    """A repetitive prompt commits its 64 tokens in fewer than 32 ticks;
    the ``serve.spec`` histograms equal the reference scheduler's on the
    same weights; the ``spec.propose``/``spec.verify`` events validate and
    rebuild the accepted counts; the introspection names the proposer."""
    log = EventLog(tmp_path / 'spec.jsonl')
    # The reference test's engine and weights (seed 4), whose stream
    # repeats.
    eng = _engine(slots=1, t_max=256, head_dim=8)
    je = JaxEngine(slots=1, t_max=256, vocab=VOCAB, decode_impl='xla',
                   seed=4)
    eng.load_weights(engine_state_from_jax(
        {name: np.asarray(getattr(je, name))
         for name in ('_embed', '_wq', '_wk', '_wv', '_wo')}))
    sched = Scheduler(eng, ServeConfig(queue_limit=4, max_new_tokens=64,
                                       watchdog=False, spec='ngram',
                                       spec_k=4),
                      registry=MetricsRegistry(), event_log=log)
    assert sched.introspection()['proposer'] == 'NgramProposer'
    sched.submit([1, 2, 3, 1, 2, 3, 1, 2], request_id='r0')
    results = sched.run_until_idle()
    sched.close()
    log.close()
    assert len(results['r0'].tokens) == 64
    steps = sched.registry.snapshot()['counters']['serve.decode_steps']
    assert steps < 32, steps
    reg = sched.registry
    acc = reg.histogram('serve.spec.accepted_per_step', buckets=()).summary()
    prop = reg.histogram('serve.spec.proposed_per_step',
                         buckets=()).summary()
    assert acc['count'] > 0 and prop['count'] >= acc['count']
    jsched = JaxScheduler(je, JaxConfig(queue_limit=4, max_new_tokens=64,
                                        watchdog=False, spec='ngram',
                                        spec_k=4), registry=JaxRegistry())
    jsched.submit([1, 2, 3, 1, 2, 3, 1, 2], request_id='r0')
    assert jsched.run_until_idle()['r0'].tokens == results['r0'].tokens
    jsched.close()
    for name, mine in (('accepted', acc), ('proposed', prop)):
        want = jsched.registry.histogram(f'serve.spec.{name}_per_step',
                                         buckets=()).summary()
        assert mine == want, name
    records, errors = validate_file(log.path)
    assert not errors, errors[:3]
    verify = [r for r in records if r['event'] == 'spec.verify']
    proposed = [r for r in records if r['event'] == 'spec.propose']
    assert len(verify) == acc['count'] == len(proposed)
    assert sum(r['accepted'] for r in verify) == acc['total_sum']
    assert sum(r['proposed'] for r in proposed) == prop['total_sum']
    assert all(r['proposer'] == 'NgramProposer' for r in proposed)
    decodes = [r for r in records if r['event'] == 'serve.decode']
    assert len(decodes) == 64


@pytest.mark.parametrize('cache_mode,decode_impl',
                         [('slab', 'kernel'), ('slab', 'plain'),
                          ('paged', 'kernel'), ('paged', 'plain')])
def test_spec_soak_fault_cocktail_identical(cache_mode, decode_impl):
    """Stuck step + NaN slot against the same seeded burst, spec against
    non-spec: every completed request's stream is equal, every request
    terminal, readiness restored."""
    def run(spec):
        plan = ServeFaultPlan(stuck_at_step=2, stuck_seconds=0.2,
                              nan_at_step=4, nan_slot=1)
        sched = _mk_sched(spec, cache_mode, decode_impl=decode_impl,
                          max_new=4, t_max=32,
                          injector=ServeFaultInjector(plan))
        results, rejected = _drive(sched, n_req=10, interleave=True)
        return sched, results, rejected

    sched_a, base, rej_a = run(None)
    sched_b, got, rej_b = run('ngram')
    assert rej_a == rej_b
    assert set(base) == set(got)
    compared = 0
    for rid in base:
        assert base[rid].status in TERMINAL
        assert got[rid].status in TERMINAL
        if base[rid].status == got[rid].status == 'completed':
            assert got[rid].tokens == base[rid].tokens, rid
            compared += 1
    assert compared >= 4
    for s in (sched_a, sched_b):
        assert s.registry.snapshot()['counters'][
            'serve.nan_quarantined'] >= 1
        assert s.health.readiness in (Readiness.READY, Readiness.STOPPED)


@pytest.mark.parametrize('env,want', [('ngram', NgramProposer),
                                      ('draft', DraftEngineProposer),
                                      ('off', None), ('0', None)])
def test_spec_env_knob(monkeypatch, env, want):
    """``DDP_TPU_SPEC`` names the proposer when ``ServeConfig.spec`` is
    None; 'off'/'none'/'0' disable, and ``spec='off'`` wins over the
    knob; an unknown name raises."""
    monkeypatch.setenv('DDP_TPU_SPEC', env)
    sched = Scheduler(_engine(), ServeConfig(watchdog=False),
                      registry=MetricsRegistry())
    assert (sched._proposer is None if want is None
            else isinstance(sched._proposer, want))
    sched.close()
    sched = Scheduler(_engine(), ServeConfig(watchdog=False, spec='off'),
                      registry=MetricsRegistry())
    assert sched._proposer is None
    assert sched.introspection()['proposer'] is None
    sched.close()
    with pytest.raises(ValueError, match='spec must be'):
        Scheduler(_engine(), ServeConfig(watchdog=False, spec='bogus'),
                  registry=MetricsRegistry())
