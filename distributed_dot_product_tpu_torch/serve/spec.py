# -*- coding: utf-8 -*-
"""
Token proposers for speculative (draft-verify) decoding — the port of
``distributed_dot_product_tpu/serve/spec.py``: the "guess k tokens" half
of the scheme whose "check them in one step" half is the engine's fused
verify-k step (:meth:`~.engine.KernelEngine.verify_step`).

Draft-verify decoding (Leviathan et al., "Fast Inference from
Transformers via Speculative Decoding"): a cheap proposer guesses k
continuation tokens, the target model scores all k+1 positions in ONE
verify step, and the longest prefix of guesses matching the target's own
(greedy) choices is committed — plus the one "free" token the verify step
computes after it. Greedy verification makes the scheme EXACT: the
committed stream is token for token the non-speculative stream whatever
the proposer emits; a bad proposer only costs wasted verify width, never
correctness. The scheduler treats proposers as untrusted accelerators —
mixed spec/non-spec batches ride the same verify step with per-slot
counts.

Two proposers ship:

- :class:`NgramProposer` — self-drafting n-gram lookahead (prompt-lookup
  decoding): find the longest recent suffix of the slot's token history
  (prompt + emitted) that occurred earlier, and propose the tokens that
  followed it. No model, no state, no device work.
- :class:`DraftEngineProposer` — a small draft model with its OWN
  per-slot KV cache and acceptance-prefix rollback, stepped k times to
  propose and rolled back to the committed prefix after each verify.
  :func:`make_draft_engine` builds the default twin.
"""

import numpy as np

__all__ = ['Proposer', 'NgramProposer', 'DraftEngineProposer',
           'make_draft_engine', 'ngram_propose']


def ngram_propose(history, k, max_ngram=3):
    """Suffix-match lookahead over ``history`` (a 1-D int sequence): find
    the LONGEST suffix of length ``<= max_ngram`` that occurred earlier in
    the history and return up to ``k`` of the tokens that followed it.
    Among matches of one length, the most recent with a FULL ``k``-token
    continuation wins, falling back to the longest continuation found (a
    match near the end of the history would otherwise truncate the guess
    to a token or two). Returns ``[]`` when no suffix recurs (the slot
    then rides the tick as a plain decode). Pure host work."""
    h = np.asarray(history, np.int64)
    n = len(h)
    if k < 1 or n < 2:
        return []
    for length in range(min(max_ngram, n - 1), 0, -1):
        pattern = h[n - length:]
        # Start positions of an EARLIER occurrence (the suffix itself,
        # ending at n, is excluded).
        starts = np.flatnonzero(h[:n - length] == pattern[0])
        best = None
        for s in starts[::-1]:                  # most recent first
            if s + length > n - 1:
                continue
            if np.array_equal(h[s:s + length], pattern):
                cont = h[s + length:s + length + k]
                if len(cont) == k:
                    return [int(t) for t in cont]
                if best is None or len(cont) > len(best):
                    best = cont
        if best is not None and len(best):
            return [int(t) for t in best]
    return []


class Proposer:
    """Interface the scheduler drives. All hooks default to no-ops so a
    stateless proposer only implements :meth:`propose_batch`.

    Lifecycle per slot: :meth:`start` when a request begins decoding in a
    slot (full prompt known — requeues restart here too), then per verify
    tick :meth:`propose_batch` → (scheduler verifies) → :meth:`commit`
    per slot → :meth:`end_step` once; :meth:`reset` when the slot frees
    (retire/evict/quarantine/preempt)."""

    def start(self, slot, history):
        """``history``: the full committed token list (prompt + emitted so
        far — nonempty; its last token is the slot's next input)."""

    def propose_batch(self, requests, k):
        """``requests``: list of ``(slot, history, cap)`` with ``cap <= k``
        the most tokens that slot can use this tick. Returns ``{slot:
        [token, ...]}`` with each list at most ``cap`` long (missing/empty
        = no proposal — the slot decodes normally)."""
        raise NotImplementedError

    def commit(self, slot, committed, accepted):
        """``committed``: tokens just appended to the stream (the accepted
        proposals plus the free token); ``accepted``: how many PROPOSALS
        survived (``len(committed) - 1`` unless the stream hit a terminal
        condition mid-commit)."""

    def end_step(self):
        """Called once after all :meth:`commit` calls of a tick."""

    def reset(self, slot):
        """The slot was freed (or its request requeued)."""


class NgramProposer(Proposer):
    """Self-drafting n-gram lookahead (:func:`ngram_propose` per slot).
    Stateless — the history arrives with every propose call, so requeues,
    forks and slot reuse need no bookkeeping."""

    def __init__(self, max_ngram=3):
        if max_ngram < 1:
            raise ValueError(f'max_ngram must be >= 1, got {max_ngram}')
        self.max_ngram = max_ngram

    def propose_batch(self, requests, k):
        out = {}
        for slot, history, cap in requests:
            props = ngram_propose(history, min(cap, k), self.max_ngram)
            if props:
                out[slot] = props
        return out


def make_draft_engine(target, *, heads=None, head_dim=None, seed=None,
                      vocab=None):
    """The default draft twin of a target
    :class:`~distributed_dot_product_tpu_torch.serve.engine.KernelEngine`:
    same slots/t_max/vocab (the draft cache mirrors the target's per-slot
    clocks; proposals must be target-vocabulary tokens), a slab cache (the
    draft never shares prefixes), and — by default — the target's own
    shape and seed, i.e. a self-draft that accepts everything (a real
    deployment passes a smaller ``heads``/``head_dim`` or another seed).

    The one deliberate difference from the reference: the twin takes the
    target's ``device`` and ``dtype``. The reference passes neither, so
    its twin takes the engine's float32 default; here that would put a
    float32 draft on a bf16 target's card, where the decode kernel
    (K5) takes only bf16, and a default-device twin could land elsewhere
    than its target."""
    from distributed_dot_product_tpu_torch.serve.engine import KernelEngine
    return KernelEngine(
        slots=target.slots, t_max=target.t_max,
        vocab=vocab or target.vocab,
        heads=heads or target.heads,
        head_dim=head_dim or target.head_dim,
        prefill_chunk=target.prefill_chunk,
        seed=target.seed if seed is None else seed,
        dtype=target.dtype, decode_impl=target.decode_impl,
        cache_mode='slab', device=target.device)


class DraftEngineProposer(Proposer):
    """Draft-model proposer: a small greedy engine with its own per-slot
    KV cache, kept exactly in sync with the COMMITTED stream by
    acceptance-prefix rollback.

    Invariant between ticks: the draft cache of slot ``i`` holds the k/v
    of ``history[:-1]`` and ``history[-1]`` is the next input — the same
    convention as the target engine. Proposing runs the draft ``c_max +
    1`` batched steps (step j appends the previous token and emits guess
    j; the extra step appends the LAST guess's k/v so a fully-accepted
    verify leaves nothing missing), and :meth:`commit` / :meth:`end_step`
    roll every slot back to ``pre + 1 + accepted`` — bit-identical to
    having decoded only the committed tokens."""

    def __init__(self, engine):
        self.engine = engine
        self._pre = np.zeros(engine.slots, np.int64)    # len before propose
        self._targets = {}                              # slot -> rollback len
        self._proposed = set()                          # slots of last batch

    def start(self, slot, history):
        self.engine.reset(slot)
        history = np.asarray(history, np.int64)
        body = history[:-1]
        chunk = self.engine.prefill_chunk
        for s in range(0, len(body), chunk):
            self.engine.prefill(slot, body[s:s + chunk])

    def propose_batch(self, requests, k):
        self._proposed = {slot for slot, _, _ in requests}
        if not requests:
            return {}
        eng = self.engine
        slots = eng.slots
        caps = np.zeros(slots, np.int64)
        cur = np.zeros(slots, np.int64)
        mask = np.zeros(slots, bool)
        for slot, history, cap in requests:
            caps[slot] = min(cap, k)
            cur[slot] = int(history[-1])
            mask[slot] = True
        self._pre[mask] = np.asarray(eng.lengths())[mask]
        out = {slot: [] for slot, _, _ in requests}
        c_max = int(caps.max())
        # Step j (1-based) appends the previous token's k/v and emits
        # guess j; a slot drafts while j <= cap and takes one extra
        # append-only step (j == cap + 1) so the last guess's k/v is in
        # the draft cache when the verify accepts it.
        for j in range(1, c_max + 2):
            act = mask & (caps + 1 >= j)
            if not act.any():
                break
            nxt, _ = eng.step(cur, act)
            for slot in out:
                if j <= caps[slot]:
                    out[slot].append(int(nxt[slot]))
            cur = np.where(act, nxt, cur)
        return {slot: props for slot, props in out.items() if props}

    def commit(self, slot, committed, accepted):
        # A slot the last propose_batch never drafted for has a stale
        # _pre anchor — leave its cache alone (its guesses degrade until
        # its next start/propose; correctness never depends on the draft
        # state).
        if slot in self._proposed:
            self._targets[slot] = int(self._pre[slot]) + 1 + int(accepted)

    def end_step(self):
        if not self._targets:
            return
        big = np.iinfo(np.int32).max
        lengths = np.full(self.engine.slots, big, np.int64)
        for slot, tgt in self._targets.items():
            lengths[slot] = tgt
        self._targets.clear()
        self.engine.rollback(lengths)

    def reset(self, slot):
        self._targets.pop(slot, None)
        self._proposed.discard(slot)
        self.engine.reset(slot)
