# -*- coding: utf-8 -*-
"""
Causal language model over the transformer stack — the port of
``TransformerLM``, ``lm_targets`` and ``greedy_generate`` in
``distributed_dot_product_tpu/models/lm.py``.

Token embedding → :class:`~..models.transformer.TransformerStack` → final
LayerNorm → head, with the head's float32 accumulation as in the
reference: tied (the embedding table transposed), or with
``tie_embeddings=False`` an explicit ``lm_head_kernel (dim, vocab)``
(the reference's name and layout, ``lecun_normal``, no bias). Both the
logits and the loss read the ``(vocab, dim)`` table through
``_head_table``. ``weight_quant='int8'`` quantizes every block's
projection and MLP matmuls; the embedding and the head stay float.
Training: ``forward`` returns the logits, ``nll_sum`` the chunked
cross-entropy ``(sum, count)`` the train step divides. Generation: ``prefill`` ingests the prompt through
the flash kernel (K1), ``decode`` is the one-token cached step through
the fused decode kernel (K5).
"""

from collections import OrderedDict

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from distributed_dot_product_tpu_torch.models.dense import default_generator
from distributed_dot_product_tpu_torch.models.transformer import (
    LayerNorm, TransformerStack,
)
from distributed_dot_product_tpu_torch.utils.comm import (
    SEQ_AXIS, resolve_device,
)

__all__ = ['TransformerLM', 'greedy_generate', 'lm_targets']


def lm_targets(tokens, segment_ids=None, pad_id=None):
    """Next-token targets for ``tokens (B, T)``: ``targets[t] =
    tokens[t+1]``, with ignore (−1) at the final position, at segment
    boundaries (a segment's last token must not predict the next
    segment's first) and at padding (``pad_id`` as the token or as the
    next token)."""
    t = tokens.shape[-1]
    nxt = torch.roll(tokens, -1, dims=-1)
    ignore = torch.zeros(tokens.shape, dtype=torch.bool,
                         device=tokens.device)
    ignore[..., t - 1] = True
    if segment_ids is not None:
        seg = torch.as_tensor(segment_ids, device=tokens.device)
        ignore |= seg != torch.roll(seg, -1, dims=-1)
    if pad_id is not None:
        ignore |= (nxt == pad_id) | (tokens == pad_id)
    return torch.where(ignore, -1, nxt)


def _chunk_nll(x, targets, table):
    """Summed −log p(target) and the count of valid (``>= 0``) targets
    for one chunk, logits in float32 from the float32 table."""
    logits = torch.matmul(x.float(), table.t())
    lse = torch.logsumexp(logits, dim=-1)
    valid = targets >= 0
    ll = logits.gather(-1, torch.where(valid, targets, 0)[..., None])
    nll = torch.where(valid, lse - ll[..., 0], 0.0)
    return nll.sum(), valid.float().sum()


class TransformerLM(nn.Module):
    """Causal LM: embed → stack → LayerNorm → tied head.

    ``attn_kwargs`` pass to the stack's attention modules with
    ``causal=True``, ``softmax_impl='flash'`` and ``use_rope=True``
    defaulted in (``causal=False`` raises). Parameters are created on
    ``device`` at ``param_dtype`` (float32 by default, as in the
    reference; LayerNorm parameters stay float32) and computed at
    ``dtype`` (``param_dtype`` when None), drawn from one CPU
    ``generator`` (seeded 0 when None) — the embedding as flax's default
    ``normal(1/√dim)``, the dense layers as its ``lecun_normal``. Serving
    a bf16 model: ``dtype=param_dtype=torch.bfloat16``; training:
    float32 parameters under ``dtype=torch.bfloat16``.
    ``remat``/``remat_policy`` and ``weight_quant`` forward to the stack;
    ``scan_layers`` (default True, the reference's default layout) decides
    the layers' dropout salt (:class:`~..models.transformer
    .TransformerStack`). ``tie_embeddings=False`` adds the untied head
    ``lm_head_kernel (dim, vocab)``, drawn after the stack's parameters
    (so the tied model's draws are unchanged) and stored at
    ``param_dtype`` like the table (the reference's float32 is its
    parameter dtype)."""

    def __init__(self, vocab_size, dim, num_heads, n_layers=2, mlp_ratio=4,
                 axis_name=SEQ_AXIS, dtype=None, weight_quant=None,
                 attn_kwargs=None, scan_layers=True, remat=False,
                 remat_policy=None, tie_embeddings=True,
                 param_dtype=torch.float32, device='cuda', generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = default_generator(generator)
        kw = dict(attn_kwargs or {})
        if not kw.setdefault('causal', True):
            raise ValueError('TransformerLM is autoregressive: '
                             'causal=False makes no sense here')
        kw.setdefault('softmax_impl', 'flash')
        kw.setdefault('use_rope', True)
        self.dtype = dtype or param_dtype
        emb = torch.empty(vocab_size, dim).normal_(
            0.0, dim ** -0.5, generator=gen)
        self.embedding = nn.Parameter(emb.to(device=dev, dtype=param_dtype))
        self.stack = TransformerStack(
            dim, num_heads, n_layers=n_layers, mlp_ratio=mlp_ratio,
            axis_name=axis_name, dtype=dtype, weight_quant=weight_quant,
            attn_kwargs=kw, remat=remat, remat_policy=remat_policy,
            scan_layers=scan_layers, path=('stack',), param_dtype=param_dtype,
            device=dev, generator=gen)
        self.ln_f = LayerNorm(dim, dtype=dtype, device=dev)
        self.tie_embeddings = tie_embeddings
        if not tie_embeddings:
            std = dim ** -0.5 / .87962566103423978
            head = torch.empty(dim, vocab_size)
            nn.init.trunc_normal_(head, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=gen)
            self.lm_head_kernel = nn.Parameter(
                head.to(device=dev, dtype=param_dtype))

    @property
    def device(self):
        return self.embedding.device

    def _head_table(self):
        """The ``(vocab, dim)`` logit table: the tied embedding, or the
        untied head kernel transposed."""
        if self.tie_embeddings:
            return self.embedding
        return self.lm_head_kernel.t()

    def _head(self, x):
        # logits = x · tableᵀ with float32 accumulation, cast back to the
        # activation dtype (the contract is f32 accumulation, not f32
        # logits).
        x = self.ln_f(x)
        return F.linear(x, self._head_table().to(x.dtype)).to(x.dtype)

    def _embed(self, tokens):
        # flax nn.Embed casts the table to the compute dtype and gathers;
        # gathering first and casting the rows is the same numbers.
        return F.embedding(tokens.long(), self.embedding).to(self.dtype)

    def _hidden(self, tokens, segment_ids, deterministic, dropout_seed,
                group):
        x = self._embed(tokens)
        return self.stack(x, x, x, None, segment_ids, deterministic,
                          dropout_seed, group=group)

    def forward(self, tokens, segment_ids=None, deterministic=False,
                dropout_seed=None, *, group=None):
        """Logits ``(B, T, vocab)`` at the compute dtype for
        ``tokens (B, T)`` (this rank's shard ``(B, T/N)`` over
        ``group``)."""
        return self._head(self._hidden(tokens, segment_ids, deterministic,
                                       dropout_seed, group))

    def nll_sum(self, tokens, targets, segment_ids=None, deterministic=False,
                dropout_seed=None, chunk=None, *, group=None):
        """Summed next-token negative log-likelihood and the count of
        valid targets (``>= 0``), both float32 scalars — the training
        loss primitive (the train step divides them).

        The logits are float32 from the float32 table, as in the
        reference. ``chunk``: the loss walks row chunks of the final
        hidden states, each chunk's ``(chunk, vocab)`` logits and
        logsumexp inside ``torch.utils.checkpoint``, so neither pass
        holds the ``(T, vocab)`` logits; a chunk that does not divide T is
        padded with target −1. ``None`` (or ``chunk >= T``) is one
        unchunked pass."""
        x = self.ln_f(self._hidden(tokens, segment_ids, deterministic,
                                   dropout_seed, group))
        table = self._head_table().float()
        targets = torch.as_tensor(targets, device=x.device).long()
        tn = x.shape[-2]
        if chunk is None or chunk >= tn:
            return _chunk_nll(x, targets, table)
        pad = (-tn) % chunk
        if pad:
            x = F.pad(x, (0, 0, 0, pad))
            targets = F.pad(targets, (0, pad), value=-1)
        total = count = 0.0
        for i in range(0, tn + pad, chunk):
            args = (x[..., i:i + chunk, :], targets[..., i:i + chunk], table)
            s, c = (checkpoint(_chunk_nll, *args, use_reentrant=False)
                    if torch.is_grad_enabled() else _chunk_nll(*args))
            total, count = total + s, count + c
        return total, count

    def make_decode_caches(self, batch, t_max, dtype=None):
        """KV caches for generation: a list, one per layer."""
        return self.stack.make_decode_caches(batch, t_max, dtype=dtype)

    def prefill(self, tokens, caches):
        """Ingest a prompt ``tokens (B, n)``: returns ``(caches, logits
        (B, n, vocab))`` — the last position's logits seed generation."""
        x = self._embed(tokens)
        caches, x = self.stack.prefill(x, caches)
        return caches, self._head(x)

    def decode(self, tokens, caches):
        """One cached generation step for ``tokens (B, 1)``."""
        x = self._embed(tokens)
        caches, x = self.stack.decode(x, caches)
        return caches, self._head(x)


def greedy_generate(model, prompt, steps, t_max):
    """Greedy sampling through the KV caches: prefill the prompt, then
    ``steps - 1`` cached decode steps (the first token comes from the
    prefill logits). Returns ``(B, steps) int32`` on the model's device.

    Capacity, as in the reference: prefill writes the ``n`` prompt rows
    and the loop ``steps - 1`` more, so ``n + steps - 1 <= t_max``.
    Ties in the argmax go to the lowest token id."""
    prompt = torch.as_tensor(prompt, device=model.device)
    b, n = prompt.shape
    if steps < 1:
        raise ValueError(f'steps must be >= 1, got {steps} (the prefill '
                         'logits already commit the first token)')
    if n + steps - 1 > t_max:
        raise ValueError(f'prompt {n} + steps {steps} needs '
                         f'{n + steps - 1} cache rows but t_max is '
                         f'{t_max}')
    prefill, step = _generate_programs(model, b, n, t_max)
    with torch.inference_mode():
        caches = model.make_decode_caches(b, t_max)
        caches, tok = prefill(prompt, caches)
        out = [tok]
        for _ in range(steps - 1):
            caches, tok = step(tok, caches)
            out.append(tok)
    return torch.cat(out, dim=1)


# The generation programs of greedy_generate, as the reference's cache of
# compiled programs: the model keeps its own (a reference cycle the
# collector frees with the model), keyed by (batch, prompt_len, t_max) —
# every shape a program sees is IN the key, so each entry sees one input
# signature, and repeated calls reuse the pair. LRU past
# _GENERATE_PROGRAMS_CAP entries a model.
_GENERATE_PROGRAMS_CAP = 8


def _generate_programs(model, b, n, t_max):
    """``(prefill, step)`` for ``model`` at this shape: prefill gives the
    first token from the prompt's last logits, step one cached token —
    each under the retrace sentinel (analysis/retrace.py), budget 2 as
    in the reference: a second signature past that is a storm."""
    progs = model.__dict__.setdefault('_generate_programs', OrderedDict())
    key = (b, n, t_max)
    pair = progs.get(key)
    if pair is not None:
        progs.move_to_end(key)
        return pair
    from distributed_dot_product_tpu_torch.analysis.retrace import (
        watch_traces,
    )

    def prefill_fn(tokens, caches):
        caches, logits = model.prefill(tokens, caches)
        return caches, logits[:, -1:].argmax(dim=-1).to(torch.int32)

    def step_fn(tok, caches):
        caches, logits = model.decode(tok, caches)
        return caches, logits[:, -1:].argmax(dim=-1).to(torch.int32)

    pair = progs[key] = (
        watch_traces(prefill_fn, 'lm.generate_prefill', budget=2),
        watch_traces(step_fn, 'lm.generate_step', budget=2))
    while len(progs) > _GENERATE_PROGRAMS_CAP:
        progs.popitem(last=False)
    return pair


def graphlint_entrypoints():
    """Registration hook (``analysis/registry.py``): the LM head at bf16
    and the chunked token-mean loss (``nll_sum``), with float32 and with
    bf16 parameters (the attention computes in bf16, through the flash
    kernels' bf16 instantiations)."""
    from functools import partial

    def _model(device, param_dtype):
        from distributed_dot_product_tpu_torch.analysis.registry import (
            HEAD_DIM,
        )
        return TransformerLM(
            vocab_size=32, dim=2 * HEAD_DIM, num_heads=2, n_layers=1,
            dtype=torch.bfloat16, param_dtype=param_dtype,
            attn_kwargs={'distributed': False}, device=device,
            generator=torch.Generator().manual_seed(0))

    def head_bf16(device):
        from distributed_dot_product_tpu_torch.analysis.registry import (
            TraceSpec, example,
        )
        model = _model(device, torch.bfloat16)
        x = example((1, 8, model.embedding.shape[1]), torch.bfloat16,
                    device)

        def fn(m, h):
            with torch.no_grad():
                return m._head(h)

        # Debt (ROADMAP §3): the bf16 head GEMM runs with cuBLAS's
        # reduced-precision reduction allowed.
        return TraceSpec(name='lm.head_bf16', fn=fn, args=(model, x),
                         allow=('f32-accum',))

    def loss(device, name='lm.loss_f32', param_dtype=torch.float32):
        from distributed_dot_product_tpu_torch.analysis.registry import (
            TraceSpec,
        )
        model = _model(device, param_dtype)
        gen = torch.Generator().manual_seed(1)
        tokens = torch.randint(0, 32, (1, 16), generator=gen).to(device)
        targets = torch.randint(0, 32, (1, 16), generator=gen).to(device)

        def fn(m, tok, tgt):
            with torch.no_grad():
                return m.nll_sum(tok, tgt, chunk=4)

        return TraceSpec(name=name, fn=fn, args=(model, tokens, targets),
                         allow=('f32-accum',))      # bf16 GEMMs, as above

    return {'lm.head_bf16': head_bf16, 'lm.loss_f32': loss,
            'lm.loss_bf16': partial(loss, name='lm.loss_bf16',
                                    param_dtype=torch.bfloat16)}
