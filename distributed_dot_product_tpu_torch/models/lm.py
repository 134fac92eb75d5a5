# -*- coding: utf-8 -*-
"""
Causal language model over the transformer stack — the port of
``TransformerLM`` and ``greedy_generate`` in
``distributed_dot_product_tpu/models/lm.py`` (cached generation; the
training forward and loss come with the training slice).

Token embedding → :class:`~..models.transformer.TransformerStack` → final
LayerNorm → tied head (the embedding table transposed), with the head's
float32 accumulation as in the reference. Generation: ``prefill``
ingests the prompt through the flash kernel (K1), ``decode`` is the
one-token cached step through the fused decode kernel (K5).
"""

import torch
import torch.nn.functional as F
from torch import nn

from distributed_dot_product_tpu_torch.models.dense import default_generator
from distributed_dot_product_tpu_torch.models.transformer import (
    LayerNorm, TransformerStack,
)
from distributed_dot_product_tpu_torch.utils.comm import (
    SEQ_AXIS, resolve_device,
)

__all__ = ['TransformerLM', 'greedy_generate']


class TransformerLM(nn.Module):
    """Causal LM: embed → stack → LayerNorm → tied head.

    ``attn_kwargs`` pass to the stack's attention modules with
    ``causal=True``, ``softmax_impl='flash'`` and ``use_rope=True``
    defaulted in (``causal=False`` raises). Parameters are created on
    ``device`` at ``dtype`` (LayerNorm parameters stay float32), drawn
    from one CPU ``generator`` (seeded 0 when None) — the embedding as
    flax's default ``normal(1/√dim)``, the dense layers as its
    ``lecun_normal``."""

    def __init__(self, vocab_size, dim, num_heads, n_layers=2, mlp_ratio=4,
                 axis_name=SEQ_AXIS, dtype=None, attn_kwargs=None,
                 device='cuda', generator=None):
        super().__init__()
        dev = resolve_device(device)
        gen = default_generator(generator)
        kw = dict(attn_kwargs or {})
        if not kw.setdefault('causal', True):
            raise ValueError('TransformerLM is autoregressive: '
                             'causal=False makes no sense here')
        kw.setdefault('softmax_impl', 'flash')
        kw.setdefault('use_rope', True)
        self.dtype = dtype or torch.float32
        emb = torch.empty(vocab_size, dim).normal_(
            0.0, dim ** -0.5, generator=gen)
        self.embedding = nn.Parameter(emb.to(device=dev, dtype=self.dtype))
        self.stack = TransformerStack(
            dim, num_heads, n_layers=n_layers, mlp_ratio=mlp_ratio,
            axis_name=axis_name, dtype=dtype, attn_kwargs=kw, device=dev,
            generator=gen)
        self.ln_f = LayerNorm(dim, dtype=dtype, device=dev)

    @property
    def device(self):
        return self.embedding.device

    def _head(self, x):
        # logits = x · Eᵀ with float32 accumulation, cast back to the
        # activation dtype (the contract is f32 accumulation, not f32
        # logits).
        x = self.ln_f(x)
        return F.linear(x, self.embedding.to(x.dtype)).to(x.dtype)

    def forward(self, *args, **kwargs):
        raise NotImplementedError('the training forward of TransformerLM is '
                                  'ported with the training slice')

    def make_decode_caches(self, batch, t_max, dtype=None):
        """KV caches for generation: a list, one per layer."""
        return self.stack.make_decode_caches(batch, t_max, dtype=dtype)

    def prefill(self, tokens, caches):
        """Ingest a prompt ``tokens (B, n)``: returns ``(caches, logits
        (B, n, vocab))`` — the last position's logits seed generation."""
        x = F.embedding(tokens.long(), self.embedding)
        caches, x = self.stack.prefill(x, caches)
        return caches, self._head(x)

    def decode(self, tokens, caches):
        """One cached generation step for ``tokens (B, 1)``."""
        x = F.embedding(tokens.long(), self.embedding)
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
    with torch.inference_mode():
        caches = model.make_decode_caches(b, t_max)
        caches, logits = model.prefill(prompt, caches)
        tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
        out = [tok]
        for _ in range(steps - 1):
            caches, logits = model.decode(tok, caches)
            tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
            out.append(tok)
    return torch.cat(out, dim=1)
