# -*- coding: utf-8 -*-
"""
Training step for the language model — the port of
``make_lm_train_step`` in ``distributed_dot_product_tpu/train.py``, on
one card.

The reference builds one compiled SPMD program (forward, token-mean
loss, cross-shard gradient ``psum``, optax update) over a device mesh.
On one card the mesh is one wide and the sums are over one shard, so
the port's step is the same arithmetic in PyTorch's idiom: forward,
``loss = nll_sum / max(count, 1)``, ``backward()`` and
``optimizer.step()``, updating the model and the optimizer in place.
``optax.adam(lr)`` maps to ``torch.optim.Adam(params, lr,
betas=(0.9, 0.999), eps=1e-8)``: the same ``m̂/(√v̂ + ε)`` update. A
process group of more than one rank raises until the sequence-parallel
slice ports the data × seq gradient reduction.
"""

import torch

from distributed_dot_product_tpu_torch.utils.comm import get_world_size

__all__ = ['make_lm_train_step']


def _global_grad_norm(params):
    """L2 norm over every gradient, in float32 (bf16 leaves can overflow
    the squared sum); NaN/Inf exactly when a gradient is."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p.grad.float()) for p in params
         if p.grad is not None]))


def make_lm_train_step(model, optimizer, loss_chunk=4096, guard=False):
    """Next-token training step for a
    :class:`~..models.lm.TransformerLM`.

    Returns ``step(batch)`` with ``batch = (tokens, targets)`` — ``(B, T)``
    integer tensors on the model's device (build ``targets`` with
    :func:`~..models.lm.lm_targets`). The step runs the forward and the
    token-mean cross-entropy over valid targets, the backward, and
    ``optimizer.step()``, and returns the loss tensor. ``loss_chunk``
    bounds the live logit memory (``nll_sum(chunk=)``; None =
    unchunked).

    ``guard=True``: the update is skipped when the loss or the global
    gradient norm (float32) is not finite, and the step returns
    ``{'loss', 'bad_step', 'grad_norm'}`` (``bad_step`` a bool tensor, as
    the reference's record).
    """
    if get_world_size() > 1:
        raise NotImplementedError(
            'the multi-rank train step (data x seq gradient reduction) is '
            'not ported yet (ROADMAP.md §1 item 8); this step trains on one '
            'card')
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch):
        tokens, targets = batch
        optimizer.zero_grad(set_to_none=True)
        loss_sum, count = model.nll_sum(tokens, targets, chunk=loss_chunk)
        loss = loss_sum / torch.clamp_min(count, 1.0)
        loss.backward()
        if not guard:
            optimizer.step()
            return loss.detach()
        grad_norm = _global_grad_norm(params)
        finite = torch.isfinite(loss.detach()) & torch.isfinite(grad_norm)
        if bool(finite):
            optimizer.step()
        return {'loss': loss.detach(), 'bad_step': ~finite,
                'grad_norm': grad_norm}

    return step
