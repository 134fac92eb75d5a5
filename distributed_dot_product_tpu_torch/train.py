# -*- coding: utf-8 -*-
"""
Training steps — the port of ``make_train_step`` (the attention module's
DP × SP step) and ``make_lm_train_step`` (the language model, one card)
in ``distributed_dot_product_tpu/train.py``.

The reference builds one compiled SPMD program (forward, loss, cross-shard
gradient ``psum``, optax update) over a device mesh. Here every rank is a
process and runs the same arithmetic in PyTorch's idiom on its shard:
forward, loss, ``backward()``, the gradient all-reduce over the mesh's
process groups, ``optimizer.step()`` — updating the module and the
optimizer in place, the same update on every rank. ``optax.adam(lr)``
maps to ``torch.optim.Adam(params, lr, betas=(0.9, 0.999), eps=1e-8)``:
the same ``m̂/(√v̂ + ε)`` update.

Gradient scale, as the reference computes it: its objective is the
local loss ``pmean``ed over the mesh axes inside the differentiated
function, and ``pmean``'s transpose under ``shard_map`` hands every shard
the cotangent 1 for its own local loss; the ``psum`` of the shards'
partials is then the gradient of the SUM of the local losses (the axis
width times that of their mean). The port backpropagates each rank's
local loss with cotangent 1 and sums the gradients over the data and seq
groups — the same numbers (``tests/test_torch_seq_parallel.py`` holds
one SGD step and one Adam step against the reference's step). The
returned loss is the mean over the ranks.
"""

import torch

from distributed_dot_product_tpu_torch.parallel.mesh import shard_seq
from distributed_dot_product_tpu_torch.utils.comm import (
    all_reduce, get_world_size,
)

__all__ = ['make_train_step', 'make_lm_train_step', 'mse_loss']


def _global_grad_norm(params):
    """L2 norm over every gradient, in float32 (bf16 leaves can overflow
    the squared sum); NaN/Inf exactly when a gradient is."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(p.grad.float()) for p in params
         if p.grad is not None]))


def mse_loss(pred, target):
    """Per-shard mean-squared error (the reference's ``mse_loss``)."""
    return torch.mean((pred - target) ** 2)


def _finish(optimizer, params, loss, guard):
    """The update, or with ``guard`` the reference's record: the update
    is skipped when the loss or the global gradient norm is not
    finite."""
    if not guard:
        optimizer.step()
        return loss
    grad_norm = _global_grad_norm(params)
    finite = torch.isfinite(loss) & torch.isfinite(grad_norm)
    if bool(finite):
        optimizer.step()
    return {'loss': loss, 'bad_step': ~finite, 'grad_norm': grad_norm}


def make_train_step(module, optimizer, mesh, data_axis=None, guard=False):
    """DP × SP train step for a
    :class:`~..models.attention.DistributedDotProductAttn`-like module
    whose ``forward(keys, queries, values, attn_mask, group=)`` takes
    this rank's shards.

    ``mesh``: a :class:`~..parallel.mesh.Mesh` (``seq_mesh`` or
    ``data_seq_mesh``); ``data_axis``: the batch axis's name, or None for
    pure SP. The loss is :func:`mse_loss` on each rank's shard, as in the
    reference's default. Returns ``step(batch)`` with ``batch = (keys,
    queries, values, attn_mask, target)`` GLOBAL tensors that every rank
    holds alike; each rank takes its shard (time → seq, batch → data),
    and the step returns the mean loss over the ranks — or, with
    ``guard=True``, the ``{'loss', 'bad_step', 'grad_norm'}`` record with
    the update skipped on a non-finite loss or gradient. Parameters and
    optimizer state stay replicated: every rank applies the same summed
    gradient. Segment ids and the dropout seed are not ported
    (``ROADMAP.md`` §1 item 8)."""
    params = [p for p in module.parameters() if p.requires_grad]
    groups = [mesh.seq_group]
    ranks = mesh.seq_size
    if data_axis is not None:
        groups.append(mesh.data_group)
        ranks *= mesh.data_size
    batch_axis = None if data_axis is None else 0

    def step(batch):
        if len(batch) != 5:
            raise NotImplementedError(
                'segment ids in the train step are not ported yet '
                '(ROADMAP.md §1 item 8)')
        keys, queries, values, mask, target = (
            None if x is None else shard_seq(x, mesh, batch_axis=batch_axis)
            for x in batch)
        optimizer.zero_grad(set_to_none=True)
        out = module(keys, queries, values, mask, group=mesh.seq_group)
        local = mse_loss(out, target)
        local.backward()
        loss = local.detach()
        for grp in groups:
            loss = all_reduce(loss, grp)
        for p in params:
            if p.grad is not None:
                grad = p.grad
                for grp in groups:
                    grad = all_reduce(grad, grp)
                p.grad = grad
        return _finish(optimizer, params, loss / ranks, guard)

    return step


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
            "the language model's multi-rank train step is not ported yet "
            '(ROADMAP.md §1 item 8); this step trains on one card '
            '(make_train_step trains the attention module across ranks)')
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch):
        tokens, targets = batch
        optimizer.zero_grad(set_to_none=True)
        loss_sum, count = model.nll_sum(tokens, targets, chunk=loss_chunk)
        loss = loss_sum / torch.clamp_min(count, 1.0)
        loss.backward()
        return _finish(optimizer, params, loss.detach(), guard)

    return step
