# -*- coding: utf-8 -*-
"""
Training steps — the port of ``make_train_step`` (the attention module's,
or a transformer stack's, DP × SP step) and ``make_lm_train_step`` (the
language model's, on one card or DP × SP) in
``distributed_dot_product_tpu/train.py``.

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

The language model's loss is the token mean over valid targets: each
rank backpropagates ``loss_sum / C`` with ``C`` the all-reduced count of
valid targets (reduced outside the autograd graph, as the reference
psums only the parameter-independent count inside its objective); the
gradients and the loss value are then summed over both groups.

Dropout: ``step(batch, dropout_seed=None)``. A module with dropout needs
the seed on every call (the step counter); omitting it raises, because
a constant fallback would draw the same mask every step (the reference's
missing-seed policy). Modules without dropout ignore it.

Each returned step carries the module and the optimizer it updates as
``step.module`` and ``step.optimizer`` (the resilient training loop,
:func:`~..train_loop.run_training`, saves and restores their state).
"""

import torch

from distributed_dot_product_tpu_torch.parallel.mesh import shard_seq
from distributed_dot_product_tpu_torch.utils.comm import all_reduce

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


def _resolve_dropout_seed(needs_seed, dropout_seed):
    """The reference's missing-seed policy: a dropout-enabled module
    without an explicit per-step seed is an error; modules without
    dropout get the constant 0."""
    if dropout_seed is None:
        if needs_seed:
            raise ValueError(
                'this module has dropout_rate > 0: pass '
                'dropout_seed=<step counter> to every step() call — '
                'a constant fallback would reuse ONE dropout mask '
                'for the whole run (silently correlated dropout)')
        return 0
    return int(dropout_seed)


def _module_has_dropout(module):
    """Does this module (or a stack or LM over attention modules) apply
    attention dropout?"""
    return any(getattr(m, 'dropout_rate', 0.0) for m in module.modules())


def _groups(mesh, data_axis):
    groups = [mesh.seq_group]
    ranks = mesh.seq_size
    if data_axis is not None:
        groups.append(mesh.data_group)
        ranks *= mesh.data_size
    return groups, ranks


def _sum_grads(params, groups):
    for p in params:
        if p.grad is not None:
            grad = p.grad
            for grp in groups:
                grad = all_reduce(grad, grp)
            p.grad = grad


def make_train_step(module, optimizer, mesh, data_axis=None, guard=False):
    """DP × SP train step for a
    :class:`~..models.attention.DistributedDotProductAttn`-like module
    (or a :class:`~..models.transformer.TransformerStack`) whose
    ``forward(keys, queries, values, attn_mask, segment_ids,
    deterministic, dropout_seed, group=)`` takes this rank's shards.

    ``mesh``: a :class:`~..parallel.mesh.Mesh` (``seq_mesh`` or
    ``data_seq_mesh``); ``data_axis``: the batch axis's name, or None for
    pure SP. The loss is :func:`mse_loss` on each rank's shard, as in the
    reference's default. Returns ``step(batch, dropout_seed=None)`` with
    ``batch = (keys, queries, values, attn_mask, target)`` — or ``(...,
    target, segment_ids)`` with global ``(B, T)`` packed-document ids —
    GLOBAL tensors that every rank holds alike; each rank takes its shard
    (time → seq, batch → data; the ids on their last axis), and the step
    returns the mean loss over the ranks — or, with ``guard=True``, the
    ``{'loss', 'bad_step', 'grad_norm'}`` record with the update skipped
    on a non-finite loss or gradient. Parameters and optimizer state stay
    replicated: every rank applies the same summed gradient."""
    params = [p for p in module.parameters() if p.requires_grad]
    groups, ranks = _groups(mesh, data_axis)
    batch_axis = None if data_axis is None else 0
    needs_seed = _module_has_dropout(module)

    def step(batch, dropout_seed=None):
        seed = _resolve_dropout_seed(needs_seed, dropout_seed)
        keys, queries, values, mask, target, *rest = batch
        keys, queries, values, mask, target = (
            None if x is None else shard_seq(x, mesh, batch_axis=batch_axis)
            for x in (keys, queries, values, mask, target))
        seg = rest[0] if rest else None
        if seg is not None:
            seg = shard_seq(seg, mesh, seq_axis=-1, batch_axis=batch_axis)
        optimizer.zero_grad(set_to_none=True)
        out = module(keys, queries, values, mask, seg, dropout_seed=seed,
                     group=mesh.seq_group)
        local = mse_loss(out, target)
        local.backward()
        loss = local.detach()
        for grp in groups:
            loss = all_reduce(loss, grp)
        _sum_grads(params, groups)
        return _finish(optimizer, params, loss / ranks, guard)

    step.module, step.optimizer = module, optimizer
    return step


def make_lm_train_step(model, optimizer, mesh=None, data_axis=None,
                       loss_chunk=4096, guard=False):
    """Next-token training step for a
    :class:`~..models.lm.TransformerLM`.

    Returns ``step(batch, dropout_seed=None)`` with ``batch = (tokens,
    targets)`` or ``(tokens, targets, segment_ids)`` — ``(B, T)`` integer
    tensors (build ``targets`` with :func:`~..models.lm.lm_targets`
    BEFORE sharding: the next-token shift crosses shard boundaries).
    ``mesh=None``: the one-card step on tensors on the model's device.
    With a mesh (``seq_mesh`` or ``data_seq_mesh``; ``data_axis`` the
    batch axis's name, or None) the batch is GLOBAL, every rank holds it
    alike and takes its shard (batch → data, time → seq), and the loss is
    the token mean over every rank's valid targets: this rank's
    ``loss_sum / all_reduce(count)``, its gradient summed over the groups
    as in :func:`make_train_step`, and the loss value summed likewise.
    ``loss_chunk`` bounds the live logit memory (``nll_sum(chunk=)``;
    None = unchunked).

    ``guard=True``: the update is skipped when the loss or the global
    gradient norm (float32) is not finite, and the step returns
    ``{'loss', 'bad_step', 'grad_norm'}`` (``bad_step`` a bool tensor, as
    the reference's record).
    """
    params = [p for p in model.parameters() if p.requires_grad]
    groups = [] if mesh is None else _groups(mesh, data_axis)[0]
    batch_axis = None if data_axis is None else 0
    needs_seed = _module_has_dropout(model)

    def step(batch, dropout_seed=None):
        seed = _resolve_dropout_seed(needs_seed, dropout_seed)
        tokens, targets, *rest = batch
        seg = rest[0] if rest else None
        if mesh is not None:
            tokens, targets = (shard_seq(x, mesh, seq_axis=-1,
                                         batch_axis=batch_axis)
                               for x in (tokens, targets))
            if seg is not None:
                seg = shard_seq(seg, mesh, seq_axis=-1,
                                batch_axis=batch_axis)
        optimizer.zero_grad(set_to_none=True)
        loss_sum, count = model.nll_sum(
            tokens, targets, seg, dropout_seed=seed, chunk=loss_chunk,
            group=None if mesh is None else mesh.seq_group)
        total = count.detach()
        for grp in groups:
            total = all_reduce(total, grp)
        loss = loss_sum / torch.clamp_min(total, 1.0)
        loss.backward()
        value = loss.detach()
        for grp in groups:
            value = all_reduce(value, grp)
        _sum_grads(params, groups)
        return _finish(optimizer, params, value, guard)

    step.module, step.optimizer = model, optimizer
    return step


def graphlint_entrypoints():
    """Registration hook (``analysis/registry.py``): the full LM train
    step — forward, chunked loss, the gradient all-reduce over the seq
    group, the SGD update — on a 2-rank seq group where the process has
    one (else the one-rank mesh), at the reference's shapes but for the
    head dim (32, the kernels' smallest), computing in bf16. The step
    updates the parameters in place and returns them with the loss (the
    reference donates params and optimizer state: ``expect_donation``);
    each call restores the parameters it moved, so every call computes
    the same step."""

    def lm_step(device):
        from distributed_dot_product_tpu_torch.analysis.registry import (
            HEAD_DIM, TraceSpec,
        )
        from distributed_dot_product_tpu_torch.models.lm import (
            TransformerLM,
        )
        from distributed_dot_product_tpu_torch.parallel.mesh import seq_mesh
        from distributed_dot_product_tpu_torch.utils.comm import (
            SEQ_AXIS, get_world_size,
        )
        mesh = seq_mesh(2 if get_world_size() >= 2 else None)
        # bf16 compute (the flash kernels' bf16 instantiations), float32
        # parameters.
        model = TransformerLM(vocab_size=32, dim=2 * HEAD_DIM, num_heads=2,
                              n_layers=1, dtype=torch.bfloat16, device=device,
                              generator=torch.Generator().manual_seed(0))
        optimizer = torch.optim.SGD(model.parameters(), lr=1e-2)
        step = make_lm_train_step(model, optimizer, mesh, loss_chunk=8)
        tokens = torch.zeros((1, 16), dtype=torch.int64, device=device)
        targets = torch.zeros((1, 16), dtype=torch.int64, device=device)

        def fn(m, batch):
            params = list(m.parameters())
            with torch.no_grad():
                saved = [p.detach().clone() for p in params]
            loss = step(batch)
            with torch.no_grad():
                for p, s in zip(params, saved):
                    p.copy_(s)
            return loss, params

        # Debt (ROADMAP §3): the bf16 GEMMs run with cuBLAS's
        # reduced-precision reduction allowed, as the lm.* entries'.
        return TraceSpec(name='train.lm_step', fn=fn,
                         args=(model, (tokens, targets)),
                         mesh_axes=(SEQ_AXIS,), prejitted=True,
                         expect_donation=True, min_donated=1,
                         allow=('f32-accum',))

    return {'train.lm_step': lm_step}
