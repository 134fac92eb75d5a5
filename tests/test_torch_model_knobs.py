# -*- coding: utf-8 -*-
"""
The language model's untied head (``tie_embeddings=False``) and the
stack's partial rematerialisation (``remat_policy``) against the
reference package on the CPU, from seeded numpy inputs and the same
parameters:

- the untied-head LM: logits, ``nll_sum`` chunked and unchunked, and
  every parameter's gradient (the head's included), relative 1e-5 of each
  tensor's largest element as ``tests/test_torch_train.py`` holds the
  tied LM;
- every argument-free ``jax.checkpoint_policies`` name on the scanned
  stack: outputs and gradients against the reference stack under the same
  policy (relative 1e-5) and, bit for bit, against the port's stack
  without remat (the recompute runs the same float ops in the same order);
- a ``TorchDispatchMode`` count of the matmuls the backward runs shows the
  policy at work: no remat and ``everything_saveable`` run none of the
  forward's again, ``nothing_saveable`` all of them (but each block's
  last, after which the recompute stops), ``dots_saveable`` none,
  ``dots_with_no_batch_dims_saveable`` the batched ones only;
- the policy factories fail as in the reference: ``TypeError`` where the
  stack is built with ``remat=True`` (the reference's ``init``), nothing
  without remat.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from distributed_dot_product_tpu.models.lm import (
    TransformerLM as JaxLM, lm_targets as jax_lm_targets,
)
from distributed_dot_product_tpu.models.transformer import (
    TransformerStack as JaxStack,
)
from distributed_dot_product_tpu_torch import (
    TransformerLM, TransformerStack, lm_state_from_jax, stack_state_from_jax,
)

REL = 1e-5
ATTN = dict(distributed=False, causal=True, softmax_impl='flash')
POLICIES = ('dots_saveable', 'checkpoint_dots',
            'dots_with_no_batch_dims_saveable',
            'checkpoint_dots_with_no_batch_dims', 'nothing_saveable',
            'everything_saveable')
FACTORIES = ('save_only_these_names', 'save_any_names_but_these',
             'save_anything_except_these_names', 'save_from_both_policies',
             'offload_dot_with_no_batch_dims',
             'save_and_offload_only_these_names')


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, what=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max()
    assert err <= REL * max(np.abs(want).max(), 1e-30), (
        what, err, np.abs(want).max())


def _close_state(got, want):
    assert got.keys() == want.keys()
    for name in want:
        _close(got[name], want[name], name)


# -- the untied head ------------------------------------------------------

@pytest.mark.parametrize('chunk', [16, None], ids=['chunked', 'unchunked'])
def test_untied_head_lm_matches_jax(chunk):
    jm = JaxLM(vocab_size=64, dim=32, num_heads=4, n_layers=2,
               tie_embeddings=False, attn_kwargs=dict(distributed=False))
    tokens = np.random.default_rng(8).integers(0, 64, (2, 40), np.int32)
    targets = np.array(jax_lm_targets(jnp.asarray(tokens)))
    params = jm.init(jax.random.key(8), jnp.asarray(tokens))
    port = TransformerLM(64, 32, 4, n_layers=2, tie_embeddings=False,
                         device='cpu')
    state = lm_state_from_jax(_np(params))
    assert state['lm_head_kernel'].shape == (32, 64)
    port.load_state_dict(state)
    with torch.no_grad():
        _close(port(torch.from_numpy(tokens)),
               jm.apply(params, jnp.asarray(tokens)), 'logits')

    def loss(p):
        s, c = jm.apply(p, jnp.asarray(tokens), jnp.asarray(targets),
                        chunk=chunk, method='nll_sum')
        return s / c, (s, c)
    (_, (want_s, want_c)), want_g = jax.value_and_grad(
        loss, has_aux=True)(params)
    s, c = port.nll_sum(torch.from_numpy(tokens), torch.from_numpy(targets),
                        chunk=chunk)
    assert float(c) == float(want_c)
    _close(s, want_s, 'nll sum')
    (s / c).backward()
    _close_state({n: p.grad for n, p in port.named_parameters()},
                 lm_state_from_jax(_np(want_g)))
    assert port.lm_head_kernel.grad.abs().max() > 0


def test_untied_head_draws_after_the_tied_model():
    """The untied head is drawn after every other parameter, so the rest
    of the model equals the tied model of the same seed."""
    tied = TransformerLM(64, 32, 4, n_layers=2, device='cpu').state_dict()
    untied = TransformerLM(64, 32, 4, n_layers=2, tie_embeddings=False,
                           device='cpu').state_dict()
    assert untied.keys() - tied.keys() == {'lm_head_kernel'}
    assert all(torch.equal(untied[k], v) for k, v in tied.items())


# -- remat_policy ---------------------------------------------------------

def _stack_pair(policy, x):
    js = JaxStack(dim=32, num_heads=4, n_layers=2, scan_layers=True,
                  remat=True, remat_policy=policy, attn_kwargs=ATTN)
    params = js.init(jax.random.key(9), *(jnp.asarray(x),) * 3)
    port = TransformerStack(32, 4, n_layers=2, scan_layers=True, remat=True,
                            remat_policy=policy, attn_kwargs=ATTN,
                            device='cpu')
    port.load_state_dict(stack_state_from_jax(_np(params)))
    return js, params, port


def _port_grads(port, x):
    port.zero_grad()
    y = port(torch.from_numpy(x))
    (y ** 2).sum().backward()
    return y.detach(), {n: p.grad.clone() for n, p in port.named_parameters()}


@pytest.mark.parametrize('policy', POLICIES)
def test_remat_policy_matches_jax_and_no_remat(policy):
    x = np.random.default_rng(9).standard_normal((2, 12, 32)).astype(
        np.float32)
    js, params, port = _stack_pair(policy, x)
    jx = jnp.asarray(x)
    want = js.apply(params, jx, jx, jx)
    want_g = jax.grad(lambda p: jnp.sum(js.apply(p, jx, jx, jx) ** 2))(
        params)
    y, grads = _port_grads(port, x)
    _close(y, want, 'out')
    _close_state(grads, stack_state_from_jax(_np(want_g)))
    plain = TransformerStack(32, 4, n_layers=2, scan_layers=True,
                             attn_kwargs=ATTN, device='cpu')
    plain.load_state_dict(port.state_dict())
    y0, grads0 = _port_grads(plain, x)
    assert torch.equal(y, y0)
    for name, g in grads0.items():
        assert torch.equal(grads[name], g), name


_aten = torch.ops.aten
_MM = {_aten.mm.default, _aten.addmm.default}
_BMM = {_aten.bmm.default, _aten.baddbmm.default}


class _DotCount(TorchDispatchMode):
    """Counts the matmul ops that reach the dispatcher, by kind."""

    def __init__(self):
        super().__init__()
        self.mm = self.bmm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.mm += func in _MM
        self.bmm += func in _BMM
        return func(*args, **(kwargs or {}))


def _counts(port, x):
    """Matmuls of one forward (grad on) and of its backward."""
    xt = torch.from_numpy(x)
    with _DotCount() as fwd:
        y = port(xt)
    loss = (y ** 2).sum()
    with _DotCount() as bwd:
        loss.backward()
    return (fwd.mm, fwd.bmm), (bwd.mm, bwd.bmm)


def test_remat_policy_changes_what_the_backward_recomputes():
    x = np.random.default_rng(10).standard_normal((2, 12, 32)).astype(
        np.float32)
    kw = dict(n_layers=2, scan_layers=True, attn_kwargs=ATTN, device='cpu')
    (f_mm, f_bmm), base = _counts(TransformerStack(32, 4, **kw), x)
    assert f_mm == 2 * 6            # 4 projections + 2 MLP matmuls a layer
    got = {p: _counts(TransformerStack(32, 4, remat=True, remat_policy=p,
                                       **kw), x)[1]
           for p in (None, 'nothing_saveable', 'dots_saveable',
                     'dots_with_no_batch_dims_saveable',
                     'everything_saveable')}
    # Full remat reruns every forward matmul but each block's last (the
    # non-reentrant checkpoint stops recomputing once the tensors the
    # backward needs exist, and the MLP's output projection's output is
    # not one of them).
    full = (base[0] + f_mm - 2, base[1] + f_bmm)
    assert got[None] == got['nothing_saveable'] == full
    assert got['dots_saveable'] == base
    assert got['dots_with_no_batch_dims_saveable'] == (base[0],
                                                       base[1] + f_bmm)
    assert got['everything_saveable'] == base


@pytest.mark.parametrize('name', FACTORIES)
def test_policy_factories_fail_as_in_the_reference(name):
    x = jnp.ones((1, 8, 16))
    js = JaxStack(dim=16, num_heads=2, n_layers=2, scan_layers=True,
                  remat=True, remat_policy=name,
                  attn_kwargs=dict(distributed=False))
    with pytest.raises(TypeError):
        js.init(jax.random.key(0), x, x, x)
    with pytest.raises(TypeError):
        TransformerStack(16, 2, n_layers=2, scan_layers=True, remat=True,
                         remat_policy=name, device='cpu')
    # Without remat the policy is never built: both accept the name.
    JaxStack(dim=16, num_heads=2, n_layers=2, scan_layers=True,
             remat_policy=name, attn_kwargs=dict(distributed=False)).init(
                 jax.random.key(0), x, x, x)
    TransformerStack(16, 2, n_layers=2, scan_layers=True, remat_policy=name,
                     device='cpu')
