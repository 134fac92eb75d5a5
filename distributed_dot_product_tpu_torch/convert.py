# -*- coding: utf-8 -*-
"""
Convert the reference package's ``TransformerLM``, ``TransformerStack``
and ``DistributedDotProductAttn`` parameters (GQA's narrower queries /
values projections included) into the port's state dicts, and the
reference serving ``KernelEngine``'s weights into the port engine's.

The input is the flax parameter tree as plain mappings of arrays
(numpy arrays, or anything ``numpy.asarray`` reads): either the scanned
layout (``params['stack']['layers']['block']…`` with a leading
``n_layers`` axis, the reference default) or the unrolled ``block_i``
subtrees. Dense ``kernel (in, out)`` becomes ``weight (out, in)``;
LayerNorm ``scale``/``bias`` and the ``embedding`` table keep their
shapes. Load the result with ``model.load_state_dict(state)``, which
casts to the model's dtypes and device. A gradient tree of the reference
has its params' structure and converts the same way.
"""

import numpy as np
import torch

__all__ = ['attn_state_from_jax', 'engine_state_from_jax',
           'lm_state_from_jax', 'stack_state_from_jax']

_ATTN = (('keys', 'keys_proj'), ('queries', 'queries_proj'),
         ('values', 'values_proj'), ('composition', 'composition'))


def _blocks(stack):
    if 'layers' in stack:
        block = stack['layers']['block']
        n = np.asarray(block['ln1']['scale']).shape[0]

        def take(node, i):
            if hasattr(node, 'keys'):
                return {k: take(v, i) for k, v in node.items()}
            return np.asarray(node)[i]
        return [take(block, i) for i in range(n)]
    n = sum(1 for name in stack if name.startswith('block_'))
    return [stack[f'block_{i}'] for i in range(n)]


def _dense(state, prefix, node):
    state[f'{prefix}.weight'] = np.asarray(node['kernel']).T
    if 'bias' in node:
        state[f'{prefix}.bias'] = np.asarray(node['bias'])


def _attn(state, prefix, node):
    for flax_name, port_name in _ATTN:
        _dense(state, f'{prefix}{port_name}', node[flax_name])


def _tensors(state):
    return {k: torch.tensor(v) for k, v in state.items()}


def attn_state_from_jax(params):
    """``{name: torch.Tensor}`` for the port's
    ``DistributedDotProductAttn`` from the reference module's params
    (``{'params': …}`` or the inner tree)."""
    p = params['params'] if 'params' in params else params
    state = {}
    _attn(state, '', p)
    return _tensors(state)


def _stack(state, prefix, stack):
    for i, blk in enumerate(_blocks(stack)):
        pre = f'{prefix}blocks.{i}'
        _attn(state, f'{pre}.attn.', blk['attn'])
        for ln in ('ln1', 'ln2'):
            state[f'{pre}.{ln}.scale'] = np.asarray(blk[ln]['scale'])
            state[f'{pre}.{ln}.bias'] = np.asarray(blk[ln]['bias'])
        _dense(state, f'{pre}.mlp_in', blk['mlp_in'])
        _dense(state, f'{pre}.mlp_out', blk['mlp_out'])


def stack_state_from_jax(params):
    """``{name: torch.Tensor}`` for the port's ``TransformerStack`` from
    the reference ``TransformerStack`` params, unrolled (``block_i``) or
    scanned (``layers/block`` with a leading layer axis), ``{'params':
    …}`` or the inner tree."""
    p = params['params'] if 'params' in params else params
    state = {}
    _stack(state, '', p)
    return _tensors(state)


def lm_state_from_jax(params):
    """``{name: torch.Tensor}`` for the port's ``TransformerLM`` from the
    reference ``TransformerLM`` params (``{'params': …}`` or the inner
    tree)."""
    p = params['params'] if 'params' in params else params
    state = {'embedding': np.asarray(p['embed']['embedding']),
             'ln_f.scale': np.asarray(p['ln_f']['scale']),
             'ln_f.bias': np.asarray(p['ln_f']['bias'])}
    _stack(state, 'stack.', p['stack'])
    return _tensors(state)


def engine_state_from_jax(arrays):
    """``{'embed', 'wq', 'wk', 'wv', 'wo'}`` tensors for the port's
    ``KernelEngine.load_weights`` from the reference engine's float
    weights — a mapping of its ``_embed``, ``_wq``, ``_wk``, ``_wv`` and
    ``_wo`` arrays (leading underscores optional). The layouts agree
    (``x @ w`` on both sides), so nothing is transposed."""
    state = {}
    for name in ('embed', 'wq', 'wk', 'wv', 'wo'):
        value = arrays[f'_{name}'] if f'_{name}' in arrays else arrays[name]
        state[name] = torch.tensor(np.asarray(value))
    return state
