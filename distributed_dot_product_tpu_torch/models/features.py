# -*- coding: utf-8 -*-
"""
Feature x softmax-path support matrix: a copy of
``distributed_dot_product_tpu/models/features.py`` (the port imports
nothing of the reference package). ``DistributedDotProductAttn.__init__``
raises from it with the same uniform message as the reference, so the
two packages validate their constructor knobs identically.

Vocabulary: ``True`` = supported natively; ``False`` = raises; a string =
supported with a caveat (treated as supported by validation).
"""

IMPLS = ('full', 'online', 'flash', 'ulysses')

# knob -> {impl: True | False | 'caveat string'}
FEATURE_MATRIX = {
    'attn_mask': {
        'full': True,
        'online': 'O(T²/N) input',
        'flash': 'O(T²/N) input; blockwise skip/redirect',
        'ulysses': 'gathered to O(T²) per device',
    },
    'causal': {
        'full': 'densified into the mask',
        'online': 'native (block + whole-fold skip)',
        'flash': 'native (block skip)',
        'ulysses': 'native (block skip)',
    },
    'window': {
        'full': 'densified into the mask',
        'online': 'native (whole-fold skip)',
        'flash': 'native (banded grid, O(T·window))',
        'ulysses': 'native (banded grid)',
    },
    'segment_ids': {
        'full': 'densified into the mask',
        'online': 'native O(T/N) vectors, rotate with K/V',
        'flash': 'native O(T) vectors',
        'ulysses': 'native O(T) vectors',
    },
    'num_kv_heads': {
        'full': 'heads repeated (parity path)',
        'online': 'native grouped kernels',
        'flash': 'native grouped kernels',
        'ulysses': 'native; needs num_kv_heads % N == 0',
    },
    'dropout_rate': {
        'full': False,
        'online': 'in-kernel hash mask',
        'flash': 'in-kernel hash mask',
        'ulysses': 'in-kernel hash mask',
    },
    'alibi_slopes': {
        'full': False,
        'online': 'in-kernel, global distances',
        'flash': 'in-kernel, global distances',
        'ulysses': 'in-kernel, global distances',
    },
    'qk_quant': {
        'full': False,
        'online': 'int8 MXU scoring (per-fold kernels)',
        'flash': 'int8 MXU scoring',
        'ulysses': 'int8 MXU scoring (local flash kernel)',
    },
    'use_rope': {
        'full': 'shard-global rotation',
        'online': 'shard-global rotation (zigzag-aware)',
        'flash': 'shard-global rotation',
        'ulysses': 'shard-global rotation',
    },
    'ring_layout=zigzag': {
        'full': False,
        'online': 'causal critical-path balance',
        'flash': False,
        'ulysses': False,
    },
    'flash_softmax_mode=bounded': {
        'full': False,
        'online': False,
        'flash': 'forward-only win; see RESULTS.md',
        'ulysses': 'forward-only win; see RESULTS.md',
    },
    'offset': {
        'full': 'chunked-gather knob (reference semantics)',
        'online': 'n/a (ring rotation)',
        'flash': 'n/a (one tiled gather)',
        'ulysses': 'n/a (all-to-all)',
    },
}

def check(knob, impl):
    """Raise the uniform unsupported-knob error when the matrix says no."""
    if not FEATURE_MATRIX[knob][impl]:
        ok = [i for i in IMPLS if FEATURE_MATRIX[knob][i]]
        raise ValueError(
            f"{knob} is not supported with softmax_impl={impl!r}; "
            f"supported paths: {', '.join(ok) if ok else 'none'} "
            f'(see the feature matrix in README.md / models/features.py)')
