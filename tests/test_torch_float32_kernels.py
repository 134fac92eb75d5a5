# -*- coding: utf-8 -*-
"""
Float32 operands on the kernels' launch path (``csrc/flash_f32.cu`` for
K1/K2, ``csrc/flash_bwd_f32.cu`` for K3/K4, ``csrc/flash_decode.cu`` built
with ``-DDECODE_F32`` for K5/K5p),
checked on the CPU: there is no card here, so this test alone replaces
each launch with a fake that records the library and symbol the wrapper
asked for and runs the plain version on the operands the wrapper hands
it (K5/K5p's from the raw pointers and sizes of the C call), writing the
kernel's outputs in place.

- (a) float32 operands reach K1, K2, K3, K4, K5 and K5p as float32,
  through the float32 libraries' symbols (the Ext library for a launch
  with features), and no bf16 tensor is made on the way (a dispatch mode
  watches every operation); outputs come back float32, gradients float32
  whether ``grad_dtype`` is None or float32;
- (b) float16 operands, and operands of two dtypes, raise ``TypeError``
  naming both accepted types; bf16 operands still reach the bf16
  symbols;
- (c) through that float32 launch path, the port against the JAX package
  at float32 on the CPU, on inputs made with numpy from a seed:
  ``KernelEngine`` at its defaults (slots 2, t_max 24; slab and paged)
  serving a burst — tokens equal to the reference engine's;
  ``TransformerLM`` at ``dtype=None`` (2 layers, dim 32) — loss and last
  logits; the paper's module with ``softmax_impl='flash'`` on float32
  inputs, causal and not — output and input gradients.

Tolerance (as tests/test_torch_head_dims.py): max |got − want| ≤ 1e-5 ·
max |want| per tensor, float32 rounding of two libraries' reduction
orders; the launch path's own results against the plain version on the
same operands the same (the padded columns add exact zeros but may
change a sum's blocking).
"""

import ctypes
import importlib
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from distributed_dot_product_tpu import DistributedDotProductAttn as JaxAttn
from distributed_dot_product_tpu.models.lm import TransformerLM as JaxLM
from distributed_dot_product_tpu.models.lm import (
    lm_targets as jax_lm_targets,
)
from distributed_dot_product_tpu.serve import (
    KernelEngine as JaxEngine, Scheduler as JaxScheduler,
    ServeConfig as JaxConfig,
)
from distributed_dot_product_tpu.utils.tracing import (
    MetricsRegistry as JaxRegistry,
)
from distributed_dot_product_tpu_torch import (
    DistributedDotProductAttn, TransformerLM, attn_state_from_jax,
    lm_state_from_jax,
)
from distributed_dot_product_tpu_torch.convert import engine_state_from_jax
from distributed_dot_product_tpu_torch.serve import (
    KernelEngine, Scheduler, ServeConfig,
)
from distributed_dot_product_tpu_torch.utils.tracing import MetricsRegistry
from torch_serving import cyclic_gc_paused  # noqa: E402,F401  autouse

fa = importlib.import_module(
    'distributed_dot_product_tpu_torch.ops.flash_attention')
fd = importlib.import_module(
    'distributed_dot_product_tpu_torch.ops.flash_decode')

REL = 1e-5


def _close(got, want, what=''):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    bound = REL * max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= bound, what


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


class _NoBf16(TorchDispatchMode):
    """Records every operation that makes a bf16 tensor."""

    def __init__(self):
        super().__init__()
        self.bf16_ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if any(isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16
               for t in tree_leaves(out)):
            self.bf16_ops.append(str(func))
        return out


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_CTYPES = {torch.float32: ctypes.c_float, torch.int32: ctypes.c_int32,
           torch.int8: ctypes.c_int8}


def _at(ptr, shape, dtype):
    """The ``shape`` tensor of ``dtype`` at address ``ptr`` (the memory
    itself, not a copy); None for a null pointer."""
    if ptr is None:
        return None
    n = math.prod(shape)
    buf = (_CTYPES[dtype] * n).from_address(ptr)
    return torch.from_numpy(np.ctypeslib.as_array(buf)).view(shape)


def _route(monkeypatch):
    """Patches the K1–K5p wrappers so that CPU tensors take the launch
    path: the plain versions the wrappers call on the CPU hand over to
    ``_launch`` / ``_launch_dq`` / ``_launch_dkv`` / the decode
    ``_launch``, and each launch is a fake running the original plain
    version on the launch's operands. Returns the list of ``(library,
    symbol, out_f32)`` the launches asked for (``out_f32``: the
    backward's float32-gradient flag, None elsewhere)."""
    calls, seen = [], {}
    plain_fwd = fa._plain_fwd
    dq_plain, dkv_plain = fa.flash_attention_dq_plain, \
        fa.flash_attention_dkv_plain
    decode_plain = fd.flash_decode_plain
    real_empty, real_ptrs = torch.empty, fa._ptrs

    def empty(*a, **kw):
        t = real_empty(*a, **kw)
        seen[t.data_ptr()] = t
        return t

    def ptrs(*tensors):
        for t in tensors:
            seen[t.data_ptr()] = t
        return real_ptrs(*tensors)

    def fake_fwd(q, k, v, out, lse, mvec, mask, inner, so, si, sr, nb,
                 group, tq, tk, d, dv, causal, co, ko, qscale, ext, s):
        if seen[q].dtype != torch.float32:
            return 0
        o, l = plain_fwd(seen[q], seen[k], seen[v], None, bool(causal), co,
                         ko, qscale / fa._LOG2E, fa._NO_FEAT,
                         bounded=mvec is not None)
        seen[out].copy_(o)
        if lse is not None:
            seen[lse].copy_(l)
        return 0

    def fake_dq(q2, k, v, g, lse2, delta, dq, mask, inner, so, si, sr, nb,
                group, tq, tk, d, dv, causal, co, ko, scale, f32, ext, s):
        calls[-1] = (*calls[-1][:2], f32)
        if seen[q2].dtype == torch.float32:
            seen[dq].copy_(dq_plain(*(seen[p] for p in (
                q2, k, v, g, lse2, delta)), causal=bool(causal),
                causal_offset=co, kv_offset=ko, scale=scale))
        return 0

    def fake_dkv(q2, k, v, g, lse2, delta, dk, dv_, mask, inner, so, si, sr,
                 nb, group, tq, tk, d, dv, causal, co, ko, scale, f32, ext,
                 s):
        calls[-1] = (*calls[-1][:2], f32)
        if seen[q2].dtype == torch.float32:
            got = dkv_plain(*(seen[p] for p in (q2, k, v, g, lse2, delta)),
                            causal=bool(causal), causal_offset=co,
                            kv_offset=ko)
            seen[dk].copy_(got[0])
            seen[dv_].copy_(got[1])
        return 0

    fakes = {'fwd': fake_fwd, 'dq': fake_dq, 'dkv': fake_dkv}

    def cfn(name, symbol, argtypes):
        calls.append((name, symbol, None))
        return fakes[symbol.split('_')[-2]]

    def decode_call(paged, f32):
        def fake(*args):
            if not f32:
                return 0
            if paged:
                (q, kn, vn, ck, cv, vt, ap, nn, table, kq, ks, alibi, out,
                 num, m, l, b, h, h_kv, n, pps, ps, d, dv, win, _, qscale,
                 _) = args
                tbl = _at(table, (b, pps), torch.int32)
                pages = max(int(tbl.max()) + 1, 1)
                rows, t = (pages, h_kv, ps), None
            else:
                (q, kn, vn, ck, cv, vt, ap, nn, kq, ks, alibi, out, num, m,
                 l, b, h, h_kv, n, t, d, dv, win, _, _, qscale, _) = args
                tbl, rows = None, (b, h_kv, t)
            f = torch.float32
            res = decode_plain(
                _at(q, (b, h, n, d), f), _at(kn, (b, h_kv, n, d), f),
                _at(vn, (b, h_kv, n, dv), f), _at(ck, (*rows, d), f),
                _at(cv, (*rows, dv), f), _at(vt, (b,), torch.int32),
                _at(ap, (b,), torch.int32),
                n_new=_at(nn, (b,), torch.int32),
                scale=qscale / fa._LOG2E, page_table=tbl,
                window=win or None, partials=num is not None,
                k_q=_at(kq, (*rows, d), torch.int8),
                k_scale=_at(ks, (*rows, 1), f),
                qk_quant='int8' if kq else None,
                alibi_slopes=_at(alibi, (h,), f))[0]
            if num is None:
                _at(out, (b, h, n, dv), f).copy_(res)
            else:
                for p, x, w in zip((num, m, l), res, (dv, 1, 1)):
                    _at(p, (b, h, n, w), f).copy_(x)
            return 0
        return fake

    def kernel_lib(f32):
        name = 'flash_decode_f32' if f32 else 'flash_decode'
        suffix = 'f32' if f32 else 'bf16'
        lib = types.SimpleNamespace(flash_decode_chunk=lambda: fd._SPLIT,
                                    flash_decode_smem=lambda *a: 0)

        def named(symbol, paged):
            fake = decode_call(paged, f32)

            def call(*args):
                calls.append((name, symbol, None))
                return fake(*args)
            return call
        return (lib, named(f'flash_decode_{suffix}', False),
                named(f'flash_decode_paged_{suffix}', True))

    def route_fwd(q, k, v, mask, causal, co, ko, scale, feat, bounded=False):
        mvec = (fa.bounded_shift(fa._fold_q(q, scale), k) if bounded
                else None)
        return fa._launch(q, k, v, mask, causal, co, ko, scale, True,
                          mvec=mvec, feat=feat)

    def route_dq(q2, k, v, g, lse2, delta, *, mask=None, causal=False,
                 causal_offset=0, kv_offset=0, scale=1.0, grad_dtype=None,
                 segment_ids=None, window=None, dropout_rate=0.0,
                 dropout_seed=None, quant=None, positions=None,
                 alibi_slopes=None):
        feat = fa._bwd_feat(q2, k, causal, segment_ids, window, dropout_rate,
                            dropout_seed, quant, positions, alibi_slopes)
        return fa._launch_dq(q2, k, v, g, lse2, delta, mask, causal,
                             causal_offset, kv_offset, scale, grad_dtype,
                             feat, quant)

    def route_dkv(q2, k, v, g, lse2, delta, *, mask=None, causal=False,
                  causal_offset=0, kv_offset=0, grad_dtype=None, scale=None,
                  segment_ids=None, window=None, dropout_rate=0.0,
                  dropout_seed=None, quant=None, positions=None,
                  alibi_slopes=None):
        feat = fa._bwd_feat(q2, k, causal, segment_ids, window, dropout_rate,
                            dropout_seed, quant, positions, alibi_slopes)
        if scale is None:
            scale = 1.0 / math.sqrt(q2.shape[-1])
        return fa._launch_dkv(q2, k, v, g, lse2, delta, mask, causal,
                              causal_offset, kv_offset, scale, grad_dtype,
                              feat, quant)

    def route_decode(q, k_new, v_new, cache_k, cache_v, valid_to, append_at,
                     *, n_new=None, scale=None, page_table=None, window=None,
                     partials=False, k_q=None, k_scale=None, qk_quant=None,
                     alibi_slopes=None, block_k=None):
        _, bk = fd._k_split(block_k, cache_k, page_table, q.shape[2])
        scale = 1.0 / math.sqrt(q.shape[-1]) if scale is None else scale
        mirror = (k_q, k_scale) if qk_quant == 'int8' else None
        return fd._launch(q, k_new, v_new, cache_k, cache_v, valid_to,
                          append_at, n_new, scale, page_table=page_table,
                          window=window, partials=partials, mirror=mirror,
                          alibi_slopes=alibi_slopes, block_k=bk)

    monkeypatch.setattr(torch, 'empty', empty)
    monkeypatch.setattr(fa, '_ptrs', ptrs)
    monkeypatch.setattr(fa, '_cfn', cfn)
    monkeypatch.setattr(fa, '_plain_fwd', route_fwd)
    monkeypatch.setattr(fa, 'flash_attention_dq_plain', route_dq)
    monkeypatch.setattr(fa, 'flash_attention_dkv_plain', route_dkv)
    monkeypatch.setattr(fd, '_kernel_lib', kernel_lib)
    monkeypatch.setattr(fd, '_sm_count', lambda index: 132)
    monkeypatch.setattr(fd, 'flash_decode_plain', route_decode)
    monkeypatch.setattr(torch.cuda, 'device', lambda dev: _Null())
    monkeypatch.setattr(torch.cuda, 'current_stream',
                        lambda *a: types.SimpleNamespace(cuda_stream=0))
    return calls


def _qkvg(rng, d, dv, dtype=torch.float32):
    q, g = _rand(rng, 1, 4, 33, d), _rand(rng, 1, 4, 33, dv)
    k, v = _rand(rng, 1, 2, 33, d), _rand(rng, 1, 2, 33, dv)
    return tuple(torch.from_numpy(x).to(dtype) for x in (q, k, v, g))


# -- (a) float32 operands reach the float32 kernels as float32 ------------

@pytest.mark.parametrize('features', ['base', 'ext'])
def test_float32_reaches_k1_to_k4_as_float32(monkeypatch, features):
    calls = _route(monkeypatch)
    q, k, v, g = _qkvg(np.random.default_rng(1), 24, 12)
    scale = 1.0 / math.sqrt(24)
    feat = fa._NO_FEAT
    if features == 'ext':
        seg = torch.zeros((1, 33), dtype=torch.int32)
        feat = fa._features(q, k, True, segment_ids=(seg, seg), window=8)
    with _NoBf16() as mode:
        out, lse = fa._launch(q, k, v, None, True, 2, 0, scale, True,
                              feat=feat)
        out2 = fa._launch(q, k, v, None, True, 2, 0, scale, False,
                          mvec=fa.bounded_shift(fa._fold_q(q, scale), k),
                          feat=feat)
        q2, lse2, delta = fa.flash_attention_bwd_operands(q, out, lse, g,
                                                          scale)
        dq = fa._launch_dq(q2, k, v, g, lse2, delta, None, True, 2, 0, scale,
                           None, feat, None)
        dq32 = fa._launch_dq(q2, k, v, g, lse2, delta, None, True, 2, 0,
                             scale, torch.float32, feat, None)
        dk, dv = fa._launch_dkv(q2, k, v, g, lse2, delta, None, True, 2, 0,
                                scale, None, feat, None)
    assert not mode.bf16_ops
    lib = {kind: f'flash_f32_{kind}_ext' for kind in ('fwd', 'dq', 'dkv')}
    if features == 'base':
        lib = {'fwd': 'flash_f32', 'dq': 'flash_f32_bwd',
               'dkv': 'flash_f32_bwd'}
    assert calls == [(lib['fwd'], 'flash_fwd_f32', None),
                     (lib['fwd'], 'flash_fwd_f32', None),
                     (lib['dq'], 'flash_bwd_dq_f32', 1),
                     (lib['dq'], 'flash_bwd_dq_f32', 1),
                     (lib['dkv'], 'flash_bwd_dkv_f32', 1)]
    for t, like in ((out, v), (out2, v), (dq, q), (dq32, q), (dk, k),
                    (dv, v)):
        assert t.dtype == torch.float32
        assert tuple(t.shape[-2:]) == (33, like.shape[-1])
    assert (fa.flash_attention.f32_launches, fa.flash_attention_dq.f32_launches
            ) >= (1, 2)
    if features == 'base':
        want, want_lse = fa.flash_attention_plain_lse(
            q, k, v, causal=True, causal_offset=2, scale=scale)
        _close(out, want, 'out')
        _close(lse, want_lse, 'lse')
        want_dq, want_dk, want_dv = fa.flash_attention_backward_plain(
            q, k, v, out, lse, g, True, 2, scale)
        for got, w, n in ((dq, want_dq, 'dq'), (dk, want_dk, 'dk'),
                          (dv, want_dv, 'dv')):
            _close(got, w, n)


@pytest.mark.parametrize('paged', [False, True], ids=['slab', 'paged'])
def test_float32_reaches_k5_k5p_as_float32(monkeypatch, paged):
    calls = _route(monkeypatch)
    rng = np.random.default_rng(2)
    b, h, h_kv, n, d, dv, t, ps = 2, 4, 2, 3, 24, 12, 32, 8
    q, kn, vn = (torch.from_numpy(_rand(rng, b, h, n, d)),
                 torch.from_numpy(_rand(rng, b, h_kv, n, d)),
                 torch.from_numpy(_rand(rng, b, h_kv, n, dv)))
    ck = torch.from_numpy(_rand(rng, b, h_kv, t, d))
    cv = torch.from_numpy(_rand(rng, b, h_kv, t, dv))
    vt = torch.tensor([20, 5], dtype=torch.int32)
    kw = dict(scale=0.3)
    if paged:
        pages = b * t // ps
        table = torch.from_numpy(rng.permutation(pages).astype(np.int32)
                                 .reshape(b, t // ps))
        pool_k = torch.from_numpy(_rand(rng, pages + 1, h_kv, ps, d))
        pool_v = torch.from_numpy(_rand(rng, pages + 1, h_kv, ps, dv))
        for i in range(b):
            for j in range(t // ps):
                pool_k[table[i, j]] = ck[i, :, j * ps:(j + 1) * ps]
                pool_v[table[i, j]] = cv[i, :, j * ps:(j + 1) * ps]
        ck, cv, kw = pool_k, pool_v, dict(kw, page_table=table)
    ck2, cv2 = ck.clone(), cv.clone()
    with _NoBf16() as mode:
        out = fd._launch(q, kn, vn, ck, cv, vt, vt, None, 0.3,
                         page_table=kw.get('page_table'))[0]
    assert not mode.bf16_ops
    symbol = 'flash_decode_paged_f32' if paged else 'flash_decode_f32'
    assert calls == [('flash_decode_f32', symbol, None)]
    assert out.dtype == torch.float32 and tuple(out.shape) == (b, h, n, dv)
    counter = fd.flash_decode_paged if paged else fd.flash_decode
    assert counter.f32_launches >= 1
    monkeypatch.undo()
    ref = fd.flash_decode_plain(q, kn, vn, ck2, cv2, vt, vt, **kw)[0]
    _close(out, ref, 'decode out')
    assert torch.equal(ck[:-1] if paged else ck, ck2[:-1] if paged else ck2)
    assert torch.equal(cv[:-1] if paged else cv, cv2[:-1] if paged else cv2)


# -- (b) other dtypes raise; bf16 keeps its own kernels ---------------------

def _mixed(case):
    rng = np.random.default_rng(3)
    q, k, v, g = _qkvg(rng, 32, 32)
    if case == 'fp16':
        return tuple(x.half() for x in (q, k, v, g))
    if case == 'mixed_k':
        return q, k.bfloat16(), v, g
    return q, k, v, g.bfloat16()


@pytest.mark.parametrize('case', ['fp16', 'mixed_k', 'mixed_g'])
def test_fp16_and_mixed_dtypes_raise(monkeypatch, case):
    calls = _route(monkeypatch)
    q, k, v, g = _mixed(case)
    lse = torch.zeros(q.shape[:-1])
    calls_fwd = [lambda: fa._launch(q, k, v, None, True, 0, 0, 0.2)]
    calls_bwd = [
        lambda: fa._launch_dq(q, k, v, g, lse, lse, None, True, 0, 0, 0.2,
                              None, fa._NO_FEAT, None),
        lambda: fa._launch_dkv(q, k, v, g, lse, lse, None, True, 0, 0, 0.2,
                               None, fa._NO_FEAT, None)]
    for call in (calls_bwd if case == 'mixed_g' else calls_fwd + calls_bwd):
        with pytest.raises(TypeError, match='bf16 or float32'):
            call()
    dq = q[:, :, :1].contiguous()
    # K5: the cache float32 beside a bf16 k_new, or bf16 beside float32 q.
    cache = {'fp16': k, 'mixed_k': k.float(), 'mixed_g': k.bfloat16()}[case]
    with pytest.raises(TypeError, match='bf16 or float32'):
        fd._launch(dq, k[:, :, :1].contiguous(), v[:, :, :1].contiguous(),
                   cache.contiguous(), v.contiguous(),
                   torch.tensor([3], dtype=torch.int32),
                   torch.tensor([3], dtype=torch.int32), None, 0.2)
    assert calls == []


def test_bf16_still_picks_bf16_symbols(monkeypatch):
    calls = _route(monkeypatch)
    q, k, v, g = _qkvg(np.random.default_rng(4), 32, 32, torch.bfloat16)
    lse = torch.zeros(q.shape[:-1])
    seg = torch.zeros((1, 33), dtype=torch.int32)
    ext = fa._features(q, k, True, segment_ids=(seg, seg))
    fa._launch(q, k, v, None, True, 0, 0, 0.2)
    fa._launch(q, k, v, None, True, 0, 0, 0.2, feat=ext)
    fa._launch_dq(q, k, v, g, lse, lse, None, True, 0, 0, 0.2, None,
                  fa._NO_FEAT, None)
    fa._launch_dkv(q, k, v, g, lse, lse, None, True, 0, 0, 0.2, None, ext,
                   None)
    fd._launch(q[:, :, :1].contiguous(), k[:, :, :1].contiguous(),
               v[:, :, :1].contiguous(), k.contiguous(), v.contiguous(),
               torch.tensor([3], dtype=torch.int32),
               torch.tensor([3], dtype=torch.int32), None, 0.2)
    assert calls == [('flash_fwd', 'flash_fwd_bf16', None),
                     ('flash_fwd_ext', 'flash_fwd_bf16', None),
                     ('flash_bwd', 'flash_bwd_dq_bf16', 0),
                     ('flash_bwd_dkv_ext', 'flash_bwd_dkv_bf16', 0),
                     ('flash_decode', 'flash_decode_bf16', None)]


# -- (c) the float32 launch path against the JAX package -------------------

def _symbols(calls):
    return {symbol for _, symbol, _ in calls}


@pytest.mark.parametrize('mode', ['slab', 'paged'])
def test_engine_defaults_float32_route_matches_jax(monkeypatch, mode):
    """KernelEngine at its defaults (float32, vocab 64, 2 heads of 8,
    prefill chunk 8) with 2 slots and t_max 24, serving 6 requests through
    the Scheduler; the reference engine at its defaults with the same
    weights: every request's status and tokens equal."""
    paged = dict(cache_mode='paged', page_size=4) if mode == 'paged' else {}
    je = JaxEngine(slots=2, t_max=24, decode_impl='xla', **paged)
    calls = _route(monkeypatch)
    te = KernelEngine(slots=2, t_max=24, device='cpu', decode_impl='kernel',
                      **paged)
    assert te.dtype == torch.float32
    te.load_weights(engine_state_from_jax(
        {name: np.asarray(getattr(je, name))
         for name in ('_embed', '_wq', '_wk', '_wv', '_wo')}))
    rng = np.random.default_rng(5)
    burst = [(f'r{i}', rng.integers(0, 64, size=int(rng.integers(1, 9)))
              .astype(np.int32)) for i in range(6)]

    def run(sched):
        for rid, prompt in burst:
            sched.submit(prompt, request_id=rid)
        res = sched.run_until_idle()
        sched.close()
        return {rid: (r.status, list(r.tokens)) for rid, r in res.items()}
    want = run(JaxScheduler(je, JaxConfig(queue_limit=8, max_new_tokens=5,
                                          watchdog=False),
                            registry=JaxRegistry(), fault_injector=False))
    got = run(Scheduler(te, ServeConfig(queue_limit=8, max_new_tokens=5,
                                        watchdog=False),
                        registry=MetricsRegistry(), fault_injector=False))
    assert got == want
    assert all(s == 'completed' for s, _ in got.values())
    assert _symbols(calls) == {'flash_decode_paged_f32' if paged
                               else 'flash_decode_f32'}


def test_lm_dtype_none_float32_route_matches_jax(monkeypatch):
    """TransformerLM at dtype=None (float32 compute and parameters; vocab
    64, dim 32, 4 heads, 2 layers) through K1's float32 launch path: the
    token-mean loss and the last position's logits against the reference
    LM's."""
    vocab, dim, heads, layers = 64, 32, 4, 2
    jm = JaxLM(vocab_size=vocab, dim=dim, num_heads=heads, n_layers=layers,
               attn_kwargs=dict(distributed=False))
    tokens = np.random.default_rng(6).integers(0, vocab, (2, 24),
                                               dtype=np.int32)
    targets = np.array(jax_lm_targets(jnp.asarray(tokens)))
    params = jm.init(jax.random.key(6), jnp.asarray(tokens))
    s, c = jm.apply(params, jnp.asarray(tokens), jnp.asarray(targets),
                    method='nll_sum')
    want_logits = jm.apply(params, jnp.asarray(tokens))[:, -1]
    calls = _route(monkeypatch)
    port = TransformerLM(vocab, dim, heads, n_layers=layers, device='cpu',
                         attn_kwargs=dict(distributed=False))
    assert port.dtype == torch.float32
    port.load_state_dict(lm_state_from_jax(jax.tree.map(np.asarray,
                                                        params)))
    with torch.no_grad():
        ps, pc = port.nll_sum(torch.from_numpy(tokens),
                              torch.from_numpy(targets))
        logits = port(torch.from_numpy(tokens))[:, -1]
    assert logits.dtype == torch.float32
    _close(ps / pc, np.asarray(s / c), 'loss')
    _close(logits, want_logits, 'last logits')
    assert _symbols(calls) == {'flash_fwd_f32'}


@pytest.mark.parametrize('causal', [True, False], ids=['causal', 'full'])
def test_module_flash_float32_route_matches_jax(monkeypatch, causal):
    """The paper's module (key_dim 16, 2 heads, ``softmax_impl='flash'``,
    dtype None) on float32 inputs through K1, K3 and K4's float32 launch
    path: output and input gradients against the reference module's."""
    kw = dict(key_dim=16, num_heads=2, causal=causal, distributed=False,
              softmax_impl='flash')
    rng = np.random.default_rng(7)
    xs = [_rand(rng, 2, 12, 16) for _ in range(3)]
    g = _rand(rng, 2, 12, 16)
    jm = JaxAttn(**kw)
    params = jm.init(jax.random.key(7), *(jnp.asarray(x) for x in xs))
    want, vjp = jax.vjp(lambda *a: jm.apply(params, *a),
                        *(jnp.asarray(x) for x in xs))
    want_g = vjp(jnp.asarray(g))
    calls = _route(monkeypatch)
    port = DistributedDotProductAttn(device='cpu', **kw)
    port.load_state_dict(attn_state_from_jax(jax.tree.map(np.asarray,
                                                          params)))
    ins = [torch.from_numpy(x).requires_grad_() for x in xs]
    got = port(*ins, deterministic=True)
    got_g = torch.autograd.grad(got, ins, torch.from_numpy(g))
    assert got.dtype == torch.float32
    _close(got, want, 'out')
    for n, x, y in zip(('dkeys', 'dqueries', 'dvalues'), got_g, want_g):
        _close(x, y, n)
    assert _symbols(calls) == {'flash_fwd_f32', 'flash_bwd_dq_f32',
                               'flash_bwd_dkv_f32'}
