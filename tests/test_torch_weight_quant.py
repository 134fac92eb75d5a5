# -*- coding: utf-8 -*-
"""
int8 weights in the port (``models/dense.py``, ``weight_quant='int8'`` on
the attention module, block, stack, language model and serving engine)
against the reference package on the CPU, from seeded numpy inputs and
the same parameters carried across by ``convert.py``:

- ``quantized_dot`` and ``quantize_kernel`` bit for bit the reference's
  (float32 and bf16 inputs, leading batch axes, an all-zero row, a
  layer-stacked kernel): the same f32 divides, round half to even, an
  exact integer product and the same ``(y · s_x) · s_w`` order;
- ``quantize_dense_params`` (what it replaces and keeps),
  ``dense_param_bytes`` and ``OwnedDense`` int8 (with bias, f32 and bf16)
  against the reference's; ``weight_scale`` stays float32 under a dtype
  cast;
- the module, block, stack (scanned and unrolled) and LM at int8 against
  the reference's on the same quantized parameters, forward and cached
  decode, at float32 within 1e-5 (the int products are exact; the float
  work around them differs in accumulation order only), and each within
  the reference's ``WQ8_RTOL`` = 0.05 of its float twin; LM greedy tokens
  equal;
- the engine's ``DDP_TPU_*`` knobs, ``weight_bytes``, int8 streams equal
  to the reference int8 engine's from the same float weights, slab equal
  to paged under the fault cocktail, ``kv_shards=2`` equal to the single
  pool.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_dot_product_tpu.models import dense as jd
from distributed_dot_product_tpu.models.attention import (
    DistributedDotProductAttn as JaxAttn,
)
from distributed_dot_product_tpu.models.decode import (
    init_cache as jax_init_cache,
)
from distributed_dot_product_tpu.models.lm import (
    TransformerLM as JaxLM, greedy_generate as jax_greedy,
)
from distributed_dot_product_tpu.models.transformer import (
    TransformerBlock as JaxBlock, TransformerStack as JaxStack,
)
from distributed_dot_product_tpu.serve import engine as jax_engine_mod
from distributed_dot_product_tpu.serve import (
    KernelEngine as JaxEngine, RejectedError as JaxRejected,
    Scheduler as JaxScheduler, ServeConfig as JaxConfig,
)
from distributed_dot_product_tpu.utils.tracing import (
    MetricsRegistry as JaxRegistry,
)
from distributed_dot_product_tpu_torch import (
    DistributedDotProductAttn, TransformerBlock, TransformerLM,
    TransformerStack, attn_state_from_jax, lm_state_from_jax,
    stack_state_from_jax,
)
from distributed_dot_product_tpu_torch.convert import engine_state_from_jax
from distributed_dot_product_tpu_torch.models import dense as td
from distributed_dot_product_tpu_torch.models.lm import greedy_generate
from distributed_dot_product_tpu_torch.serve import engine as port_engine_mod
from distributed_dot_product_tpu_torch.serve import (
    KernelEngine, RejectedError, Scheduler, ServeConfig,
)
from distributed_dot_product_tpu_torch.utils import faults
from distributed_dot_product_tpu_torch.utils.tracing import MetricsRegistry

# The reference's documented int8 class (tests/test_weight_quant.py):
# both operands round to int8 (half a step of each side's scale, ~0.4% of
# the row / column max), so outputs land within a few percent of the
# float twin's scale.
WQ8_RTOL = 0.05
# Port against reference on the same quantized parameters, float32: the
# s8 products are exact integers on both sides; the float work around them
# (LayerNorm, the attention, GELU) differs by accumulation order.
TOL = dict(atol=1e-5, rtol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-9))


# -- the rule, bit for bit ------------------------------------------------

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('lead', [(), (3,), (2, 3)], ids=['2d', 'b', 'bb'])
def test_quantized_dot_and_kernel_bit_for_bit(dtype, lead):
    rng = np.random.default_rng(len(lead))
    x = (rng.standard_normal((*lead, 5, 64)) * 4).astype(np.float32)
    x[..., 2, :] = 0.0                                # an all-zero row
    kernel = rng.standard_normal((64, 40)).astype(np.float32)
    jq, js = jd.quantize_kernel(jnp.asarray(kernel))
    tq, ts = td.quantize_kernel(torch.from_numpy(kernel).t())
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    want = np.asarray(jd.quantized_dot(jx, jq, js))
    got = td.quantized_dot(tx, tq, ts)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert not got[..., 2, :].any()


def test_layer_stacked_kernel_quantizes_per_layer():
    w = np.random.default_rng(1).standard_normal((3, 16, 24)).astype(
        np.float32)                                   # (L, in, out)
    jq, js = jd.quantize_kernel(jnp.asarray(w))
    tq, ts = td.quantize_kernel(torch.from_numpy(w).transpose(-1, -2))
    assert tq.shape == (3, 24, 16) and ts.shape == (3, 24)
    np.testing.assert_array_equal(tq.numpy(),
                                  np.asarray(jq).transpose(0, 2, 1))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    one_q, one_s = td.quantize_kernel(torch.from_numpy(w[1]).t())
    assert torch.equal(tq[1], one_q) and torch.equal(ts[1], one_s)


# -- OwnedDense and the parameter helpers ---------------------------------

@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_owned_dense_int8_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    jm = jd.OwnedDense(16, dtype=getattr(jnp, dtype))
    params = _np(jm.init(jax.random.key(1), jx))
    params['params']['bias'] = rng.standard_normal(16).astype(np.float32)
    jq = jd.quantize_dense_params(params)
    want = jd.OwnedDense(16, dtype=getattr(jnp, dtype),
                         weight_quant='int8').apply(jq, jx)
    port = td.OwnedDense(32, 16, dtype=getattr(torch, dtype),
                         weight_quant='int8', device='cpu')
    port.load_state_dict({
        'weight_q': torch.from_numpy(
            np.array(jq['params']['kernel_q']).T.copy()),
        'weight_scale': torch.from_numpy(
            np.array(jq['params']['kernel_scale'])),
        'bias': torch.from_numpy(params['params']['bias'])})
    with torch.no_grad():
        got = port(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    # The float twin: within the int8 class.
    flt = td.OwnedDense(32, 16, dtype=getattr(torch, dtype), device='cpu')
    flt.load_state_dict({'weight': torch.from_numpy(
        params['params']['kernel'].T.copy()),
        'bias': torch.from_numpy(params['params']['bias'])})
    with torch.no_grad():
        ref = flt(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert _rel_err(got.float(), ref.float()) < WQ8_RTOL
    with pytest.raises(ValueError, match='weight_quant'):
        td.OwnedDense(4, 4, weight_quant='int4', device='cpu')


def test_weight_scale_stays_float32_under_a_dtype_cast():
    port = td.OwnedDense(32, 16, weight_quant='int8', device='cpu')
    scale = port.weight_scale.clone()
    port = port.to(torch.bfloat16)
    assert port.weight_scale.dtype == torch.float32
    assert torch.equal(port.weight_scale, scale)
    assert port.weight_q.dtype == torch.int8
    assert port.bias.dtype == torch.bfloat16
    model = TransformerLM(32, 16, 2, n_layers=1, weight_quant='int8',
                          device='cpu').half()
    for name, buf in model.named_buffers():
        if name.endswith('weight_scale'):
            assert buf.dtype == torch.float32, name


def test_quantize_dense_params_keys_and_bytes():
    """The port's rule leaves the embedding, the untied head, LayerNorm
    and biases alone, on a module and on its state dict alike; the
    quantized model loads strictly into the int8 twin, whose state equals
    the reference's quantized tree converted; the byte counts equal the
    reference's."""
    kw = dict(vocab_size=48, dim=16, num_heads=2, n_layers=2,
              attn_kwargs={'distributed': False}, tie_embeddings=False)
    tok = jnp.zeros((1, 4), jnp.int32)
    jp = _np(JaxLM(**kw).init(jax.random.key(0), tok))
    jq = jd.quantize_dense_params(jp)
    port = TransformerLM(48, 16, 2, n_layers=2, tie_embeddings=False,
                         device='cpu')
    port.load_state_dict(lm_state_from_jax(jp))
    for q in (td.quantize_dense_params(port),
              td.quantize_dense_params(port.state_dict())):
        kept = {k for k in q if not k.endswith(('weight_q',
                                                'weight_scale'))}
        assert kept == {k for k in port.state_dict()
                        if not k.endswith('.weight')}
        assert {'embedding', 'lm_head_kernel', 'ln_f.scale',
                'stack.blocks.0.ln1.bias'} <= kept
        assert sum(k.endswith('weight_q') for k in q) == 2 * 6
        want = lm_state_from_jax(jq)
        assert q.keys() == want.keys()
        for k, v in want.items():
            assert torch.equal(q[k], v), k
        twin = TransformerLM(48, 16, 2, n_layers=2, tie_embeddings=False,
                             weight_quant='int8', device='cpu')
        twin.load_state_dict(q)
    assert td.dense_param_bytes(q) == jd.dense_param_bytes(jq)
    assert td.dense_param_bytes(port) == jd.dense_param_bytes(jp)
    assert td.dense_param_bytes(q) < td.dense_param_bytes(port)


# -- the models at int8 ---------------------------------------------------

def _x(t=7, d=16, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (2, t, d)).astype(np.float32)


def _close_and_near_float(got, want, flt):
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    assert _rel_err(got, flt) < WQ8_RTOL


def test_attention_module_int8_forward_and_decode():
    kw = dict(key_dim=16, num_heads=2, causal=True, distributed=False,
              softmax_impl='flash')
    x = _x()
    jx = jnp.asarray(x)
    jf = JaxAttn(**kw)
    params = _np(jf.init(jax.random.key(1), jx, jx, jx))
    jq = jd.quantize_dense_params(params)
    jm = JaxAttn(weight_quant='int8', **kw)
    port = DistributedDotProductAttn(weight_quant='int8', device='cpu', **kw)
    port.load_state_dict(attn_state_from_jax(jq))
    flt = DistributedDotProductAttn(device='cpu', **kw)
    flt.load_state_dict(attn_state_from_jax(params))
    tx = torch.from_numpy(x)
    with torch.no_grad():
        _close_and_near_float(port(tx, tx, tx).numpy(),
                              jm.apply(jq, jx, jx, jx),
                              flt(tx, tx, tx).numpy())
        jc, tc = jm.make_decode_cache(2, 10), port.make_decode_cache(2, 10)
        jc, want = jm.apply(jq, jx[:, :4], jx[:, :4], jx[:, :4], jc,
                            method='prefill')
        tc, got = port.prefill(tx[:, :4], tx[:, :4], tx[:, :4], tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for t in range(4, 7):
            s = slice(t, t + 1)
            jc, want = jm.apply(jq, jx[:, s], jx[:, s], jx[:, s], jc,
                                method='decode')
            tc, got = port.decode(tx[:, s], tx[:, s], tx[:, s], tc)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=f't={t}', **TOL)


def test_block_int8_forward_and_decode():
    attn_kw = dict(distributed=False, causal=True, softmax_impl='flash')
    x = _x(seed=4)
    jx = jnp.asarray(x)
    params = _np(JaxBlock(dim=16, num_heads=2, attn_kwargs=attn_kw).init(
        jax.random.key(2), jx))
    jq = jd.quantize_dense_params(params)
    jb = JaxBlock(dim=16, num_heads=2, attn_kwargs=attn_kw,
                  weight_quant='int8')
    state = stack_state_from_jax({'block_0': jq['params']})
    port = TransformerBlock(16, 2, weight_quant='int8', attn_kwargs=attn_kw,
                            device='cpu')
    port.load_state_dict({k[len('blocks.0.'):]: v for k, v in state.items()})
    flt = TransformerBlock(16, 2, attn_kwargs=attn_kw, device='cpu')
    fstate = stack_state_from_jax({'block_0': params['params']})
    flt.load_state_dict({k[len('blocks.0.'):]: v for k, v in fstate.items()})
    tx = torch.from_numpy(x)
    with torch.no_grad():
        _close_and_near_float(port(tx).numpy(), jb.apply(jq, jx),
                              flt(tx).numpy())
        jc = jax_init_cache(2, 2, 10, 8, dtype=jnp.float32)
        tc = port.attn.make_decode_cache(2, 10)
        jc, want = jb.apply(jq, jx[:, :5], jc, method='prefill')
        tc, got = port.prefill(tx[:, :5], tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for t in (5, 6):
            jc, want = jb.apply(jq, jx[:, t:t + 1], jc, method='decode')
            tc, got = port.decode(tx[:, t:t + 1], tc)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=f't={t}', **TOL)


@pytest.mark.parametrize('scan', [False, True], ids=['unrolled', 'scanned'])
def test_stack_int8_forward_and_decode(scan):
    attn_kw = dict(distributed=False, causal=True, softmax_impl='flash')
    x = _x(seed=5)
    jx = jnp.asarray(x)
    kw = dict(dim=16, num_heads=2, n_layers=2, scan_layers=scan,
              attn_kwargs=attn_kw)
    params = _np(JaxStack(**kw).init(jax.random.key(3), jx, jx, jx))
    jq = jd.quantize_dense_params(params)
    js = JaxStack(weight_quant='int8', **kw)
    port = TransformerStack(16, 2, n_layers=2, scan_layers=scan,
                            weight_quant='int8', attn_kwargs=attn_kw,
                            device='cpu')
    port.load_state_dict(stack_state_from_jax(jq))
    flt = TransformerStack(16, 2, n_layers=2, scan_layers=scan,
                           attn_kwargs=attn_kw, device='cpu')
    flt.load_state_dict(stack_state_from_jax(params))
    tx = torch.from_numpy(x)
    with torch.no_grad():
        _close_and_near_float(port(tx).numpy(), js.apply(jq, jx, jx, jx),
                              flt(tx).numpy())
        jc = js.make_decode_caches(2, 10)
        tc = port.make_decode_caches(2, 10)
        jc, want = js.apply(jq, jx[:, :5], jc, method='prefill')
        tc, got = port.prefill(tx[:, :5], tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        for t in (5, 6):
            jc, want = js.apply(jq, jx[:, t:t + 1], jc, method='decode')
            tc, got = port.decode(tx[:, t:t + 1], tc)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       err_msg=f't={t}', **TOL)


def test_lm_int8_logits_decode_and_greedy():
    kw = dict(vocab_size=48, dim=16, num_heads=2, n_layers=2,
              attn_kwargs={'distributed': False})
    prompt = np.random.default_rng(6).integers(0, 48, (2, 7), np.int32)
    jt = jnp.asarray(prompt)
    params = _np(JaxLM(**kw).init(jax.random.key(4), jt))
    jq = jd.quantize_dense_params(params)
    jm = JaxLM(weight_quant='int8', **kw)
    port = TransformerLM(48, 16, 2, n_layers=2, weight_quant='int8',
                         attn_kwargs={'distributed': False}, device='cpu')
    port.load_state_dict(lm_state_from_jax(jq))
    flt = TransformerLM(48, 16, 2, n_layers=2,
                        attn_kwargs={'distributed': False}, device='cpu')
    flt.load_state_dict(lm_state_from_jax(params))
    tt = torch.from_numpy(prompt)
    with torch.no_grad():
        _close_and_near_float(port(tt).numpy(), jm.apply(jq, jt),
                              flt(tt).numpy())
        jc, want = jm.apply(jq, jt, jm.make_decode_caches(2, 16),
                            method='prefill')
        tc, got = port.prefill(tt, port.make_decode_caches(2, 16))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        nxt = np.asarray(want)[:, -1:].argmax(-1).astype(np.int32)
        _, want = jm.apply(jq, jnp.asarray(nxt), jc, method='decode')
        _, got = port.decode(torch.from_numpy(nxt), tc)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want = jax_greedy(jm, jq, jt, 6, 16)
    np.testing.assert_array_equal(greedy_generate(port, tt, 6, 16).numpy(),
                                  np.asarray(want))


# -- the engine -----------------------------------------------------------

@pytest.mark.parametrize('var,values', [
    ('DDP_TPU_WEIGHT_QUANT', ['int8', '1', 'true', '', 'off', 'int4']),
    ('DDP_TPU_DECODE_KERNEL', ['1', 'kernel', '0', 'xla', 'false', '']),
    ('DDP_TPU_PAGED_CACHE', ['1', 'paged', 'slab', '0', '']),
])
def test_engine_knobs_resolve_as_the_reference(monkeypatch, var, values):
    """Each env value resolves to the reference's setting (its 'xla' and
    'auto' are the port's 'plain' and 'kernel'); an explicit argument
    wins, 'off' overrides the weight knob; the engine reads them."""
    name = {'DDP_TPU_WEIGHT_QUANT': '_resolve_weight_quant',
            'DDP_TPU_DECODE_KERNEL': '_resolve_decode_impl',
            'DDP_TPU_PAGED_CACHE': '_resolve_cache_mode'}[var]
    as_port = {'xla': 'plain', 'auto': 'kernel'}
    for value in values:
        monkeypatch.setenv(var, value)
        want = getattr(jax_engine_mod, name)(None)
        assert getattr(port_engine_mod, name)(None) == as_port.get(want,
                                                                    want)
    monkeypatch.setenv('DDP_TPU_WEIGHT_QUANT', 'int8')
    monkeypatch.setenv('DDP_TPU_DECODE_KERNEL', 'xla')
    monkeypatch.setenv('DDP_TPU_PAGED_CACHE', 'paged')
    eng = KernelEngine(slots=2, t_max=8, device='cpu')
    assert (eng.weight_quant, eng.decode_impl, eng.cache_mode) == (
        'int8', 'plain', 'paged')
    eng = KernelEngine(slots=2, t_max=8, weight_quant='off',
                       decode_impl='kernel', cache_mode='slab',
                       device='cpu')
    assert (eng.weight_quant, eng.decode_impl, eng.cache_mode) == (
        None, 'kernel', 'slab')
    with pytest.raises(ValueError, match='weight_quant'):
        KernelEngine(slots=2, t_max=8, weight_quant='fp4', device='cpu')


VOCAB, T_MAX, SLOTS, CHUNK = 48, 64, 4, 4
_WEIGHTS = ('_embed', '_wq', '_wk', '_wv', '_wo')


def _engines(mode, seed=5, **kw):
    """The reference int8 engine and the port's, built from the reference
    engine's float weights of the same seed."""
    ekw = dict(slots=SLOTS, t_max=T_MAX, vocab=VOCAB, heads=2, head_dim=4,
               prefill_chunk=CHUNK, seed=seed)
    if mode == 'paged':
        ekw.update(cache_mode='paged', page_size=4)
    flt = JaxEngine(decode_impl='xla', weight_quant='off', **ekw)
    je = JaxEngine(decode_impl='xla', weight_quant='int8', **ekw)
    te = KernelEngine(weight_quant='int8', device='cpu', **ekw, **kw)
    te.load_weights(engine_state_from_jax(
        {n: np.asarray(getattr(flt, n)) for n in _WEIGHTS}))
    return je, te


def _burst(scheduler, rejected_error, n=16, seed=11):
    rng = np.random.default_rng(seed)
    rejected = {}
    for i in range(n):
        prompt = rng.integers(0, VOCAB, size=int(rng.integers(1, 9)))
        try:
            scheduler.submit(prompt.astype(np.int32), request_id=f'r{i:03d}')
        except rejected_error as e:
            rejected[f'r{i:03d}'] = e.reason.value
        if i % 4 == 3:
            scheduler.step()
    results = scheduler.run_until_idle()
    scheduler.close()
    return rejected, {rid: (r.status, list(r.tokens))
                      for rid, r in results.items()}


def _cfg(cls):
    return cls(queue_limit=16, max_new_tokens=6, watchdog=False,
               evict_before_reject=False)


@pytest.mark.parametrize('mode', ['slab', 'paged'])
def test_engine_int8_streams_and_bytes_match_jax(mode):
    je, te = _engines(mode)
    assert te.weight_bytes == je.weight_bytes
    np.testing.assert_array_equal(te._wq[0].numpy(),
                                  np.asarray(je._wq[0]).T)
    np.testing.assert_array_equal(te._wo[1].numpy(), np.asarray(je._wo[1]))
    want = _burst(JaxScheduler(je, _cfg(JaxConfig), registry=JaxRegistry(),
                               fault_injector=False), JaxRejected)
    got = _burst(Scheduler(te, _cfg(ServeConfig), registry=MetricsRegistry(),
                           fault_injector=False), RejectedError)
    assert got == want
    assert sum(s == 'completed' for s, _ in got[1].values()) >= 8
    flt = KernelEngine(slots=SLOTS, t_max=T_MAX, vocab=VOCAB, heads=2,
                       head_dim=4, device='cpu')
    assert te.weight_bytes < flt.weight_bytes


def _port_run(mode, injector=None, **kw):
    _, te = _engines(mode, **kw)
    return _burst(Scheduler(te, _cfg(ServeConfig), registry=MetricsRegistry(),
                            fault_injector=injector or False),
                  RejectedError, n=16)


def test_engine_int8_slab_equals_paged_under_the_cocktail():
    """The reference's cocktail check at int8 weights (stuck step, NaN
    slot): every request both runs complete has the same tokens."""
    plan = dict(stuck_at_step=3, stuck_seconds=0.02, nan_at_step=5,
                nan_slot=1)
    _, res_s = _port_run('slab', faults.ServeFaultInjector(
        faults.ServeFaultPlan(**plan)))
    _, res_p = _port_run('paged', faults.ServeFaultInjector(
        faults.ServeFaultPlan(**plan)))
    compared = 0
    for rid, (status, tokens) in res_p.items():
        if status != 'completed' or res_s.get(rid, ('',))[0] != 'completed':
            continue
        assert tokens == res_s[rid][1], rid
        compared += 1
    assert compared >= 5


def test_engine_int8_kv_shards_equal_the_single_pool():
    assert _port_run('paged', kv_shards=2) == _port_run('paged')
