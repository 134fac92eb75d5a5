# -*- coding: utf-8 -*-
"""
ALiBi and packed segments in the port's decode path against the
reference package, on the same seeded float32 inputs (numpy). The CPU
runs K5/K5p's plain version, the arithmetic the CUDA kernel is held to
on the card.

- ``flash_decode`` with ALiBi: partial outputs on slab and paged caches
  (rows mid-cache, at the last column, wholly in the future, wholly in
  the past) against the reference kernel (``interpret=True``);
- ``decode_step`` with ALiBi, slab and paged, at n = 1 (a frozen slot),
  verify-k (n = 3, per-slot counts) and with the int8 K mirror: both port
  impls against the reference kernel and its XLA step;
- ``decode_attention`` / ``decode_step`` with packed segments (and
  ALiBi): the plain step against the reference's XLA step, slab and
  paged, GQA; the kernel's verdict on segments;
- the module: ``prefill`` and ``decode`` with ALiBi and segments against
  the reference module's, and ``decode_sharded`` with ALiBi (both
  impls) and with segments on gloo groups of 2 and 4 against the
  reference module's local decode.

Tolerance: decode outputs ≤ 1e-5 (atol = rtol, float32, exp vs exp2 and
different reduction orders), the partials' maxima ≤ 1e-6 absolute;
caches and mirrors bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dist import GlooGroup

from distributed_dot_product_tpu import DistributedDotProductAttn as JaxAttn
from distributed_dot_product_tpu.models import decode as jdec
from distributed_dot_product_tpu.ops.pallas_decode import (
    flash_decode as jax_flash_decode,
)
from distributed_dot_product_tpu_torch import (
    DistributedDotProductAttn, attn_state_from_jax,
)
from distributed_dot_product_tpu_torch.models import decode as tdec
from distributed_dot_product_tpu_torch.ops.flash_decode import (
    flash_decode_plain,
)

TOL = dict(atol=1e-5, rtol=1e-5)
D, T, PS = 8, 32, 8
PRE = [5, 9, 0, 12]
SLOPES4 = (0.5, 0.25, 0.125, 0.0625)


@pytest.fixture(scope='module')
def groups(tmp_path_factory):
    made = {}

    def get(world):
        if world not in made:
            made[world] = GlooGroup(
                world, str(tmp_path_factory.mktemp(f'gloo{world}') / 'store'))
        return made[world]
    yield get
    for g in made.values():
        g.close()


def _rand(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _copy(cache):
    return type(cache)(*(x.clone() if isinstance(x, torch.Tensor)
                         else x if x is None else x.copy() for x in cache))


def _caches(rng, h_kv, paged, qk_quant=None):
    """Reference and port per-slot caches holding ``PRE`` rows per slot;
    paged: a scrambled table with pages for the prefix plus 4 rows."""
    b, rows = len(PRE), max(PRE)
    kn, vn = _rand(rng, b, h_kv, rows, D), _rand(rng, b, h_kv, rows, D)
    if paged:
        pool = tdec.PagePool(24, PS, b, T // PS)
        for s in range(b):
            assert pool.reserve_rows(s, PRE[s] + 4)[0]
        jc = jdec.init_paged_cache(b, h_kv, T, D, pages=24, page_size=PS,
                                   dtype=jnp.float32, qk_quant=qk_quant)
        jc = jc._replace(page_table=jnp.asarray(pool.table))
        tc = tdec.init_paged_cache(b, h_kv, T, D, pages=24, page_size=PS,
                                   dtype=torch.float32, qk_quant=qk_quant,
                                   device='cpu')
        tc.page_table.copy_(torch.from_numpy(pool.table))
    else:
        jc = jdec.init_cache(b, h_kv, T, D, dtype=jnp.float32,
                             qk_quant=qk_quant)
        jc = jc._replace(length=jnp.zeros((b,), jnp.int32))
        tc = tdec.init_cache(b, h_kv, T, D, dtype=torch.float32,
                             qk_quant=qk_quant, device='cpu')
        tc = tc._replace(length=np.zeros(b, np.int64))
    counts = np.asarray(PRE)
    jc = jdec.append_kv_slots(jc, jnp.asarray(kn), jnp.asarray(vn),
                              counts=jnp.asarray(counts, jnp.int32))
    tc = tdec.append_kv_slots(tc, _t(kn), _t(vn), counts=counts)
    return jc, tc


# (valid_to, append_at) per row: mid-cache, the last column, wholly in the
# future (an empty row), wholly in the past, a frozen row.
ROWS = ((6, 6), (T - 1, T - 1), (-3, -1), (T + 5, -1), (9, -1))


@pytest.mark.parametrize('paged', [False, True], ids=['slab', 'paged'])
def test_flash_decode_alibi_partials_match_jax(paged):
    rng = np.random.default_rng(1 + paged)
    b, h, h_kv = len(ROWS), 4, 2
    vt = np.array([r[0] for r in ROWS], np.int32)
    ap = np.array([r[1] for r in ROWS], np.int32)
    q, kn, vn = (_rand(rng, b, h, 1, D), _rand(rng, b, h_kv, 1, D),
                 _rand(rng, b, h_kv, 1, D))
    kw, tkw = {}, {}
    if paged:
        pages, pps = 24, T // PS
        table = rng.permutation(pages)[:b * pps].reshape(b, pps)
        table = table.astype(np.int32)
        table[2] = -1                   # the empty row holds no page
        ck = _rand(rng, pages + 1, h_kv, PS, D)
        cv = _rand(rng, pages + 1, h_kv, PS, D)
        kw, tkw = (dict(page_table=jnp.asarray(table)),
                   dict(page_table=_t(table)))
    else:
        ck, cv = _rand(rng, b, h_kv, T, D), _rand(rng, b, h_kv, T, D)
    sl = np.asarray(SLOPES4, np.float32)
    (wn, wm, wl), wk, _, _, _ = jax_flash_decode(
        *(jnp.asarray(x) for x in (q, kn, vn, ck, cv, vt, ap)),
        alibi_slopes=jnp.asarray(sl), partials=True, interpret=True, **kw)
    tk = _t(ck)
    (gn, gm, gl), _, _ = flash_decode_plain(
        _t(q), _t(kn), _t(vn), tk, _t(cv), _t(vt), _t(ap),
        alibi_slopes=_t(sl), partials=True, **tkw)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), atol=1e-6, rtol=0)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
    np.testing.assert_allclose(gn.numpy(), np.asarray(wn), **TOL)
    assert not gn[2].any() and not gl[2].any()
    body = slice(None, -1) if paged else slice(None)
    np.testing.assert_array_equal(tk.numpy()[body], np.asarray(wk)[body])


# name: (query heads, new rows n, int8 mirror)
STEPS = {'n1_mha': (2, 1, False), 'n1_gqa': (4, 1, False),
         'verify_k3': (4, 3, False), 'int8': (4, 1, True)}


@pytest.mark.parametrize('paged', [False, True], ids=['slab', 'paged'])
@pytest.mark.parametrize('case', sorted(STEPS))
def test_decode_step_alibi_matches_jax(case, paged):
    """Two ALiBi steps (a frozen slot; verify-k with per-slot counts
    3/2/1 and a frozen slot): the port's kernel path (K5/K5p's plain
    version) and plain path against the reference kernel (interpreted)
    and its XLA step; caches and mirrors bit for bit."""
    h, n, int8 = STEPS[case]
    h_kv = 2
    rng = np.random.default_rng(sorted(STEPS).index(case) + 10 * paged)
    jc, tc = _caches(rng, h_kv, paged, 'int8' if int8 else None)
    tcs = {'kernel': tc, 'plain': _copy(tc)}
    jcs = {'xla': jc, 'kernel': jc}
    b = len(PRE)
    sl = SLOPES4[:h]
    mask = np.array([True, True, True, False])
    extra = dict(qk_quant='int8') if int8 else {}
    counts = np.array([3, 2, 1, 3]) if n > 1 else None
    for _ in range(2):
        q, kn, vn = (_rand(rng, b, h, n, D), _rand(rng, b, h_kv, n, D),
                     _rand(rng, b, h_kv, n, D))
        want = {}
        for impl in jcs:
            kw = dict(interpret=True) if impl == 'kernel' else {}
            if counts is not None:
                kw['counts'] = jnp.asarray(counts, jnp.int32)
            jcs[impl], out = jdec.decode_step(
                jnp.asarray(q), jcs[impl], jnp.asarray(kn), jnp.asarray(vn),
                slot_mask=jnp.asarray(mask), alibi_slopes=jnp.asarray(sl),
                impl=impl, **extra, **kw)
            want[impl] = np.asarray(out)
        for impl in tcs:
            tcs[impl], got = tdec.decode_step(
                _t(q), tcs[impl], _t(kn), _t(vn), slot_mask=mask,
                counts=counts, alibi_slopes=sl, impl=impl, **extra)
            for ref_impl, ref in want.items():
                if counts is not None:
                    # Rows past a slot's count are don't-care outputs.
                    keep = np.arange(n)[None, :] < counts[:, None]
                    got_c = np.where(keep[:, None, :, None], got.numpy(), 0)
                    ref = np.where(keep[:, None, :, None], ref, 0)
                else:
                    got_c = got.numpy()
                np.testing.assert_allclose(got_c, ref,
                                           err_msg=f'{impl}/{ref_impl}',
                                           **TOL)
            body = slice(None, -1) if paged else slice(None)
            tk = tcs[impl].k_pool if paged else tcs[impl].k
            wk = jcs['xla'].k_pool if paged else jcs['xla'].k
            np.testing.assert_array_equal(tk.numpy()[body],
                                          np.asarray(wk)[body])
            if int8:
                tq = tcs[impl].k_q_pool if paged else tcs[impl].k_q
                wq = jcs['xla'].k_q_pool if paged else jcs['xla'].k_q
                np.testing.assert_array_equal(tq.numpy()[body],
                                              np.asarray(wq)[body])


def _segment_ids(b, t, cuts):
    seg = np.zeros((b, t), np.int32)
    for i, c in enumerate(cuts):
        seg[i, c:] = 1
    return seg


@pytest.mark.parametrize('alibi', [False, True], ids=['segments',
                                                      'segments_alibi'])
@pytest.mark.parametrize('paged', [False, True], ids=['slab', 'paged'])
def test_decode_step_segments_match_jax(paged, alibi):
    """Packed segments ride the plain step (the kernel's verdict says so,
    as the reference's does): one GQA step with each slot's query in its
    last document, against the reference's XLA step."""
    rng = np.random.default_rng(40 + 2 * paged + alibi)
    jc, tc = _caches(rng, 2, paged)
    b, h = len(PRE), 4
    seg = _segment_ids(b, T, (3, 4, 0, 7))
    seg_q = np.ones((b, 1), np.int32)
    seg_q[2] = 0
    q, kn, vn = (_rand(rng, b, h, 1, D), _rand(rng, b, 2, 1, D),
                 _rand(rng, b, 2, 1, D))
    kw = dict(alibi_slopes=SLOPES4) if alibi else {}
    _, want = jdec.decode_step(
        jnp.asarray(q), jc, jnp.asarray(kn), jnp.asarray(vn),
        segment_ids=jnp.asarray(seg), seg_q=jnp.asarray(seg_q), impl='xla',
        **{k: jnp.asarray(v) for k, v in kw.items()})
    ok, reason = tdec.decode_kernel_eligible(tc, 1, segment_ids=seg,
                                             explain=True)
    assert not ok and 'segment_ids' in reason
    with pytest.raises(ValueError, match='segment_ids'):
        tdec.decode_step(_t(q), _copy(tc), _t(kn), _t(vn),
                         segment_ids=_t(seg), seg_q=_t(seg_q), impl='kernel')
    _, got = tdec.decode_step(_t(q), tc, _t(kn), _t(vn), segment_ids=_t(seg),
                              seg_q=_t(seg_q), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- the module -------------------------------------------------------------

MOD = dict(key_dim=32, num_heads=4, causal=True, softmax_impl='flash',
           alibi_slopes=SLOPES4)


def test_module_prefill_and_decode_alibi_segments_match_jax():
    """A packed two-document prompt through ``prefill(segment_ids,
    seg_cache)``, then three ``decode`` steps in the second document, with
    ALiBi and RoPE: outputs against the reference module's; the same
    module without segments on both impls too."""
    b, n, steps, t_max = 2, 9, 3, 16
    rng = np.random.default_rng(50)
    prompt = _rand(rng, b, n, 32)
    xs = _rand(rng, b, steps, 32)
    seg_cache = _segment_ids(b, t_max, (4, 6))
    kw = dict(MOD, use_rope=True)
    jm = JaxAttn(**kw)
    params = jm.init(jax.random.key(2), *(jnp.asarray(prompt),) * 3, None)
    state = {k: torch.from_numpy(v.numpy()) for k, v in attn_state_from_jax(
        jax.tree.map(np.asarray, params)).items()}
    for segs in (True, False):
        want = []
        jc = jm.make_decode_cache(b, t_max)
        skw = (dict(segment_ids=jnp.asarray(seg_cache[:, :n]),
                    seg_cache=jnp.asarray(seg_cache)) if segs else {})
        p = jnp.asarray(prompt)
        jc, out = jm.apply(params, p, p, p, jc, method='prefill', **skw)
        want.append(np.asarray(out))
        for t in range(steps):
            x = jnp.asarray(xs[:, t:t + 1])
            skw = (dict(segment_ids=jnp.asarray(seg_cache[:, n + t:
                                                          n + t + 1]),
                        seg_cache=jnp.asarray(seg_cache)) if segs else {})
            jc, out = jm.apply(params, x, x, x, jc, method='decode', **skw)
            want.append(np.asarray(out))
        for impl in (None, 'plain'):
            mod = DistributedDotProductAttn(device='cpu', decode_impl=impl,
                                            **kw)
            mod.load_state_dict(state)
            with torch.no_grad():
                tc = mod.make_decode_cache(b, t_max)
                skw = (dict(segment_ids=_t(seg_cache[:, :n]),
                            seg_cache=_t(seg_cache)) if segs else {})
                p = _t(prompt)
                tc, out = mod.prefill(p, p, p, tc, **skw)
                got = [out.numpy()]
                for t in range(steps):
                    x = _t(xs[:, t:t + 1])
                    skw = (dict(segment_ids=_t(seg_cache[:, n + t:
                                                         n + t + 1]),
                                seg_cache=_t(seg_cache)) if segs else {})
                    tc, out = mod.decode(x, x, x, tc, **skw)
                    got.append(out.numpy())
            for i, (a, w) in enumerate(zip(got, want)):
                np.testing.assert_allclose(a, w, err_msg=f'{segs} {impl} {i}',
                                           **TOL)
    mod = DistributedDotProductAttn(device='cpu', **kw)
    with pytest.raises(ValueError, match='seg_cache'):
        mod.prefill(*(_t(prompt),) * 3, mod.make_decode_cache(b, t_max),
                    segment_ids=_t(seg_cache[:, :n]))


def _jax_local(prompt, seg_prompt, xs, seg_xs, t_max):
    """The reference module's local prefill + decode (segments when
    given): its converted state and each step's output."""
    jm = JaxAttn(**MOD)
    x0 = jnp.asarray(xs[:, :1])
    params = jm.init(jax.random.key(1), x0, x0, x0, None)
    cache = jm.make_decode_cache(xs.shape[0], t_max)
    seg_cache = None
    if seg_prompt is not None:
        n = seg_prompt.shape[1]
        seg_cache = np.zeros((xs.shape[0], t_max), np.int32)
        seg_cache[:, :n] = seg_prompt
        seg_cache[:, n:n + xs.shape[1]] = seg_xs

    def skw(ids):
        if seg_cache is None:
            return {}
        return dict(segment_ids=jnp.asarray(ids),
                    seg_cache=jnp.asarray(seg_cache))
    p = jnp.asarray(prompt)
    cache, _ = jm.apply(params, p, p, p, cache, method='prefill',
                        **skw(seg_prompt))
    outs = []
    for t in range(xs.shape[1]):
        x = jnp.asarray(xs[:, t:t + 1])
        cache, out = jm.apply(params, x, x, x, cache, method='decode',
                              **skw(None if seg_xs is None
                                    else seg_xs[:, t:t + 1]))
        outs.append(np.asarray(out))
    state = {k: v.numpy() for k, v in attn_state_from_jax(
        jax.tree.map(np.asarray, params)).items()}
    return state, outs


@pytest.mark.parametrize('world', [2, 4])
def test_module_decode_sharded_alibi_matches_jax_local(groups, world):
    """``decode_seq_parallel`` of the ALiBi module after a prefill, steps
    crossing the slab boundaries, both impls (the kernel path: K5 partials
    with ALiBi on every slab, merged), against the reference module's
    local decode."""
    rng = np.random.default_rng(60 + world)
    b, n, steps = 2, 5, 6
    prompt, xs = _rand(rng, b, n, 32), _rand(rng, b, steps, 32)
    state, want = _jax_local(prompt, None, xs, None, 16)
    for impl in ('kernel', 'plain'):
        for outs, length, _, _ in groups(world).run(
                'decode_sharded_module', dict(MOD, decode_impl=impl), state,
                prompt, xs, 16, False):
            assert length == n + steps
            for t, (got, ref) in enumerate(zip(outs, want)):
                np.testing.assert_allclose(got, ref, err_msg=f'{impl} {t}',
                                           **TOL)


@pytest.mark.parametrize('world', [2, 4])
def test_module_decode_sharded_segments_match_jax_local(groups, world):
    """The sharded decode with packed segments (each rank passes its
    slab's shard of the cached ids) and ALiBi against the reference
    module's local decode with the same ids."""
    rng = np.random.default_rng(70 + world)
    b, n, steps = 2, 7, 5
    prompt, xs = _rand(rng, b, n, 32), _rand(rng, b, steps, 32)
    seg_prompt = _segment_ids(b, n, (3, 5))
    seg_xs = np.ones((b, steps), np.int32)
    seg_xs[1, 2:] = 2                    # a third document starts
    state, want = _jax_local(prompt, seg_prompt, xs, seg_xs, 16)
    for outs in groups(world).run('decode_segments_module', MOD, state,
                                  prompt, seg_prompt, xs, seg_xs, 16):
        for t, (got, ref) in enumerate(zip(outs, want)):
            np.testing.assert_allclose(got, ref, err_msg=str(t), **TOL)
