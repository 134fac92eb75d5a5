# -*- coding: utf-8 -*-
"""
Sequence-sharded decode on the port against the reference package, on
the same seeded float32 inputs:

- K5/K5p's ``partials=True`` and ``window`` in the plain version
  (``flash_decode_plain``, what the CUDA kernel is held to on the card)
  against the reference ``flash_decode(partials=True, interpret=True)``,
  slab and paged, with and without a window, with ``valid_to`` negative
  (the slab wholly in the query's future: an empty row), past the slab
  (wholly in its past) and an empty page-table row;
- ``decode_attention(col_offset=, col_valid=, window=)`` against the
  reference's (no ``axis_name``: that path of the reference is broken on
  this jax, so the sharded steps are held against its LOCAL decode, as
  ``dryrun_multichip`` does);
- ``append_kv_sharded`` + ``decode_attention`` over gloo groups of W = 2
  and 4 with a prefill chunk that straddles slabs, against the
  reference's local append + attention;
- the module's ``decode_seq_parallel`` on W = 2 and 4 against the
  reference module's local ``decode`` with converted parameters: the
  recipe's GQA + RoPE module after a prefill, a windowed module, steps
  whose owner moves to the next rank, both ``decode_impl``s, and the
  eager overflow raise after which no rank's slab has changed;
- the recipe's own stage (``__graft_entry__.py``): 3 steps on the 2 × 2
  data × seq group against the local decode.

Tolerance: float32, atol = rtol = 1e-5 (``m`` of the partials 1e-6
absolute); caches bit for bit.
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
from distributed_dot_product_tpu_torch import attn_state_from_jax
from distributed_dot_product_tpu_torch.models import decode as tdec
from distributed_dot_product_tpu_torch.ops.flash_decode import (
    _NEG_BIG, flash_decode_plain,
)

TOL = dict(atol=1e-5, rtol=1e-5)
D, T_MAX = 8, 16


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
    return torch.from_numpy(np.array(x))


# (valid_to, append_at) per row: mid-cache, the last column, an empty row
# (the slab in the query's future), past the slab (wholly in its past), a
# frozen row. Columns are 0..T_MAX-1.
ROWS = ((6, 6), (T_MAX - 1, T_MAX - 1), (-3, -1), (T_MAX + 5, -1), (9, -1))


@pytest.mark.parametrize('window', [None, 3, 11], ids=str)
@pytest.mark.parametrize('paged', [False, True], ids=['slab', 'paged'])
def test_flash_decode_partials_match_jax(paged, window):
    rng = np.random.default_rng(7 + bool(paged) + (window or 0))
    b, h, h_kv, ps = len(ROWS), 4, 2, 4
    vt = np.array([r[0] for r in ROWS], np.int32)
    ap = np.array([r[1] for r in ROWS], np.int32)
    q, kn, vn = (_rand(rng, b, h, 1, D), _rand(rng, b, h_kv, 1, D),
                 _rand(rng, b, h_kv, 1, D))
    kw, tkw = {}, {}
    if paged:
        pages, pps = 24, T_MAX // ps
        table = rng.permutation(pages)[:b * pps].reshape(b, pps)
        table = table.astype(np.int32)
        table[4, 2:] = -1               # frozen row: two pages held
        table[2] = -1                   # the empty row holds no page
        ck = _rand(rng, pages + 1, h_kv, ps, D)
        cv = _rand(rng, pages + 1, h_kv, ps, D)
        kw = dict(page_table=jnp.asarray(table))
        tkw = dict(page_table=_t(table))
    else:
        ck, cv = _rand(rng, b, h_kv, T_MAX, D), _rand(rng, b, h_kv, T_MAX, D)
    (wn, wm, wl), wk, wv, _, _ = jax_flash_decode(
        *(jnp.asarray(x) for x in (q, kn, vn, ck, cv, vt, ap)),
        window=window, partials=True, interpret=True, **kw)
    tk, tv = _t(ck), _t(cv)
    (gn, gm, gl), _, _ = flash_decode_plain(
        _t(q), _t(kn), _t(vn), tk, tv, _t(vt), _t(ap), window=window,
        partials=True, **tkw)
    assert gn.dtype == gm.dtype == gl.dtype == torch.float32
    assert gn.shape == (b, h, 1, D) and gm.shape == gl.shape == (b, h, 1, 1)
    np.testing.assert_allclose(gm.numpy(), np.asarray(wm), atol=1e-6, rtol=0)
    np.testing.assert_allclose(gl.numpy(), np.asarray(wl), **TOL)
    np.testing.assert_allclose(gn.numpy(), np.asarray(wn), **TOL)
    # The empty row (valid_to < 0): exactly (0, _NEG_BIG, 0), as the
    # reference initialises its running max.
    assert not gn[2].any() and not gl[2].any()
    assert (gm[2] == np.float32(_NEG_BIG)).all()
    np.testing.assert_array_equal(tk.numpy()[:-1] if paged else tk.numpy(),
                                  np.asarray(wk)[:-1] if paged
                                  else np.asarray(wk))
    # The normalised output is the partials divided, as without partials.
    out, _, _ = flash_decode_plain(
        _t(q), _t(kn), _t(vn), _t(ck), _t(cv), _t(vt), _t(ap), window=window,
        **tkw)
    np.testing.assert_allclose(
        out.numpy(), (gn / torch.where(gl == 0, 1, gl)).numpy(), **TOL)


def test_neg_big_is_the_kernels():
    """The CUDA kernel's NEG_BIG is the port's ``_NEG_BIG`` in float32: an
    empty shard's max must be the same number on both sides of the
    cross-shard merge."""
    src = (tdec.__file__.rsplit('/models/', 1)[0] + '/csrc/flash_decode.cu')
    line = next(ln for ln in open(src) if 'kNegBig =' in ln)
    assert line.split('=')[1].strip() == '-0.7f * 3.4e38f;'
    assert np.float32(-0.7) * np.float32(3.4e38) == np.float32(_NEG_BIG)


@pytest.mark.parametrize('case', ['offset', 'valid', 'window', 'all'])
def test_decode_attention_masks_match_jax(case):
    rng = np.random.default_rng(len(case))
    b, h, h_kv, n = 3, 4, 2, 1
    q = _rand(rng, b, h, n, D)
    k, v = _rand(rng, b, h_kv, T_MAX, D), _rand(rng, b, h_kv, T_MAX, D)
    length = 21
    kw = {}
    if case in ('offset', 'all'):
        kw['col_offset'] = 8                    # columns sit at 8..23
    if case in ('valid', 'all'):
        kw['col_valid'] = rng.random((b, T_MAX)) < 0.6
    if case in ('window', 'all'):
        kw['window'] = 6
    jc = jdec.DecodeCache(k=jnp.asarray(k), v=jnp.asarray(v),
                          length=jnp.asarray(length, jnp.int32))
    want = jdec.decode_attention(
        jnp.asarray(q), jc, **{k_: (jnp.asarray(v_) if k_ == 'col_valid'
                                    else v_) for k_, v_ in kw.items()})
    tc = tdec.DecodeCache(_t(k), _t(v), length)
    got = tdec.decode_attention(
        _t(q), tc, **{k_: (_t(v_) if k_ == 'col_valid' else v_)
                      for k_, v_ in kw.items()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize('window', [None, 5], ids=str)
@pytest.mark.parametrize('world', [2, 4])
def test_sharded_append_and_attention_match_local(groups, world, window):
    """A 13-row prefill chunk (straddling the slabs), then two single
    rows; q attends the 15-deep prefix — the reference's own case."""
    rng = np.random.default_rng(world)
    b, h, h_kv, t_max = 2, 4, 2, 32
    k1, v1 = _rand(rng, b, h_kv, 13, D), _rand(rng, b, h_kv, 13, D)
    ks = [k1, k1[:, :, :1] + 1.0, k1[:, :, 1:2] * 2.0]
    vs = [v1, v1[:, :, :1] - 1.0, v1[:, :, 1:2] * 0.5]
    q = _rand(rng, b, h, 1, D)
    jc = jdec.init_cache(b, h_kv, t_max, D, dtype=jnp.float32)
    for k, v in zip(ks, vs):
        jc = jdec.append_kv(jc, jnp.asarray(k), jnp.asarray(v))
    want = jdec.decode_attention(jnp.asarray(q), jc, window=window)
    for out, length, gk, gv in groups(world).run(
            'decode_sharded_ops', ks, vs, q, window, t_max):
        assert length == 15
        np.testing.assert_allclose(out, np.asarray(want), **TOL)
        np.testing.assert_array_equal(gk, np.asarray(jc.k))
        np.testing.assert_array_equal(gv, np.asarray(jc.v))


def _jax_local_decode(build, prompt, xs, t_max):
    """The reference module's local decode (after ``prefill(prompt)``):
    its converted parameters and each step's output."""
    jm = build()
    x0 = jnp.asarray(xs[:, :1])
    params = jm.init(jax.random.key(1), x0, x0, x0, None)
    cache = jm.make_decode_cache(xs.shape[0], t_max)
    if prompt is not None:
        p = jnp.asarray(prompt)
        cache, _ = jm.apply(params, p, p, p, cache, method='prefill')
    outs = []
    for t in range(xs.shape[1]):
        x = jnp.asarray(xs[:, t:t + 1])
        cache, out = jm.apply(params, x, x, x, cache, method='decode')
        outs.append(np.asarray(out))
    state = {k: v.numpy() for k, v in attn_state_from_jax(
        jax.tree.map(np.asarray, params)).items()}
    return state, outs, np.asarray(cache.k)


# name: (module kwargs, prompt rows, decode steps); global t_max 16 — the
# recipe's GQA + RoPE module, and a windowed one. Prompt + steps cross the
# slab boundary at 8 (W = 2) and at 4, 8, 12 (W = 4).
MODULES = {
    'gqa_rope': (dict(key_dim=32, num_heads=4, num_kv_heads=2, causal=True,
                      use_rope=True), 5, 6),
    'window': (dict(key_dim=32, num_heads=4, causal=True, window=3), 0, 10),
}


@pytest.mark.parametrize('impl', ['kernel', 'plain'])
@pytest.mark.parametrize('world', [2, 4])
@pytest.mark.parametrize('name', sorted(MODULES))
def test_module_decode_sharded_matches_jax_local(groups, name, world, impl):
    kw, n_prompt, steps = MODULES[name]
    rng = np.random.default_rng(10 * sorted(MODULES).index(name) + world)
    b = 2
    xs = _rand(rng, b, steps, kw['key_dim'])
    prompt = _rand(rng, b, n_prompt, kw['key_dim']) if n_prompt else None
    state, want, want_k = _jax_local_decode(lambda: JaxAttn(**kw), prompt,
                                            xs, T_MAX)
    res = groups(world).run('decode_sharded_module',
                            dict(kw, decode_impl=impl), state, prompt, xs,
                            T_MAX, False)
    for outs, length, gk, _ in res:
        assert length == n_prompt + steps
        for t, (got, ref) in enumerate(zip(outs, want)):
            np.testing.assert_allclose(got, ref, err_msg=f't={t}', **TOL)
        np.testing.assert_allclose(gk, want_k, atol=1e-6, rtol=0)


@pytest.mark.parametrize('impl', ['kernel', 'plain'])
def test_sharded_overflow_raises_on_every_rank_and_writes_nothing(groups,
                                                                  impl):
    """The port's lengths are host ints: a step past the global capacity
    raises eagerly on every rank (so every rank skips the step's
    collectives alike) and leaves every slab as it was."""
    kw = dict(key_dim=16, num_heads=2, causal=True, decode_impl=impl)
    rng = np.random.default_rng(5)
    state = {k: v.numpy() for k, v in attn_state_from_jax(jax.tree.map(
        np.asarray, JaxAttn(key_dim=16, num_heads=2, causal=True).init(
            jax.random.key(0), *(jnp.ones((1, 1, 16)),) * 3, None))).items()}
    xs = _rand(rng, 1, 8, 16)
    for outs, length, _, (err, kept) in groups(4).run(
            'decode_sharded_module', kw, state, None, xs, 8, False, True):
        assert length == 8 and len(outs) == 8
        assert err is not None and 'overflow' in err and kept


def test_recipe_sharded_decode_stage_on_2x2(groups):
    """``dryrun_multichip``'s sharded-decode stage: GQA + RoPE (dim 64,
    4 heads on 2 kv heads), B 4, t_cap 8 over the 2 × 2 data × seq group
    (slabs of 4 on the seq ranks, replicated over data), 3 steps against
    the local decode — at 1e-5 here (the recipe asks 1e-4)."""
    kw = dict(key_dim=64, num_heads=4, num_kv_heads=2, causal=True,
              use_rope=True)
    xd = np.asarray(jax.random.normal(jax.random.key(7), (4, 3, 64),
                                      jnp.float32))
    state, want, _ = _jax_local_decode(lambda: JaxAttn(**kw), None, xd, 8)
    for outs, length, _, _ in groups(4).run('decode_sharded_module', kw,
                                            state, None, xd, 8, True):
        assert length == 3
        for t, (got, ref) in enumerate(zip(outs, want)):
            np.testing.assert_allclose(got, ref, err_msg=f't={t}', **TOL)


@pytest.mark.parametrize('kind', ['paged', 'per_slot'])
def test_sharded_step_takes_a_scalar_slab(kind):
    """The sharded step runs on a slab with one global length: a paged
    cache (the sequence-sharded page table is not ported) and a per-slot
    cache (a local serving construct, as in the reference) are refused
    before anything is written."""
    if kind == 'paged':
        cache = tdec.init_paged_cache(2, 2, 8, D, pages=4, page_size=4,
                                      dtype=torch.float32, device='cpu')
        error = NotImplementedError
    else:
        cache = tdec.init_slot_cache(2, 2, 8, D, dtype=torch.float32,
                                     device='cpu')
        error = ValueError
    x = torch.ones((2, 2, 1, D))
    for impl in ('kernel', 'plain'):
        with pytest.raises(error):
            tdec.decode_step(x, cache, x, x, group=object(), impl=impl)
    assert not cache.length.any()
