# -*- coding: utf-8 -*-
"""
N-rank gloo harness for the port's multi-rank CPU tests, and the tasks
its ranks run.

:class:`GlooGroup` spawns ``world`` worker processes (a ``spawn``
context: a fresh interpreter each, importing only torch, numpy and the
port — never JAX) that join one gloo process group through a
``FileStore`` under the test's temporary directory, so concurrent test
workers never share a port. The group lives for a whole test module
(a module-scoped fixture) and runs one task after another:
``group.run('task', *args)`` calls ``task(rank, world, *args)`` below on
every rank and returns the per-rank results. Every wait has a deadline:
a rank that fails, or a group that does not answer in time, kills every
worker and fails the test — a hung rendezvous cannot eat the suite. The
workers bound their own waits too: the rendezvous and every collective
by the group's timeout, the wait for the next task by ``_IDLE_S`` (a
worker whose parent died exits instead of waiting forever).

Tasks take and return numpy arrays (pickled across the pipe); the tests
compute the reference package's numbers in their own process.
"""

import multiprocessing as mp
import queue
import time
import traceback

import numpy as np

__all__ = ['GlooGroup']

_JOIN_S = 30
_IDLE_S = 1800


class GlooGroup:
    """``world`` gloo ranks, alive until :meth:`close`."""

    def __init__(self, world, store_path, timeout=180):
        ctx = mp.get_context('spawn')
        self.world, self.timeout = world, timeout
        self._tasks = [ctx.Queue() for _ in range(world)]
        self._results = ctx.Queue()
        self._procs = [
            ctx.Process(target=_worker, name=f'gloo-rank-{r}', daemon=True,
                        args=(r, world, store_path, self._tasks[r],
                              self._results, timeout))
            for r in range(world)]
        for p in self._procs:
            p.start()
        self.run('ping')

    def run(self, task, *args, timeout=None):
        """``task(rank, world, *args)`` on every rank; the results in rank
        order. Raises (after killing the workers) when a rank fails or the
        deadline passes."""
        for q in self._tasks:
            q.put((task, args))
        deadline = time.monotonic() + (timeout or self.timeout)
        out, pending = [None] * self.world, set(range(self.world))
        while pending:
            try:
                rank, ok, value = self._results.get(
                    timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                self.close(kill=True)
                raise TimeoutError(
                    f'gloo task {task!r}: ranks {sorted(pending)} did not '
                    f'answer within {timeout or self.timeout} s; workers '
                    f'killed') from None
            if not ok:
                self.close(kill=True)
                raise RuntimeError(f'gloo task {task!r} failed on rank '
                                   f'{rank}:\n{value}')
            out[rank] = value
            pending.discard(rank)
        return out

    def close(self, kill=False):
        """Stop the workers: a clean exit, or (``kill``, and after the
        join deadline in any case) terminate them."""
        if not kill:
            for q in self._tasks:
                q.put(None)
            for p in self._procs:
                p.join(timeout=_JOIN_S)
        for p in self._procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=_JOIN_S)


def _worker(rank, world, store_path, tasks, results, timeout):
    import datetime
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group('gloo', store=store, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        while True:
            try:
                item = tasks.get(timeout=_IDLE_S)
            except queue.Empty:
                break
            if item is None:
                break
            name, args = item
            try:
                results.put((rank, True, globals()[name](rank, world,
                                                         *args)))
            except Exception:
                # Reported to the parent, which fails the test and kills
                # the group; the worker dies with it.
                results.put((rank, False, traceback.format_exc()))
                raise
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Tasks: ``task(rank, world, *args)`` on every rank.
# ---------------------------------------------------------------------------

def _t(a):
    import torch
    return None if a is None else torch.from_numpy(np.array(a))


def _np(t):
    return None if t is None else t.detach().cpu().numpy()


def ping(rank, world):
    return rank


def comm_contract(rank, world):
    """Every collective of ``utils/comm.py`` and the meshes of
    ``parallel/mesh.py`` on small tensors that encode their rank."""
    import torch
    from distributed_dot_product_tpu_torch.parallel import mesh as pm
    from distributed_dot_product_tpu_torch.utils import comm
    x = torch.arange(6, dtype=torch.float32).reshape(2, 3) + 10 * rank
    out = {
        'rank': comm.get_rank(), 'world': comm.get_world_size(),
        'main': comm.is_main_process(), 'axis_size': comm.axis_size(),
        'transport': comm.transport(None, 'cpu'),
        'gather': _np(comm.all_gather(x, dim=-2)),
        'gather_last': _np(comm.all_gather(x, dim=-1)),
        'stacked': _np(comm.all_gather_stacked(x)),
        'sum': _np(comm.all_reduce(x)),
        'max': _np(comm.all_reduce_max(torch.tensor([rank, -rank, 3.0]))),
        'world_group': comm.world_group() is not None,
        'scatter': _np(comm.reduce_scatter(
            torch.stack([x * (r + 1) for r in range(world)]))),
        'left': _np(comm.ring_shift((x,))[0]),
        'right': _np(comm.ring_shift((x,), direction=1)[0]),
        'a2a': _np(comm.all_to_all(
            torch.arange(world * 2 * 3, dtype=torch.float32).reshape(
                world * 2, 3, 1) + 100 * rank, split_dim=0, concat_dim=1)),
    }
    comm.synchronize()
    m = pm.seq_mesh()
    d = pm.data_seq_mesh(2, world // 2)
    out['seq_mesh'] = (m.shape, m.seq_rank, m.seq_size)
    out['data_seq'] = (d.shape, d.data_rank, d.seq_rank,
                       comm.get_world_size(d.seq_group),
                       comm.get_world_size(d.data_group))
    g = torch.arange(4 * 2 * world * 2, dtype=torch.float32).reshape(
        4, 2 * world, 2)
    shard = pm.shard_seq(g, d, seq_axis=-2, batch_axis=0)
    out['shard'] = _np(shard)
    out['unshard'] = _np(pm.unshard_seq(shard, d, seq_axis=-2,
                                        batch_axis=0))
    out['data_sum'] = _np(comm.all_reduce(x, d.data_group))
    sub = pm.seq_mesh(2)
    out['sub_member'] = sub.member
    return out


def matmul_global(rank, world, kind, left, right, kw):
    """A ``distributed_matmul_*_global`` product on global operands."""
    from distributed_dot_product_tpu_torch.ops import functions as F
    from distributed_dot_product_tpu_torch.parallel.mesh import seq_mesh
    fn = getattr(F, f'distributed_matmul_{kind}_global')
    return _np(fn(_t(left), _t(right), mesh=seq_mesh(world), **kw))


def matmul_errors(rank, world, left, right):
    """The reference's errors: offset < 1 and a tn width not divisible by
    the group width raise ValueError."""
    from distributed_dot_product_tpu_torch.ops import functions as F
    from distributed_dot_product_tpu_torch.parallel.mesh import (
        seq_mesh, shard_seq,
    )
    mesh = seq_mesh(world)
    a, b = shard_seq(_t(left), mesh), shard_seq(_t(right), mesh)
    raised = []
    for call in (lambda: F.distributed_matmul_nt(a, b, 0),
                 lambda: F.distributed_matmul_all(a, b, -1),
                 lambda: F.distributed_matmul_tn(a, b)):
        try:
            call()
            raised.append(None)
        except ValueError as exc:
            raised.append(str(exc))
    return raised


def ops_grad(rank, world, op, left, right, g, offset, impl):
    """Output and input gradients of one differentiable product on the
    shards of global operands, gathered back to global tensors."""
    import torch
    from distributed_dot_product_tpu_torch.ops import ops
    from distributed_dot_product_tpu_torch.parallel.mesh import (
        seq_mesh, shard_seq, unshard_seq,
    )
    mesh = seq_mesh(world)
    a = shard_seq(_t(left), mesh).clone().requires_grad_()
    b = shard_seq(_t(right), mesh).clone().requires_grad_()
    fn = {'nt': ops.RightTransposeMultiplication,
          'all': ops.FullMultiplication,
          'tn': ops.LeftTransposeMultiplication}[op]
    out = fn.apply(a, b, offset, None, impl)
    gl = shard_seq(_t(g), mesh)
    ga, gb = torch.autograd.grad(out, (a, b), gl)
    return [_np(unshard_seq(t, mesh)) for t in (out, ga, gb)]


def _module(kw, state):
    import torch
    from distributed_dot_product_tpu_torch import DistributedDotProductAttn
    mod = DistributedDotProductAttn(device='cpu', **kw)
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return mod


def module_fwd_grad(rank, world, kw, state, keys, queries, values, mask, g):
    """The module on this rank's shards of global inputs: the gathered
    output, the parameter gradients of ``sum(out * g)`` summed over the
    ranks, and the gathered input gradients; plus ``apply_seq_parallel``'s
    output on the same global tensors."""
    import torch
    from distributed_dot_product_tpu_torch.models.attention import (
        apply_seq_parallel,
    )
    from distributed_dot_product_tpu_torch.parallel.mesh import (
        seq_mesh, shard_seq, unshard_seq,
    )
    from distributed_dot_product_tpu_torch.utils.comm import all_reduce
    mesh = seq_mesh(world)
    mod = _module(kw, state)
    xs = [shard_seq(_t(a), mesh).clone().requires_grad_()
          for a in (keys, queries, values)]
    m = None if mask is None else shard_seq(_t(mask), mesh)
    out = mod(*xs, m)
    (out * shard_seq(_t(g), mesh)).sum().backward()
    grads = {n: _np(all_reduce(p.grad)) for n, p in mod.named_parameters()}
    with torch.no_grad():
        applied = apply_seq_parallel(mod, mesh, *(_t(a) for a in (
            keys, queries, values)), _t(mask))
    return (_np(unshard_seq(out, mesh)), grads,
            [_np(unshard_seq(x.grad, mesh)) for x in xs], _np(applied))


def ring_impls(rank, world, q, k, v, mask, causal):
    """``ring_attention`` with the flash folds and the plain folds on
    this rank's shards, gathered; gradients of ``sum(out)`` for both."""
    import torch
    from distributed_dot_product_tpu_torch.models.ring_attention import (
        ring_attention,
    )
    from distributed_dot_product_tpu_torch.parallel.mesh import (
        seq_mesh, shard_seq, unshard_seq,
    )
    mesh = seq_mesh(world)
    res = {}
    for impl in ('flash', 'xla'):
        xs = [shard_seq(_t(a), mesh).clone().requires_grad_()
              for a in (q, k, v)]
        m = None if mask is None else shard_seq(_t(mask), mesh)
        out = ring_attention(*xs, m, causal=causal, block_impl=impl)
        grads = torch.autograd.grad(out.sum(), xs)
        res[impl] = [_np(unshard_seq(t, mesh)) for t in (out, *grads)]
    return res


def attn_op(rank, world, fn, q, k, v, mask, seg, g, kw):
    """``ring_attention`` (``fn='ring'``) or ``ulysses_attention``
    (``'ulysses'``) with ``kw`` on this rank's time shards of global
    ``(B, H, T, d)`` inputs (a mask ``(B, 1, T, T)`` by rows, segment ids
    ``(..., T)`` by positions): the gathered output and the gathered
    gradients of ``sum(out * g)``."""
    from distributed_dot_product_tpu_torch.models.ring_attention import (
        ring_attention,
    )
    from distributed_dot_product_tpu_torch.models.ulysses_attention import (
        ulysses_attention,
    )
    from distributed_dot_product_tpu_torch.parallel.mesh import (
        seq_mesh, shard_seq, unshard_seq,
    )
    op = {'ring': ring_attention, 'ulysses': ulysses_attention}[fn]
    mesh = seq_mesh(world)
    xs = [shard_seq(_t(a), mesh).clone().requires_grad_()
          for a in (q, k, v)]
    m = None if mask is None else shard_seq(_t(mask), mesh)
    if seg is not None:
        kw = dict(kw, segment_ids=shard_seq(_t(seg), mesh, seq_axis=-1))
    out = op(*xs, m, group=mesh.seq_group, **kw)
    (out * shard_seq(_t(g), mesh)).sum().backward()
    return [_np(unshard_seq(t, mesh)) for t in (out, *(x.grad for x in xs))]


def decode_segments_module(rank, world, kw, state, prompt, seg_prompt, xs,
                           seg_xs, t_max):
    """The module's sequence-sharded decode with packed segments: the
    local cache filled by ``prefill(prompt, segment_ids=seg_prompt,
    seg_cache=...)`` and sharded, then one ``decode_sharded`` step per
    row of ``xs`` with its ids ``seg_xs (B, steps)``; the cached
    positions' ids ``(B, t_max)`` are prompt then steps, each rank passing
    its slab's shard. Returns each step's output."""
    import torch
    from distributed_dot_product_tpu_torch.parallel.mesh import (
        seq_mesh, shard_decode_cache, shard_seq,
    )
    mesh = seq_mesh(world)
    mod = _module(kw, state)
    b, n = seg_prompt.shape
    seg_cache = np.zeros((b, t_max), np.int32)
    seg_cache[:, :n] = seg_prompt
    seg_cache[:, n:n + seg_xs.shape[1]] = seg_xs
    outs = []
    with torch.no_grad():
        cache = mod.make_decode_cache(b, t_max)
        p = _t(prompt)
        cache, _ = mod.prefill(p, p, p, cache, _t(seg_prompt),
                               _t(seg_cache))
        cache = shard_decode_cache(cache, mesh)
        slab = shard_seq(_t(seg_cache), mesh, seq_axis=-1)
        for t in range(xs.shape[1]):
            x = _t(xs[:, t:t + 1])
            cache, out = mod.decode_sharded(x, x, x, cache,
                                            _t(seg_xs[:, t:t + 1]), slab,
                                            group=mesh.seq_group)
            outs.append(_np(out))
    return outs


def train_step(rank, world, kw, state, batch, opt, lr, guard=False):
    """One ``make_train_step`` step on a 2 x (world/2) data x seq mesh:
    the loss (or guarded record) and the parameters after the step."""
    import torch
    from distributed_dot_product_tpu_torch.parallel.mesh import (
        data_seq_mesh,
    )
    from distributed_dot_product_tpu_torch.train import make_train_step
    mesh = data_seq_mesh(2, world // 2)
    mod = _module(kw, state)
    optimizer = (torch.optim.SGD(mod.parameters(), lr=lr) if opt == 'sgd'
                 else torch.optim.Adam(mod.parameters(), lr=lr,
                                       betas=(0.9, 0.999), eps=1e-8))
    step = make_train_step(mod, optimizer, mesh, data_axis='data',
                           guard=guard)
    res = step(tuple(_t(a) for a in batch))
    if guard:
        res = {k: _np(v) for k, v in res.items()}
    else:
        res = _np(res)
    return res, {n: _np(p) for n, p in mod.state_dict().items()}


def _flagship_module(stage, kw, state):
    import torch
    from distributed_dot_product_tpu_torch import (
        DistributedDotProductAttn, TransformerLM, TransformerStack,
    )
    cls = {'stack': TransformerStack, 'lm': TransformerLM}.get(
        stage, DistributedDotProductAttn)
    mod = cls(device='cpu', **kw)
    mod.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    return mod


def flagship_step(rank, world, stage, kw, state, batch, seed):
    """One ``make_train_step`` step of ``dryrun_multichip``'s ``stage``
    (an attention module or a transformer stack) on a 2 x (world/2)
    data x seq group, SGD at lr 0 so the parameters' ``.grad`` is the
    step's summed gradient: the loss and every gradient."""
    import torch
    from distributed_dot_product_tpu_torch.parallel.mesh import (
        data_seq_mesh,
    )
    from distributed_dot_product_tpu_torch.train import make_train_step
    mesh = data_seq_mesh(2, world // 2)
    mod = _flagship_module(stage, kw, state)
    step = make_train_step(mod, torch.optim.SGD(mod.parameters(), lr=0.0),
                           mesh, data_axis='data')
    loss = step(tuple(None if a is None else _t(a) for a in batch),
                dropout_seed=seed)
    return _np(loss), {n: _np(p.grad) for n, p in mod.named_parameters()}


def flagship_lm(rank, world, kw, state, batch, prompt, t_max):
    """``make_lm_train_step`` over the 2 x (world/2) data x seq group on a
    ``(tokens, targets, segment_ids)`` batch (SGD at lr 0): the loss and
    every gradient; then ``greedy_generate`` on rank 0."""
    import torch
    from distributed_dot_product_tpu_torch.models.lm import greedy_generate
    from distributed_dot_product_tpu_torch.parallel.mesh import (
        data_seq_mesh,
    )
    from distributed_dot_product_tpu_torch.train import make_lm_train_step
    mesh = data_seq_mesh(2, world // 2)
    model = _flagship_module('lm', kw, state)
    step = make_lm_train_step(model, torch.optim.SGD(model.parameters(),
                                                     lr=0.0),
                              mesh, data_axis='data', loss_chunk=8)
    loss = step(tuple(_t(a) for a in batch))
    gen = (_np(greedy_generate(model, _t(prompt), 3, t_max)) if rank == 0
           else None)
    return (_np(loss), {n: _np(p.grad) for n, p in model.named_parameters()},
            gen)


def rope_shards(rank, world, x):
    """``rope_seq_parallel`` on this rank's time shard, gathered."""
    from distributed_dot_product_tpu_torch.ops.rope import rope_seq_parallel
    from distributed_dot_product_tpu_torch.parallel.mesh import (
        seq_mesh, shard_seq, unshard_seq,
    )
    mesh = seq_mesh(world)
    out = rope_seq_parallel(shard_seq(_t(x), mesh), group=mesh.seq_group)
    return _np(unshard_seq(out, mesh))


def decode_sharded_ops(rank, world, ks, vs, q, window, t_max):
    """``append_kv_sharded`` of each (k, v) chunk into this rank's slab of
    a ``t_max``-column global cache, then ``decode_attention`` merged over
    the group: the output and the gathered slabs."""
    import torch
    from distributed_dot_product_tpu_torch.models import decode as tdec
    from distributed_dot_product_tpu_torch.utils import comm
    b, h_kv, _, d = ks[0].shape
    cache = tdec.init_cache(b, h_kv, t_max // world, d, dtype=torch.float32,
                            device='cpu')
    for k, v in zip(ks, vs):
        cache = tdec.append_kv_sharded(cache, _t(k), _t(v),
                                       group=comm.world_group())
    out = tdec.decode_attention(_t(q), cache, window=window,
                                group=comm.world_group())
    return (_np(out), cache.length, _np(comm.all_gather(cache.k)),
            _np(comm.all_gather(cache.v)))


def decode_sharded_module(rank, world, kw, state, prompt, xs, t_max, mesh2d,
                          overflow=False):
    """The module's sequence-sharded decode on this rank's slab: the local
    cache filled by ``prefill(prompt)`` (when given) and sharded with
    ``shard_decode_cache``, then one ``decode_seq_parallel`` step per row
    of ``xs (B, steps, dim)``. Returns the outputs, the final length, the
    gathered slabs and, with ``overflow``, the error a step past the
    global capacity raises and whether the slab kept its bits."""
    import torch
    from distributed_dot_product_tpu_torch.models.attention import (
        decode_seq_parallel,
    )
    from distributed_dot_product_tpu_torch.parallel.mesh import (
        data_seq_mesh, seq_mesh, shard_decode_cache,
    )
    from distributed_dot_product_tpu_torch.utils import comm
    mesh = data_seq_mesh(2, world // 2) if mesh2d else seq_mesh(world)
    mod = _module(kw, state)
    with torch.no_grad():
        cache = mod.make_decode_cache(xs.shape[0], t_max)
        if prompt is not None:
            p = _t(prompt)
            cache, _ = mod.prefill(p, p, p, cache)
        cache = shard_decode_cache(cache, mesh)
        outs = []
        for t in range(xs.shape[1]):
            x = _t(xs[:, t:t + 1])
            cache, out = decode_seq_parallel(mod, mesh, x, x, x, cache)
            outs.append(_np(out))
        err = None
        if overflow:
            k0 = cache.k.clone()
            x = _t(xs[:, :1])
            try:
                decode_seq_parallel(mod, mesh, x, x, x, cache)
            except ValueError as exc:
                err = str(exc)
            err = (err, bool(torch.equal(k0, cache.k)))
    return (outs, cache.length,
            _np(comm.all_gather(cache.k, mesh.seq_group)), err)


def decode_sharded_paged(rank, world, k_pool, v_pool, lengths, steps,
                         window, impl):
    """``decode_step(group=...)`` on this rank's local view of a
    sequence-sharded page table: its block of the stacked pools
    ``k_pool``/``v_pool`` (``world`` shards) and, each step, its table of
    the step's stacked ``(world, slots, pages_per_slot)`` tables, one row
    a slot (``steps``: ``(tables, q, k_new, v_new, slot_mask)``). Returns
    the outputs and the rank's pools."""
    from distributed_dot_product_tpu_torch.models import decode as tdec
    from distributed_dot_product_tpu_torch.utils import comm
    cache = tdec.shard_view(tdec.PagedDecodeCache(
        _t(k_pool), _t(v_pool), _t(steps[0][0]), np.array(lengths)), rank)
    outs = []
    for tables, q, kn, vn, mask in steps:
        cache = cache._replace(page_table=_t(tables[rank]))
        cache, out = tdec.decode_step(_t(q), cache, _t(kn), _t(vn),
                                      slot_mask=mask, window=window,
                                      impl=impl, group=comm.world_group())
        outs.append(_np(out))
    return outs, _np(cache.k_pool), _np(cache.v_pool), cache.length


def checkpoint_stage(rank, world, kw, state, batch, ckdir):
    """``dryrun_multichip``'s checkpoint stage on a 2 x (world/2) data x
    seq group: one Adam step, a collective save, the next step; then a
    fresh module and Adam restored from the checkpoint take that step
    again. The two losses, the restored step, and whether the restored
    state equals the saved one bit for bit."""
    import torch
    from distributed_dot_product_tpu_torch.parallel.mesh import (
        data_seq_mesh,
    )
    from distributed_dot_product_tpu_torch.train import make_train_step
    from distributed_dot_product_tpu_torch.utils import checkpoint as ck
    mesh = data_seq_mesh(2, world // 2)
    tb = tuple(None if a is None else _t(a) for a in batch)

    def build():
        mod = _module(kw, state)
        opt = torch.optim.Adam(mod.parameters(), lr=1e-3)
        return mod, opt, make_train_step(mod, opt, mesh, data_axis='data')
    mod, opt, step = build()
    step(tb)
    ck.save(ckdir, ck.TrainState(1, mod.state_dict(), opt.state_dict()))
    saved = {k: v.clone() for k, v in mod.state_dict().items()}
    want = step(tb)
    mod2, opt2, step2 = build()
    restored = ck.restore(ckdir, ck.TrainState(0, mod2.state_dict(),
                                               opt2.state_dict()))
    mod2.load_state_dict(restored.params)
    opt2.load_state_dict(restored.opt_state)
    same = all(torch.equal(saved[k], v) for k, v in mod2.state_dict().items())
    got = step2(tb)
    return _np(want), _np(got), restored.step, same


def _split_pool(world, state, t_max=64):
    from distributed_dot_product_tpu_torch.parallel.mesh import seq_mesh
    from distributed_dot_product_tpu_torch.serve import PrefillPool
    pool = PrefillPool(t_max=t_max, page_size=16, vocab=32, seed=3,
                       mesh=seq_mesh(world), device='cpu')
    pool.engine.load_weights(state)
    return pool


def prefill_split(rank, world, state, prompts):
    """Every rank builds each prompt on a ``world``-rank PrefillPool:
    per prompt the (n_shards, bucket, pages' K, pages' V)."""
    pool = _split_pool(world, state)
    out = []
    for tokens in prompts:
        h = pool.build(tokens)
        pages = list(h.pages)
        out.append((pool.n_shards, pool._bucket(len(tokens)),
                    _np(pool.engine.cache.k_pool[pages]),
                    _np(pool.engine.cache.v_pool[pages])))
        pool.release(h)
    return out


def replica_pool_split(rank, world, state, prompt, new_tokens):
    """A 1x1 ReplicaPool whose prefill pool spans the ``world`` ranks: the
    prompt's prefix built by the pool, adopted by the replica, and the
    last token decoded on it; the committed stream."""
    from distributed_dot_product_tpu_torch.parallel.mesh import seq_mesh
    from distributed_dot_product_tpu_torch.serve import (
        ReplicaPool, ServeConfig, TopologyConfig,
    )
    topo = TopologyConfig(prefill_pools=1, decode_replicas=1, slots=2,
                          t_max=64, page_size=16, vocab=32, seed=3,
                          device='cpu')
    rp = ReplicaPool(topo, serve_config=ServeConfig(
        watchdog=False, max_new_tokens=new_tokens), mesh=seq_mesh(world))
    try:
        rp.prefill.engine.load_weights(state)
        rep = rp.replicas[0]
        rep.engine.load_weights(state)
        h = rp.prefill.build(prompt[:-1])
        pid = rep.engine.adopt_prefix(
            rp.prefill.engine.cache, h.pages, h.length,
            src_checksums=rp.prefill.engine.checksums)
        rp.prefill.release(h)
        r = rep.scheduler.submit(list(prompt[-1:]), prefix_id=pid,
                                 max_new_tokens=new_tokens)
        while rep.step():
            pass
        return (rp.prefill.n_shards, list(rep.results[r.id].tokens))
    finally:
        rp.close()
