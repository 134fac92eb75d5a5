# -*- coding: utf-8 -*-
"""
The decode kernel's launch geometry (``ops/flash_decode.py``
``_launch_geometry``) and the chunk ownership it implies, on the CPU
(the kernel itself runs only on the card).

A launch is a grid of ``(cluster, batch * h_kv)`` blocks in clusters of
``cluster``; rank ``r`` of a (slot, kv head) cluster owns the 128-column
chunks ``c`` with ``c % cluster == r`` and walks the 64-column steps of
its chunks that lie in the slot's attended span, in increasing order
(``owned_from`` in ``csrc/flash_decode.cu``; ``_rank_steps`` below is its
twin). Checked here: every chunk of every ``t_max`` is owned by exactly
one block of the launch, every step of any span is walked by exactly one
rank, and the geometry is a function of ``(batch, h_kv, t_max, SM
count)`` alone — never of the query rows, ``valid_to``, ``append_at`` or
the page table, which the bit-for-bit contracts (verify row j = the j-th
sequential launch, K5p = K5 on the gathered slab) rest on. Also the page
sizes the paged kernel takes.
"""

import importlib
import inspect

import pytest

fd = importlib.import_module(
    'distributed_dot_product_tpu_torch.ops.flash_decode')

T_MAXES = (1, 127, 128, 129, 2048, 4096, 8192)
# (batch, h_kv, SM count): the greedy and serving shapes, the sharded
# decode slab's, one (slot, kv head) and a batch wider than the card.
SHAPES = ((4, 8, 132), (8, 8, 132), (4, 4, 132), (1, 1, 132),
          (64, 16, 132), (4, 8, 114))
STEP = 64            # kStep in csrc/flash_decode.cu


def _owned_from(s, rank, cluster):
    """The kernel's ``owned_from``: the first step at or after ``s`` whose
    chunk ``rank`` owns."""
    c = s // (fd._SPLIT // STEP)
    own = c + (rank - c % cluster) % cluster
    return s if own == c else own * (fd._SPLIT // STEP)


def _rank_steps(rank, cluster, lo, hi):
    """The steps rank ``rank`` walks for a span ``lo..hi`` (the kernel's
    loop: from ``owned_from(lo // 64)`` to ``hi // 64`` by ``next_step``:
    the chunk's second half, else ``cluster`` chunks on)."""
    steps, last = [], hi // STEP if hi >= lo else lo // STEP - 1
    s = _owned_from(lo // STEP, rank, cluster)
    while s <= last:
        steps.append(s)
        s = s + 2 * cluster - 1 if s % 2 else s + 1
    return steps


@pytest.mark.parametrize('t_max', T_MAXES)
def test_every_chunk_owned_by_exactly_one_block(t_max):
    for batch, h_kv, sms in SHAPES:
        cluster, grid = fd._launch_geometry(batch, h_kv, t_max, sms)
        assert grid == (cluster, batch * h_kv)
        assert 1 <= cluster <= fd._MAX_CLUSTER
        assert cluster & (cluster - 1) == 0           # a power of two
        chunks = -(-t_max // fd._SPLIT)
        assert cluster <= max(1, 2 * chunks - 1)      # no idle half
        assert cluster * batch * h_kv <= max(2 * sms, batch * h_kv)
        for row in range(grid[1]):
            owners = {c: [r for r in range(grid[0]) if c % cluster == r]
                      for c in range(chunks)}
            assert all(len(o) == 1 for o in owners.values()), (t_max, row)
        # Every step of the whole slab and of spans that start and end
        # mid-chunk is walked once, in increasing order within a rank.
        for lo, hi in ((0, t_max - 1), (t_max // 3, t_max - 1),
                       (min(70, t_max - 1), min(200, t_max - 1)),
                       (t_max - 1, t_max - 1), (5, 4)):
            walked = [s for r in range(cluster)
                      for s in _rank_steps(r, cluster, lo, hi)]
            want = list(range(lo // STEP, hi // STEP + 1)) if hi >= lo \
                else []
            assert sorted(walked) == want, (t_max, cluster, lo, hi)
            for r in range(cluster):
                steps = _rank_steps(r, cluster, lo, hi)
                assert steps == sorted(steps)
                assert all((s * STEP // fd._SPLIT) % cluster == r
                           for s in steps)


def test_geometry_depends_on_the_shape_alone():
    """The geometry's only inputs are (batch, h_kv, t_max, SM count); a
    step's chunk -> rank map is fixed by the chunk alone, so a span that
    grows by the verify rows or shifts with valid_to or a window keeps
    every shared chunk on its rank."""
    params = list(inspect.signature(fd._launch_geometry).parameters)
    assert params == ['batch', 'h_kv', 't_max', 'sm_count']
    for t_max in T_MAXES:
        for batch, h_kv, sms in SHAPES:
            first = fd._launch_geometry(batch, h_kv, t_max, sms)
            assert all(fd._launch_geometry(batch, h_kv, t_max, sms)
                       == first for _ in range(3))
            cluster = first[0]
            # A one-row span and the same slot's verify span (5 rows),
            # with and without a window: the steps they share sit on the
            # same rank.
            for vt in (0, t_max // 2, t_max - 5):
                for window in (None, 100):
                    def span(v, n):
                        hi = min(v + n - 1, t_max - 1)
                        lo = 0 if window is None else max(v - window + 1, 0)
                        return lo, hi
                    one = {s: r for r in range(cluster)
                           for s in _rank_steps(r, cluster, *span(vt, 1))}
                    five = {s: r for r in range(cluster)
                            for s in _rank_steps(r, cluster, *span(vt, 5))}
                    assert all(five[s] == r for s, r in one.items())


def test_geometry_fills_the_card():
    """At most about two blocks an SM (one wave) at the greedy (8 blocks
    a slot and kv head) and serving (4) shapes, one block a (slot, kv
    head) once the batch alone fills the card, no more than the chunks
    need."""
    assert fd._launch_geometry(4, 8, 2048, 132) == (8, (8, 32))
    assert fd._launch_geometry(8, 8, 4096, 132) == (4, (4, 64))
    assert fd._launch_geometry(64, 16, 4096, 132) == (1, (1, 1024))
    assert fd._launch_geometry(4, 8, 128, 132)[0] == 1
    assert fd._launch_geometry(4, 8, 129, 132)[0] == 2


def _pages_per_chunk(ps):
    """The kernel's ``pages_per_chunk``: the page ids one 128-column chunk
    holds (128 / ps for a divisor, 1 for a multiple of 128, else the most
    pages 128 consecutive columns can touch)."""
    if fd._SPLIT % ps == 0:
        return fd._SPLIT // ps
    if ps % fd._SPLIT == 0:
        return 1
    return (fd._SPLIT - 1 + ps - 1) // ps + 1


def _paged_matches_reference(ps):
    """The port's paged decode (CPU) against the reference kernel at page
    size ``ps``: 4 slots of 3 pages each scattered over a pool of 9 (+ the
    sink), GQA 4:2, k rows of 16 and v rows of 8; fills at a page's last
    row, on a page boundary and mid-page, and an inactive slot."""
    import jax.numpy as jnp
    import numpy as np
    import torch
    from distributed_dot_product_tpu.ops.pallas_decode import (
        flash_decode as jax_flash_decode,
    )
    rng = np.random.default_rng(ps)
    b, h, h_kv, d, dv, pps, pages = 4, 4, 2, 16, 8, 3, 9

    def rand(*shape):
        return rng.standard_normal(shape, dtype=np.float32)
    fills = [ps - 1, ps, ps + ps // 2 + 1, 0]
    table = np.full((b, pps), -1, np.int32)
    perm, nxt = rng.permutation(pages), 0
    for i, f in enumerate(fills[:3]):
        need = f // ps + 1
        table[i, :need] = perm[nxt:nxt + need]
        nxt += need
    q, kn, vn = rand(b, h, 1, d), rand(b, h_kv, 1, d), rand(b, h_kv, 1, dv)
    ck, cv = rand(pages + 1, h_kv, ps, d), rand(pages + 1, h_kv, ps, dv)
    vt = np.array(fills[:3] + [-1], np.int32)
    ap = np.array(fills[:3] + [-1], np.int32)
    want = jax_flash_decode(*(jnp.asarray(x) for x in (q, kn, vn, ck, cv,
                                                       vt, ap)),
                            page_table=jnp.asarray(table),
                            interpret=True)[:3]
    tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    got = fd.flash_decode(*(torch.from_numpy(x) for x in (q, kn, vn)), tk,
                          tv, torch.from_numpy(vt), torch.from_numpy(ap),
                          page_table=torch.from_numpy(table))[0]
    want_out = np.asarray(want[0])
    assert tuple(got.shape) == (b, h, 1, dv)
    assert float(np.abs(got.numpy() - want_out).max()) <= 1e-5 * float(
        np.abs(want_out).max()), ps
    np.testing.assert_array_equal(tk.numpy()[:-1], np.asarray(want[1])[:-1])
    np.testing.assert_array_equal(tv.numpy()[:-1], np.asarray(want[2])[:-1])


@pytest.mark.parametrize('ps,ok', [(1, True), (16, True), (128, True),
                                   (256, True), (512, True), (48, True),
                                   (100, True), (192, True), (0, False)])
def test_page_sizes_the_paged_kernel_takes(ps, ok):
    """Every page size of at least one row: the port's ``flash_decode``
    with a page table at that page size gives the reference kernel's
    answer (interpret mode) on the same scrambled pool, the pools
    appended alike but the sink page (out within 1e-5 of its largest
    entry: float32 rounding of two reduction orders); and the kernel's
    page walk (``cache_row`` and the page-id load in
    ``csrc/flash_decode.cu``, twinned here) finds each column's page among
    its rank's ids, at the column's row of that page, with the 128-column
    chunk partition unchanged (so K5p stays K5 on the gathered slab bit
    for bit). A pool of zero-row pages is refused with ValueError."""
    if not ok:
        import torch
        pool, row = torch.zeros(3, 1, ps, 8), torch.zeros(1, 1, 1, 8)
        table = torch.zeros(1, 2, dtype=torch.int32)
        with pytest.raises(ValueError, match='at least one row'):
            fd.flash_decode(row, row, row, pool, pool.clone(), [0], [0],
                            page_table=table)
        return
    _paged_matches_reference(ps)
    ppc = _pages_per_chunk(ps)
    for npages in (1, 3, 7):
        t_max = npages * ps
        chunks = -(-t_max // fd._SPLIT)
        for cluster in (1, 2, 4, 8):
            # The ids rank r loads: chunk c = r + (i // ppc) * cluster, its
            # first page c * 128 // ps and the ones after it (-1 past the
            # table).
            held = {}
            for r in range(cluster):
                owned = -(-(chunks - r) // cluster) * ppc if r < chunks else 0
                ids = []
                for i in range(owned):
                    c = r + i // ppc * cluster
                    p = c * fd._SPLIT // ps + i % ppc
                    ids.append(p if p < npages else -1)
                held[r] = ids
            for col in range(t_max):
                c = col // fd._SPLIT
                r, k = c % cluster, c // cluster
                entry = col // ps - c * fd._SPLIT // ps
                assert 0 <= entry < ppc, (ps, col)
                assert held[r][k * ppc + entry] == col // ps, (ps, col)
