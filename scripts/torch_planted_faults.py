#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Planted faults against ``chip_smoke.py``'s kernel checks, on one CUDA card.

    python3 scripts/torch_planted_faults.py      # from the repository root

    python3 scripts/torch_planted_faults.py k5_merge_arrival_order ...

For each fault below (or each one named): copies ``chip_smoke.py`` and the
port's package into a temporary directory, plants the fault in one kernel
source, runs ``chip_smoke.py --phases ...`` there with the phases that hold
that source's kernels (``PHASES``), and reads those phases' lines. The run
must fail, in a phase that holds the faulty kernel. Prints one JSON line
per fault with the readings of every case (largest row error and
whole-tensor error of out / dq / dk / dv, K1's lse error; the decode
cases' errors and bit-for-bit flags), then ``{"faults": n, "caught":
m}``; exits non-zero unless every fault was caught. Most K1-K4 faults sit
past query or key tile 32, so only the training shape (T 4096, 64 tiles)
reaches them, or round an accumulator to bf16 after every tile; two more
break K1's online softmax (the rescale of O dropped) and its causal loop
(every query tile's diagonal key tile skipped). Three break int8 scoring
past key tile 32 by a last bit or so, where no tolerance sees them: K1
scales each score by its neighbouring column's k scale, K3 and K4 apply
the two row scales in the other order; the int8 exactness cases of
``flash_masks`` must catch them. The K5/K5p faults break
the decode kernel's merge (ranks taken in an order that varies from
launch to launch, as arrival order would; or the peers' partials read
before they have landed), drop the fresh rows' substitution (the appended columns read
from the cache, racing the appends), copy and score a -1 page, or score a
column on a -1 page as 0 (which only the sequence-sharded page table's
holes show: ``kv_sharded_serve`` must catch it). Three more sit in the
port's Python: ``quantized_dot`` dequantizing with a scale per input
channel, and its padding rows put in front so that they leak into the
output in place of the real rows (``wq8_serve`` must catch both); the
scheduling policy choosing the lowest priority first (``load_serve``
must catch it). Three sit in disaggregated serving (``router_serve`` must
catch them): the handoff's page copy shifted by one destination ordinal,
recovery replaying the prefix-stripped prompt, and the shard-local
handoff allocating every page on shard 0. A source with a ``/`` is a path
in the package; a bare name is in ``csrc/``. Kernel libraries already
built under ``build/kernels`` from unchanged sources are reused.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = 'distributed_dot_product_tpu_torch'


def _round_acc(*names):
    """Rounds each named accumulator array (D / 2 floats) to bf16."""
    return ''.join(f'    for (int i = 0; i < D / 2; ++i)\n'
                   f'      {n}[i] = '
                   f'__bfloat162float(__float2bfloat16({n}[i]));\n'
                   for n in names)


# The phases that hold K5 and K5p.
DECODE = ('flash_decode', 'flash_decode_paged', 'flash_decode_verify')

# name: (source, text to replace, replacement, phases one of which
# must fail)
FAULTS = {
    'k1_late_diagonal_tile_dropped': (
        'flash_fwd.cu', '    if (sees(wg, t)) {\n      const int k0 = t * kB;\n'
        '      const uint32_t tK = smem_u32(sKV + 2 * stage * kB * D);\n',
        '    if (sees(wg, t) && !(q0 >= 32 * kB &&\n'
        '                         t == (wg ? t_hi[1] : t_hi[0]) - 1)) {\n'
        '      const int k0 = t * kB;\n'
        '      const uint32_t tK = smem_u32(sKV + 2 * stage * kB * D);\n',
        ('flash_attention', 'flash_backward')),
    'k1_accumulator_bf16': (
        'flash_fwd.cu', '      fence_regs(o);\n',
        '      fence_regs(o);\n' + _round_acc('o'),
        ('flash_attention', 'flash_backward')),
    # The online softmax's rescale of O left out: O keeps the weights of
    # earlier tiles at their old, smaller running max.
    'k1_corr_dropped': (
        'flash_fwd.cu',
        '        for (int i = 0; i < D / 2; ++i) o[i] *= corr[(i >> 1) & 1];\n',
        '',
        ('flash_attention', 'flash_backward')),
    # Every query tile's last causal key tile (its diagonal) skipped.
    'k1_last_causal_tile_skipped': (
        'flash_fwd.cu', '    if (sees(wg, t)) {\n      const int k0 = t * kB;\n'
        '      const uint32_t tK = smem_u32(sKV + 2 * stage * kB * D);\n',
        '    if (sees(wg, t) && !(causal &&\n'
        '                         t == (wg ? t_hi[1] : t_hi[0]) - 1)) {\n'
        '      const int k0 = t * kB;\n'
        '      const uint32_t tK = smem_u32(sKV + 2 * stage * kB * D);\n',
        ('flash_attention', 'flash_backward')),
    'k3_late_diagonal_tile_dropped': (
        'flash_bwd.cu', '      uint32_t ds[4][4];\n',
        '      if (q0 >= 32 * kB && t == (wg ? t_hi[1] : t_hi[0]) - 1)\n'
        '        for (int i = 0; i < 32; ++i) dp[i] = 0.f;\n'
        '      uint32_t ds[4][4];\n',
        ('flash_backward',)),
    'k3_accumulator_bf16': (
        'flash_bwd.cu', '      fence_regs(acc);\n',
        '      fence_regs(acc);\n' + _round_acc('acc'),
        ('flash_backward',)),
    'k4_late_diagonal_tile_dropped': (
        'flash_bwd.cu', '    bool yes = qt >= lo && qt < hi;\n',
        '    bool yes = qt >= lo + (kb0 + w * kB >= 32 * kB ? 1 : 0) &&\n'
        '               qt < hi;\n',
        ('flash_backward',)),
    'k4_accumulator_bf16': (
        'flash_bwd.cu',
        '      fence_regs(acc_dv);\n      fence_regs(acc_dk);\n',
        '      fence_regs(acc_dv);\n      fence_regs(acc_dk);\n'
        + _round_acc('acc_dv', 'acc_dk'),
        ('flash_backward',)),
    # int8 scoring past key tile 32: each score scaled by the neighbouring
    # column's k scale.
    'k1_int8_neighbour_scale': (
        'flash_fwd.cu', '          const float2 c = skr2[acc_col(i) / 2];\n',
        '          const float2 c0 = skr2[acc_col(i) / 2];\n'
        '          const float2 c = t >= 32 ? make_float2(c0.y, c0.x) : c0;\n',
        ('flash_masks',)),
    # int8 scoring past key tile 32: (dot * skr) * sqf, the scale factors
    # in the other order.
    'k4_int8_scale_order': (
        'flash_bwd.cu',
        '          s[i] = __fmul_rn(__fmul_rn(static_cast<float>(sa[i]), c.x),'
        ' r);\n'
        '          s[i + 1] =\n'
        '              __fmul_rn(__fmul_rn(static_cast<float>(sa[i + 1]), c.y),'
        ' r);\n',
        '          auto mul = [&](int e, float q) {\n'
        '            const float x = static_cast<float>(sa[e]);\n'
        '            return k0 >= 32 * kB ? __fmul_rn(__fmul_rn(x, r), q)\n'
        '                                 : __fmul_rn(__fmul_rn(x, q), r);\n'
        '          };\n'
        '          s[i] = mul(i, c.x);\n'
        '          s[i + 1] = mul(i + 1, c.y);\n',
        ('flash_masks',)),
    # The same in K3: (dot * skr) * sqf.
    'k3_int8_scale_order': (
        'flash_bwd.cu',
        '          s[i] = __fmul_rn(__fmul_rn(static_cast<float>(sa[i]), rq),'
        ' ck.x);\n'
        '          s[i + 1] =\n'
        '              __fmul_rn(__fmul_rn(static_cast<float>(sa[i + 1]), rq),'
        ' ck.y);\n',
        '          auto mul = [&](int e, float c) {\n'
        '            const float x = static_cast<float>(sa[e]);\n'
        '            return k0 >= 32 * kB ? __fmul_rn(__fmul_rn(x, c), rq)\n'
        '                                 : __fmul_rn(__fmul_rn(x, rq), c);\n'
        '          };\n'
        '          s[i] = mul(i, ck.x);\n'
        '          s[i + 1] = mul(i + 1, ck.y);\n',
        ('flash_masks',)),
    # The merge takes the ranks in an order that changes from launch to
    # launch (a rotation read from the clock, as arrival order would).
    'k5_merge_arrival_order': (
        'flash_decode.cu',
        '    for (int i = 0; i < C; ++i)\n'
        '      if ((active >> i) & 1)\n'
        '        acc += w[i * nr + rl] * gath[i * per + 2 * nr + e - e0];\n',
        '    const int k0 = static_cast<int>(clock64() >> 4) % C;\n'
        '    for (int k = 0; k < C; ++k) {\n'
        '      const int i = (k + k0) % C;\n'
        '      if ((active >> i) & 1)\n'
        '        acc += w[i * nr + rl] * gath[i * per + 2 * nr + e - e0];\n'
        '    }\n',
        DECODE),
    # Every column is read from the cache, the appended ones too.
    'k5_fresh_rows_not_substituted': (
        'flash_decode.cu',
        '  const int m = col0 + r - s.ap;\n'
        '  const bool fresh = s.ap >= 0 && m >= 0 && m < s.nn;\n',
        '  const int m = col0 + r - s.ap;\n'
        '  const bool fresh = false;\n',
        DECODE),
    # A -1 table entry read as page 0 (pages of at most 128 columns, as
    # the smoke's): its rows copied and scored.
    'k5p_unallocated_page_scored': (
        'flash_decode.cu',
        '    if (page < 0) return -1;\n'
        '    return ((page * a.h_kv + s.hk) << sh)',
        '    if (page < 0) return (s.hk << sh) + (col & (ps - 1));\n'
        '    return ((page * a.h_kv + s.hk) << sh)',
        DECODE),
    # The merge reads the partials its peers store without waiting for
    # them to land (the wait on the block's merge barrier dropped).
    'k5_merge_before_peers_landed': (
        'flash_decode.cu', '  mbar_wait(bar, 0);\n', '', DECODE),
    # A column on a -1 page scores 0 (its zero-filled K row) instead of
    # -inf: the held mask is ignored. A dense table never shows it; the
    # sequence-sharded page table's -1 holes below a slot's fill do
    # (kv_sharded_serve's step check: an empty shard's partials).
    'k5p_unheld_column_scored': (
        'flash_decode.cu',
        '          const bool ok =\n'
        '              ((hmask >> cl) & 1) && col >= lo[hf] && col <= hi[hf];\n',
        '          const bool ok = col >= lo[hf] && col <= hi[hf];\n',
        ('kv_sharded_serve',)),
    # The s8 product dequantized with a scale per INPUT channel (column j
    # of the output takes input channel j mod in's scale) where the rule
    # has one per output channel: the logits leave the int8 class.
    'wq8_scale_per_input_channel': (
        'models/dense.py', '    return y * sx * w_s\n',
        '    s_in = (w_q.float() * w_s[:, None]).abs().amax(dim=0) / 127.0\n'
        '    return y * sx * s_in[torch.arange(w_q.shape[0],\n'
        '                                      device=y.device)\n'
        '                         % w_q.shape[1]]\n',
        ('wq8_serve',)),
    # The zero rows that lift a decode step past torch._int_mm's row
    # minimum padded in FRONT: the slice keeps them and drops real rows.
    'wq8_padding_rows_leak': (
        'models/dense.py',
        '        xi = F.pad(xi, (0, 0, 0, _INT_MM_MIN_ROWS - rows))\n',
        '        xi = F.pad(xi, (0, 0, _INT_MM_MIN_ROWS - rows, 0))\n',
        ('wq8_serve',)),
    # The priority classes inverted: the policy boards the LOWEST first.
    'policy_lowest_priority_first': (
        'serve/policy.py', '            return (-pol.priority, share, i)\n',
        '            return (pol.priority, share, i)\n',
        ('load_serve',)),
    # The prefill→decode handoff copies each source page one destination
    # ordinal over (the last page into the first): the adopted prefix is
    # scrambled.
    'handoff_pages_off_by_one': (
        'serve/engine.py',
        '        paged_transfer_pages(self.cache, src_cache.k_pool, '
        'src_cache.v_pool,\n'
        '                             src_pages, pages)\n',
        '        paged_transfer_pages(self.cache, src_cache.k_pool, '
        'src_cache.v_pool,\n'
        '                             src_pages, pages[1:] + pages[:1])\n',
        ('router_serve',)),
    # Recovery replays the prefix-stripped prompt (its last token) where
    # the ledger keeps the full one: a recovered stream decodes without
    # its context.
    'recovery_replays_stripped_prompt': (
        'serve/router.py', "        req = Request(prompt=entry['prompt'],\n",
        "        req = Request(prompt=entry['prompt'][-1:],\n",
        ('router_serve',)),
    # The shard-local handoff allocates every ordinal's page on shard 0,
    # whoever owns the ordinal.
    'sharded_adopt_all_on_shard0': (
        'serve/engine.py',
        '            lo, hi = self.pool.owned_range(s)\n'
        '            k = max(0, min(hi, needed) - lo)\n',
        '            lo, hi = (0, needed) if s == 0 else (0, 0)\n'
        '            k = max(0, min(hi, needed) - lo)\n',
        ('router_serve',)),
}

# Phases a fault names that run alone (the source's PHASES otherwise).
SOLO = ('flash_masks', 'kv_sharded_serve', 'wq8_serve', 'load_serve',
        'router_serve')


# The phases that hold each source's kernels: K1, K3 and K4 at the
# training shape; K5 and K5p at their serving shapes, edges and verify-k.
# A fault that names only flash_masks (int8 scoring) runs that phase.
PHASES = {'flash_fwd.cu': ('flash_attention', 'flash_backward'),
          'flash_bwd.cu': ('flash_attention', 'flash_backward'),
          'flash_decode.cu': DECODE}


def plant(dst, source, old, new):
    shutil.copy(os.path.join(ROOT, 'chip_smoke.py'), dst)
    shutil.copytree(os.path.join(ROOT, PKG), os.path.join(dst, PKG),
                    ignore=shutil.ignore_patterns('__pycache__'))
    # Libraries already built from unchanged sources are reused: a
    # library's file name carries the digest of its sources, so the
    # planted one builds anew and no other does.
    built = os.path.join(ROOT, 'build', 'kernels')
    if os.path.isdir(built):
        shutil.copytree(built, os.path.join(dst, 'build', 'kernels'))
    path = os.path.join(dst, PKG, *(source.split('/') if '/' in source
                                    else ('csrc', source)))
    with open(path) as f:
        text = f.read()
    if text.count(old) != 1:
        raise SystemExit(f'{source}: the text to replace is not there once')
    with open(path, 'w') as f:
        f.write(text.replace(old, new))


def readings(stdout):
    """Per case, the kernel-vs-plain errors the smoke printed; and the
    phase that failed."""
    cases, failed = {}, None
    for line in stdout.splitlines():
        try:
            row = json.loads(line)
        except ValueError:
            continue
        if not isinstance(row, dict):
            continue
        if row.get('ok') is False:
            failed = row['phase']
        if row.get('phase') == 'flash_attention' and 'k1' in row:
            for kern in ('k1', 'k2'):   # the kernels' edge cases
                cases[f"flash_attention/{row['case']}/{kern}"] = {
                    'row_rel': row[kern]['max_row_rel_err'],
                    'rel': row[kern]['rel_err'],
                    'lse': row[kern]['lse_max_abs_err']}
        elif row.get('phase') == 'flash_masks' and 'exactly_equal' in row:
            cases[f"flash_masks/{row['case']}"] = {
                'exactly_equal': row['exactly_equal'],
                'max_abs_err': row.get('max_abs_err')}
        elif row.get('phase') in ('flash_attention', 'flash_backward') and \
                'max_row_rel_err' in row:
            key = f"{row['phase']}/{row['case']}"
            cases[key] = {'row_rel': row['max_row_rel_err'],
                          'rel': row['rel_err']}
            if isinstance(row['max_abs_err'], dict):
                cases[key]['lse'] = row['max_abs_err']['lse']
        elif row.get('phase') == 'wq8_serve' and row.get('case') in (
                'first_step_logits', 'quantized_dot_exact', 'streams'):
            key = f"wq8_serve/{row['case']}"
            if 'rows' in row:
                key += f"/{row['rows']}"
            cases[key] = {k: v for k, v in row.items()
                          if k not in ('phase', 'case')}
        elif row.get('phase') == 'load_serve' and \
                'priority_inversions' in row:
            cases[f"load_serve/{row['case']}"] = {
                k: row[k] for k in ('priority_inversions',
                                    'per_tenant_goodput_pct')}
        elif row.get('phase') == 'router_serve' and row.get('case') in (
                'handoff', 'topology_burst', 'recovery', 'scrub',
                'kv_shards_handoff'):
            key = f"router_serve/{row['case']}"
            if 'rows' in row:
                key += f"/{row['rows']}"
            cases[key] = {k: v for k, v in row.items()
                          if k not in ('phase', 'case') and (
                              isinstance(v, (bool, dict)) or k == 'ok')}
        elif row.get('phase') == 'kv_sharded_serve' and \
                row.get('case') == 'step_check':
            cases['kv_sharded_serve/step_check'] = {
                k: row[k] for k in ('vs_single_pool', 'vs_plain',
                                    'max_abs_err', 'empty_rows_exact',
                                    'pools_equal_single_pool',
                                    'pools_equal_plain',
                                    'pools_changed_only_at_owner_appends')}
        elif row.get('phase') in DECODE and 'max_abs_err' in row:
            key = f"{row['phase']}/{row['case']}"
            if 'head_dim' in row:
                key += f"/d{row['head_dim']}/k{row.get('k', 1)}"
            cases[key] = {k: v for k, v in row.items()
                          if k in ('max_abs_err', 'max_row_rel_err',
                                   'rel_err')
                          or isinstance(v, bool)}
    return cases, failed


def main():
    names = sys.argv[1:] or list(FAULTS)
    unknown = sorted(set(names) - set(FAULTS))
    if unknown:
        raise SystemExit(f'unknown faults {unknown}; known: {list(FAULTS)}')
    caught = 0
    for name in names:
        source, old, new, phases = FAULTS[name]
        run_phases = phases if phases[0] in SOLO else PHASES[source]
        with tempfile.TemporaryDirectory() as dst:
            plant(dst, source, old, new)
            run = subprocess.run([sys.executable, 'chip_smoke.py',
                                  '--phases', ','.join(run_phases)],
                                 cwd=dst, capture_output=True, text=True,
                                 timeout=900)
        cases, failed = readings(run.stdout)
        ok = run.returncode != 0 and failed in phases
        caught += ok
        print(json.dumps({'fault': name, 'source': source,
                          'must_fail_in': phases, 'failed_phase': failed,
                          'rc': run.returncode, 'caught': ok,
                          'readings': cases}), flush=True)
    print(json.dumps({'faults': len(names), 'caught': caught}), flush=True)
    return 0 if caught == len(names) else 1


if __name__ == '__main__':
    sys.exit(main())
