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
handoff allocating every page on shard 0. Three sit in chaos and control
(``chaos_serve`` must catch them): the chaos schedule firing a planned
crash one tick late, the doctor naming a surviving replica for a replica
loss, and the controller scaling down without draining the member.
Three sit in the port's analysis and training driver
(``analysis_examples`` must catch them): the retrace sentinel keying a
tensor's signature on the tensor object (every call a new trace), a
resumed run starting one step past its checkpoint, and the entrypoint
registry dropping its last layer's hook. Three sit in the benchmark CLI
twin (``benchmark_cli`` must catch them): the nt row without the
reference's ``perf_model``, paged ``decode-serve`` routed to the plain
step (no K5p launched), and the matmul timings not fenced on the card.
Eight sit in the float32 kernels (``float32_path`` must catch them):
the 3xTF32 product cut to one TF32 product (what a kernel that is only
TF32-accurate computes; K1–K4 run it), K1/K2's V^T planes stored in
another key order than P's fragments take and K3/K4's dS.K, P^T.dO and
dS^T.q2 reading the score accumulators in another reduction order than
the B tile's rows, K1/K2's split K tile and K4's split dO tile stored
without their small parts (S, dV at TF32 accuracy), and three in the
float32 K5/K5p: two of a step's V rows swapped in P.V, a lane's partials
left out of S's butterfly, and a verify row scoring the columns fetched
for the later rows. A
source with a ``/`` is a path in the package, one starting ``./`` a path
from the repository root; a bare name is in ``csrc/``. Kernel libraries
already built under ``build/kernels`` from unchanged sources are
reused.
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
    """Rounds each named accumulator array of floats to bf16."""
    return ''.join(f'    for (int i = 0; i < int(sizeof({n}) / 4); ++i)\n'
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
        '      const uint32_t tK = smem_u32(sKV + stage * kB * (D + DV));\n',
        '    if (sees(wg, t) && !(q0 >= 32 * kB &&\n'
        '                         t == (wg ? t_hi[1] : t_hi[0]) - 1)) {\n'
        '      const int k0 = t * kB;\n'
        '      const uint32_t tK = smem_u32(sKV + stage * kB * (D + DV));\n',
        ('flash_attention', 'flash_backward')),
    'k1_accumulator_bf16': (
        'flash_fwd.cu', '      fence_regs(o);\n',
        '      fence_regs(o);\n' + _round_acc('o'),
        ('flash_attention', 'flash_backward')),
    # The online softmax's rescale of O left out: O keeps the weights of
    # earlier tiles at their old, smaller running max.
    'k1_corr_dropped': (
        'flash_fwd.cu',
        '        for (int i = 0; i < DV / 2; ++i) o[i] *= corr[(i >> 1) & 1];\n',
        '',
        ('flash_attention', 'flash_backward')),
    # Every query tile's last causal key tile (its diagonal) skipped.
    'k1_last_causal_tile_skipped': (
        'flash_fwd.cu', '    if (sees(wg, t)) {\n      const int k0 = t * kB;\n'
        '      const uint32_t tK = smem_u32(sKV + stage * kB * (D + DV));\n',
        '    if (sees(wg, t) && !(causal &&\n'
        '                         t == (wg ? t_hi[1] : t_hi[0]) - 1)) {\n'
        '      const int k0 = t * kB;\n'
        '      const uint32_t tK = smem_u32(sKV + stage * kB * (D + DV));\n',
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
        '        fence_regs(acc_dv);\n        fence_regs(acc_dk);\n',
        '        fence_regs(acc_dv);\n        fence_regs(acc_dk);\n'
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
    # A -1 table entry read as page 0: its rows copied and scored.
    'k5p_unallocated_page_scored': (
        'flash_decode.cu',
        '  if (page < 0) return -1;\n'
        '  return (page * a.h_kv + s.hk) * ps + at;',
        '  if (page < 0) return s.hk * ps + at;\n'
        '  return (page * a.h_kv + s.hk) * ps + at;',
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
        'serve/engine.py', '        vec_dst[:needed] = pages\n',
        '        vec_dst[:needed] = np.roll(pages, -1)\n',
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
    # The chaos schedule fires a planned replica crash one tick late: the
    # replay no longer kills the victim at the planned instant.
    'chaos_schedule_one_tick_late': (
        'serve/loadgen.py',
        '        victim = self.injector.crash_due(self.tick)\n',
        '        victim = self.injector.crash_due(self.tick - 1)\n',
        ('chaos_serve',)),
    # The doctor names a replica the router still routes to (a survivor)
    # where the loss declaration names the dead one.
    'doctor_names_the_survivor': (
        'obs/doctor.py',
        '    if primary == \'replica_loss\' and lost:\n'
        '        where = lost[-1]\n',
        '    if primary == \'replica_loss\' and lost:\n'
        '        where = next((str(r[\'target\']) for r in events\n'
        '                      if r.get(\'event\') == \'router.route\'\n'
        '                      and str(r.get(\'target\')) not in lost),\n'
        '                     lost[-1])\n',
        ('chaos_serve',)),
    # The controller scales down by dropping the member from the pool,
    # without draining and retiring it.
    'controller_scales_down_without_drain': (
        'serve/control.py',
        '            requeued = self.router.drain_replica(victim.name)\n',
        '            requeued = 0\n'
        '            self.router.pool.replicas.remove(victim)\n'
        '            del self.router._by_name[victim.name]\n',
        ('chaos_serve',)),
    # The retrace sentinel keys a tensor's signature on the tensor object:
    # every call of a watched program counts as a new trace.
    'retrace_signature_per_tensor': (
        'analysis/retrace.py',
        "        return ('array', tuple(x.shape), str(x.dtype), str(dev))\n",
        "        return ('array', tuple(x.shape), str(x.dtype), str(dev), "
        "id(x))\n",
        ('analysis_examples',)),
    # A resumed run starts one step past its checkpoint: the resumed
    # losses no longer line up with the uninterrupted run's.
    'resume_one_step_late': (
        './distributed_dot_product_tpu_torch/train_loop.py',
        '        step_i = resumed_from\n',
        '        step_i = resumed_from + 1\n',
        ('analysis_examples',)),
    # The entrypoint registry skips its last layer's hook: an entry goes
    # unchecked without a word.
    'registry_drops_last_layer': (
        'analysis/registry.py', '    for modpath in LAYER_HOOKS:\n',
        '    for modpath in LAYER_HOOKS[:-1]:\n',
        ('analysis_examples',)),
    # The nt / all / tn row without the reference's perf_model key.
    'bench_row_without_perf_model': (
        './torch_benchmark.py',
        '        perf_model=_perf_model(program, best),\n',
        '',
        ('benchmark_cli',)),
    # Paged decode-serve built on the plain decode step: no K5p launched.
    'bench_paged_serve_on_the_plain_step': (
        './torch_benchmark.py',
        '                            decode_impl=impl, dtype=edt, device=dev,\n',
        "                            decode_impl='plain' if paged else impl,\n"
        '                            dtype=edt, device=dev,\n',
        ('benchmark_cli',)),
    # The matmul timings not fenced on the card: the host clock reads the
    # enqueue.
    'bench_matmul_timing_unfenced': (
        './torch_benchmark.py', '    if not args.skip_local:\n',
        '    tracing.hard_sync = lambda out=None: None\n'
        '    if not args.skip_local:\n',
        ('benchmark_cli',)),
    # The float32 kernels' products at TF32 accuracy: the small parts'
    # two products dropped, big.big alone.
    'f32_single_tf32_product': (
        'tf32x3.cuh', '  term(true, false);\n  term(false, true);\n', '',
        ('float32_path',)),
    # K1/K2's V^T planes stored with the keys in their own order against
    # P's fragments, which take each slice's keys as 0, 2, 4, 6, 1, 3, 5, 7.
    'f32_pv_reduction_order': (
        'flash_f32.cu',
        '        const int r = 8 * (p >> 1) + (p & 1) + 2 * e;   '
        '// key of column 4p + e\n',
        '        const int r = 4 * p + e;   // key of column 4p + e\n',
        ('float32_path',)),
    # K1/K2's K tile stored with its small parts zero: S at TF32 accuracy.
    'f32_k_small_plane_zero': (
        'flash_f32.cu',
        "      *reinterpret_cast<uint4*>(small + off) = s;   "
        "// K's small part\n",
        "      *reinterpret_cast<uint4*>(small + off) = "
        "make_uint4(0u, 0u, 0u, 0u);\n",
        ('float32_path',)),
    # K3/K4's twin of it: dS.K (P^T.dO, dS^T.q2) reading dS in the
    # accumulator's order against the split B tile's rows 2t, 2t + 1.
    'f32_bwd_pv_reduction_order': (
        'flash_bwd_f32.cu',
        '      fa[m] = frag_a(p[4 * ks], p[4 * ks + 2], p[4 * ks + 1],\n',
        '      fa[m] = frag_a(p[4 * ks], p[4 * ks + 1], p[4 * ks + 2],\n',
        ('float32_path',)),
    # K4's split dO tile stored with its small parts zero: dV (and dP^T)
    # at TF32 accuracy.
    'f32_bwd_do_small_part_zero': (
        'flash_bwd_f32.cu',
        '      split_rows<DV, kN>(reinterpret_cast<uint2*>(st + S::off_g(kN)),\n'
        '                         g + qoff * DV, q0, tq, ptid);\n',
        '      split_rows<DV, kN>(reinterpret_cast<uint2*>(st + S::off_g(kN)),\n'
        '                         g + qoff * DV, q0, tq, ptid);\n'
        '      for (int i = ptid; i < kN * DV; i += kWgThreads)\n'
        '        reinterpret_cast<uint2*>(st + S::off_g(kN))[i].y = 0u;\n',
        ('float32_path',)),
    # K5's float32 P.V: the V rows of a step's columns 8 and 9 swapped.
    'k5_f32_v_rows_swapped': (
        'flash_decode.cu',
        '          const float* vr = vst + cc * DV;\n',
        '          const float* vr = vst + (cc == 8 ? 9 : cc == 9 ? 8 : cc) * '
        'DV;\n',
        ('float32_path',)),
    # K5's float32 S: the butterfly that sums a column's lane partials
    # leaves out one lane's (lane 16 drops lane 0's partials of columns
    # 8-15 at the first halving).
    'k5_f32_butterfly_drops_lane': (
        'flash_decode.cu', '      part[i] = keep + got;\n',
        '      part[i] = lane == 16 && half == 8 ? keep : keep + got;\n',
        ('float32_path',)),
    # K5/K5p's float32 softmax: a row's own span check dropped at its end,
    # so a verify row scores the columns the launch fetched for the later
    # rows (outside its span).
    'k5p_f32_reads_unheld_column': (
        'flash_decode.cu',
        '        const bool ok = ((hmask >> c) & 1) && col >= rc.x && '
        'col <= rc.y;\n',
        '        const bool ok = ((hmask >> c) & 1) && col >= rc.x;\n',
        ('float32_path',)),
}

# Phases a fault names that run alone (the source's PHASES otherwise).
SOLO = ('flash_masks', 'kv_sharded_serve', 'wq8_serve', 'load_serve',
        'router_serve', 'chaos_serve', 'analysis_examples', 'benchmark_cli',
        'float32_path')

# Beside the package, what analysis_examples and benchmark_cli run: the
# harness twins, the smoke scripts, and the files they read.
SUPPORT = ('torch_benchmark.py', 'torch_bench.py', 'bench.py',
           'SLO_BASELINE.json', 'torch_example.py',
           'torch_example_longcontext.py', 'examples', 'scripts')


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
    for name in SUPPORT:
        src = os.path.join(ROOT, name)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(dst, name),
                            ignore=shutil.ignore_patterns('__pycache__'))
        else:
            shutil.copy(src, dst)
    if source.startswith('./'):
        path = os.path.join(dst, source[2:])
    else:
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
            cases[f"{row['phase']}/error"] = row.get('error')
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
        elif row.get('phase') == 'chaos_serve' and row.get('case') not in (
                'twin', 'done', None):
            cases[f"chaos_serve/{row['case']}"] = {
                k: row[k] for k in ('kills', 'doctor', 'recovered', 'healed',
                                    'scale_ups', 'scale_downs', 'retired')
                if k in row}
        elif row.get('phase') in ('analysis_examples', 'benchmark_cli') \
                and row.get('case') not in ('done', None):
            cases[f"{row['phase']}/{row['case']}"] = {
                k: row[k] for k in ('launches', 'totals', 'entries',
                                    'resumed_vs_whole', 'bound_ms',
                                    'dist_ms', 'local_ms') if k in row}
        elif row.get('phase') == 'float32_path' and 'bwd' in row:
            cases[f"float32_path/{row['case']}"] = {
                'k1_row_rel': row['k1']['max_row_rel_err'],
                'lse': row['k1']['lse_max_abs_err'],
                'bwd_held': row['bwd']['held']}
        elif row.get('phase') == 'float32_path' and \
                str(row.get('case')).startswith('decode_'):
            cases[f"float32_path/{row['case']}"] = {
                k: v['max_row_rel_err'] for k, v in row.items()
                if isinstance(v, dict) and 'max_row_rel_err' in v}
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
