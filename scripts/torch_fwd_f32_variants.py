#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Named variants of the float32 forward's source (K1 f32 and K2 f32 in
``csrc/flash_f32.cu``), each built from a temporary copy of ``csrc/`` and
timed at the float32 LM's shape on one CUDA card (the forward twin of
``scripts/torch_bwd_f32_variants.py``).

    python3 scripts/torch_fwd_f32_variants.py [NAME ...]

Without names it runs every variant of ``VARIANTS``. Each variant is a
list of (anchor, replacement) edits of the source, every anchor there
once; all variants build at once through the port's builder, then each
runs in a process of its own (a variant that traps ends its process
only): K1 and K2 (on a precomputed row bound) at 4 x 8 heads x 4096 rows,
head dim 96, causal, timed as ``chip_smoke.time_ms`` times them (CUDA
events, cold L2), and, for the variants that keep the arithmetic, the
largest difference of K1's and K2's outputs from the unedited build's on
the same inputs. Some variants break the numerics on purpose to show
what a part of the kernel costs (``one_tf32_s`` / ``one_tf32_pv``: one
TF32 product in place of three in S / P.V; ``no_products``: neither
product; ``no_products_no_producer``: nor the producer's loads, splits
and stores). Prints one JSON line a variant: the card's name and power
limit, ``ptxas``'s registers and spill bytes of K1/K2 at (96, 96), the
times and the differences. Run from the repository root.
"""

import json
import math
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'scripts'))
import torch_bwd_f32_sections as bwd  # noqa: E402
import torch_fwd_f32_sections as sections  # noqa: E402

_PV_CALL = '      pv_product<kN, DV>(o, s, vt, vt + S::plane_v(kN));\n'
_S_CALL = ('        s_product<kN, D>(s, qa0, qa0 + 8 * PQ, kt, '
           'kt + S::plane_k(kN));\n')
_ONE_TERM = '([&](auto term) { term(false, false); })('


def _group(name, was, n):
    return [(f'constexpr int {name} = {was};',
             f'constexpr int {name} = {n};')]


# The two consumer warpgroups take turns on the tensor core (S, then P.V),
# handed over by two more mbarriers; a tile a warpgroup skips still takes
# and passes its turns, so both walk the same sequence.
_PING_PONG = [
    ('  static constexpr size_t kBytes = kBars + 2 * kS * sizeof(uint64_t);',
     '  static constexpr size_t kBytes = kBars + (2 * kS + 2) * '
     'sizeof(uint64_t);'),
    ('  init_bars<kS>(full, empty, kWgThreads * kWg);\n',
     '  uint64_t* turn = empty + kS;\n'
     '  if (kWg == 2 && threadIdx.x == 0) {\n'
     '    mbar_init(turn, kWgThreads);\n'
     '    mbar_init(turn + 1, kWgThreads);\n'
     '  }\n'
     '  init_bars<kS>(full, empty, kWgThreads * kWg);\n'),
    ('  Ring ring;\n  for (int t = next_tile(span.lo);',
     '  uint32_t my_turn = 0;\n'
     '  auto turn_wait = [&] {\n'
     '    if constexpr (kWg == 2) {\n'
     '      stage_wait(turn + wg, my_turn);\n'
     '      my_turn ^= 1;\n'
     '    }\n'
     '  };\n'
     '  auto turn_pass = [&] {\n'
     '    if constexpr (kWg == 2) mbar_arrive(turn + (wg ^ 1));\n'
     '  };\n'
     '  if (kWg == 2 && wg == 1) mbar_arrive(turn);\n'
     '  Ring ring;\n  for (int t = next_tile(span.lo);'),
    ('    if (live && span_sees<Ext>(own, t, kN, posk_mm, ext)) {\n',
     '    if (live && span_sees<Ext>(own, t, kN, posk_mm, ext)) {\n'
     '      turn_wait();\n'),
    ('      // [section] fwd consumer: S done\n',
     '      turn_pass();\n      // [section] fwd consumer: S done\n'),
    (_PV_CALL, '      turn_wait();\n' + _PV_CALL + '      turn_pass();\n'),
    ('      mbar_arrive(empty + kring.slot);\n'
     '      stage_wait(full + vring.slot, vring.phase);\n'
     '      mbar_arrive(empty + vring.slot);\n    }\n',
     '      turn_wait();\n      turn_pass();\n'
     '      turn_wait();\n      turn_pass();\n'
     '      mbar_arrive(empty + kring.slot);\n'
     '      stage_wait(full + vring.slot, vring.phase);\n'
     '      mbar_arrive(empty + vring.slot);\n    }\n')]
_NO_PRODUCTS = [(_PV_CALL, ''),
                (_S_CALL, '        for (int i = 0; i < kN / 2; ++i) '
                          's[i] = 0.f;\n')]
_NO_PRODUCER = [
    ('        kr.store(st, st + S::plane_k(kN), ptid);\n', '        ;\n'),
    ('      vt.store(st, st + S::plane_v(kN), ptid);\n', ''),
    ('      if constexpr (!Quant) kr.load(kbase, t * kN, tk, ptid);\n', ''),
    ('      vt.load(vbase, t * kN, tk, ptid);\n', '')]

# name: (edits, whether the arithmetic is kept)
VARIANTS = {
    'as_is': ([], True),
    's_group_2': (_group('kSGroup', 1, 2), True),
    's_group_3': (_group('kSGroup', 1, 3), True),
    'pv_group_2': (_group('kPvGroup', 1, 2), True),
    'pv_group_4': (_group('kPvGroup', 1, 4), True),
    'ping_pong': (_PING_PONG, True),
    'one_tf32_s': ([('  tf32x3_terms([&](bool a_small, bool b_small) {\n'
                     '    WgmmaTf32<N>::rs(acc,',
                     '  ' + _ONE_TERM + '[&](bool a_small, bool b_small) {\n'
                     '    WgmmaTf32<N>::rs(acc,')], False),
    'one_tf32_pv': ([('    tf32x3_terms([&](bool a_small, bool b_small) {\n'
                      '      WgmmaTf32<W>::rs(fresh,',
                      '    ' + _ONE_TERM + '[&](bool a_small, bool b_small) '
                      '{\n      WgmmaTf32<W>::rs(fresh,')], False),
    'no_products': (_NO_PRODUCTS, False),
    'no_products_no_producer': (_NO_PRODUCTS + _NO_PRODUCER, False),
}

B, H, T, D = 4, 8, 4096, 96


def edited(text, edits):
    for old, new in edits:
        if text.count(old) != 1:
            raise SystemExit(f'anchor not there once: {old!r}')
        text = text.replace(old, new)
    return text


def run(name, place, base_place):
    """One variant in this process: its times and, where it keeps the
    arithmetic, its differences from the unedited build."""
    import importlib

    import torch
    sys.path.insert(0, ROOT)
    import chip_smoke
    from distributed_dot_product_tpu_torch.ops import _build
    fa = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_attention')
    gen = torch.Generator().manual_seed(0)
    dev = torch.device('cuda')
    q, k, v = (torch.randn((B, H, T, D), generator=gen).to(dev)
               for _ in range(3))
    scale = 1.0 / math.sqrt(D)
    mvec = fa.bounded_shift(q * (scale * math.log2(math.e)), k)

    def k1():
        return fa.flash_attention(q, k, v, causal=True, scale=scale)

    def k2():
        return fa.flash_attention_bounded(q, k, v, causal=True, scale=scale,
                                          mvec=mvec)

    row = {'variant': name}
    if VARIANTS[name][1]:
        bwd.point(_build, base_place, sections.LIB)
        want = (k1(), k2())
        bwd.point(_build, place, sections.LIB)
        got = (k1(), k2())
        torch.cuda.synchronize()
        row['max_abs_diff_vs_as_is'] = {
            n: (a - b).abs().max().item()
            for n, a, b in zip(('k1', 'k2'), got, want)}
    bwd.point(_build, place, sections.LIB)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    row['k1_ms'] = chip_smoke.time_ms(torch, k1, flush)
    row['k2_ms'] = chip_smoke.time_ms(torch, k2, flush)
    print(json.dumps(row), flush=True)


def main():
    if len(sys.argv) > 1 and sys.argv[1] == '--one':
        name, place, base = sys.argv[2], sys.argv[3:5], sys.argv[5:7]
        run(name, tuple(place), tuple(base))
        return 0
    names = sys.argv[1:] or list(VARIANTS)
    unknown = sorted(set(names) - set(VARIANTS))
    if unknown:
        raise SystemExit(f'unknown variants {unknown}: {list(VARIANTS)}')
    import torch
    if not torch.cuda.is_available():
        print('torch_fwd_f32_variants: no CUDA card', file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke
    from distributed_dot_product_tpu_torch.ops import _build
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip()
    with open(sections.OWN) as f:
        text = f.read()
    with tempfile.TemporaryDirectory() as tmp:
        places = {n: bwd.csrc_copy(tmp, n, edited(text, VARIANTS[n][0]),
                                   'flash_f32.cu')
                  for n in dict.fromkeys(['as_is', *names])}
        reports = bwd.build_together(_build, places, sections.LIB, ())
        for name in names:
            regs = sections.registers_at_96(reports[name],
                                            chip_smoke.kernel_label)
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), '--one', name,
                 *places[name], *places['as_is']],
                capture_output=True, text=True, timeout=900, cwd=ROOT)
            try:
                row = json.loads(res.stdout.strip().splitlines()[-1])
            except (ValueError, IndexError):
                row = {'variant': name, 'rc': res.returncode,
                       'error': res.stderr[-600:]}
            print(json.dumps({'card': smi, **row, 'ptxas_96': regs}),
                  flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
