#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Planted faults against ``chip_smoke.py``'s kernel checks, on one CUDA card.

    python3 scripts/torch_planted_faults.py      # from the repository root

For each fault below: copies ``chip_smoke.py`` and the port's package into
a temporary directory, plants the fault in one kernel source, runs
``chip_smoke.py --phases flash_attention,flash_backward`` there, and reads
those phases' lines. The run must fail, in a phase that holds the
faulty kernel. Prints one JSON line per fault with the readings of every case
(largest row error and whole-tensor error of out / dq / dk / dv, K1's lse
error), then ``{"faults": n, "caught": m}``; exits non-zero unless every
fault was caught. The faults sit past query or key tile 32, so only the
training shape (T 4096, 64 tiles) reaches them, or round an accumulator to
bf16 after every tile.
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


# name: (source, text to replace, replacement, phases one of which
# must fail)
FAULTS = {
    'k1_late_diagonal_tile_dropped': (
        'flash_fwd.cu', 'for (int t = t_begin; t < n_ktiles; ++t) {',
        'for (int t = t_begin; t < n_ktiles - (tile >= 32 ? 1 : 0); ++t) {',
        ('flash_attention', 'flash_backward')),
    'k1_accumulator_bf16': (
        'flash_fwd.cu', 'orow[c] *= corr;',
        'orow[c] = __bfloat162float(__float2bfloat16(orow[c] * corr));',
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
}


# The phases that hold K1, K3 and K4 at the training shape.
PHASES = ('flash_attention', 'flash_backward')


def plant(dst, source, old, new):
    shutil.copy(os.path.join(ROOT, 'chip_smoke.py'), dst)
    shutil.copytree(os.path.join(ROOT, PKG), os.path.join(dst, PKG),
                    ignore=shutil.ignore_patterns('__pycache__'))
    path = os.path.join(dst, PKG, 'csrc', source)
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
        if row.get('phase') in ('flash_attention', 'flash_backward') and \
                'max_row_rel_err' in row:
            key = f"{row['phase']}/{row['case']}"
            cases[key] = {'row_rel': row['max_row_rel_err'],
                          'rel': row['rel_err']}
            if isinstance(row['max_abs_err'], dict):
                cases[key]['lse'] = row['max_abs_err']['lse']
    return cases, failed


def main():
    caught = 0
    for name, (source, old, new, phases) in FAULTS.items():
        with tempfile.TemporaryDirectory() as dst:
            plant(dst, source, old, new)
            run = subprocess.run([sys.executable, 'chip_smoke.py',
                                  '--phases', ','.join(PHASES)], cwd=dst,
                                 capture_output=True, text=True, timeout=900)
        cases, failed = readings(run.stdout)
        ok = run.returncode != 0 and failed in phases
        caught += ok
        print(json.dumps({'fault': name, 'source': source,
                          'must_fail_in': phases, 'failed_phase': failed,
                          'rc': run.returncode, 'caught': ok,
                          'readings': cases}), flush=True)
    print(json.dumps({'faults': len(FAULTS), 'caught': caught}), flush=True)
    return 0 if caught == len(FAULTS) else 1


if __name__ == '__main__':
    sys.exit(main())
