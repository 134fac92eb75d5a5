#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Named variants of the float32 backward's source (K3 f32 and K4 f32 in
``csrc/flash_bwd_f32.cu``), each built from a temporary copy of ``csrc/``
and timed at the float32 LM's shape on one CUDA card.

    python3 scripts/torch_bwd_f32_variants.py [NAME ...]

Without names it runs every variant of ``VARIANTS``. Each variant is a
list of (anchor, replacement) edits of the source, every anchor there
once; all variants build at once through the port's builder, then each
runs in a process of its own (a variant that traps ends its process
only): K3 and K4 at 4 x 8 heads x 4096 rows, head dim 96, causal, timed
as ``chip_smoke.time_ms`` times them (CUDA events, cold L2), and, for the
variants that keep the arithmetic, the largest difference of dq, dk and
dv from the unedited build's on the same inputs. Some variants break the
numerics on purpose to show what a part of the kernel costs
(``one_tf32_mma``: one TF32 product in place of three; ``no_b_loads``:
constant B fragments in place of the shared loads). Prints one JSON line
a variant: the card, ``ptxas``'s registers and spill bytes of the two
kernels at (96, 96), the times and the differences. Run from the
repository root.
"""

import json
import math
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, 'scripts'))
import torch_bwd_f32_sections as sections  # noqa: E402

_PRODUCER = ('    // The producer: each tile the block sees into the next '
             'free stage.\n')
_PRODUCER4 = ('    // The producer: each (head, query tile) item into the '
              'next free stage.\n')
_ROLE = ('  const int wg = warpgroup_of_thread();   // the producer: wg == kWg\n'
         '  if (wg == kWg) {\n')
_DIVIDED = ('  const int wg = static_cast<int>(threadIdx.x) / kWgThreads;\n'
            '  if (wg == kWg) {\n')
_CONSUMER = "    // A consumer warpgroup: its 64 rows' dq.\n"
_CONSUMER4 = "    // A consumer warpgroup: its 64 key rows' dk and dv.\n"


def _shares(producer, consumer):
    """setmaxnreg: the producer warpgroup down to `producer` registers a
    thread, the two consumer ones up to `consumer` (with one consumer
    warpgroup, 255 each already)."""
    line = ('    if constexpr (kWg == 2) asm volatile('
            '"setmaxnreg.{}.sync.aligned.u32 {};\\n");\n')
    dec, inc = line.format('dec', producer), line.format('inc', consumer)
    return [(_PRODUCER, dec + _PRODUCER), (_PRODUCER4, dec + _PRODUCER4),
            (_CONSUMER, inc + _CONSUMER), (_CONSUMER4, inc + _CONSUMER4)]


_ONE_MMA = [
    ('mma3_parts(part[m] + 4 * nt, fa[m], lo.x, lo.y, hi.x, hi.y);',
     'mma_tf32(part[m] + 4 * nt, fa[m].big, lo.x, hi.x);'),
    ('mma3_parts(part[m] + 4 * (nt - N0), fa[m], lo.x, lo.y, hi.x, hi.y);',
     'mma_tf32(part[m] + 4 * (nt - N0), fa[m].big, lo.x, hi.x);')]
_NO_B = [
    ('const uint2 lo = op[m].b[b0[kk & 1] + 8 * nt * K + 8 * kk];',
     'const uint2 lo = make_uint2(0x3f800000u + nt, 0u);'),
    ('const uint2 hi = op[m].b[b1[kk & 1] + 8 * nt * K + 8 * kk];',
     'const uint2 hi = make_uint2(0x3f800000u + kk, 0u);'),
    ('const uint2 lo = op[m].b[b0[nt & 1] + 8 * ks * kRow + 8 * nt];',
     'const uint2 lo = make_uint2(0x3f800000u + nt, 0u);'),
    ('const uint2 hi = op[m].b[b1[nt & 1] + 8 * ks * kRow + 8 * nt];',
     'const uint2 hi = make_uint2(0x3f800000u + ks, 0u);')]

# name: (edits, whether the arithmetic is kept)
VARIANTS = {
    'as_is': ([], True),
    'setmaxnreg_56_224': (_shares(56, 224), True),
    'setmaxnreg_40_232': (_shares(40, 232), True),
    'setmaxnreg_24_240': (_shares(24, 240), True),
    'unfused_s_dp': ([
        ('if constexpr (!Quant && D == DV) {\n          // S and dP side by',
         'if constexpr (false) {\n          // S and dP side by'),
        ('if constexpr (!Quant && D == DV) {\n          // S^T and dP^T side',
         'if constexpr (false) {\n          // S^T and dP^T side')], True),
    'unfused_dv_dk': ([
        ('} else if constexpr (D == DV) {\n          // dV and dK side by',
         '} else if constexpr (false) {\n          // dV and dK side by')],
        True),
    'role_by_division': ([
        (_ROLE + _PRODUCER, _DIVIDED + _PRODUCER),
        (_ROLE + _PRODUCER4, _DIVIDED + _PRODUCER4)], True),
    'one_tf32_mma': (_ONE_MMA, False),
    'no_b_loads': (_NO_B, False),
    'one_tf32_mma_no_b_loads': (_ONE_MMA + _NO_B, False),
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
    q, k, v, g = (torch.randn((B, H, T, D), generator=gen).to(dev)
                  for _ in range(4))
    scale = 1.0 / math.sqrt(D)
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=True, scale=scale)
    q2, lse2, delta = fa.flash_attention_bwd_operands(q, out, lse, g, scale)

    def k3():
        return fa.flash_attention_dq(q2, k, v, g, lse2, delta, causal=True,
                                     scale=scale)

    def k4():
        return fa.flash_attention_dkv(q2, k, v, g, lse2, delta, causal=True)

    row = {'variant': name}
    if VARIANTS[name][1]:
        sections.point(_build, base_place)
        want = (k3(), *k4())
        sections.point(_build, place)
        got = (k3(), *k4())
        torch.cuda.synchronize()
        row['max_abs_diff_vs_as_is'] = {
            n: (a - b).abs().max().item()
            for n, a, b in zip(('dq', 'dk', 'dv'), got, want)}
    sections.point(_build, place)
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    row['k3_ms'] = chip_smoke.time_ms(torch, k3, flush)
    row['k4_ms'] = chip_smoke.time_ms(torch, k4, flush)
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
        print('torch_bwd_f32_variants: no CUDA card', file=sys.stderr)
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
        places = {n: sections.csrc_copy(tmp, n, edited(text, VARIANTS[n][0]))
                  for n in dict.fromkeys(['as_is', *names])}
        reports = sections.build_together(_build, places)
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
