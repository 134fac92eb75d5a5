# -*- coding: utf-8 -*-
"""
The port's benchmark CLI (``torch_benchmark.py``) and headline line
(``torch_bench.py``) against the reference's (``benchmark.py``,
``bench.py``) on the CPU: the same flags, choices and defaults (plus
``--device``); for each mode of the reference's CLI tests
(``tests/test_benchmark_cli.py``), at their tiny sizes, the reference's
row computed in this process once and the twin's row carrying its keys,
with the values that do not depend on the random weights equal (sizes,
counts, the serve-load goodput and ticks on the virtual clock); the rows
of the modes the reference cannot run here (its sharded decode fails on
this jax, ROADMAP §3) or runs too slowly for this file (the LM step, the
chaos twins) held against the keys of the reference's own row literals;
the append-to-JSON file; ``--device cuda`` refusing without a card; and,
in one subprocess, the twins importing no ``jax`` while two ranks on the
CPU write one averaged row and ``torch_bench.py`` prints ``bench.py``'s
keys.
"""

import argparse
import ast
import contextlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import benchmark  # noqa: E402  the reference CLI
import torch_benchmark  # noqa: E402

from torch_serving import cyclic_gc_paused  # noqa: E402,F401

# case: (row kind, the reference CLI test's arguments).
CASES = {
    'nt': ('nt', '--mode nt --scale 2344 --offset 2 --devices 1'),
    'all': ('nt_skip_local',
            '--mode all --scale 2344 --offset 2 --skip-local --devices 1'),
    'tn': ('nt_skip_local', '--mode tn --scale 2344 --skip-local --devices 1'),
    'attn': ('attn', '--mode attn --attn-impl online --scale 2344 '
                     '--devices 1'),
    'train': ('train', '--mode train --attn-impl online --seq-len 64 '
                       '--devices 1'),
    'decode': ('decode', '--mode decode --seq-len 128 --heads 2 '
                         '--head-dim 8 --decode-impl xla --decode-chain 2'),
    'decode_spec': ('decode_spec', '--mode decode --spec ngram --seq-len 128 '
                                   '--heads 2 --head-dim 8'),
    'decode_serve': ('decode_serve', '--mode decode-serve --seq-len 48 '
                                     '--serve-requests 4'),
    'decode_serve_paged': ('decode_serve_paged',
                           '--mode decode-serve --seq-len 64 --batch 2 '
                           '--serve-requests 8 --cache-mode paged '
                           '--page-size 8'),
    'serve_load': ('serve_load', '--mode serve-load'),
    'serve_load_topology': ('serve_load_topology',
                            '--mode serve-load --topology 1x2 '
                            '--load-requests 24'),
}

# Rows of the twin alone: (row kind, arguments).
TWIN_ONLY = {
    'decode_kernel': ('decode', '--mode decode --seq-len 128 --heads 2 '
                                '--head-dim 8 --decode-impl kernel'),
    'lm': ('lm', '--mode lm --seq-len 64 --layers 1 --vocab 64 --heads 2'),
    'decode_kv_shards': ('decode_kv_shards',
                         '--mode decode --kv-shards 4 --seq-len 512 '
                         '--heads 2 --head-dim 8'),
    'serve_load_chaos': ('serve_load_chaos',
                         '--mode serve-load --topology 1x2 --chaos '
                         '--slo-ttft 2.0 --slo-token 1.0'),
    'serve_load_corrupt': ('serve_load_corrupt',
                           '--mode serve-load --topology 1x2 '
                           '--chaos-victim r0 --chaos-corrupt 2:8 '
                           '--slo-ttft 2.0 --slo-token 1.0'),
}

# Values that do not depend on the random weights.
SAME = ('T', 'world', 'slots', 'pages', 'page_size', 'kv_budget_bytes',
        'completed', 'requests')


def _argv(case_args, tmp, name):
    argv = case_args.split() + ['--iters', '1',
                                '--file', str(tmp / f'{name}.json')]
    if '--mode serve-load' in case_args:
        log = tmp / (name if '--topology' in case_args else f'{name}.jsonl')
        argv += ['--event-log', str(log)]
    return argv


def _one_row(path):
    with open(path) as f:
        rows = json.load(f)
    assert len(rows) == 1, rows
    return rows[0]


@pytest.fixture(scope='module')
def reference_rows(tmp_path_factory):
    """The reference CLI's row of every case, computed in this process
    (the retrace sentinel off: its topology trips it, ROADMAP §3; the
    cyclic collector paused through the module, ``cyclic_gc_paused``)."""
    tmp = tmp_path_factory.mktemp('reference')
    rows = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv('DDP_TPU_RETRACE_SENTINEL', '0')
        for name, (_, args) in CASES.items():
            argv = _argv(args, tmp, name)
            mp.setattr(sys, 'argv', ['benchmark.py'] + argv)
            with contextlib.redirect_stdout(io.StringIO()):
                benchmark.run(benchmark.parse_args())
            rows[name] = _one_row(tmp / f'{name}.json')
    return rows


@pytest.fixture(scope='module')
def twin_rows(tmp_path_factory):
    """The twin's row of every case and twin-only run, on the CPU, one
    intra-op thread (the rows are tiny; more threads only contend)."""
    tmp = tmp_path_factory.mktemp('twin')
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    rows = {}
    try:
        for name, (_, args) in {**CASES, **TWIN_ONLY}.items():
            argv = ['--device', 'cpu'] + _argv(args, tmp, name)
            with contextlib.redirect_stdout(io.StringIO()):
                torch_benchmark.main(argv)
            rows[name] = _one_row(tmp / f'{name}.json')
    finally:
        torch.set_num_threads(threads)
    return rows


def _parser(module, argv_kw):
    """The argparse parser a module's ``parse_args`` builds."""
    grabbed = {}
    original = argparse.ArgumentParser.parse_args

    def grab(self, *args, **kwargs):
        grabbed['parser'] = self
        return original(self, [])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(argparse.ArgumentParser, 'parse_args', grab)
        mp.setattr(sys, 'argv', ['prog'])
        module.parse_args(**argv_kw)
    return {a.dest: a for a in grabbed['parser']._actions
            if a.dest != 'help'}


def test_parser_has_the_references_flags_defaults_and_choices():
    ref = _parser(benchmark, {})
    twin = _parser(torch_benchmark, {'argv': []})
    assert set(twin) == set(ref) | {'device'}
    assert twin['device'].default == 'cuda'
    for dest, a in ref.items():
        b = twin[dest]
        assert b.option_strings == a.option_strings, dest
        assert b.default == a.default, dest
        assert b.choices == a.choices, dest
        assert type(b) is type(a), dest
        assert b.metavar == a.metavar, dest
        assert (b.type is None) == (a.type is None), dest
        if a.type is not None and a.type not in (int, float, str):
            for text in ('none', 'full', '7'):      # --offset's parser
                assert b.type(text) == a.type(text), (dest, text)
        else:
            assert b.type == a.type, dest


@pytest.mark.parametrize('case', sorted(CASES))
def test_twin_row_has_the_reference_rows_keys(case, reference_rows,
                                              twin_rows):
    kind, _ = CASES[case]
    ref, twin = reference_rows[case], twin_rows[case]
    assert set(ref) == set(torch_benchmark.REFERENCE_ROW_KEYS[kind])
    assert set(ref) <= set(twin), sorted(set(ref) - set(twin))
    assert twin['platform'] == 'cpu' and twin['device_kind'] == 'cpu'
    assert set(twin['kernel_launches']) == set(torch_benchmark.KERNELS)
    assert set(twin['kernel_launches_f32']) == set(torch_benchmark.KERNELS)


@pytest.mark.parametrize('device', ['cuda', 'cpu'])
def test_dtypes_follow_the_reference_cli_on_every_device(device):
    """``--dtype f32`` computes in float32 on the card as on the CPU (the
    kernels take float32), ``bf16`` in bf16, and the serving engines run
    float32, the reference ``KernelEngine``'s default (a device object
    needs no card)."""
    dev = torch.device(device)
    assert torch_benchmark._compute_dtype('f32', dev) == torch.float32
    assert torch_benchmark._compute_dtype('bf16', dev) == torch.bfloat16
    assert torch_benchmark._engine_dtype(dev) == torch.float32


@pytest.mark.parametrize('case', sorted(CASES))
def test_weight_independent_values_equal(case, reference_rows, twin_rows):
    ref, twin = reference_rows[case], twin_rows[case]
    compared = [k for k in SAME if k in ref]
    assert compared, case
    assert {k: twin[k] for k in compared} == {k: ref[k] for k in compared}
    for key in ('mode', 'decode_impl', 'cache_mode', 'offset', 'impl',
                'attn_impl', 'spec', 'topology'):
        if key in ref:
            assert twin[key] == ref[key], key


@pytest.mark.parametrize('case', ['serve_load', 'serve_load_topology'])
def test_serve_load_goodput_and_ticks_equal(case, reference_rows,
                                            twin_rows):
    ref, twin = reference_rows[case], twin_rows[case]
    keys = ['per_tenant', 'goodput_pct', 'counts', 'ticks',
            'virtual_seconds', 'rate_offered']
    if case == 'serve_load_topology':
        keys += ['twin_goodput_pct', 'twin_counts', 'twin_ticks']
    assert {k: twin[k] for k in keys} == {k: ref[k] for k in keys}


def _reference_dict_keys(function, target=None):
    """The constant keys of the dict literal ``function`` in benchmark.py
    assigns to ``target`` (or returns, when None)."""
    with open(os.path.join(REPO, 'benchmark.py')) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == function)
    for node in ast.walk(fn):
        value = None
        if target is None and isinstance(node, ast.Return):
            value = node.value
        elif isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == target
                for t in node.targets):
            value = node.value
        if isinstance(value, ast.Dict) and value.keys:
            return {k.value for k in value.keys}
    raise AssertionError(f'no dict literal {target} in {function}')


@pytest.mark.parametrize('case', sorted(TWIN_ONLY))
def test_rows_the_reference_cannot_run_here_carry_its_keys(case, twin_rows,
                                                           reference_rows):
    kind, _ = TWIN_ONLY[case]
    want = set(torch_benchmark.REFERENCE_ROW_KEYS[kind])
    topo = set(reference_rows['serve_load_topology'])
    literal = {
        'decode': lambda: set(reference_rows['decode']),
        'lm': lambda: _reference_dict_keys('measure_lm_step'),
        'decode_kv_shards': lambda: _reference_dict_keys(
            'run_decode_kv_sharded', 'record'),
        'serve_load_chaos': lambda: topo | _reference_dict_keys(
            'run_serve_load_topology', 'chaos_extra'),
        'serve_load_corrupt': lambda: topo | _reference_dict_keys(
            'run_serve_load_topology', 'corrupt_extra'),
    }[kind]()
    assert want == literal
    twin = twin_rows[case]
    assert want <= set(twin), sorted(want - set(twin))


def test_decode_paths_keep_the_references_names(twin_rows):
    assert twin_rows['decode']['decode_impl'] == 'xla'
    assert twin_rows['decode_kernel']['decode_impl'] == 'kernel'
    assert twin_rows['decode_serve']['decode_impl'] == 'xla'   # auto, CPU
    assert twin_rows['decode_kv_shards']['decode_steps'] == 49
    chaos, corrupt = (twin_rows['serve_load_chaos'],
                      twin_rows['serve_load_corrupt'])
    assert chaos['recovered_bitident'] and chaos['replica_lost'] == ['r1']
    assert corrupt['corrupt_bitident'] and corrupt['nointeg_wrong_streams']


def test_rows_append_to_the_json_file(tmp_path):
    path = tmp_path / 'rows.json'
    path.write_text(json.dumps([{'earlier': 1}]))
    argv = ['--device', 'cpu', '--mode', 'tn', '--scale', '2344',
            '--skip-local', '--iters', '1', '--file', str(path)]
    with contextlib.redirect_stdout(io.StringIO()):
        first = torch_benchmark.main(argv)
        torch_benchmark.main(argv)
    rows = json.loads(path.read_text())
    assert len(rows) == 3 and rows[0] == {'earlier': 1}
    assert rows[1]['mode'] == rows[2]['mode'] == 'tn'
    assert rows[1]['T'] == first['T'] == 31


def test_cuda_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: the default device runs')
    with pytest.raises(RuntimeError, match='cuda'):
        torch_benchmark.main(['--mode', 'nt', '--file',
                              str(tmp_path / 'x.json')])
    assert not (tmp_path / 'x.json').exists()


def _bench_keys():
    """The keys of bench.py's JSON line (its ``json.dumps`` literal) and
    of its ``detail``."""
    with open(os.path.join(REPO, 'bench.py')) as f:
        tree = ast.parse(f.read())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, 'attr', None) == 'dumps')
    line = call.args[0]
    keys = {k.value for k in line.keys}
    detail = line.values[[k.value for k in line.keys].index('detail')]
    return keys, {k.value for k in detail.keys}


_SUBPROCESS = r'''
import json
import sys

sys.path.insert(0, sys.argv[1])
import torch_bench
import torch_benchmark

rec = torch_benchmark.main([
    '--device', 'cpu', '--mode', 'nt', '--scale', '2344', '--offset', '2',
    '--devices', '2', '--iters', '1', '--skip-local', '--file', sys.argv[2]])
line = torch_bench.main(['--device', 'cpu'])
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'flax')
             or m.split('.')[0] == 'distributed_dot_product_tpu')
print('RESULT ' + json.dumps({'jax_modules': bad, 'record': rec,
                              'line': line}))
'''


def test_twins_import_no_jax_two_ranks_write_one_row_bench_keys(tmp_path):
    path = tmp_path / 'ranks.json'
    env = {k: v for k, v in os.environ.items()
           if not k.startswith('DDP_TPU_')}
    env['OMP_NUM_THREADS'] = '1'
    proc = subprocess.run(
        [sys.executable, '-c', _SUBPROCESS, REPO, str(path)], cwd=REPO,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout
    out = json.loads(proc.stdout.split('RESULT ', 1)[1])
    assert out['jax_modules'] == []
    row = _one_row(path)
    assert row['world'] == 2 and row['n_processes'] == 2
    assert row['T'] == 30 and out['record']['world'] == 2
    keys, detail = _bench_keys()
    assert set(out['line']) == keys
    assert detail <= set(out['line']['detail'])
