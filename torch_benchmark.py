# -*- coding: utf-8 -*-
"""
Benchmark CLI of the PyTorch / CUDA port — the twin of ``benchmark.py``,
with its flags (names, choices and defaults), its modes, its result rows
(same keys, same meanings) and its append-to-JSON result file, plus
``--device``:

    python torch_benchmark.py --mode nt --offset 1000 --scale 2 --file out.json
    python torch_benchmark.py --mode decode-serve --cache-mode paged
    python torch_benchmark.py --device cpu --mode nt --scale 2344

Every mode runs on the card (``--device cuda``, the default; without a
card it raises) unless given ``--device cpu``, where the kernels' plain
PyTorch versions run. Workload of the sequence matmuls: ``T =
75000/scale``, ``d = 768``; the "local" baseline is the full-size product
on one card, the "distributed" measurement the sequence-sharded product
over every rank (``--devices N`` starts N ranks on the one card over
gloo, host-staged collectives, from this one command; ``--multihost``
joins a process group of one process per host; ``torchrun`` describes
one the same way).

What differs from the reference, and why:

- The timed call reduces its output to a float32 scalar, as the
  reference's does inside its jit (``_summed``). The distributed call
  sums each rank's shard of the product and all-reduces the scalar: the
  reference's sum of a sharded global array never gathers it, and the
  port's ``distributed_matmul_*_global`` wrappers would (a (T, T) output
  on every rank). The shard-local products are those wrappers' own
  (``ops/functions.py``).
- ``perf_model`` and ``dist_memory_analysis`` (``memory_analysis``)
  read XLA's compiled executable in the reference. Here one extra call
  of the timed function is counted: FLOPs and bytes by ``obs/perf.py``'s
  ``CostCounter`` (the kernels by their own formulas) into
  ``program_model``, and the card's memory around it
  (``torch.cuda.memory_allocated`` / ``max_memory_allocated``: the
  arguments, the output, the temporaries above both). The memory
  analysis is None on the CPU, which has no such counters.
- ``--dtype f32`` computes in float32 on the card as on the CPU: the
  flash kernels (K1–K5p) take float32 operands through their
  float32-accurate kernels, as they take bf16 through their bf16 ones;
  the rows record it as ``compute_dtype``. The serving engines run
  float32, the reference ``KernelEngine``'s default, whatever ``--dtype``
  says, as the reference's do (``engine_dtype``).
- ``--decode-impl auto`` resolves to ``kernel`` on the card and to the
  plain path on the CPU; the rows keep the reference's strings,
  ``kernel`` / ``xla`` (``xla`` names the plain path).
- ``--decode-chain N``: the reference's ``lax.scan`` of N steps inside
  one jit is N module steps a timed call here (no fused dispatch).
- Every row also carries ``kernel_launches``: each CUDA kernel's
  launches in the run, its wrapper's count (K1 ``flash_attention``, K2
  ``flash_attention_bounded``, K3 ``flash_attention_dq``, K4
  ``flash_attention_dkv``, K5 ``flash_decode``, K5p
  ``flash_decode_paged``; all 0 on the CPU, where the plain versions
  run), and ``kernel_launches_f32``: those of them on float32 operands.

Imports ``torch`` and the port, never ``jax``.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

from distributed_dot_product_tpu_torch.obs import spans as obs_spans
from distributed_dot_product_tpu_torch.obs.spans import span
from distributed_dot_product_tpu_torch.ops.functions import (
    distributed_matmul_all, distributed_matmul_nt, distributed_matmul_tn,
)
from distributed_dot_product_tpu_torch.parallel.mesh import (
    seq_mesh, shard_seq,
)
from distributed_dot_product_tpu_torch.utils import comm, tracing
from distributed_dot_product_tpu_torch.utils.tracing import (
    device_peak_bytes, hard_sync, time_fn,
)

FULL_T = 75000
DIM = 768

# The CUDA kernels whose launches every row reports (their wrappers'
# counters, ops/flash_attention.py and ops/flash_decode.py).
KERNELS = ('flash_attention', 'flash_attention_bounded',
           'flash_attention_dq', 'flash_attention_dkv', 'flash_decode',
           'flash_decode_paged')

# The keys of the reference's row for each kind of run (benchmark.py),
# which every row of the same kind here carries (and more: the
# compute_dtype / engine_dtype / kernel_launches notes above).
# tests/test_torch_benchmark_cli.py holds each against a row the
# reference writes; chip_smoke.py's benchmark_cli phase checks the rows
# the card writes against them.
_LOCAL_KEYS = ('local_time', 'local_time_mean', 'local_gflops')
_MATMUL_KEYS = ('mode', 'scale', 'offset', 'impl', 'T', 'dim', 'world',
                'dtype', 'platform', 'device_kind', 'dist_time',
                'dist_time_mean', 'dist_gflops_per_chip',
                'dist_peak_bytes_per_chip', 'dist_memory_analysis',
                'perf_model')
_DISPATCH_KEYS = ('dispatch_ticks', 'dispatch_overhead_s',
                  'dispatch_device_s', 'dispatch_overhead_pct',
                  'dispatch_overhead_ms_per_token',
                  'dispatch_overhead_p99_ms')
_DECODE_SERVE_KEYS = (
    'mode', 'slots', 't_max', 'heads', 'head_dim', 'requests',
    'prompt_len', 'max_new_tokens', 'decode_impl', 'cache_mode',
    'weight_quant', 'weight_bytes', 'kv_budget_bytes', 'max_concurrent',
    'platform', 'device_kind', 'bare_tokens_per_s', 'sched_tokens_per_s',
    'sched_overhead_pct', 'ttft_ms', 'completed', 'perf_model',
    'device_polls', 'devices_reporting') + _DISPATCH_KEYS
_TOPOLOGY_KEYS = (
    'mode', 'topology', 'seed', 'arrival', 'rate_requested',
    'rate_offered', 'requests', 'slots', 't_max', 'page_size', 'spec',
    'decode_impl', 'queue_limit', 'tick_seconds', 'prefill_threshold',
    'platform', 'device_kind', 'slo', 'goodput_pct', 'counts',
    'per_tenant', 'twin_goodput_pct', 'twin_counts', 'twin_ticks',
    'routed', 'prefix_hits', 'prefix_misses', 'handoffs',
    'handoff_pages', 'virtual_seconds', 'wall_seconds', 'ticks', 'trace',
    'event_logs', 'control', 'control_actions', 'replicas_final',
    'dispatch_ticks', 'dispatch_overhead_s',
    'dispatch_overhead_ms_per_token', 'dispatch_per_replica')
REFERENCE_ROW_KEYS = {
    'nt': _MATMUL_KEYS + _LOCAL_KEYS,
    'nt_skip_local': _MATMUL_KEYS,
    'attn': ('mode', 'attn_impl', 'scale', 'T', 'heads', 'kv_heads',
             'head_dim', 'qk_quant', 'world', 'dtype', 'platform',
             'device_kind', 'dist_time', 'dist_time_mean',
             'dist_gflops_per_chip', 'dist_peak_bytes_per_chip',
             'dist_memory_analysis', 'perf_model'),
    'train': ('mode', 'attn_impl', 'T', 'dim', 'heads', 'kv_heads',
              'use_rope', 'world', 'dtype', 'offset', 'impl', 'mask',
              'mask_kind', 'n_segments', 'causal', 'window', 'platform',
              'device_kind', 'step_time', 'step_time_mean',
              'step_gflops_per_chip', 'memory_analysis', 'perf_model'),
    'lm': ('mode', 'attn_impl', 'T', 'dim', 'heads', 'kv_heads',
           'n_layers', 'vocab', 'n_params', 'scan_layers', 'remat',
           'world', 'dtype', 'causal', 'window', 'platform',
           'device_kind', 'step_time', 'step_time_mean', 'tokens_per_s',
           'step_gflops_per_chip', 'memory_analysis', 'perf_model'),
    'decode': ('mode', 't_max', 'fill', 'heads', 'kv_heads', 'head_dim',
               'dtype', 'use_rope', 'world', 'batch', 'chain', 'qk_quant',
               'weight_quant', 'weight_bytes', 'kv_bytes', 'step_bytes',
               'paged_int8_kernel_eligible', 'decode_impl', 'platform',
               'device_kind', 'ms_per_step', 'ms_per_token',
               'ms_per_token_mean', 'tokens_per_s', 'cache_gb_per_s',
               'prefill_ms', 'ttft_ms', 'perf_model'),
    'decode_spec': ('mode', 'spec', 'spec_k', 'slots', 't_max', 'heads',
                    'head_dim', 'requests', 'prompt_len',
                    'max_new_tokens', 'decode_impl', 'platform',
                    'device_kind', 'tokens', 'tokens_per_s',
                    'baseline_tokens_per_s', 'spec_speedup',
                    'decode_steps', 'baseline_decode_steps',
                    'accepted_per_step', 'proposed_per_step',
                    'completed'),
    'decode_kv_shards': ('mode', 'kv_shards', 't_max', 'heads',
                         'head_dim', 'page_size', 'pages_per_shard',
                         'capacity_tokens', 'pool_tokens', 'fill',
                         'decode_impl', 'ms_per_token', 'tokens_per_s',
                         'platform', 'device_kind'),
    'decode_serve': _DECODE_SERVE_KEYS,
    'decode_serve_paged': _DECODE_SERVE_KEYS + (
        'page_size', 'pages', 'kv_shards', 'capacity_tokens',
        'pages_used_peak', 'page_utilization_peak'),
    'serve_load': (
        'mode', 'seed', 'arrival', 'rate_requested', 'rate_offered',
        'requests', 'slots', 't_max', 'cache_mode', 'spec',
        'decode_impl', 'queue_limit', 'control', 'tick_seconds',
        'platform', 'device_kind', 'slo', 'goodput_pct', 'counts',
        'per_tenant', 'ttft_ms', 'gap_ms', 'queue_wait_ms',
        'virtual_seconds', 'wall_seconds', 'ticks', 'event_log',
        'device_polls', 'devices_reporting') + _DISPATCH_KEYS,
    'serve_load_topology': _TOPOLOGY_KEYS,
    'serve_load_chaos': _TOPOLOGY_KEYS + (
        'chaos', 'replica_lost', 'recovered', 'recovered_compared',
        'recovered_bitident', 'replica_lost_rejects', 'probe_events',
        'flight_bundle', 'norec_goodput_pct', 'norec_counts',
        'norec_replica_lost_rejects'),
    'serve_load_corrupt': _TOPOLOGY_KEYS + (
        'chaos_corrupt', 'corruptions_injected', 'corruptions_detected',
        'corrupt_sites', 'corrupt_pages', 'corrupt_inject_events',
        'corrupt_healed', 'corrupt_rejects', 'corrupt_compared',
        'corrupt_bitident', 'verify_seconds', 'flight_bundle',
        'nointeg_goodput_pct', 'nointeg_counts', 'nointeg_wrong_streams'),
}


def parse_args(argv=None):
    # The reference's surface (benchmark.py), plus --device.
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--device', default='cuda',
                        help="'cuda' (default; raises without a card) or "
                             "'cpu' (the kernels' plain versions)")
    parser.add_argument('--mode', choices=['nt', 'all', 'tn', 'attn',
                                           'train', 'decode', 'lm',
                                           'decode-serve', 'serve-load'],
                        default='nt')
    parser.add_argument('--serve-requests', type=int, default=None,
                        help='decode-serve mode: burst size (default '
                             '4x slots)')
    parser.add_argument('--layers', type=int, default=8,
                        help='lm mode: transformer depth')
    parser.add_argument('--vocab', type=int, default=32768,
                        help='lm mode: vocabulary size')
    parser.add_argument('--remat', action='store_true',
                        help='lm mode: per-layer rematerialization '
                             '(scanned stack)')
    parser.add_argument('--no-scan', action='store_true',
                        help='lm mode: unrolled layers instead of the '
                             'scanned stack')
    parser.add_argument('--batch', type=int, default=1,
                        help='decode mode: sequences decoded per step')
    parser.add_argument('--decode-chain', type=int, default=1,
                        help='decode mode: decode steps per timed call')
    parser.add_argument('--seq-len', type=int, default=None,
                        help='global sequence length (train mode default '
                             '16384; attn mode default 75000//scale)')
    parser.add_argument('--no-mask', action='store_true',
                        help='train mode: attn_mask=None')
    parser.add_argument('--mask-kind', choices=['dense', 'none', 'segments'],
                        default=None,
                        help='train mode mask form (overrides --no-mask): '
                             "'segments' = packed-sequence ids")
    parser.add_argument('--segments', type=int, default=8,
                        help='number of packed spans for '
                             '--mask-kind segments')
    parser.add_argument('--causal', action='store_true',
                        help='train mode: autoregressive masking')
    parser.add_argument('--window', type=int, default=None,
                        help='train mode: sliding-window lookback cap '
                             '(requires --causal)')
    parser.add_argument('--attn-impl',
                        choices=['full', 'online', 'flash', 'flash_bounded',
                                 'ulysses'],
                        default='flash',
                        help='attention softmax/fusion path')
    parser.add_argument('--heads', type=int, default=8,
                        help='attention heads')
    parser.add_argument('--head-dim', type=int, default=64,
                        help='per-head feature dim')
    parser.add_argument('--qk-quant', choices=['int8'], default=None,
                        help='attn mode (flash impls): int8-quantized '
                             'QK^T; decode mode: an int8-trained model '
                             'decoding through its int8 K mirror')
    parser.add_argument('--weight-quant', choices=['off', 'int8'],
                        default='off',
                        help='decode/decode-serve modes: int8 weights '
                             'for the projection/head matmuls')
    parser.add_argument('--kv-heads', type=int, default=None,
                        help='attn/train modes: grouped-query K/V head '
                             'count; default = --heads')
    parser.add_argument('--decode-impl', choices=['auto', 'kernel', 'xla'],
                        default='auto',
                        help="decode/decode-serve modes: 'kernel' (K5 / "
                             "K5p), 'xla' (the plain path), 'auto' (the "
                             'kernel on the card, the plain path on the '
                             'CPU)')
    parser.add_argument('--cache-mode', choices=['slab', 'paged'],
                        default='slab',
                        help='decode-serve mode: KV-cache layout')
    parser.add_argument('--page-size', type=int, default=16,
                        help='paged cache page size in rows')
    parser.add_argument('--kv-shards', type=int, default=None,
                        help='decode / decode-serve: shard each paged '
                             'KV pool into N sequence shards')
    parser.add_argument('--spec', choices=['off', 'ngram', 'draft'],
                        default='off',
                        help='decode mode: speculative generation rows')
    parser.add_argument('--spec-k', type=int, default=4,
                        help='--spec: most proposals per slot per '
                             'verify step')
    # serve-load: the defaults are the reference's CI smoke config.
    parser.add_argument('--load-seed', type=int, default=7,
                        help='serve-load mode: trace seed')
    parser.add_argument('--load-rate', type=float, default=600.0,
                        help='serve-load mode: offered requests per '
                             'virtual second')
    parser.add_argument('--load-requests', type=int, default=48,
                        help='serve-load mode: trace length')
    parser.add_argument('--load-tenants', type=int, default=2,
                        help='serve-load mode: tenant count')
    parser.add_argument('--arrival',
                        choices=['poisson', 'bursty', 'ramp', 'step'],
                        default='poisson',
                        help='serve-load mode: arrival process')
    parser.add_argument('--ramp-factor', type=float, default=4.0,
                        help='serve-load mode, --arrival ramp/step: '
                             'peak rate multiple')
    parser.add_argument('--control', action='store_true',
                        help='serve-load mode: arm the closed-loop '
                             'controller')
    parser.add_argument('--control-max-replicas', type=int, default=3,
                        help='--control + --topology: autoscaling '
                             'ceiling for the decode pool')
    parser.add_argument('--load-tick', type=float, default=0.002,
                        help='serve-load mode: virtual seconds one '
                             'scheduler tick costs')
    parser.add_argument('--slo-ttft', type=float, default=0.25,
                        help='serve-load mode: TTFT deadline (s)')
    parser.add_argument('--slo-token', type=float, default=0.05,
                        help='serve-load mode: max inter-token gap (s)')
    parser.add_argument('--queue-limit', type=int, default=12,
                        help='serve-load mode: admission queue bound')
    parser.add_argument('--event-log', default=None,
                        help="serve-load mode: the run's JSONL event log "
                             '(default: a temp file); with --topology the '
                             'log DIRECTORY')
    parser.add_argument('--topology', default=None,
                        help="serve-load mode: a 'PxD' topology (P prefill "
                             'pools x D decode replicas, e.g. 1x2) behind '
                             'the router, beside its single-process twin')
    parser.add_argument('--prefill-threshold', type=int, default=8,
                        help='--topology: prefix rows at/above which a '
                             'fresh prompt offloads to the prefill pool')
    parser.add_argument('--chaos', action='store_true',
                        help='--topology: kill --chaos-victim at '
                             '--chaos-tick, beside a no-recovery twin')
    parser.add_argument('--chaos-victim', default='r1',
                        help='--chaos: decode replica to kill')
    parser.add_argument('--chaos-tick', type=int, default=40,
                        help='--chaos: loadgen tick at which the victim '
                             'dies')
    parser.add_argument('--chaos-corrupt', default=None,
                        metavar='PAGE:TICK',
                        help='--topology: flip one bit in tracked page '
                             'PAGE of --chaos-victim at tick TICK, beside '
                             'a checksums-off twin')
    parser.add_argument('--chaos-prefill-crash', type=int, default=None,
                        metavar='TICK',
                        help='--topology: kill the prefill pool at tick '
                             'TICK')
    parser.add_argument('--no-ttft', action='store_true',
                        help='decode mode: skip the time-to-first-token '
                             'prefill row')
    parser.add_argument('--use-rope', action='store_true',
                        help='train mode: rotary position embeddings')
    parser.add_argument(
        '--offset', default=32,
        type=lambda s: None if s.lower() in ('none', 'full') else int(s),
        help="gathered-chunk size; 'none' = single full gather")
    parser.add_argument('--scale', type=int, default=1,
                        help='T = 75000 // scale')
    parser.add_argument('--file', default='benchmark_results.json')
    parser.add_argument('--metrics-out', default=None,
                        help='write an observability snapshot JSON for '
                             'this run (enables span collection)')
    parser.add_argument('--dtype', choices=['f32', 'bf16'], default='f32')
    parser.add_argument('--impl', choices=['allgather', 'ring'],
                        default='allgather')
    parser.add_argument('--devices', type=int, default=None,
                        help='mesh width (default: every rank of the '
                             'process group; N > 1 starts N ranks)')
    parser.add_argument('--iters', type=int, default=5)
    parser.add_argument('--skip-local', action='store_true',
                        help='skip the single-card full-size baseline')
    parser.add_argument('--profile-dir', default=None,
                        help='write a torch.profiler trace of one timed '
                             'call here')
    parser.add_argument('--multihost', action='store_true',
                        help='join a multi-process run (one process per '
                             'host); process 0 writes the averaged record')
    parser.add_argument('--coordinator', default=None,
                        help='coordinator address host:port (multihost)')
    parser.add_argument('--num-processes', type=int, default=None)
    parser.add_argument('--process-id', type=int, default=None)
    return parser.parse_args(argv)


# -- devices, dtypes, counters --------------------------------------------

def _device(device):
    """The run's device (``--device``; raises without a card), a card
    with its index: the current card of this process (each rank's)."""
    dev = comm.resolve_device(device)
    if dev.type == 'cuda':
        dev = torch.device('cuda', torch.cuda.current_device())
    return dev


def _platform(dev):
    return 'gpu' if dev.type == 'cuda' else 'cpu'


def _device_kind(dev):
    return torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'


def _compute_dtype(dtype, dev):
    """``--dtype``: bf16 or float32, the same on the card (``dev``) as on
    the CPU — the flash kernels take both."""
    return torch.bfloat16 if dtype == 'bf16' else torch.float32


def _dtype_name(dtype):
    return 'bf16' if dtype == torch.bfloat16 else 'f32'


def _engine_dtype(dev):
    """The serving engines' dtype: float32, the reference
    ``KernelEngine``'s default, on the card (``dev``) as on the CPU."""
    return torch.float32


def _decode_impl(args, dev):
    """``--decode-impl`` as the port names it: ``'kernel'`` or
    ``'plain'``; ``auto`` is the kernel on the card, the plain path on the
    CPU."""
    if args.decode_impl == 'auto':
        return 'kernel' if dev.type == 'cuda' else 'plain'
    return 'plain' if args.decode_impl == 'xla' else 'kernel'


def _impl_label(impl):
    """The reference's name of a decode path: ``xla`` for the plain one."""
    return 'xla' if impl == 'plain' else impl


def _counters():
    import distributed_dot_product_tpu_torch as ddp
    return {name: getattr(ddp, name) for name in KERNELS}


def _zero_launches():
    for fn in _counters().values():
        fn.launches = fn.f32_launches = 0


def _launches(attr='launches'):
    return {name: getattr(fn, attr) for name, fn in _counters().items()}


def _generator(dev, seed):
    """A generator on ``dev`` (the card draws large inputs itself)."""
    return torch.Generator(device=dev).manual_seed(seed)


def make_inputs(mode, t, dtype, device, seed=111):
    """The nt operands ``(T, d) x (T, d)``, or for all / tn a score-shaped
    ``(T, T)`` left operand and a ``(T, d)`` right one, drawn on
    ``device`` from a generator seeded 111 (the reference's key)."""
    gen = _generator(device, seed)
    lshape = (t, DIM) if mode == 'nt' else (t, t)
    left = torch.randn(lshape, generator=gen, device=device, dtype=dtype)
    right = torch.randn((t, DIM), generator=gen, device=device, dtype=dtype)
    return left, right


LOCAL = {
    'nt': lambda l, r: torch.matmul(l, r.T),
    'all': lambda l, r: torch.matmul(l, r),
    'tn': lambda l, r: torch.matmul(l.T, r),
}


def _summed(fn):
    """Reduce the op's output to a float32 scalar inside the timed call:
    the reduction pass is charged to the local and the distributed
    measurements alike, and no full output outlives its call (the
    caching allocator hands the next call the same block)."""
    return lambda *a: fn(*a).sum(dtype=torch.float32)


def _device_bytes_limit(device):
    """The card's memory (``torch.cuda.mem_get_info``'s total); None on
    the CPU, which skips the pre-flight check."""
    if device.type != 'cuda':
        return None
    return torch.cuda.mem_get_info(device)[1]


def _tensor_bytes(obj, seen=None):
    """Bytes of every distinct tensor in ``obj`` (tensors, modules'
    parameters, and containers of them)."""
    seen = set() if seen is None else seen
    if isinstance(obj, torch.Tensor):
        key = (obj.data_ptr(), obj.numel(), obj.dtype)
        if key in seen:
            return 0
        seen.add(key)
        return obj.numel() * obj.element_size()
    if isinstance(obj, torch.nn.Module):
        return _tensor_bytes(list(obj.parameters()), seen)
    if isinstance(obj, dict):
        obj = list(obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_tensor_bytes(v, seen) for v in obj)
    return 0


def _program(dev, fn, *args):
    """One more call of the timed function, counted: its FLOPs and bytes
    (``obs/perf.py``'s ``CostCounter``, every kernel by its own formula)
    and, on the card, its memory — what the reference reads from its
    compiled executable."""
    from distributed_dot_product_tpu_torch.obs.perf import CostCounter
    on_card = dev.type == 'cuda'
    if on_card:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    with CostCounter() as counter:
        out = fn(*args)
    hard_sync()
    memory = None
    if on_card:
        arg = _tensor_bytes(args)
        res = _tensor_bytes(out)
        temp = max(0, torch.cuda.max_memory_allocated() - base - res)
        memory = {'argument_bytes': arg, 'output_bytes': res,
                  'temp_bytes': temp, 'total_bytes': arg + res + temp}
    return {'flops': counter.flops, 'bytes': counter.bytes,
            'memory': memory}


def _perf_model(program, measured_seconds=None):
    """Counted model-vs-measured columns of a timed call (``obs/perf.py``
    ``program_model``): its FLOPs and bytes, arithmetic intensity, the
    roofline class and, with a measured time, the achieved rates and the
    model's share of it (the H100's published peaks)."""
    from distributed_dot_product_tpu_torch.obs.perf import program_model
    return program_model(program['flops'], program['bytes'],
                         measured_seconds=measured_seconds)


def _memory_analysis(program):
    """The timed call's memory on the card: argument, output and
    temporary bytes (the peak above the arguments and output), None on
    the CPU."""
    return program['memory']


# -- attention, training ---------------------------------------------------

def run_attn(args):
    """Attention-op benchmark: the fused / online / full attention paths
    ``softmax(q·kᵀ/√d)·v`` at ``T = 75000 // scale`` over the seq ranks,
    reporting the 2·matmul FLOP rate. flash / flash_bounded gather k and v
    and run K1 / K2 on this rank's query rows; online is the ring (K1 a
    fold), ulysses the head↔time all-to-all around K1; full the
    distributed matmuls and a softmax."""
    import math

    from distributed_dot_product_tpu_torch.models.ring_attention import (
        ring_attention,
    )
    from distributed_dot_product_tpu_torch.ops.flash_attention import (
        flash_attention,
    )

    dev = _device(args.device)
    mesh = seq_mesh(args.devices)
    world = mesh.seq_size
    group = mesh.seq_group
    t = args.seq_len or FULL_T // args.scale
    t -= t % world
    h, d = args.heads, args.head_dim
    dtype = _compute_dtype(args.dtype, dev)
    flops = 4.0 * h * t * t * d

    if args.attn_impl == 'full':
        # Full softmax materializes the per-shard (H, T/N, T) scores:
        # refuse what cannot fit rather than dying in a device OOM (x2 for
        # scores and softmax output both live).
        limit = _device_bytes_limit(dev)
        need = 2 * h * (t // world) * t * torch.finfo(dtype).bits // 8
        if limit and need > 0.45 * limit:
            raise SystemExit(
                f'attn_impl=full needs ~{need / 2**30:.1f} GiB of score '
                f'buffers per device; raise --scale or use more devices')

    h_kv = args.kv_heads or h
    if args.kv_heads and args.attn_impl not in ('flash', 'flash_bounded',
                                                'online', 'ulysses'):
        raise SystemExit('--kv-heads (GQA) needs a fused attn impl '
                         '(flash/flash_bounded/online/ulysses)')
    if args.qk_quant and args.attn_impl not in ('flash', 'ulysses'):
        raise SystemExit('--qk-quant applies to --attn-impl flash or '
                         'ulysses (the record must name the path actually '
                         'measured)')
    gen = _generator(dev, 111)
    q = torch.randn((1, h, t, d), generator=gen, device=dev, dtype=dtype)
    k, v = (torch.randn((1, h_kv, t, d), generator=gen, device=dev,
                        dtype=dtype) for _ in range(2))
    q, k, v = (shard_seq(x, mesh) for x in (q, k, v))

    if args.attn_impl == 'online':
        def body(q, k, v):
            return ring_attention(q, k, v, group=group)
    elif args.attn_impl == 'ulysses':
        from distributed_dot_product_tpu_torch.models.ulysses_attention \
            import ulysses_attention

        def body(q, k, v):
            return ulysses_attention(q, k, v, group=group,
                                     qk_quant=args.qk_quant)
    elif args.attn_impl in ('flash', 'flash_bounded'):
        smode = 'bounded' if args.attn_impl == 'flash_bounded' else 'exact'

        def body(q, k, v):
            kf = comm.all_gather(k, group, dim=-2)
            vf = comm.all_gather(v, group, dim=-2)
            return flash_attention(q, kf, vf, softmax_mode=smode,
                                   qk_quant=args.qk_quant)
    else:
        def body(q, k, v):
            s = distributed_matmul_nt(q, k, args.offset, group) / math.sqrt(d)
            a = torch.softmax(s, dim=-1)
            return distributed_matmul_all(a, v, args.offset, group)

    def timed(q, k, v):
        return comm.all_reduce(body(q, k, v).sum(dtype=torch.float32),
                               group)

    with torch.no_grad():
        with span('benchmark.measure', mode='attn'):
            best, mean = time_fn(timed, q, k, v, iters=args.iters)
        peak = device_peak_bytes(dev) if dev.type == 'cuda' else None
        program = _program(dev, timed, q, k, v)
    record = {
        'mode': 'attn', 'attn_impl': args.attn_impl, 'scale': args.scale,
        'T': t, 'heads': h, 'kv_heads': h_kv, 'head_dim': d,
        'qk_quant': args.qk_quant, 'world': world,
        'dtype': args.dtype, 'compute_dtype': _dtype_name(dtype),
        'platform': _platform(dev), 'device_kind': _device_kind(dev),
        'dist_time': best, 'dist_time_mean': mean,
        'dist_gflops_per_chip': flops / world / best / 1e9,
        'dist_peak_bytes_per_chip': peak,
        'dist_memory_analysis': _memory_analysis(program),
        'perf_model': _perf_model(program, best),
    }
    gq = '' if h_kv == h else f'/kv{h_kv}'
    print(f"attn[{args.attn_impl}] T={t} H={h}{gq} d={d} {world}-device: "
          f"{best:.4f}s ({record['dist_gflops_per_chip']:.0f} GFLOP/s/chip"
          + (f", peak {peak / 2**30:.2f} GiB)" if peak else ")"))
    _append_record(args.file, record)
    return record


def _pairs(t, causal, window):
    """Attended (query, key) pairs: the full square, the causal lower
    triangle, or the sliding-window band (row i attends min(i+1, window)
    keys)."""
    if causal and window is not None:
        w = min(window, t)
        return w * (w + 1) / 2.0 + (t - w) * float(w)
    if causal:
        return t * t / 2.0
    return float(t) * t


def measure_train_step(*, seq_len, attn_impl='flash', dtype='bf16',
                       no_mask=False, causal=False, iters=3, devices=None,
                       impl='allgather', offset=32, heads=8,
                       mask_kind=None, n_segments=8, window=None,
                       kv_heads=None, use_rope=False, device='cuda'):
    """Measure one full training step of the paper's module — forward,
    MSE loss, backward, the gradient all-reduce over the seq ranks, the
    Adam update (``train.make_train_step``). Returns the result record;
    shared by ``--mode train`` and ``torch_bench.py``.

    ``mask_kind``: 'dense' (a boolean (B, T, T) zeros mask), 'none' or
    'segments' (``n_segments`` equal packed spans); default from
    ``no_mask``. FLOPs: 4 projections (2·T·768² each) and the scores /
    context matmuls (2·pairs·768 each) forward, backward 2x forward; the
    causal and window cases count only the attended pairs, the segments
    case does not discount cross-segment skipping (as the reference)."""
    from distributed_dot_product_tpu_torch import (
        DistributedDotProductAttn, make_train_step,
    )

    dev = _device(device)
    mesh = seq_mesh(devices)
    world = mesh.seq_size
    t = seq_len - seq_len % world
    cdt = _compute_dtype(dtype, dev)

    model = DistributedDotProductAttn(
        key_dim=DIM, num_heads=heads, num_kv_heads=kv_heads, offset=offset,
        softmax_impl=attn_impl.replace('_bounded', ''),
        flash_softmax_mode=('bounded' if attn_impl == 'flash_bounded'
                            else 'exact'),
        causal=causal, window=window, impl=impl, dtype=cdt,
        use_rope=use_rope, device=dev,
        generator=torch.Generator().manual_seed(0))

    if mask_kind is None:
        mask_kind = 'none' if no_mask else 'dense'
    if mask_kind not in ('dense', 'none', 'segments'):
        raise ValueError(f'unknown mask_kind {mask_kind!r}')

    gen = _generator(dev, 111)
    x = torch.randn((1, t, DIM), generator=gen, device=dev, dtype=cdt)
    target = torch.randn((1, t, DIM), generator=gen, device=dev, dtype=cdt)
    mask = (torch.zeros((1, t, t), dtype=torch.bool, device=dev)
            if mask_kind == 'dense' else None)
    seg = None
    if mask_kind == 'segments':
        seg = (torch.arange(t, dtype=torch.int32, device=dev)
               * n_segments // t)[None]
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = make_train_step(model, optimizer, mesh)

    batch = (x, x, x, mask, target, seg)
    with span('benchmark.measure', mode='train'):
        best, mean = time_fn(step, batch, iters=iters)
    program = _program(dev, step, batch)
    pairs = _pairs(t, causal, window)
    # GQA shrinks the queries / values projections to kv_heads/heads of
    # their features; the attention matmuls stay per query head.
    kvfrac = (kv_heads / heads) if kv_heads else 1.0
    flops = 3.0 * (4.0 * t * DIM * DIM * (1.0 + kvfrac)
                   + 4.0 * pairs * DIM)
    return {
        'mode': 'train', 'attn_impl': attn_impl, 'T': t, 'dim': DIM,
        'heads': heads, 'kv_heads': kv_heads or heads,
        'use_rope': use_rope, 'world': world, 'dtype': dtype,
        'compute_dtype': _dtype_name(cdt),
        # offset/impl shape only the 'full' softmax path's matmuls, but are
        # recorded always so any run is reproducible from its record.
        'offset': offset, 'impl': impl,
        'mask': mask_kind == 'dense', 'mask_kind': mask_kind,
        'n_segments': n_segments if mask_kind == 'segments' else None,
        'causal': causal, 'window': window,
        'platform': _platform(dev), 'device_kind': _device_kind(dev),
        'step_time': best, 'step_time_mean': mean,
        'step_gflops_per_chip': flops / world / best / 1e9,
        'memory_analysis': _memory_analysis(program),
        'perf_model': _perf_model(program, best),
    }


def measure_lm_step(*, seq_len, n_layers=8, vocab=32768, dtype='bf16',
                    heads=8, kv_heads=None, iters=3, devices=None,
                    causal=True, window=None, scan_layers=True,
                    remat=False, attn_impl='flash', device='cuda'):
    """One full LM training step — embed, the transformer stack, the tied
    head, the chunked cross-entropy, backward, the gradient all-reduce,
    Adam (``train.make_lm_train_step``).

    FLOPs (per forward, x3 for the step): per layer the 4 attention
    projections ``4·T·D²·(1+kv/H)``, the two attention matmuls
    ``4·pairs·D`` and the MLP ``16·T·D²``; plus the tied head
    ``2·T·D·V``."""
    from distributed_dot_product_tpu_torch import (
        TransformerLM, lm_targets, make_lm_train_step,
    )

    dev = _device(device)
    mesh = seq_mesh(devices)
    world = mesh.seq_size
    t = seq_len - seq_len % world
    cdt = _compute_dtype(dtype, dev)

    model = TransformerLM(
        vocab_size=vocab, dim=DIM, num_heads=heads, n_layers=n_layers,
        scan_layers=scan_layers, remat=remat, dtype=cdt,
        attn_kwargs=dict(softmax_impl=attn_impl, num_kv_heads=kv_heads,
                         causal=causal, window=window),
        device=dev, generator=torch.Generator().manual_seed(0))
    tokens = torch.randint(0, vocab, (1, t), generator=_generator(dev, 111),
                           device=dev, dtype=torch.int64)
    targets = lm_targets(tokens)
    n_params = sum(p.numel() for p in model.parameters())
    optimizer = torch.optim.Adam(model.parameters(), lr=1e-3)
    step = make_lm_train_step(model, optimizer, mesh)

    batch = (tokens, targets)
    with span('benchmark.measure', mode='lm'):
        best, mean = time_fn(step, batch, iters=iters)
    program = _program(dev, step, batch)
    pairs = _pairs(t, causal, window)
    kvfrac = (kv_heads / heads) if kv_heads else 1.0
    fwd = (n_layers * (4.0 * t * DIM * DIM * (1.0 + kvfrac)
                       + 16.0 * t * DIM * DIM + 4.0 * pairs * DIM)
           + 2.0 * t * DIM * vocab)
    return {
        'mode': 'lm', 'attn_impl': attn_impl, 'T': t, 'dim': DIM,
        'heads': heads, 'kv_heads': kv_heads or heads,
        'n_layers': n_layers, 'vocab': vocab, 'n_params': n_params,
        'scan_layers': scan_layers, 'remat': remat, 'world': world,
        'dtype': dtype, 'compute_dtype': _dtype_name(cdt),
        'causal': causal, 'window': window,
        'platform': _platform(dev), 'device_kind': _device_kind(dev),
        'step_time': best, 'step_time_mean': mean,
        'tokens_per_s': t / best,
        'step_gflops_per_chip': 3.0 * fwd / world / best / 1e9,
        'memory_analysis': _memory_analysis(program),
        'perf_model': _perf_model(program, best),
    }


def run_lm(args):
    """``--mode lm``: the LM's training step."""
    record = measure_lm_step(
        seq_len=args.seq_len or 16384, n_layers=args.layers,
        vocab=args.vocab, dtype=args.dtype, heads=args.heads,
        kv_heads=args.kv_heads, iters=args.iters, devices=args.devices,
        causal=True, window=args.window,
        scan_layers=not args.no_scan, remat=args.remat,
        attn_impl=args.attn_impl, device=args.device)
    ma = record['memory_analysis'] or {}
    print(f"lm[{record['attn_impl']}] T={record['T']} "
          f"{record['n_layers']}L dim={DIM} vocab={record['vocab']} "
          f"({record['n_params'] / 1e6:.1f}M params"
          f"{', remat' if record['remat'] else ''}): "
          f"{record['step_time']:.4f}s/step "
          f"{record['tokens_per_s']:,.0f} tok/s "
          f"({record['step_gflops_per_chip']:.0f} GFLOP/s/chip, "
          f"temp {ma.get('temp_bytes', 0) / 2**30:.2f} GiB)")
    _append_record(args.file, record)
    return record


def run_train(args):
    """``--mode train``: the paper's module, one Adam step (T 16384 by
    default)."""
    record = measure_train_step(
        seq_len=args.seq_len or 16384, attn_impl=args.attn_impl,
        dtype=args.dtype,
        no_mask=args.no_mask, causal=args.causal, iters=args.iters,
        devices=args.devices, impl=args.impl, offset=args.offset,
        heads=args.heads, mask_kind=args.mask_kind, window=args.window,
        n_segments=args.segments, kv_heads=args.kv_heads,
        use_rope=args.use_rope, device=args.device)
    ma = record['memory_analysis'] or {}
    gq = ('' if record['kv_heads'] == record['heads']
          else f"/kv{record['kv_heads']}")
    print(f"train[{args.attn_impl}] T={record['T']} dim={DIM} "
          f"H={record['heads']}{gq} {record['world']}-device: "
          f"{record['step_time']:.4f}s/step "
          f"({record['step_gflops_per_chip']:.0f} GFLOP/s/chip, "
          f"temp {ma.get('temp_bytes', 0) / 2**30:.2f} GiB)")
    _append_record(args.file, record)
    return record


# Per-rank measurements averaged across the ranks (the reference's
# per-process average); the throughput fields derived from them are
# rescaled to match.
_MH_TIME_KEYS = ('local_time', 'local_time_mean', 'dist_time',
                 'dist_time_mean', 'step_time', 'step_time_mean')
_MH_RATE_KEYS = {'dist_gflops_per_chip': 'dist_time',
                 'step_gflops_per_chip': 'step_time',
                 'local_gflops': 'local_time'}


def _multihost_aggregate(record):
    """Average the timing fields over every rank; every rank returns the
    same aggregated record (rank 0 is the only writer). A collective:
    every rank calls it."""
    world = comm.get_world_size()
    if world == 1:
        return record
    import torch.distributed as dist
    dev = (torch.device('cuda', torch.cuda.current_device())
           if dist.get_backend() == 'nccl' else torch.device('cpu'))
    local = torch.tensor([float(record[k]) if record.get(k) is not None
                          else float('nan') for k in _MH_TIME_KEYS],
                         dtype=torch.float64, device=dev)
    gathered = comm.all_gather_stacked(local).cpu()
    rec = dict(record)
    for i, k in enumerate(_MH_TIME_KEYS):
        if record.get(k) is not None:
            rec[k] = float(gathered[:, i].mean())
    for rate, timek in _MH_RATE_KEYS.items():
        if record.get(rate) is not None and record.get(timek):
            rec[rate] = record[rate] * record[timek] / rec[timek]
    rec['n_processes'] = world
    return rec


def _append_record(path, record):
    """Append-to-JSON-file convention: the file holds a list of rows.
    With several ranks every rank aggregates (a collective) and rank 0
    alone writes. Each row also carries the run's kernel launches."""
    record['kernel_launches'] = _launches()
    record['kernel_launches_f32'] = _launches('f32_launches')
    record = _multihost_aggregate(record)
    if comm.get_rank() != 0:
        return record
    results = []
    if os.path.exists(path):
        with open(path) as f:
            results = json.load(f)
    results.append(record)
    with open(path, 'w') as f:
        json.dump(results, f, indent=2)
    return record


# -- decoding ----------------------------------------------------------------

def _probe_paged_int8(h_kv, d, dev, dtype):
    """A fixed-shape mirror-carrying paged cache for the eligibility flag
    recorded on decode rows: the categorical capability (the int8 mirror
    pools ride the fused K5p), not this row's geometry."""
    from distributed_dot_product_tpu_torch.models.decode import (
        init_paged_cache,
    )
    return init_paged_cache(1, h_kv, 64, d, pages=2, page_size=16,
                            qk_quant='int8', dtype=dtype, device=dev)


def run_decode(args):
    """``--mode decode``: steady-state KV-cache decode latency through
    the module surface (one token per step against a part-filled
    cache); decode streams the K/V cache once a step, so the row also
    derives the achieved GB/s over the cache bytes."""
    from distributed_dot_product_tpu_torch import DistributedDotProductAttn
    from distributed_dot_product_tpu_torch.models.decode import (
        append_kv, decode_kernel_eligible,
    )
    from distributed_dot_product_tpu_torch.models.dense import (
        dense_param_bytes, quantize_dense_params,
    )

    dev = _device(args.device)
    t_max = args.seq_len or 16384
    h, d = args.heads, args.head_dim
    h_kv = args.kv_heads or h
    # The TTFT prefill runs K1 whatever the decode path.
    dtype = _compute_dtype(args.dtype, dev)
    impl = _decode_impl(args, dev)
    # qk_quant='int8': the cache carries an append-time int8 K mirror that
    # the decode step streams instead of the K cache.
    weight_quant = (None if args.weight_quant == 'off'
                    else args.weight_quant)

    def module(wq):
        return DistributedDotProductAttn(
            key_dim=h * d, num_heads=h, num_kv_heads=args.kv_heads,
            causal=True, use_rope=args.use_rope, softmax_impl='flash',
            qk_quant=args.qk_quant, weight_quant=wq, dtype=dtype,
            decode_impl=impl, device=dev,
            generator=torch.Generator().manual_seed(0))

    model = module(weight_quant)
    if weight_quant == 'int8':
        # Load-time quantization of the float twin's weights: the
        # deployment flow (a float checkpoint quantized once at load).
        model.load_state_dict(quantize_dense_params(module(None)))
    b = args.batch
    fill = t_max - 64  # headroom for the timed decode steps
    cache = model.make_decode_cache(b, t_max, dtype=dtype)
    # The cache is filled with random projected rows directly: a step's
    # cost does not depend on the cached values.
    gen = _generator(dev, 1)
    kf = torch.randn((b, h_kv, fill, d), generator=gen, device=dev,
                     dtype=dtype)
    vf = torch.randn((b, h_kv, fill, d), generator=gen, device=dev,
                     dtype=dtype)
    cache = append_kv(cache, kf, vf)
    del kf, vf
    tok = torch.randn((b, 1, h * d), generator=_generator(dev, 2),
                      device=dev, dtype=dtype)
    chain = max(1, args.decode_chain)
    cache_box = [cache]

    def timed(xt):
        # The timed unit: `chain` decode steps (in-place cache append +
        # attention over the cache + 4 projections). Once the timing
        # loop has used the 64-row headroom the length is rolled back to
        # the fill: the rows are overwritten, the step's cost unchanged.
        c = cache_box[0]
        if c.length + chain > t_max:
            c = c._replace(length=fill)
        for _ in range(chain):
            c, out = model.decode(xt, xt, xt, c)
        cache_box[0] = c
        return out

    with torch.no_grad():
        # One throwaway measurement first: the recorded number is the
        # warm steady state.
        with span('benchmark.warmup', mode='decode'):
            time_fn(timed, tok, iters=2, max_inner=16384)
        with span('benchmark.measure', mode='decode'):
            best, mean = time_fn(timed, tok, iters=args.iters,
                                 max_inner=16384)
        if best * 1e3 < 1e-3:
            # A sample window under the measured sync overhead clamps to
            # ~0; fall back to the mean, which averages real windows.
            best = mean
        # One timed call decodes `chain` steps of `b` sequences.
        step_time = best / chain
        program = _program(dev, timed, tok)

        # Time to first token: a fresh cache, the whole prompt through
        # the prefill (K1), plus one decode step.
        prefill_time = None
        if not args.no_ttft:
            prompt = torch.randn((b, fill, h * d),
                                 generator=_generator(dev, 3), device=dev,
                                 dtype=dtype)

            def prefill_fn(toks):
                c = model.make_decode_cache(b, t_max, dtype=dtype)
                c, out = model.prefill(toks, toks, toks, c)
                return out[:, -1:]

            with span('benchmark.ttft', mode='decode'):
                prefill_time, _ = time_fn(prefill_fn, prompt,
                                          iters=max(2, args.iters // 2))
    # Bytes the attention streams a step: V and K at the cache dtype, or
    # the 1-byte int8 mirror and its per-row scales for K.
    elem = torch.finfo(dtype).bits // 8
    k_bytes = (t_max * d * 1 + t_max * 4 if args.qk_quant == 'int8'
               else t_max * d * elem)
    cache_bytes = b * h_kv * (t_max * d * elem + k_bytes)
    weight_bytes = dense_param_bytes(model)
    record = {
        'mode': 'decode', 't_max': t_max, 'fill': fill, 'heads': h,
        'kv_heads': h_kv, 'head_dim': d, 'dtype': args.dtype,
        'compute_dtype': _dtype_name(dtype),
        'use_rope': args.use_rope, 'world': 1,
        'batch': b, 'chain': chain, 'qk_quant': args.qk_quant,
        'weight_quant': weight_quant,
        'weight_bytes': weight_bytes,
        'kv_bytes': cache_bytes,
        'step_bytes': cache_bytes + weight_bytes,
        'paged_int8_kernel_eligible': bool(decode_kernel_eligible(
            _probe_paged_int8(h_kv, d, dev, dtype), qk_quant='int8')),
        'decode_impl': _impl_label(impl),
        'platform': _platform(dev), 'device_kind': _device_kind(dev),
        'ms_per_step': step_time * 1e3,
        'ms_per_token': step_time / b * 1e3,
        'ms_per_token_mean': mean / chain / b * 1e3,
        'tokens_per_s': b * chain / best,
        'cache_gb_per_s': cache_bytes / step_time / 1e9,
        'prefill_ms': (None if prefill_time is None
                       else prefill_time * 1e3),
        'ttft_ms': (None if prefill_time is None
                    else (prefill_time + step_time) * 1e3),
        # Model-vs-measured over one timed call (`chain` decode steps).
        'perf_model': _perf_model(program, best),
    }
    gq = '' if h_kv == h else f'/kv{h_kv}'
    bc = '' if (b == 1 and chain == 1) else f' B={b} chain={chain}'
    wq = '' if weight_quant is None else f'/w{weight_quant}'
    ttft = ('' if prefill_time is None
            else f" TTFT {record['ttft_ms']:.1f} ms")
    print(f"decode[{record['decode_impl']}{wq}] t_max={t_max} fill={fill} "
          f"H={h}{gq} d={d}{bc}: "
          f"{record['ms_per_step']:.3f} ms/step "
          f"{record['tokens_per_s']:,.0f} tok/s "
          f"({record['cache_gb_per_s']:.0f} GB/s over the cache, "
          f"{record['step_bytes'] / 2**20:.2f} MiB kv+weights/step)"
          + ttft)
    _append_record(args.file, record)
    return record


def _dispatch_split(registry, n_tokens):
    """Dispatch-floor columns from a scheduler run's registry: the
    host-dispatch vs device-compute split of its decode ticks
    (``serve.dispatch_overhead_seconds`` / ``serve.device_seconds``,
    ``serve/scheduler.py``). Empty when no decode tick was recorded."""
    h_over = registry.peek('histogram',
                           'serve.dispatch_overhead_seconds')
    h_dev = registry.peek('histogram', 'serve.device_seconds')
    if h_over is None or not h_over.total_count:
        return {}
    over_s = h_over.total_sum
    dev_s = h_dev.total_sum if h_dev is not None else 0.0
    tick_s = over_s + dev_s
    return {
        'dispatch_ticks': h_over.total_count,
        'dispatch_overhead_s': over_s,
        'dispatch_device_s': dev_s,
        'dispatch_overhead_pct': (100.0 * over_s / tick_s
                                  if tick_s > 0 else None),
        'dispatch_overhead_ms_per_token': (over_s / n_tokens * 1e3
                                           if n_tokens else None),
        'dispatch_overhead_p99_ms': h_over.percentile(99) * 1e3,
    }


def run_decode_serve(args):
    """``--mode decode-serve``: what the continuous-batching scheduler
    costs over the bare decode step, on one ``KernelEngine`` shape: (a) a
    bare lockstep decode loop (every slot active, nothing but the
    per-round slot resets) and (b) the scheduler draining a request burst
    of the same token volume (admission, chunked prefill, retirement,
    metrics). ``--cache-mode paged`` is the fixed-memory twin: the slab
    row's KV bytes as a page pool, up to 4x the slots."""
    import numpy as np

    from distributed_dot_product_tpu_torch.obs import DeviceMonitor
    from distributed_dot_product_tpu_torch.serve import (
        KernelEngine, Scheduler, ServeConfig,
    )
    from distributed_dot_product_tpu_torch.utils.tracing import (
        MetricsRegistry,
    )

    dev = _device(args.device)
    edt = _engine_dtype(dev)
    impl = _decode_impl(args, dev)
    slots_slab = args.batch if args.batch > 1 else 4
    t_max = args.seq_len or 256
    h, d = args.heads, args.head_dim
    max_new = 16
    prompt_len = min(8, t_max - max_new - 1)
    steps_per_seq = prompt_len + max_new
    paged = args.cache_mode == 'paged'
    # Fixed-memory framing: the slab row's KV budget is slots x t_max
    # rows; the paged twin holds the same bytes as a page pool and raises
    # the slot count toward 4x, capped by what the pool holds at this
    # run's per-sequence fill.
    budget_rows = slots_slab * t_max
    kv_shards = args.kv_shards or 1
    if kv_shards > 1 and not paged:
        raise SystemExit('--kv-shards needs --cache-mode paged (the '
                         'sharded unit is the page pool)')
    if paged:
        page_size = args.page_size
        if t_max % page_size:
            raise SystemExit(f'--page-size {page_size} must divide '
                             f'the cache length {t_max}')
        # Under --kv-shards the slab-budget pool is per shard.
        pages = budget_rows // page_size
        pages_per_seq = -(-steps_per_seq // page_size)
        if kv_shards > 1:
            # Contiguous ordinal ownership puts every stream's early
            # pages on the low shards: size slots by the tightest shard.
            pps_total = t_max // page_size
            ops = -(-pps_total // kv_shards)
            by_shard = [0] * kv_shards
            for o in range(pages_per_seq):
                by_shard[min(o // ops, kv_shards - 1)] += 1
            per_shard_cap = min(pages // c for c in by_shard if c)
            slots = max(1, min(4 * slots_slab, per_shard_cap))
        else:
            slots = max(1, min(4 * slots_slab, pages // pages_per_seq))
    else:
        page_size = pages = None
        slots = slots_slab
    # Whole rounds of `slots` concurrent sequences: both measurements
    # serve the same token volume and every sequence stays inside t_max.
    n_rounds = -(-(args.serve_requests or 4 * slots) // slots)
    n_requests = n_rounds * slots
    # K + V buffers at the engine dtype.
    kv_budget_bytes = budget_rows * h * d * (torch.finfo(edt).bits // 8) * 2

    def make_engine():
        extra = (dict(cache_mode='paged', pages=pages,
                      page_size=page_size, kv_shards=kv_shards)
                 if paged else dict(cache_mode='slab'))
        return KernelEngine(slots=slots, t_max=t_max, vocab=256, heads=h,
                            head_dim=d, prefill_chunk=8, seed=0,
                            decode_impl=impl, dtype=edt, device=dev,
                            weight_quant=args.weight_quant, **extra)

    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=prompt_len).astype(np.int32)
               for _ in range(n_requests)]

    # (a) bare loop: every slot decodes every step; step() prepares pages
    # itself, the same per-token cost the scheduler path pays.
    eng = make_engine()
    tokens = np.zeros(slots, np.int32)
    active = np.ones(slots, bool)
    eng.step(tokens, active)                      # load + warm
    for i in range(slots):
        eng.reset(i)                              # warm append undone
    hard_sync()
    t0 = time.perf_counter()
    for _ in range(n_rounds):
        for _ in range(steps_per_seq):
            tokens, _ = eng.step(tokens, active)
        for i in range(slots):
            eng.reset(i)
    hard_sync()
    bare_s = time.perf_counter() - t0
    n_steps = n_rounds * steps_per_seq
    bare_tps = slots * n_steps / bare_s

    # The cost model of the decode step both measurements drive, the
    # measured time the bare loop's per-step wall time.
    step_model = _perf_model(_program(dev, eng.step, tokens, active),
                             bare_s / n_steps)
    for i in range(slots):
        eng.reset(i)

    # Time to first token through the engine surface: chunked prefill of
    # one prompt and the first decode step, on warm paths.
    chunks = [prompts[0][i:i + eng.prefill_chunk]
              for i in range(0, prompt_len, eng.prefill_chunk)]

    def _reserve_ttft_pages():
        # Page allocation happens here, outside the timed window.
        if paged and not eng.reserve_rows(0, prompt_len + 1):
            raise RuntimeError(
                'page pool too small for the TTFT probe prompt — the '
                'pool is sized from the slab twin (--batch x --seq-len '
                'rows): raise --batch/--seq-len or lower --page-size')
    _reserve_ttft_pages()
    for c in chunks:                              # warm the prefill
        eng.prefill(0, c)
    eng.step(tokens, active)
    eng.reset(0)
    _reserve_ttft_pages()
    hard_sync()
    t0 = time.perf_counter()
    for c in chunks:
        eng.prefill(0, c)
    eng.step(tokens, active)
    hard_sync()
    ttft_s = time.perf_counter() - t0

    # (b) the scheduler serving the same token volume as a burst.
    eng = make_engine()
    eng.step(tokens, active)                      # same warm start
    for i in range(slots):
        eng.reset(i)                              # slots handed over clean
    cfg = ServeConfig(queue_limit=max(8, n_requests),
                      max_new_tokens=max_new, watchdog=False,
                      degrade_watermark=1.1)      # measure undegraded
    # Peak concurrency and pool fill, observed per tick.
    peak = {'busy': 0, 'pages_used': 0}

    def _on_tick(s):
        peak['busy'] = max(peak['busy'],
                           sum(sl.request is not None for sl in s._slots))
        if paged:
            peak['pages_used'] = max(peak['pages_used'],
                                     eng.pool.used_pages)

    # --metrics-out: the serve metrics go to the process registry the
    # snapshot serializes; otherwise to a registry of this run alone.
    registry = (tracing.get_registry()
                if getattr(args, 'metrics_out', None)
                else MetricsRegistry())
    sched = Scheduler(eng, cfg, on_tick=_on_tick, registry=registry)
    # Live device telemetry across the burst.
    devmon = DeviceMonitor(registry=registry, interval=0.2).start()
    t0 = time.perf_counter()
    try:
        with span('benchmark.scheduler_burst', mode='decode-serve'):
            for i, p in enumerate(prompts):
                sched.submit(p, request_id=f'b{i}')
            results = sched.run_until_idle()
        hard_sync()
        sched_s = time.perf_counter() - t0
    finally:
        devmon.stop()
    sched.close()
    devmon.poll_once()      # end-of-burst device state
    device_polls = registry.counter('device.memory.polls').value
    n_tok = sum(len(r.tokens) for r in results.values())
    sched_tps = n_tok / sched_s

    record = {
        'mode': 'decode-serve', 'slots': slots, 't_max': t_max,
        'heads': h, 'head_dim': d, 'requests': n_requests,
        'prompt_len': prompt_len, 'max_new_tokens': max_new,
        'decode_impl': _impl_label(eng.decode_impl),
        'cache_mode': args.cache_mode,
        'engine_dtype': _dtype_name(edt),
        'weight_quant': eng.weight_quant,
        'weight_bytes': eng.weight_bytes,
        'kv_budget_bytes': kv_budget_bytes,
        'max_concurrent': peak['busy'],
        'platform': _platform(dev), 'device_kind': _device_kind(dev),
        'bare_tokens_per_s': bare_tps,
        'sched_tokens_per_s': sched_tps,
        'sched_overhead_pct': 100.0 * (bare_tps - sched_tps) / bare_tps,
        'ttft_ms': ttft_s * 1e3,
        'completed': sum(r.status == 'completed'
                         for r in results.values()),
        'perf_model': step_model,
        'device_polls': device_polls,
        'devices_reporting': registry.gauge(
            'device.memory.devices_reporting').value,
    }
    record.update(_dispatch_split(registry, n_tok))
    if paged:
        record.update({
            'page_size': page_size, 'pages': pages,
            'kv_shards': kv_shards,
            'capacity_tokens': eng.capacity_tokens,
            'pages_used_peak': peak['pages_used'],
            'page_utilization_peak': peak['pages_used']
                                     / (kv_shards * pages),
        })
    paged_note = ('' if not paged else
                  f" pages={peak['pages_used']}/{kv_shards * pages} "
                  f"({100.0 * record['page_utilization_peak']:.0f}% "
                  f"peak"
                  + (f', kv_shards={kv_shards}' if kv_shards > 1
                     else '') + ')')
    disp_note = ''
    if record.get('dispatch_overhead_ms_per_token') is not None:
        disp_note = (f", dispatch overhead "
                     f"{record['dispatch_overhead_ms_per_token']:.3f} "
                     f"ms/tok "
                     f"({record['dispatch_overhead_pct']:.0f}% of tick)")
    print(f"decode-serve[{record['decode_impl']}/{args.cache_mode}] "
          f"slots={slots} t_max={t_max} "
          f"req={n_requests}: scheduler {sched_tps:,.0f} tok/s vs bare "
          f"{bare_tps:,.0f} tok/s "
          f"({record['sched_overhead_pct']:.1f}% overhead, "
          f"TTFT {record['ttft_ms']:.1f} ms, "
          f"peak {peak['busy']} concurrent at "
          f"{kv_budget_bytes / 2**20:.1f} MiB KV{paged_note}"
          f"{disp_note})")
    _append_record(args.file, record)
    return record


def run_decode_kv_sharded(args):
    """``--mode decode --kv-shards N``: one stream decoding against a paged
    pool sharded N ways with a fixed per-shard pool (a quarter of
    ``t_max``'s pages), so ``capacity_tokens`` — the longest stream the
    engine holds — is the linear-scaling column: ~N/4 x ``t_max``,
    clamped at ``t_max``. The timed unit is the steady-state sharded step
    (K5p partials on every shard, merged) at a near-capacity fill."""
    import numpy as np

    from distributed_dot_product_tpu_torch.serve import KernelEngine

    dev = _device(args.device)
    t_max = args.seq_len or 4096
    page_size = args.page_size
    if t_max % page_size:
        raise SystemExit(f'--page-size {page_size} must divide the '
                         f'cache length {t_max}')
    n = args.kv_shards
    pages_per_shard = max(1, t_max // page_size // 4)
    eng = KernelEngine(
        slots=1, t_max=t_max, vocab=256, heads=args.heads,
        head_dim=args.head_dim, prefill_chunk=8, seed=0,
        decode_impl=_decode_impl(args, dev), dtype=_engine_dtype(dev),
        device=dev, cache_mode='paged', page_size=page_size,
        pages=pages_per_shard, kv_shards=n)
    capacity = eng.capacity_tokens
    pool_tokens = eng.pool.pages * page_size
    # Fill to near capacity, leaving headroom for the timed steps.
    timed_steps = 48
    fill = max(8, capacity - timed_steps - 8)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 256, size=fill).astype(np.int32)
    with span('benchmark.prefill', mode='decode-kv-sharded'):
        for i in range(0, fill, eng.prefill_chunk):
            eng.prefill(0, prompt[i:i + eng.prefill_chunk])
    tokens = np.asarray([int(prompt[-1])], np.int32)
    active = np.ones(1, bool)
    with span('benchmark.compile', mode='decode-kv-sharded'):
        tokens, _ = eng.step(tokens, active)      # load + warm
    with span('benchmark.measure', mode='decode-kv-sharded'):
        hard_sync()
        t0 = time.perf_counter()
        for _ in range(timed_steps):
            tokens, _ = eng.step(tokens, active)
        hard_sync()
        elapsed = time.perf_counter() - t0
    ms_per_token = elapsed / timed_steps * 1e3
    record = {
        'mode': 'decode', 'kv_shards': n, 't_max': t_max,
        'heads': args.heads, 'head_dim': args.head_dim,
        'page_size': page_size, 'pages_per_shard': pages_per_shard,
        'capacity_tokens': capacity, 'pool_tokens': pool_tokens,
        'fill': fill, 'decode_impl': _impl_label(eng.decode_impl),
        'engine_dtype': _dtype_name(eng.dtype),
        # Every step of the run, the warm one included (the kernel
        # launches a shard per step).
        'decode_steps': timed_steps + 1,
        'ms_per_token': ms_per_token,
        'tokens_per_s': 1e3 / ms_per_token,
        'platform': _platform(dev), 'device_kind': _device_kind(dev),
    }
    print(f'decode[kv_shards={n}] t_max={t_max} '
          f'capacity={capacity} tokens '
          f'({pages_per_shard} pages/shard x {page_size} rows x {n}): '
          f'{ms_per_token:.3f} ms/token at fill={fill}')
    _append_record(args.file, record)
    return record


# -- serving under load ------------------------------------------------------

def _fresh_logs(log_dir, names):
    """Remove a previous run's member logs (an EventLog appends, and a
    stale log would double every merged timeline); decode-member logs by
    glob, since autoscaling names replicas with a never-reused
    sequence."""
    import glob

    from distributed_dot_product_tpu_torch import obs
    for name in names:
        obs.remove_log(os.path.join(log_dir, f'{name}.jsonl'))
    for stale in glob.glob(os.path.join(log_dir, 'r[0-9]*.jsonl')):
        obs.remove_log(stale)


def run_serve_load_topology(args):
    """``--mode serve-load --topology 1x2``: the disaggregated-serving
    row. The same seeded trace (written to ``trace.json`` and read back:
    both runs consume the same file) drives (a) the router over a
    P-prefill-pool / D-decode-replica topology (each replica its own
    paged engine, scheduler and event log; long prompts prefilled by the
    pool and handed off as pool pages) and (b) the single-process twin
    (one replica's engine behind one scheduler). Goodput of the topology
    is computed over the merged member logs (every submitted request must
    reconstruct exactly once across them), the twin's over its own log;
    the row records both and the routing telemetry. ``--chaos``,
    ``--chaos-corrupt`` and ``--chaos-prefill-crash`` add their faults
    and twins; ``--control`` arms the controller."""
    import tempfile

    from distributed_dot_product_tpu_torch import obs
    from distributed_dot_product_tpu_torch.obs import slo as obs_slo
    from distributed_dot_product_tpu_torch.serve import (
        KernelEngine, LoadGenConfig, RouterConfig, Scheduler,
        ServeConfig, TopologyConfig, VirtualClock, build_serving,
        default_tenants, generate_trace, load_trace, parse_topology,
        run_trace, save_trace,
    )
    from distributed_dot_product_tpu_torch.utils.tracing import (
        MetricsRegistry,
    )

    dev = _device(args.device)
    edt = _engine_dtype(dev)
    prefill_pools, decode_replicas = parse_topology(args.topology)
    slots = args.batch if args.batch > 1 else 4
    t_max = args.seq_len or 96
    if t_max % args.page_size:
        raise SystemExit(f'--page-size {args.page_size} must divide '
                         f'the cache length {t_max}')
    decode_impl = _decode_impl(args, dev)
    log_dir = args.event_log or tempfile.mkdtemp(prefix='ddp_serve_topo_')
    os.makedirs(log_dir, exist_ok=True)
    _fresh_logs(log_dir, ['router'] + (['prefill'] if prefill_pools else [])
                + ['twin'])
    cfg = LoadGenConfig(
        seed=args.load_seed, rate=args.load_rate,
        requests=args.load_requests, arrival=args.arrival,
        ramp_factor=args.ramp_factor,
        tenants=default_tenants(args.load_tenants), vocab=64,
        tick_seconds=args.load_tick)
    trace_path = os.path.join(log_dir, 'trace.json')
    save_trace(trace_path, generate_trace(cfg))
    serve_cfg = ServeConfig(
        queue_limit=args.queue_limit,
        max_new_tokens=max(t.new_hi for t in cfg.tenants),
        watchdog=False, spec=args.spec, spec_k=args.spec_k)
    # The twin runs the STATIC config: the controller actuates knobs by
    # mutating the schedulers' shared ServeConfig.
    twin_cfg = dataclasses.replace(serve_cfg)
    topo = TopologyConfig(
        prefill_pools=prefill_pools, decode_replicas=decode_replicas,
        slots=slots, t_max=t_max, page_size=args.page_size, vocab=64,
        heads=args.heads, head_dim=args.head_dim, seed=0,
        decode_impl=decode_impl, dtype=edt, device=dev.type)
    router_cfg = RouterConfig(prefill_threshold=args.prefill_threshold)
    chaos_any = (args.chaos or args.chaos_corrupt
                 or args.chaos_prefill_crash is not None)
    chaos = chaos_plan = flight_rec = flight_prev = None
    corrupt_page = corrupt_tick = None
    if chaos_any:
        from distributed_dot_product_tpu_torch.obs import flight as obs_flight
        from distributed_dot_product_tpu_torch.serve import ChaosSchedule
        from distributed_dot_product_tpu_torch.utils.faults import (
            ChaosInjector, ChaosPlan,
        )
        # Fast probes on the virtual clock: the loss must be declared, and
        # recovery land, inside the trace's own virtual window.
        router_cfg = dataclasses.replace(
            router_cfg, probe_interval=0.01, probe_backoff_max=0.02)
        plan_kw = {}
        if args.chaos:
            if decode_replicas < 2:
                raise SystemExit(f'--chaos kills one decode replica '
                                 f'mid-trace: the topology needs >= 2 '
                                 f'for a survivor, got {args.topology}')
            plan_kw['replica_crash'] = (args.chaos_victim,
                                        args.chaos_tick)
        if args.chaos_corrupt:
            try:
                page_s, tick_s = args.chaos_corrupt.split(':')
                corrupt_page, corrupt_tick = int(page_s), int(tick_s)
            except ValueError:
                raise SystemExit(f'--chaos-corrupt wants PAGE:TICK, '
                                 f'got {args.chaos_corrupt!r}')
            if decode_replicas < 2:
                raise SystemExit(f'--chaos-corrupt heals the victim '
                                 f'streams on a CLEAN replica: the '
                                 f'topology needs >= 2, got '
                                 f'{args.topology}')
            plan_kw['page_corrupt'] = (args.chaos_victim, corrupt_page,
                                       corrupt_tick)
            # Scrub every tick: detection within one tick, never a token.
            router_cfg = dataclasses.replace(router_cfg,
                                             integrity_interval=0.0)
        if args.chaos_prefill_crash is not None:
            if not prefill_pools:
                raise SystemExit('--chaos-prefill-crash kills the '
                                 'prefill pool: the topology needs '
                                 f'P=1 (e.g. 1x2), got {args.topology}')
            plan_kw['prefill_crash'] = args.chaos_prefill_crash
        chaos_plan = ChaosPlan(**plan_kw)
        chaos = ChaosInjector(chaos_plan)
        # The black box armed for the run: the router's replica_lost /
        # kv_corrupt / prefill_lost triggers dump a bundle at once.
        flight_rec = obs_flight.FlightRecorder(
            os.path.join(log_dir, 'flight'))
        flight_prev = obs_flight.install(flight_rec)
    clock = VirtualClock()
    router = build_serving(
        topo, serve_config=serve_cfg, router_config=router_cfg,
        clock=clock, log_dir=log_dir, chaos=chaos)
    controller = None
    if args.control:
        from distributed_dot_product_tpu_torch.serve import (
            ControlConfig, Controller,
        )
        controller = Controller(
            router=router,
            config=ControlConfig(
                interval=0.01, scale_up_after=1, scale_down_after=20,
                max_replicas=args.control_max_replicas),
            clock=clock, event_log=router.event_log)
    on_tick = controller.tick if controller else None
    chaos_sched = None
    if chaos is not None:
        on_tick = chaos_sched = ChaosSchedule(chaos, router,
                                              on_tick=on_tick)
    try:
        with span('benchmark.serve_load_topology', seed=args.load_seed,
                  topology=args.topology):
            res = run_trace(router, load_trace(trace_path), clock,
                            tick_seconds=cfg.tick_seconds,
                            on_tick=on_tick)
    finally:
        # Member logs close (flushing their tails) even when the run under
        # them fails: those logs are the debugging record.
        router.close()
        if flight_rec is not None:
            # Disarmed before the twins run: the bundle records the chaos
            # run alone.
            obs_flight.install(flight_prev)
            flight_rec.stop()
    sources = router.pool.logs()
    spec = obs_slo.SloSpec(ttft=args.slo_ttft, per_token=args.slo_token)
    report = obs_slo.goodput(sources, spec)
    if not res.accounted:
        raise SystemExit('serve-load: a submitted request has no '
                         'terminal record across the topology — '
                         'router accounting bug, not a measurable row')
    if report.requests != len(res.submitted):
        raise SystemExit(
            f'serve-load: {report.requests} requests classified from '
            f'the merged logs vs {len(res.submitted)} submitted — a '
            f'request reconstructed zero or several times')
    bad = [rid for rid, tl in obs.reconstruct(sources).items()
           if not tl.complete]
    if bad:
        raise SystemExit(
            f'serve-load: {len(bad)} request lifecycle(s) do not '
            f'reconstruct across the merged replica logs: {bad[:5]}')

    # The single-process twin on the same trace file: one replica's
    # engine behind one scheduler, its own virtual clock.
    clock_twin = VirtualClock()
    twin_path = os.path.join(log_dir, 'twin.jsonl')
    twin_log = obs.EventLog(twin_path, clock=clock_twin)
    twin_engine = KernelEngine(
        slots=slots, t_max=t_max, vocab=64, heads=args.heads,
        head_dim=args.head_dim, prefill_chunk=8, seed=0,
        decode_impl=decode_impl, dtype=edt, device=dev,
        cache_mode='paged', page_size=args.page_size)
    twin = Scheduler(twin_engine, twin_cfg, clock=clock_twin,
                     event_log=twin_log, fault_injector=False,
                     registry=MetricsRegistry())
    try:
        res_twin = run_trace(twin, load_trace(trace_path), clock_twin,
                             tick_seconds=cfg.tick_seconds)
    finally:
        twin.close()
        twin_log.close()
    report_twin = obs_slo.goodput(twin_path, spec)

    def _rerun(sub, label, topology, router_config, injector, tick):
        """The same trace and fault against another configuration of the
        topology (the no-recovery or checksums-off twin)."""
        path = os.path.join(log_dir, sub)
        os.makedirs(path, exist_ok=True)
        _fresh_logs(path, ['router'] + (['prefill'] if prefill_pools
                                        else []))
        clk = VirtualClock()
        rt = build_serving(topology,
                           serve_config=dataclasses.replace(twin_cfg),
                           router_config=router_config, clock=clk,
                           log_dir=path, chaos=injector)
        try:
            out = run_trace(rt, load_trace(trace_path), clk,
                            tick_seconds=cfg.tick_seconds, on_tick=tick(rt))
        finally:
            rt.close()
        if not out.accounted:
            raise SystemExit(f'{label}: a request ended without a typed '
                             f'terminal')
        return out, obs_slo.goodput(rt.pool.logs(), spec)

    def _router_events():
        return list(obs.read_events(dict(sources)['router']))

    chaos_extra = {}
    if args.chaos:
        # What the recovery did, from the router log.
        revents = _router_events()
        losses = [r for r in revents if r.get('event') == 'replica.lost']
        recovered = [r['request_id'] for r in revents
                     if r.get('event') == 'request.recovered'
                     and r.get('requeued')]
        lost_rejects = [r['request_id'] for r in revents
                        if r.get('event') == 'request.recovered'
                        and not r.get('requeued')]
        probe_events = sum(1 for r in revents
                           if r.get('event') == 'replica.probe')
        if not losses:
            raise SystemExit(
                f'chaos: killing {args.chaos_victim} at tick '
                f'{args.chaos_tick} never became a replica.lost '
                f'declaration — the probe path is broken')
        if not recovered:
            raise SystemExit(
                f'chaos: replica {args.chaos_victim} died with no '
                f'stream to recover — move --chaos-tick into the busy '
                f'part of the trace (died at tick {args.chaos_tick} '
                f'of {res.ticks})')
        if not flight_rec.dumps:
            raise SystemExit('chaos: the replica loss produced no '
                             'flight bundle (trigger replica_lost)')
        # A recovered stream is the crash-free stream: compare the streams
        # both runs completed uncapped.
        compared, mismatched = 0, []
        for rid in recovered:
            a, b = res.results.get(rid), res_twin.results.get(rid)
            if (a is not None and b is not None
                    and a.status == b.status == 'completed'
                    and not a.degraded and not b.degraded):
                compared += 1
                if list(a.tokens) != list(b.tokens):
                    mismatched.append(rid)
        if mismatched:
            raise SystemExit(
                f'chaos: {len(mismatched)} recovered stream(s) '
                f'diverged from the crash-free twin: '
                f'{mismatched[:5]} — replay-prefill recovery broke '
                f'the determinism contract')
        # The no-recovery twin: same topology, trace and crash,
        # max_recoveries=0; the goodput gap is what recovery is worth.
        res_norec, report_norec = _rerun(
            'norec', 'chaos: the no-recovery twin', topo,
            dataclasses.replace(router_cfg, max_recoveries=0),
            ChaosInjector(chaos_plan),
            lambda rt: ChaosSchedule(rt.chaos, rt))
        norec_lost = sorted(
            rid for rid, rr in res_norec.results.items()
            if rr.status == 'rejected'
            and getattr(rr.reason, 'value', rr.reason) == 'replica_lost')
        if not norec_lost:
            raise SystemExit('chaos: the no-recovery twin lost the '
                             'same replica yet rejected nothing '
                             'replica_lost — the typed terminal path '
                             'is broken')
        if report.goodput_pct < report_norec.goodput_pct:
            raise SystemExit(
                f'chaos: goodput WITH recovery '
                f'({report.goodput_pct:.1f}%) fell below the '
                f'no-recovery twin ({report_norec.goodput_pct:.1f}%) '
                f'— recovery made things worse')
        chaos_extra = {
            'chaos': {'victim': args.chaos_victim,
                      'tick': args.chaos_tick},
            'replica_lost': [r.get('target') for r in losses],
            'recovered': sorted(recovered),
            'recovered_compared': compared,
            'recovered_bitident': compared > 0 and not mismatched,
            'replica_lost_rejects': sorted(lost_rejects),
            'probe_events': probe_events,
            'flight_bundle': flight_rec.dumps[-1]['path'],
            'norec_goodput_pct': report_norec.goodput_pct,
            'norec_counts': report_norec.counts,
            'norec_replica_lost_rejects': norec_lost,
        }

    corrupt_extra = {}
    if args.chaos_corrupt:
        # What the integrity layer did, from the router log.
        revents = _router_events()
        corrupt_events = [r for r in revents
                          if r.get('event') == 'kv.corrupt']
        injected = [r for r in revents
                    if r.get('event') == 'fault.inject'
                    and r.get('kind') == 'page_corrupt']
        healed = [r['request_id'] for r in revents
                  if r.get('event') == 'request.recovered'
                  and r.get('reason') == 'kv_corrupt'
                  and r.get('requeued')]
        corrupt_rejects = [r['request_id'] for r in revents
                           if r.get('event') == 'request.recovered'
                           and r.get('reason') == 'kv_corrupt'
                           and not r.get('requeued')]
        if not chaos_sched.corrupted:
            raise SystemExit(
                f'chaos-corrupt: the bit flip never landed (no '
                f'tracked page on {args.chaos_victim} from tick '
                f'{corrupt_tick} of {res.ticks}) — move the tick into '
                f'the busy part of the trace or lower '
                f'--prefill-threshold')
        if not corrupt_events:
            raise SystemExit(
                f'chaos-corrupt: {len(chaos_sched.corrupted)} flip(s) '
                f'landed but NO kv.corrupt verdict was declared — the '
                f'checksum verification path is broken')
        if not flight_rec.dumps:
            raise SystemExit('chaos-corrupt: the corruption produced '
                             'no flight bundle (trigger kv_corrupt)')
        # No silent wrong token: every delivered token must match the
        # crash-free twin's stream prefix, whatever either terminal was.
        compared, mismatched = 0, []
        for rid, a in res.results.items():
            b = res_twin.results.get(rid)
            if b is None:
                continue
            n = min(len(a.tokens), len(b.tokens))
            if n:
                compared += 1
                if list(a.tokens)[:n] != list(b.tokens)[:n]:
                    mismatched.append(rid)
        if mismatched:
            raise SystemExit(
                f'chaos-corrupt: {len(mismatched)} completed '
                f'stream(s) diverged from the crash-free twin: '
                f'{mismatched[:5]} — a corrupted page leaked into a '
                f'delivered token')
        # Verify-time cost, summed over every engine that digested.
        verify_seconds = sum(r.engine.verify_seconds
                             for r in router.pool.replicas)
        if router.pool.prefill is not None:
            verify_seconds += router.pool.prefill.engine.verify_seconds
        # The no-integrity twin: same topology, trace and flip,
        # kv_checksums=False — what completes wrong there is what the
        # checksums are worth.
        ni_scheds = []

        def _ni_tick(rt):
            ni_scheds.append(ChaosSchedule(rt.chaos, rt))
            return ni_scheds[-1]
        res_ni, report_ni = _rerun(
            'nointeg', 'chaos-corrupt: the no-integrity twin',
            dataclasses.replace(topo, kv_checksums=False),
            dataclasses.replace(router_cfg, integrity_interval=None),
            ChaosInjector(chaos_plan), _ni_tick)
        if not ni_scheds[0].corrupted:
            raise SystemExit('chaos-corrupt: the flip landed in the '
                             'integrity run but not in the '
                             'no-integrity twin — the comparison is '
                             'meaningless')
        # Silently wrong: delivered tokens diverging from the twin
        # stream's prefix.
        wrong = []
        for rid, a in res_ni.results.items():
            b = res_twin.results.get(rid)
            if b is None:
                continue
            n = min(len(a.tokens), len(b.tokens))
            if n and list(a.tokens)[:n] != list(b.tokens)[:n]:
                wrong.append(rid)
        wrong.sort()
        corrupt_extra = {
            'chaos_corrupt': {'victim': args.chaos_victim,
                              'page': corrupt_page,
                              'tick': corrupt_tick},
            'corruptions_injected': len(chaos_sched.corrupted),
            'corruptions_detected': len(corrupt_events),
            'corrupt_sites': sorted({str(r.get('site'))
                                     for r in corrupt_events}),
            'corrupt_pages': sorted({int(p) for r in corrupt_events
                                     for p in (r.get('pages') or [])}),
            'corrupt_inject_events': len(injected),
            'corrupt_healed': sorted(healed),
            'corrupt_rejects': sorted(corrupt_rejects),
            'corrupt_compared': compared,
            'corrupt_bitident': compared > 0 and not mismatched,
            'verify_seconds': verify_seconds,
            'flight_bundle': flight_rec.dumps[-1]['path'],
            'nointeg_goodput_pct': report_ni.goodput_pct,
            'nointeg_counts': report_ni.counts,
            'nointeg_wrong_streams': wrong,
        }

    prefill_extra = {}
    if args.chaos_prefill_crash is not None:
        plost = [r for r in _router_events()
                 if r.get('event') == 'prefill.lost']
        if not plost:
            raise SystemExit(
                f'chaos-prefill-crash: killing the prefill pool at '
                f'tick {args.chaos_prefill_crash} never became a '
                f'prefill.lost declaration — the probe path is broken')
        if router.pool.prefill is not None:
            raise SystemExit('chaos-prefill-crash: the router still '
                             'holds a live prefill pool after the '
                             'loss was declared')
        prefill_extra = {
            'chaos_prefill_crash': {'tick': args.chaos_prefill_crash},
            'prefill_lost': [r.get('target') for r in plost],
            'prefill_lost_reason': plost[-1].get('reason'),
        }

    counters = router.registry.snapshot()['counters']
    routed = {}
    for key, n in counters.items():
        # Per-(replica, tenant) labeled series summed per replica:
        # 'router.routed{replica=r0,tenant=t1}'.
        if key.startswith('router.routed{'):
            name = key.split('replica=', 1)[1].split(',')[0].rstrip('}')
            routed[name] = routed.get(name, 0) + n
    record = {
        'mode': 'serve-load', 'topology': args.topology,
        'seed': args.load_seed, 'arrival': cfg.arrival,
        'rate_requested': cfg.rate, 'rate_offered': res.offered_rate,
        'requests': report.requests, 'slots': slots, 't_max': t_max,
        'page_size': args.page_size, 'spec': args.spec,
        'decode_impl': args.decode_impl,
        'engine_dtype': _dtype_name(edt),
        'queue_limit': serve_cfg.queue_limit,
        'tick_seconds': cfg.tick_seconds,
        'prefill_threshold': args.prefill_threshold,
        'platform': _platform(dev), 'device_kind': _device_kind(dev),
        'slo': spec.to_dict(),
        'goodput_pct': report.goodput_pct,
        'counts': report.counts,
        'per_tenant': {t: tb['goodput_pct']
                       for t, tb in sorted(report.per_tenant.items())},
        'twin_goodput_pct': report_twin.goodput_pct,
        'twin_counts': report_twin.counts,
        'twin_ticks': res_twin.ticks,
        'routed': routed,
        'prefix_hits': counters.get('router.prefix_hits', 0),
        'prefix_misses': counters.get('router.prefix_misses', 0),
        'handoffs': counters.get('router.handoffs', 0),
        'handoff_pages': counters.get('router.handoff_pages', 0),
        'virtual_seconds': res.virtual_seconds,
        'wall_seconds': res.wall_seconds,
        'ticks': res.ticks,
        'trace': trace_path,
        'event_logs': dict(sources),
        'control': bool(args.control),
        'control_actions': (list(controller.actions)
                            if controller else []),
        'replicas_final': len(router.pool.replicas),
    }
    # Dispatch-floor split from the merged serve.dispatch stream (the
    # replicas keep separate registries).
    from distributed_dot_product_tpu_torch.obs import critpath
    disp = critpath.dispatch_floor(sources)
    if disp['total']['ticks']:
        tot = disp['total']
        record['dispatch_ticks'] = tot['ticks']
        record['dispatch_overhead_s'] = tot['overhead_seconds']
        record['dispatch_overhead_ms_per_token'] = (
            None if tot['overhead_per_token'] is None
            else tot['overhead_per_token'] * 1e3)
        record['dispatch_per_replica'] = {
            name: {'ticks': agg['ticks'],
                   'overhead_s': agg['overhead_seconds'],
                   'overhead_share': agg['overhead_share']}
            for name, agg in sorted(disp['per_replica'].items())}
    record.update(chaos_extra)
    record.update(corrupt_extra)
    record.update(prefill_extra)
    if args.chaos_corrupt:
        print(f"chaos-corrupt[{args.chaos_victim} page {corrupt_page}"
              f"@tick {corrupt_tick}]: "
              f"{corrupt_extra['corruptions_injected']} flip(s) "
              f"injected, {corrupt_extra['corruptions_detected']} "
              f"kv.corrupt verdict(s) at "
              f"{corrupt_extra['corrupt_sites']}, "
              f"{len(corrupt_extra['corrupt_healed'])} victim(s) "
              f"healed + {len(corrupt_extra['corrupt_rejects'])} typed "
              f"kv_corrupt terminal(s), "
              f"{corrupt_extra['corrupt_compared']} completed streams "
              f"bit-identical to the twin; verify cost "
              f"{corrupt_extra['verify_seconds'] * 1e3:.1f}ms; goodput "
              f"with integrity {report.goodput_pct:.1f}% vs "
              f"no-integrity twin "
              f"{corrupt_extra['nointeg_goodput_pct']:.1f}% "
              f"({len(corrupt_extra['nointeg_wrong_streams'])} "
              f"SILENTLY WRONG stream(s) there); flight bundle "
              f"{corrupt_extra['flight_bundle']}")
    if args.chaos_prefill_crash is not None:
        print(f"chaos-prefill[tick {args.chaos_prefill_crash}]: "
              f"{prefill_extra['prefill_lost']} declared lost "
              f"({prefill_extra['prefill_lost_reason']}); every later "
              f"long prompt served by flat prefill "
              f"({record.get('handoffs', 0)} handoffs before the "
              f"loss); goodput {report.goodput_pct:.1f}%")
    if args.chaos:
        print(f"chaos[{args.chaos_victim}@tick {args.chaos_tick}]: "
              f"{len(chaos_extra['recovered'])} stream(s) recovered "
              f"({chaos_extra['recovered_compared']} bit-identical to "
              f"the crash-free twin), "
              f"{len(chaos_extra['replica_lost_rejects'])} typed "
              f"replica_lost terminal(s); goodput with recovery "
              f"{report.goodput_pct:.1f}% vs no-recovery twin "
              f"{chaos_extra['norec_goodput_pct']:.1f}%; "
              f"flight bundle {chaos_extra['flight_bundle']}")
    print(f"serve-load[topology {args.topology}"
          f"{'+control' if args.control else ''}] "
          f"seed={args.load_seed} "
          f"{cfg.arrival}@{cfg.rate:.0f}/s x{report.requests}: "
          f"goodput {report.goodput_pct:.1f}% vs single-process twin "
          f"{report_twin.goodput_pct:.1f}% "
          f"(routed {routed}, {record['handoffs']} handoffs, "
          f"{record['prefix_hits']} prefix hits"
          + (f", {len(record['control_actions'])} control actions, "
             f"{record['replicas_final']} replicas final"
             if args.control else '') + ')')
    print(obs_slo.render_report(report))
    print(f'event logs: {log_dir}')
    _append_record(args.file, record)
    return record


def run_serve_load(args):
    """``--mode serve-load``: goodput under SLO for a seeded open-loop
    trace. The load generator drives the scheduler in virtual time
    (Poisson or bursty arrivals, heavy-tailed per-tenant lengths), the
    run's JSONL event log is written, and the goodput report is computed
    from the log alone (``obs/slo.py``). The flag defaults are the
    reference's CI smoke config (``SLO_BASELINE.json``). With
    ``--topology PxD`` the run goes through the router instead
    (:func:`run_serve_load_topology`)."""
    import tempfile

    from distributed_dot_product_tpu_torch import obs
    from distributed_dot_product_tpu_torch.obs import DeviceMonitor
    from distributed_dot_product_tpu_torch.obs import slo as obs_slo
    from distributed_dot_product_tpu_torch.serve import (
        KernelEngine, LoadGenConfig, ServeConfig, VirtualClock,
        default_tenants, run_load,
    )
    from distributed_dot_product_tpu_torch.utils.tracing import (
        MetricsRegistry,
    )

    if args.topology:
        return run_serve_load_topology(args)

    dev = _device(args.device)
    edt = _engine_dtype(dev)
    slots = args.batch if args.batch > 1 else 4
    t_max = args.seq_len or 96
    paged = args.cache_mode == 'paged'
    extra = dict(cache_mode='slab')
    if paged:
        if t_max % args.page_size:
            raise SystemExit(f'--page-size {args.page_size} must '
                             f'divide the cache length {t_max}')
        extra = dict(cache_mode='paged', page_size=args.page_size,
                     pages=slots * (t_max // args.page_size))
    engine = KernelEngine(
        slots=slots, t_max=t_max, vocab=64, heads=args.heads,
        head_dim=args.head_dim, prefill_chunk=8, seed=0,
        decode_impl=_decode_impl(args, dev), dtype=edt, device=dev,
        **extra)
    cfg = LoadGenConfig(
        seed=args.load_seed, rate=args.load_rate,
        requests=args.load_requests, arrival=args.arrival,
        ramp_factor=args.ramp_factor,
        tenants=default_tenants(args.load_tenants), vocab=64,
        tick_seconds=args.load_tick)
    serve_cfg = ServeConfig(
        queue_limit=args.queue_limit,
        max_new_tokens=max(t.new_hi for t in cfg.tenants),
        watchdog=False, spec=args.spec, spec_k=args.spec_k)
    control_cfg = None
    if args.control:
        from distributed_dot_product_tpu_torch.serve import ControlConfig
        control_cfg = ControlConfig(interval=0.01)
    log_path = args.event_log or os.path.join(
        tempfile.gettempdir(), f'ddp_serve_load_{os.getpid()}.jsonl')
    # A fresh log per run: an EventLog appends.
    obs.remove_log(log_path)
    clock = VirtualClock()
    event_log = obs.EventLog(log_path, clock=clock)
    registry = (tracing.get_registry()
                if getattr(args, 'metrics_out', None)
                else MetricsRegistry())
    # Device telemetry across the run (wall time: the monitor polls the
    # card however fast the virtual clock spins).
    devmon = DeviceMonitor(registry=registry, interval=0.2).start()
    try:
        with span('benchmark.serve_load', seed=args.load_seed):
            res = run_load(cfg, engine=engine, serve_config=serve_cfg,
                           registry=registry, event_log=event_log,
                           clock=clock, control=control_cfg)
    finally:
        devmon.stop()
    devmon.poll_once()      # end-of-run device state
    event_log.close()

    spec = obs_slo.SloSpec(ttft=args.slo_ttft, per_token=args.slo_token)
    # Read and decode the log once; goodput and the churn reconstruction
    # both take the decoded records.
    records = obs.read_events(log_path)
    report = obs_slo.goodput(records, spec)
    if not res.accounted:
        raise SystemExit('serve-load: a submitted request has no '
                         'terminal record — scheduler accounting bug, '
                         'not a measurable row')
    if report.requests != len(res.submitted):
        raise SystemExit(
            f'serve-load: {report.requests} requests classified from '
            f'the log vs {len(res.submitted)} submitted — the event '
            f'log is not a complete record')
    # Per-tenant churn, reconstructed from the same log.
    preempts, requeues = {}, {}
    for tl in obs.reconstruct(records).values():
        tenant = tl.tenant or 'default'
        preempts[tenant] = preempts.get(tenant, 0) + tl.preempts
        requeues[tenant] = requeues.get(tenant, 0) + max(0, tl.admits - 1)
    per_tenant = {
        t: {'requests': tb['requests'],
            'goodput_pct': tb['goodput_pct'],
            'met': tb['counts']['met'],
            'rejected': tb['counts']['rejected'],
            'preempts': preempts.get(t, 0),
            'requeues': requeues.get(t, 0)}
        for t, tb in sorted(report.per_tenant.items())}

    def _ms(name):
        return {k: (None if v is None else v * 1e3)
                for k, v in report.percentiles[name].items()
                if k != 'count'}
    record = {
        'mode': 'serve-load', 'seed': args.load_seed,
        'arrival': cfg.arrival, 'rate_requested': cfg.rate,
        'rate_offered': res.offered_rate,
        'requests': report.requests, 'slots': slots, 't_max': t_max,
        'cache_mode': args.cache_mode, 'spec': args.spec,
        'decode_impl': args.decode_impl,
        'engine_dtype': _dtype_name(edt),
        'queue_limit': serve_cfg.queue_limit,
        'control': bool(args.control),
        'tick_seconds': cfg.tick_seconds,
        'platform': _platform(dev), 'device_kind': _device_kind(dev),
        'slo': spec.to_dict(),
        'goodput_pct': report.goodput_pct,
        'counts': report.counts,
        'per_tenant': per_tenant,
        'ttft_ms': _ms('ttft'),
        'gap_ms': _ms('gap'),
        'queue_wait_ms': _ms('queue_wait'),
        'virtual_seconds': res.virtual_seconds,
        'wall_seconds': res.wall_seconds,
        'ticks': res.ticks,
        'event_log': log_path,
        'device_polls': registry.counter('device.memory.polls').value,
        'devices_reporting': registry.gauge(
            'device.memory.devices_reporting').value,
    }
    # Dispatch-floor split of the decode ticks (real seconds, reporting
    # only; never the timeline).
    tok_c = registry.peek('counter', 'serve.tokens_generated')
    record.update(_dispatch_split(
        registry, tok_c.value if tok_c is not None else 0))
    print(f"serve-load[{args.cache_mode}/"
          f"{args.spec}] seed={args.load_seed} "
          f"{cfg.arrival}@{cfg.rate:.0f}/s x{report.requests}: "
          f"goodput {report.goodput_pct:.1f}% under "
          f"ttft<{args.slo_ttft * 1e3:.0f}ms "
          f"gap<{args.slo_token * 1e3:.0f}ms")
    print(obs_slo.render_report(report))
    print(f'event log: {log_path}')
    _append_record(args.file, record)
    return record


def run_decode_spec(args):
    """``--mode decode --spec {ngram,draft}``: what draft-verify decoding
    buys over one-token-a-step generation. Two scheduler runs over the
    same engine shape and the same repetitive prompts: (a) the non-spec
    baseline, (b) the named proposer feeding the fused verify-k step (K5
    with k new rows). Both timed warm; greedy verification makes the two
    streams identical, which the run asserts before recording anything."""
    import numpy as np

    from distributed_dot_product_tpu_torch.serve import (
        KernelEngine, Scheduler, ServeConfig,
    )
    from distributed_dot_product_tpu_torch.utils.tracing import (
        MetricsRegistry,
    )

    dev = _device(args.device)
    impl = _decode_impl(args, dev)
    slots = args.batch
    t_max = args.seq_len or 512
    max_new = 64
    # A cyclic prompt (period 3): the n-gram proposer's best case; the
    # prompt and the generated tokens must fit the cache.
    prompt_len = min(8, t_max - max_new - 1)
    if prompt_len < 2:
        raise SystemExit(f'--seq-len {t_max} leaves no room for a '
                         f'prompt + {max_new} generated tokens')
    prompt = [(i % 3) + 1 for i in range(prompt_len)]
    n_rounds = -(-(args.serve_requests or 2 * slots) // slots)
    n_requests = n_rounds * slots

    def burst(sched, tag):
        for i in range(n_requests):
            sched.submit(list(prompt), request_id=f'{tag}.{i}')
        # run_until_idle returns every result since the scheduler
        # started: keep this burst's.
        return {rid: r for rid, r in sched.run_until_idle().items()
                if rid.startswith(f'{tag}.')}

    def measure(spec):
        # seed=4: a random-init engine whose greedy continuation of the
        # cyclic prompt locks into the cycle; the baseline shares it.
        eng = KernelEngine(
            slots=slots, t_max=t_max, vocab=256, heads=args.heads,
            head_dim=args.head_dim, prefill_chunk=8, seed=4,
            decode_impl=impl, dtype=_engine_dtype(dev), device=dev,
            cache_mode='slab')
        reg = (tracing.get_registry()
               if spec != 'off' and getattr(args, 'metrics_out', None)
               else MetricsRegistry())
        sched = Scheduler(eng, ServeConfig(
            queue_limit=max(8, 2 * n_requests), max_new_tokens=max_new,
            watchdog=False, degrade_watermark=1.1,
            spec=spec, spec_k=args.spec_k), registry=reg)
        burst(sched, 'warm')                 # load and warm every path
        steps0 = reg.snapshot()['counters'].get('serve.decode_steps', 0)
        hard_sync()
        t0 = time.perf_counter()
        with span('benchmark.spec_burst', spec=spec):
            results = burst(sched, 'r')
        hard_sync()
        dt = time.perf_counter() - t0
        steps = reg.snapshot()['counters']['serve.decode_steps'] - steps0
        sched.close()
        n_tok = sum(len(r.tokens) for r in results.values())
        return results, n_tok / dt, steps, reg, eng

    # 'off', not None: None would consult the DDP_TPU_SPEC knob and could
    # make the baseline speculative too.
    base, base_tps, base_steps, _, _ = measure('off')
    spec, spec_tps, spec_steps, reg, eng = measure(args.spec)
    for rid in base:
        if spec[rid].tokens != base[rid].tokens:
            raise SystemExit(
                f'spec stream diverged from the non-spec stream for '
                f'{rid} — greedy verification must be exact; this is '
                f'a decode bug, not a measurable row')
    acc = reg.histogram('serve.spec.accepted_per_step',
                        buckets=()).summary()
    prop = reg.histogram('serve.spec.proposed_per_step',
                         buckets=()).summary()
    n_tok = sum(len(r.tokens) for r in spec.values())
    record = {
        'mode': 'decode', 'spec': args.spec, 'spec_k': args.spec_k,
        'slots': slots, 't_max': t_max, 'heads': args.heads,
        'head_dim': args.head_dim, 'requests': n_requests,
        'prompt_len': prompt_len, 'max_new_tokens': max_new,
        'decode_impl': _impl_label(eng.decode_impl),
        'engine_dtype': _dtype_name(eng.dtype),
        'platform': _platform(dev), 'device_kind': _device_kind(dev),
        'tokens': n_tok,
        'tokens_per_s': spec_tps,
        'baseline_tokens_per_s': base_tps,
        'spec_speedup': spec_tps / base_tps,
        'decode_steps': spec_steps,
        'baseline_decode_steps': base_steps,
        'accepted_per_step': acc['mean'],
        'proposed_per_step': prop['mean'],
        'completed': sum(r.status == 'completed' for r in spec.values()),
    }
    print(f"decode-spec[{args.spec} k={args.spec_k}/"
          f"{record['decode_impl']}] B={slots} t_max={t_max}: "
          f"{spec_tps:,.0f} tok/s vs {base_tps:,.0f} non-spec "
          f"({record['spec_speedup']:.2f}x), accepted "
          f"{acc['mean']:.2f}/step of {prop['mean']:.2f} proposed, "
          f"{spec_steps} vs {base_steps} dispatches for {n_tok} tokens")
    _append_record(args.file, record)
    return record


# -- the sequence matmuls ----------------------------------------------------

_SHARD_LOCAL = {'nt': distributed_matmul_nt, 'all': distributed_matmul_all,
                'tn': distributed_matmul_tn}


def _profile_call(fn, args_, profile_dir):
    """A ``torch.profiler`` trace (``obs/devmon.py`` ``ProfileCapture``) of
    the timed call, warm: calls run until the bounded capture lands
    under ``profile_dir``. Returns the trace directory."""
    from distributed_dot_product_tpu_torch.obs.devmon import ProfileCapture
    hard_sync(fn(*args_))                         # warm outside the trace
    t0 = time.perf_counter()
    hard_sync(fn(*args_))
    one = time.perf_counter() - t0
    cap = ProfileCapture(profile_dir, max_seconds=60.0)
    cap.warmup()
    info = cap.start(seconds=max(0.2, 2.0 * one), trigger='benchmark')
    while cap.busy:
        hard_sync(fn(*args_))
    cap.join()
    return info['path']


def run(args):
    _zero_launches()
    if args.mode == 'attn':
        return run_attn(args)
    if args.mode == 'train':
        return run_train(args)
    if args.mode == 'decode' and args.spec != 'off':
        return run_decode_spec(args)
    if args.mode == 'decode' and args.kv_shards:
        # Explicit --kv-shards (1 included: the sweep's baseline row)
        # selects the sharded-pool capacity row.
        return run_decode_kv_sharded(args)
    if args.mode == 'decode':
        return run_decode(args)
    if args.mode == 'decode-serve':
        return run_decode_serve(args)
    if args.mode == 'serve-load':
        return run_serve_load(args)
    if args.mode == 'lm':
        return run_lm(args)
    dev = _device(args.device)
    mesh = seq_mesh(args.devices)
    world = mesh.seq_size
    t = FULL_T // args.scale
    t -= t % world  # shard evenly
    dtype = torch.bfloat16 if args.dtype == 'bf16' else torch.float32
    flops = 2.0 * t * t * DIM  # the same count for all three products

    # The largest single buffer: the (T, T) score-shaped operand / output.
    # Refuse what cannot fit the card rather than dying in an opaque OOM.
    limit = _device_bytes_limit(dev)
    score_bytes = t * t * (torch.finfo(dtype).bits // 8)
    if limit and score_bytes > 0.9 * limit:
        raise SystemExit(
            f'workload needs a {score_bytes / 2**30:.1f} GiB (T,T) buffer '
            f'per device but the device limit is {limit / 2**30:.1f} GiB; '
            f'raise --scale or use --dtype bf16')

    left, right = make_inputs(args.mode, t, dtype, dev)
    record = {
        'mode': args.mode, 'scale': args.scale,
        # tn has no chunk / impl knobs: recorded null.
        'offset': args.offset if args.mode != 'tn' else None,
        'impl': args.impl if args.mode != 'tn' else None,
        'T': t, 'dim': DIM, 'world': world, 'dtype': args.dtype,
        'platform': _platform(dev), 'device_kind': _device_kind(dev),
    }

    if not args.skip_local:
        # The one-card full-size baseline.
        local = _summed(LOCAL[args.mode])
        best, mean = time_fn(local, left, right, iters=args.iters)
        record.update(local_time=best, local_time_mean=mean,
                      local_gflops=flops / best / 1e9)
        print(f"local 1-device {args.mode}: {best:.4f}s "
              f"({record['local_gflops']:.0f} GFLOP/s)")

    # Distributed: this rank's shards through the shard-local product,
    # summed, the scalar all-reduced over the seq ranks.
    op = _SHARD_LOCAL[args.mode]
    kw = ({} if args.mode == 'tn'
          else {'offset': args.offset, 'impl': args.impl})
    group = mesh.seq_group

    def fn(l, r):
        out = op(shard_seq(l, mesh), shard_seq(r, mesh), group=group, **kw)
        return comm.all_reduce(out.sum(dtype=torch.float32), group)

    if args.profile_dir:
        path = _profile_call(fn, (left, right), args.profile_dir)
        print(f'profile trace: {path}')

    with span('benchmark.measure', mode=args.mode):
        best, mean = time_fn(fn, left, right, iters=args.iters)
    peak = device_peak_bytes(dev) if dev.type == 'cuda' else None
    program = _program(dev, fn, left, right)
    record.update(
        dist_time=best, dist_time_mean=mean,
        dist_gflops_per_chip=flops / world / best / 1e9,
        dist_peak_bytes_per_chip=peak,
        dist_memory_analysis=_memory_analysis(program),
        perf_model=_perf_model(program, best),
    )
    print(f"dist {world}-device {args.mode} offset={args.offset} "
          f"impl={args.impl}: {best:.4f}s "
          f"({record['dist_gflops_per_chip']:.0f} GFLOP/s/chip"
          + (f", peak {peak / 2**30:.2f} GiB)" if peak else ")"))
    _append_record(args.file, record)
    return record


def _write_metrics_out(args, record):
    """One observability artifact per run: the metrics-registry snapshot,
    the phase-span summary and tree, the result record and every card's
    memory statistics."""
    from distributed_dot_product_tpu_torch.obs.devmon import (
        device_stats_snapshot,
    )
    payload = {
        'mode': args.mode,
        'record': record,
        'perf_model': record.get('perf_model'),
        'metrics': tracing.metrics(),
        'spans': obs_spans.get_collector().summary(),
        'span_tree': obs_spans.get_collector().render().splitlines(),
        'devices': device_stats_snapshot(),
    }
    with open(args.metrics_out, 'w') as f:
        json.dump(payload, f, indent=2, default=str)
    print(f'metrics snapshot written to {args.metrics_out}')


def _run_process(args):
    """This process's part of the run: spans on for ``--metrics-out``,
    the mode, the artifact (rank 0)."""
    if args.metrics_out:
        # Spans on for the run, mirrored into the process registry so the
        # snapshot carries span.<phase>.seconds histograms too.
        obs_spans.enable(True, registry=tracing.get_registry())
    record = run(args)
    if args.metrics_out and comm.get_rank() == 0:
        _write_metrics_out(args, record)
    return record


def _rank_main(rank, world, init_method, backend, argv, results):
    """One of ``--devices N`` ranks started by :func:`_spawn_ranks`: joins
    the group, runs, reports its record (rank 0's is the row) or its
    traceback."""
    import traceback

    import torch.distributed as dist
    try:
        args = parse_args(argv)
        if comm.resolve_device(args.device).type == 'cuda':
            torch.cuda.set_device(rank if backend == 'nccl' else 0)
        comm.init(backend, init_method, world, rank)
        record = _run_process(args)
        results.put((rank, None, record if rank == 0 else None))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn_ranks(args, argv):
    """``--devices N`` from one command: N processes, one rank each, over
    gloo (host-staged collectives on a shared card) or NCCL when every
    rank has a card. Returns rank 0's record; a rank that fails or dies
    fails the run, and every process is stopped either way."""
    import multiprocessing as mp
    import queue
    import socket

    world = args.devices
    dev = comm.resolve_device(args.device)
    backend = ('nccl' if dev.type == 'cuda'
               and torch.cuda.device_count() >= world else 'gloo')
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context('spawn')
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world, f'tcp://localhost:{port}', backend,
                               argv, results))
             for r in range(world)]
    for p in procs:
        p.start()
    record, done = None, set()
    try:
        while len(done) < world:
            try:
                rank, error, value = results.get(timeout=5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in done and p.exitcode is not None]
                if dead:
                    raise RuntimeError(f'rank(s) {dead} exited without a '
                                       f'result (exit codes '
                                       f'{[procs[r].exitcode for r in dead]})')
                continue
            if error is not None:
                raise RuntimeError(f'rank {rank} failed:\n{error}')
            done.add(rank)
            if rank == 0:
                record = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return record


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    comm.resolve_device(args.device)      # no card: raise before anything
    if args.multihost:
        # One process per host: NCCL between the cards, gloo on the CPU.
        backend = 'nccl' if args.device.startswith('cuda') else 'gloo'
        if backend == 'nccl':
            torch.cuda.set_device(0)
        comm.init(backend, f'tcp://{args.coordinator}', args.num_processes,
                  args.process_id)
        comm.synchronize()
    elif os.environ.get('WORLD_SIZE'):
        comm.init_from_env(args.device)   # started by torchrun
    elif args.devices and args.devices > comm.get_world_size():
        return _spawn_ranks(args, argv)
    return _run_process(args)


if __name__ == '__main__':
    main()
