#!/usr/bin/env python3
# -*- coding: utf-8 -*-
"""
Smoke run of the PyTorch / CUDA port on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, one JSON line each (some several):

1. device: the card, torch and CUDA versions;
2. build: compiles every kernel source in ``csrc/``, one ``nvcc`` each,
   all started together; its seconds, per library the most registers a
   kernel takes and the kernels that spill (``ptxas -v``), and the
   dynamic shared memory of a K1, a K3 and a K4 block per (d, d_v) pair
   of the kernels' grid (bf16 Ext and int8);
3. flash_attention: K1 (flash-attention forward) against its plain
   PyTorch version at the prefill shape, at ragged shapes with a causal
   offset (one with GQA) and at a ragged shape without causal masking,
   in bf16;
4. flash_decode: K5 (fused decode step) against its plain version at the
   decode shape with mixed per-row fill: the appended cache must equal
   the plain append bit for bit, the output must agree within tolerance,
   a second launch must give the same bits, and one call must run exactly
   one kernel on the card (torch.profiler's kernel names); then K5 and
   K5p at their edges (a t_max no multiple of 128, a window starting
   mid-chunk, spans inside one chunk; head dims 32/64/96/128, one new row
   and verify k = 5, K5p at pages 16 and 256 bit for bit K5 on the
   gathered slab); then its partial outputs (num, m, l) and its window at the
   sequence-sharded decode shapes (a rank's 8192-column slab in the
   query's past, the owner's, one wholly in its future whose rows must be
   exactly empty, a window of 1024 past the slab, and the window on the
   32768-column local cache); then K5 with ALiBi (the classic slopes of
   8 heads): one new row, verify k = 5 (bit for bit its sequential
   one-row launches), the partials and the int8 mirror (scores' maxima
   bit for bit);
5. flash_decode_paged: K5p (the paged decode step) against its plain
   version at the serving shape (8 slots, 8 heads, head dim 96, page
   16, t_max 4096, 2048 pages) with a scrambled table and mixed fill:
   the pool must equal the plain append bit for bit on every page but
   the sink, the output must agree within tolerance and equal K5's on
   the same rows gathered into a slab, bit for bit; K5p and K5 launched
   at once on two streams on separate caches (each bit for bit its launch
   alone); K5p at page 256 (one new row and k = 5); then its partial
   outputs and window (1024) on the same cache, one slot past its
   columns and the empty slot exactly empty; then K5p with ALiBi as K5,
   each case bit for bit K5 on the gathered slab;
6. serve_path: a seeded burst of 24 requests (prompts of 1..2048 tokens)
   through the continuous-batching Scheduler over the paged KernelEngine
   (slots 8, t_max 4096, the TransformerLM's widths, bf16, prefill chunk
   64; ServeConfig(queue_limit 64, max_new_tokens 256)): terminal states,
   tokens/s, TTFT and step latency, K5p launches against decode steps;
   the same burst over the slab engine (K5) must give the same streams;
   then requests 0 and 1 on a float32 CPU engine with the same weights;
7. main_path (serving): greedy generation of the full-width TransformerLM
   (vocab 32768, dim 768, 8 heads, 16 layers, bf16 parameters and
   compute, seeded random weights) for 4 prompts of 1000 tokens, 64
   steps, t_max 2048, with the kernel launch counts of that run, then
   prompt 0 against the same weights run on the CPU in float32 (plain
   versions);
8. flash_backward: K1's LSE output, K3 (dq) and K4 (dk, dv) against
   their plain versions in bf16 at the training shape (4 x 8 heads,
   T 4096, head dim 96, causal), a ragged causal GQA 8:2 self-attention
   at T 333, Tq 77 over Tk 1077 at causal offset 1000, and a non-causal
   50 x 300; timings at the training shape, the pair K3 + K4 beside one
   SDPA backward (dq, dk and dv together) and each over it; the backward
   run twice at the training shape must give dq, dk and dv bit for bit;
9. train_path: five Adam steps (lr 3e-4) of the same model with float32
   parameters, bf16 compute and remat, on one batch of 4 x 4096 seeded
   random tokens (loss_chunk 4096): losses, ms per step, tokens/s, peak
   memory and each step's K1 / K3 / K4 launches;
10. train_cpu_reference: one step's loss and every parameter's gradient
   of a 2-layer model at full width (B 1 x T 512), the card (bf16 compute
   through the kernels) against the same float32 weights on the CPU
   (float32, plain versions);
11. flash_features (run after flash_backward): K1/K3/K4 at the flagship
   module's fold shape (2 x 8 heads, 4096 rows, head dim 64) with a dense
   mask that has fully masked rows (passed as a column slice of a
   (B, 1, 4096, 8192) mask, uncopied), with ring-fold kv_offsets (past,
   diagonal, future) and float32 gradients, against their plain
   versions; K2 against its plain version and K1, and a large-norm case
   in which the guard must launch K1; times against bound, plain and
   SDPA with a boolean mask;
12. seq_parallel: 4 ranks spawned on the card (gloo with host-staged
   collectives; NCCL when there is a card per rank) running the
   flagship DistributedDotProductAttn(key_dim=512, num_heads=8,
   offset=64): entry() at W = 1 and 4, nt / all / tn times, each
   strategy's output and gradients at W = 4 against the local module,
   and three DP x SP train steps (2 x 2, B 4 x T 8192, Adam 1e-3) of
   'full', 'flash', 'online', bounded 'flash', 'ulysses' and causal
   'online' with ms per step and each kernel's launches per step;
13. flash_masks (run after flash_features): K1/K3/K4 with ragged packed
   segments, a causal window of 2048 at kv_offset 2048, dropout 0.1,
   int8 scoring, and all four at once under GQA 8:4 at head dim 96,
   against their plain versions (K1's out and lse, K3/K4 in bf16 and
   float32) at the fold shape 2 x 8 x 4096; the dropout keep pattern
   bit for bit (v = eye(128), at the origin and near 2^20), int8 scores
   bit for bit (one key; and on every key tile: K1's lse and K4's dk, dv
   at a causal window of 1, K4 twice on the causal fold), a wholly
   cross-segment fold exactly empty; K1/K3/K4, bf16 and int8, with 65600
   (batch, head) rows (B 8200 x H 8, T 64) against their plain versions;
   ALiBi on a
   causal ring fold, zigzag positions (rank 1's diagonal fold of W = 4),
   and ALiBi with positions, a window of 1024 and dropout; K2 with
   positions; times against bound, plain and SDPA with a boolean mask
   (a float bias for ALiBi) where one call computes the same function
   (its forward for K1 and K2, its backward for K3 and K4);
13b. kernel_coverage (run after flash_masks): the widths, page sizes
   and K splits of the kernels' (d, d_v) grid — K1/K2 with their lse and
   K3/K4 (bf16 and float32 gradients) at (d, d_v) in COV_DIMS (8/8,
   24/12, 16/24, 64/32, 80/80, 160/160, 192/128, 128/256, 256/256; GQA
   8:2, 70 rows without a key), the same with packed segments, a causal
   window of 64 and dropout 0.1, and with int8 scoring, and the base
   kernels at the LM step's shape (B 2 x 8 heads x T 4096, 256/256); K5
   and K5p at the same widths and at 6/10, 7/5, 12/3 and 1/1 (rows whose
   bytes are no multiple of 16, 8 or 4), one new row and verify k = 5,
   t_max 4096, the slab also at
   block_k 128, 256 and 512, K5p at pages 16, 48, 192 and 256, the int8
   mirror; each against its plain version, empty rows exactly 0, repeats,
   caches and verify-vs-sequential and K5p-vs-K5 bit for bit, the refused
   block_k raising; K1 and K3 + K4 timed at every pair (B 2 x 8 x 2048,
   causal) beside the padding copy, the plain versions, SDPA and the
   bounds, their out, dq, dk and dv held against the plain versions';
   then DistributedDotProductAttn(key_dim 512, value_dim 256, 8
   heads, flash, causal, bf16) forward and backward at B 4 x T 8192
   against the float32 'full' module on the card, the head-dim-256
   TransformerLM (vocab 32768, dim 2048, 8 heads, 2 layers): its loss and
   last-position logits at B 2 x T 4096 against the same weights in
   float32 on the 'full' path on the card, one Adam step at B 2 x T 4096
   and 32 greedy tokens, and KernelEngine(slots 8, t_max
   3072, head_dim 256, page 48) serving serve_path's burst with its
   first-step logits against the plain decode path's; launches of each;
13c. float32_path (run before kernel_coverage): float32 operands, the
   JAX package's default dtype, on the float32 kernels (csrc/flash_f32.cu's
   K1/K2, csrc/flash_bwd_f32.cu's K3/K4; csrc/flash_decode.cu built with
   -DDECODE_F32 for K5/K5p), torch's
   TF32 switches printed and left at their defaults, nothing passing
   dtype=torch.bfloat16: every float32 kernel against its plain float32
   version on operands drawn as float32 (B 2, 8:2 heads, T 200; every
   grid pair and 80/80, 24/12, 160/160; causal with 70 rows without a key,
   a dense mask, segments with a window of 64 and dropout 0.1, ALiBi over
   shuffled positions with a window, int8 scoring; 96/96 also on GQA 4:1 at
   T 1000 and 900, causal and Ext; K1/K2's and K3/K4's shared memory,
   threads, blocks and computing warps an SM (at least 8 at 96/96) and
   ptxas registers and spills, and K1's TF32 HGMMA in its SASS at 96/96;
   K5/K5p at t_max 4096,
   96/96, 256/256, 24/12, 7/5 and 12/3, one row and verify k = 5, block_k
   128 and 512, pages 16 and 48, the partials, a window, ALiBi and the
   int8 mirror; K5/K5p f32's shared memory, steps a warp keeps in flight
   (at least 2 at 96/96), blocks an SM and ptxas registers and spills,
   and no HMMA in the SASS of its 96/96 float32 kernel):
   out, dv, decode out within 1e-4 on the row statistic, lse within 1e-5,
   dq and dk within 1e-4 of a float64 evaluation on the scale of their
   terms; rows without a key exactly 0; the dropout keep pattern bit for
   bit the bf16 kernel's and the hash's; K5p bit for bit K5 on the
   gathered slab, verify bit for bit its sequential launches, block_k 128
   bit for bit the default split, every repeat bit for bit; each kernel
   timed at the LM's shape (K5 at the greedy shape, K5p the serving one)
   beside its bf16 kernel, its plain version, SDPA at float32 (its
   backend named) and its bound (3xTF32's 165 TFLOP/s, K5/K5p FFMA's 67,
   3.35 TB/s); README
   "Resilient serving" (KernelEngine(slots 8, t_max 4096) at serve_path's
   widths and its float32 default, slab and paged) under serve_path's
   burst, streams equal to the same engine's plain decode path, beside
   the bf16 engines; the 16-layer LM at dtype=None (float32), B 4 x T
   4096, remat: the first loss within 1e-4 of softmax_impl='full', three
   Adam steps, greedy generation equal to the plain decode's; the paper's
   module (key_dim 512, 8 heads, offset 64, flash, float32) at B 4 x T
   8192, causal, not causal and bounded, within 1e-4 of 'full';
14. flagship: dryrun_multichip's window, gqa_ring (GQA, RoPE, the ring
   with packed segments, dropout 0.1 and int8 scoring), stack (a 2-layer
   TransformerStack at dim 768) and lm (the 16-layer TransformerLM on
   packed segments) stages, 4 ranks on one card as seq_parallel, a 2 x 2
   data x seq group, global B 4 x T 8192, three Adam steps each (1e-3,
   the stack 3e-4): ms per step, losses, launches per step against the
   fold counts, the gradient all-reduce's ms, peak memory; window and
   gqa_ring at W = 4 against the local module; then greedy generation
   from the trained LM on rank 0, and the LM's checkpoint case: its
   TrainState saved after step 2 (rank 0 writes, every rank barriers;
   blocking and async), a fresh LM and Adam restored, and step 3 taken
   again must give the same loss bit for bit;
15. decode_sharded (run before flagship): the recipe's decode module
   (key_dim 512, 8 heads on 4 kv heads, causal, RoPE, bf16) on 4 ranks
   as seq_parallel, batch 4, a global cache of 32768 columns in slabs of
   8192: every rank prefills the same 24544-token prompt (K1) and takes
   its slab, then 64 decode_seq_parallel steps (K5 partials on every
   slab, the flash-decoding merge across the ranks) held against the
   local twin on rank 0 at each step, one K5 launch per rank per step,
   the owner rank per step, ms per step and the merge's collectives'
   ms; then the recipe's own 3-step check on the 2 x 2 group;
16. flash_decode_verify (run after flash_decode_paged): K5 verify-k (5
   new rows per slot; counts 5/3/1/0 and an inactive slot, one slot's
   rows straddling the split at column 1024) at the greedy decode shape
   and at the flagship decode module's GQA 8:4 with head dim 64, and K5p
   at the serving shape (one slot's rows straddling a page), each against
   its plain version and, bit for bit, against 5 sequential one-row
   launches (outputs, partials, caches); times against the bound, the
   plain version and SDPA with the boolean verify mask;
17. flash_decode_int8: K5 and K5p with the int8 K mirror (one new row)
   at the same shapes and K5's partials on a full 8192-column slab: the
   scores' row maxima (the partials' m), mirror rows and caches bit for
   bit against the plain version, outputs within tolerance; times against
   the bound (K at one byte plus a 4-byte scale a row) and, for scale
   only, SDPA in bf16;
18. spec_serve (run after serve_path): the serve_path burst with
   speculative decoding (spec_k 4; the n-gram proposer and the self-draft
   twin) over the paged and slab engines: streams equal to the non-spec
   run's token for token, the target kernel's verify launches equal to
   the verify ticks; tokens/s, TTFT p99, decode ticks, proposed and
   accepted per verify step, the draft twin's K5 launches;
19. int8_decode: the gqa_ring stage's module with int8 scoring (no
   segments or dropout), bf16, batch 4: K1 int8 prefills 8128 rows of an
   8192-column cache, then 64 decode steps, one K5 int8 launch each, held
   against the module's own int8 forward and the plain decode on the
   card; ms per step; then K1 int8 timed at the prefill and at the
   gqa_ring fold, K3 and K4 int8 at that fold (with ``--parent``, beside
   the parent checkout's kernels), K3's dq and K4's dk, dv there held
   against their plain versions;
20. alibi_lm (run after train_path and main_path): the same 16-layer
   LM with use_rope=False and ALiBi slopes 2^(-8i/8): 3 Adam steps at
   B 4 x T 4096 (every K1/K3/K4 launch ALiBi), then greedy generation
   from the trained weights (batch 4, prompt 1000, 64 steps; K1 and K5
   ALiBi) and the same steps through paged caches at page 16, pages
   scrambled (K5p ALiBi), logits and tokens bit for bit the slab
   route's; ms per step, tokens/s, peak memory, prefill ms and ms per
   decode step beside the RoPE LM's of the same call; the trained
   weights' prefill logits against float32 on the CPU;
21. zigzag_ring (run after seq_parallel): the flagship module with
   causal masking, RoPE and ALiBi on 4 ranks as seq_parallel (B 4 x T
   8192): one forward and backward on the zigzag ring (inputs permuted
   by zigzag_indices, outputs and gradients permuted back) against its
   contiguous twin, one ulysses step against the local flash module,
   each rank's launches against its folds; then each rank's fold device
   time on both layouts (slowest rank against the mean);
22. wq8_serve (run after serve_path): the serve_path burst over the
   int8-weight engine (``weight_quant='int8'``), paged, slab and paged
   again: K5p / K5 launches equal decode steps, slab and paged streams
   equal token for token, the second run identical; weight bytes exact
   (27,075,584 int8 with scales, 53,870,592 bf16); first-step logits of
   the burst's first 8 prompts within the reference's 0.05 of the float
   engine's; ``quantized_dot`` on the card bit for bit its plain version
   at the head's shape (8 rows and 1 padded row; its s8 product exact);
   tokens/s and TTFT p99 beside serve_path's, the head product's ms
   beside bf16 ``F.linear``'s and its bound;
23. load_serve: the seeded two-tenant trace (``LoadGenConfig(seed=7,
   rate=300, requests=64)``, the stock tenants) through ``run_load`` on
   the virtual clock over the paged engine (4 slots), bf16 and int8,
   FIFO and with t0 at priority 1, each twice: every request accounted,
   K5p launches equal decode ticks, the second run's outcomes and SLO
   report identical, every timeline valid, no t1 admitted past a waiting
   t0 under the policy (some under FIFO); per-tenant goodput under
   ttft 20 ms / per token 4 ms, virtual and wall seconds, ticks;
24. wq8_lm (run after main_path): main_path's LM quantized by
   ``quantize_dense_params``: last-position prefill logits within 0.05
   of the bf16 LM's, greedy generation twice identical, K1 / K5 launch
   counts, the 16 layers' matrix bytes (113,246,208 int8 against
   226,492,416 bf16); prefill ms and ms a step beside the bf16 LM's;
25. train_knobs (run after train_path): train_path's LM, 2 Adam steps
   without remat, with remat, ``remat_policy='dots_saveable'`` and
   ``'dots_with_no_batch_dims_saveable'``: losses and step-1 gradients
   bit for bit alike, K1 / K3 / K4 launches a step, ms a step and peak
   memory each; then ``tie_embeddings=False``, 3 steps: loss finite and
   falling, launches a step;
26. router_serve (run after load_serve): disaggregated serving on the
   card, serve_path's configuration as a 1 x 2 topology (a prefill pool
   and two decode replicas of 8 slots behind ``build_serving``'s Router,
   ``RouterConfig()`` defaults): (1) handoff: prefixes of 17, 1000 and
   2047 rows built by the pool and adopted by a paged engine — pages bit
   for bit that engine's ``register_prefix`` of the same tokens, a slot
   started on the adopted prefix bit for bit a flat-prefilled slot and a
   registered-prefix slot in its first-step logits, 64 greedy tokens equal;
   ``build`` and ``adopt_prefix`` ms (CUDA events), the page copy's ms
   against its bound; (2) topology_burst: serve_path's burst through the
   topology beside the single paged engine: every stream equal, K5p
   launches equal the replicas' decode ticks, both replicas routed, every
   request reconstructed exactly once over the merged logs; tokens/s, TTFT
   p99, handoffs, per-handoff build / transfer seconds; (3)
   prefix_affinity: the same prompts again, each a prefix hit on its
   holder, shared pages on the holder only, streams equal; (4) recovery:
   a fresh topology on a virtual clock, r1 killed once both replicas
   decode: one replica.lost (probe_timeout), every in-flight stream
   recovered, all 24 equal, r1's torn log merged; (5) scrub: every-tick
   scrub, a rider's page of r0 flipped: kv.corrupt at the scrub, the page
   quarantined, its riders healed equal (the burst's first 8 requests);
   (6) kv_shards: 2 shards a replica — adopted pages on their owning shard
   bit for bit the source's, landed digests equal; the burst: all
   complete, K5p launches 2 x decode ticks, divergences from the single
   engine reported (bf16).
27. chaos_serve (run after router_serve): the seeded two-tenant trace
   through router_serve's topology at load_serve's 4 slots a replica,
   beside the crash-free single engine: a replica crash (and the
   no-recovery twin), a crash in the handoff, a probe blackhole, a
   prefill-pool crash, a page bit flip (and the checksums-off twin), and
   the controller against the static topology;
28. obs_serve (run after chaos_serve): (a) prefill_split: a PrefillPool
   over 2 ranks of the card (gloo) builds prefixes of 17, 1000 and 2047
   rows of serve_path's configuration — pages bit for bit the one-rank
   pool's and ``register_prefix``'s, 64 greedy tokens from the adopted
   prefix equal to a flat prefill's; build ms at 1 and 2 ranks; then
   serve_path's burst over the paged engine with (b) the device monitor
   polling (bytes in use above 0 and at most the limit, the peak at
   least the engine's cache, one device reporting), (c) the adaptive
   profiler capture armed at a TTFT p99 threshold of 0 s (exactly one
   capture inside the cooldown, its trace holding K5p kernel events and
   the serving spans) and (d) the exporter on localhost, scraped while
   the capture runs (``/metrics`` with the TTFT summary, the device
   gauges and the build info; ``/healthz`` 200; ``/profile`` 409;
   ``/dump`` a bundle), K5p launches equal to the decode steps; (e) a
   perf snapshot of every registered entrypoint on the card
   (``obs/perf.py``): measured ms beside the model's, the model's share
   at most 1, the kernel entries' kernel work equal to this script's
   count for their inputs.
29. analysis_examples (run after obs_serve): the port's graph rules over
   every registry entry on the card, the raising retrace sentinel over
   serve_path's burst, and the four harness twins at their hardware
   configurations;
30. benchmark_cli (run last): ``torch_benchmark.py`` as a user types it,
   each run a process of its own (forked from one that imported torch
   once) — nt, all and tn at scale 1 in bf16 and nt in float32, nt on 2
   ranks of the card (gloo, offset 1000), attn, train and lm in bf16 and
   attn at its float32 default, decode on the kernel and on the plain
   path in bf16, decode with the n-gram proposer and with 4 KV shards,
   decode-serve slab and paged, serve-load (the engines at their float32
   default) — each recording the dtype it computed in, the float32 runs
   launching the float32 kernels, each exiting 0 with one row carrying
   the reference's keys, on the card, its kernels launched (K1 / K3 / K4
   in attn, train, lm; K5 in the kernel decode, spec, slab serving; K5p
   in paged serving and once a shard a step under 4 shards; none of K5
   on the plain path), the matmuls no faster than their bound; then
   ``torch_bench.py``'s line
   with ``bench.py``'s keys; ``scripts/torch_smoke_router.sh``,
   ``torch_smoke_chaos.sh`` and ``torch_smoke_corrupt.sh`` run beside
   the all, tn, float32 nt, attn, train and lm runs.

Every kernel bound here reads the port's ``obs/perf.py`` (float32_path's:
3xTF32's rate and 4-byte elements, the phase's own arithmetic): the card's
peak rates and each kernel's operation and byte formula.

Then the card's ``nvidia-smi`` name and power limit, the kernels line
(``{"kernels": [...]}``: K1, K2, K3, K4, K5 and K5p with their launches on
their path (and on wq8_serve, load_serve, router_serve, chaos_serve,
obs_serve, analysis_examples, benchmark_cli, kernel_coverage, wq8_lm and
train_knobs), max error, kernel / plain / library / bound times; K1, K2,
K3 and K4 also per mask variant, K5 and K5p per partials / window /
verify / int8 / ALiBi variant; then the six float32 kernels, ``*_f32``,
with their launches on float32_path's runs and benchmark_cli's) and,
only if every phase passed, the last line ``{"ok": true, "device":
{...}}``.
Exits non-zero on any failure, and without a card. ``--phases a,b`` runs
only the named phases (after device and build) and prints no result
line. ``--parent DIR`` names the root of another checkout (the parent
commit's, unpacked): the int8 cases of ``flash_masks`` and
``int8_decode`` then also time that checkout's kernels through that
checkout's own wrappers (its ``ops/flash_attention.py``, its libraries
built from its ``csrc/`` into ``DIR/build/kernels``), in turns with this
one's.
"""

import functools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

VOCAB, DIM, HEADS, LAYERS = 32768, 768, 8, 16
BATCH, PROMPT, STEPS, T_MAX = 4, 1000, 64, 2048
HEAD_DIM = DIM // HEADS
# The training configuration: the README's model and Adam learning rate.
TRAIN_B, TRAIN_T, TRAIN_STEPS, LOSS_CHUNK, LR = 4, 4096, 5, 4096, 3e-4
REF_LAYERS, REF_T = 2, 512
# The serving configuration (README "Resilient serving"): KernelEngine(slots
# 8, t_max 4096) at the TransformerLM's widths, paged, page size 16, the
# default pool of slots * t_max / page_size pages, prefill chunk 64, and
# ServeConfig(queue_limit 64, max_new_tokens 256); a seeded burst of 24
# requests with prompt lengths uniform in 1..2048.
SERVE_SLOTS, SERVE_T_MAX, SERVE_PAGE, SERVE_CHUNK = 8, 4096, 16, 64
SERVE_PAGES = SERVE_SLOTS * SERVE_T_MAX // SERVE_PAGE
SERVE_REQUESTS, SERVE_PROMPT, SERVE_QUEUE, SERVE_NEW = 24, 2048, 64, 256
SERVE_SEED = 0
# The sequence-sharded decode configuration: the recipe's decode module
# (DistributedDotProductAttn(key_dim=512, num_heads=8, num_kv_heads=4,
# causal=True, use_rope=True), head dim 64, bf16), batch 4, a global cache
# of 32768 columns over 4 ranks (slabs of 8192), a prompt of 3 * 8192 - 32
# rows, then 64 decode steps: rank 2 owns the first 32 appends, rank 3 the
# next 32, ranks 0 and 1 hold full slabs in the query's past.
DS_B, DS_KV, DS_T, DS_RANKS = 4, 4, 32768, 4
DS_LOCAL = DS_T // DS_RANKS
DS_STEPS, DS_WINDOW = 64, 1024
DS_PROMPT = 3 * DS_LOCAL - DS_STEPS // 2

# K5 vs its plain version, absolute: both round the output to bf16, a
# relative 2^-8 at most; with unit-normal values (|v| < ~5) that stays
# under 2e-2.
TOL_BF16 = 2e-2
# Greedy logits of the bf16 model vs the same weights in float32 on the
# CPU, max |Δ| over max |logit| at prompt 0's last position.
TOL_LM_REL = 0.1
# K1's row logsumexp vs its plain version, absolute (natural-log units):
# both sum the same float32 exp2 terms of float32 scores that differ only
# by accumulation order, so |Δ| stays at float32 rounding of lse values
# of magnitude ~10 (~1e-6); 1e-3 leaves room for the card's exp2f/log2f
# (2 ulp) and a different summation order over thousands of terms.
TOL_LSE = 1e-3
# K1's output and K3 / K4's gradients vs their plain versions, held on
# each row's own scale: a row (a query row of out and dq, a key row of dk
# and dv) is compared as ||kernel_r - plain_r|| / ||plain_r||, so a row
# that attends 4000 keys, whose values are ~100x smaller than a first
# row's, is held as tightly as that first row. Two readings per tensor:
# the largest such row error (catches a fault confined to a few rows,
# such as a dropped tile) and ||kernel - plain|| / ||plain|| over the
# whole tensor (catches a small error in every row, such as lost
# accumulator precision). Both versions round p and ds to bf16 before
# the same products and round the result to bf16 (2^-9 relative), so a
# sound kernel differs by float32 accumulation order, single bf16 flips
# and, under GQA, the plain version's per-head bf16 partials; K1's out
# also by its bf16 softmax weights against the plain version's float32
# ones. Each limit sits between the sound kernels' readings and those of
# the same kernels with a planted fault (scripts/torch_planted_faults.py:
# one diagonal tile dropped past tile 32, or an accumulator rounded to
# bf16 after every tile). On an H100 the sound kernels read at most
# ~5.5e-3 on a row and ~2.8e-3 whole (dk under GQA 4:1); every planted
# fault reads above 1.5e-2 on a row or 4.2e-3 whole in some case.
# PERF.md lists the readings.
TOL_ROW_REL = 1e-2
TOL_NORM_REL = 4e-3
# One training step of the 2-layer model, bf16 compute on the card vs
# float32 on the CPU from the same float32 weights. Loss: a mean of 512
# per-token losses of magnitude ~10 whose bf16 rounding errors (2^-9
# relative per rounded activation) are independent and average out, so
# the mean moves by ~1e-4 at most: bound 1e-3. Gradients, per tensor
# ||g_card - g_cpu|| / ||g_cpu||: each bf16 rounding of an activation on
# the forward and backward chains adds ~2^-9 relative error, some twenty
# in series through a block; the attention projections' gradients go
# through ds = p * (dp - delta), a difference of nearly equal terms at
# near-uniform attention, which magnifies that error several-fold (to
# ~2e-2); bound 5e-2.
TOL_REF_LOSS_REL = 1e-3
TOL_REF_GRAD_REL = 5e-2
TRAIN_KERNELS = ('flash_attention', 'flash_attention_dq',
                 'flash_attention_dkv')


def emit(obj):
    print(json.dumps(obj), flush=True)


# The RoPE LM's numbers of this call (train_path, main_path), printed
# beside the ALiBi LM's (alibi_lm).
SAME_CALL = {}


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def time_ms(torch, fn, flush, reps=30):
    """Median device time of ``fn`` over ``reps`` launches, CUDA events
    around each, L2 flushed before each (the main path finds the cache
    cold: 15 other layers' K/V pass through L2 between two calls). A
    ~1 ms device-side spin after the flush keeps the card busy while the
    host runs the wrapper's Python, so the events time the kernels and
    not the host's enqueue."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


# ``--parent DIR``: the root of another checkout of the repository (the
# parent commit's, unpacked beside this one) whose int8 K1, K3 and K4 are
# timed in the same run as this checkout's, at the same shapes.
PARENT = None
_PARENT_OPS = []


def parent_ops():
    """The ``--parent`` checkout's ``ops.flash_attention``, imported from
    its own files under the package's name with this checkout's modules set
    aside for the import, so that its wrappers pass its own arguments to
    its own libraries; those are built (all at once) on first use."""
    if not _PARENT_OPS:
        import importlib
        pkg = 'distributed_dot_product_tpu_torch'

        def ours(name):
            return name == pkg or name.startswith(pkg + '.')
        mine = {n: sys.modules.pop(n) for n in list(sys.modules) if ours(n)}
        sys.path.insert(0, PARENT)
        try:
            fa = importlib.import_module(pkg + '.ops.flash_attention')
        finally:
            sys.path.remove(PARENT)
            for n in [n for n in sys.modules if ours(n)]:
                del sys.modules[n]
            sys.modules.update(mine)
        fa._build.build_all()
        _PARENT_OPS.append(fa)
    return _PARENT_OPS[0]


def ab_ms(torch, make, fa, flush, reps=30):
    """``(ms, parent_ms)``: ``make(fa)``, the call to time made with this
    checkout's ops module ``fa``, timed as :func:`time_ms` and, with
    ``--parent``, ``make`` of the parent's (:func:`parent_ops`), in turns
    parent, this, this, parent (the mean of each pair); ``parent_ms`` is
    None without ``--parent``."""
    if PARENT is None:
        return time_ms(torch, make(fa), flush, reps), None
    fn, parent_fn = make(fa), make(parent_ops())
    mine, theirs = [], []
    for f, into in ((parent_fn, theirs), (fn, mine), (fn, mine),
                    (parent_fn, theirs)):
        into.append(time_ms(torch, f, flush, reps))
    return statistics.mean(mine), statistics.mean(theirs)


def rel_errs(torch, got, want, group=1):
    """``(largest row error, whole-tensor error)`` of ``got`` against
    ``want`` (rows along the last axis), in float32: the row error is
    ``||got_r - want_r|| / max(||want_r||, floor)``, the whole-tensor
    error the same over every element. ``floor`` is a hundredth of the
    root-mean-square row norm: a row that is zero in exact arithmetic
    (causal query row 0's dq, where the one weight is 1 and
    ``ds = dO.v - rowsum(dO*O)`` cancels; keys no query sees) holds only
    the kernel's float32 rounding, which must stay small on the tensor's
    own scale. ``group``: each ``group`` consecutive rows (zero rows
    appended to fill the last) are taken as one."""
    diff = (got.float() - want.float()).flatten(0, -2)
    ref = want.float().flatten(0, -2)
    if group > 1:
        pad = -diff.shape[0] % group
        diff, ref = (torch.nn.functional.pad(x, (0, 0, 0, pad))
                     .reshape(-1, group * x.shape[1]) for x in (diff, ref))
    vnorm = torch.linalg.vector_norm
    ref_rows = vnorm(ref, dim=-1)
    floor = 1e-2 * ref_rows.square().mean().sqrt().clamp_min(1e-30)
    rows = vnorm(diff, dim=-1) / torch.maximum(ref_rows, floor)
    whole = vnorm(diff) / vnorm(ref).clamp_min(1e-30)
    return rows.max().item(), whole.item()


def check_rel(errs, what):
    """Failure messages for ``errs = {tensor: (row, whole)}`` (NaN
    fails)."""
    out = []
    for n, (row, whole) in errs.items():
        if not row <= TOL_ROW_REL:
            out.append(f'{what} {n}: row rel err {row} > {TOL_ROW_REL}')
        if not whole <= TOL_NORM_REL:
            out.append(f'{what} {n}: rel err {whole} > {TOL_NORM_REL}')
    return out


def perf():
    """The port's ``obs/perf.py``: the card's peak rates
    (``DEFAULT_PEAKS``, H100 SXM) and each kernel's operation and byte
    formula, shared with ``python -m distributed_dot_product_tpu_torch.obs
    .perf`` so a kernel's bound reads the same work in both."""
    from distributed_dot_product_tpu_torch.obs import perf as _perf
    return _perf


def bound_ms(flops, nbytes):
    peaks = perf().DEFAULT_PEAKS
    t_ops, t_bytes = flops / peaks.flops_per_s, nbytes / peaks.bytes_per_s
    return 1e3 * max(t_ops, t_bytes), ('operations' if t_ops > t_bytes
                                       else 'bytes')


def kernel_label(name):
    """A mangled kernel name as ``flash_bwd_dkv_kernel<96,0,bf16,1,1>``
    where its template arguments are integers, flags and the output types
    bf16 / f32, else from its last ``flash_`` on."""
    m = re.search(r'(flash_\w*?kernel)I', name)
    if m:
        rest, args = name[m.end():], []
        while True:
            t = re.match(r'L[ib](-?\d+)E|13__nv_bfloat16|f', rest)
            if t is None:
                break
            args.append(t.group(1) or ('f32' if t.group(0) == 'f'
                                       else 'bf16'))
            rest = rest[t.end():]
        if args and rest.startswith('E'):
            label = m.group(1)
            return f'{label[label.rfind("flash_"):]}<{",".join(args)}>'
    short = re.findall(r'flash_\w+', name)
    return short[-1] if short else name


def build_resources(build):
    """Per library, ``ptxas -v``'s most registers a kernel uses, the
    kernels that spill (their spill bytes, stored + loaded) and every
    kernel's registers and spill bytes."""
    out = {}
    for lib in build.SOURCES:
        res = build.resources(lib)
        spilling = {kernel_label(name): spill
                    for name, (_, spill) in res.items() if spill}
        out[lib] = {'kernels': len(res),
                    'max_registers': max((r for r, _ in res.values()),
                                         default=None),
                    'spilling': spilling,
                    'registers_spills': {kernel_label(name): list(rs)
                                         for name, rs in res.items()}}
    return out


def smem_bytes(build):
    """The dynamic shared memory of a K1, a K3 and a K4 block at each
    (d, d_v) pair of the kernels' grid, in bytes: the bf16 Ext
    instantiation and the int8 ones (K1's alone and with the Ext
    features, K3's and K4's with them)."""
    import ctypes
    from distributed_dot_product_tpu_torch.ops.flash_attention import (
        _KERNEL_GRID,
    )
    out = {}
    for kern, lib, symbol in (('k1', 'flash_fwd_ext', 'flash_fwd_smem_bytes'),
                              ('k3', 'flash_bwd_dq_ext',
                               'flash_bwd_dq_smem_bytes'),
                              ('k4', 'flash_bwd_dkv_ext',
                               'flash_bwd_dkv_smem_bytes')):
        fn = getattr(build.load(lib), symbol)
        fn.argtypes, fn.restype = [ctypes.c_int] * 4, ctypes.c_longlong
        for d, dv in _KERNEL_GRID:
            out[f'{kern}_d{d}_dv{dv}'] = {
                'ext': fn(d, dv, 1, 0), 'int8_ext': fn(d, dv, 1, 1),
                **({'int8': fn(d, dv, 0, 1)} if kern == 'k1' else {})}
    return out


def randn(torch, shape, gen, dev, dtype):
    return torch.randn(shape, generator=gen).to(device=dev, dtype=dtype)


def phase_flash(torch, ddp, flush, gen):
    from distributed_dot_product_tpu_torch.ops.flash_attention import (
        flash_attention_plain,
    )
    F = torch.nn.functional
    dev, bf16 = torch.device('cuda'), torch.bfloat16
    scale = 1.0 / math.sqrt(HEAD_DIM)
    results, worst, worst_rel = {}, 0.0, 0.0
    # (name, q heads, kv heads, Tq, Tk, filled rows, causal offset or
    # None for no causal mask)
    cases = [('prefill', HEADS, HEADS, PROMPT, T_MAX, PROMPT, 0),
             ('ragged_offset', HEADS, HEADS, 77, T_MAX, 1077, 1000),
             ('gqa_ragged', HEADS, 2, 333, T_MAX, 700, 367),
             ('full_ragged', HEADS, HEADS, 50, 300, 300, None)]
    for name, hq, hkv, tq, tk, filled, off in cases:
        causal = off is not None
        off = off or 0
        q = randn(torch, (BATCH, hq, tq, HEAD_DIM), gen, dev, bf16)
        k = torch.zeros((BATCH, hkv, tk, HEAD_DIM), dtype=bf16, device=dev)
        v = torch.zeros_like(k)
        k[:, :, :filled] = randn(torch, (BATCH, hkv, filled, HEAD_DIM), gen,
                                 dev, bf16)
        v[:, :, :filled] = randn(torch, (BATCH, hkv, filled, HEAD_DIM), gen,
                                 dev, bf16)
        out = ddp.flash_attention(q, k, v, causal=causal,
                                  causal_offset=off, scale=scale)
        ref = flash_attention_plain(q, k, v, causal=causal,
                                    causal_offset=off, scale=scale)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        row_rel, rel = rel_errs(torch, out, ref)
        row = {'phase': 'flash_attention', 'case': name,
               'q': list(q.shape), 'kv': list(k.shape), 'causal': causal,
               'causal_offset': off, 'max_abs_err': err,
               'max_row_rel_err': row_rel, 'rel_err': rel,
               'tol': {'row_rel': TOL_ROW_REL, 'rel': TOL_NORM_REL}}
        fails = check_rel({'out': (row_rel, rel)}, f'K1 {name}')
        if not torch.isfinite(out).all().item():
            fails.append(f'K1 {name}: non-finite')
        if fails:                  # the readings first, then the failure
            emit(row)
        check(not fails, '; '.join(fails))
        # Bound and library call over the key columns this run needs.
        nb = BATCH * hq
        if causal:
            pairs = sum(min(tk, off + i + 1) for i in range(tq))
            kv_rows = min(tk, off + tq)
        else:
            pairs, kv_rows = tq * tk, tk
        flops, nbytes = perf().attention_fwd_cost(
            d=HEAD_DIM, q_rows=nb * tq, kv_rows=BATCH * hkv * kv_rows,
            pairs=pairs * nb)
        bms, by = bound_ms(flops, nbytes)
        kf, vf = k[:, :, :kv_rows], v[:, :, :kv_rows]
        lib_kw = {'scale': scale, 'enable_gqa': hq != hkv}
        if causal and (off or tq != kv_rows):
            rows = off + torch.arange(tq, device=dev)
            lib_kw['attn_mask'] = (torch.arange(kv_rows, device=dev)[None, :]
                                   <= rows[:, None])
        else:
            lib_kw['is_causal'] = causal
        row.update(
            ms=time_ms(torch, lambda: ddp.flash_attention(
                q, k, v, causal=causal, causal_offset=off, scale=scale),
                flush),
            plain_ms=time_ms(torch, lambda: flash_attention_plain(
                q, k, v, causal=causal, causal_offset=off, scale=scale),
                flush, reps=10),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, kf, vf, **lib_kw), flush),
            bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes)
        if name == 'prefill':
            results = row
        worst = max(worst, err)
        worst_rel = max(worst_rel, row_rel)
        emit(row)
    edge_worst = flash_edges(torch, gen)
    results.update(max_abs_err=max(worst, edge_worst['abs']),
                   max_row_rel_err=max(worst_rel, edge_worst['row_rel']),
                   edges=edge_worst)
    return results


# The forward kernels' edges, at every head dim they are built for: (name,
# batch, q heads, kv heads, Tq, Tk, causal offset or None for no causal
# mask, filled Tk rows or None): lengths crossing the 64- and 128-row
# tiles, GQA 4, a prefill (Tq < Tk) at an offset whose rows attend a zero
# tail, an offset that leaves more than a whole 64-row tile without a key,
# and a ragged non-causal GQA 4 fold.
EDGE_DIMS = (32, 64, 96, 128)
EDGE_CASES = (('tiles_129', 2, 8, 8, 129, 129, 0, None),
              ('tiles_191', 2, 8, 8, 191, 191, 0, None),
              ('gqa_4', 2, 8, 2, 200, 200, 0, None),
              ('prefill_tail', 2, 8, 8, 300, 1000, 600, 400),
              ('offset_no_key', 2, 8, 8, 200, 150, -130, None),
              ('full_ragged_gqa_4', 2, 8, 2, 77, 333, None, None))


def flash_edges(torch, gen):
    """K1 (with its lse) and K2 (the bounded forward, with its lse) at
    EDGE_CASES x EDGE_DIMS and with the MASK_EDGES masks against their
    plain versions: out on each row's scale and whole, lse within TOL_LSE,
    rows with no attendable key exactly 0 (K1's lse exactly ln2*NEG_BIG),
    and each launched twice on the same inputs, bit for bit. Returns the
    worst readings."""
    import importlib
    fa = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_attention')
    dev, bf16 = torch.device('cuda'), torch.bfloat16
    neg = fa._LN2 * fa._NEG_BIG
    worst = {'abs': 0.0, 'row_rel': 0.0, 'rel': 0.0, 'lse': 0.0}
    failures = []

    def hold(row, q, k, v, mask, kw, empty):
        """Both kernels on one case; ``empty`` marks the (batch, head, row)
        entries with no attendable key."""
        runs = {
            'k1': lambda: fa.flash_attention_with_lse(q, k, v, mask, **kw),
            'k2': lambda: fa.flash_attention_bounded(q, k, v, mask,
                                                     save_lse=True, **kw)}
        plain = {'k1': fa.flash_attention_plain_lse,
                 'k2': fa.flash_attention_bounded_plain_lse}
        for kern, run in runs.items():
            out, lse = run()
            out2, lse2 = run()
            out_p, lse_p = plain[kern](q, k, v, mask, **kw)
            torch.cuda.synchronize()
            err = (out.float() - out_p.float()).abs().max().item()
            row_rel, rel = rel_errs(torch, out, out_p)
            lse_err = (lse - lse_p).abs().max().item()
            same = bool(torch.equal(out, out2) and torch.equal(lse, lse2))
            exact = bool(not out[empty].any().item() and (
                kern == 'k2' or (lse[empty] == neg).all().item()))
            row[kern] = {'max_abs_err': err, 'max_row_rel_err': row_rel,
                         'rel_err': rel, 'lse_max_abs_err': lse_err,
                         'repeat_bitwise': same, 'empty_rows_exact': exact}
            what = f"{kern.upper()} {row['case']}"
            if not (torch.isfinite(out).all().item()
                    and torch.isfinite(lse).all().item()):
                failures.append(f'{what}: non-finite')
            failures.extend(check_rel({'out': (row_rel, rel)}, what))
            if not lse_err <= TOL_LSE:
                failures.append(f'{what}: lse abs err {lse_err} > {TOL_LSE}')
            if not exact:
                failures.append(f'{what}: rows with no key are not exactly '
                                f'0 (K1: lse ln2*NEG_BIG)')
            if not same:
                failures.append(f'{what}: two launches differ')
            for key, val in (('abs', err), ('row_rel', row_rel),
                             ('rel', rel), ('lse', lse_err)):
                worst[key] = max(worst[key], val)
        row['tol'] = {'row_rel': TOL_ROW_REL, 'rel': TOL_NORM_REL,
                      'lse': TOL_LSE}
        emit(row)

    for d in EDGE_DIMS:
        scale = 1.0 / math.sqrt(d)
        for name, b, hq, hkv, tq, tk, off, filled in EDGE_CASES:
            causal = off is not None
            off = off or 0
            q = randn(torch, (b, hq, tq, d), gen, dev, bf16)
            k = randn(torch, (b, hkv, tk, d), gen, dev, bf16)
            v = randn(torch, (b, hkv, tk, d), gen, dev, bf16)
            if filled is not None:
                k[:, :, filled:] = 0
                v[:, :, filled:] = 0
            # Rows at global positions before key 0 attend nothing.
            empty = torch.zeros((b, hq, tq), dtype=torch.bool, device=dev)
            if causal:
                empty[..., torch.arange(tq, device=dev) + off < 0] = True
            hold({'phase': 'flash_attention', 'case': f'{name}_d{d}',
                  'q': list(q.shape), 'kv': list(k.shape), 'causal': causal,
                  'causal_offset': off, 'filled': filled,
                  'empty_rows': int(empty[0, 0].sum().item())},
                 q, k, v, None, dict(causal=causal, causal_offset=off,
                                     scale=scale), empty)
    for name, width, start, tq, tk, causal in MASK_EDGES:
        d, hq, hkv = 64, 8, 2
        q = randn(torch, (2, hq, tq, d), gen, dev, bf16)
        k = randn(torch, (2, hkv, tk, d), gen, dev, bf16)
        v = randn(torch, (2, hkv, tk, d), gen, dev, bf16)
        wide = torch.rand((2, 1, tq, width), generator=gen) < 0.3
        wide[:, :, ::7] = True                    # every 7th row masked
        mask = wide.to(dev)[..., start:start + tk]
        empty = mask.all(dim=-1).expand(2, hq, tq).clone()
        hold({'phase': 'flash_attention', 'case': name, 'q': list(q.shape),
              'kv': list(k.shape), 'causal': causal,
              'mask': {'shape': list(mask.shape),
                       'strides': list(mask.stride()),
                       'first_column': start},
              'empty_rows': int(empty[0, 0].sum().item())},
             q, k, v, mask, dict(causal=causal, scale=1.0 / math.sqrt(d)),
             empty)
    check(not failures, '; '.join(failures))
    return worst


# A dense mask at each width the forward kernels copy it with: (name, mask
# row width, first column of the slice passed, Tq, Tk, causal): rows of 333
# bytes (no aligned copy: read a byte at a time), a column slice starting
# at byte 4 (4-byte copies) and at byte 8 (8-byte copies) of 512-byte rows,
# a ragged 16-byte-aligned one with causal masking.
MASK_EDGES = (('mask_bytes', 333, 0, 77, 333, False),
              ('mask_w4', 512, 4, 77, 300, False),
              ('mask_w8', 512, 8, 130, 400, False),
              ('mask_w16_causal', 256, 0, 191, 191, True))


def phase_decode(torch, ddp, flush, gen):
    from distributed_dot_product_tpu_torch.ops.flash_decode import (
        flash_decode_plain,
    )
    F = torch.nn.functional
    dev, bf16 = torch.device('cuda'), torch.bfloat16
    scale = 1.0 / math.sqrt(HEAD_DIM)
    shape_q = (BATCH, HEADS, 1, HEAD_DIM)

    def make(valid_to, append_at):
        q = randn(torch, shape_q, gen, dev, bf16)
        kn = randn(torch, shape_q, gen, dev, bf16)
        vn = randn(torch, shape_q, gen, dev, bf16)
        # Filled rows unit-normal; past the fill, large garbage the mask
        # must keep out of every score.
        ck = 30.0 * randn(torch, (BATCH, HEADS, T_MAX, HEAD_DIM), gen, dev,
                          bf16)
        cv = 30.0 * randn(torch, (BATCH, HEADS, T_MAX, HEAD_DIM), gen, dev,
                          bf16)
        for b, (vt, ap) in enumerate(zip(valid_to, append_at)):
            n = max(vt if ap == vt else vt + 1, 0)   # the append fills vt
            ck[b, :, :n] = randn(torch, (HEADS, n, HEAD_DIM), gen, dev, bf16)
            cv[b, :, :n] = randn(torch, (HEADS, n, HEAD_DIM), gen, dev, bf16)
        vt = torch.tensor(valid_to, dtype=torch.int32, device=dev)
        ap = torch.tensor(append_at, dtype=torch.int32, device=dev)
        return q, kn, vn, ck, cv, vt, ap

    # Mixed fill: two mid-generation rows, a first token on an empty
    # cache, and a frozen row that appends nothing.
    q, kn, vn, ck, cv, vt, ap = make([999, 1062, 0, 516], [999, 1062, 0, -1])
    ck2, cv2 = ck.clone(), cv.clone()
    out, _, _ = ddp.flash_decode(q, kn, vn, ck, cv, vt, ap, scale=scale)
    ref, _, _ = flash_decode_plain(q, kn, vn, ck2, cv2, vt, ap, scale=scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    same = bool(torch.equal(ck, ck2) and torch.equal(cv, cv2))
    row = {'phase': 'flash_decode', 'case': 'mixed_fill',
           'valid_to': vt.tolist(), 'append_at': ap.tolist(),
           'max_abs_err': err, 'tol': TOL_BF16,
           'cache_bit_identical': same}
    emit(row)
    check(torch.isfinite(out).all().item(), 'K5: non-finite output')
    check(err <= TOL_BF16, f'K5: max abs err {err} > {TOL_BF16}')
    check(same, 'K5: appended cache differs from the plain append')

    # Timing at the main path's shape: every row mid-generation.
    fill = PROMPT + STEPS // 2
    q, kn, vn, ck, cv, vt, ap = make([fill] * BATCH, [fill] * BATCH)
    cols = fill + 1
    bh = BATCH * HEADS
    # The cached K and V rows read; q and out; k_new / v_new read; the
    # appended row written.
    flops, nbytes = perf().decode_cost(
        d=HEAD_DIM, q_rows=bh, new_rows=bh, rows_read=bh * (cols - 1),
        rows_appended=bh, cols=bh * cols)
    bms, by = bound_ms(flops, nbytes)
    mask = (torch.arange(T_MAX, device=dev)[None, :] <= vt[:, None].long())
    mask = mask[:, None, None, :]
    ck2, cv2, ck3, cv3 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    out, _, _ = ddp.flash_decode(q, kn, vn, ck, cv, vt, ap, scale=scale)
    ref, _, _ = flash_decode_plain(q, kn, vn, ck2, cv2, vt, ap, scale=scale)
    again, _, _ = ddp.flash_decode(q, kn, vn, ck3, cv3, vt, ap, scale=scale)
    torch.cuda.synchronize()
    err2 = (out.float() - ref.float()).abs().max().item()
    check(err2 <= TOL_BF16, f'K5 uniform fill: max abs err {err2}')
    check(torch.equal(ck, ck2) and torch.equal(cv, cv2),
          'K5 uniform fill: appended cache differs from the plain append')
    check(torch.equal(out, again), 'K5 uniform fill: a second launch on '
                                   'the same inputs gave other bits')
    row = {'phase': 'flash_decode', 'case': 'main_shape', 'fill': fill,
           'max_abs_err': max(err, err2), 'tol': TOL_BF16,
           'repeat_bit_identical': True,
           'ms': time_ms(torch, lambda: ddp.flash_decode(
               q, kn, vn, ck, cv, vt, ap, scale=scale), flush),
           'plain_ms': time_ms(torch, lambda: flash_decode_plain(
               q, kn, vn, ck2, cv2, vt, ap, scale=scale), flush),
           'library_ms': time_ms(torch, lambda: F.scaled_dot_product_attention(
               q, ck, cv, attn_mask=mask, scale=scale), flush),
           'bound_ms': bms, 'bound_by': by, 'flops': flops, 'bytes': nbytes}
    check_one_kernel(torch, row, 'K5 main shape', lambda: ddp.flash_decode(
        q, kn, vn, ck, cv, vt, ap, scale=scale))
    emit(row)
    row['edges'] = decode_edges(torch, gen)
    row['variants'] = decode_variants(torch, ddp, flush, gen)
    row['variants']['alibi'] = alibi_decode_variants(torch, flush, gen,
                                                     paged=False)
    return row


def _filled_slab(torch, gen, dev, t, fill):
    """A (DS_B, DS_KV, t, 64) bf16 slab: unit-normal rows below ``fill``,
    large garbage past it that the mask must keep out."""
    shape = (DS_B, DS_KV, t, 64)
    x = 30.0 * randn(torch, shape, gen, dev, torch.bfloat16)
    n = min(max(fill, 0), t)
    x[:, :, :n] = randn(torch, (DS_B, DS_KV, n, 64), gen, dev,
                        torch.bfloat16)
    return x


def _decode_errs(torch, got, want, rel=rel_errs):
    """``({tensor: (row, whole)}, max abs err, finite)`` of a decode
    kernel's result against its plain version's: the output, or the
    partials (num, m, l) each on its rows' own scale (``rel``: the
    reading, :func:`rel_errs` or kernel_coverage's :func:`_cov_rel`)."""
    if not isinstance(got, tuple):
        got, want, names = (got,), (want,), ('out',)
    else:
        names = ('num', 'm', 'l')
    errs = {n: rel(torch, g, w) for n, g, w in zip(names, got, want)}
    err = max((g.float() - w.float()).abs().max().item()
              for g, w in zip(got, want))
    return errs, err, all(torch.isfinite(g).all().item() for g in got)


def kernels_per_call(torch, fn):
    """``(kernels, decode kernels)`` the card ran for one call of ``fn``,
    by torch.profiler's device events (copies and fills apart): a
    flash_decode call runs one kernel, the decode kernel, and nothing
    else (no scratch, no merge pass, no quantization). A session that
    recorded no device event at all (the profiler lost its trace: the
    call's results were checked before) is taken again, seven times at
    most, a moment apart."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(8):
        if attempt:
            time.sleep(0.2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if str(e.device_type).endswith('CUDA')
                 and not e.name.startswith(('Memcpy', 'Memset'))]
        if names:
            break
    return len(names), sum('flash_decode_kernel' in n for n in names)


def check_one_kernel(torch, row, what, fn):
    """Records on ``row`` and checks that one call of ``fn`` ran exactly
    one kernel on the card, the decode kernel."""
    total, decode = kernels_per_call(torch, fn)
    row['kernels_per_call'] = total
    row['decode_kernels_per_call'] = decode
    check(total == 1 and decode == 1,
          f'{what}: one call ran {total} kernels, {decode} of them the '
          f'decode kernel (must be exactly one)')


def paged_twin(torch, gen, slab_k, slab_v, ps):
    """A scrambled page pool of page ``ps`` that holds the slab's rows
    (the slab padded with large garbage to whole pages), every page
    allocated, and its table: ``(k_pool, v_pool, table)``; the sink page
    holds garbage."""
    b, h_kv, t, _ = slab_k.shape
    pps = -(-t // ps)
    perm = torch.randperm(b * pps, generator=gen)
    table = perm.reshape(b, pps).to(torch.int32).to(slab_k.device)
    pools = []
    for x in (slab_k, slab_v):
        d = x.shape[-1]
        pad = 30.0 * randn(torch, (b, h_kv, pps * ps - t, d), gen,
                           x.device, x.dtype)
        pages = torch.cat([x, pad], dim=2).reshape(b, h_kv, pps, ps, d)
        pages = pages.transpose(1, 2).reshape(b * pps, h_kv, ps, d)
        pool = 30.0 * randn(torch, (b * pps + 1, h_kv, ps, d), gen,
                            x.device, x.dtype)
        pool[perm.to(x.device)] = pages
        pools.append(pool)
    return pools[0], pools[1], table


# K5/K5p at their edges (flash_decode): per case, the slab's columns, the
# window and per slot (rows filled before the step, rows it appends; None
# = an inactive slot). t_max_200: a t_max that is no multiple of 128 (or
# 64), the step ending on its last row, rows straddling the first chunk's
# end, a first token, an inactive slot; window_mid_chunk: a window of 100
# whose start falls inside a chunk; one_chunk: every slot's span inside
# one chunk. At every kernel head dim, GQA 8:2 (a verify launch's 20 rows
# take two passes of 16, a one-row launch's 4 one), one new row and k = 5.
DECODE_EDGES = (('t_max_200', 200, None, ((195, 5), (124, 5), (0, 1),
                                          (60, None))),
                ('window_mid_chunk', 1000, 100, ((995, 5), (700, 3),
                                                 (150, None), (40, 2))),
                ('one_chunk', 384, 45, ((300, 5), (2, 4), (120, 5),
                                        (380, None))))
EDGE_PAGES = (16, 256)


def decode_edges(torch, gen):
    """K5 and K5p at ``DECODE_EDGES`` x head dims 32/64/96/128, one new
    row and verify k = 5: the output within tolerance of the plain
    version, the cache bit for bit its append, a second launch bit for
    bit the first, verify bit for bit the sequential one-row launches;
    K5p on a scrambled pool of the same rows at pages 16 and 256 bit for
    bit K5 on the gathered slab and within tolerance of its plain
    version, its pool bit for bit the plain append's but the sink."""
    import importlib
    fd = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_decode')
    dev, h, h_kv = torch.device('cuda'), 8, 2
    worst = {'max_abs_err': 0.0, 'max_row_rel_err': 0.0, 'rel_err': 0.0}
    for name, t, window, slots in DECODE_EDGES:
        for d in EDGE_DIMS:
            for k in (1, VERIFY_K):
                sl = _one_row(slots) if k == 1 else slots
                vt, ap, nn = _verify_vectors(torch, sl, k, dev)
                q, kn, vn, ck, cv = _verify_slab(torch, gen, dev, sl, h,
                                                 h_kv, d, t)
                q, kn, vn = (x[:, :, :k].contiguous() for x in (q, kn, vn))
                base = dict(scale=1.0 / math.sqrt(d), window=window)
                kw = dict(base, n_new=nn)
                c = [(ck.clone(), cv.clone()) for _ in range(4)]
                out = fd.flash_decode(q, kn, vn, *c[0], vt, ap, **kw)[0]
                again = fd.flash_decode(q, kn, vn, *c[1], vt, ap, **kw)[0]
                ref = fd.flash_decode_plain(q, kn, vn, *c[2], vt, ap,
                                            **kw)[0]
                seq = _sequential(torch, fd, q, kn, vn, *c[3], vt, ap, nn,
                                  **base)
                torch.cuda.synchronize()
                errs, err, finite = _decode_errs(torch, out, ref)
                row = {'phase': 'flash_decode', 'case': f'edge_{name}',
                       't_max': t, 'window': window, 'head_dim': d, 'k': k,
                       'valid_to': vt.tolist(), 'n_new': nn.tolist(),
                       'max_abs_err': err,
                       'max_row_rel_err': errs['out'][0],
                       'rel_err': errs['out'][1],
                       'cache_bit_identical': all(
                           torch.equal(x, y) for x, y in zip(c[0], c[2])),
                       'repeat_bit_identical': _same(torch, out, again),
                       'equals_sequential': _same(torch, out, seq)}
                fails = check_rel(errs, f'K5 edge {name} d {d} k {k}')
                row['pages'] = {}
                for ps in EDGE_PAGES:
                    kp, vp, table = paged_twin(torch, gen, ck, cv, ps)
                    kp2, vp2 = kp.clone(), vp.clone()
                    slab = [fd.gather_pages(x, table) for x in (kp, vp)]
                    pkw = dict(kw, page_table=table)
                    got = fd.flash_decode(q, kn, vn, kp, vp, vt, ap,
                                          **pkw)[0]
                    want = fd.flash_decode_plain(q, kn, vn, kp2, vp2, vt,
                                                 ap, **pkw)[0]
                    on_slab = fd.flash_decode(q, kn, vn, *slab, vt, ap,
                                              **kw)[0]
                    torch.cuda.synchronize()
                    perrs, perr, pfinite = _decode_errs(torch, got, want)
                    fails += check_rel(perrs, f'K5p edge {name} d {d} k {k} '
                                              f'page {ps}')
                    finite = finite and pfinite
                    row['pages'][ps] = {
                        'max_abs_err': perr,
                        'max_row_rel_err': perrs['out'][0],
                        'equals_k5_on_gathered_slab': _same(torch, got,
                                                            on_slab),
                        'pools_bit_identical_but_sink': bool(
                            torch.equal(kp[:-1], kp2[:-1])
                            and torch.equal(vp[:-1], vp2[:-1]))}
                emit(row)
                check(finite, f'K5 edge {name} d {d} k {k}: non-finite')
                check(not fails, '; '.join(fails))
                for key in ('cache_bit_identical', 'repeat_bit_identical',
                            'equals_sequential'):
                    check(row[key], f'K5 edge {name} d {d} k {k}: {key} is '
                                    f'False')
                for ps, prow in row['pages'].items():
                    for key in ('equals_k5_on_gathered_slab',
                                'pools_bit_identical_but_sink'):
                        check(prow[key], f'K5p edge {name} d {d} k {k} page '
                                         f'{ps}: {key} is False')
                worst['max_abs_err'] = max(worst['max_abs_err'], err)
                worst['max_row_rel_err'] = max(worst['max_row_rel_err'],
                                                errs['out'][0])
                worst['rel_err'] = max(worst['rel_err'], errs['out'][1])
    return worst


def _decode_library(torch, partials, flush, call, what):
    """``library_ms`` and ``library`` of a decode case: ``call`` timed,
    or none for the partial outputs."""
    if partials:
        return dict(library_ms=None, library=(
            'none: no PyTorch call returns the un-normalised numerator '
            'with the base-2 max and denominator'))
    return dict(library_ms=time_ms(torch, call, flush), library=what)


def decode_variants(torch, ddp, flush, gen):
    """K5's partial outputs and window against their plain versions at the
    sequence-sharded decode shapes: a rank's 8192-column slab wholly in the
    query's past, the owner's slab (query inside it), a slab wholly in the
    future (rows exactly empty: 0, _NEG_BIG, 0), a window of 1024 past the
    slab; and the window on the local twin's 32768-column cache. Each with
    ms, plain ms, the bound and SDPA over the same columns."""
    import importlib
    fd = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_decode')
    F = torch.nn.functional
    dev, bf16 = torch.device('cuda'), torch.bfloat16
    scale = 1.0 / math.sqrt(64)
    heads = SP_HEADS
    # name: (slab columns, valid_to, append_at, window, partials)
    cases = (('partials_past_slab', DS_LOCAL, DS_PROMPT, -1, None, True),
             ('partials_owner', DS_LOCAL, DS_PROMPT - 2 * DS_LOCAL,
              DS_PROMPT - 2 * DS_LOCAL, None, True),
             ('partials_future', DS_LOCAL, DS_PROMPT - 3 * DS_LOCAL, -1, None,
              True),
             ('partials_window_past', DS_LOCAL, DS_LOCAL + DS_WINDOW // 2,
              -1, DS_WINDOW, True),
             ('window', DS_T, DS_PROMPT, DS_PROMPT, DS_WINDOW, False))
    out_rows = {}
    for name, t, vt0, ap0, window, partials in cases:
        q = randn(torch, (DS_B, heads, 1, 64), gen, dev, bf16)
        kn = randn(torch, (DS_B, DS_KV, 1, 64), gen, dev, bf16)
        vn = randn(torch, (DS_B, DS_KV, 1, 64), gen, dev, bf16)
        fill = vt0 if ap0 == vt0 else vt0 + 1
        ck = _filled_slab(torch, gen, dev, t, fill)
        cv = _filled_slab(torch, gen, dev, t, fill)
        ck2, cv2 = ck.clone(), cv.clone()
        vt = torch.full((DS_B,), vt0, dtype=torch.int32, device=dev)
        ap = torch.full((DS_B,), ap0, dtype=torch.int32, device=dev)
        kw = dict(scale=scale, window=window, partials=partials)
        got, _, _ = fd.flash_decode(q, kn, vn, ck, cv, vt, ap, **kw)
        want, _, _ = fd.flash_decode_plain(q, kn, vn, ck2, cv2, vt, ap, **kw)
        torch.cuda.synchronize()
        same = bool(torch.equal(ck, ck2) and torch.equal(cv, cv2))
        errs, err, finite = _decode_errs(torch, got, want)
        row = {'phase': 'flash_decode', 'case': name, 'slab': [
            DS_B, DS_KV, t, 64], 'heads': heads, 'valid_to': vt0,
            'append_at': ap0, 'window': window, 'partials': partials,
            'max_abs_err': err,
            'max_row_rel_err': {n: e[0] for n, e in errs.items()},
            'rel_err': {n: e[1] for n, e in errs.items()},
            'tol': {'row_rel': TOL_ROW_REL, 'rel': TOL_NORM_REL},
            'cache_bit_identical': same}
        check(finite, f'K5 {name}: non-finite output')
        fails = check_rel(errs, f'K5 {name}')
        check(not fails, '; '.join(fails))
        check(same, f'K5 {name}: appended cache differs from the plain '
                    f'append')
        if name == 'partials_future':
            num, m, l = got
            empty = (not num.any().item() and not l.any().item()
                     and bool((m == fd._NEG_BIG).all().item()))
            row['rows_exactly_empty'] = empty
            check(empty, 'K5 partials_future: rows are not exactly (0, '
                         '_NEG_BIG, 0)')
        # The columns this run attends, its bound, and SDPA over them.
        cols = torch.arange(t, device=dev)
        lo = 0 if window is None else vt0 - window + 1
        allowed = (cols <= vt0) & (cols >= lo)
        n_cols = int(allowed.sum().item())
        flops, nbytes = perf().decode_cost(
            d=64, q_rows=DS_B * heads, new_rows=DS_B * DS_KV,
            rows_read=DS_B * DS_KV * n_cols, rows_appended=DS_B * DS_KV,
            cols=n_cols * DS_B * heads,
            out_row_bytes=(64 + 2) * 4 if partials else None)
        bms, by = bound_ms(flops, nbytes)
        mask = allowed[None, None, None, :].expand(DS_B, 1, 1, t)
        check_one_kernel(torch, row, f'K5 {name}', lambda: fd.flash_decode(
            q, kn, vn, ck, cv, vt, ap, **kw))
        row.update(
            ms=time_ms(torch, lambda: fd.flash_decode(
                q, kn, vn, ck, cv, vt, ap, **kw), flush),
            plain_ms=time_ms(torch, lambda: fd.flash_decode_plain(
                q, kn, vn, ck2, cv2, vt, ap, **kw), flush, reps=10),
            bound_ms=bms, bound_by=by, flops=flops, bytes=nbytes,
            attended_columns=n_cols, **_decode_library(
                torch, partials, flush, lambda: F.scaled_dot_product_attention(
                    q, ck, cv, attn_mask=mask, scale=scale, enable_gqa=True),
                'sdpa over the same columns'
                + (' with the window mask' if window else '')))
        emit(row)
        out_rows[name] = {k: row[k] for k in (
            'ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by',
            'max_abs_err', 'max_row_rel_err', 'rel_err')}
        del q, kn, vn, ck, cv, ck2, cv2, got, want
        torch.cuda.empty_cache()
    return out_rows


def paged_case(torch, gen, dev):
    """The serving shape's paged cache with mixed fill and a scrambled
    table: (q, k_new, v_new, k_pool, v_pool, valid_to, append_at, table,
    the sets of distinct pool rows each slot reads). Slots: mid-generation,
    empty (table row all -1, valid_to -1), frozen (append_at -1), appending
    on a page boundary, two sharing a 640-row prefix (40 pages), a long
    and a short one. Unallocated pages and the sink hold large garbage."""
    bf16, ps, pps = torch.bfloat16, SERVE_PAGE, SERVE_T_MAX // SERVE_PAGE
    fills = [1500, 0, 778, 2048, 700, 1000, 4000, 5]   # rows before the step
    active = [True, False, False, True, True, True, True, True]
    valid_to = [f if a else f - 1 for f, a in zip(fills, active)]
    append_at = [f if a else -1 for f, a in zip(fills, active)]
    perm = torch.randperm(SERVE_PAGES, generator=gen).tolist()
    table = torch.full((SERVE_SLOTS, pps), -1, dtype=torch.int32)
    shared = perm[:40]
    nxt = 40
    for b, (f, a) in enumerate(zip(fills, active)):
        n = -(-(f + (1 if a else 0)) // ps)
        own = shared[:n] if b in (4, 5) else []
        need = n - len(own)
        table[b, :n] = torch.tensor(own + perm[nxt:nxt + need],
                                    dtype=torch.int32)
        nxt += need
    shape = (SERVE_PAGES + 1, HEADS, ps, HEAD_DIM)
    k_pool = 30.0 * randn(torch, shape, gen, dev, bf16)
    v_pool = 30.0 * randn(torch, shape, gen, dev, bf16)
    rows = [{(int(table[b, c // ps]), c % ps) for c in range(f)}
            for b, f in enumerate(fills)]
    filled = sorted(set().union(*rows))
    pg, r = (torch.tensor(x, device=dev) for x in zip(*filled))
    unit = (len(filled), HEADS, HEAD_DIM)
    k_pool[pg, :, r] = randn(torch, unit, gen, dev, bf16)
    v_pool[pg, :, r] = randn(torch, unit, gen, dev, bf16)
    shape_q = (SERVE_SLOTS, HEADS, 1, HEAD_DIM)
    q, kn, vn = (randn(torch, shape_q, gen, dev, bf16) for _ in range(3))
    vt = torch.tensor(valid_to, dtype=torch.int32, device=dev)
    ap = torch.tensor(append_at, dtype=torch.int32, device=dev)
    return q, kn, vn, k_pool, v_pool, vt, ap, table.to(dev), rows


def phase_decode_paged(torch, ddp, flush, gen):
    import importlib
    fd = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_decode')
    F = torch.nn.functional
    dev = torch.device('cuda')
    scale = 1.0 / math.sqrt(HEAD_DIM)
    q, kn, vn, kp, vp, vt, ap, table, rows = paged_case(torch, gen, dev)
    k0, v0 = kp.clone(), vp.clone()           # before the step
    kp2, vp2 = kp.clone(), vp.clone()
    out, _, _ = fd.flash_decode(q, kn, vn, kp, vp, vt, ap, page_table=table,
                                scale=scale)
    ref, _, _ = fd.flash_decode_plain(q, kn, vn, kp2, vp2, vt, ap,
                                      page_table=table, scale=scale)
    # K5 on the same rows gathered into a slab.
    ks, vs = fd.gather_pages(k0, table), fd.gather_pages(v0, table)
    out5, _, _ = fd.flash_decode(q, kn, vn, ks, vs, vt, ap, scale=scale)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    row_rel, rel = rel_errs(torch, out, ref)
    pools_same = bool(torch.equal(kp[:-1], kp2[:-1])
                      and torch.equal(vp[:-1], vp2[:-1]))
    written = int(((kp != k0).any(dim=(1, 2, 3))).sum().item())
    k5_same = bool(torch.equal(out, out5))
    row = {'phase': 'flash_decode_paged', 'case': 'mixed_fill',
           'valid_to': vt.tolist(), 'append_at': ap.tolist(),
           'page_size': SERVE_PAGE, 'pages': SERVE_PAGES,
           'max_abs_err': err, 'max_row_rel_err': row_rel, 'rel_err': rel,
           'tol': {'abs': TOL_BF16, 'row_rel': TOL_ROW_REL},
           'pools_bit_identical_but_sink': pools_same,
           'pages_written': written, 'equals_k5_on_gathered_slab': k5_same}
    emit(row)
    check(torch.isfinite(out).all().item(), 'K5p: non-finite output')
    check(not out[1].any().item(), 'K5p: the empty slot is not exactly 0')
    check(err <= TOL_BF16, f'K5p: max abs err {err} > {TOL_BF16}')
    check(row_rel <= TOL_ROW_REL,
          f'K5p: row rel err {row_rel} > {TOL_ROW_REL}')
    check(pools_same, 'K5p: pool differs from the plain append')
    check(k5_same, 'K5p: output differs from K5 on the gathered slab')
    emit(two_streams(torch, fd, (q, kn, vn, k0, v0, vt, ap, table), out,
                     out5, scale))
    emit(page_256(torch, fd, gen, scale))

    # Bound over this run's inputs: the distinct filled K and V rows read
    # once (shared prefix rows once), q read, out written, k_new/v_new
    # read, the appended rows written, the table read.
    n_rows = len(set().union(*rows))
    cols = sum(v + 1 for v in vt.tolist() if v >= 0)
    n_app = sum(a >= 0 for a in ap.tolist())
    flops, nbytes = perf().decode_cost(
        d=HEAD_DIM, q_rows=SERVE_SLOTS * HEADS, new_rows=SERVE_SLOTS * HEADS,
        rows_read=n_rows * HEADS, rows_appended=n_app * HEADS,
        cols=cols * HEADS, table_entries=table.numel())
    bms, by = bound_ms(flops, nbytes)
    mask = (torch.arange(SERVE_T_MAX, device=dev)[None, :]
            <= vt[:, None].long())[:, None, None, :]
    row = {'phase': 'flash_decode_paged', 'case': 'serve_shape',
           'max_abs_err': err,
           'ms': time_ms(torch, lambda: fd.flash_decode(
               q, kn, vn, kp, vp, vt, ap, page_table=table, scale=scale),
               flush),
           'plain_ms': time_ms(torch, lambda: fd.flash_decode_plain(
               q, kn, vn, kp2, vp2, vt, ap, page_table=table, scale=scale),
               flush, reps=10),
           'library_ms': time_ms(torch, lambda: F.scaled_dot_product_attention(
               q, ks, vs, attn_mask=mask, scale=scale), flush),
           'gather_ms': time_ms(torch, lambda: (
               fd.gather_pages(kp, table), fd.gather_pages(vp, table)),
               flush),
           'library': 'sdpa over the slab gathered beforehand (gather_ms '
                      'apart): no single PyTorch call attends a paged cache',
           'bound_ms': bms, 'bound_by': by, 'flops': flops, 'bytes': nbytes,
           'bound_formula': '2*2*d*H_kv*(distinct filled rows) + q, out, '
                            'k_new, v_new, appended rows (2*d*H each, bf16) '
                            '+ 4*table entries'}
    check_one_kernel(torch, row, 'K5p serve shape', lambda: fd.flash_decode(
        q, kn, vn, kp, vp, vt, ap, page_table=table, scale=scale))
    emit(row)
    row['variants'] = paged_variants(torch, fd, flush, q, kn, vn, k0, v0, vt,
                                     ap, table, scale)
    row['variants']['alibi'] = alibi_decode_variants(torch, flush, gen,
                                                     paged=True)
    return row


def two_streams(torch, fd, case, out_paged, out_slab, scale):
    """K5p on the serving case's pool and K5 on its gathered slab, each on
    its own stream at once, on separate copies of the caches: each result
    bit for bit its launch alone (``out_paged``, ``out_slab``) and within
    tolerance of its plain version, each cache its plain append."""
    q, kn, vn, k0, v0, vt, ap, table = case
    slab = [fd.gather_pages(x, table) for x in (k0, v0)]
    pools = [k0.clone(), v0.clone()]
    slabs = [x.clone() for x in slab]
    main = torch.cuda.current_stream()
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for st in streams:
        st.wait_stream(main)
    with torch.cuda.stream(streams[0]):
        got_p = fd.flash_decode(q, kn, vn, *pools, vt, ap, page_table=table,
                                scale=scale)[0]
    with torch.cuda.stream(streams[1]):
        got_s = fd.flash_decode(q, kn, vn, *slabs, vt, ap, scale=scale)[0]
    torch.cuda.synchronize()
    pools2 = [k0.clone(), v0.clone()]
    slabs2 = [x.clone() for x in slab]
    ref_p = fd.flash_decode_plain(q, kn, vn, *pools2, vt, ap,
                                  page_table=table, scale=scale)[0]
    ref_s = fd.flash_decode_plain(q, kn, vn, *slabs2, vt, ap,
                                  scale=scale)[0]
    errs_p, err_p, fin_p = _decode_errs(torch, got_p, ref_p)
    errs_s, err_s, fin_s = _decode_errs(torch, got_s, ref_s)
    row = {'phase': 'flash_decode_paged', 'case': 'two_streams',
           'max_abs_err': {'paged': err_p, 'slab': err_s},
           'max_row_rel_err': {'paged': errs_p['out'][0],
                               'slab': errs_s['out'][0]},
           'paged_equals_alone': _same(torch, got_p, out_paged),
           'slab_equals_alone': _same(torch, got_s, out_slab),
           'caches_equal_plain': all(
               torch.equal(a[:-1], b[:-1]) for a, b in zip(pools, pools2))
           and all(torch.equal(a, b) for a, b in zip(slabs, slabs2))}
    fails = (check_rel(errs_p, 'K5p on its own stream')
             + check_rel(errs_s, 'K5 on its own stream'))
    check(fin_p and fin_s, 'two streams: non-finite output')
    check(not fails, '; '.join(fails))
    for key in ('paged_equals_alone', 'slab_equals_alone',
                'caches_equal_plain'):
        check(row[key], f'two streams: {key} is False')
    return row


def page_256(torch, fd, gen, scale):
    """K5p at page 256 on the serving widths (8 slots, 8 heads of 96,
    t_max 4096: 16 pages a slot, two chunks a page), scrambled, the
    ``VERIFY_PAGED`` fills: one new row and verify k = 5, each within
    tolerance of its plain version and bit for bit K5 on the gathered
    slab (every page allocated: every row), the pool its plain append but
    the sink."""
    dev = torch.device('cuda')
    row = {'phase': 'flash_decode_paged', 'case': 'page_256', 'cases': {}}
    for k in (1, VERIFY_K):
        slots = _one_row(VERIFY_PAGED) if k == 1 else VERIFY_PAGED
        vt, ap, nn = _verify_vectors(torch, slots, k, dev)
        q, kn, vn, ck, cv = _verify_slab(torch, gen, dev, slots, HEADS,
                                         HEADS, HEAD_DIM, SERVE_T_MAX)
        q, kn, vn = (x[:, :, :k].contiguous() for x in (q, kn, vn))
        kp, vp, table = paged_twin(torch, gen, ck, cv, 256)
        kp2, vp2 = kp.clone(), vp.clone()
        slab = [fd.gather_pages(x, table) for x in (kp, vp)]
        kw = dict(scale=scale, n_new=nn)
        got = fd.flash_decode(q, kn, vn, kp, vp, vt, ap, page_table=table,
                              **kw)[0]
        want = fd.flash_decode_plain(q, kn, vn, kp2, vp2, vt, ap,
                                     page_table=table, **kw)[0]
        on_slab = fd.flash_decode(q, kn, vn, *slab, vt, ap, **kw)[0]
        torch.cuda.synchronize()
        errs, err, finite = _decode_errs(torch, got, want)
        case = {'max_abs_err': err, 'max_row_rel_err': errs['out'][0],
                'rel_err': errs['out'][1],
                'equals_k5_on_gathered_slab': _same(torch, got, on_slab),
                'pools_bit_identical_but_sink': bool(
                    torch.equal(kp[:-1], kp2[:-1])
                    and torch.equal(vp[:-1], vp2[:-1]))}
        check_one_kernel(torch, case, f'K5p page 256 k {k}',
                         lambda: fd.flash_decode(q, kn, vn, kp, vp, vt, ap,
                                                 page_table=table, **kw))
        row['cases'][k] = case
        fails = check_rel(errs, f'K5p page 256 k {k}')
        check(finite, f'K5p page 256 k {k}: non-finite output')
        check(not fails, '; '.join(fails))
        for key in ('equals_k5_on_gathered_slab',
                    'pools_bit_identical_but_sink'):
            check(case[key], f'K5p page 256 k {k}: {key} is False')
    return row


def paged_variants(torch, fd, flush, q, kn, vn, k0, v0, vt, ap, table, scale):
    """K5p's partial outputs and window against their plain versions on the
    serving shape's paged cache (``k0``/``v0`` before the step), with slot
    6's ``valid_to`` moved past its 4096 columns (the slab wholly in the
    query's past) and the empty slot 1 (an empty row): ms, plain ms, the
    bound and SDPA over the gathered slab."""
    F = torch.nn.functional
    dev = q.device
    vt_p, ap_p = vt.clone(), ap.clone()
    vt_p[6], ap_p[6] = SERVE_T_MAX + 904, -1
    rows = {}
    for name, window, partials, v_t, a_p in (
            ('partials', None, True, vt_p, ap_p),
            ('window', DS_WINDOW, False, vt, ap),
            ('partials_window', DS_WINDOW, True, vt_p, ap_p)):
        kp, vp, kp2, vp2 = k0.clone(), v0.clone(), k0.clone(), v0.clone()
        kw = dict(page_table=table, scale=scale, window=window,
                  partials=partials)
        got, _, _ = fd.flash_decode(q, kn, vn, kp, vp, v_t, a_p, **kw)
        want, _, _ = fd.flash_decode_plain(q, kn, vn, kp2, vp2, v_t, a_p,
                                           **kw)
        torch.cuda.synchronize()
        same = bool(torch.equal(kp[:-1], kp2[:-1])
                    and torch.equal(vp[:-1], vp2[:-1]))
        errs, err, finite = _decode_errs(torch, got, want)
        if partials:
            num, m, l = got
            empty = (not num[1].any().item() and not l[1].any().item()
                     and bool((m[1] == fd._NEG_BIG).all().item()))
            check(empty, f'K5p {name}: the empty slot is not exactly '
                         f'(0, _NEG_BIG, 0)')
        check(finite, f'K5p {name}: non-finite output')
        fails = check_rel(errs, f'K5p {name}')
        check(not fails, '; '.join(fails))
        check(same, f'K5p {name}: pool differs from the plain append')
        # Attended columns of each slot (held pages only), the bound over
        # the distinct rows they read, and SDPA over the gathered slab.
        ks, vs = fd.gather_pages(k0, table), fd.gather_pages(v0, table)
        cols = torch.arange(SERVE_T_MAX, device=dev)[None, :]
        vtl = v_t.long()[:, None]
        allowed = (cols <= vtl) & (table.long() >= 0).repeat_interleave(
            SERVE_PAGE, dim=1)
        if window is not None:
            allowed &= cols > vtl - window
        n_cols = int(allowed.sum().item())
        # Distinct pool rows read (the shared prefix's once).
        pool_rows = (table.long().repeat_interleave(SERVE_PAGE, dim=1)
                     * SERVE_PAGE + cols % SERVE_PAGE)[allowed]
        n_rows = int(torch.unique(pool_rows).numel())
        flops, nbytes = perf().decode_cost(
            d=HEAD_DIM, q_rows=SERVE_SLOTS * HEADS,
            new_rows=SERVE_SLOTS * HEADS, rows_read=n_rows * HEADS,
            rows_appended=int((a_p >= 0).sum().item()) * HEADS,
            cols=n_cols * HEADS, table_entries=table.numel(),
            out_row_bytes=(HEAD_DIM + 2) * 4 if partials else None)
        bms, by = bound_ms(flops, nbytes)
        mask = allowed[:, None, None, :]
        counted = {}
        check_one_kernel(torch, counted, f'K5p {name}',
                         lambda: fd.flash_decode(q, kn, vn, kp, vp, v_t, a_p,
                                                 **kw))
        row = {'phase': 'flash_decode_paged', 'case': name, **counted,
               'window': window, 'partials': partials,
               'valid_to': v_t.tolist(), 'max_abs_err': err,
               'max_row_rel_err': {n: e[0] for n, e in errs.items()},
               'rel_err': {n: e[1] for n, e in errs.items()},
               'tol': {'row_rel': TOL_ROW_REL, 'rel': TOL_NORM_REL},
               'pools_bit_identical_but_sink': same,
               'ms': time_ms(torch, lambda: fd.flash_decode(
                   q, kn, vn, kp, vp, v_t, a_p, **kw), flush),
               'plain_ms': time_ms(torch, lambda: fd.flash_decode_plain(
                   q, kn, vn, kp2, vp2, v_t, a_p, **kw), flush, reps=10),
               **_decode_library(
                   torch, partials, flush,
                   lambda: F.scaled_dot_product_attention(
                       q, ks, vs, attn_mask=mask, scale=scale),
                   'sdpa over the slab gathered beforehand'
                   + (' with the window mask' if window else '')),
               'bound_ms': bms, 'bound_by': by, 'flops': flops,
               'bytes': nbytes, 'attended_columns': n_cols,
               'distinct_rows_read': n_rows}
        emit(row)
        rows[name] = {k: row[k] for k in (
            'ms', 'plain_ms', 'library_ms', 'bound_ms', 'bound_by',
            'max_abs_err', 'max_row_rel_err', 'rel_err')}
    return rows


# The verify-k cases (flash_decode_verify): k = 5 new rows per slot, the
# width of a spec_k = 4 verify step. Per slot: (rows filled before the
# step, rows it appends; None = an inactive slot that appends nothing and
# attends its un-advanced prefix). K5's first slot straddles the split at
# column 1024, K5p's slots 0 and 5 a split and a page.
VERIFY_K = 5
VERIFY_SLAB = ((1021, 5), (999, 3), (1062, 1), (1000, None))
VERIFY_GQA = ((1021, 5), (999, 0), (1062, 3), (1000, None))
VERIFY_PAGED = ((1021, 5), (999, 3), (1062, 1), (700, 0), (1500, None),
                (30, 5), (4000, 2), (5, 4))


def _verify_vectors(torch, slots, k, dev):
    """``(valid_to, append_at, n_new)`` int32 on ``dev`` for ``slots`` as
    ``decode_step`` forms them: an active slot's row 0 at its fill, an
    inactive one ``k`` rows back."""
    vt = [f if c is not None else f - k for f, c in slots]
    ap = [f if c else -1 for f, c in slots]
    nn = [c or 0 for _, c in slots]
    return tuple(torch.tensor(x, dtype=torch.int32, device=dev)
                 for x in (vt, ap, nn))


def _verify_mask(torch, vt, k, t, dev, col_ok=None):
    """``(B, 1, k, t)`` bool: row j of a slot attends columns <= vt + j
    (and ``col_ok``)."""
    cols = torch.arange(t, device=dev)
    rows = vt.long()[:, None] + torch.arange(k, device=dev)[None, :]
    allowed = cols[None, None, :] <= rows[:, :, None]
    if col_ok is not None:
        allowed &= col_ok[:, None, :]
    return allowed[:, None]


def _sequential(torch, fd, q, kn, vn, ck, cv, vt, ap, nn, **kw):
    """``k`` one-row launches, row j at ``valid_to + j`` appending (when
    ``j < n_new``) at ``append_at + j``: the outputs stacked on dim 2."""
    outs = []
    for j in range(q.shape[2]):
        apj = torch.where((ap >= 0) & (j < nn), ap + j, -1).to(torch.int32)
        out, _, _ = fd.flash_decode(
            q[:, :, j:j + 1].contiguous(), kn[:, :, j:j + 1].contiguous(),
            vn[:, :, j:j + 1].contiguous(), ck, cv, vt + j, apj, **kw)
        outs.append(out)
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(x, dim=2) for x in zip(*outs))
    return torch.cat(outs, dim=2)


def _same(torch, a, b):
    if isinstance(a, tuple):
        return all(torch.equal(x, y) for x, y in zip(a, b))
    return bool(torch.equal(a, b))


def _verify_slab(torch, gen, dev, slots, h, h_kv, d, t):
    """A slab case: (q, k_new, v_new, cache_k, cache_v) in bf16 with
    unit-normal rows below each slot's fill and large garbage past it."""
    bf16, b, k = torch.bfloat16, len(slots), VERIFY_K
    q = randn(torch, (b, h, k, d), gen, dev, bf16)
    kn = randn(torch, (b, h_kv, k, d), gen, dev, bf16)
    vn = randn(torch, (b, h_kv, k, d), gen, dev, bf16)
    ck = 30.0 * randn(torch, (b, h_kv, t, d), gen, dev, bf16)
    cv = 30.0 * randn(torch, (b, h_kv, t, d), gen, dev, bf16)
    for i, (f, _) in enumerate(slots):
        ck[i, :, :f] = randn(torch, (h_kv, f, d), gen, dev, bf16)
        cv[i, :, :f] = randn(torch, (h_kv, f, d), gen, dev, bf16)
    return q, kn, vn, ck, cv


def _verify_paged(torch, gen, dev, slots):
    """The serving shape's pool for ``slots`` (pages for each fill plus
    its appended rows, scrambled): (q, k_new, v_new, k_pool, v_pool,
    table, the distinct pool rows each slot's filled columns hold)."""
    bf16, ps, pps = torch.bfloat16, SERVE_PAGE, SERVE_T_MAX // SERVE_PAGE
    b, k = len(slots), VERIFY_K
    perm = torch.randperm(SERVE_PAGES, generator=gen).tolist()
    table = torch.full((b, pps), -1, dtype=torch.int32)
    nxt = 0
    for i, (f, c) in enumerate(slots):
        n = -(-(f + (c or 0)) // ps)
        table[i, :n] = torch.tensor(perm[nxt:nxt + n], dtype=torch.int32)
        nxt += n
    shape = (SERVE_PAGES + 1, HEADS, ps, HEAD_DIM)
    k_pool = 30.0 * randn(torch, shape, gen, dev, bf16)
    v_pool = 30.0 * randn(torch, shape, gen, dev, bf16)
    filled = sorted({(int(table[i, c // ps]), c % ps)
                     for i, (f, _) in enumerate(slots) for c in range(f)})
    pg, r = (torch.tensor(x, device=dev) for x in zip(*filled))
    unit = (len(filled), HEADS, HEAD_DIM)
    k_pool[pg, :, r] = randn(torch, unit, gen, dev, bf16)
    v_pool[pg, :, r] = randn(torch, unit, gen, dev, bf16)
    q = randn(torch, (b, HEADS, k, HEAD_DIM), gen, dev, bf16)
    kn = randn(torch, (b, HEADS, k, HEAD_DIM), gen, dev, bf16)
    vn = randn(torch, (b, HEADS, k, HEAD_DIM), gen, dev, bf16)
    return q, kn, vn, k_pool, v_pool, table.to(dev)


def _decode_bound(torch, mask, h, h_kv, d, b, k, n_app, k_bytes=None,
                  partials=False):
    """``(ms, by, flops, bytes)`` of a decode launch whose query rows
    attend ``mask (B, 1, k, t)``: every K and V row some row of a slot
    attends read once (K at ``k_bytes`` a row, default bf16; V bf16), q
    read, the output written, k_new/v_new read, the appended rows
    written; 4·d operations per attended (query head, column)."""
    flops, nbytes = perf().decode_cost(
        d=d, q_rows=b * h * k, new_rows=b * h_kv * k,
        rows_read=int(mask.any(dim=2).sum().item()) * h_kv,
        rows_appended=n_app * h_kv,
        cols=int(mask.sum().item()) * (h // h_kv), k_row_bytes=k_bytes,
        out_row_bytes=(d + 2) * 4 if partials else None)
    bms, by = bound_ms(flops, nbytes)
    return bms, by, flops, nbytes


def _decode_library_mask(torch, vt, k, t, col_ok, h, alibi, dtype):
    """SDPA's mask for a decode launch whose row j of a slot sits at
    ``valid_to + j``: the boolean verify mask ``(B, 1, k, t)``, or with
    ALiBi the float ``slope·(col − (valid_to + j))`` where the row attends
    the column and ``-inf`` elsewhere, ``(B, h, k, t)``."""
    allowed = _verify_mask(torch, vt, k, t, vt.device, col_ok)
    if not alibi:
        return allowed
    rows = vt.long()[:, None] + torch.arange(k, device=vt.device)[None, :]
    back = rows[:, None, :, None] - torch.arange(t, device=vt.device)
    return alibi_bias(torch, ALIBI_SLOPES[:h], back,
                      allowed.expand(-1, h, -1, -1), dtype)


def _real_rows(torch, x, nn):
    """The rows ``j < n_new`` of an output or partials, per slot: a padded
    verify row may reach an unallocated page, which K5p masks and a
    gathered slab holds as zeros."""
    real = torch.arange(x[0].shape[2] if isinstance(x, tuple)
                        else x.shape[2], device=nn.device)[None, :] \
        < nn[:, None]
    return tuple(t.transpose(1, 2)[real]
                 for t in (x if isinstance(x, tuple) else (x,)))


def _decode_case(torch, fd, gen, slots, k, h, h_kv, d, t, paged):
    """Inputs of a decode case with ``k`` new rows a slot: (q, k_new,
    v_new, cache_k, cache_v, the launch's base kwargs, the columns a slot
    holds (None on a slab), the cache as a slab)."""
    dev = torch.device('cuda')
    if paged:
        q, kn, vn, c_k, c_v, table = _verify_paged(torch, gen, dev, slots)
        col_ok = (table >= 0).repeat_interleave(SERVE_PAGE, dim=1)
        return (*(x[:, :, :k].contiguous() for x in (q, kn, vn)), c_k, c_v,
                dict(page_table=table), col_ok,
                lambda x: fd.gather_pages(x, table))
    q, kn, vn, c_k, c_v = _verify_slab(torch, gen, dev, slots, h, h_kv, d, t)
    return (*(x[:, :, :k].contiguous() for x in (q, kn, vn)), c_k, c_v, {},
            None, lambda x: x)


def verify_variants(torch, flush, gen, phase, cases):
    """K5 and K5p verify-k (k = 5) against their plain versions and
    against 5 sequential one-row launches, bit for bit (outputs, partial
    outputs and caches); K5p also bit for bit K5 on the gathered slab
    (real rows). ``cases``: (name, slots, heads, kv heads, head dim,
    paged, ALiBi); a slab case has T_MAX columns, a paged one the serving
    shape's pool. Times against the bound, the plain version and SDPA with
    the verify mask (a float ALiBi bias with ALiBi)."""
    import importlib
    fd = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_decode')
    F = torch.nn.functional
    dev, k = torch.device('cuda'), VERIFY_K
    res = {}
    for name, slots, h, h_kv, d, paged, alibi in cases:
        scale = 1.0 / math.sqrt(d)
        t = SERVE_T_MAX if paged else T_MAX
        vt, ap, nn = _verify_vectors(torch, slots, k, dev)
        q, kn, vn, c_k, c_v, base, col_ok, slab_k = _decode_case(
            torch, fd, gen, slots, k, h, h_kv, d, t, paged)
        kw = dict(base, scale=scale)
        if alibi:
            kw['alibi_slopes'] = torch.tensor(
                ALIBI_SLOPES[:h], dtype=torch.float32, device=dev)
        k0, v0 = c_k.clone(), c_v.clone()
        caches = [(k0.clone(), v0.clone()) for _ in range(3)]
        out, _, _ = fd.flash_decode(q, kn, vn, *caches[0], vt, ap, n_new=nn,
                                    **kw)
        ref, _, _ = fd.flash_decode_plain(q, kn, vn, *caches[1], vt, ap,
                                          n_new=nn, **kw)
        seq = _sequential(torch, fd, q, kn, vn, *caches[2], vt, ap, nn, **kw)
        torch.cuda.synchronize()
        body = slice(None, -1) if paged else slice(None)   # the sink apart
        errs, err, finite = _decode_errs(torch, out, ref)
        row = {'phase': phase, 'case': name, 'k': k,
               'batch': len(slots), 'heads': h, 'kv_heads': h_kv,
               'head_dim': d, 'valid_to': vt.tolist(),
               'append_at': ap.tolist(), 'n_new': nn.tolist(),
               'alibi_slopes': list(ALIBI_SLOPES[:h]) if alibi else None,
               'max_abs_err': err,
               'max_row_rel_err': errs['out'][0], 'rel_err': errs['out'][1],
               'tol': {'row_rel': TOL_ROW_REL, 'rel': TOL_NORM_REL},
               'equals_sequential': _same(torch, out, seq),
               'caches_equal_sequential': all(
                   torch.equal(a[body], b[body])
                   for a, b in zip(caches[0], caches[2])),
               'caches_equal_plain': all(
                   torch.equal(a[body], b[body])
                   for a, b in zip(caches[0], caches[1]))}
        if paged:
            row['sink_untouched'] = bool(torch.equal(caches[0][0][-1],
                                                     k0[-1]))
            slab_kw = {n: a for n, a in kw.items() if n != 'page_table'}
            slab = fd.flash_decode(q, kn, vn, slab_k(k0), slab_k(v0), vt, ap,
                                   n_new=nn, **slab_kw)[0]
            row['equals_k5_on_gathered_slab'] = _same(
                torch, _real_rows(torch, out, nn), _real_rows(torch, slab, nn))
        # The partial outputs of the same launch, against the sequential
        # launches' partials.
        pc = [(k0.clone(), v0.clone()) for _ in range(2)]
        part, _, _ = fd.flash_decode(q, kn, vn, *pc[0], vt, ap, n_new=nn,
                                     partials=True, **kw)
        part_seq = _sequential(torch, fd, q, kn, vn, *pc[1], vt, ap, nn,
                               partials=True, **kw)
        row['partials_equal_sequential'] = _same(torch, part, part_seq)
        check_one_kernel(torch, row, f'verify {name}',
                         lambda: fd.flash_decode(q, kn, vn, *pc[0], vt, ap,
                                                 n_new=nn, **kw))
        fails = check_rel(errs, f'K5{"p" if paged else ""} verify {name}')
        check(finite, f'verify {name}: non-finite output')
        emit(row)
        check(not fails, '; '.join(fails))
        for key in ('equals_sequential', 'caches_equal_sequential',
                    'caches_equal_plain', 'partials_equal_sequential',
                    'sink_untouched', 'equals_k5_on_gathered_slab'):
            check(row.get(key, True), f'verify {name}: {key} is False')
        mask = _verify_mask(torch, vt, k, t, dev, col_ok)
        n_app = int(nn.sum().item())
        bms, by, flops, nbytes = _decode_bound(torch, mask, h, h_kv, d,
                                               len(slots), k, n_app)
        ks, vs = slab_k(k0), slab_k(v0)
        lib_mask = _decode_library_mask(torch, vt, k, t, col_ok, h, alibi,
                                        q.dtype)
        timed = dict(
            ms=time_ms(torch, lambda: fd.flash_decode(
                q, kn, vn, *caches[0], vt, ap, n_new=nn, **kw), flush),
            plain_ms=time_ms(torch, lambda: fd.flash_decode_plain(
                q, kn, vn, *caches[1], vt, ap, n_new=nn, **kw), flush,
                reps=5),
            library_ms=time_ms(torch, lambda: F.scaled_dot_product_attention(
                q, ks, vs, attn_mask=lib_mask, scale=scale,
                enable_gqa=h != h_kv), flush),
            bound_ms=bms, bound_by=by)
        emit({'phase': phase, 'case': name, **timed,
              'library': ('sdpa with a float ALiBi bias (bf16)' if alibi
                          else 'sdpa with the boolean verify mask')
                         + ' over the same columns'
                         + (' (slab gathered beforehand)' if paged else ''),
              'flops': flops, 'bytes': nbytes})
        res[name] = {'max_abs_err': err, 'max_row_rel_err': errs['out'][0],
                     'rel_err': errs['out'][1], **timed}
        del q, kn, vn, c_k, c_v, k0, v0, caches, pc, ks, vs, lib_mask
        torch.cuda.empty_cache()
    return res


def phase_decode_verify(torch, ddp, flush, gen):
    """Verify-k: K5 at the greedy decode shape (batch 4, 8 heads of 96,
    t_max 2048) and at the flagship decode module's GQA 8:4 with head dim
    64, K5p at the serving shape (``verify_variants``)."""
    return verify_variants(torch, flush, gen, 'flash_decode_verify', (
        ('slab', VERIFY_SLAB, HEADS, HEADS, HEAD_DIM, False, False),
        ('slab_gqa', VERIFY_GQA, SP_HEADS, DS_KV, 64, False, False),
        ('paged', VERIFY_PAGED, HEADS, HEADS, HEAD_DIM, True, False)))


def _mirror(torch, fd, cache_k):
    """The int8 mirror of a bf16 cache (every row quantized, the garbage
    past the fill too: the mask keeps it out)."""
    k_q, k_scale = fd.quantize_rows(cache_k)
    return k_q.contiguous(), k_scale.contiguous()


def _one_row(slots):
    """``slots`` with at most one appended row each."""
    return tuple((f, c if c is None else min(c, 1)) for f, c in slots)


def one_row_variants(torch, flush, gen, phase, cases):
    """K5 and K5p with one new row a slot against their plain versions:
    the output and the partial outputs (only the partials with
    ``partials``), caches bit for bit; with ``int8`` the K mirror, its
    rows and the scores' row maxima (the partials' m) bit for bit; K5p
    also bit for bit K5 on the gathered slab (real rows). ``cases``: (name,
    slots, heads, kv heads, head dim, columns, flags: any of ``paged``,
    ``partials``, ``int8``, ``alibi``). Times of the case's own launch
    against the bound (int8: K at 1 byte plus a 4-byte scale a row, V at 2
    bytes), the plain version and SDPA over the same columns (a float
    ALiBi bias with ALiBi; for int8 in bf16, for scale only)."""
    import importlib
    fd = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_decode')
    F = torch.nn.functional
    dev = torch.device('cuda')
    res = {}
    for name, slots, h, h_kv, d, t, flags in cases:
        paged, partials = flags.get('paged'), flags.get('partials', False)
        int8, alibi = flags.get('int8'), flags.get('alibi')
        scale = 1.0 / math.sqrt(d)
        # A full slab lies wholly in the query's past: valid_to past it.
        vt, ap, nn = _verify_vectors(torch, slots, 1, dev)
        q, kn, vn, c_k, c_v, base, col_ok, slab_k = _decode_case(
            torch, fd, gen, slots, 1, h, h_kv, d, t, paged)
        base['scale'] = scale
        if alibi:
            base['alibi_slopes'] = torch.tensor(
                ALIBI_SLOPES[:h], dtype=torch.float32, device=dev)
        m0 = _mirror(torch, fd, c_k) if int8 else ()
        k0, v0 = c_k.clone(), c_v.clone()

        def fresh():
            return [x.clone() for x in (k0, v0, *m0)]

        def kwargs(c, part):
            kw = dict(base, partials=part)
            if int8:
                kw.update(k_q=c[2], k_scale=c[3], qk_quant='int8')
            return kw
        modes = (True,) if partials else (False, True)
        runs = {}
        for impl, fn in (('kernel', fd.flash_decode),
                         ('plain', fd.flash_decode_plain)):
            for part in modes:
                c = fresh()
                runs[impl, part] = (fn(q, kn, vn, c[0], c[1], vt, ap,
                                       **kwargs(c, part))[0], c)
        torch.cuda.synchronize()
        body = slice(None, -1) if paged else slice(None)
        errs, err, finite = {}, 0.0, True
        for part in modes:
            e, a, f = _decode_errs(torch, runs['kernel', part][0],
                                   runs['plain', part][0])
            errs.update(e)
            err, finite = max(err, a), finite and f
        (kern, kc), (plain, pc) = runs['kernel', True], runs['plain', True]
        row = {'phase': phase, 'case': name, 'batch': len(slots),
               'heads': h, 'kv_heads': h_kv, 'head_dim': d, 'columns': t,
               'partials': partials, 'qk_quant': 'int8' if int8 else None,
               'alibi_slopes': list(ALIBI_SLOPES[:h]) if alibi else None,
               'valid_to': vt.tolist(), 'append_at': ap.tolist(),
               'max_abs_err': err,
               'max_row_rel_err': {n: e[0] for n, e in errs.items()},
               'rel_err': {n: e[1] for n, e in errs.items()},
               'tol': {'row_rel': TOL_ROW_REL, 'rel': TOL_NORM_REL},
               'caches_bit_identical': all(
                   torch.equal(a[body], b[body])
                   for a, b in zip(kc[:2], pc[:2]))}
        checks = ['caches_bit_identical']
        if int8:
            attended = plain[1] > fd._NEG_BIG
            row.update(score_max_bit_identical=bool(torch.equal(kern[1],
                                                                plain[1])),
                       rows_attending=int(attended.sum().item()),
                       mirror_bit_identical=all(
                           torch.equal(a[body], b[body])
                           for a, b in zip(kc[2:], pc[2:])))
            checks += ['score_max_bit_identical', 'mirror_bit_identical']
        if paged:
            c = [slab_k(x) for x in (k0, v0, *m0)]
            row['equals_k5_on_gathered_slab'] = True
            for part in modes:
                kw = {n: a for n, a in kwargs(c, part).items()
                      if n != 'page_table'}
                slab = fd.flash_decode(q, kn, vn, c[0], c[1], vt, ap,
                                       **kw)[0]
                row['equals_k5_on_gathered_slab'] &= _same(
                    torch, _real_rows(torch, runs['kernel', part][0], nn),
                    _real_rows(torch, slab, nn))
            checks.append('equals_k5_on_gathered_slab')
        c = fresh()
        check_one_kernel(torch, row, f'{phase} {name}',
                         lambda: fd.flash_decode(q, kn, vn, c[0], c[1], vt,
                                                 ap, **kwargs(c, partials)))
        emit(row)
        check(finite, f'{phase} {name}: non-finite output')
        fails = check_rel(errs, f'{phase} {name}')
        check(not fails, '; '.join(fails))
        for key in checks:
            check(row[key], f'{phase} {name}: {key} is False')
        mask = _verify_mask(torch, vt, 1, t, dev, col_ok)
        n_app = int(nn.sum().item())
        bms, by, flops, nbytes = _decode_bound(
            torch, mask, h, h_kv, d, len(slots), 1, n_app,
            k_bytes=d + 4 if int8 else None, partials=partials)
        cols = int(mask.sum().item()) * (h // h_kv)
        if int8:
            bms, by = bound_mixed(2 * d * cols, 2 * d * cols, nbytes)
        c = fresh()
        ks, vs = slab_k(k0), slab_k(v0)
        lib_mask = _decode_library_mask(torch, vt, 1, t, col_ok, h, alibi,
                                        q.dtype)
        timed = dict(
            ms=time_ms(torch, lambda: fd.flash_decode(
                q, kn, vn, c[0], c[1], vt, ap, **kwargs(c, partials)),
                flush),
            plain_ms=time_ms(torch, lambda: fd.flash_decode_plain(
                q, kn, vn, c[0], c[1], vt, ap, **kwargs(c, partials)),
                flush, reps=5),
            bound_ms=bms, bound_by=by)
        library = ('sdpa with a float ALiBi bias (bf16)' if alibi
                   else 'sdpa') + ' over the same columns'
        if int8:
            library = ('none computes int8-scored decode: ' + library
                       + ', in bf16, for scale only')
        lib = _decode_library(
            torch, partials, flush, lambda: F.scaled_dot_product_attention(
                q, ks, vs, attn_mask=lib_mask, scale=scale,
                enable_gqa=h != h_kv), library)
        timed['library_ms'] = lib['library_ms']
        emit({'phase': phase, 'case': name, **timed,
              'library': lib['library'],
              'bytes': nbytes, **({'int8_ops': 2 * d * cols,
                                   'bf16_flops': 2 * d * cols} if int8
                                  else {'flops': flops})})
        res[name] = {'max_abs_err': err,
                     'max_row_rel_err': max(e[0] for e in errs.values()),
                     **timed}
        del q, kn, vn, c_k, c_v, k0, v0, m0, runs, kern, kc, plain, pc, c
        del ks, vs, lib_mask
        torch.cuda.empty_cache()
    return res


def phase_decode_int8(torch, ddp, flush, gen):
    """The int8 K mirror (k = 1): K5 at the greedy decode shape, K5p at the
    serving shape, and K5's partials on a full 8192-column slab at the
    flagship decode module's widths (``one_row_variants``)."""
    full = ((DS_LOCAL, None),) * DS_B
    return one_row_variants(torch, flush, gen, 'flash_decode_int8', (
        ('slab', _one_row(VERIFY_SLAB), HEADS, HEADS, HEAD_DIM, T_MAX,
         dict(int8=True)),
        ('paged', _one_row(VERIFY_PAGED), HEADS, HEADS, HEAD_DIM,
         SERVE_T_MAX, dict(paged=True, int8=True)),
        ('partials_full_slab', full, SP_HEADS, DS_KV, 64, DS_LOCAL,
         dict(partials=True, int8=True))))


def alibi_decode_variants(torch, flush, gen, paged):
    """K5 (``paged`` False, the greedy decode shape) or K5p (the serving
    shape) with ALiBi (the classic slopes of 8 heads): one new row a slot,
    its partial outputs, the int8 mirror (``one_row_variants``) and verify
    k = 5 (``verify_variants``)."""
    phase = 'flash_decode_paged' if paged else 'flash_decode'
    t = SERVE_T_MAX if paged else T_MAX
    slots = VERIFY_PAGED if paged else VERIFY_SLAB
    one = _one_row(slots)
    res = one_row_variants(torch, flush, gen, phase, tuple(
        (f'alibi_{name}', one, HEADS, HEADS, HEAD_DIM, t,
         dict(flags, paged=paged, alibi=True))
        for name, flags in (('n1', {}), ('partials', {'partials': True}),
                            ('int8', {'int8': True}))))
    res.update(verify_variants(torch, flush, gen, phase, (
        ('alibi_verify', slots, HEADS, HEADS, HEAD_DIM, paged, True),)))
    return res


def serve_burst():
    """The seeded burst, built as ``examples/serve_lm.py``'s
    ``build_requests`` does: (id, prompt) with prompt lengths uniform in
    1..SERVE_PROMPT."""
    import numpy as np
    rng = np.random.default_rng(SERVE_SEED)
    reqs = []
    for i in range(SERVE_REQUESTS):
        plen = int(rng.integers(1, SERVE_PROMPT + 1))
        reqs.append((f'req-{i:03d}',
                     rng.integers(0, VOCAB, size=plen).astype(np.int32)))
    return reqs


def serve_engine(torch, mode, dtype=None, device='cuda', slots=SERVE_SLOTS,
                 t_max=SERVE_T_MAX, weight_quant='off', decode_impl='kernel',
                 **kw):
    """The serving engine, every setting explicit (the decode path, the
    cache layout, float weights unless ``weight_quant='int8'``), so no
    ``DDP_TPU_*`` knob in the environment can change a phase's path.
    ``dtype``: bf16 when None; ``'default'`` leaves KernelEngine's own
    (float32)."""
    from distributed_dot_product_tpu_torch.serve import KernelEngine
    paged = (dict(cache_mode='paged', page_size=SERVE_PAGE)
             if mode == 'paged' else dict(cache_mode='slab'))
    if dtype != 'default':
        kw['dtype'] = dtype or torch.bfloat16
    engine = KernelEngine(slots=slots, t_max=t_max, vocab=VOCAB,
                          heads=HEADS, head_dim=HEAD_DIM,
                          prefill_chunk=SERVE_CHUNK, seed=SERVE_SEED,
                          device=device, decode_impl=decode_impl,
                          weight_quant=weight_quant, **paged, **kw)
    check((engine.decode_impl, engine.cache_mode, engine.weight_quant) == (
        decode_impl, paged['cache_mode'],
        None if weight_quant == 'off' else weight_quant),
          'engine settings are not the ones asked for')
    return engine


def first_step_logits(torch, engine, prompts):
    """Logits of each prompt's first decode step: prefill the prompts into
    slots 0.. and apply the engine's own projection, fused step and head
    to its caches (what ``step`` computes before its argmax, through the
    engine's one product ``_dot``: int8 weights on an int8 engine)."""
    import numpy as np
    from distributed_dot_product_tpu_torch.models.decode import decode_step
    active = np.zeros(engine.slots, bool)
    tokens = np.zeros(engine.slots, np.int64)
    for i, p in enumerate(prompts):
        for start in range(0, len(p) - 1, engine.prefill_chunk):
            engine.prefill(i, p[start:min(start + engine.prefill_chunk,
                                          len(p) - 1)])
        active[i], tokens[i] = True, p[-1]
    if engine.cache_mode == 'paged':
        engine.prepare_step(active)
    with torch.inference_mode():
        q, k, v = engine._project(torch.as_tensor(tokens,
                                                  device=engine.device))
        engine.cache, out = decode_step(q, engine.cache, k, v,
                                        slot_mask=active,
                                        impl=engine.decode_impl)
        logits = engine._dot(out.reshape(engine.slots, -1), engine._wo)
    return logits[:len(prompts)].float().cpu()


def _serve_burst(torch, ddp, engine, burst, what):
    """The seeded burst through the Scheduler over ``engine``, after
    warming every engine operation: ``(results, row)``, the row with the
    engine's shape, terminal states, tokens/s, TTFT, step latency and the
    decode kernels' launches in the run (counts at 0 just before). Fails
    unless every request ends in a typed terminal state with tokens in
    range."""
    import numpy as np
    from distributed_dot_product_tpu_torch.serve import (
        RejectedError, Scheduler, ServeConfig,
    )
    from distributed_dot_product_tpu_torch.utils.tracing import (
        MetricsRegistry,
    )
    t0 = time.perf_counter()
    slots = engine.slots
    # Warm every engine operation, and so load the kernels, before the
    # watchdog arms: first use would otherwise count as a stall.
    engine.step(np.zeros(slots, np.int32), np.ones(slots, bool))
    engine.prefill(0, np.zeros(engine.prefill_chunk, np.int32))
    for i in range(slots):
        engine.reset(i)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    registry = MetricsRegistry()
    sched = Scheduler(engine, ServeConfig(queue_limit=SERVE_QUEUE,
                                          max_new_tokens=SERVE_NEW),
                      registry=registry, fault_injector=False)
    for fn in (ddp.flash_decode, ddp.flash_decode_paged):
        fn.launches = fn.f32_launches = 0
    rejected = {}
    t0 = time.perf_counter()
    try:
        for i, (rid, prompt) in enumerate(burst):
            try:
                sched.submit(prompt, request_id=rid)
            except RejectedError as e:
                rejected[rid] = e.reason.value
            if i % 4 == 3:
                sched.step()
        results = sched.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sched.close()
    launches = {'flash_decode': ddp.flash_decode.launches,
                'flash_decode_paged': ddp.flash_decode_paged.launches}
    snap = registry.snapshot()
    counters, hist = snap['counters'], snap['histograms']
    by_status = {}
    for r in results.values():
        by_status[r.status] = by_status.get(r.status, 0) + 1
    tokens = counters.get('serve.tokens_generated', 0)
    row = {'engine': {'slots': slots, 't_max': engine.t_max,
                      'vocab': engine.vocab, 'heads': engine.heads,
                      'head_dim': engine.head_dim,
                      'prefill_chunk': engine.prefill_chunk,
                      'page_size': engine.page_size,
                      'pages': engine.pool.pages if engine.pool else None,
                      'kv_shards': engine.kv_shards,
                      'placement': engine.placement,
                      'dtype': str(engine.dtype).split('.')[-1]},
           'engine_build_and_warm_s': build_s,
           'requests': len(burst), 'rejected_at_submit': rejected,
           'terminal': by_status, 'tokens_generated': tokens,
           'decode_steps': counters.get('serve.decode_steps', 0),
           'wall_s': wall, 'tokens_per_s': tokens / wall,
           'program_seconds': engine.program_seconds,
           'ttft_s': {k: hist['serve.ttft_seconds'][k]
                      for k in ('p50', 'p99')},
           'step_s': {k: hist['serve.step_seconds'][k]
                      for k in ('p50', 'p99')},
           'watchdog_stalls': sched.health.stall_events,
           'launches': launches}
    for rid, _ in burst:
        r = results.get(rid)
        check(rid in rejected or (r is not None and r.status in (
            'completed', 'deadline_expired', 'evicted', 'abandoned',
            'failed_nan', 'rejected') and (r.status != 'rejected'
                                           or r.reason is not None)),
              f'{what}: {rid} has no typed terminal state')
    check(all(np.all((0 <= np.asarray(r.tokens))
                     & (np.asarray(r.tokens) < VOCAB))
              for r in results.values()), f'{what}: token out of range')
    return results, row


def phase_serve_path(torch, ddp):
    """The burst through the Scheduler over the paged engine (K5p), then
    over the slab engine (K5) with the same seed, then requests 0 and 1
    on a float32 CPU engine with the same weights."""
    import numpy as np
    from distributed_dot_product_tpu_torch.serve import Scheduler, ServeConfig
    from distributed_dot_product_tpu_torch.utils.tracing import (
        MetricsRegistry,
    )
    burst = serve_burst()
    runs = {}
    for mode in ('paged', 'slab'):
        engine = serve_engine(torch, mode)
        results, row = _serve_burst(torch, ddp, engine, burst, mode)
        row = {'phase': 'serve_path', 'cache_mode': mode, **row}
        emit(row)
        own, other = (('flash_decode_paged', 'flash_decode')
                      if mode == 'paged' else
                      ('flash_decode', 'flash_decode_paged'))
        launches, steps = row['launches'], row['decode_steps']
        check(launches[own] == steps,
              f'{mode}: {own} launched {launches[own]} times for {steps} '
              f'decode steps')
        check(launches[other] == 0,
              f'{mode}: {other} launched {launches[other]} times')
        runs[mode] = (engine, results, row)
        SAME_CALL[f'serve_path_{mode}'] = {
            'tokens_per_s': row['tokens_per_s'],
            'ttft_p99_s': row['ttft_s']['p99']}
        if mode == 'slab':
            del engine
    paged_res, slab_res = runs['paged'][1], runs['slab'][1]
    same = [rid for rid, r in paged_res.items()
            if r.status == 'completed' and rid in slab_res
            and slab_res[rid].status == 'completed']
    diverged = [rid for rid in same
                if paged_res[rid].tokens != slab_res[rid].tokens]
    emit({'phase': 'serve_path', 'case': 'paged_vs_slab',
          'completed_in_both': len(same), 'diverged': diverged})
    check(len(same) == len(paged_res) == len(slab_res),
          'paged and slab runs completed different requests')
    check(not diverged, f'paged and slab streams differ: {diverged}')

    # Requests 0 and 1 on the CPU in float32 with the same weights.
    t0 = time.perf_counter()
    card = runs['paged'][0]
    cpu = serve_engine(torch, 'slab', dtype=torch.float32, device='cpu',
                       slots=2)
    cpu.load_weights({name: getattr(card, f'_{name}').float().cpu()
                      for name in ('embed', 'wq', 'wk', 'wv', 'wo')})
    prompts = [p for _, p in burst[:2]]
    card_logits = first_step_logits(torch, card, prompts)
    cpu_logits = first_step_logits(torch, cpu, prompts)
    rel = [((c - g).abs().max() / g.abs().max()).item()
           for c, g in zip(card_logits, cpu_logits)]
    cpu = serve_engine(torch, 'slab', dtype=torch.float32, device='cpu',
                       slots=2)
    cpu.load_weights({name: getattr(card, f'_{name}').float().cpu()
                      for name in ('embed', 'wq', 'wk', 'wv', 'wo')})
    with Scheduler(cpu, ServeConfig(queue_limit=SERVE_QUEUE,
                                    max_new_tokens=SERVE_NEW,
                                    watchdog=False),
                   registry=MetricsRegistry(), fault_injector=False) as ref:
        for rid, prompt in burst[:2]:
            ref.submit(prompt, request_id=rid)
        ref_res = ref.run_until_idle()
    match = {}
    for rid, _ in burst[:2]:
        a, b = ref_res[rid].tokens, paged_res[rid].tokens
        n = 0
        while n < min(len(a), len(b)) and a[n] == b[n]:
            n += 1
        match[rid] = n
    row = {'phase': 'serve_cpu_reference', 'requests': [r for r, _ in
                                                        burst[:2]],
           'first_step_logits_max_rel_err': rel, 'tol': TOL_LM_REL,
           'argmax_card': card_logits.argmax(-1).tolist(),
           'argmax_cpu': cpu_logits.argmax(-1).tolist(),
           'greedy_prefix_match': match, 'tokens': SERVE_NEW,
           'seconds': time.perf_counter() - t0}
    emit(row)
    for r in rel:
        check(r <= TOL_LM_REL, f'serve logits rel err {r} > {TOL_LM_REL}')
    launches_by_path = {mode: runs[mode][2]['launches'] for mode in runs}
    del runs
    torch.cuda.empty_cache()
    return launches_by_path


# The sequence-sharded page table (kv_sharded_serve; README "Cluster-scale
# long context"): the serve_path burst over KernelEngine(kv_shards=4,
# pages=512), 4 x 512 = SERVE_PAGES pages pooled; the README's user, one
# stream at t_max 32768 (decode_sharded's global cache) over the same four
# 512-page shards: capacity 32768 rows against 8192 unsharded, the
# decode_sharded prompt of 24544 tokens and 64 decode steps.
KV_SHARDS, KV_PAGES, KV_SLOTS, KV_T = 4, 512, 2, DS_T
# The step check at the long stream's shapes: its own ownership, ordinal
# boundaries at 515, 1030 and 1545 (columns 8240, 16480 and 24720, inside
# 128-column chunks); slot 0 filled to DS_PROMPT rows (shards 0-2 attend),
# slot 1 to 3000 (shard 0 alone); shard 3 owns no attended column. 1024
# pages a shard hold every owned ordinal of both slots.
KV_CUTS, KV_FILLS, KV_CHECK_PAGES = (0, 515, 1030, 1545), (DS_PROMPT, 3000), \
    1024


def _partials_errs(torch, got, want):
    """One shard's ``(num, m, l)`` partials against its plain version's.
    Rows the plain version attends (``l > 0``) are compared after the
    shift by ``m``: the normalised context ``num / l`` (row and
    whole-tensor relative errors) and the row's log-sum-exp ``m +
    log2 l``, absolute in natural-log units; rows it attends nowhere must
    be exactly ``(0, NEG_BIG, 0)`` in both."""
    import math
    import numpy as np
    from distributed_dot_product_tpu_torch.ops.flash_decode import _NEG_BIG
    (gn, gm, gl), (wn, wm, wl) = got, want
    held = (wl > 0).expand_as(wn)
    empty = ~held[..., :1]
    neg = float(np.float32(_NEG_BIG))
    exact = all(bool((x[e] == v).all()) for x, e, v in (
        (gn, ~held, 0.0), (wn, ~held, 0.0), (gm, empty, neg),
        (wm, empty, neg), (gl, empty, 0.0), (wl, empty, 0.0)))
    same_held = bool(torch.equal(gl > 0, wl > 0))
    if not held.any():
        return {'rows': 0, 'row_rel': 0.0, 'rel': 0.0, 'lse_abs': 0.0,
                'empty_exact': exact and same_held}
    o_got = torch.where(held, gn / gl.clamp_min(1e-30), 0.0)
    o_want = torch.where(held, wn / wl.clamp_min(1e-30), 0.0)
    row, whole = rel_errs(torch, o_got[held[..., 0]], o_want[held[..., 0]])
    lse = ((gm + torch.log2(gl.clamp_min(1e-30)))
           - (wm + torch.log2(wl.clamp_min(1e-30))))[~empty]
    return {'rows': int((~empty).sum()), 'row_rel': row, 'rel': whole,
            'lse_abs': abs(lse).max().item() * math.log(2),
            'empty_exact': exact and same_held}


def _kv_step_check(torch, ddp, flush, gen):
    """kv_sharded_serve (c): the four shards' K5p launches with partials
    on their local views of a stacked cache (random rows everywhere, the
    sinks included), merged by ``merge_partials``, against K5p on the
    single pool (the same stacked rows through one combined table), row
    1e-2 and norm 4e-3, and against the merge of the plain versions'
    partials at the same limits; each shard's partials against its plain
    version's (:func:`_partials_errs`); the empty shard-rows exactly (0,
    NEG_BIG, 0); the pools after the appends bit for bit the single
    pool's, the plain version's and the originals but the owners'
    appended rows. Then each shard's launch and the single-pool launch
    timed (no append)."""
    import importlib
    import numpy as np
    dec = importlib.import_module(
        'distributed_dot_product_tpu_torch.models.decode')
    fd = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_decode')
    dev, bf16 = torch.device('cuda'), torch.bfloat16
    n, b, h, d, ps = KV_SHARDS, KV_SLOTS, HEADS, HEAD_DIM, SERVE_PAGE
    pps, per = KV_T // ps, KV_CHECK_PAGES
    owner = np.searchsorted(KV_CUTS, np.arange(pps), side='right') - 1
    lengths = np.asarray(KV_FILLS, np.int64)
    spt = dec.ShardedPageTable(n, per, ps, b, pps)
    stacked = dec.init_sharded_paged_cache(n, b, h, KV_T, d,
                                           pages_per_shard=per, page_size=ps,
                                           dtype=bf16, device=dev)
    stacked.k_pool.copy_(randn(torch, stacked.k_pool.shape, gen, dev, bf16))
    stacked.v_pool.copy_(randn(torch, stacked.v_pool.shape, gen, dev, bf16))
    rng = np.random.default_rng(5)
    tables = np.full((n, b, pps), -1, np.int32)
    for sh in range(n):
        need = [(i, o) for i in range(b) for o in range(pps)
                if owner[o] == sh and o <= lengths[i] // ps]
        for (i, o), page in zip(need, rng.permutation(per)):
            tables[sh, i, o] = page
    combined = np.full((b, pps), -1, np.int32)
    for sh in range(n):
        held = tables[sh] >= 0
        combined[held] = spt.gpage(sh, tables[sh][held])
    stacked.page_table.copy_(torch.from_numpy(tables))
    q = randn(torch, (b, h, 1, d), gen, dev, bf16)
    kn, vn = (randn(torch, (b, h, 1, d), gen, dev, bf16) for _ in range(2))
    vt = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
    orig = (stacked.k_pool.clone(), stacked.v_pool.clone())
    single = tuple(x.clone() for x in orig)
    table = torch.from_numpy(combined).to(dev)
    want, _, _ = ddp.flash_decode(q, kn, vn, *single, vt, vt,
                                  page_table=table)
    views = [dec.shard_view(stacked, sh) for sh in range(n)]
    parts = [ddp.flash_decode(q, kn, vn, v.k_pool, v.v_pool, vt, vt,
                              page_table=v.page_table, partials=True)[0]
             for v in views]
    got = dec.merge_partials(parts, bf16)
    plain_pools = tuple(x.clone() for x in orig)
    plain_parts = [fd.flash_decode_plain(
        q, kn, vn, plain_pools[0].chunk(n)[sh], plain_pools[1].chunk(n)[sh],
        vt, vt, page_table=views[sh].page_table, partials=True)[0]
        for sh in range(n)]
    plain = dec.merge_partials(plain_parts, bf16)
    row, whole = rel_errs(torch, got, want)
    prow, pwhole = rel_errs(torch, got, plain)
    by_shard = [_partials_errs(torch, parts[sh], plain_parts[sh])
                for sh in range(n)]
    neg = float(np.float32(fd._NEG_BIG))
    empty = [(sh, i) for sh in range(n) for i in range(b)
             if not ((owner == sh) & (np.arange(pps) <= lengths[i] // ps)
                     ).any()]
    exact_empty = all(bool((parts[sh][0][i] == 0).all()
                           and (parts[sh][1][i] == neg).all()
                           and (parts[sh][2][i] == 0).all())
                      for sh, i in empty)
    expect = tuple(x.clone() for x in orig)
    for i in range(b):
        o = int(lengths[i]) // ps
        g = spt.gpage(int(owner[o]), int(tables[owner[o], i, o]))
        expect[0][g, :, int(lengths[i]) % ps] = kn[i, :, 0]
        expect[1][g, :, int(lengths[i]) % ps] = vn[i, :, 0]
    pools_equal_single = (torch.equal(stacked.k_pool, single[0])
                          and torch.equal(stacked.v_pool, single[1]))
    pools_only_appends = (torch.equal(stacked.k_pool, expect[0])
                          and torch.equal(stacked.v_pool, expect[1]))
    pools_equal_plain = (torch.equal(stacked.k_pool, plain_pools[0])
                         and torch.equal(stacked.v_pool, plain_pools[1]))
    # Times: no append (append_at -1), so repeats change nothing.
    noap = torch.full((b,), -1, dtype=torch.int32, device=dev)
    cols = torch.arange(KV_T, device=dev)
    attended = cols[None] <= vt[:, None].long()
    own = torch.as_tensor(owner, device=dev).repeat_interleave(ps)
    shards = {}
    for sh, v in enumerate(views):
        mask = (attended & (own[None] == sh))[:, None, None]
        bms, by, _, _ = _decode_bound(torch, mask, h, h, d, b, 1, 0,
                                      partials=True)
        shards[sh] = {
            'attended_owned_columns': mask.sum(dim=-1).flatten().tolist(),
            'ms': time_ms(torch, lambda v=v: ddp.flash_decode(
                q, kn, vn, v.k_pool, v.v_pool, vt, noap,
                page_table=v.page_table, partials=True), flush),
            'bound_ms': bms, 'bound_by': by}
    bms, by, _, _ = _decode_bound(torch, attended[:, None, None], h, h, d,
                                  b, 1, 0)
    single_ms = time_ms(torch, lambda: ddp.flash_decode(
        q, kn, vn, *single, vt, noap, page_table=table), flush)
    plain_ms = time_ms(torch, lambda: fd.flash_decode_plain(
        q, kn, vn, plain_pools[0].chunk(n)[0], plain_pools[1].chunk(n)[0],
        vt, noap, page_table=views[0].page_table, partials=True), flush,
        reps=5)
    res = {'phase': 'kv_sharded_serve', 'case': 'step_check',
           'shapes': {'slots': b, 'heads': h, 'head_dim': d, 't_max': KV_T,
                      'page_size': ps, 'shards': n, 'pages_per_shard': per,
                      'ordinal_cuts': list(KV_CUTS),
                      'lengths': lengths.tolist()},
           'vs_single_pool': {'max_row_rel_err': row, 'rel_err': whole,
                              'tol': {'row_rel': TOL_ROW_REL,
                                      'rel': TOL_NORM_REL}},
           'vs_plain': {'max_row_rel_err': prow, 'rel_err': pwhole,
                        'partials_by_shard': by_shard},
           'max_abs_err': (got.float() - plain.float()).abs().max().item(),
           'empty_shard_rows': empty, 'empty_rows_exact': exact_empty,
           'pools_equal_single_pool': pools_equal_single,
           'pools_equal_plain': pools_equal_plain,
           'pools_changed_only_at_owner_appends': pools_only_appends,
           'shards': shards, 'single_pool_ms': single_ms,
           'single_pool_bound_ms': bms, 'plain_ms_shard0': plain_ms,
           'library_ms': None}
    emit(res)
    check(row <= TOL_ROW_REL and whole <= TOL_NORM_REL,
          f'kv_sharded step: merged K5p partials vs single-pool K5p row '
          f'{row}, whole {whole}')
    check(prow <= TOL_ROW_REL and pwhole <= TOL_NORM_REL,
          f'kv_sharded step: merged K5p partials vs the merged plain '
          f'partials row {prow}, whole {pwhole}')
    for sh, e in enumerate(by_shard):
        check(e['row_rel'] <= TOL_ROW_REL and e['rel'] <= TOL_NORM_REL
              and e['lse_abs'] <= TOL_LSE and e['empty_exact'],
              f'kv_sharded step: shard {sh} K5p partials vs its plain '
              f'version: {e}')
    check(exact_empty, 'kv_sharded step: an empty shard-row is not exactly '
          '(0, NEG_BIG, 0)')
    check(pools_equal_plain, 'kv_sharded step: the shards\' pools differ '
          'from the plain version\'s after the appends')
    check(pools_equal_single, 'kv_sharded step: the shards\' pools differ '
          'from the single pool after the appends')
    check(pools_only_appends, 'kv_sharded step: a pool changed beyond its '
          'owner\'s appended rows')
    del stacked, views, single, plain_pools, orig, expect
    torch.cuda.empty_cache()
    return res


def _kv_burst(torch, ddp):
    """kv_sharded_serve (a): the serve_path burst over the single-pool
    paged engine and over the kv_shards engine of the same pooled pages,
    in this call; the sharded run's K5p launches = KV_SHARDS x its decode
    steps and no other decode kernel; the streams that diverge from the
    single pool's, with their first divergent step."""
    burst = serve_burst()
    runs = {}
    for name, kw in (('single_pool', {}),
                     ('kv_shards', dict(kv_shards=KV_SHARDS,
                                        pages=KV_PAGES))):
        engine = serve_engine(torch, 'paged', **kw)
        results, row = _serve_burst(torch, ddp, engine, burst, name)
        emit({'phase': 'kv_sharded_serve', 'case': f'burst_{name}', **row})
        runs[name] = (results, row)
        del engine
        torch.cuda.empty_cache()
    (base, brow), (sh, row) = runs['single_pool'], runs['kv_shards']
    diverged = {}
    for rid, r in sh.items():
        other = base.get(rid)
        if other is not None and r.tokens != other.tokens:
            k = 0
            while k < min(len(r.tokens), len(other.tokens)) \
                    and r.tokens[k] == other.tokens[k]:
                k += 1
            diverged[rid] = k
    same_status = {rid: (r.status, base[rid].status) for rid, r in sh.items()
                   if rid in base and r.status != base[rid].status}
    emit({'phase': 'kv_sharded_serve', 'case': 'burst_vs_single_pool',
          'tokens_per_s': {'kv_shards': row['tokens_per_s'],
                           'single_pool': brow['tokens_per_s']},
          'ttft_p99_s': {'kv_shards': row['ttft_s']['p99'],
                         'single_pool': brow['ttft_s']['p99']},
          'decode_steps': {'kv_shards': row['decode_steps'],
                           'single_pool': brow['decode_steps']},
          'diverged_first_step': diverged, 'status_differs': same_status,
          'note': 'bf16: the cross-shard merge adds in another order than '
                  'the kernel\'s cluster merge; streams reported, not '
                  'gated'})
    launches, steps = row['launches'], row['decode_steps']
    check(launches['flash_decode_paged'] == KV_SHARDS * steps,
          f'kv_shards burst: flash_decode_paged launched '
          f'{launches["flash_decode_paged"]} times for {steps} decode steps '
          f'x {KV_SHARDS} shards')
    check(launches['flash_decode'] == 0,
          f'kv_shards burst: flash_decode launched '
          f'{launches["flash_decode"]} times')
    return {'launches': launches['flash_decode_paged'], 'row': row,
            'single_pool': brow, 'diverged': diverged}


def _kv_forced(torch, burst):
    """kv_sharded_serve (a), teacher-forced: the burst's first SERVE_SLOTS
    prompts prefilled into a single-pool engine and a kv_shards engine of
    the same pooled pages, then SERVE_NEW steps of both, every step fed
    the single pool's own greedy tokens. The logits each engine's ``step``
    takes its argmax of (captured where it checks them for finiteness)
    are held against each other at the decode limits, row 1e-2 and norm
    4e-3, on every step; at each step where the argmaxes differ, the
    single pool's top-2 gap beside the sharded logits' error at those two
    tokens (a flip needs the gap no larger than their sum: what the
    listing shows is how small the gaps that flip are)."""
    import importlib
    import numpy as np
    em = importlib.import_module(
        'distributed_dot_product_tpu_torch.serve.engine')
    engines = {'single_pool': serve_engine(torch, 'paged'),
               'kv_shards': serve_engine(torch, 'paged', kv_shards=KV_SHARDS,
                                         pages=KV_PAGES)}
    prompts = [p for _, p in burst[:SERVE_SLOTS]]
    tokens = np.array([p[-1] for p in prompts], np.int32)
    active = np.ones(SERVE_SLOTS, bool)
    for eng in engines.values():
        for i, p in enumerate(prompts):
            for start in range(0, len(p) - 1, eng.prefill_chunk):
                eng.prefill(i, p[start:min(start + eng.prefill_chunk,
                                           len(p) - 1)])
    seen, real = [], em.slots_all_finite

    def capture(logits):
        seen.append(logits[:, 0].float())
        return real(logits)
    em.slots_all_finite = capture
    worst, flips, finite = [0.0, 0.0], [], True
    try:
        for t in range(SERVE_NEW):
            seen.clear()
            out = {name: eng.step(tokens, active)
                   for name, eng in engines.items()}
            ref, got = seen
            row, whole = rel_errs(torch, got, ref)
            worst = [max(worst[0], row), max(worst[1], whole)]
            finite = finite and all(f.all() for _, f in out.values())
            a, b = out['single_pool'][0], out['kv_shards'][0]
            for i in np.nonzero(a != b)[0]:
                top = torch.topk(ref[i], 2).values
                flips.append({
                    'slot': int(i), 'step': t,
                    'top2_gap': (top[0] - top[1]).item(),
                    'err_at_the_two': [
                        abs(got[i, j] - ref[i, j]).item()
                        for j in (int(a[i]), int(b[i]))],
                    'max_abs_logit_err': (got[i] - ref[i]).abs().max()
                    .item()})
            tokens = a
    finally:
        em.slots_all_finite = real
    row = {'phase': 'kv_sharded_serve', 'case': 'burst_teacher_forced',
           'slots': SERVE_SLOTS, 'steps': SERVE_NEW,
           'prompt_lengths': [len(p) for p in prompts],
           'logits_vs_single_pool': {'max_row_rel_err': worst[0],
                                     'rel_err': worst[1],
                                     'tol': {'row_rel': TOL_ROW_REL,
                                             'rel': TOL_NORM_REL}},
           'argmax_flips': flips,
           'max_flip_top2_gap': max((f['top2_gap'] for f in flips),
                                    default=None),
           'finite': bool(finite)}
    emit(row)
    check(finite, 'kv_shards teacher-forced: non-finite logits')
    check(worst[0] <= TOL_ROW_REL and worst[1] <= TOL_NORM_REL,
          f'kv_shards teacher-forced: logits vs the single pool row '
          f'{worst[0]}, whole {worst[1]}')
    del engines
    torch.cuda.empty_cache()
    return row


def _kv_long(torch, ddp, flush, gen):
    """kv_sharded_serve (b): the README's user. capacity_tokens 32768 at
    kv_shards=4 against 8192 for one shard of the same 512 pages; the
    24544-token prompt refused by the unsharded engine's Scheduler with
    a typed CACHE_EXHAUSTED, admitted by the sharded one and decoded for
    64 tokens (K5p launches = 4 x decode steps); ms per decode step and,
    halfway, each shard's K5p partials launch timed on the live cache."""
    import numpy as np
    from distributed_dot_product_tpu_torch.serve import (
        RejectedError, RejectReason, Scheduler, ServeConfig,
    )
    from distributed_dot_product_tpu_torch.utils.tracing import (
        MetricsRegistry,
    )
    prompt = np.random.default_rng(SERVE_SEED + 1).integers(
        0, VOCAB, size=DS_PROMPT).astype(np.int32)
    one = serve_engine(torch, 'paged', slots=KV_SLOTS, t_max=KV_T,
                       pages=KV_PAGES)
    cap_one = one.capacity_tokens
    refusal = None
    with Scheduler(one, ServeConfig(queue_limit=SERVE_QUEUE,
                                    max_new_tokens=DS_STEPS, watchdog=False),
                   registry=MetricsRegistry(), fault_injector=False) as s1:
        try:
            s1.submit(prompt, request_id='long')
        except RejectedError as e:
            refusal = (e.reason, str(e))
    del one
    eng = serve_engine(torch, 'paged', slots=KV_SLOTS, t_max=KV_T,
                       pages=KV_PAGES, kv_shards=KV_SHARDS)
    eng.step(np.zeros(KV_SLOTS, np.int32), np.ones(KV_SLOTS, bool))
    for i in range(KV_SLOTS):
        eng.reset(i)
    torch.cuda.synchronize()
    step_ms, shard_ms = [], {}
    inner = eng.step

    def timed_step(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*a, **k)
        step_ms.append(1e3 * (time.perf_counter() - t0))
        return out
    eng.step = timed_step
    dev, bf16 = eng.device, torch.bfloat16
    q = randn(torch, (KV_SLOTS, HEADS, 1, HEAD_DIM), gen, dev, bf16)
    noap = torch.full((KV_SLOTS,), -1, dtype=torch.int32, device=dev)

    def on_tick(sched):
        # Halfway through the decode, each shard's launch on the live
        # cache (no append; counted launches restored after).
        if len(step_ms) != DS_STEPS // 2 or shard_ms:
            return
        before = ddp.flash_decode_paged.launches
        vt = torch.as_tensor(np.maximum(eng.pool.lengths - 1, 0),
                             dtype=torch.int32, device=dev)
        for sh in range(KV_SHARDS):
            v = eng.shard_cache(sh)
            shard_ms[sh] = time_ms(torch, lambda v=v: ddp.flash_decode(
                q, q, q, v.k_pool, v.v_pool, vt, noap,
                page_table=v.page_table, partials=True), flush)
        ddp.flash_decode_paged.launches = before
    registry = MetricsRegistry()
    sched = Scheduler(eng, ServeConfig(queue_limit=SERVE_QUEUE,
                                       max_new_tokens=DS_STEPS,
                                       watchdog=False),
                      registry=registry, fault_injector=False,
                      on_tick=on_tick)
    ddp.flash_decode.launches = 0
    ddp.flash_decode_paged.launches = 0
    t0 = time.perf_counter()
    try:
        sched.submit(prompt, request_id='long')
        results = sched.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sched.close()
    launches = {'flash_decode': ddp.flash_decode.launches,
                'flash_decode_paged': ddp.flash_decode_paged.launches}
    counters = registry.snapshot()['counters']
    steps = counters.get('serve.decode_steps', 0)
    r = results.get('long')
    row = {'phase': 'kv_sharded_serve', 'case': 'long_stream',
           'engine': {'slots': KV_SLOTS, 't_max': KV_T, 'kv_shards':
                      KV_SHARDS, 'pages_per_shard': KV_PAGES,
                      'page_size': SERVE_PAGE, 'placement': eng.placement},
           'capacity_tokens': {'kv_shards': eng.capacity_tokens,
                               'one_shard': cap_one},
           'prompt': DS_PROMPT, 'unsharded_refusal': (
               None if refusal is None else [refusal[0].value, refusal[1]]),
           'status': None if r is None else r.status,
           'tokens': 0 if r is None else len(r.tokens),
           'decode_steps': steps, 'wall_s': wall,
           'ms_per_step_median': (statistics.median(step_ms)
                                  if step_ms else None),
           'k5p_ms_by_shard_halfway': shard_ms,
           'pages_free_by_shard_after': eng.pool.free_pages_by_shard,
           'launches': launches}
    emit(row)
    check(eng.capacity_tokens == KV_T and cap_one == KV_PAGES * SERVE_PAGE,
          f'capacity_tokens {eng.capacity_tokens} sharded, {cap_one} '
          f'unsharded')
    check(refusal is not None
          and refusal[0] is RejectReason.CACHE_EXHAUSTED,
          f'the unsharded engine did not refuse the {DS_PROMPT}-token '
          f'prompt with CACHE_EXHAUSTED: {refusal}')
    check(r is not None and r.status == 'completed'
          and len(r.tokens) == DS_STEPS,
          f'long stream: {None if r is None else (r.status, len(r.tokens))}')
    check(launches['flash_decode_paged'] == KV_SHARDS * steps
          and launches["flash_decode"] == 0 and steps == DS_STEPS,
          f'long stream: launches {launches} for {steps} decode steps')
    check(len(shard_ms) == KV_SHARDS, 'long stream: shards not timed')
    del eng, sched
    torch.cuda.empty_cache()
    return {'launches': launches['flash_decode_paged'], 'row': row}


def phase_kv_sharded_serve(torch, ddp, flush, gen):
    """The sequence-sharded page table: (c) the step check, (a) the burst
    and its teacher-forced logits, (b) the long stream (see the
    helpers)."""
    step = _kv_step_check(torch, ddp, flush, gen)
    burst = _kv_burst(torch, ddp)
    forced = _kv_forced(torch, serve_burst())
    long = _kv_long(torch, ddp, flush, gen)
    return {'step': step, 'burst': burst, 'forced': forced, 'long': long}


# Speculative serving (spec_serve): the serve_path burst with spec_k = 4
# (verify width 5, the VERIFY_K of flash_decode_verify).
SPEC_K = 4
SPEC_PROPOSERS = ('ngram', 'draft')


def _tick_parts(records):
    """Where a burst's decode ticks spend their wall time, from the
    scheduler's and engine's spans: the spec ticks (``serve.decode_step``
    with ``spec``) and inside them the fused verify step and the
    rollbacks (the target's and the draft twin's); the proposer
    (``serve.spec.propose``, the draft twin's steps inside it; the
    twin's rollbacks count with the rollbacks); the plain
    ticks and their one-token steps. Each part: count, total seconds and
    mean ms."""
    parts = {}

    def add(part, rec):
        agg = parts.setdefault(part, {'count': 0, 'total_s': 0.0})
        agg['count'] += 1
        agg['total_s'] += rec.seconds
    for rec in records:
        spec_tick = dict(rec.attrs).get('spec', False)
        if rec.name == 'serve.decode_step':
            add('spec_tick' if spec_tick else 'plain_tick', rec)
        elif rec.name == 'serve.spec.propose':
            add('propose', rec)
        elif rec.name == 'engine.verify_step':
            add('verify_step', rec)
        elif rec.name == 'engine.rollback':
            add('rollback', rec)
        elif rec.name == 'engine.decode_step':
            add('draft_step' if 'serve.spec.propose' in rec.path
                else 'plain_step', rec)
    for agg in parts.values():
        agg['mean_ms'] = 1e3 * agg['total_s'] / agg['count']
    return parts


def _spec_run(torch, ddp, mode, spec, burst):
    """One burst through the Scheduler over a fresh engine with proposer
    ``spec`` (None: the non-spec twin). Returns (streams, row)."""
    import numpy as np
    from distributed_dot_product_tpu_torch.serve import (
        RejectedError, Scheduler, ServeConfig,
    )
    from distributed_dot_product_tpu_torch.obs import spans as obs_spans
    from distributed_dot_product_tpu_torch.utils.tracing import (
        MetricsRegistry,
    )
    engine = serve_engine(torch, mode)
    registry = MetricsRegistry()
    sched = Scheduler(engine, ServeConfig(
        queue_limit=SERVE_QUEUE, max_new_tokens=SERVE_NEW, spec=spec,
        spec_k=SPEC_K), registry=registry, fault_injector=False)
    draft = getattr(sched._proposer, 'engine', None)
    # Warm every engine operation (the draft's too) before the burst:
    # first use would otherwise count as a stall.
    for eng in (engine, draft):
        if eng is None:
            continue
        on = np.ones(SERVE_SLOTS, bool)
        eng.step(np.zeros(SERVE_SLOTS, np.int32), on)
        eng.verify_step(np.zeros((SERVE_SLOTS, SPEC_K + 1), np.int32),
                        np.full(SERVE_SLOTS, SPEC_K + 1), on)
        eng.rollback(np.zeros(SERVE_SLOTS, np.int64))
        eng.prefill(0, np.zeros(SERVE_CHUNK, np.int32))
        for i in range(SERVE_SLOTS):
            eng.reset(i)
    torch.cuda.synchronize()
    calls = {'verify_ticks': 0, 'draft_steps': 0}

    def counting(fn, name):
        def counted(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return counted
    engine.verify_step = counting(engine.verify_step, 'verify_ticks')
    if draft is not None:
        draft.step = counting(draft.step, 'draft_steps')
    # The main path: counts at 0 just before the burst, read just after.
    for fn in (ddp.flash_decode, ddp.flash_decode_paged):
        fn.launches = fn.verify_launches = fn.int8_launches = 0
    rejected = {}
    # The scheduler's and engine's spans are on for every run (spec and
    # non-spec alike): they split a tick into its parts (_tick_parts).
    spans = obs_spans.enable(True)
    spans.clear()
    t0 = time.perf_counter()
    try:
        for i, (rid, prompt) in enumerate(burst):
            try:
                sched.submit(prompt, request_id=rid)
            except RejectedError as e:
                rejected[rid] = e.reason.value
            if i % 4 == 3:
                sched.step()
        results = sched.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sched.close()
        obs_spans.enable(False)
    launches = {}
    for fn in (ddp.flash_decode, ddp.flash_decode_paged):
        launches[fn.__name__] = fn.launches
        launches[f'{fn.__name__}.verify'] = fn.verify_launches
    records = spans.records()
    snap = registry.snapshot()
    counters, hist = snap['counters'], snap['histograms']
    tokens = counters.get('serve.tokens_generated', 0)
    steps = counters.get('serve.decode_steps', 0)
    row = {'phase': 'spec_serve', 'cache_mode': mode, 'spec': spec,
           'spec_k': SPEC_K, 'requests': len(burst),
           'rejected_at_submit': rejected, 'tokens_generated': tokens,
           'decode_ticks': steps, 'verify_ticks': calls['verify_ticks'],
           'draft_steps': calls['draft_steps'],
           'wall_s': wall, 'tokens_per_s': tokens / wall,
           'ttft_p99_s': hist['serve.ttft_seconds']['p99'],
           'launches': launches, 'watchdog_stalls':
               sched.health.stall_events, 'tick_parts': _tick_parts(records)}
    if spec is not None:
        for name in ('proposed', 'accepted'):
            h = hist.get(f'serve.spec.{name}_per_step', {})
            row[f'{name}_per_verify_step'] = h.get('mean')
            row[f'{name}_total'] = h.get('total_sum')
    streams = {rid: (r.status, list(r.tokens))
               for rid, r in results.items()}
    return streams, row


def phase_spec_serve(torch, ddp):
    """The serve_path burst with speculative decoding (n-gram and the
    self-draft twin, spec_k = 4) over the paged (K5p) and slab (K5)
    engines: every committed stream must equal the non-spec twin's token
    for token, the target kernel's verify launches must equal the verify
    ticks and its launches the decode ticks; tokens/s, TTFT p99, decode
    ticks, proposed and accepted per verify step, and the draft twin's
    K5 launches."""
    burst = serve_burst()
    out = {}
    for mode in ('paged', 'slab'):
        target = 'flash_decode_paged' if mode == 'paged' else 'flash_decode'
        base, base_row = _spec_run(torch, ddp, mode, None, burst)
        emit(base_row)
        check(base_row['verify_ticks'] == 0, f'{mode}: non-spec verify')
        for spec in SPEC_PROPOSERS:
            streams, row = _spec_run(torch, ddp, mode, spec, burst)
            ln = row['launches']
            verify = ln[f'{target}.verify']
            differ = sorted(rid for rid in base if streams.get(rid)
                            != base[rid])
            # The draft twin is a slab engine: its steps are K5 launches,
            # beside the target's own on the slab engine.
            draft = ln['flash_decode'] - (row['decode_ticks']
                                          if mode == 'slab' else 0)
            row.update(streams_equal_non_spec=not differ, diverged=differ,
                       target_kernel=target,
                       target_verify_launches=verify,
                       draft_k5_launches=draft,
                       vs_non_spec={
                           'tokens_per_s': base_row['tokens_per_s'],
                           'ttft_p99_s': base_row['ttft_p99_s'],
                           'decode_ticks': base_row['decode_ticks'],
                           'tick_parts': base_row['tick_parts']})
            emit(row)
            check(not differ, f'{mode} {spec}: streams differ from the '
                              f'non-spec run: {differ[:5]}')
            check(set(streams) == set(base), f'{mode} {spec}: results')
            check(verify == row['verify_ticks'] > 0,
                  f'{mode} {spec}: {verify} verify launches for '
                  f'{row["verify_ticks"]} verify ticks')
            check((row['draft_steps'] > 0) == (spec == 'draft'),
                  f'{mode} {spec}: {row["draft_steps"]} draft steps')
            # One target launch a tick, one K5 launch a draft step.
            if mode == 'slab':
                check(ln['flash_decode'] == row['decode_ticks']
                      + row['draft_steps'],
                      f'slab {spec}: {ln["flash_decode"]} K5 launches for '
                      f'{row["decode_ticks"]} decode ticks + '
                      f'{row["draft_steps"]} draft steps')
            else:
                check(ln[target] == row['decode_ticks'],
                      f'paged {spec}: {ln[target]} K5p launches for '
                      f'{row["decode_ticks"]} decode ticks')
                check(ln['flash_decode'] == row['draft_steps'],
                      f'paged {spec}: {ln["flash_decode"]} K5 launches for '
                      f'{row["draft_steps"]} draft steps')
            out[f'{mode}_{spec}'] = row
        torch.cuda.empty_cache()
    return out


# The int8 cached-inference configuration (int8_decode): the gqa_ring
# stage's module without segments or dropout — key_dim 512 over 8 heads on
# 4 kv heads, causal, RoPE, int8 QK^T — in bf16, batch 4, a cache of 8192
# columns; K1 int8 prefills 8128 rows, then 64 decode steps.
INT8_B, INT8_T, INT8_STEPS = 4, 8192, 64
INT8_PROMPT = INT8_T - INT8_STEPS
INT8_PAGED_STEPS = 8      # the paged route's steps (K5p int8)


def _paged_twin(torch, ddp, cache, gen):
    """A paged cache at the serving page size holding the slab ``cache``'s
    rows (and its int8 mirror, when it carries one), its pages
    scrambled."""
    import numpy as np
    b, h_kv, t, d = cache.k.shape
    pps = t // SERVE_PAGE
    quant = cache.k_q is not None
    pc = ddp.init_paged_cache(b, h_kv, t, d, pages=b * pps,
                              page_size=SERVE_PAGE, dtype=cache.k.dtype,
                              qk_quant='int8' if quant else None,
                              device=cache.k.device)
    order = torch.randperm(b * pps, generator=gen).to(cache.k.device)
    pc.page_table.copy_(order.view(b, pps))
    pairs = [(pc.k_pool, cache.k), (pc.v_pool, cache.v)]
    if quant:
        pairs += [(pc.k_q_pool, cache.k_q), (pc.k_scale_pool, cache.k_scale)]
    for pool, slab in pairs:
        pool[order] = slab.unflatten(2, (pps, SERVE_PAGE)).transpose(
            1, 2).flatten(0, 1)
    return pc._replace(length=np.full(b, int(cache.length), np.int64))


def phase_int8_decode(torch, ddp):
    """An int8 module's cached inference: K1 int8 prefill, then 64 decode
    steps through K5 with the int8 mirror (one launch a step), each step
    held against the module's own int8 forward over the sequence (row t
    of a causal forward is the decode at position t) and against the
    plain decode on the card; ms per step. Then the paged route: the
    module's projections of the first steps through ``decode_step`` on a
    paged cache with the mirror pools (K5p int8, one launch a step), held
    bit for bit against the slab run: outputs and mirror rows."""
    from distributed_dot_product_tpu_torch.models.decode import (
        paged_gather_mirror,
    )
    dev, bf16 = torch.device('cuda'), torch.bfloat16
    mod = ddp.DistributedDotProductAttn(
        key_dim=SP_DIM, num_heads=SP_HEADS, num_kv_heads=SP_HEADS // 2,
        causal=True, use_rope=True, qk_quant='int8', softmax_impl='flash',
        distributed=False, dtype=bf16, device=dev,
        generator=torch.Generator().manual_seed(13))
    gen = torch.Generator().manual_seed(31)
    x = randn(torch, (INT8_B, INT8_T, SP_DIM), gen, dev, bf16)
    res = {}
    with torch.no_grad():
        cache = mod.make_decode_cache(INT8_B, INT8_T)
        check(cache.k_q is not None and cache.k_q.dtype == torch.int8,
              'int8 module cache carries no int8 mirror')
        p = x[:, :INT8_PROMPT]
        # The module's whole prefill (host clock to a synchronize): first
        # on a scratch cache (its first call loads the kernel library),
        # then the one the decode steps use, warm.
        for key, c in (('prefill_first_ms',
                        mod.make_decode_cache(INT8_B, INT8_T)),
                       ('prefill_ms', cache)):
            ddp.flash_attention.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c, _ = mod.prefill(p, p, p, c)
            torch.cuda.synchronize()
            res[key] = 1e3 * (time.perf_counter() - t0)
        cache = c
        res['prefill_k1_launches'] = ddp.flash_attention.launches
        twin = cache._replace(**{n: getattr(cache, n).clone() for n in
                                 ('k', 'v', 'k_q', 'k_scale')})
        paged = _paged_twin(torch, ddp, cache, gen)
        # The main path: counts at 0 just before, read just after.
        for fn in (ddp.flash_attention, ddp.flash_decode,
                   ddp.flash_decode_paged):
            fn.launches = 0
        ddp.flash_decode.int8_launches = 0
        outs, ms = [], []
        for t in range(INT8_STEPS):
            xt = x[:, INT8_PROMPT + t:INT8_PROMPT + t + 1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache, out = mod.decode(xt, xt, xt, cache)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            outs.append(out)
        launches = {'flash_decode': ddp.flash_decode.launches,
                    'flash_decode.int8': ddp.flash_decode.int8_launches,
                    'flash_decode_paged': ddp.flash_decode_paged.launches,
                    'flash_attention': ddp.flash_attention.launches}
        got = torch.cat(outs, dim=1)
        # The paged route: counts at 0 just before, read just after.
        for fn in (ddp.flash_decode, ddp.flash_decode_paged):
            fn.launches = fn.int8_launches = 0
        paged_outs, paged_ms = [], []
        for t in range(INT8_PAGED_STEPS):
            xt = x[:, INT8_PROMPT + t:INT8_PROMPT + t + 1]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            k_t, q_t, v_t = mod._project(xt, xt, xt, INT8_PROMPT + t)
            paged, out = ddp.decode_step(
                k_t, paged, q_t, v_t, scale=1.0 / math.sqrt(mod.head_dim),
                window=mod.window, qk_quant='int8')
            out = mod._merge_heads(out)
            torch.cuda.synchronize()
            paged_ms.append(1e3 * (time.perf_counter() - t0))
            paged_outs.append(out)
        paged_launches = {
            'flash_decode_paged': ddp.flash_decode_paged.launches,
            'flash_decode_paged.int8': ddp.flash_decode_paged.int8_launches,
            'flash_decode': ddp.flash_decode.launches}
        filled = INT8_PROMPT + INT8_PAGED_STEPS
        pk_q, pk_s = paged_gather_mirror(paged)
        paged_same = {
            'outputs': bool(torch.equal(torch.cat(paged_outs, dim=1),
                                        got[:, :INT8_PAGED_STEPS])),
            'mirror': bool(torch.equal(pk_q[:, :, :filled],
                                       cache.k_q[:, :, :filled])
                           and torch.equal(pk_s[:, :, :filled],
                                           cache.k_scale[:, :, :filled]))}
        del paged, pk_q, pk_s
        mod.decode_impl = 'plain'
        plain = []
        for t in range(INT8_STEPS):
            xt = x[:, INT8_PROMPT + t:INT8_PROMPT + t + 1]
            twin, out = mod.decode(xt, xt, xt, twin)
            plain.append(out)
        plain = torch.cat(plain, dim=1)
        mod.decode_impl = None
        fwd = mod(x, x, x, deterministic=True)[:, INT8_PROMPT:]
        torch.cuda.synchronize()
    mirror_same = bool(torch.equal(cache.k_q, twin.k_q)
                       and torch.equal(cache.k_scale, twin.k_scale))
    errs = {'vs_forward': rel_errs(torch, got, fwd),
            'vs_plain': rel_errs(torch, got, plain)}
    row = {'phase': 'int8_decode', 'batch': INT8_B, 'cache': INT8_T,
           'prompt': INT8_PROMPT, 'steps': INT8_STEPS,
           'module': {'key_dim': SP_DIM, 'num_heads': SP_HEADS,
                      'num_kv_heads': SP_HEADS // 2, 'qk_quant': 'int8',
                      'use_rope': True, 'dtype': 'bfloat16'},
           **res, 'launches': launches,
           'step_ms': {'median': statistics.median(ms), 'min': min(ms),
                       'max': max(ms)},
           'max_row_rel_err': {n: e[0] for n, e in errs.items()},
           'rel_err': {n: e[1] for n, e in errs.items()},
           'tol': {'row_rel': TOL_ROW_REL, 'rel': TOL_NORM_REL},
           'mirror_equal_plain_twin': mirror_same,
           'finite': bool(torch.isfinite(got).all().item()),
           'paged': {'page_size': SERVE_PAGE, 'steps': INT8_PAGED_STEPS,
                     'launches': paged_launches,
                     'step_ms': {'median': statistics.median(paged_ms),
                                 'min': min(paged_ms),
                                 'max': max(paged_ms)},
                     'bit_equal_slab': paged_same}}
    emit(row)
    check(row['finite'], 'int8_decode: non-finite output')
    check(launches['flash_decode'] == INT8_STEPS
          and launches['flash_decode.int8'] == INT8_STEPS,
          f'int8_decode: launches {launches} for {INT8_STEPS} steps')
    check(launches['flash_attention'] == 0
          and launches['flash_decode_paged'] == 0,
          f'int8_decode: other kernels launched {launches}')
    check(mirror_same, 'int8_decode: the mirror differs from the plain '
                       'twin\'s')
    check(paged_launches['flash_decode_paged'] == INT8_PAGED_STEPS
          and paged_launches['flash_decode_paged.int8'] == INT8_PAGED_STEPS
          and paged_launches['flash_decode'] == 0,
          f'int8_decode paged: launches {paged_launches} for '
          f'{INT8_PAGED_STEPS} steps')
    check(all(paged_same.values()),
          f'int8_decode paged: not bit-equal to the slab run {paged_same}')
    fails = check_rel(errs, 'int8_decode')
    check(not fails, '; '.join(fails))
    row['int8_kernels'], fails = int8_timing(torch, gen)
    emit({'phase': 'int8_decode', 'case': 'int8_timing',
          **row['int8_kernels']})
    check(not fails, '; '.join(fails))
    return row


def int8_timing(torch, gen):
    """K1, K3 and K4 with int8 scoring (their s8 wgmma bodies) timed at
    this phase's prefill (K1: 8128 rows of the 8192-column cache, its tail
    zero) and at the flagship gqa_ring stage's diagonal ring fold (K1, K3
    and K4: 2 x 4096 rows a rank, packed segments, dropout 0.1, float32
    gradients as the ring takes them), both GQA 8:4 at head dim 64. ``ms``
    is the kernel's launch with the int8 operands made beforehand and,
    with ``--parent``, ``parent_ms`` the parent checkout's kernel on the
    same call in the same run; beside them the public wrapper's time with
    the quantization (``wrapper_ms``, K1), the quantization alone
    (``quant_ms``, quant_operands of q and k) and the dequantized operand
    (``dequant_ms``, made inside ``ms``: K3's k~, K4's q~); the plain
    version, the bound (the int8 products at the int8 rate, the others at
    the bf16 rate, or the bytes) and, for scale only, SDPA's bf16 causal
    forward on the same shape (no PyTorch call computes int8 scoring).
    At the gqa_ring fold K3's dq and K4's dk, dv are also held against
    their plain versions (``row_rel``, ``rel``; the flash_masks limits).
    Returns ``(times, failures)``."""
    import importlib
    fa = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_attention')
    F = torch.nn.functional
    dev, bf16 = torch.device('cuda'), torch.bfloat16
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32, device=dev)
    d, hq, hkv = SP_HEAD_DIM, SP_HEADS, SP_HEADS // 2
    scale = 1.0 / math.sqrt(d)
    out = {'library': 'sdpa forward in bf16, causal: scale only'}
    failures = []
    for name, b, tq, tk, packed, rate in (
            ('int8_decode_prefill', INT8_B, INT8_PROMPT, INT8_T, False, 0.0),
            ('gqa_ring_fold', SP_B // SP_DATA, SP_TN, SP_TN, True,
             FS_RATE)):
        q = randn(torch, (b, hq, tq, d), gen, dev, bf16)
        k = torch.zeros((b, hkv, tk, d), dtype=bf16, device=dev)
        v = torch.zeros_like(k)
        k[:, :, :tq] = randn(torch, (b, hkv, tq, d), gen, dev, bf16)
        v[:, :, :tq] = randn(torch, (b, hkv, tq, d), gen, dev, bf16)
        seg = None
        if packed:
            one = ragged_segments(torch, gen, b, tq).to(dev)
            seg = (one, one)
        kw = dict(causal=True, scale=scale, qk_quant='int8',
                  segment_ids=seg, dropout_rate=rate,
                  dropout_seed=MASK_SEED if rate else None)
        quant = fa.quant_operands(q, k)
        pairs = hq * valid_pairs(torch, b, tq, tk, True, 0, 0, None, seg)
        s_ops = 2 * d * pairs
        q_b, kv_b = b * hq * tq * d, b * hkv * tk * d   # elements
        rows_b = 4 * b * (hq * tq + hkv * tk)           # row scales
        seg_b = 8 * b * tq if seg is not None else 0
        bms, by = bound_mixed(s_ops, s_ops,
                              q_b + kv_b + 2 * kv_b + 2 * q_b + rows_b
                              + seg_b)
        lib_kw = dict(scale=scale, enable_gqa=True)
        if tq == tk:
            lib_kw['is_causal'] = True
        else:
            lib_kw['attn_mask'] = (torch.arange(tk, device=dev)[None, :]
                                   <= torch.arange(tq, device=dev)[:, None])
        ms, parent = ab_ms(torch, lambda m: functools.partial(
            m._launch, q, k, v, None, True, 0, 0, scale, feat=m._features(
                q, k, True, seg, None, rate, kw['dropout_seed'], 'int8'),
            quant=quant), fa, flush)
        quant_ms = time_ms(torch, lambda: fa.quant_operands(q, k), flush)
        common = {'q': list(q.shape), 'kv': list(k.shape), 'pairs': pairs,
                  'segments': seg is not None, 'dropout_rate': rate}
        out[name] = {
            **common, 'ms': ms, 'parent_ms': parent,
            'wrapper_ms': time_ms(torch, lambda: fa.flash_attention(
                q, k, v, **kw), flush),
            'quant_ms': quant_ms,
            'plain_ms': time_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, **kw), flush, reps=3),
            'library_ms': time_ms(
                torch, lambda: F.scaled_dot_product_attention(q, k, v,
                                                              **lib_kw),
                flush),
            'bound_ms': bms, 'bound_by': by}
        if not packed:
            continue
        # K4 at the fold, from this fold's forward, float32 gradients.
        o, lse = fa.flash_attention_with_lse(q, k, v, **kw)
        g = randn(torch, (b, hq, tq, d), gen, dev, bf16)
        q2, lse2, delta = fa.flash_attention_bwd_operands(q, o, lse, g,
                                                          scale)
        bw = dict(causal=True, scale=scale, segment_ids=seg,
                  dropout_rate=rate, dropout_seed=kw['dropout_seed'],
                  quant=quant, grad_dtype=torch.float32)
        # K3: S in int8, dP and dQ in bf16; dq written in float32.
        bms, by = bound_mixed(2 * s_ops, s_ops,
                              q_b + kv_b + 2 * kv_b + 2 * q_b + 4 * q_b
                              + 8 * b * hq * tq + rows_b + seg_b)
        ms, parent = ab_ms(torch, lambda m: functools.partial(
            m.flash_attention_dq, q2, k, v, g, lse2, delta, **bw), fa, flush)
        rel = {'dq': rel_errs(torch, fa.flash_attention_dq(
            q2, k, v, g, lse2, delta, **bw), fa.flash_attention_dq_plain(
                q2, k, v, g, lse2, delta, **bw))}
        failures += check_rel(rel, 'k3_' + name)
        out['k3_' + name] = {
            **common, 'row_rel': rel['dq'][0], 'rel': rel['dq'][1],
            'ms': ms, 'parent_ms': parent, 'quant_ms': quant_ms,
            'dequant_ms': time_ms(torch, lambda: fa.dequantize_rows(
                quant[2], quant[3], bf16), flush),
            'plain_ms': time_ms(torch, lambda: fa.flash_attention_dq_plain(
                q2, k, v, g, lse2, delta, **bw), flush, reps=3),
            'library_ms': None, 'bound_ms': bms, 'bound_by': by}
        bms, by = bound_mixed(3 * s_ops, s_ops,
                              q_b + kv_b + 2 * kv_b + 2 * q_b
                              + 8 * kv_b + 8 * b * hq * tq + rows_b
                              + seg_b)
        ms, parent = ab_ms(torch, lambda m: functools.partial(
            m.flash_attention_dkv, q2, k, v, g, lse2, delta, **bw), fa, flush)
        rel = dict(zip(('dk', 'dv'), (
            rel_errs(torch, x, y) for x, y in zip(
                fa.flash_attention_dkv(q2, k, v, g, lse2, delta, **bw),
                fa.flash_attention_dkv_plain(q2, k, v, g, lse2, delta,
                                             **bw)))))
        failures += check_rel(rel, 'k4_' + name)
        out['k4_' + name] = {
            **common, 'row_rel': {n: e[0] for n, e in rel.items()},
            'rel': {n: e[1] for n, e in rel.items()},
            'ms': ms, 'parent_ms': parent, 'quant_ms': quant_ms,
            'dequant_ms': time_ms(torch, lambda: fa.dequantize_rows(
                quant[0], quant[1], bf16), flush),
            'plain_ms': time_ms(torch, lambda: fa.flash_attention_dkv_plain(
                q2, k, v, g, lse2, delta, **bw), flush, reps=3),
            'library_ms': None, 'bound_ms': bms, 'bound_by': by}
    out['bwd_library'] = 'none: no PyTorch call computes int8 scoring'
    del flush
    return out, failures


def phase_main_path(torch, ddp):
    from distributed_dot_product_tpu_torch.models.lm import greedy_generate
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(0)
    t0 = time.perf_counter()
    model = ddp.TransformerLM(VOCAB, DIM, HEADS, n_layers=LAYERS,
                              dtype=torch.bfloat16,
                              param_dtype=torch.bfloat16, device=dev,
                              generator=gen)
    prompts = torch.randint(0, VOCAB, (BATCH, PROMPT), generator=gen
                            ).to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    build_s = time.perf_counter() - t0

    greedy_generate(model, prompts, 2, T_MAX)          # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    greedy_generate(model, prompts, 1, T_MAX)          # prefill only
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)

    ddp.flash_attention.launches = 0
    ddp.flash_decode.launches = 0
    t0 = time.perf_counter()
    tokens = greedy_generate(model, prompts, STEPS, T_MAX)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = {'flash_attention': ddp.flash_attention.launches,
                'flash_decode': ddp.flash_decode.launches}

    with torch.inference_mode():
        caches = model.make_decode_caches(BATCH, T_MAX)
        caches, logits = model.prefill(prompts, caches)
        _, step_logits = model.decode(tokens[:, :1], caches)
        finite = bool(torch.isfinite(logits).all().item()
                      and torch.isfinite(step_logits).all().item())
        gpu_last = logits[0, -1].float().cpu()

    row = {'phase': 'main_path', 'params': n_params,
           'model_build_s': build_s, 'tokens_shape': list(tokens.shape),
           'launches': launches, 'expected_launches': {
               'flash_attention': LAYERS,
               'flash_decode': LAYERS * (STEPS - 1)},
           'prefill_ms': prefill_ms,
           'ms_per_decode_step': (1e3 * total_s - prefill_ms) / (STEPS - 1),
           'generate_s': total_s,
           'tokens_per_s': BATCH * STEPS / total_s,
           'logits_finite': finite}
    emit(row)
    SAME_CALL['main_path'] = {k: row[k] for k in (
        'prefill_ms', 'ms_per_decode_step', 'tokens_per_s')}
    check(tuple(tokens.shape) == (BATCH, STEPS), 'wrong token shape')
    check(bool(((tokens >= 0) & (tokens < VOCAB)).all()), 'token out of range')
    check(finite, 'non-finite logits')
    check(launches['flash_attention'] == LAYERS,
          f'K1 launched {launches["flash_attention"]} times, want {LAYERS}')
    check(launches['flash_decode'] == LAYERS * (STEPS - 1),
          f'K5 launched {launches["flash_decode"]} times, '
          f'want {LAYERS * (STEPS - 1)}')

    # The same weights in float32 on the CPU, plain versions throughout.
    t0 = time.perf_counter()
    cpu = ddp.TransformerLM(VOCAB, DIM, HEADS, n_layers=LAYERS,
                            dtype=torch.float32, device='cpu')
    cpu.load_state_dict(model.state_dict())
    p0 = prompts[:1].cpu()
    with torch.inference_mode():
        _, cpu_logits = cpu.prefill(p0, cpu.make_decode_caches(1, T_MAX))
    cpu_last = cpu_logits[0, -1]
    rel = ((gpu_last - cpu_last).abs().max()
           / cpu_last.abs().max()).item()
    cpu_tokens = greedy_generate(cpu, p0, STEPS, T_MAX)[0]
    gpu_tokens = tokens[0].cpu()
    match = int((cpu_tokens == gpu_tokens).int().cumprod(0).sum().item())
    row = {'phase': 'cpu_reference', 'prompt': 0,
           'last_logits_max_rel_err': rel, 'tol': TOL_LM_REL,
           'argmax_gpu': int(gpu_last.argmax()),
           'argmax_cpu': int(cpu_last.argmax()),
           'greedy_prefix_match': match, 'steps': STEPS,
           'seconds': time.perf_counter() - t0}
    emit(row)
    check(rel <= TOL_LM_REL, f'LM logits rel err {rel} > {TOL_LM_REL}')
    return launches


def causal_pairs(tq, tk, off):
    """Attended (row, column) pairs of one causal (batch, head) row."""
    return sum(max(0, min(tk, off + i + 1)) for i in range(tq))


def phase_flash_backward(torch, ddp, flush, gen):
    import importlib
    fa = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_attention')
    F = torch.nn.functional
    dev, bf16 = torch.device('cuda'), torch.bfloat16
    # (name, batch, q heads, kv heads, Tq, Tk, causal offset or None for
    # no causal mask, head dim): the main path's shapes, then one small
    # case for each other head dim the kernels are built for.
    cases = [('train', TRAIN_B, HEADS, HEADS, TRAIN_T, TRAIN_T, 0, HEAD_DIM),
             ('gqa_ragged', BATCH, HEADS, 2, 333, 333, 0, HEAD_DIM),
             ('ragged_offset', BATCH, HEADS, HEADS, 77, 1077, 1000,
              HEAD_DIM),
             ('full_ragged', BATCH, HEADS, HEADS, 50, 300, None, HEAD_DIM),
             ('d32_gqa', 2, 4, 1, 130, 130, 0, 32),
             ('d64_full', 2, 2, 2, 70, 90, None, 64),
             ('d128_offset', 2, 2, 2, 100, 140, 5, 128)]
    worst, failures = {}, []
    # Every case is held and printed before the phase fails, so one run
    # reads all of them.
    for name, b, hq, hkv, tq, tk, off, hd in cases:
        causal = off is not None
        off = off or 0
        kw = dict(causal=causal, causal_offset=off)
        scale = 1.0 / math.sqrt(hd)
        q = randn(torch, (b, hq, tq, hd), gen, dev, bf16)
        k = randn(torch, (b, hkv, tk, hd), gen, dev, bf16)
        v = randn(torch, (b, hkv, tk, hd), gen, dev, bf16)
        g = randn(torch, (b, hq, tq, hd), gen, dev, bf16)
        out, lse = fa.flash_attention_with_lse(q, k, v, scale=scale, **kw)
        out_p, lse_p = fa.flash_attention_plain_lse(q, k, v, scale=scale,
                                                    **kw)
        # Both backward versions from the kernel's own (out, lse).
        grads = fa.flash_attention_backward(q, k, v, out, lse, g,
                                            scale=scale, **kw)
        plain = fa.flash_attention_backward_plain(q, k, v, out, lse, g,
                                                  scale=scale, **kw)
        torch.cuda.synchronize()
        got = dict(zip(('out', 'dq', 'dk', 'dv'), (out, *grads)))
        want = dict(zip(('out', 'dq', 'dk', 'dv'), (out_p, *plain)))
        err = {n: (got[n].float() - want[n].float()).abs().max().item()
               for n in got}
        err['lse'] = (lse - lse_p).abs().max().item()
        rel = {n: rel_errs(torch, got[n], want[n]) for n in got}
        emit({'phase': 'flash_backward', 'case': name,
              'q': list(q.shape), 'kv': list(k.shape), 'causal': causal,
              'causal_offset': off, 'max_abs_err': err,
              'max_row_rel_err': {n: e[0] for n, e in rel.items()},
              'rel_err': {n: e[1] for n, e in rel.items()},
              'tol': {'lse': TOL_LSE, 'row_rel': TOL_ROW_REL,
                      'rel': TOL_NORM_REL}})
        for n, t in (*got.items(), ('lse', lse)):
            if not torch.isfinite(t).all().item():
                failures.append(f'{n} {name}: non-finite')
        if err['lse'] > TOL_LSE:
            failures.append(f'lse {name}: abs err {err["lse"]} > {TOL_LSE}')
        failures += check_rel(rel, name)
        for n, e in err.items():
            worst[n] = max(worst.get(n, 0.0), e)
        for n, e in rel.items():
            worst[n + '_row_rel'] = max(worst.get(n + '_row_rel', 0.0), e[0])
        if name == 'train':
            train = (b, hq, hkv, tq, tk, off, kw, scale, q, k, v, g, out, lse)
    check(not failures, '; '.join(failures))

    # Times at the training shape, with the bound each kernel could
    # reach: operations on this run's causal pairs, bytes of each
    # operand read once and each result written once.
    b, hq, hkv, tq, tk, off, kw, scale, q, k, v, g, out, lse = train
    nb, d = b * hq, HEAD_DIM
    pairs = causal_pairs(tq, tk, off) * nb
    q2, lse2, delta = fa.flash_attention_bwd_operands(q, out, lse, g, scale)
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qr, kr, vr, is_causal=True,
                                           scale=scale)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        o_lib, (qr, kr, vr), g, retain_graph=True), flush)
    timing = {}
    work = dict(d=d, q_rows=nb * tq, kv_rows=b * hkv * tk, pairs=pairs)
    cost = perf()
    for kname, (flops, nbytes), fn, plain_fn, lib in (
            ('flash_attention', cost.attention_fwd_cost(**work, lse=True),
             lambda: fa.flash_attention_with_lse(q, k, v, scale=scale, **kw),
             lambda: fa.flash_attention_plain_lse(q, k, v, scale=scale,
                                                  **kw),
             lambda: F.scaled_dot_product_attention(
                 q, k, v, is_causal=True, scale=scale)),
            ('flash_attention_dq', cost.attention_dq_cost(**work),
             lambda: fa.flash_attention_dq(
                 q2, k, v, g, lse2, delta, scale=scale, **kw),
             lambda: fa.flash_attention_dq_plain(
                 q2, k, v, g, lse2, delta, scale=scale, **kw),
             None),
            ('flash_attention_dkv', cost.attention_dkv_cost(**work),
             lambda: fa.flash_attention_dkv(q2, k, v, g, lse2, delta, **kw),
             lambda: fa.flash_attention_dkv_plain(
                 q2, k, v, g, lse2, delta, **kw),
             None)):
        bms, by = bound_ms(flops, nbytes)
        timing[kname] = {
            'ms': time_ms(torch, fn, flush),
            'plain_ms': time_ms(torch, plain_fn, flush, reps=5),
            'library_ms': time_ms(torch, lib, flush) if lib else lib_bwd,
            'bound_ms': bms, 'bound_by': by, 'flops': flops,
            'bytes': nbytes}
    # The pair K3 + K4 computes what one SDPA backward computes (dq, dk and
    # dv together): each kernel's and the pair's time over it.
    pair_ms = timing['flash_attention_dq']['ms'] + \
        timing['flash_attention_dkv']['ms']
    for kname in ('flash_attention_dq', 'flash_attention_dkv'):
        timing[kname]['x_library'] = timing[kname]['ms'] / lib_bwd
    emit({'phase': 'flash_backward', 'case': 'train_timing',
          'library': {'flash_attention': 'sdpa forward, is_causal',
                      'flash_attention_dq': 'sdpa backward (dq, dk, dv '
                      'together)',
                      'flash_attention_dkv': 'sdpa backward (dq, dk, dv '
                      'together)'},
          'pair_dq_dkv': {'ms': pair_ms, 'library_ms': lib_bwd,
                          'x_library': pair_ms / lib_bwd},
          **timing})
    # No atomics: the backward run twice on the same inputs gives dq, dk
    # and dv bit for bit.
    first = fa.flash_attention_backward(q, k, v, out, lse, g, scale=scale,
                                        **kw)
    again = fa.flash_attention_backward(q, k, v, out, lse, g, scale=scale,
                                        **kw)
    torch.cuda.synchronize()
    same = {n: bool(torch.equal(a, b))
            for n, a, b in zip(('dq', 'dk', 'dv'), first, again)}
    emit({'phase': 'flash_backward', 'case': 'train_repeat_bitwise',
          'q': list(q.shape), 'exactly_equal': same})
    check(all(same.values()), f'the backward is not repeatable bit for '
          f'bit: {same}')
    return worst, timing


# The sequence-parallel configuration: the flagship module
# DistributedDotProductAttn(key_dim=512, num_heads=8, offset=64) (head dim
# 64), trained DP x SP on a 2 x 2 group: global batch 4 x T 8192, so each
# rank holds 2 x 4096 rows of 8 heads.
SP_DIM, SP_HEADS, SP_OFFSET = 512, 8, 64
SP_HEAD_DIM = SP_DIM // SP_HEADS
SP_DATA, SP_SEQ, SP_B, SP_T = 2, 2, 4, 8192
SP_TN = SP_T // SP_SEQ
SP_RANKS = 4                 # seq_parallel's and zigzag_ring's group
# K2 vs its plain version and vs K1: the same shift-invariant softmax, the
# bound's shift only moves where float32 rounds, so the row limits above
# hold it (its p is rounded to bf16 as K1's is).


def _fold_inputs(torch, gen, b, h, tq, tk, d, mask_cols=None, scale=1.0):
    dev, bf16 = torch.device('cuda'), torch.bfloat16
    q = scale * randn(torch, (b, h, tq, d), gen, dev, torch.float32)
    k = scale * randn(torch, (b, h, tk, d), gen, dev, torch.float32)
    v = randn(torch, (b, h, tk, d), gen, dev, bf16)
    g = randn(torch, (b, h, tq, d), gen, dev, bf16)
    mask = None
    if mask_cols is not None:
        # A rank's (B, 1, T/N, T) rows with 30% of entries masked and
        # every 97th row fully masked.
        mask = torch.rand((b, 1, tq, mask_cols), generator=gen) < 0.3
        mask[:, :, ::97] = True
        mask = mask.to(dev)
    return q.to(bf16), k.to(bf16), v, g, mask


def phase_flash_features(torch, ddp, flush, gen):
    """K1/K3/K4 with a dense mask (fully masked rows), ring-fold
    kv_offsets and float32 gradients; K2 against its plain version and
    K1, and a large-norm case where the guard must launch K1."""
    import importlib
    fa = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_attention')
    F = torch.nn.functional
    b, h, tn, d = SP_B // SP_DATA, SP_HEADS, SP_TN, SP_HEAD_DIM
    scale = 1.0 / math.sqrt(d)
    worst, failures, rows_out = {}, [], {}
    q, k, v, g, mask = _fold_inputs(torch, gen, b, h, tn, tn, d,
                                    mask_cols=SP_T)
    # (name, causal, causal_offset, kv_offset, mask column block or None,
    # grad dtype): rank 1's ring folds of the causal 2-rank ring (owner 0
    # in the past, owner 1 the diagonal, owner 0 seen from rank 0's future
    # side would be skipped), a masked non-causal fold, and the masked
    # self-attention of one rank's block.
    cases = [('fold_past_f32', True, tn, 0, None, torch.float32),
             ('fold_diag_f32', True, tn, tn, None, torch.float32),
             ('fold_future', True, 0, tn, None, torch.float32),
             ('fold_mask_f32', False, tn, 0, 0, torch.float32),
             ('fold_mask_causal_f32', True, tn, tn, 1, torch.float32),
             ('mask_bf16', False, 0, 0, 1, None)]
    neg = fa._LN2 * fa._NEG_BIG
    for name, causal, co, ko, blk, gdt in cases:
        m = None if blk is None else mask[..., blk * tn:(blk + 1) * tn]
        kw = dict(causal=causal, causal_offset=co, kv_offset=ko)
        out, lse = fa.flash_attention_with_lse(q, k, v, m, scale=scale, **kw)
        out_p, lse_p = fa.flash_attention_plain_lse(q, k, v, m, scale=scale,
                                                    **kw)
        grads = fa.flash_attention_backward(q, k, v, out, lse, g, scale=scale,
                                            mask=m, grad_dtype=gdt, **kw)
        plain = fa.flash_attention_backward_plain(
            q, k, v, out, lse, g, scale=scale, mask=m, grad_dtype=gdt, **kw)
        torch.cuda.synchronize()
        got = dict(zip(('out', 'dq', 'dk', 'dv'), (out, *grads)))
        want = dict(zip(('out', 'dq', 'dk', 'dv'), (out_p, *plain)))
        err = {n: (got[n].float() - want[n].float()).abs().max().item()
               for n in got}
        finite_lse = lse_p > 0.5 * neg
        err['lse'] = (lse - lse_p)[finite_lse].abs().max().item() \
            if finite_lse.any() else 0.0
        rel = {n: rel_errs(torch, got[n], want[n]) for n in got
               if want[n].abs().max().item() > 0}
        empty = (~finite_lse)
        exact_empty = bool((lse[empty] == neg).all().item()
                           and not out[empty].any().item()
                           and not grads[0][empty].any().item())
        dtypes = sorted({str(t.dtype) for t in grads})
        emit({'phase': 'flash_features', 'case': name, 'q': list(q.shape),
              'kv': list(k.shape), 'causal': causal, 'causal_offset': co,
              'kv_offset': ko, 'mask': None if m is None else
              {'shape': list(m.shape), 'strides': list(m.stride()),
               'masked_share': m.float().mean().item()},
              'grad_dtypes': dtypes, 'max_abs_err': err,
              'max_row_rel_err': {n: e[0] for n, e in rel.items()},
              'rel_err': {n: e[1] for n, e in rel.items()},
              'empty_rows': int(empty.sum().item()),
              'empty_rows_exact': exact_empty,
              'tol': {'lse': TOL_LSE, 'row_rel': TOL_ROW_REL,
                      'rel': TOL_NORM_REL}})
        for n, t in (*got.items(), ('lse', lse)):
            if not torch.isfinite(t).all().item():
                failures.append(f'{n} {name}: non-finite')
        if err['lse'] > TOL_LSE:
            failures.append(f'lse {name}: abs err {err["lse"]} > {TOL_LSE}')
        if not exact_empty:
            failures.append(f'{name}: rows with no attendable key are not '
                            f'exactly out 0 / lse ln2*NEG_BIG / dq 0')
        if gdt is not None and dtypes != ['torch.float32']:
            failures.append(f'{name}: gradients in {dtypes}, want float32')
        failures += check_rel(rel, name)
        for n, e in err.items():
            worst[n] = max(worst.get(n, 0.0), e)
        if name == 'fold_future' and out.any().item():
            failures.append('fold_future: output not 0')
        rows_out[name] = (kw, m, gdt, out, lse)

    # K2: against its plain version and against K1 on unit-normal inputs
    # (the guard picks K2), then at a large norm (the guard must pick K1).
    for name, norm, want_k2 in (('bounded', 1.0, True),
                                ('bounded_large_norm', 4.0, False)):
        qb, kb, vb, _, _ = _fold_inputs(torch, gen, b, h, tn, tn, d,
                                        scale=norm)
        m = mask[..., tn:2 * tn]
        launches = (ddp.flash_attention.launches,
                    fa.flash_attention_bounded.launches)
        out = ddp.flash_attention(qb, kb, vb, m, scale=scale,
                                  softmax_mode='bounded')
        torch.cuda.synchronize()
        took = (ddp.flash_attention.launches - launches[0],
                fa.flash_attention_bounded.launches - launches[1])
        mvec = fa.bounded_shift(fa._fold_q(qb, scale), kb)
        ref = (fa.flash_attention_bounded_plain_lse(qb, kb, vb, m,
                                                    scale=scale)[0]
               if want_k2 else fa.flash_attention_plain(qb, kb, vb, m,
                                                        scale=scale))
        k1 = fa.flash_attention(qb, kb, vb, m, scale=scale)
        row, whole = rel_errs(torch, out, ref)
        row1, whole1 = rel_errs(torch, out, k1)
        err = (out.float() - ref.float()).abs().max().item()
        emit({'phase': 'flash_features', 'case': name, 'q': list(qb.shape),
              'max_bound': mvec.max().item(),
              'guard': '2*max(bound) <= 100',
              'launched': {'flash_attention': took[0],
                           'flash_attention_bounded': took[1]},
              'max_abs_err': err, 'max_row_rel_err': row, 'rel_err': whole,
              'vs_k1': {'max_row_rel_err': row1, 'rel_err': whole1},
              'tol': {'row_rel': TOL_ROW_REL, 'rel': TOL_NORM_REL}})
        want_took = (0, 1) if want_k2 else (1, 0)
        if took != want_took:
            failures.append(f'{name}: launched (K1, K2) = {took}, want '
                            f'{want_took}')
        failures += check_rel({'out': (row, whole)}, name)
        failures += check_rel({'out_vs_k1': (row1, whole1)}, name)
        worst['bounded' if want_k2 else 'bounded_large'] = err
        if want_k2:
            bounded = (qb, kb, vb, m, mvec)
    check(not failures, '; '.join(failures))

    # Times at the flagship's fold shape: K1 on rank 1's masked causal
    # diagonal fold, K2 on the same inputs unmasked non-causal (the flash
    # branch's shape), K3 / K4 with float32 gradients.
    timing = {}
    kw, m, gdt, out, lse = rows_out['fold_mask_causal_f32']
    q2, lse2, delta = fa.flash_attention_bwd_operands(q, out, lse, g, scale)
    nb = b * h
    # Operations count the pairs this run's data needs: the causal
    # diagonal's unmasked pairs (K2: every unmasked pair).
    pairs = int((~m).expand(b, h, tn, tn).tril().sum().item())
    mask_bytes = m.numel()                                # read once
    qb, kb, vb, mb, mvec = bounded
    pairs_k2 = int((~mb).expand(b, h, tn, tn).sum().item())
    lib_mask = ~(m | torch.ones(tn, tn, dtype=torch.bool,
                                device=m.device).triu(1))
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    o_lib = F.scaled_dot_product_attention(qr, kr, vr, attn_mask=lib_mask,
                                           scale=scale)
    lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
        o_lib, (qr, kr, vr), g, retain_graph=True), flush)
    cost = perf()

    def work(n_pairs, **extra):
        return dict(d=d, q_rows=nb * tn, kv_rows=nb * tn, pairs=n_pairs,
                    mask_bytes=mask_bytes, **extra)
    for kname, (flops, nbytes), fn, plain_fn, lib in (
            ('flash_attention', cost.attention_fwd_cost(**work(pairs,
                                                               lse=True)),
             lambda: fa.flash_attention_with_lse(q, k, v, m, scale=scale,
                                                 **kw),
             lambda: fa.flash_attention_plain_lse(q, k, v, m, scale=scale,
                                                  **kw),
             lambda: F.scaled_dot_product_attention(q, k, v,
                                                    attn_mask=lib_mask,
                                                    scale=scale)),
            ('flash_attention_bounded',
             cost.attention_fwd_cost(**work(pairs_k2, lse=True)),
             lambda: fa.flash_attention_bounded(qb, kb, vb, mb, scale=scale,
                                                mvec=mvec),
             lambda: fa.flash_attention_bounded_plain_lse(qb, kb, vb, mb,
                                                          scale=scale),
             lambda: F.scaled_dot_product_attention(qb, kb, vb,
                                                    attn_mask=~mb,
                                                    scale=scale)),
            ('flash_attention_dq', cost.attention_dq_cost(
                **work(pairs, grad_bytes=gdt.itemsize)),
             lambda: fa.flash_attention_dq(q2, k, v, g, lse2, delta, mask=m,
                                           scale=scale, grad_dtype=gdt, **kw),
             lambda: fa.flash_attention_dq_plain(q2, k, v, g, lse2, delta,
                                                 mask=m, scale=scale,
                                                 grad_dtype=gdt, **kw),
             None),
            ('flash_attention_dkv', cost.attention_dkv_cost(
                **work(pairs, grad_bytes=gdt.itemsize)),
             lambda: fa.flash_attention_dkv(q2, k, v, g, lse2, delta, mask=m,
                                            grad_dtype=gdt, **kw),
             lambda: fa.flash_attention_dkv_plain(q2, k, v, g, lse2, delta,
                                                  mask=m, grad_dtype=gdt,
                                                  **kw),
             None)):
        bms, by = bound_ms(flops, nbytes)
        timing[kname] = {
            'ms': time_ms(torch, fn, flush),
            'plain_ms': time_ms(torch, plain_fn, flush, reps=5),
            'library_ms': time_ms(torch, lib, flush) if lib else lib_bwd,
            'bound_ms': bms, 'bound_by': by, 'flops': flops,
            'bytes': nbytes}
    # K1 on K2's inputs: the two forwards on the same work, one call.
    k1_same = time_ms(torch, lambda: fa.flash_attention(qb, kb, vb, mb,
                                                        scale=scale), flush)
    emit({'phase': 'flash_features', 'case': 'fold_timing',
          'shape': [b, h, tn, d], 'pairs': pairs, 'pairs_k2': pairs_k2,
          'k1_on_k2_inputs_ms': k1_same,
          'library': {'flash_attention': 'sdpa forward, boolean mask',
                      'flash_attention_bounded': 'sdpa forward, boolean '
                      'mask', 'flash_attention_dq': 'sdpa backward (dq, dk, '
                      'dv together), boolean mask',
                      'flash_attention_dkv': 'sdpa backward (dq, dk, dv '
                      'together), boolean mask'},
          'bound_formula': 'bytes: q, k, v, dO/out read once (bf16), mask '
                           'bytes, lse/delta; operations: 4/6/8*d per '
                           'unmasked causal pair (K2: per unmasked pair)',
          **timing})
    return worst, timing


# The masks and terms of K1/K3/K4 at the flagship's fold shape (2 x 8
# heads x 4096 rows, head dim 64), all four at once under GQA 8:4 at the
# LM's head dim 96, and ALiBi at the ALiBi LM's and zigzag_ring's own
# shapes (MASK_SHAPES): (name, q heads, kv heads, head dim, causal,
# causal_offset, kv_offset, segments, window, dropout rate, int8, ALiBi,
# positions: None or the zigzag fold (world, shard, owner) whose row and
# column positions the case passes with causal off).
MASK_CASES = (
    ('segments', 8, 8, 64, False, 0, 0, True, None, 0.0, False, False, None),
    ('window', 8, 8, 64, True, 4096, 2048, False, 2048, 0.0, False, False,
     None),
    ('dropout', 8, 8, 64, True, 0, 0, False, None, 0.1, False, False, None),
    ('int8', 8, 8, 64, False, 0, 0, False, None, 0.0, True, False, None),
    ('all_gqa', 8, 4, 96, True, 0, 0, True, 2048, 0.1, True, False, None),
    # rank 1's causal fold of owner 0 in the recipe's packed layout: its
    # rows are document 1, the owner's keys document 0 — every row has no
    # attendable key.
    ('cross_segment', 8, 8, 64, True, 4096, 0, 'cross', None, 0.1, True,
     False, None),
    # ALiBi on the causal diagonal fold at a ring rank's offsets.
    ('alibi', 8, 8, 64, True, 4096, 4096, False, None, 0.0, False, True,
     None),
    # zigzag rank 1's diagonal fold (half-stripes 1 and 6 of 8): causal
    # triangles, a wholly past and a wholly future half-block (skipped).
    ('zigzag_positions', 8, 8, 64, False, 0, 0, False, None, 0.0, False,
     False, (4, 1, 1)),
    # the same fold with ALiBi, a window of 1024 (the past half-block lies
    # wholly outside it) and dropout keyed on the positions.
    ('alibi_positions_window_dropout', 8, 8, 64, False, 0, 0, False, 1024,
     0.1, False, True, (4, 1, 1)),
    # The ALiBi LM's attention at its own shapes (MASK_SHAPES): a training
    # step's layer and the greedy run's prefill, causal from row 0.
    ('alibi_lm_train', HEADS, HEADS, HEAD_DIM, True, 0, 0, False, None,
     0.0, False, True, None),
    ('alibi_lm_prefill', HEADS, HEADS, HEAD_DIM, True, 0, 0, False, None,
     0.0, False, True, None),
    # zigzag_ring's folds with ALiBi at its shard shape: rank 2's diagonal
    # fold, and rank 0's fold of owner 3 (half-stripes 0, 7 against 3, 4:
    # two half-blocks wholly past, two wholly future).
    ('zigzag_alibi_diagonal', SP_HEADS, SP_HEADS, SP_HEAD_DIM, False, 0, 0,
     False, None, 0.0, False, True, (SP_RANKS, 2, 2)),
    ('zigzag_alibi_off_diagonal', SP_HEADS, SP_HEADS, SP_HEAD_DIM, False, 0,
     0, False, None, 0.0, False, True, (SP_RANKS, 0, 3)))
# (batch, rows) of the cases run at a main path's shape; the others run at
# the flagship's fold shape (SP_B // SP_DATA, SP_TN).
MASK_SHAPES = {'alibi_lm_train': (TRAIN_B, TRAIN_T),
               'alibi_lm_prefill': (BATCH, PROMPT),
               'zigzag_alibi_diagonal': (SP_B, SP_T // SP_RANKS),
               'zigzag_alibi_off_diagonal': (SP_B, SP_T // SP_RANKS)}
MASK_SEED = 12345
# The classic geometric ALiBi slopes 2^(-8i/H), i = 1..H, at the LM's and
# the flagship module's 8 heads.
ALIBI_SLOPES = tuple(2.0 ** (-8.0 * i / HEADS) for i in range(1, HEADS + 1))


def zigzag_positions(torch, world, shard, tn, dev):
    """Zigzag shard ``shard``'s ``(tn,)`` int32 global positions: the
    half-stripes ``shard`` and ``2W-1-shard``."""
    h = tn // 2
    ar = torch.arange(h, device=dev, dtype=torch.int32)
    return torch.cat([shard * h + ar, (2 * world - 1 - shard) * h + ar])


def alibi_bias(torch, slopes, back, allowed, dtype):
    """SDPA's float mask for ALiBi: ``slope·(pos_k − pos_q)`` (natural-log
    units) where ``allowed``, ``-inf`` elsewhere; ``back`` is ``pos_q −
    pos_k`` broadcast against ``allowed``, heads on axis 1."""
    s = torch.tensor(slopes, dtype=torch.float32, device=back.device)
    bias = s.reshape(1, -1, *([1] * (back.dim() - 2))) * (-back).float()
    return bias.masked_fill(~allowed, float('-inf')).to(dtype)


def ragged_segments(torch, gen, b, t, docs=6):
    """``(b, 1, t)`` int32 packed-document ids: ``docs`` documents a row,
    boundaries at random positions, different in every row."""
    seg = torch.zeros((b, 1, t), dtype=torch.int32)
    for i in range(b):
        cuts = torch.randperm(t - 1, generator=gen)[:docs - 1] + 1
        seg[i, 0, cuts] = 1
    return seg.cumsum(-1).to(torch.int32)


def valid_pairs(torch, b, tq, tk, causal, co, ko, window, seg, pos=None):
    """Attended (row, column) pairs over the batch ``b`` of one head (the
    pairs this run's data needs); ``pos`` the explicit ``(pos_q, pos_k)``."""
    dev = torch.device('cuda')
    rows = co + torch.arange(tq, device=dev)[:, None]
    cols = ko + torch.arange(tk, device=dev)[None, :]
    if pos is not None:
        rows, cols = pos[0].long()[:, None], pos[1].long()[None, :]
    ok = torch.ones((tq, tk), dtype=torch.bool, device=dev)
    if causal or pos is not None:
        ok &= rows >= cols
        if window is not None:
            ok &= rows - cols < window
    if seg is None:
        return b * int(ok.sum().item())
    sq, sk = seg
    same = sq[:, 0, :, None] == sk[:, 0, None, :]
    return int((same & ok).sum().item())


def bound_mixed(ops_bf16, ops_int8, nbytes):
    """``bound_ms`` for work split between bf16 and int8 tensor-core
    products: their times at each peak add up."""
    peaks = perf().DEFAULT_PEAKS
    t_ops = ops_bf16 / peaks.flops_per_s + ops_int8 / peaks.int8_ops_per_s
    t_bytes = nbytes / peaks.bytes_per_s
    return 1e3 * max(t_ops, t_bytes), ('operations' if t_ops > t_bytes
                                       else 'bytes')


def phase_flash_masks(torch, ddp, flush, gen):
    """K1/K3/K4 with segments, a window, dropout, int8 scoring, ALiBi and
    explicit positions against their plain versions (K1's out and lse,
    K3/K4 in bf16 and float32), ALiBi also at the ALiBi LM's training and
    prefill shapes and on zigzag_ring's folds; the dropout keep pattern
    bit for bit, int8 scores bit for bit, a wholly cross-segment fold
    exactly empty; K2 with segments, a window and positions; times against
    bound, plain and, where one PyTorch call computes the same function,
    SDPA."""
    import importlib
    fa = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_attention')
    F = torch.nn.functional
    dev, bf16 = torch.device('cuda'), torch.bfloat16
    neg = fa._LN2 * fa._NEG_BIG
    worst, failures, timing = {}, [], {}
    for (name, hq, hkv, d, causal, co, ko, segs, window, rate,
         int8, alibi, zig) in MASK_CASES:
        b, t = MASK_SHAPES.get(name, (SP_B // SP_DATA, SP_TN))
        scale = 1.0 / math.sqrt(d)
        pos = None
        if zig is not None:
            world, shard, owner = zig
            pos = tuple(zigzag_positions(torch, world, r, t, dev)
                        for r in (shard, owner))
        q = randn(torch, (b, hq, t, d), gen, dev, bf16)
        k = randn(torch, (b, hkv, t, d), gen, dev, bf16)
        v = randn(torch, (b, hkv, t, d), gen, dev, bf16)
        g = randn(torch, (b, hq, t, d), gen, dev, bf16)
        seg = None
        if segs == 'cross':
            seg = (torch.ones((b, 1, t), dtype=torch.int32, device=dev),
                   torch.zeros((b, 1, t), dtype=torch.int32, device=dev))
        elif segs:
            one = ragged_segments(torch, gen, b, t).to(dev)
            seg = (one, one)
        feat = dict(segment_ids=seg, window=window, dropout_rate=rate,
                    dropout_seed=MASK_SEED if rate else None,
                    qk_quant='int8' if int8 else None, positions=pos,
                    alibi_slopes=ALIBI_SLOPES[:hq] if alibi else None)
        kw = dict(causal=causal, causal_offset=co, kv_offset=ko, scale=scale)
        out, lse = fa.flash_attention_with_lse(q, k, v, **kw, **feat)
        out_p, lse_p = fa.flash_attention_plain_lse(q, k, v, **kw, **feat)
        got, want = {'out': out}, {'out': out_p}
        for gdt, tag in ((None, ''), (torch.float32, '_f32')):
            gk = fa.flash_attention_backward(
                q, k, v, out, lse, g, causal, co, scale, kv_offset=ko,
                grad_dtype=gdt, **feat)
            gp = fa.flash_attention_backward_plain(
                q, k, v, out, lse, g, causal, co, scale, kv_offset=ko,
                grad_dtype=gdt, **feat)
            for n, a, w in zip(('dq', 'dk', 'dv'), gk, gp):
                got[n + tag], want[n + tag] = a, w
                if gdt is not None and a.dtype != torch.float32:
                    failures.append(f'{name}: {n} in {a.dtype}, want '
                                    f'float32')
        torch.cuda.synchronize()
        finite_lse = lse_p > 0.5 * neg
        err = {n: (got[n].float() - want[n].float()).abs().max().item()
               for n in got}
        err['lse'] = ((lse - lse_p)[finite_lse].abs().max().item()
                      if finite_lse.any() else 0.0)
        rel = {n: rel_errs(torch, got[n], want[n]) for n in got
               if want[n].abs().max().item() > 0}
        empty = ~finite_lse
        exact_empty = bool((lse[empty] == neg).all().item()
                           and not out[empty].any().item()
                           and not got['dq'][empty].any().item()
                           and not got['dq_f32'][empty].any().item())
        emit({'phase': 'flash_masks', 'case': name, 'q': list(q.shape),
              'kv': list(k.shape), 'causal': causal, 'causal_offset': co,
              'kv_offset': ko, 'segments': None if seg is None else
              ('cross' if segs == 'cross' else
               int(seg[0].max().item()) + 1), 'window': window,
              'dropout_rate': rate, 'qk_quant': feat['qk_quant'],
              'alibi_slopes': feat['alibi_slopes'],
              'positions': None if zig is None else {
                  'zigzag_world': zig[0], 'rows_of_rank': zig[1],
                  'columns_of_rank': zig[2]},
              'max_abs_err': err,
              'max_row_rel_err': {n: e[0] for n, e in rel.items()},
              'rel_err': {n: e[1] for n, e in rel.items()},
              'empty_rows': int(empty.sum().item()),
              'empty_rows_exact': exact_empty,
              'tol': {'lse': TOL_LSE, 'row_rel': TOL_ROW_REL,
                      'rel': TOL_NORM_REL}})
        for n, x in (*got.items(), ('lse', lse)):
            if not torch.isfinite(x).all().item():
                failures.append(f'{n} {name}: non-finite')
        if err['lse'] > TOL_LSE:
            failures.append(f'lse {name}: abs err {err["lse"]} > {TOL_LSE}')
        if not exact_empty:
            failures.append(f'{name}: rows with no attendable key are not '
                            f'exactly out 0 / lse ln2*NEG_BIG / dq 0')
        if segs == 'cross':
            if empty.sum().item() != empty.numel() or any(
                    x.any().item() for x in got.values()):
                failures.append(f'{name}: a wholly cross-segment fold is '
                                f'not exactly empty with zero gradients')
            continue
        failures += check_rel(rel, name)
        for n, e in err.items():
            worst[n] = max(worst.get(n, 0.0), e)

        # Times: K1 with its lse, K3 and K4 in bf16, at this case's shape.
        nb = b * hq
        pairs = hq * valid_pairs(torch, b, t, t, causal, co, ko, window,
                                 seg, pos)
        q2, lse2, delta = fa.flash_attention_bwd_operands(q, out, lse, g,
                                                          scale)
        quant = fa.quant_operands(q, k) if int8 else None
        bw = dict(causal=causal, causal_offset=co, kv_offset=ko,
                  segment_ids=seg, window=window, dropout_rate=rate,
                  dropout_seed=feat['dropout_seed'], quant=quant,
                  positions=pos, alibi_slopes=feat['alibi_slopes'])
        el = 1 if int8 else 2              # bytes of a q / k element read
        q_b, kv_b = nb * t * d, b * hkv * t * d
        rows_b = 4 * nb * t
        vec_b = (8 * b * t if seg is not None else 0) + \
            (4 * (nb + b * hkv) * t if int8 else 0) + \
            (8 * t if pos is not None else 0) + (4 * hq if alibi else 0)
        lib = lib_bwd = None
        if not rate and not int8:
            if pos is not None:
                back = pos[0].long()[:, None] - pos[1].long()[None, :]
            else:
                back = ((co + torch.arange(t, device=dev))[:, None]
                        - (ko + torch.arange(t, device=dev))[None, :])
            allowed = torch.ones((t, t), dtype=torch.bool, device=dev)
            if causal or pos is not None:
                allowed = back >= 0
                if window is not None:
                    allowed = allowed & (back < window)
            if seg is not None:
                allowed = allowed & (seg[0][:, :, :, None]
                                     == seg[1][:, :, None, :])
            if alibi:
                # A float bias (bf16, as SDPA takes q's dtype) per head.
                allowed = alibi_bias(torch, ALIBI_SLOPES[:hq], back[None,
                                                                    None],
                                     allowed.expand(1, 1, t, t), q.dtype)
            lib = (lambda al=allowed: F.scaled_dot_product_attention(
                q, k, v, attn_mask=al, scale=scale))
            # K3 and K4 against one SDPA backward with the same mask or
            # bias (dq, dk and dv together).
            qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
            o_lib = F.scaled_dot_product_attention(qr, kr, vr,
                                                   attn_mask=allowed,
                                                   scale=scale)
            lib_bwd = time_ms(torch, lambda: torch.autograd.grad(
                o_lib, (qr, kr, vr), g, retain_graph=True), flush)
            del o_lib, qr, kr, vr
        s_ops = 2 * d * pairs              # one product's multiply-adds
        for kname, ops, nbytes, make, plain_fn in (
                ('flash_attention', (s_ops * (1 - int8) + s_ops,
                                     s_ops * int8),
                 el * (q_b + kv_b) + 2 * kv_b + 2 * q_b + rows_b + vec_b,
                 lambda m: functools.partial(m.flash_attention_with_lse,
                                             q, k, v, **kw, **feat),
                 lambda: fa.flash_attention_plain_lse(q, k, v, **kw,
                                                      **feat)),
                ('flash_attention_dq', (s_ops * (1 - int8) + 2 * s_ops,
                                        s_ops * int8),
                 el * (q_b + kv_b) + 2 * kv_b + 4 * q_b + 2 * rows_b
                 + vec_b,
                 lambda m: functools.partial(
                     m.flash_attention_dq, q2, k, v, g, lse2, delta,
                     scale=scale, **bw),
                 lambda: fa.flash_attention_dq_plain(
                     q2, k, v, g, lse2, delta, scale=scale, **bw)),
                ('flash_attention_dkv', (s_ops * (1 - int8) + 3 * s_ops,
                                         s_ops * int8),
                 el * (q_b + kv_b) + 2 * kv_b + 2 * q_b + 4 * kv_b
                 + 2 * rows_b + vec_b,
                 lambda m: functools.partial(
                     m.flash_attention_dkv, q2, k, v, g, lse2, delta,
                     scale=scale, **bw),
                 lambda: fa.flash_attention_dkv_plain(
                     q2, k, v, g, lse2, delta, scale=scale, **bw))):
            bms, by = bound_mixed(*ops, nbytes)
            # int8 cases: beside the parent checkout's kernels (--parent).
            ms, parent = (ab_ms(torch, make, fa, flush) if int8 else
                          (time_ms(torch, make(fa), flush), None))
            timing.setdefault(kname, {})[name] = {
                'ms': ms, **({} if parent is None else {'parent_ms': parent}),
                'plain_ms': time_ms(torch, plain_fn, flush, reps=3),
                'library_ms': (None if lib is None else
                               time_ms(torch, lib, flush)
                               if kname == 'flash_attention' else lib_bwd),
                'bound_ms': bms, 'bound_by': by}
        if lib is not None:
            how = ('float ALiBi bias (bf16)' if alibi else 'boolean mask')
            library = {'flash_attention': f'sdpa forward, {how}',
                       'backward': f'sdpa backward (dq, dk, dv together), '
                                   f'{how}'}
        elif rate:
            library = ('none: the coordinate-hash dropout has no library '
                       'counterpart')
        else:
            library = 'none: no PyTorch call computes int8 scoring'
        emit({'phase': 'flash_masks', 'case': name + '_timing',
              'pairs': pairs, 'library': library,
              **{kn: timing[kn][name] for kn in timing}})
        del q, k, v, g, out, lse, out_p, lse_p, got, want, q2, lse2, delta
        lib = None
        torch.cuda.empty_cache()

    b, t = SP_B // SP_DATA, SP_TN
    windows = {case[0]: case[8] for case in MASK_CASES}
    # The dropout keep pattern, bit for bit: with v = eye(Tk) the output
    # row is the row's dropped weights, exactly 0 where an element was
    # dropped; at Tk = d = 128, once at the origin and once with the
    # coordinates near 2^20 (they wrap in the hash's multiplies).
    for co, ko in ((0, 0), (2 ** 20 + 7, 2 ** 20 - 100)):
        n = 128
        q = randn(torch, (b, 8, n, n), gen, dev, bf16)
        k = randn(torch, (b, 8, n, n), gen, dev, bf16)
        eye = torch.eye(n, dtype=bf16, device=dev).expand(b, 8, n, n)
        kw = dict(causal_offset=co, kv_offset=ko, dropout_rate=0.1,
                  dropout_seed=-MASK_SEED)
        out = fa.flash_attention(q, k, eye, **kw)
        out_p = fa.flash_attention_plain(q, k, eye, **kw)
        keep, _ = fa.dropout_keep((b, 8), n, n, co, ko, 0.1, -MASK_SEED,
                                  dev)
        same = bool(torch.equal(out != 0, keep)
                    and torch.equal(out_p != 0, keep))
        emit({'phase': 'flash_masks', 'case': 'keep_pattern',
              'offsets': [co, ko], 'shape': list(out.shape),
              'kept_share': keep.float().mean().item(),
              'exactly_equal': same})
        if not same:
            failures.append(f'keep pattern at offsets {co, ko} differs from '
                            f'the plain version')
    # K2 with segments and a window (its Ext instantiation) against its
    # plain version, the guard picking K2 on unit-normal inputs.
    q = randn(torch, (b, 8, t, 64), gen, dev, bf16)
    k = randn(torch, (b, 8, t, 64), gen, dev, bf16)
    v = randn(torch, (b, 8, t, 64), gen, dev, bf16)
    one = ragged_segments(torch, gen, b, t).to(dev)
    kw = dict(causal=True, causal_offset=t, kv_offset=t // 2,
              window=windows['window'], segment_ids=(one, one))
    before = fa.flash_attention_bounded.launches
    out = fa.flash_attention(q, k, v, softmax_mode='bounded', **kw)
    torch.cuda.synchronize()
    took = fa.flash_attention_bounded.launches - before
    ref = fa.flash_attention_bounded_plain_lse(q, k, v, **kw)[0]
    row, whole = rel_errs(torch, out, ref)
    emit({'phase': 'flash_masks', 'case': 'bounded_segments_window',
          'q': list(q.shape), 'k2_launched': took, 'max_row_rel_err': row,
          'rel_err': whole, 'tol': {'row_rel': TOL_ROW_REL,
                                    'rel': TOL_NORM_REL}})
    failures += check_rel({'out': (row, whole)}, 'bounded_segments_window')
    if took != 1:
        failures.append(f'bounded_segments_window: K2 launched {took} times')
    # K2 with positions (zigzag rank 1's diagonal fold), through the guard
    # and directly, against its plain version; its time at this shape.
    pos = tuple(zigzag_positions(torch, 4, 1, t, dev) for _ in range(2))
    kw = dict(positions=pos, window=windows['alibi_positions_window_dropout'])
    before = fa.flash_attention_bounded.positions_launches
    out = fa.flash_attention(q, k, v, softmax_mode='bounded', **kw)
    torch.cuda.synchronize()
    took = fa.flash_attention_bounded.positions_launches - before
    ref = fa.flash_attention_bounded_plain_lse(q, k, v, **kw)[0]
    row, whole = rel_errs(torch, out, ref)
    pairs = 8 * valid_pairs(torch, b, t, t, False, 0, 0, kw['window'],
                            None, pos)
    nbytes = 2 * 4 * b * 8 * t * 64 + 8 * t + 4 * b * 8 * t
    bms, by = bound_ms(4 * 64 * pairs, nbytes)
    mvec = fa.bounded_shift(fa._fold_q(q, 1.0 / 8.0), k)
    back = pos[0].long()[:, None] - pos[1].long()[None, :]
    allowed = (back >= 0) & (back < kw['window'])
    k2 = {'ms': time_ms(torch, lambda: fa.flash_attention_bounded(
              q, k, v, mvec=mvec, **kw), flush),
          'plain_ms': time_ms(
              torch, lambda: fa.flash_attention_bounded_plain_lse(
                  q, k, v, **kw), flush, reps=3),
          'library_ms': time_ms(
              torch, lambda: F.scaled_dot_product_attention(
                  q, k, v, attn_mask=allowed, scale=1.0 / 8.0), flush),
          'bound_ms': bms, 'bound_by': by,
          'max_abs_err': (out.float() - ref.float()).abs().max().item(),
          'max_row_rel_err': row, 'rel_err': whole}
    emit({'phase': 'flash_masks', 'case': 'bounded_positions',
          'q': list(q.shape), 'k2_launched': took, 'pairs': pairs,
          'library': 'sdpa forward, boolean mask from the positions and '
                     'the window (the same softmax: the shift cancels)',
          **k2,
          'tol': {'row_rel': TOL_ROW_REL, 'rel': TOL_NORM_REL}})
    failures += check_rel({'out': (row, whole)}, 'bounded_positions')
    if took != 1:
        failures.append(f'bounded_positions: K2 with positions launched '
                        f'{took} times')
    timing.setdefault('flash_attention_bounded', {})['positions'] = k2
    # int8 scores bit for bit: with one key the softmax weight is 1 and
    # lse = ln2 * score, in float32 on both sides.
    q = randn(torch, (b, 8, 64, 64), gen, dev, bf16)
    k = randn(torch, (b, 8, 1, 64), gen, dev, bf16)
    lse = fa.flash_attention_with_lse(q, k, k, qk_quant='int8')[1]
    lse_p = fa.flash_attention_plain_lse(q, k, k, qk_quant='int8')[1]
    same = bool(torch.equal(lse, lse_p))
    emit({'phase': 'flash_masks', 'case': 'int8_scores_exact',
          'exactly_equal': same,
          'max_abs_err': (lse - lse_p).abs().max().item()})
    if not same:
        failures.append('int8 scores differ from the plain version')
    failures += int8_exact(torch, fa, gen, b)
    failures += large_grid(torch, fa, gen)
    check(not failures, '; '.join(failures))
    return worst, timing


def int8_exact(torch, fa, gen, b):
    """int8 scoring bit for bit on every key tile (the fold shape, 4096
    rows, 64 key tiles), as failure messages.

    K1: causal with a window of 1, each row attends its own key alone, so
    lse_i = ln2 * s_ii in float32 on both sides. K4: at a window of 1 key
    j is attended by query j alone, so dk_j = scale * bf16(ds_jj) * q~_j
    and dv_j = bf16(p_jj) * dO_j are single products on both sides
    (float32 gradients); K3 likewise: dq_i = scale * bf16(ds_ii) * k~_i.
    v and dO hold multiples of 1/8 (|x| <= 16), so dP = dO.v^T is exact
    in float32 in any order; lse2 is the exact diagonal score (dot * sqf)
    * skr, so p_jj = exp2(0) = 1; delta puts ds_jj = dP_jj - delta_j on a
    tie of bf16 rounding (+-(1 + 2^-8) or +-(1 + 3 * 2^-8)), which any
    change of the score's last bit (the two scale factors in the other
    order, a neighbour's scale) moves to a neighbouring bf16 value. Then
    K4 and K3 each twice on the causal fold, bit for bit."""
    dev, bf16 = torch.device('cuda'), torch.bfloat16
    t, d, scale = SP_TN, 64, 1.0 / 8.0
    failures = []
    q = randn(torch, (b, 8, t, d), gen, dev, bf16)
    k = randn(torch, (b, 8, t, d), gen, dev, bf16)
    kw = dict(causal=True, window=1, qk_quant='int8')
    lse = fa.flash_attention_with_lse(q, k, k, **kw)[1]
    lse_p = fa.flash_attention_plain_lse(q, k, k, **kw)[1]
    same = bool(torch.equal(lse, lse_p))
    emit({'phase': 'flash_masks', 'case': 'int8_scores_exact_all_tiles',
          'q': list(q.shape), 'window': 1, 'exactly_equal': same,
          'max_abs_err': (lse - lse_p).abs().max().item()})
    if not same:
        failures.append('int8 scores past the first key tile differ from '
                        'the plain version (K1 lse at window 1)')

    def eighths(shape):
        x = torch.randn(shape, generator=gen) * 8
        return (x.round().clamp(-128, 128) / 8).to(device=dev, dtype=bf16)
    v, g = eighths((b, 8, t, d)), eighths((b, 8, t, d))
    quant = q8, sq, k8, sk = fa.quant_operands(q, k)
    dot = (q8.float() * k8.float()).sum(-1)
    lse2 = dot * (sq[..., 0] * (scale * fa._LOG2E)) * sk[..., 0]
    dp = (g.float() * v.float()).sum(-1)
    tie = torch.where(torch.rand(dp.shape, generator=gen) < 0.5,
                      1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8).to(dev)
    sign = torch.where(torch.rand(dp.shape, generator=gen) < 0.5, -1.0, 1.0)
    delta = dp - tie * sign.to(dev)
    q2 = fa._fold_q(q, scale)
    bw = dict(causal=True, window=1, scale=scale, quant=quant,
              grad_dtype=torch.float32)
    got = fa.flash_attention_dkv(q2, k, v, g, lse2, delta, **bw)
    want = fa.flash_attention_dkv_plain(q2, k, v, g, lse2, delta, **bw)
    same = {n: bool(torch.equal(a, w))
            for n, a, w in zip(('dk', 'dv'), got, want)}
    bw.pop('window')
    twice = [fa.flash_attention_dkv(q2, k, v, g, lse2, delta, **bw)
             for _ in range(2)]
    torch.cuda.synchronize()
    repeat = {n: bool(torch.equal(a, w))
              for n, a, w in zip(('dk', 'dv'), *twice)}
    emit({'phase': 'flash_masks', 'case': 'int8_dkv_exact_all_tiles',
          'q': list(q.shape), 'window': 1, 'exactly_equal': same,
          'max_abs_err': {n: (a - w).abs().max().item()
                          for n, a, w in zip(('dk', 'dv'), got, want)},
          'causal_repeat_bitwise': repeat})
    if not all(same.values()):
        failures.append(f'K4 int8 at window 1 differs from the plain '
                        f'version: {same}')
    if not all(repeat.values()):
        failures.append(f'K4 int8 is not repeatable bit for bit: {repeat}')

    bw['window'] = 1
    got = fa.flash_attention_dq(q2, k, v, g, lse2, delta, **bw)
    want = fa.flash_attention_dq_plain(q2, k, v, g, lse2, delta, **bw)
    same = bool(torch.equal(got, want))
    bw.pop('window')
    twice = [fa.flash_attention_dq(q2, k, v, g, lse2, delta, **bw)
             for _ in range(2)]
    torch.cuda.synchronize()
    repeat = bool(torch.equal(*twice))
    emit({'phase': 'flash_masks', 'case': 'int8_dq_exact_all_tiles',
          'q': list(q.shape), 'window': 1, 'exactly_equal': same,
          'max_abs_err': (got - want).abs().max().item(),
          'causal_repeat_bitwise': repeat})
    if not same:
        failures.append('K3 int8 at window 1 differs from the plain version')
    if not repeat:
        failures.append('K3 int8 is not repeatable bit for bit')
    return failures


# More (batch, head) rows than a grid's y dimension takes (65535), at a
# small tile: B 8200 x H 8 = 65600 rows of T 64, head dim 64, causal.
GRID_B, GRID_H, GRID_T = 8200, 8, 64


def large_grid(torch, fa, gen):
    """K1/K3/K4, bf16 and int8 scoring, with 65600 (batch, head) rows
    against their plain versions (K1's out and lse, the gradients in
    bf16); failure messages."""
    dev, bf16 = torch.device('cuda'), torch.bfloat16
    shape = (GRID_B, GRID_H, GRID_T, 64)
    q, k, v, g = (randn(torch, shape, gen, dev, bf16) for _ in range(4))
    failures = []
    for quant in (None, 'int8'):
        before = [fn.launches for fn in (fa.flash_attention,
                                         fa.flash_attention_dq,
                                         fa.flash_attention_dkv)]
        kw = dict(causal=True, qk_quant=quant)
        out, lse = fa.flash_attention_with_lse(q, k, v, **kw)
        got = dict(zip(('out', 'dq', 'dk', 'dv'), (out, *(
            fa.flash_attention_backward(q, k, v, out, lse, g, True,
                                        qk_quant=quant)))))
        launched = [fn.launches - n for fn, n in zip(
            (fa.flash_attention, fa.flash_attention_dq,
             fa.flash_attention_dkv), before)]
        out_p, lse_p = fa.flash_attention_plain_lse(q, k, v, **kw)
        want = dict(zip(('out', 'dq', 'dk', 'dv'), (out_p, *(
            fa.flash_attention_backward_plain(q, k, v, out, lse, g, True,
                                              qk_quant=quant)))))
        torch.cuda.synchronize()
        rel = {n: rel_errs(torch, got[n], want[n]) for n in got}
        lse_err = (lse - lse_p).abs().max().item()
        name = f'large_grid_{quant or "bf16"}'
        emit({'phase': 'flash_masks', 'case': name, 'q': list(shape),
              'rows': GRID_B * GRID_H, 'qk_quant': quant,
              'launches': dict(zip(('k1', 'k3', 'k4'), launched)),
              'lse_max_abs_err': lse_err,
              'max_row_rel_err': {n: e[0] for n, e in rel.items()},
              'rel_err': {n: e[1] for n, e in rel.items()},
              'tol': {'lse': TOL_LSE, 'row_rel': TOL_ROW_REL,
                      'rel': TOL_NORM_REL}})
        failures += check_rel(rel, name)
        if not lse_err <= TOL_LSE:
            failures.append(f'{name}: lse abs err {lse_err} > {TOL_LSE}')
        if launched != [1, 1, 1]:
            failures.append(f'{name}: launches {launched}, want one each')
        del out, lse, got, out_p, lse_p, want
        torch.cuda.empty_cache()
    return failures


def phase_train_path(torch, ddp):
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(3)
    t0 = time.perf_counter()
    model = ddp.TransformerLM(VOCAB, DIM, HEADS, n_layers=LAYERS,
                              dtype=torch.bfloat16, remat=True, device=dev,
                              generator=gen)
    optimizer = torch.optim.Adam(model.parameters(), lr=LR,
                                 betas=(0.9, 0.999), eps=1e-8)
    step = ddp.make_lm_train_step(model, optimizer, loss_chunk=LOSS_CHUNK)
    tokens = torch.randint(0, VOCAB, (TRAIN_B, TRAIN_T), generator=gen
                           ).to(dev)
    batch = (tokens, ddp.lm_targets(tokens))
    build_s = time.perf_counter() - t0

    counters = {name: getattr(ddp, name) for name in TRAIN_KERNELS}
    expected = {'flash_attention': 2 * LAYERS,      # forward + remat
                'flash_attention_dq': LAYERS, 'flash_attention_dkv': LAYERS}
    for fn in counters.values():
        fn.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, per_step = [], [], []
    for _ in range(TRAIN_STEPS):
        before = {n: fn.launches for n, fn in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss.item())
        per_step.append({n: fn.launches - before[n]
                         for n, fn in counters.items()})
    launches = {n: fn.launches for n, fn in counters.items()}
    median_ms = statistics.median(step_ms[1:])
    row = {'phase': 'train_path',
           'params': sum(p.numel() for p in model.parameters()),
           'model_build_s': build_s, 'batch': [TRAIN_B, TRAIN_T],
           'losses': losses, 'step_ms': step_ms,
           'ms_per_step_median_2_5': median_ms,
           'tokens_per_s': TRAIN_B * TRAIN_T / (median_ms / 1e3),
           'max_memory_allocated': torch.cuda.max_memory_allocated(),
           'launches_per_step': per_step,
           'expected_launches_per_step': expected, 'launches': launches}
    emit(row)
    SAME_CALL['train_path'] = {k: row[k] for k in (
        'ms_per_step_median_2_5', 'tokens_per_s', 'max_memory_allocated')}
    check(all(math.isfinite(x) for x in losses), 'non-finite loss')
    check(losses[-1] < losses[0],
          f'loss did not fall: {losses[0]} -> {losses[-1]}')
    for i, counts in enumerate(per_step):
        check(counts == expected,
              f'step {i + 1} launched {counts}, want {expected}')
    del model, optimizer, step, batch
    torch.cuda.empty_cache()
    return launches


def phase_train_cpu_reference(torch, ddp):
    gen = torch.Generator().manual_seed(4)
    t0 = time.perf_counter()
    cpu = ddp.TransformerLM(VOCAB, DIM, HEADS, n_layers=REF_LAYERS,
                            remat=True, device='cpu', generator=gen)
    card = ddp.TransformerLM(VOCAB, DIM, HEADS, n_layers=REF_LAYERS,
                             dtype=torch.bfloat16, remat=True,
                             device='cuda')
    card.load_state_dict(cpu.state_dict())
    tokens = torch.randint(0, VOCAB, (1, REF_T), generator=gen)
    targets = ddp.lm_targets(tokens)
    loss, grads = {}, {}
    for side, m in (('card', card), ('cpu', cpu)):
        s, c = m.nll_sum(tokens.to(m.device), targets.to(m.device),
                         chunk=LOSS_CHUNK)
        value = s / c.clamp_min(1.0)
        value.backward()
        loss[side] = value.item()
        grads[side] = {n: p.grad.float().cpu()
                       for n, p in m.named_parameters()}
    loss_rel = abs(loss['card'] - loss['cpu']) / abs(loss['cpu'])
    grad_rel = {n: (torch.linalg.vector_norm(grads['card'][n] - g)
                    / torch.linalg.vector_norm(g)).item()
                for n, g in grads['cpu'].items()}
    worst = max(grad_rel, key=grad_rel.get)
    row = {'phase': 'train_cpu_reference', 'layers': REF_LAYERS,
           'batch': [1, REF_T], 'loss': loss, 'loss_rel_err': loss_rel,
           'tol_loss_rel': TOL_REF_LOSS_REL,
           'worst_grad': worst, 'worst_grad_rel_err': grad_rel[worst],
           'tol_grad_rel': TOL_REF_GRAD_REL, 'grad_rel_err': grad_rel,
           'seconds': time.perf_counter() - t0}
    emit(row)
    check(math.isfinite(loss['card']), 'non-finite card loss')
    check(loss_rel <= TOL_REF_LOSS_REL,
          f'loss rel err {loss_rel} > {TOL_REF_LOSS_REL}')
    check(grad_rel[worst] <= TOL_REF_GRAD_REL,
          f'{worst}: grad rel err {grad_rel[worst]} > {TOL_REF_GRAD_REL}')


# The ALiBi LM (alibi_lm): train_path's and main_path's 16-layer
# TransformerLM with use_rope=False and the classic slopes, trained
# ALIBI_TRAIN_STEPS Adam steps at B 4 x T 4096 (float32 parameters, bf16,
# remat), then served from the trained weights: greedy generation at batch
# 4, prompt 1000, 64 steps, and the same steps through paged caches (page
# 16, pages scrambled).
ALIBI_TRAIN_STEPS = 3
ALIBI_KERNELS = TRAIN_KERNELS + ('flash_decode', 'flash_decode_paged')


def _alibi_counts(ddp):
    """``{kernel: (launches, ALiBi launches)}`` of the ALiBi LM's path."""
    return {n: (getattr(ddp, n).launches, getattr(ddp, n).alibi_launches)
            for n in ALIBI_KERNELS}


def _zero_counts(ddp, names):
    for n in names:
        fn = getattr(ddp, n)
        fn.launches = fn.alibi_launches = 0
        if hasattr(fn, 'positions_launches'):
            fn.positions_launches = 0


def phase_alibi_lm(torch, ddp):
    """The ALiBi LM trained and served on the card: each train step's
    K1 / K3 / K4 launches (every one ALiBi), losses, ms per step,
    tokens/s and peak memory; the greedy run's K1 prefill and K5 steps
    (every one ALiBi), prefill ms and ms per decode step; the paged route
    (K5p ALiBi) bit for bit the slab route, logits and tokens; the
    trained weights' prefill logits against float32 on the CPU. The RoPE
    LM's numbers of this call stand beside them."""
    from distributed_dot_product_tpu_torch.models.lm import greedy_generate
    dev, bf16 = torch.device('cuda'), torch.bfloat16
    gen = torch.Generator().manual_seed(5)
    attn = dict(use_rope=False, alibi_slopes=ALIBI_SLOPES)
    model = ddp.TransformerLM(VOCAB, DIM, HEADS, n_layers=LAYERS,
                              dtype=bf16, remat=True, attn_kwargs=attn,
                              device=dev, generator=gen)
    optimizer = torch.optim.Adam(model.parameters(), lr=LR,
                                 betas=(0.9, 0.999), eps=1e-8)
    step = ddp.make_lm_train_step(model, optimizer, loss_chunk=LOSS_CHUNK)
    tokens = torch.randint(0, VOCAB, (TRAIN_B, TRAIN_T), generator=gen
                           ).to(dev)
    batch = (tokens, ddp.lm_targets(tokens))
    expected = {'flash_attention': 2 * LAYERS,      # forward + remat
                'flash_attention_dq': LAYERS, 'flash_attention_dkv': LAYERS,
                'flash_decode': 0, 'flash_decode_paged': 0}
    failures = []
    # The training path: counts at 0 just before, read just after.
    _zero_counts(ddp, ALIBI_KERNELS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, per_step = [], [], []
    for i in range(ALIBI_TRAIN_STEPS):
        before = _alibi_counts(ddp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss.item())
        counts = {n: [a - b for a, b in zip(c, before[n])]
                  for n, c in _alibi_counts(ddp).items()}
        per_step.append(counts)
        for n, want in expected.items():
            if counts[n] != [want, want]:
                failures.append(f'alibi_lm train step {i + 1}: {n} '
                                f'(launches, ALiBi) {counts[n]}, want '
                                f'{[want, want]}')
    train_launches = {n: c[0] for n, c in _alibi_counts(ddp).items()}
    median_ms = statistics.median(step_ms[1:])
    rope = SAME_CALL.get('train_path')
    emit({'phase': 'alibi_lm', 'case': 'train',
          'params': sum(p.numel() for p in model.parameters()),
          'batch': [TRAIN_B, TRAIN_T], 'alibi_slopes': list(ALIBI_SLOPES),
          'losses': losses, 'step_ms': step_ms,
          'ms_per_step_median_2_3': median_ms,
          'tokens_per_s': TRAIN_B * TRAIN_T / (median_ms / 1e3),
          'max_memory_allocated': torch.cuda.max_memory_allocated(),
          'launches_per_step': per_step,
          'rope_lm_same_call': rope})
    if not all(math.isfinite(x) for x in losses):
        failures.append('alibi_lm: non-finite loss')
    if not losses[-1] < losses[0]:
        failures.append(f'alibi_lm: loss did not fall: {losses}')
    del optimizer, step, batch
    torch.cuda.empty_cache()

    # Serving from the trained weights (float32 parameters, bf16
    # compute), as main_path serves the RoPE LM.
    prompts = torch.randint(0, VOCAB, (BATCH, PROMPT), generator=gen
                            ).to(dev)
    greedy_generate(model, prompts, 2, T_MAX)           # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    greedy_generate(model, prompts, 1, T_MAX)           # prefill only
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    _zero_counts(ddp, ALIBI_KERNELS)
    t0 = time.perf_counter()
    out_tokens = greedy_generate(model, prompts, STEPS, T_MAX)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    serve_launches = _alibi_counts(ddp)
    want = {'flash_attention': LAYERS, 'flash_decode': LAYERS * (STEPS - 1),
            'flash_attention_dq': 0, 'flash_attention_dkv': 0,
            'flash_decode_paged': 0}
    for n, w in want.items():
        if list(serve_launches[n]) != [w, w]:
            failures.append(f'alibi_lm greedy: {n} (launches, ALiBi) '
                            f'{serve_launches[n]}, want {[w, w]}')

    # The paged route: the same prefill, then the same decode steps
    # through paged twins of every layer's cache (K5p), bit for bit the
    # slab route (K5): logits and tokens.
    with torch.inference_mode():
        caches = model.make_decode_caches(BATCH, T_MAX)
        caches, logits = model.prefill(prompts, caches)
        first_finite = bool(torch.isfinite(logits).all().item())
        tok = logits[:, -1:].argmax(dim=-1).to(torch.int32)
        gpu_last = logits[0, -1].float().cpu()
        pcaches = [_paged_twin(torch, ddp, c, gen) for c in caches]
        slab_logits, slab_tok, t_s = [], [tok], tok
        for _ in range(STEPS - 1):
            caches, lg = model.decode(t_s, caches)
            t_s = lg[:, -1:].argmax(dim=-1).to(torch.int32)
            slab_logits.append(lg)
            slab_tok.append(t_s)
        _zero_counts(ddp, ALIBI_KERNELS)
        paged_ms, paged_logits, paged_tok, t_p = [], [], [tok], tok
        for _ in range(STEPS - 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pcaches, lg = model.decode(t_p, pcaches)
            t_p = lg[:, -1:].argmax(dim=-1).to(torch.int32)
            torch.cuda.synchronize()
            paged_ms.append(1e3 * (time.perf_counter() - t0))
            paged_logits.append(lg)
            paged_tok.append(t_p)
        paged_launches = _alibi_counts(ddp)
        slab_tokens = torch.cat(slab_tok, dim=1)
        paged_same = {
            'logits': all(torch.equal(a, b) for a, b in
                          zip(slab_logits, paged_logits)),
            'tokens': bool(torch.equal(torch.cat(paged_tok, dim=1),
                                       slab_tokens)),
            'greedy_generate_tokens': bool(torch.equal(slab_tokens,
                                                       out_tokens))}
        finite = first_finite and all(torch.isfinite(x).all().item()
                                       for x in slab_logits)
    del caches, pcaches, slab_logits, paged_logits
    torch.cuda.empty_cache()
    w = LAYERS * (STEPS - 1)
    if list(paged_launches['flash_decode_paged']) != [w, w] or \
            paged_launches['flash_decode'][0]:
        failures.append(f'alibi_lm paged: launches {paged_launches}, want '
                        f'{w} K5p ALiBi and no K5')
    if not all(paged_same.values()):
        failures.append(f'alibi_lm paged: not bit-equal to the slab route '
                        f'{paged_same}')
    if not finite:
        failures.append('alibi_lm: non-finite logits')

    # The trained weights in float32 on the CPU (plain versions): prompt
    # 0's last prefill logits.
    t0 = time.perf_counter()
    cpu = ddp.TransformerLM(VOCAB, DIM, HEADS, n_layers=LAYERS,
                            attn_kwargs=attn, device='cpu')
    cpu.load_state_dict({k: v.float().cpu()
                         for k, v in model.state_dict().items()})
    with torch.inference_mode():
        _, cpu_logits = cpu.prefill(prompts[:1].cpu(),
                                    cpu.make_decode_caches(1, T_MAX))
    cpu_last = cpu_logits[0, -1]
    rel = ((gpu_last - cpu_last).abs().max() / cpu_last.abs().max()).item()
    cpu_s = time.perf_counter() - t0
    del cpu, model
    torch.cuda.empty_cache()
    rope = SAME_CALL.get('main_path')
    emit({'phase': 'alibi_lm', 'case': 'serve', 'batch': BATCH,
          'prompt': PROMPT, 'steps': STEPS, 't_max': T_MAX,
          'prefill_ms': prefill_ms,
          'ms_per_decode_step': (1e3 * total_s - prefill_ms) / (STEPS - 1),
          'generate_s': total_s, 'tokens_per_s': BATCH * STEPS / total_s,
          'launches': serve_launches,
          'paged': {'page_size': SERVE_PAGE, 'steps': STEPS - 1,
                    'launches': paged_launches,
                    'step_ms_median': statistics.median(paged_ms),
                    'bit_equal_slab': paged_same},
          'cpu_reference': {'last_logits_max_rel_err': rel,
                            'tol': TOL_LM_REL, 'seconds': cpu_s},
          'rope_lm_same_call': rope})
    if not rel <= TOL_LM_REL:
        failures.append(f'alibi_lm: logits rel err {rel} > {TOL_LM_REL}')
    check(not failures, '; '.join(failures))
    return {'train': train_launches,
            'greedy': {n: c[0] for n, c in serve_launches.items()},
            'paged': {n: c[0] for n, c in paged_launches.items()}}


# The sequence-parallel phase's SP_RANKS ranks, all on card 0 over gloo
# (host-staged collectives) unless there is a card per rank (NCCL).
SP_LABEL = f'{SP_RANKS} ranks on one card, gloo'
SP_STEPS = 3
SP_CHECK_B, SP_CHECK_T = 2, 2048    # distributed vs local, W = 4
# Distributed vs the local module, W = 4, per tensor (rows as above;
# weight gradients whole-tensor). The float32 'full' path differs only by
# float32 summation order over 2048..8192 terms (~1e-6): 1e-4. The bf16
# kernel paths round the same values to bf16 at different points on the
# two sides: the ring's per-fold softmax weights and its float32 merge,
# the bf16 sum of four ranks' cotangents in the gathers' reduce-scatter,
# the bf16 output of each rank's weight-gradient GEMM before the float32
# sum over ranks. One such rounding moves a tensor by up to 2^-9 relative
# (the composition weight's gradient, rounded once more on one side,
# reads 2.3e-3 whole); a gradient chain holds at most four of them in
# series: whole 4 * 2^-9 ~ 8e-3, a row 2.5x that (the kernels' own
# row-to-whole ratio above).
SP_TOL_F32 = 1e-4
SP_TOL_BF16_ROW, SP_TOL_BF16 = 2e-2, 8e-3
# (name, softmax_impl, flash_softmax_mode, causal): the configurations of
# dryrun_multichip's strategies, the bounded flash mode and a causal ring.
SP_CONFIGS = (('full', 'full', 'exact', False),
              ('flash', 'flash', 'exact', False),
              ('online', 'online', 'exact', False),
              ('flash_bounded', 'flash', 'bounded', False),
              ('ulysses', 'ulysses', 'exact', False),
              ('online_causal', 'online', 'exact', True))
SP_KERNELS = ('flash_attention', 'flash_attention_bounded',
              'flash_attention_dq', 'flash_attention_dkv')


def sp_expected(name, seq_rank, seq):
    """Launches per train step of (K1, K2, K3, K4) on a rank: one forward
    and one backward per step; the ring folds W blocks (rank + 1 under
    causal masking: the rest lie in its future)."""
    if name == 'full':
        return (0, 0, 0, 0)
    if name.startswith('online'):
        folds = seq_rank + 1 if name.endswith('causal') else seq
        return (folds, 0, folds, folds)
    if name == 'flash_bounded':
        return (0, 1, 1, 1)
    return (1, 0, 1, 1)


def _sp_module(torch, ddp, impl, mode, causal, dev, seed=0):
    kernel_path = impl != 'full'
    return ddp.DistributedDotProductAttn(
        key_dim=SP_DIM, num_heads=SP_HEADS, offset=SP_OFFSET,
        softmax_impl=impl, flash_softmax_mode=mode, causal=causal,
        dtype=torch.bfloat16 if kernel_path else torch.float32, device=dev,
        generator=torch.Generator().manual_seed(seed))


def _sp_wall_ms(torch, ddp, fn, group=None, reps=3):
    """Median wall time of ``fn`` over ``reps`` calls on every rank at
    once (a barrier before each; the card synchronised around it): the
    collectives are host-staged, so the host's clock is the honest one."""
    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        ddp.synchronize(group)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _sp_run(torch, ddp, rank, dev):
    """One rank's part of the seq_parallel phase; returns its numbers."""
    import importlib
    comm = importlib.import_module(
        'distributed_dot_product_tpu_torch.utils.comm')
    res = {'rank': rank, 'transport': comm.transport(None, dev)}
    world = comm.get_world_size()

    # entry(): the flagship module, B 1 x T 1024, all-False mask, 'full',
    # forward at W = 1 (rank 0 alone) and W = 4.
    model = _sp_module(torch, ddp, 'full', 'exact', False, dev)
    x = torch.ones((1, 1024, SP_DIM), device=dev)
    mask = torch.zeros((1, 1024, 1024), dtype=torch.bool, device=dev)
    mesh1, mesh4 = ddp.seq_mesh(1), ddp.seq_mesh(world)
    with torch.no_grad():
        if rank == 0:
            out1 = ddp.apply_seq_parallel(model, mesh1, x, x, x, mask)
        out4 = ddp.apply_seq_parallel(model, mesh4, x, x, x, mask)
        res['entry'] = {
            'shape': list(out4.shape),
            'finite': bool(torch.isfinite(out4).all().item()),
            'ms_w4': _sp_wall_ms(torch, ddp, lambda: ddp.apply_seq_parallel(
                model, mesh4, x, x, x, mask))}
        if rank == 0:
            res['entry']['w4_vs_w1_max_rel'] = (
                (out4 - out1).abs().max() / out1.abs().max()).item()
            res['entry']['ms_w1'] = _sp_wall_ms(
                torch, ddp, lambda: ddp.apply_seq_parallel(
                    model, mesh1, x, x, x, mask), group=mesh1.seq_group)
    del model, out4

    # nt / all / tn at the flagship's widths: (B 2, 8 heads, T 8192) over
    # the W = 4 sequence shards, float32 as on the 'full' path.
    gen = torch.Generator().manual_seed(100 + rank)
    tn_local = SP_T // world
    a = randn(torch, (2, SP_HEADS, tn_local, SP_HEAD_DIM), gen, dev,
              torch.float32)
    b = randn(torch, (2, SP_HEADS, tn_local, SP_HEAD_DIM), gen, dev,
              torch.float32)
    with torch.no_grad():
        scores = ddp.distributed_matmul_nt(a, b, SP_OFFSET)
        res['matmuls'] = {
            'nt_ms': _sp_wall_ms(torch, ddp, lambda: ddp.distributed_matmul_nt(
                a, b, SP_OFFSET)),
            'all_ms': _sp_wall_ms(torch, ddp, lambda: ddp.distributed_matmul_all(
                scores, b, SP_OFFSET)),
            'tn_ms': _sp_wall_ms(torch, ddp, lambda: ddp.distributed_matmul_tn(
                scores, b)),
            'scores_shape': list(scores.shape)}
    del a, b, scores
    torch.cuda.empty_cache()

    # Distributed (W = 4) vs the local module on the gathered tensors.
    from distributed_dot_product_tpu_torch.utils.comm import all_reduce
    gen = torch.Generator().manual_seed(7)      # the same on every rank
    xs = [randn(torch, (SP_CHECK_B, SP_CHECK_T, SP_DIM), gen, dev,
                torch.float32) for _ in range(4)]
    cmask = (torch.rand((SP_CHECK_B, SP_CHECK_T, SP_CHECK_T), generator=gen)
             < 0.3).to(dev)
    res['vs_local'] = {}
    for name, impl, mode, causal in SP_CONFIGS:
        mod = _sp_module(torch, ddp, impl, mode, causal, dev)
        shards = [ddp.shard_seq(t, mesh4).clone().requires_grad_()
                  for t in xs[:3]]
        out = mod(*shards, ddp.shard_seq(cmask, mesh4), group=None)
        (out.float() * ddp.shard_seq(xs[3], mesh4)).sum().backward()
        got = {'out': ddp.unshard_seq(out, mesh4)}
        for n, t in zip(('d_keys', 'd_queries', 'd_values'), shards):
            got[n] = ddp.unshard_seq(t.grad, mesh4)
        pgrads = {n: all_reduce(p.grad) for n, p in mod.named_parameters()}
        if rank == 0:
            local = _sp_module(torch, ddp, impl, mode, causal, dev)
            local.distributed = False
            gx = [t.clone().requires_grad_() for t in xs[:3]]
            ref = local(*gx, cmask)
            (ref.float() * xs[3]).sum().backward()
            want = {'out': ref, 'd_keys': gx[0].grad, 'd_queries': gx[1].grad,
                    'd_values': gx[2].grad}
            errs = {n: rel_errs(torch, got[n], want[n]) for n in want}
            for n, p in local.named_parameters():
                whole = (torch.linalg.vector_norm(pgrads[n].float()
                                                  - p.grad.float())
                         / torch.linalg.vector_norm(p.grad.float())).item()
                errs[n] = (whole, whole)
            res['vs_local'][name] = errs
            del local, ref, gx
        del mod, out, shards, got, pgrads
        torch.cuda.empty_cache()
    del xs, cmask

    # The DP x SP train step on a 2 x 2 group: global B 4 x T 8192,
    # all-False mask, MSE against zeros, Adam 1e-3, SP_STEPS steps.
    mesh = ddp.data_seq_mesh(SP_DATA, SP_SEQ)
    res['seq_rank'], res['data_rank'] = mesh.seq_rank, mesh.data_rank
    res['seq_transport'] = comm.transport(mesh.seq_group, dev)
    gen = torch.Generator().manual_seed(3)
    x = randn(torch, (SP_B, SP_T, SP_DIM), gen, dev, torch.float32)
    batch = (x, x, x, torch.zeros((SP_B, SP_T, SP_T), dtype=torch.bool,
                                  device=dev), torch.zeros_like(x))
    counters = [getattr(ddp, n) for n in SP_KERNELS]
    res['train'] = {}
    for name, impl, mode, causal in SP_CONFIGS:
        mod = _sp_module(torch, ddp, impl, mode, causal, dev, seed=1)
        opt = torch.optim.Adam(mod.parameters(), lr=1e-3)
        step = ddp.make_train_step(mod, opt, mesh, data_axis='data')
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        for fn in counters:
            fn.launches = 0
        losses, ms, per_step = [], [], []
        for _ in range(SP_STEPS):
            before = [fn.launches for fn in counters]
            torch.cuda.synchronize()
            ddp.synchronize()
            t0 = time.perf_counter()
            loss = step(batch).item()
            ms.append(1e3 * (time.perf_counter() - t0))
            losses.append(loss)
            per_step.append([fn.launches - b for fn, b in
                             zip(counters, before)])
        res['train'][name] = {
            'losses': losses, 'step_ms': ms,
            'launches_per_step': per_step,
            'launches': [fn.launches for fn in counters],
            'expected_per_step': list(sp_expected(name, mesh.seq_rank,
                                                  SP_SEQ)),
            'max_memory_allocated': torch.cuda.max_memory_allocated(dev)}
        del mod, opt, step
        torch.cuda.empty_cache()
    return res


def _sp_worker(rank, world, init_method, backend, results, run='_sp_run'):
    """A rank of a multi-rank phase: joins the group, runs ``run`` (the
    name of :func:`_sp_run`, :func:`_zz_run`, :func:`_ds_run` or
    :func:`_flagship_run`),
    and reports its numbers or its traceback."""
    import traceback
    try:
        import torch
        import distributed_dot_product_tpu_torch as ddp
        torch.set_num_threads(2)
        dev = torch.device('cuda', rank if backend == 'nccl' else 0)
        torch.cuda.set_device(dev)
        ddp.init(backend, init_method, world, rank)
        results.put((rank, True, globals()[run](torch, ddp, rank, dev)))
    except Exception:
        # Reported to the parent, which fails the phase; the rank dies.
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        import torch.distributed as dist
        if dist.is_initialized():
            dist.destroy_process_group()


def _spawn_ranks(torch, phase, run, timeout, world=SP_RANKS):
    """``world`` processes running ``run``, on card 0 over gloo
    (host-staged collectives) unless there is a card per rank (NCCL):
    ``(results by rank, seconds, backend)``. A rank that fails, or the
    phase timing out, fails the phase; every process is stopped either
    way."""
    import multiprocessing as mp
    import queue
    import socket
    torch.cuda.empty_cache()
    backend = 'nccl' if torch.cuda.device_count() >= world else 'gloo'
    with socket.socket() as sock:
        sock.bind(('localhost', 0))
        port = sock.getsockname()[1]
    ctx = mp.get_context('spawn')
    results = ctx.Queue()
    procs = [ctx.Process(target=_sp_worker, daemon=True,
                         args=(r, world, f'tcp://localhost:{port}',
                               backend, results, run))
             for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    ranks = {}
    try:
        while len(ranks) < world:
            left = timeout - (time.perf_counter() - t0)
            try:
                rank, ok, value = results.get(timeout=max(left, 1))
            except queue.Empty:
                raise PhaseError(f'{phase}: ranks '
                                 f'{sorted(set(range(world)) - set(ranks))}'
                                 f' did not finish within {timeout} s')
            check(ok, f'{phase} rank {rank} failed:\n{value}')
            ranks[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
    return ranks, time.perf_counter() - t0, backend


def phase_seq_parallel(torch, ddp, timeout=600):
    """W = 4 ranks of the sequence-parallel layer, spawned after the
    kernels are built: entry() at W = 1 and 4, nt / all / tn, each
    strategy against the local module, and SP_STEPS DP x SP train steps
    per strategy with launch counts. A rank that fails or the phase
    timing out fails the phase."""
    ranks, seconds, backend = _spawn_ranks(torch, 'seq_parallel', '_sp_run',
                                           timeout)
    r0 = ranks[0]
    label = (SP_LABEL if backend == 'gloo'
             else f'{SP_RANKS} ranks on {SP_RANKS} cards, nccl')
    base = {'phase': 'seq_parallel', 'ranks': SP_RANKS, 'label': label,
            'transport': r0['transport']}
    failures = []
    entry = r0['entry']
    emit({**base, 'case': 'entry', 'module': {
        'key_dim': SP_DIM, 'num_heads': SP_HEADS, 'offset': SP_OFFSET,
        'softmax_impl': 'full'}, 'batch': [1, 1024], **entry,
        'ms_w4_by_rank': [ranks[r]['entry']['ms_w4'] for r in sorted(ranks)],
        'tol': SP_TOL_F32})
    if not all(ranks[r]['entry']['finite'] for r in ranks):
        failures.append('entry: non-finite output')
    if not entry['w4_vs_w1_max_rel'] <= SP_TOL_F32:
        failures.append(f'entry: W=4 vs W=1 rel err '
                        f'{entry["w4_vs_w1_max_rel"]} > {SP_TOL_F32}')
    emit({**base, 'case': 'matmuls', 'offset': SP_OFFSET,
          'shard': [2, SP_HEADS, SP_T // SP_RANKS, SP_HEAD_DIM],
          'dtype': 'float32', **r0['matmuls'],
          'by_rank': {k: [ranks[r]['matmuls'][k] for r in sorted(ranks)]
                      for k in ('nt_ms', 'all_ms', 'tn_ms')}})
    for name, impl, mode, causal in SP_CONFIGS:
        errs = r0['vs_local'][name]
        emit({**base, 'case': 'vs_local', 'strategy': name,
              'batch': [SP_CHECK_B, SP_CHECK_T], 'mask': 'random 30%',
              'max_row_rel_err': {n: e[0] for n, e in errs.items()},
              'rel_err': {n: e[1] for n, e in errs.items()},
              'tol': ({'row_rel': SP_TOL_F32, 'rel': SP_TOL_F32}
                      if impl == 'full' else
                      {'row_rel': SP_TOL_BF16_ROW, 'rel': SP_TOL_BF16})})
        for n, (row, whole) in errs.items():
            lim_row, lim = ((SP_TOL_F32, SP_TOL_F32) if impl == 'full'
                            else (SP_TOL_BF16_ROW, SP_TOL_BF16))
            if not (row <= lim_row and whole <= lim):
                failures.append(f'{name} vs local {n}: row {row}, whole '
                                f'{whole} > ({lim_row}, {lim})')
    launches = {}
    for name, impl, mode, causal in SP_CONFIGS:
        runs = {r: ranks[r]['train'][name] for r in sorted(ranks)}
        t0r = runs[0]
        emit({**base, 'case': 'train', 'strategy': name,
              'mesh': {'data': SP_DATA, 'seq': SP_SEQ},
              'seq_transport': r0['seq_transport'],
              'batch': [SP_B, SP_T], 'module': {
                  'key_dim': SP_DIM, 'num_heads': SP_HEADS,
                  'offset': SP_OFFSET, 'softmax_impl': impl,
                  'flash_softmax_mode': mode, 'causal': causal,
                  'compute': 'float32' if impl == 'full' else 'bfloat16'},
              'optimizer': 'adam 1e-3', 'losses': t0r['losses'],
              'step_ms_rank0': t0r['step_ms'],
              'ms_per_step_median': statistics.median(
                  max(runs[r]['step_ms'][i] for r in runs)
                  for i in range(SP_STEPS)),
              'kernels': list(SP_KERNELS),
              'launches_per_step': {r: runs[r]['launches_per_step']
                                    for r in runs},
              'expected_per_step': {r: runs[r]['expected_per_step']
                                    for r in runs},
              'max_memory_allocated': {r: runs[r]['max_memory_allocated']
                                       for r in runs}})
        for r, run in runs.items():
            if not all(math.isfinite(v) for v in run['losses']):
                failures.append(f'{name} rank {r}: non-finite loss')
            want = run['expected_per_step']
            for i, got in enumerate(run['launches_per_step']):
                if got != want:
                    failures.append(f'{name} rank {r} step {i + 1}: '
                                    f'launched {got}, want {want}')
        if len({tuple(runs[r]['losses']) for r in runs}) != 1:
            failures.append(f'{name}: ranks report different losses')
        launches[name] = dict(zip(SP_KERNELS, t0r['launches']))
    if launches['flash_bounded']['flash_attention_bounded'] < 1:
        failures.append('flash_bounded: K2 never launched')
    emit({**base, 'case': 'summary', 'seconds': seconds,
          'backend': backend})
    check(not failures, '; '.join(failures))
    return launches


# The zigzag causal ring (zigzag_ring): the flagship module with causal
# masking, RoPE and ALiBi, DistributedDotProductAttn(key_dim=512,
# num_heads=8, causal=True, use_rope=True, softmax_impl='online',
# alibi_slopes=2^(-8i/8)), on a sequence group of the SP_RANKS ranks at
# seq_parallel's B 4 x T 8192 (2048 rows a rank): one forward and backward
# per ring layout, then one 'ulysses' step of the same module.
ZZ_KERNELS = ('flash_attention', 'flash_attention_dq', 'flash_attention_dkv')


def _zz_module(torch, ddp, dev, impl='online', layout='contiguous',
               distributed=True):
    return ddp.DistributedDotProductAttn(
        key_dim=SP_DIM, num_heads=SP_HEADS, causal=True, use_rope=True,
        softmax_impl=impl, ring_layout=layout, alibi_slopes=ALIBI_SLOPES,
        distributed=distributed, dtype=torch.bfloat16, device=dev,
        generator=torch.Generator().manual_seed(21))


def _zz_counts(ddp):
    """``{kernel: [launches, ALiBi launches, positions launches]}``."""
    return {n: [getattr(ddp, n).launches, getattr(ddp, n).alibi_launches,
                getattr(ddp, n).positions_launches] for n in ZZ_KERNELS}


def _zz_run(torch, ddp, rank, dev):
    """One rank of zigzag_ring: the module's forward and backward on this
    rank's shard of the global inputs, contiguous and zigzag (inputs
    permuted by zigzag_indices), then 'ulysses', each after an untimed
    pass; launches and wall ms of the timed pass, and (rank 0) each run
    against its twin: zigzag against contiguous after the permutation,
    ulysses against the local flash module."""
    import importlib
    comm = importlib.import_module(
        'distributed_dot_product_tpu_torch.utils.comm')
    ra = importlib.import_module(
        'distributed_dot_product_tpu_torch.models.ring_attention')
    world = comm.get_world_size()
    mesh = ddp.seq_mesh(world)
    gen = torch.Generator().manual_seed(23)     # the same on every rank
    xs = [randn(torch, (SP_B, SP_T, SP_DIM), gen, dev, torch.float32)
          for _ in range(4)]
    idx = ra.zigzag_indices(SP_T, world).to(dev)
    inv = torch.argsort(idx)
    res = {'rank': rank, 'transport': comm.transport(None, dev), 'runs': {}}
    got = {}
    for name, impl, layout in (('contiguous', 'online', 'contiguous'),
                               ('zigzag', 'online', 'zigzag'),
                               ('ulysses', 'ulysses', 'contiguous')):
        mod = _zz_module(torch, ddp, dev, impl, layout)
        glob = [x[:, idx] for x in xs] if layout == 'zigzag' else xs
        g = ddp.shard_seq(glob[3], mesh)
        # An untimed pass first: the ranks' first hops set up their gloo
        # pairs, and the first launches load the kernel libraries.
        for timed in (False, True):
            mod.zero_grad()
            shards = [ddp.shard_seq(t, mesh).clone().requires_grad_()
                      for t in glob[:3]]
            _zero_counts(ddp, ZZ_KERNELS)
            torch.cuda.synchronize()
            ddp.synchronize()
            t0 = time.perf_counter()
            out = mod(*shards, None, group=mesh.seq_group)
            (out.float() * g).sum().backward()
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t0)
        res['runs'][name] = {'launches': _zz_counts(ddp), 'wall_ms': wall}
        tensors = {'out': ddp.unshard_seq(out, mesh)}
        for n, t in zip(('d_keys', 'd_queries', 'd_values'), shards):
            tensors[n] = ddp.unshard_seq(t.grad, mesh)
        if layout == 'zigzag':
            tensors = {n: t[:, inv] for n, t in tensors.items()}
        for n, p in mod.named_parameters():
            tensors[n] = comm.all_reduce(p.grad)
        if rank == 0:
            got[name] = tensors
        del mod, out, shards, g, tensors
        torch.cuda.empty_cache()
    if rank == 0:
        local = _zz_module(torch, ddp, dev, 'flash', distributed=False)
        gx = [x.clone().requires_grad_() for x in xs[:3]]
        ref = local(*gx, None)
        (ref.float() * xs[3]).sum().backward()
        want = {'out': ref, 'd_keys': gx[0].grad, 'd_queries': gx[1].grad,
                'd_values': gx[2].grad,
                **{n: p.grad for n, p in local.named_parameters()}}
        res['errs'] = {}
        for name, twin, ref_t in (('zigzag_vs_contiguous', 'zigzag',
                                   got['contiguous']),
                                  ('ulysses_vs_local_flash', 'ulysses',
                                   want)):
            errs = {}
            for n, t in got[twin].items():
                if n in ('out', 'd_keys', 'd_queries', 'd_values'):
                    errs[n] = rel_errs(torch, t, ref_t[n])
                else:                   # a weight gradient: whole-tensor
                    whole = (torch.linalg.vector_norm(
                        t.float() - ref_t[n].float())
                        / torch.linalg.vector_norm(ref_t[n].float())).item()
                    errs[n] = (whole, whole)
            res['errs'][name] = errs
        res['finite'] = all(bool(torch.isfinite(t).all().item())
                            for run in got.values() for t in run.values())
        del local, gx, ref, want, got
    return res


def zz_expected(layout, rank, world):
    """Launches of K1, K3 and K4 on a rank for one forward and backward:
    the contiguous causal ring folds its rank + 1 past blocks (the rest
    lie wholly in its future), the zigzag ring all W (every pair of
    shards shares a past half-block), ulysses one; every launch ALiBi,
    the zigzag folds' with positions."""
    folds = {'contiguous': rank + 1, 'zigzag': world, 'ulysses': 1}[layout]
    return [folds, folds, folds if layout == 'zigzag' else 0]


def _zz_fold_ms(torch, flush, gen, layout, rank, world):
    """Device ms of each fold a rank's ring runs (K1 with its lse, K3 and
    K4 in float32, with ALiBi), one process alone on the card: the
    contiguous ring's folds of owners <= rank at the ranks' offsets, the
    zigzag ring's W folds at the shards' positions."""
    import importlib
    fa = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_attention')
    dev, bf16 = torch.device('cuda'), torch.bfloat16
    tn, d = SP_T // world, SP_HEAD_DIM
    scale = 1.0 / math.sqrt(d)
    q, k, v, g = (randn(torch, (SP_B, SP_HEADS, tn, d), gen, dev, bf16)
                  for _ in range(4))
    times = []
    for s in range(world):
        owner = (rank + s) % world
        if layout == 'contiguous':
            if owner > rank:
                continue
            kw = dict(causal=True, causal_offset=rank * tn,
                      kv_offset=owner * tn)
        else:
            kw = dict(positions=tuple(zigzag_positions(torch, world, r, tn,
                                                       dev)
                                      for r in (rank, owner)))
        kw['alibi_slopes'] = ALIBI_SLOPES
        out, lse = fa.flash_attention_with_lse(q, k, v, scale=scale, **kw)
        q2, lse2, delta = fa.flash_attention_bwd_operands(q, out, lse, g,
                                                          scale)
        bw = dict(kw, scale=scale, grad_dtype=torch.float32)
        times.append(
            time_ms(torch, lambda: fa.flash_attention_with_lse(
                q, k, v, scale=scale, **kw), flush, reps=10)
            + time_ms(torch, lambda: fa.flash_attention_dq(
                q2, k, v, g, lse2, delta, **bw), flush, reps=10)
            + time_ms(torch, lambda: fa.flash_attention_dkv(
                q2, k, v, g, lse2, delta, **bw), flush, reps=10))
    return times


def phase_zigzag_ring(torch, ddp, timeout=600):
    """The causal ring on both layouts and ulysses, with ALiBi, on
    SP_RANKS ranks: each rank's launches against the folds it runs, the
    zigzag run against its contiguous twin and ulysses against the local
    flash module (the seq_parallel tolerances); then each rank's fold
    device time on both layouts, measured one process alone on the card,
    the slowest rank against the mean (the critical path zigzag
    evens out)."""
    ranks, seconds, backend = _spawn_ranks(torch, 'zigzag_ring', '_zz_run',
                                           timeout)
    label = (SP_LABEL if backend == 'gloo'
             else f'{SP_RANKS} ranks on {SP_RANKS} cards, nccl')
    base = {'phase': 'zigzag_ring', 'ranks': SP_RANKS, 'label': label,
            'transport': ranks[0]['transport'], 'batch': [SP_B, SP_T],
            'module': {'key_dim': SP_DIM, 'num_heads': SP_HEADS,
                       'causal': True, 'use_rope': True,
                       'alibi_slopes': list(ALIBI_SLOPES),
                       'compute': 'bfloat16'}}
    failures = []
    launches = {}
    for name in ('contiguous', 'zigzag', 'ulysses'):
        by_rank = {r: ranks[r]['runs'][name] for r in sorted(ranks)}
        emit({**base, 'case': name, 'launches_by_rank': {
            r: run['launches'] for r, run in by_rank.items()},
            'wall_ms_by_rank': {r: run['wall_ms']
                                for r, run in by_rank.items()}})
        for r, run in by_rank.items():
            folds, _, pos = zz_expected(name, r, SP_RANKS)
            for n, (got, alibi, got_pos) in run['launches'].items():
                if [got, alibi, got_pos] != [folds, folds, pos]:
                    failures.append(
                        f'{name} rank {r} {n}: (launches, ALiBi, positions) '
                        f'{[got, alibi, got_pos]}, want {[folds, folds, pos]}')
        launches[name] = {n: [by_rank[r]['launches'][n][0]
                              for r in sorted(by_rank)] for n in ZZ_KERNELS}
    r0 = ranks[0]
    if not r0['finite']:
        failures.append('zigzag_ring: non-finite output or gradient')
    for name, errs in r0['errs'].items():
        emit({**base, 'case': name,
              'max_row_rel_err': {n: e[0] for n, e in errs.items()},
              'rel_err': {n: e[1] for n, e in errs.items()},
              'tol': {'row_rel': SP_TOL_BF16_ROW, 'rel': SP_TOL_BF16}})
        for n, (row, whole) in errs.items():
            if not (row <= SP_TOL_BF16_ROW and whole <= SP_TOL_BF16):
                failures.append(f'{name} {n}: row {row}, whole {whole} > '
                                f'({SP_TOL_BF16_ROW}, {SP_TOL_BF16})')
    # Each rank's folds, one process alone on the card.
    flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32,
                        device=torch.device('cuda'))
    gen = torch.Generator().manual_seed(29)
    folds = {}
    for layout in ('contiguous', 'zigzag'):
        per_rank = [_zz_fold_ms(torch, flush, gen, layout, r, SP_RANKS)
                    for r in range(SP_RANKS)]
        totals = [sum(x) for x in per_rank]
        mean = statistics.mean(totals)
        folds[layout] = {'fold_ms_by_rank': per_rank,
                         'rank_ms': totals, 'slowest_ms': max(totals),
                         'mean_ms': mean,
                         'slowest_over_mean': max(totals) / mean}
    del flush
    torch.cuda.empty_cache()
    emit({**base, 'case': 'fold_times',
          'timing': 'device ms per fold (K1 with lse + K3 + K4 float32, '
                    'ALiBi), one process alone on the card',
          **folds, 'seconds': seconds, 'backend': backend})
    check(not failures, '; '.join(failures))
    return {'launches': launches, 'folds': folds}


def _ds_module(torch, ddp, dev, dtype=None, impl=None, key_dim=None,
               heads=None):
    """The recipe's decode module at ``key_dim`` (default the flagship's
    512 over 8 heads; GQA 2:1, causal, RoPE), seeded weights, computing at
    ``dtype``."""
    key_dim, heads = key_dim or SP_DIM, heads or SP_HEADS
    return ddp.DistributedDotProductAttn(
        key_dim=key_dim, num_heads=heads, num_kv_heads=heads // 2,
        causal=True, use_rope=True, dtype=dtype, decode_impl=impl,
        device=dev, generator=torch.Generator().manual_seed(11))


DS_COUNTED = ('flash_attention', 'flash_decode', 'flash_decode_paged')


def _ds_run(torch, ddp, rank, dev):
    """One rank's part of the decode_sharded phase; returns its numbers."""
    import importlib
    comm = importlib.import_module(
        'distributed_dot_product_tpu_torch.utils.comm')
    dec = importlib.import_module(
        'distributed_dot_product_tpu_torch.models.decode')
    res = {'rank': rank, 'transport': comm.transport(None, dev)}
    world = comm.get_world_size()
    mesh = ddp.seq_mesh(world)
    bf16 = torch.bfloat16
    mod = _ds_module(torch, ddp, dev, bf16)
    gen = torch.Generator().manual_seed(21)      # the same on every rank
    prompt = randn(torch, (DS_B, DS_PROMPT, SP_DIM), gen, dev, bf16)
    xs = randn(torch, (DS_B, DS_STEPS, SP_DIM), gen, dev, bf16)
    with torch.no_grad():
        # Every rank fills the same local cache by prefill (K1), then
        # takes its slab; rank 0 keeps the whole cache for the local twin.
        cache = mod.make_decode_cache(DS_B, DS_T)
        ddp.flash_attention.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache, _ = mod.prefill(prompt, prompt, prompt, cache)
        torch.cuda.synchronize()
        res['prefill_ms'] = 1e3 * (time.perf_counter() - t0)
        res['prefill_k1_launches'] = ddp.flash_attention.launches
        local = (cache._replace(k=cache.k.clone(), v=cache.v.clone())
                 if rank == 0 else None)
        slab = ddp.shard_decode_cache(cache, mesh)
        del cache, prompt
        torch.cuda.empty_cache()

        # The main path: DS_STEPS sequence-sharded steps, counts at 0
        # just before and read just after.
        outs, ms, per_step, owned = [], [], [], []
        for name in DS_COUNTED:
            getattr(ddp, name).launches = 0
        for t in range(DS_STEPS):
            x = xs[:, t:t + 1]
            owned.append(rank * DS_LOCAL <= slab.length
                         < (rank + 1) * DS_LOCAL)
            before = ddp.flash_decode.launches
            torch.cuda.synchronize()
            ddp.synchronize()
            t0 = time.perf_counter()
            slab, out = ddp.decode_seq_parallel(mod, mesh, x, x, x, slab)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            per_step.append(ddp.flash_decode.launches - before)
            outs.append(out)
        res['launches'] = {n: getattr(ddp, n).launches for n in DS_COUNTED}
        res.update(step_ms=ms, launches_per_step=per_step, owned=owned,
                   length=slab.length)

        # The merge's collectives alone (max, then one sum of numerator
        # and denominator), on this step's partials.
        vt = torch.full((DS_B,), slab.length - 1 - rank * DS_LOCAL,
                        dtype=torch.int32, device=dev)
        ap = torch.full((DS_B,), -1, dtype=torch.int32, device=dev)
        q = randn(torch, (DS_B, SP_HEADS, 1, SP_HEAD_DIM), gen, dev, bf16)
        kv = randn(torch, (DS_B, SP_HEADS // 2, 1, SP_HEAD_DIM), gen, dev,
                   bf16)
        parts, _, _ = ddp.flash_decode(q, kv, kv, slab.k, slab.v, vt, ap,
                                       partials=True)
        res['merge_ms'] = _sp_wall_ms(
            torch, ddp, lambda: dec._flash_merge(parts, None, bf16), reps=9)

        # The local twin on rank 0: the unsharded decode (K5 without
        # partials) over the whole cache, the same tokens.
        if rank == 0:
            twin, twin_ms = [], []
            for t in range(DS_STEPS):
                x = xs[:, t:t + 1]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                local, out = mod.decode(x, x, x, local)
                torch.cuda.synchronize()
                twin_ms.append(1e3 * (time.perf_counter() - t0))
                twin.append(out)
            errs = [rel_errs(torch, a, b) for a, b in zip(outs, twin)]
            res['vs_local'] = {
                'max_row_rel_err': max(e[0] for e in errs),
                'max_rel_err': max(e[1] for e in errs),
                'max_abs_err': max((a.float() - b.float()).abs().max().item()
                                   for a, b in zip(outs, twin)),
                'finite': all(torch.isfinite(a).all().item() for a in outs)}
            res['twin_ms'] = twin_ms
        gk = comm.all_gather(slab.k, mesh.seq_group)
        gv = comm.all_gather(slab.v, mesh.seq_group)
        if rank == 0:
            res['cache_bit_identical'] = bool(torch.equal(gk, local.k)
                                              and torch.equal(gv, local.v))
            del local
        del gk, gv, slab, outs
        torch.cuda.empty_cache()

        res['paged'] = _ds_paged(torch, ddp, dec, comm, mesh, rank, dev)

        # The recipe's own check (dryrun_multichip): 3 steps on the 2 x 2
        # data x seq group, t_cap 8, B 4, sharded against local — float32
        # through the plain path at the recipe's widths (key_dim 64, head
        # dim 16), and bf16 through the kernel at head dim 32 (the
        # smallest the kernel takes).
        dmesh = ddp.data_seq_mesh(2, world // 2)
        res['recipe'] = {}
        for name, dtype, impl, kd in (('float32_plain', torch.float32,
                                       'plain', 64),
                                      ('bf16_kernel', bf16, 'kernel', 128)):
            m = _ds_module(torch, ddp, dev, dtype, impl, key_dim=kd, heads=4)
            g = torch.Generator().manual_seed(7)
            xd = randn(torch, (4, 3, kd), g, dev, torch.float32)
            sc = ddp.shard_decode_cache(m.make_decode_cache(4, 8), dmesh)
            lc = m.make_decode_cache(4, 8)
            errs = []
            for t in range(3):
                xt = xd[:, t:t + 1]
                sc, s_out = ddp.decode_seq_parallel(m, dmesh, xt, xt, xt, sc)
                lc, l_out = m.decode(xt, xt, xt, lc)
                errs.append(((s_out.float() - l_out.float()).abs().max()
                             .item(), *rel_errs(torch, s_out, l_out)))
            res['recipe'][name] = errs
    return res


def _ds_paged(torch, ddp, dec, comm, mesh, rank, dev):
    """decode_sharded's paged case on one rank: its local view of a
    sequence-sharded page table over the same global cache (DS_T columns,
    page 16: 2048 ordinals, 512 a rank; DS_B slots at DS_PROMPT rows, the
    same seeded rows on every rank, each keeping those it owns), then
    DS_STEPS ``decode_step(group=...)`` steps (one K5p partials launch a
    rank, the merge over the group); rank 0 then runs the single-pool
    twins, K5p and the plain version, on the same rows and steps."""
    import numpy as np
    bf16 = torch.bfloat16
    b, h, h_kv, d, ps = DS_B, SP_HEADS, SP_HEADS // 2, SP_HEAD_DIM, SERVE_PAGE
    world, pps = comm.get_world_size(), DS_T // ps
    per = b * (DS_LOCAL // ps)            # every slot's whole range
    spt = dec.ShardedPageTable(world, per, ps, b, pps)
    local = dec.init_paged_cache(b, h_kv, DS_T, d, pages=per, page_size=ps,
                                 dtype=bf16, device=dev)._replace(
                                     length=spt.lengths)
    g = torch.Generator().manual_seed(23)      # the same on every rank
    k = randn(torch, (b, h_kv, DS_PROMPT, d), g, dev, bf16)
    v = randn(torch, (b, h_kv, DS_PROMPT, d), g, dev, bf16)
    xs = [[randn(torch, (b, hh, 1, d), g, dev, bf16) for hh in (h, h_kv,
                                                                h_kv)]
          for _ in range(DS_STEPS)]
    for i in range(b):
        check(spt.reserve_rows(i, DS_PROMPT)[0], 'paged: reserve failed')
    local.page_table.copy_(torch.from_numpy(spt.shards[rank].table))
    dec.paged_append_kv_slots(local, k, v)
    spt.lengths[:] = DS_PROMPT
    # A mesh over the whole world names its seq group None (the default
    # group); decode_step's group=None is the local step.
    group = comm.world_group() if mesh.seq_group is None else mesh.seq_group
    outs, ms = [], []
    ddp.flash_decode_paged.launches = 0
    for q, kn, vn in xs:
        for i in range(b):
            check(spt.prepare_append(i)[0] in ('ok', 'alloc'),
                  'paged: prepare_append failed')
        local.page_table.copy_(torch.from_numpy(spt.shards[rank].table))
        torch.cuda.synchronize()
        ddp.synchronize()
        t0 = time.perf_counter()
        _, out = dec.decode_step(q, local, kn, vn, group=group,
                                 impl='kernel')
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        outs.append(out)
        spt.lengths += 1
    res = {'step_ms': ms, 'launches': ddp.flash_decode_paged.launches,
           'length': spt.lengths.tolist(),
           'owned_pages': spt.shards[rank].used_pages}
    if rank == 0:
        # The single-pool twins: K5p, and the plain version.
        for impl, key in (('kernel', 'vs_single_pool'),
                          ('plain', 'vs_plain_single_pool')):
            pool = dec.PagePool(world * per, ps, b, pps)
            single = dec.init_paged_cache(b, h_kv, DS_T, d,
                                          pages=world * per, page_size=ps,
                                          dtype=bf16, device=dev)
            for i in range(b):
                check(pool.reserve_rows(i, DS_PROMPT)[0],
                      'twin: reserve failed')
            single.page_table.copy_(torch.from_numpy(pool.table))
            single = dec.paged_append_kv_slots(single, k, v)
            pool.lengths[:] = DS_PROMPT
            twin = []
            for q, kn, vn in xs:
                for i in range(b):
                    check(pool.prepare_append(i)[0] in ('ok', 'alloc'),
                          'twin: prepare_append failed')
                single.page_table.copy_(torch.from_numpy(pool.table))
                single, out = dec.decode_step(q, single, kn, vn, impl=impl)
                twin.append(out)
                pool.lengths += 1
            errs = [rel_errs(torch, a, b_) for a, b_ in zip(outs, twin)]
            res[key] = {
                'max_row_rel_err': max(e[0] for e in errs),
                'max_rel_err': max(e[1] for e in errs),
                'finite': all(torch.isfinite(a).all().item() for a in outs)}
            del single, twin
    del local, k, v
    torch.cuda.empty_cache()
    return res


def phase_decode_sharded(torch, ddp, timeout=600):
    """The recipe's sequence-sharded decode at full width on 4 ranks (on one
    card over gloo, host-staged, as seq_parallel; NCCL with a card per
    rank): prefill, then DS_STEPS steps of decode_seq_parallel against the
    local twin on rank 0, one K5 launch per rank per step, the owner rank
    per step; and the recipe's own 3-step check on the 2 x 2 group."""
    ranks, seconds, backend = _spawn_ranks(torch, 'decode_sharded', '_ds_run',
                                           timeout)
    ranks = dict(sorted(ranks.items()))
    r0 = ranks[0]
    label = (SP_LABEL if backend == 'gloo'
             else f'{SP_RANKS} ranks on {SP_RANKS} cards, nccl')
    base = {'phase': 'decode_sharded', 'ranks': SP_RANKS, 'label': label,
            'transport': r0['transport']}
    failures = []
    owners = [[r for r in sorted(ranks) if ranks[r]['owned'][t]]
              for t in range(DS_STEPS)]
    want_owners = [[2]] * (DS_STEPS // 2) + [[3]] * (DS_STEPS // 2)
    step_ms = statistics.median(max(ranks[r]['step_ms'][t] for r in ranks)
                                for t in range(DS_STEPS))
    vs = r0['vs_local']
    emit({**base, 'case': 'steps', 'module': {
        'key_dim': SP_DIM, 'num_heads': SP_HEADS,
        'num_kv_heads': SP_HEADS // 2,
        'causal': True, 'use_rope': True, 'compute': 'bfloat16'},
        'batch': DS_B, 't_max_global': DS_T, 'slab': DS_LOCAL,
        'prompt': DS_PROMPT, 'steps': DS_STEPS,
        'prefill_ms': {r: ranks[r]['prefill_ms'] for r in ranks},
        'prefill_k1_launches': {r: ranks[r]['prefill_k1_launches']
                                for r in ranks},
        'ms_per_step_median': step_ms,
        'twin_ms_per_step_median': statistics.median(r0['twin_ms']),
        'merge_ms': {r: ranks[r]['merge_ms'] for r in ranks},
        'launches': {r: ranks[r]['launches'] for r in ranks},
        'k5_launches_per_step': {r: sorted(set(ranks[r]['launches_per_step']))
                                 for r in ranks},
        'owner_per_step': [o[0] if len(o) == 1 else o for o in owners],
        'vs_local': vs, 'tol': {'row_rel': SP_TOL_BF16_ROW,
                                'rel': SP_TOL_BF16},
        'cache_bit_identical': r0['cache_bit_identical']})
    if owners != want_owners:
        failures.append(f'owners per step {owners}')
    for r in ranks:
        if ranks[r]['launches_per_step'] != [1] * DS_STEPS:
            failures.append(f'rank {r}: K5 launches per step '
                            f'{ranks[r]["launches_per_step"]}')
        got = ranks[r]['launches']
        if got != {'flash_attention': 0, 'flash_decode': DS_STEPS,
                   'flash_decode_paged': 0}:
            failures.append(f'rank {r}: launches {got}')
        if ranks[r]['length'] != DS_PROMPT + DS_STEPS:
            failures.append(f'rank {r}: length {ranks[r]["length"]}')
    if not vs['finite']:
        failures.append('non-finite sharded output')
    if not (vs['max_row_rel_err'] <= SP_TOL_BF16_ROW
            and vs['max_rel_err'] <= SP_TOL_BF16):
        failures.append(f'sharded vs local: row {vs["max_row_rel_err"]}, '
                        f'whole {vs["max_rel_err"]}')
    if not r0['cache_bit_identical']:
        failures.append('gathered slabs differ from the local cache')
    for name, tol in (('float32_plain', (1e-4, None)),
                      ('bf16_kernel', (None, (SP_TOL_BF16_ROW,
                                              SP_TOL_BF16)))):
        errs = {r: ranks[r]['recipe'][name] for r in ranks}
        emit({**base, 'case': 'recipe', 'config': name, 'mesh': {
            'data': 2, 'seq': 2}, 'batch': 4, 't_cap': 8, 'steps': 3,
            'errs_abs_row_whole': errs,
            'tol': ({'abs': tol[0]} if tol[0] else
                    {'row_rel': tol[1][0], 'rel': tol[1][1]})})
        for r, steps in errs.items():
            for t, (ab, row, whole) in enumerate(steps):
                ok = (ab <= tol[0] if tol[0] else
                      row <= tol[1][0] and whole <= tol[1][1])
                if not ok:
                    failures.append(f'recipe {name} rank {r} step {t}: '
                                    f'abs {ab}, row {row}, whole {whole}')
    # The paged case: decode_step(group=...) on each rank's view of the
    # sequence-sharded page table, against rank 0's single-pool K5p.
    pg = {r: ranks[r]['paged'] for r in ranks}
    paged_ms = statistics.median(max(pg[r]['step_ms'][t] for r in pg)
                                 for t in range(DS_STEPS))
    pv, pp = pg[0]['vs_single_pool'], pg[0]['vs_plain_single_pool']
    emit({**base, 'case': 'paged', 'batch': DS_B, 't_max_global': DS_T,
          'page_size': SERVE_PAGE, 'ordinals_per_rank': DS_LOCAL // SERVE_PAGE,
          'prompt': DS_PROMPT, 'steps': DS_STEPS,
          'ms_per_step_median': paged_ms, 'slab_ms_per_step_median': step_ms,
          'k5p_launches': {r: pg[r]['launches'] for r in pg},
          'owned_pages': {r: pg[r]['owned_pages'] for r in pg},
          'vs_single_pool': pv, 'vs_plain_single_pool': pp,
          'tol': {'row_rel': TOL_ROW_REL, 'rel': TOL_NORM_REL}})
    for r in pg:
        if pg[r]['launches'] != DS_STEPS:
            failures.append(f'paged rank {r}: K5p launches '
                            f'{pg[r]["launches"]}')
        if pg[r]['length'] != [DS_PROMPT + DS_STEPS] * DS_B:
            failures.append(f'paged rank {r}: lengths {pg[r]["length"]}')
    for what, e in (('K5p', pv), ('plain', pp)):
        if not (e['finite'] and e['max_row_rel_err'] <= TOL_ROW_REL
                and e['max_rel_err'] <= TOL_NORM_REL):
            failures.append(f'paged sharded vs single-pool {what}: {e}')
    emit({**base, 'case': 'summary', 'seconds': seconds, 'backend': backend})
    check(not failures, '; '.join(failures))
    return {'launches_per_rank': {r: ranks[r]['launches']['flash_decode']
                                  for r in ranks},
            'paged_launches_per_rank': {r: pg[r]['launches'] for r in pg},
            'ms_per_step': step_ms, 'paged_ms_per_step': paged_ms,
            'merge_ms': statistics.median(ranks[r]['merge_ms']
                                          for r in ranks)}


# The flagship recipe's stages beyond the strategies (dryrun_multichip's
# window, gqa_ring, stack and lm) at full width on the 2 x 2 group, global
# B 4 x T 8192, 3 steps each, Adam 1e-3 (the stack at the README's 3e-4:
# at width 768 Adam's first 1e-3 step overshoots — its loss rose 1.91 ->
# 3.67 -> 2.38 on the card, and the same on the CPU in float32), MSE
# against zeros for the module stages; then greedy generation from the
# trained LM on rank 0.
FS_STEPS, FS_WINDOW, FS_RATE = 3, 2048, 0.1
FS_LR = {'window': 1e-3, 'gqa_ring': 1e-3, 'stack': LR, 'lm': 1e-3}
FS_GEN_PROMPT, FS_GEN_STEPS, FS_GEN_T_MAX = 4, 3, 128
FS_STAGES = ('window', 'gqa_ring', 'stack', 'lm')
FS_KERNELS = ('flash_attention', 'flash_attention_dq', 'flash_attention_dkv')


def fs_expected(stage, seq_rank):
    """Launches per train step of (K1, K3, K4) on a rank: the flash
    stages one per attention layer (the LM's remat recomputes each
    forward once more); the causal ring folds seq rank + 1 blocks — the
    wholly cross-segment fold of rank 1 included: it is skipped inside
    the kernel, not on the host."""
    if stage == 'gqa_ring':
        return (seq_rank + 1,) * 3
    if stage == 'stack':
        return (2, 2, 2)
    if stage == 'lm':
        return (2 * LAYERS, LAYERS, LAYERS)
    return (1, 1, 1)


def _fs_segments(torch, b, t, dev):
    """The recipe's packed layout: two documents a row, positions
    ``arange(T)·2 // T``."""
    return (torch.arange(t, device=dev) * 2 // t).to(torch.int32).expand(
        b, t).contiguous()


def _fs_module(torch, ddp, stage, dev, **over):
    gen = torch.Generator().manual_seed(5)
    bf16 = torch.bfloat16
    if stage == 'stack':
        return ddp.TransformerStack(
            DIM, HEADS, n_layers=2, dtype=bf16, device=dev, generator=gen,
            attn_kwargs=dict(causal=True, softmax_impl='flash',
                             use_rope=True))
    if stage == 'lm':
        return ddp.TransformerLM(VOCAB, DIM, HEADS, n_layers=LAYERS,
                                 dtype=bf16, remat=True, device=dev,
                                 generator=gen)
    kw = dict(key_dim=SP_DIM, num_heads=SP_HEADS, causal=True, dtype=bf16,
              device=dev, generator=gen)
    if stage == 'window':
        kw.update(softmax_impl='flash', window=FS_WINDOW)
    else:
        kw.update(num_kv_heads=SP_HEADS // 2, use_rope=True,
                  softmax_impl='online', qk_quant='int8',
                  dropout_rate=FS_RATE)
    kw.update(over)
    return ddp.DistributedDotProductAttn(**kw)


def _flagship_run(torch, ddp, rank, dev):
    """One rank's part of the flagship phase; returns its numbers."""
    import importlib
    comm = importlib.import_module(
        'distributed_dot_product_tpu_torch.utils.comm')
    train = importlib.import_module('distributed_dot_product_tpu_torch.train')
    res = {'rank': rank, 'transport': comm.transport(None, dev)}
    world = comm.get_world_size()

    # window and gqa_ring at W = 4 against the local module, with the
    # segments and the dropout of the stage (the same global-coordinate
    # mask on both sides).
    mesh4 = ddp.seq_mesh(world)
    gen = torch.Generator().manual_seed(7)      # the same on every rank
    xs = [randn(torch, (SP_CHECK_B, SP_CHECK_T, SP_DIM), gen, dev,
                torch.float32) for _ in range(4)]
    seg = _fs_segments(torch, SP_CHECK_B, SP_CHECK_T, dev)
    res['vs_local'] = {}
    for stage in ('window', 'gqa_ring'):
        mod = _fs_module(torch, ddp, stage, dev)
        local = _fs_module(torch, ddp, stage, dev, distributed=False)
        shards = [ddp.shard_seq(t, mesh4).clone().requires_grad_()
                  for t in xs[:3]]
        kw = dict(dropout_seed=3)
        sseg = ddp.shard_seq(seg, mesh4, seq_axis=-1)
        out = mod(*shards, None, sseg if stage == 'gqa_ring' else None,
                  group=None, **kw)
        (out.float() * ddp.shard_seq(xs[3], mesh4)).sum().backward()
        got = {'out': ddp.unshard_seq(out, mesh4)}
        for n, t in zip(('d_keys', 'd_queries', 'd_values'), shards):
            got[n] = ddp.unshard_seq(t.grad, mesh4)
        pgrads = {n: comm.all_reduce(p.grad) for n, p in
                  mod.named_parameters()}
        if rank == 0:
            gx = [t.clone().requires_grad_() for t in xs[:3]]
            ref = local(*gx, None, seg if stage == 'gqa_ring' else None, **kw)
            (ref.float() * xs[3]).sum().backward()
            want = {'out': ref, 'd_keys': gx[0].grad,
                    'd_queries': gx[1].grad, 'd_values': gx[2].grad}
            errs = {n: rel_errs(torch, got[n], want[n]) for n in want}
            for n, p in local.named_parameters():
                whole = (torch.linalg.vector_norm(pgrads[n].float()
                                                  - p.grad.float())
                         / torch.linalg.vector_norm(p.grad.float())).item()
                errs[n] = (whole, whole)
            res['vs_local'][stage] = errs
        del mod, local, out, shards, got, pgrads
        torch.cuda.empty_cache()
    del xs

    # The stages' DP x SP train steps on the 2 x 2 group.
    mesh = ddp.data_seq_mesh(SP_DATA, SP_SEQ)
    res['seq_rank'], res['data_rank'] = mesh.seq_rank, mesh.data_rank
    gen = torch.Generator().manual_seed(3)
    seg = _fs_segments(torch, SP_B, SP_T, dev)
    counters = [getattr(ddp, n) for n in FS_KERNELS]
    res['train'] = {}
    for stage in FS_STAGES:
        model = _fs_module(torch, ddp, stage, dev)
        opt = torch.optim.Adam(model.parameters(), lr=FS_LR[stage])
        if stage == 'lm':
            tokens = torch.randint(0, VOCAB, (SP_B, SP_T),
                                   generator=gen).to(dev)
            batch = (tokens, ddp.lm_targets(tokens, seg), seg)
            step = ddp.make_lm_train_step(model, opt, mesh, data_axis='data',
                                          loss_chunk=LOSS_CHUNK)
        else:
            width = DIM if stage == 'stack' else SP_DIM
            x = randn(torch, (SP_B, SP_T, width), gen, dev, torch.float32)
            batch = (x, x, x, None, torch.zeros_like(x))
            if stage == 'gqa_ring':
                batch += (seg,)
            step = ddp.make_train_step(model, opt, mesh, data_axis='data')
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        losses, ms, per_step = [], [], []
        for i in range(FS_STEPS):
            for fn in counters:
                fn.launches = 0
            torch.cuda.synchronize()
            ddp.synchronize()
            t0 = time.perf_counter()
            loss = step(batch, dropout_seed=i).item()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
            per_step.append([fn.launches for fn in counters])
            losses.append(loss)
            if stage == 'lm' and i == 1:
                ckpt = _fs_checkpoint_save(torch, ddp, model, opt)
        # The step's host-staged gradient all-reduce over both groups,
        # timed alone on the last step's gradients.
        params = [p for p in model.parameters() if p.grad is not None]
        torch.cuda.synchronize()
        ddp.synchronize()
        t0 = time.perf_counter()
        train._sum_grads(params, [mesh.seq_group, mesh.data_group])
        torch.cuda.synchronize()
        reduce_ms = 1e3 * (time.perf_counter() - t0)
        run = {'losses': losses, 'step_ms': ms, 'launches_per_step': per_step,
               'expected_per_step': list(fs_expected(stage, mesh.seq_rank)),
               'grad_reduce_ms': reduce_ms,
               'max_memory_allocated': torch.cuda.max_memory_allocated(dev),
               'params': sum(p.numel() for p in model.parameters())}
        if stage == 'lm' and rank == 0:
            ddp.flash_attention.launches = ddp.flash_decode.launches = 0
            prompt = batch[0][:, :FS_GEN_PROMPT]
            t0 = time.perf_counter()
            out = ddp.greedy_generate(model, prompt, FS_GEN_STEPS,
                                      FS_GEN_T_MAX)
            torch.cuda.synchronize()
            run['generate'] = {
                'shape': list(out.shape), 'tokens': out.tolist(),
                'in_vocab': bool(((out >= 0) & (out < VOCAB)).all().item()),
                'ms': 1e3 * (time.perf_counter() - t0),
                'launches': {'flash_attention': ddp.flash_attention.launches,
                             'flash_decode': ddp.flash_decode.launches}}
        del model, opt, step
        torch.cuda.empty_cache()
        if stage == 'lm':
            run['checkpoint'] = {**ckpt, **_fs_checkpoint_resume(
                torch, ddp, mesh, batch, losses[2], dev)}
        res['train'][stage] = run
        del batch
        torch.cuda.empty_cache()
    return res


# The checkpoint case of the flagship phase: the LM's state after step 2,
# saved by rank 0 under the checkout's build/ directory (every rank
# barriers), blocking and async; then a fresh LM and Adam restored from it
# take step 3 again.
FS_CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           'build', 'smoke_checkpoints')


def _fs_checkpoint_save(torch, ddp, model, opt):
    import shutil
    if ddp.get_rank() == 0:
        shutil.rmtree(FS_CKPT_DIR, ignore_errors=True)
    ddp.synchronize()
    state = ddp.TrainState(2, model.state_dict(), opt.state_dict())
    out = {}
    for mode in ('blocking', 'async'):
        torch.cuda.synchronize()
        ddp.synchronize()
        t0 = time.perf_counter()
        ddp.save(os.path.join(FS_CKPT_DIR, mode), state,
                 blocking=mode == 'blocking')
        out[f'save_{mode}_ms'] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    ddp.wait(os.path.join(FS_CKPT_DIR, 'async'))
    out['async_wait_ms'] = 1e3 * (time.perf_counter() - t0)
    out['bytes'] = os.path.getsize(os.path.join(
        FS_CKPT_DIR, 'blocking', 'step_000000002', 'state.pt'))
    return out


def _fs_checkpoint_resume(torch, ddp, mesh, batch, want, dev):
    import shutil
    model = ddp.TransformerLM(VOCAB, DIM, HEADS, n_layers=LAYERS,
                              dtype=torch.bfloat16, remat=True, device=dev,
                              generator=torch.Generator().manual_seed(99))
    opt = torch.optim.Adam(model.parameters(), lr=FS_LR['lm'])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = ddp.restore(os.path.join(FS_CKPT_DIR, 'blocking'),
                           ddp.TrainState(0, model.state_dict(),
                                          opt.state_dict()))
    model.load_state_dict(restored.params)
    opt.load_state_dict(restored.opt_state)
    torch.cuda.synchronize()
    restore_ms = 1e3 * (time.perf_counter() - t0)
    step = ddp.make_lm_train_step(model, opt, mesh, data_axis='data',
                                  loss_chunk=LOSS_CHUNK)
    loss = step(batch, dropout_seed=2).item()
    restored_step = restored.step
    del model, opt, step, restored
    ddp.synchronize()
    if ddp.get_rank() == 0:
        shutil.rmtree(FS_CKPT_DIR, ignore_errors=True)
    return {'restore_ms': restore_ms, 'restored_step': restored_step,
            'step3_loss': want, 'resumed_step3_loss': loss,
            'bitwise_equal': loss == want,
            'rel_diff': abs(loss - want) / max(abs(want), 1e-30)}


def phase_flagship(torch, ddp, timeout=900):
    """dryrun_multichip's window, gqa_ring, stack and lm stages on a 2 x 2
    data x seq group of 4 ranks (on one card over gloo, host-staged, as
    seq_parallel), at full width: ms per step, losses (finite, equal on
    every rank, falling for the module stages), launches per step against
    the fold counts, peak memory; window and gqa_ring at W = 4 against
    the local module; greedy generation from the trained LM."""
    ranks, seconds, backend = _spawn_ranks(torch, 'flagship',
                                           '_flagship_run', timeout)
    r0 = ranks[0]
    label = (SP_LABEL if backend == 'gloo'
             else f'{SP_RANKS} ranks on {SP_RANKS} cards, nccl')
    base = {'phase': 'flagship', 'ranks': SP_RANKS, 'label': label,
            'transport': r0['transport']}
    failures = []
    for stage, errs in r0['vs_local'].items():
        emit({**base, 'case': 'vs_local', 'stage': stage,
              'batch': [SP_CHECK_B, SP_CHECK_T],
              'max_row_rel_err': {n: e[0] for n, e in errs.items()},
              'rel_err': {n: e[1] for n, e in errs.items()},
              'tol': {'row_rel': SP_TOL_BF16_ROW, 'rel': SP_TOL_BF16}})
        for n, (row, whole) in errs.items():
            if not (row <= SP_TOL_BF16_ROW and whole <= SP_TOL_BF16):
                failures.append(f'{stage} vs local {n}: row {row}, whole '
                                f'{whole} > ({SP_TOL_BF16_ROW}, '
                                f'{SP_TOL_BF16})')
    launches = {}
    for stage in FS_STAGES:
        runs = {r: ranks[r]['train'][stage] for r in sorted(ranks)}
        t0r = runs[0]
        emit({**base, 'case': 'train', 'stage': stage,
              'mesh': {'data': SP_DATA, 'seq': SP_SEQ},
              'batch': [SP_B, SP_T], 'params': t0r['params'],
              'optimizer': f'adam {FS_LR[stage]}', 'losses': t0r['losses'],
              'step_ms_rank0': t0r['step_ms'],
              'ms_per_step_median': statistics.median(
                  max(runs[r]['step_ms'][i] for r in runs)
                  for i in range(FS_STEPS)),
              'grad_reduce_ms': {r: runs[r]['grad_reduce_ms'] for r in runs},
              'kernels': list(FS_KERNELS),
              'launches_per_step': {r: runs[r]['launches_per_step']
                                    for r in runs},
              'expected_per_step': {r: runs[r]['expected_per_step']
                                    for r in runs},
              'max_memory_allocated': {r: runs[r]['max_memory_allocated']
                                       for r in runs}})
        for r, run in runs.items():
            if not all(math.isfinite(v) for v in run['losses']):
                failures.append(f'{stage} rank {r}: non-finite loss')
            for i, got in enumerate(run['launches_per_step']):
                if got != run['expected_per_step']:
                    failures.append(f'{stage} rank {r} step {i + 1}: '
                                    f'launched {got}, want '
                                    f'{run["expected_per_step"]}')
        if len({tuple(runs[r]['losses']) for r in runs}) != 1:
            failures.append(f'{stage}: ranks report different losses')
        if stage != 'lm' and not t0r['losses'][-1] < t0r['losses'][0]:
            failures.append(f'{stage}: loss did not fall '
                            f'({t0r["losses"]})')
        launches[stage] = {n: sum(s[i] for s in t0r['launches_per_step'])
                           for i, n in enumerate(FS_KERNELS)}
    cks = {r: ranks[r]['train']['lm']['checkpoint'] for r in sorted(ranks)}
    emit({**base, 'case': 'checkpoint', 'stage': 'lm',
          'saved_after_step': 2, 'by_rank': cks,
          'tol': 'bit for bit (1e-6 relative if a kernel is not '
                 'deterministic)'})
    for r, ck in cks.items():
        if ck['restored_step'] != 2:
            failures.append(f'checkpoint rank {r}: restored step '
                            f'{ck["restored_step"]}')
        if not (ck['bitwise_equal'] or ck['rel_diff'] <= 1e-6):
            failures.append(f'checkpoint rank {r}: resumed step 3 loss '
                            f'{ck["resumed_step3_loss"]} vs '
                            f'{ck["step3_loss"]}')
    gen = r0['train']['lm']['generate']
    emit({**base, 'case': 'greedy_generate', 'prompt': FS_GEN_PROMPT,
          'steps': FS_GEN_STEPS, 't_max': FS_GEN_T_MAX, **gen})
    if gen['shape'] != [SP_B, FS_GEN_STEPS] or not gen['in_vocab']:
        failures.append(f'greedy_generate returned {gen["shape"]} '
                        f'(in vocab: {gen["in_vocab"]})')
    emit({**base, 'case': 'summary', 'seconds': seconds, 'backend': backend})
    check(not failures, '; '.join(failures))
    return launches


# int8 weights, the untied head and partial remat; seeded multi-tenant
# load under the scheduling policy, read out as SLO goodput.
#
# wq8_serve: the serve_path burst over KernelEngine(weight_quant='int8'),
# paged and slab, bf16, at the serving widths. WQ8_RTOL is the reference's
# documented int8 class (tests/test_weight_quant.py): each operand of the
# s8 product rounds by half a step of its row's / channel's scale (~0.4% of
# the max), so logits stay within a few percent of the float twin's scale.
WQ8_RTOL = 0.05
# The head's product at the decode shape (8 slots) and one padded row.
WQ8_ROWS = (SERVE_SLOTS, 1)


def _wq8_bytes(n_matrices_dim, out_widths):
    """``(int8 bytes, float32 scale bytes, bf16 bytes)`` of weight matrices
    with ``n_matrices_dim`` (rows, cols) shapes."""
    n = sum(r * c for r, c in n_matrices_dim)
    return n, 4 * sum(out_widths), 2 * n


def _int_mm_exact(torch, ddp_dense, gen, rows, w_q, w_s):
    """One ``quantized_dot`` at ``rows`` rows of the head on the card
    against its plain version on the CPU (bit for bit), and the card's
    s8 product against the float64 product of the same int8 values (exact
    at these widths)."""
    x = randn(torch, (rows, w_q.shape[1]), gen, 'cuda', torch.bfloat16)
    got = ddp_dense.quantized_dot(x, w_q, w_s)
    want = ddp_dense.quantized_dot(x.cpu(), w_q.cpu(), w_s.cpu())
    x32 = x.float()
    sx = torch.clamp_min(x32.abs().amax(-1, keepdim=True) / 127.0,
                         ddp_dense._EPS)
    xi = torch.round(x32 / sx).to(torch.int8)
    prod = ddp_dense._int_product(xi, w_q)
    exact = (xi.double() @ w_q.double().t())
    return {'rows': rows, 'bit_for_bit_plain': bool(torch.equal(got.cpu(),
                                                                want)),
            'int_mm_exact': bool(torch.equal(prod.double(), exact)),
            'max_abs_err': (got.cpu() - want).abs().max().item()}


def phase_wq8_serve(torch, ddp, flush):
    """The serve_path burst over the int8-weight engine, paged then slab
    (then paged again), beside the float engine's numbers of this call;
    weight bytes; first-step logits against the float engine; the head's
    quantized_dot on the card against its plain version."""
    from distributed_dot_product_tpu_torch.models import dense as ddp_dense
    import torch.nn.functional as F
    t_phase = time.perf_counter()
    burst = serve_burst()
    runs = {}
    for name, mode in (('paged', 'paged'), ('slab', 'slab'),
                       ('paged_again', 'paged')):
        engine = serve_engine(torch, mode, weight_quant='int8')
        results, row = _serve_burst(torch, ddp, engine, burst,
                                    f'wq8 {name}')
        own, other = (('flash_decode_paged', 'flash_decode')
                      if mode == 'paged' else
                      ('flash_decode', 'flash_decode_paged'))
        launches, steps = row['launches'], row['decode_steps']
        row = {'phase': 'wq8_serve', 'case': name, 'weight_quant': 'int8',
               'float_same_call': SAME_CALL.get(f'serve_path_{mode}'),
               **row}
        emit(row)
        check(launches[own] == steps,
              f'wq8 {name}: {own} launched {launches[own]} times for '
              f'{steps} decode steps')
        check(launches[other] == 0,
              f'wq8 {name}: {other} launched {launches[other]} times')
        runs[name] = (results, row)
        if name == 'paged':
            kept = engine
        else:
            del engine
    streams = {n: {rid: (r.status, r.tokens) for rid, r in res.items()}
               for n, (res, _) in runs.items()}
    completed = [rid for rid, (st, _) in streams['paged'].items()
                 if st == 'completed']
    diverged = [rid for rid in streams['paged']
                if streams['paged'][rid] != streams['slab'].get(rid)]
    emit({'phase': 'wq8_serve', 'case': 'streams',
          'completed': len(completed), 'slab_vs_paged_diverged': diverged,
          'paged_twice_identical':
              streams['paged'] == streams['paged_again']})
    check(len(completed) == len(burst), 'wq8: not every request completed')
    check(not diverged, f'wq8: slab and paged streams differ: {diverged}')
    check(streams['paged'] == streams['paged_again'],
          'wq8: the same run twice gave other streams')

    # Weight bytes: the four matrices int8 with float32 scales, against
    # the bf16 twin's.
    q8, scales, bf16 = _wq8_bytes(((DIM, DIM),) * 3 + ((VOCAB, DIM),),
                                  (DIM,) * 3 + (VOCAB,))
    flt = serve_engine(torch, 'slab', slots=SERVE_SLOTS)
    row = {'phase': 'wq8_serve', 'case': 'weight_bytes',
           'int8': kept.weight_bytes, 'want_int8': q8 + scales,
           'bf16': flt.weight_bytes, 'want_bf16': bf16}
    emit(row)
    check(kept.weight_bytes == q8 + scales,
          f'int8 weight bytes {kept.weight_bytes} != {q8 + scales}')
    check(flt.weight_bytes == bf16,
          f'bf16 weight bytes {flt.weight_bytes} != {bf16}')

    # Teacher-forced first step: the burst's first prompts prefilled into
    # both engines, the logits each step argmaxes held against each other.
    q_eng = serve_engine(torch, 'slab', weight_quant='int8')
    prompts = [p for _, p in burst[:SERVE_SLOTS]]
    got = first_step_logits(torch, q_eng, prompts)
    want = first_step_logits(torch, flt, prompts)
    rel = [((g - w).abs().max() / w.abs().max()).item()
           for g, w in zip(got, want)]
    emit({'phase': 'wq8_serve', 'case': 'first_step_logits',
          'max_rel_err': rel, 'tol': WQ8_RTOL,
          'argmax_equal': int((got.argmax(-1) == want.argmax(-1)).sum())})
    for r in rel:
        check(r <= WQ8_RTOL, f'wq8 logits rel err {r} > {WQ8_RTOL}')

    # The head's product: on the card bit for bit its plain version; its
    # time beside bf16 F.linear's at the same shape, and the bound (the
    # int8 weight, its scales, x and the float32 output once each).
    gen = torch.Generator().manual_seed(15)
    w_q, w_s = kept._wo
    cases = [_int_mm_exact(torch, ddp_dense, gen, r, w_q, w_s)
             for r in WQ8_ROWS]
    for c in cases:
        emit({'phase': 'wq8_serve', 'case': 'quantized_dot_exact', **c})
        check(c['bit_for_bit_plain'] and c['int_mm_exact'],
              f"quantized_dot at {c['rows']} rows differs from its plain "
              f"version")
    x = randn(torch, (SERVE_SLOTS, DIM), gen, 'cuda', torch.bfloat16)
    w_bf16 = flt._wo.t().contiguous()                 # (vocab, dim)
    x_bf16 = x.to(w_bf16.dtype)
    ms = time_ms(torch, lambda: ddp_dense.quantized_dot(x, w_q, w_s), flush)
    linear_ms = time_ms(torch, lambda: F.linear(x_bf16, w_bf16), flush)
    nbytes = (w_q.numel() + 4 * w_s.numel() + 2 * x.numel()
              + 4 * SERVE_SLOTS * VOCAB)
    b_ms, b_by = bound_ms(2 * SERVE_SLOTS * DIM * VOCAB, nbytes)
    row = {'phase': 'wq8_serve', 'case': 'head_product',
           'shape': [SERVE_SLOTS, DIM, VOCAB], 'quantized_dot_ms': ms,
           'bf16_linear_ms': linear_ms, 'bound_ms': b_ms, 'bound_by': b_by,
           'seconds': time.perf_counter() - t_phase}
    emit(row)
    del kept, flt, q_eng
    torch.cuda.empty_cache()
    return {'launches': {n: r['launches'] for n, (_, r) in runs.items()},
            'head_product': row}


def phase_wq8_lm(torch, ddp):
    """main_path's 16-layer LM with its float (bf16) parameters quantized
    by quantize_dense_params: prefill logits against the float LM, greedy
    generation twice, launch counts, weight bytes; ms beside the float
    LM's in this phase."""
    from distributed_dot_product_tpu_torch.models.lm import greedy_generate
    t_phase = time.perf_counter()
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(0)
    kw = dict(n_layers=LAYERS, dtype=torch.bfloat16,
              param_dtype=torch.bfloat16, device=dev)
    flt = ddp.TransformerLM(VOCAB, DIM, HEADS, generator=gen, **kw)
    prompts = torch.randint(0, VOCAB, (BATCH, PROMPT), generator=gen
                            ).to(dev)
    q8 = ddp.TransformerLM(VOCAB, DIM, HEADS, weight_quant='int8', **kw)
    q8.load_state_dict(ddp.quantize_dense_params(flt))
    state = q8.state_dict()
    int8_bytes = sum(v.numel() for k, v in state.items()
                     if k.endswith('weight_q'))
    scale_bytes = sum(4 * v.numel() for k, v in state.items()
                      if k.endswith('weight_scale'))
    bf16_bytes = sum(v.numel() * v.element_size()
                     for k, v in flt.state_dict().items()
                     if k.endswith('.weight'))
    want8, _, want16 = _wq8_bytes(
        ((DIM, DIM),) * 4 + ((4 * DIM, DIM), (DIM, 4 * DIM)) * 1, ())
    want8, want16 = LAYERS * want8, LAYERS * want16

    with torch.inference_mode():
        logits = {}
        for name, m in (('int8', q8), ('bf16', flt)):
            _, out = m.prefill(prompts, m.make_decode_caches(BATCH, T_MAX))
            logits[name] = out[:, -1].float()
    rel = ((logits['int8'] - logits['bf16']).abs().amax(-1)
           / logits['bf16'].abs().amax(-1)).tolist()

    times = {}
    for name, m in (('bf16', flt), ('int8', q8)):
        greedy_generate(m, prompts, 2, T_MAX)                 # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        greedy_generate(m, prompts, 1, T_MAX)
        torch.cuda.synchronize()
        prefill_ms = 1e3 * (time.perf_counter() - t0)
        ddp.flash_attention.launches = 0
        ddp.flash_decode.launches = 0
        t0 = time.perf_counter()
        tokens = greedy_generate(m, prompts, STEPS, T_MAX)
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        times[name] = {'prefill_ms': prefill_ms,
                       'ms_per_decode_step':
                           (1e3 * total_s - prefill_ms) / (STEPS - 1),
                       'tokens_per_s': BATCH * STEPS / total_s,
                       'launches': {
                           'flash_attention': ddp.flash_attention.launches,
                           'flash_decode': ddp.flash_decode.launches},
                       'tokens': tokens}
    again = greedy_generate(q8, prompts, STEPS, T_MAX)
    launches = times['int8']['launches']
    row = {'phase': 'wq8_lm', 'prefill_last_logits_max_rel_err': rel,
           'tol': WQ8_RTOL,
           'weight_bytes': {'int8': int8_bytes, 'scales': scale_bytes,
                            'bf16': bf16_bytes, 'want_int8': want8,
                            'want_bf16': want16},
           'greedy_twice_identical': bool(torch.equal(
               again, times['int8']['tokens'])),
           'tokens_equal_bf16': int((times['int8']['tokens']
                                     == times['bf16']['tokens']).sum()),
           **{name: {k: v for k, v in t.items() if k != 'tokens'}
              for name, t in times.items()},
           'seconds': time.perf_counter() - t_phase}
    emit(row)
    for r in rel:
        check(r <= WQ8_RTOL, f'wq8 LM logits rel err {r} > {WQ8_RTOL}')
    check(row['greedy_twice_identical'], 'wq8 LM greedy runs differ')
    check(bool(((again >= 0) & (again < VOCAB)).all()), 'token out of range')
    check(launches == {'flash_attention': LAYERS,
                       'flash_decode': LAYERS * (STEPS - 1)},
          f'wq8 LM launched {launches}')
    check(int8_bytes == want8 and bf16_bytes == want16,
          f'wq8 LM weight bytes {int8_bytes} / {bf16_bytes}, want '
          f'{want8} / {want16}')
    del flt, q8
    torch.cuda.empty_cache()
    return launches


# train_knobs: train_path's LM, 2 Adam steps under each remat setting,
# then the untied head for 3 steps.
KNOB_STEPS, UNTIED_STEPS = 2, 3
REMAT_KNOBS = (('no_remat', False, None), ('remat', True, None),
               ('dots_saveable', True, 'dots_saveable'),
               ('dots_with_no_batch_dims_saveable', True,
                'dots_with_no_batch_dims_saveable'))


def _knob_run(torch, ddp, steps, **kw):
    """``steps`` Adam steps of train_path's LM built with ``kw``: losses,
    ms a step, peak memory, launches a step and step 1's gradients."""
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(3)
    model = ddp.TransformerLM(VOCAB, DIM, HEADS, n_layers=LAYERS,
                              dtype=torch.bfloat16, device=dev,
                              generator=gen, **kw)
    opt = torch.optim.Adam(model.parameters(), lr=LR, betas=(0.9, 0.999),
                           eps=1e-8)
    step = ddp.make_lm_train_step(model, opt, loss_chunk=LOSS_CHUNK)
    tokens = torch.randint(0, VOCAB, (TRAIN_B, TRAIN_T), generator=gen
                           ).to(dev)
    batch = (tokens, ddp.lm_targets(tokens))
    counters = {name: getattr(ddp, name) for name in TRAIN_KERNELS}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, per_step, grads = [], [], [], None
    for i in range(steps):
        before = {n: fn.launches for n, fn in counters.items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = step(batch)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss.item())
        per_step.append({n: fn.launches - before[n]
                         for n, fn in counters.items()})
        if i == 0:
            grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    out = {'losses': losses, 'step_ms': step_ms,
           'max_memory_allocated': torch.cuda.max_memory_allocated(),
           'launches_per_step': per_step}
    del model, opt, step, batch
    return out, grads


def phase_train_knobs(torch, ddp):
    """The four remat settings (losses and step-1 gradients bit for bit
    alike: each recompute runs the same kernels on the same inputs, and a
    kept matmul output is the one the forward made), then the untied
    head."""
    t_phase = time.perf_counter()
    rows, ref = {}, None
    for name, remat, policy in REMAT_KNOBS:
        row, grads = _knob_run(torch, ddp, KNOB_STEPS, remat=remat,
                               remat_policy=policy)
        if ref is None:
            ref, ref_losses = grads, row['losses']
            row['grads_equal_no_remat'] = row['losses_equal_no_remat'] = True
        else:
            row['grads_equal_no_remat'] = all(torch.equal(grads[n], g)
                                              for n, g in ref.items())
            row['losses_equal_no_remat'] = row['losses'] == ref_losses
        del grads
        torch.cuda.empty_cache()
        want = {'flash_attention': (2 if remat else 1) * LAYERS,
                'flash_attention_dq': LAYERS, 'flash_attention_dkv': LAYERS}
        emit({'phase': 'train_knobs', 'case': name, 'remat': remat,
              'remat_policy': policy, 'expected_launches_per_step': want,
              **row})
        check(all(c == want for c in row['launches_per_step']),
              f'{name}: launched {row["launches_per_step"]}, want {want}')
        check(row['losses_equal_no_remat'] and row['grads_equal_no_remat'],
              f'{name}: loss or gradients differ from no remat')
        rows[name] = row
    del ref
    torch.cuda.empty_cache()
    row, _ = _knob_run(torch, ddp, UNTIED_STEPS, remat=True,
                       tie_embeddings=False)
    want = {'flash_attention': 2 * LAYERS, 'flash_attention_dq': LAYERS,
            'flash_attention_dkv': LAYERS}
    emit({'phase': 'train_knobs', 'case': 'untied_head',
          'expected_launches_per_step': want, **row,
          'seconds': time.perf_counter() - t_phase})
    losses = row['losses']
    check(all(math.isfinite(x) for x in losses), 'untied: non-finite loss')
    check(losses[-1] < losses[0], f'untied: loss did not fall: {losses}')
    check(all(c == want for c in row['launches_per_step']),
          f'untied: launched {row["launches_per_step"]}, want {want}')
    rows['untied_head'] = row
    torch.cuda.empty_cache()
    return {name: {k: sum(c[k] for c in r['launches_per_step'])
                   for k in TRAIN_KERNELS} for name, r in rows.items()}


# load_serve: the seeded open-loop two-tenant trace (LoadGenConfig(seed=7,
# rate=300, requests=64) with the stock tenants: t0 interactive, 2/3 of
# the traffic; t1 batchy) over the paged engine at the serving widths
# (bf16, t_max 4096, page 16, prefill chunk 64) with the reference's
# serve-load slot count, 4 (at 8 slots this trace never queues, and no
# policy has anything to decide), float and int8 weights, FIFO and with
# t0 at priority 1; each run twice. Goodput under one SLO on the run's
# virtual clock (a tick is 2 ms): the first token within 20 ms (10
# ticks), no gap between tokens over 4 ms.
LOAD_SEED, LOAD_RATE, LOAD_REQUESTS, LOAD_SLOTS = 7, 300.0, 64, 4
LOAD_SLO = dict(ttft=0.02, per_token=0.004)


def _inversions(timelines):
    """Admissions of a t1 request at a moment a t0 request submitted
    earlier was still queued: what a priority-1 t0 must never see."""
    spans = []
    for tl in timelines.values():
        if tl.tenant == 't0':
            admits = [e['ts'] for e in tl.events
                      if e['event'] == 'serve.admit']
            if admits and tl.queue_wait is not None:
                spans.append((admits[0] - tl.queue_wait, admits[0]))
    n = 0
    for tl in timelines.values():
        if tl.tenant != 't1':
            continue
        for e in tl.events:
            if e['event'] == 'serve.admit':
                n += any(s < e['ts'] < a for s, a in spans)
    return n


def _load_run(torch, ddp, engine, policy, log_path):
    from distributed_dot_product_tpu_torch.obs import EventLog
    from distributed_dot_product_tpu_torch.obs.slo import SloSpec, goodput
    from distributed_dot_product_tpu_torch.obs.timeline import reconstruct
    from distributed_dot_product_tpu_torch.serve import (
        LoadGenConfig, default_tenants, run_load,
    )
    from distributed_dot_product_tpu_torch.utils.tracing import (
        MetricsRegistry,
    )
    registry = MetricsRegistry()
    log = EventLog(log_path)
    ddp.flash_decode.launches = 0
    ddp.flash_decode_paged.launches = 0
    try:
        res = run_load(LoadGenConfig(seed=LOAD_SEED, rate=LOAD_RATE,
                                     requests=LOAD_REQUESTS, vocab=VOCAB,
                                     tenants=default_tenants(2)),
                       engine=engine, registry=registry, event_log=log,
                       policy=policy)
    finally:
        log.close()
    launches = {'flash_decode': ddp.flash_decode.launches,
                'flash_decode_paged': ddp.flash_decode_paged.launches}
    report = goodput(log_path, SloSpec(**LOAD_SLO))
    timelines = reconstruct(log_path)
    outcomes = {rid: (r.status, r.reason.value if r.reason else None,
                      list(r.tokens)) for rid, r in res.results.items()}
    counters = registry.snapshot()['counters']
    return {'result': res, 'launches': launches, 'report': report,
            'timelines': timelines, 'outcomes': outcomes,
            'decode_ticks': counters.get('serve.decode_steps', 0)}


def phase_load_serve(torch, ddp):
    """The seeded trace over the paged engine, float and int8, FIFO and
    under the priority policy, each twice: accounted, K5p launches equal
    decode ticks, identical outcomes and SLO report on the second run,
    every timeline valid, no priority inversion under the policy (and
    some under FIFO, or the trace would not contend)."""
    import tempfile
    import numpy as np
    from distributed_dot_product_tpu_torch.serve import (
        PolicyConfig, TenantPolicy,
    )
    t_phase = time.perf_counter()
    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        for weights in ('off', 'int8'):
            engine = serve_engine(torch, 'paged', slots=LOAD_SLOTS,
                                  weight_quant=weights)
            # Load every kernel before the timed runs.
            engine.step(np.zeros(engine.slots, np.int32),
                        np.ones(engine.slots, bool))
            for i in range(engine.slots):
                engine.reset(i)
            for pol_name, policy in (
                    ('fifo', None),
                    ('priority', PolicyConfig(
                        tenants={'t0': TenantPolicy(priority=1)}))):
                name = f"{'bf16' if weights == 'off' else 'int8'}_{pol_name}"
                runs = [_load_run(torch, ddp, engine, policy,
                                  os.path.join(tmp, f'{name}_{i}.jsonl'))
                        for i in range(2)]
                first, second = runs
                res, rep = first['result'], first['report']
                bad = {rid: tl.errors for rid, tl in
                       first['timelines'].items() if not tl.complete}
                inversions = _inversions(first['timelines'])
                row = {'phase': 'load_serve', 'case': name,
                       'requests': LOAD_REQUESTS, 'slo': LOAD_SLO,
                       'goodput_pct': rep.goodput_pct,
                       'per_tenant_goodput_pct': {
                           t: v['goodput_pct']
                           for t, v in sorted(rep.per_tenant.items())},
                       'counts': rep.counts, 'statuses': rep.statuses,
                       'rejected_at_submit': len(res.rejected_at_submit),
                       'ttft_p99_s': rep.percentiles['ttft']['p99'],
                       'virtual_seconds': res.virtual_seconds,
                       'wall_seconds': res.wall_seconds, 'ticks': res.ticks,
                       'decode_ticks': first['decode_ticks'],
                       'launches': first['launches'],
                       'accounted': res.accounted,
                       'timelines_invalid': bad,
                       'priority_inversions': inversions,
                       'second_run_identical': (
                           second['outcomes'] == first['outcomes']
                           and second['report'].to_dict()
                           == rep.to_dict()),
                       'second_wall_seconds':
                           second['result'].wall_seconds}
                emit(row)
                check(res.accounted, f'{name}: a request has no terminal')
                check(first['launches']['flash_decode_paged']
                      == first['decode_ticks'] > 0
                      and first['launches']['flash_decode'] == 0,
                      f"{name}: launches {first['launches']} for "
                      f"{first['decode_ticks']} decode ticks")
                check(row['second_run_identical'],
                      f'{name}: the same seed twice gave other outcomes')
                check(not bad, f'{name}: invalid timelines {bad}')
                check(len(first['timelines']) == LOAD_REQUESTS,
                      f'{name}: {len(first["timelines"])} timelines')
                if policy is None:
                    check(inversions > 0,
                          f'{name}: the trace never contends (no t1 '
                          f'admitted past a waiting t0 under FIFO)')
                else:
                    check(inversions == 0,
                          f'{name}: {inversions} t1 admissions past a '
                          f'waiting priority-1 t0')
                launches[name] = first['launches']['flash_decode_paged']
            del engine
            torch.cuda.empty_cache()
    emit({'phase': 'load_serve', 'case': 'done',
          'seconds': time.perf_counter() - t_phase})
    return launches


# Disaggregated serving (router_serve; README "Disaggregated serving"): the
# serve_path configuration as a 1 x 2 topology on one card — a prefill pool
# and two decode replicas of KernelEngine(slots 8, t_max 4096, page 16,
# prefill chunk 64) at the LM's widths, bf16, behind build_serving's Router
# with RouterConfig() defaults (prefill threshold 8): every burst prompt
# of 9 or more tokens hands its KV pages off. Handoff prompts of 17 (a tail
# page), 1000 and 2047 rows; the recovery and scrub runs on a virtual
# clock advanced ROUTER_TICK a tick; the scrub run serves the burst's first
# ROUTER_SCRUB_REQUESTS requests; the kv_shards run gives each replica 2
# shards of SERVE_PAGES pages (its registered prefixes all sit on shard 0's
# ordinals, so shard 0 gets the slab's whole pool), and its handoff check
# adds a 3000-row prefix that spans both shards.
ROUTER_HANDOFF_ROWS = (17, 1000, 2047)
ROUTER_KV_ROWS = (17, 2047, 3000)
ROUTER_GREEDY = 64
ROUTER_TICK = 0.01
ROUTER_SCRUB_REQUESTS = 8
ROUTER_KV_SHARDS = 2
ROUTER_MAX_TICKS = 20000
ROUTER_DEVICE = 'cuda'
TORN_TAIL = '{"schema":2,"seq":'


def events_ms(torch, fn):
    """``(result, ms)``: one call of ``fn`` between CUDA events, the card
    idle before it — the host's work inside the call included, as the
    card sees it."""
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _router_pool(torch):
    """A prefill pool of the topology's configuration."""
    from distributed_dot_product_tpu_torch.serve import PrefillPool
    return PrefillPool(t_max=SERVE_T_MAX, page_size=SERVE_PAGE, vocab=VOCAB,
                       heads=HEADS, head_dim=HEAD_DIM, seed=SERVE_SEED,
                       dtype=torch.bfloat16, prefill_chunk=SERVE_CHUNK,
                       device=ROUTER_DEVICE)


def _router_topology(torch, clock, log_dir, router_kw=None, chaos=None,
                     **topo_kw):
    """build_serving over the 1 x 2 topology, every engine setting
    explicit and checked; ``chaos`` arms the router's chaos seams."""
    from distributed_dot_product_tpu_torch.serve import (
        RouterConfig, ServeConfig, TopologyConfig, build_serving,
    )
    topo = TopologyConfig(**{**dict(
        prefill_pools=1, decode_replicas=2, slots=SERVE_SLOTS,
        t_max=SERVE_T_MAX, page_size=SERVE_PAGE, vocab=VOCAB, heads=HEADS,
        head_dim=HEAD_DIM, seed=SERVE_SEED, decode_impl='kernel',
        prefill_chunk=SERVE_CHUNK, dtype=torch.bfloat16,
        device=ROUTER_DEVICE), **topo_kw})
    router = build_serving(
        topo, serve_config=ServeConfig(queue_limit=SERVE_QUEUE,
                                       max_new_tokens=SERVE_NEW,
                                       watchdog=False),
        router_config=RouterConfig(**(router_kw or {})), clock=clock,
        log_dir=log_dir, chaos=chaos)
    for r in router.pool.replicas:
        eng = r.engine
        check((eng.decode_impl, eng.cache_mode, eng.weight_quant,
               eng.kv_shards) == ('kernel', 'paged', None,
                                  topo_kw.get('kv_shards', 1)),
              f'{r.name}: engine settings are not the ones asked for')
    return router


def _router_drive(router, burst, advance=None, on_tick=None):
    """The burst through ``router`` as serve_path feeds its scheduler (a
    tick after every 4th submit), then ticks to idle. ``advance`` moves a
    virtual clock each tick; ``on_tick(router)`` runs after every tick
    once the whole burst is submitted, until it returns True."""
    from distributed_dot_product_tpu_torch.serve import RejectedError
    rejected = {}
    ticks = 0

    def tick():
        nonlocal ticks
        busy = router.step()
        ticks += 1
        if advance is not None:
            advance(ROUTER_TICK)
        check(ticks < ROUTER_MAX_TICKS, 'the topology never went idle')
        return busy
    for i, (rid, prompt) in enumerate(burst):
        try:
            router.submit(prompt, request_id=rid)
        except RejectedError as e:
            rejected[rid] = e.reason.value
        if i % 4 == 3:
            tick()
    while tick():
        if on_tick is not None and on_tick(router):
            on_tick = None
    return router.results, rejected, ticks


def _router_decode_steps(router):
    """Decode ticks of every replica the run had, lost and drained ones
    included."""
    pool = router.pool
    return sum(r.registry.snapshot()['counters'].get('serve.decode_steps', 0)
               for r in pool.replicas + pool.lost + pool.retired)


def _router_streams(what, results, base, rids):
    """Gate: every request in ``rids`` completed with ``base``'s stream."""
    bad = [rid for rid in rids
           if results.get(rid) is None or results[rid].status != 'completed'
           or results[rid].tokens != base[rid].tokens]
    check(not bad, f'{what}: streams differ from the reference run: {bad}')


def _router_once(what, router, rids):
    """Gate: every request reconstructs exactly once, complete, over the
    merged logs; returns the timelines."""
    from distributed_dot_product_tpu_torch.obs.timeline import reconstruct
    tls = reconstruct(router.pool.logs())
    check(set(tls) == set(rids), f'{what}: timelines for {sorted(tls)} '
                                 f'of {len(rids)} requests')
    bad = {rid: tl.errors for rid, tl in tls.items() if not tl.complete}
    check(not bad, f'{what}: incomplete timelines {bad}')
    return tls


def _router_events(router, name):
    from distributed_dot_product_tpu_torch.obs.events import read_events
    return list(read_events(dict(router.pool.logs())[name]))


def _router_handoff(torch, ddp, flush, rng):
    """router_serve (1): build + adopt_prefix on one paged engine beside
    register_prefix of the same tokens — pages bit for bit, a slot started
    on the adopted prefix against a flat-prefilled slot and one started on
    the registered prefix: first-step logits bit for bit, 64 greedy tokens
    equal."""
    import numpy as np
    from distributed_dot_product_tpu_torch.models.decode import (
        paged_transfer_pages,
    )
    from distributed_dot_product_tpu_torch.serve import engine as eng_mod
    eng = serve_engine(torch, 'paged')
    pool = _router_pool(torch)
    page_bytes = 2 * HEADS * SERVE_PAGE * HEAD_DIM * 2       # K and V, bf16
    rows = []
    for n in ROUTER_HANDOFF_ROWS:
        tokens = rng.integers(0, VOCAB, size=n).astype(np.int64)
        last = int(rng.integers(0, VOCAB))
        handle, build_ms = events_ms(torch, lambda: pool.build(tokens))
        pid_a, adopt_ms = events_ms(torch, lambda: eng.adopt_prefix(
            pool.engine.cache, handle.pages, n,
            src_checksums=pool.engine.checksums))
        pages_a = eng._prefix_registry[pid_a][0]
        copy_ms = time_ms(torch, lambda: paged_transfer_pages(
            eng.cache, pool.engine.cache.k_pool, pool.engine.cache.v_pool,
            handle.pages, pages_a), flush)
        pool.release(handle)
        pid_r = eng.register_prefix(tokens)
        pages_r = eng._prefix_registry[pid_r][0]
        pages_equal = all(
            torch.equal(eng.cache.k_pool[a], eng.cache.k_pool[r])
            and torch.equal(eng.cache.v_pool[a], eng.cache.v_pool[r])
            for a, r in zip(pages_a, pages_r))
        check(eng.start_with_prefix(0, pid_a)
              and eng.start_with_prefix(2, pid_r), 'attach failed')
        for start in range(0, n, SERVE_CHUNK):
            eng.prefill(1, tokens[start:start + SERVE_CHUNK])
        active = np.zeros(eng.slots, bool)
        active[:3] = True
        tok = np.full(eng.slots, last, np.int32)
        first, streams = [], [[], [], []]
        spied = eng_mod.slots_all_finite

        def spy(x):
            if not first:
                first.append(x[:3, 0].float().cpu())
            return spied(x)
        eng_mod.slots_all_finite = spy
        try:
            for _ in range(ROUTER_GREEDY):
                tok, _ = eng.step(tok, active)
                for i in range(3):
                    streams[i].append(int(tok[i]))
        finally:
            eng_mod.slots_all_finite = spied
        logits = first[0]
        npages = len(pages_a)
        moved = npages * page_bytes
        row = {'phase': 'router_serve', 'case': 'handoff', 'rows': n,
               'pages': npages, 'bytes_moved': moved,
               'pages_equal_register_prefix': pages_equal,
               'first_step_logits_equal': {
                   'adopted_vs_flat': torch.equal(logits[0], logits[1]),
                   'adopted_vs_registered': torch.equal(logits[0],
                                                        logits[2])},
               'greedy_equal': {
                   'adopted_vs_flat': streams[0] == streams[1],
                   'adopted_vs_registered': streams[0] == streams[2]},
               'build_ms': build_ms, 'adopt_prefix_ms': adopt_ms,
               'copy_ms': copy_ms,
               'copy_bound_ms':
                   2 * moved / perf().DEFAULT_PEAKS.bytes_per_s * 1e3}
        emit(row)
        rows.append(row)
        check(pages_equal, f'handoff {n}: adopted pages differ from '
                           f'register_prefix')
        check(all(row['first_step_logits_equal'].values()),
              f'handoff {n}: first-step logits differ')
        check(all(row['greedy_equal'].values()),
              f'handoff {n}: greedy streams differ')
        for slot in range(3):
            eng.reset(slot)
        eng.unregister_prefix(pid_a)
        eng.unregister_prefix(pid_r)
    del eng, pool
    torch.cuda.empty_cache()
    return rows


def _router_kv_handoff(torch, rng):
    """router_serve (6a): adopt_prefix into a kv_shards engine — each
    adopted page on the shard owning its ordinal, bit for bit the source
    page, its landed digest the source's."""
    import numpy as np
    eng = serve_engine(torch, 'paged', kv_shards=ROUTER_KV_SHARDS,
                       pages=SERVE_PAGES)
    pool = _router_pool(torch)
    out = []
    for n in ROUTER_KV_ROWS:
        tokens = rng.integers(0, VOCAB, size=n).astype(np.int64)
        handle = pool.build(tokens)
        pid = eng.adopt_prefix(pool.engine.cache, handle.pages, n,
                               src_checksums=pool.engine.checksums)
        gpages = eng._prefix_registry[pid][0]
        per_shard, owned, equal, digests = {}, True, True, True
        for o, (src, g) in enumerate(zip(handle.pages, gpages)):
            s, p = eng._gsplit(g)
            lo, hi = eng.pool.owned_range(s)
            owned &= lo <= o < hi
            per_shard[s] = per_shard.get(s, 0) + 1
            cache = eng.shard_cache(s)
            equal &= (torch.equal(cache.k_pool[p],
                                  pool.engine.cache.k_pool[src])
                      and torch.equal(cache.v_pool[p],
                                      pool.engine.cache.v_pool[src]))
            digests &= (eng.checksums[s].get(p)[0]
                        == pool.engine.checksums.get(src)[0])
        pool.release(handle)
        eng.unregister_prefix(pid)
        row = {'phase': 'router_serve', 'case': 'kv_shards_handoff',
               'rows': n, 'pages_by_shard': per_shard,
               'on_owning_shard': owned, 'pages_equal_source': equal,
               'landed_digests_equal': digests}
        emit(row)
        out.append(row)
        check(owned and equal and digests,
              f'kv_shards handoff {n}: {row}')
    del eng, pool
    torch.cuda.empty_cache()
    return out


def _router_ttft_p99(tls, submitted=None):
    """TTFT p99 over the timelines: the replicas' own (from the replica's
    submit, the scheduler's definition), or from ``submitted`` (the
    router's submit instant) to the first token's event."""
    import numpy as np
    if submitted is None:
        vals = [tl.ttft for tl in tls.values() if tl.ttft is not None]
    else:
        vals = [min(e['ts'] for e in tl.events
                    if e['event'] == 'serve.decode') - submitted[rid]
                for rid, tl in tls.items()
                if any(e['event'] == 'serve.decode' for e in tl.events)]
    return float(np.percentile(vals, 99)) if vals else None


def phase_router_serve(torch, ddp, flush):
    """Disaggregated serving on one card: the handoff case, the burst
    through the 1 x 2 topology beside the single paged engine, prefix
    affinity on resubmission, recovery from a killed replica, the scrub
    healing a flipped page, and the topology with kv_shards replicas."""
    import statistics as stats
    import tempfile
    import numpy as np
    from distributed_dot_product_tpu_torch.serve import VirtualClock
    t_phase = time.perf_counter()
    rng = np.random.default_rng(SERVE_SEED + 16)
    out = {'handoff': _router_handoff(torch, ddp, flush, rng)}
    burst = serve_burst()
    rids = [rid for rid, _ in burst]

    # (2) the single paged engine, then the topology, in this call.
    single_eng = serve_engine(torch, 'paged')
    single, srow = _serve_burst(torch, ddp, single_eng, burst, 'single')
    del single_eng
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix='router_serve_')
    launches = {}
    router = _router_topology(torch, time.monotonic,
                              os.path.join(tmp, 'topology'))
    try:
        submitted = {}
        orig_submit = router.submit

        def stamped(prompt, **kw):
            submitted[kw['request_id']] = router.clock()
            return orig_submit(prompt, **kw)
        router.submit = stamped
        ddp.flash_decode.launches = ddp.flash_decode_paged.launches = 0
        t0 = time.perf_counter()
        results, rejected, ticks = _router_drive(router, burst)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k5p, k5 = ddp.flash_decode_paged.launches, ddp.flash_decode.launches
        router.submit = orig_submit
        steps = _router_decode_steps(router)
        counters = router.registry.snapshot()['counters']
        tls = _router_once('topology_burst', router, rids)
        handoffs = [e for e in _router_events(router, 'prefill')
                    if e['event'] == 'prefill.handoff']
        routed = {r.name: sum(v for k, v in counters.items()
                              if k.startswith(f'router.routed{{replica='
                                              f'{r.name},'))
                  for r in router.pool.replicas}
        tokens = sum(len(r.tokens) for r in results.values())
        build = [e['build_seconds'] for e in handoffs]
        transfer = [e['transfer_seconds'] for e in handoffs]
        row = {'phase': 'router_serve', 'case': 'topology_burst',
               'requests': len(burst), 'rejected_at_submit': rejected,
               'terminal': {st: sum(r.status == st for r in results.values())
                            for st in {r.status for r in results.values()}},
               'tokens_generated': tokens, 'wall_s': wall,
               'tokens_per_s': tokens / wall,
               'single_tokens_per_s': srow['tokens_per_s'],
               'ttft_p99_s': _router_ttft_p99(tls),
               'ttft_p99_from_router_submit_s': _router_ttft_p99(
                   tls, submitted),
               'single_ttft_p99_s': srow['ttft_s']['p99'],
               'decode_ticks': steps, 'router_ticks': ticks,
               'single_decode_steps': srow['decode_steps'],
               'launches': {'flash_decode_paged': k5p, 'flash_decode': k5},
               'routed': routed, 'handoffs': counters['router.handoffs'],
               'handoff_pages': counters['router.handoff_pages'],
               'build_seconds': {'p50': stats.median(build),
                                 'max': max(build)} if build else None,
               'transfer_seconds': {'p50': stats.median(transfer),
                                    'max': max(transfer)}
               if transfer else None}
        emit(row)
        check(not rejected and len(results) == len(burst),
              f'topology_burst: {len(results)} results, rejected {rejected}')
        _router_streams('topology_burst', results, single, rids)
        check(k5p == steps > 0 and k5 == 0,
              f'topology_burst: K5p launched {k5p} times (K5 {k5}) for '
              f'{steps} decode ticks')
        check(all(v > 0 for v in routed.values()) and row['handoffs'] >= 1,
              f'topology_burst: routed {routed}, handoffs '
              f'{row["handoffs"]}')
        launches['topology_burst'] = k5p
        holder = {tuple(int(t) for t in dict(burst)[e['request_id']][:-1]):
                  e['target'] for e in handoffs}

        # (3) the same prompts again: prefix hits on the holders. The first
        # one alone first, sampled after one tick (the attach happens at
        # admission): shared pages on its holder only.
        hits0 = counters['router.prefix_hits']
        probe_rid, probe_prompt = burst[0]
        router.submit(probe_prompt, request_id=f'{probe_rid}-again')
        router.step()
        shared = {r.name: r.engine.cache_stats()['shared_pages']
                  for r in router.pool.replicas}
        probe_home = holder[tuple(int(t) for t in probe_prompt[:-1])]
        ddp.flash_decode_paged.launches = 0
        steps0 = _router_decode_steps(router)
        again = [(f'{rid}-again', p) for rid, p in burst[1:]]
        results2, rejected2, _ = _router_drive(router, again)
        k5p = ddp.flash_decode_paged.launches
        steps = _router_decode_steps(router) - steps0
        counters = router.registry.snapshot()['counters']
        route_events = [e for e in _router_events(router, 'router')
                        if e['event'] == 'router.route'
                        and e['request_id'].endswith('-again')]
        prompts = dict(burst)
        misplaced = [e['request_id'] for e in route_events
                     if e['policy'] != 'prefix' or e['target'] != holder.get(
                         tuple(int(t) for t in prompts[
                             e['request_id'][:-len('-again')]][:-1]))]
        row = {'phase': 'router_serve', 'case': 'prefix_affinity',
               'requests': len(burst),
               'prefix_hits': counters['router.prefix_hits'] - hits0,
               'handoffs_total': counters['router.handoffs'],
               'shared_pages_after_first_tick': shared,
               'first_holder': probe_home, 'not_routed_to_holder': misplaced,
               'launches': k5p, 'decode_ticks': steps}
        emit(row)
        check(not rejected2, f'prefix_affinity: rejected {rejected2}')
        check(len(route_events) == len(burst) and not misplaced,
              f'prefix_affinity: {misplaced} not prefix hits on their '
              f'holders')
        check(shared[probe_home] > 0 and all(
            v == 0 for name, v in shared.items() if name != probe_home),
              f'prefix_affinity: shared pages {shared}, holder {probe_home}')
        check(counters['router.handoffs'] == len(handoffs),
              'prefix_affinity: a resubmitted prompt was handed off again')
        _router_streams('prefix_affinity',
                        {rid[:-len('-again')]: r for rid, r in
                         router.results.items() if rid.endswith('-again')},
                        single, rids)
        _router_once('prefix_affinity', router,
                     rids + [f'{rid}-again' for rid in rids])
        launches['prefix_affinity'] = k5p
    finally:
        router.close()
    del router
    torch.cuda.empty_cache()

    # (4) recovery: r1 killed once both replicas decode. Each replica's
    # pool holds both replicas' streams (the survivor replays r1's prompts
    # flat beside its own pinned prefixes): a smaller pool would evict.
    clock = VirtualClock()
    router = _router_topology(torch, clock, os.path.join(tmp, 'recovery'),
                              pages=2 * SERVE_PAGES)
    try:
        state = {}

        def kill_r1(rt):
            names = {r.name: r for r in rt.pool.replicas}
            if not all(r.registry.snapshot()['counters'].get(
                    'serve.decode_steps', 0) for r in names.values()):
                return False
            inflight = [rid for rid, e in rt._ledger.items()
                        if e['replica'] == 'r1'
                        and rid not in names['r1'].results]
            if not inflight:
                return False
            state['in_flight'] = inflight
            names['r1'].kill()
            return True
        ddp.flash_decode_paged.launches = 0
        results, rejected, ticks = _router_drive(
            router, burst, advance=clock.advance, on_tick=kill_r1)
        k5p = ddp.flash_decode_paged.launches
        steps = _router_decode_steps(router)
        counters = router.registry.snapshot()['counters']
        revs = _router_events(router, 'router')
        lost = [e for e in revs if e['event'] == 'replica.lost']
        r1_log = dict(router.pool.logs())['r1']
        with open(r1_log, encoding='utf-8') as fh:
            tail = fh.read().rsplit('\n', 1)[-1]
        tls = _router_once('recovery', router, rids)
        row = {'phase': 'router_serve', 'case': 'recovery',
               'killed': 'r1', 'in_flight_at_kill': len(
                   state.get('in_flight', [])),
               'replica_lost': [{k: e[k] for k in ('target', 'reason',
                                                   'in_flight')}
                                for e in lost],
               'recovered': counters.get('router.recovered', 0),
               'recoveries_in_timelines': sum(tl.recoveries
                                              for tl in tls.values()),
               'torn_tail': tail == TORN_TAIL, 'ticks': ticks,
               'launches': k5p, 'decode_ticks': steps,
               'virtual_seconds': clock()}
        emit(row)
        check(state.get('in_flight'), 'recovery: r1 was never killed')
        check(len(lost) == 1 and lost[0]['target'] == 'r1'
              and lost[0]['reason'] == 'probe_timeout'
              and lost[0]['in_flight'] == len(state['in_flight']),
              f'recovery: replica.lost events {lost}')
        check(row['recovered'] == len(state['in_flight']),
              f'recovery: {row["recovered"]} recovered of '
              f'{len(state["in_flight"])} in flight')
        check(row['torn_tail'], f'recovery: r1 log tail {tail!r}')
        check(not rejected, f'recovery: rejected {rejected}')
        _router_streams('recovery', results, single, rids)
        check(k5p == steps, f'recovery: K5p launched {k5p} times for '
                            f'{steps} decode ticks')
        launches['recovery'] = k5p
    finally:
        router.close()
    del router
    torch.cuda.empty_cache()

    # (5) the scrub: a page of r0 with a rider flipped mid-run.
    clock = VirtualClock()
    router = _router_topology(torch, clock, os.path.join(tmp, 'scrub'),
                              router_kw=dict(integrity_interval=0.0))
    sub = burst[:ROUTER_SCRUB_REQUESTS]
    try:
        state = {}

        def flip(rt):
            r0 = next(r for r in rt.pool.replicas if r.name == 'r0')
            eng = r0.engine
            for page in eng.tracked_pages():
                riders = r0.scheduler.requests_on_slots(
                    eng.slots_sharing([page]))
                if riders:
                    state.update(page=page, riders=riders)
                    eng.flip_page_bit(page)
                    return True
            return False
        ddp.flash_decode_paged.launches = 0
        results, rejected, ticks = _router_drive(
            router, sub, advance=clock.advance, on_tick=flip)
        k5p = ddp.flash_decode_paged.launches
        steps = _router_decode_steps(router)
        revs = _router_events(router, 'router')
        corrupt = [e for e in revs if e['event'] == 'kv.corrupt']
        healed = [e['request_id'] for e in revs
                  if e['event'] == 'request.recovered'
                  and e.get('reason') == 'kv_corrupt' and e['requeued']]
        r0 = next(r for r in router.pool.replicas if r.name == 'r0')
        _router_once('scrub', router, [rid for rid, _ in sub])
        row = {'phase': 'router_serve', 'case': 'scrub',
               'requests': len(sub), 'flipped_page': state.get('page'),
               'riders': state.get('riders'),
               'kv_corrupt': [{k: e[k] for k in ('target', 'pages', 'site')}
                              for e in corrupt],
               'quarantined': sorted(r0.engine.pool.quarantined),
               'healed': healed, 'ticks': ticks, 'launches': k5p,
               'decode_ticks': steps}
        emit(row)
        check(state.get('page') is not None, 'scrub: no page was flipped')
        check(len(corrupt) == 1 and corrupt[0]['site'] == 'scrub'
              and corrupt[0]['target'] == 'r0'
              and state['page'] in corrupt[0]['pages'],
              f'scrub: kv.corrupt events {corrupt}')
        check(state['page'] in r0.engine.pool.quarantined,
              'scrub: the flipped page is not quarantined')
        check(sorted(healed) == sorted(state['riders']),
              f'scrub: healed {healed}, riders {state["riders"]}')
        check(not rejected, f'scrub: rejected {rejected}')
        _router_streams('scrub', results, single, [rid for rid, _ in sub])
        check(k5p == steps, f'scrub: K5p launched {k5p} times for {steps} '
                            f'decode ticks')
        launches['scrub'] = k5p
    finally:
        router.close()
    del router
    torch.cuda.empty_cache()

    # (6) kv_shards replicas: the shard-local handoff, then the burst.
    out['kv_shards_handoff'] = _router_kv_handoff(torch, rng)
    router = _router_topology(torch, time.monotonic,
                              os.path.join(tmp, 'kv_shards'),
                              kv_shards=ROUTER_KV_SHARDS, pages=SERVE_PAGES)
    try:
        ddp.flash_decode.launches = ddp.flash_decode_paged.launches = 0
        t0 = time.perf_counter()
        results, rejected, ticks = _router_drive(router, burst)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        k5p, k5 = ddp.flash_decode_paged.launches, ddp.flash_decode.launches
        steps = _router_decode_steps(router)
        _router_once('kv_shards', router, rids)
        diverged = {}
        for rid, r in results.items():
            base = single[rid].tokens
            if r.tokens != base:
                k = 0
                while k < min(len(r.tokens), len(base)) \
                        and r.tokens[k] == base[k]:
                    k += 1
                diverged[rid] = k
        tokens = sum(len(r.tokens) for r in results.values())
        row = {'phase': 'router_serve', 'case': 'kv_shards',
               'kv_shards': ROUTER_KV_SHARDS,
               'placement': {r.name: r.engine.placement
                             for r in router.pool.replicas},
               'terminal': {st: sum(r.status == st for r in results.values())
                            for st in {r.status for r in results.values()}},
               'tokens_per_s': tokens / wall, 'launches': k5p,
               'decode_ticks': steps,
               'handoffs': router.registry.snapshot()['counters'][
                   'router.handoffs'],
               'diverged_first_step': diverged,
               'note': 'bf16: the cross-shard merge adds in another order '
                       'than the kernel\'s cluster merge; streams reported, '
                       'not gated'}
        emit(row)
        check(not rejected and len(results) == len(burst) and all(
            r.status == 'completed' for r in results.values()),
              f'kv_shards: terminal {row["terminal"]}, rejected {rejected}')
        check(k5p == ROUTER_KV_SHARDS * steps > 0 and k5 == 0,
              f'kv_shards: K5p launched {k5p} times (K5 {k5}) for {steps} '
              f'decode ticks x {ROUTER_KV_SHARDS} shards')
        launches['kv_shards'] = k5p
    finally:
        router.close()
    del router
    torch.cuda.empty_cache()
    shutil.rmtree(tmp, ignore_errors=True)
    emit({'phase': 'router_serve', 'case': 'done',
          'seconds': time.perf_counter() - t_phase})
    out['launches'] = launches
    return out


# Chaos and control on the disaggregated topology (chaos_serve): the
# router_serve configuration (a prefill pool and decode replicas of
# KernelEngine(t_max 4096, page 16, prefill chunk 64) at the LM's widths,
# bf16, RouterConfig() defaults) driven by run_trace on a VirtualClock
# through load_serve's seeded trace (LoadGenConfig(seed 7, rate 300, 64
# requests), the stock tenants), beside the crash-free single engine on the
# same trace, the flight recorder armed. The replicas have load_serve's 4
# slots, the reference serve-load's: at 8 this trace never queues (its
# prompts are 2..15 tokens, so a handed-off prefix is one partial page that
# no decoding slot shares), and then no rider could wait on a corrupted
# page and no backlog could drive the controller. The faults land at fixed
# ticks of the trace, chosen on the CPU rehearsal at these shapes (the
# schedule reads no token values, so its ticks are the card's): CHAOS_CRASH
# kills r1 with 2 streams in flight, CHAOS_PREFILL_TICK kills the prefill
# pool with 6 long prompts still to come, and CHAOS_CORRUPT flips a bit of
# r0's tracked page 3 while request t1-0058 waits in r0's queue on its
# prefix (the page scrub runs every tick in that case, as the reference's
# corruption smoke does). Goodput is held under the reference chaos smoke's
# SLO (first token within 2 s, gaps within 1 s: a recovered stream keeps its
# original submit anchor) and, for the controller, under LOAD_SLO too. The
# controller is the reference benchmark's (ControlConfig(interval 0.01,
# scale_up_after 1, scale_down_after 20, max_replicas 3)) on a topology that
# starts from one decode replica, as the reference's control smoke does (two
# never reach a backlog of one queued request a slot on this trace); after
# the trace the topology idles for up to CHAOS_TAIL ticks so that sustained
# idleness drains the added replicas. The serving engine's prefill appends
# projected K/V rows and attends nothing, so the path's one kernel is K5p;
# K1's count is printed beside it and stays 0.
CHAOS_SLOTS = LOAD_SLOTS
CHAOS_CRASH = ('r1', 40)
CHAOS_PREFILL_TICK = 30
CHAOS_CORRUPT = ('r0', 3, 116)
CHAOS_SLO = dict(ttft=2.0, per_token=1.0)
CHAOS_CONTROL = dict(interval=0.01, scale_up_after=1, scale_down_after=20,
                     max_replicas=3)
CHAOS_CONTROL_REPLICAS = 1
CHAOS_TAIL = 600


def _obs_cli(*args):
    """``python -m distributed_dot_product_tpu_torch.obs ARGS`` from this
    checkout: ``(exit code, stdout, stderr)``."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        p for p in (root, env.get('PYTHONPATH')) if p)
    proc = subprocess.run(
        [sys.executable, '-m', 'distributed_dot_product_tpu_torch.obs',
         *args], capture_output=True, text=True, timeout=300, cwd=root,
        env=env)
    return proc.returncode, proc.stdout, proc.stderr


def _chaos_twin(torch, ddp, trace_path, tick, log_path):
    """The crash-free single engine on the same trace: one paged
    scheduler, its own virtual clock."""
    from distributed_dot_product_tpu_torch.obs import EventLog
    from distributed_dot_product_tpu_torch.obs.slo import SloSpec, goodput
    from distributed_dot_product_tpu_torch.serve import (
        Scheduler, ServeConfig, VirtualClock, load_trace, run_trace,
    )
    from distributed_dot_product_tpu_torch.utils.tracing import (
        MetricsRegistry,
    )
    import numpy as np
    engine = serve_engine(torch, 'paged', slots=CHAOS_SLOTS)
    # Load the kernel and warm every engine operation before the timed run.
    engine.step(np.zeros(engine.slots, np.int32), np.ones(engine.slots, bool))
    engine.prefill(0, np.zeros(engine.prefill_chunk, np.int32))
    for i in range(engine.slots):
        engine.reset(i)
    clock = VirtualClock()
    log = EventLog(log_path, clock=clock)
    registry = MetricsRegistry()
    sched = Scheduler(engine, ServeConfig(queue_limit=SERVE_QUEUE,
                                          max_new_tokens=SERVE_NEW,
                                          watchdog=False),
                      clock=clock, registry=registry, event_log=log,
                      fault_injector=False)
    ddp.flash_decode_paged.launches = 0
    t0 = time.perf_counter()
    try:
        res = run_trace(sched, load_trace(trace_path), clock,
                        tick_seconds=tick)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        sched.close()
        log.close()
    k5p = ddp.flash_decode_paged.launches
    counters = registry.snapshot()['counters']
    report = goodput(log_path, SloSpec(**CHAOS_SLO))
    tokens = counters.get('serve.tokens_generated', 0)
    del engine
    torch.cuda.empty_cache()
    check(res.accounted and k5p == counters.get('serve.decode_steps', 0),
          f'chaos twin: accounted {res.accounted}, K5p {k5p}')
    return {'result': res, 'report': report, 'wall_s': wall,
            'tokens_per_s': tokens / wall,
            'ttft_p99_s': report.percentiles['ttft']['p99'],
            'goodput_pct': report.goodput_pct}


def _chaos_run(torch, ddp, tmp, name, trace_path, tick, plan=None,
               router_kw=None, control=None, tail=0, flight=False,
               **topo_kw):
    """One run of the trace through a fresh 1 x 2 topology: ``plan`` (the
    ChaosPlan's fields) through a ChaosSchedule, ``control`` (the
    ControlConfig's) through a Controller on the router, the flight
    recorder installed when ``flight``; the kernels' counts set to 0 just
    before the trace and read just after (the idle tail included)."""
    from distributed_dot_product_tpu_torch.obs import flight as obs_flight
    from distributed_dot_product_tpu_torch.obs.events import read_events
    from distributed_dot_product_tpu_torch.obs.slo import SloSpec, goodput
    from distributed_dot_product_tpu_torch.serve import (
        ChaosSchedule, ControlConfig, Controller, VirtualClock, load_trace,
        run_trace,
    )
    from distributed_dot_product_tpu_torch.utils.faults import (
        ChaosInjector, ChaosPlan,
    )
    clock = VirtualClock()
    chaos = ChaosInjector(ChaosPlan(**plan)) if plan else None
    topo_kw.setdefault('slots', CHAOS_SLOTS)
    router = _router_topology(torch, clock, os.path.join(tmp, name),
                              router_kw=router_kw, chaos=chaos, **topo_kw)
    ctrl = (Controller(router=router, config=ControlConfig(**control),
                       clock=clock, event_log=router.event_log)
            if control else None)
    on_tick = ctrl.tick if ctrl is not None else None
    sched = None
    if chaos is not None:
        on_tick = sched = ChaosSchedule(chaos, router, on_tick=on_tick)
    # An observer apart from the schedule: the loop's own tick count, and
    # the tick at which each member was killed.
    ticks, kills = [0], []

    def observed(member):
        kill = member.kill

        def killed():
            if member.alive:
                kills.append((member.name, ticks[0]))
            kill()
        member.kill = killed
    for member in router.pool.replicas + [router.pool.prefill]:
        observed(member)
    inner = on_tick

    def on_tick():
        if inner is not None:
            inner()
        ticks[0] += 1
    rec = prev = None
    if flight:
        rec = obs_flight.FlightRecorder(os.path.join(tmp, name, 'flight'))
        prev = obs_flight.install(rec)
    ddp.flash_decode.launches = ddp.flash_decode_paged.launches = 0
    ddp.flash_attention.launches = 0
    t0 = time.perf_counter()
    tail_ticks = 0
    try:
        res = run_trace(router, load_trace(trace_path), clock,
                        tick_seconds=tick, on_tick=on_tick)
        while tail_ticks < tail and len(router.pool.replicas) > (
                ctrl.cfg.min_replicas):
            router.step()
            ctrl.tick()
            clock.advance(tick)
            tail_ticks += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {'flash_decode_paged': ddp.flash_decode_paged.launches,
                    'flash_decode': ddp.flash_decode.launches,
                    'flash_attention': ddp.flash_attention.launches}
    finally:
        router.close()
        if rec is not None:
            obs_flight.install(prev)
            rec.stop()
    logs = router.pool.logs()
    steps = _router_decode_steps(router)
    revs = list(read_events(dict(logs)['router']))
    report = goodput(logs, SloSpec(**CHAOS_SLO))
    tokens = sum(len(r.tokens) for r in res.results.values())
    out = {'router': router, 'result': res, 'report': report, 'logs': logs,
           'events': revs, 'launches': launches, 'decode_ticks': steps,
           'wall_s': wall, 'tokens_per_s': tokens / wall,
           'ttft_p99_s': report.percentiles['ttft']['p99'],
           'goodput_pct': report.goodput_pct, 'sched': sched,
           'ctrl': ctrl, 'tail_ticks': tail_ticks, 'kills': kills,
           'dumps': list(rec.dumps) if rec is not None else []}
    check(launches['flash_decode_paged'] == steps > 0
          and launches['flash_decode'] == 0,
          f'{name}: K5p launched {launches["flash_decode_paged"]} times '
          f'(K5 {launches["flash_decode"]}) for {steps} decode ticks')
    return out


def _chaos_partition(name, run):
    """Gate: every submitted request has exactly one typed terminal, and
    the goodput classes partition the requests."""
    res, report = run['result'], run['report']
    check(res.accounted, f'{name}: a request has no typed terminal')
    check(report.requests == len(res.submitted)
          and sum(report.counts.values()) == report.requests,
          f'{name}: classes {report.counts} do not partition the '
          f'{len(res.submitted)} requests')
    for rid, r in res.results.items():
        check(r.status != 'rejected' or r.reason is not None,
              f'{name}: {rid} rejected without a typed reason')


def _chaos_diverged(run, twin, rids=None):
    """``(compared, equal in full, diverged)`` over the delivered streams
    (of ``rids``, default all): a stream diverges unless it is a prefix of
    the twin's, and equal to it where both completed undegraded."""
    results, base = run['result'].results, twin['result'].results
    compared = full = 0
    bad = []
    for rid in (rids if rids is not None else sorted(results)):
        a, b = results.get(rid), base.get(rid)
        if a is None or b is None:
            continue
        n = min(len(a.tokens), len(b.tokens))
        if n:
            compared += 1
            if list(a.tokens)[:n] != list(b.tokens)[:n]:
                bad.append(rid)
        if (a.status == b.status == 'completed' and not a.degraded
                and not b.degraded):
            full += 1
            if list(a.tokens) != list(b.tokens):
                bad.append(rid)
    return compared, full, sorted(set(bad))


def _chaos_streams(name, run, twin, rids=None):
    """Gate: no delivered stream diverges from the twin's
    (:func:`_chaos_diverged`); returns ``(compared, equal in full)``."""
    compared, full, bad = _chaos_diverged(run, twin, rids)
    check(not bad, f'{name}: streams differ from the twin: {bad}')
    return compared, full


def _chaos_doctor(name, run, trigger):
    """The port's ``obs doctor --json`` on the run's auto-dumped bundle of
    ``trigger``."""
    dumps = [d for d in run['dumps'] if d['trigger'] == trigger]
    check(dumps, f'{name}: no flight bundle of trigger {trigger}: '
                 f'{run["dumps"]}')
    rc, out, err = _obs_cli('doctor', dumps[0]['path'], '--json')
    check(rc == 0, f'{name}: obs doctor exited {rc}: {err[-2000:]}')
    incident = json.loads(out)
    return {'primary': incident['primary'], 'replica': incident['replica']}


def _chaos_row(name, run, twin, **extra):
    row = {'phase': 'chaos_serve', 'case': name,
           'launches': run['launches'], 'decode_ticks': run['decode_ticks'],
           'ticks': run['result'].ticks, 'tail_ticks': run['tail_ticks'],
           'recovered': sorted(e['request_id'] for e in run['events']
                               if e['event'] == 'request.recovered'
                               and e['requeued']
                               and e.get('reason') is None),
           'healed': sorted(e['request_id'] for e in run['events']
                            if e['event'] == 'request.recovered'
                            and e['requeued']
                            and e.get('reason') == 'kv_corrupt'),
           'statuses': run['report'].statuses,
           'goodput_pct': run['goodput_pct'],
           'twin_goodput_pct': twin['goodput_pct'],
           'tokens_per_s': run['tokens_per_s'],
           'twin_tokens_per_s': twin['tokens_per_s'],
           'ttft_p99_s': run['ttft_p99_s'],
           'twin_ttft_p99_s': twin['ttft_p99_s'],
           'wall_s': run['wall_s'], 'virtual_seconds':
               run['result'].virtual_seconds}
    row.update(extra)
    emit(row)
    return row


def _chaos_events(run, event, **match):
    return [e for e in run['events'] if e['event'] == event
            and all(e.get(k) == v for k, v in match.items())]


def _chaos_crash(torch, ddp, tmp, trace, tick, twin):
    """replica_crash: r1 killed at CHAOS_CRASH's tick, its loss declared by
    the probes, its streams recovered equal to the twin's; the logs
    validate through the port's CLI; the no-recovery twin rejects typed
    and loses goodput; the doctor names r1."""
    victim, at = CHAOS_CRASH
    run = _chaos_run(torch, ddp, tmp, 'crash', trace, tick,
                     plan=dict(replica_crash=CHAOS_CRASH), flight=True)
    lost = _chaos_events(run, 'replica.lost')
    check(run['kills'] == [(victim, at)],
          f'crash: kills (member, loop tick) {run["kills"]}, planned '
          f'{CHAOS_CRASH}')
    check(len(lost) == 1 and lost[0]['target'] == victim
          and lost[0]['reason'] == 'probe_timeout',
          f'crash: replica.lost events {lost}')
    _chaos_partition('crash', run)
    recovered = [e['request_id'] for e in
                 _chaos_events(run, 'request.recovered', requeued=True)]
    check(recovered, f'crash: r1 died at tick {at} with nothing in flight')
    compared, full = _chaos_streams('crash', run, twin, recovered)
    check(full >= 1, f'crash: no recovered stream completed undegraded in '
                     f'both runs ({recovered})')
    _chaos_streams('crash (all)', run, twin)
    logs = dict(run['logs'])
    rc, out, err = _obs_cli('validate', logs['router'], '--require',
                            'replica.lost,replica.probe,request.recovered')
    check(rc == 0, f'crash: obs validate router log: {out}{err}')
    rc, out_r1, err = _obs_cli('validate', logs[victim])
    check(rc == 0, f'crash: obs validate torn {victim} log: {out_r1}{err}')
    with open(logs[victim], encoding='utf-8') as fh:
        torn = fh.read().rsplit('\n', 1)[-1] == TORN_TAIL
    check(torn, f'crash: the {victim} log is not torn')
    doctor = _chaos_doctor('crash', run, 'replica_lost')
    check(doctor == {'primary': 'replica_loss', 'replica': victim},
          f'crash: doctor says {doctor}')
    norec = _chaos_run(torch, ddp, tmp, 'crash_norec', trace, tick,
                       plan=dict(replica_crash=CHAOS_CRASH),
                       router_kw=dict(max_recoveries=0))
    _chaos_partition('crash_norec', norec)
    lost_rejects = sorted(
        rid for rid, r in norec['result'].results.items()
        if r.status == 'rejected' and r.reason is not None
        and r.reason.value == 'replica_lost')
    check(lost_rejects, 'crash_norec: no typed replica_lost reject')
    check(norec['goodput_pct'] < run['goodput_pct'],
          f'crash_norec: goodput {norec["goodput_pct"]} not below '
          f'{run["goodput_pct"]} with recovery')
    _chaos_streams('crash_norec', norec, twin)
    _chaos_row('replica_crash', run, twin,
               plan={'replica_crash': [victim, at]}, kills=run['kills'],
               replica_lost=[{k: e[k] for k in ('target', 'reason',
                                                'in_flight')}
                             for e in lost],
               streams_compared=compared, streams_equal_in_full=full,
               router_log_validates=out.strip().splitlines()[-1],
               torn_log_validates=out_r1.strip().splitlines()[-1],
               doctor=doctor, norec_goodput_pct=norec['goodput_pct'],
               norec_replica_lost_rejects=lost_rejects,
               norec_launches=norec['launches'],
               norec_decode_ticks=norec['decode_ticks'])
    return {'replica_crash': run['launches']['flash_decode_paged'],
            'replica_crash_norec': norec['launches']['flash_decode_paged']}


def _chaos_seams(torch, ddp, tmp, trace, tick, twin):
    """handoff_crash, probe_blackhole, prefill_crash: one run each; every
    delivered stream equals the twin's, the terminals partition."""
    from distributed_dot_product_tpu_torch.obs.events import read_events
    from distributed_dot_product_tpu_torch.serve import (
        RouterConfig, load_trace,
    )
    launches = {}
    run = _chaos_run(torch, ddp, tmp, 'handoff', trace, tick,
                     plan=dict(crash_in_handoff='r1'))
    lost = _chaos_events(run, 'replica.lost')
    check(len(lost) == 1 and lost[0]['target'] == 'r1'
          and lost[0]['reason'] == 'handoff_crash',
          f'handoff_crash: replica.lost events {lost}')
    check(_chaos_events(run, 'fault.inject', kind='handoff_crash'),
          'handoff_crash: no fault.inject')
    # The request whose handoff crashed r1 is re-placed on the survivor in
    # the same submit: its route is the first one after the loss and r1's
    # recoveries (policy 'recovery'), and it goes to r0.
    after = [e for e in run['events'] if e['event'] == 'router.route'
             and e['seq'] > lost[0]['seq'] and e['policy'] != 'recovery']
    check(after and after[0]['target'] == 'r0'
          and after[0]['policy'] == 'load',
          f'handoff_crash: first route after the loss {after[:1]}')
    _chaos_partition('handoff_crash', run)
    compared, full = _chaos_streams('handoff_crash', run, twin)
    _chaos_row('handoff_crash', run, twin, replica_lost=[
        {k: lost[0][k] for k in ('target', 'reason', 'in_flight')}],
               fallback_request=after[0]['request_id'],
               streams_compared=compared, streams_equal_in_full=full)
    launches['handoff_crash'] = run['launches']['flash_decode_paged']

    run = _chaos_run(torch, ddp, tmp, 'blackhole', trace, tick,
                     plan=dict(probe_blackhole='r1'))
    lost = _chaos_events(run, 'replica.lost')
    misses = [e['misses'] for e in _chaos_events(run, 'replica.probe',
                                                 target='r1',
                                                 state='missed')]
    check(len(lost) == 1 and lost[0]['target'] == 'r1'
          and lost[0]['reason'] == 'probe_timeout'
          and misses == [1, 2, 3],
          f'probe_blackhole: replica.lost {lost}, misses {misses}')
    check(len(_chaos_events(run, 'fault.inject',
                            kind='probe_blackhole')) == 1,
          'probe_blackhole: not announced once')
    _chaos_partition('probe_blackhole', run)
    compared, full = _chaos_streams('probe_blackhole', run, twin)
    _chaos_row('probe_blackhole', run, twin, replica_lost=[
        {k: lost[0][k] for k in ('target', 'reason', 'in_flight')}],
               probe_misses=misses, streams_compared=compared,
               streams_equal_in_full=full)
    launches['probe_blackhole'] = run['launches']['flash_decode_paged']

    run = _chaos_run(torch, ddp, tmp, 'prefill', trace, tick,
                     plan=dict(prefill_crash=CHAOS_PREFILL_TICK))
    check(run['kills'] == [('prefill', CHAOS_PREFILL_TICK)],
          f'prefill_crash: kills (member, loop tick) {run["kills"]}')
    plost = _chaos_events(run, 'prefill.lost')
    check(len(plost) == 1 and plost[0]['reason'] == 'probe_timeout'
          and run['router'].pool.prefill is None,
          f'prefill_crash: prefill.lost {plost}')
    check(not _chaos_events(run, 'replica.lost'),
          'prefill_crash: a decode replica was lost')
    handoffs = run['router'].registry.snapshot()['counters'].get(
        'router.handoffs', 0)
    # Every long prompt routed after the kill prefilled flat on its
    # replica: no handoff names it (the pool's torn log holds the
    # handoffs made before the kill), and none waited for the loss to be
    # declared.
    killed = _chaos_events(run, 'fault.inject', kind='prefill_crash')
    check(len(killed) == 1, f'prefill_crash: fault.inject {killed}')
    prompts = {a.request_id: a.prompt for a in load_trace(trace)}
    threshold = RouterConfig().prefill_threshold
    flat_after = sorted(
        e['request_id'] for e in run['events']
        if e['event'] == 'router.route' and e['ts'] > killed[0]['ts']
        and len(prompts[e['request_id']]) - 1 >= threshold)
    handed = {e['request_id'] for e in read_events(
        dict(run['logs'])['prefill']) if e['event'] == 'prefill.handoff'}
    check(flat_after and not handed & set(flat_after),
          f'prefill_crash: long prompts after the kill {flat_after}, '
          f'handed off {sorted(handed & set(flat_after))}')
    _chaos_partition('prefill_crash', run)
    compared, full = _chaos_streams('prefill_crash', run, twin)
    _chaos_row('prefill_crash', run, twin,
               plan={'prefill_crash': CHAOS_PREFILL_TICK},
               kills=run['kills'],
               prefill_lost=[{k: plost[0][k] for k in ('target',
                                                       'reason')}],
               handoffs_before_kill=handoffs,
               long_prompts_flat_after_kill=flat_after,
               streams_compared=compared, streams_equal_in_full=full)
    launches['prefill_crash'] = run['launches']['flash_decode_paged']
    return launches


def _chaos_corrupt(torch, ddp, tmp, trace, tick, twin):
    """page_corrupt: the flip caught by the every-tick scrub before any
    poisoned token is delivered, the page quarantined, its riders healed,
    every delivered stream the twin's; the checksums-off twin delivers a
    wrong stream; the doctor names r0."""
    victim, page_index, at = CHAOS_CORRUPT
    scrub = dict(integrity_interval=0.0)
    run = _chaos_run(torch, ddp, tmp, 'corrupt', trace, tick,
                     plan=dict(page_corrupt=CHAOS_CORRUPT),
                     router_kw=scrub, flight=True)
    flips = run['sched'].corrupted
    corrupt = _chaos_events(run, 'kv.corrupt')
    check(len(flips) == 1, f'page_corrupt: flips landed {flips}')
    _, page, flip_tick = flips[0]
    check(len(corrupt) >= len(flips) and corrupt[0]['target'] == victim
          and page in corrupt[0]['pages'],
          f'page_corrupt: kv.corrupt {corrupt} for the flip of page {page}')
    r0 = next(r for r in run['router'].pool.replicas if r.name == victim)
    check(page in r0.engine.pool.quarantined,
          f'page_corrupt: page {page} not quarantined')
    healed = [e['request_id'] for e in
              _chaos_events(run, 'request.recovered', reason='kv_corrupt',
                            requeued=True)]
    check(healed, 'page_corrupt: the flip had no victim to heal')
    _chaos_partition('page_corrupt', run)
    compared, full = _chaos_streams('page_corrupt', run, twin)
    doctor = _chaos_doctor('page_corrupt', run, 'kv_corrupt')
    check(doctor == {'primary': 'kv_corruption', 'replica': victim},
          f'page_corrupt: doctor says {doctor}')
    rc, out, err = _obs_cli('validate', dict(run['logs'])['router'],
                            '--require',
                            'kv.corrupt,fault.inject,request.recovered')
    check(rc == 0, f'page_corrupt: obs validate router log: {out}{err}')
    nointeg = _chaos_run(torch, ddp, tmp, 'corrupt_nointeg', trace, tick,
                         plan=dict(page_corrupt=CHAOS_CORRUPT),
                         kv_checksums=False)
    check(len(nointeg['sched'].corrupted) == 1,
          'page_corrupt_nointeg: the flip did not land')
    _, _, wrong = _chaos_diverged(nointeg, twin)
    check(wrong, 'page_corrupt_nointeg: no wrong stream was delivered: the '
                 'flip changed nothing the comparison can see')
    _chaos_row('page_corrupt', run, twin, plan={'page_corrupt': [
        victim, page_index, at]}, flipped_page=page, flip_tick=flip_tick,
               kv_corrupt=[{k: e[k] for k in ('target', 'pages', 'site')}
                           for e in corrupt],
               quarantined=sorted(r0.engine.pool.quarantined),
               streams_compared=compared, streams_equal_in_full=full,
               doctor=doctor, nointeg_wrong_streams=wrong,
               nointeg_goodput_pct=nointeg['goodput_pct'],
               nointeg_launches=nointeg['launches'])
    return {'page_corrupt': run['launches']['flash_decode_paged'],
            'page_corrupt_nointeg':
                nointeg['launches']['flash_decode_paged']}


def _control_history(run):
    return [{k: v for k, v in e.items() if k != 'seq'}
            for e in run['events']
            if e['event'] in ('control.adjust', 'control.scale',
                              'control.drain')]


def _chaos_control(torch, ddp, tmp, trace, tick, twin):
    """control: the Controller on the router scales up under the trace and
    down through drains in the idle tail, every request typed; a second
    run repeats the control history event for event; goodput beside the
    static topology's."""
    from distributed_dot_product_tpu_torch.obs.slo import SloSpec, goodput
    start = dict(decode_replicas=CHAOS_CONTROL_REPLICAS)
    runs = [_chaos_run(torch, ddp, tmp, f'control_{i}', trace, tick,
                       control=CHAOS_CONTROL, tail=CHAOS_TAIL, **start)
            for i in range(2)]
    static = _chaos_run(torch, ddp, tmp, 'static', trace, tick, **start)
    run = runs[0]
    history = _control_history(run)
    ups = [e for e in history if e['event'] == 'control.scale'
           and e['direction'] == 'up']
    downs = [e for e in history if e['event'] == 'control.scale'
             and e['direction'] == 'down']
    drains = [e for e in history if e['event'] == 'control.drain']
    check(ups and downs and len(drains) == len(downs),
          f'control: {len(ups)} scale-ups, {len(downs)} scale-downs, '
          f'{len(drains)} drains')
    retired = [r.name for r in run['router'].pool.retired]
    for i, e in enumerate(history):
        if e['event'] == 'control.scale' and e['direction'] == 'down':
            check(i and history[i - 1]['event'] == 'control.drain'
                  and history[i - 1]['target'] == e['target']
                  and e['target'] in retired,
                  f'control: scale-down of {e["target"]} without its drain '
                  f'(drained and retired: {retired})')
    for r in runs + [static]:
        _chaos_partition('control', r)
        _chaos_streams('control', r, twin)
    check(_control_history(runs[1]) == history,
          'control: the second run took another control history')
    load_slo = SloSpec(**LOAD_SLO)
    good = {name: goodput(r['logs'], load_slo).goodput_pct
            for name, r in (('controlled', run), ('static', static))}
    # The CPU rehearsal at these shapes (the schedule reads no token
    # values) puts the controlled topology above the static one under
    # LOAD_SLO; the card must keep that order.
    check(good['controlled'] > good['static'],
          f'control: goodput under {LOAD_SLO} {good}')
    _chaos_row('control', run, twin, control=CHAOS_CONTROL,
               start_replicas=CHAOS_CONTROL_REPLICAS,
               scale_ups=len(ups), scale_downs=len(downs),
               adjusts=sum(e['event'] == 'control.adjust' for e in history),
               peak_replicas=max([CHAOS_CONTROL_REPLICAS]
                                 + [e['replicas'] for e in ups]),
               members=[r.name for r in run['router'].pool.replicas
                        + run['router'].pool.retired],
               retired=retired,
               second_run_same_history=True,
               static_goodput_pct=static['goodput_pct'],
               load_slo=LOAD_SLO, load_slo_goodput_pct=good,
               static_tokens_per_s=static['tokens_per_s'],
               static_ttft_p99_s=static['ttft_p99_s'],
               static_launches=static['launches'])
    return {'control': run['launches']['flash_decode_paged'],
            'control_again': runs[1]['launches']['flash_decode_paged'],
            'static': static['launches']['flash_decode_paged']}


def phase_chaos_serve(torch, ddp):
    """Chaos and control through the 1 x 2 topology on one card: a replica
    crash (and its no-recovery twin), a crash in the handoff, a probe
    blackhole, a prefill-pool crash, a page bit flip (and its
    checksums-off twin) and the controller (twice, beside the static
    topology), each against the crash-free single engine on the same
    seeded trace."""
    import tempfile
    from distributed_dot_product_tpu_torch.serve import (
        LoadGenConfig, default_tenants, generate_trace, save_trace,
    )
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix='chaos_serve_')
    try:
        cfg = LoadGenConfig(seed=LOAD_SEED, rate=LOAD_RATE,
                            requests=LOAD_REQUESTS, vocab=VOCAB,
                            tenants=default_tenants(2))
        trace = os.path.join(tmp, 'trace.json')
        save_trace(trace, generate_trace(cfg))
        tick = cfg.tick_seconds
        twin = _chaos_twin(torch, ddp, trace, tick,
                           os.path.join(tmp, 'twin.jsonl'))
        emit({'phase': 'chaos_serve', 'case': 'twin',
              'requests': LOAD_REQUESTS, 'ticks': twin['result'].ticks,
              'statuses': twin['report'].statuses,
              'goodput_pct': twin['goodput_pct'],
              'tokens_per_s': twin['tokens_per_s'],
              'ttft_p99_s': twin['ttft_p99_s'], 'wall_s': twin['wall_s']})
        launches = {}
        for case in (_chaos_crash, _chaos_seams, _chaos_corrupt,
                     _chaos_control):
            launches.update(case(torch, ddp, tmp, trace, tick, twin))
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({'phase': 'chaos_serve', 'case': 'done',
          'seconds': time.perf_counter() - t_phase})
    return {'launches': launches}


# The obs_serve configuration: serve_path's engine (8 slots, t_max 4096,
# the LM's widths, bf16, paged at 16, chunk 64) and burst. The prefill
# split runs on OBS_SPLIT_RANKS ranks of one card (gloo, host-staged
# all-gather), prefixes of OBS_SPLIT_ROWS rows (a build timed as the
# median of OBS_BUILD_REPS), OBS_GREEDY tokens after each adoption. The adaptive capture fires at the first fresh TTFT (a
# threshold of 0 s lies below any burst's p99) and records
# OBS_PROFILE_SECONDS; its cooldown outlasts the burst, so exactly one
# capture may fire.
OBS_SPLIT_RANKS = 2
OBS_SPLIT_ROWS = (17, 1000, 2047)
OBS_GREEDY = 64
OBS_BUILD_REPS = 3
OBS_PROFILE_SECONDS = 0.25
OBS_PROFILE_COOLDOWN = 3600.0
OBS_DEVICE = 'cuda'


def _k5p_kernel(name):
    """True for a trace event name of the paged decode kernel (K5p):
    ``flash_decode_kernel<D, DV, true, …>``, demangled or mangled."""
    return bool(
        re.search(r'flash_decode_kernel<\d+,\s*\d+,\s*true', name)
        or re.search(r'flash_decode_kernelILi\d+ELi\d+ELb1E', name))


def _obs_split_run(torch, ddp, rank, dev):
    """A rank of obs_serve's prefill split: each prefix built by the
    OBS_SPLIT_RANKS-rank PrefillPool, by a one-rank pool and by an
    engine's ``register_prefix`` (pages compared bit for bit), then
    adopted by a paged engine and decoded OBS_GREEDY tokens beside the
    same prompt prefilled flat; the build's ms at each rank count."""
    import numpy as np
    from distributed_dot_product_tpu_torch.parallel.mesh import seq_mesh
    from distributed_dot_product_tpu_torch.serve import (
        PrefillPool, Scheduler, ServeConfig,
    )
    from distributed_dot_product_tpu_torch.utils import comm
    from distributed_dot_product_tpu_torch.utils.tracing import (
        MetricsRegistry,
    )
    kw = dict(t_max=SERVE_T_MAX, page_size=SERVE_PAGE, vocab=VOCAB,
              heads=HEADS, head_dim=HEAD_DIM, seed=SERVE_SEED,
              dtype=torch.bfloat16, prefill_chunk=SERVE_CHUNK, device=dev)
    pools = {OBS_SPLIT_RANKS: PrefillPool(mesh=seq_mesh(OBS_SPLIT_RANKS),
                                          **kw),
             1: PrefillPool(**kw)}
    registered = serve_engine(torch, 'paged', device=dev)
    rng = np.random.default_rng(SERVE_SEED)

    def build(pool, tokens, reps=OBS_BUILD_REPS):
        """The last of ``reps`` builds (the others released) and the
        median ms of a build."""
        times = []
        for i in range(reps):
            if i:
                pool.release(handle)
            comm.synchronize()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            handle = pool.build(tokens)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        return handle, statistics.median(times)

    def greedy(engine, submit, prefix_id=None):
        with Scheduler(engine, ServeConfig(watchdog=False,
                                           max_new_tokens=OBS_GREEDY),
                       registry=MetricsRegistry(), fault_injector=False) as s:
            r = s.submit(submit, prefix_id=prefix_id,
                         max_new_tokens=OBS_GREEDY)
            return list(s.run_until_idle()[r.id].tokens)

    for pool in pools.values():         # first use of every operation
        pool.release(build(pool, np.ones(SERVE_CHUNK, np.int64), 1)[0])
    out = {}
    for n in OBS_SPLIT_ROWS:
        prompt = rng.integers(0, VOCAB, size=n + 1).astype(np.int32)
        handles, ms = {}, {}
        for w, pool in pools.items():
            handles[w], ms[w] = build(pool, prompt[:n])
        reg_id = registered.register_prefix(prompt[:n])
        pages, _ = registered._prefix_registry[reg_id]
        split, one = pools[OBS_SPLIT_RANKS], pools[1]
        hs, h1 = handles[OBS_SPLIT_RANKS], handles[1]
        same = {'one_rank': True, 'register_prefix': True}
        for name in ('k_pool', 'v_pool'):
            got = getattr(split.engine.cache, name)[hs.pages]
            same['one_rank'] &= bool(torch.equal(
                got, getattr(one.engine.cache, name)[h1.pages]))
            same['register_prefix'] &= bool(torch.equal(
                got, getattr(registered.cache, name)[pages]))
        dec = serve_engine(torch, 'paged', device=dev)
        pid = dec.adopt_prefix(split.engine.cache, hs.pages, hs.length,
                               src_checksums=split.engine.checksums)
        adopted = greedy(dec, list(prompt[n:]), pid)
        flat = greedy(serve_engine(torch, 'paged', device=dev), list(prompt))
        for w, pool in pools.items():
            pool.release(handles[w])
        registered.unregister_prefix(reg_id)
        out[n] = {'pages': len(hs.pages), 'bit_identical': same,
                  'greedy_equal': adopted == flat, 'greedy_tokens':
                  len(adopted), 'build_ms': {str(w): ms[w] for w in ms}}
        del dec
        torch.cuda.empty_cache()
    return out


def _obs_split(torch):
    """(a) The prefill split on OBS_SPLIT_RANKS ranks of the card."""
    ranks, secs, backend = _spawn_ranks(torch, 'obs_serve', '_obs_split_run',
                                        timeout=600, world=OBS_SPLIT_RANKS)
    row = {'phase': 'obs_serve', 'case': 'prefill_split',
           'ranks': OBS_SPLIT_RANKS, 'backend': backend, 'seconds': secs,
           'by_rank': ranks}
    emit(row)
    for rank, cases in ranks.items():
        for n, c in cases.items():
            check(all(c['bit_identical'].values()),
                  f'prefill_split rank {rank}, {n} rows: pages differ '
                  f'{c["bit_identical"]}')
            check(c['greedy_equal'] and c['greedy_tokens'] == OBS_GREEDY,
                  f'prefill_split rank {rank}, {n} rows: the adopted '
                  f'stream is not the flat prefill\'s')
    return row


def _http(url):
    """``(status, body)`` of a GET on the local exporter."""
    import urllib.error
    import urllib.request
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _obs_burst(torch, ddp, tmp):
    """(b)–(d): the burst through the Scheduler with the device monitor
    polling, the adaptive capture armed and the exporter serving; the
    endpoints scraped while the capture runs."""
    import numpy as np
    from distributed_dot_product_tpu_torch.obs import (
        DeviceMonitor, MetricsServer, ProfileCapture, collecting,
    )
    from distributed_dot_product_tpu_torch.obs.events import (
        EventLog, read_events,
    )
    from distributed_dot_product_tpu_torch.obs.flight import (
        FlightRecorder, load_bundle,
    )
    from distributed_dot_product_tpu_torch.serve import (
        RejectedError, Scheduler, ServeConfig,
    )
    from distributed_dot_product_tpu_torch.utils.tracing import (
        MetricsRegistry,
    )
    engine = serve_engine(torch, 'paged', device=OBS_DEVICE)
    engine.step(np.zeros(engine.slots, np.int32), np.ones(engine.slots, bool))
    for i in range(engine.slots):
        engine.reset(i)
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in (engine.cache.k_pool, engine.cache.v_pool))
    registry = MetricsRegistry()
    prof = ProfileCapture(os.path.join(tmp, 'profile'), registry=registry,
                          max_seconds=OBS_PROFILE_SECONDS)
    log = EventLog(os.path.join(tmp, 'events.jsonl'))
    sched = Scheduler(engine, ServeConfig(
        queue_limit=SERVE_QUEUE, max_new_tokens=SERVE_NEW,
        profile_ttft_p99=0.0, profile_seconds=OBS_PROFILE_SECONDS,
        profile_cooldown=OBS_PROFILE_COOLDOWN, profile_warmup=True),
        registry=registry, fault_injector=False, profiler=prof,
        event_log=log)
    mon = DeviceMonitor(registry, interval=0.02)
    server = MetricsServer(registry, health=sched.health, profiler=prof,
                           flight=FlightRecorder(os.path.join(tmp, 'flight'),
                                                 registry=registry))
    probes = {}

    def on_tick(s):
        # While the capture runs: scrape every endpoint once.
        if probes or not prof.busy:
            return
        mon.poll_once()
        probes['profile'] = _http(server.url + '/profile?seconds=0.1')[0]
        probes['metrics'] = _http(server.url + '/metrics')
        probes['healthz'] = _http(server.url + '/healthz')[0]
        code, body = _http(server.url + '/dump?reason=obs_serve')
        probes['dump'] = (code, json.loads(body).get('path'))
    sched.on_tick = on_tick
    burst = serve_burst()
    ddp.flash_decode_paged.launches = 0
    t0 = time.perf_counter()
    try:
        mon.start()
        server.start()
        with collecting():
            for i, (rid, prompt) in enumerate(burst):
                try:
                    sched.submit(prompt, request_id=rid)
                except RejectedError:
                    pass
                if i % 4 == 3:
                    sched.step()
            results = sched.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ddp.flash_decode_paged.launches
        check(prof.join(120), 'the profile capture did not land')
    finally:
        sched.close()
        mon.stop()
        server.stop()
        log.close()
    snap = registry.snapshot()
    counters, gauges = snap['counters'], snap['gauges']
    steps = counters.get('serve.decode_steps', 0)
    check(launches == steps and steps > 0,
          f'obs_serve: K5p launched {launches} times for {steps} decode '
          f'steps')
    tokens = counters.get('serve.tokens_generated', 0)
    # (b) the device monitor.
    in_use, peak, limit = (gauges.get(f'device.memory.{k}{{device=cuda:0}}')
                           for k in ('bytes_in_use', 'peak_bytes_in_use',
                                     'bytes_limit'))
    devmon = {'bytes_in_use': in_use, 'peak_bytes_in_use': peak,
              'bytes_limit': limit, 'cache_bytes': cache_bytes,
              'devices_reporting': gauges.get(
                  'device.memory.devices_reporting'),
              'polls': counters.get('device.memory.polls')}
    # (c) the capture.
    events = [r for r in read_events(log.path)
              if r.get('event') == 'profile.capture']
    captures = counters.get('profile.captures', 0)
    names, k5p = set(), 0
    if events:
        with open(os.path.join(events[0]['path'], 'trace.json')) as f:
            trace = json.load(f)['traceEvents']
        for e in trace:
            name = e.get('name', '')
            names.add(name)
            k5p += e.get('cat') == 'kernel' and _k5p_kernel(name)
    spans = sorted(n for n in ('serve.decode_step', 'engine.decode_step',
                               'engine.prefill') if n in names)
    capture = {'captures': captures,
               'triggers': counters.get('serve.profile_triggers', 0),
               'events': [{k: e.get(k) for k in ('trigger', 'seconds',
                                                  'ttft_p99', 'threshold')}
                          for e in events],
               'trace_events': len(names) and len(trace),
               'k5p_kernel_events': k5p, 'span_names': spans}
    # (d) the exporter.
    metrics_code, metrics = probes.get('metrics', (None, ''))
    dump_code, bundle = probes.get('dump', (None, None))
    exporter = {
        'profile_status_during_capture': probes.get('profile'),
        'metrics_status': metrics_code,
        'metrics_has': {
            'ttft_summary': 'ddp_serve_ttft_seconds{quantile="0.99"}'
                            in metrics,
            'device_gauges': 'ddp_device_memory_bytes_in_use{device='
                             '"cuda:0"}' in metrics,
            'build_info': 'ddp_build_info{' in metrics},
        'healthz_status': probes.get('healthz'),
        'dump_status': dump_code,
        'dump_bundle_files': (sorted(load_bundle(bundle)['manifest']['files'])
                              if dump_code == 200 else None)}
    row = {'phase': 'obs_serve', 'case': 'burst', 'requests': len(burst),
           'completed': sum(r.status == 'completed'
                            for r in results.values()),
           'tokens_generated': tokens, 'decode_steps': steps,
           'wall_s': wall, 'tokens_per_s': tokens / wall,
           'ttft_s': {k: snap['histograms']['serve.ttft_seconds'][k]
                      for k in ('p50', 'p99')},
           'launches': {'flash_decode_paged': launches},
           'devmon': devmon, 'capture': capture, 'exporter': exporter}
    emit(row)
    check(devmon['devices_reporting'] == 1,
          f'devmon: {devmon["devices_reporting"]} devices reporting')
    check(in_use is not None and 0 < in_use <= limit,
          f'devmon: bytes_in_use {in_use} against the limit {limit}')
    check(peak is not None and peak >= cache_bytes,
          f'devmon: peak {peak} below the engine cache\'s {cache_bytes}')
    check(captures == 1 and capture['triggers'] == 1 and len(events) == 1,
          f'profile: {captures} captures, {capture["triggers"]} triggers, '
          f'{len(events)} events (one expected)')
    check(k5p >= 1, 'profile: the trace holds no K5p kernel event')
    check(spans, 'profile: the trace holds no serving span')
    check(exporter['profile_status_during_capture'] == 409,
          f'exporter: /profile answered '
          f'{exporter["profile_status_during_capture"]} during the capture')
    check(metrics_code == 200 and all(exporter['metrics_has'].values()),
          f'exporter: /metrics {metrics_code} {exporter["metrics_has"]}')
    check(exporter['healthz_status'] == 200,
          f'exporter: /healthz {exporter["healthz_status"]}')
    check(dump_code == 200 and exporter['dump_bundle_files'],
          f'exporter: /dump {dump_code}')
    return row


def _obs_perf(torch):
    """(e) A perf snapshot of every registered entrypoint on the card:
    measured ms beside the model's, the model's share at most 1, and the
    kernel work of the kernel entries what this script's own bound
    arithmetic counts for their inputs."""
    import numpy as np
    perf_mod = perf()
    snap = perf_mod.snapshot(device=OBS_DEVICE)
    entries = snap['entries']
    errors = {n: e['error'] for n, e in entries.items() if 'error' in e}
    table = {n: {'model_ms': 1e3 * e['model_seconds'],
                 'measured_ms': 1e3 * e['measured_seconds'],
                 'share': e['fraction_of_roofline'],
                 'flops': e['flops'], 'bytes': e['bytes_accessed'],
                 'peak_bytes': e['peak_bytes'],
                 'first_call_s': e['first_call_seconds'],
                 'kernels': e['kernels']}
             for n, e in entries.items() if 'error' not in e}
    # The kernel entries' inputs, counted here: causal (b 1, 2 heads,
    # 16 rows, head dim 32) for K1 / K3 / K4; decode.step_paged_kernel's
    # two slots (fills 10 and 3, pages of 8, 2 kv heads) for K5p.
    from distributed_dot_product_tpu_torch.analysis.registry import HEAD_DIM
    d, nb, t = HEAD_DIM, 2, 16
    work = dict(d=d, q_rows=nb * t, kv_rows=nb * t,
                pairs=nb * causal_pairs(t, t, 0))
    fills, h = np.array([10, 3]), 2
    paged = perf_mod.decode_cost(
        d=d, q_rows=2 * h, new_rows=2 * h, rows_read=int(fills.sum()) * h,
        rows_appended=2 * h, cols=int((fills + 1).sum()) * h,
        table_entries=2 * 4)
    want = {
        'ops.flash_fwd_bf16': {'flash_attention':
                               perf_mod.attention_fwd_cost(**work)},
        'ops.flash_bwd_bf16': {
            'flash_attention': perf_mod.attention_fwd_cost(**work, lse=True),
            'flash_attention_dq': perf_mod.attention_dq_cost(**work),
            'flash_attention_dkv': perf_mod.attention_dkv_cost(**work)},
        'decode.step_paged_kernel': {'flash_decode_paged': paged}}
    agree = {}
    for name, kernels in want.items():
        got = table.get(name, {}).get('kernels', {})
        agree[name] = all(
            got.get(k, {}).get('calls') == 1
            and (got[k]['flops'], got[k]['bytes']) == tuple(v)
            for k, v in kernels.items())
    row = {'phase': 'obs_serve', 'case': 'perf', 'device': snap['device_kind'],
           'entries': table, 'errors': errors, 'kernel_counts_agree': agree,
           'peaks': snap['peaks']}
    emit(row)
    check(not errors, f'perf: entries failed on the card: {errors}')
    over = {n: e['share'] for n, e in table.items() if not e['share'] <= 1.0}
    check(not over, f'perf: model over measured above 1: {over}')
    check(all(agree.values()), f'perf: kernel counts differ: {agree}')
    return row


def phase_obs_serve(torch, ddp):
    """The rest of obs/ on the serving path: the prefill split (a), the
    device monitor (b), the adaptive capture (c) and the exporter (d)
    over serve_path's burst, then a perf snapshot of every registered
    entrypoint (e)."""
    import tempfile
    t_phase = time.perf_counter()
    split = _obs_split(torch)
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix='obs_serve_')
    try:
        burst = _obs_burst(torch, ddp, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    _obs_perf(torch)
    emit({'phase': 'obs_serve', 'case': 'done',
          'seconds': time.perf_counter() - t_phase})
    return {'launches': burst['launches']['flash_decode_paged'],
            'split': split}


# The port's static analysis and the harness twins (analysis_examples):
# the graph rules over every registry entry on the card, the retrace
# sentinel over serve_path's burst, then the four twins at the
# configurations their reference docstrings give for real hardware.
AE_DEVICE = 'cuda'
AE_KERNELS = ('flash_attention', 'flash_attention_bounded',
              'flash_attention_dq', 'flash_attention_dkv', 'flash_decode',
              'flash_decode_paged')
AE_LM = ('--seq-len', '32768', '--dim', '512', '--layers', '8', '--batch',
         '1', '--softmax-impl', 'flash')
AE_LM_STEPS = 50
AE_LM_CKPT = 25            # the mid-run checkpoint the resume starts from
AE_LM_RESUMED = 2          # steps the resumed run trains past it
AE_LONG_T = 131072         # example_longcontext's "real hardware" length
AE_SERVE_FAULTS = {'DDP_TPU_PAGED_CACHE': '1',
                   'DDP_TPU_FAULT_STUCK_STEP': '4',
                   'DDP_TPU_FAULT_NAN_DECODE_STEP': '7'}


def _ae_counts(ddp):
    return {n: getattr(ddp, n).launches for n in AE_KERNELS}


def _ae_zero(ddp):
    for n in AE_KERNELS:
        getattr(ddp, n).launches = 0


def _ae_twin(relpath):
    """A harness twin's module, imported from its file (its ``main(argv)``
    is the command line a user runs)."""
    import importlib.util
    here = os.path.dirname(os.path.abspath(__file__))
    name = 'twin_' + os.path.basename(relpath)[:-3]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(here, relpath))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ae_graph(torch, ddp):
    """(a) The graph rules (and the AST pass) over every registry entry
    on the card: the aten ops each entry issued, the kernels it launched,
    no active violation."""
    from distributed_dot_product_tpu_torch.analysis import (
        active_violations, run_analysis,
    )
    t0 = time.perf_counter()
    stats = {}
    _ae_zero(ddp)
    violations = run_analysis(device=AE_DEVICE, stats=stats)
    launches = _ae_counts(ddp)
    active = active_violations(violations)
    allowed = sorted({(v.entrypoint, v.rule) for v in violations
                      if v.allowed})
    row = {'phase': 'analysis_examples', 'case': 'graph_rules',
           'entries': len(stats),
           'per_entry': {n: {'ops': e['ops'], 'kernels': e.get('kernels',
                                                               {})}
                         for n, e in stats.items()},
           'active': [v.render() for v in active],
           'allowed': [list(a) for a in allowed],
           'launches': launches, 'seconds': time.perf_counter() - t0}
    emit(row)
    check(len(stats) == 32, f'graph rules ran {len(stats)} entries, not 32')
    check(not active, f'graph rules: {len(active)} active violations')
    for name in ('flash_attention', 'flash_attention_dq',
                 'flash_attention_dkv', 'flash_decode',
                 'flash_decode_paged'):
        check(launches[name] > 0, f'graph rules: {name} never launched')
    return row


def _ae_sentinel(torch, ddp):
    """(b) The retrace sentinel, raising, over serve_path's burst on the
    paged engine: every watched program within its budget, the decode
    step one signature for the whole burst."""
    from distributed_dot_product_tpu_torch.analysis import retrace
    t0 = time.perf_counter()
    old = os.environ.get(retrace.ENV_VAR)
    os.environ[retrace.ENV_VAR] = '1'
    try:
        retrace.reset()
        engine = serve_engine(torch, 'paged')
        _, burst = _serve_burst(torch, ddp, engine, serve_burst(),
                                'analysis_examples')
        totals = retrace.totals()
        budgets = {name: budget for name, (_, budget)
                   in retrace.snapshot().items()}
    finally:
        if old is None:
            os.environ.pop(retrace.ENV_VAR, None)
        else:
            os.environ[retrace.ENV_VAR] = old
    row = {'phase': 'analysis_examples', 'case': 'retrace_sentinel',
           'totals': totals, 'budgets': budgets,
           'decode_steps': burst['decode_steps'],
           'terminal': burst['terminal'], 'launches': burst['launches'],
           'seconds': time.perf_counter() - t0}
    emit(row)
    del engine
    torch.cuda.empty_cache()
    over = {n: c for n, c in totals.items() if c > budgets.get(n, 2)}
    check(not over, f'retrace budgets exceeded: {over}')
    check(totals.get('engine.decode') == 1,
          f"engine.decode counted {totals.get('engine.decode')}, not 1")
    check(burst['launches']['flash_decode_paged'] > 0,
          'sentinel burst: K5p never launched')
    return row


def _ae_train_lm(torch, ddp, tmp):
    """(c1) examples/torch_train_lm.py at its reference docstring's
    single-card configuration, checkpointing mid-run; then a run resumed
    from that checkpoint, whose steps must give the same losses."""
    mod = _ae_twin(os.path.join('examples', 'torch_train_lm.py'))
    whole_dir = os.path.join(tmp, 'lm_whole')
    _ae_zero(ddp)
    t0 = time.perf_counter()
    whole = mod.main(['--device', AE_DEVICE, *AE_LM, '--steps',
                      str(AE_LM_STEPS), '--generate', '--ckpt-dir',
                      whole_dir, '--ckpt-every', str(AE_LM_CKPT),
                      '--log-every', '10'])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _ae_counts(ddp)
    # The resume: a fresh root holding the mid-run checkpoint only.
    resume_dir = os.path.join(tmp, 'lm_resume')
    os.makedirs(resume_dir)
    shutil.copytree(os.path.join(whole_dir, f'step_{AE_LM_CKPT:09d}'),
                    os.path.join(resume_dir, f'step_{AE_LM_CKPT:09d}'))
    t0 = time.perf_counter()
    resumed = mod.main(['--device', AE_DEVICE, *AE_LM, '--steps',
                        str(AE_LM_CKPT + AE_LM_RESUMED), '--ckpt-dir',
                        resume_dir, '--ckpt-every', str(AE_LM_CKPT),
                        '--log-every', '1'])
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    pairs = {i: (whole['losses'].get(i), resumed['losses'].get(i))
             for i in range(AE_LM_CKPT, AE_LM_CKPT + AE_LM_RESUMED)}
    losses = whole['losses']
    row = {'phase': 'analysis_examples', 'case': 'torch_train_lm',
           'argv': [*AE_LM, '--steps', str(AE_LM_STEPS), '--generate'],
           'seconds': seconds,
           'loss_first': losses.get(0), 'loss_last': whole['loss'],
           'losses_every_10': {i: losses[i] for i in sorted(losses)
                               if i % 10 == 0 or i == len(losses) - 1},
           'copy_accuracy': whole['acc'], 'resumed_from':
           resumed['resumed_from'], 'resume_seconds': resume_s,
           'resumed_vs_whole': pairs, 'launches': launches}
    emit(row)
    check(all(v == v and abs(v) != float('inf') for v in losses.values()),
          'train_lm: a loss is not finite')
    check(len(losses) == AE_LM_STEPS,
          f'train_lm ran {len(losses)} steps, not {AE_LM_STEPS}')
    check(resumed['resumed_from'] == AE_LM_CKPT,
          f"train_lm resumed from {resumed['resumed_from']}")
    check(all(a is not None and a == b for a, b in pairs.values()),
          f'train_lm: resumed losses differ: {pairs}')
    for name in ('flash_attention', 'flash_attention_dq',
                 'flash_attention_dkv', 'flash_decode'):
        check(launches[name] > 0, f'train_lm: {name} never launched')
    return row


def _ae_longcontext(torch, ddp, tmp):
    """(c2) torch_example_longcontext.py at the length its reference
    docstring gives for real hardware, in bf16."""
    mod = _ae_twin('torch_example_longcontext.py')
    _ae_zero(ddp)
    t0 = time.perf_counter()
    res = mod.main(['--device', AE_DEVICE, '--seq-len', str(AE_LONG_T),
                    '--ckpt-dir', os.path.join(tmp, 'long')])
    torch.cuda.synchronize()
    row = {'phase': 'analysis_examples', 'case': 'torch_example_longcontext',
           'seq_len': AE_LONG_T, 'seconds': time.perf_counter() - t0,
           'train_seconds': res['train_seconds'], 'losses': res['losses'],
           'ms_per_token': res.get('ms_per_token'),
           'launches': _ae_counts(ddp)}
    emit(row)
    check(res['exit_code'] == 0 and res.get('decode_finite'),
          'longcontext: the run or its decode failed')
    check(all(v == v for v in res['losses'].values()),
          'longcontext: a loss is not finite')
    check(row['launches']['flash_attention'] > 0
          and row['launches']['flash_decode'] > 0,
          'longcontext: K1 or K5 never launched')
    return row


def _ae_example(torch, ddp):
    """(c3) torch_example.py at the reference workload."""
    mod = _ae_twin('torch_example.py')
    _ae_zero(ddp)
    t0 = time.perf_counter()
    res = mod.main(['--device', AE_DEVICE])
    torch.cuda.synchronize()
    row = {'phase': 'analysis_examples', 'case': 'torch_example',
           'seconds': time.perf_counter() - t0, 'losses': res['losses'],
           'launches': _ae_counts(ddp)}
    emit(row)
    check(res['ok'], 'torch_example: a loss is not finite')
    return row


def _ae_serve(torch, ddp):
    """(c4) examples/torch_serve_lm.py, 24 requests, stuck step and NaN
    decode injected, the bit-identity rerun, on the paged cache."""
    mod = _ae_twin(os.path.join('examples', 'torch_serve_lm.py'))
    saved = {k: os.environ.get(k) for k in AE_SERVE_FAULTS}
    os.environ.update(AE_SERVE_FAULTS)
    _ae_zero(ddp)
    t0 = time.perf_counter()
    summary = {}
    try:
        rc = mod.main(['--device', AE_DEVICE, '--requests', '24',
                       '--check-identical'], summary=summary)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.synchronize()
    row = {'phase': 'analysis_examples', 'case': 'torch_serve_lm',
           'rc': rc, 'env': AE_SERVE_FAULTS, 'seconds':
           time.perf_counter() - t0, **summary,
           'launches': _ae_counts(ddp)}
    emit(row)
    check(rc == 0, f'serve_lm audit failed: {summary.get("failures")}')
    check(row['launches']['flash_decode_paged'] > 0,
          'serve_lm: K5p never launched')
    return row


def phase_analysis_examples(torch, ddp):
    """The port's analysis on the card (a) and under a serving burst (b),
    then the four harness twins (c). Returns each sub-run's launches."""
    import tempfile
    t_phase = time.perf_counter()
    rows = {'graph_rules': _ae_graph(torch, ddp)}
    torch.cuda.empty_cache()
    rows['retrace_sentinel'] = _ae_sentinel(torch, ddp)
    tmp = tempfile.mkdtemp(prefix='analysis_examples_')
    try:
        rows['torch_train_lm'] = _ae_train_lm(torch, ddp, tmp)
        torch.cuda.empty_cache()
        rows['torch_example_longcontext'] = _ae_longcontext(torch, ddp, tmp)
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows['torch_example'] = _ae_example(torch, ddp)
    torch.cuda.empty_cache()
    rows['torch_serve_lm'] = _ae_serve(torch, ddp)
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t_phase
    emit({'phase': 'analysis_examples', 'case': 'done', 'seconds': seconds,
          'by_case': {k: r['seconds'] for k, r in rows.items()}})
    return {name: {k: r['launches'].get(k, 0) for k in AE_KERNELS}
            for name, r in rows.items()}


# The benchmark_cli phase: the port's measurement CLIs run as a user types
# them, one subprocess each (as scripts/run_sweeps.py runs the
# reference's): (name, row kind, torch_benchmark.py arguments, kernels the
# run must launch). The matmul runs launch none (cuBLAS products).
BC_TRAIN_KERNELS = ('flash_attention', 'flash_attention_dq',
                    'flash_attention_dkv')
BC_RUNS = (
    ('nt_bf16', 'nt', ('--mode', 'nt', '--dtype', 'bf16'), ()),
    ('all_bf16', 'nt', ('--mode', 'all', '--dtype', 'bf16'), ()),
    ('tn_bf16', 'nt', ('--mode', 'tn', '--dtype', 'bf16'), ()),
    ('nt_f32', 'nt', ('--mode', 'nt'), ()),
    # The kernel rows in bf16 (the default, float32, computes in float32:
    # attn_f32 runs it); the engine rows run float32 whatever --dtype says,
    # as the reference's engines do.
    ('attn', 'attn', ('--mode', 'attn', '--dtype', 'bf16'),
     ('flash_attention',)),
    ('attn_f32', 'attn', ('--mode', 'attn'), ('flash_attention',)),
    ('train', 'train', ('--mode', 'train', '--dtype', 'bf16'),
     BC_TRAIN_KERNELS),
    ('lm', 'lm', ('--mode', 'lm', '--dtype', 'bf16'), BC_TRAIN_KERNELS),
    # Two ranks on the one card exchange each gathered slab through the
    # host (gloo): the README's --offset 1000 keeps that to 75 exchanges
    # a call (the default 32, 2,344, takes ~2.3 s a call).
    ('nt_bf16_2ranks', 'nt_skip_local',
     ('--mode', 'nt', '--dtype', 'bf16', '--devices', '2', '--skip-local',
      '--offset', '1000'), ()),
    ('decode_kernel', 'decode', ('--mode', 'decode', '--decode-impl',
                                 'kernel', '--dtype', 'bf16'),
     ('flash_decode',)),
    ('decode_plain', 'decode', ('--mode', 'decode', '--decode-impl', 'xla',
                                '--dtype', 'bf16'), ('flash_attention',)),
    ('decode_spec_ngram', 'decode_spec', ('--mode', 'decode', '--spec',
                                          'ngram'), ('flash_decode',)),
    ('decode_kv_shards_4', 'decode_kv_shards',
     ('--mode', 'decode', '--kv-shards', '4'), ('flash_decode_paged',)),
    ('decode_serve_slab', 'decode_serve', ('--mode', 'decode-serve'),
     ('flash_decode',)),
    ('decode_serve_paged', 'decode_serve_paged',
     ('--mode', 'decode-serve', '--cache-mode', 'paged'),
     ('flash_decode_paged',)),
    ('serve_load', 'serve_load', ('--mode', 'serve-load'),
     ('flash_decode',)),
)
BC_SMOKES = ('torch_smoke_router.sh', 'torch_smoke_chaos.sh',
             'torch_smoke_corrupt.sh')
# The runs the smoke twins run beside: GPU-bound work of 11 ms and more a
# call (the products; attention at T 75000; the train and lm steps at T
# 16384), where the smokes' host load and microsecond kernels do not
# show (nt_bf16's 2,344-slab loop is host-paced, and runs alone; so does
# the gloo exchange of nt_bf16_2ranks). The smokes take longer than the
# products alone: these runs fill that time.
BC_BESIDE_SMOKES = ('all_bf16', 'tn_bf16', 'nt_f32', 'attn', 'attn_f32',
                    'train', 'lm')
# Float32 products outside the tensor cores (torch's default: no TF32): the
# H100 SXM's published 67 TFLOP/s (the bf16 peak is obs/perf.py's).
FP32_PEAK = 67e12


def _bc_here(*parts):
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), *parts)


# A process start on the card's host spends ~9 s importing torch (9.2 s
# of a 9.7 s import of torch_benchmark.py, measured there), so the phase's
# runs are children forked from one process that imported torch and the
# twins once and never touches the card: each child runs its script as the
# command line would (runpy, as __main__, its argv), its output to a log
# of its own, and exits with the script's status.
_BC_FORKS = r"""
import json, os, runpy, sys, traceback
sys.path.insert(0, sys.argv[1])
import torch_bench, torch_benchmark  # noqa: F401  imported once
for line in sys.stdin:
    script, argv, log = json.loads(line)
    pid = os.fork()
    if pid == 0:
        code = 1
        try:
            fd = os.open(log, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
            os.dup2(fd, 1)
            os.dup2(fd, 2)
            sys.argv = [script, *argv]
            runpy.run_path(script, run_name='__main__')
            code = 0
        except SystemExit as exc:
            code = exc.code if isinstance(exc.code, int) else int(
                exc.code is not None)
        except BaseException:
            traceback.print_exc()
        finally:
            sys.stdout.flush()
            sys.stderr.flush()
            os._exit(code)
    _, status = os.waitpid(pid, 0)
    print(os.waitstatus_to_exitcode(status), flush=True)
"""


def _bc_forks():
    """The fork server of the phase's runs (:data:`_BC_FORKS`)."""
    return subprocess.Popen([sys.executable, '-c', _BC_FORKS, _bc_here()],
                            cwd=_bc_here(), stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True)


def _bc_run(forks, what, script, argv, tmp, timeout=900):
    """``python <script> <argv>`` as a child of ``forks``; fails the phase
    on a non-zero exit. Returns ``(its output, seconds)``."""
    import select
    log = os.path.join(tmp, f'{what}.log')
    t0 = time.perf_counter()
    forks.stdin.write(json.dumps([_bc_here(script), list(argv), log]) + '\n')
    forks.stdin.flush()
    ready, _, _ = select.select([forks.stdout], [], [], timeout)
    check(ready, f'benchmark_cli {what}: no exit within {timeout} s')
    status = forks.stdout.readline().strip()
    seconds = time.perf_counter() - t0
    with open(log) as f:
        out = f.read()
    check(status == '0', f'benchmark_cli {what}: exit {status or "lost"} '
                         f'after {seconds:.1f} s:\n{out[-3000:]}')
    return out, seconds


def _bc_matmul_bound(row):
    """The least time of one timed call of nt / all / tn at the row's
    shape: the larger of the 2·T²·768 products at the dtype's peak and
    the operands read once (the output is a scalar) at 3.35 TB/s.
    Returns ``(ms, bound_by, peak FLOP/s)``."""
    t, d = row['T'], row['dim']
    elem = 2 if row['dtype'] == 'bf16' else 4
    peaks = perf().DEFAULT_PEAKS
    peak = peaks.flops_per_s if row['dtype'] == 'bf16' else FP32_PEAK
    left = t * d if row['mode'] == 'nt' else t * t
    t_ops = 2.0 * t * t * d / peak
    t_bytes = (left + t * d) * elem / peaks.bytes_per_s
    return (1e3 * max(t_ops, t_bytes),
            'operations' if t_ops > t_bytes else 'bytes', peak)


def _bc_row(torch, forks, name, kind, argv, kernels, tmp):
    """One torch_benchmark.py run: exit 0, exactly one row, every key of
    the reference's row of its kind, on the card, and each named kernel
    launched."""
    import torch_benchmark
    path = os.path.join(tmp, f'{name}.json')
    _, seconds = _bc_run(forks, name, 'torch_benchmark.py',
                         [*argv, '--file', path], tmp)
    with open(path) as f:
        rows = json.load(f)
    check(len(rows) == 1, f'benchmark_cli {name}: {len(rows)} rows, not 1')
    row = rows[0]
    missing = sorted(set(torch_benchmark.REFERENCE_ROW_KEYS[kind])
                     - set(row))
    check(not missing, f'benchmark_cli {name}: the row lacks the '
                       f"reference's keys {missing}")
    check(row['platform'] == 'gpu'
          and row['device_kind'] == torch.cuda.get_device_name(0),
          f"benchmark_cli {name}: ran on {row['platform']} "
          f"{row['device_kind']}")
    launches = row['kernel_launches']
    for kernel in kernels:
        check(launches[kernel] > 0,
              f'benchmark_cli {name}: {kernel} never launched')
    # --dtype as the row records it (float32 by default, on the card as
    # on the CPU); the engines' float32 whatever --dtype says. A run that
    # computes in float32 launches the float32 kernels.
    flag = argv[argv.index('--dtype') + 1] if '--dtype' in argv else 'f32'
    if 'compute_dtype' in row:
        check(row['compute_dtype'] == flag,
              f"benchmark_cli {name}: compute_dtype {row['compute_dtype']} "
              f'for --dtype {flag}')
    if 'engine_dtype' in row:
        check(row['engine_dtype'] == 'f32',
              f"benchmark_cli {name}: engine_dtype {row['engine_dtype']}")
    f32_run = row.get('engine_dtype', row.get('compute_dtype')) == 'f32'
    for kernel in kernels:
        check(not f32_run or row['kernel_launches_f32'][kernel] > 0,
              f'benchmark_cli {name}: float32 run, float32 {kernel} never '
              f'launched')
    out = {'phase': 'benchmark_cli', 'case': name, 'argv': list(argv),
           'seconds': seconds, 'launches': launches,
           'launches_f32': row['kernel_launches_f32'],
           **{k: row[k] for k in ('compute_dtype', 'engine_dtype')
              if k in row}}
    if kind in ('nt', 'nt_skip_local'):
        ms, bound_by, peak = _bc_matmul_bound(row)
        out.update(T=row['T'], dtype=row['dtype'], world=row['world'],
                   bound_ms=ms, bound_by=bound_by,
                   dist_ms=row['dist_time'] * 1e3,
                   dist_gflops_per_chip=row['dist_gflops_per_chip'],
                   peak_gflops=peak / 1e9,
                   dist_memory_analysis=row['dist_memory_analysis'],
                   dist_peak_bytes_per_chip=row['dist_peak_bytes_per_chip'])
        # The ranks share the one card: together they do the whole work.
        check(row['dist_time'] * 1e3 >= ms,
              f"benchmark_cli {name}: {row['dist_time'] * 1e3:.4f} ms a "
              f'call, under the bound {ms:.4f} ms — the timing is not '
              f'fenced on the card')
        if 'local_time' in row:
            out.update(local_ms=row['local_time'] * 1e3,
                       local_gflops=row['local_gflops'])
            check(row['local_time'] * 1e3 >= ms,
                  f"benchmark_cli {name}: local {row['local_time'] * 1e3:.4f}"
                  f' ms under the bound {ms:.4f} ms')
    for key in ('T', 'step_time', 'tokens_per_s', 'ms_per_step',
                'ms_per_token', 'ttft_ms', 'prefill_ms', 'decode_impl',
                'bare_tokens_per_s', 'sched_tokens_per_s', 'slots',
                'completed', 'requests', 'goodput_pct', 'per_tenant',
                'ticks', 'capacity_tokens', 'decode_steps',
                'spec_speedup', 'accepted_per_step', 'dist_time',
                'step_gflops_per_chip', 'memory_analysis', 'perf_model'):
        if key in row and key not in out:
            out[key] = row[key]
    emit(out)
    if kind == 'decode_kv_shards':
        check(launches['flash_decode_paged']
              == row['kv_shards'] * row['decode_steps'],
              f"benchmark_cli {name}: K5p launched "
              f"{launches['flash_decode_paged']} times, not one a shard a "
              f"step ({row['kv_shards']} x {row['decode_steps']})")
    if name == 'decode_plain':
        check(launches['flash_decode'] == 0 and row['decode_impl'] == 'xla',
              'benchmark_cli decode_plain: the plain path launched K5')
    if kind.startswith('decode_serve') or kind == 'decode_spec':
        check(row['completed'] == row['requests'],
              f"benchmark_cli {name}: {row['completed']} of "
              f"{row['requests']} requests completed")
    if kind == 'decode_serve_paged':
        check(launches['flash_decode'] == 0,
              'benchmark_cli decode_serve_paged: the slab kernel launched')
    return out


def _bench_keys():
    """The keys of bench.py's JSON line and of its ``detail`` (its
    ``json.dumps`` literal, read from the source: bench.py imports
    JAX)."""
    import ast
    with open(_bc_here('bench.py')) as f:
        tree = ast.parse(f.read())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, 'attr', None) == 'dumps')
    line = call.args[0]
    names = [k.value for k in line.keys]
    return set(names), {k.value for k in line.values[
        names.index('detail')].keys}


def _bc_smokes_start():
    """The three smoke twins, started at once; :func:`_bc_smokes_wait`
    collects them. They count virtual time (no number here reads their
    clocks) and launch microsecond kernels, so they run beside the
    GPU-bound matmul runs."""
    return time.perf_counter(), {script: subprocess.Popen(
        ['bash', _bc_here('scripts', script)], cwd=_bc_here(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for script in BC_SMOKES}


def _bc_smokes_wait(started):
    """Each smoke twin must exit 0; every one is stopped either way."""
    t0, procs = started
    try:
        for script, proc in procs.items():
            stdout, _ = proc.communicate(timeout=900)
            emit({'phase': 'benchmark_cli', 'case': script,
                  'rc': proc.returncode,
                  'seconds': time.perf_counter() - t0,
                  'ok_lines': [ln for ln in stdout.splitlines()
                               if ' OK' in ln or ln.endswith(' OK')]})
            check(proc.returncode == 0,
                  f'benchmark_cli {script}: exit {proc.returncode}:\n'
                  f'{stdout[-3000:]}')
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def phase_benchmark_cli(torch):
    """torch_benchmark.py in every mode the reference's CLI has, on the
    card, each run a process of its own; torch_bench.py's line; the
    router, chaos and corrupt smoke twins (beside the matmul runs of
    :data:`BC_BESIDE_SMOKES`). Returns each run's kernel launches."""
    import gc
    import tempfile
    gc.collect()
    torch.cuda.empty_cache()          # the runs need the card's memory
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix='benchmark_cli_')
    launches = {}
    forks = _bc_forks()
    smokes = None
    try:
        for name, kind, argv, kernels in BC_RUNS:
            if name == BC_BESIDE_SMOKES[0]:
                smokes = _bc_smokes_start()
            out = _bc_row(torch, forks, name, kind, argv, kernels, tmp)
            launches[name] = {**out['launches'], **{
                f'{k}_f32': n for k, n in out['launches_f32'].items()}}
            if name == BC_BESIDE_SMOKES[-1]:
                started, smokes = smokes, None
                _bc_smokes_wait(started)
        stdout, seconds = _bc_run(forks, 'torch_bench', 'torch_bench.py',
                                  [], tmp)
        line = json.loads(stdout.strip().splitlines()[-1])
        keys, detail = _bench_keys()
        emit({'phase': 'benchmark_cli', 'case': 'torch_bench',
              'seconds': seconds, 'line': line})
        check(set(line) == keys and detail <= set(line['detail']),
              f"torch_bench.py's line lacks bench.py's keys: "
              f'{sorted(keys ^ set(line))} / '
              f"{sorted(detail - set(line['detail']))}")
        check(line['detail']['platform'] == 'gpu'
              and line['detail']['train_step_gflops'] is not None,
              'torch_bench.py did not run its card measurements')
    finally:
        if smokes is not None:            # a run failed inside the window
            for proc in smokes[1].values():
                proc.kill()
                proc.wait()
        forks.stdin.close()
        forks.wait(timeout=60)
        shutil.rmtree(tmp, ignore_errors=True)
    emit({'phase': 'benchmark_cli', 'case': 'done',
          'seconds': time.perf_counter() - t_phase,
          'launches': launches})
    for kernel in ('flash_attention', 'flash_attention_dq',
                   'flash_attention_dkv', 'flash_decode',
                   'flash_decode_paged'):
        check(sum(c[kernel] for c in launches.values()) > 0,
              f'benchmark_cli: {kernel} never launched')
    return launches


# The kernel_coverage phase: the widths, page sizes and K splits K1-K5p
# took only since the (d, d_v) grid (csrc/hopper.cuh FLASH_GRID). (d, d_v)
# pairs: widths no multiple of 8 or 16 (padded copies, narrow decode
# loads), d_v != d both ways, a pair between grid points, the grid's
# unpadded (192, 128) and its widest (256, 256).
COV_DIMS = ((8, 8), (24, 12), (16, 24), (64, 32), (80, 80), (160, 160),
            (192, 128), (128, 256), (256, 256))
# K5/K5p also at widths whose rows take each narrow path of
# csrc/flash_decode.cu: bf16 rows of 12 and 20 bytes (4-byte cp.async),
# 24 (8-byte), 14, 10, 6 and 2 (byte by byte); int8 mirror rows of 7 and
# 1 bytes (byte by byte), 6 (2) and 12 (4); q rows loaded element by
# element (d no multiple of 8).
COV_DECODE_DIMS = COV_DIMS + ((6, 10), (7, 5), (12, 3), (1, 1))
# The row statistic's limit (TOL_ROW_REL) was set on rows of 32 to 128
# elements. A row of 1 to 24 elements is one or a few bf16 scalars, and
# the kernels' documented roundings (q * scale and p to bf16, the output
# to bf16) move one such scalar by one or two bf16 ulps, up to 1.6e-2 of
# it (the phase read 1.06e-2 at d_v 1 and 1.05e-2 at d_v 8 on sound
# kernels): so rows narrower than COV_MIN_ROW are held in groups of
# consecutive rows (along the query, key or head axis) that hold at least
# COV_MIN_ROW elements, each row's own reading printed beside it; the
# whole-tensor limit is unchanged. The
# narrow decode widths' copy paths are held bit for bit as well: against
# the same kernel on rows zero-padded to a multiple of 8 elements (the
# 16-byte path, the same instantiation).
COV_MIN_ROW = 32
COV_PAGES = (16, 48, 192, 256)
COV_BLOCK_K = (128, 256, 512)
COV_T_MAX = 4096
# Decode slots (rows filled before the step, rows appended; None =
# inactive): a step near the slab's end, rows straddling a chunk, a first
# token, an inactive slot.
COV_SLOTS = ((4000, 5), (124, 5), (0, 1), (60, None))
# K5 splits that are no multiple of the 64-column step, on a slab of
# 1000 columns (a step near its end, rows straddling a split, a first
# token, an inactive slot).
COV_ODD_T_MAX = 1000
COV_ODD_BLOCK_K = (40, 100, 200, 1000)
COV_ODD_SLOTS = ((995, 5), (97, 5), (0, 1), (60, None))
COV_SEED = 2121
# The module with value_dim != key_dim at the flagship's width, and the
# LM and the engine at head dim 256.
COV_MOD = dict(key_dim=512, value_dim=256, num_heads=8)
COV_MOD_B, COV_MOD_T, COV_MOD_REF_B = 4, 8192, 2
COV_LM = dict(vocab=32768, dim=2048, heads=8, layers=2)
COV_LM_B, COV_LM_T, COV_LM_STEPS = 2, 4096, 32
COV_LM_PROMPT = 1000
COV_ENGINE = dict(slots=8, t_max=3072, heads=8, head_dim=256, page_size=48)
# The card's nvidia-smi name and power limit, beside the end-to-end rows.
CARD = None
COV_KERNELS = ('flash_attention', 'flash_attention_bounded',
               'flash_attention_dq', 'flash_attention_dkv', 'flash_decode',
               'flash_decode_paged')


def _cov_counts(ddp):
    return {n: getattr(ddp, n).launches for n in COV_KERNELS}


def _cov_rel(torch, got, want):
    """:func:`rel_errs` with rows narrower than COV_MIN_ROW held in groups
    of at least COV_MIN_ROW elements."""
    return rel_errs(torch, got, want, group=-(-COV_MIN_ROW // got.shape[-1]))


def _cov_row_readings(torch, pairs):
    """``{tensor: each row's own largest error}`` of ``{tensor: (got,
    want)}``, for the tensors whose rows are narrower than COV_MIN_ROW
    (printed beside the grouped readings)."""
    return {n: rel_errs(torch, g, w)[0] for n, (g, w) in pairs.items()
            if g.shape[-1] < COV_MIN_ROW}


def _cov_fwd_bwd(torch, fa, gen, d, dv, feat, tag,
                 shape=(2, 8, 2, 200, 200)):
    """K1 (with lse), K2 (base features) and K3/K4 (bf16 and float32
    gradients) at widths ``(d, dv)`` with feature kwargs ``feat`` on
    ``shape = (B, H_q, H_kv, T_q, T_k)`` against their plain versions:
    the row errors within the other phases' tolerances, lse within
    TOL_LSE, rows with no attendable key exactly 0 (K1's lse
    ln2*NEG_BIG), a second launch bit for bit the first."""
    dev, bf16 = torch.device('cuda'), torch.bfloat16
    b, hq, hkv, tq, tk = shape
    off = feat.pop('causal_offset', 0)
    q = randn(torch, (b, hq, tq, d), gen, dev, bf16)
    k = randn(torch, (b, hkv, tk, d), gen, dev, bf16)
    v = randn(torch, (b, hkv, tk, dv), gen, dev, bf16)
    g = randn(torch, (b, hq, tq, dv), gen, dev, bf16)
    kw = dict(causal=True, causal_offset=off, scale=1.0 / math.sqrt(d),
              **feat)
    empty = torch.zeros((b, hq, tq), dtype=torch.bool, device=dev)
    empty[..., torch.arange(tq, device=dev) + off < 0] = True
    neg = fa._LN2 * fa._NEG_BIG
    row, fails = {'phase': 'kernel_coverage', 'case': tag, 'd': d, 'd_v': dv,
                  'q': list(q.shape), 'kv': list(k.shape),
                  'features': sorted(feat), 'causal_offset': off}, []
    runs = {'k1': (lambda: fa.flash_attention_with_lse(q, k, v, **kw),
                   lambda: fa.flash_attention_plain_lse(q, k, v, **kw))}
    if not feat.get('dropout_rate') and not feat.get('qk_quant'):
        bkw = {n: x for n, x in kw.items() if n != 'dropout_seed'}
        runs['k2'] = (lambda: fa.flash_attention_bounded(q, k, v,
                                                         save_lse=True,
                                                         **bkw),
                      lambda: fa.flash_attention_bounded_plain_lse(q, k, v,
                                                                   **bkw))
    lse_k1 = out_k1 = None
    for kern, (run, plain) in runs.items():
        out, lse = run()
        out2, lse2 = run()
        out_p, lse_p = plain()
        torch.cuda.synchronize()
        row_rel, rel = _cov_rel(torch, out, out_p)
        lse_err = (lse - lse_p).abs().max().item()
        exact = bool(not out[empty].any().item() and (
            kern == 'k2' or (lse[empty] == neg).all().item()))
        same = bool(torch.equal(out, out2) and torch.equal(lse, lse2))
        row[kern] = {'max_abs_err': (out.float() - out_p.float()).abs()
                     .max().item(), 'max_row_rel_err': row_rel,
                     'rel_err': rel, 'lse_max_abs_err': lse_err,
                     'empty_rows_exact': exact, 'repeat_bitwise': same,
                     'out_shape': list(out.shape),
                     'per_row': _cov_row_readings(torch,
                                                  {'out': (out, out_p)})}
        what = f'{kern.upper()} {tag}'
        fails += check_rel({'out': (row_rel, rel)}, what)
        if not lse_err <= TOL_LSE:
            fails.append(f'{what}: lse abs err {lse_err} > {TOL_LSE}')
        if not (exact and same):
            fails.append(f'{what}: empty rows exact {exact}, repeat '
                         f'bitwise {same}')
        if tuple(out.shape) != (b, hq, tq, dv):
            fails.append(f'{what}: out shape {tuple(out.shape)}')
        if kern == 'k1':
            out_k1, lse_k1 = out, lse
    bkw = {n: x for n, x in kw.items() if n != 'scale'}
    for gdt in (None, torch.float32):
        got = fa.flash_attention_backward(q, k, v, out_k1, lse_k1, g,
                                          scale=kw['scale'], grad_dtype=gdt,
                                          **bkw)
        again = fa.flash_attention_backward(q, k, v, out_k1, lse_k1, g,
                                            scale=kw['scale'],
                                            grad_dtype=gdt, **bkw)
        want = fa.flash_attention_backward_plain(
            q, k, v, out_k1, lse_k1, g, scale=kw['scale'], grad_dtype=gdt,
            **bkw)
        torch.cuda.synchronize()
        name = 'bwd_f32' if gdt else 'bwd'
        errs = {n: _cov_rel(torch, x, y)
                for n, x, y in zip(('dq', 'dk', 'dv'), got, want)}
        same = all(torch.equal(x, y) for x, y in zip(got, again))
        shapes_ok = [tuple(x.shape) for x in got] == [
            tuple(x.shape) for x in (q, k, v)]
        row[name] = {'max_row_rel_err': {n: e[0] for n, e in errs.items()},
                     'rel_err': {n: e[1] for n, e in errs.items()},
                     'repeat_bitwise': same,
                     'empty_rows_dq_exact': bool(
                         not got[0][empty].any().item()),
                     'per_row': _cov_row_readings(torch, dict(zip(
                         ('dq', 'dk', 'dv'), zip(got, want))))}
        fails += check_rel(errs, f'K3/K4 {tag} {name}')
        if not (same and shapes_ok and row[name]['empty_rows_dq_exact']):
            fails.append(f'K3/K4 {tag} {name}: repeat bitwise {same}, '
                         f'shapes {shapes_ok}, empty dq rows exact '
                         f'{row[name]["empty_rows_dq_exact"]}')
    emit(row)
    return row, fails


def _cov_flash(torch, fa, gen):
    """K1-K4 at every COV_DIMS pair: the base kernels at a causal offset
    that leaves 70 rows without a key; the Ext features (packed segments,
    a causal window of 64, dropout 0.1) and int8 scoring at the same
    widths; then the base kernels at the LM step's shape (COV_LM: B 2 x 8
    heads x T 4096 at 256/256, causal), where long rows reach what short
    ones do not (the two-stage ring, many key tiles a block)."""
    fails, worst = [], {'row_rel': 0.0, 'lse': 0.0}
    lm_d = COV_LM['dim'] // COV_LM['heads']
    lm_shape = (COV_LM_B, COV_LM['heads'], COV_LM['heads'], COV_LM_T,
                COV_LM_T)
    cases = [(d, dv, tag, feat, (2, 8, 2, 200, 200)) for d, dv in COV_DIMS
             for tag, feat in (
                 ('base', dict(causal_offset=-70)),
                 ('ext', 'segments'),
                 ('int8', dict(qk_quant='int8', causal_offset=-70)))]
    cases.append((lm_d, lm_d, 'lm_shape', {}, lm_shape))
    for d, dv, tag, feat, shape in cases:
        if feat == 'segments':
            seg = ragged_segments(torch, gen, 2, 200).to('cuda')
            feat = dict(segment_ids=(seg, seg), window=64, dropout_rate=0.1,
                        dropout_seed=7)
        row, f = _cov_fwd_bwd(torch, fa, gen, d, dv, feat,
                              f'{tag}_d{d}_dv{dv}', shape)
        fails += f
        for kern in ('k1', 'k2'):
            if kern in row:
                worst['row_rel'] = max(worst['row_rel'],
                                       row[kern]['max_row_rel_err'])
                worst['lse'] = max(worst['lse'],
                                   row[kern]['lse_max_abs_err'])
    return worst, fails


def _cov_slab(torch, gen, slots, h, h_kv, d, dv, t):
    """A slab decode case at widths (d, dv): (q, k_new, v_new, cache_k,
    cache_v), unit-normal rows below each slot's fill, garbage past it."""
    dev, bf16, b, k = torch.device('cuda'), torch.bfloat16, len(slots), 5
    q = randn(torch, (b, h, k, d), gen, dev, bf16)
    kn = randn(torch, (b, h_kv, k, d), gen, dev, bf16)
    vn = randn(torch, (b, h_kv, k, dv), gen, dev, bf16)
    ck = 30.0 * randn(torch, (b, h_kv, t, d), gen, dev, bf16)
    cv = 30.0 * randn(torch, (b, h_kv, t, dv), gen, dev, bf16)
    for i, (f, _) in enumerate(slots):
        ck[i, :, :f] = randn(torch, (h_kv, f, d), gen, dev, bf16)
        cv[i, :, :f] = randn(torch, (h_kv, f, dv), gen, dev, bf16)
    return q, kn, vn, ck, cv


def _cov_split(torch, fd, x, vectors, base, split, what):
    """K5 on the slab case ``x = (q, k_new, v_new, cache_k, cache_v)``
    split at ``split`` (block_k; None: the kernel's own): against its
    plain version, the cache bit for bit the plain append, a second
    launch bit for bit the first, and bit for bit its own sequential
    one-row launches at the same split. ``(readings, failures)``."""
    q, kn, vn, ck, cv = x
    vt, ap, nn = vectors
    kw = dict(base, n_new=nn, block_k=split)
    c = [(ck.clone(), cv.clone()) for _ in range(4)]
    out = fd.flash_decode(q, kn, vn, *c[0], vt, ap, **kw)[0]
    again = fd.flash_decode(q, kn, vn, *c[1], vt, ap, **kw)[0]
    ref = fd.flash_decode_plain(q, kn, vn, *c[2], vt, ap, **kw)[0]
    seq = _sequential(torch, fd, q, kn, vn, *c[3], vt, ap, nn,
                      block_k=split, **base)
    torch.cuda.synchronize()
    errs, err, finite = _decode_errs(torch, out, ref, _cov_rel)
    got = {'max_abs_err': err, 'max_row_rel_err': errs['out'][0],
           'per_row': _cov_row_readings(torch, {'out': (out, ref)}),
           'cache_bit_identical': all(
               torch.equal(a, b) for a, b in zip(c[0], c[2])),
           'repeat_bit_identical': _same(torch, out, again),
           'equals_sequential': _same(torch, out, seq), 'finite': finite}
    fails = check_rel(errs, what)
    fails += [f'{what}: {n} is False' for n, v in got.items() if v is False]
    return got, fails


def _cov_narrow(torch, fd, x, vectors, base):
    """K5 on the slab case ``x`` at widths no multiple of 8 (the narrow
    row copies, appends and q loads) against the same kernel on every row
    zero-padded to a multiple of 8 (the 16-byte paths; the instantiation
    is the same): the output and the appended caches bit for bit."""
    F = torch.nn.functional
    q, kn, vn, ck, cv = x
    vt, ap, nn = vectors
    pk, pv = -q.shape[-1] % 8, -cv.shape[-1] % 8
    kw = dict(base, n_new=nn)
    narrow = (ck.clone(), cv.clone())
    wide = (F.pad(ck, (0, pk)), F.pad(cv, (0, pv)))
    out = fd.flash_decode(q, kn, vn, *narrow, vt, ap, **kw)[0]
    out_w = fd.flash_decode(F.pad(q, (0, pk)), F.pad(kn, (0, pk)),
                            F.pad(vn, (0, pv)), *wide, vt, ap, **kw)[0]
    torch.cuda.synchronize()
    return bool(torch.equal(out, out_w[..., :out.shape[-1]])
                and torch.equal(narrow[0], wide[0][..., :ck.shape[-1]])
                and torch.equal(narrow[1], wide[1][..., :cv.shape[-1]]))


def _cov_decode_bound(torch, mask, h, h_kv, d, dv, b, k):
    """``(ms, by)`` of a decode launch at true widths (d, dv) whose query
    rows attend ``mask (B, 1, k, t)``: every attended K and V row read once
    (2d + 2dv bytes), q read and the output written, k_new / v_new read and
    appended; 2(d + dv) operations per attended (query head, column)."""
    rows = int(mask.any(dim=2).sum().item()) * h_kv
    cols = int(mask.sum().item()) * h
    nbytes = (2 * rows * (d + dv) + 2 * b * h * k * (d + dv)
              + 4 * b * h_kv * k * (d + dv))
    return bound_ms(2 * cols * (d + dv), nbytes)


def _cov_decode(torch, fd, gen, flush):
    """K5 and K5p at every COV_DECODE_DIMS pair (GQA 8:2), one new row and
    verify k = 5, rows read and appended in place at their true widths: the
    output within tolerance of the plain version, widths no multiple of 8
    bit for bit the 16-byte path on zero-padded rows, the cache bit for bit
    its append, a second launch bit for bit the first, verify bit for bit
    the sequential one-row launches; K5p on scrambled pools at
    COV_PAGES bit for bit K5 on the gathered slab, its pool bit for bit
    the plain append's but the sink; the int8 mirror (one row); K5 split
    at COV_BLOCK_K bit for bit its own sequential launches; the refused
    block_k raise the reference's ValueError."""
    dev, h, h_kv, t = torch.device('cuda'), 8, 2, COV_T_MAX
    fails, worst = [], 0.0
    for d, dv in COV_DECODE_DIMS:
        for k in (1, VERIFY_K):
            sl = _one_row(COV_SLOTS) if k == 1 else COV_SLOTS
            vt, ap, nn = _verify_vectors(torch, sl, k, dev)
            q, kn, vn, ck, cv = _cov_slab(torch, gen, sl, h, h_kv, d, dv, t)
            q, kn, vn = (x[:, :, :k].contiguous() for x in (q, kn, vn))
            base = dict(scale=1.0 / math.sqrt(d))
            kw = dict(base, n_new=nn)
            tag = f'd{d}_dv{dv}_k{k}'
            row = {'phase': 'kernel_coverage', 'case': f'decode_{tag}',
                   'd': d, 'd_v': dv, 'k': k, 't_max': t}
            for split in (None, *COV_BLOCK_K):
                key = 'block_k_none' if split is None else f'block_k_{split}'
                row[key], f = _cov_split(torch, fd, (q, kn, vn, ck, cv),
                                         (vt, ap, nn), base, split,
                                         f'K5 {tag} {key}')
                fails += f
                worst = max(worst, row[key]['max_abs_err'])
            if d % 8 or dv % 8:
                row['equals_16_byte_path'] = _cov_narrow(
                    torch, fd, (q, kn, vn, ck, cv), (vt, ap, nn), base)
                if not row['equals_16_byte_path']:
                    fails.append(f'K5 {tag}: narrow rows differ from the '
                                 f'16-byte path')
            for ps in COV_PAGES:
                kp, vp, table = paged_twin(torch, gen, ck, cv, ps)
                kp2, vp2 = kp.clone(), vp.clone()
                slab = [fd.gather_pages(x, table) for x in (kp, vp)]
                pkw = dict(kw, page_table=table)
                got = fd.flash_decode(q, kn, vn, kp, vp, vt, ap, **pkw)[0]
                want = fd.flash_decode_plain(q, kn, vn, kp2, vp2, vt, ap,
                                             **pkw)[0]
                on_slab = fd.flash_decode(q, kn, vn, *slab, vt, ap, **kw)[0]
                torch.cuda.synchronize()
                perrs, perr, pfinite = _decode_errs(torch, got, want,
                                                    _cov_rel)
                row[f'page_{ps}'] = {
                    'max_abs_err': perr, 'max_row_rel_err': perrs['out'][0],
                    'per_row': _cov_row_readings(torch,
                                                 {'out': (got, want)}),
                    'equals_k5_on_gathered_slab': _same(torch, got, on_slab),
                    'pools_bit_identical_but_sink': bool(
                        torch.equal(kp[:-1], kp2[:-1])
                        and torch.equal(vp[:-1], vp2[:-1])),
                    'finite': pfinite}
                fails += check_rel(perrs, f'K5p {tag} page {ps}')
                fails += [f'K5p {tag} page {ps}: {n} is False'
                          for n, x in row[f'page_{ps}'].items()
                          if x is False]
                worst = max(worst, perr)
            if k == 1:
                # Times at this width: K5, its plain version, SDPA over
                # the slab with the boolean mask, K5p at page 48.
                F = torch.nn.functional
                ct = (ck.clone(), cv.clone())
                mask = _verify_mask(torch, vt, 1, t, dev)
                kp, vp, table = paged_twin(torch, gen, ck, cv, 48)
                bms, by = _cov_decode_bound(torch, mask, h, h_kv, d, dv,
                                            len(sl), 1)
                row['times'] = {
                    'k5_ms': time_ms(torch, lambda: fd.flash_decode(
                        q, kn, vn, *ct, vt, ap, **kw), flush),
                    'k5_plain_ms': time_ms(
                        torch, lambda: fd.flash_decode_plain(
                            q, kn, vn, *ct, vt, ap, **kw), flush, reps=5),
                    'k5p_page_48_ms': time_ms(torch, lambda: fd.flash_decode(
                        q, kn, vn, kp, vp, vt, ap, page_table=table, **kw),
                        flush),
                    'library_ms': time_ms(
                        torch, lambda: F.scaled_dot_product_attention(
                            q, ct[0], ct[1], attn_mask=mask,
                            scale=base['scale'], enable_gqa=True), flush),
                    'library': 'SDPA over the slab, boolean mask',
                    'bound_ms': bms, 'bound_by': by}
                c = [(ck.clone(), cv.clone(), *_mirror(torch, fd, ck))
                     for _ in range(2)]
                ikw = dict(kw, qk_quant='int8')
                got = fd.flash_decode(q, kn, vn, c[0][0], c[0][1], vt, ap,
                                      k_q=c[0][2], k_scale=c[0][3],
                                      partials=True, **ikw)[0]
                want = fd.flash_decode_plain(q, kn, vn, c[1][0], c[1][1],
                                             vt, ap, k_q=c[1][2],
                                             k_scale=c[1][3], partials=True,
                                             **ikw)[0]
                torch.cuda.synchronize()
                ierrs, ierr, ifinite = _decode_errs(torch, got, want,
                                                    _cov_rel)
                row['int8'] = {
                    'max_abs_err': ierr,
                    'max_row_rel_err': {n: e[0] for n, e in ierrs.items()},
                    'scores_max_bit_identical': bool(torch.equal(got[1],
                                                                 want[1])),
                    'mirror_bit_identical': bool(
                        torch.equal(c[0][2], c[1][2])
                        and torch.equal(c[0][3], c[1][3])),
                    'finite': ifinite}
                fails += check_rel({'num': ierrs['num']}, f'K5 int8 {tag}')
                fails += [f'K5 int8 {tag}: {n} is False'
                          for n, x in row['int8'].items() if x is False]
            emit(row)
    # Splits that are no multiple of the 64-column step (a chunk's last
    # step shorter) on a t_max of 1000, at two widths.
    for d, dv in ((24, 12), (256, 256)):
        for k in (1, VERIFY_K):
            sl = _one_row(COV_ODD_SLOTS) if k == 1 else COV_ODD_SLOTS
            vt, ap, nn = _verify_vectors(torch, sl, k, dev)
            x = _cov_slab(torch, gen, sl, h, h_kv, d, dv, COV_ODD_T_MAX)
            x = (*(y[:, :, :k].contiguous() for y in x[:3]), *x[3:])
            row = {'phase': 'kernel_coverage',
                   'case': f'decode_odd_splits_d{d}_dv{dv}_k{k}',
                   't_max': COV_ODD_T_MAX}
            for split in COV_ODD_BLOCK_K:
                row[f'block_k_{split}'], f = _cov_split(
                    torch, fd, x, (vt, ap, nn), dict(scale=1.0 / math.sqrt(d)),
                    split, f'K5 odd split d {d} k {k} block_k {split}')
                fails += f
                worst = max(worst, row[f'block_k_{split}']['max_abs_err'])
            emit(row)
    # The reference's refusals, on the card.
    q, kn, vn, ck, cv = _cov_slab(torch, gen, _one_row(COV_SLOTS), h, h_kv,
                                  64, 64, t)
    vt, ap, nn = _verify_vectors(torch, _one_row(COV_SLOTS), 1, dev)
    kp48, vp48, t48 = paged_twin(torch, gen, ck, cv, 48)
    refused = {}
    for name, call in (
            ('slab_block_k_100', lambda: fd.flash_decode(
                q[:, :, :1], kn[:, :, :1], vn[:, :, :1], ck, cv, vt, ap,
                block_k=100)),
            ('verify_wider_than_block_k', lambda: fd.flash_decode(
                q, kn, vn, ck, cv, vt, ap, block_k=4)),
            ('paged_block_k_not_page', lambda: fd.flash_decode(
                q[:, :, :1], kn[:, :, :1], vn[:, :, :1], kp48, vp48, vt, ap,
                page_table=t48, block_k=128))):
        try:
            call()
            refused[name] = None
        except ValueError as exc:
            refused[name] = str(exc)[:80]
    emit({'phase': 'kernel_coverage', 'case': 'block_k_refusals',
          'refused': refused})
    fails += [f'block_k {n} not refused' for n, x in refused.items()
              if x is None]
    return worst, fails


def _cov_bound(d, dv, nq, nkv, tq, tk, pairs, grad_bytes=2):
    """``{k1, k3, k4}: (ms, by)`` bounds at true widths (d, dv): K1 does
    2(d + dv) operations a pair (S, P.V) and moves q, k, v, out and the
    lse once; K3 4d + 2dv (S, dP, dQ) and K4 4(d + dv) (S^T, dP^T, dV,
    dK), each reading q, k, v, dO, lse2 and delta once and writing its
    gradients."""
    rows_q, rows_k = nq * tq, nkv * tk
    io = 2 * (rows_q * (d + dv) + rows_k * (d + dv)) + 8 * rows_q
    return {'k1': bound_ms(2 * pairs * (d + dv), io - 4 * rows_q),
            'k3': bound_ms(pairs * (4 * d + 2 * dv),
                           io + grad_bytes * rows_q * d),
            'k4': bound_ms(pairs * 4 * (d + dv),
                           io + grad_bytes * rows_k * (d + dv))}


def _cov_timing(torch, fa, flush, gen):
    """K1 and K3 + K4 at every COV_DIMS pair, B 2 x 8 heads x T 2048,
    causal: out, dq, dk and dv held against the plain versions' on the
    same inputs (check_rel's tolerances), then the kernels' ms (the
    wrapper's zero-padding copy included, and timed alone beside it), the
    plain versions' and SDPA's (its forward; its backward for K3 + K4, dq,
    dk and dv together) where a backend takes the widths, and the bounds.
    ``(rows, failures)``."""
    F = torch.nn.functional
    dev, bf16 = torch.device('cuda'), torch.bfloat16
    b, h, t = 2, 8, 2048
    pairs = b * h * t * (t + 1) // 2
    out, fails = {}, []
    for d, dv in COV_DIMS:
        q = randn(torch, (b, h, t, d), gen, dev, bf16).requires_grad_()
        k = randn(torch, (b, h, t, d), gen, dev, bf16).requires_grad_()
        v = randn(torch, (b, h, t, dv), gen, dev, bf16).requires_grad_()
        g = randn(torch, (b, h, t, dv), gen, dev, bf16)
        scale = 1.0 / math.sqrt(d)
        kw = dict(causal=True, scale=scale)
        o, lse = fa.flash_attention_with_lse(q.detach(), k.detach(),
                                             v.detach(), **kw)
        got = (fa.flash_attention(q.detach(), k.detach(), v.detach(), **kw),
               *fa.flash_attention_backward(q.detach(), k.detach(),
                                            v.detach(), o, lse, g, True,
                                            scale=scale))
        want = (fa.flash_attention_plain(q.detach(), k.detach(), v.detach(),
                                         **kw),
                *fa.flash_attention_backward_plain(
                    q.detach(), k.detach(), v.detach(), o, lse, g, True,
                    scale=scale))
        torch.cuda.synchronize()
        names = ('out', 'dq', 'dk', 'dv')
        errs = {n: _cov_rel(torch, x, y) for n, x, y in zip(names, got, want)}
        per_row = _cov_row_readings(torch, dict(zip(names, zip(got, want))))
        fails += check_rel(errs, f'K1/K3/K4 timing d {d} dv {dv}')
        del got, want
        D, DV = fa._grid_dims(d, dv)
        row = {'d': d, 'd_v': dv, 'grid': [D, DV], 'shape': [b, h, t],
               'max_row_rel_err': {n: e[0] for n, e in errs.items()},
               'rel_err': {n: e[1] for n, e in errs.items()},
               'per_row': per_row,
               'k1_ms': time_ms(torch, lambda: fa.flash_attention(
                   q.detach(), k.detach(), v.detach(), **kw), flush),
               'k1_plain_ms': time_ms(torch, lambda: fa.flash_attention_plain(
                   q.detach(), k.detach(), v.detach(), **kw), flush, reps=3),
               'k3_k4_ms': time_ms(torch, lambda: fa.flash_attention_backward(
                   q.detach(), k.detach(), v.detach(), o, lse, g, True,
                   scale=scale), flush),
               'k3_k4_plain_ms': time_ms(
                   torch, lambda: fa.flash_attention_backward_plain(
                       q.detach(), k.detach(), v.detach(), o, lse, g, True,
                       scale=scale), flush, reps=3),
               'pad_ms': (time_ms(torch, lambda: (
                   fa._pad_cols(q.detach(), D), fa._pad_cols(k.detach(), D),
                   fa._pad_cols(v.detach(), DV)), flush)
                          if (D, DV) != (d, dv) else 0.0)}
        try:
            row['library_ms'] = time_ms(
                torch, lambda: F.scaled_dot_product_attention(
                    q.detach(), k.detach(), v.detach(), is_causal=True,
                    scale=scale), flush)

            def sdpa_bwd():
                y = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                   scale=scale)
                torch.autograd.grad(y, (q, k, v), g)
            row['library_bwd_ms'] = time_ms(torch, sdpa_bwd, flush)
            row['library'] = 'SDPA (its fastest backend for the widths)'
        except RuntimeError as exc:
            row.update(library_ms=None, library_bwd_ms=None,
                       library=f'none: SDPA refuses the widths '
                               f'({str(exc)[:60]})')
        for kern, (ms, by) in _cov_bound(d, dv, b * h, b * h, t, t,
                                         pairs).items():
            row[f'{kern}_bound_ms'], row[f'{kern}_bound_by'] = ms, by
        emit({'phase': 'kernel_coverage', 'case': f'timing_d{d}_dv{dv}',
              **row})
        out[f'd{d}_dv{dv}'] = row
    return out, fails


def _cov_module(torch, ddp, flush):
    """The paper's module with value_dim != key_dim at the flagship's
    width (COV_MOD, causal, bf16, flash), its weights made by the
    converter from a seeded tree in the reference module's layout
    (kernel (in, out)): forward and backward at B 4 x T 8192 through K1,
    K3 and K4, ms a step and the launches (counts at 0 just before); the
    first COV_MOD_REF_B rows' output and input gradients held against the
    same weights on the module's plain path ('full', float32) on the
    card."""
    import numpy as np
    from distributed_dot_product_tpu_torch import convert
    from distributed_dot_product_tpu_torch.convert import attn_state_from_jax
    dev, bf16 = torch.device('cuda'), torch.bfloat16
    mod = ddp.DistributedDotProductAttn(**COV_MOD, softmax_impl='flash',
                                        causal=True, dtype=bf16, device=dev)
    rng = np.random.default_rng(COV_SEED)
    flax_name = {port: flax for flax, port in convert._ATTN}
    tree = {}
    for name, w in mod.state_dict().items():
        layer, kind = name.rsplit('.', 1)
        check(kind == 'weight', f'unexpected module parameter {name}')
        fan_in = w.shape[1]
        tree[flax_name[layer]] = {'kernel': (
            rng.standard_normal((fan_in, w.shape[0])) / math.sqrt(fan_in)
        ).astype(np.float32)}
    state = attn_state_from_jax({'params': tree})
    mod.load_state_dict(state)
    ref = ddp.DistributedDotProductAttn(**COV_MOD, softmax_impl='full',
                                        causal=True, dtype=torch.float32,
                                        device=dev)
    ref.load_state_dict(state)
    gen = torch.Generator().manual_seed(COV_SEED)
    b, t = COV_MOD_B, COV_MOD_T
    kd, vd = COV_MOD['key_dim'], COV_MOD['value_dim']
    x = [torch.randn((b, t, w), generator=gen).to(dev, bf16)
         for w in (kd, kd, vd)]
    gy = torch.randn((b, t, vd), generator=gen).to(dev, bf16)

    def step():
        ins = [a.detach().requires_grad_() for a in x]
        y = mod(*ins)
        grads = torch.autograd.grad(y, ins, gy)
        return y, grads
    step()
    torch.cuda.synchronize()
    for n in ('flash_attention', 'flash_attention_dq', 'flash_attention_dkv'):
        getattr(ddp, n).launches = 0
    t0 = time.perf_counter()
    y, grads = step()
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0)
    launches = {n: getattr(ddp, n).launches for n in (
        'flash_attention', 'flash_attention_dq', 'flash_attention_dkv')}
    ms = time_ms(torch, step, flush, reps=5)
    rb = COV_MOD_REF_B
    ins = [a[:rb].float().detach().requires_grad_() for a in x]
    y_ref = ref(*ins)
    g_ref = torch.autograd.grad(y_ref, ins, gy[:rb].float())
    errs = {'out': rel_errs(torch, y[:rb], y_ref)}
    errs.update({f'd{n}': rel_errs(torch, gr[:rb], gw)
                 for n, gr, gw in zip(('keys', 'queries', 'values'), grads,
                                      g_ref)})
    row = {'phase': 'kernel_coverage', 'case': 'module_value_dim',
           'card': CARD,
           'module': dict(COV_MOD, softmax_impl='flash', causal=True),
           'head_dim': kd // COV_MOD['num_heads'],
           'value_head_dim': vd // COV_MOD['num_heads'],
           'batch': [b, t], 'first_step_ms': step_ms,
           'ms_per_step': ms, 'launches': launches,
           'held_rows': rb, 'rel_err_vs_full_f32': {
               n: e[1] for n, e in errs.items()},
           'tol': TOL_REF_GRAD_REL,
           'finite': bool(torch.isfinite(y).all().item())}
    emit(row)
    fails = [f'module value_dim {n}: rel err {e[1]} > {TOL_REF_GRAD_REL}'
             for n, e in errs.items() if not e[1] <= TOL_REF_GRAD_REL]
    if launches != {'flash_attention': 1, 'flash_attention_dq': 1,
                    'flash_attention_dkv': 1} or not row['finite']:
        fails.append(f'module value_dim: launches {launches}, finite '
                     f'{row["finite"]}')
    del mod, ref, x, y, grads, y_ref, g_ref, ins
    torch.cuda.empty_cache()
    return launches, fails


def _cov_lm(torch, ddp):
    """The LM at head dim 256 (COV_LM): its loss and last-position logits
    at B 2 x T 4096 held against the same weights in float32 on the
    'full' path on the card (TOL_REF_LOSS_REL, TOL_LM_REL); one Adam step
    at that batch (K1, K3, K4; a warm step first), then greedy generation
    of COV_LM_STEPS tokens from B 2 prompts of COV_LM_PROMPT tokens (K1,
    K5); ms, tokens/s and the launches of each (counts at 0 just
    before)."""
    from distributed_dot_product_tpu_torch.models.lm import greedy_generate
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(COV_SEED)
    c = COV_LM
    model = ddp.TransformerLM(c['vocab'], c['dim'], c['heads'],
                              n_layers=c['layers'], dtype=torch.bfloat16,
                              device=dev, generator=gen)
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    step = ddp.make_lm_train_step(model, opt, loss_chunk=LOSS_CHUNK)
    tokens = torch.randint(0, c['vocab'], (COV_LM_B, COV_LM_T),
                           generator=gen).to(dev)
    batch = (tokens, ddp.lm_targets(tokens))
    ref = ddp.TransformerLM(c['vocab'], c['dim'], c['heads'],
                            n_layers=c['layers'], dtype=torch.float32,
                            attn_kwargs=dict(softmax_impl='full'),
                            device=dev, generator=torch.Generator())
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        loss_sum, count = ref.nll_sum(*batch, chunk=LOSS_CHUNK)
        ref_loss = (loss_sum / count).item()
        ref_logits = ref(tokens)[:, -1].float()
        del ref
        got_logits = model(tokens)[:, -1].float()
    logits_rel = ((got_logits - ref_logits).abs().max()
                  / ref_logits.abs().max()).item()
    del ref_logits, got_logits
    torch.cuda.empty_cache()
    losses = [step(batch).item()]
    loss_rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    torch.cuda.synchronize()
    for n in COV_KERNELS:
        getattr(ddp, n).launches = 0
    t0 = time.perf_counter()
    losses.append(step(batch).item())
    torch.cuda.synchronize()
    train_ms = 1e3 * (time.perf_counter() - t0)
    train_launches = _cov_counts(ddp)
    prompts = tokens[:, :COV_LM_PROMPT]
    t_max = COV_LM_PROMPT + COV_LM_STEPS
    greedy_generate(model, prompts, 2, t_max)         # warm-up
    torch.cuda.synchronize()
    for n in COV_KERNELS:
        getattr(ddp, n).launches = 0
    t0 = time.perf_counter()
    out = greedy_generate(model, prompts, COV_LM_STEPS, t_max)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    gen_launches = _cov_counts(ddp)
    row = {'phase': 'kernel_coverage', 'case': 'lm_head_dim_256',
           'card': CARD,
           'lm': dict(c, head_dim=c['dim'] // c['heads']),
           'vs_full_f32': {'loss': ref_loss, 'loss_rel_err': loss_rel,
                           'tol_loss_rel': TOL_REF_LOSS_REL,
                           'last_logits_rel_err': logits_rel,
                           'tol_logits_rel': TOL_LM_REL},
           'train': {'batch': [COV_LM_B, COV_LM_T], 'losses': losses,
                     'ms_per_step': train_ms,
                     'tokens_per_s': COV_LM_B * COV_LM_T / (train_ms / 1e3),
                     'launches': train_launches},
           'greedy': {'batch': [COV_LM_B, COV_LM_PROMPT],
                      'steps': COV_LM_STEPS, 'generate_s': gen_s,
                      'tokens_per_s': COV_LM_B * COV_LM_STEPS / gen_s,
                      'launches': gen_launches}}
    emit(row)
    fails = []
    if not all(math.isfinite(x) for x in losses):
        fails.append(f'LM d 256: losses {losses}')
    if not loss_rel <= TOL_REF_LOSS_REL:
        fails.append(f'LM d 256: loss rel err vs float32 full {loss_rel} '
                     f'> {TOL_REF_LOSS_REL}')
    if not logits_rel <= TOL_LM_REL:
        fails.append(f'LM d 256: last logits rel err vs float32 full '
                     f'{logits_rel} > {TOL_LM_REL}')
    want_t = {'flash_attention': c['layers'],
              'flash_attention_dq': c['layers'],
              'flash_attention_dkv': c['layers']}
    want_g = {'flash_attention': c['layers'],
              'flash_decode': c['layers'] * (COV_LM_STEPS - 1)}
    for want, got, what in ((want_t, train_launches, 'train step'),
                            (want_g, gen_launches, 'greedy run')):
        if any(got[n] != x for n, x in want.items()):
            fails.append(f'LM d 256 {what}: launches {got}, want {want}')
    if tuple(out.shape) != (COV_LM_B, COV_LM_STEPS) or not bool(
            ((out >= 0) & (out < c['vocab'])).all()):
        fails.append(f'LM d 256 greedy: tokens {tuple(out.shape)}')
    del model, opt, step, batch
    torch.cuda.empty_cache()
    return {'train': train_launches, 'greedy': gen_launches}, fails


def _cov_engine(torch, ddp):
    """KernelEngine at head dim 256 and page 48 (COV_ENGINE, bf16, K5p):
    the first-step logits of the burst's first 8 prompts held against the
    same engine's plain decode path on the card, then the seeded burst
    through the Scheduler (tokens/s, TTFT p99, K5p launches against the
    decode steps)."""
    from distributed_dot_product_tpu_torch.serve import KernelEngine

    def engine(impl):
        return KernelEngine(
            slots=COV_ENGINE['slots'], t_max=COV_ENGINE['t_max'],
            vocab=VOCAB, heads=COV_ENGINE['heads'],
            head_dim=COV_ENGINE['head_dim'], prefill_chunk=SERVE_CHUNK,
            seed=SERVE_SEED, dtype=torch.bfloat16, device='cuda',
            decode_impl=impl, cache_mode='paged',
            page_size=COV_ENGINE['page_size'], weight_quant='off')
    burst = serve_burst()
    prompts = [p for _, p in burst[:COV_ENGINE['slots']]]
    kern = engine('kernel')
    check((kern.decode_impl, kern.cache_mode, kern.page_size) == (
        'kernel', 'paged', COV_ENGINE['page_size']),
          'kernel_coverage engine settings')
    got = first_step_logits(torch, kern, prompts)
    plain = engine('plain')
    want = first_step_logits(torch, plain, prompts)
    del plain
    rel = ((got - want).abs().max() / want.abs().max()).item()
    for i in range(kern.slots):
        kern.reset(i)
    _, row = _serve_burst(torch, ddp, kern, burst, 'kernel_coverage engine')
    row.update(phase='kernel_coverage', case='engine_head_dim_256_page_48',
               card=CARD,
               first_step_logits_rel_err_vs_plain=rel, tol=TOL_BF16)
    emit(row)
    fails = []
    if not rel <= TOL_BF16:
        fails.append(f'engine d 256 page 48: first-step logits rel err '
                     f'{rel} > {TOL_BF16}')
    if row['launches']['flash_decode_paged'] != row['decode_steps'] or \
            row['launches']['flash_decode']:
        fails.append(f'engine d 256 page 48: launches {row["launches"]}, '
                     f'decode steps {row["decode_steps"]}')
    del kern
    torch.cuda.empty_cache()
    return row['launches'], fails


def phase_kernel_coverage(torch, ddp, flush):
    """The widths, page sizes and K splits the kernels took in this slice
    (the module docstring, phase 13b): every case is held against its
    plain version and every failure reported together at the end."""
    import importlib
    fa = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_attention')
    fd = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_decode')
    gen = torch.Generator().manual_seed(COV_SEED)
    flash_worst, fails = _cov_flash(torch, fa, gen)
    decode_worst, f = _cov_decode(torch, fd, gen, flush)
    fails += f
    timing, f = _cov_timing(torch, fa, flush, gen)
    fails += f
    module_launches, f = _cov_module(torch, ddp, flush)
    fails += f
    lm_launches, f = _cov_lm(torch, ddp)
    fails += f
    engine_launches, f = _cov_engine(torch, ddp)
    fails += f
    check(not fails, '; '.join(fails))
    return {'flash_worst': flash_worst, 'decode_max_abs_err': decode_worst,
            'timing': timing, 'launches': {
                'module_value_dim': module_launches,
                'lm_train_step': lm_launches['train'],
                'lm_greedy': lm_launches['greedy'],
                'engine_page_48': engine_launches}}


# float32_path: the float32 kernels (K1/K2 in csrc/flash_f32.cu, K3/K4 in
# csrc/flash_bwd_f32.cu, K5/K5p in
# csrc/flash_decode.cu's -DDECODE_F32 library) and the slice's entry points
# at the JAX package's default dtype. Every operand below is float32 drawn
# as float32 (bf16-representable values would let a kernel that drops to
# bf16 or to one TF32 product read exact). The widths: every FLASH_GRID pair
# and three off the grid; B 2, 8:2 heads, T 200.
F32_DIMS = ((32, 32), (64, 64), (96, 96), (128, 128), (192, 128),
            (256, 256), (80, 80), (24, 12), (160, 160))
F32_SHAPE = (2, 8, 2, 200, 200)
# K3 and K4 run 128 rows a block at (96, 96), a consumer warpgroup each
# 64: GQA 4:1 at T 1000 (the last block's second warpgroup holds 40 rows)
# and 900 (it holds none), causal and with the Ext features.
F32_RAGGED = (('causal', (1, 8, 2, 1000, 1000)), ('ext', (1, 8, 2, 900, 900)))
# K5/K5p: the main path's width, the widest, a pair off the grid, and two
# whose rows are no multiple of 16 bytes (7/5: every row by 4-byte
# cp.async; 12/3: K rows by bulk copy, V rows by cp.async).
F32_DECODE_DIMS = ((96, 96), (256, 256), (24, 12), (7, 5), (12, 3))
F32_PAGES = (16, 48)
F32_BLOCK_K = (128, 512)
F32_WINDOW = 1024
F32_SEED = 2222
# The float32 kernels against their plain float32 versions (cuBLAS at
# torch's default "highest" precision): the row statistic of rel_errs at
# most 1e-4 for out, dq, dk, dv and decode out, and |lse - plain| at most
# 1e-5 (lse ~ 5-10 in natural-log units: a few float32 ulps). Both sides
# accumulate float32-accurate products in other orders: ~1e-6 relative on
# a row, more where ds = p * (dp - delta) cancels. One TF32 product
# (~2^-11 relative) reads ~1e-3 and fails on purpose; the bf16 kernels'
# limit is 1e-2.
TOL_F32_ROW = 1e-4
TOL_F32_LSE = 1e-5
# dq and dk are sums of ds = p * (dp - delta) terms that cancel: a query
# row with one attended key has dq = 0 in exact arithmetic, and any
# float32 evaluation leaves rounding there (the plain float32 version's
# own row statistic against float64 reads ~1e-3 in such rows, printed as
# dq_plain_vs_float64). So dq and dk are held to TOL_F32_ROW against a
# float64 evaluation of the same formulas (:func:`_f64_grads`), each row's
# error over the magnitude of its terms before anything cancels (dp and
# delta as sums of |dO| |v| and |dO| |O|; ds as p times their sum; dq as
# scale * that @ |k|, dk its transpose @ |q2|): the componentwise bound a
# float32 evaluation meets. Float32-accurate products read ~1e-6 there, a
# single TF32 product ~5e-4. Their row statistic against the plain
# version is printed beside it.
# 3xTF32, the card's fastest float32-accurate rate (TF32's 495 over 3), for
# the float32 kernels' operation bound; K5/K5p f32 run FFMA on the CUDA
# cores (67 TFLOP/s float32 outside the tensor cores).
F32_FLOPS = 165e12
F32_FFMA_FLOPS = 67e12
F32_KERNELS = ('flash_attention', 'flash_attention_bounded',
               'flash_attention_dq', 'flash_attention_dkv', 'flash_decode',
               'flash_decode_paged')
# The body each float32 kernel runs, named on the kernels line.
_F32_FWD_BODY = ('flash_fwd_f32_kernel: S and P.V on 3xTF32 wgmma m64nNk8 '
                 '(A from registers), K and V^T split once by a producer '
                 'warpgroup, two consumer warpgroups')
_F32_BWD_BODY = ('3xTF32 mma.sync m16n8k8 on operands split once by a '
                 'producer warpgroup, two consumer warpgroups')
_F32_DECODE_BODY = ('flash_decode_f32_kernel (-DDECODE_F32): exact float32 '
                    'FFMA over the real query rows (lanes along d for S, '
                    'one butterfly; along dv for P.V), each cache row '
                    'fetched by one cp.async.bulk, two steps a warp in '
                    'flight at (96, 96)')
F32_BODY = {'flash_attention': _F32_FWD_BODY,
            'flash_attention_bounded': _F32_FWD_BODY,
            'flash_attention_dq': 'flash_dq_f32_kernel: ' + _F32_BWD_BODY,
            'flash_attention_dkv': 'flash_dkv_f32_kernel: ' + _F32_BWD_BODY,
            'flash_decode': _F32_DECODE_BODY,
            'flash_decode_paged': _F32_DECODE_BODY}
# The entry points at full width: the README "Resilient serving" engine,
# the LM (train_path's widths at dtype=None), the paper's module
# (entry()'s shapes).
F32_LM_STEPS = 3
TOL_F32_REL = 1e-4
F32_MOD = dict(key_dim=512, num_heads=8, offset=64)
F32_MOD_B, F32_MOD_T, F32_MOD_REF_B = 4, 8192, 2
F32_NEAR_TIE = 1e-4


def f32n(torch, shape, gen, dev):
    return torch.randn(shape, generator=gen, dtype=torch.float32).to(dev)


def _f32_counts(ddp):
    """Each kernel's float32 launches."""
    return {n: getattr(ddp, n).f32_launches for n in F32_KERNELS}


def _f32_zero(ddp):
    for n in F32_KERNELS:
        getattr(ddp, n).launches = getattr(ddp, n).f32_launches = 0


def _f32_case_kw(torch, gen, case, b, hq, tq, tk):
    """The flash kwargs of a kernel case: 'causal' (70 rows with no key),
    'mask' (not causal, a dense mask with 10 fully masked rows), 'ext'
    (packed segments, a causal window of 64, dropout 0.1), 'alibi_pos'
    (ALiBi over shuffled explicit positions with a window of 100) and
    'int8' (int8 scoring, 70 rows with no key); and the (B, H, Tq) rows
    that attend nothing."""
    dev = torch.device('cuda')
    empty = torch.zeros((b, hq, tq), dtype=torch.bool, device=dev)
    if case in ('causal', 'int8'):
        kw = dict(causal=True, causal_offset=-70)
        empty[..., :70] = True
        if case == 'int8':
            kw['qk_quant'] = 'int8'
    elif case == 'mask':
        mask = torch.rand((b, 1, tq, tk), generator=gen) < 0.3
        mask[:, :, :10] = True
        kw = dict(mask=mask.to(dev))
        empty[..., :10] = True
    elif case == 'ext':
        seg = ragged_segments(torch, gen, b, tq).to(dev)
        kw = dict(causal=True, segment_ids=(seg, seg), window=64,
                  dropout_rate=0.1, dropout_seed=11)
    else:
        pos = torch.stack([torch.randperm(tq, generator=gen)
                           for _ in range(b)]).to(dev)
        kw = dict(positions=(pos[:, None], pos[:, None]), window=100,
                  alibi_slopes=torch.tensor(ALIBI_SLOPES, device=dev))
    return kw, empty


def _f64_grads(torch, fa, q, k, v, g, out, lse, scale, kw):
    """dq and dk in float64 from the float32 operands, ``out`` and ``lse``
    (the formulas of ``flash_attention_backward_plain``: the masks, ALiBi
    bias and dropout keep from its own pieces, everything else in
    float64), and the magnitude of each element's terms before anything
    cancels (``p * (|dO| @ |v|^T + rowsum(|dO| |O|))`` in place of ds:
    ``@ |k|`` for dq, ``^T @ |q2|`` for dk, scaled alike): ``(dq,
    dq_terms, dk, dk_terms)``, dk summed over each GQA group."""
    causal, co = kw.get('causal', False), kw.get('causal_offset', 0)
    feat = fa._features(q, k, causal, kw.get('segment_ids'),
                        kw.get('window'), kw.get('dropout_rate', 0.0),
                        kw.get('dropout_seed'), kw.get('qk_quant'),
                        kw.get('positions'), kw.get('alibi_slopes'))
    group = fa._kv_group(q, k)
    q2, lse2, delta = fa.flash_attention_bwd_operands(q, out, lse, g, scale)
    ke, ve = fa._expand_group(k, group), fa._expand_group(v, group)
    f64 = torch.float64
    if feat.quant:
        q8, sq, k8, sk = fa.quant_operands(q, k)
        k8e, ske = (fa._expand_group(x, group) for x in (k8, sk))
        s = (torch.matmul(q8.to(f64), k8e.to(f64).transpose(-1, -2))
             * (sq.to(f64) * (scale * fa._LOG2E))
             * ske.to(f64).transpose(-1, -2))
        k_op = fa._expand_group(fa.dequantize_rows(k8, sk, v.dtype),
                                group).to(f64)
        q_op, dk_mul = fa.dequantize_rows(q8, sq, v.dtype).to(f64), scale
    else:
        s = torch.matmul(q2.to(f64), ke.to(f64).transpose(-1, -2))
        k_op, q_op, dk_mul = ke.to(f64), q2.to(f64), 1.0 / fa._LOG2E
    # ALiBi's bias where a pair is attended, -inf where it is not.
    bias = fa._plain_scores(torch.zeros_like(q2), ke, kw.get('mask'), causal,
                            co, 0, feat, scale)
    p = torch.exp2(s + bias.to(f64) - lse2.to(f64)[..., None])
    dp = torch.matmul(g.to(f64), ve.to(f64).transpose(-1, -2))
    # The size of each dot product's terms: sum |dO| |v|, sum |dO| |O|.
    dp_terms = torch.matmul(g.to(f64).abs(), ve.to(f64).abs().transpose(-1,
                                                                       -2))
    delta_terms = (g.to(f64).abs() * out.to(f64).abs()).sum(dim=-1)
    keep, inv = fa._keep(feat, q, k.shape[-2], co, 0)
    if keep is not None:
        dp = torch.where(keep, dp, 0.0) * inv
        dp_terms = torch.where(keep, dp_terms, 0.0) * inv
    ds = p * (dp - delta.to(f64)[..., None])
    # Each term's size before anything cancels.
    ds_terms = p * (dp_terms + delta_terms[..., None])
    dq = scale * torch.matmul(ds, k_op)
    dq_terms = scale * torch.matmul(ds_terms, k_op.abs())
    dk = dk_mul * torch.matmul(ds.transpose(-1, -2), q_op)
    dk_terms = dk_mul * torch.matmul(ds_terms.transpose(-1, -2),
                                     q_op.abs())
    if group > 1:
        dk, dk_terms = (x.reshape(*k.shape[:-2], group, *x.shape[-2:])
                        .sum(dim=-3) for x in (dk, dk_terms))
    return dq, dq_terms, dk, dk_terms


def cond_err(torch, got, want, terms):
    """The largest row error of ``got`` against the float64 ``want`` over
    the row's terms' magnitude ``terms`` (rows along the last axis; a row
    with no terms reads its absolute error)."""
    vnorm = torch.linalg.vector_norm
    diff = vnorm((got.to(want.dtype) - want).flatten(0, -2), dim=-1)
    mag = vnorm(terms.flatten(0, -2), dim=-1)
    return (diff / torch.where(mag > 0, mag, 1.0)).max().item()


def _f32_fwd_bwd(torch, fa, gen, d, dv, case, shape=F32_SHAPE):
    """K1 (with lse), K2 (where the case allows the bounded kernel) and
    K3/K4 on float32 operands at widths ``(d, dv)`` and ``shape`` (B, Hq,
    Hkv, Tq, Tk) against their plain float32 versions: the row statistic
    within TOL_F32_ROW, lse within TOL_F32_LSE, rows with no key exactly 0
    (K1's lse ln2*NEG_BIG), a second launch bit for bit the first, every
    launch a float32 kernel's. ``(row, failures)``."""
    dev = torch.device('cuda')
    b, hq, hkv, tq, tk = shape
    q = f32n(torch, (b, hq, tq, d), gen, dev)
    k = f32n(torch, (b, hkv, tk, d), gen, dev)
    v = f32n(torch, (b, hkv, tk, dv), gen, dev)
    g = f32n(torch, (b, hq, tq, dv), gen, dev)
    feat, empty = _f32_case_kw(torch, gen, case, b, hq, tq, tk)
    scale = 1.0 / math.sqrt(d)
    kw = dict(scale=scale, **feat)
    neg = fa._LN2 * fa._NEG_BIG
    tag = f'{case}_d{d}_dv{dv}' + ('' if shape == F32_SHAPE else
                                   f'_gqa{hq // hkv}_t{tq}')
    row, fails = {'phase': 'float32_path', 'case': tag, 'd': d, 'd_v': dv,
                  'q': list(q.shape), 'kv': list(k.shape),
                  'features': sorted(feat)}, []
    runs = {'k1': (lambda: fa.flash_attention_with_lse(q, k, v, **kw),
                   lambda: fa.flash_attention_plain_lse(q, k, v, **kw))}
    if case not in ('int8', 'alibi_pos') and 'dropout_rate' not in feat:
        bkw = dict(kw)
        runs['k2'] = (
            lambda: fa.flash_attention_bounded(q, k, v, save_lse=True,
                                               **bkw),
            lambda: fa.flash_attention_bounded_plain_lse(q, k, v, **bkw))
    out_k1 = lse_k1 = None
    for kern, (run, plain) in runs.items():
        before = fa.flash_attention.f32_launches + \
            fa.flash_attention_bounded.f32_launches
        out, lse = run()
        out2, lse2 = run()
        launched = fa.flash_attention.f32_launches + \
            fa.flash_attention_bounded.f32_launches - before
        out_p, lse_p = plain()
        torch.cuda.synchronize()
        row_rel, rel = rel_errs(torch, out, out_p)
        lse_err = (lse - lse_p).abs().max().item()
        exact = bool(not out[empty].any().item() and (
            kern == 'k2' or (lse[empty] == neg).all().item()))
        same = bool(torch.equal(out, out2) and torch.equal(lse, lse2))
        row[kern] = {'max_abs_err': (out - out_p).abs().max().item(),
                     'max_row_rel_err': row_rel, 'rel_err': rel,
                     'lse_max_abs_err': lse_err, 'empty_rows_exact': exact,
                     'repeat_bitwise': same, 'f32_launches': launched,
                     'dtype': str(out.dtype).split('.')[-1]}
        what = f'float32 {kern.upper()} {tag}'
        if not row_rel <= TOL_F32_ROW:
            fails.append(f'{what}: row rel err {row_rel} > {TOL_F32_ROW}')
        if not lse_err <= TOL_F32_LSE:
            fails.append(f'{what}: lse abs err {lse_err} > {TOL_F32_LSE}')
        if not (exact and same and launched == 2
                and out.dtype == torch.float32
                and tuple(out.shape) == (b, hq, tq, dv)):
            fails.append(f'{what}: empty rows exact {exact}, repeat bitwise '
                         f'{same}, float32 launches {launched}, out '
                         f'{out.dtype} {tuple(out.shape)}')
        if kern == 'k1':
            out_k1, lse_k1 = out, lse
    bkw = {n: x for n, x in kw.items() if n != 'scale'}
    before = (fa.flash_attention_dq.f32_launches,
              fa.flash_attention_dkv.f32_launches)
    got = fa.flash_attention_backward(q, k, v, out_k1, lse_k1, g,
                                      scale=scale, **bkw)
    again = fa.flash_attention_backward(q, k, v, out_k1, lse_k1, g,
                                        scale=scale, **bkw)
    launched = (fa.flash_attention_dq.f32_launches - before[0],
                fa.flash_attention_dkv.f32_launches - before[1])
    want = fa.flash_attention_backward_plain(q, k, v, out_k1, lse_k1, g,
                                             scale=scale, **bkw)
    torch.cuda.synchronize()
    errs = {n: rel_errs(torch, x, y)
            for n, x, y in zip(('dq', 'dk', 'dv'), got, want)}
    same = all(torch.equal(x, y) for x, y in zip(got, again))
    ok = [tuple(x.shape) == tuple(y.shape) and x.dtype == torch.float32
          for x, y in zip(got, (q, k, v))]
    dq64, tq64, dk64, tk64 = _f64_grads(torch, fa, q, k, v, g, out_k1, lse_k1,
                                        scale, feat)
    held = {'dq': cond_err(torch, got[0], dq64, tq64),
            'dk': cond_err(torch, got[1], dk64, tk64),
            'dv': errs['dv'][0]}
    row['bwd'] = {'max_abs_err': {n: (x - y).abs().max().item() for n, x, y
                                  in zip(('dq', 'dk', 'dv'), got, want)},
                  'max_row_rel_err': {n: e[0] for n, e in errs.items()},
                  'rel_err': {n: e[1] for n, e in errs.items()},
                  'held': held,
                  'plain_vs_float64': {
                      'dq': cond_err(torch, want[0], dq64, tq64),
                      'dk': cond_err(torch, want[1], dk64, tk64),
                      'dq_row_rel_err': rel_errs(torch, want[0], dq64)[0]},
                  'repeat_bitwise': same, 'f32_launches': launched,
                  'empty_rows_dq_exact': bool(
                      not got[0][empty].any().item())}
    for n, r in held.items():
        if not r <= TOL_F32_ROW:
            fails.append(f'float32 K3/K4 {tag} {n}: row err {r} > '
                         f'{TOL_F32_ROW}')
    if not (same and all(ok) and launched == (2, 2)
            and row['bwd']['empty_rows_dq_exact']):
        fails.append(f'float32 K3/K4 {tag}: repeat bitwise {same}, float32 '
                     f'shapes {ok}, launches {launched}, empty dq rows exact '
                     f'{row["bwd"]["empty_rows_dq_exact"]}')
    emit(row)
    return row, fails


def _f32_keep_pattern(torch, fa, gen):
    """The float32 K1's dropout keep pattern bit for bit the bf16 K1's and
    the reference hash's: v = eye(128), so the output is the dropped
    weights, exactly 0 where dropped."""
    dev = torch.device('cuda')
    q = f32n(torch, (2, 8, 128, 64), gen, dev)
    k = f32n(torch, (2, 8, 128, 64), gen, dev)
    v = torch.eye(128, device=dev).expand(2, 8, 128, 128).contiguous()
    kw = dict(dropout_rate=0.1, dropout_seed=2 ** 20 + 5)
    o32 = fa.flash_attention(q, k, v, **kw)
    o16 = fa.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(), **kw)
    keep, _ = fa.dropout_keep((2, 8), 128, 128, 0, 0, 0.1, 2 ** 20 + 5, dev)
    torch.cuda.synchronize()
    row = {'phase': 'float32_path', 'case': 'dropout_keep_pattern',
           'equals_bf16_kernel': bool(torch.equal(o32 == 0, o16 == 0)),
           'equals_hash': bool(torch.equal(o32 != 0, keep)),
           'dropped_share': (o32 == 0).float().mean().item()}
    emit(row)
    return [f'float32 K1 dropout: {n} is False' for n in
            ('equals_bf16_kernel', 'equals_hash') if not row[n]]


def _f32_slab(torch, gen, slots, h, h_kv, d, dv, t):
    """A float32 slab decode case: (q, k_new, v_new, cache_k, cache_v),
    unit-normal rows below each slot's fill, garbage past it."""
    dev, b, k = torch.device('cuda'), len(slots), VERIFY_K
    q = f32n(torch, (b, h, k, d), gen, dev)
    kn = f32n(torch, (b, h_kv, k, d), gen, dev)
    vn = f32n(torch, (b, h_kv, k, dv), gen, dev)
    ck = 30.0 * f32n(torch, (b, h_kv, t, d), gen, dev)
    cv = 30.0 * f32n(torch, (b, h_kv, t, dv), gen, dev)
    for i, (f, _) in enumerate(slots):
        ck[i, :, :f] = f32n(torch, (h_kv, f, d), gen, dev)
        cv[i, :, :f] = f32n(torch, (h_kv, f, dv), gen, dev)
    return q, kn, vn, ck, cv


def _f32_decode_case(torch, fd, x, vectors, kw):
    """One float32 K5/K5p call (``kw``: its knobs, page_table for K5p) and
    the same call again and on the plain version, each on its own copy of
    the cache: ``(out, readings, failures-free flags)``."""
    q, kn, vn, ck, cv = x
    vt, ap = vectors
    c = [(ck.clone(), cv.clone()) for _ in range(3)]
    out = fd.flash_decode(q, kn, vn, *c[0], vt, ap, **kw)[0]
    again = fd.flash_decode(q, kn, vn, *c[1], vt, ap, **kw)[0]
    ref = fd.flash_decode_plain(q, kn, vn, *c[2], vt, ap, **kw)[0]
    torch.cuda.synchronize()
    errs, err, finite = _decode_errs(torch, out, ref)
    flags = {'cache_bit_identical': all(torch.equal(a, b) for a, b in zip(
                 c[0] if 'page_table' not in kw else
                 (c[0][0][:-1], c[0][1][:-1]),
                 c[2] if 'page_table' not in kw else
                 (c[2][0][:-1], c[2][1][:-1]))),
             'repeat_bit_identical': _same(torch, out, again),
             'finite': finite,
             'float32': all(t.dtype == torch.float32 for t in (
                 out if isinstance(out, tuple) else (out,)))}
    return out, {'max_abs_err': err, 'max_row_rel_err': {
        n: e[0] for n, e in errs.items()}, **flags}, errs


def _f32_decode(torch, fd, gen):
    """K5 and K5p on float32 caches at F32_DECODE_DIMS (GQA 8:2, t_max
    4096), one new row and verify k = 5: each against its plain version
    (row statistic within TOL_F32_ROW), caches bit for bit the plain
    append (pools but the sink), a repeat bit for bit, verify bit for bit
    its sequential one-row launches; K5 at block_k 128 bit for bit the
    default split and at 512 bit for bit its own sequential launches; K5p
    at F32_PAGES bit for bit K5 on the gathered slab; with one new row the
    partials, a window, ALiBi and the int8 mirror (the scores' row maxima
    and the mirror rows bit for bit). ``(worst readings of each kernel,
    failures)``."""
    dev, h, h_kv, t = torch.device('cuda'), 8, 2, COV_T_MAX
    fails, worst = [], {}

    def hold(row, key, readings, errs, what):
        row[key] = readings
        _worse(worst, 'flash_decode_paged' if 'K5p' in what
               else 'flash_decode', readings['max_abs_err'],
               max(e[0] for e in errs.values()))
        fails.extend(f'{what}: {n} row rel err {e[0]} > {TOL_F32_ROW}'
                     for n, e in errs.items() if not e[0] <= TOL_F32_ROW)
        fails.extend(f'{what}: {n} is False'
                     for n, v in readings.items() if v is False)

    for d, dv in F32_DECODE_DIMS:
        for k in (1, VERIFY_K):
            sl = _one_row(COV_SLOTS) if k == 1 else COV_SLOTS
            vt, ap, nn = _verify_vectors(torch, sl, k, dev)
            q, kn, vn, ck, cv = _f32_slab(torch, gen, sl, h, h_kv, d, dv, t)
            q, kn, vn = (x[:, :, :k].contiguous() for x in (q, kn, vn))
            x = (q, kn, vn, ck, cv)
            base = dict(scale=1.0 / math.sqrt(d), n_new=nn)
            tag = f'd{d}_dv{dv}_k{k}'
            row = {'phase': 'float32_path', 'case': f'decode_{tag}',
                   't_max': t}
            outs = {}
            for split in (None, *F32_BLOCK_K):
                key = 'block_k_none' if split is None else f'block_k_{split}'
                out, got, errs = _f32_decode_case(
                    torch, fd, x, (vt, ap), dict(base, block_k=split))
                c = (ck.clone(), cv.clone())
                seq = _sequential(torch, fd, q, kn, vn, *c, vt, ap, nn,
                                  block_k=split, scale=base['scale'])
                got['equals_sequential'] = _same(torch, out, seq)
                outs[split] = out
                hold(row, key, got, errs, f'float32 K5 {tag} {key}')
            row['block_k_128_equals_default'] = _same(torch, outs[None],
                                                      outs[128])
            if not row['block_k_128_equals_default']:
                fails.append(f'float32 K5 {tag}: block_k 128 differs from '
                             f'the default split')
            for ps in F32_PAGES:
                kp, vp, table = paged_twin(torch, gen, ck, cv, ps)
                out, got, errs = _f32_decode_case(
                    torch, fd, (q, kn, vn, kp, vp), (vt, ap),
                    dict(base, page_table=table))
                slab = [fd.gather_pages(z, table) for z in (kp, vp)]
                on_slab = fd.flash_decode(q, kn, vn, *slab, vt, ap,
                                          **base)[0]
                got['equals_k5_on_gathered_slab'] = _same(torch, out,
                                                          on_slab)
                hold(row, f'page_{ps}', got, errs,
                     f'float32 K5p {tag} page {ps}')
            if k == 1:
                slopes = torch.tensor(ALIBI_SLOPES, device=dev)
                for name, extra in (
                        ('partials', dict(partials=True)),
                        ('window', dict(window=F32_WINDOW)),
                        ('alibi', dict(alibi_slopes=slopes))):
                    _, got, errs = _f32_decode_case(
                        torch, fd, x, (vt, ap), dict(base, **extra))
                    hold(row, name, got, errs, f'float32 K5 {tag} {name}')
                c = [(ck.clone(), cv.clone(), *_mirror(torch, fd, ck))
                     for _ in range(2)]
                ikw = dict(base, qk_quant='int8', partials=True)
                got = fd.flash_decode(q, kn, vn, c[0][0], c[0][1], vt, ap,
                                      k_q=c[0][2], k_scale=c[0][3],
                                      **ikw)[0]
                want = fd.flash_decode_plain(q, kn, vn, c[1][0], c[1][1],
                                             vt, ap, k_q=c[1][2],
                                             k_scale=c[1][3], **ikw)[0]
                torch.cuda.synchronize()
                errs, err, finite = _decode_errs(torch, got, want)
                hold(row, 'int8', {
                    'max_abs_err': err,
                    'max_row_rel_err': {n: e[0] for n, e in errs.items()},
                    'scores_max_bit_identical': bool(torch.equal(got[1],
                                                                 want[1])),
                    'mirror_bit_identical': bool(
                        torch.equal(c[0][2], c[1][2])
                        and torch.equal(c[0][3], c[1][3])),
                    'cache_bit_identical': bool(
                        torch.equal(c[0][0], c[1][0])
                        and torch.equal(c[0][1], c[1][1])),
                    'finite': finite}, {'num': errs['num']},
                    f'float32 K5 int8 {tag}')
            emit(row)
    return worst, fails


def _worse(worst, name, abs_err, row_err, lse_err=None):
    """Raise kernel ``name``'s worst readings in ``worst`` to these."""
    w = worst.setdefault(name, {'max_abs_err': 0.0, 'max_row_rel_err': 0.0})
    w['max_abs_err'] = max(w['max_abs_err'], abs_err)
    w['max_row_rel_err'] = max(w['max_row_rel_err'], row_err)
    if lse_err is not None:
        w['lse_max_abs_err'] = max(w.get('lse_max_abs_err', 0.0), lse_err)


def _f32_kernels(torch, ddp, gen):
    """Every float32 kernel against its plain float32 version: K1-K4 at
    F32_DIMS in each case of :func:`_f32_case_kw`, the dropout keep
    pattern, K5/K5p (:func:`_f32_decode`). ``(worst readings of each
    kernel, failures)``."""
    import importlib
    fa = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_attention')
    fd = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_decode')
    fails, worst = [], {}
    cases = [(d, dv, case, F32_SHAPE) for d, dv in F32_DIMS
             for case in ('causal', 'mask', 'ext', 'alibi_pos', 'int8')]
    cases += [(96, 96, case, shape) for case, shape in F32_RAGGED]
    for d, dv, case, shape in cases:
        row, f = _f32_fwd_bwd(torch, fa, gen, d, dv, case, shape)
        fails += f
        for kern, name in (('k1', 'flash_attention'),
                           ('k2', 'flash_attention_bounded')):
            if kern in row:
                _worse(worst, name, row[kern]['max_abs_err'],
                       row[kern]['max_row_rel_err'],
                       row[kern]['lse_max_abs_err'])
        b = row['bwd']
        _worse(worst, 'flash_attention_dq', b['max_abs_err']['dq'],
               b['held']['dq'])
        _worse(worst, 'flash_attention_dkv',
               max(b['max_abs_err'][n] for n in ('dk', 'dv')),
               max(b['held'][n] for n in ('dk', 'dv')))
    fails += _f32_keep_pattern(torch, fa, gen)
    decode, f = _f32_decode(torch, fd, gen)
    worst.update(decode)
    fails += f
    emit({'phase': 'float32_path', 'case': 'worst', 'kernels': worst,
          'tol_row': TOL_F32_ROW, 'tol_lse': TOL_F32_LSE})
    return worst, fails


def _f32_bwd_occupancy():
    """K3 f32 and K4 f32 (csrc/flash_bwd_f32.cu's base library) at (96, 96)
    and (256, 256): each kernel's dynamic shared memory, threads a block,
    blocks an SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), the
    computing warps an SM that makes (the producer warpgroup aside) and
    ``ptxas``'s registers and spill bytes (stored + loaded). At (96, 96)
    each must run at least 8 computing warps an SM. ``(row,
    failures)``."""
    import ctypes
    from distributed_dot_product_tpu_torch.ops import _build
    fn = _build.load('flash_f32_bwd').flash_bwd_f32_occupancy
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    res = _build.resources('flash_f32_bwd')
    row, fails = {'phase': 'float32_path', 'case': 'bwd_occupancy',
                  'card': CARD, 'kernels': {}}, []
    for d, dv in ((96, 96), (256, 256)):
        for kind, name in ((0, 'flash_dq_f32_kernel'),
                           (1, 'flash_dkv_f32_kernel')):
            vals = [ctypes.c_int() for _ in range(3)]
            err = fn(kind, d, dv, 0, *(ctypes.addressof(x) for x in vals))
            smem, threads, blocks = (x.value for x in vals)
            regs = [rs for m, rs in res.items() if name in m
                    and f'ILi{d}ELi{dv}ELb0ELb0E' in m]
            k = {'smem_bytes': smem, 'threads': threads,
                 'blocks_per_sm': blocks,
                 'computing_warps_per_sm': blocks * (threads - 128) // 32,
                 'registers': regs[0][0] if regs else None,
                 'spill_bytes': regs[0][1] if regs else None, 'error': err}
            row['kernels'][f'{name}<{d},{dv}>'] = k
            if (d, dv) == (96, 96) and not (
                    err == 0 and k['computing_warps_per_sm'] >= 8):
                fails.append(f'{name} at (96, 96): {k}')
    emit(row)
    return row, fails


def _f32_fwd_occupancy():
    """K1 f32 / K2 f32 (csrc/flash_f32.cu's base library) at (96, 96) and
    (256, 256): the kernel's dynamic shared memory, threads a block, blocks
    an SM, the computing warps an SM that makes (the producer warpgroup
    aside) and ``ptxas``'s registers and spill bytes; at (96, 96) at least
    8 computing warps an SM. Beside it the (96, 96) kernel's SASS
    (``cuobjdump -sass`` of the built library): its HGMMA instructions with
    TF32 operands (S and P.V on wgmma), which must be there. ``(row,
    failures)``."""
    import ctypes
    from distributed_dot_product_tpu_torch.ops import _build
    fn = _build.load('flash_f32').flash_fwd_f32_occupancy
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    res = _build.resources('flash_f32')
    name = 'flash_fwd_f32_kernel'
    row, fails = {'phase': 'float32_path', 'case': 'fwd_occupancy',
                  'card': CARD, 'kernels': {}}, []
    for d, dv in ((96, 96), (256, 256)):
        vals = [ctypes.c_int() for _ in range(4)]
        err = fn(d, dv, 0, *(ctypes.addressof(x) for x in vals))
        smem, threads, blocks, computing = (x.value for x in vals)
        regs = [rs for m, rs in res.items() if name in m
                and f'ILi{d}ELi{dv}ELb0ELb0E' in m]
        k = {'smem_bytes': smem, 'threads': threads, 'blocks_per_sm': blocks,
             'computing_warps_per_sm': blocks * computing // 32,
             'registers': regs[0][0] if regs else None,
             'spill_bytes': regs[0][1] if regs else None, 'error': err}
        row['kernels'][f'{name}<{d},{dv}>'] = k
        if (d, dv) == (96, 96) and not (
                err == 0 and k['computing_warps_per_sm'] >= 8):
            fails.append(f'{name} at (96, 96): {k}')
    row['sass_96'] = sass = _tf32_hgmma(_build, name + 'ILi96ELi96ELb0ELb0E')
    if not sass.get('tf32_hgmma'):
        fails.append(f'{name}<96,96> issues no TF32 HGMMA: {sass}')
    emit(row)
    return row, fails


def _sass_of(build, lib, mangled):
    """The SASS lines (``cuobjdump -sass`` of the built library ``lib``) of
    the kernel whose mangled name holds ``mangled``."""
    tool = os.path.join(os.path.dirname(build._nvcc()), 'cuobjdump')
    sass = subprocess.run([tool, '-sass', str(build._target(lib))],
                          capture_output=True, text=True, timeout=300).stdout
    body, inside = [], False
    for line in sass.splitlines():
        if 'Function :' in line:
            inside = mangled in line
        elif inside:
            body.append(line)
    return body


def _tf32_hgmma(build, mangled):
    """The HGMMA instructions of the kernel whose mangled name holds
    ``mangled`` in the built ``flash_f32`` library's SASS: ``{tf32_hgmma:
    count with TF32 operands, shapes: {mnemonic: count}}``."""
    body = _sass_of(build, 'flash_f32', mangled)
    shapes = {}
    for m in re.findall(r'\b(HGMMA\.[\w.]+)', '\n'.join(body)):
        shapes[m] = shapes.get(m, 0) + 1
    return {'function_found': bool(body), 'shapes': shapes,
            'tf32_hgmma': sum(n for m, n in shapes.items() if 'TF32' in m)}


def _f32_decode_occupancy():
    """K5/K5p f32 (the ``flash_decode_f32`` library) at (96, 96) and (256,
    256), one query row, slab: the block's dynamic shared memory, the steps
    a warp keeps in flight (``flash_decode_stages``), blocks an SM
    (clusters of one block the card holds at once, over its SMs), the
    8-block clusters it holds at once (the greedy shape's), and ``ptxas``'s
    registers and spill bytes of each instantiation; at (96, 96) at least 2
    steps a warp. Beside it the SASS of the (96, 96) float32 kernel
    (``cuobjdump -sass``): its FFMA and bulk copies, and no HMMA (the
    products are FFMA; the int8 mirror's s8 products are another
    instantiation). ``(row, failures)``."""
    import ctypes
    from distributed_dot_product_tpu_torch.ops import _build
    import torch
    lib = _build.load('flash_decode_f32')
    for fn, n in ((lib.flash_decode_stages, 3),
                  (lib.flash_decode_max_clusters, 7),
                  (lib.flash_decode_smem, 8)):
        fn.argtypes, fn.restype = [ctypes.c_int] * n, ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = _build.resources('flash_decode_f32')
    name = 'flash_decode_f32_kernel'
    row, fails = {'phase': 'float32_path', 'case': 'decode_f32_occupancy',
                  'card': CARD, 'kernels': {}}, []
    for d, dv in ((96, 96), (256, 256)):
        k = {'smem_bytes': lib.flash_decode_smem(1, 1, d, dv, 0, COV_T_MAX,
                                                 0, 1),
             'steps_in_flight': lib.flash_decode_stages(d, dv, 0),
             'int8_steps_in_flight': lib.flash_decode_stages(d, dv, 1),
             'blocks_per_sm': lib.flash_decode_max_clusters(
                 1, 1, d, dv, 0, 0, 1) / sms,
             'clusters_of_8': lib.flash_decode_max_clusters(1, 1, d, dv, 0,
                                                            0, 8),
             'ptxas': {kernel_label(m): list(rs) for m, rs in res.items()
                       if name in m and f'ILi{d}ELi{dv}E' in m}}
        row['kernels'][f'{name}<{d},{dv}>'] = k
        if (d, dv) == (96, 96) and not k['steps_in_flight'] >= 2:
            fails.append(f'{name} at (96, 96): {k}')
    body = _sass_of(_build, 'flash_decode_f32',
                    name + 'ILi96ELi96ELb0ELb0E')
    ops = {}
    for m in re.findall(r'\b(HMMA|FFMA|UBLKCP|LDGSTS)\b', '\n'.join(body)):
        ops[m] = ops.get(m, 0) + 1
    row['sass_96'] = sass = {'function_found': bool(body), 'ops': ops}
    if not body or ops.get('HMMA', 0) or not ops.get('FFMA', 0):
        fails.append(f'{name}<96,96> SASS: {sass}')
    emit(row)
    return row, fails


def f32_bound_ms(flops, nbytes, rate=F32_FLOPS):
    """``(ms, by)``: a float32 kernel's bound, operations at ``rate``
    (F32_FLOPS: 3xTF32) and bytes at the card's memory rate."""
    t_ops = flops / rate
    t_bytes = nbytes / perf().DEFAULT_PEAKS.bytes_per_s
    return 1e3 * max(t_ops, t_bytes), ('operations' if t_ops > t_bytes
                                       else 'bytes')


def sdpa_backend(torch, fn):
    """The backend SDPA picked for ``fn`` (one call), from the names of
    the kernels torch.profiler saw run: ``(name, first kernel names)``. A
    session that recorded no device event (the profiler lost its trace)
    is taken again, seven times at most, a moment apart, as in
    :func:`kernels_per_call`."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(8):
        if attempt:
            time.sleep(0.2)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if str(e.device_type).endswith('CUDA')
                 and not e.name.startswith(('Memcpy', 'Memset'))]
        if names:
            break
    low = [n.lower() for n in names]
    for key, label in (('flash', 'flash'), ('fmha', 'efficient'),
                       ('efficient', 'efficient'), ('cudnn', 'cudnn')):
        if any(key in n for n in low):
            return label, names[:3]
    return ('math' if names else 'not seen by the profiler'), names[:3]


def _near_tie(torch, logits):
    """The gap between a logit row's two largest entries over its
    largest magnitude."""
    top = logits.float().topk(2).values
    return ((top[0] - top[1]) / logits.float().abs().max()).item()


def _first_divergence(a, b):
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n


def _f32_readme(torch, ddp):
    """README "Resilient serving" as written: ``Scheduler(KernelEngine(
    slots=8, t_max=4096), ServeConfig(queue_limit=64,
    max_new_tokens=256))``, every other setting the engine's default
    (float32, vocab 64, 2 heads of 8), 16 seeded prompts of 1..64 tokens:
    each completed, the slab K5's float32 kernel launched once a decode
    step. ``(row, failures)``."""
    import numpy as np
    from distributed_dot_product_tpu_torch.serve import (
        KernelEngine, Scheduler, ServeConfig,
    )
    sched = Scheduler(KernelEngine(slots=8, t_max=4096),
                      ServeConfig(queue_limit=64, max_new_tokens=256))
    engine = sched.engine

    def decode_steps():      # the process-wide registry the example uses
        return sched.registry.snapshot()['counters'].get(
            'serve.decode_steps', 0)
    before = decode_steps()
    rng = np.random.default_rng(SERVE_SEED)
    _f32_zero(ddp)
    t0 = time.perf_counter()
    for i in range(16):
        sched.submit(rng.integers(0, engine.vocab,
                                  size=int(rng.integers(1, 65))
                                  ).astype(np.int32), request_id=f'r{i}')
    results = sched.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = decode_steps() - before
    sched.close()
    row = {'phase': 'float32_path', 'case': 'readme_resilient_serving',
           'card': CARD, 'dtype': str(engine.dtype).split('.')[-1],
           'engine': {'vocab': engine.vocab, 'heads': engine.heads,
                      'head_dim': engine.head_dim,
                      'cache_mode': engine.cache_mode,
                      'decode_impl': engine.decode_impl},
           'terminal': sorted({r.status for r in results.values()}),
           'tokens': sum(len(r.tokens) for r in results.values()),
           'decode_steps': steps, 'wall_s': wall,
           'f32_launches': _f32_counts(ddp)}
    emit(row)
    fails = []
    if engine.dtype != torch.float32 or row['terminal'] != ['completed'] \
            or len(results) != 16:
        fails.append(f'README serving: dtype {engine.dtype}, terminal '
                     f'{row["terminal"]}, {len(results)} results')
    if row['f32_launches']['flash_decode'] != steps or not steps:
        fails.append(f'README serving: float32 K5 launched '
                     f'{row["f32_launches"]["flash_decode"]} times for '
                     f'{steps} decode steps')
    return row, fails


def _f32_engine(torch, ddp):
    """README "Resilient serving" at the engine's default dtype:
    serve_path's burst through ``Scheduler(KernelEngine(slots=8,
    t_max=4096), ServeConfig(queue_limit=64, max_new_tokens=256))`` at
    serve_path's LM widths, dtype left at KernelEngine's float32 default,
    slab (K5) and paged (page 16, K5p); the same engines with
    ``decode_impl='plain'`` on the card, whose greedy streams the kernel
    engines' must equal (a divergence is a fault unless the plain
    engine's logits at its first differing token are a near tie: top-2 gap
    at most F32_NEAR_TIE of the largest logit); beside them the bf16
    engines of the same call (serve_path's runs, the same configuration
    and burst; run here when serve_path did not run). ``(launches,
    failures)``."""
    import numpy as np
    burst = serve_burst()
    fails, rows, res, engines = [], {}, {}, {}
    for mode in ('slab', 'paged'):
        bf16 = SAME_CALL.get(f'serve_path_{mode}')
        if bf16 is not None:
            rows[(mode, 'kernel_bf16')] = {
                'tokens_per_s': bf16['tokens_per_s'],
                'ttft_s': {'p99': bf16['ttft_p99_s']}}
        for impl, dtype in (('kernel', 'default'), ('plain', 'default'),
                            ('kernel_bf16', torch.bfloat16)):
            if (mode, impl) in rows:
                continue
            engine = serve_engine(torch, mode, dtype=dtype,
                                  decode_impl=impl.split('_')[0])
            want = torch.bfloat16 if dtype != 'default' else torch.float32
            if engine.dtype != want:
                fails.append(f'float32 engine {mode} {impl}: dtype '
                             f'{engine.dtype}')
            _f32_zero(ddp)
            ddp.flash_attention.launches = 0
            results, row = _serve_burst(torch, ddp, engine, burst,
                                        f'float32 engine {mode} {impl}')
            f32 = _f32_counts(ddp)
            row = {'phase': 'float32_path', 'case': f'engine_{mode}_{impl}',
                   'card': CARD, 'decode_impl': impl.split('_')[0],
                   'f32_launches': {'flash_attention': f32['flash_attention'],
                                    'flash_decode': f32['flash_decode'],
                                    'flash_decode_paged':
                                        f32['flash_decode_paged']},
                   **row}
            emit(row)
            rows[(mode, impl)], res[(mode, impl)] = row, results
            if impl != 'kernel_bf16':
                engines[(mode, impl)] = engine
            else:
                del engine
        own = 'flash_decode' if mode == 'slab' else 'flash_decode_paged'
        kr = rows[(mode, 'kernel')]
        if kr['f32_launches'][own] != kr['decode_steps'] or \
                kr['f32_launches'][own] == 0 or \
                kr['launches'][own] != kr['decode_steps']:
            fails.append(f'float32 engine {mode}: {own} float32 launches '
                         f'{kr["f32_launches"][own]} for '
                         f'{kr["decode_steps"]} decode steps')
        if sum(rows[(mode, 'plain')]['launches'].values()):
            fails.append(f'float32 engine {mode} plain: decode kernels '
                         f'launched {rows[(mode, "plain")]["launches"]}')
        kern, plain = res[(mode, 'kernel')], res[(mode, 'plain')]
        equal, ties, diverged = [], {}, {}
        for rid, prompt in burst:
            a, b = kern[rid].tokens, plain[rid].tokens
            if kern[rid].status == plain[rid].status and list(a) == list(b):
                equal.append(rid)
                continue
            n = _first_divergence(list(a), list(b))
            ext = np.concatenate([prompt, np.asarray(b[:n], np.int32)])
            eng = engines[(mode, 'plain')]
            for i in range(eng.slots):
                eng.reset(i)
            gap = _near_tie(torch, first_step_logits(torch, eng, [ext])[0])
            (ties if gap <= F32_NEAR_TIE else diverged)[rid] = {
                'at_token': n, 'top2_gap_rel': gap}
        row = {'phase': 'float32_path', 'case': f'engine_{mode}_streams',
               'requests': len(burst), 'equal_to_plain': len(equal),
               'share_equal': len(equal) / len(burst),
               'near_ties': ties, 'diverged': diverged,
               'tokens_per_s': {i: rows[(mode, i)]['tokens_per_s']
                                for i in ('kernel', 'plain', 'kernel_bf16')},
               'ttft_p99_s': {i: rows[(mode, i)]['ttft_s']['p99']
                              for i in ('kernel', 'plain', 'kernel_bf16')}}
        emit(row)
        if diverged:
            fails.append(f'float32 engine {mode}: streams differ from the '
                         f'plain decode (no near tie): {diverged}')
        for impl in ('kernel', 'plain'):
            engines.pop((mode, impl))
        torch.cuda.empty_cache()
    return {mode: rows[(mode, 'kernel')]['f32_launches']
            for mode in ('slab', 'paged')}, fails


def _f32_lm(torch, ddp):
    """``TransformerLM(vocab_size=32768, dim=768, num_heads=8,
    n_layers=16)`` at ``dtype=None`` (float32 compute and parameters),
    remat, B 4 x T 4096: the first step's loss against the same weights
    on ``softmax_impl='full'`` (cuBLAS float32) within TOL_F32_REL, then
    F32_LM_STEPS Adam 3e-4 steps (ms, peak memory, K1/K3/K4 float32
    launches a step, counts at 0 just before); then greedy_generate at
    main_path's shape (batch 4, prompt 1000, 64 steps), its tokens equal
    to the same weights' plain decode (``decode_impl='plain'``; a near tie
    at the first differing token excepted). ``(launches, failures)``."""
    from distributed_dot_product_tpu_torch.models.lm import greedy_generate
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(F32_SEED)
    fails = []
    model = ddp.TransformerLM(VOCAB, DIM, HEADS, n_layers=LAYERS,
                              remat=True, device=dev, generator=gen)
    dtypes = sorted({str(p.dtype) for p in model.parameters()})
    tokens = torch.randint(0, VOCAB, (TRAIN_B, TRAIN_T), generator=gen
                           ).to(dev)
    batch = (tokens, ddp.lm_targets(tokens))
    ref = ddp.TransformerLM(VOCAB, DIM, HEADS, n_layers=LAYERS,
                            attn_kwargs=dict(softmax_impl='full'),
                            device=dev, generator=torch.Generator())
    ref.load_state_dict(model.state_dict())
    with torch.no_grad():
        loss_sum, count = ref.nll_sum(*batch, chunk=LOSS_CHUNK)
        ref_loss = (loss_sum / count).item()
    del ref
    torch.cuda.empty_cache()
    optimizer = torch.optim.Adam(model.parameters(), lr=LR,
                                 betas=(0.9, 0.999), eps=1e-8)
    step = ddp.make_lm_train_step(model, optimizer, loss_chunk=LOSS_CHUNK)
    _f32_zero(ddp)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, per_step = [], [], []
    for _ in range(F32_LM_STEPS):
        before = _f32_counts(ddp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step(batch).item())
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        per_step.append({n: c - before[n]
                         for n, c in _f32_counts(ddp).items() if c})
    train = {n: c for n, c in _f32_counts(ddp).items() if c}
    peak = torch.cuda.max_memory_allocated()
    loss_rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    expected = {'flash_attention': 2 * LAYERS, 'flash_attention_dq': LAYERS,
                'flash_attention_dkv': LAYERS}
    del optimizer, step, batch
    torch.cuda.empty_cache()

    prompts = tokens[:, :PROMPT]
    greedy_generate(model, prompts, 2, T_MAX)         # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    greedy_generate(model, prompts, 1, T_MAX)         # prefill only
    torch.cuda.synchronize()
    prefill_ms = 1e3 * (time.perf_counter() - t0)
    _f32_zero(ddp)
    t0 = time.perf_counter()
    out = greedy_generate(model, prompts, STEPS, T_MAX)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    greedy = {n: c for n, c in _f32_counts(ddp).items() if c}
    plain = ddp.TransformerLM(VOCAB, DIM, HEADS, n_layers=LAYERS,
                              attn_kwargs=dict(decode_impl='plain'),
                              device=dev, generator=torch.Generator())
    plain.load_state_dict(model.state_dict())
    want = greedy_generate(plain, prompts, STEPS, T_MAX)
    torch.cuda.synchronize()
    ties, diverged = {}, {}
    for i in range(out.shape[0]):
        a, b = out[i].tolist(), want[i].tolist()
        if a == b:
            continue
        n = _first_divergence(a, b)
        ext = torch.cat([prompts[i], want[i, :n].to(prompts.dtype)])[None]
        with torch.inference_mode():
            _, logits = plain.prefill(ext, plain.make_decode_caches(
                1, T_MAX))
        gap = _near_tie(torch, logits[0, -1])
        (ties if gap <= F32_NEAR_TIE else diverged)[i] = {
            'at_token': n, 'top2_gap_rel': gap}
    del plain
    row = {'phase': 'float32_path', 'case': 'lm', 'card': CARD,
           'lm': dict(vocab=VOCAB, dim=DIM, heads=HEADS, layers=LAYERS,
                      dtype=None, remat=True),
           'parameter_dtypes': dtypes, 'batch': [TRAIN_B, TRAIN_T],
           'losses': losses, 'full_f32_loss': ref_loss,
           'loss_rel_err_vs_full': loss_rel, 'tol': TOL_F32_REL,
           'step_ms': step_ms,
           'ms_per_step_median': statistics.median(step_ms[1:]),
           'max_memory_allocated': peak,
           'f32_launches_per_step': per_step,
           'expected_per_step': expected, 'f32_launches': train,
           'greedy': {'batch': [BATCH, PROMPT], 'steps': STEPS,
                      'prefill_ms': prefill_ms,
                      'ms_per_decode_step':
                          (1e3 * gen_s - prefill_ms) / (STEPS - 1),
                      'tokens_per_s': BATCH * STEPS / gen_s,
                      'f32_launches': greedy,
                      'rows_equal_to_plain_decode':
                          out.shape[0] - len(ties) - len(diverged),
                      'near_ties': ties, 'diverged': diverged}}
    emit(row)
    if dtypes != ['torch.float32'] or not all(
            math.isfinite(x) for x in losses):
        fails.append(f'float32 LM: parameters {dtypes}, losses {losses}')
    if not loss_rel <= TOL_F32_REL:
        fails.append(f'float32 LM: first loss rel err vs full {loss_rel} > '
                     f'{TOL_F32_REL}')
    if any(c != expected for c in per_step):
        fails.append(f'float32 LM: float32 launches a step {per_step}, '
                     f'want {expected}')
    want_g = {'flash_attention': LAYERS, 'flash_decode': LAYERS * (STEPS - 1)}
    if greedy != want_g or tuple(out.shape) != (BATCH, STEPS):
        fails.append(f'float32 LM greedy: float32 launches {greedy}, want '
                     f'{want_g}; tokens {tuple(out.shape)}')
    if diverged:
        fails.append(f'float32 LM greedy: rows differ from the plain decode '
                     f'(no near tie): {diverged}')
    del model
    torch.cuda.empty_cache()
    return {'train': train, 'greedy': greedy}, fails


def _f32_module(torch, ddp, flush):
    """The paper's module at entry()'s shapes, float32: ``Distributed
    DotProductAttn(key_dim=512, num_heads=8, offset=64,
    softmax_impl='flash')`` (dtype None) at B 4 x T 8192, causal and not,
    and causal with ``flash_softmax_mode='bounded'`` (K2): forward and
    input gradients, the first F32_MOD_REF_B rows within TOL_F32_REL of
    the same weights on ``softmax_impl='full'`` (float32, on the card);
    ms a step; float32 launches a step (counts at 0 just before).
    ``(launches, failures)``."""
    dev = torch.device('cuda')
    gen = torch.Generator().manual_seed(F32_SEED)
    fails, launches = [], {}
    b, t, kd = F32_MOD_B, F32_MOD_T, F32_MOD['key_dim']
    x = [f32n(torch, (b, t, kd), gen, dev) for _ in range(3)]
    gy = f32n(torch, (b, t, kd), gen, dev)
    for case, causal, mode in (('causal', True, 'exact'),
                               ('not_causal', False, 'exact'),
                               ('causal_bounded', True, 'bounded')):
        mod = ddp.DistributedDotProductAttn(
            **F32_MOD, softmax_impl='flash', causal=causal,
            flash_softmax_mode=mode, device=dev,
            generator=torch.Generator().manual_seed(F32_SEED))
        ref = ddp.DistributedDotProductAttn(
            **F32_MOD, softmax_impl='full', causal=causal, device=dev)
        ref.load_state_dict(mod.state_dict())

        def step():
            ins = [a.detach().requires_grad_() for a in x]
            y = mod(*ins)
            return y, torch.autograd.grad(y, ins, gy)
        step()
        torch.cuda.synchronize()
        _f32_zero(ddp)
        y, grads = step()
        torch.cuda.synchronize()
        counts = {n: c for n, c in _f32_counts(ddp).items() if c}
        ms = time_ms(torch, step, flush, reps=5)
        rb = F32_MOD_REF_B
        ins = [a[:rb].detach().requires_grad_() for a in x]
        y_ref = ref(*ins)
        g_ref = torch.autograd.grad(y_ref, ins, gy[:rb])
        errs = {'out': rel_errs(torch, y[:rb], y_ref)}
        errs.update({f'd{n}': rel_errs(torch, gr[:rb], gw) for n, gr, gw in
                     zip(('keys', 'queries', 'values'), grads, g_ref)})
        k1 = 'flash_attention_bounded' if mode == 'bounded' \
            else 'flash_attention'
        want = {k1: 1, 'flash_attention_dq': 1, 'flash_attention_dkv': 1}
        row = {'phase': 'float32_path', 'case': f'module_{case}',
               'card': CARD,
               'module': dict(F32_MOD, softmax_impl='flash', causal=causal,
                              flash_softmax_mode=mode, dtype=None),
               'batch': [b, t], 'ms_per_step': ms,
               'out_dtype': str(y.dtype).split('.')[-1],
               'f32_launches': counts, 'held_rows': rb,
               'rel_err_vs_full_f32': {n: e[1] for n, e in errs.items()},
               'max_row_rel_err_vs_full_f32': {n: e[0]
                                               for n, e in errs.items()},
               'tol': TOL_F32_REL}
        emit(row)
        fails += [f'float32 module {case} {n}: rel err {e[1]} > '
                  f'{TOL_F32_REL}' for n, e in errs.items()
                  if not e[1] <= TOL_F32_REL]
        if counts != want or y.dtype != torch.float32:
            fails.append(f'float32 module {case}: launches {counts}, want '
                         f'{want}; out {y.dtype}')
        launches[case] = counts
        del mod, ref, y, grads, y_ref, g_ref, ins
        torch.cuda.empty_cache()
    return launches, fails


def _f32_attn_bound(d, dv, rows_q, rows_k, pairs):
    """``{k1, k3, k4}: (ms, by)`` of the float32 kernels: K1 2(d + dv)
    operations a pair, K3 4d + 2dv, K4 4(d + dv), at F32_FLOPS; q, k, v,
    out (dO) read or written once in 4-byte elements, lse (lse2, delta)
    and the gradients."""
    io = 4 * (rows_q * (d + dv) + rows_k * (d + dv))
    return {'k1': f32_bound_ms(2 * pairs * (d + dv), io + 4 * rows_q),
            'k3': f32_bound_ms(pairs * (4 * d + 2 * dv),
                               io + 8 * rows_q + 4 * rows_q * d),
            'k4': f32_bound_ms(pairs * 4 * (d + dv),
                               io + 8 * rows_q + 4 * rows_k * (d + dv))}


def _f32_timing(torch, ddp, flush, gen):
    """Each float32 kernel's ms at the LM's shape (4 x 8 x 4096, d 96,
    causal; K2 on its precomputed bound), the bf16 kernel of the same
    call, the plain float32 version, SDPA at float32 (the backend it
    picked; its backward alone beside K3 and K4) and the bound; K5 at the
    greedy shape and K5p at the serving shape likewise, float32 caches.
    ``(rows, failures)``."""
    import importlib
    fa = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_attention')
    fd = importlib.import_module(
        'distributed_dot_product_tpu_torch.ops.flash_decode')
    F = torch.nn.functional
    dev = torch.device('cuda')
    b, h, t, d = TRAIN_B, HEADS, TRAIN_T, HEAD_DIM
    scale = 1.0 / math.sqrt(d)
    pairs = b * h * t * (t + 1) // 2
    q, k, v, g = (f32n(torch, (b, h, t, d), gen, dev) for _ in range(4))
    q16, k16, v16, g16 = (x.bfloat16() for x in (q, k, v, g))
    out, lse = fa.flash_attention_with_lse(q, k, v, causal=True)
    q2, lse2, delta = fa.flash_attention_bwd_operands(q, out, lse, g, scale)
    o16, l16 = fa.flash_attention_with_lse(q16, k16, v16, causal=True)
    q2b, lse2b, deltab = fa.flash_attention_bwd_operands(q16, o16, l16, g16,
                                                         scale)
    mvec = fa.bounded_shift(q2, k)
    mvec16 = fa.bounded_shift(q2b, k16)
    bk = dict(causal=True, scale=scale)
    calls = {
        'flash_attention': (
            lambda: fa.flash_attention(q, k, v, causal=True),
            lambda: fa.flash_attention(q16, k16, v16, causal=True),
            lambda: fa.flash_attention_plain(q, k, v, causal=True)),
        'flash_attention_bounded': (
            lambda: fa.flash_attention_bounded(q, k, v, causal=True,
                                               mvec=mvec),
            lambda: fa.flash_attention_bounded(q16, k16, v16, causal=True,
                                               mvec=mvec16),
            lambda: fa.flash_attention_bounded_plain_lse(q, k, v,
                                                         causal=True)),
        'flash_attention_dq': (
            lambda: fa.flash_attention_dq(q2, k, v, g, lse2, delta, **bk),
            lambda: fa.flash_attention_dq(q2b, k16, v16, g16, lse2b, deltab,
                                          **bk),
            lambda: fa.flash_attention_dq_plain(q2, k, v, g, lse2, delta,
                                                **bk)),
        'flash_attention_dkv': (
            lambda: fa.flash_attention_dkv(q2, k, v, g, lse2, delta,
                                           causal=True),
            lambda: fa.flash_attention_dkv(q2b, k16, v16, g16, lse2b,
                                           deltab, causal=True),
            lambda: fa.flash_attention_dkv_plain(q2, k, v, g, lse2, delta,
                                                 causal=True))}
    qs, ks_, vs = (x.detach().requires_grad_() for x in (q, k, v))
    y = F.scaled_dot_product_attention(qs, ks_, vs, is_causal=True)
    sdpa_fwd = (lambda: F.scaled_dot_product_attention(q, k, v,
                                                       is_causal=True))
    sdpa_bwd = (lambda: torch.autograd.grad(y, (qs, ks_, vs), g,
                                            retain_graph=True))
    backend, names = sdpa_backend(torch, sdpa_fwd)
    sdpa_err = rel_errs(torch, sdpa_fwd(), fa.flash_attention_plain(
        q, k, v, causal=True))[0]
    library = {'flash_attention': time_ms(torch, sdpa_fwd, flush),
               'flash_attention_bwd': time_ms(torch, sdpa_bwd, flush)}
    library['flash_attention_bounded'] = library['flash_attention']
    bounds = _f32_attn_bound(d, d, b * h * t, b * h * t, pairs)
    bound_of = {'flash_attention': bounds['k1'],
                'flash_attention_bounded': bounds['k1'],
                'flash_attention_dq': bounds['k3'],
                'flash_attention_dkv': bounds['k4']}
    rows, fails = {}, []
    for name, (f32, b16, plain) in calls.items():
        got, want = f32(), plain()
        got = got if not isinstance(got, tuple) else got[0]
        want = want if not isinstance(want, tuple) else want[0]
        torch.cuda.synchronize()
        err = rel_errs(torch, got, want)[0]
        held = err
        if name in ('flash_attention_dq', 'flash_attention_dkv'):
            # dq and dk against float64, one batch row at a time.
            held = 0.0
            for i in range(b):
                dq64, tq64, dk64, tk64 = _f64_grads(
                    torch, fa, q[i:i + 1], k[i:i + 1], v[i:i + 1],
                    g[i:i + 1], out[i:i + 1], lse[i:i + 1], scale,
                    dict(causal=True))
                held = max(held, cond_err(torch, got[i:i + 1], dq64, tq64)
                           if name == 'flash_attention_dq' else
                           cond_err(torch, got[i:i + 1], dk64, tk64))
                del dq64, tq64, dk64, tk64
            if name == 'flash_attention_dkv':
                held = max(held, rel_errs(torch, f32()[1], plain()[1])[0])
        ms, by = bound_of[name]
        row = {'shape': [b, h, t, d], 'causal': True,
               'ms': time_ms(torch, f32, flush),
               'bf16_ms': time_ms(torch, b16, flush),
               'plain_ms': time_ms(torch, plain, flush, reps=3),
               'library_ms': (library['flash_attention_bwd']
                              if name in ('flash_attention_dq',
                                          'flash_attention_dkv')
                              else library[name]),
               'library': f'SDPA float32 ({backend} backend'
                          + ('; its backward alone: dq, dk, dv together)'
                             if name in ('flash_attention_dq',
                                         'flash_attention_dkv') else ')'),
               'bound_ms': ms, 'bound_by': by,
               'max_row_rel_err': err, 'held': held,
               'max_abs_err': (got - want).abs().max().item()}
        emit({'phase': 'float32_path', 'case': f'timing_{name}',
              'card': CARD, **row})
        rows[name] = row
        if not held <= TOL_F32_ROW:
            fails.append(f'float32 {name} timing shape: row err {held} > '
                         f'{TOL_F32_ROW}')
    emit({'phase': 'float32_path', 'case': 'sdpa_float32',
          'backend': backend, 'kernels': names,
          'max_row_rel_err_vs_plain': sdpa_err,
          'allow_tf32': {'matmul': torch.backends.cuda.matmul.allow_tf32,
                         'cudnn': torch.backends.cudnn.allow_tf32}})
    del qs, ks_, vs, y
    torch.cuda.empty_cache()

    # K5 at the greedy shape (4 slots mid-generation, t_max 2048) and K5p
    # at the serving shape (paged_case), float32 caches.
    fill = PROMPT + STEPS // 2
    vt = torch.full((BATCH,), fill, dtype=torch.int32, device=dev)
    q5, kn, vn = (f32n(torch, (BATCH, HEADS, 1, HEAD_DIM), gen, dev)
                  for _ in range(3))
    ck, cv = (f32n(torch, (BATCH, HEADS, T_MAX, HEAD_DIM), gen, dev)
              for _ in range(2))
    mask = (torch.arange(T_MAX, device=dev)[None, :]
            <= vt[:, None].long())[:, None, None, :]
    bh = BATCH * HEADS
    cols = fill + 1
    nbytes = (8 * HEAD_DIM * bh * (cols - 1) + 8 * HEAD_DIM * bh
              + 16 * HEAD_DIM * bh)
    k5 = (lambda: fd.flash_decode(q5, kn, vn, ck, cv, vt, vt, scale=scale),
          lambda: fd.flash_decode(q5.bfloat16(), kn.bfloat16(),
                                  vn.bfloat16(), ck16, cv16, vt, vt,
                                  scale=scale),
          lambda: fd.flash_decode_plain(q5, kn, vn, ck, cv, vt, vt,
                                        scale=scale),
          lambda: F.scaled_dot_product_attention(q5, ck, cv, attn_mask=mask,
                                                 scale=scale),
          f32_bound_ms(4 * HEAD_DIM * bh * cols, nbytes, F32_FFMA_FLOPS))
    ck16, cv16 = ck.bfloat16(), cv.bfloat16()
    pq, pkn, pvn, kp, vp, pvt, pap, table, prow = paged_case(torch, gen, dev)
    pq, pkn, pvn, kp, vp = (x.float() for x in (pq, pkn, pvn, kp, vp))
    kp16, vp16 = kp.bfloat16(), vp.bfloat16()
    gk, gv = fd.gather_pages(kp, table), fd.gather_pages(vp, table)
    pmask = (torch.arange(SERVE_T_MAX, device=dev)[None, :]
             <= pvt[:, None].long())[:, None, None, :]
    n_rows = len(set().union(*prow))
    pcols = sum(x + 1 for x in pvt.tolist() if x >= 0)
    n_app = sum(a >= 0 for a in pap.tolist())
    pbytes = (8 * HEAD_DIM * HEADS * n_rows
              + 8 * HEAD_DIM * SERVE_SLOTS * HEADS
              + 8 * HEAD_DIM * SERVE_SLOTS * HEADS
              + 8 * HEAD_DIM * HEADS * n_app + 4 * table.numel())
    k5p = (lambda: fd.flash_decode(pq, pkn, pvn, kp, vp, pvt, pap,
                                   page_table=table, scale=scale),
           lambda: fd.flash_decode(pq.bfloat16(), pkn.bfloat16(),
                                   pvn.bfloat16(), kp16, vp16, pvt, pap,
                                   page_table=table, scale=scale),
           lambda: fd.flash_decode_plain(pq, pkn, pvn, kp, vp, pvt, pap,
                                         page_table=table, scale=scale),
           lambda: F.scaled_dot_product_attention(pq, gk, gv,
                                                  attn_mask=pmask,
                                                  scale=scale),
           f32_bound_ms(4 * HEAD_DIM * HEADS * pcols, pbytes,
                        F32_FFMA_FLOPS))
    for name, (f32, b16, plain, lib, (bms, by)) in (
            ('flash_decode', k5), ('flash_decode_paged', k5p)):
        over = ('the slab' if name == 'flash_decode'
                else 'the slab gathered beforehand')
        row = {'ms': time_ms(torch, f32, flush),
               'bf16_ms': time_ms(torch, b16, flush),
               'plain_ms': time_ms(torch, plain, flush, reps=10),
               'library_ms': time_ms(torch, lib, flush),
               'library': f'SDPA float32 over {over}, boolean mask '
                          f'({sdpa_backend(torch, lib)[0]} backend)',
               'bound_ms': bms, 'bound_by': by}
        emit({'phase': 'float32_path', 'case': f'timing_{name}',
              'card': CARD, **row})
        rows[name] = row
    return rows, fails


def phase_float32_path(torch, ddp, flush):
    """The float32 kernels and the slice's entry points at the JAX
    package's default dtype (the module docstring, phase 13c); every
    failure reported together at the end."""
    emit({'phase': 'float32_path', 'case': 'settings', 'card': CARD,
          'allow_tf32': {'matmul': torch.backends.cuda.matmul.allow_tf32,
                         'cudnn': torch.backends.cudnn.allow_tf32},
          'float32_matmul_precision': torch.get_float32_matmul_precision()})
    gen = torch.Generator().manual_seed(F32_SEED)
    worst, fails = _f32_kernels(torch, ddp, gen)
    occupancy, f = _f32_bwd_occupancy()
    fails += f
    fwd_occupancy, f = _f32_fwd_occupancy()
    fails += f
    decode_occupancy, f = _f32_decode_occupancy()
    fails += f
    timing, f = _f32_timing(torch, ddp, flush, gen)
    fails += f
    readme, f = _f32_readme(torch, ddp)
    fails += f
    engine, f = _f32_engine(torch, ddp)
    fails += f
    lm, f = _f32_lm(torch, ddp)
    fails += f
    module, f = _f32_module(torch, ddp, flush)
    fails += f
    check(not fails, '; '.join(fails))
    return {'worst': worst, 'timing': timing,
            'bwd_occupancy': occupancy['kernels'],
            'fwd_occupancy': fwd_occupancy['kernels'],
            'decode_occupancy': decode_occupancy['kernels'], 'launches': {
        'readme': readme['f32_launches'], 'engine': engine, 'lm': lm,
        'module': module}}


def main():
    try:
        import torch
    except ImportError as exc:
        print(f'chip_smoke: torch is not importable: {exc}', file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this script '
              'runs only on a CUDA card', file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    # The engine's environment knobs would switch a phase's decode path,
    # cache layout or weight precision: every engine here asks for its
    # own explicitly, and the knobs are cleared for anything built inside.
    for knob in ('DDP_TPU_DECODE_KERNEL', 'DDP_TPU_PAGED_CACHE',
                 'DDP_TPU_WEIGHT_QUANT'):
        os.environ.pop(knob, None)
    try:
        import distributed_dot_product_tpu_torch as ddp
        from distributed_dot_product_tpu_torch.ops import _build
    except ImportError as exc:
        print(f'chip_smoke: the port package is not importable: {exc}',
              file=sys.stderr)
        return 2

    only = None
    if '--phases' in sys.argv:
        only = set(sys.argv[sys.argv.index('--phases') + 1].split(','))
    if '--parent' in sys.argv:
        global PARENT
        PARENT = os.path.abspath(sys.argv[sys.argv.index('--parent') + 1])

    def want(name):
        return only is None or name in only

    phase = 'device'
    res = {}
    try:
        smi = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
        kind = torch.cuda.get_device_name(0)
        count = torch.cuda.device_count()
        global CARD
        CARD = smi
        emit({'phase': 'device', 'name': kind, 'count': count,
              'nvidia_smi': smi, 'torch': torch.__version__,
              'cuda': torch.version.cuda})

        phase = 'build'
        t0 = time.perf_counter()
        _build.build_all()
        emit({'phase': 'build', 'sources': list(_build.SOURCES),
              'seconds': time.perf_counter() - t0,
              'ptxas': build_resources(_build),
              'smem_bytes': smem_bytes(_build)})

        flush = torch.empty(64 * 1024 * 1024, dtype=torch.int32,
                            device='cuda')            # 256 MB > 50 MB L2
        gen = torch.Generator().manual_seed(1)
        phases = (
            ('flash_attention', lambda: phase_flash(torch, ddp, flush, gen)),
            ('flash_decode', lambda: phase_decode(torch, ddp, flush, gen)),
            ('flash_decode_paged',
             lambda: phase_decode_paged(torch, ddp, flush, gen)),
            ('flash_decode_verify',
             lambda: phase_decode_verify(torch, ddp, flush, gen)),
            ('flash_decode_int8',
             lambda: phase_decode_int8(torch, ddp, flush, gen)),
            ('serve_path', lambda: phase_serve_path(torch, ddp)),
            ('spec_serve', lambda: phase_spec_serve(torch, ddp)),
            ('wq8_serve', lambda: phase_wq8_serve(torch, ddp, flush)),
            ('load_serve', lambda: phase_load_serve(torch, ddp)),
            ('router_serve', lambda: phase_router_serve(torch, ddp, flush)),
            ('chaos_serve', lambda: phase_chaos_serve(torch, ddp)),
            ('obs_serve', lambda: phase_obs_serve(torch, ddp)),
            ('kv_sharded_serve',
             lambda: phase_kv_sharded_serve(torch, ddp, flush, gen)),
            ('int8_decode', lambda: phase_int8_decode(torch, ddp)),
            ('flash_backward',
             lambda: phase_flash_backward(torch, ddp, flush, gen)),
            ('flash_features',
             lambda: phase_flash_features(torch, ddp, flush, gen)),
            ('flash_masks',
             lambda: phase_flash_masks(torch, ddp, flush, gen)),
            ('float32_path',
             lambda: phase_float32_path(torch, ddp, flush)),
            ('kernel_coverage',
             lambda: phase_kernel_coverage(torch, ddp, flush)),
            ('main_path', lambda: phase_main_path(torch, ddp)),
            ('wq8_lm', lambda: phase_wq8_lm(torch, ddp)),
            ('train_path', lambda: phase_train_path(torch, ddp)),
            ('train_knobs', lambda: phase_train_knobs(torch, ddp)),
            ('train_cpu_reference',
             lambda: phase_train_cpu_reference(torch, ddp)),
            ('alibi_lm', lambda: phase_alibi_lm(torch, ddp)),
            ('seq_parallel', lambda: phase_seq_parallel(torch, ddp)),
            ('zigzag_ring', lambda: phase_zigzag_ring(torch, ddp)),
            ('decode_sharded', lambda: phase_decode_sharded(torch, ddp)),
            ('flagship', lambda: phase_flagship(torch, ddp)),
            ('analysis_examples',
             lambda: phase_analysis_examples(torch, ddp)),
            ('benchmark_cli', lambda: phase_benchmark_cli(torch)))
        for phase, run in phases:
            if want(phase):
                t0 = time.perf_counter()
                res[phase] = run()
                emit({'phase': phase, 'phase_seconds':
                      time.perf_counter() - t0})
            if phase == 'kernel_coverage':
                del flush
                torch.cuda.empty_cache()
    except Exception as exc:   # report the failed phase, then fail
        emit({'phase': phase, 'ok': False,
              'error': f'{type(exc).__name__}: {exc}'})
        raise
    if only is not None:       # a partial run prints no result line
        print(smi, flush=True)
        emit({'phases_run': sorted(res)})
        return 0
    k1, k5, k5p = (res['flash_attention'], res['flash_decode'],
                   res['flash_decode_paged'])
    serve_path_launches = res['serve_path']
    bwd_err, bwd_time = res['flash_backward']
    feat_err, feat_time = res['flash_features']
    mask_err, mask_time = res['flash_masks']
    serve_launches = res['main_path']
    train_launches = res['train_path']
    sp = res['seq_parallel']
    ds = res['decode_sharded']
    fs = res['flagship']
    ver, i8 = res['flash_decode_verify'], res['flash_decode_int8']
    spec, int8_path = res['spec_serve'], res['int8_decode']
    alibi, zz = res['alibi_lm'], res['zigzag_ring']
    kv = res['kv_sharded_serve']
    int8_k = int8_path['int8_kernels']
    wq8, load = res['wq8_serve']['launches'], res['load_serve']
    wq8_lm, knobs = res['wq8_lm'], res['train_knobs']
    router = res['router_serve']
    chaos = res['chaos_serve']
    obs = res['obs_serve']
    ae = res['analysis_examples']
    bc = res['benchmark_cli']
    cov = res['kernel_coverage']

    def knob_paths(kernel):
        """The kernel's launches on train_knobs's runs (2 steps under each
        remat setting, 3 with the untied head)."""
        return {f'train_knobs_{name}': counts[kernel]
                for name, counts in knobs.items()}

    def variant(cases, head, launches, path):
        """A verify / int8 variant of K5 or K5p: its launches on the path
        that runs it, the head case's times, every case's numbers."""
        return dict(launches=launches, path=path,
                    max_abs_err=max(c['max_abs_err'] for c in cases.values()),
                    **{k: cases[head][k] for k in (
                        'ms', 'plain_ms', 'library_ms', 'bound_ms',
                        'bound_by')},
                    cases=cases)
    spec_verify = {mode: sum(spec[f'{mode}_{p}']['target_verify_launches']
                             for p in SPEC_PROPOSERS)
                   for mode in ('slab', 'paged')}
    k5['variants'].update(
        verify=variant({c: ver[c] for c in ('slab', 'slab_gqa')}, 'slab',
                       spec_verify['slab'],
                       'spec_serve slab engine, ngram + draft runs'),
        int8=variant({c: i8[c] for c in ('slab', 'partials_full_slab')},
                     'slab', int8_path['launches']['flash_decode.int8'],
                     'int8_decode, 64 module decode steps'))
    k5p['variants'].update(
        verify=variant({'paged': ver['paged']}, 'paged',
                       spec_verify['paged'],
                       'spec_serve paged engine, ngram + draft runs'),
        int8=variant({'paged': i8['paged']}, 'paged',
                     int8_path['paged']['launches']['flash_decode_paged.int8'],
                     f'int8_decode, {INT8_PAGED_STEPS} decode_step calls '
                     f'on a paged int8 cache'))
    k5['variants']['alibi'] = variant(
        k5['variants']['alibi'], 'alibi_n1',
        alibi['greedy']['flash_decode'],
        f'alibi_lm greedy run, {STEPS - 1} steps x {LAYERS} layers')
    k5p['variants']['alibi'] = variant(
        k5p['variants']['alibi'], 'alibi_n1',
        alibi['paged']['flash_decode_paged'],
        f'alibi_lm paged route, {STEPS - 1} steps x {LAYERS} layers')
    # K5p with partials on each shard of the sequence-sharded page table:
    # its launches on kv_sharded_serve's burst and long stream, its time
    # per shard at the long stream's shapes (the slowest shard as ms).
    kv_step = kv['step']
    slowest = max(kv_step['shards'], key=lambda sh: kv_step['shards'][sh]['ms'])
    k5p['variants']['kv_shards'] = dict(
        launches=kv['burst']['launches'] + kv['long']['launches'],
        path=f'kv_sharded_serve: the burst ({KV_SHARDS} a decode step) and '
             f'the {KV_T}-column long stream ({DS_STEPS} steps x '
             f'{KV_SHARDS})',
        launches_by_path={
            'kv_sharded_serve_burst': kv['burst']['launches'],
            'kv_sharded_serve_long': kv['long']['launches'],
            'decode_sharded_paged_per_rank':
                ds['paged_launches_per_rank']},
        max_abs_err=kv_step['max_abs_err'],
        ms=kv_step['shards'][slowest]['ms'],
        ms_by_shard={sh: c['ms'] for sh, c in kv_step['shards'].items()},
        single_pool_ms=kv_step['single_pool_ms'],
        plain_ms=kv_step['plain_ms_shard0'], library_ms=None,
        bound_ms=kv_step['shards'][slowest]['bound_ms'],
        bound_by=kv_step['shards'][slowest]['bound_by'],
        vs_single_pool=kv_step['vs_single_pool'])

    # K1, K3, K4: launches on the training path (beside them the serving
    # path's and each sequence-parallel strategy's, rank 0 over its
    # SP_STEPS train steps), times at the training shape. K2: launches on
    # the bounded flash train steps, times at the flagship's fold shape
    # (flash_features). K5: launches and times of the greedy serving path
    # (its launches on the slab twin of the scheduler's run beside them).
    # K5p: launches on the scheduler's paged run, times at the serving
    # shape. K5 and K5p also carry their partials / window / verify / int8
    # variants (`variants`; verify launches on the spec_serve runs, int8
    # on int8_decode), and K5 its launches per rank on the 64
    # sequence-sharded steps (decode_sharded). K1/K3/K4 also carry their
    # segment / window / dropout / int8 / ALiBi / positions variants' times
    # (flash_masks, `masks`; K2's positions variant too) and their
    # launches on the flagship stages (rank 0 over FS_STEPS train steps),
    # on alibi_lm and on zigzag_ring (per rank). K5 and K5p carry their
    # ALiBi variants with their launches on alibi_lm's greedy run and
    # paged route.
    csrc = 'distributed_dot_product_tpu_torch/csrc/'
    tpu = 'distributed_dot_product_tpu/ops/'
    k1_err = max(k1['max_abs_err'], bwd_err['out'], feat_err['out'])

    def sp_paths(kernel):
        return {**{f'seq_parallel_{name}': counts[kernel]
                   for name, counts in sp.items() if counts[kernel]},
                **{f'flagship_{stage}': counts[kernel]
                   for stage, counts in fs.items()
                   if counts.get(kernel)}}

    def alibi_paths(kernel):
        """The kernel's launches on alibi_lm (3 train steps; the greedy
        run) and zigzag_ring (per rank, one forward and backward)."""
        return {f'alibi_lm_train_{ALIBI_TRAIN_STEPS}_steps':
                alibi['train'][kernel],
                **({'alibi_lm_greedy': alibi['greedy'][kernel]}
                   if alibi['greedy'][kernel] else {}),
                **{f'zigzag_ring_{name}_by_rank': counts[kernel]
                   for name, counts in zz['launches'].items()}}
    kernels = [
        dict(name='flash_attention', source=csrc + 'flash_fwd.cu',
             replaces=tpu + 'pallas_attention.py:630',
             launches=train_launches['flash_attention'],
             launches_by_path={
                 'serve': serve_launches['flash_attention'],
                 'train': train_launches['flash_attention'],
                 'wq8_lm': wq8_lm['flash_attention'],
                 **knob_paths('flash_attention'),
                 **sp_paths('flash_attention'),
                 **alibi_paths('flash_attention')},
             max_abs_err=k1_err, lse_max_abs_err=max(bwd_err['lse'],
                                                     feat_err['lse']),
             max_row_rel_err=max(k1['max_row_rel_err'],
                                 bwd_err['out_row_rel']),
             masked_fold=feat_time['flash_attention'],
             masks=mask_time['flash_attention'],
             masks_max_abs_err={n: mask_err[n] for n in ('out', 'lse')},
             int8=dict(
                 launches_by_path={
                     'int8_decode_prefill':
                         int8_path['prefill_k1_launches'],
                     f'flagship_gqa_ring_{FS_STEPS}_steps':
                         fs['gqa_ring']['flash_attention']},
                 library=int8_k['library'],
                 **{c: int8_k[c] for c in ('int8_decode_prefill',
                                           'gqa_ring_fold')}),
             edges=k1['edges'],
             coverage=dict(cov['flash_worst'], widths={
                 dims: {k: row[k] for k in (
                     'grid', 'k1_ms', 'pad_ms', 'k1_plain_ms', 'library_ms',
                     'k1_bound_ms', 'k1_bound_by', 'library')}
                 for dims, row in cov['timing'].items()}),
             **bwd_time['flash_attention']),
        dict(name='flash_attention_bounded', source=csrc + 'flash_fwd.cu',
             replaces=tpu + 'pallas_attention.py:1151',
             launches=sp['flash_bounded']['flash_attention_bounded'],
             launches_by_path=sp_paths('flash_attention_bounded'),
             max_abs_err=feat_err['bounded'],
             masks=mask_time['flash_attention_bounded'],
             **feat_time['flash_attention_bounded']),
        dict(name='flash_attention_dq', source=csrc + 'flash_bwd.cu',
             replaces=tpu + 'pallas_attention.py:1228',
             launches=train_launches['flash_attention_dq'],
             launches_by_path={
                 'train': train_launches['flash_attention_dq'],
                 **knob_paths('flash_attention_dq'),
                 **sp_paths('flash_attention_dq'),
                 **alibi_paths('flash_attention_dq')},
             max_abs_err=max(bwd_err['dq'], feat_err['dq']),
             max_row_rel_err=bwd_err['dq_row_rel'],
             masked_fold_f32=feat_time['flash_attention_dq'],
             masks=mask_time['flash_attention_dq'],
             masks_max_abs_err={n: mask_err[n] for n in ('dq', 'dq_f32')},
             int8=dict(
                 launches_by_path={
                     f'flagship_gqa_ring_{FS_STEPS}_steps':
                         fs['gqa_ring']['flash_attention_dq']},
                 library=int8_k['bwd_library'],
                 gqa_ring_fold=int8_k['k3_gqa_ring_fold']),
             coverage_widths_k3_k4={
                 dims: {k: row[k] for k in (
                     'grid', 'k3_k4_ms', 'pad_ms', 'k3_k4_plain_ms',
                     'library_bwd_ms', 'k3_bound_ms', 'k4_bound_ms')}
                 for dims, row in cov['timing'].items()},
             **bwd_time['flash_attention_dq']),
        dict(name='flash_attention_dkv', source=csrc + 'flash_bwd.cu',
             replaces=tpu + 'pallas_attention.py:1319',
             launches=train_launches['flash_attention_dkv'],
             launches_by_path={
                 'train': train_launches['flash_attention_dkv'],
                 **knob_paths('flash_attention_dkv'),
                 **sp_paths('flash_attention_dkv'),
                 **alibi_paths('flash_attention_dkv')},
             max_abs_err=max(bwd_err['dk'], bwd_err['dv'], feat_err['dk'],
                             feat_err['dv']),
             max_row_rel_err=max(bwd_err['dk_row_rel'],
                                 bwd_err['dv_row_rel']),
             masked_fold_f32=feat_time['flash_attention_dkv'],
             masks=mask_time['flash_attention_dkv'],
             masks_max_abs_err={n: mask_err[n] for n in
                                ('dk', 'dv', 'dk_f32', 'dv_f32')},
             int8=dict(
                 launches_by_path={
                     f'flagship_gqa_ring_{FS_STEPS}_steps':
                         fs['gqa_ring']['flash_attention_dkv']},
                 library=int8_k['bwd_library'],
                 gqa_ring_fold=int8_k['k4_gqa_ring_fold']),
             **bwd_time['flash_attention_dkv']),
        dict(name='flash_decode', source=csrc + 'flash_decode.cu',
             replaces=tpu + 'pallas_decode.py:107',
             launches=serve_launches['flash_decode'],
             launches_by_path={
                 'main_path': serve_launches['flash_decode'],
                 'serve_path_slab':
                     serve_path_launches['slab']['flash_decode'],
                 'spec_serve_slab': {
                     p: spec[f'slab_{p}']['launches']['flash_decode']
                     for p in SPEC_PROPOSERS},
                 'int8_decode': int8_path['launches']['flash_decode'],
                 'decode_sharded_per_rank': ds['launches_per_rank'],
                 'alibi_lm_greedy': alibi['greedy']['flash_decode'],
                 'wq8_serve_slab': wq8['slab']['flash_decode'],
                 'wq8_lm_greedy': wq8_lm['flash_decode']},
             max_abs_err=k5['max_abs_err'],
             coverage_max_abs_err=cov['decode_max_abs_err'],
             edges=k5['edges'],
             variants=k5['variants'],
             **{key: k5[key] for key in ('ms', 'plain_ms', 'library_ms',
                                         'bound_ms', 'bound_by')}),
        dict(name='flash_decode_paged', source=csrc + 'flash_decode.cu',
             replaces=tpu + 'pallas_decode.py:310',
             launches=serve_path_launches['paged']['flash_decode_paged'],
             launches_by_path={
                 'serve_path_paged':
                     serve_path_launches['paged']['flash_decode_paged'],
                 'spec_serve_paged': {
                     p: spec[f'paged_{p}']['launches']['flash_decode_paged']
                     for p in SPEC_PROPOSERS},
                 'int8_decode_paged':
                     int8_path['paged']['launches']['flash_decode_paged'],
                 'alibi_lm_paged': alibi['paged']['flash_decode_paged'],
                 'kv_sharded_serve_burst': kv['burst']['launches'],
                 'kv_sharded_serve_long': kv['long']['launches'],
                 'decode_sharded_paged_per_rank':
                     ds['paged_launches_per_rank'],
                 'wq8_serve_paged': {
                     n: wq8[n]['flash_decode_paged']
                     for n in ('paged', 'paged_again')},
                 'load_serve': load,
                 **{f'router_serve_{case}': n
                    for case, n in router['launches'].items()},
                 **{f'chaos_serve_{case}': n
                    for case, n in chaos['launches'].items()},
                 'obs_serve': obs['launches']},
             max_abs_err=k5p['max_abs_err'],
             variants=k5p['variants'],
             **{key: k5p[key] for key in ('ms', 'plain_ms', 'library_ms',
                                          'gather_ms', 'library',
                                          'bound_ms', 'bound_by')})]
    for entry in kernels:
        entry['route'] = 'cuda'
        # analysis_examples: the kernel's launches in each of its runs
        # (the registry under the graph rules, the sentinel's burst, the
        # four harness twins), zeros included.
        entry.setdefault('launches_by_path', {})['analysis_examples'] = {
            case: counts[entry['name']] for case, counts in ae.items()}
        # benchmark_cli: its launches in each torch_benchmark.py run (the
        # float32 kernel's apart, on its own entry below).
        entry['launches_by_path']['benchmark_cli'] = {
            run: counts[entry['name']] - counts[f'{entry["name"]}_f32']
            for run, counts in bc.items()}
        # kernel_coverage: its launches on that phase's runs (the module at
        # value_dim 256, the head-dim-256 LM's train step and greedy run,
        # the page-48 engine's burst).
        entry['launches_by_path']['kernel_coverage'] = {
            run: counts.get(entry['name'], 0)
            for run, counts in cov['launches'].items()}
        for key in ('flops', 'bytes'):
            entry.pop(key, None)
        for extra in ('masked_fold', 'masked_fold_f32'):
            if extra in entry:
                entry[extra] = {k: v for k, v in entry[extra].items()
                                if k not in ('flops', 'bytes')}
    # The float32 kernels (float32_path): launches on that phase's runs
    # (K1, K3, K4: the float32 LM's train steps; K2: the module's bounded
    # step; K5 / K5p: the float32 engine's slab / paged burst), errors
    # against their plain float32 versions, times at the LM's shape and
    # K5 / K5p's greedy and serving shapes.
    f32 = res['float32_path']
    fl = f32['launches']
    f32_paths = {
        'flash_attention': {
            f'float32_path_lm_train_{F32_LM_STEPS}_steps':
                fl['lm']['train'].get('flash_attention', 0),
            'float32_path_lm_greedy':
                fl['lm']['greedy'].get('flash_attention', 0),
            **{f'float32_path_module_{c}': n.get('flash_attention', 0)
               for c, n in fl['module'].items()}},
        'flash_attention_bounded': {
            f'float32_path_module_{c}': n.get('flash_attention_bounded', 0)
            for c, n in fl['module'].items()},
        'flash_attention_dq': {
            f'float32_path_lm_train_{F32_LM_STEPS}_steps':
                fl['lm']['train'].get('flash_attention_dq', 0),
            **{f'float32_path_module_{c}': n.get('flash_attention_dq', 0)
               for c, n in fl['module'].items()}},
        'flash_attention_dkv': {
            f'float32_path_lm_train_{F32_LM_STEPS}_steps':
                fl['lm']['train'].get('flash_attention_dkv', 0),
            **{f'float32_path_module_{c}': n.get('flash_attention_dkv', 0)
               for c, n in fl['module'].items()}},
        'flash_decode': {
            'float32_path_engine_slab': fl['engine']['slab']['flash_decode'],
            'float32_path_lm_greedy':
                fl['lm']['greedy'].get('flash_decode', 0)},
        'flash_decode_paged': {
            'float32_path_engine_paged':
                fl['engine']['paged']['flash_decode_paged']}}
    f32_main = {'flash_attention': f'float32_path_lm_train_{F32_LM_STEPS}'
                                   f'_steps',
                'flash_attention_bounded': 'float32_path_module_'
                                           'causal_bounded',
                'flash_attention_dq': f'float32_path_lm_train_'
                                      f'{F32_LM_STEPS}_steps',
                'flash_attention_dkv': f'float32_path_lm_train_'
                                       f'{F32_LM_STEPS}_steps',
                'flash_decode': 'float32_path_engine_slab',
                'flash_decode_paged': 'float32_path_engine_paged'}
    base = {e['name']: e for e in kernels}
    for name in F32_KERNELS:
        t = f32['timing'][name]
        kernels.append(dict(
            name=f'{name}_f32', route='cuda', body=F32_BODY[name],
            source=(base[name]['source'] if 'decode' in name
                    else csrc + ('flash_bwd_f32.cu' if name in (
                        'flash_attention_dq', 'flash_attention_dkv')
                        else 'flash_f32.cu')),
            replaces=base[name]['replaces'],
            launches=f32_paths[name][f32_main[name]],
            launches_by_path={**f32_paths[name], 'benchmark_cli': {
                run: counts[f'{name}_f32'] for run, counts in bc.items()}},
            **f32['worst'][name],
            **{k: t[k] for k in ('ms', 'plain_ms', 'library_ms', 'library',
                                 'bound_ms', 'bound_by', 'bf16_ms')},
            bound_rate=('operations at 67 TFLOP/s (float32 FFMA)'
                        if 'decode' in name else
                        'operations at 165 TFLOP/s (3xTF32)')
            + ', bytes at 3.35 TB/s'))
    print(smi, flush=True)
    emit({'kernels': kernels})
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': kind,
                                 'count': count}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
