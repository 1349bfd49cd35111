#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (src/repro_torch) on one GPU.

  python3 chip_smoke.py                # needs one CUDA card
  python3 chip_smoke.py --paged-only   # phases 1-2 only, no result line

Phases, in the order they run, each of which fails the run:
  1. build every kernel under src/repro_torch/kernels/csrc (one nvcc per
     source, all started together) and print the build time;
  2. hold the paged-attention kernels against their plain PyTorch
     versions on the card at gemma2-2b's attention shapes, and at a 1 x 2
     mesh rank's (h 4, n_kv 2, hd 256; phase D(e)) (fp32 and bf16
     arenas, S = 1 and 4, a dead slot, position -1 rows, window on and
     off, softcap on, with and without a new row routed to a null table
     entry): K8 (paged_attention_fused) and K7 (paged_attention, on the
     arenas before the write) within 1e-5 (fp32 summation order), arenas
     torch.equal, dead slots exactly 0, a second launch on the same
     inputs equal bit for bit; K7 on the arenas K8 has just written, with
     the same q, equal to K8's output within 1e-5; then the same checks
     and the timing of both, with the L2 cache evicted (a 256 MB read)
     before each launch, beside their bounds and their launches' device
     times from torch.profiler, at two shapes: the serving run's (6 blocks of 16
     rows) and a long context (256 blocks, a 4096-row ring); and drive
     K7's path, its library entry as a read of one decode step (26
     layers), which must launch it 26 times; K8 at the 1 x 2 rank's heads
     is timed at the serving shape beside its bound too;
  3. serve gemma2-2b at full width and depth through the port's CLI
     (`repro_torch.launch.serve.main`): first a short warm-up stream (2
     requests, 4 new tokens) so that first-use costs land on neither
     timed run, then fp32 with the kernel, then the same stream with the
     plain-torch gather: greedy tokens must be equal and the kernel must
     have launched decode steps x 26 times; then with --interpret (K8's
     plain version on the card): tokens equal, no K8 launch;
  4. serve once in bf16 with the kernel: it must finish with finite
     logits;
  S. speculative and sampled serving of the same model and stream
     (after phase 4): (a) --spec-draft self --spec-k 4 greedy fp32 tokens
     equal phase 3's, with --attn-kernel paged (K8 launched exactly
     rounds x 26 times: the draft, on its dense pool, launches none) and
     with xla (no launch); (d) --sampler
     temperature=0.8,top_k=50,top_p=0.9,seed=3: the sampled stream equal
     between the paged non-spec, self-draft spec and dense runs; (b)
     reject churn: make_spec_pair's one-period draft of an independently
     seeded gemma2-2b, paired with the target through the engine API,
     greedy and with (d)'s sampler: tokens equal phase 3's and (d)'s,
     every verify call a (4, 4) query block against row-margined tables
     of 7 blocks, K8 launched calls x 26 times, acceptance printed; (e)
     --engine static --cache dense greedy tokens equal phase 3's; (f)
     bf16 spec with --sampler temperature=0,stable=1 ends with finite
     logits, its share of tokens equal to the bf16 non-spec run printed
     (not gated); (g) K8 at S = 4 at the serving shapes with a
     row-margined table (pa.verify_case), held to its plain version as
     in phase 2 and timed beside its byte bound and the profiler's split
     and combine times, the same at S = 16 (a whole block of rows) with
     bf16 and fp32 arenas, and spec vs non-spec tokens/s and ITL p50
     printed (no gain claimed);
  C. chunked-prefill admission and open-loop traffic (after phase S) on
     the same model in fp32, 4 slots, block 16, prefill bucket 16, a
     mixed stream of 12 requests (bimodal_requests: short prompts of
     48-64 tokens and long ones of 384-512, 32 new tokens each, seed 4):
     (a) through the CLI (`main(argv, requests=...)`), unchunked with
     the kernel, --chunk-budget 64 with the kernel and with xla: greedy
     tokens equal across the three, K8 launched decode steps x 26 times
     in the kernel runs and never in the xla run (chunk forwards run on
     the task's dense cache), chunked rows >= the padded prompt rows,
     chunk forwards per size printed; (b) a warm unchunked and a warm
     chunked engine (6 warm-up requests each, the controller's
     warmup()) replay the stream on poisson_arrivals(12, 2.0, seed=2)
     through OpenLoopDriver: tokens equal (a)'s, K8 launched decode
     steps x 26 times, goodput, SLO attainment and TTFT/ITL p50/p99
     printed against SLOs from the warm unchunked ITL p50 (ITL 4x it,
     TTFT max(1 s, 40x the ITL bound)), not gated; the median wall time
     of one chunk forward per size; (c) bf16 with --sampler
     temperature=0,stable=1, unchunked vs chunked: equal streams of 12
     and the first parting printed, not gated; and K8 held to its plain
     version and timed at this pool's 34-block rings;
  M. MoE, Mamba-2 and hybrid decoders and fp16 serving (after phase C):
     (a) granite-moe-3b-a800m at full width and depth (32 layers, 40
     experts top-8, 24 query heads over 8 KV heads of 64), fp32, through
     the CLI with phase 3's stream (8 requests, prompts up to 64, 32 new
     tokens, 4 slots, block 16, seed 0) after a warm-up stream, with the
     kernel and with the plain gather: greedy tokens equal, K8 launched
     decode steps x 32 times, none in the gather run; tokens/s, ITL
     p50/p99 and peak memory printed, one 4-slot decode step profiled
     (device busy, idle share, launches), and a decode step and a 4 x 64
     prefill forward timed on each MoE expert route of models/moe.py
     (dense buffer, gathered rows; alternated); (b) K8 and K7 held to
     their plain versions at granite's heads as in phase 2: q fp32, bf16
     and fp16, bf16 and fp32 arenas, S = 1 with and without a new row on
     a null table entry and S = 4 on a row-margined table
     (pa.verify_case), a dead slot, position -1 rows; within 1e-5 for
     every q dtype (both sides widen q exactly to fp32), arenas
     torch.equal, second launches bit for bit; both timed at the serving
     shape (S = 1) beside their bounds and the profiler's split and
     combine times, and K7's path driven over 32 granite layers with its
     count read; (c) mamba2-130m at full width, fp32, after a warm-up
     stream: --engine static --cache dense, --cache dense, --chunk-budget
     128 (the granularity is its SSD chunk, 64) and --attn-kernel paged
     (a pool with no arena): greedy tokens equal across the four, K8
     never launched; (d) reduced jamba-1.5-large-398b (one period: one
     attention and seven Mamba layers, 4 experts top-2; reduced: full
     jamba does not fit one H100) with the kernel and the gather: tokens
     equal, K8 launched decode steps x 1; (e) gemma2-2b at full width
     with --precision fp16 and the kernel: finite logits, K8 launched
     decode steps x 26, the share of greedy tokens equal to phase 3's
     fp32 run printed (not gated), and K8 and K7 with fp16 q held and
     timed at phase 2's serving shape, K7's path driven with fp16 q.
     Each sub-phase's time is printed;
  E. the encoder-decoder and BERT scoring (after phase M): (a)
     whisper-large-v3 at full width and depth (32 + 32 layers, d 1280,
     20 heads, 1500 frames), fp32, through the CLI after a 2-request
     warm-up: 8 requests over 2 distinct inputs (--shared-inputs 2:
     beams or retries of one utterance), prompts 4-8, 16-32 new tokens,
     4 slots; every request ends with its budget, the shared cross
     blocks are a positive multiple of 94 (one input's blocks); the
     same stream on engines with and without prefix sharing gives the
     CLI's tokens, and so does run_one for each request; after the
     drains check_invariants passes and no cross block is live;
     tokens/s, TTFT and ITL p50/p99, decode steps, peak memory and one
     profiled 4-slot decode step printed; (b) bert-large at full width,
     fp32, --task score and then --task embed: 32 requests of 64-128
     tokens, 8 slots, one forward per step (4 steps); embeddings of the
     two tasks within 1e-5, each request's run_one embedding within
     1e-5 of the batched one, run_one masked-LM ids equal to the batched
     ones on at least 99.9% of the positions (each differing position
     printed: batch 1 and batch 8 may reduce in another order, and 4096
     argmaxes over 30,522 logits can meet a near-tie); requests/s,
     tokens/s and ms per forward printed; (c) whisper-large-v3 trained
     at full width and depth with fp32 LANS (seq 128, batch 2, seed 0,
     3 steps, warmup-hold-decay): one shared set of step-1 gradients at
     8 layers per stack (every leaf; both routes fit the card) applied
     by lans and fused_lans within 2e-5; the CLI (unfused) and
     build_train_step + fused_lans from the same seed and batches:
     losses finite and within 1e-2 relative, K1-K3 each launched 3 x 46
     (the leaves) times, step times and peak memory printed, one fused
     step profiled (idle share, the LANS kernels' share); then K1-K4 at
     the largest leaf (209,715,200 fp32 elements) held to their plain
     versions and timed beside their byte bounds and, for K1, a library
     call. Each sub-phase's time is printed;
  5. hold the fused LANS kernels K1-K4 against their plain versions
     (1, 127, 32,773 and 1,048,579 elements; g/x fp32 and bf16; step 1
     and 4; lam 0 with trust off, a zero-gradient leaf, a NaN in g; K4
     with bf16 and fp16 copies): fp32 outputs within 2e-5, K3's bf16 x
     within 2e-2 (tests/test_kernels.py's tolerances), K4's master
     torch.equal to K3's output and its copy to the cast, K1 bitwise
     repeatable; then, at BERT-large's largest leaf (100,663,296 fp32
     elements, where the sums run with their cap of per-CTA partials),
     the same checks, and each kernel timed beside its plain version,
     its byte bound and a library call; and one whole fused LANS update
     over BERT-large's 29 leaves against its byte bound;
  6. the same for the fused LAMB kernels K5-K6 over phase 5's grid with
     clip 1 and 0.3 (128 cases): fp32 outputs within 2e-5, K6's bf16 x
     within 2e-2, NaN where the plain version has NaN, K5's norms
     repeating bit for bit; then at the largest leaf, each timed beside
     its plain version and byte bound; and one whole fused_lamb update
     over the 29 leaves against its byte bound (40 B/param, 44 with the
     clip's norm pass) beside the unfused lamb update;
  7. train BERT-large at full width and depth (seq 128, batch 16, seed
     0, 4 steps, warmup-hold-decay): the port's CLI (unfused lans, fp32
     policy) and build_train_step + fused_lans from the same seed and
     batches. Losses finite; one shared set of step-1 gradients applied
     by lans and by fused_lans agrees leaf by leaf within 2e-5, and
     one shared set of bf16-policy gradients applied by fused_mixed_lans
     and by mixed_precision(lans) gives masters and moments within 2e-5
     and bf16 params within 2e-2; the 4-step loss trajectories agree
     within 1e-2 relative; K1-K3 each launched 4 x 29 times. Then bf16
     steps through fused_mixed_lans (K4 launched applied steps x 29
     times, K3 not at all) and the CLI with --precision fp16 (finite
     loss, loss_scale and overflow_count printed);
  8. train it as in phase 7 with LAMB: shared step-1 gradients applied
     by lamb and by fused_lamb (params and moments within 2e-5), the CLI
     with --optimizer lamb and build_train_step + fused_lamb over the
     same 4 batches (losses within 1e-2 relative; K5, K6 and K1, the
     last for the global clip's sums of squares, each launched 4 x 29
     times, K2-K4 not at all); then 2 steps each of the CLI with
     --optimizer adamw and with --optimizer lamb --precision bf16, with
     finite losses;
  T. causal-LM pretraining of gemma2-2b at full width (seq 1024, so the
     chunked loss runs in 2 chunks of 512; batch 2, seed 0,
     warmup-hold-decay, fp32 policy): (d) at full depth on one batch, the
     chunked loss equals lm_loss on the whole (2, 1024, 256000) logits
     within 1e-5 relative and is what Arch.loss_fn returns, and the
     gradients with each period recomputed (remat) equal those with every
     activation kept within 1e-5, peak memory printed both ways; (b) at
     full width and 2 periods (4 layers: the 589,824,000-element
     embedding leaf whole, and both routes fit the card), one shared set
     of step-1 gradients applied by lans and fused_lans agrees leaf by
     leaf within 2e-5, and on the bf16 policy fused_mixed_lans against
     mixed_precision(lans) (masters and moments 2e-5, bf16 params 2e-2);
     (a) at full depth, 3 steps through the CLI (--arch gemma2-2b --full
     --optimizer lans, unfused) and through build_train_step +
     fused_lans from the same seed and batches: losses finite, the
     trajectories within 1e-2 relative, K1-K3 each launched 3 x 24 (the
     leaves) times, step times and peak memory printed, one fused step
     profiled (launches per step, device busy and idle share); (c) 2 bf16
     steps through fused_mixed_lans at full depth: K4 launched applied
     steps x 24 times, K3 never; (e) K1-K4 at the embedding leaf held to
     their plain versions (K1 bitwise repeatable with its capped
     partials) and timed beside their byte bounds, and the kernels of one
     whole fused LANS update over gemma2-2b's 2,614,341,888 parameters
     beside 48 bytes per parameter. Each sub-phase's time is printed;
  A. the analysis, on phase 7's fused BERT-large step (after its
     profile) and phase T(a)'s fused gemma2-2b step: the dry run of the
     same configuration on one device (launch/dryrun.py on meta tensors:
     FLOPs by dtype, bytes, argument and temp bytes); its argument bytes
     of params and state equal the live ones on the card; 3 steps after a
     warm-up, each ended by a synchronize: the achieved TFLOP/s over the
     wall and over the profiled device busy time, the MFU (the counted
     matmul FLOPs over the wall time at the peak of their dtype), the
     roofline share (the dry run's bound over the wall, and its
     dominant term) and the predicted peak memory (argument + temp)
     over max_memory_allocated; a summary of both before the last lines;
  D. the mesh and the router (after phase T, its memory freed): (a)
     gemma2-2b at full width, fp32, K8, block 16, 4 slots per engine: a
     chat service's stream of 3 tenants x 4 requests (a 64-token system
     prompt each, user turns of 16-48 tokens) and 2 prompts shorter than
     a block, 32 new tokens each, after a warm-up, on one engine, on
     ReplicaRouter over 2 replicas sharing one params tree with each of
     prefix, depth and rr, and on one engine with --sched-policy
     prefix-affinity: greedy tokens equal across the runs, K8 launched
     decode steps x 26 summed over the replicas in each, under prefix
     routed_fallback 2 and routed_affinity_hits >= 9; tokens/s,
     retained_hit_rate, prefix blocks written per replica and peak
     memory printed (not gated); then the CLI with --replicas 2
     --route-policy prefix --shared-prefix 64 against --replicas 1:
     tokens equal, K8 launched decode steps x 26; (b) BERT-large at full
     width, 6 of its 24 layers (fp32 compute, seq 128, global batch 16,
     seed 0, 3 fused_lans steps, hold schedule) on meshes whose two ranks
     are two processes on the one card under gloo (said why on a line):
     on 2 x 1, losses within 1e-4 relative of a one-process fused run on
     the same global batch, its gradient summed in the mesh's order (the
     two blocks of 8 on their own, the means over the 16, the blocks'
     gradients added), step-1 params within 2e-5, every element, no
     partial all-reduce; on 2 x 1 with zero3 (each layer gathered at its
     use, gradients reduce-scattered) the same gates; on 1 x 2 (attention
     and MLP split over "model" on whole heads) the same gates against
     the one-process run with its matmuls split as the two model ranks
     split them (mesh_worker.mesh_order), and the step-1 gradient within
     rtol 1e-5 / atol 1e-6 of the one process's, every element, and the
     fused update on the mesh's own step-1 gradient within 2e-5 of the
     one-device optimizer's on that gradient; K1-K3
     launched 3 x 29 times on each rank in every run; rank 1's peak
     under zero3 and under 1 x 2 at most 0.70 x its 2 x 1 peak; step
     ms, collective ms per step and peak memory per rank printed;
     (d) granite-moe-3b-a800m at full width (d 1536, 40 experts) and 1
     layer on 2 x 1, each rank's block routed as its group: the gates
     of (b)'s 2 x 1 against the mesh-order one-process run, K1-K3 3 x
     12 per rank, router_entropy printed beside the one process's; (f)
     on 1 x 2, the model axis computing on what it cuts, at full width,
     2 fused_lans steps each: granite-moe-3b-a800m (1 layer, (d)'s
     batch; 20 of the 40 experts a rank), gemma2-2b (2 layers, seq 1024,
     batch 2; its tied embedding, readout and chunked loss on 128,000
     vocab rows a rank) and mamba2-130m (24 layers, seq 1024, batch 2;
     12 of each mixer's 24 heads a rank, vocab 50280 cut too): (b)'s 1 x
     2 gates against the one-process run that splits the experts, the
     vocab and the Mamba mixers as the ranks do (mesh_worker.model_split),
     K1-K3 launched 2 x the rank's leaves on each rank, and no shape the
     fetch gathered on either rank that of an expert stack, a vocab-cut
     table or a Mamba projection; step ms, collective ms per step, the
     largest gathered shape and rank 1's peak beside the one-process
     run's printed. Both ranks exit 0 within the join timeout; (c) the
     sharded-leaf contract
     in one process: the
     100,663,296-element leaf cut into 2 and 4 shards, K1-K3, K1/K2/K4
     (bf16 copy) and K1/K5/K6 run on each shard with their partial sums
     added, equal to the whole leaf's run within 2e-5 (the bf16 copy
     2e-2), each output held under the kernel that computes it (K1's
     summed sums; K2's and K5's summed norms, m and v; K3's, K4's and
     K6's x) and for each shard count; each kernel timed on one shard
     beside its byte bound; (e) the serving engine on a mesh (run after
     (d), before (c)): gemma2-2b at full width and depth, fp32, K8, 4
     slots, block 16, phase 3's stream after a warm-up stream, through
     the engine on 2 x 1 (two slots and half of every arena's data blocks
     per rank) and 1 x 2 (4 of the 8 heads and 2 of the 4 KV heads, and
     half the MLP columns, per rank), two gloo processes on the one card,
     then through the CLI with --mesh 2x1: greedy tokens equal phase 3's
     on every rank, K8 launched decode steps x 26 on every rank, each
     rank's data-block bytes exactly half of one card's; each rank's
     arena bytes, KV heads, peak memory, median decode step and
     collective ms per step printed. On 1 x 2 the tied 256,000-row vocab
     is cut too (128,000 rows a rank, the picks taken over "model"), and
     phase S's sampled stream (temperature=0.8,top_k=50,top_p=0.9,seed=3)
     runs after the greedy one: its tokens equal phase S's; on both
     meshes run_one serves the stream's first two requests at batch 1
     (whole on every data rank), their tokens phase 3's; on 2 x 1 a
     fresh engine of 3 slots (which do not divide over two data ranks:
     each rank holds and decodes all three) serves the stream, its
     tokens the one-card engine's at max_batch 3; (g) serving
     on 1 x 2 cuts what training's model axis cuts (after (e), two gloo
     processes on the one card, fp32, (e)'s stream after a warm-up
     stream): granite-moe-3b-a800m at full width and depth with K8, 20
     of its 40 experts a rank (its 49155-row vocab does not divide), and
     mamba2-130m, 12 of its 24 heads and 25,140 of its vocab rows a rank
     (in_proj and conv_w placed at load in its heads' columns, its
     heads' SSM state): greedy tokens equal phase M's one-card tokens, K8
     launched decode steps x 32 on each rank for granite and never for
     mamba2, each rank's bytes of expert stacks, vocab tables and Mamba
     out_proj exactly half of one card's and of in_proj / conv_w exactly
     its columns'; each rank's peak, median decode step and collective
     ms per step printed, and (g)'s seconds; (h) attention in head groups
     (after (g)): gemma2-2b at full width and one period (2 layers) on a
     1 x 8 mesh, eight gloo processes on the one card, its 8 heads and 4
     KV heads cut into 4 groups of 2 ranks (distributed/sharding.py:
     head_groups): (e)'s stream through the engine, greedy tokens equal
     the one-card engine's at 2 layers, K8 launched decode steps x 2 on
     every rank, each rank's K/V arena and wq / wk / wv bytes exactly 1/4
     of one card's and its wo bytes 1/8, its median decode step and
     collective ms printed; then one fused_lans step (seq 128, batch 2)
     on the same mesh with (f)'s gates against the one process that
     splits the heads as the ranks do (mesh_worker.model_split), K1-K3
     launched once per leaf on each rank, and every rank's gathered
     shapes exactly a head group's wq and wk / wv columns (no whole
     wq / wk / wv, no wo). Phase 2 also holds K8 at a 1 x 8 rank's heads
     (h 2, n_kv 1, hd 256) and times it beside its bound.

The last lines are the card's name and power limit (nvidia-smi), one
JSON line describing every kernel, and
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or without the repository beside this script, it
exits non-zero and prints no result.
"""
from __future__ import annotations

import itertools
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
# phase T holds two generations of gemma2-2b's params and moments (~73 GB
# on the bf16 route): grow the allocator's segments instead of carving
# fixed blocks, so that freed leaves of different sizes do not strand
# memory between them
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
TOL = dict(rtol=1e-5, atol=1e-5)
SLEEP_CYCLES = 1_000_000            # ~0.5 ms of card time ahead of a timing
LANS_TOL = {"fp32": dict(rtol=2e-5, atol=2e-5),
            "bf16": dict(rtol=2e-2, atol=2e-2)}
LARGEST_LEAF = 24 * 1024 * 4096      # BERT-large layers/mlp/up/kernel
BERT_LEAVES = 29
EMBED_LEAF = 256000 * 2304           # gemma2-2b's embedding, its largest
DECODER_ARGV = ["--arch", "gemma2-2b", "--full", "--optimizer", "lans",
                "--precision", "fp32", "--steps", "3", "--batch", "2",
                "--seq", "1024", "--seed", "0", "--schedule", "hold",
                "--device", "cuda", "--log-every", "1"]
TRAIN_ARGV = ["--arch", "bert-large", "--full", "--optimizer", "lans",
              "--precision", "fp32", "--steps", "4", "--batch", "16",
              "--seq", "128", "--seed", "0", "--schedule", "hold",
              "--device", "cuda", "--log-every", "1"]
SERVE_ARGV = ["--arch", "gemma2-2b", "--full", "--precision", "fp32",
              "--attn-kernel", "paged", "--requests", "8", "--max-batch",
              "4", "--prompt-len", "64", "--new-tokens", "32", "--seed", "0"]
SPEC_ARGV = ["--spec-draft", "self", "--spec-k", "4"]
SAMPLER_ARGV = ["--sampler", "temperature=0.8,top_k=50,top_p=0.9,seed=3"]
N_LAYERS = 26                        # gemma2-2b
LOCAL_HEADS = (4, 2)                 # gemma2-2b's heads on a 1 x 2 rank
GROUP_HEADS = (2, 1)                 # on a 1 x 8 rank: 4 head groups of 2
GRANITE_ARGV = ["--arch", "granite-moe-3b-a800m", "--full", "--precision",
                "fp32", "--attn-kernel", "paged", "--requests", "8",
                "--max-batch", "4", "--prompt-len", "64", "--new-tokens",
                "32", "--seed", "0", "--device", "cuda"]
GRANITE_LAYERS = 32                  # granite-moe-3b-a800m
GRANITE_HEADS = dict(n_heads=24, n_kv=8, head_dim=64, block_size=16)
GEMMA_HEADS = dict(n_heads=8, n_kv=4, head_dim=256, block_size=16)
WHISPER_SERVE_ARGV = ["--arch", "whisper-large-v3", "--full", "--precision",
                      "fp32", "--requests", "8", "--max-batch", "4",
                      "--prompt-len", "8", "--new-tokens", "32",
                      "--shared-inputs", "2", "--seed", "0", "--device",
                      "cuda"]
WHISPER_BLOCKS = 94                  # 1500 frames in blocks of 16 rows
BERT_SCORE_ARGV = ["--arch", "bert-large", "--full", "--precision", "fp32",
                   "--task", "score", "--requests", "32", "--max-batch", "8",
                   "--prompt-len", "128", "--seed", "0", "--device", "cuda"]
WHISPER_TRAIN_ARGV = ["--arch", "whisper-large-v3", "--full", "--optimizer",
                      "lans", "--precision", "fp32", "--steps", "3",
                      "--batch", "2", "--seq", "128", "--seed", "0",
                      "--schedule", "hold", "--device", "cuda",
                      "--log-every", "1"]
WHISPER_LEAVES = 46
WHISPER_LEAF = 32 * 5120 * 1280      # whisper's mlp up/down kernels


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def evict_l2(flush):
    """Fill the L2 cache with clean lines of `flush` (256 MB, read): the
    serving loop reaches a layer's arena after streaming the model's
    weights, so it finds the cache cold and clean. A write flush would
    leave dirty lines whose write-back the timed call would pay."""
    flush.sum()


def time_ms(fn, flush, n=30, warmup=3):
    """Median device time of fn() over n launches, each after evict_l2.
    The card sleeps between the eviction and the start event, so fn()'s
    host work is queued while it sleeps and the events time the device
    work alone; the median drops the odd launch that a host stall longer
    than the sleep still reaches."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        evict_l2(flush)
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_launches(torch, fn, flush, n=10):
    """{kernel: (launches per call, mean device us per launch)} of the
    paged-attention kernels fn() launches, from torch.profiler over n
    calls, each after evict_l2."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            evict_l2(flush)
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if e.device_type == DeviceType.CUDA and "paged" in e.key and us > 0:
            name = re.search(r"\w*paged\w*", e.key).group(0)
            out[name] = (e.count / n, us / e.count)
    return out


def time_reps(torch, fn, reps):
    """Mean device time of fn() over reps back-to-back calls after one
    warm-up call (a whole optimizer update: caches stay warm, as in a
    training loop)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def card_bound(flops, nbytes):
    """(bound ms, "bytes" or "operations") of work on the card: the bytes
    at its memory rate and the FLOPs (fp32, outside the tensor cores) at
    that peak, the NVIDIA H100 SXM constants of launch/mesh.py."""
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS
    t_bytes = nbytes / HBM_BW * 1e3
    t_ops = flops / PEAK_FLOPS["float32"] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def bytes_ms(nbytes):
    """Milliseconds to move `nbytes` at the card's memory rate."""
    from repro_torch.launch.mesh import HBM_BW
    return nbytes / HBM_BW * 1e3


def kernel_cost(name, g, x):
    """(FLOPs, bytes) of one launch of optimizer kernel `name` on the
    gradient g and weights x (the cost functions beside the kernels)."""
    import torch
    from repro_torch.kernels import lamb as kb
    from repro_torch.kernels import lans as kl
    return {"sq_norm": lambda: kl.sq_norm_cost(g),
            "lans_phase1": lambda: kl.lans_phase1_cost(g, x),
            "lans_phase2": lambda: kl.lans_phase2_cost(g, x),
            "lans_phase2_cast": lambda: kl.lans_phase2_cost(
                g, x, torch.bfloat16),
            "lamb_phase1": lambda: kb.lamb_phase1_cost(g, x),
            "lamb_phase2": lambda: kb.lamb_phase2_cost(x)}[name]()


def update_bytes(leaves, names):
    """Bytes the kernels `names` move, each once per leaf of `leaves`
    (fp32 weights, their gradients fp32)."""
    return sum(kernel_cost(k, t, t)[1] for t in leaves for k in names)


LANS_K123 = ("sq_norm", "lans_phase1", "lans_phase2")


def paged_bound(args):
    """(bound ms, bound_by, bytes, flops) of one paged-attention call on
    these inputs (K8's nine operands, or K7's six), by the kernel's cost
    (kernels/paged_attention.py: paged_cost) on the blocks, table entries
    and valid rows of this call's data."""
    from repro_torch.kernels import paged_attention as pa
    if len(args) == 9:
        q, k_new, v_new, k_arena, v_arena, pos, tables, q_pos, cursor = args
    else:
        q, k_arena, v_arena, pos, tables, q_pos = args
        k_new = cursor = None
    flops, nbytes = pa.paged_cost(q, k_arena, tables, q_pos, k_new=k_new,
                                  cursor=cursor,
                                  **pa.paged_counts(tables, q_pos))
    return (*card_bound(flops, nbytes), nbytes, flops)


def read_args(args):
    """K7's operands (q, arenas, positions, tables, q_pos) of a K8 case."""
    q, _, _, k_arena, v_arena, pos, tables, q_pos, _ = args
    return q, k_arena, v_arena, pos, tables, q_pos


def paged_parity_at(torch, pa, args, kw, where):
    """K7 on the arenas before the write and K8 against their plain
    versions within 1e-5, arenas torch.equal, dead slots exactly 0; K7
    on the arenas K8 has just written, with the same q, equal to K8's
    output within 1e-5; a second launch of each on the same inputs equal
    bit for bit. Leaves `args` written as K8 writes them. Returns the
    largest |kernel - plain| of each and of K7 on K8's arenas."""
    read = read_args(args)
    fresh = [a.clone() for a in args]
    out7 = pa.paged_attention(*read, **kw)
    again7 = pa.paged_attention(*read, **kw)
    want7 = pa.paged_attention_plain(*read, **kw)
    plain = [a.clone() for a in args]
    out = pa.paged_attention_fused(*args, **kw)
    want = pa.paged_attention_fused_plain(*plain, **kw)
    again = pa.paged_attention_fused(*fresh, **kw)
    after7 = pa.paged_attention(*read_args(args), **kw)
    torch.cuda.synchronize()
    err = {}
    for name, got, ref in (("paged_attention", out7, want7),
                           ("paged_attention_fused", out, want)):
        torch.testing.assert_close(got, ref, **TOL,
                                   msg=lambda m: f"{name} {where}: {m}")
        err[name] = (got - ref).abs().max().item()
        check(bool((got[-1] == 0).all()), f"{name}: dead slot is not 0 "
                                          f"{where}")
    torch.testing.assert_close(after7, out, **TOL,
                               msg=lambda m: f"K7 on K8's arenas {where}: "
                                             f"{m}")
    err["k7_on_k8"] = (after7 - out).abs().max().item()
    check(torch.equal(out7, again7), f"K7 does not repeat bit for bit "
                                     f"{where}")
    check(torch.equal(out, again), f"K8 does not repeat bit for bit {where}")
    for name, got, ref, rep in zip(("k", "v", "pos"), args[3:6], plain[3:6],
                                   fresh[3:6]):
        check(torch.equal(got, ref) and torch.equal(rep, ref),
              f"{name} arena differs from the plain version {where}")
    return err


def phase_kernels(torch, pa):
    """Phase 2: K8 and K7 parity cases, K7 on K8's post-write arenas,
    then parity and timing at the serving shapes and at a long context,
    and K7's path. Returns the two kernels' entries; K8's lacks
    `launches` until the serving run."""
    max_err = {"paged_attention_fused": 0.0, "paged_attention": 0.0}
    k7_vs_k8 = 0.0
    n_cases = 0
    # gemma2-2b's heads, and a rank's on a 1 x 2 mesh (phase D(e)) and
    # on a 1 x 8 mesh (phase D(h))
    for (h, n_kv), (kv_dt, q_dt) in itertools.product(
            ((8, 4), LOCAL_HEADS, GROUP_HEADS),
            ((torch.float32, torch.float32),
             (torch.bfloat16, torch.float32),
             (torch.bfloat16, torch.bfloat16))):
        for S in (1, 4):
            for window, null_write in itertools.product((None, 24),
                                                        (False, True)):
                args = pa.decode_case(B=4, S=S, n_heads=h, n_kv=n_kv,
                                      head_dim=256, block_size=16, nb=8,
                                      dtype=kv_dt, q_dtype=q_dt,
                                      device="cuda", seed=n_cases,
                                      null_write=null_write)
                where = (f"(h={h}, n_kv={n_kv}, {kv_dt}, S={S}, "
                         f"window={window}, null_write={null_write})")
                kw = dict(scale=256 ** -0.5, window=window, softcap=50.0)
                err = paged_parity_at(torch, pa, args, kw, where)
                k7_vs_k8 = max(k7_vs_k8, err.pop("k7_on_k8"))
                for name, e in err.items():
                    max_err[name] = max(max_err[name], e)
                n_cases += 1
    print(f"kernel parity: paged_attention_fused (K8) and paged_attention "
          f"(K7), {n_cases} cases each (h 8 / n_kv 4, a 1 x 2 rank's h "
          f"{LOCAL_HEADS[0]} / n_kv {LOCAL_HEADS[1]} and a 1 x 8 rank's h "
          f"{GROUP_HEADS[0]} / n_kv {GROUP_HEADS[1]}), max |out - plain| K8 "
          f"{max_err['paged_attention_fused']:.3e}, K7 "
          f"{max_err['paged_attention']:.3e}, K7 on K8's post-write arenas "
          f"vs K8 {k7_vs_k8:.3e} (tolerance 1e-5); arenas torch.equal; "
          f"dead slots exactly 0; second launches bit for bit equal")

    # the serving run's shapes: 4 slots, S=1, ring 96 rows = 6 blocks of
    # 16, bf16 arenas (the pool's storage dtype), fp32 queries (fp32
    # policy), window 4096 on local layers and softcap 50; then the same
    # with a 4096-row ring (256 blocks): the context of gemma2-2b's window
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    entries = {}
    kw = dict(scale=256 ** -0.5, window=4096, softcap=50.0)
    for shape, nb in (("serving", 6), ("long-context", 256)):
        args = pa.decode_case(B=4, S=1, n_heads=8, n_kv=4, head_dim=256,
                              block_size=16, nb=nb, dtype=torch.bfloat16,
                              q_dtype=torch.float32, device="cuda", seed=99)
        read = read_args(args)
        errs = paged_parity_at(torch, pa, args, kw, f"({shape} shape)")
        print(f"kernel parity at the {shape} shape (nb={nb}): max |out - "
              f"plain| K8 {errs['paged_attention_fused']:.3e}, K7 "
              f"{errs['paged_attention']:.3e}, K7 on K8's arenas "
              f"{errs['k7_on_k8']:.3e} (tolerance 1e-5); arenas "
              f"torch.equal; second launches bit for bit equal")
        for name in max_err:
            max_err[name] = max(max_err[name], errs[name])
        plain = [a.clone() for a in args]
        for name, kern, plain_fn, operands in (
                ("paged_attention_fused",
                 lambda: pa.paged_attention_fused(*args, **kw),
                 lambda: pa.paged_attention_fused_plain(*plain, **kw), args),
                ("paged_attention", lambda: pa.paged_attention(*read, **kw),
                 lambda: pa.paged_attention_plain(*read, **kw), read)):
            ms = time_ms(kern, flush)
            plain_ms = time_ms(plain_fn, flush)
            launches = device_launches(torch, kern, flush)
            bound_ms, bound_by, nbytes, flops = paged_bound(operands)
            print(f"kernel timing {name} ({shape} shape: B=4 S=1 h=8 n_kv=4 "
                  f"hd=256 bs=16 nb={nb}, bf16 arenas, L2 evicted): kernel "
                  f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bound_ms:.6f} ms by {bound_by} ({nbytes} bytes at 3.35 "
                  f"TB/s, {flops} flops at 67 TFLOP/s fp32), bound / time "
                  f"{bound_ms / ms:.3f}; device time per launch (profiler) "
                  + ", ".join(f"{k} {c:g} x {us:.2f} us"
                              for k, (c, us) in launches.items())
                  + f", sum {sum(c * us for c, us in launches.values()):.2f}"
                  f" us per call")
            timing = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                          bound_by=bound_by, device_us={
                              k: us for k, (_, us) in launches.items()})
            if shape == "serving":
                line = 527 if name == "paged_attention_fused" else 342
                entries[name] = dict(
                    name=name, route="cuda",
                    source="src/repro_torch/kernels/csrc/paged_attention.cu",
                    replaces=f"src/repro/kernels/paged_attention_kernel.py:"
                             f"{line}", library_ms=None, **timing)
            else:
                entries[name]["long_context"] = dict(nb=nb, **timing)
    for name in entries:
        entries[name]["max_abs_err"] = max_err[name]
    entries["paged_attention_fused"]["mesh_local"] = local_heads_timing(
        torch, pa, flush, kw)
    entries["paged_attention_fused"]["mesh_groups"] = local_heads_timing(
        torch, pa, flush, kw, GROUP_HEADS, "1 x 8")

    entries["paged_attention"]["launches"] = k7_path(
        torch, pa, torch.float32, "gemma2-2b", gemma_layer_kw)
    return entries


def local_heads_timing(torch, pa, flush, kw, heads=LOCAL_HEADS,
                       mesh="1 x 2"):
    """K8 at a mesh rank's `heads` (1 x 2: h 4, n_kv 2; 1 x 8, a head
    group's: h 2, n_kv 1; hd 256) at the serving shape: held to its plain
    version (1e-5, arenas torch.equal) and timed beside its byte bound.
    Returns its entry."""
    h, n_kv = heads
    args = pa.decode_case(B=4, S=1, n_heads=h, n_kv=n_kv, head_dim=256,
                          block_size=16, nb=6, dtype=torch.bfloat16,
                          q_dtype=torch.float32, device="cuda", seed=97)
    errs = paged_parity_at(torch, pa, args, kw, f"({mesh} local heads)")
    plain = [a.clone() for a in args]
    ms = time_ms(lambda: pa.paged_attention_fused(*args, **kw), flush)
    plain_ms = time_ms(lambda: pa.paged_attention_fused_plain(*plain, **kw),
                       flush)
    bound_ms, bound_by, nbytes, flops = paged_bound(args)
    print(f"kernel timing paged_attention_fused ({mesh} rank's heads: B=4 "
          f"S=1 h={h} n_kv={n_kv} hd=256 bs=16 nb=6, bf16 arenas, L2 "
          f"evicted): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.6f} ms by {bound_by} ({nbytes} bytes, {flops} "
          f"flops), bound / time {bound_ms / ms:.3f}; max |out - plain| "
          f"{errs['paged_attention_fused']:.3e} (tolerance 1e-5)")
    return dict(n_heads=h, n_kv=n_kv, head_dim=256, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=errs["paged_attention_fused"])


def gemma_layer_kw(layer):
    """gemma2-2b's K7/K8 arguments at `layer` (local layers windowed)."""
    return dict(scale=256 ** -0.5, softcap=50.0,
                window=4096 if layer % 2 == 0 else None)


def k7_path(torch, pa, q_dtype, arch, layer_kw):
    """K7's path: its library entry, as a read of one decode step of
    `arch` at the serving shapes (4 slots, 96-row rings, bf16 arenas),
    with K7's count set to 0 just before and read just after. Returns the
    count."""
    heads, n_layers = ((GEMMA_HEADS, N_LAYERS) if arch == "gemma2-2b"
                       else (GRANITE_HEADS, GRANITE_LAYERS))
    read = read_args(pa.decode_case(
        B=4, S=1, nb=6, dtype=torch.bfloat16, q_dtype=q_dtype,
        device="cuda", seed=99, **heads))
    pa.paged_attention.launches = 0
    for layer in range(n_layers):
        out = pa.paged_attention(*read, **layer_kw(layer))
    torch.cuda.synchronize()
    launches = pa.paged_attention.launches
    check(launches == n_layers,
          f"K7 launched {launches} times for {n_layers} layers")
    check(bool(torch.isfinite(out).all()), "K7's path gave non-finite "
          "output")
    print(f"K7 path: paged_attention over {n_layers} layers of one {arch} "
          f"decode step at the serving shapes, q {q_dtype}, {launches} "
          f"launches")
    return launches


def serve(serve_mod, argv, label):
    """Serve through the CLI; check 8 requests and, on the continuous
    engine (the static one counts no logits), finite logits."""
    stats, done = serve_mod.main(argv)
    tokens = {r.rid: r.generated.tolist() for r in done}
    print(f"serve[{label}]: requests={stats['requests']} "
          f"tokens={stats['tokens']} "
          f"decode_steps={stats.get('decode_steps', 'n/a')} "
          f"tokens_per_s={stats['tokens_per_s']:.2f} "
          f"ttft_p50_ms={stats['ttft_p50_ms']:.2f} "
          f"ttft_p99_ms={stats['ttft_p99_ms']:.2f} "
          f"itl_p50_ms={stats['itl_p50_ms']:.2f} "
          f"itl_p99_ms={stats['itl_p99_ms']:.2f} "
          f"wall_s={stats['wall_s']:.2f}")
    check(stats["requests"] == 8 and stats["tokens"] > 0,
          f"{label}: served {stats['requests']} requests")
    if stats["engine"] == "continuous":
        check(stats["nonfinite_logit_steps"] == 0,
              f"{label}: {stats['nonfinite_logit_steps']} steps had "
              f"NaN/inf logits")
    return stats, tokens


def with_flag(argv, flag, value):
    """argv with `flag`'s value replaced (or the flag appended)."""
    out = list(argv)
    if flag in out:
        out[out.index(flag) + 1] = value
    else:
        out += [flag, value]
    return out


def without_flag(argv, flag):
    out = list(argv)
    i = out.index(flag)
    return out[:i] + out[i + 2:]


def spec_verify_timing(torch, pa, flush, S=4, dtype=None):
    """Phase S (g): K8 at S query rows (4: the spec run's; 16, a whole
    block, also with fp32 arenas: the rows that fold with two key groups)
    at the serving shapes (4 slots, 7-block tables: 96 rows + the row
    margin's block, bf16 arenas, fp32 q, window 4096, softcap 50) held to
    its plain version and timed as in phase 2. Returns its entry (without
    `launches`)."""
    dtype = dtype or torch.bfloat16
    args, fl = pa.verify_case(S=S, n_heads=8, n_kv=4, head_dim=256,
                              block_size=16, nb=7, dtype=dtype,
                              q_dtype=torch.float32, device="cuda",
                              seed=11)
    kw = dict(scale=256 ** -0.5, window=4096, softcap=50.0)
    errs = paged_parity_at(torch, pa, args, kw, f"(verify shape, S={S})")
    plain = [a.clone() for a in args]
    kern = lambda: pa.paged_attention_fused(*args, **kw)  # noqa: E731
    ms = time_ms(kern, flush)
    plain_ms = time_ms(
        lambda: pa.paged_attention_fused_plain(*plain, **kw), flush)
    launches = device_launches(torch, kern, flush)
    bound_ms, bound_by, nbytes, flops = paged_bound(args)
    arena = "bf16" if dtype == torch.bfloat16 else "fp32"
    print(f"kernel parity and timing paged_attention_fused at S={S} "
          f"(verify shape: B=4 h=8 n_kv=4 hd=256 bs=16 nb=7 row-margined, "
          f"real rows per slot {fl.tolist()}, {arena} arenas, key groups "
          f"{pa.key_groups(S, 8, 4, 256, 16, dtype)}, L2 evicted): max "
          f"|out - "
          f"plain| {errs['paged_attention_fused']:.3e} (tolerance 1e-5), "
          f"arenas torch.equal, second launch bit for bit; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
          f"by {bound_by} ({nbytes} bytes, {flops} flops), bound / time "
          f"{bound_ms / ms:.3f}; device time per launch (profiler) "
          + ", ".join(f"{k} {c:g} x {us:.2f} us"
                      for k, (c, us) in launches.items()))
    return dict(S=S, nb=7, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, max_abs_err=errs["paged_attention_fused"],
                device_us={k: us for k, (_, us) in launches.items()})


def phase_spec(torch, pa, serve_mod, paged, paged_tokens, flush):
    """Phase S: speculative and sampled serving of full-width gemma2-2b
    (see the module docstring). `paged` / `paged_tokens` are phase 3's
    fp32 kernel run. Returns K8's S = 4 entry for the kernels line and
    the sampled stream's tokens."""
    from repro_torch.configs import get_arch
    from repro_torch.models.decoder import paged_layout
    from repro_torch.serving import (ContinuousEngine, make_spec_pair,
                                     synthetic_requests)

    # (a) + (c): self-draft speculation through the CLI
    spec_argv = SERVE_ARGV + SPEC_ARGV
    pa.paged_attention_fused.launches = 0
    spec, spec_tokens = serve(serve_mod, spec_argv, "fp32 spec self paged")
    launches = pa.paged_attention_fused.launches
    check(spec_tokens == paged_tokens,
          "spec self (paged) greedy tokens differ from the non-spec run")
    check(spec["spec_rounds"] == spec["decode_steps"] > 0,
          f"spec run: {spec['spec_rounds']} rounds for "
          f"{spec['decode_steps']} decode steps")
    check(launches == spec["spec_rounds"] * N_LAYERS,
          f"K8 launched {launches} times for {spec['spec_rounds']} verify "
          f"rounds x {N_LAYERS} layers")
    print(f"spec self (paged): tokens equal the non-spec kernel run; "
          f"{spec['spec_rounds']} rounds, acceptance "
          f"{spec['acceptance_rate']:.4f}; K8 launches {launches} = "
          f"{spec['spec_rounds']} rounds x {N_LAYERS} (the draft: none)")
    before = pa.paged_attention_fused.launches
    _, xla_tokens = serve(serve_mod, with_flag(spec_argv, "--attn-kernel",
                                               "xla"), "fp32 spec self xla")
    check(pa.paged_attention_fused.launches == before,
          "the xla spec run launched K8")
    check(xla_tokens == paged_tokens,
          "spec self (xla) greedy tokens differ from the non-spec run")
    print("spec self (xla): tokens equal the non-spec kernel run")

    # (d) sampled decoding
    samp = {}
    for label, argv in (
            ("paged", SERVE_ARGV + SAMPLER_ARGV),
            ("spec", SERVE_ARGV + SAMPLER_ARGV + SPEC_ARGV),
            ("dense", without_flag(SERVE_ARGV, "--attn-kernel")
             + SAMPLER_ARGV + ["--cache", "dense"])):
        _, samp[label] = serve(serve_mod, argv, f"fp32 sampled {label}")
    check(samp["paged"] == samp["spec"],
          "sampled stream differs between spec and non-spec")
    check(samp["paged"] == samp["dense"],
          "sampled stream differs between the paged and the dense pool")
    check(samp["paged"] != paged_tokens, "the sampled stream is greedy")
    print("sampled (temperature=0.8,top_k=50,top_p=0.9,seed=3): paged == "
          "spec == dense streams")

    # (b) + (c): reject churn, through the engine API, greedy and sampled
    arch = get_arch("gemma2-2b")
    dev = torch.device("cuda")
    # the CLI's max_len (prompt + new tokens, whole blocks) and its rings
    # widened by the row margin of spec_k - 1 = 3 rows (one block)
    tables = tuple((4, ring // 16)
                   for _, ring in paged_layout(arch.cfg, 96, 16, 3))
    params = arch.init(torch.Generator(device=dev).manual_seed(0))
    # the one-period draft of an independently seeded gemma2-2b
    _, draft_arch, draft = make_spec_pair(
        arch, arch.init(torch.Generator(device=dev).manual_seed(1)))
    for sampler, want in ((None, paged_tokens),
                          (SAMPLER_ARGV[1], samp["paged"])):
        eng = ContinuousEngine(arch, params, max_batch=4, max_len=96,
                               policy="fp32", prefill_bucket=8,
                               attn_kernel="paged", sampler=sampler,
                               spec_draft=(draft_arch, draft), spec_k=4)
        shapes = []
        verify = eng._verify

        def recording_verify(params, tokens, positions, cache, *keys):
            shapes.append((tuple(tokens.shape),
                           tuple(t.shape for t in cache["tables"])))
            return verify(params, tokens, positions, cache, *keys)

        eng._verify = recording_verify
        pa.paged_attention_fused.launches = 0
        reqs = synthetic_requests(8, arch.cfg.vocab, prompt_len=64,
                                  new_tokens=32, seed=0)
        eng.run(reqs)
        launches = pa.paged_attention_fused.launches
        rep = eng.report(1.0)
        label = sampler or "greedy"
        check({r.rid: r.generated.tolist() for r in reqs} == want,
              f"reject-churn spec tokens ({label}) differ from the "
              f"non-spec run")
        check(rep["nonfinite_logit_steps"] == 0,
              f"reject churn ({label}): NaN/inf logits")
        check(len(shapes) == rep["spec_rounds"] > 0
              and all(s == ((4, 4), tables) for s in shapes),
              f"verify calls were not (4, 4) query blocks on the tables "
              f"{tables}: {sorted(set(shapes))}")
        check(launches == len(shapes) * N_LAYERS,
              f"K8 launched {launches} times for {len(shapes)} verify "
              f"calls")
        print(f"spec reject churn ({label}; make_spec_pair's one-period "
              f"draft of a gemma2-2b seeded 1): tokens equal the non-spec "
              f"run; {rep['spec_rounds']} rounds, {rep['drafted_tokens']} "
              f"drafted, {rep['accepted_tokens']} accepted, acceptance rate "
              f"{rep['acceptance_rate']:.4f}; every verify call (4, 4) rows "
              f"on {tables} tables; K8 launches {launches} = {len(shapes)} "
              f"x {N_LAYERS}")
        eng._verify = verify
        del eng, reqs
    del params, draft, draft_arch
    torch.cuda.empty_cache()

    # (e) the static engine on the dense pool
    _, static_tokens = serve(serve_mod, without_flag(
        SERVE_ARGV, "--attn-kernel") + ["--engine", "static", "--cache",
                                        "dense"], "fp32 static dense")
    check(static_tokens == paged_tokens,
          "static dense greedy tokens differ from continuous paged")
    print("static (dense): greedy tokens equal the continuous paged run")

    # (f) bf16
    bf16 = with_flag(with_flag(SERVE_ARGV, "--precision", "bf16"),
                     "--sampler", "temperature=0,stable=1")
    _, bf16_plain = serve(serve_mod, bf16, "bf16 stable paged")
    _, bf16_spec = serve(serve_mod, bf16 + SPEC_ARGV, "bf16 stable spec")
    same = sum(a == b for rid in bf16_plain
               for a, b in zip(bf16_plain[rid], bf16_spec[rid]))
    total = sum(len(t) for t in bf16_plain.values())
    print(f"bf16 spec (stable argmax): finite logits; {same} of {total} "
          f"tokens ({same / total:.4f}) equal the bf16 non-spec run (not "
          f"gated)")

    # (g) K8 at S = 4, at S = 16 (bf16 and fp32 arenas: two key
    # groups; not on the serving path, no launches counted), and the
    # end-to-end numbers of this call
    entry = spec_verify_timing(torch, pa, flush)
    entry["block_of_rows"] = [
        spec_verify_timing(torch, pa, flush, S=16, dtype=dt)
        for dt in (torch.bfloat16, torch.float32)]
    print(f"serve spec vs non-spec (fp32, kernel, same call): tokens_per_s "
          f"{spec['tokens_per_s']:.2f} vs {paged['tokens_per_s']:.2f}, "
          f"itl_p50_ms {spec['itl_p50_ms']:.2f} vs "
          f"{paged['itl_p50_ms']:.2f}, itl_p99_ms {spec['itl_p99_ms']:.2f} "
          f"vs {paged['itl_p99_ms']:.2f} (a round's tokens share one "
          f"timestamp; no gain claimed)")
    entry["launches"] = spec["spec_rounds"] * N_LAYERS
    return entry, samp["paged"]


def chunked_stream(vocab, n=12, seed=4):
    """Phase C's mixed stream: mostly short turns and a long-prompt
    minority whose whole-prompt prefill stalls every running stream."""
    from repro_torch.serving import bimodal_requests
    return bimodal_requests(n, vocab, short_len=64, long_len=512,
                            new_tokens=32, long_frac=0.25, seed=seed)


def serve_stream(torch, pa, serve_mod, argv, reqs, label):
    """Serve `reqs` through the CLI with `argv`, K8's count set to 0 just
    before and read just after. Returns (report, tokens in stream order,
    K8 launches)."""
    pa.paged_attention_fused.launches = 0
    stats, done = serve_mod.main(argv, requests=reqs)
    torch.cuda.synchronize()
    launches = pa.paged_attention_fused.launches
    check(len(done) == len(reqs) and stats["nonfinite_logit_steps"] == 0,
          f"{label}: {len(done)} of {len(reqs)} requests done, "
          f"{stats['nonfinite_logit_steps']} steps with NaN/inf logits")
    print(f"serve[{label}]: tokens={stats['tokens']} decode_steps="
          f"{stats['decode_steps']} chunk_steps="
          f"{stats.get('chunk_steps', 0)} chunk_tokens="
          f"{stats.get('chunk_tokens', 0)} chunk_sizes="
          f"{stats.get('chunk_sizes', {})} K8 launches={launches} "
          f"tokens_per_s={stats['tokens_per_s']:.2f} "
          f"ttft_p50_ms={stats['ttft_p50_ms']:.2f} "
          f"ttft_p99_ms={stats['ttft_p99_ms']:.2f} "
          f"itl_p50_ms={stats['itl_p50_ms']:.2f} "
          f"itl_p99_ms={stats['itl_p99_ms']:.2f} wall_s={stats['wall_s']:.2f}")
    return stats, [r.generated.tolist() for r in reqs], launches


def time_chunk_forwards(torch, ctrl, vocab, reps=10):
    """{size: median wall ms of one chunk forward} for every size the
    controller can run, each call against a fresh task cache and ended
    by a synchronize: what one engine step pays for its chunk."""
    out = {}
    for size in ctrl.sizes():
        tokens = torch.randint(5, vocab, (1, size), dtype=torch.int32,
                               device="cuda")
        positions = torch.arange(size, dtype=torch.int32,
                                 device="cuda")[None]
        wall = []
        for _ in range(reps):
            cache = ctrl._fresh_cache()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ctrl._fn(size)(ctrl.params, tokens, positions, cache)
            torch.cuda.synchronize()
            wall.append((time.perf_counter() - t0) * 1e3)
        out[size] = statistics.median(wall)
    return out


def print_profile(label, wall_ms, kernels, counts):
    """Device busy time, idle share and the top kernels of one profiled
    forward; returns (busy ms, idle share)."""
    busy = sum(kernels.values())
    check(busy > 0, f"profile[{label}]: the profiler saw no device work")
    print(f"profile[{label}]: wall {wall_ms:.2f} ms (under the profiler), "
          f"device busy {busy:.2f} ms, idle share {1 - busy / wall_ms:.3f},"
          f" {sum(counts.values())} launches")
    for name, ms in sorted(kernels.items(), key=lambda kv: -kv[1])[:6]:
        print(f"  {ms:8.3f} ms  {counts[name]:5d} x  {name[:100]}")
    return busy, 1 - busy / wall_ms


def phase_chunked(torch, pa, serve_mod, flush):
    """Phase C: chunked-prefill admission and open-loop Poisson traffic
    on full-width gemma2-2b (see the module docstring). Returns what K8's
    entry records of it: launches per run and K8 at this pool's shape."""
    from repro_torch.configs import get_arch
    from repro_torch.serving import (SLO, ContinuousEngine, OpenLoopDriver,
                                     percentile, poisson_arrivals,
                                     slo_report)
    t0 = time.perf_counter()
    arch = get_arch("gemma2-2b")
    vocab = arch.cfg.vocab
    stream = chunked_stream(vocab)
    max_len = max(len(r.prompt) + r.max_new_tokens for r in stream)
    max_len = -(-max_len // 16) * 16
    padded = sum(-(-len(r.prompt) // 16) * 16 for r in stream)
    print(f"phase C: 12 requests, prompts "
          f"{sorted(len(r.prompt) for r in stream)}, 32 new tokens each, "
          f"max_len {max_len}, padded prompt rows {padded}")
    argv = ["--arch", "gemma2-2b", "--full", "--precision", "fp32",
            "--attn-kernel", "paged", "--max-batch", "4", "--block-size",
            "16", "--prefill-bucket", "16", "--max-len", str(max_len),
            "--seed", "0", "--device", "cuda"]
    chunk = ["--chunk-budget", "64"]

    # (a) closed loop: unchunked and chunked with the kernel, chunked with
    # the plain-torch gather
    runs, launches = {}, {}
    for label, run_argv in (
            ("unchunked paged", argv),
            ("chunked paged", argv + chunk),
            ("chunked xla", with_flag(argv, "--attn-kernel", "xla") + chunk)):
        stats, runs[label], launches[label] = serve_stream(
            torch, pa, serve_mod, run_argv, chunked_stream(vocab),
            f"C {label}")
        if "paged" in label:
            check(launches[label] == stats["decode_steps"] * N_LAYERS,
                  f"{label}: K8 launched {launches[label]} times for "
                  f"{stats['decode_steps']} decode steps x {N_LAYERS}")
        else:
            check(launches[label] == 0, f"{label}: the xla run launched K8")
        if label.startswith("chunked"):
            check(stats["chunk_tokens"] >= padded,
                  f"{label}: {stats['chunk_tokens']} rows chunked for "
                  f"{padded} padded prompt rows")
    want = runs["unchunked paged"]
    check(runs["chunked paged"] == want and runs["chunked xla"] == want,
          "closed-loop greedy tokens differ between unchunked-paged, "
          "chunked-paged and chunked-xla")
    print(f"phase C(a): tokens equal across unchunked paged, chunked paged "
          f"and chunked xla; K8 launches = decode steps x {N_LAYERS} "
          f"in the kernel runs, none in the xla run")

    # (b) open loop: the same stream on a Poisson clock (2 requests/s),
    # through a warm unchunked engine and a warm chunked one
    params = arch.init(torch.Generator(device="cuda").manual_seed(0))

    def engine(chunk_budget=None):
        return ContinuousEngine(arch, params, max_batch=4, max_len=max_len,
                                policy="fp32", prefill_bucket=16,
                                block_size=16, attn_kernel="paged",
                                chunk_budget=chunk_budget)

    engines = {"unchunked": engine(), "chunked": engine(64)}
    engines["chunked"]._admission.warmup()
    warm_itl = []
    for name, eng in engines.items():
        warm = chunked_stream(vocab, n=6, seed=11)
        eng.run(warm)
        if name == "unchunked":
            warm_itl = [g for r in warm for g in r.trace.inter_token_s]
    # the SLOs of benchmarks/serving_load.py's open-loop workload: 4x the
    # warm unchunked ITL p50, and a loose TTFT bound
    itl_slo = 4 * percentile(warm_itl, 50) * 1e3
    slo = SLO(ttft_ms=max(1000.0, 40 * itl_slo), itl_ms=itl_slo)
    print(f"phase C(b): SLO from the warm unchunked ITL p50: ttft <= "
          f"{slo.ttft_ms:.2f} ms, itl <= {slo.itl_ms:.4f} ms")
    arrivals = poisson_arrivals(12, 2.0, seed=2)
    open_reports = {}
    for name, eng in engines.items():
        reqs = chunked_stream(vocab)
        steps = eng.steps_run
        pa.paged_attention_fused.launches = 0
        wall = OpenLoopDriver(eng, reqs, arrivals).run()
        torch.cuda.synchronize()
        n = pa.paged_attention_fused.launches
        launches[f"open {name}"] = n
        check(n == (eng.steps_run - steps) * N_LAYERS,
              f"open loop ({name}): K8 launched {n} times for "
              f"{eng.steps_run - steps} decode steps x {N_LAYERS}")
        check([r.generated.tolist() for r in reqs] == want,
              f"open-loop ({name}) tokens differ from the closed loop's")
        check(eng.report(wall)["nonfinite_logit_steps"] == 0,
              f"open loop ({name}): NaN/inf logits")
        rep = slo_report(reqs, slo, wall)
        open_reports[name] = rep
        print(f"open loop ({name}, 12 requests at 2.0/s, Poisson seed 2): "
              f"goodput {rep['goodput_tokens_per_s']:.2f} tokens/s (all "
              f"{rep['tokens_per_s']:.2f}), attainment "
              f"{rep['slo_attainment']:.4f}, ttft p50 "
              f"{rep['ttft_p50_ms']:.2f} p99 {rep['ttft_p99_ms']:.2f} ms, "
              f"itl p50 {rep['itl_p50_ms']:.2f} p99 "
              f"{rep['itl_p99_ms']:.2f} ms, violations ttft "
              f"{rep['ttft_violations']} itl {rep['itl_violations']}, "
              f"wall {wall:.2f} s, decode steps {eng.steps_run - steps}, "
              f"K8 launches {n} (tokens equal (a)'s)")
    ctrl = engines["chunked"]._admission
    chunk_ms = time_chunk_forwards(torch, ctrl, vocab)
    print("chunk forward, median wall of 10 with a synchronize: "
          + ", ".join(f"{size} rows {ms:.2f} ms"
                      for size, ms in chunk_ms.items()))
    # where a forward's time goes: one 32-row chunk (the size most chunks
    # ran at) and one decode step of 4 slots, each under the profiler
    tokens = torch.randint(5, vocab, (1, 32), dtype=torch.int32,
                           device="cuda")
    positions = torch.arange(32, dtype=torch.int32, device="cuda")[None]
    cache = ctrl._fresh_cache()
    profiles = {"chunk forward, 32 rows": print_profile(
        "chunk forward, 32 rows", *device_profile(
            torch, lambda: ctrl._fn(32)(ctrl.params, tokens, positions,
                                        cache)))}
    eng = engines["unchunked"]
    for r in chunked_stream(vocab, n=4, seed=12):
        r.prompt = r.prompt[:64]
        eng.submit(r)
    eng.step()                  # admits all four and decodes once
    check(len(eng.scheduler.active) == 4, "decode profile: not 4 slots")
    profiles["decode step, 4 slots"] = print_profile(
        "decode step, 4 slots", *device_profile(torch, eng.step))
    eng.run()
    del engines, ctrl, params, eng, cache
    torch.cuda.empty_cache()

    # (c) bf16 with the tie-stable argmax: equality is printed, not gated
    bf16 = with_flag(argv, "--precision", "bf16") + [
        "--sampler", "temperature=0,stable=1"]
    _, bf_whole, _ = serve_stream(torch, pa, serve_mod, bf16,
                                  chunked_stream(vocab), "C bf16 unchunked")
    _, bf_chunk, _ = serve_stream(torch, pa, serve_mod, bf16 + chunk,
                                  chunked_stream(vocab), "C bf16 chunked")
    same = sum(a == b for a, b in zip(bf_whole, bf_chunk))
    parts = [(i, next(j for j, (x, y) in enumerate(zip(a, b)) if x != y))
             for i, (a, b) in enumerate(zip(bf_whole, bf_chunk)) if a != b]
    print(f"phase C(c): bf16 (stable argmax) unchunked vs chunked paged: "
          f"{same} of 12 streams equal; first parting (request, token): "
          f"{parts[0] if parts else None} (not gated)")

    # K8 at this pool's shape: 4 slots, 34-block (544-row) rings
    args = pa.decode_case(B=4, S=1, n_heads=8, n_kv=4, head_dim=256,
                          block_size=16, nb=max_len // 16,
                          dtype=torch.bfloat16, q_dtype=torch.float32,
                          device="cuda", seed=7)
    kw = dict(scale=256 ** -0.5, window=4096, softcap=50.0)
    errs = paged_parity_at(torch, pa, args, kw, "(phase C shape)")
    plain = [a.clone() for a in args]
    ms = time_ms(lambda: pa.paged_attention_fused(*args, **kw), flush)
    plain_ms = time_ms(lambda: pa.paged_attention_fused_plain(*plain, **kw),
                       flush)
    bound_ms, bound_by, nbytes, flops = paged_bound(args)
    print(f"kernel timing paged_attention_fused (phase C shape: B=4 S=1 "
          f"nb={max_len // 16}, bf16 arenas, L2 evicted): kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
          f"by {bound_by} ({nbytes} bytes, {flops} flops), max |out - "
          f"plain| {errs['paged_attention_fused']:.3e}")
    print(f"phase C: {time.perf_counter() - t0:.1f} s")
    return dict(launches=launches, max_len=max_len, chunk_budget=64,
                nb=max_len // 16, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                max_abs_err=errs["paged_attention_fused"],
                chunk_forward_ms=chunk_ms,
                busy_ms_idle_share=profiles,
                open_loop={k: {m: v[m] for m in (
                    "goodput_tokens_per_s", "slo_attainment",
                    "ttft_p50_ms", "ttft_p99_ms", "itl_p50_ms",
                    "itl_p99_ms")} for k, v in open_reports.items()},
                bf16_equal_streams=same)


def serve_counted(torch, pa, serve_mod, argv, label):
    """serve() with K8's count set to 0 just before and read just after;
    also the run's peak memory. Returns (report, tokens, K8 launches,
    peak GB)."""
    torch.cuda.reset_peak_memory_stats()
    pa.paged_attention_fused.launches = 0
    stats, tokens = serve(serve_mod, argv, label)
    torch.cuda.synchronize()
    launches = pa.paged_attention_fused.launches
    peak = peak_gb(torch)
    print(f"serve[{label}]: K8 launches {launches}, peak memory "
          f"{peak:.2f} GB")
    return stats, tokens, launches, peak


def granite_case(pa, S, q_dtype, kv_dtype, seed, nb=6, null_write=False):
    """K8's operands at granite-moe-3b-a800m's heads (h 24, n_kv 8, hd
    64, block 16): decode_case at S = 1, verify_case (nb + 1 blocks, the
    row margin's) at S > 1."""
    kw = dict(**GRANITE_HEADS, dtype=kv_dtype, q_dtype=q_dtype,
              device="cuda", seed=seed)
    if S == 1:
        return pa.decode_case(B=4, S=1, nb=nb, null_write=null_write, **kw)
    return pa.verify_case(S=S, nb=nb + 1, **kw)[0]


def kernel_timing(torch, pa, args, kw, flush, S, label):
    """K8 and K7 (on the arenas before the write) at these operands:
    median device ms after an L2 eviction, the plain versions', the
    bounds and the profiler's split / combine times. Returns {name:
    entry}; K8's operands are left written."""
    read = read_args(args)
    plain = [a.clone() for a in args]
    out = {}
    for name, kern, plain_fn, operands in (
            ("paged_attention", lambda: pa.paged_attention(*read, **kw),
             lambda: pa.paged_attention_plain(*read, **kw), read),
            ("paged_attention_fused",
             lambda: pa.paged_attention_fused(*args, **kw),
             lambda: pa.paged_attention_fused_plain(*plain, **kw), args)):
        ms = time_ms(kern, flush)
        plain_ms = time_ms(plain_fn, flush)
        launches = device_launches(torch, kern, flush)
        bound_ms, bound_by, nbytes, flops = paged_bound(operands)
        print(f"kernel timing {name} ({label}, L2 evicted): kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.6f} ms by {bound_by} ({nbytes} bytes, {flops} "
              f"flops), bound / time {bound_ms / ms:.3f}; device time per "
              f"launch (profiler) "
              + ", ".join(f"{k} {c:g} x {us:.2f} us"
                          for k, (c, us) in launches.items()))
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by, library_ms=None,
                         device_us={k: us for k, (_, us) in launches.items()})
    return out


def moe_route_timing(torch, eng, reps=3):
    """Median wall ms of one decode step of `eng`'s 4 active slots and of
    a 4 x 64 forward (a batched prefill) on each MoE expert route of
    models/moe.py (the dense (E, cap) buffer, or each expert on its
    gathered rows), taken in the order dense, gathered, gathered, dense,
    `reps` of each per turn. Takes 4 * reps decode steps from `eng`."""
    from repro_torch.models import decoder as dec_lib
    from repro_torch.models import moe as moe_lib
    cfg = eng.arch.cfg
    tokens = torch.randint(0, cfg.vocab, (4, 64), device="cuda",
                           generator=torch.Generator("cuda").manual_seed(5))

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    times = {r: {"decode_ms": [], "prefill_ms": []}
             for r in ("dense", "gathered")}
    default = moe_lib.DENSE_ROWS
    try:
        for route in ("dense", "gathered", "gathered", "dense"):
            moe_lib.DENSE_ROWS = 1 << 62 if route == "dense" else 0
            for _ in range(reps):
                times[route]["decode_ms"].append(wall(eng.step))
            with torch.no_grad():
                for _ in range(reps):
                    times[route]["prefill_ms"].append(wall(
                        lambda: dec_lib.decoder_apply(eng.params, cfg,
                                                      tokens)))
    finally:
        moe_lib.DENSE_ROWS = default
    out = {r: {k: statistics.median(v) for k, v in t.items()}
           for r, t in times.items()}
    rows = cfg.n_experts * cfg.top_k           # E * cap per token, dropless
    print("granite MoE expert routes, median wall ms with a synchronize "
          f"({2 * reps} of each; a decode step of 4 slots, E * cap = "
          f"{rows * 4}; a 4 x 64 prefill forward, E * cap = {rows * 256}): "
          + "; ".join(f"{r} decode {t['decode_ms']:.2f} prefill "
                      f"{t['prefill_ms']:.2f}" for r, t in out.items())
          + f" (DENSE_ROWS {default})")
    return out


def phase_moe_mamba(torch, pa, serve_mod, flush, fp32_tokens):
    """Phase M: MoE, Mamba-2 and hybrid decoders served on the card, and
    fp16 serving (see the module docstring). `fp32_tokens` are phase 3's
    fp32 kernel run's. Returns K8's and K7's granite and fp16 entries,
    and under "tokens" granite's and mamba2's greedy tokens."""
    from repro_torch.configs import get_arch
    from repro_torch.serving import ContinuousEngine, synthetic_requests
    t_all = time.perf_counter()
    entries = {"paged_attention_fused": {}, "paged_attention": {}}

    # (a) granite-moe-3b-a800m at full width and depth, fp32
    t0 = time.perf_counter()
    warm = with_flag(with_flag(GRANITE_ARGV, "--requests", "2"),
                     "--new-tokens", "4")
    serve_mod.main(warm)
    print("serve: granite warm-up stream done (2 requests, 4 new tokens)")
    granite, g_tokens, g_launches, g_peak = serve_counted(
        torch, pa, serve_mod, GRANITE_ARGV, "granite fp32 paged")
    check(g_launches == granite["decode_steps"] * GRANITE_LAYERS,
          f"granite: K8 launched {g_launches} times for "
          f"{granite['decode_steps']} decode steps x {GRANITE_LAYERS}")
    _, x_tokens, x_launches, _ = serve_counted(
        torch, pa, serve_mod, with_flag(GRANITE_ARGV, "--attn-kernel",
                                        "xla"), "granite fp32 xla")
    check(x_launches == 0, "granite: the xla run launched K8")
    check(g_tokens == x_tokens,
          "granite: greedy tokens differ between the kernel and the gather")
    print(f"phase M(a): granite-moe-3b-a800m kernel == gather tokens; K8 "
          f"{g_launches} = {granite['decode_steps']} decode steps x "
          f"{GRANITE_LAYERS}; tokens_per_s {granite['tokens_per_s']:.2f}, "
          f"itl_p50_ms {granite['itl_p50_ms']:.2f}, itl_p99_ms "
          f"{granite['itl_p99_ms']:.2f}, peak {g_peak:.2f} GB")
    # where a granite decode step's time goes: 4 slots, under the profiler
    arch = get_arch("granite-moe-3b-a800m")
    params = arch.init(torch.Generator(device="cuda").manual_seed(0))
    eng = ContinuousEngine(arch, params, max_batch=4, max_len=96,
                           policy="fp32", prefill_bucket=8,
                           attn_kernel="paged")
    for r in synthetic_requests(4, arch.cfg.vocab, prompt_len=64,
                                new_tokens=32, seed=3, min_new_frac=1.0):
        eng.submit(r)
    eng.step()
    eng.step()
    check(len(eng.scheduler.active) == 4, "granite profile: not 4 slots")
    busy, idle = print_profile("granite decode step, 4 slots",
                               *device_profile(torch, eng.step))
    routes = moe_route_timing(torch, eng)
    eng.run()
    del eng, params
    torch.cuda.empty_cache()
    print(f"phase M(a): {time.perf_counter() - t0:.1f} s")

    # (b) K8 and K7 at granite's heads, every q dtype, both arena dtypes
    t0 = time.perf_counter()
    max_err = {"paged_attention_fused": 0.0, "paged_attention": 0.0}
    k7_vs_k8, n_cases = 0.0, 0
    qs = (torch.float32, torch.bfloat16, torch.float16)
    for q_dt, kv_dt in itertools.product(qs, (torch.bfloat16,
                                              torch.float32)):
        for S, null_write in ((1, False), (1, True), (4, False)):
            args = granite_case(pa, S, q_dt, kv_dt, seed=n_cases,
                                null_write=null_write)
            err = paged_parity_at(
                torch, pa, args, dict(scale=0.125),
                f"(granite heads, q {q_dt}, arenas {kv_dt}, S={S}, "
                f"null_write={null_write})")
            k7_vs_k8 = max(k7_vs_k8, err.pop("k7_on_k8"))
            for name, e in err.items():
                max_err[name] = max(max_err[name], e)
            n_cases += 1
    print(f"phase M(b): K8 and K7 at granite's heads (h 24, n_kv 8, hd 64, "
          f"block 16), {n_cases} cases (q fp32 / bf16 / fp16, bf16 and "
          f"fp32 arenas, S = 1 with and without a null-entry write, S = 4 "
          f"row-margined): max |out - plain| K8 "
          f"{max_err['paged_attention_fused']:.3e}, K7 "
          f"{max_err['paged_attention']:.3e}, K7 on K8's arenas "
          f"{k7_vs_k8:.3e} (tolerance 1e-5 for every q dtype: both sides "
          f"widen q exactly to fp32); arenas torch.equal; dead slots 0; "
          f"second launches bit for bit")
    # the serving shape: 4 slots, 96-row rings (6 blocks), bf16 arenas,
    # fp32 q, no window, no softcap
    args = granite_case(pa, 1, torch.float32, torch.bfloat16, seed=50)
    t = kernel_timing(torch, pa, args, dict(scale=0.125), flush, 1,
                      "granite serving shape: B=4 S=1 h=24 n_kv=8 hd=64 "
                      "bs=16 nb=6, bf16 arenas, fp32 q")
    for name, e in t.items():
        e["max_abs_err"] = max_err[name]
        entries[name]["granite"] = e
    entries["paged_attention_fused"]["granite"].update(
        launches=g_launches, moe_routes=routes,
        decode_step_profile=dict(busy_ms=busy, idle_share=idle))
    entries["paged_attention"]["granite"]["launches"] = k7_path(
        torch, pa, torch.float32, "granite-moe-3b-a800m",
        lambda layer: dict(scale=0.125))
    print(f"phase M(b): {time.perf_counter() - t0:.1f} s")

    # (c) mamba2-130m at full width, fp32: four engines, equal tokens,
    # no K8 launch (no attention: the paged pool holds no arena)
    t0 = time.perf_counter()
    m_argv = ["--arch", "mamba2-130m", "--full", "--precision", "fp32",
              "--requests", "8", "--max-batch", "4", "--prompt-len", "64",
              "--new-tokens", "32", "--seed", "0", "--device", "cuda"]
    serve_mod.main(with_flag(with_flag(m_argv, "--requests", "2"),
                             "--new-tokens", "4"))
    print("serve: mamba2 warm-up stream done (2 requests, 4 new tokens)")
    mamba = {}
    for label, argv in (
            ("static", m_argv + ["--engine", "static", "--cache", "dense"]),
            ("dense", m_argv + ["--cache", "dense"]),
            ("chunked", m_argv + ["--chunk-budget", "128"]),
            ("paged", m_argv + ["--attn-kernel", "paged"])):
        stats, mamba[label], n, _ = serve_counted(
            torch, pa, serve_mod, argv, f"mamba2 {label}")
        check(n == 0, f"mamba2 {label}: K8 launched {n} times")
        if label == "chunked":
            check(stats["chunk_steps"] > 0, "mamba2: no chunk ran")
    check(all(t == mamba["static"] for t in mamba.values()),
          "mamba2: greedy tokens differ between static, dense, chunked "
          "and paged")
    print(f"phase M(c): mamba2-130m static == dense == chunked (budget "
          f"128, granularity 64) == paged tokens, K8 never launched; "
          f"{time.perf_counter() - t0:.1f} s")

    # (d) reduced jamba (reduced: full jamba does not fit one H100)
    t0 = time.perf_counter()
    j_argv = ["--arch", "jamba-1.5-large-398b", "--precision", "fp32",
              "--attn-kernel", "paged", "--requests", "8", "--max-batch",
              "4", "--prompt-len", "64", "--new-tokens", "32", "--seed",
              "0", "--device", "cuda"]
    jamba, j_tokens, j_launches, _ = serve_counted(
        torch, pa, serve_mod, j_argv, "reduced jamba paged")
    _, jx_tokens, jx_launches, _ = serve_counted(
        torch, pa, serve_mod, with_flag(j_argv, "--attn-kernel", "xla"),
        "reduced jamba xla")
    check(j_tokens == jx_tokens and jx_launches == 0,
          "reduced jamba: kernel and gather tokens differ")
    check(j_launches == jamba["decode_steps"] * 1,
          f"reduced jamba: K8 launched {j_launches} times for "
          f"{jamba['decode_steps']} decode steps x 1 attention layer")
    print(f"phase M(d): reduced jamba-1.5-large-398b (1 period: 1 attention "
          f"+ 7 Mamba layers, 4 experts top-2; reduced: full jamba does "
          f"not fit one H100) kernel == gather tokens, K8 {j_launches} = "
          f"{jamba['decode_steps']} decode steps x 1; "
          f"{time.perf_counter() - t0:.1f} s")

    # (e) gemma2-2b at full width, fp16, with K8
    t0 = time.perf_counter()
    fp16, f_tokens, f_launches, _ = serve_counted(
        torch, pa, serve_mod, with_flag(SERVE_ARGV, "--precision", "fp16")
        + ["--device", "cuda"], "gemma2-2b fp16 paged")
    check(f_launches == fp16["decode_steps"] * N_LAYERS,
          f"fp16: K8 launched {f_launches} times for "
          f"{fp16['decode_steps']} decode steps x {N_LAYERS}")
    same = sum(a == b for rid in fp32_tokens
               for a, b in zip(fp32_tokens[rid], f_tokens[rid]))
    total = sum(len(t) for t in fp32_tokens.values())
    print(f"phase M(e): gemma2-2b fp16: finite logits, K8 {f_launches} = "
          f"{fp16['decode_steps']} decode steps x {N_LAYERS}; {same} of "
          f"{total} greedy tokens ({same / total:.4f}) equal the fp32 run "
          f"(not gated)")
    args = pa.decode_case(B=4, S=1, nb=6, dtype=torch.bfloat16,
                          q_dtype=torch.float16, device="cuda", seed=99,
                          **GEMMA_HEADS)
    kw = gemma_layer_kw(0)
    errs = paged_parity_at(torch, pa, args, kw, "(fp16 q, serving shape)")
    t = kernel_timing(torch, pa, args, kw, flush, 1,
                      "gemma2-2b serving shape, fp16 q: B=4 S=1 h=8 n_kv=4 "
                      "hd=256 bs=16 nb=6, bf16 arenas")
    for name, e in t.items():
        e["max_abs_err"] = errs[name]
        entries[name]["fp16"] = e
    entries["paged_attention_fused"]["fp16"]["launches"] = f_launches
    entries["paged_attention"]["fp16"]["launches"] = k7_path(
        torch, pa, torch.float16, "gemma2-2b", gemma_layer_kw)
    entries["paged_attention_fused"]["fp16"]["equal_token_share"] = \
        same / total
    print(f"phase M(e): {time.perf_counter() - t0:.1f} s")
    print(f"phase M: {time.perf_counter() - t_all:.1f} s")
    # the one-card tokens phase D(g) holds its 1 x 2 runs to
    entries["tokens"] = {"granite": g_tokens, "mamba2": mamba["static"]}
    return entries


def close(torch, err, name, got, want, tol, where=""):
    """assert_close(got, want) and keep the largest finite |got - want|
    in err[name]."""
    torch.testing.assert_close(got.float(), want.float(), **tol,
                               equal_nan=True,
                               msg=lambda m: f"{name} {where}: {m}")
    d = (got.float() - want.float()).abs()
    d = d[torch.isfinite(d)]
    if d.numel():
        err[name] = max(err[name], d.max().item())


def lans_parity(torch, kl, kops):
    """Phase 5a: K1-K4 against their plain versions, phase by phase, on
    the same inputs. K1 and K2 write fp32 whatever g and x are (and
    compute in fp32 on inputs that convert to fp32 exactly), so they are
    held to the fp32 tolerance in every case; the bf16 one is for K3's
    bf16 x. Returns {kernel name: max |kernel - plain|}."""
    err = {k.__name__: 0.0 for k in kl.KERNELS}
    n_cases = 0
    f32 = LANS_TOL["fp32"]

    def near(name, got, want, tol):
        close(torch, err, name, got, want, tol)

    kinds = (("normal", 0.01, True), ("normal", 0.0, False),
             ("zero_grad", 0.01, True), ("nan_grad", 0.01, True))
    kw = dict(beta1=0.9, eps=1e-6)
    for n, (dname, dtype), step, (kind, lam, trust) in itertools.product(
            (1, 127, 32773, 1048579),
            (("fp32", torch.float32), ("bf16", torch.bfloat16)), (1, 4),
            kinds):
        tol = LANS_TOL[dname]
        g, m, v, x = kl.lans_case(n, dtype, kind=kind, seed=n_cases,
                                  device="cuda")
        g_sq = kl.sq_norm(g).clone()
        near("sq_norm", g_sq, kl.sq_norm_plain(g), f32)
        check(torch.equal(kl.sq_norm(g), g_sq) or kind == "nan_grad",
              f"sq_norm is not bitwise repeatable (n={n}, {dname})")
        scal = kops.lans_scalars(0.02, step, beta1=0.9, beta2=0.999,
                                 lam=lam, apply_trust=trust, device="cuda")
        scal[5] = kl.sq_norm_plain(g)
        got = kl.lans_phase1(scal, g, m, v, x, beta2=0.999, **kw)
        want = kl.lans_phase1_plain(scal, g, m, v, x, beta2=0.999, **kw)
        for a, b in zip(got, want):
            near("lans_phase1", a, b, f32)
        m1, v1, norms = want
        x3 = kl.lans_phase2(scal, norms, g, m1, v1, x, **kw)
        near("lans_phase2", x3,
              kl.lans_phase2_plain(scal, norms, g, m1, v1, x, **kw), tol)
        if dtype == torch.float32:
            for lp in (torch.bfloat16, torch.float16):
                xm, xlp = kl.lans_phase2_cast(scal, norms, g, m1, v1, x,
                                              lp_dtype=lp, **kw)
                wm, _ = kl.lans_phase2_cast_plain(scal, norms, g, m1, v1, x,
                                                  lp_dtype=lp, **kw)
                near("lans_phase2_cast", xm, wm, f32)
                check(torch.equal(xm, x3), "K4 master differs from K3")
                check(torch.equal(xlp, xm.to(lp)),
                      f"K4 copy is not the {lp} cast of its master")
        torch.cuda.synchronize()
        n_cases += 1
    print(f"kernel parity: K1-K4, {n_cases} cases, max |kernel - plain| "
          + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
          + " (tolerance 2e-5 relative and absolute; 2e-2 for K3 on bf16 "
          "x); K4 master == K3, copy == cast; K1 bitwise repeatable")
    return err


def time_calls(torch, n, calls):
    """Time each {name: (kernel, plain, library call or None, (flops,
    bytes moved))} at n fp32 elements, L2 evicted, beside its bound (the
    larger of bytes at 3.35 TB/s and flops at 67 TFLOP/s: card_bound),
    the cost being the kernel's own (kernels/lans.py, lamb.py). Returns
    {name: timing entry}."""
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    out = {}
    for name, (kern, plain, lib, (flops, nbytes)) in calls.items():
        ms = time_ms(kern, flush, n=10)
        plain_ms = time_ms(plain, flush, n=5, warmup=1)
        lib_ms = None if lib is None else time_ms(lib, flush, n=10)
        bound_ms, bound_by = card_bound(flops, nbytes)
        out[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        print(f"kernel timing {name} (n={n} fp32, L2 evicted): kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library "
              f"{'none' if lib_ms is None else f'{lib_ms:.4f} ms'}, bound "
              f"{out[name]['bound_ms']:.4f} ms by {out[name]['bound_by']} "
              f"({nbytes} bytes at 3.35 TB/s, {flops} flops at 67 TFLOP/s)")
    return out


def lans_timing(torch, kl, kops, err, n=LARGEST_LEAF):
    """Phase 5b (and T(e) at gemma2-2b's embedding): at the largest leaf
    (fp32), the main path's size, where the reductions run with their cap
    of per-CTA partials, each kernel first against its plain version
    (updating `err`), then timed beside its plain version, its byte bound
    and, for K1, a library call."""
    f32 = LANS_TOL["fp32"]
    g, m, v, x = kl.lans_case(n, torch.float32, seed=3, device="cuda")
    kw = dict(beta1=0.9, eps=1e-6)
    scal = kops.lans_scalars(0.02, 4, beta1=0.9, beta2=0.999, lam=0.01,
                             apply_trust=True, device="cuda")
    big = {name: 0.0 for name in err}
    g_sq = kl.sq_norm(g, out=scal[5:6]).clone()
    close(torch, big, "sq_norm", g_sq, kl.sq_norm_plain(g), f32)
    check(torch.equal(kl.sq_norm(g), g_sq),
          f"sq_norm is not bitwise repeatable at {n} elements")
    m1, v1, norms = kl.lans_phase1(scal, g, m, v, x, beta2=0.999, **kw)
    for got, want in zip((m1, v1, norms), kl.lans_phase1_plain(
            scal, g, m, v, x, beta2=0.999, **kw)):
        close(torch, big, "lans_phase1", got, want, f32)
    x3 = kl.lans_phase2(scal, norms, g, m1, v1, x, **kw)
    close(torch, big, "lans_phase2", x3,
          kl.lans_phase2_plain(scal, norms, g, m1, v1, x, **kw), f32)
    cast = dict(lp_dtype=torch.bfloat16, **kw)
    xm, xlp = kl.lans_phase2_cast(scal, norms, g, m1, v1, x, **cast)
    wm, wlp = kl.lans_phase2_cast_plain(scal, norms, g, m1, v1, x, **cast)
    close(torch, big, "lans_phase2_cast", xm, wm, f32)
    # the copies are bf16: equal to the cast of their masters, and to
    # each other within a bf16 ulp where the masters straddle a rounding
    # edge
    close(torch, big, "lans_phase2_cast", xlp, wlp, LANS_TOL["bf16"])
    check(torch.equal(xm, x3), f"K4 master differs from K3 at {n}")
    check(torch.equal(xlp, xm.to(torch.bfloat16)),
          f"K4 copy is not the cast of its master at {n}")
    del x3, xm, xlp, wm, wlp
    torch.cuda.synchronize()
    print(f"kernel parity at the largest leaf ({n} fp32 elements): max "
          f"|kernel - plain| " + ", ".join(f"{k} {v:.3e}"
                                           for k, v in big.items())
          + f" (tolerance 2e-5; K4's bf16 copy 2e-2; g_sq {g_sq.item():.6e}"
          f", K2's norms {[f'{v:.6e}' for v in norms[:3].tolist()]}), K4 "
          f"master == K3, copy == cast, K1 bitwise repeatable")
    for name, e in big.items():
        err[name] = max(err[name], e)
    # name: (kernel, plain, library call, (flops, bytes moved))
    calls = {
        "sq_norm": (lambda: kl.sq_norm(g), lambda: kl.sq_norm_plain(g),
                    lambda: torch.linalg.vector_norm(g, dtype=torch.float32),
                    kl.sq_norm_cost(g)),
        "lans_phase1": (
            lambda: kl.lans_phase1(scal, g, m, v, x, beta2=0.999, **kw),
            lambda: kl.lans_phase1_plain(scal, g, m, v, x, beta2=0.999,
                                         **kw), None,
            kl.lans_phase1_cost(g, x)),
        "lans_phase2": (
            lambda: kl.lans_phase2(scal, norms, g, m1, v1, x, **kw),
            lambda: kl.lans_phase2_plain(scal, norms, g, m1, v1, x, **kw),
            None, kl.lans_phase2_cost(g, x)),
        "lans_phase2_cast": (
            lambda: kl.lans_phase2_cast(scal, norms, g, m1, v1, x, **cast),
            lambda: kl.lans_phase2_cast_plain(scal, norms, g, m1, v1, x,
                                              **cast), None,
            kl.lans_phase2_cost(g, x, torch.bfloat16)),
    }
    return time_calls(torch, n, calls)


def fused_step_timing(torch, arch, kops):
    """Phase 5c: one fused LANS update (K1, K2, K3 per leaf) over
    BERT-large's 29 fp32 leaves against 48 bytes per parameter at
    3.35 TB/s: fused_lans's update, which builds the kernels' scalars
    once per step, and the same kernels driven leaf by leaf through
    ops.fused_lans_step, which builds them once per leaf; and the unfused
    lans update on the same tensors."""
    from repro_torch.core.optim import fused_lans, lans
    from repro_torch.core.optim.base import (WeightDecayMask, tree_items,
                                             tree_map)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = arch.init(gen)
    g = tree_map(lambda t: torch.randn(t.shape, generator=gen,
                                       device="cuda"), x)
    zeros = tree_map(torch.zeros_like, x)
    leaves = list(zip(tree_items(x), tree_items(g), tree_items(zeros)))
    mask = WeightDecayMask()
    n_params = sum(t.numel() for (_, t), _, _ in leaves)
    eta = torch.full((), 1e-3, device="cuda")
    step = torch.ones((), dtype=torch.int32, device="cuda")

    def fused():    # as fused_lans's update, with scalars per leaf
        for (path, xt), (_, gt), (_, z) in leaves:
            dm = mask(path)
            o = kops.fused_lans_step(gt, z, z, xt, eta=eta, step=step,
                                     lam=0.01 if dm else 0.0,
                                     apply_trust=dm)
            o.x.sub(xt)     # the additive update fused_lans returns

    tx, ftx = lans(1e-3), fused_lans(1e-3)
    state, fstate = tx.init(x), ftx.init(x)

    # per leaf, per step, per step, per leaf: neither goes first only
    update = lambda: ftx.update(g, fstate, x)
    per_leaf_ms = time_reps(torch, fused, 5)
    fused_ms = time_reps(torch, update, 5)
    fused_ms = (fused_ms + time_reps(torch, update, 5)) / 2
    per_leaf_ms = (per_leaf_ms + time_reps(torch, fused, 5)) / 2
    unfused_ms = time_reps(torch, lambda: tx.update(g, state, x), 3)
    nbytes = update_bytes([t for (_, t), _, _ in leaves], LANS_K123)
    bound_ms = bytes_ms(nbytes)
    print(f"fused LANS step, bert-large fp32 ({len(leaves)} leaves, "
          f"{n_params} params): fused_lans update {fused_ms:.3f} ms "
          f"(K1+K2+K3 per leaf, scalars once per step), the kernels leaf "
          f"by leaf with scalars per leaf {per_leaf_ms:.3f} ms, unfused "
          f"lans update {unfused_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({nbytes / n_params:g} B/param at 3.35 TB/s)")
    check(len(leaves) == BERT_LEAVES, f"bert-large has {len(leaves)} leaves")
    return dict(fused_step_ms=fused_ms, per_leaf_ms=per_leaf_ms,
                unfused_step_ms=unfused_ms, bound_ms=bound_ms)


def lamb_check(torch, kb, kops, err, g, m, v, x, *, step, lam, trust, clip,
               x_tol, where):
    """K5 and K6 against their plain versions on one case: K5's m, v and
    norms within 2e-5 (fp32 outputs), its norms bitwise repeatable
    (compared as bits, so that a NaN repeats too), K6's x within x_tol.
    Returns K5's (m, v, norms) and the scalars."""
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-6)
    scal = kops.lamb_scalars(0.02, step, clip, beta1=0.9, beta2=0.999,
                             lam=lam, apply_trust=trust, device="cuda")
    got = kb.lamb_phase1(scal, g, m, v, x, **kw)
    again = kb.lamb_phase1(scal, g, m, v, x, **kw)[2]
    check(torch.equal(got[2].view(torch.int32), again.view(torch.int32)),
          f"K5's norms do not repeat bit for bit {where}")
    want = kb.lamb_phase1_plain(scal, g, m, v, x, **kw)
    for a, b in zip(got, want):
        close(torch, err, "lamb_phase1", a, b, LANS_TOL["fp32"], where)
    m1, v1, norms = want
    close(torch, err, "lamb_phase2",
          kb.lamb_phase2(scal, norms, m1, v1, x, eps=1e-6),
          kb.lamb_phase2_plain(scal, norms, m1, v1, x, eps=1e-6), x_tol,
          where)
    return got, scal


def lamb_parity(torch, kl, kb, kops):
    """Phase 6a: K5-K6 against their plain versions over phase 5's grid
    and clip 1 and 0.3. Returns {kernel name: max |kernel - plain|}."""
    err = {k.__name__: 0.0 for k in kb.KERNELS}
    kinds = (("normal", 0.01, True), ("normal", 0.0, False),
             ("zero_grad", 0.01, True), ("nan_grad", 0.01, True))
    n_cases = 0
    for n, (dname, dtype), step, (kind, lam, trust), clip in \
            itertools.product((1, 127, 32773, 1048579),
                              (("fp32", torch.float32),
                               ("bf16", torch.bfloat16)), (1, 4), kinds,
                              (1.0, 0.3)):
        g, m, v, x = kl.lans_case(n, dtype, kind=kind, seed=n_cases,
                                  device="cuda")
        lamb_check(torch, kb, kops, err, g, m, v, x, step=step, lam=lam,
                   trust=trust, clip=clip, x_tol=LANS_TOL[dname],
                   where=f"(n={n}, {dname}, step {step}, {kind}, lam {lam},"
                         f" clip {clip})")
        n_cases += 1
    torch.cuda.synchronize()
    print(f"kernel parity: K5-K6, {n_cases} cases, max |kernel - plain| "
          + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
          + " (tolerance 2e-5 relative and absolute; 2e-2 for K6 on bf16 "
          "x; NaN where the plain version has NaN); K5's norms bitwise "
          "repeatable")
    return err


def lamb_timing(torch, kl, kb, kops, err):
    """Phase 6b: at the largest leaf (fp32, step 4, clip 0.3), K5 and K6
    against their plain versions (updating `err`), then timed beside
    their plain versions and byte bounds. Neither has a library call."""
    n = LARGEST_LEAF
    g, m, v, x = kl.lans_case(n, torch.float32, seed=5, device="cuda")
    big = {k.__name__: 0.0 for k in kb.KERNELS}
    (m1, v1, norms), scal = lamb_check(
        torch, kb, kops, big, g, m, v, x, step=4, lam=0.01, trust=True,
        clip=0.3, x_tol=LANS_TOL["fp32"], where=f"at {n} elements")
    torch.cuda.synchronize()
    print(f"kernel parity at the largest leaf ({n} fp32 elements): max "
          f"|kernel - plain| " + ", ".join(f"{k} {v:.3e}"
                                           for k, v in big.items())
          + f" (tolerance 2e-5; K5's norms "
          f"{[f'{v:.6e}' for v in norms[:2].tolist()]}), K5's norms "
          f"bitwise repeatable")
    for name, e in big.items():
        err[name] = max(err[name], e)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-6)
    # name: (kernel, plain, library call, (flops, bytes moved))
    calls = {
        "lamb_phase1": (
            lambda: kb.lamb_phase1(scal, g, m, v, x, **kw),
            lambda: kb.lamb_phase1_plain(scal, g, m, v, x, **kw), None,
            kb.lamb_phase1_cost(g, x)),
        "lamb_phase2": (
            lambda: kb.lamb_phase2(scal, norms, m1, v1, x, eps=1e-6),
            lambda: kb.lamb_phase2_plain(scal, norms, m1, v1, x, eps=1e-6),
            None, kb.lamb_phase2_cost(x)),
    }
    return time_calls(torch, n, calls)


def fused_lamb_timing(torch, arch):
    """Phase 6c: one fused LAMB update (K1 on every gradient for the
    global clip, then K5 and K6 per leaf) over BERT-large's 29 fp32
    leaves, against 40 bytes per parameter at 3.35 TB/s (44 with the
    clip's norm pass), and the unfused lamb update on the same tensors,
    in the order fused, unfused, fused."""
    from repro_torch.core.optim import fused_lamb, lamb
    from repro_torch.core.optim.base import tree_leaves, tree_map
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = arch.init(gen)
    g = tree_map(lambda t: torch.randn(t.shape, generator=gen,
                                       device="cuda"), x)
    n_params = sum(t.numel() for t in tree_leaves(x))
    tx, ftx = lamb(1e-3), fused_lamb(1e-3)
    state, fstate = tx.init(x), ftx.init(x)

    update = lambda: ftx.update(g, fstate, x)
    first = time_reps(torch, update, 5)
    unfused_ms = time_reps(torch, lambda: tx.update(g, state, x), 3)
    fused_ms = (first + time_reps(torch, update, 5)) / 2
    nbytes = update_bytes(tree_leaves(x), ("lamb_phase1", "lamb_phase2"))
    clip_bytes = update_bytes(tree_leaves(x), ("sq_norm",))
    bound_ms = bytes_ms(nbytes)
    clip_bound_ms = bytes_ms(nbytes + clip_bytes)
    print(f"fused LAMB step, bert-large fp32 ({len(tree_leaves(x))} leaves,"
          f" {n_params} params): fused_lamb update {fused_ms:.3f} ms (K1 "
          f"per leaf for the clip, then K5+K6 per leaf), unfused lamb "
          f"update {unfused_ms:.3f} ms, bound {bound_ms:.3f} ms "
          f"({nbytes / n_params:g} B/param at 3.35 TB/s; "
          f"{clip_bound_ms:.3f} ms with the clip's "
          f"{clip_bytes / n_params:g} B/param norm pass)")
    del x, g, state, fstate
    torch.cuda.empty_cache()
    return dict(fused_step_ms=fused_ms, unfused_step_ms=unfused_ms,
                bound_ms=bound_ms, clip_bound_ms=clip_bound_ms)


def device_profile(torch, fn):
    """fn() under torch.profiler, ended by a synchronize: (wall ms,
    {kernel: device ms}, {kernel: launches}) from the device-side events
    only (CPU ops carry their kernels' device time too)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels, counts = {}, {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0.0)
        if e.device_type == DeviceType.CUDA and us > 0:
            kernels[e.key] = kernels.get(e.key, 0.0) + us / 1e3
            counts[e.key] = counts.get(e.key, 0) + e.count
    return wall_ms, kernels, counts


def profile_step(torch, step_fn, params, state, batch):
    """One training step under torch.profiler: wall time, device busy
    time (the sum of the kernels' own device times), the idle share, the
    device time by kernel family, and K1-K3's device time summed over
    the step's launches beside their bounds summed over the leaves (the
    kernels' own byte counts at 3.35 TB/s: 4, 24 and 20 bytes per fp32
    parameter). Returns (wall ms, device busy ms), busy None where the
    profiler saw no device activity."""
    from repro_torch.core.optim.base import tree_leaves
    wall_ms, kernels, counts = device_profile(
        torch, lambda: float(step_fn(params, state, batch)[2]["loss"]))
    busy = sum(kernels.values())
    families = {"lans K1-K4": ("sq_norm_kernel", "lans_phase",
                               "finish_sums_kernel"),
                "matmul": ("gemm", "gemv", "cutlass", "sm90_", "nvjet"),
                "copy/cast": ("copy", "Memcpy", "Memset"),
                "fill": ("FillFunctor",), "add": ("CUDAFunctor_add",)}
    by_family = {f: sum(ms for k, ms in kernels.items()
                        if any(w in k for w in words))
                 for f, words in families.items()}
    by_family["other"] = busy - sum(by_family.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    if busy == 0:
        print(f"profile[fused route step]: wall {wall_ms:.2f} ms; device "
              f"time not measured (the profiler saw no device activity)")
        return wall_ms, None
    print(f"profile[fused route step]: wall {wall_ms:.2f} ms (under the "
          f"profiler), device busy {busy:.2f} ms, idle share "
          f"{1 - busy / wall_ms:.3f}; by family "
          + ", ".join(f"{f} {ms:.2f} ms" for f, ms in by_family.items()))
    for name, ms in top:
        print(f"  {ms:8.3f} ms  {name[:110]}")
    # the finishing pass (finish_sums_kernel) of K1 and K2 is shared and
    # listed on its own
    leaves = tree_leaves(params)
    for label, word, kern in (("K1 sq_norm", "sq_norm_kernel", "sq_norm"),
                              ("K2 lans_phase1", "lans_phase1_kernel",
                               "lans_phase1"),
                              ("K3 lans_phase2", "lans_phase2_kernel",
                               "lans_phase2"),
                              ("K1/K2 finishing pass",
                               "finish_sums_kernel", None)):
        ms = sum(v for k, v in kernels.items() if word in k)
        n = sum(c for k, c in counts.items() if word in k)
        bound = bytes_ms(update_bytes(leaves, (kern,))) if kern else 0
        print(f"profile[fused route step]: {label}: {n} launches, device "
              f"time summed {ms:.4f} ms"
              + (f", bound summed over the leaves {bound:.4f} ms (bytes), "
                 f"bound / time {bound / ms:.3f}" if kern and ms
                 else ""))
    return wall_ms, busy


def mixed_step1(torch, arch, sched, batches, leaves=BERT_LEAVES):
    """One shared set of bf16-policy step-1 gradients applied by
    fused_mixed_lans (K1, K2, K4) and by mixed_precision(lans) (fp32
    moments, as the kernels keep) to copies of the same state: the fp32
    masters and moments agree leaf by leaf within 2e-5, the bf16 params
    within a bf16 ulp (2e-2)."""
    import dataclasses
    from repro_torch.core.optim import lans
    from repro_torch.core.optim.base import apply_updates, tree_items
    from repro_torch.core.optim.lans import LansState
    from repro_torch.distributed.steps import loss_and_grads
    from repro_torch.precision import (fused_mixed_lans, get_policy,
                                       loss_scale_value, mixed_precision)
    policy = get_policy("bf16")
    arch16 = dataclasses.replace(arch, cfg=policy.apply_to_cfg(arch.cfg))
    params = policy.cast_params(
        arch16.init(torch.Generator(device="cuda").manual_seed(1)))
    fused_tx = fused_mixed_lans(sched, policy)
    plain_tx = mixed_precision(lans(sched), policy)
    fused_st, plain_st = fused_tx.init(params), plain_tx.init(params)
    _, _, grads = loss_and_grads(arch16.loss_fn, params, next(batches()),
                                 loss_scale_value(fused_st))
    with torch.no_grad():
        fu, fused_st = fused_tx.update(grads, fused_st, params)
        pu, plain_st = plain_tx.update(grads, plain_st, params)
        fused_p, plain_p = (apply_updates(params, fu),
                            apply_updates(params, pu))
    inner = next(s for s in plain_st.inner if isinstance(s, LansState))
    trees = {"master": (fused_st.master, plain_st.master),
             "mu": (fused_st.mu, inner.mu), "nu": (fused_st.nu, inner.nu),
             "params": (fused_p, plain_p)}
    err = {name: 0.0 for name in trees}
    n_leaves = len(tree_items(params))
    for name, (a, b) in trees.items():
        for (path, got), (_, want) in zip(tree_items(a), tree_items(b)):
            tol = LANS_TOL["bf16" if got.dtype == torch.bfloat16
                           else "fp32"]
            close(torch, err, name, got, want, tol, path)
    print(f"train: step-1 update, bf16 policy, fused_mixed_lans vs "
          f"mixed_precision(lans) on shared gradients, {n_leaves} leaves, "
          f"max |diff| " + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
          + " (tolerance 2e-5; bf16 params 2e-2)")
    check(n_leaves == leaves, f"{arch.name} has {n_leaves} leaves")
    del params, grads, fused_st, plain_st, fused_p, plain_p, trees, inner
    torch.cuda.empty_cache()


def cli_batches(torch, train_mod, arch, batch_size, seq, seed):
    """A function that starts the CLI's data stream anew (the same
    batches each time), as CUDA tensors."""
    def batches():
        data = train_mod.make_data(arch, batch=batch_size, seq=seq,
                                   seed=seed)
        for b in data:
            yield {k: torch.from_numpy(a).to("cuda") for k, a in b.items()}
    return batches


def shared_step1(torch, arch, batches, unfused, fused, label,
                 leaves=BERT_LEAVES):
    """One shared set of step-1 gradients (seed 0, the first batch)
    applied by an unfused transform and its fused counterpart to the same
    params: params and moments agree leaf by leaf within 2e-5."""
    from repro_torch.core.optim.base import apply_updates, tree_items
    from repro_torch.distributed.steps import loss_and_grads
    params = arch.init(torch.Generator(device="cuda").manual_seed(0))
    _, _, grads = loss_and_grads(arch.loss_fn, params, next(batches()),
                                 None)
    outs = []
    for tx in (unfused, fused):
        with torch.no_grad():
            upd, st = tx.update(grads, tx.init(params), params)
        if not hasattr(st, "mu"):          # chain: the optimizer's state
            st = next(s for s in st if hasattr(s, "mu"))
        outs.append({"params": apply_updates(params, upd), "mu": st.mu,
                     "nu": st.nu})
        del upd, st
    err = {name: 0.0 for name in outs[0]}
    for name in err:
        for (path, a), (_, b) in zip(tree_items(outs[0][name]),
                                     tree_items(outs[1][name])):
            close(torch, err, name, b, a, LANS_TOL["fp32"], path)
    n_leaves = len(tree_items(params))
    print(f"train: step-1 update, {label} on shared gradients, "
          f"{n_leaves} leaves, max |diff| "
          + ", ".join(f"{k} {v:.3e}" for k, v in err.items())
          + " (tolerance 2e-5)")
    check(n_leaves == leaves, f"{arch.name} has {n_leaves} leaves")
    del params, grads, outs
    torch.cuda.empty_cache()


def train_routes(torch, kl):
    """Phase 7: full-width BERT-large training through the CLI (unfused
    lans) and through build_train_step + fused_lans (K1-K3), then bf16
    through fused_mixed_lans (K1, K2, K4) and the CLI in fp16. Returns
    the launch counts of each kernel's main-path run and the step
    times."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.core.optim import fused_lans, lans
    from repro_torch.core.optim.base import tree_leaves
    from repro_torch.distributed.steps import build_train_step
    from repro_torch.launch import train as train_mod
    from repro_torch.precision import fused_mixed_lans, get_policy

    arch = get_arch("bert-large")
    steps, batch_size, seq, seed = 4, 16, 128, 0
    sched = train_mod.make_schedule("hold", 2e-3, steps, 0.2, 0.3)

    batches = cli_batches(torch, train_mod, arch, batch_size, seq, seed)

    shared_step1(torch, arch, batches, lans(sched), fused_lans(sched),
                 "lans vs fused_lans")
    mixed_step1(torch, arch, sched, batches)

    # the plain route: the port's CLI
    cli = train_mod.main(TRAIN_ARGV)
    print(f"train[cli, unfused lans, fp32 policy]: losses "
          f"{[round(v, 6) for v in cli['losses']]} step_ms "
          f"{[round(t * 1e3, 2) for t in cli['step_s']]}")
    torch.cuda.empty_cache()

    # the kernel route: build_train_step + fused_lans, same seed, batches
    step_fn, init_fn = build_train_step(arch.loss_fn, fused_lans(sched),
                                        param_init_fn=arch.init,
                                        policy="fp32")
    params, state = init_fn(torch.Generator(device="cuda").manual_seed(seed))
    for k in kl.KERNELS:
        k.launches = 0
    losses, step_ms = [], []
    for _, b in zip(range(steps), batches()):
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, b)
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k.__name__: k.launches for k in kl.KERNELS}
    print(f"train[build_train_step + fused_lans, fp32 policy]: losses "
          f"{[round(v, 6) for v in losses]} step_ms "
          f"{[round(t, 2) for t in step_ms]}; launches {launches}")
    check(all(math.isfinite(v) for v in losses + cli["losses"]),
          "a training loss is not finite")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cli["losses"]))
    check(rel <= 1e-2, f"fused and CLI loss trajectories differ by {rel:.3e} "
          f"relative (> 1e-2)")
    print(f"train: fused vs CLI loss trajectory, max relative diff "
          f"{rel:.3e} (tolerance 1e-2)")
    for name in ("sq_norm", "lans_phase1", "lans_phase2"):
        check(launches[name] == steps * BERT_LEAVES,
              f"{name} launched {launches[name]} times, expected "
              f"{steps} x {BERT_LEAVES}")
    check(launches["lans_phase2_cast"] == 0, "the fp32 route launched K4")
    _, busy = profile_step(torch, step_fn, params, state, next(batches()))
    box = [params, state]
    del params, state
    analysis = phase_analysis(torch, "bert-large", arch,
                              lambda: fused_lans(sched), step_fn, box,
                              batches, busy)
    torch.cuda.empty_cache()

    # bf16 through fused_mixed_lans: K1, K2 and K4
    policy = get_policy("bf16")
    arch16 = dataclasses.replace(arch, cfg=policy.apply_to_cfg(arch.cfg))
    step_fn, init_fn = build_train_step(
        arch16.loss_fn, fused_mixed_lans(sched, policy),
        param_init_fn=arch16.init, policy=policy)
    params, state = init_fn(torch.Generator(device="cuda").manual_seed(seed))
    for k in kl.KERNELS:
        k.launches = 0
    bf16_losses, bf16_ms, bf16_steps = [], [], 2
    for _, b in zip(range(bf16_steps), batches()):
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, b)
        bf16_losses.append(float(metrics["loss"]))
        bf16_ms.append((time.perf_counter() - t0) * 1e3)
    applied = bf16_steps - int(metrics["overflow_count"])
    bf16_launches = {k.__name__: k.launches for k in kl.KERNELS}
    print(f"train[build_train_step + fused_mixed_lans, bf16 policy]: losses "
          f"{[round(v, 6) for v in bf16_losses]} step_ms "
          f"{[round(t, 2) for t in bf16_ms]}; applied steps {applied}; "
          f"launches {bf16_launches}")
    check(all(math.isfinite(v) for v in bf16_losses),
          "a bf16 training loss is not finite")
    check(bf16_launches["lans_phase2_cast"] == applied * BERT_LEAVES,
          f"K4 launched {bf16_launches['lans_phase2_cast']} times for "
          f"{applied} applied steps")
    check(bf16_launches["lans_phase2"] == 0, "the mixed route launched K3")
    del params, state
    torch.cuda.empty_cache()

    # the CLI in fp16: dynamic loss scaling
    fp16 = train_mod.main(train_argv("lans", "fp16", steps))
    check(math.isfinite(fp16["final_loss"]), "fp16 final loss not finite")
    print(f"train[cli, fp16]: losses {[round(v, 6) for v in fp16['losses']]}"
          f" loss_scale {fp16['loss_scale']} overflow_count "
          f"{fp16['overflow_count']} step_ms "
          f"{[round(t * 1e3, 2) for t in fp16['step_s']]}")
    torch.cuda.empty_cache()
    return launches, bf16_launches, analysis


def train_argv(optimizer, precision, steps):
    """The CLI's arguments of phase 7 with another optimizer, precision
    or step count."""
    argv = list(TRAIN_ARGV)
    for flag, value in (("--optimizer", optimizer),
                        ("--precision", precision), ("--steps", steps)):
        argv[argv.index(flag) + 1] = str(value)
    return argv


def lamb_routes(torch, kl, kb):
    """Phase 8: full-width BERT-large training with LAMB, as phase 7 with
    LANS: one shared set of step-1 gradients applied by lamb and by
    fused_lamb; the CLI with --optimizer lamb (unfused) and
    build_train_step + fused_lamb (K1 for the clip, K5, K6) from the
    same seed and batches; then 2 steps each of the CLI with --optimizer
    adamw and with --optimizer lamb --precision bf16. Returns the launch
    counts of the fused route."""
    from repro_torch.configs import get_arch
    from repro_torch.core.optim import fused_lamb, lamb
    from repro_torch.distributed.steps import build_train_step
    from repro_torch.launch import train as train_mod

    arch = get_arch("bert-large")
    steps, batch_size, seq, seed = 4, 16, 128, 0
    sched = train_mod.make_schedule("hold", 2e-3, steps, 0.2, 0.3)
    batches = cli_batches(torch, train_mod, arch, batch_size, seq, seed)
    shared_step1(torch, arch, batches, lamb(sched), fused_lamb(sched),
                 "lamb vs fused_lamb")

    cli = train_mod.main(train_argv("lamb", "fp32", steps))
    print(f"train[cli, unfused lamb, fp32 policy]: losses "
          f"{[round(v, 6) for v in cli['losses']]} step_ms "
          f"{[round(t * 1e3, 2) for t in cli['step_s']]}")
    torch.cuda.empty_cache()

    step_fn, init_fn = build_train_step(arch.loss_fn, fused_lamb(sched),
                                        param_init_fn=arch.init,
                                        policy="fp32")
    params, state = init_fn(torch.Generator(device="cuda").manual_seed(seed))
    kernels = kl.KERNELS + kb.KERNELS
    for k in kernels:
        k.launches = 0
    losses, step_ms = [], []
    for _, b in zip(range(steps), batches()):
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, b)
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k.__name__: k.launches for k in kernels}
    print(f"train[build_train_step + fused_lamb, fp32 policy]: losses "
          f"{[round(v, 6) for v in losses]} step_ms "
          f"{[round(t, 2) for t in step_ms]}; launches {launches}")
    check(all(math.isfinite(v) for v in losses + cli["losses"]),
          "a LAMB training loss is not finite")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cli["losses"]))
    check(rel <= 1e-2, f"fused_lamb and CLI loss trajectories differ by "
          f"{rel:.3e} relative (> 1e-2)")
    print(f"train: fused_lamb vs CLI lamb loss trajectory, max relative "
          f"diff {rel:.3e} (tolerance 1e-2)")
    # K1 once per leaf per step for the clip's sums of squares
    for name in ("sq_norm", "lamb_phase1", "lamb_phase2"):
        check(launches[name] == steps * BERT_LEAVES,
              f"{name} launched {launches[name]} times, expected "
              f"{steps} x {BERT_LEAVES}")
    check(not any(launches[k.__name__] for k in kl.KERNELS[1:]),
          "the LAMB route launched a LANS kernel")
    del params, state
    torch.cuda.empty_cache()

    for optimizer, precision in (("adamw", "fp32"), ("lamb", "bf16")):
        out = train_mod.main(train_argv(optimizer, precision, 2))
        check(all(math.isfinite(v) for v in out["losses"]),
              f"{optimizer} {precision} loss not finite")
        print(f"train[cli, {optimizer}, {precision}]: losses "
              f"{[round(v, 6) for v in out['losses']]} step_ms "
              f"{[round(t * 1e3, 2) for t in out['step_s']]}")
        torch.cuda.empty_cache()
    return launches


def peak_gb(torch):
    """torch.cuda.max_memory_allocated() in GB (1e9 bytes)."""
    return torch.cuda.max_memory_allocated() / 1e9


def leaf_bytes(torch, tree):
    """Bytes of a tree's tensors (numel x element size, each leaf once)."""
    from torch.utils._pytree import tree_flatten
    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
               if isinstance(t, torch.Tensor))


def phase_analysis(torch, label, arch, make_tx, step_fn, box, batches,
                   busy_ms, steps=3):
    """Phase A on one training step (phase 7's or phase T's): the dry run
    of the same configuration on one device (launch/dryrun.py:
    trace_train, meta tensors on the host: FLOPs by dtype, bytes,
    argument and temp bytes), then `steps` steps after a warm-up, each
    ended by torch.cuda.synchronize(), from the params and state in `box`
    ([params, state]: the caller's only references, taken here). Prints
    the achieved FLOP/s over the wall time and over `busy_ms` (the device
    busy time the phase's profile measured), the MFU (the counted matmul
    FLOPs over the wall time at the peak of the dtype each ran in), the
    whole step's roofline share (bound / wall) and the predicted peak
    memory (argument + temp) beside torch.cuda.max_memory_allocated().
    Gate: the dry run's argument bytes of params and optimizer state
    equal the bytes of the live ones on the card. Returns the numbers."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import PEAK_FLOPS
    t0 = time.perf_counter()
    it = batches()
    batch = next(it)
    dry, _ = dryrun.trace_train(arch, batch, tx=make_tx(), policy="fp32")
    trace_s = time.perf_counter() - t0
    mem = dry["memory_analysis"]
    params, state = box.pop(0), box.pop(0)
    live = leaf_bytes(torch, (params, state))
    dry_state = mem["argument_size_in_bytes"] - leaf_bytes(torch, batch)
    check(dry_state == live, f"phase A[{label}]: the dry run's params and "
          f"state take {dry_state} bytes, the card's {live}")
    params, state, _ = step_fn(params, state, batch)         # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wall = []
    for _, b in zip(range(steps), it):
        t1 = time.perf_counter()
        params, state, metrics = step_fn(params, state, b)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t1) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    check(math.isfinite(float(metrics["loss"])),
          f"phase A[{label}]: a loss is not finite")
    del params, state, metrics
    wall_ms = statistics.median(wall)
    by_dtype = dry["flops_by_dtype"]
    matmul = {k: v for k, v in by_dtype.items() if k != "elementwise"}
    at_peak_s = sum(v / PEAK_FLOPS[k] for k, v in matmul.items())
    mfu = at_peak_s / (wall_ms / 1e3)
    flops = dry["flops"]
    roof = dry["roofline"]
    predicted = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    out = dict(flops_by_dtype=by_dtype, flops=flops,
               bytes=dry["bytes_accessed"],
               argument_bytes=mem["argument_size_in_bytes"],
               temp_bytes=mem["temp_size_in_bytes"], trace_s=trace_s,
               wall_ms=wall, busy_ms=busy_ms, mfu=mfu,
               tflops_wall=flops / (wall_ms / 1e3) / 1e12,
               tflops_busy=(flops / (busy_ms / 1e3) / 1e12 if busy_ms
                            else None),
               roofline=roof, roofline_share=roof["bound_s"] / (wall_ms / 1e3),
               predicted_peak=predicted, max_allocated=peak)
    peaks = ", ".join(f"{k} {v:.4e} FLOPs at {PEAK_FLOPS[k] / 1e12:g} "
                      f"TFLOP/s" for k, v in matmul.items())
    print(f"phase A[{label}]: dry run (one device, meta tensors, "
          f"{trace_s:.1f} s on the host): FLOPs by dtype "
          + ", ".join(f"{k} {v:.4e}" for k, v in by_dtype.items())
          + f", {dry['bytes_accessed']:.4e} bytes, argument "
          f"{mem['argument_size_in_bytes']} bytes (params and state "
          f"{dry_state} == {live} live on the card), temp "
          f"{mem['temp_size_in_bytes']} bytes")
    print(f"phase A[{label}]: step wall {[round(t, 3) for t in wall]} ms "
          f"(median {wall_ms:.3f}, {steps} steps after a warm-up, each "
          f"ended by a synchronize); achieved {out['tflops_wall']:.2f} "
          f"TFLOP/s over the wall time, "
          + (f"{out['tflops_busy']:.2f} TFLOP/s over the profiled device "
             f"busy time {busy_ms:.2f} ms" if busy_ms
             else "device busy time not measured"))
    print(f"phase A[{label}]: MFU {mfu:.4f} (matmul FLOPs {peaks}; "
          f"{at_peak_s * 1e3:.3f} ms at peak over the {wall_ms:.3f} ms "
          f"wall); roofline share {out['roofline_share']:.4f} (bound "
          f"{roof['bound_s'] * 1e3:.3f} ms by {roof['dominant']}: compute "
          f"{roof['compute_s'] * 1e3:.3f} ms, memory "
          f"{roof['memory_s'] * 1e3:.3f} ms, collective "
          f"{roof['collective_s'] * 1e3:.3f} ms); predicted peak memory "
          f"{predicted / 1e9:.3f} GB (argument + temp) vs "
          f"max_memory_allocated {peak / 1e9:.3f} GB, ratio "
          f"{predicted / peak:.4f}")
    print(f"phase A[{label}]: {time.perf_counter() - t0:.1f} s; "
          f"{card_line()}")
    return out


def run_steps(torch, step_fn, params, state, batches, steps):
    """`steps` training steps on the stream's batches: (params, state,
    losses, step ms, the last metrics). The caller hands over its only
    references to params and state (`run_steps(..., *init_fn(gen),
    ...)`): at full size two generations of them fit the card, three do
    not."""
    losses, step_ms, metrics = [], [], None
    for _, b in zip(range(steps), batches()):
        t0 = time.perf_counter()
        params, state, metrics = step_fn(params, state, b)
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return params, state, losses, step_ms, metrics


def decoder_update_timing(torch, arch, kops, n_leaves):
    """Phase T(e): the kernels of one fused LANS update (K1, K2, K3 per
    leaf, the scalars built once per step as fused_lans builds them, and
    the additive update x_new - x) over gemma2-2b's fp32 leaves, each
    leaf's outputs dropped before the next (fused_lans's whole update
    tree beside the params, gradients and moments would not fit the
    card), against 48 bytes per parameter at 3.35 TB/s."""
    from repro_torch.core.optim.base import (WeightDecayMask, tree_items,
                                             tree_map)
    from repro_torch.core.optim.fused import step_scalars
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = arch.init(gen)
    g = tree_map(lambda t: torch.randn(t.shape, generator=gen,
                                       device="cuda"), x)
    zeros = tree_map(torch.zeros_like, x)
    leaves = list(zip(tree_items(x), tree_items(g), tree_items(zeros)))
    n_params = sum(t.numel() for (_, t), _, _ in leaves)
    eta = torch.full((), 1e-3, device="cuda")
    step = torch.ones((), dtype=torch.int32, device="cuda")

    def update():
        rows = step_scalars(eta, step, x, WeightDecayMask(), beta1=0.9,
                            beta2=0.999, lam=0.01)
        for (path, xt), (_, gt), (_, z) in leaves:
            o = kops.fused_lans_step(gt, z, z, xt, scalars=rows[path])
            o.x.sub(xt)

    ms = (time_reps(torch, update, 3) + time_reps(torch, update, 3)) / 2
    nbytes = update_bytes([t for (_, t), _, _ in leaves], LANS_K123)
    bound_ms = bytes_ms(nbytes)
    print(f"fused LANS update, gemma2-2b fp32 ({len(leaves)} leaves, "
          f"{n_params} params): K1+K2+K3 over every leaf {ms:.3f} ms, "
          f"bound {bound_ms:.3f} ms ({nbytes / n_params:g} B/param at 3.35 "
          f"TB/s), bound / time {bound_ms / ms:.3f}")
    check(len(leaves) == n_leaves, f"gemma2-2b has {len(leaves)} leaves")
    del x, g, zeros, leaves
    torch.cuda.empty_cache()
    return dict(update_ms=ms, bound_ms=bound_ms, n_params=n_params)


def decoder_routes(torch, kl, kops):
    """Phase T: causal-LM pretraining of gemma2-2b at full width (see the
    module docstring). Returns (K1-K3 launches of the fused fp32 route,
    launches of the bf16 route, K1-K4 timings and errors at the
    embedding leaf, the whole update's timing)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.core.optim import fused_lans, lans
    from repro_torch.core.optim.base import tree_items, tree_leaves
    from repro_torch.distributed.steps import (build_train_step,
                                               loss_and_grads)
    from repro_torch.launch import train as train_mod
    from repro_torch.models import decoder as dec
    from repro_torch.precision import fused_mixed_lans, get_policy

    arch = get_arch("gemma2-2b")
    steps, batch_size, seq, seed = 3, 2, 1024, 0
    sched = train_mod.make_schedule("hold", 2e-3, steps, 0.2, 0.3)
    batches = cli_batches(torch, train_mod, arch, batch_size, seq, seed)
    with torch.device("meta"):
        shapes = tree_items(arch.init(None))
    n_leaves = len(shapes)
    n_params = sum(t.numel() for _, t in shapes)
    check(dict(shapes)["embed/embedding"].numel() == EMBED_LEAF,
          "gemma2-2b's embedding is not its 256000 x 2304 leaf")
    gen = lambda: torch.Generator(device="cuda").manual_seed(seed)
    print(f"phase T: gemma2-2b, {n_leaves} leaves, {n_params} params, "
          f"seq {seq}, batch {batch_size}")

    # (d) the chunked loss against lm_loss on the whole logits, and the
    # gradients with each period recomputed (remat) and kept
    t0 = time.perf_counter()
    params = arch.init(gen())
    b = next(batches())
    with torch.no_grad():
        hidden, _, _ = dec.decoder_apply(params, arch.cfg, b["tokens"],
                                         return_hidden=True)
        chunked = float(dec.chunked_lm_loss(params, arch.cfg, hidden,
                                            b["labels"]))
        logits = dec._head_logits(params, arch.cfg, hidden)   # 2.1 GB
        full = float(dec.lm_loss(logits, b["labels"]))
        via_arch = float(arch.loss_fn(params, b)[0])
        del hidden, logits
    rel = abs(chunked - full) / abs(full)
    check(math.isfinite(full) and rel <= 1e-5,
          f"chunked loss {chunked} vs lm_loss {full}: {rel:.3e} relative "
          f"(> 1e-5)")
    check(abs(via_arch - chunked) <= 1e-6 * abs(chunked),
          f"Arch.loss_fn's loss {via_arch} is not the chunked loss")
    grads, peaks = {}, {}
    for remat in (True, False):
        a = dataclasses.replace(arch, cfg=dataclasses.replace(
            arch.cfg, remat=remat))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _, _, grads[remat] = loss_and_grads(a.loss_fn, params, b, None)
        torch.cuda.synchronize()
        peaks[remat] = peak_gb(torch)
    err = {"grads": 0.0}
    for (path, x), (_, y) in zip(tree_items(grads[True]),
                                 tree_items(grads[False])):
        close(torch, err, "grads", x, y, dict(rtol=1e-5, atol=1e-5), path)
    print(f"train[gemma2-2b, loss checks]: chunked loss (2 chunks of 512) "
          f"{chunked:.6f} vs lm_loss on the (2, 1024, 256000) fp32 logits "
          f"{full:.6f}, {rel:.3e} relative (tolerance 1e-5); grads with "
          f"remat vs without, max |diff| {err['grads']:.3e} (tolerance "
          f"1e-5); peak memory of a forward and backward {peaks[True]:.2f} "
          f"GB with remat, {peaks[False]:.2f} GB without")
    del params, grads, b
    torch.cuda.empty_cache()
    print(f"phase T(d): {time.perf_counter() - t0:.1f} s")

    # (b) shared step-1 gradients at full width, 2 periods (4 layers):
    # the embedding leaf whole, and both routes fit the card
    t0 = time.perf_counter()
    arch4 = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, n_layers=4))
    shared_step1(torch, arch4, batches, lans(sched), fused_lans(sched),
                 "gemma2-2b (4 layers), lans vs fused_lans",
                 leaves=n_leaves)
    mixed_step1(torch, arch4, sched, batches, leaves=n_leaves)
    print(f"phase T(b): {time.perf_counter() - t0:.1f} s")

    # (a) 3 steps through the CLI (unfused lans) and through
    # build_train_step + fused_lans, from the same seed and batches
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cli = train_mod.main(DECODER_ARGV)
    cli_peak = peak_gb(torch)
    torch.cuda.empty_cache()
    print(f"train[gemma2-2b, cli, unfused lans, fp32 policy]: losses "
          f"{[round(v, 6) for v in cli['losses']]} step_ms "
          f"{[round(t * 1e3, 2) for t in cli['step_s']]} peak memory "
          f"{cli_peak:.2f} GB")
    step_fn, init_fn = build_train_step(arch.loss_fn, fused_lans(sched),
                                        param_init_fn=arch.init,
                                        policy="fp32")
    torch.cuda.reset_peak_memory_stats()
    for k in kl.KERNELS:
        k.launches = 0
    params, state, losses, step_ms, _ = run_steps(
        torch, step_fn, *init_fn(gen()), batches, steps)
    launches = {k.__name__: k.launches for k in kl.KERNELS}
    fused_peak = peak_gb(torch)
    print(f"train[gemma2-2b, build_train_step + fused_lans, fp32 policy]: "
          f"losses {[round(v, 6) for v in losses]} step_ms "
          f"{[round(t, 2) for t in step_ms]} peak memory {fused_peak:.2f} "
          f"GB; launches {launches}")
    check(all(math.isfinite(v) for v in losses + cli["losses"]),
          "a gemma2-2b training loss is not finite")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cli["losses"]))
    check(rel <= 1e-2, f"gemma2-2b fused and CLI loss trajectories differ "
          f"by {rel:.3e} relative (> 1e-2)")
    print(f"train: gemma2-2b fused vs CLI loss trajectory, max relative "
          f"diff {rel:.3e} (tolerance 1e-2)")
    for name in ("sq_norm", "lans_phase1", "lans_phase2"):
        check(launches[name] == steps * n_leaves,
              f"{name} launched {launches[name]} times, expected "
              f"{steps} x {n_leaves}")
    check(launches["lans_phase2_cast"] == 0, "the fp32 route launched K4")
    _, busy = profile_step(torch, step_fn, params, state, next(batches()))
    box = [params, state]
    del params, state
    print(f"phase T(a): {time.perf_counter() - t0:.1f} s")
    analysis = phase_analysis(torch, "gemma2-2b", arch,
                              lambda: fused_lans(sched), step_fn, box,
                              batches, busy)
    del step_fn, init_fn
    torch.cuda.empty_cache()

    # (c) bf16 steps through fused_mixed_lans: K1, K2, K4
    t0 = time.perf_counter()
    policy = get_policy("bf16")
    arch16 = dataclasses.replace(arch, cfg=policy.apply_to_cfg(arch.cfg))
    step_fn, init_fn = build_train_step(
        arch16.loss_fn, fused_mixed_lans(sched, policy),
        param_init_fn=arch16.init, policy=policy)
    torch.cuda.reset_peak_memory_stats()
    for k in kl.KERNELS:
        k.launches = 0
    params, state, bf16_losses, bf16_ms, metrics = run_steps(
        torch, step_fn, *init_fn(gen()), batches, 2)
    applied = 2 - int(metrics["overflow_count"])
    bf16_launches = {k.__name__: k.launches for k in kl.KERNELS}
    print(f"train[gemma2-2b, build_train_step + fused_mixed_lans, bf16 "
          f"policy]: losses {[round(v, 6) for v in bf16_losses]} step_ms "
          f"{[round(t, 2) for t in bf16_ms]} peak memory "
          f"{peak_gb(torch):.2f} GB; applied steps {applied}; launches "
          f"{bf16_launches}")
    check(all(math.isfinite(v) for v in bf16_losses),
          "a gemma2-2b bf16 training loss is not finite")
    check(bf16_launches["lans_phase2_cast"] == applied * n_leaves,
          f"K4 launched {bf16_launches['lans_phase2_cast']} times for "
          f"{applied} applied steps x {n_leaves} leaves")
    check(bf16_launches["lans_phase2"] == 0, "the mixed route launched K3")
    del params, state, step_fn, init_fn, metrics
    torch.cuda.empty_cache()
    print(f"phase T(c): {time.perf_counter() - t0:.1f} s")

    # (e) K1-K4 at the embedding leaf, and the whole update
    t0 = time.perf_counter()
    errs = {k.__name__: 0.0 for k in kl.KERNELS}
    times = lans_timing(torch, kl, kops, errs, n=EMBED_LEAF)
    torch.cuda.empty_cache()
    update = decoder_update_timing(torch, arch, kops, n_leaves)
    print(f"phase T(e): {time.perf_counter() - t0:.1f} s")
    return launches, bf16_launches, times, errs, update, analysis


def whisper_serving(torch, serve_mod):
    """Phase E(a): whisper-large-v3 served at full width and depth (see
    the module docstring)."""
    from repro_torch.configs import get_arch
    from repro_torch.serving import (ContinuousEngine,
                                     synthetic_encdec_requests)
    t0 = time.perf_counter()
    serve_mod.main(with_flag(with_flag(WHISPER_SERVE_ARGV, "--requests",
                                       "2"), "--new-tokens", "4"))
    print("serve: whisper warm-up stream done (2 requests, 4 new tokens)")
    torch.cuda.reset_peak_memory_stats()
    stats, cli_tokens = serve(serve_mod, WHISPER_SERVE_ARGV,
                              "whisper-large-v3 fp32")
    peak = peak_gb(torch)
    arch = get_arch("whisper-large-v3")
    # the CLI's weights (the seed on the card) and its request stream
    params = arch.init(torch.Generator(device="cuda").manual_seed(0))

    def stream():
        return synthetic_encdec_requests(
            8, arch.cfg.vocab, n_frames=arch.cfg.n_frames,
            d_model=arch.cfg.d_model, prompt_len=8, new_tokens=32,
            n_inputs=2, seed=0)
    want = {i: r.max_new_tokens for i, r in enumerate(stream())}
    check(all(len(cli_tokens[i]) == n for i, n in want.items()),
          "whisper: a request did not end with its budget")
    hits = stats["shared_block_hits"]
    check(hits > 0 and hits % WHISPER_BLOCKS == 0,
          f"whisper: {hits} shared cross blocks, not a positive multiple "
          f"of {WHISPER_BLOCKS} (one input's blocks)")
    print(f"phase E(a): tokens_per_s {stats['tokens_per_s']:.2f}, ttft p50 "
          f"{stats['ttft_p50_ms']:.2f} ms p99 {stats['ttft_p99_ms']:.2f} ms, "
          f"itl p50 {stats['itl_p50_ms']:.2f} ms p99 "
          f"{stats['itl_p99_ms']:.2f} ms, decode steps "
          f"{stats['decode_steps']}, shared cross blocks {hits}, retained "
          f"{stats['retained_block_hits']}, peak memory {peak:.2f} GB")
    kw = dict(max_batch=4, max_len=40, policy="fp32", prefill_bucket=8)
    eng = ContinuousEngine(arch, params, **kw)
    # where a decode step's time goes: 4 slots, under the profiler
    for r in stream()[:4]:
        eng.submit(r)
    eng.step()
    eng.step()
    check(len(eng.scheduler.active) == 4, "whisper profile: not 4 slots")
    print_profile("whisper decode step, 4 slots",
                  *device_profile(torch, eng.step))
    eng.run()
    shared = {i: r.generated.tolist()
              for i, r in enumerate(eng.run_batch(stream()))}
    check(shared == cli_tokens, "whisper: a library engine's tokens differ "
          "from the CLI's")
    solo = {i: eng.run_one(r).generated.tolist()
            for i, r in enumerate(stream())}
    check(solo == cli_tokens, "whisper: run_one tokens differ from the "
          "pooled engine's")
    eng.pool.check_invariants()
    check(eng.pool.map.alloc.n_live == 0, "whisper: cross blocks stay live "
          "after the drain")
    del eng
    torch.cuda.empty_cache()
    eng = ContinuousEngine(arch, params, share_prefix=False, **kw)
    unshared = {i: r.generated.tolist()
                for i, r in enumerate(eng.run_batch(stream()))}
    check(eng.pool.shared_hits == 0, "whisper: share_prefix=False shared")
    check(unshared == cli_tokens, "whisper: tokens differ between "
          "share_prefix True and False")
    eng.pool.check_invariants()
    check(eng.pool.map.alloc.n_live == 0, "whisper: cross blocks stay live "
          "after the drain (unshared)")
    print(f"phase E(a): tokens equal across the CLI, an engine with and "
          f"without sharing, and run_one for {len(cli_tokens)} requests; "
          f"no cross block live after the drains")
    del eng, params
    torch.cuda.empty_cache()
    print(f"phase E(a): {time.perf_counter() - t0:.1f} s")


def bert_scoring(torch, serve_mod):
    """Phase E(b): bert-large scored and embedded at full width (see the
    module docstring)."""
    import numpy as np
    from repro_torch.configs import get_arch
    from repro_torch.serving import (ContinuousEngine,
                                     synthetic_scoring_requests)
    t0 = time.perf_counter()
    serve_mod.main(with_flag(BERT_SCORE_ARGV, "--requests", "8"))
    print("serve: bert warm-up stream done (8 requests)")
    out = {}
    for task in ("score", "embed"):
        stats, done = serve_mod.main(with_flag(BERT_SCORE_ARGV, "--task",
                                               task))
        out[task] = done
        steps = stats["decode_steps"]
        print(f"serve[bert-large {task}]: requests={stats['requests']} "
              f"requests_per_s {stats['requests'] / stats['wall_s']:.2f} "
              f"tokens_per_s {stats['tokens_per_s']:.2f} forwards {steps}, "
              f"{stats['wall_s'] * 1e3 / steps:.2f} ms per forward")
        check(stats["requests"] == 32 and steps == 4,
              f"bert {task}: {stats['requests']} requests in {steps} "
              f"forwards, expected 32 in 4")
    for s, e in zip(out["score"], out["embed"]):
        check(len(s.generated) == len(s.prompt) and len(e.generated) == 0,
              "bert: score/embed outputs of the wrong length")
        check(np.allclose(s.embedding, e.embedding, rtol=1e-5, atol=1e-5),
              f"bert: request {s.rid}'s score and embed embeddings differ")
    arch = get_arch("bert-large")
    params = arch.init(torch.Generator(device="cuda").manual_seed(0))
    eng = ContinuousEngine(arch, params, max_batch=8, max_len=128,
                           policy="fp32", task="score")
    solo = synthetic_scoring_requests(32, arch.cfg.vocab, prompt_len=128,
                                      seed=0)
    emb_err, n_pos, differ = 0.0, 0, []
    for b, r in zip(out["score"], solo):
        eng.run_one(r)
        emb_err = max(emb_err, float(np.abs(r.embedding - b.embedding).max()))
        check(np.allclose(r.embedding, b.embedding, rtol=1e-5, atol=1e-5),
              f"bert: request {b.rid}'s run_one embedding differs from the "
              f"batched one beyond 1e-5")
        n_pos += len(r.generated)
        differ += [(b.rid, int(i), int(b.generated[i]), int(r.generated[i]))
                   for i in np.nonzero(r.generated != b.generated)[0]]
    # cuBLAS may reduce in another order at batch 1 than at batch 8, and
    # 4096 argmaxes over 30,522 logits can meet a near-tie: the masked-LM
    # ids must agree on 99.9% of the positions, each differing one printed
    for rid, i, batched, single in differ:
        print(f"  bert ids differ: request {rid} position {i}: batched "
              f"{batched}, run_one {single}")
    agree = 1 - len(differ) / n_pos
    print(f"phase E(b): run_one vs batched: embeddings max |diff| "
          f"{emb_err:.3e} (tolerance 1e-5), masked-LM ids equal on "
          f"{n_pos - len(differ)} of {n_pos} positions ({agree:.5f})")
    check(agree >= 0.999, f"bert: run_one ids agree on {agree:.5f} < 0.999")
    del eng, params
    torch.cuda.empty_cache()
    print(f"phase E(b): {time.perf_counter() - t0:.1f} s")


def whisper_training(torch, kl, kops):
    """Phase E(c): whisper-large-v3 trained at full width and depth
    through K1-K3 (see the module docstring). Returns (the fused route's
    launches, K1-K3 timings and errors at the largest leaf)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.core.optim import fused_lans, lans
    from repro_torch.core.optim.base import tree_items
    from repro_torch.distributed.steps import build_train_step
    from repro_torch.launch import train as train_mod
    t0 = time.perf_counter()
    arch = get_arch("whisper-large-v3")
    steps, batch_size, seq, seed = 3, 2, 128, 0
    sched = train_mod.make_schedule("hold", 2e-3, steps, 0.2, 0.3)
    batches = cli_batches(torch, train_mod, arch, batch_size, seq, seed)
    with torch.device("meta"):
        shapes = tree_items(arch.init(None))
    n_params = sum(t.numel() for _, t in shapes)
    check(len(shapes) == WHISPER_LEAVES and max(
        t.numel() for _, t in shapes) == WHISPER_LEAF,
        "whisper-large-v3's leaves are not 46 with 209,715,200 at most")
    print(f"phase E(c): whisper-large-v3, {len(shapes)} leaves, {n_params} "
          f"params, seq {seq}, batch {batch_size}, 1500 frames")
    # shared step-1 gradients at full width, 8 layers per stack (every
    # leaf; both routes' params, moments and updates fit the card)
    arch8 = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, n_layers=8))
    shared_step1(torch, arch8, batches, lans(sched), fused_lans(sched),
                 "whisper-large-v3 (8 layers per stack), lans vs "
                 "fused_lans", leaves=WHISPER_LEAVES)
    torch.cuda.reset_peak_memory_stats()
    cli = train_mod.main(WHISPER_TRAIN_ARGV)
    cli_peak = peak_gb(torch)
    torch.cuda.empty_cache()
    print(f"train[whisper-large-v3, cli, unfused lans, fp32 policy]: losses "
          f"{[round(v, 6) for v in cli['losses']]} step_ms "
          f"{[round(t * 1e3, 2) for t in cli['step_s']]} peak memory "
          f"{cli_peak:.2f} GB")
    step_fn, init_fn = build_train_step(arch.loss_fn, fused_lans(sched),
                                        param_init_fn=arch.init,
                                        policy="fp32")
    torch.cuda.reset_peak_memory_stats()
    for k in kl.KERNELS:
        k.launches = 0
    params, state, losses, step_ms, _ = run_steps(
        torch, step_fn,
        *init_fn(torch.Generator(device="cuda").manual_seed(seed)),
        batches, steps)
    launches = {k.__name__: k.launches for k in kl.KERNELS}
    fused_peak = peak_gb(torch)
    print(f"train[whisper-large-v3, build_train_step + fused_lans, fp32 "
          f"policy]: losses {[round(v, 6) for v in losses]} step_ms "
          f"{[round(t, 2) for t in step_ms]} peak memory {fused_peak:.2f} "
          f"GB; launches {launches}")
    check(all(math.isfinite(v) for v in losses + cli["losses"]),
          "a whisper training loss is not finite")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cli["losses"]))
    check(rel <= 1e-2, f"whisper fused and CLI loss trajectories differ by "
          f"{rel:.3e} relative (> 1e-2)")
    print(f"train: whisper fused vs CLI loss trajectory, max relative diff "
          f"{rel:.3e} (tolerance 1e-2)")
    for name in ("sq_norm", "lans_phase1", "lans_phase2"):
        check(launches[name] == steps * WHISPER_LEAVES,
              f"{name} launched {launches[name]} times, expected "
              f"{steps} x {WHISPER_LEAVES}")
    check(launches["lans_phase2_cast"] == 0, "the fp32 route launched K4")
    profile_step(torch, step_fn, params, state, next(batches()))
    del params, state, step_fn, init_fn
    torch.cuda.empty_cache()
    errs = {k.__name__: 0.0 for k in kl.KERNELS}
    times = lans_timing(torch, kl, kops, errs, n=WHISPER_LEAF)
    torch.cuda.empty_cache()
    print(f"phase E(c): {time.perf_counter() - t0:.1f} s")
    return launches, times, errs


# ---------------------------------------------------------------------------
# phase D: the router, the 2 x 1 mesh, leaves cut into shards
# ---------------------------------------------------------------------------

ROUTER_KW = dict(max_batch=4, max_len=144, policy="fp32", prefill_bucket=16,
                 cache="paged", block_size=16, attn_kernel="paged")
ROUTER_CLI_ARGV = ["--arch", "gemma2-2b", "--full", "--precision", "fp32",
                   "--attn-kernel", "paged", "--requests", "8",
                   "--max-batch", "4", "--prompt-len", "32", "--new-tokens",
                   "32", "--shared-prefix", "64", "--seed", "0", "--device",
                   "cuda"]
MESH_STEPS = 3
MESH_JOIN_S = 900


def tenant_prompts(vocab, seed=20):
    """A chat service's stream: 3 tenants, each with its own 64-token
    system prompt (4 blocks), 4 requests each with a user turn of 16-48
    tokens, interleaved; then 2 prompts shorter than one block."""
    import numpy as np
    rng = np.random.default_rng(seed)
    system = [rng.integers(5, vocab, 64) for _ in range(3)]
    prompts = [np.concatenate([system[i % 3], rng.integers(
        5, vocab, int(rng.integers(16, 49)))]).astype(np.int32)
        for i in range(12)]
    return prompts + [rng.integers(5, vocab, int(rng.integers(4, 16))
                                   ).astype(np.int32) for _ in range(2)]


def replica_steps(report):
    """Decode steps summed over a fleet's replicas (or one engine's)."""
    if "per_replica" in report:
        return sum(r["decode_steps"] for r in report["per_replica"])
    return report["decode_steps"]


def router_run(torch, pa, label, make, prompts):
    """Serve `prompts` (32 new tokens each) on the engine or fleet make()
    builds: K8 launched decode steps x 26 (summed over the replicas).
    Returns (report, tokens in request order)."""
    from repro_torch.serving import Request
    eng = make()
    reqs = [Request(prompt=p.copy(), max_new_tokens=32) for p in prompts]
    torch.cuda.reset_peak_memory_stats()
    pa.paged_attention_fused.launches = 0
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    rep = eng.report(time.perf_counter() - t0)
    launches = pa.paged_attention_fused.launches
    steps = replica_steps(rep)
    check(launches == steps * N_LAYERS,
          f"router[{label}]: K8 launched {launches} times for {steps} "
          f"decode steps x {N_LAYERS}")
    per = rep.get("per_replica", [rep])
    print(f"router[{label}]: tokens_per_s={rep['tokens_per_s']:.2f} "
          f"retained_hit_rate={rep['retained_hit_rate']:.3f} decode_steps="
          f"{[r['decode_steps'] for r in per]} prefix_blocks_written="
          f"{[r['prefix_misses'] for r in per]} shared_block_hits="
          f"{[r['shared_block_hits'] for r in per]} K8 launches={launches} "
          f"peak_gb={peak_gb(torch):.2f}")
    tokens = [r.generated.tolist() for r in reqs]
    check(all(len(t) == 32 for t in tokens),
          f"router[{label}]: a request stopped short of its budget")
    del eng
    return rep, tokens, launches


def phase_router(torch, pa, serve_mod):
    """Phase D(a): gemma2-2b at full width behind ReplicaRouter (K8 on
    every replica's decode steps)."""
    from repro_torch.configs import get_arch
    from repro_torch.serving import ContinuousEngine, ReplicaRouter
    arch = get_arch("gemma2-2b")
    params = arch.init(torch.Generator(device="cuda").manual_seed(0))
    prompts = tenant_prompts(arch.cfg.vocab)
    engine = lambda **kw: ContinuousEngine(arch, params, **ROUTER_KW, **kw)
    router_run(torch, pa, "warm-up", engine, prompts[:2])
    runs = {"one engine": lambda: engine()}
    for policy in ("prefix", "depth", "rr"):
        runs[policy] = (lambda p: lambda: ReplicaRouter(
            [engine(), engine()], policy=p))(policy)
    runs["prefix-affinity"] = lambda: engine(sched_policy="prefix-affinity")
    out, launches = {}, 0
    for label, make in runs.items():
        rep, tokens, n = router_run(torch, pa, label, make, prompts)
        launches += n
        out[label] = (rep, tokens)
    want = out["one engine"][1]
    for label, (rep, tokens) in out.items():
        check(tokens == want, f"router[{label}]: tokens differ from one "
                              f"engine's")
    rep = out["prefix"][0]
    check(rep["routed_fallback"] == 2 and rep["routed_affinity_hits"] >= 9,
          f"router[prefix]: fallback {rep['routed_fallback']}, affinity "
          f"hits {rep['routed_affinity_hits']}")
    print(f"router: tokens equal across {', '.join(out)} (14 requests); "
          f"prefix: routed_affinity_hits {rep['routed_affinity_hits']}, "
          f"routed_fallback {rep['routed_fallback']}")
    del params
    torch.cuda.empty_cache()
    # the CLI: --replicas 2 --route-policy prefix against --replicas 1
    cli = {}
    for n in ("1", "2"):
        argv = ROUTER_CLI_ARGV + (["--replicas", n, "--route-policy",
                                   "prefix"] if n == "2" else [])
        pa.paged_attention_fused.launches = 0
        stats, done = serve_mod.main(argv)
        steps = replica_steps(stats)
        check(pa.paged_attention_fused.launches == steps * N_LAYERS,
              f"router CLI --replicas {n}: K8 launched "
              f"{pa.paged_attention_fused.launches} times for {steps} "
              f"decode steps x {N_LAYERS}")
        launches += pa.paged_attention_fused.launches
        cli[n] = {r.prompt.tobytes(): r.generated.tolist() for r in done}
        print(f"router CLI --replicas {n}: tokens_per_s="
              f"{stats['tokens_per_s']:.2f} decode_steps={steps} "
              f"routed_affinity_hits="
              f"{stats.get('routed_affinity_hits', 'n/a')}")
        torch.cuda.empty_cache()
    check(cli["1"] == cli["2"] and len(cli["2"]) == 8,
          "router CLI: --replicas 2 tokens differ from --replicas 1")
    print("router CLI: --replicas 2 --route-policy prefix == --replicas 1 "
          "greedy tokens (8 requests, one 64-token shared prefix)")
    return launches


# name: (arch, data, model, zero3, depth or None for the arch's own,
#        global batch, seq, steps)
MESH_RUNS = {
    # D(b): BERT-large at full width and 6 of its 24 layers, the depth
    # cut to 12 when phase D(e) was added and to 6 when phase D(h) was,
    # to keep the script's time
    "2x1": ("bert-large", 2, 1, False, 6, 16, 128, MESH_STEPS),
    "2x1-zero3": ("bert-large", 2, 1, True, 6, 16, 128, MESH_STEPS),
    "1x2": ("bert-large", 1, 2, False, 6, 16, 128, MESH_STEPS),
    # D(d): granite-moe-3b-a800m at full width; two ranks of fp32 params
    # and moments at its full depth would not fit the one card, and one
    # layer keeps phase D nearer 150 s
    "granite-2x1": ("granite-moe-3b-a800m", 2, 1, False, 1, 16, 128,
                    MESH_STEPS),
    # D(f): the model axis computes on the experts (20 of 40 a rank),
    # the vocab (gemma2-2b's 256000 rows, 128000 a rank; mamba2's 50280)
    # and the Mamba-2 mixers (12 of 24 heads a rank), full width
    "granite-1x2": ("granite-moe-3b-a800m", 1, 2, False, 1, 16, 128, 2),
    "gemma2-1x2": ("gemma2-2b", 1, 2, False, 2, 2, 1024, 2),
    "mamba2-1x2": ("mamba2-130m", 1, 2, False, None, 2, 1024, 2),
    # D(h): attention in 4 head groups of 2 ranks (gemma2-2b's 8 heads
    # and 4 KV heads on 8 model ranks), full width, one period (2
    # layers), one step: eight gloo processes on the card
    "gemma2-1x8": ("gemma2-2b", 1, 8, False, 2, 2, 128, 1),
}
SPLIT_RUNS = ("granite-1x2", "gemma2-1x2", "mamba2-1x2")   # phase D(f)
GROUP_RUNS = ("gemma2-1x8",)                               # phase D(h)
# what the fetch gathers of gemma2-2b on 1 x 8: a head group's columns of
# wq (2 of its 8 heads of 256) and of wk / wv (1 of 4), nothing else
GROUP_GATHERS = {(2304, 512), (2304, 256)}
MESH_MEMORY_CUT = 0.70       # rank 1's peak under zero3 / 1 x 2 vs 2 x 1


def host_whole(torch, partial, t, keep=True):
    """A placed leaf's whole value on the CPU, gathered through
    partial.all_gather_dim; a plain tensor copied to the CPU. With keep
    False the rank takes part in the gather and returns None."""
    from torch.distributed.tensor import DTensor
    if not isinstance(t, DTensor):
        return t.detach().cpu() if keep else None
    x, mesh = t.to_local(), t.device_mesh
    for md in reversed(range(mesh.ndim)):
        p = t.placements[md]
        if p.is_shard():
            x = partial.all_gather_dim(x, p.dim, mesh.get_group(md))
    return x.detach().cpu() if keep else None


def collective_timer(torch, dist, partial, steps):
    """Wraps the step's collectives (dist.all_reduce, the gathers and
    reduce-scatters of distributed/partial.py, and the gradient sums
    after the backward pass, steps._placed_grad) with a host clock,
    synchronised around each outermost call. Returns {"ms": total}."""
    acc = {"ms": 0.0, "depth": 0}

    def timed(fn):
        def run(*a, **k):
            if acc["depth"]:
                return fn(*a, **k)
            acc["depth"] += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.synchronize()
                acc["ms"] += (time.perf_counter() - t0) * 1e3
                acc["depth"] -= 1
        return run

    dist.all_reduce = timed(dist.all_reduce)
    for mod, name in ((partial, "all_gather_dim"),
                      (partial, "reduce_scatter_dim"),
                      (steps, "_placed_grad")):
        setattr(mod, name, timed(getattr(mod, name)))
    return acc


def mesh_run(torch, name, rank, ref_rank, timer, gathered):
    """One run of phase D(b), D(d) or D(f) on this rank; returns its
    numbers. `gathered` is the list the fetch's gathers append their
    shapes to."""
    import dataclasses
    import gc
    import contextlib
    import torch.distributed as dist
    from port.mesh_worker import mesh_order
    from repro_torch.configs import get_arch
    from repro_torch.core.optim import fused_lans
    from repro_torch.core.optim.base import (apply_updates, tree_items,
                                             tree_leaves, tree_map)
    from repro_torch.distributed import partial
    from repro_torch.distributed import sharding as shd
    from repro_torch.distributed.partial import reduce_partials
    from repro_torch.distributed.steps import (build_train_step,
                                               place_train_step)
    from repro_torch.kernels import lans as kl
    from repro_torch.launch import train as train_mod
    from repro_torch.launch.mesh import make_local_mesh
    t_run = time.perf_counter()
    arch_name, data, model, zero3, depth, size, seq, n_steps = \
        MESH_RUNS[name]
    arch = get_arch(arch_name)
    arch = dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, compute_dtype=torch.float32,
        **({} if depth is None else {"n_layers": depth})))
    sched = train_mod.make_schedule("hold", 2e-3, n_steps, 0.2, 0.3)
    batches = list(zip(range(n_steps), cli_batches(
        torch, train_mod, arch, size, seq, 0)()))
    init = lambda: arch.init(torch.Generator(device="cuda").manual_seed(0))
    split = model > 1

    def whole(tree):
        # every rank takes part in each leaf's gather; the reference rank
        # alone keeps the whole leaves (eight ranks' copies would not fit
        # the host's memory)
        out = {}
        for p, v in tree_items(tree):
            t = host_whole(torch, partial, v, keep=rank == ref_rank)
            if t is not None:
                out[p] = t
        return out

    def recording(tx, seen):
        # the step-1 gradient, whole on the CPU (every rank gathers)
        def update(grads, state, params=None):
            if split and not seen:
                seen.append(whole(grads))
            return tx.update(grads, state, params)
        return tx._replace(update=update)

    def steps(step, placed):
        """(losses, step ms, step-1 params whole, router entropies, (peak
        bytes since the caller's reset, peak bytes of the last step
        alone: no gate's whole-tree gathers run in it)). placed: [params,
        state], emptied, so that no generation outlives its step."""
        params, state = placed
        placed.clear()
        losses, ms, first, entropy = [], [], None, []
        for i, b in batches:
            if i == n_steps - 1:
                before = torch.cuda.max_memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
            entropy.append(float(m.get("router_entropy", 0.0)))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                first = whole(params)
        last = torch.cuda.max_memory_allocated()
        return losses, ms, first, entropy, (max(before, last), last)

    out = {}
    if rank == ref_rank:
        # the one-process run, its gradient summed in the mesh's order
        # (each rank's block of 8 on its own, its means over the whole
        # batch of 16, the two blocks' gradients added, as the all-reduce
        # adds them; MoE routes each block as its group; the matmuls
        # split as the two model ranks split them): the maths of one
        # device, the mesh's order of sums
        ref_seen = []
        step, init_fn = build_train_step(
            arch.loss_fn, recording(fused_lans(sched), ref_seen),
            param_init_fn=lambda _: init())
        torch.cuda.reset_peak_memory_stats()
        with (mesh_order(data, 1, model=model, heads=arch.heads,
                         mamba=arch.mamba)
              if data > 1 or split else contextlib.nullcontext()):
            (out["ref_losses"], _, ref_first, out["ref_entropy"],
             peaks) = steps(step, list(init_fn(None)))
        out["ref_peak_gb"], out["ref_last_peak_gb"] = (p / 1e9 for p in peaks)
        del step, init_fn
        gc.collect()
        torch.cuda.empty_cache()
    mesh = make_local_mesh(data=data, model=model, device="cuda")
    seen = []
    step, init_fn = build_train_step(
        arch.loss_fn, recording(fused_lans(sched), seen), mesh, zero3=zero3,
        param_init_fn=lambda _: init(), heads=arch.heads, mamba=arch.mamba)
    params, state = init_fn(None)
    pspec, ospec = step.specs_for(params, state)
    # placed (cut) before the run, the whole init freed: the peak is the
    # step's
    params = shd.distribute(params, mesh, pspec)
    state = shd.distribute(state, mesh, ospec)
    step = place_train_step(step, mesh, pspec, ospec, batches[0][1])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in kl.KERNELS:
        k.launches = 0
    reduce_partials.calls = 0
    timer["ms"] = 0.0
    gathered.clear()
    out.update(n_leaves=len(tree_leaves(params)),
               n_params=sum((p.to_local() if hasattr(p, "to_local")
                             else p).numel() for p in tree_leaves(params)))
    placed = [params, state]
    del params, state
    losses, ms, first, entropy, peaks = steps(step, placed)
    out.update(losses=losses, step_ms=ms, entropy=entropy,
               peak_gb=peaks[0] / 1e9, last_peak_gb=peaks[1] / 1e9,
               collective_ms=timer["ms"] / n_steps,
               gathered=sorted(set(gathered)),
               launches={k.__name__: k.launches for k in kl.KERNELS},
               partial_allreduces=reduce_partials.calls)
    del step
    gc.collect()
    torch.cuda.empty_cache()
    if rank == ref_rank:
        diffs = [(first[p] - a).abs() for p, a in ref_first.items()]
        out["step1_param_err"] = max(d.max().item() for d in diffs)
        out["step1_n"] = sum(d.numel() for d in diffs)
        out["step1_unequal"] = sum(int((d > 0).sum()) for d in diffs)
        if split:
            # the update gate: the one-device optimizer's step on the
            # mesh's own step-1 gradient, against the mesh's step-1 params
            p0 = init()
            tx = fused_lans(sched)
            g = {p: v.cuda() for p, v in seen[0].items()}
            g = tree_map(lambda pth: g[pth], _paths(p0))
            upd, _ = tx.update(g, tx.init(p0), p0)
            p1 = dict(tree_items(apply_updates(p0, upd)))
            out["update_err"] = max((first[p] - v.cpu()).abs().max().item()
                                    for p, v in p1.items())
            del p0, g, upd, p1
            # the gradient gate: every element of the step-1 gradient
            # against the one process's
            over, worst = 0, 0.0
            for p, v in ref_seen[0].items():
                d = (seen[0][p] - v).abs()
                over += int((d > 1e-6 + 1e-5 * v.abs()).sum())
                worst = max(worst, d.max().item())
            out["grad_over"], out["grad_err"] = over, worst
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    out["run_s"] = time.perf_counter() - t_run
    return out


def _paths(tree):
    from repro_torch.core.optim.base import tree_paths
    return tree_paths(tree)


def mesh_rank(rank, world, init_method, out_path, ref_rank, names):
    """One rank of phase D(b), D(d) and D(f), in a process of its own:
    the runs `names` of MESH_RUNS on two gloo ranks sharing the one card.
    The reference rank also runs each one-process reference (no mesh)
    for the gates. Writes its numbers as JSON to out_path."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch import select_device
    from repro_torch.distributed import partial, steps
    select_device("cuda")
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world)
    try:
        out = {"rank": rank, "runs": {}}
        timer = collective_timer(torch, dist, partial, steps)
        gathered = []
        plain = partial.gather_leaf

        def recorded(t, cuts):
            result = plain(t, cuts)
            if cuts:
                gathered.append(tuple(result.shape))
            return result

        partial.gather_leaf = recorded
        for name in names:
            out["runs"][name] = mesh_run(torch, name, rank, ref_rank, timer,
                                         gathered)
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(out, f)


def phase_mesh(torch, names=tuple(n for n in MESH_RUNS
                                   if n not in GROUP_RUNS)):
    """Phase D(b), D(d) and D(f): BERT-large on 2 x 1, 2 x 1 with zero3
    and 1 x 2 meshes, granite-moe-3b-a800m (full width, 1 layer) on 2 x
    1, and on 1 x 2 granite-moe (its experts over "model"), gemma2-2b (a
    vocab-parallel readout and loss) and mamba2-130m (Mamba-2 on whole
    heads), two ranks as two processes on the one card under gloo; the
    runs `names` of MESH_RUNS (D(f) alone: SPLIT_RUNS; D(h)'s training:
    GROUP_RUNS, eight ranks), all of one mesh size."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import dataclasses
    from port.mesh_worker import model_cut_shapes
    from repro_torch.configs import get_arch
    import multiprocessing
    import socket
    import tempfile
    print("mesh: one card, so each mesh's two ranks are two processes on "
          "it under gloo (NCCL refuses two ranks on one device; gloo takes "
          "CUDA tensors for all_reduce, all_gather_into_tensor and "
          "reduce_scatter_tensor, staging them through the host itself); "
          "the model axis and zero3 also run on four cards over NCCL in "
          "tests/port/test_torch_cuda_kernels.py")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "src", "repro_torch",
                                            "kernels", "_build"))
    ctx = multiprocessing.get_context("spawn")
    worlds = {MESH_RUNS[n][1] * MESH_RUNS[n][2] for n in names}
    check(len(worlds) == 1, f"mesh: runs {names} on meshes of {worlds} "
                            f"ranks")
    world = worlds.pop()
    paths = [os.path.join(tmp, f"rank{r}.json") for r in range(world)]
    procs = [ctx.Process(target=mesh_rank, args=(
        r, world, f"tcp://localhost:{port}", paths[r], 0, names))
        for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(MESH_JOIN_S)
        codes = [p.exitcode for p in procs]
        check(codes == [0] * world, f"mesh: rank exit codes {codes} (join "
                                    f"timeout {MESH_JOIN_S} s)")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    ranks = []
    for path in paths:
        with open(path) as f:
            ranks.append(json.load(f))
    shutil.rmtree(tmp)
    for name in names:
        arch, data, model, zero3, depth, size, seq, n_steps = MESH_RUNS[name]
        r0, r1 = (r["runs"][name] for r in ranks[:2])
        where = f"mesh {name} ({arch})"
        check(all(r["runs"][name]["losses"] == r0["losses"]
                  for r in ranks),
              f"{where}: the ranks report different losses")
        rel = max(abs(a - b) / abs(b) for a, b in zip(r0["losses"],
                                                      r0["ref_losses"]))
        check(rel <= 1e-4, f"{where}: losses {r0['losses']} vs one process "
                           f"{r0['ref_losses']} ({rel:.3e} relative)")
        for i, r in enumerate(x["runs"][name] for x in ranks):
            for k in ("sq_norm", "lans_phase1", "lans_phase2"):
                check(r["launches"][k] == r0["n_leaves"] * n_steps,
                      f"{where} rank {i}: {k} launched "
                      f"{r['launches'][k]} times")
            check(r["launches"]["lans_phase2_cast"] == 0,
                  f"{where}: K4 launched")
            cut = model > 1 or zero3
            check((r["partial_allreduces"] > 0) == cut,
                  f"{where}: {r['partial_allreduces']} partial all-reduces")
        check(r0["step1_param_err"] <= 2e-5,
              f"{where}: step-1 params {r0['step1_param_err']:.3e} "
              f"from the one process's (gate 2e-5, every element)")
        held = (f"step-1 params: every one of {r0['step1_n']} elements "
                f"within {r0['step1_param_err']:.3e} (gate 2e-5), "
                f"{r0['step1_unequal']} not bit-equal")
        if model > 1:
            check(r0["grad_over"] == 0,
                  f"{where}: {r0['grad_over']} step-1 gradient elements "
                  f"off the one process's (gate rtol 1e-5, atol 1e-6; "
                  f"worst {r0['grad_err']:.3e})")
            check(r0["update_err"] <= 2e-5,
                  f"{where}: the update on the mesh's own gradient "
                  f"{r0['update_err']:.3e} from the one-device "
                  f"optimizer's (gate 2e-5)")
            held += (f"; the step-1 gradient within {r0['grad_err']:.3e} "
                     f"of the one process's (gate rtol 1e-5, atol 1e-6, "
                     f"every element); the update on its own step-1 "
                     f"gradient within {r0['update_err']:.3e} of the "
                     f"one-device optimizer's (gate 2e-5)")
        for r in ranks:
            x = r["runs"][name]
            print(f"{where} rank {r['rank']}: step_ms "
                  f"{[round(v, 2) for v in x['step_ms']]}, collective_ms "
                  f"per step {x['collective_ms']:.2f} (gloo, host-timed, "
                  f"through the host: no measure of NVLink), "
                  f"peak_gb {x['peak_gb']:.2f}, K1-K3 launches "
                  f"{x['launches']['sq_norm']} = {n_steps} x "
                  f"{x['n_leaves']}, partial all-reduces "
                  f"{x['partial_allreduces']}, {x['n_params']} local "
                  f"elements")
        print(f"{where}: losses {r0['losses']} vs one process "
              f"{r0['ref_losses']} ({rel:.3e} relative, gate 1e-4); {held}")
        if arch.startswith("granite"):
            print(f"{where}: router_entropy {r0['entropy']} vs one process "
                  f"{r0['ref_entropy']} (the aux metric; moe_aux_loss is "
                  f"inside the loss)")
        if name in GROUP_RUNS:
            for r in ranks:
                shapes = {tuple(g) for g in r["runs"][name]["gathered"]}
                check(shapes == GROUP_GATHERS,
                      f"{where} rank {r['rank']}: the fetch gathered "
                      f"{sorted(shapes)}, not a head group's wq / wk / wv "
                      f"columns {sorted(GROUP_GATHERS)} alone")
            print(f"{where}: every rank gathered a head group's wq / wk / "
                  f"wv columns {sorted(GROUP_GATHERS)} and nothing else: "
                  f"no whole wq / wk / wv, no wo (gate)")
        if name in SPLIT_RUNS + GROUP_RUNS:
            a = get_arch(arch)
            if depth is not None:
                a = dataclasses.replace(a, cfg=dataclasses.replace(
                    a.cfg, n_layers=depth))
            cut, _ = model_cut_shapes(a)
            for r in ranks:
                shapes = {tuple(g) for g in r["runs"][name]["gathered"]}
                check(not shapes & cut,
                      f"{where} rank {r['rank']}: the fetch gathered "
                      f"{sorted(shapes & cut)}: an expert stack, a "
                      f"vocab-cut table or a Mamba projection")
            shapes = [tuple(g) for g in r1["gathered"]]
            biggest = max(shapes, key=lambda g: math.prod(g), default=None)
            print(f"{where}: the fetch gathered no expert stack, vocab-cut "
                  f"table or Mamba projection on either rank (gate); rank "
                  f"1 gathered {len(shapes)} shapes, the largest "
                  f"{biggest} ({math.prod(biggest) if biggest else 0} "
                  f"elements); rank 1 peak {r1['peak_gb']:.2f} GB vs the "
                  f"one-process run's {r0['ref_peak_gb']:.2f} GB, in "
                  f"the last step alone (no gate's whole-tree gathers) "
                  f"{r1['last_peak_gb']:.2f} GB vs "
                  f"{r0['ref_last_peak_gb']:.2f} GB; "
                  f"{r0['run_s']:.1f} s")
    if set(names) & set(SPLIT_RUNS):
        split_s = sum(ranks[0]["runs"][n]["run_s"] for n in names
                      if n in SPLIT_RUNS)
        print(f"phase D(f): {split_s:.1f} s")
    peaks = {name: ranks[1]["runs"][name]["peak_gb"] for name in names}
    for name in ("2x1-zero3", "1x2") if "2x1" in names else ():
        ratio = peaks[name] / peaks["2x1"]
        check(ratio <= MESH_MEMORY_CUT,
              f"mesh {name}: rank 1 peak {peaks[name]:.2f} GB is "
              f"{ratio:.3f} x the 2 x 1 run's {peaks['2x1']:.2f} GB (gate "
              f"{MESH_MEMORY_CUT})")
        print(f"mesh {name}: rank 1 peak {peaks[name]:.2f} GB = "
              f"{ratio:.3f} x 2 x 1's {peaks['2x1']:.2f} GB (gate "
              f"{MESH_MEMORY_CUT})")
    print(f"mesh: {time.perf_counter() - t0:.1f} s")
    return {name: {k: ranks[0]["runs"][name]["launches"][k]
                   for k in ("sq_norm", "lans_phase1", "lans_phase2")}
            for name in names}


# phase D(e): name: (data, model)
SERVE_MESHES = {"2x1": (2, 1), "1x2": (1, 2)}


def arena_bytes(pool, data_only=False):
    """Bytes of a paged pool's K and V arenas (with data_only, of their
    data blocks alone: no null block) and, without, their positions."""
    total = 0
    for si, m in pool.maps.items():
        arena = pool.cache["slots"][si]
        for name in ("k", "v") if data_only else ("k", "v", "pos"):
            t = arena[name]
            blocks = m.alloc.n_blocks - (1 if data_only else 0)
            total += t[:, 0].numel() * t.element_size() * blocks
    return total


def serve_mesh_run(torch, name, arch, timer, sampler=None):
    """One mesh of phase D(e) on this rank: phase 3's stream through the
    engine on the mesh after a warm-up stream, the whole params freed
    once the engine holds its own; with `sampler`, then the same stream
    sampled on a fresh engine. Returns its numbers."""
    import gc
    import statistics
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.serving import (ContinuousEngine, PagedCachePool,
                                     synthetic_requests)
    data, model = SERVE_MESHES[name]
    mesh = make_local_mesh(data=data, model=model, device="cuda")
    params = arch.init(torch.Generator(device="cuda").manual_seed(0))

    def engine(sampler=None, max_batch=4):  # SERVE_ARGV's, on the mesh
        return ContinuousEngine(arch, params, max_batch=max_batch,
                                max_len=96, policy="fp32", mesh=mesh,
                                prefill_bucket=8, block_size=16,
                                attn_kernel="paged", sampler=sampler)

    def stream(n, new):
        return synthetic_requests(n, arch.cfg.vocab, prompt_len=64,
                                  new_tokens=new, seed=0)
    engine().run(stream(2, 4))
    eng = engine()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    step_ms, coll_ms = [], []
    real = eng._step

    def timed(*a, **k):
        torch.cuda.synchronize()
        timer["ms"] = 0.0
        t0 = time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        coll_ms.append(timer["ms"])
        return out
    eng._step = timed

    one = PagedCachePool(eng.arch, 4, 96, block_size=16, device="meta")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reqs = stream(8, 32)
    pa.paged_attention_fused.launches = 0
    eng.run(reqs)
    launches = pa.paged_attention_fused.launches
    out = dict(tokens={r.rid: r.generated.tolist() for r in reqs},
               launches=launches, decode_steps=eng.steps_run,
               step_ms=statistics.median(step_ms),
               collective_ms=statistics.mean(coll_ms),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               arena_bytes=arena_bytes(eng.pool),
               one_arena_bytes=arena_bytes(one),
               data_block_bytes=arena_bytes(eng.pool, data_only=True),
               one_data_block_bytes=arena_bytes(one, data_only=True),
               kv_heads=eng.pool.cache["slots"][0]["k"].shape[-2],
               vocab_rows=eng.params["embed"]["embedding"].shape[0],
               nonfinite=eng.report(1.0)["nonfinite_logit_steps"])
    # run_one on the mesh engine: the stream's first two requests, each
    # alone at batch 1 (whole on every data rank)
    out["run_one"] = [eng.run_one(r).generated.tolist()
                      for r in stream(8, 32)[:2]]
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    if data > 1:
        # three slots, which do not divide over the data ranks: every
        # rank holds and decodes all three
        params = arch.init(torch.Generator(device="cuda").manual_seed(0))
        eng = engine(max_batch=3)
        del params
        reqs = stream(8, 32)
        eng.run(reqs)
        out["b3_tokens"] = {r.rid: r.generated.tolist() for r in reqs}
        out["b3_block"] = eng.layout.block
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    if sampler is not None:
        params = arch.init(torch.Generator(device="cuda").manual_seed(0))
        eng = engine(sampler)
        del params
        reqs = stream(8, 32)
        eng.run(reqs)
        out["sampled_tokens"] = {r.rid: r.generated.tolist() for r in reqs}
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


def serve_mesh_rank(rank, world, init_method, out_path, runs=None):
    """One rank of phase D(e), in a process of its own: gemma2-2b at full
    width and depth (fp32, K8, 4 slots, block 16) on each mesh of
    SERVE_MESHES through the engine, then through the CLI with --mesh
    2x1, two gloo ranks sharing the one card; `runs` (phase D(g), a
    list of SPLIT_SERVE names) runs those instead. Writes its numbers as
    JSON to out_path."""
    sys.path.insert(0, os.path.join(ROOT, "src"))
    import torch
    import torch.distributed as dist
    from repro_torch import select_device
    from repro_torch.configs import get_arch
    from repro_torch.distributed import partial
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import serve as serve_mod
    select_device("cuda")
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=init_method, rank=rank,
                            world_size=world)
    timer = {"ms": 0.0}
    real = partial.all_gather_dim

    def timed(*a, **k):        # every collective of a serve step
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return real(*a, **k)
        finally:
            torch.cuda.synchronize()
            timer["ms"] += (time.perf_counter() - t0) * 1e3
    partial.all_gather_dim = timed
    try:
        out = {"rank": rank, "runs": {}}
        if runs is not None:
            for name in runs:
                out["runs"][name] = (group_serve_run if name in GROUP_SERVE
                                     else split_serve_run)(torch, name,
                                                           timer)
            return
        arch = get_arch("gemma2-2b")
        for name in SERVE_MESHES:
            out["runs"][name] = serve_mesh_run(
                torch, name, arch, timer,
                SAMPLER_ARGV[1] if name == "1x2" else None)
        pa.paged_attention_fused.launches = 0
        stats, done = serve_mod.main(SERVE_ARGV + ["--mesh", "2x1"])
        out["cli"] = dict(tokens={r.rid: r.generated.tolist() for r in done},
                          launches=pa.paged_attention_fused.launches,
                          decode_steps=stats["decode_steps"],
                          mesh_devices=stats["mesh_devices"])
    finally:
        dist.destroy_process_group()
        with open(out_path, "w") as f:
            json.dump(out, f)


def serve_ranks(runs=None, world=2):
    """`world` ranks of serve_mesh_rank (with `runs`), each a gloo
    process on the one card; their numbers once all exited 0."""
    import multiprocessing
    import socket
    import tempfile
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    tmp = tempfile.mkdtemp(dir=os.path.join(ROOT, "src", "repro_torch",
                                            "kernels", "_build"))
    ctx = multiprocessing.get_context("spawn")
    paths = [os.path.join(tmp, f"serve{r}.json") for r in range(world)]
    procs = [ctx.Process(target=serve_mesh_rank, args=(
        r, world, f"tcp://localhost:{port}", paths[r], runs))
        for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(MESH_JOIN_S)
        codes = [p.exitcode for p in procs]
        check(codes == [0] * world,
              f"serving mesh: rank exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    ranks = []
    for path in paths:
        with open(path) as f:
            ranks.append(json.load(f))
    shutil.rmtree(tmp)
    return ranks


def phase_serve_mesh(torch, paged_tokens, sampled_tokens):
    """Phase D(e): gemma2-2b served on 2 x 1 and 1 x 2 meshes (two gloo
    processes on the one card) through the engine, and on 2 x 1 through
    the CLI: greedy tokens equal phase 3's one-card tokens, K8 launched
    decode steps x 26 on every rank; on 1 x 2, with the vocab cut, also
    phase S's sampled stream, its tokens equal phase S's; run_one on
    both meshes equal to the pooled tokens; on 2 x 1 a stream at
    max_batch 3 (whole on both data ranks) equal to the one-card
    engine's at max_batch 3. Returns K8's launches per run and rank."""
    import gc
    from repro_torch.configs import get_arch
    from repro_torch.serving import ContinuousEngine, synthetic_requests
    arch = get_arch("gemma2-2b")
    params = arch.init(torch.Generator(device="cuda").manual_seed(0))
    eng = ContinuousEngine(arch, params, max_batch=3, max_len=96,
                           policy="fp32", prefill_bucket=8, block_size=16,
                           attn_kernel="paged")
    del params
    reqs = synthetic_requests(8, arch.cfg.vocab, prompt_len=64,
                              new_tokens=32, seed=0)
    eng.run(reqs)
    b3_tokens = {r.rid: r.generated.tolist() for r in reqs}
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    ranks = serve_ranks()
    launches = {}
    for name in list(SERVE_MESHES) + ["cli"]:
        label = "CLI --mesh 2x1" if name == "cli" else f"engine {name}"
        launches[name if name != "cli" else "cli-2x1"] = []
        for r in ranks:
            x = r["cli"] if name == "cli" else r["runs"][name]
            tokens = {int(k): v for k, v in x["tokens"].items()}
            check(tokens == paged_tokens,
                  f"serving mesh {label} rank {r['rank']}: greedy tokens "
                  f"differ from phase 3's one-card tokens")
            if "sampled_tokens" in x:
                sampled = {int(k): v for k, v in x["sampled_tokens"].items()}
                check(sampled == sampled_tokens,
                      f"serving mesh {label} rank {r['rank']}: sampled "
                      f"tokens differ from phase S's one-card tokens")
                check(x["vocab_rows"] * 2 == 256000 and x["nonfinite"] == 0,
                      f"serving mesh {label} rank {r['rank']}: "
                      f"{x['vocab_rows']} vocab rows, {x['nonfinite']} "
                      f"non-finite steps")
                print(f"serving mesh {label} rank {r['rank']}: "
                      f"{x['vocab_rows']} of 256000 vocab rows; the "
                      f"sampled stream ({SAMPLER_ARGV[1]}) equals phase "
                      f"S's tokens")
            check(x["launches"] == x["decode_steps"] * N_LAYERS,
                  f"serving mesh {label} rank {r['rank']}: K8 launched "
                  f"{x['launches']} times for {x['decode_steps']} decode "
                  f"steps x {N_LAYERS}")
            if "run_one" in x:
                check(x["run_one"] == [paged_tokens[0], paged_tokens[1]],
                      f"serving mesh {label} rank {r['rank']}: run_one's "
                      f"tokens differ from the pooled stream's")
                print(f"serving mesh {label} rank {r['rank']}: run_one "
                      f"(requests 0 and 1 at batch 1) equals the pooled "
                      f"stream's tokens")
            if "b3_tokens" in x:
                b3 = {int(k): v for k, v in x["b3_tokens"].items()}
                check(b3 == b3_tokens and x["b3_block"] == 3,
                      f"serving mesh {label} rank {r['rank']}: max_batch 3 "
                      f"tokens differ from the one-card engine's (block "
                      f"{x['b3_block']})")
                print(f"serving mesh {label} rank {r['rank']}: max_batch 3 "
                      f"(all 3 slots on each data rank) equals the "
                      f"one-card engine's tokens")
            launches[name if name != "cli" else "cli-2x1"].append(
                x["launches"])
            if name == "cli":
                continue
            data, model = SERVE_MESHES[name]
            # a rank's share of the data blocks' K and V: exactly 1 / (D M)
            check(x["data_block_bytes"] * data * model
                  == x["one_data_block_bytes"],
                  f"serving mesh {name} rank {r['rank']}: data-block K/V "
                  f"bytes {x['data_block_bytes']} are not 1/{data * model} "
                  f"of one card's {x['one_data_block_bytes']}")
            print(f"serving mesh {name} rank {r['rank']}: arena bytes "
                  f"(K, V, positions) {x['arena_bytes']} = "
                  f"{x['arena_bytes'] / x['one_arena_bytes']:.4f} x one "
                  f"card's {x['one_arena_bytes']}; data-block K/V bytes "
                  f"{x['data_block_bytes']} = 1/{data * model} of one "
                  f"card's (a 2 x 1 rank adds its own null block, a 1 x 2 "
                  f"rank keeps every position); KV heads {x['kv_heads']}, "
                  f"peak "
                  f"{x['peak_gb']:.2f} GB, decode step median "
                  f"{x['step_ms']:.2f} ms, collective {x['collective_ms']:.2f}"
                  f" ms per step (gloo through the host), K8 "
                  f"{x['launches']} = {x['decode_steps']} x {N_LAYERS}")
        print(f"serving mesh {label}: greedy tokens equal phase 3's on both "
              f"ranks")
    return launches


# phase D(g): name: (arch, attn_kernel, K8 launches per decode step)
SPLIT_SERVE = {"granite-1x2": ("granite-moe-3b-a800m", "paged",
                               GRANITE_LAYERS),
               "mamba2-1x2": ("mamba2-130m", None, 0)}


def split_leaf(path):
    """The kind of a param leaf that a model axis of two cuts in serving
    (what it leaves whole: None): expert stacks, vocab tables, Mamba
    out_proj rows, Mamba in_proj / conv_w columns."""
    parts = path.split("/")
    if parts[-1] in ("up", "gate", "down"):
        return "expert"                 # (P, E, din, dout): no /kernel
    if path in ("embed/embedding", "lm_head/kernel"):
        return "vocab"
    if parts[-2:] == ["out_proj", "kernel"]:
        return "out_proj"
    if parts[-2:] == ["in_proj", "kernel"] or parts[-1] == "conv_w":
        return "columns"
    return None


def split_bytes(arch, params):
    """{kind: [this rank's bytes, one card's, what the rank should hold]}
    of the leaves split_leaf names: half of one card's (a vocab that two
    ranks do not divide: all of it), the rank's columns of in_proj and
    conv_w (its heads' z, x, dt; B and C whole)."""
    from repro_torch.core.optim.base import tree_items
    from repro_torch.distributed.sharding import (mamba_segments,
                                                  segment_columns)
    whole = dict(tree_items(arch.abstract_params()))
    out = {}
    for path, t in tree_items(params):
        kind = split_leaf(path)
        if kind is None:
            continue
        size = t.element_size()
        one = whole[path].numel() * size
        if kind == "columns":
            leaf = "conv_w" if path.endswith("conv_w") else "in_proj"
            cols = len(segment_columns(mamba_segments(leaf, arch.mamba, 2),
                                       2, 0))
            want = one // whole[path].shape[-1] * cols
        elif kind == "vocab" and arch.cfg.vocab % 2:
            want = one
        else:
            want = one // 2
        acc = out.setdefault(kind, [0, 0, 0])
        for i, v in enumerate((t.numel() * size, one, want)):
            acc[i] += v
    return out


def split_serve_run(torch, name, timer):
    """One run of phase D(g) on this rank: the arch of SPLIT_SERVE[name]
    at full width and depth on 1 x 2, fp32, (e)'s stream after a warm-up
    stream, the whole params freed once the engine holds its parts;
    returns its numbers."""
    import gc
    import statistics
    from repro_torch.configs import get_arch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.serving import ContinuousEngine, synthetic_requests
    arch_name, kernel, _ = SPLIT_SERVE[name]
    arch = get_arch(arch_name)
    mesh = make_local_mesh(data=1, model=2, device="cuda")
    params = arch.init(torch.Generator(device="cuda").manual_seed(0))

    def engine():       # the CLI's engine of phase M, on the mesh
        return ContinuousEngine(arch, params, max_batch=4, max_len=96,
                                policy="fp32", mesh=mesh, prefill_bucket=8,
                                block_size=16, attn_kernel=kernel)

    def stream(n, new):
        return synthetic_requests(n, arch.cfg.vocab, prompt_len=64,
                                  new_tokens=new, seed=0)
    engine().run(stream(2, 4))
    eng = engine()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    step_ms, coll_ms = [], []
    real = eng._step

    def timed(*a, **k):
        torch.cuda.synchronize()
        timer["ms"] = 0.0
        t0 = time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        coll_ms.append(timer["ms"])
        return out
    eng._step = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reqs = stream(8, 32)
    pa.paged_attention_fused.launches = 0
    eng.run(reqs)
    launches = pa.paged_attention_fused.launches
    state = [s for s in eng.pool.cache["slots"] if "ssm" in s]
    out = dict(tokens={r.rid: r.generated.tolist() for r in reqs},
               launches=launches, decode_steps=eng.steps_run,
               step_ms=statistics.median(step_ms),
               collective_ms=statistics.mean(coll_ms),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               bytes=split_bytes(arch, eng.params),
               vocab_rows=eng.params["embed"]["embedding"].shape[0],
               ssm=list(state[0]["ssm"].shape) if state else None,
               nonfinite=eng.report(1.0)["nonfinite_logit_steps"])
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_serve_split(torch, one_card):
    """Phase D(g): granite-moe-3b-a800m and mamba2-130m served on 1 x 2
    (two gloo processes on the one card), each rank computing its
    experts, vocab rows and Mamba heads: greedy tokens equal phase M's
    one-card tokens (`one_card`), K8 launched decode steps x 32 on each
    rank for granite and never for mamba2, each rank's cut leaves at
    half of one card's bytes (in_proj / conv_w at its columns'). Returns
    K8's launches per run and rank."""
    ranks = serve_ranks(list(SPLIT_SERVE))
    launches = {}
    for name, (arch_name, _, per_step) in SPLIT_SERVE.items():
        fam = name.split("-")[0]
        launches[name] = []
        for r in ranks:
            x = r["runs"][name]
            tokens = {int(k): v for k, v in x["tokens"].items()}
            check(tokens == one_card[fam],
                  f"split serving {name} rank {r['rank']}: greedy tokens "
                  f"differ from phase M's one-card tokens")
            check(x["launches"] == x["decode_steps"] * per_step,
                  f"split serving {name} rank {r['rank']}: K8 launched "
                  f"{x['launches']} times for {x['decode_steps']} decode "
                  f"steps x {per_step}")
            check(x["nonfinite"] == 0,
                  f"split serving {name} rank {r['rank']}: "
                  f"{x['nonfinite']} non-finite steps")
            for kind, (mine, one, want) in x["bytes"].items():
                check(mine == want,
                      f"split serving {name} rank {r['rank']}: {kind} "
                      f"bytes {mine}, want {want} of one card's {one}")
            launches[name].append(x["launches"])
            sizes = "; ".join(
                f"{kind} {mine} of one card's {one} bytes "
                f"({mine / one:.4f})"
                for kind, (mine, one, _) in sorted(x["bytes"].items()))
            print(f"split serving {name} rank {r['rank']}: {sizes}; vocab "
                  f"rows {x['vocab_rows']}, SSM state {x['ssm']}; peak "
                  f"{x['peak_gb']:.2f} GB, decode step median "
                  f"{x['step_ms']:.2f} ms, collective "
                  f"{x['collective_ms']:.2f} ms per step (gloo through the "
                  f"host), K8 {x['launches']} = {x['decode_steps']} x "
                  f"{per_step}")
        print(f"split serving {name}: greedy tokens equal phase M's "
              f"one-card tokens on both ranks")
    return launches


# phase D(h): name: (arch, layers, (data, model), K8 launches per step)
GROUP_SERVE = {"gemma2-1x8": ("gemma2-2b", 2, (1, 8), 2)}


def group_arch(name):
    """The arch of a GROUP_SERVE run: its layers (one period) at full
    width."""
    import dataclasses
    from repro_torch.configs import get_arch
    arch_name, layers, _, _ = GROUP_SERVE[name]
    arch = get_arch(arch_name)
    return dataclasses.replace(arch, cfg=dataclasses.replace(
        arch.cfg, n_layers=layers))


def attention_bytes(tree):
    """{"wq/wk/wv": bytes, "wo": bytes} of the attention kernels of a
    params tree (its meta or real leaves)."""
    from repro_torch.core.optim.base import tree_items
    out = {"wq/wk/wv": 0, "wo": 0}
    for path, t in tree_items(tree):
        parts = path.split("/")
        if parts[-1] == "kernel" and parts[-2] in ("wq", "wk", "wv", "wo"):
            key = "wo" if parts[-2] == "wo" else "wq/wk/wv"
            out[key] += t.numel() * t.element_size()
    return out


def group_engine(torch, name, mesh=None, max_batch=4):
    """(D(h)'s engine of GROUP_SERVE[name] on `mesh` or one card, its
    stream): (e)'s engine (fp32, K8, block 16) at the run's depth, after
    a warm-up stream; the whole params freed once it holds its parts."""
    import gc
    from repro_torch.serving import ContinuousEngine, synthetic_requests
    arch = group_arch(name)
    params = arch.init(torch.Generator(device="cuda").manual_seed(0))

    def engine():
        return ContinuousEngine(arch, params, max_batch=max_batch,
                                max_len=96, policy="fp32", mesh=mesh,
                                prefill_bucket=8, block_size=16,
                                attn_kernel="paged")

    def stream(n, new):
        return synthetic_requests(n, arch.cfg.vocab, prompt_len=64,
                                  new_tokens=new, seed=0)
    engine().run(stream(2, 4))
    eng = engine()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return eng, stream(8, 32)


def group_serve_run(torch, name, timer):
    """One rank of phase D(h)'s serving: GROUP_SERVE[name] on its mesh,
    (e)'s stream; returns its numbers."""
    import gc
    import statistics
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch.mesh import make_local_mesh
    data, model = GROUP_SERVE[name][2]
    mesh = make_local_mesh(data=data, model=model, device="cuda")
    eng, reqs = group_engine(torch, name, mesh)
    step_ms, coll_ms = [], []
    real = eng._step

    def timed(*a, **k):
        torch.cuda.synchronize()
        timer["ms"] = 0.0
        t0 = time.perf_counter()
        out = real(*a, **k)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        coll_ms.append(timer["ms"])
        return out
    eng._step = timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pa.paged_attention_fused.launches = 0
    eng.run(reqs)
    out = dict(tokens={r.rid: r.generated.tolist() for r in reqs},
               launches=pa.paged_attention_fused.launches,
               decode_steps=eng.steps_run,
               step_ms=statistics.median(step_ms),
               collective_ms=statistics.mean(coll_ms),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9,
               kv_bytes=arena_bytes(eng.pool, data_only=True),
               kv_heads=eng.pool.cache["slots"][0]["k"].shape[-2],
               attention=attention_bytes(eng.params),
               nonfinite=eng.report(1.0)["nonfinite_logit_steps"])
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_head_groups(torch, mesh_launches):
    """Phase D(h): gemma2-2b (full width, one period of 2 layers) on a 1
    x 8 mesh, eight gloo processes on the one card; its 8 heads and 4 KV
    heads do not divide over 8 ranks, so attention runs in 4 head groups
    of 2 ranks (distributed/sharding.py: head_groups). Serving ((e)'s
    stream): greedy tokens equal the one-card engine's at the same
    depth, K8 launched decode steps x 2 on every rank, a rank's K/V
    arena and wq / wk / wv bytes exactly 1/4 of one card's, its wo bytes
    1/8. Training: one fused_lans step (phase_mesh's GROUP_RUNS, its
    launches added to `mesh_launches`) against the one process that
    splits the heads as the ranks do. Returns K8's launches per rank."""
    import gc
    from repro_torch.serving import PagedCachePool
    t0 = time.perf_counter()
    launches = {}
    for name, (_, layers, (data, model), per_step) in GROUP_SERVE.items():
        eng, reqs = group_engine(torch, name)
        eng.run(reqs)
        one_tokens = {r.rid: r.generated.tolist() for r in reqs}
        one_kv = arena_bytes(PagedCachePool(eng.arch, 4, 96, block_size=16,
                                            device="meta"), data_only=True)
        one_attention = attention_bytes(eng.params)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        groups = 4                       # gcd(8, 8 heads, 4 KV heads)
        ranks = serve_ranks([name], world=data * model)
        launches[name] = []
        for r in ranks:
            x = r["runs"][name]
            where = f"head groups serving {name} rank {r['rank']}"
            tokens = {int(k): v for k, v in x["tokens"].items()}
            check(tokens == one_tokens, f"{where}: greedy tokens differ "
                                        f"from the one-card engine's")
            check(x["launches"] == x["decode_steps"] * per_step,
                  f"{where}: K8 launched {x['launches']} times for "
                  f"{x['decode_steps']} decode steps x {per_step}")
            check(x["nonfinite"] == 0, f"{where}: {x['nonfinite']} "
                                       f"non-finite steps")
            check(x["kv_bytes"] * groups == one_kv,
                  f"{where}: K/V arena bytes {x['kv_bytes']} are not "
                  f"1/{groups} of one card's {one_kv}")
            for kind, share in (("wq/wk/wv", groups), ("wo", model)):
                check(x["attention"][kind] * share == one_attention[kind],
                      f"{where}: {kind} bytes {x['attention'][kind]} are "
                      f"not 1/{share} of one card's {one_attention[kind]}")
            launches[name].append(x["launches"])
            print(f"{where}: K/V arena bytes {x['kv_bytes']} = 1/{groups} "
                  f"of one card's {one_kv} (KV heads {x['kv_heads']}); "
                  f"wq/wk/wv {x['attention']['wq/wk/wv']} = 1/{groups} and "
                  f"wo {x['attention']['wo']} = 1/{model} of one card's "
                  f"{one_attention['wq/wk/wv']} / {one_attention['wo']} "
                  f"bytes; peak {x['peak_gb']:.2f} GB, decode step median "
                  f"{x['step_ms']:.2f} ms, collective "
                  f"{x['collective_ms']:.2f} ms per step (gloo through the "
                  f"host), K8 {x['launches']} = {x['decode_steps']} x "
                  f"{per_step}")
        print(f"head groups serving {name}: greedy tokens equal the "
              f"one-card engine's at {layers} layers on all "
              f"{data * model} ranks")
    print(f"phase D(h) serving: {time.perf_counter() - t0:.1f} s")
    mesh_launches.update(phase_mesh(torch, GROUP_RUNS))
    print(f"phase D(h): {time.perf_counter() - t0:.1f} s")
    return launches


def shard_rows(kops, n_shards, lamb_clip=None, step=4):
    rows = []
    for _ in range(n_shards):
        rows.append(kops.lans_scalars(0.02, step, beta1=0.9, beta2=0.999,
                                      lam=0.01, apply_trust=True,
                                      device="cuda") if lamb_clip is None
                    else kops.lamb_scalars(0.02, step, lamb_clip, beta1=0.9,
                                           beta2=0.999, lam=0.01,
                                           apply_trust=True, device="cuda"))
    return rows


def sharded_lans(torch, kl, kops, g, m, v, x, n_shards, lp=None):
    """K1, K2 and K3 (K4 with lp) on n_shards contiguous shards of one
    leaf, the partial sums added between the phases as the ranks of a
    mesh add them. Returns (K1's summed g_sq, K2's summed norms, [x, m,
    v(, x_lp)] concatenated)."""
    kw = dict(beta1=0.9, eps=1e-6)
    cuts = [t.chunk(n_shards) for t in (g, m, v, x)]
    rows = shard_rows(kops, n_shards)
    g_sq = sum(kl.sq_norm(gs) for gs in cuts[0])
    for row in rows:
        row[5] = g_sq
    p1 = [kl.lans_phase1(row, gs, ms, vs, xs, beta2=0.999, **kw)
          for row, gs, ms, vs, xs in zip(rows, *cuts)]
    norms = sum(p[2] for p in p1)
    outs = []
    for row, gs, xs, (m1, v1, _) in zip(rows, cuts[0], cuts[3], p1):
        if lp is None:
            outs.append((kl.lans_phase2(row, norms, gs, m1, v1, xs, **kw),
                         m1, v1))
        else:
            xm, xlp = kl.lans_phase2_cast(row, norms, gs, m1, v1, xs,
                                          lp_dtype=lp, **kw)
            outs.append((xm, m1, v1, xlp))
    return g_sq, norms, [torch.cat(parts) for parts in zip(*outs)]


def sharded_lamb(torch, kl, kb, kops, g, m, v, x, n_shards):
    """K1 on the shards for the clip's sum of squares, K5 on each shard,
    its norms added, K6 on each shard. Returns (K1's summed sum of
    squares, K5's summed norms, [x, m, v] concatenated)."""
    from repro_torch.core.optim.lamb import clip_factor
    cuts = [t.chunk(n_shards) for t in (g, m, v, x)]
    g_sq = sum(kl.sq_norm(gs) for gs in cuts[0])
    rows = shard_rows(kops, n_shards, lamb_clip=clip_factor(g_sq, 1.0))
    p1 = [kb.lamb_phase1(row, gs, ms, vs, xs, beta1=0.9, beta2=0.999,
                         eps=1e-6) for row, gs, ms, vs, xs in zip(rows, *cuts)]
    norms = sum(p[2] for p in p1)
    outs = [(kb.lamb_phase2(row, norms, m1, v1, xs, eps=1e-6), m1, v1)
            for row, xs, (m1, v1, _) in zip(rows, cuts[3], p1)]
    return g_sq, norms, [torch.cat(parts) for parts in zip(*outs)]


def phase_shards(torch, kl, kb, kops):
    """Phase D(c): the sharded-leaf contract on the card. BERT-large's
    largest leaf cut into 2 and 4 shards: K1-K3, K1/K2/K4 (bf16 copy)
    and K1/K5/K6 on the shards, their partial sums added, equal to the
    whole leaf's run within 2e-5; each shard's kernels timed beside their
    byte bounds. Returns {kernel: {shards: entry}}."""
    t0 = time.perf_counter()
    n = LARGEST_LEAF
    g, m, v, x = kl.lans_case(n, torch.float32, seed=11, device="cuda")
    runs = {
        "lans": lambda k: sharded_lans(torch, kl, kops, g, m, v, x, k),
        "cast": lambda k: sharded_lans(torch, kl, kops, g, m, v, x, k,
                                       torch.bfloat16),
        "lamb": lambda k: sharded_lamb(torch, kl, kb, kops, g, m, v, x, k)}
    # each output under the kernel that computes it: K1's sums, K2's
    # (K5's) summed norms and m, v, K3's (K4's, K6's) x
    owners = {"lans": ("sq_norm", "lans_phase1", "lans_phase2"),
              "cast": ("sq_norm", "lans_phase1", "lans_phase2_cast"),
              "lamb": ("sq_norm", "lamb_phase1", "lamb_phase2")}
    tol = LANS_TOL["fp32"]
    err = {}                               # {kernel: {shards: max |diff|}}
    for kind, run in runs.items():
        whole_sq, whole_norms, whole_out = run(1)
        k1, k2, k3 = owners[kind]
        for k in (2, 4):
            e = dict.fromkeys(owners[kind], 0.0)
            g_sq, norms, out = run(k)
            where = f"{kind}, {k} shards"
            close(torch, e, k1, g_sq, whole_sq, tol, where)
            close(torch, e, k2, norms, whole_norms, tol, where)
            for a, b in zip(out[1:3], whole_out[1:3]):     # m, v
                close(torch, e, k2, a, b, tol, where)
            close(torch, e, k3, out[0], whole_out[0], tol, where)
            if kind == "cast":
                close(torch, e, k3, out[3], whole_out[3], LANS_TOL["bf16"],
                      f"{where}, bf16 copy")
            for name, x_err in e.items():
                cell = err.setdefault(name, {})
                cell[str(k)] = max(cell.get(str(k), 0.0), x_err)
            del out
        del whole_out
    torch.cuda.synchronize()
    print("shards: K1-K3, K1/K2/K4 and K1/K5/K6 on 2 and 4 shards of the "
          f"{n}-element leaf, partial sums added, vs the whole leaf: max "
          "|diff| " + "; ".join(
              f"{name} " + ", ".join(f"{k} shards {e:.3e}"
                                     for k, e in cells.items())
              for name, cells in err.items())
          + " (gate 2e-5 + 2e-5 |whole|, so relative for K1's sums and "
          "K2's / K5's norms, sums over 1e8 squares; K4's bf16 copy 2e-2)")
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    kw = dict(beta1=0.9, eps=1e-6)
    out = {}
    for k in (2, 4):
        s = n // k
        gs, ms, vs, xs = (t[:s] for t in (g, m, v, x))
        row = shard_rows(kops, 1)[0]
        row[5] = kl.sq_norm(gs)
        m1, v1, norms = kl.lans_phase1(row, gs, ms, vs, xs, beta2=0.999,
                                       **kw)
        lrow = shard_rows(kops, 1, lamb_clip=0.3)[0]
        bm, bv, bnorms = kb.lamb_phase1(lrow, gs, ms, vs, xs, beta1=0.9,
                                        beta2=0.999, eps=1e-6)
        calls = {
            "sq_norm": lambda: kl.sq_norm(gs),
            "lans_phase1": lambda: kl.lans_phase1(
                row, gs, ms, vs, xs, beta2=0.999, **kw),
            "lans_phase2": lambda: kl.lans_phase2(
                row, norms, gs, m1, v1, xs, **kw),
            "lans_phase2_cast": lambda: kl.lans_phase2_cast(
                row, norms, gs, m1, v1, xs, lp_dtype=torch.bfloat16, **kw),
            "lamb_phase1": lambda: kb.lamb_phase1(
                lrow, gs, ms, vs, xs, beta1=0.9, beta2=0.999, eps=1e-6),
            "lamb_phase2": lambda: kb.lamb_phase2(
                lrow, bnorms, bm, bv, xs, eps=1e-6),
        }
        for name, fn in calls.items():
            ms_ = time_ms(fn, flush, n=10)
            nbytes = kernel_cost(name, gs, xs)[1]
            bytes_per = nbytes // s
            bound = bytes_ms(nbytes)
            out.setdefault(name, {})[str(k)] = dict(
                n=s, ms=ms_, bound_ms=bound, bound_by="bytes",
                max_abs_err=err[name][str(k)])
            print(f"shards: {name} on 1 of {k} shards ({s} fp32 elements, "
                  f"L2 evicted): {ms_:.4f} ms, bound {bound:.4f} ms "
                  f"({bytes_per} B/element at 3.35 TB/s), bound / time "
                  f"{bound / ms_:.2f}")
    del flush, g, m, v, x
    torch.cuda.empty_cache()
    print(f"phase D(c): {time.perf_counter() - t0:.1f} s")
    return out


def run() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = os.path.join(ROOT, "src")
    if not os.path.isdir(os.path.join(src, "repro_torch")):
        print(f"chip_smoke: {src}/repro_torch not found beside this script",
              file=sys.stderr)
        return 3
    sys.path.insert(0, src)
    from repro_torch import select_device
    from repro_torch.configs import get_arch
    from repro_torch.kernels import build
    from repro_torch.kernels import lamb as kb
    from repro_torch.kernels import lans as kl
    from repro_torch.kernels import ops as kops
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.launch import serve as serve_mod

    select_device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {len(libs)} kernel libraries ({', '.join(libs)}) in "
          f"{time.perf_counter() - t0:.2f} s")
    for name in libs:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas[{name}]: {line.strip()}")

    paged_entries = phase_kernels(torch, pa)
    if "--paged-only" in sys.argv[1:]:
        print(card_line())
        print(json.dumps({"paged_kernels": list(paged_entries.values())}))
        return 0
    kernel = paged_entries["paged_attention_fused"]

    warm_argv = list(SERVE_ARGV)
    warm_argv[warm_argv.index("--requests") + 1] = "2"
    warm_argv[warm_argv.index("--new-tokens") + 1] = "4"
    serve_mod.main(warm_argv)
    print("serve: warm-up stream done (2 requests, 4 new tokens)")
    pa.paged_attention_fused.launches = 0
    paged, paged_tokens = serve(serve_mod, SERVE_ARGV, "fp32 paged")
    kernel["launches"] = pa.paged_attention_fused.launches
    n_layers = N_LAYERS
    check(kernel["launches"] == paged["decode_steps"] * n_layers,
          f"kernel launched {kernel['launches']} times for "
          f"{paged['decode_steps']} decode steps x {n_layers} layers")
    xla_argv = list(SERVE_ARGV)
    xla_argv[xla_argv.index("paged")] = "xla"
    before = pa.paged_attention_fused.launches
    _, xla_tokens = serve(serve_mod, xla_argv, "fp32 xla")
    check(pa.paged_attention_fused.launches == before,
          "the xla path launched the kernel")
    check(paged_tokens == xla_tokens,
          "greedy tokens differ between --attn-kernel paged and xla")
    print(f"serve: paged == xla greedy tokens for {len(paged_tokens)} "
          f"requests; kernel launches {kernel['launches']} = "
          f"{paged['decode_steps']} decode steps x {n_layers}")
    before = pa.paged_attention_fused.launches
    _, interp_tokens = serve(serve_mod, SERVE_ARGV + ["--interpret"],
                             "fp32 paged --interpret")
    check(pa.paged_attention_fused.launches == before,
          "--interpret launched the kernel")
    check(interp_tokens == paged_tokens,
          "greedy tokens differ between --interpret and the kernel path")
    print(f"serve: --interpret (K8's plain version on the card) == kernel "
          f"path greedy tokens, K8 launches unchanged at {before}")
    bf16_argv = list(SERVE_ARGV)
    bf16_argv[bf16_argv.index("fp32")] = "bf16"
    serve(serve_mod, bf16_argv, "bf16 paged")
    torch.cuda.empty_cache()
    flush = torch.empty(256 * 2 ** 20, dtype=torch.uint8, device="cuda")
    kernel["spec_verify"], sampled_tokens = phase_spec(
        torch, pa, serve_mod, paged, paged_tokens, flush)
    torch.cuda.empty_cache()
    kernel["chunked_serving"] = phase_chunked(torch, pa, serve_mod, flush)
    torch.cuda.empty_cache()
    moe_mamba = phase_moe_mamba(torch, pa, serve_mod, flush, paged_tokens)
    one_card_tokens = moe_mamba.pop("tokens")
    kernel.update(moe_mamba["paged_attention_fused"])
    paged_entries["paged_attention"].update(moe_mamba["paged_attention"])
    del flush
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    whisper_serving(torch, serve_mod)
    bert_scoring(torch, serve_mod)
    enc_launches, enc_times, enc_errs = whisper_training(torch, kl, kops)
    print(f"phase E: {time.perf_counter() - t0:.1f} s")

    errs = lans_parity(torch, kl, kops)
    times = lans_timing(torch, kl, kops, errs)
    fused_step_timing(torch, get_arch("bert-large"), kops)
    torch.cuda.empty_cache()
    errs.update(lamb_parity(torch, kl, kb, kops))
    times.update(lamb_timing(torch, kl, kb, kops, errs))
    fused_lamb_timing(torch, get_arch("bert-large"))
    torch.cuda.empty_cache()
    fp32_launches, bf16_launches, bert_analysis = train_routes(torch, kl)
    lamb_launches = lamb_routes(torch, kl, kb)
    t0 = time.perf_counter()
    (dec_fp32, dec_bf16, dec_times, dec_errs, dec_update,
     dec_analysis) = decoder_routes(torch, kl, kops)
    print(f"phase T: {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    router_launches = phase_router(torch, pa, serve_mod)
    print(f"phase D(a): {time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    mesh_launches = phase_mesh(torch)
    t1 = time.perf_counter()
    kernel["mesh"] = phase_serve_mesh(torch, paged_tokens, sampled_tokens)
    print(f"phase D(e): {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    kernel["mesh"]["split-1x2"] = phase_serve_split(torch, one_card_tokens)
    print(f"phase D(g): {time.perf_counter() - t1:.1f} s")
    kernel["mesh"].update(phase_head_groups(torch, mesh_launches))
    shards = phase_shards(torch, kl, kb, kops)
    print(f"phase D: {time.perf_counter() - t0:.1f} s")
    kernel["router"] = dict(launches=router_launches)
    decoder = {"sq_norm": dec_fp32, "lans_phase1": dec_fp32,
               "lans_phase2": dec_fp32, "lans_phase2_cast": dec_bf16}
    # name: (TPU source, launches of its main path)
    optim = {
        "sq_norm": ("lans_kernel.py:68", fp32_launches),
        "lans_phase1": ("lans_kernel.py:122", fp32_launches),
        "lans_phase2": ("lans_kernel.py:207", fp32_launches),
        "lans_phase2_cast": ("lans_kernel.py:228", bf16_launches),
        "lamb_phase1": ("lamb_kernel.py:54", lamb_launches),
        "lamb_phase2": ("lamb_kernel.py:101", lamb_launches),
    }
    entries = [kernel, paged_entries["paged_attention"]]
    for name, (line, launches) in optim.items():
        cu = "lamb.cu" if name.startswith("lamb") else "lans.cu"
        entries.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{cu}",
            replaces=f"src/repro/kernels/{line}",
            launches=launches[name], max_abs_err=errs[name],
            **times[name]))
        if name in decoder:     # phase T: gemma2-2b's embedding leaf
            entries[-1]["decoder"] = dict(
                n=EMBED_LEAF, launches=decoder[name][name],
                max_abs_err=dec_errs[name], **dec_times[name])
        entries[-1]["shards"] = shards[name]     # phase D(c)
        if name in mesh_launches["2x1"]:    # phases D(b), D(d), per rank
            entries[-1]["mesh"] = {run: dict(launches=counts[name])
                                   for run, counts in mesh_launches.items()}
        if name in ("sq_norm", "lans_phase1", "lans_phase2"):
            # phase E(c): whisper-large-v3's largest leaf
            entries[-1]["whisper"] = dict(
                n=WHISPER_LEAF, launches=enc_launches[name],
                max_abs_err=enc_errs[name], **enc_times[name])
    next(e for e in entries if e["name"] == "sq_norm")["decoder"][
        "whole_update"] = dec_update

    for label, a in (("bert-large", bert_analysis),
                     ("gemma2-2b", dec_analysis)):
        busy = ("not measured" if a["tflops_busy"] is None
                else f"{a['tflops_busy']:.2f}")
        print(f"phase A summary[{label}]: FLOPs by dtype "
              + ", ".join(f"{k} {v:.4e}"
                          for k, v in a["flops_by_dtype"].items())
              + f"; step wall {[round(t, 3) for t in a['wall_ms']]} ms; "
              f"MFU {a['mfu']:.4f} (bf16 / fp16 at 989 TFLOP/s, fp32 at "
              f"67); {a['tflops_wall']:.2f} TFLOP/s over the wall, {busy} "
              f"over the busy {a['busy_ms']} ms; roofline share "
              f"{a['roofline_share']:.4f} ({a['roofline']['dominant']}); "
              f"peak memory predicted {a['predicted_peak'] / 1e9:.3f} GB / "
              f"measured {a['max_allocated'] / 1e9:.3f} GB = "
              f"{a['predicted_peak'] / a['max_allocated']:.4f}")
    print(card_line())
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    try:
        return run()
    except Exception:              # report the failure, exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
