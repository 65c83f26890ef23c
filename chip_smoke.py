"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Drives the port's serving, update, LM-generation (dense, MoE, SSM, audio
and VLM), LM-training and multi-process mesh paths the way a user does
and holds every kernel to its plain PyTorch version on the card.
Phases, in order; any failure exits non-zero:

  1. build    compile ``src/repro_torch/kernels/csrc/*.cu`` (nvcc, sm_90a,
              one nvcc per source, all at once); each kernel's ptxas
              registers and spills, and HGMMA in the SASS of every bf16
              SWA backward kernel (``cuobjdump -sass``); the eighteen
              selective-scan forward instances (d_state x dtype x bare /
              fused / fused writing its tile states) and its six backward
              ones (d_state x dtype), with their SASS opcode counts, none
              of which may spill
  2. kernels  the top-k kernel against its plain version: the edge grid,
              exact duplicate rows, N in {40k, 100k} x Q in {1, 32, 64} x
              k in {1, 10, 64, 65, 2000, N}, streamed and device-resident,
              1024-row slabs (40 slabs at 40k; at Q = 1 and k = 2000 the
              running list outgrows the slab), one k = 2000 slab step (3
              launches), a device-resident k = 300 call at 100k rows
              (13 sub-slabs, 13 merges), device-resident k = 10 and 64
              calls at 100k rows with every row repeated (2 launches, ties
              to the lower index exactly), and one k = 100 slab step of
              65,536 queries, past the grid's y limit
  3. kge      the kge_score forward and backward kernels against their
              plain versions: TransE-L1/L2 and DistMult x (B, K, d) in
              {(1024, 32, 200), (100, 5, 200), (7, 3, 32), (1, 1, 1),
              (3, 7, 13), (4, 8192, 200), (2, 64, 4096)} x masks
              all-true/all-false/random, with and without t = h + r; the
              backward's staging paths (one bulk copy a slab, 4-byte
              cp.async, the two-stage ring, column tiles) and every input
              one float off 16-byte alignment; two backward launches give
              the same bits
  4. swa      the sliding-window attention kernel against its plain
              version, fp32 and bf16: the reference's test shapes, reduced
              h2o-danube (with and without padded kv groups), q_offset with
              Sq < Skv, W = 1, W >= S, ragged S, one full h2o-danube
              layer (S 6144, W 4096, d 80) on 4 heads, and the tile plan's
              edges (ragged Sq with q_offset, W and Skv not multiples of
              the key tile, d = 128, 16 and 32) and the bf16 dK/dV
              tiling's (a 128-key CTA half past Skv, group 1 and 8, d =
              16, 32 and 128 at W not a multiple of 64), and full causal
              attention as a window over every key (one olmoe-1b-7b layer:
              B 2, 16 heads, S 2048, W 2048, d 128; W = q_offset + Sq
              with q_offset > 0; whisper-base's decoder, 8 heads of 64,
              at its 64-token prompt and its 448-token cap; one
              llava-next-34b layer, 56 q heads over 8 kv heads of 128,
              over 2,880 image + 64 text tokens), and head dim 256
              (recurrentgemma-2b's layer, 10 q heads over 1 kv head, S
              4,096, W 2,048; ragged S, q_offset with Sq < Skv, W 77, one
              query, W >= S); on each, the
              forward's log-sum-exp and the three backward kernels
              (bwd_dot, backward_dkdv, backward_dq) on the plain forward's
              saved tensors, and two backward launches bit for bit on a
              few (on every d = 256 case); the build phase records every
              d = 256 instance's registers and spills
     scan     the selective-scan kernel's three entry points against their
              plain versions, fp32 and bf16 inputs: the bare scan on y
              and h_last (rtol = atol = 2e-4), the fused one (dt's bias
              and softplus, the D skip, the silu(z) gate, z a strided half
              of in_proj's output) on h_last and out (the same, plus one
              bf16 ulp on a bf16 out), the fused one with its tile states
              (the same bits as without), and the fused one's backward on
              every gradient: ddt, dxc, dz, dh0 as the forward's out,
              dA, dD, ddt_bias, dBm, dCm within 2e-4 * max|plain| (+ one
              bf16 ulp in bf16); d_state 4 and 8 at S 24, 33, 300 and 1,
              and one falcon-mamba-7b layer (B 2, S 2048, d_in 8192,
              d_state 16) from h0 != 0, each launched twice (the same
              bits); two cases from a gradient of h_last; a gradient asked
              of the fused entry point runs its forward and backward
              kernels, one asked of the bare scan raises
  5. serve    two versions of a 40,000 x 200 GO-size snapshot published
              through the port's registry; ``repro_torch.launch.serve``
              in client-session mode, then HTTP over the gateway, every
              answer checked against the plain version
     shard    the sharded serving path, its shards on the one card
              (``ServingMesh.of((cuda:0,) * S)``): a ServingEngine over
              the serve registry with the table row-sharded 4 ways answers
              54 closest-concepts requests (k 10 and 2,000) through the
              Gateway with the unsharded engine's bodies, one top-k step
              a shard a call; the GO table (40,000 x 200; 2 pad rows at 3
              shards) and the SCALE table (100,000 x 200) sharded 4 and 3
              ways, Q 1 and 32, k 10 and 2,000, self-exclusions at shard
              borders: identical to the unsharded kernel call, within
              1e-5 of the plain version (the same function on CPU shards;
              ids under the near-tie rule), ``device_table_bytes()`` the
              shards' bytes; the ms of a sharded and of the streamed 40k
              call (Q 32, k 10); the dry run (``launch.dryrun --all --mesh
              both``) on the meta device
  6. workers  pre-forked serving on the card over the same registry:
              ``launch.serve --http 0`` as one process, then with
              ``--workers 2`` and ``--workers 4``, three HTTP client
              sessions each (``bench_http.run_mp``'s: 16
              keep-alive clients, 2,048 requests, k = 10; fresh rows a
              session), q/s and p50/p99 as median and range, every
              answer against the plain top-k; per pool: the merged /stats
              count, a worker SIGKILLed under load and restarted (no 5xx),
              a new sealed version adopted by every worker, and every
              worker pid (not the parent's) among the card's compute
              processes in ``nvidia-smi``
  7. update   the update path at the GO workload's full width: a 40k-term
              synthetic GO release published by ``Updater.run_once`` with
              the paper's six models (TransE and DistMult through the
              kge_score kernels, each run's step captured as one CUDA
              graph; 3,000 steps a full run: 50 epochs of the triples, a
              cut in depth that keeps the script inside its time limit),
              evolved to v2 and
              updated incrementally, a cold v2 in a second registry,
              closest-concepts for v2 from the engine the updater
              invalidated, and MRR warm against cold per model; graph
              replays per run (the steps less the warm-up); the kge_score
              launches each capture recorded, from this run's own
              counters (one an entry point, as a capture of the same step
              alone records), and the launches on the path (eager steps
              plus replays x that count); TransE's and DistMult's replayed
              step against the eager step over 50 steps (losses within
              1e-4 relative), its wall and device ms, steps/s
  8. jobs     batch-analytics jobs through the port's gateway: a
              knn-join of all 40,000 classes of the serve table at k = 10
              and one of 1,024 at k = 100 (512 and 256 sampled rows equal
              to one serial ``top_k_rows`` call each, bit for bit, and to
              the plain top-k), drift v1 -> v2 of the update registry for
              TransE and DistMult on 4,096 classes (256 Jaccards against
              serial ``top_k_rows``, graph_delta against ``GraphDelta``),
              compare of every model at sample 1,000 ("kge" MRR against
              ``rank_based_eval``, RDF2vec by cosine, then all cached),
              64 ``AsyncGateway`` coroutines against the sync answers,
              the serve session alone and beside a 10,000-class join; over
              ``launch.serve --http 0 --max-jobs-queued 2``: pages with
              304 on their ETags, ``?stream=true``, a running 40k join
              cancelled (409) and the queue bound (429); a pool of 2:
              polls answered by both workers from the shared state dir,
              the owner SIGKILLed mid-join (FAILED) and restarted.  Run
              alone (``--phases build,jobs``) it trains its own v1 and
              v2 with TransE and DistMult at 300 steps
  9. lm       h2o-danube-1.8b at its published width: in fp32 the last
              logits of prefill(6145) against prefill(6144) + decode_step
              (2e-3, same argmax), 24 SWA launches per prefill; then a
              bf16 generation through ``repro_torch.launch.generate``
              (batch 2, prompt 6144, 16 greedy decode steps), ids in vocab;
              the same generation with ``--kv-cache-dtype int8`` (decode ms
              a token and the cache's bytes beside the bf16 cache's); the
              int8 cache against the fp cache in fp32 at full width, cut to
              2 layers (tests/test_int8_kv_cache.py's contract: rtol 0.1,
              atol 0.15, the same top-1)
     moe      olmoe-1b-7b at its published width and depth: in fp32, 2
              layers, capacity factor 16, the last logits of
              prefill(2049) against prefill(2048) + decode_step (2e-3,
              same argmax); then a bf16 generation through
              ``launch.generate`` (batch 2, prompt 2048, 16 greedy decode
              steps): prefill ms, tokens/s, decode ms a token, peak memory,
              16 causal SWA launches per prefill, the dropped (token, slot)
              pairs per prefill and per decode step, beside the expert
              products' and the decode weight read's bounds
     mesh     the multi-process mesh (``launch.mesh.run_world``): a world
              of one rank on NCCL, then two ranks sharing cuda:0 on gloo
              (NCCL refuses two ranks on one device), mesh (data 1, model
              2).  In both, olmoe-1b-7b's fp32 2-layer check at capacity
              factor 16: the expert-parallel prefill's last logits against
              the one-process ``moe_apply``'s (2e-3, same argmax); then,
              on two ranks, the tensor-parallel layout (the reference's
              ``param_pspec``: each rank's heads, ff channels and vocab
              block): fp32, 2 layers at published width, the prefill and
              4 decode steps against the one-process model on the same
              params (2e-3 (1 + |want|), same argmax every step) for
              mistral-large-123b (B 1, prompt 512; 48 q heads and 4 KV
              slots a rank) and h2o-danube-1.8b (a 6,144-token prompt
              past its 4,096 window: the rolling cache cut by slot);
              bf16 mistral-large-123b at the zoo's cut (4 layers), B 2,
              prompt 2048, 16 greedy steps through the prefill and serve
              steps on the mesh: prefill ms, decode ms a token, 4 causal
              SWA launches a prefill, peak memory, the rank's param and
              cache bytes equal to the dry run's per-device bytes
              (``device_bytes`` on the mesh's sizes), one (B S, d)
              all_reduce timed alone (two a layer), the greedy tokens
              that equal the one-process zoo run's (reported); the bf16
              expert-parallel olmoe prefill at published width (B 2,
              prompt 2048, 32 experts a rank, its attention cut too): ms,
              16 causal SWA launches, the (B S, d) all_reduce timed
              alone (two a layer), peak memory, a rank each; a 2-layer fp32 training
              step (B 2, S 512) against the one-process step (loss 1e-5,
              each leaf of the rank's share 2e-4 max|g|), its SWA forward
              and backward launches at d 128; the sharded KGE trainer on
              the GO workload (TransE-L1, DistMult; 20,000 entity rows a
              rank): 3 steps against the one-process eager step on the
              same negatives (loss 1e-5, params 2e-4 max|p|), then 200
              steps, steps/s beside the one-process eager step's, and the
              kge_score launches.  The shared card's times stand for no
              multi-card deployment
     mamba    falcon-mamba-7b at its published width and depth: in fp32,
              2 layers, the last logits of prefill(2049) against
              prefill(2048) + decode_step (2e-3, same argmax), one fused
              scan launch a layer a prefill; then a bf16
              ``launch.generate`` (batch 2, prompt 2048, 16 steps):
              prefill ms, tokens/s, decode ms a token, the state's bytes,
              peak memory, 64 fused scan launches per prefill
     hybrid   recurrentgemma-2b at its published width and depth: in fp32,
              3 layers (two RG-LRU, then local attention at d 256), the
              last logits of prefill(4097) against prefill(4096) +
              decode_step (2e-3, same argmax), one SWA launch a prefill;
              then a bf16 ``launch.generate`` (batch 2, prompt 4,096,
              twice the window, 16 steps): prefill ms, tokens/s, decode
              ms a token, the cache's bytes (RG-LRU states, conv tails,
              rolling KV), peak memory, 8 SWA launches per prefill; the
              RG-LRU scan's time at one layer and over a prefill's and a
              training step's recurrent layers
     whisper  whisper-base at its published width and depth: in fp32,
              1,500 encoder frames, a 65-token decoder prefill against
              64 + decode_step (2e-3, same argmax), 6 causal SWA launches
              (d 64) a prefill; then a bf16 ``launch.generate`` (batch 2,
              1,500 frames, prompt 64, 16 steps)
     llava    llava-next-34b at its published width and depth, in a fresh
              child process (68.8 GB of bf16 weights): in fp32, 2 layers,
              2,880 image embeddings + 65 text tokens against 64 +
              decode_step at position 2,944 (2e-3, same argmax); then a
              bf16 ``launch.generate`` (batch 2, 2,880 image + 64 text
              tokens, 16 steps), 60 causal SWA launches (56 / 8 heads,
              d 128) a prefill; where a prefill's and a decode step's
              device time goes
     zoo      the zoo's four large archs at published width, in a fresh
              child process, one after another (each freed before the
              next): internlm2-20b at all 48 layers, qwen2-72b,
              mistral-large-123b and grok-1-314b cut in depth to 4, 4 and
              2 layers (``ZOO_ARCHS``); each in fp32 at 2 layers, the
              last logits of prefill(2049) against prefill(2048) +
              decode_step (2e-3, same argmax; grok at capacity factor 16,
              B 1, prompt 512, no pair dropped), one SWA launch a layer;
              then a bf16 ``launch.generate --layers`` (batch 2, prompt
              2048, 16 steps): prefill ms, decode ms a token, cache bytes
              and peak memory beside ``serve_specs``' bytes at that depth,
              one causal SWA launch a layer (mistral's 12 q heads a kv
              head), grok's dropped pairs.  ``zoo_deep`` (only when
              named): the same at the deepest depths that fit 63 GB of
              weights and cache, 32, 22 and 6 layers
 10. train    h2o-danube-1.8b training at its published width: in fp32
              two layers (B = 1, S = 6144 > W) with the kernels against the
              same step with the plain SWA forward and backward
              substituted (loss 1e-5 relative, each gradient leaf 2e-4 *
              max|g|); then bf16, 24 layers, remat "full", through
              ``repro_torch.launch.train`` (a 1-step warm-up run, then 3
              measured steps): step ms, tokens/s, peak memory, 48 SWA
              forwards and 24 launches of each backward entry point a
              step, finite losses; 6 steps on one repeated batch, whose
              first 5 losses fall, 1 of them under torch.profiler
              (device-busy share, device ms by kernel group and by host
              op, Adam's passes apart).  Then falcon-mamba-7b
              at its published width: in fp32 two layers (B = 1, S =
              2048) with the kernels against the same step with the
              plain fused scan and its plain backward substituted (the
              same tolerances); then bf16, all 64 layers, remat "full",
              B 2, S 2048, Adam at lr 3e-4, through ``launch.train`` (a
              1-step warm-up run, then 3 measured steps): step ms,
              tokens/s, peak memory, 128 fused scans and 64 backward
              launches a step, finite losses; 6 steps on one repeated
              batch, whose first 5 losses fall, 1 under torch.profiler.  Then
              recurrentgemma-2b: fp32, 3 layers (B 1, S 4,096) with the
              SWA Function swapped for the plain one; bf16, all 26
              layers, remat "full" per period, B 2, S 4,096 (16 SWA
              forwards at d 256 and 8 of each backward entry point a
              step), the same measurements, but its repeated batch's
              first 3 losses fall: Adam at lr 3e-4 overshoots at its
              fourth step on both paths.  Then olmoe-1b-7b: fp32, 2
              layers (B 1, S 2,048, capacity factor 16) with the SWA
              Function swapped, the (token, expert) choices its router
              makes apart in the two steps counted; bf16, all 16 layers,
              remat "full", B 2, S 2,048 (32 SWA forwards and 16 of each
              backward entry point a step), the same measurements, Adam's
              passes, the expert einsums and the MoE's scatter and gather
              apart in the profiled step.  The
              generation runs' 16 decode steps (were 32) and the 3
              measured training steps (were 5) are the depth cut that
              keeps the whole script near 1,000 s
 11. numbers  top-k kernel, plain, library and host-to-device times (CUDA
              events) at N = 40k, Q 1 and 32; kge_score forward and backward
              times at (1024, 32, 200) (back-to-back calls, profiler device
              time, 50 calls replayed from one CUDA graph) and the
              forward wrapper's host time by part; the device-busy share
              of an eager training step by part (torch.profiler); the SWA
              kernel at one h2o-danube layer's shape, bf16 (B = 2, and
              B = 1, the training shape) and fp32, against its bound, its
              plain version and ``scaled_dot_product_attention``, and at
              one olmoe-1b-7b, one llava-next-34b and one
              mistral-large-123b prefill layer's causal shape against
              SDPA ``is_causal``; where the device time of an olmoe-1b-7b
              prefill and decode step goes, and their busy shares; the
              device-busy share of a full-width decode step; the SWA
              backward at one layer's shape (B = 1 and 2, bf16 and fp32),
              and at olmoe-1b-7b's training shape (causal, bf16), against
              its bounds (the function's, the two-kernel
              design's), its plain version and SDPA forward + backward,
              and the forward with its log-sum-exp against without; the
              selective scan at one falcon-mamba-7b layer's shape, bare
              and fused, against its bound (exps on the SFUs, bytes) and
              its plain version, the fused one also against the bare
              kernel with the PyTorch passes it replaces (``unfused``)
              and with its tile states written against without, in
              turns, and the fused one's backward as training runs it
              (kernel, device and plain ms, against its bound: the
              recomputed exps and softplus / sigmoid / silu on the SFUs
              and its fp32 operations against the bytes of its inputs,
              the saved states included, and outputs; the partials' bytes
              beside it, not in it);
              where a falcon-mamba-7b and a whisper-base prefill and
              decode step spend their device time; the SWA kernels at
              d = 256 at one recurrentgemma-2b layer (forward, and
              forward with lse + backward) against their bounds, plain
              versions and SDPA, and where a recurrentgemma-2b prefill and
              decode step spend their device time.
              After other phases it runs in a fresh child process
              (``--phases numbers``), whose profiler sessions read the
              device; every kge, SWA and scan row must carry a device
              time
 12. alloc    only when ``--phases`` names it: host time of the kge_score
              backward's output allocations two ways, in turns: four
              tensors (what the wrapper allocates) against one (3, B, d)
              buffer seen three ways

Run from the repository root with no arguments::

    python3 chip_smoke.py

It prints JSON lines as it goes (a ``{"ended": ..., "seconds": ...}``
line on stdout and stderr as each phase, and each part of the numbers
phase, ends), then the card's name and power limit, the kernels line,
and last ``{"ok": true, "device": {...}}``.
``--phases`` runs a subset (``build,kernels``, ``build,kge``,
``build,swa,lm``, ``build,swa,moe``, ``build,mesh``,
``build,scan,mamba``,
``build,swa,whisper``, ``build,swa,llava``, ``build,swa,hybrid``,
``build,zoo``, ``build,zoo_deep``,
``build,swa,train`` or ``build,scan,train`` (the four training runs)
is a quick check of one slice;
``build,serve,workers``
the serving paths, ``build,shard`` the sharded one; ``--sass-of
SOURCE.cu`` one source's kernels' registers, spills and SASS; ``build,kge,update`` the update path alone;
``build,jobs`` the batch jobs; ``alloc`` the backward's allocation
choice);
``--out PATH`` also writes every result to one JSON file.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 20250907
D = 200                     # PAPER_DIM of the GO workload
GO_ROWS = 40_000            # configs/go_kge.py CONFIG.n_terms
SCALE_ROWS = 100_000        # configs/go_kge.py SCALE.n_terms
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, fp32 on the CUDA cores
SCORE_TOL = 1e-5            # kernel vs plain scores (fp32 sums in another order)
TIE_TOL = 1e-6              # runs of scores this close may order ids freely
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/topk_cosine.cu"
REPLACES = "src/repro/kernels/topk_similarity.py:78"
KGE_SOURCE = "src/repro_torch/kernels/csrc/kge_score.cu"
KGE_REPLACES = "src/repro/kernels/kge_score.py:54"
KGE_TOL = 1e-4              # kernel vs plain, the reference's own (test_kernels.py)
KGE_MODELS = ("transe_l1", "transe_l2", "distmult")
KGE_SHAPE = (1024, 32, 200)  # TrainConfig batch, negatives; PAPER_DIM
#: the numbers phase's eager GO training step of each of the six models:
#: timed calls and profiled steps (50 and 30 before olmoe-1b-7b's
#: training run and the zoo phase joined the script: a depth cut of
#: figures PERF.md already records)
KGE_STEP_TIMED, KGE_STEP_PROFILED = 20, 10
#: phase_kge's shapes: the training shape, the reference's test shapes, and
#: the backward's staging paths (K * d not a multiple of 4; a slab past
#: one stage; d past 128 float4 columns)
KGE_CASES = (KGE_SHAPE, (100, 5, 200), (7, 3, 32), (1, 1, 1), (3, 7, 13),
             (4, 8192, 200), (2, 64, 4096))
#: ... and the shapes run again with every input one float off alignment
KGE_OFFSET_CASES = (KGE_SHAPE, (4, 8192, 200), (2, 64, 4096))
#: the paper's six models, every one of them on the update path
UPDATE_MODELS = ("transe", "transr", "distmult", "hole", "boxe", "rdf2vec")
#: steps of a full run of every model (Updater.steps_override; an
#: incremental run takes warm_frac of it): ~42 epochs of the GO triples
#: (60 steps of 1024 an epoch), a cut in depth (the paper's budget is 100
#: epochs; 6,000 steps took 280 s of the phase's 410 on an H100) that
#: keeps the whole script well inside its 1,200 s; at 2,000 steps
#: DistMult's warm MRR came within 0.01 of its gate, so no deeper; for
#: RDF2vec, whose epoch of skip-gram pairs would be about 12,000 steps,
#: a deeper cut.  3,000 (50 epochs) until the recurrentgemma phase and
#: training run joined the script: a depth cut that keeps it near 820 s
#: of phases (at 2,500 DistMult's warm MRR sat 0.035 above its gate)
UPDATE_STEPS = 2500
GO_TRIPLES = 61_749          # triples of generate(GO_SPEC, seed=0, n_terms=40000)
#: bench_update.py's low-churn release evolution and MRR band
CALM = dict(add_frac=0.02, obsolete_frac=0.005, rewire_frac=0.005)
MRR_TOL_ABS, MRR_TOL_REL = 0.05, 0.15
MRR_SAMPLE = 1000
SWA_SOURCE = "src/repro_torch/kernels/csrc/swa_attention.cu"
SWA_REPLACES = "src/repro/kernels/swa_attention.py:72"
SWA_TOL = 2e-4              # fp32 kernel vs plain, the reference's own (test_kernels.py)
#: bf16: the output's rounding plus p rounded to bf16 before P.V
SWA_BF16_TOL = 1e-2
#: (B, Hq, Hkv, Sq, Skv, hd, window, q_offset) the swa phase holds the
#: kernel to its plain version on
SWA_CASES = (
    ("test_kernels 1", (1, 2, 1, 128, 128, 32, 32, 0)),
    ("test_kernels 2", (2, 4, 2, 256, 256, 64, 64, 0)),
    ("test_kernels 3 (W >= S)", (1, 1, 1, 64, 64, 16, 128, 0)),
    ("h2o reduced (S 80 wraps W 64)", (2, 4, 2, 80, 80, 64, 64, 0)),
    ("h2o reduced, kv_groups 4", (2, 4, 4, 80, 80, 64, 64, 0)),
    ("q_offset, Sq < Skv", (2, 8, 2, 37, 300, 80, 128, 263)),
    ("q_offset, one query", (1, 4, 1, 1, 517, 128, 64, 516)),
    ("W = 1", (1, 4, 2, 130, 130, 80, 1, 0)),
    ("W >= S, ragged", (1, 6, 3, 1000, 1000, 80, 5000, 0)),
    ("ragged S", (2, 4, 1, 131, 131, 128, 50, 0)),
    ("h2o layer, 4 heads", (1, 4, 1, 6144, 6144, 80, 4096, 0)),
    # the tile plan's edges: ragged Sq with q_offset > 0, W not a multiple
    # of the 64-key tile, Skv not a multiple of it, d = 128 and 16
    ("d 128 ragged, q_offset, W 200, Skv 1000",
     (1, 4, 2, 333, 1000, 128, 200, 700)),
    ("d 16, q_offset, W 100, Skv 461", (1, 2, 1, 200, 461, 16, 100, 300)),
    ("d 32 ragged, W 77", (1, 2, 1, 300, 300, 32, 77, 0)),
    # the bf16 dK/dV tiling's edges: a 128-key CTA half past Skv, group 1
    # and group 8, d = 16, 32 and 128 at W not a multiple of 64
    ("128-key CTA half past Skv, group 1", (1, 2, 2, 178, 178, 80, 100, 0)),
    ("group 8, Skv 300", (1, 8, 1, 300, 300, 80, 150, 0)),
    ("d 16, W 100", (1, 4, 2, 150, 150, 16, 100, 0)),
    ("d 32, W 77, one key past 128", (2, 4, 1, 129, 129, 32, 77, 0)),
    ("d 128, W 130, q_offset, Skv 250", (1, 4, 2, 190, 250, 128, 130, 60)),
    # full causal attention, a window over every key (W >= q_offset + Sq):
    # one olmoe-1b-7b prefill layer, and a causal block past q_offset
    ("causal: olmoe layer, W = S", (2, 16, 16, 2048, 2048, 128, 2048, 0)),
    ("causal: q_offset, W = q_offset + Sq",
     (1, 4, 4, 300, 812, 128, 812, 512)),
    # whisper-base's decoder (8 heads of 64): its prompt and its 448-token
    # cap; one llava-next-34b layer (56 q heads over 8 kv heads, d 128)
    # over 2,880 image tokens and a 64-token prompt
    ("causal: whisper decoder prompt, W = S", (2, 8, 8, 64, 64, 64, 64, 0)),
    ("causal: whisper decoder at its cap, W = S",
     (2, 8, 8, 448, 448, 64, 448, 0)),
    ("causal: llava layer, 56 / 8 heads, W = S",
     (1, 56, 8, 2944, 2944, 128, 2944, 0)),
    # mistral-large-123b's 12 q heads a kv head (96 / 8), two groups
    ("causal: mistral's group of 12, W = S",
     (1, 24, 2, 2048, 2048, 128, 2048, 0)),
    # head dim 256 (recurrentgemma-2b: 10 q heads over 1 kv head, W 2048):
    # its layer, ragged S, q_offset with Sq < Skv, W not a multiple of 64,
    # one query, W >= S; each also launched twice (the same bits)
    ("d 256: recurrentgemma layer, 10 / 1 heads",
     (1, 10, 1, 4096, 4096, 256, 2048, 0)),
    ("d 256: ragged S", (2, 4, 1, 131, 131, 256, 50, 0)),
    ("d 256: q_offset, Sq < Skv", (1, 4, 2, 37, 300, 256, 128, 263)),
    ("d 256: W 77", (1, 10, 1, 300, 300, 256, 77, 0)),
    ("d 256: q_offset, one query", (1, 10, 1, 1, 517, 256, 2048, 516)),
    ("d 256: W >= S, ragged", (1, 6, 3, 1000, 1000, 256, 5000, 0)),
)
#: the LM generation run: h2o-danube-1.8b at its published width, a prompt
#: longer than its 4096 window (the roll shift after prefill is 2048).
#: Every generation run decodes 16 greedy steps (32 before the falcon-mamba
#: training run joined the train phase: a depth cut that keeps the whole
#: script near 1,000 s; decode ms a token is measured over them)
LM_ARCH = "h2o-danube-1.8b"
LM_BATCH, LM_PROMPT, LM_STEPS = 2, 6144, 16
LM_TOL = 2e-3               # the reference's TOL (tests/test_arch_consistency.py)
#: the int8 cache against the fp cache: h2o-danube at full width, fp32,
#: cut to 2 layers; the contract of tests/test_int8_kv_cache.py
INT8_CHECK_LAYERS = 2
INT8_RTOL, INT8_ATOL = 0.1, 0.15
#: the MoE generation run: olmoe-1b-7b at its published width and depth
#: (causal attention, no window: every prefill layer on the SWA kernel
#: with W = S)
MOE_ARCH = "olmoe-1b-7b"
MOE_BATCH, MOE_PROMPT, MOE_STEPS = 2, 2048, 16
#: the fp32 prefill(S + 1) / prefill(S) + decode check: full width, 2
#: layers, capacity factor 16 (no drop, as tests/test_arch_consistency.py
#: runs the MoE archs: dropping depends on which tokens share a prefill)
MOE_CHECK_LAYERS, MOE_CHECK_CF = 2, 16.0
#: the selective-scan kernel against its plain version: rtol = atol =
#: 2e-4 on y and h_last (tests/test_recurrent_blocks.py's tolerance for
#: the chunked scan against the stepwise decode)
SCAN_SOURCE = "src/repro_torch/kernels/csrc/selective_scan.cu"
SCAN_REPLACES = ("src/repro/models/blocks.py:605 _selective_scan_chunk "
                 "(jnp associative scan under lax.scan; no Pallas kernel)")
SCAN_TOL = 2e-4
#: the fused entry point's bf16 out may round the other way at a tie of
#: its fp32 value: one bf16 ulp (2^-7 |plain|) beyond SCAN_TOL
BF16_ULP = 2.0 ** -7
#: the forward kernel's instances: d_state 4 / 8 / 16 x fp32 / bf16 x
#: bare / fused / fused writing its tile states; the backward's: d_state x
#: dtype
SCAN_INSTANCES = 18
SCAN_BWD_INSTANCES = 6
#: (B, S, d_in, d_state, h0 = 0): the reference's test config (d 32 ->
#: d_in 64, d_state 4), reduced falcon-mamba (d_in 512, d_state 8) with S
#: past one 256-step chunk and not a multiple of it, S = 1, and one
#: falcon-mamba-7b layer from a state h0 != 0
SCAN_CASES = (
    ("test config, S 24", (2, 24, 64, 4, True)),
    ("test config, S 33, h0", (1, 33, 64, 4, False)),
    ("reduced falcon-mamba, S 300", (2, 300, 512, 8, True)),
    ("reduced falcon-mamba, S 1, h0", (2, 1, 512, 8, False)),
    ("falcon-mamba-7b layer, h0", (2, 2048, 8192, 16, False)),
)
#: exps an H100 SXM's SFUs give a second: 16 a clock an SM, 132 SMs, the
#: 1.98 GHz boost clock (NVIDIA's throughput table and data sheet)
SFU_EXP_PER_S = 16 * 132 * 1.98e9
#: the SSM generation run: falcon-mamba-7b at its published width and
#: depth; the fp32 prefill(S + 1) / prefill(S) + decode check at 2 layers
MAMBA_ARCH = "falcon-mamba-7b"
MAMBA_BATCH, MAMBA_PROMPT, MAMBA_STEPS = 2, 2048, 16
MAMBA_CHECK_LAYERS = 2
#: the audio run: whisper-base at its published width and depth, 1,500
#: encoder frames (its 30-s window after the conv stem, arXiv:2212.04356),
#: a 64-token decoder prompt, 16 steps (inside its 448-token cap)
WHISPER_ARCH = "whisper-base"
WHISPER_BATCH, WHISPER_FRAMES, WHISPER_PROMPT, WHISPER_STEPS = 2, 1500, 64, 16
#: the VLM run: llava-next-34b at its published width and depth (68.8 GB
#: of bf16 weights), 2,880 image tokens and a 64-token text prompt, 16
#: steps; the fp32 check at 2 layers
LLAVA_ARCH = "llava-next-34b"
LLAVA_BATCH, LLAVA_PROMPT, LLAVA_STEPS = 2, 64, 16
LLAVA_CHECK_LAYERS = 2
#: the training run: h2o-danube-1.8b at its published width and depth,
#: bf16, remat "full", one sequence of 6144 tokens (past the 4096 window);
#: 3 measured steps after a 1-step warm-up run (5 before the depth cut
#: above; the warm-up run had 2 steps before the recurrentgemma run
#: joined the script)
TRAIN_BATCH, TRAIN_SEQ = 1, 6144
TRAIN_WARM_STEPS, TRAIN_STEPS = 1, 3
#: profiled steps on one repeated batch (3 warm-up + 1 profiled + 1 + 1
#: timed: 6 steps, whose losses must fall over the first 5); 2 profiled
#: before olmoe-1b-7b's training run and the zoo phase joined the
#: script: a depth cut of figures PERF.md already records
TRAIN_REPEAT_STEPS = 1
#: the fp32 check: 2 layers at full width, the kernels' step against the
#: plain SWA forward and backward substituted; loss within 1e-5
#: relative, each gradient leaf within 2e-4 * max|g_plain| of the leaf
#: (fp32 sums in another order, as tests/test_torch_lm_train.py holds the
#: port to the reference)
TRAIN_CHECK_LAYERS = 2
TRAIN_LOSS_RTOL = 1e-5
TRAIN_GRAD_TOL = 2e-4
#: the SSM training run: falcon-mamba-7b at its published width and depth,
#: bf16, remat "full", batch 2 of 2048 tokens (the generation run's
#: shape), Adam at lr 3e-4: 7.27 B params, which with their gradients and
#: Adam's two bf16 moments take ~58 GB; the fp32 check at B = 1
MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ, MAMBA_TRAIN_STEPS = 2, 2048, 3
MAMBA_CHECK_BATCH = 1
#: the hybrid run: recurrentgemma-2b at its published width and depth (26
#: layers: 18 RG-LRU and 8 local attention at head dim 256, 10 q heads
#: over 1 kv head, W 2048), a 4,096-token prompt (twice the window: the
#: rolling cache wraps), 16 steps; the fp32 prefill(S + 1) / prefill(S) +
#: decode check at 3 layers, the first with an attention layer (the
#: pattern is recurrent, recurrent, attention)
HYBRID_ARCH = "recurrentgemma-2b"
HYBRID_BATCH, HYBRID_PROMPT, HYBRID_STEPS = 2, 4096, 16
HYBRID_CHECK_LAYERS = 3
#: its training run: bf16, remat "full" (per period of 3 layers, as the
#: reference wraps its period body), batch 2 of 4,096 tokens, Adam at lr
#: 3e-4: 3.04 B params, ~24.3 GB with their gradients and two bf16 Adam
#: moments; the fp32 check at 3 layers, B 1
HYBRID_TRAIN_BATCH, HYBRID_TRAIN_SEQ, HYBRID_TRAIN_STEPS = 2, 4096, 3
HYBRID_CHECK_BATCH = 1
#: its repeated batch: Adam at lr 3e-4 overshoots at the fourth step on
#: this batch with the plain SWA Function as with the kernels (losses
#: 12.96, 12.14, 10.85, 14.56, 10.29 on both), so its first 3 losses must
#: fall where the other archs' first 5 must; the fp32 check holds its
#: kernels' step to the plain Function's
HYBRID_REPEAT_FALLS = 3
#: the MoE training run: olmoe-1b-7b at its published width and depth,
#: bf16, remat "full", batch 2 of 2048 tokens (the generation run's
#: shape), Adam at lr 3e-4: 6.92 B params, ~55.4 GB with their gradients
#: and two bf16 Adam moments; the fp32 check at 2 layers, B 1, capacity
#: factor MOE_CHECK_CF (no pair is past the capacity in either step)
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ, MOE_TRAIN_STEPS = 2, 2048, 3
MOE_CHECK_BATCH = 1
#: the zoo phase: the zoo's four large archs at published width, one after
#: another in a fresh process, each generating through launch.generate at
#: B 2 from a 2,048-token prompt, 16 steps.  (arch, depth of the default
#: run, depth of the opt-in zoo_deep).  A depth is fixed by serve_specs'
#: bytes (params + cache at B 2, 2,064 positions) against
#: ZOO_BUDGET_BYTES, 63 GB of the card's 80, which leaves room for a
#: leaf's fp32 draw (grok's experts: 6.4 GB) and the prefill's
#: activations.  internlm2-20b is whole (39.7 GB) in both runs; qwen2-72b
#: (1.76 GB a layer, 4.98 GB outside the layers), mistral-large-123b
#: (2.77, 1.61) and grok-1-314b (9.84, 3.22) are cut: 32, 22 and 6 layers
#: fill the budget (zoo_deep), and the default run takes 4, 4 and 2 to
#: keep the script's time
MISTRAL_ARCH = "mistral-large-123b"      # 12 q heads a kv head
ZOO_ARCHS = (("internlm2-20b", 48, 48), ("qwen2-72b", 4, 32),
             (MISTRAL_ARCH, 4, 22), ("grok-1-314b", 2, 6))
ZOO_BUDGET_BYTES = 63e9
ZOO_BATCH, ZOO_PROMPT, ZOO_STEPS = 2, 2048, 16
#: the fp32 prefill(S + 1) / prefill(S) + decode check: 2 layers at full
#: width, B 2, S 2048; grok at capacity factor MOE_CHECK_CF (no drop) and
#: B 1, S 512: at that factor C = 4 T, and at B 2, S 2049 each fp32
#: product of its experts, (8, C, 32768), would take 34 GB beside 46 GB
#: of fp32 params
ZOO_CHECK_LAYERS = 2
ZOO_MOE_CHECK_BATCH, ZOO_MOE_CHECK_PROMPT = 1, 512
BF16_FLOP_PER_S = 989e12    # H100 SXM data sheet, dense bf16 tensor cores
#: steps under the profiler in the prefill and decode breakdowns of the
#: numbers and llava phases (2 prefills and 16 / 8 decode steps before
#: the recurrentgemma phase and training run joined the script, 4
#: decode steps before olmoe-1b-7b's training run and the zoo phase did:
#: depth cuts of figures PERF.md already records, to keep it near 820 s)
PREFILL_PROFILE_STEPS, DECODE_PROFILE_STEPS = 1, 2
#: the bf16 SWA backward kernels, which must run on wgmma (HGMMA in SASS)
BF16_BWD_KERNELS = ("swa_bwd_dkdv_bf16_kernel", "swa_bwd_dq_bf16_kernel")
SMALL_ENTRY = ("topk_score_select", "topk_merge_lists")
LARGE_ENTRY = ("topk_score_keys", "topk_select_sort", "topk_merge_path")
#: the device kernels in topk_cosine.cu, as the profiler names them
_KERNEL_NAMES = ("score_select", "merge_lists", "score_keys",
                 "select_sort", "merge_path")

RESULTS: dict = {"phases": {}, "phase_seconds": {}}
#: the card; the phases take it from here
DEV = "cuda"


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# --------------------------------------------------------------------- #
# comparisons
# --------------------------------------------------------------------- #
def _ids_agree(a: np.ndarray, b: np.ndarray, s_plain: np.ndarray):
    """ids equal position by position, except inside runs of plain scores
    closer than TIE_TOL, where only the sets must match; a run cut by the
    end of the row may hold different members.  Returns the number of
    runs that needed the set rule, or raises."""
    if np.array_equal(a, b):
        return 0
    n = len(a)
    brk = np.ones(n, bool)
    brk[1:] = (s_plain[:-1] - s_plain[1:]) >= TIE_TOL
    starts = np.flatnonzero(brk)
    ends = np.append(starts[1:], n)
    run_of = np.cumsum(brk) - 1
    relaxed = 0
    for rid in np.unique(run_of[a != b]):
        lo, hi = starts[rid], ends[rid]
        if hi == n:
            relaxed += 1           # the cut-off falls inside a near-tie
            continue
        check(np.array_equal(np.sort(a[lo:hi]), np.sort(b[lo:hi])),
              f"ids differ outside a near-tie run at [{lo}, {hi})")
        relaxed += 1
    check(len(np.unique(a)) == n, "duplicate ids in the kernel's result")
    return relaxed


def compare(got, want, note: str) -> dict:
    s, i, v = (t.cpu().numpy() for t in got)
    sr, ir, vr = (t.cpu().numpy() for t in want)
    check(np.array_equal(v, vr), f"{note}: valid {v} != {vr}")
    err, relaxed = 0.0, 0
    for r in range(s.shape[0]):
        n = int(v[r])
        if n == 0:
            continue
        e = float(np.abs(s[r, :n] - sr[r, :n]).max())
        check(e <= SCORE_TOL, f"{note}: row {r} score error {e}")
        err = max(err, e)
        relaxed += _ids_agree(i[r, :n], ir[r, :n], sr[r, :n])
    return {"max_abs_err": err, "tie_runs_by_set": relaxed}


# --------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------- #
def go_table(n: int, seed: int):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, D), dtype=np.float32)
    ids = [f"GO:{i:07d}" for i in range(n)]
    labels = [f"go term {i:06d} {seed % 97}" for i in range(n)]
    return ids, labels, emb


def unit_rows(table: np.ndarray, norms: np.ndarray, rows) -> np.ndarray:
    sub = np.asarray(table[rows], dtype=np.float32)
    n = np.asarray(norms[rows], dtype=np.float32)
    return sub / np.maximum(n[..., None], 1e-12)


# --------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------- #
#: the template arguments ``_kernel_name`` reads: an int, float, bf16, bool
_TEMPLATE_ARG = r"Li(-?\d+)E|(f)|13(__nv_bfloat16)|Lb([01])E"


def _kernel_name(mangled: str) -> str:
    """``swa_bf16_kernel<80>`` or ``selective_scan_kernel<16, bf16, true>``
    from its mangled name (a length-prefixed ``*_kernel`` and its integer,
    float, bf16 and bool template arguments); other names as they are.
    Of the length prefixes that read a ``*_kernel``, the last one: an
    anonymous namespace's hash (which follows the source's path) may hold
    digits that read a longer span ending at the same ``_kernel``."""
    found = None
    for d in re.finditer(r"\d+(?!\d)", mangled):
        for i in range(d.start(), d.end()):   # a hash's digits may lead
            end = d.end() + int(mangled[i:d.end()])
            if mangled[d.end():end].endswith("_kernel"):
                found = (d.end(), end)
    if found is None:
        return mangled
    start, end = found
    m = re.match(rf"I((?:{_TEMPLATE_ARG})+)E", mangled[end:])
    args = [n or ("float" if f else "bf16" if bf else
                  "true" if bl == "1" else "false")
            for n, f, bf, bl in re.findall(_TEMPLATE_ARG, m.group(1))] \
        if m else []
    return mangled[start:end] + (f"<{', '.join(args)}>" if args else "")


def _ptxas_kernels(log: str) -> dict:
    """``{kernel: {"registers", "spill_stores", "spill_loads"}}`` from
    ``nvcc -Xptxas=-v``'s output."""
    out: dict = {}
    name = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            name = _kernel_name(m.group(1))
            out.setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and name:
            out[name].update(spill_stores=int(m.group(1)),
                             spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out[name]["registers"] = int(m.group(1))
    return out


def _sass_functions(lib: Path) -> dict:
    """``{kernel: SASS}`` of a built library, from ``cuobjdump -sass``
    (beside nvcc in the toolkit)."""
    from repro_torch.kernels import _build
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300)
    check(out.returncode == 0, f"cuobjdump -sass {lib}: {out.stderr[-400:]}")
    funcs = {}
    for chunk in re.split(r"\n\s*Function : ", out.stdout)[1:]:
        name, _, body = chunk.partition("\n")
        funcs[_kernel_name(name.strip())] = body
    return funcs


#: a SASS instruction's opcode, after its address and any predicate
_SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
                      r"([A-Z][A-Z0-9_]*)")


def _sass_ops(sass: str) -> dict:
    """``{opcode: count}`` of one kernel's SASS (static instructions, the
    unrolled loops as compiled), most frequent first, with ``total``."""
    ops: dict = {}
    for m in _SASS_OP.finditer(sass):
        ops[m.group(1)] = ops.get(m.group(1), 0) + 1
    out = dict(sorted(ops.items(), key=lambda kv: -kv[1]))
    out["total"] = sum(ops.values())
    return out


def scan_instances(log: str, lib: Path) -> dict:
    """Each selective-scan instance's registers, spills and SASS opcode
    counts, from the build's ptxas report and ``cuobjdump -sass``."""
    sass = _sass_functions(lib)
    return {name: {**regs, "sass_ops": _sass_ops(sass.get(name, ""))}
            for name, regs in sorted(_ptxas_kernels(log).items())}


def sass_of(source: str) -> dict:
    """Compile one CUDA source with the port's nvcc flags into a scratch
    directory under ``build/`` and report its kernels as
    :func:`scan_instances` does: registers, spills, SASS opcode counts,
    and each kernel's SASS in a file beside the library.  The one way to
    build a source other than the tree's: ``--sass-of`` (e.g. an earlier
    revision's kernel, ``git show REV:PATH``) and ``tools/scan_probes.py``
    (the scan with one cost taken out)."""
    from repro_torch.kernels import _build
    src = Path(source).resolve()
    out_dir = ROOT / "build" / "sass_of" / src.stem
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / f"lib{src.stem}.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(src)], capture_output=True,
                          text=True, timeout=600)
    check(proc.returncode == 0, f"nvcc {src}: {proc.stdout[-2000:]}"
                                f"{proc.stderr[-2000:]}")
    for name, sass in _sass_functions(lib).items():    # beside the library
        (out_dir / f"{name}.sass").write_text(sass)
    return {"source": str(src), "sass_dir": str(out_dir.relative_to(ROOT)),
            "library": str(lib),
            "kernels": scan_instances(proc.stdout + proc.stderr, lib)}


def phase_build() -> dict:
    """Build every source; print each kernel's ptxas line; the SWA
    backward kernels' registers and spills, and fail unless every bf16
    one runs on the tensor cores (HGMMA in its SASS); the selective
    scan's eighteen forward and six backward instances and the
    backward's sum, with their SASS opcode counts, and fail if any of
    them spills."""
    from repro_torch.kernels import _build, swa_attention as sw
    t0 = time.perf_counter()
    libs = _build.build_all()
    import torch
    out = {"phase": "build", "seconds": time.perf_counter() - t0,
           "torch": torch.__version__, "cuda": torch.version.cuda,
           "compile_s": _build.last_build_s,
           "libraries": {k: str(p.relative_to(ROOT)) for k, p in libs.items()}}
    for name in libs:
        for line in _build.build_log(name).splitlines():
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:                       # which kernel the next lines are
                print(f"[ptxas] {name}: {_kernel_name(m.group(1))}")
            elif any(w in line for w in ("registers", "spill", "error",
                                         "warning")):
                print(f"[ptxas] {line.strip()}")
    ptxas = _ptxas_kernels(_build.build_log("swa_attention"))
    sass = _sass_functions(libs["swa_attention"])
    bwd = {}
    for name, regs in sorted(ptxas.items()):
        if name.startswith("swa_bwd_"):
            bwd[name] = {**regs, "hgmma": sass.get(name, "").count("HGMMA")}
    bf16 = [f"{k}<{d}>" for k in BF16_BWD_KERNELS for d in sw.HEAD_DIMS]
    missing = [k for k in bf16 if not bwd.get(k, {}).get("hgmma")]
    check(not missing, f"no HGMMA in the SASS of {missing}")
    out["swa_backward_kernels"] = bwd
    # every SWA instance at d = 256 (forward and backward, both dtypes)
    out["swa_d256_kernels"] = {k: v for k, v in sorted(ptxas.items())
                               if k.endswith("<256>")}
    check(len(out["swa_d256_kernels"]) == 6,
          f"swa_attention at d = 256: {sorted(out['swa_d256_kernels'])}, "
          f"want the forward and both backward kernels in both dtypes")
    # the selective scan's instances (d_state 4 / 8 / 16 x fp32 / bf16 x
    # bare / fused / fused with states; the backward's d_state x dtype)
    scan = scan_instances(_build.build_log("selective_scan"),
                          libs["selective_scan"])
    out["scan_kernels"] = scan
    counts = [sum(k.startswith(f"{n}<") for k in scan) for n in (
        "selective_scan_kernel", "selective_scan_bwd_kernel")]
    check(counts == [SCAN_INSTANCES, SCAN_BWD_INSTANCES]
          and len(scan) == SCAN_INSTANCES + SCAN_BWD_INSTANCES,
          f"selective_scan: {sorted(scan)}, want {SCAN_INSTANCES} forward "
          f"and {SCAN_BWD_INSTANCES} backward instances")
    spills = {k: (v.get("spill_stores"), v.get("spill_loads"))
              for k, v in scan.items()
              if v.get("spill_stores") or v.get("spill_loads")}
    check(not spills, f"selective_scan instances spill: {spills}")
    emit(out)
    return out


def phase_kernels(store_tables) -> dict:
    import torch
    from repro_torch.kernels import ops, ref, topk_similarity as ts

    dev = torch.device(DEV)
    rng = np.random.default_rng(SEED)
    errs = {"small": 0.0, "large": 0.0}
    cases = 0
    relaxed_total = 0

    def record(k_c, res):
        nonlocal cases, relaxed_total
        path = "small" if k_c <= ts.SMALL_K_MAX else "large"
        errs[path] = max(errs[path], res["max_abs_err"])
        relaxed_total += res["tie_runs_by_set"]
        cases += 1

    # -- the edge grid of tests/test_blocked_topk.py, both paths -------- #
    grid = [(2, 21, 16, 12, 8), (3, 21, 16, 5, 8), (2, 16, 8, 16, 8),
            (1, 7, 8, 10, 8), (2, 64, 32, 64, 16)]
    for Q, N, d, k, block in grid:
        q = rng.standard_normal((Q, d)).astype(np.float32)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        e = rng.standard_normal((N, d)).astype(np.float32)
        nrm = np.linalg.norm(e, axis=1).astype(np.float32)
        excl = np.array([N - 1 if j % 2 == 0 else -1 for j in range(Q)],
                        np.int32)
        want = ref.topk_cosine_blocked_ref(
            torch.from_numpy(q).to(dev), torch.from_numpy(e).to(dev), k,
            exclude_rows=torch.from_numpy(excl).to(dev),
            norms=torch.from_numpy(nrm).to(dev), block_n=block)
        got = ops.topk_cosine(q, e, k, exclude_rows=excl, norms=nrm,
                              block_rows=block, device=dev)
        record(min(k, N), compare(got, want, f"edge stream {Q, N, d, k}"))
        got = ops.topk_cosine(q, torch.from_numpy(e).to(dev), k,
                              exclude_rows=excl, norms=nrm)
        record(min(k, N), compare(got, want, f"edge device {Q, N, d, k}"))
    torch.cuda.synchronize()

    # -- exact duplicate rows: integer data, every score exact ---------- #
    n_dup, q_dup = 5000, 8
    base = rng.integers(-2, 3, size=(n_dup // 2, D)).astype(np.float32)
    e = np.concatenate([base, base])            # row j == row j + n/2
    q = rng.integers(-2, 3, size=(q_dup, D)).astype(np.float32)
    ones = np.ones(n_dup, np.float32)
    for k in (10, 64, 65, 300):
        want = ref.topk_cosine_blocked_ref(
            torch.from_numpy(q).to(dev), torch.from_numpy(e).to(dev), k,
            norms=torch.from_numpy(ones).to(dev), block_n=1024)
        for got in (ops.topk_cosine(q, e, k, norms=ones, block_rows=1024,
                                    device=dev),
                    ops.topk_cosine(q, torch.from_numpy(e).to(dev), k,
                                    norms=ones)):
            s, i, v = (t.cpu().numpy() for t in got)
            sr, ir, vr = (t.cpu().numpy() for t in want)
            check(np.array_equal(v, vr) and np.array_equal(i, ir)
                  and np.array_equal(s, sr),
                  f"duplicate rows k={k}: ties not resolved to the lower "
                  f"index exactly")
            cases += 1
    torch.cuda.synchronize()

    # -- GO and SCALE sizes, streamed from the store and device-resident - #
    for n_rows, (table, norms) in store_tables.items():
        table_dev = torch.from_numpy(np.array(table)).to(dev)
        norms_dev = torch.from_numpy(np.array(norms)).to(dev)
        for Q in (1, 32, 64):
            rows = rng.choice(n_rows, size=Q, replace=False)
            q = unit_rows(table, norms, rows)
            excl = rows.astype(np.int32)
            q_dev = torch.from_numpy(q).to(dev)
            x_dev = torch.from_numpy(excl).to(dev)
            for k in (1, 10, 64, 65, 2000, n_rows):
                k_c = min(k, n_rows)
                want = ref.topk_cosine_blocked_ref(
                    q_dev, table_dev, k, exclude_rows=x_dev, norms=norms_dev,
                    block_n=ops.STREAM_BLOCK_ROWS)
                got = ops.topk_cosine(q, table, k, exclude_rows=excl,
                                      norms=norms, device=dev)
                record(k_c, compare(got, want, f"stream N={n_rows} Q={Q} k={k}"))
                got = ops.topk_cosine(q, table_dev, k, exclude_rows=excl,
                                      norms=norms)
                record(k_c, compare(got, want, f"device N={n_rows} Q={Q} k={k}"))
                del want, got
            torch.cuda.synchronize()
        # 1024-row slabs: 40 slabs at 40k, staging buffers reused 20 times
        if n_rows == GO_ROWS:
            for Q, k in ((32, 10), (64, 2000)):
                rows = rng.choice(n_rows, size=Q, replace=False)
                q = unit_rows(table, norms, rows)
                excl = rows.astype(np.int32)
                want = ref.topk_cosine_blocked_ref(
                    torch.from_numpy(q).to(dev), table_dev, k,
                    exclude_rows=torch.from_numpy(excl).to(dev),
                    norms=norms_dev, block_n=1024)
                before = ops.stream_stats["blocks"]
                got = ops.topk_cosine(q, table, k, exclude_rows=excl,
                                      norms=norms, block_rows=1024, device=dev)
                check(ops.stream_stats["blocks"] - before == 40,
                      "1024-row slabs: expected 40 slabs at 40k rows")
                record(k, compare(got, want, f"slabs1024 Q={Q} k={k}"))
            # one large-k slab step with its running list is 3 launches
            q_dev = torch.from_numpy(q).to(dev)
            x_dev = torch.from_numpy(excl).to(dev)
            slab = ops.STREAM_BLOCK_ROWS
            run = ts.topk_cosine_step(q_dev, table_dev[:slab],
                                      norms_dev[:slab], x_dev, 0, n_rows, 2000)
            ts.reset_launches()
            got = ts.topk_cosine_step(q_dev, table_dev[slab:2 * slab],
                                      norms_dev[slab:2 * slab], x_dev, slab,
                                      n_rows, 2000, *run)
            step_launches = dict(ts.launches)
            check(sum(step_launches.values()) == 3
                  and all(step_launches[e] == 1 for e in LARGE_ENTRY),
                  f"a large-k slab step launched {step_launches}, want one "
                  f"of each of {LARGE_ENTRY}")
            want = ref.stream_step_ref(q_dev, table_dev[slab:2 * slab],
                                       norms_dev[slab:2 * slab], slab,
                                       n_rows, x_dev, *run, 2000)
            full = torch.full((Q,), 2000, dtype=torch.int32)
            record(2000, compare((*got, full), (*want, full),
                                 "one slab step Q=64 k=2000"))
        # k_run > rows: Q = 1, k = 2000 over 1024-row slabs, so every merge
        # takes the whole running list before any slab candidate
        if n_rows == GO_ROWS:
            rows = rng.choice(n_rows, size=1, replace=False)
            q = unit_rows(table, norms, rows)
            excl = rows.astype(np.int32)
            want = ref.topk_cosine_blocked_ref(
                torch.from_numpy(q).to(dev), table_dev, 2000,
                exclude_rows=torch.from_numpy(excl).to(dev),
                norms=norms_dev, block_n=1024)
            got = ops.topk_cosine(q, table, 2000, exclude_rows=excl,
                                  norms=norms, block_rows=1024, device=dev)
            record(2000, compare(got, want, "slabs1024 Q=1 k=2000"))
        # device-resident, k <= 64, at 100k rows with every row repeated
        # (integer data, exact scores): one step of 2 launches, and each
        # tie goes to the lower index exactly
        if n_rows == SCALE_ROWS:
            base = rng.integers(-2, 3, size=(n_rows // 2, D)).astype(
                np.float32)
            e_dup = torch.from_numpy(np.concatenate([base, base])).to(dev)
            q_dup = rng.integers(-2, 3, size=(16, D)).astype(np.float32)
            ones = torch.ones(n_rows, dtype=torch.float32, device=dev)
            for k in (10, 64):
                want = ref.topk_cosine_blocked_ref(
                    torch.from_numpy(q_dup).to(dev), e_dup, k, norms=ones,
                    block_n=ops.STREAM_BLOCK_ROWS)
                ts.reset_launches()
                got = ops.topk_cosine(q_dup, e_dup, k, norms=ones)
                check(dict(ts.launches) == {**{e: 0 for e in ts.launches},
                                            **{e: 1 for e in SMALL_ENTRY}},
                      f"device N={n_rows} k={k}: {dict(ts.launches)}, want "
                      f"one launch of each of {SMALL_ENTRY}")
                check(all(torch.equal(a, b) for a, b in zip(got, want)),
                      f"duplicate rows N={n_rows} k={k}: ties not resolved "
                      f"to the lower index exactly")
                cases += 1
            del e_dup, ones
        # device-resident, k > 64, more than one sub-slab: one merge per
        # sub-slab of SORT_CAP rows
        if n_rows == SCALE_ROWS:
            Q, k = 32, 300
            rows = rng.choice(n_rows, size=Q, replace=False)
            q = unit_rows(table, norms, rows)
            excl = rows.astype(np.int32)
            want = ref.topk_cosine_blocked_ref(
                torch.from_numpy(q).to(dev), table_dev, k,
                exclude_rows=torch.from_numpy(excl).to(dev),
                norms=norms_dev, block_n=ops.STREAM_BLOCK_ROWS)
            ts.reset_launches()
            got = ops.topk_cosine(q, table_dev, k, exclude_rows=excl,
                                  norms=norms_dev)
            n_sub = -(-n_rows // ts.SORT_CAP)
            check(ts.launches["topk_merge_path"] == n_sub > 1
                  and ts.launches["topk_select_sort"] == 1,
                  f"device-resident N={n_rows} k={k}: {dict(ts.launches)}, "
                  f"want {n_sub} merges")
            record(k, compare(got, want, f"device N={n_rows} Q={Q} k={k} "
                                         f"({n_sub} sub-slabs)"))
        del table_dev, norms_dev
        torch.cuda.synchronize()
    # -- k > 64 past the grid's y limit: one slab step of 65,536 queries
    # (select/sort and merge path launch twice, 65,535 queries + 1) ---- #
    table, norms = store_tables[GO_ROWS]
    qn, slab, k = ts.MAX_GRID_Y + 1, 1024, 100
    q_big = rng.standard_normal((qn, D)).astype(np.float32)
    q_big /= np.linalg.norm(q_big, axis=1, keepdims=True)
    q_dev = torch.from_numpy(q_big).to(dev)
    blk = torch.from_numpy(np.array(table[:slab])).to(dev)
    nrm = torch.from_numpy(np.array(norms[:slab])).to(dev)
    x_dev = torch.from_numpy((np.arange(qn) % slab).astype(np.int32)).to(dev)
    ts.reset_launches()
    got = ts.topk_cosine_step(q_dev, blk, nrm, x_dev, 0, GO_ROWS, k)
    big_launches = dict(ts.launches)
    check(big_launches["topk_select_sort"] == 2
          and big_launches["topk_merge_path"] == 2
          and big_launches["topk_score_keys"] == 1,
          f"Q={qn} k={k}: {big_launches}, want 1 score, 2 select/sort and "
          f"2 merge-path launches")
    want = ref.stream_step_ref(q_dev, blk, nrm, 0, GO_ROWS, x_dev, None,
                               None, k)
    s_g, i_g = (t.cpu().numpy() for t in got)
    s_w, i_w = (t.cpu().numpy() for t in want)
    big_err = float(np.abs(s_g - s_w).max())
    check(big_err <= SCORE_TOL, f"Q={qn} k={k}: score error {big_err}")
    for r in np.flatnonzero((i_g != i_w).any(axis=1)):
        relaxed_total += _ids_agree(i_g[r], i_w[r], s_w[r])
    errs["large"] = max(errs["large"], big_err)
    cases += 1
    del q_dev, blk, nrm, x_dev, got, want
    torch.cuda.synchronize()
    out = {"phase": "kernels", "cases": cases,
           "q_past_grid_y": {"Q": qn, "k": k, "slab": slab,
                             "max_abs_err": big_err,
                             "launches": big_launches},
           "max_abs_err_small": errs["small"],
           "max_abs_err_large": errs["large"],
           "tie_runs_compared_by_set": relaxed_total,
           "tolerance": {"scores": SCORE_TOL, "tie_runs": TIE_TOL}}
    emit(out)
    return out


def _kge_inputs(B: int, K: int, d: int, mask: str, t_is_h_plus_r: bool,
                gen, offset: int = 0):
    """h, r, t, neg, corrupt_head on the card; with ``offset``, each float
    tensor lies that many floats into a larger buffer (no row 16-byte
    aligned)."""
    import torch
    dev = torch.device(DEV)

    def randn(*shape):
        x = torch.randn(shape, generator=gen, device=dev)
        if not offset:
            return x
        buf = torch.empty(x.numel() + offset, device=dev)
        return buf[offset:].view(shape).copy_(x)

    h, r, t = (randn(B, d) for _ in range(3))
    if t_is_h_plus_r:
        t.copy_(h + r)              # every coordinate of h + r - t is 0
    neg = randn(B, K, d)
    if mask == "random":
        ch = torch.rand((B, K), generator=gen, device=dev) < 0.5
    else:
        ch = torch.full((B, K), mask == "true", dtype=torch.bool, device=dev)
    return h, r, t, neg, ch


def _kge_err(got, want, note: str) -> float:
    """max |got - want|; fails past KGE_TOL * (1 + |want|), the
    allclose(rtol=atol=1e-4) of the reference's own test."""
    err = 0.0
    for g, w in zip(got, want):
        diff = (g - w).abs()
        check(bool((diff <= KGE_TOL * (1 + w.abs())).all()),
              f"{note}: off by {float(diff.max())}")
        err = max(err, float(diff.max()))
    return err


def phase_kge() -> dict:
    """kge_score forward and backward kernels against their plain versions
    on the card."""
    import torch
    from repro_torch.kernels import kge_score as tk, ref

    gen = torch.Generator(device=DEV).manual_seed(SEED)
    err = {"forward": 0.0, "backward": 0.0}
    cases = exact = same_bits = 0
    grid = [(shape, 0) for shape in KGE_CASES] + [
        (shape, 1) for shape in KGE_OFFSET_CASES]
    for model in KGE_MODELS:
        for (B, K, d), offset in grid:
            for mask in ("true", "false", "random"):
                for tz in (False, True):
                    note = (f"{model} {(B, K, d)} mask={mask} t=h+r:{tz} "
                            f"offset={offset}")
                    h, r, t, neg, ch = _kge_inputs(B, K, d, mask, tz, gen,
                                                   offset)
                    g_pos = torch.randn((B,), generator=gen, device=DEV)
                    g_negs = torch.randn((B, K), generator=gen, device=DEV)
                    err["forward"] = max(err["forward"], _kge_err(
                        tk.kge_score_forward(h, r, t, neg, ch, model),
                        ref.kge_score_ref(h, r, t, neg, ch, model),
                        f"forward {note}"))
                    err["backward"] = max(err["backward"], _kge_err(
                        tk.kge_score_backward(h, r, t, neg, ch, g_pos,
                                              g_negs, model),
                        ref.kge_score_backward_ref(h, r, t, neg, ch, g_pos,
                                                   g_negs, model),
                        f"backward {note}"))
                    cases += 1
                    if tz:
                        # only the positive's cotangent: grad h, r, t
                        # exactly as the plain version (sign at 0)
                        zero = torch.zeros_like(g_negs)
                        got = tk.kge_score_backward(h, r, t, neg, ch, g_pos,
                                                    zero, model)
                        want = ref.kge_score_backward_ref(
                            h, r, t, neg, ch, g_pos, zero, model)
                        for name, a, b in zip("hrt", got[:3], want[:3]):
                            check(torch.equal(a, b), f"grad_{name} at "
                                  f"t = h + r differs from plain: {note}")
                        exact += 1
                    elif mask == "random":
                        # no atomics: a second launch gives the same bits
                        first = tk.kge_score_backward(h, r, t, neg, ch, g_pos,
                                                      g_negs, model)
                        second = tk.kge_score_backward(h, r, t, neg, ch,
                                                       g_pos, g_negs, model)
                        check(all(torch.equal(a, b)
                                  for a, b in zip(first, second)),
                              f"two backward launches differ: {note}")
                        same_bits += 1
        torch.cuda.synchronize()
    out = {"phase": "kge", "cases": cases, "exact_cases_t_eq_h_plus_r": exact,
           "same_bits_cases": same_bits,
           "max_abs_err_forward": err["forward"],
           "max_abs_err_backward": err["backward"],
           "tolerance": {"rtol": KGE_TOL, "atol": KGE_TOL}}
    emit(out)
    return out


def _swa_inputs(B: int, hq: int, hkv: int, sq: int, skv: int, hd: int,
                dtype, gen):
    import torch
    q = torch.randn((B * hq, sq, hd), generator=gen, device=DEV)
    k = torch.randn((B * hkv, skv, hd), generator=gen, device=DEV)
    v = torch.randn((B * hkv, skv, hd), generator=gen, device=DEV)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _swa_close(got, want, dtype, note: str) -> float:
    """Max abs error of ``got`` against ``want``; fails past the tolerance:
    fp32 SWA_TOL, bf16 SWA_BF16_TOL * (1 + |plain|)."""
    import torch
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    tol = SWA_TOL if dtype == torch.float32 else SWA_BF16_TOL * (1 + want.abs())
    check(bool(torch.isfinite(got).all()) and bool((diff <= tol).all()),
          f"{note}: off by {float(diff.max())}")
    return float(diff.max())


def phase_swa() -> dict:
    """The sliding-window attention kernels against their plain versions on
    the card, fp32 and bf16, over the reference's test shapes, reduced and
    full h2o-danube, and the edges of the mask: the forward; the forward's
    log-sum-exp (SWA_TOL * (1 + |plain|) in both dtypes: it is fp32 on
    both sides); the three backward kernels on the plain forward's saved
    tensors; two backward launches bit for bit on three cases."""
    import torch
    from repro_torch.kernels import ref, swa_attention as sw

    gen = torch.Generator(device=DEV).manual_seed(SEED + 11)
    err = {"float32": 0.0, "bfloat16": 0.0}
    err_lse, err_bwd, err_causal = dict(err), dict(err), dict(err)
    err_256, err_bwd_256 = dict(err), dict(err)
    cases, same_bits = [], 0
    sw.reset_launches()
    for n, (note, (B, hq, hkv, sq, skv, hd, W, off)) in enumerate(SWA_CASES):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            q, k, v = _swa_inputs(B, hq, hkv, sq, skv, hd, dtype, gen)
            want = ref.swa_attention_ref(q[None], k[None], v[None], W,
                                         off)[0]
            e = _swa_close(sw.swa_attention_forward(q, k, v, W, off), want,
                           dtype, f"swa {note} {name}")
            err[name] = max(err[name], e)
            if note.startswith("causal"):
                err_causal[name] = max(err_causal[name], e)
            if hd == 256:
                err_256[name] = max(err_256[name], e)
            # the training forward: the same output and the log-sum-exp
            o, lse = sw.swa_attention_forward(q, k, v, W, off,
                                              return_lse=True)
            _swa_close(o, want, dtype, f"swa {note} {name} (with lse)")
            lse_p = ref.swa_attention_lse_ref(q[None], k[None], W, off)[0]
            seen = torch.isfinite(lse_p)
            check(torch.equal(torch.isfinite(lse), seen),
                  f"swa {note} {name}: lse finite where the plain one is not")
            d_lse = (lse - lse_p).abs()[seen]
            check(bool((d_lse <= SWA_TOL * (1 + lse_p.abs()[seen])).all()),
                  f"swa {note} {name}: lse off by {float(d_lse.max())}")
            err_lse[name] = max(err_lse[name], float(d_lse.max()))
            # the backward on the plain forward's saved tensors
            do = torch.randn(q.shape, generator=gen, device=DEV).to(dtype)
            got = sw.swa_attention_backward(q, k, v, want, lse_p, do, W, off)
            plain = ref.swa_attention_backward_ref(
                q[None], k[None], v[None], want[None], lse_p[None], do[None],
                W, off)
            for g, w, what in zip(got, plain, ("dq", "dk", "dv")):
                e = _swa_close(g, w[0], dtype,
                               f"swa backward {what} {note} {name}")
                err_bwd[name] = max(err_bwd[name], e)
                if hd == 256:
                    err_bwd_256[name] = max(err_bwd_256[name], e)
            if n % 5 == 4 or hd == 256:
                again = sw.swa_attention_backward(q, k, v, want, lse_p, do,
                                                  W, off)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"swa backward {note} {name}: two launches differ")
                same_bits += 1
            cases.append(f"{note} {name}")
            del q, k, v, want, o, lse, lse_p, do, got, plain
    torch.cuda.synchronize()
    n_bwd = len(cases) + same_bits
    check(sw.launches == {"swa_attention_forward": 2 * len(cases),
                          "swa_attention_bwd_dot": n_bwd,
                          "swa_attention_backward_dkdv": n_bwd,
                          "swa_attention_backward_dq": n_bwd},
          f"swa: launches {sw.launches}, want one a call")
    out = {"phase": "swa", "cases": len(cases), "max_abs_err_fp32":
           err["float32"], "max_abs_err_bf16": err["bfloat16"],
           "max_abs_err_lse": err_lse,
           "max_abs_err_causal": err_causal,
           "max_abs_err_d256": err_256,
           "max_abs_err_backward_d256": err_bwd_256,
           "max_abs_err_backward_fp32": err_bwd["float32"],
           "max_abs_err_backward_bf16": err_bwd["bfloat16"],
           "backward_same_bits_cases": same_bits,
           "tolerance": {"fp32": SWA_TOL,
                         "bf16": f"{SWA_BF16_TOL} * (1 + |plain|)",
                         "lse": f"{SWA_TOL} * (1 + |plain|)"}}
    emit(out)
    return out


def _http_json(base: str, path: str, params: dict, retries: int = 3):
    url = f"{base}{path}?{urllib.parse.urlencode(params)}"
    for attempt in range(retries):
        try:
            with urllib.request.urlopen(url, timeout=60) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())
        except (ConnectionError, urllib.error.URLError):
            if attempt == retries - 1:
                raise
            time.sleep(0.1)


def phase_serve(registry_root: str, served: dict) -> dict:
    """The main path: launch.serve (client session) then HTTP."""
    import torch
    from repro_torch.api import Gateway, serve_http
    from repro_torch.core.registry import EmbeddingRegistry
    from repro_torch.core.serving import ServingEngine
    from repro_torch.kernels import ops, ref, topk_similarity as ts
    from repro_torch.launch import serve

    dev = torch.device(DEV)
    ids, labels, emb = served["ids"], served["labels"], served["emb"]
    norms = np.linalg.norm(emb, axis=1).astype(np.float32)
    emb_dev = torch.from_numpy(emb).to(dev)
    norms_dev = torch.from_numpy(norms).to(dev)

    ts.reset_launches()
    ops.reset_stream_stats()
    # ---------------- main path: client session ----------------------- #
    session = serve.main(["--registry", registry_root, "--requests", "512",
                          "--batch", "32", "--threads", "8",
                          "--device", DEV])
    torch.cuda.synchronize()
    after_session = dict(ts.launches)
    check(sum(after_session[n] for n in SMALL_ENTRY) > 0,
          "serve session launched no top-k kernel")

    # ---------------- main path: HTTP over the gateway ---------------- #
    engine = ServingEngine(EmbeddingRegistry(registry_root), device=DEV)
    gw = Gateway(engine, max_batch=32, flush_after_ms=2.0)
    server = serve_http(gw, port=0)
    rng = np.random.default_rng(SEED + 1)
    n = len(ids)
    counts = {"sim": 0, "closest-concepts": 0, "get-vector": 0,
              "download": 0, "autocomplete": 0}
    sim_bits_exact = 0
    lat_lock = threading.Lock()
    closest_answers = []
    try:
        base = server.url

        def closest(row: int, k: int):
            st, body = _http_json(base, "/closest-concepts/go/transe",
                                  {"query": ids[row], "k": k})
            with lat_lock:
                closest_answers.append((row, k, st, body))

        jobs = [(int(r), 10) for r in rng.integers(0, n, 160)]
        jobs += [(int(r), 2000) for r in rng.integers(0, n, 16)]
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(lambda a: closest(*a), jobs))
        torch.cuda.synchronize()
        for row, k, st, body in closest_answers:
            check(st == 200, f"closest-concepts {ids[row]} k={k}: {body}")
            q = unit_rows(emb, norms, [row])
            s_ref, i_ref, v_ref = ref.topk_cosine_blocked_ref(
                torch.from_numpy(q).to(dev), emb_dev, k,
                exclude_rows=torch.tensor([row], dtype=torch.int32,
                                          device=dev),
                norms=norms_dev, block_n=ops.STREAM_BLOCK_ROWS)
            nv = int(v_ref[0])
            hits = body["results"]
            check(len(hits) == nv, f"closest {ids[row]}: {len(hits)} hits")
            s_got = np.array([h["score"] for h in hits], np.float64)
            i_got = np.array([int(h["identifier"][3:]) for h in hits])
            s_plain = s_ref[0, :nv].cpu().numpy().astype(np.float64)
            check(float(np.abs(s_got - s_plain).max()) <= SCORE_TOL,
                  f"closest {ids[row]}: scores off")
            _ids_agree(i_got, i_ref[0, :nv].cpu().numpy(), s_plain)
            check(all(h["label"] == labels[int(h["identifier"][3:])]
                      for h in hits), "closest: labels do not match ids")
            counts["closest-concepts"] += 1
        for _ in range(100):
            a, b = (int(x) for x in rng.integers(0, n, 2))
            st, body = _http_json(base, "/sim/go/transe",
                                  {"a": ids[a], "b": labels[b]})
            check(st == 200, f"sim: {body}")
            ua, ub = unit_rows(emb, norms, [a]), unit_rows(emb, norms, [b])
            want = float(np.einsum("ij,ij->i", ua, ub)[0])
            check(abs(body["score"] - want) <= 1e-6, "sim score off")
            sim_bits_exact += body["score"] == want
            counts["sim"] += 1
        for r in rng.integers(0, n, 50):
            st, body = _http_json(base, "/get-vector/go/transe",
                                  {"query": ids[int(r)]})
            check(st == 200 and body["vector"] == [float(x) for x in emb[r]],
                  f"get-vector {ids[int(r)]} differs from the table row")
            counts["get-vector"] += 1
        for off in range(0, 20 * 97, 97):
            st, body = _http_json(base, "/download/go/transe",
                                  {"offset": off, "limit": 13})
            check(st == 200 and [r[0] for r in body["rows"]]
                  == ids[off:off + 13] and all(
                      r[1] == [float(x) for x in emb[off + j]]
                      for j, r in enumerate(body["rows"])),
                  f"download page at {off} differs")
            counts["download"] += 1
        norm_labels = sorted({" ".join(x.lower().split()) for x in labels})
        for r in rng.integers(0, n, 50):
            prefix = labels[int(r)][:-4]
            st, body = _http_json(base, "/autocomplete/go/transe",
                                  {"prefix": prefix, "limit": 5})
            p = " ".join(prefix.lower().split())
            want = [x for x in norm_labels if x.startswith(p)][:5]
            check(st == 200 and [" ".join(c.lower().split())
                                 for c in body["completions"]] == want,
                  f"autocomplete {prefix!r}")
            counts["autocomplete"] += 1
        stats = gw.stats()
    finally:
        server.close()
        gw.close()
    torch.cuda.synchronize()
    launches = dict(ts.launches)
    check(sum(launches[x] for x in SMALL_ENTRY)
          > sum(after_session[x] for x in SMALL_ENTRY),
          "HTTP phase launched no small-k kernel")
    check(all(launches[x] > 0 for x in LARGE_ENTRY),
          "k=2000 requests launched no large-k kernel")
    out = {"phase": "serve", "session": session, "http_requests": counts,
           "sim_bit_exact": sim_bits_exact,
           "stream_stats": dict(ops.stream_stats),
           "scheduler_batches": stats.scheduler["batches"],
           "launches": launches}
    emit(out)
    return out


#: the shard phase: (rows, shards) of the sharded tables (40,000 rows do
#: not divide by 3: two pad rows), then queries and k a case
SHARD_TABLES = ((GO_ROWS, 4), (GO_ROWS, 3), (SCALE_ROWS, 4), (SCALE_ROWS, 3))
SHARD_QK = ((1, 10), (32, 10), (1, 2000), (32, 2000))


def phase_shard(registry_root: str, served: dict, store_tables,
                card: str) -> dict:
    """The sharded serving path on the card, its shards on one card
    (``ServingMesh.of((cuda:0,) * S)``): first the main path, a sharded
    ``ServingEngine`` over the serve phase's registry answering
    closest-concepts through the ``Gateway`` with the unsharded engine's
    bodies; then every (table, S, Q, k) case of ``SHARD_TABLES`` x
    ``SHARD_QK`` held to the unsharded ``topk_cosine`` on the card
    (identical indices, ``valid`` and scores) and to the plain version
    (the same function on CPU shards: ``valid``, scores within 1e-5, ids
    under the near-tie rule), with ``device_table_bytes()`` equal to the
    shards' bytes; the ms of a sharded and of the streamed 40k call; then
    the dry run over every arch, shape and mesh on the meta device."""
    import torch
    from repro_torch.api import Gateway
    from repro_torch.core.registry import EmbeddingRegistry
    from repro_torch.core.serving import EmbeddingIndex, ServingEngine
    from repro_torch.kernels import ops, topk_similarity as ts
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import ServingMesh

    dev = torch.device(DEV)
    ids = served["ids"]
    rng = np.random.default_rng(SEED + 27)
    t_phase = time.perf_counter()
    # ---------------- main path: the sharded engine ------------------- #
    reg = EmbeddingRegistry(registry_root)
    mesh4 = ServingMesh.of((dev,) * 4)
    gws = {name: Gateway(ServingEngine(reg, device=DEV, mesh=m),
                         max_batch=32, flush_after_ms=2.0)
           for name, m in (("sharded", mesh4), ("single", None))}
    asks = [(int(r), 10) for r in rng.integers(0, GO_ROWS, 48)]
    asks += [(int(r), 2000) for r in rng.integers(0, GO_ROWS, 6)]
    bodies = {}
    try:
        for name, gw in gws.items():
            def ask(a, gw=gw):
                return json.dumps(gw.handle("/closest-concepts/go/transe",
                                            {"query": ids[a[0]], "k": a[1]}))
            if name == "sharded":
                torch.cuda.synchronize()
                ts.reset_launches()
            with ThreadPoolExecutor(8) as pool:
                bodies[name] = list(pool.map(ask, asks))
            torch.cuda.synchronize()
            if name == "sharded":
                launches = dict(ts.launches)
        index = gws["sharded"].engine._index("go", "transe")
    finally:
        for gw in gws.values():
            gw.close()
    check(index.mesh is mesh4, "the engine's index is not sharded")
    check(all(launches[e] > 0 for e in SMALL_ENTRY + LARGE_ENTRY),
          f"the sharded engine missed a top-k entry point: {launches}")
    check(all('"results"' in b for b in bodies["sharded"]),
          "a sharded closest-concepts request failed")
    same = sum(a == b for a, b in zip(bodies["sharded"], bodies["single"]))
    check(same == len(asks), f"{len(asks) - same} of {len(asks)} sharded "
          f"bodies differ from the unsharded engine's")
    out = {"phase": "shard", "launches": launches,
           "engine_requests": len(asks), "engine_bodies_equal": same}
    # ---------------- the cases, at full width ------------------------ #
    cases, ms = [], {}
    for rows, s in SHARD_TABLES:
        table, norms = store_tables[rows]
        names = ids if rows == GO_ROWS else [f"GO:{i:07d}"
                                             for i in range(rows)]
        idx = EmbeddingIndex(names, names, table, norms=norms, device=DEV,
                             mesh=ServingMesh.of((dev,) * s))
        blocks, nblocks = idx._table_sharded, idx._norms_sharded
        local = blocks[0].shape[0]
        shard_bytes = sum(t.numel() * t.element_size()
                          for t in blocks + nblocks)
        check(idx.device_table_bytes() == shard_bytes
              == local * s * (D + 1) * 4,
              f"{rows} rows / {s}: device_table_bytes "
              f"{idx.device_table_bytes()} != {shard_bytes}")
        cpu = ServingMesh.of(("cpu",) * s)
        pb, pn, _ = ops.shard_table_raw(table, norms, cpu)
        whole = torch.from_numpy(np.array(table)).to(dev)
        whole_n = torch.from_numpy(np.array(norms)).to(dev)
        for qn, k in SHARD_QK:
            qrows = np.concatenate([[local - 1, local, rows - 1][:qn],
                                    rng.integers(0, rows, max(0, qn - 3))])
            q = unit_rows(table, norms, qrows)
            excl = qrows.astype(np.int32)
            got = ops.topk_cosine_sharded(q, blocks, k, exclude_rows=excl,
                                          mesh=idx.mesh, n_valid=rows,
                                          norms=nblocks)
            one = ops.topk_cosine(q, whole, k, exclude_rows=excl,
                                  norms=whole_n)
            torch.cuda.synchronize()
            note = f"shard {rows}/{s} Q={qn} k={k}"
            g = [t.cpu() for t in got]
            for a, b, what in zip(g, one, ("scores", "ids", "valid")):
                check(torch.equal(a, b.cpu()), f"{note}: {what} differ from "
                      f"the unsharded kernel call")
            plain = ops.topk_cosine_sharded(q, pb, k, exclude_rows=excl,
                                            mesh=cpu, n_valid=rows, norms=pn)
            cases.append({"rows": rows, "shards": s, "Q": qn, "k": k,
                          "pad_rows": local * s - rows,
                          **compare(got, plain, note)})
        if rows == GO_ROWS:
            q = unit_rows(table, norms, rng.integers(0, rows, 32))
            ms[f"sharded_{s}"] = _cuda_ms(lambda: ops.topk_cosine_sharded(
                q, blocks, 10, mesh=idx.mesh, n_valid=rows, norms=nblocks))
            if s == 4:
                staging = ops.StagingPool()
                ms["streamed"] = _cuda_ms(lambda: ops.topk_cosine(
                    q, table, 10, norms=norms, device=dev, staging=staging))
        del idx, blocks, nblocks, whole, whole_n, pb, pn
        torch.cuda.empty_cache()
    out["cases"] = cases
    out["ms_q32_k10_40k"] = ms
    out["max_abs_err"] = max(c["max_abs_err"] for c in cases)
    # ---------------- the dry run ------------------------------------- #
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        check(dryrun.main(["--all", "--mesh", "both", "--out", d]) == 0,
              "the dry run failed")
        recs = [json.loads(p.read_text()) for p in Path(d).glob("*.json")]
    out["dryrun"] = {"tags": len(recs),
                     "ok": sum(r["status"] == "ok" for r in recs),
                     "seconds": time.perf_counter() - t0}
    out["seconds"] = time.perf_counter() - t_phase
    out["card"] = card
    emit(out)
    return out


#: the workers phase: HTTP client sessions (keep-alive connections, one
#: per thread) against one serving process, then a pool of 2; a
#: session is ``benchmarks/bench_http.py`` ``run_mp``'s (16 clients,
#: 2,048 requests, k = 10), run WORKER_SESSIONS times a pool on rows no
#: other session asks for (no result-cache hits), so each pool gets a
#: median and a spread over fresh connection-to-worker splits (2 since
#: the recurrentgemma phase and training run joined the script, 3
#: before); pools of 2 beside the single process (pools of 2 and 4 until
#: then: 4 workers gave little more than 2).  Both are depth cuts that
#: keep the whole script near 820 s of phases
WORKER_POOLS = (2,)
WORKER_THREADS, WORKER_REQUESTS, WORKER_K = 16, 2048, 10
WORKER_SESSIONS = 2
WATCH_INTERVAL_S = 0.25     # WorkerPool's default store-watch interval


def _env_src() -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    return env


def _start_server(registry_root: str, workers: int, state_dir: str,
                  extra=()):
    """``python -m repro_torch.launch.serve --http 0 [--workers N]
    [extra...]`` in a process of its own (this one holds a CUDA context,
    which must not cross the pool's fork); returns (process, port) once it
    serves."""
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--registry",
           registry_root, "--http", "0", "--device", DEV, "--batch", "32",
           *extra]
    if workers > 1:
        cmd += ["--workers", str(workers), "--state-dir", state_dir]
    log = open(Path(state_dir) / f"serve-{workers}.log", "w")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=log,
                            text=True, env=_env_src(), cwd=str(ROOT))
    lines = []

    def read():
        for line in proc.stdout:
            lines.append(line)

    threading.Thread(target=read, daemon=True).start()
    deadline = time.monotonic() + 240
    port = None
    while time.monotonic() < deadline and port is None:
        for line in list(lines):
            m = re.search(r"HTTP service on http://127\.0\.0\.1:(\d+)", line)
            if m:
                port = int(m.group(1))
        if proc.poll() is not None:
            break
        time.sleep(0.1)
    if port is None:
        proc.kill()
        log.close()
        raise SmokeFailure(
            f"launch.serve --workers {workers} did not come up: "
            f"{''.join(lines)[-2000:]} "
            f"{(Path(state_dir) / f'serve-{workers}.log').read_text()[-3000:]}")
    for _ in range(600):
        try:
            st, _ = _http_get(port, "/health")
            if st == 200:
                break
        except OSError:
            time.sleep(0.1)
    proc.log = log
    return proc, port


def _stop_server(proc) -> None:
    proc.terminate()
    try:
        proc.wait(timeout=60)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
    proc.log.close()


def _http_req(port: int, method: str, path: str, body=None,
              headers=None, timeout: float = 60):
    """One request on a fresh connection: (status, headers, body bytes)."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path,
                     body=None if body is None else json.dumps(body),
                     headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _http_get(port: int, path: str, timeout: float = 60):
    """One GET on a fresh connection: (status, body bytes)."""
    st, _, body = _http_req(port, "GET", path, timeout=timeout)
    return st, body


#: one client process of the workers phase's HTTP session: stdlib only,
#: ``threads`` keep-alive connections; reads its job as one JSON line,
#: says "ready", waits for "go", answers one JSON line
_CLIENT = r"""
import http.client, json, sys, threading, time
job = json.loads(sys.stdin.readline())
port, paths = job["port"], job["paths"]
chunks = [list(range(i, len(paths), job["threads"]))
          for i in range(job["threads"])]
res, lock = {"lat": [], "answers": [], "errors": []}, threading.Lock()
def get(conn, path):
    conn.request("GET", path)
    r = conn.getresponse()
    return r.status, r.read().decode()
def client(mine):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    lat, got, errs = [], [], []
    for i in mine:
        t0 = time.perf_counter()
        for attempt in range(3):
            try:
                st, body = get(conn, paths[i])
                break
            except (OSError, http.client.HTTPException) as e:
                # the connection's worker died: reconnect, and the kernel
                # routes the new connection to a live worker
                errs.append(repr(e))
                conn.close()
                conn = http.client.HTTPConnection("127.0.0.1", port,
                                                  timeout=60)
        else:
            st, body = 0, ""
        lat.append((time.perf_counter() - t0) * 1e3)
        got.append((i, st, body))
    conn.close()
    with lock:
        res["lat"] += lat
        res["answers"] += got
        res["errors"] += errs
ths = [threading.Thread(target=client, args=(c,)) for c in chunks]
print("ready", flush=True)
sys.stdin.readline()
cpu0, res["t0"] = time.process_time(), time.time()
for t in ths:
    t.start()
for t in ths:
    t.join()
res["t1"], res["cpu_s"] = time.time(), time.process_time() - cpu0
print(json.dumps(res), flush=True)
"""
#: client processes of the session (its threads split over them), so the
#: client's own GIL does not cap what the servers answer
CLIENT_PROCS = 4


def _client_session(port: int, ids, rows, k: int, threads: int):
    """``threads`` clients, each with one keep-alive connection, spread
    over CLIENT_PROCS processes, send the closest-concepts requests of
    ``rows``; returns (seconds, latencies ms, answers [(row, status,
    body)], errors, client CPU share: CPU seconds per wall second of the
    busiest client process)."""
    procs = []
    for c in range(CLIENT_PROCS):
        mine = rows[c::CLIENT_PROCS]
        p = subprocess.Popen([sys.executable, "-c", _CLIENT],
                             stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                             text=True)
        p.stdin.write(json.dumps({
            "port": port, "threads": threads // CLIENT_PROCS,
            "paths": [f"/closest-concepts/go/transe?query={ids[r]}&k={k}"
                      for r in mine]}) + "\n")
        p.stdin.flush()
        procs.append((p, mine))
    for p, _ in procs:
        check(p.stdout.readline().strip() == "ready", "client did not start")
    for p, _ in procs:
        p.stdin.write("go\n")
        p.stdin.flush()
    lat, answers, errors, outs = [], [], [], []
    for p, mine in procs:
        line = p.stdout.readline()
        p.wait(timeout=60)
        check(p.returncode == 0 and line, "an HTTP client process failed")
        out = json.loads(line)
        outs.append(out)
        lat += out["lat"]
        errors += out["errors"]
        answers += [(mine[i], st, body) for i, st, body in out["answers"]]
    seconds = max(o["t1"] for o in outs) - min(o["t0"] for o in outs)
    cpu_share = max(o["cpu_s"] / max(o["t1"] - o["t0"], 1e-9) for o in outs)
    return seconds, lat, answers, errors, cpu_share


def _gpu_pids() -> list:
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi compute-apps: {out.stderr}")
    return [int(x) for x in out.stdout.split() if x.strip().isdigit()]


def phase_workers(registry_root: str, served: dict) -> dict:
    """Pre-forked multi-process serving on the card, through
    ``launch.serve --http 0 --workers N``: the same client session against
    one process and a pool of 2 (``WORKER_POOLS``), every answer against
    the plain top-k, the merged /stats count, a worker SIGKILLed under load and
    restarted, a publish adopted by every worker, and every worker pid
    holding a CUDA context."""
    import torch
    from repro_torch.api.workers import read_worker_states
    from repro_torch.core.registry import EmbeddingRegistry
    from repro_torch.kernels import ops, ref

    dev = torch.device(DEV)
    ids, labels, emb = served["ids"], served["labels"], served["emb"]
    n = len(ids)
    norms = np.linalg.norm(emb, axis=1).astype(np.float32)
    rng = np.random.default_rng(SEED + 21)
    # distinct rows: 256 to warm up, WORKER_SESSIONS timed sessions, and
    # 1,024 for the SIGKILL session; every pool gets the same sessions
    perm = [int(r) for r in rng.permutation(n)]
    warm_rows = perm[:256]
    sessions = [perm[256 + i * WORKER_REQUESTS:256 + (i + 1) * WORKER_REQUESTS]
                for i in range(WORKER_SESSIONS)]
    kill_rows = perm[256 + WORKER_SESSIONS * WORKER_REQUESTS:][:1024]
    # the plain top-k of every query row, once, on the card
    uniq = sorted(set(perm[:256 + WORKER_SESSIONS * WORKER_REQUESTS + 1024]))
    s_ref, i_ref, v_ref = ref.topk_cosine_blocked_ref(
        torch.from_numpy(unit_rows(emb, norms, uniq)).to(dev),
        torch.from_numpy(emb).to(dev), WORKER_K,
        exclude_rows=torch.tensor(uniq, dtype=torch.int32, device=dev),
        norms=torch.from_numpy(norms).to(dev),
        block_n=ops.STREAM_BLOCK_ROWS)
    plain = {r: (s_ref[j].cpu().numpy(), i_ref[j].cpu().numpy(),
                 int(v_ref[j])) for j, r in enumerate(uniq)}
    del s_ref, i_ref, v_ref
    torch.cuda.empty_cache()

    def check_answers(answers, note):
        ties = 0
        for row, st, body in answers:
            check(st == 200, f"{note}: closest {ids[row]} answered {st}")
            hits = json.loads(body)["results"]
            s_p, i_p, nv = plain[row]
            check(len(hits) == nv, f"{note}: {len(hits)} hits, want {nv}")
            s_got = np.array([h["score"] for h in hits], np.float64)
            check(float(np.abs(s_got - s_p[:nv]).max()) <= SCORE_TOL,
                  f"{note}: closest {ids[row]} scores off the plain top-k")
            ties += _ids_agree(
                np.array([int(h["identifier"][3:]) for h in hits]),
                i_p[:nv], s_p[:nv].astype(np.float64))
        return ties

    # compute processes on the card before any server: this one
    base_procs = len(_gpu_pids())
    runs = {}
    lap = laps("workers")
    reg = EmbeddingRegistry(registry_root)
    v_latest = reg.store.latest_version("go")
    for n_proc in (1,) + WORKER_POOLS:
        state = tempfile.mkdtemp(prefix=f"biokg-workers{n_proc}-",
                                 dir=registry_root)
        # the previous server's processes have left the card
        deadline = time.monotonic() + 30
        while len(_gpu_pids()) > base_procs and time.monotonic() < deadline:
            time.sleep(0.2)
        t_up = time.perf_counter()
        proc, port = _start_server(registry_root, n_proc, state)
        up_s = time.perf_counter() - t_up
        try:
            run = {"processes": n_proc, "startup_s": up_s}
            if n_proc > 1:
                # one request per fresh connection until every worker has
                # served through the kernel (SO_REUSEPORT spreads accepts)
                deadline = time.monotonic() + 120
                while time.monotonic() < deadline:
                    for r in warm_rows[:16]:
                        _http_get(port, f"/closest-concepts/go/transe?"
                                        f"query={ids[r]}&k={WORKER_K}")
                    time.sleep(1.2)
                    states = read_worker_states(state)
                    if len(states) == n_proc and all(
                            sum(x["kernel_launches"].values()) > 0
                            for x in states):
                        break
                pids = sorted(x["pid"] for x in states)
                check(len(pids) == n_proc and all(
                    sum(x["kernel_launches"].values()) > 0 for x in states),
                      f"pool of {n_proc}: not every worker served through "
                      f"the top-k kernel: "
                      f"{[(x['pid'], x['kernel_launches']) for x in states]}")
                gpu = _gpu_pids()
                sup = json.loads((Path(state) / "supervisor.json").read_text())
                run["worker_pids"] = pids
                run["nvidia_smi_pids"] = gpu
                run["card_processes"] = {"before": base_procs,
                                         "with_pool": len(gpu)}
                if set(pids) <= set(gpu):
                    check(proc.pid not in gpu, f"the pool's parent "
                                               f"{proc.pid} holds a CUDA "
                                               f"context")
                    run["pids_matched"] = True
                else:
                    # nvidia-smi reports the pids of another pid namespace
                    # (in a container every entry may read 1): then the
                    # card must list exactly one more process per worker
                    check(len(gpu) - base_procs == n_proc,
                          f"pool of {n_proc}: the card lists {len(gpu)} "
                          f"compute processes ({gpu}), {base_procs} before "
                          f"the pool; want one more per worker")
                    run["pids_matched"] = False
                check(sup["cuda_initialized"] is False,
                      f"the pool's parent {proc.pid} initialised CUDA")
                check(all(x["device"].startswith("cuda") for x in states),
                      f"workers on {[x['device'] for x in states]}")
            # warm every worker's padding buckets, then the timed session
            _client_session(port, ids, warm_rows, WORKER_K, WORKER_THREADS)
            sent_before = None
            if n_proc > 1:
                time.sleep(1.2)
                sent_before = json.loads(_http_get(port, "/stats")[1])
            timed, ties, cpu_share = [], 0, 0.0
            for rows in sessions:
                dt, lat, answers, errors, cpu = _client_session(
                    port, ids, rows, WORKER_K, WORKER_THREADS)
                check(not errors,
                      f"{n_proc} processes: client errors {errors}")
                ties += check_answers(answers, f"{n_proc} proc")
                cpu_share = max(cpu_share, cpu)
                lat_ms = np.array(lat)
                timed.append({"seconds": dt, "qps": len(rows) / dt,
                              "p50_ms": float(np.percentile(lat_ms, 50)),
                              "p99_ms": float(np.percentile(lat_ms, 99))})
            run["ties_by_set"] = ties
            run.update({"requests_per_session": WORKER_REQUESTS,
                        "sessions": timed, "threads": WORKER_THREADS,
                        "client_processes": CLIENT_PROCS,
                        "client_cpu_share": cpu_share, "k": WORKER_K})
            for key in ("qps", "p50_ms", "p99_ms"):
                vals = [x[key] for x in timed]
                run[key] = float(np.median(vals))
                run[key + "_range"] = [min(vals), max(vals)]
            if n_proc > 1:
                # ---- merged /stats: the pool saw what was sent -------- #
                want = sent_before["gateway"]["by_route"].get(
                    "closest-concepts", 0) + WORKER_SESSIONS * WORKER_REQUESTS
                deadline = time.monotonic() + 15
                while time.monotonic() < deadline:
                    st = json.loads(_http_get(port, "/stats")[1])
                    got = st["gateway"]["by_route"].get("closest-concepts")
                    if got == want and st["workers"]["count"] == n_proc:
                        break
                    time.sleep(0.3)
                check(got == want and st["workers"]["count"] == n_proc,
                      f"pool of {n_proc}: merged /stats counts {got} "
                      f"closest-concepts requests, {want} were sent")
                run["merged_closest_requests"] = got
                run["per_worker_requests"] = sorted(
                    x["stats"]["gateway"]["by_route"].get(
                        "closest-concepts", 0)
                    for x in read_worker_states(state))
                # ---- SIGKILL one worker under load -------------------- #
                victim = st["workers"]["pids"][0]
                load = {}

                def under_load():
                    load["out"] = _client_session(
                        port, ids, kill_rows, WORKER_K, WORKER_THREADS)

                th = threading.Thread(target=under_load)
                th.start()
                time.sleep(0.3)
                os.kill(victim, signal.SIGKILL)
                th.join()
                _, _, k_answers, k_errors, _ = load["out"]
                five = [st_ for _, st_, _ in k_answers if st_ >= 500]
                check(not five, f"pool of {n_proc}: {len(five)} 5xx "
                                f"after SIGKILL")
                check(len(k_errors) <= WORKER_THREADS,
                      f"pool of {n_proc}: {len(k_errors)} connection errors"
                      f" after SIGKILL, more than its connections")
                check_answers(k_answers, f"{n_proc} proc under SIGKILL")
                deadline = time.monotonic() + 60
                while time.monotonic() < deadline:
                    w = json.loads(_http_get(port, "/stats")[1])["workers"]
                    if w["count"] == n_proc and w["restarts"] >= 1 \
                            and victim not in w["pids"]:
                        break
                    time.sleep(0.3)
                check(w["count"] == n_proc and w["restarts"] >= 1
                      and victim not in w["pids"],
                      f"pool of {n_proc}: worker {victim} not restarted: {w}")
                run["restart"] = {"victim": victim,
                                  "connection_errors": len(k_errors),
                                  "http_5xx": len(five),
                                  "restarts": w["restarts"]}
                # ---- publish: every worker adopts the sealed version -- #
                scale = float(2 ** (len(runs)))
                v_new = f"2025-0{3 + len(runs) - 1}"
                before = {x["pid"]: x["adoptions"]
                          for x in read_worker_states(state)}
                t_pub = time.perf_counter()
                reg.publish("go", v_new, "transe", ids, labels, emb * scale,
                            ontology_checksum=f"seed-{SEED}-x{scale:g}",
                            hyperparameters={"dim": D, "seed": SEED},
                            generated_at="2025-01-01T00:00:00+00:00")
                reg.seal("go", v_new)
                t_seal = time.perf_counter()
                deadline = time.monotonic() + 30
                while time.monotonic() < deadline:
                    states = read_worker_states(state)
                    if len(states) == n_proc and all(
                            x["adoptions"] > before.get(x["pid"], 0)
                            or x["pid"] not in before for x in states):
                        break
                    time.sleep(0.05)
                adopt_s = time.perf_counter() - t_seal
                check(all(x["adoptions"] > before.get(x["pid"], 0)
                          for x in states if x["pid"] in before),
                      f"pool of {n_proc}: not every worker adopted {v_new}")
                for r in warm_rows[:32]:      # fresh connections: any worker
                    st_, body = _http_get(
                        port, f"/get-vector/go/transe?query={ids[r]}")
                    got_v = json.loads(body)
                    check(st_ == 200 and got_v["version"] == v_new
                          and got_v["vector"] == [float(x) for x in
                                                  emb[r] * scale],
                          f"pool of {n_proc}: get-vector not from {v_new}")
                run["publish"] = {"version": v_new,
                                  "publish_s": t_seal - t_pub,
                                  "adopted_by_all_s": adopt_s,
                                  "watch_interval_s": WATCH_INTERVAL_S}
                v_latest = v_new
                states = read_worker_states(state)
                run["kernel_launches_by_worker"] = {
                    x["pid"]: x["kernel_launches"] for x in states}
        finally:
            _stop_server(proc)
        runs[n_proc] = run
        emit({"phase": "workers", **run})
        lap(f"{n_proc} processes")
    out = {"phase": "workers", "runs": runs, "latest_version": v_latest,
           "qps": {p: r["qps"] for p, r in runs.items()},
           "p50_ms": {p: r["p50_ms"] for p, r in runs.items()},
           "p99_ms": {p: r["p99_ms"] for p, r in runs.items()},
           "qps_range": {p: r["qps_range"] for p, r in runs.items()},
           "vs_one_process": {p: r["qps"] / runs[1]["qps"]
                              for p, r in runs.items()}}
    emit({k: v for k, v in out.items() if k != "runs"})
    return out


_RELEASES: dict = {}


def go_releases():
    """v1: the synthetic GO at 40k terms (40,000 entities, 61,749 triples);
    v2: one low-churn release later."""
    if not _RELEASES:
        from repro_torch.configs.go_kge import CONFIG
        from repro_torch.ontology.synthetic import evolve, generate
        kg1 = generate(CONFIG.spec, seed=0, n_terms=CONFIG.n_terms)
        kg2 = evolve(kg1, CONFIG.spec, seed=1000, **CALM)
        _RELEASES.update(v1=("2025-01-01", kg1), v2=("2025-07-01", kg2))
    return _RELEASES["v1"], _RELEASES["v2"]


#: steps over which a replayed step's losses are held to the eager step's
GRAPH_CHECK_STEPS = 50
#: relative tolerance of that comparison: the index scatter-adds sum
#: colliding rows in whatever order their atomics land
GRAPH_LOSS_RTOL = 1e-4


def _graph_against_eager(trainer, triples, steps: int) -> dict:
    """The losses of ``steps`` steps run by ``train_step.step`` and by a
    :class:`GraphedStep` (warm-up steps, one capture, replays), each from
    the same init, loader and generator seed; fails unless every replayed
    step's loss is within ``GRAPH_LOSS_RTOL`` of the eager one's."""
    import torch
    from repro_torch.data import TripleLoader
    from repro_torch.kge.train import GRAPH_WARMUP_STEPS, GraphedStep

    losses = {}
    for form in ("eager", "graph"):
        params, opt_state = trainer.init()
        loader = iter(TripleLoader(triples, trainer.cfg.batch_size))
        gen = trainer.generator(1)
        if form == "eager":
            got = [float(trainer.train_step.step(
                params, opt_state,
                torch.from_numpy(next(loader)).to(DEV, torch.int64), gen))
                for _ in range(steps)]
        else:
            graphed = GraphedStep(trainer, params, opt_state)
            got = [float(x) for x in graphed.warm_up(loader, gen,
                                                     GRAPH_WARMUP_STEPS)]
            graphed.capture()
            got += [float(graphed.replay(next(loader), gen))
                    for _ in range(steps - GRAPH_WARMUP_STEPS)]
            check(graphed.replays == steps - GRAPH_WARMUP_STEPS,
                  f"{graphed.replays} replays in {steps} steps")
            del graphed
        losses[form] = np.array(got)
        del params, opt_state
    eager, graph = losses["eager"], losses["graph"]
    rel = np.abs(graph - eager) / np.maximum(np.abs(eager), 1e-30)
    check(bool(np.isfinite(graph).all())
          and float(rel.max()) <= GRAPH_LOSS_RTOL,
          f"{trainer.model.spec.name}: a replayed step's loss differs from "
          f"the eager step's by {float(rel.max()):.3g} relative")
    return {"steps": steps, "max_rel_loss_diff": float(rel.max()),
            "first_loss": float(eager[0]), "last_loss": float(eager[-1])}


def graphed_step_numbers(steps: int = 30) -> dict:
    """TransE's and DistMult's GO-size training step as ``KGETrainer.fit``
    runs it on the card: warm-up steps, one capture, then one replay a step
    (its batch staged and its negatives drawn outside the graph).  Per
    model: the replayed step's losses against the eager step's over
    ``GRAPH_CHECK_STEPS`` steps; the kge_score launches a capture records;
    wall and device ms a replayed step (torch.profiler), ms a step and
    steps/s unprofiled, and the replays."""
    from repro_torch.configs.go_kge import CONFIG
    from repro_torch.data import TripleLoader
    from repro_torch.kernels import kge_score as tk
    from repro_torch.kge import KGETrainer, make_model
    from repro_torch.kge.train import GRAPH_WARMUP_STEPS, GraphedStep

    (_, kg1), _ = go_releases()
    out = {}
    for name in ("transe", "distmult"):
        model = make_model(name, kg1.num_entities, kg1.num_relations,
                           dim=CONFIG.dim)
        trainer = KGETrainer(model, CONFIG.train, device=DEV)
        against_eager = _graph_against_eager(trainer, kg1.triples,
                                             GRAPH_CHECK_STEPS)
        params, opt_state = trainer.init()
        loader = iter(TripleLoader(kg1.triples, CONFIG.train.batch_size))
        gen = trainer.generator(1)
        graphed = GraphedStep(trainer, params, opt_state)
        graphed.warm_up(loader, gen, GRAPH_WARMUP_STEPS)
        before = dict(tk.launches)
        graphed.capture()
        per_replay = {e: tk.launches[e] - before[e] for e in before}

        def one():
            graphed.replay(next(loader), gen)

        rec = {"model": name, "against_eager": against_eager,
               "launches_per_replay": per_replay,
               **_step_breakdown(one, steps)}
        rec["unprofiled_ms_per_step"] = _host_ms(one, iters=200, warmup=5)
        rec["steps_per_s_unprofiled"] = 1e3 / rec["unprofiled_ms_per_step"]
        rec["graph_replays"] = graphed.replays
        emit({"graphed_step": rec})
        out[name] = rec
        del graphed, params, opt_state
    return out


def phase_update(tmp: str) -> dict:
    """The update path at full width and budget: publish v1, update to v2
    incrementally, train a cold v2, serve v2 from the invalidated engine,
    compare MRR warm against cold."""
    import torch
    from repro_torch.api import Gateway
    from repro_torch.configs.go_kge import CONFIG
    from repro_torch.core.registry import EmbeddingRegistry
    from repro_torch.core.serving import ServingEngine
    from repro_torch.core.updater import SyntheticReleaseChannel, Updater
    from repro_torch.kernels import kge_score as tk, ops, ref
    from repro_torch.kernels import topk_similarity as ts
    from repro_torch.kge import make_model, params_from_numpy, rank_based_eval
    from repro_torch.kge.train import GRAPH_WARMUP_STEPS

    (v1, kg1), (v2, kg2) = go_releases()
    check((kg1.num_entities, kg1.num_triples) == (CONFIG.n_terms, GO_TRIPLES),
          f"GO release: {kg1.num_entities} entities, {kg1.num_triples} "
          f"triples")
    warm_reg = EmbeddingRegistry(Path(tmp) / "warm")
    cold_reg = EmbeddingRegistry(Path(tmp) / "cold")
    engine = ServingEngine(warm_reg, device=DEV)
    gw = Gateway(engine, max_batch=32, flush_after_ms=2.0)
    warm = Updater(warm_reg, engine=engine, models=UPDATE_MODELS,
                   dim=CONFIG.dim, train_cfg=CONFIG.train,
                   steps_override=UPDATE_STEPS, device=DEV)
    cold = Updater(cold_reg, models=UPDATE_MODELS, dim=CONFIG.dim,
                   train_cfg=CONFIG.train, steps_override=UPDATE_STEPS,
                   device=DEV)
    channel = SyntheticReleaseChannel("go")
    reports = {}

    tk.reset_launches()
    ts.reset_launches()
    # ----------------- main path: publish, update, serve -------------- #
    lap = laps("update")
    channel.bump(v1, kg1)
    reports["v1"] = warm.run_once(channel, seed=0)
    lap("v1")
    check(reports["v1"].mode == "full", f"v1: {reports['v1'].reason}")
    for m in UPDATE_MODELS:      # the engine serves v1 before the update
        gw.closest_concepts("go", m, kg1.entities[0], k=10)
    channel.bump(v2, kg2)
    reports["v2_warm"] = warm.run_once(channel, seed=1)
    lap("v2_warm")
    check(reports["v2_warm"].mode == "incremental",
          f"v2: {reports['v2_warm'].mode} ({reports['v2_warm'].reason})")
    check(engine.latest_version("go") == v2, "engine not invalidated to v2")
    reports["v2_cold"] = cold.run_once(
        SyntheticReleaseChannel("go", v2, kg2), seed=1)
    lap("v2_cold")
    check(reports["v2_cold"].mode == "full", "cold v2 not a full update")

    rng = np.random.default_rng(SEED + 3)
    rows = rng.choice(kg2.num_entities, size=32, replace=False)
    answers = {m: [gw.closest_concepts("go", m, kg2.entities[r], k=10)
                   for r in rows] for m in UPDATE_MODELS}
    torch.cuda.synchronize()
    launches = {**tk.launches, **ts.launches}
    gw.close()
    check(tk.launches["kge_score_forward"] > 0
          and tk.launches["kge_score_backward"] > 0,
          "the update path launched no kge_score kernel")
    check(sum(ts.launches[e] for e in SMALL_ENTRY) > 0,
          "serving v2 launched no top-k kernel")

    # TransE and DistMult trained through one captured graph a run: the
    # counters saw the eager warm-up steps and each capture once; the card
    # ran each replay's kernels too
    captures = replays = 0
    for key, rep in reports.items():
        for m in UPDATE_MODELS:
            det = rep.details[m]
            if m in ("transe", "distmult"):
                check(det["graph_replays"]
                      == det["steps"] - GRAPH_WARMUP_STEPS,
                      f"{key} {m}: {det['graph_replays']} graph replays in "
                      f"{det['steps']} steps")
                captures += 1
                replays += det["graph_replays"]
            else:
                check(det["graph_replays"] == 0, f"{key} {m} was captured")
    # what each of this run's captures recorded, from its own counters:
    # one launch an entry point, as a capture of the same step alone does
    check(captures == 2 * len(reports), f"{captures} captured runs")
    lap("answers")
    graphed = graphed_step_numbers()
    lap("graphed_steps")
    per_capture, kge_path = {}, {}
    for e in ("kge_score_forward", "kge_score_backward"):
        recorded, rem = divmod(launches[e] - captures * GRAPH_WARMUP_STEPS,
                               captures)
        alone = [graphed[m]["launches_per_replay"][e] for m in graphed]
        check(rem == 0 and recorded == 1 and alone == [1, 1],
              f"{e}: {launches[e]} launches counted in {captures} captured "
              f"runs of {GRAPH_WARMUP_STEPS} eager steps each; a capture "
              f"alone records {alone}")
        per_capture[e] = recorded
        kge_path[e] = captures * GRAPH_WARMUP_STEPS + replays * recorded

    # -------- what came out: published table, answers, MRR ------------ #
    per_model = {}
    sample = kg2.triples[np.random.default_rng(SEED + 4).choice(
        kg2.num_triples, size=MRR_SAMPLE, replace=False)]
    for m in UPDATE_MODELS:
        table, norms, header = warm_reg.store.open_table("go", v2, m)
        params, _ = warm_reg.get_params("go", m, v2)
        arrays, _ = warm_reg.store.load("go", v2, m)
        # rdf2vec serves the graph entities' rows of its token table
        trained = np.ascontiguousarray(
            params["entity"][:kg2.num_entities], np.float32)
        check(np.asarray(table).tobytes() == trained.tobytes()
              and arrays["embeddings"].tobytes() == trained.tobytes(),
              f"{m}: published table differs from the trained embeddings")
        check(header["ids"] == list(kg2.entities), f"{m}: ids differ")
        emb_dev = torch.from_numpy(trained).to(DEV)
        nrm_dev = torch.from_numpy(np.array(norms)).to(DEV)
        ties = 0
        for r, resp in zip(rows, answers[m]):
            check(resp.version == v2, f"{m}: answered from {resp.version}")
            q = unit_rows(trained, np.asarray(norms), [r])
            s_ref, i_ref, v_ref = ref.topk_cosine_blocked_ref(
                torch.from_numpy(q).to(DEV), emb_dev, 10,
                exclude_rows=torch.tensor([int(r)], dtype=torch.int32,
                                          device=DEV),
                norms=nrm_dev, block_n=ops.STREAM_BLOCK_ROWS)
            nv = int(v_ref[0])
            hits = resp.results
            check(len(hits) == nv, f"{m}: {len(hits)} hits, want {nv}")
            s_plain = s_ref[0, :nv].cpu().numpy().astype(np.float64)
            s_got = np.array([h.score for h in hits], np.float64)
            check(float(np.abs(s_got - s_plain).max()) <= SCORE_TOL,
                  f"{m}: closest-concepts scores off the plain version")
            i_got = np.array([kg2.entity_to_id[h.identifier] for h in hits])
            ties += _ids_agree(i_got, i_ref[0, :nv].cpu().numpy(), s_plain)
        mrr = {}
        for name, reg in (("warm", warm_reg), ("cold", cold_reg)):
            arr, _ = reg.get_params("go", m, v2)
            if m == "rdf2vec":
                # link prediction by <in[h], out[t]> over the graph's
                # entities: the served rows of both SGNS tables
                model = make_model(m, kg2.num_entities, 1, dim=CONFIG.dim)
                arr = {k: v[:kg2.num_entities] for k, v in arr.items()}
            else:
                model = make_model(m, kg2.num_entities, kg2.num_relations,
                                   dim=CONFIG.dim)
            mrr[name] = rank_based_eval(
                model, params_from_numpy(model, arr, DEV), sample,
                kg2.triples)["mrr"]
        band = max(MRR_TOL_ABS, MRR_TOL_REL * mrr["cold"])
        check(mrr["warm"] >= mrr["cold"] - band,
              f"{m}: warm MRR {mrr['warm']:.4f} below cold "
              f"{mrr['cold']:.4f} - {band:.4f}")
        d1, dw, dc = (reports[k].details[m]
                      for k in ("v1", "v2_warm", "v2_cold"))
        per_model[m] = {
            "answers_checked": len(rows), "tie_runs_by_set": ties,
            "mrr_warm": mrr["warm"], "mrr_cold": mrr["cold"],
            "mrr_band": band, "carried_rows": dw["carried_rows"],
            **{f"{k}_{f}": d[f] for k, d in (("v1", d1), ("warm", dw),
                                           ("cold", dc))
               for f in ("steps", "final_loss", "wall_s", "triples_per_s")},
            **{f"{k}_first_loss": d["losses"][0][1]
               for k, d in (("v1", d1), ("warm", dw), ("cold", dc))},
            # every 10th logged (step, loss): where a run converges or
            # falls apart
            **{f"{k}_loss_curve": d["losses"][::10] + d["losses"][-1:]
               for k, d in (("v1", d1), ("warm", dw), ("cold", dc))},
            **{f"{k}_steps_per_s": d["steps"] / d["wall_s"]
               for k, d in (("v1", d1), ("warm", dw), ("cold", dc))},
            **{f"{k}_graph_replays": d["graph_replays"]
               for k, d in (("v1", d1), ("warm", dw), ("cold", dc))}}
        del emb_dev, nrm_dev, table, norms
    lap("answers_and_mrr")
    out = {"phase": "update", "models": list(UPDATE_MODELS),
           "steps_override": UPDATE_STEPS,
           "entities": [kg1.num_entities, kg2.num_entities],
           "triples": [kg1.num_triples, kg2.num_triples],
           "plan_v2": reports["v2_warm"].reason,
           "delta_v2": reports["v2_warm"].delta,
           "update_wall_s": {k: r.wall_s for k, r in reports.items()},
           "per_model": per_model, "launches": launches,
           "kge_launches_on_path": kge_path,
           "kge_launches_per_capture": per_capture,
           "graph_captures": captures,
           "graph_replays": replays, "graphed_steps": graphed}
    emit(out)
    return out


#: the jobs phase: a knn-join of every class of the GO serve table at the
#: paper's k, a large-k join, drift and compare on the update registry,
#: the /jobs routes over HTTP, a pool of 2, and the async front end
JOBS_K = 10
JOBS_SAMPLE = 512            # join rows held to serial top_k_rows
JOBS_LARGE_K, JOBS_LARGE_CLASSES, JOBS_LARGE_SAMPLE = 100, 1024, 256
#: classes of a drift job, and of them those whose Jaccard is recomputed
#: (4,096 classes before the recurrentgemma phase and training run joined
#: the script: a depth cut that keeps it near 820 s of phases; 2,048 and
#: 256 before the channel-parallel mesh parts joined it: a depth cut that
#: keeps a slow host's whole run near 1,000 s)
DRIFT_CLASSES, DRIFT_SAMPLE = 1024, 128
#: test triples a compare job ranks (1,000 before the recurrentgemma phase
#: and training run joined the script: the same depth cut; the job's MRR
#: is still held to rank_based_eval's on the same triples)
COMPARE_SAMPLE = 250
JOBS_HTTP_CLASSES, JOBS_HTTP_PAGE = 2000, 500
JOBS_MAX_QUEUED = 2
JOBS_PROBE_SLABS = 20        # join slabs timed outside a job, by part
#: classes of the join the serve session runs beside (all 40,000 before
#: the recurrentgemma phase and training run joined the script: a depth
#: cut that keeps it near 820 s); the phase fails unless the join still
#: runs when the session ends, and compares its ms a slab with the 40k
#: join's alone
JOBS_LOAD_CLASSES = 10_000
#: with ``--phases build,jobs`` (no update phase before it) the phase
#: trains its own two releases: TransE and DistMult at this step count
JOBS_ALONE_MODELS = ("transe", "distmult")
JOBS_ALONE_STEPS = 300


def _http_job(port: int, jid: str, until, timeout: float = 300) -> dict:
    """Poll GET /jobs/{jid} (reconnecting past a dead worker) until
    ``until(status)``; returns the status."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            st, _, body = _http_req(port, "GET", f"/jobs/{jid}")
            job = json.loads(body)
            check(st == 200, f"GET /jobs/{jid}: {st} {job}")
            if until(job):
                return job
        except OSError:
            pass
        check(time.monotonic() < deadline,
              f"job {jid} did not get there in {timeout} s")
        time.sleep(0.05)


def _job_rows(gw, jid: str) -> list:
    rows, offset = [], 0
    while offset is not None:
        page = gw.job_result(jid, offset=offset, limit=gw.page_limit_max)
        rows += page.rows
        offset = page.next_offset
    return rows


def _check_join(idx, rows, sample, k, pos, table, norms, note) -> dict:
    """Rows ``sample`` of a join: ids and scores equal to one serial
    ``top_k_rows([row], k)`` call each, bit for bit; and against the plain
    top-k, scores within SCORE_TOL and ids by ``_ids_agree``."""
    import torch
    from repro_torch.kernels import ops, ref
    for r in sample:
        want = idx.top_k_rows([r], k)[0]
        ident, hits = rows[r]
        check(ident == idx.entity_ids[r], f"{note}: row {r} is {ident}")
        check([h[0] for h in hits] == [c.identifier for c in want]
              and [h[1] for h in hits] == [c.score for c in want],
              f"{note}: {ident} differs from serial top_k_rows")
    q = torch.from_numpy(unit_rows(table, norms, sample)).to(DEV)
    s_ref, i_ref, v_ref = ref.topk_cosine_blocked_ref(
        q, torch.from_numpy(np.array(table)).to(DEV), k,
        exclude_rows=torch.tensor(sample, dtype=torch.int32, device=DEV),
        norms=torch.from_numpy(np.array(norms)).to(DEV),
        block_n=ops.STREAM_BLOCK_ROWS)
    s_ref, i_ref, v_ref = (t.cpu().numpy() for t in (s_ref, i_ref, v_ref))
    ties, err = 0, 0.0
    for j, r in enumerate(sample):
        hits, nv = rows[r][1], int(v_ref[j])
        check(len(hits) == nv, f"{note}: {len(hits)} hits, want {nv}")
        s_plain = s_ref[j, :nv].astype(np.float64)
        e = float(np.abs(np.array([h[1] for h in hits]) - s_plain).max())
        check(e <= SCORE_TOL, f"{note}: {rows[r][0]} scores off the plain")
        err = max(err, e)
        ties += _ids_agree(np.array([pos[h[0]] for h in hits]),
                           i_ref[j, :nv], s_plain)
    return {"serial_bit_equal": len(sample), "plain_checked": len(sample),
            "max_abs_err": err, "tie_runs_by_set": ties}


def _jobs_update_registry(tmp: str):
    """The update phase's warm registry (six models, v1 and v2 of the GO
    release), or, when that phase did not run, two releases trained here
    with TransE and DistMult at JOBS_ALONE_STEPS steps."""
    root = Path(tmp) / "warm"
    if (root / "go").is_dir():
        return root, list(UPDATE_MODELS), None
    from repro_torch.configs.go_kge import CONFIG
    from repro_torch.core.registry import EmbeddingRegistry
    from repro_torch.core.updater import SyntheticReleaseChannel, Updater
    root = Path(tmp) / "jobs-update"
    (v1, kg1), (v2, kg2) = go_releases()
    up = Updater(EmbeddingRegistry(root), models=JOBS_ALONE_MODELS,
                 dim=CONFIG.dim, train_cfg=CONFIG.train,
                 steps_override=JOBS_ALONE_STEPS, device=DEV)
    channel = SyntheticReleaseChannel("go")
    channel.bump(v1, kg1)
    up.run_once(channel, seed=0)
    channel.bump(v2, kg2)
    up.run_once(channel, seed=1)
    note = (f"no update phase ran: v1 and v2 trained here with "
            f"{', '.join(JOBS_ALONE_MODELS)} at {JOBS_ALONE_STEPS} steps")
    print(f"[chip_smoke] jobs: {note}", flush=True)
    return root, list(JOBS_ALONE_MODELS), note


def phase_jobs(tmp: str, card: str) -> dict:
    """Batch-analytics jobs on the card through the port's gateway: a
    knn-join of all 40,000 classes at k = 10 and one of 1,024 at k = 100
    (sampled rows bit-equal to serial top_k_rows, and against the plain
    top-k), drift and compare on the update registry, the /jobs routes
    over ``launch.serve --http 0`` (pages, 304, stream, cancel -> 409,
    queue bound -> 429), the orphan rule in a pool of 2, 64 async
    closest-concepts, and the serve session alone and beside a 10,000-class
    join."""
    import asyncio
    import torch
    from repro_torch.api import AsyncGateway, Gateway
    from repro_torch.api.workers import read_worker_states
    from repro_torch.core.registry import EmbeddingRegistry
    from repro_torch.core.serving import ServingEngine
    from repro_torch.kge import make_model, params_from_numpy, rank_based_eval
    from repro_torch.kernels import ops, topk_similarity as ts
    from repro_torch.launch import serve
    from repro_torch.ontology.delta import GraphDelta

    out: dict = {"phase": "jobs", "card": card}
    lap = laps("jobs")
    reg = EmbeddingRegistry(tmp)
    engine = ServingEngine(reg, device=DEV)
    # no result cache: the two sessions below ask for the same rows
    gw = Gateway(engine, max_batch=32, flush_after_ms=2.0,
                 result_cache_entries=0)
    rng = np.random.default_rng(SEED + 31)
    try:
        version = engine.latest_version("go")
        idx = engine._index("go", "transe", version)
        ids = list(idx.entity_ids)
        n = len(ids)
        check(n == GO_ROWS, f"serve table has {n} rows")
        pos = {x: i for i, x in enumerate(ids)}
        table, norms, _ = reg.store.open_table("go", version, "transe")

        # ------------- main path: a join of every class --------------- #
        ts.reset_launches()
        sub = gw.submit_job("knn-join", "go", model="transe", classes=ids,
                            k=JOBS_K)
        st = gw.job_wait(sub.job_id, timeout=600)
        torch.cuda.synchronize()
        small = {e: ts.launches[e] for e in SMALL_ENTRY}
        check(st.state == "DONE", f"40k join {st.state}: {st.error}")
        check(st.total == n and st.summary["n_queries"] == n,
              f"40k join: {st.total} rows")
        check(sum(small.values()) > 0, "the 40k join launched no top-k")
        rows = _job_rows(gw, sub.job_id)
        check([r[0] for r in rows] == ids, "40k join: rows out of order")
        sample = sorted(int(r) for r in rng.choice(n, JOBS_SAMPLE,
                                                   replace=False))
        summ = st.summary
        out["join"] = {
            "queries": n, "k": JOBS_K, "wall_s": st.wall_s,
            "queries_per_s": n / st.wall_s,
            "compute_s": summ["compute_s"], "slabs": summ["slabs"],
            # the job's yield to interactive traffic included (duty 1.0:
            # a pause as long as the slab itself after each slab)
            "ms_per_slab": st.wall_s * 1e3 / summ["slabs"],
            "launches": small, "launches_total": sum(small.values()),
            **_check_join(idx, rows, sample, JOBS_K, pos, table, norms,
                          "40k join")}
        emit({"jobs_join": out["join"]})
        lap("join")

        # where a join slab's time goes, outside a job (no yield): the
        # streamed calls alone, then with the conversion to hits
        probe = np.arange(64 * JOBS_PROBE_SLABS, dtype=np.int32)
        t0 = time.perf_counter()
        for _ in ops.topk_cosine_join(
                idx.unit_rows(probe), idx.embeddings, JOBS_K,
                exclude_rows=probe, norms=idx.norms, query_block_rows=64,
                block_rows=idx.block_rows, device=DEV,
                staging=idx._staging):
            pass
        t1 = time.perf_counter()
        for _ in idx.knn_join_rows(probe, JOBS_K, slab=64):
            pass
        t2 = time.perf_counter()
        out["slab_ms"] = {
            "streamed_call": (t1 - t0) * 1e3 / JOBS_PROBE_SLABS,
            "with_hits": (t2 - t1) * 1e3 / JOBS_PROBE_SLABS,
            "in_the_job_with_yield": out["join"]["ms_per_slab"]}

        # ------------- the large-k path: k = 100 ---------------------- #
        rows_l = sorted(int(r) for r in rng.choice(n, JOBS_LARGE_CLASSES,
                                                   replace=False))
        before = dict(ts.launches)
        sub = gw.submit_job("knn-join", "go", model="transe",
                            classes=[ids[r] for r in rows_l],
                            k=JOBS_LARGE_K)
        st = gw.job_wait(sub.job_id, timeout=300)
        torch.cuda.synchronize()
        large = {e: ts.launches[e] - before[e] for e in LARGE_ENTRY}
        check(st.state == "DONE", f"k=100 join {st.state}: {st.error}")
        check(all(v > 0 for v in large.values()),
              f"the k=100 join missed a large-k kernel: {large}")
        got = _job_rows(gw, sub.job_id)
        by_row = {r: got[j] for j, r in enumerate(rows_l)}
        sub_sample = sorted(int(r) for r in rng.choice(
            rows_l, JOBS_LARGE_SAMPLE, replace=False))
        out["join_large"] = {
            "queries": len(rows_l), "k": JOBS_LARGE_K, "wall_s": st.wall_s,
            "queries_per_s": len(rows_l) / st.wall_s,
            "slabs": st.summary["slabs"], "launches": large,
            "launches_total": sum(large.values()),
            **_check_join(idx, by_row, sub_sample, JOBS_LARGE_K, pos, table,
                          norms, "k=100 join")}
        emit({"jobs_join_large": out["join_large"]})
        lap("join_large")

        # host gather of one join slab: each slab's call gathers the whole
        # table into pinned staging (the streaming driver's np.copyto)
        pinned = torch.empty((n, D), dtype=torch.float32,
                             pin_memory=DEV == "cuda")
        out["host_gather_ms_per_slab"] = _host_ms(
            lambda: np.copyto(pinned.numpy(), table))
        del pinned

        # ------------- async: 64 coroutines against sync -------------- #
        ag = AsyncGateway(gw)
        q_rows = [int(r) for r in rng.choice(n, 64, replace=False)]

        async def gather64():
            return await asyncio.gather(*(
                ag.closest_concepts("go", "transe", ids[r], k=JOBS_K)
                for r in q_rows))

        answers = asyncio.run(gather64())
        for r, a in zip(q_rows, answers):
            s = gw.closest_concepts("go", "transe", ids[r], k=JOBS_K)
            check([(h.identifier, h.score) for h in a.results]
                  == [(h.identifier, h.score) for h in s.results],
                  f"async closest {ids[r]} differs from the sync answer")
        out["async"] = {"coroutines": len(answers), "equal_to_sync": True}

        # ------------- serve session alone, then beside a join -------- #
        args = serve._parser().parse_args(
            ["--registry", tmp, "--requests", "512", "--batch", "32",
             "--threads", "8", "--k", str(JOBS_K), "--device", DEV])
        alone = serve._session(args, gw, torch.device(DEV))
        sub = gw.submit_job("knn-join", "go", model="transe",
                            classes=ids[:JOBS_LOAD_CLASSES], k=JOBS_K)
        deadline = time.monotonic() + 60
        while gw.job_status(sub.job_id).state == "PENDING":
            check(time.monotonic() < deadline, "join never started")
            time.sleep(0.01)
        loaded = serve._session(args, gw, torch.device(DEV))
        state_after = gw.job_status(sub.job_id).state
        st = gw.job_wait(sub.job_id, timeout=600)
        check(st.state == "DONE", f"join under load {st.state}: {st.error}")
        check(state_after == "RUNNING",
              f"the join was {state_after} when the session beside it "
              f"ended: part of the session ran alone")
        out["session"] = {
            "alone": {k: alone[k] for k in ("qps", "p50_ms", "p99_ms")},
            "beside_join": {k: loaded[k] for k in ("qps", "p50_ms",
                                                   "p99_ms")},
            "join_classes_under_load": JOBS_LOAD_CLASSES,
            "join_wall_s_under_load": st.wall_s,
            # a slab of 64 classes, the yield included: the 40k join's
            # alone, this join's beside the session
            "join_ms_per_slab_alone": out["join"]["ms_per_slab"],
            "join_ms_per_slab_under_load":
                st.wall_s * 1e3 / st.summary["slabs"]}
        emit({"jobs_session": out["session"]})
        lap("async_and_session")
    finally:
        gw.close()

    # ------------- drift and compare on the update registry ----------- #
    upd_root, models, note = _jobs_update_registry(tmp)
    out["update_registry"] = {"models": models, "note": note}
    (v1, kg1), (v2, kg2) = go_releases()
    eng_u = ServingEngine(EmbeddingRegistry(upd_root), device=DEV)
    gw_u = Gateway(eng_u, max_batch=32, flush_after_ms=2.0)
    try:
        in_v1 = set(kg1.entities)
        common = [e for e in kg2.entities if e in in_v1]
        classes = [common[int(i)] for i in sorted(rng.choice(
            len(common), DRIFT_CLASSES, replace=False))]
        delta = GraphDelta.compute(kg1, kg2).stats()
        out["drift"] = {}
        for m in ("transe", "distmult"):
            sub = gw_u.submit_job("drift", "go", model=m, version=v1,
                                  version_b=v2, k=JOBS_K, classes=classes)
            st = gw_u.job_wait(sub.job_id, timeout=300)
            check(st.state == "DONE", f"drift {m} {st.state}: {st.error}")
            got = dict(_job_rows(gw_u, sub.job_id))
            check(list(got) == classes, f"drift {m}: rows differ")
            check(st.summary["graph_delta"] == delta,
                  f"drift {m}: graph_delta {st.summary['graph_delta']} "
                  f"!= {delta}")
            ia, ib = (eng_u._index("go", m, v) for v in (v1, v2))
            for e in (classes[int(i)] for i in rng.choice(
                    len(classes), DRIFT_SAMPLE, replace=False)):
                sa = {c.identifier for c in ia.top_k_rows(
                    [ia.resolve(e)], JOBS_K)[0]}
                sb = {c.identifier for c in ib.top_k_rows(
                    [ib.resolve(e)], JOBS_K)[0]}
                check(got[e] == len(sa & sb) / len(sa | sb),
                      f"drift {m}: {e} Jaccard {got[e]}")
            out["drift"][m] = {"classes": len(classes), "wall_s": st.wall_s,
                               "mean_jaccard": st.summary["mean_jaccard"],
                               "jaccard_checked": DRIFT_SAMPLE}
        emit({"jobs_drift": out["drift"]})
        lap("drift")

        store = eng_u.registry.store
        sub = gw_u.submit_job("compare", "go", version=v2, models=models,
                              sample=COMPARE_SAMPLE)
        st = gw_u.job_wait(sub.job_id, timeout=600)
        check(st.state == "DONE", f"compare {st.state}: {st.error}")
        got = dict(_job_rows(gw_u, sub.job_id))
        kg = store.load_graph("go", v2)
        perm = np.random.default_rng(0).permutation(len(kg.triples))
        trip = np.asarray(kg.triples)
        cmp_out = {}
        for m in models:
            met = got[m]
            want_method = "cosine" if m == "rdf2vec" else "kge"
            check(met["method"] == want_method and not met["cached"]
                  and met["sample"] == COMPARE_SAMPLE,
                  f"compare {m}: {met}")
            if want_method == "kge":
                params, _ = store.load_params("go", v2, m)
                model = make_model(m, kg.num_entities, kg.num_relations,
                                   dim=params["entity"].shape[-1])
                want = rank_based_eval(
                    model, params_from_numpy(model, params, DEV),
                    trip[perm[:COMPARE_SAMPLE]], trip, batch_size=64)
                check(abs(met["mrr"] - want["mrr"]) <= 1e-5,
                      f"compare {m}: MRR {met['mrr']} != {want['mrr']}")
            cmp_out[m] = {"method": met["method"], "mrr": met["mrr"],
                          "hits@10": met["hits@10"]}
        out["compare"] = {"models": cmp_out, "wall_s": st.wall_s}
        sub = gw_u.submit_job("compare", "go", version=v2, models=models,
                              sample=COMPARE_SAMPLE)
        st2 = gw_u.job_wait(sub.job_id, timeout=60)
        check(st2.state == "DONE" and all(
            r[1]["cached"] for r in _job_rows(gw_u, sub.job_id)),
              "compare again: not every model cached")
        out["compare"]["cached_wall_s"] = st2.wall_s
        emit({"jobs_compare": out["compare"]})
        lap("compare")
    finally:
        gw_u.close()

    # ------------- HTTP: launch.serve --http 0 ------------------------ #
    http_dir = Path(tmp) / "jobs-http"
    http_dir.mkdir(exist_ok=True)
    proc, port = _start_server(tmp, 1, str(http_dir), extra=[
        "--max-jobs-queued", str(JOBS_MAX_QUEUED)])
    try:
        cls = [ids[int(r)] for r in rng.choice(n, JOBS_HTTP_CLASSES,
                                               replace=False)]
        st, _, body = _http_req(port, "POST", "/jobs/submit", {
            "kind": "knn-join", "ontology": "go", "model": "transe",
            "classes": cls, "k": JOBS_K})
        check(st == 200, f"POST /jobs/submit: {st} {body[:300]}")
        jid = json.loads(body)["job_id"]
        _http_job(port, jid, lambda j: j["state"] == "DONE")
        pages, offset, n_pages = [], 0, 0
        while offset is not None:
            path = f"/jobs/{jid}/result?offset={offset}&limit={JOBS_HTTP_PAGE}"
            st, hdr, body = _http_req(port, "GET", path)
            check(st == 200 and hdr.get("ETag"), f"GET {path}: {st}")
            page = json.loads(body)
            st2, hdr2, body2 = _http_req(port, "GET", path, headers={
                "If-None-Match": hdr["ETag"]})
            check(st2 == 304 and body2 == b"" and hdr2.get("ETag")
                  == hdr["ETag"], f"If-None-Match {path}: {st2}")
            n_pages += 1
            pages += page["rows"]
            offset = page["next_offset"]
        check([r[0] for r in pages] == cls, "HTTP join: rows differ")
        check(all(r[1] == rows[pos[r[0]]][1] for r in pages),
              "HTTP join rows differ from the in-process join's")
        st, hdr, body = _http_req(port, "GET",
                                  f"/jobs/{jid}/result?stream=true")
        check(st == 200 and hdr.get("X-Bio-KGvec2go-Job") == jid
              and json.loads(body) == pages,
              "streamed job result differs from its pages")
        big = {"kind": "knn-join", "ontology": "go", "model": "transe",
               "classes": ids, "k": JOBS_K}
        a = json.loads(_http_req(port, "POST", "/jobs/submit", big)[2])
        _http_job(port, a["job_id"], lambda j: j["state"] == "RUNNING"
                  and j["progress"] > 0)
        queued = [json.loads(_http_req(port, "POST", "/jobs/submit",
                                       big)[2]) for _ in range(
            JOBS_MAX_QUEUED)]
        check(all(q["state"] == "PENDING" for q in queued),
              f"queued joins: {[q['state'] for q in queued]}")
        st, hdr, body = _http_req(port, "POST", "/jobs/submit", big)
        check(st == 429 and hdr.get("Retry-After")
              and json.loads(body)["code"] == "OVERLOADED",
              f"submit past --max-jobs-queued: {st} {hdr}")
        for j in [a] + queued:
            st, _, _ = _http_req(port, "POST", f"/jobs/{j['job_id']}/cancel",
                                 {})
            check(st == 200, f"cancel {j['job_id']}: {st}")
        for j in [a] + queued:
            _http_job(port, j["job_id"], lambda x: x["state"] == "CANCELLED")
        st, _, body = _http_req(port, "GET", f"/jobs/{a['job_id']}/result")
        check(st == 409 and json.loads(body)["code"] == "JOB_CANCELLED",
              f"result of a cancelled join: {st}")
        out["http"] = {"pages_each_304": n_pages, "stream_equal": True,
                       "cancelled_running": True, "rejected_429": True}
    finally:
        _stop_server(proc)
    lap("http")

    # ------------- pool of 2: shared state, the orphan rule ----------- #
    pool_dir = Path(tmp) / "jobs-pool"
    pool_dir.mkdir(exist_ok=True)
    proc, port = _start_server(tmp, 2, str(pool_dir))
    try:
        st, _, body = _http_req(port, "POST", "/jobs/submit", big)
        check(st == 200, f"pool submit: {st} {body[:300]}")
        job = json.loads(body)
        jid, owner = job["job_id"], job["owner_pid"]
        check((pool_dir / "jobs" / f"job-{jid}.json").exists(),
              "the job is not in the pool's shared state dir")
        for _ in range(60):           # fresh connections: both workers
            j = json.loads(_http_req(port, "GET", f"/jobs/{jid}")[2])
            check(j["state"] in ("PENDING", "RUNNING"), f"pool job {j}")
        time.sleep(1.2)               # the workers dump stats every 0.5 s
        polls = {x["pid"]: x["stats"]["gateway"]["by_route"].get(
            "job-status", 0) for x in read_worker_states(pool_dir)}
        others = [p for p in polls if p != owner]
        check(len(polls) == 2 and others and polls[others[0]] > 0,
              f"no poll answered by the non-owner: {polls} owner {owner}")
        _http_job(port, jid, lambda x: x["state"] == "RUNNING")
        os.kill(owner, signal.SIGKILL)
        dead = _http_job(port, jid, lambda x: x["state"] != "RUNNING",
                         timeout=60)
        check(dead["state"] == "FAILED" and "died" in (dead["error"] or ""),
              f"orphaned job: {dead}")
        deadline, w = time.monotonic() + 90, {}
        while time.monotonic() < deadline:
            try:
                w = json.loads(_http_get(port, "/stats")[1])["workers"]
                if w["count"] == 2 and w["restarts"] >= 1 \
                        and owner not in w["pids"]:
                    break
            except OSError:
                pass
            time.sleep(0.3)
        check(w.get("count") == 2 and w["restarts"] >= 1
              and owner not in w["pids"], f"owner not restarted: {w}")
        out["pool"] = {"polls_by_worker": list(polls.values()),
                       "orphan_state": dead["state"],
                       "restarts": w["restarts"]}
    finally:
        _stop_server(proc)
    lap("pool")
    out["launches_jobs"] = {"small": out["join"]["launches_total"],
                            "large": out["join_large"]["launches_total"]}
    emit({k: v for k, v in out.items() if k not in ("join", "join_large")})
    return out


def _lm_prompt(cfg, n: int):
    import torch
    rng = np.random.default_rng(SEED + 12)
    return torch.from_numpy(rng.integers(0, cfg.vocab, (LM_BATCH, n),
                                         dtype=np.int32)).to(DEV)


def phase_lm() -> dict:
    """The dense-LM serving path at h2o-danube-1.8b's published width.

    fp32: the last logits of prefill(S + 1) against prefill(S) +
    decode_step, S = 6144 > W = 4096: the kernel (every layer of both
    prefills) against the plain decode attention over the rolled cache.
    bf16: the generation of ``launch.generate`` (a warm-up run, then the
    measured one), its ids in the vocab and its SWA launches."""
    import torch
    from repro_torch.kernels import swa_attention as sw
    from repro_torch.launch import generate
    from repro_torch.models import build, get_config

    cfg = get_config(LM_ARCH).with_(dtype="float32")
    model = build(cfg).init(torch.Generator(device=DEV).manual_seed(SEED))
    toks = _lm_prompt(cfg, LM_PROMPT + 1)
    t0 = time.perf_counter()
    sw.reset_launches()
    full, _ = model.prefill({"tokens": toks})
    torch.cuda.synchronize()
    launches_full = sw.launches["swa_attention_forward"]
    sw.reset_launches()
    _, cache = model.prefill({"tokens": toks[:, :-1]},
                             cache_len=LM_PROMPT + 1)
    dec, _ = model.decode_step(cache, toks[:, -1:], LM_PROMPT)
    torch.cuda.synchronize()
    launches_part = sw.launches["swa_attention_forward"]
    fp32_s = time.perf_counter() - t0
    check(launches_full == cfg.n_layers and launches_part == cfg.n_layers,
          f"fp32 prefills launched {launches_full} and {launches_part} SWA "
          f"kernels, want {cfg.n_layers} each")
    check(tuple(full.shape) == (LM_BATCH, 1, cfg.padded_vocab)
          and bool(torch.isfinite(full).all())
          and bool(torch.isfinite(dec).all()), "fp32 logits not finite")
    diff = (dec - full).abs()
    check(bool((diff <= LM_TOL * (1 + full.abs())).all()),
          f"prefill(S+1) vs prefill(S) + decode: off by {float(diff.max())}")
    argmax_same = bool(torch.equal(dec.argmax(-1), full.argmax(-1)))
    check(argmax_same, "prefill(S+1) vs prefill(S) + decode: argmax differs")
    consistency = {"max_abs_diff": float(diff.max()),
                   "max_abs_logit": float(full.abs().max()),
                   "argmax_equal": argmax_same, "seconds": fp32_s,
                   "swa_launches_per_prefill": launches_full}
    del model, cache, full, dec, diff
    torch.cuda.empty_cache()

    argv = ["--arch", LM_ARCH, "--batch", str(LM_BATCH), "--prompt-len",
            str(LM_PROMPT), "--steps", str(LM_STEPS), "--seed", str(SEED),
            "--device", DEV]
    warm = generate.main(argv)
    torch.cuda.empty_cache()
    # ----------------- main path: bf16 generation --------------------- #
    sw.reset_launches()
    run = generate.main(argv)
    torch.cuda.synchronize()
    launches = dict(sw.launches)
    check(launches == {"swa_attention_forward": get_config(LM_ARCH).n_layers,
                       "swa_attention_bwd_dot": 0,
                       "swa_attention_backward_dkdv": 0,
                       "swa_attention_backward_dq": 0},
          f"generation launched {launches} SWA kernels, want one forward "
          f"per layer and no backward")
    ids = np.asarray(run["ids"])
    check(ids.shape == (LM_BATCH, LM_STEPS + 1), f"ids shape {ids.shape}")
    torch.cuda.empty_cache()

    # the same generation with the int8 cache: a warm-up run, then the
    # measured one
    argv8 = argv + ["--kv-cache-dtype", "int8"]
    generate.main(argv8)
    torch.cuda.empty_cache()
    run8 = generate.main(argv8)
    ids8 = np.asarray(run8["ids"])
    check(ids8.shape == ids.shape and ((ids8 >= 0) & (
        ids8 < cfg.padded_vocab)).all(), f"int8 ids {ids8.shape}")
    check(run8["cache_bytes"] < 0.6 * run["cache_bytes"],
          f"int8 cache {run8['cache_bytes']} B against the bf16 cache's "
          f"{run['cache_bytes']}")
    torch.cuda.empty_cache()
    out = {"phase": "lm", "fp32_consistency": consistency,
           "generation": {k: v for k, v in run.items() if k != "ids"},
           "warmup_generation": {k: warm[k] for k in (
               "prefill_ms", "decode_ms_per_token")},
           "int8_generation": {k: v for k, v in run8.items() if k != "ids"},
           "int8_vs_fp32_cache": _int8_against_fp(),
           "ids_row0": run["ids"][0], "launches": launches}
    emit(out)
    return out


def _int8_against_fp() -> dict:
    """tests/test_int8_kv_cache.py's contract at h2o-danube's full width in
    fp32, cut to INT8_CHECK_LAYERS layers: prefill(S - 1) with room for
    one more token, then one decode step, through the fp cache and through
    the int8 cache on the same params: logits within rtol 0.1 and atol
    0.15, the same top-1."""
    import torch
    from repro_torch.models import build, get_config

    cfg = get_config(LM_ARCH).with_(dtype="float32",
                                    n_layers=INT8_CHECK_LAYERS)
    fp = build(cfg).init(torch.Generator(device=DEV).manual_seed(SEED))
    q8 = build(cfg.with_(kv_cache_dtype="int8"))
    q8.params = fp.params
    toks = _lm_prompt(cfg, LM_PROMPT)
    out = {"layers": INT8_CHECK_LAYERS, "prompt": LM_PROMPT - 1}
    logits = {}
    for name, model in (("fp32", fp), ("int8", q8)):
        _, cache = model.prefill({"tokens": toks[:, :-1]},
                                 cache_len=LM_PROMPT)
        logits[name], cache = model.decode_step(cache, toks[:, -1:],
                                                LM_PROMPT - 1)
        out[f"{name}_cache_bytes"] = sum(t.numel() * t.element_size()
                                         for t in cache.values())
        del cache
    torch.cuda.synchronize()
    lf, lq = logits["fp32"], logits["int8"]
    diff = (lq - lf).abs()
    check(bool(torch.isfinite(lq).all())
          and bool((diff <= INT8_ATOL + INT8_RTOL * lf.abs()).all()),
          f"int8 cache against fp32: off by {float(diff.max())}")
    top2 = lf.topk(2, dim=-1).values
    same = bool(torch.equal(lq.argmax(-1), lf.argmax(-1)))
    out.update({"max_abs_diff": float(diff.max()),
                "max_abs_logit": float(lf.abs().max()),
                "fp32_top2_gap_min": float((top2[..., 0]
                                            - top2[..., 1]).min()),
                "top1_equal": same,
                "tolerance": {"rtol": INT8_RTOL, "atol": INT8_ATOL}})
    check(same, f"int8 cache against fp32: top-1 differs ({out})")
    del fp, q8, lf, lq, diff
    torch.cuda.empty_cache()
    return out


def phase_moe() -> dict:
    """MoE generation at olmoe-1b-7b's published width and depth.

    fp32, 2 of its 16 layers, capacity factor 16: the last logits of
    prefill(S + 1) against prefill(S) + decode_step, S = 2048: the SWA
    kernel's causal band (W = S) in every prefill layer against the plain
    decode attention, and the MoE dispatch at no drop.  bf16: the
    generation of ``launch.generate`` (a warm-up run, then the measured
    one), its ids in the vocab, one SWA forward a layer of the prefill,
    the dropped (token, slot) pairs, and the bounds of the expert
    products (prefill) and of reading every expert's weights (a decode
    step at capacity 1)."""
    import dataclasses
    import torch
    from repro_torch.kernels import swa_attention as sw
    from repro_torch.launch import generate
    from repro_torch.models import build, get_config

    full = get_config(MOE_ARCH)
    cfg = full.with_(dtype="float32", n_layers=MOE_CHECK_LAYERS,
                     moe=dataclasses.replace(full.moe,
                                             capacity_factor=MOE_CHECK_CF))
    model = build(cfg).init(torch.Generator(device=DEV).manual_seed(SEED))
    rng = np.random.default_rng(SEED + 14)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (
        MOE_BATCH, MOE_PROMPT + 1), dtype=np.int32)).to(DEV)
    t0 = time.perf_counter()
    sw.reset_launches()
    whole, _ = model.prefill({"tokens": toks})
    torch.cuda.synchronize()
    launches_full = sw.launches["swa_attention_forward"]
    sw.reset_launches()
    _, cache = model.prefill({"tokens": toks[:, :-1]},
                             cache_len=MOE_PROMPT + 1)
    dec, _ = model.decode_step(cache, toks[:, -1:], MOE_PROMPT)
    torch.cuda.synchronize()
    launches_part = sw.launches["swa_attention_forward"]
    fp32_s = time.perf_counter() - t0
    dropped = model.take_dropped()
    check(launches_full == cfg.n_layers and launches_part == cfg.n_layers,
          f"fp32 prefills launched {launches_full} and {launches_part} SWA "
          f"kernels, want {cfg.n_layers} each")
    check(dropped == 0, f"fp32 at capacity factor {MOE_CHECK_CF} dropped "
                        f"{dropped} (token, slot) pairs")
    check(tuple(whole.shape) == (MOE_BATCH, 1, cfg.padded_vocab)
          and bool(torch.isfinite(whole).all())
          and bool(torch.isfinite(dec).all()), "fp32 logits not finite")
    diff = (dec - whole).abs()
    check(bool((diff <= LM_TOL * (1 + whole.abs())).all()),
          f"moe prefill(S+1) vs prefill(S) + decode: off by "
          f"{float(diff.max())}")
    argmax_same = bool(torch.equal(dec.argmax(-1), whole.argmax(-1)))
    check(argmax_same, "moe prefill(S+1) vs prefill(S) + decode: argmax "
                       "differs")
    consistency = {"layers": cfg.n_layers, "capacity_factor": MOE_CHECK_CF,
                   "max_abs_diff": float(diff.max()),
                   "max_abs_logit": float(whole.abs().max()),
                   "argmax_equal": argmax_same, "seconds": fp32_s,
                   "swa_launches_per_prefill": launches_full}
    del model, cache, whole, dec, diff
    torch.cuda.empty_cache()

    argv = ["--arch", MOE_ARCH, "--batch", str(MOE_BATCH), "--prompt-len",
            str(MOE_PROMPT), "--steps", str(MOE_STEPS), "--seed",
            str(SEED), "--device", DEV]
    warm = generate.main(argv)
    torch.cuda.empty_cache()
    # ----------------- main path: bf16 generation --------------------- #
    sw.reset_launches()
    run = generate.main(argv)
    torch.cuda.synchronize()
    launches = dict(sw.launches)
    check(launches == {"swa_attention_forward": full.n_layers,
                       "swa_attention_bwd_dot": 0,
                       "swa_attention_backward_dkdv": 0,
                       "swa_attention_backward_dq": 0},
          f"generation launched {launches} SWA kernels, want one forward "
          f"per layer and no backward")
    ids = np.asarray(run["ids"])
    check(ids.shape == (MOE_BATCH, MOE_STEPS + 1) and ((ids >= 0) & (
        ids < full.padded_vocab)).all(), f"ids {ids.shape}")
    torch.cuda.empty_cache()
    out = {"phase": "moe", "fp32_consistency": consistency,
           "generation": {k: v for k, v in run.items() if k != "ids"},
           "warmup_generation": {k: warm[k] for k in (
               "prefill_ms", "decode_ms_per_token")},
           "bounds": moe_bounds(full, MOE_BATCH, MOE_PROMPT),
           "ids_row0": run["ids"][0], "launches": launches}
    emit(out)
    return out


def moe_bounds(cfg, B: int, S: int) -> dict:
    """Least times of an MoE generation's largest terms: the prefill's
    expert products (gate, up and down over the E x C dispatch buffer, 6
    d ff operations a row, at bf16's peak) and a decode step's read of
    every expert's weights (at capacity 1 every expert runs a row)."""
    E, K, L = cfg.moe.n_experts, cfg.moe.top_k, cfg.n_layers
    d, ff = cfg.d_model, cfg.d_ff
    C = max(1, int(np.ceil(B * S * K / E * cfg.moe.capacity_factor)))
    flop = 6.0 * E * C * d * ff * L
    weight_bytes = 3.0 * E * d * ff * L * 2
    return {"prefill_capacity": C, "prefill_expert_flop": flop,
            "prefill_expert_bound_ms": flop / BF16_FLOP_PER_S * 1e3,
            "decode_weight_bytes": weight_bytes,
            "decode_weight_read_bound_ms":
                weight_bytes / HBM_BYTES_PER_S * 1e3}


# ------------------- the process mesh (several ranks) ----------------- #
#: the mesh phase: worlds of ranks (``launch.mesh.run_world``) on the one
#: card.  NCCL refuses two ranks on one device, so: one rank on NCCL, then
#: two ranks sharing cuda:0 on gloo, mesh (data 1, model 2); each world's
#: time limit (its collectives' too)
MESH_TIMEOUT_S = 600
#: the 2-layer fp32 expert-parallel training step against the one-process
#: step (olmoe-1b-7b at full width, capacity factor MOE_CHECK_CF; B 2, S
#: 512, where the generation runs take 2,048: a cut in length that keeps
#: the phase short)
MESH_TRAIN_BATCH, MESH_TRAIN_SEQ = 2, 512
#: the sharded KGE trainer on the GO workload (40,000 x 200, batch 1,024,
#: 32 negatives): steps held to the one-process eager step, then steps
#: timed, each model (200 timed steps before: a depth cut that keeps the
#: whole script near 800 s; the sharded steps/s, 17-27 on the card,
#: settle well inside 50 steps)
MESH_KGE_MODELS = ("transe", "distmult")
MESH_KGE_CHECK_STEPS, MESH_KGE_STEPS = 3, 50
#: the sharded trainer against the one-process step: the CPU tests'
#: tolerances against the reference (tests/test_torch_kge_mesh.py)
MESH_KGE_LOSS_RTOL, MESH_KGE_PARAM_TOL = 1e-5, 2e-4
#: the gloo world's parts, in order: the checks and the training step
#: first, so the world of one (run beside it) has ended before the timed
#: parts start
MESH_GLOO_PARTS = ("check", "tp_check", "rec_check", "audio_check",
                   "train", "rec_train", "tp", "rec_gen", "audio_gen",
                   "int8_tp", "prefill", "kge")
#: times the (B S, d) all_reduce of a bf16 prefill (two a layer) is timed
MESH_ALL_REDUCE_ITERS = 10
#: the tensor-parallel checks, fp32 at MESH_TP_CHECK_LAYERS layers against
#: the one-process model (arch, B, prompt), MESH_TP_CHECK_STEPS decode
#: steps each: mistral-large-123b at a 512-token prompt (a cut in length:
#: the generation runs take 2,048), h2o-danube-1.8b past its window
MESH_TP_CHECK_LAYERS, MESH_TP_CHECK_STEPS = 2, 4
MESH_TP_CHECKS = ((MISTRAL_ARCH, 1, 512), (LM_ARCH, 1, 6144))
#: the channel-parallel fp32 checks of the SSM and hybrid families (arch,
#: B, prompt, layers), held as MESH_TP_CHECKS are: falcon-mamba-7b at 2
#: of 64 layers and a 512-token prompt (a cut in length: its generation
#: runs take 2,048), recurrentgemma-2b at 3 of 26 layers (recurrent,
#: recurrent, attention) and a 2,304-token prompt, past its window of
#: 2,048 (a cut in length from its generation's 4,096)
MESH_REC_CHECKS = ((MAMBA_ARCH, 1, 512, 2), (HYBRID_ARCH, 1, 2304, 3))
#: their fp32 training steps against the one-process step (arch, B, S,
#: layers), TRAIN_LOSS_RTOL and TRAIN_GRAD_TOL: falcon-mamba-7b at 2
#: layers, B 2, S 512; recurrentgemma-2b at 3 layers, B 1, S 2,112, past
#: the window (a cut in length: each rank holds the full (B S, 256,000)
#: fp32 logits and their gradient beside the one-process step's)
MESH_REC_TRAIN = ((MAMBA_ARCH, 2, 512, 2), (HYBRID_ARCH, 1, 2112, 3))
#: their bf16 generation on the mesh (arch, layers, prompt), B 2,
#: MESH_REC_STEPS greedy steps: falcon-mamba-7b cut to 8 of its 64
#: layers at a 2,048-token prompt, recurrentgemma-2b cut to 5 of its 26
#: (recurrent, recurrent, attention, recurrent, recurrent) at 4,096:
#: depth cuts that keep the mesh phase near a minute more, its
#: all_reduces going through host memory on gloo
MESH_REC_GEN = ((MAMBA_ARCH, 8, 2048), (HYBRID_ARCH, 5, 4096))
MESH_REC_BATCH, MESH_REC_STEPS = 2, 16
#: the audio family on the mesh, whisper-base at published width: the
#: fp32 check at MESH_AUDIO_LAYERS of its 6 + 6 layers (B 1,
#: WHISPER_FRAMES frames, a WHISPER_PROMPT-token prompt,
#: MESH_TP_CHECK_STEPS decode steps) against the one-process model, and
#: its fp32 training step at the same depth and shape against the
#: one-process step; the bf16 generation at its published depth (74 M
#: parameters: nothing cut), WHISPER_BATCH, WHISPER_FRAMES,
#: WHISPER_PROMPT, WHISPER_STEPS
MESH_AUDIO_LAYERS = 2
#: the int8 KV cache under the model axis: h2o-danube-1.8b bf16 cut to
#: MESH_INT8_DEPTH of its 24 layers (a depth cut: a prefill's 8
#: all_reduces of 63 MB go through host memory on gloo), LM_BATCH, a
#: LM_PROMPT-token prompt past W 4,096, MESH_REC_STEPS greedy steps; its
#: teacher-forced logits against the one-process int8 run within the int8
#: contract (INT8_RTOL, INT8_ATOL)
MESH_INT8_DEPTH = 4
#: the kernels at a rank's shapes on a model axis of 2 (the mesh phase's
#: last part): the fused scan and its backward on 4,096 of
#: falcon-mamba-7b's 8,192 channels (B 2, S 2,048, d_state 16, bf16), the
#: SWA forward and backward at d 256 on 5 q heads over 1 KV slot of
#: recurrentgemma-2b's 10 over 1 (B 2, S 4,096, W 2,048, bf16)
MESH_TP_AXIS = 2


def _mesh_moe_check(mesh) -> dict:
    """fp32, 2 of olmoe-1b-7b's layers at full width, capacity factor
    MOE_CHECK_CF: the expert-parallel prefill's last logits (on two ranks
    the attention cut too) against the one-process ``moe_apply``'s, on the
    same params and prompt."""
    import dataclasses
    import torch
    from repro_torch.kernels import swa_attention as sw
    from repro_torch.models import build, get_config, runtime
    from repro_torch.models.convert import shard_params

    full = get_config(MOE_ARCH)
    cfg = full.with_(dtype="float32", n_layers=MOE_CHECK_LAYERS,
                     moe=dataclasses.replace(full.moe,
                                             capacity_factor=MOE_CHECK_CF))
    dev = mesh.device
    toks = torch.from_numpy(np.random.default_rng(SEED + 14).integers(
        0, cfg.vocab, (MOE_BATCH, MOE_PROMPT), dtype=np.int32)).to(dev)
    t0 = time.perf_counter()
    model = build(cfg).init(torch.Generator(device=dev).manual_seed(SEED))
    want, _ = model.prefill({"tokens": toks})
    del model
    ep = shard_params(build(cfg.with_(moe_impl="shard_map")).init(
        torch.Generator(device=dev).manual_seed(SEED)), mesh)
    sw.reset_launches()
    with runtime.use_mesh(mesh):
        got, _ = ep.prefill({"tokens": toks})
    torch.cuda.synchronize(dev)
    launches = sw.launches["swa_attention_forward"]
    diff = (got - want).abs()
    check(bool(torch.isfinite(got).all()), "expert-parallel logits not "
                                           "finite")
    check(bool((diff <= LM_TOL * (1 + want.abs())).all()),
          f"expert-parallel vs one-process logits: off by "
          f"{float(diff.max())}")
    argmax_same = bool(torch.equal(got.argmax(-1), want.argmax(-1)))
    check(argmax_same, "expert-parallel vs one-process: argmax differs")
    check(launches == cfg.n_layers, f"the expert-parallel prefill launched "
                                    f"{launches} SWA kernels")
    return {"layers": cfg.n_layers, "capacity_factor": MOE_CHECK_CF,
            "experts_a_rank": tuple(ep.params["layers"][0]["moe"]["gate"]
                                    .shape)[0],
            "max_abs_diff": float(diff.max()),
            "max_abs_logit": float(want.abs().max()),
            "argmax_equal": argmax_same, "swa_launches": launches,
            "seconds": time.perf_counter() - t0}


def _mesh_prefill(mesh) -> dict:
    """bf16 olmoe-1b-7b at published width and depth, expert-parallel (32
    experts a rank on a model axis of 2) and its attention cut: a warm-up
    prefill, then the measured one (ms, SWA launches, dropped pairs, peak
    memory); then the (B S, d) bf16 all_reduce over ``"model"`` (two a
    layer: the attention's and the experts') timed alone."""
    import torch
    from repro_torch.kernels import swa_attention as sw
    from repro_torch.models import build, get_config, runtime
    from repro_torch.models.convert import shard_params

    cfg = get_config(MOE_ARCH).with_(moe_impl="shard_map")
    dev = mesh.device
    torch.cuda.reset_peak_memory_stats(dev)
    model = shard_params(build(cfg).init(
        torch.Generator(device=dev).manual_seed(SEED)), mesh)
    torch.cuda.empty_cache()
    toks = torch.from_numpy(np.random.default_rng(SEED + 24).integers(
        0, cfg.vocab, (MOE_BATCH, MOE_PROMPT), dtype=np.int32)).to(dev)
    with runtime.use_mesh(mesh):
        model.prefill({"tokens": toks})
        model.take_dropped()
        sw.reset_launches()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        logits, _ = model.prefill({"tokens": toks})
        torch.cuda.synchronize(dev)
        ms = (time.perf_counter() - t0) * 1e3
    launches = sw.launches["swa_attention_forward"]
    check(bool(torch.isfinite(logits).all()) and tuple(logits.shape) == (
        MOE_BATCH, 1, cfg.padded_vocab), "bf16 expert-parallel logits")
    check(launches == cfg.n_layers, f"the bf16 prefill launched {launches} "
                                    f"SWA kernels, want {cfg.n_layers}")
    out = {"prefill_ms": ms, "swa_launches": launches,
           "experts_a_rank": tuple(model.params["layers"][0]["moe"]["gate"]
                                   .shape)[0],
           "dropped_pairs": model.take_dropped(),
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "all_reduces_a_prefill": 2 * cfg.n_layers,
           **_all_reduce_ms(mesh, MOE_BATCH * MOE_PROMPT, cfg.d_model,
                            cfg.jdtype)}
    del model, logits
    torch.cuda.empty_cache()
    return out


def _mesh_train_check(mesh) -> dict:
    """fp32, 2 of olmoe-1b-7b's layers at full width, capacity factor
    MOE_CHECK_CF: ``steps.loss_and_grads`` expert-parallel (the attention
    cut too) on the mesh against the one-process step on every rank, the loss within
    TRAIN_LOSS_RTOL and each gradient leaf of the rank's share within
    TRAIN_GRAD_TOL * max|g| of the one-process leaf; the SWA forward and
    backward launches of the mesh step."""
    import dataclasses
    import torch
    from repro_torch.kernels import swa_attention as sw
    from repro_torch.models import build, get_config, runtime
    from repro_torch.models.convert import shard_params
    from repro_torch.models.sharding import mesh_pspec
    from repro_torch.models.steps import loss_and_grads

    full = get_config(MOE_ARCH)
    cfg = full.with_(dtype="float32", n_layers=MOE_CHECK_LAYERS,
                     moe_impl="shard_map",
                     moe=dataclasses.replace(full.moe,
                                             capacity_factor=MOE_CHECK_CF))
    dev = mesh.device
    rng = np.random.default_rng(SEED + 25)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (
        MESH_TRAIN_BATCH, MESH_TRAIN_SEQ), dtype=np.int32)).to(dev)
        for k in ("tokens", "labels")}
    t0 = time.perf_counter()
    ep = shard_params(build(cfg).init(
        torch.Generator(device=dev).manual_seed(SEED)), mesh)
    ep._p().requires_grad_(True)
    sw.reset_launches()
    loss, _, grads = loss_and_grads(ep, batch, mesh)
    torch.cuda.synchronize(dev)
    launches = dict(sw.launches)
    del ep
    one = build(cfg.with_(moe_impl="gspmd")).init(
        torch.Generator(device=dev).manual_seed(SEED))
    one._p().requires_grad_(True)
    want_loss, _, want = loss_and_grads(one, batch)
    del one
    check(abs(float(loss) - float(want_loss))
          <= TRAIN_LOSS_RTOL * abs(float(want_loss)),
          f"expert-parallel loss {float(loss)} against {float(want_loss)}")
    worst = {}
    for n, w in want.items():
        w = runtime.take_share(w, mesh_pspec(
            cfg, tuple(n.split(".")), w.dim(), mesh.shape["model"]), mesh)
        err = float((grads[n] - w).abs().max())
        scale = float(w.abs().max())
        check(scale > 0 and err <= TRAIN_GRAD_TOL * scale,
              f"gradient {n}: off by {err} of max {scale}")
        worst[n] = err / scale
    check(launches["swa_attention_forward"] == 2 * cfg.n_layers
          and launches["swa_attention_backward_dq"] == cfg.n_layers,
          f"the expert-parallel step launched {launches} SWA kernels, want "
          f"a forward and a recompute, and one backward, a layer")
    name = max(worst, key=worst.get)
    return {"batch": MESH_TRAIN_BATCH, "seq": MESH_TRAIN_SEQ,
            "launches": launches, "loss": float(loss),
            "want_loss": float(want_loss), "leaves": len(worst),
            "worst_leaf": name, "worst_rel_err": worst[name],
            "seconds": time.perf_counter() - t0}


def _mesh_kge(mesh, kg) -> dict:
    """The sharded KGE trainer on the GO workload (``kg``: the v1 release's
    entity and relation counts and triples), model axis 2 (20,000 entity
    rows a rank), TransE-L1 and DistMult: MESH_KGE_CHECK_STEPS steps held
    to the one-process eager step fed the same negatives, then ``fit``
    for MESH_KGE_STEPS steps (steps/s), beside the one-process eager
    step's steps/s (rank 0); kge_score launches of the sharded runs."""
    import torch
    from repro_torch.configs.go_kge import CONFIG
    from repro_torch.data.triples import TripleLoader
    from repro_torch.kernels import kge_score as tk
    from repro_torch.kge import make_model
    from repro_torch.kge.negatives import corrupt
    from repro_torch.kge.train import KGETrainer

    dev, cfg = mesh.device, CONFIG.train
    lead = mesh.index("model") == 0
    out = {"launches": dict.fromkeys(("kge_score_forward",
                                      "kge_score_backward"), 0)}

    def count():
        torch.cuda.synchronize(dev)
        for k in out["launches"]:
            out["launches"][k] += tk.launches[k]
        tk.reset_launches()

    for name in MESH_KGE_MODELS:
        model = make_model(name, kg["entities"], kg["relations"],
                           dim=CONFIG.dim)
        sharded = KGETrainer(model, cfg, mesh=mesh)
        one = KGETrainer(model, cfg, device=dev)
        full, _ = one.init()
        params = sharded.shard(full)
        opt, opt1 = sharded.optimizer.init(params), one.optimizer.init(full)
        gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
        it = iter(TripleLoader(kg["triples"], cfg.batch_size, seed=cfg.seed))
        res = {"rows_a_rank": params["entity"].shape[0], "losses": [],
               "one_process_losses": []}
        tk.reset_launches()
        for i in range(MESH_KGE_CHECK_STEPS):
            batch = torch.from_numpy(next(it)).to(dev, torch.int64)
            rand, side = corrupt(gen, batch, model.spec.n_entities,
                                 cfg.num_negs)
            res["losses"].append(float(sharded.train_step.step_with(
                params, opt, batch, rand, side)))
            count()
            res["one_process_losses"].append(float(one.train_step.step_with(
                full, opt1, batch, rand, side)))
            tk.reset_launches()
            if i == 0:
                got = sharded.gather(params)
                err = max(float((got[k] - full[k]).abs().max()) /
                          float(full[k].abs().max()) for k in full)
                check(err <= MESH_KGE_PARAM_TOL, f"{name}: params after "
                      f"step 1 off by {err} of max|p|")
                res["params1_rel_err"] = err
        for a, b in zip(res["losses"], res["one_process_losses"]):
            check(abs(a - b) <= MESH_KGE_LOSS_RTOL * abs(b),
                  f"{name}: sharded loss {a} against one process's {b}")
        _, _, stats = sharded.fit(kg["triples"], steps=MESH_KGE_STEPS)
        count()
        check(np.isfinite(stats["final_loss"]), f"{name}: loss not finite")
        res.update(steps=MESH_KGE_STEPS, final_loss=stats["final_loss"],
                   steps_per_s=MESH_KGE_STEPS / stats["wall_s"])
        if lead:
            it = iter(TripleLoader(kg["triples"], cfg.batch_size,
                                   seed=cfg.seed))
            p, o = one.init()
            one.train_step.step(p, o, torch.from_numpy(next(it)).to(
                dev, torch.int64), gen)
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            for _ in range(MESH_KGE_STEPS):
                one.train_step.step(p, o, torch.from_numpy(next(it)).to(
                    dev, torch.int64), gen)
            torch.cuda.synchronize(dev)
            res["one_process_eager_steps_per_s"] = MESH_KGE_STEPS / (
                time.perf_counter() - t0)
            tk.reset_launches()
        out[name] = res
    want = len(MESH_KGE_MODELS) * (MESH_KGE_CHECK_STEPS + MESH_KGE_STEPS)
    check(all(v == want for v in out["launches"].values()),
          f"the sharded trainer launched {out['launches']} kge_score "
          f"kernels, want {want} of each")
    return out


def _mesh_tp_check(mesh, arch: str, B: int, S: int) -> dict:
    """fp32, MESH_TP_CHECK_LAYERS of ``arch``'s layers at published width
    (its KV slots raised to the model axis where fewer,
    ``sharding.tp_config``): the one-process prefill and
    MESH_TP_CHECK_STEPS greedy decode steps, then the same params cut by
    ``convert.shard_params`` and the tensor-parallel prefill step and
    decode steps fed the one-process run's tokens: every step's logits
    within LM_TOL (1 + |want|), the same argmax; one SWA forward a layer
    of the prefill."""
    from repro_torch.models import get_config
    from repro_torch.models.sharding import tp_config

    cfg = tp_config(get_config(arch).with_(
        dtype="float32", n_layers=MESH_TP_CHECK_LAYERS), mesh.shape["model"])
    t0 = time.perf_counter()
    worst, top, cache, launches, _, _ = _tp_against_one_process(mesh, cfg,
                                                                B, S)
    launches = launches["swa_attention_forward"]
    check(launches == cfg.n_layers, f"{arch}: the tensor-parallel prefill "
                                    f"launched {launches} SWA kernels")
    return {"arch": arch, "layers": cfg.n_layers, "batch": B, "prompt": S,
            "decode_steps": MESH_TP_CHECK_STEPS,
            "kv_slots_a_rank": cache["k"].shape[2],
            "q_heads_a_rank": cfg.padded_heads() // mesh.shape["model"],
            "max_abs_diff": worst, "max_abs_logit": top,
            "argmax_equal": True, "swa_launches": launches,
            "seconds": time.perf_counter() - t0}


def _prefill_launches():
    """``(reset, read)``: the SWA and selective-scan kernels' launch
    counts, all entry points, as one dict."""
    from repro_torch.kernels import selective_scan as ss, swa_attention as sw

    def reset():
        sw.reset_launches()
        ss.reset_launches()
    return reset, lambda: {**sw.launches, **ss.launches}


def _tp_against_one_process(mesh, cfg, B: int, S: int, batch=None,
                            int8: bool = False):
    """``cfg`` (seeded params): the one-process prefill of ``batch``
    (default: B random prompts of S tokens; an encoder-decoder's holds its
    frames too) and MESH_TP_CHECK_STEPS greedy decode steps from position
    S, then the same params cut by ``convert.shard_params`` and the
    tensor-parallel prefill step and decode steps fed the one-process
    run's tokens: every step's logits within LM_TOL (1 + |want|), the same
    argmax; with ``int8`` (a bf16 int8 KV cache) within the int8 contract,
    INT8_ATOL + INT8_RTOL |want|, the argmax counted, not gated (bf16
    partial sums round differently).  Returns (max abs diff, max |want|,
    the rank's cache, the prefill step's launches, argmax-equal rows,
    rows)."""
    import torch
    from repro_torch.models import build, runtime
    from repro_torch.models.convert import shard_params
    from repro_torch.models.steps import make_prefill_step

    arch, steps, dev = cfg.arch_id, MESH_TP_CHECK_STEPS, mesh.device
    if batch is None:
        batch = {"tokens": torch.from_numpy(np.random.default_rng(
            SEED + 41).integers(0, cfg.vocab, (B, S), dtype=np.int32)
            ).to(dev)}
    model = build(cfg).init(torch.Generator(device=dev).manual_seed(SEED))
    lg, cache = model.prefill(batch, cache_len=S + steps)
    want, feed = [lg], []
    for i in range(steps):
        feed.append(want[-1].argmax(-1).to(torch.int32))
        lg, cache = model.decode_step(cache, feed[-1], S + i)
        want.append(lg)
    del cache
    shard_params(model, mesh)
    reset, read = _prefill_launches()
    reset()
    lg, cache = make_prefill_step(model, mesh)(batch, S + steps)
    torch.cuda.synchronize(dev)
    launches = read()
    got = [lg]
    with runtime.use_mesh(mesh):
        for i, tok in enumerate(feed):
            lg, cache = model.decode_step(cache, tok, S + i)
            got.append(lg)
    worst, same, rows = 0.0, 0, 0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float(), w.float()
        diff = (g - w).abs()
        tol = INT8_ATOL + INT8_RTOL * w.abs() if int8 \
            else LM_TOL * (1 + w.abs())
        check(bool(torch.isfinite(g).all()) and g.shape == w.shape,
              f"{arch} tensor-parallel logits at step {i}")
        check(bool((diff <= tol).all()),
              f"{arch} tensor-parallel vs one-process logits at step {i}: "
              f"off by {float(diff.max())}")
        equal = g.argmax(-1) == w.argmax(-1)
        check(int8 or bool(equal.all()),
              f"{arch} tensor-parallel vs one-process: argmax differs at "
              f"step {i}")
        worst = max(worst, float(diff.max()))
        same, rows = same + int(equal.sum()), rows + equal.numel()
    return (worst, max(float(w.float().abs().max()) for w in want), cache,
            launches, same, rows)


def _prefill_want(cfg) -> dict:
    """The SWA forwards and fused scans one prefill of ``cfg`` launches:
    one scan a Mamba layer, one SWA forward an attention layer."""
    ssm = cfg.family == "ssm"
    attn = sum(_hybrid_layers(cfg, "attention")) \
        if cfg.family == "hybrid" else cfg.n_layers
    return {"swa_attention_forward": 0 if ssm else attn,
            "selective_scan_fused": cfg.n_layers if ssm else 0}


def _cache_shapes(tree, prefix: str = "") -> dict:
    """``{dotted path: shape}`` of a cache: a dict of tensors, or the
    hybrid's dicts of tuples."""
    if not isinstance(tree, (dict, list, tuple)):
        return {prefix: tuple(tree.shape)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_cache_shapes(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def _mesh_rec_check(mesh, arch: str, B: int, S: int, layers: int) -> dict:
    """fp32, ``layers`` of an SSM or hybrid ``arch``'s layers at published
    width (the hybrid's KV slots raised to the model axis,
    ``sharding.tp_config``), channel-parallel against the one-process
    model as :func:`_mesh_tp_check` holds the attention families: the
    logits of the prefill and MESH_TP_CHECK_STEPS decode steps; one fused
    scan a Mamba layer and one SWA forward an attention layer in the
    prefill; the rank's cache shapes (d_in / n or w / n channels, its KV
    slots)."""
    from repro_torch.models import get_config
    from repro_torch.models.sharding import tp_config

    cfg = tp_config(get_config(arch).with_(dtype="float32", n_layers=layers),
                    mesh.shape["model"])
    t0 = time.perf_counter()
    worst, top, cache, launches, _, _ = _tp_against_one_process(mesh, cfg,
                                                                B, S)
    want = _prefill_want(cfg)
    got = {k: launches[k] for k in want}
    check(got == want, f"{arch}: the channel-parallel prefill launched "
                       f"{got}, want {want}")
    return {"arch": arch, "layers": layers, "batch": B, "prompt": S,
            "decode_steps": MESH_TP_CHECK_STEPS,
            "cache_shapes": _cache_shapes(cache), "max_abs_diff": worst,
            "max_abs_logit": top, "argmax_equal": True, "launches": got,
            "seconds": time.perf_counter() - t0}


def _mesh_rec_train(mesh, arch: str, B: int, S: int, layers: int) -> dict:
    """fp32, ``layers`` of an SSM or hybrid ``arch``'s layers at published
    width: the channel-parallel training step against the one-process step
    (:func:`_tp_train_against_one_process`) on B random sequences of S
    tokens."""
    import torch
    from repro_torch.models import get_config
    from repro_torch.models.sharding import tp_config

    cfg = tp_config(get_config(arch).with_(dtype="float32", n_layers=layers),
                    mesh.shape["model"])
    rng = np.random.default_rng(SEED + 43)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (B, S),
                                              dtype=np.int32)).to(mesh.device)
             for k in ("tokens", "labels")}
    return {"arch": arch, "layers": layers, "batch": B, "seq": S,
            **_tp_train_against_one_process(mesh, cfg, batch)}


def _tp_train_against_one_process(mesh, cfg, batch) -> dict:
    """fp32 ``cfg`` (seeded params): ``steps.loss_and_grads`` on the
    params cut by ``convert.shard_params`` against the one-process step
    on every rank, the loss within TRAIN_LOSS_RTOL and each gradient leaf
    of the rank's share (``convert.share_of``: mamba's ``in_proj`` a block
    of each half) within TRAIN_GRAD_TOL * max|g| of the one-process leaf's
    share; the mesh step's kernel launches (a Mamba layer's scan backward
    once, an attention layer's SWA backward once)."""
    import torch
    from repro_torch.models import build
    from repro_torch.models.convert import share_of, shard_params
    from repro_torch.models.steps import loss_and_grads

    arch, dev = cfg.arch_id, mesh.device
    t0 = time.perf_counter()
    model = shard_params(build(cfg).init(
        torch.Generator(device=dev).manual_seed(SEED)), mesh)
    model._p().requires_grad_(True)
    reset, read = _prefill_launches()
    reset()
    loss, _, grads = loss_and_grads(model, batch, mesh)
    torch.cuda.synchronize(dev)
    launches = read()
    del model
    one = build(cfg).init(torch.Generator(device=dev).manual_seed(SEED))
    one._p().requires_grad_(True)
    want_loss, _, want = loss_and_grads(one, batch)
    del one
    check(abs(float(loss) - float(want_loss))
          <= TRAIN_LOSS_RTOL * abs(float(want_loss)),
          f"{arch} tensor-parallel loss {float(loss)} against "
          f"{float(want_loss)}")
    worst = {}
    for n, w in want.items():
        w = share_of(cfg, n, w, mesh)
        err = float((grads[n] - w).abs().max())
        scale = float(w.abs().max())
        check(scale > 0 and err <= TRAIN_GRAD_TOL * scale,
              f"{arch} gradient {n}: off by {err} of max {scale}")
        worst[n] = err / scale
    want = _prefill_want(cfg)
    back = {"selective_scan_fused_backward": want["selective_scan_fused"],
            "swa_attention_backward_dq": want["swa_attention_forward"]}
    check({k: launches[k] for k in back} == back,
          f"{arch}: the tensor-parallel step launched {launches}, want "
          f"{back} backward kernels")
    name = max(worst, key=worst.get)
    return {"launches": launches, "loss": float(loss),
            "want_loss": float(want_loss), "leaves": len(worst),
            "worst_leaf": name, "worst_rel_err": worst[name],
            "seconds": time.perf_counter() - t0}


def _audio_batch(cfg, B: int, S: int, dev, labels: bool = False) -> dict:
    """B rows of WHISPER_FRAMES random frames and S random decoder tokens
    (and labels) for ``cfg``, from a numpy seed."""
    import torch
    rng = np.random.default_rng(SEED + 45)
    batch = {"frames": torch.from_numpy(rng.standard_normal(
        (B, WHISPER_FRAMES, cfg.d_model), dtype=np.float32)).to(
            dev, cfg.jdtype)}
    for k in ("tokens", "labels") if labels else ("tokens",):
        batch[k] = torch.from_numpy(rng.integers(
            0, cfg.vocab, (B, S), dtype=np.int32)).to(dev)
    return batch


def _mesh_audio_check(mesh) -> dict:
    """fp32, MESH_AUDIO_LAYERS of whisper-base's encoder and decoder
    layers at published width, B 1, WHISPER_FRAMES frames and a
    WHISPER_PROMPT-token prompt: the tensor-parallel prefill step and
    MESH_TP_CHECK_STEPS decode steps against the one-process model
    (:func:`_tp_against_one_process`: the tied embed cut by vocab rows,
    each rank's 4 of 8 heads in the encoder, the decoder and the
    cross-attention), one SWA forward a decoder layer in the prefill, the
    rank's cache shapes; then the training step against the one-process
    step (:func:`_tp_train_against_one_process`, the tied embed's
    gradient of the lookup and the head included)."""
    from repro_torch.models import get_config
    from repro_torch.models.sharding import tp_config

    cfg = tp_config(get_config(WHISPER_ARCH).with_(
        dtype="float32", n_layers=MESH_AUDIO_LAYERS), mesh.shape["model"])
    t0 = time.perf_counter()
    batch = _audio_batch(cfg, 1, WHISPER_PROMPT, mesh.device)
    worst, top, cache, launches, _, _ = _tp_against_one_process(
        mesh, cfg, 1, WHISPER_PROMPT, batch)
    launches = launches["swa_attention_forward"]
    check(launches == cfg.n_layers, f"{WHISPER_ARCH}: the tensor-parallel "
                                    f"prefill launched {launches} SWA "
                                    f"kernels")
    check_s = time.perf_counter() - t0
    train = _tp_train_against_one_process(
        mesh, cfg, _audio_batch(cfg, 1, WHISPER_PROMPT, mesh.device, True))
    return {"arch": WHISPER_ARCH, "layers": cfg.n_layers, "batch": 1,
            "frames": WHISPER_FRAMES, "prompt": WHISPER_PROMPT,
            "decode_steps": MESH_TP_CHECK_STEPS,
            "cache_shapes": _cache_shapes(cache), "max_abs_diff": worst,
            "max_abs_logit": top, "argmax_equal": True,
            "swa_launches": launches, "seconds": check_s,
            "train": train}


def _mesh_audio_gen(mesh) -> dict:
    """bf16 whisper-base at its published width and depth
    (:func:`_tp_generation`: WHISPER_BATCH, WHISPER_FRAMES frames, a
    WHISPER_PROMPT-token prompt, WHISPER_STEPS greedy steps)."""
    from repro_torch.models import get_config
    return _tp_generation(mesh, WHISPER_ARCH,
                          get_config(WHISPER_ARCH).n_layers, WHISPER_BATCH,
                          WHISPER_PROMPT, WHISPER_STEPS)


def _mesh_int8(mesh) -> dict:
    """bf16 h2o-danube-1.8b with the int8 KV cache at published width, cut
    to MESH_INT8_DEPTH layers, B LM_BATCH, a LM_PROMPT-token prompt past
    its window: the tensor-parallel prefill step and MESH_TP_CHECK_STEPS
    decode steps fed the one-process int8 run's tokens, every step's
    logits within the int8 contract (INT8_ATOL + INT8_RTOL |want|; the
    argmax counted); each rank's cache int8 on its KV slots with its
    scales beside them; then the generation (:func:`_tp_generation`,
    MESH_REC_STEPS steps: the rank's cache bytes the dry run's, prefill
    and decode ms, the tokens against ``launch.generate
    --kv-cache-dtype int8``'s)."""
    import torch
    from repro_torch.models import get_config
    from repro_torch.models.sharding import tp_config

    cfg = tp_config(get_config(LM_ARCH).with_(
        n_layers=MESH_INT8_DEPTH, kv_cache_dtype="int8"),
        mesh.shape["model"])
    t0 = time.perf_counter()
    worst, top, cache, launches, same, rows = _tp_against_one_process(
        mesh, cfg, LM_BATCH, LM_PROMPT, int8=True)
    slots = cfg.groups // mesh.shape["model"]
    check(cache["k"].dtype == torch.int8 and cache["k"].shape[2] == slots
          and cache["k_scale"].shape == cache["k"].shape[:-1],
          f"the int8 cache on a rank: {_cache_shapes(cache)}")
    check(launches["swa_attention_forward"] == cfg.n_layers,
          f"the int8 tensor-parallel prefill launched {launches}")
    against = {"layers": cfg.n_layers, "batch": LM_BATCH,
               "prompt": LM_PROMPT, "decode_steps": MESH_TP_CHECK_STEPS,
               "cache_shapes": _cache_shapes(cache), "max_abs_diff": worst,
               "max_abs_logit": top, "argmax_equal_rows": same,
               "rows": rows,
               "tolerance": {"rtol": INT8_RTOL, "atol": INT8_ATOL},
               "seconds": time.perf_counter() - t0}
    del cache
    torch.cuda.empty_cache()
    return {"against_one_process": against,
            "generation": _tp_generation(mesh, LM_ARCH, MESH_INT8_DEPTH,
                                         LM_BATCH, LM_PROMPT,
                                         MESH_REC_STEPS, "int8")}


def _all_reduce_ms(mesh, rows: int, d: int, dtype) -> dict:
    """One all_reduce of (rows, d) over ``"model"``, timed alone
    MESH_ALL_REDUCE_ITERS times after one warm-up: the median ms."""
    import torch
    import torch.distributed as dist
    dev = mesh.device
    y = torch.randn((rows, d), device=dev, dtype=dtype)
    group, times = mesh.group("model"), []
    for _ in range(MESH_ALL_REDUCE_ITERS + 1):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        dist.all_reduce(y, group=group)
        torch.cuda.synchronize(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return {"all_reduce_ms": float(np.median(times[1:])),
            "all_reduce_bytes": y.numel() * y.element_size()}


def _mesh_tp(mesh) -> dict:
    """bf16 mistral-large-123b at published width, cut to the zoo's
    depth (:func:`_tp_generation`, B ZOO_BATCH, ZOO_PROMPT, ZOO_STEPS
    greedy steps, the zoo run's params and prompt)."""
    depth = next(d for a, d, _ in ZOO_ARCHS if a == MISTRAL_ARCH)
    return _tp_generation(mesh, MISTRAL_ARCH, depth, ZOO_BATCH, ZOO_PROMPT,
                          ZOO_STEPS)


def _mesh_rec_gen(mesh) -> list:
    """bf16 falcon-mamba-7b and recurrentgemma-2b at published width, cut
    to MESH_REC_GEN's depths (:func:`_tp_generation`, B MESH_REC_BATCH,
    MESH_REC_STEPS greedy steps)."""
    return [_tp_generation(mesh, arch, depth, MESH_REC_BATCH, P,
                           MESH_REC_STEPS)
            for arch, depth, P in MESH_REC_GEN]


@contextlib.contextmanager
def _collectives(into):
    """Count the all_reduces and all_gathers issued inside into the dict
    ``into`` (None: count nothing): the calls, and the bytes of the tensor
    each rank hands in."""
    import torch.distributed as dist
    if into is None:
        yield
        return
    real = {"all_reduce": dist.all_reduce, "all_gather": dist.all_gather}

    def counted(name: str, arg: int):
        def call(*args, **kw):
            t = args[arg]
            into[name] = into.get(name, 0) + 1
            into[f"{name}_bytes"] = into.get(f"{name}_bytes", 0) \
                + t.numel() * t.element_size()
            return real[name](*args, **kw)
        return call
    dist.all_reduce = counted("all_reduce", 0)
    dist.all_gather = counted("all_gather", 1)
    try:
        yield
    finally:
        dist.all_reduce, dist.all_gather = real["all_reduce"], \
            real["all_gather"]


#: how a launch-count failure names each counted kernel
_LAUNCH_NAMES = {"swa_attention_forward": "SWA kernels",
                 "selective_scan_fused": "fused scans"}


def _tp_generation(mesh, arch: str, depth: int, B: int, P: int,
                   steps: int, kv_cache_dtype: str = "model") -> dict:
    """bf16 ``arch`` at published width, cut to ``depth`` layers (with
    ``kv_cache_dtype``), its params cut by ``convert.shard_params``: a
    warm-up generation, its all_reduces and all_gathers counted
    (:func:`_collectives`), then the measured one through
    ``make_prefill_step`` / ``make_serve_step`` on the mesh (B, prompt P,
    an encoder-decoder's WHISPER_FRAMES frames, ``steps`` greedy steps,
    the params and inputs of ``launch.generate`` at the same seed):
    prefill ms, decode ms a token, the prefill's launches (one SWA forward
    an attention layer, one fused scan a Mamba layer), peak memory; the
    rank's param and cache bytes, which must equal ``device_bytes`` of
    ``param_shardings`` / ``cache_shardings`` on a ``MeshShape`` of the
    mesh's sizes (the dry run's per-device bytes); the (B S, d)
    all_reduce timed alone (S: the encoder's frames, or the prompt); on
    the lead rank, the one-process run
    (``launch.generate --layers depth``) first, and the greedy tokens of
    the two that are equal, reported, not gated (bf16 partial sums round
    differently); on every rank the bf16 prefill logits against the
    uncut model's (its max abs difference beside each row's top-2 gap),
    and on the lead rank both against the same params' fp32 logits."""
    import copy
    import gc
    import torch
    from repro_torch.launch import generate
    from repro_torch.launch.mesh import MeshShape
    from repro_torch.models import build, get_config
    from repro_torch.models.convert import shard_params
    from repro_torch.models.lm import cache_nbytes
    from repro_torch.models.sharding import (cache_shardings, device_bytes,
                                             param_shardings, tp_config)
    from repro_torch.models.steps import make_prefill_step, make_serve_step

    cfg = tp_config(get_config(arch).with_(n_layers=depth,
                                           kv_cache_dtype=kv_cache_dtype),
                    mesh.shape["model"])
    dev = mesh.device
    audio = cfg.family == "audio"
    one = None
    if mesh.index("model") == 0:
        one = generate.main([
            "--arch", arch, "--layers", str(depth), "--batch",
            str(B), "--prompt-len", str(P), "--steps", str(steps),
            "--seed", str(SEED), "--device", str(dev), "--kv-cache-dtype",
            kv_cache_dtype, "--frames", str(WHISPER_FRAMES)])
        gc.collect()
        torch.cuda.empty_cache()
    # launch.generate's inputs: the prompt, then an encoder-decoder's
    # frames, from one generator
    rng = np.random.default_rng(SEED)
    batch = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, P), dtype=np.int32)).to(dev)}
    if audio:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (B, WHISPER_FRAMES, cfg.d_model), dtype=np.float32)).to(
                dev, cfg.jdtype)
    model = build(cfg).init(torch.Generator(device=dev).manual_seed(SEED))
    whole, _ = model.prefill(batch)                 # one process, uncut
    exact = None
    if one is not None:
        # the lead rank: the same params in fp32, the yardstick of bf16's
        # own rounding
        fp32 = build(cfg.with_(dtype="float32"))
        fp32.params = copy.deepcopy(model.params)
        for t in fp32.params.parameters():
            t.data = t.data.float()
        exact, _ = fp32.prefill({k: v.float() if v.is_floating_point()
                                 else v for k, v in batch.items()})
        del fp32
        torch.cuda.empty_cache()
    shard_params(model, mesh)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)       # the cut model's serving
    prefill, serve = make_prefill_step(model, mesh), make_serve_step(model,
                                                                     mesh)
    reset, read = _prefill_launches()
    want = _prefill_want(cfg)

    def generation(count: bool = False) -> dict:
        counts = {"prefill": {}, "decode_steps": {}}
        reset()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        with _collectives(counts["prefill"] if count else None):
            logits, cache = prefill(batch, P + steps)
            tok = logits.argmax(-1).to(torch.int32)
        torch.cuda.synchronize(dev)
        t1 = time.perf_counter()
        launches = read()
        ids = [tok]
        with _collectives(counts["decode_steps"] if count else None):
            for i in range(steps):
                tok, cache = serve(cache, tok, P + i)
                ids.append(tok)
        torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        out = {"logits": logits, "prefill_ms": (t1 - t0) * 1e3,
               "decode_ms_per_token": (t2 - t1) * 1e3 / steps,
               "swa_launches": launches["swa_attention_forward"],
               "scan_launches": launches["selective_scan_fused"],
               "cache_bytes": cache_nbytes(cache),
               "ids": torch.cat(ids, 1).cpu().numpy()}
        if count:
            out["collectives"] = {
                "prefill": counts["prefill"],
                "a_decode_step": {k: v / steps for k, v in
                                  counts["decode_steps"].items()}}
        return out

    warm = generation(count=True)
    warm.pop("logits")
    run = generation()
    ids = run.pop("ids")
    # the prefill's bf16 logits against the uncut model's on the same
    # prompt: where the two argmaxes part, the one-process top-2 gap lies
    # under the difference (partial sums rounded to bf16 before the
    # all_reduce), reported, not gated
    got, whole = run.pop("logits").float(), whole.float()
    top2 = whole.topk(2, dim=-1).values
    gap = (top2[..., 0] - top2[..., 1]).flatten()
    same = (got.argmax(-1) == whole.argmax(-1)).flatten()
    vs_one = {"max_abs_diff": float((got - whole).abs().max()),
              "max_abs_logit": float(whole.abs().max()),
              "argmax_equal_rows": int(same.sum()), "rows": int(same.numel()),
              "top2_gap_by_row": gap.tolist()}
    if exact is not None:
        exact = exact.float()
        vs_one["fp32_max_abs_diff"] = {
            "tensor_parallel": float((got - exact).abs().max()),
            "one_process": float((whole - exact).abs().max())}
    del whole, got, exact
    check(np.array_equal(ids, warm.pop("ids")), f"the {arch} "
          f"tensor-parallel generation gave other tokens on its second run")
    check(((ids >= 0) & (ids < cfg.padded_vocab)).all(),
          f"{arch} tensor-parallel ids outside the vocab")
    for k, key in (("swa_attention_forward", "swa_launches"),
                   ("selective_scan_fused", "scan_launches")):
        check(run[key] == want[k], f"the bf16 tensor-parallel {arch} "
              f"prefill launched {run[key]} {_LAUNCH_NAMES[k]}, want "
              f"{want[k]}")
    shape = MeshShape(mesh.axis_names, mesh.sizes)
    specs = model.param_tree(None)
    seq = WHISPER_FRAMES if audio else P + steps
    cache = model.cache_spec(B, seq)
    dry = {"params": device_bytes(specs, param_shardings(cfg, shape, specs),
                                  shape)[1],
           "cache": device_bytes(cache, cache_shardings(cfg, shape, B, cache),
                                 shape)[1]}
    mine = {"params": sum(p.numel() * p.element_size()
                          for p in model.params.parameters()),
            "cache": run["cache_bytes"]}
    check(mine == dry, f"the rank's bytes {mine}, the dry run's {dry}")
    out = {"arch": arch, "layers": depth,
           "published_layers": get_config(arch).n_layers,
           "batch": B, "prompt": P, "steps": steps,
           "q_heads_a_rank": cfg.padded_heads() // mesh.shape["model"],
           "kv_slots_a_rank": cfg.groups // mesh.shape["model"]
           if cfg.n_heads else 0,
           **run, "warmup": warm, "bytes": mine, "dry_run_bytes": dry,
           "prefill_vs_one_process": vs_one,
           "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "kv_cache_dtype": kv_cache_dtype,
           "collectives": warm.pop("collectives"),
           **_all_reduce_ms(mesh, B * (WHISPER_FRAMES if audio else P),
                            cfg.d_model, cfg.jdtype)}
    out["all_reduces_a_prefill"] = out["collectives"]["prefill"].get(
        "all_reduce", 0)
    if one is not None:
        want = np.asarray(one["ids"])
        out.update(one_process_equal_tokens=int((ids == want).sum()),
                   tokens=int(want.size),
                   one_process_prefill_ms=one["prefill_ms"],
                   one_process_decode_ms_per_token=one[
                       "decode_ms_per_token"])
    del model, prefill, serve
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _mesh_rank(rank: int, sizes, parts, device: str, kg=None) -> dict:
    """One rank of a mesh-phase world: the mesh over ``device`` and the
    named parts, each with its seconds (``kg``: the GO release
    ``_mesh_kge`` trains on)."""
    import torch
    from repro_torch.launch.mesh import ProcessMesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = ProcessMesh.build(("data", "model"), sizes, device)
    out = {"coords": mesh.coords}
    for part in parts:
        t0 = time.perf_counter()
        if part == "kge":
            out[part] = _mesh_kge(mesh, kg)
        elif part == "tp_check":
            out[part] = [_mesh_tp_check(mesh, *c) for c in MESH_TP_CHECKS]
        elif part == "rec_check":
            out[part] = [_mesh_rec_check(mesh, *c) for c in MESH_REC_CHECKS]
        elif part == "rec_train":
            out[part] = [_mesh_rec_train(mesh, *c) for c in MESH_REC_TRAIN]
        else:
            out[part] = {"check": _mesh_moe_check, "prefill": _mesh_prefill,
                         "train": _mesh_train_check, "tp": _mesh_tp,
                         "rec_gen": _mesh_rec_gen,
                         "audio_check": _mesh_audio_check,
                         "audio_gen": _mesh_audio_gen,
                         "int8_tp": _mesh_int8}[part](mesh)
        torch.cuda.synchronize(mesh.device)
        out[part + "_seconds"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    return out


def phase_mesh(card: str) -> dict:
    """The multi-process half of the mesh on the one card: a world of one
    rank on NCCL (the expert-parallel fp32 check), then two ranks sharing
    cuda:0 on gloo, mesh (data 1, model 2): the fp32 check, the
    tensor-parallel fp32 checks (mistral-large-123b, h2o-danube-1.8b), the
    channel-parallel fp32 checks and training steps (falcon-mamba-7b,
    recurrentgemma-2b), whisper-base's fp32 check and training step, bf16
    mistral-large-123b, falcon-mamba-7b, recurrentgemma-2b and
    whisper-base generation, bf16 h2o-danube-1.8b with the int8 KV cache
    against the one-process int8 run, the bf16 expert-parallel prefill of
    olmoe-1b-7b at full width and depth, the 2-layer fp32
    expert-parallel training step against the one-process step, and the
    sharded KGE trainer on the GO workload; on two ranks the attention,
    MLP, recurrences, embedding and logits are cut over "model" as the
    reference lays them.  Then the kernels at a rank's shapes against
    their plain versions (:func:`_mesh_kernels`).  Times
    from the shared card stand for no multi-card deployment: gloo stages
    every collective through host memory."""
    import torch
    from repro_torch.launch.mesh import run_world

    torch.cuda.synchronize()
    torch.cuda.empty_cache()          # the ranks need the card's memory
    lap = laps("mesh")
    seconds = {}

    def world(name, *args, **kw):
        t0 = time.perf_counter()
        out = run_world(_mesh_rank, *args, timeout_s=MESH_TIMEOUT_S, **kw)
        seconds[name] = time.perf_counter() - t0
        return out

    # the world of one beside the world of two: its check ends while the
    # two ranks still run their checks, before any of their timed parts
    with ThreadPoolExecutor(1) as pool:
        nccl = pool.submit(world, "nccl", 1, backend="nccl",
                           devices="cuda:0",
                           args=((1, 1), ("check",), "cuda:0"))
        (_, kg1), _ = go_releases()
        kg = {"entities": kg1.num_entities, "relations": kg1.num_relations,
              "triples": kg1.triples}
        gloo = world("gloo", 2, backend="gloo", devices="cuda:0",
                     args=((1, 2), MESH_GLOO_PARTS, "cuda:0", kg))
        nccl = nccl.result()
    lap("nccl world of 1 beside the gloo world of 2 on cuda:0")
    launches = {"swa_attention_forward_prefill": sum(
        r["prefill"]["swa_launches"] for r in gloo),
        "swa_attention_forward_tp_prefill": [r["tp"]["swa_launches"]
                                             for r in gloo]}
    for e in ("swa_attention_forward", "swa_attention_bwd_dot",
              "swa_attention_backward_dkdv", "swa_attention_backward_dq"):
        launches[f"{e}_train"] = sum(r["train"]["launches"][e]
                                     for r in gloo)
    for e in ("kge_score_forward", "kge_score_backward"):
        launches[e] = sum(r["kge"]["launches"][e] for r in gloo)
    # the channel-parallel runs', over the ranks: the bf16 generations'
    # prefills and the fp32 training steps
    gen = {g["arch"]: g for r in gloo for g in r["rec_gen"]}
    for arch, key, e in ((MAMBA_ARCH, "scan_launches",
                          "selective_scan_fused"),
                         (HYBRID_ARCH, "swa_launches",
                          "swa_attention_forward")):
        launches[f"{e}_tp_prefill_{arch}"] = sum(
            g[key] for r in gloo for g in r["rec_gen"] if g["arch"] == arch)
    for e in ("selective_scan_fused", "selective_scan_fused_backward",
              "swa_attention_forward", "swa_attention_bwd_dot",
              "swa_attention_backward_dkdv", "swa_attention_backward_dq"):
        launches[f"{e}_tp_train"] = sum(t["launches"][e] for r in gloo
                                        for t in r["rec_train"])
        launches[f"{e}_audio_train"] = sum(
            r["audio_check"]["train"]["launches"][e] for r in gloo)
    # the audio and int8 parts', over the ranks: the bf16 prefills
    launches[f"swa_attention_forward_tp_prefill_{WHISPER_ARCH}"] = sum(
        r["audio_gen"]["swa_launches"] for r in gloo)
    launches["swa_attention_forward_tp_prefill_int8"] = sum(
        r["int8_tp"]["generation"]["swa_launches"] for r in gloo)
    kernels = _mesh_kernels(card)
    lap("the kernels at a rank's shapes")
    out = {"phase": "mesh", "nccl_world_of_1": nccl[0],
           "gloo_world_of_2": gloo, "launches": launches,
           "rank_shape_kernels": kernels,
           "tp_generation_by_arch": sorted(gen),
           "world_seconds": seconds,
           "note": "gloo on one shared card: collectives through host "
                   "memory; no multi-card figure"}
    emit(out)
    return out


def _mesh_kernels(card: str) -> dict:
    """The kernels of the channel-parallel paths at a rank's shapes on a
    model axis of MESH_TP_AXIS, each against its plain version by the
    scan and SWA phases' rules (PERF.md §2), then kernel ms (CUDA events)
    and the plain version's (timed once, warm from the check) beside the
    bound of the rank's half of the work, and SDPA's time for the SWA:
    the fused scan forward and its backward on falcon-mamba-7b's d_in / 2
    channels, the SWA forward and backward at d 256 on recurrentgemma-2b's
    q heads / 2 over one KV slot (B 2 each, bf16); the SWA forward at
    whisper-base's decoder layer (causal, W = S = WHISPER_PROMPT, d 64)
    on all 8 heads (the one-process shape) and on a rank's 4, and at a
    rank's 16 q / 4 kv heads of h2o-danube-1.8b's prefill layer (S
    LM_PROMPT, W 4,096, d 80), B 2 each (:func:`_swa_forward_row`)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref, selective_scan as ss, \
        swa_attention as sw
    from repro_torch.models import get_config
    from repro_torch.models.sharding import tp_config

    n = MESH_TP_AXIS
    lcfg = get_config(LM_ARCH)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 47)
    mcfg = get_config(MAMBA_ARCH)
    B, S, st = MAMBA_BATCH, MAMBA_PROMPT, mcfg.ssm.d_state
    d_in = mcfg.ssm.expand * mcfg.d_model // n
    fargs = _fused_inputs(B, S, d_in, st, torch.bfloat16, gen, True)
    h_k, o_k = ss.selective_scan_fused(*fargs)
    h_p, o_p = ref.selective_scan_fused(*fargs)
    err = max(_scan_close(o_k, o_p, "rank's fused scan out", BF16_ULP),
              _scan_close(h_k, h_p, "rank's fused scan h_last"))
    kern = lambda: ss.selective_scan_fused(*fargs)
    b_ms, b_by, parts = scan_bound_ms(B, S, d_in, st, 2, fused=True)
    scan = {"B": B, "S": S, "d_in": d_in, "d_state": st,
            "dtype": "bfloat16", "max_abs_err": err,
            "ms": _cuda_ms(kern, iters=20),
            "plain_ms": _cuda_ms(lambda: ref.selective_scan_fused(*fargs),
                                 iters=1, warmup=0),
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "bound_parts_ms": parts}
    _, _, states = ss.selective_scan_fused_forward(*fargs, save_states=True)
    dout = torch.randn((B, S, d_in), generator=gen, device=DEV).to(
        torch.bfloat16)
    bwd = lambda: ss.selective_scan_fused_backward(*fargs, dout, None,
                                                   states)
    e = _bwd_close(bwd(), ref.selective_scan_fused_backward(*fargs, dout),
                   "rank's fused scan backward")
    b_ms, b_by, parts = scan_bwd_bound_ms(B, S, d_in, st, 2)
    scan_bwd = {"B": B, "S": S, "d_in": d_in, "d_state": st,
                "dtype": "bfloat16",
                "max_abs_err": max(v for k, v in e.items()
                                   if k != "relative"),
                "max_err_over_max_reduced": e["relative"],
                "ms": _cuda_ms(bwd, iters=20),
                "plain_ms": _cuda_ms(lambda: ref.selective_scan_fused_backward(
                    *fargs, dout), iters=1, warmup=0),
                "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
                "bound_parts_ms": parts}
    del fargs, states, dout, h_k, o_k, h_p, o_p
    torch.cuda.empty_cache()

    hcfg = tp_config(get_config(HYBRID_ARCH), n)
    B, S, hd, W = HYBRID_BATCH, HYBRID_PROMPT, hcfg.hd, hcfg.hybrid.window
    hq, hkv = hcfg.padded_heads() // n, hcfg.groups // n
    fwd, (q, k, v, want, band) = _swa_forward_row(
        B, hq, hkv, S, hd, W, gen, "rank's SWA d 256")
    q4, k4, v4 = (x.reshape(B, -1, S, hd).detach().requires_grad_(True)
                  for x in (q, k, v))
    lse = ref.swa_attention_lse_ref(q[None], k[None], W)[0]
    do = torch.randn(q.shape, generator=gen, device=DEV).to(torch.bfloat16)
    back = lambda: sw.swa_attention_backward(q, k, v, want, lse, do, W)
    plain = ref.swa_attention_backward_ref(
        q[None], k[None], v[None], want[None], lse[None], do[None], W)
    err = max(_swa_close(g, w[0], torch.bfloat16,
                         f"rank's SWA d 256 backward {what}")
              for g, w, what in zip(back(), plain, ("dq", "dk", "dv")))
    del plain
    do4 = do.reshape(B, hq, S, hd)

    def lib_fb():
        for x in (q4, k4, v4):
            x.grad = None
        F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=band, enable_gqa=True).backward(do4)

    bb_ms, bb_by = swa_bwd_bound_ms(B, hq, hkv, S, hd, W, 2)
    bwd = {"B": B, "Hq": hq, "Hkv": hkv, "S": S, "d": hd, "W": W,
           "dtype": "bfloat16", "max_abs_err": err,
           "ms": _cuda_ms(back, iters=5, warmup=1),
           "plain_ms": _cuda_ms(lambda: ref.swa_attention_backward_ref(
               q[None], k[None], v[None], want[None], lse[None], do[None],
               W), iters=2, warmup=1),
           "library_ms": _cuda_ms(lib_fb, iters=3, warmup=1),
           "library_is": "SDPA forward + backward, band mask, enable_gqa",
           "bound_ms": bb_ms, "bound_by": bb_by}
    del q, k, v, want, lse, do, q4, k4, v4, do4, band
    torch.cuda.empty_cache()

    # the audio and int8 parts' SWA forwards: whisper-base's decoder layer
    # (causal, W = S) in one process and on a rank's heads, and a rank's
    # h2o-danube-1.8b prefill layer
    wcfg = get_config(WHISPER_ARCH)
    rows = {}
    for key, heads, kv_heads, (B, S, hd, W), note in (
            ("swa_forward_whisper", wcfg.padded_heads(), wcfg.groups,
             (WHISPER_BATCH, WHISPER_PROMPT, wcfg.hd, WHISPER_PROMPT),
             "whisper-base's decoder SWA, one process"),
            ("swa_forward_whisper_rank", wcfg.padded_heads() // n,
             wcfg.groups // n,
             (WHISPER_BATCH, WHISPER_PROMPT, wcfg.hd, WHISPER_PROMPT),
             "whisper-base's decoder SWA, a rank's heads"),
            ("swa_forward_h2o_rank", lcfg.padded_heads() // n,
             lcfg.groups // n, (LM_BATCH, LM_PROMPT, lcfg.hd, lcfg.window),
             "h2o-danube's SWA, a rank's heads")):
        rows[key], tensors = _swa_forward_row(B, heads, kv_heads, S, hd, W,
                                              gen, note)
        del tensors
        torch.cuda.empty_cache()
    return {"model_axis": n, "card": card, "scan_fused": scan,
            "scan_fused_backward": scan_bwd, "swa_forward_d256": fwd,
            "swa_backward_d256": bwd, **rows}


def _swa_forward_row(B: int, hq: int, hkv: int, S: int, hd: int, W: int,
                     gen, note: str) -> tuple:
    """The bf16 SWA forward at (B, hq / hkv heads, S, d, W) against its
    plain version (the SWA phase's rule), then its ms by CUDA events, the
    plain version's, SDPA's (band mask, ``enable_gqa``) and the bound.
    Returns (the row, (q, k, v, the plain output, the band))."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref, swa_attention as sw

    q, k, v = _swa_inputs(B, hq, hkv, S, S, hd, torch.bfloat16, gen)
    want = ref.swa_attention_ref(q[None], k[None], v[None], W)[0]
    err = _swa_close(sw.swa_attention_forward(q, k, v, W), want,
                     torch.bfloat16, note)
    pos = torch.arange(S, device=DEV)
    band = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < W)
    q4, k4, v4 = (x.reshape(B, -1, S, hd) for x in (q, k, v))
    b_ms, b_by = swa_bound_ms(B, hq, hkv, S, hd, W, 2)
    with torch.no_grad():
        row = {"B": B, "Hq": hq, "Hkv": hkv, "S": S, "d": hd, "W": W,
               "dtype": "bfloat16", "max_abs_err": err,
               "ms": _cuda_ms(lambda: sw.swa_attention_forward(q, k, v, W),
                              iters=20),
               "plain_ms": _cuda_ms(lambda: ref.swa_attention_ref(
                   q[None], k[None], v[None], W), iters=3, warmup=1),
               "library_ms": _cuda_ms(
                   lambda: F.scaled_dot_product_attention(
                       q4, k4, v4, attn_mask=band, enable_gqa=True),
                   iters=10, warmup=2),
               "bound_ms": b_ms, "bound_by": b_by}
    return row, (q, k, v, want, band)


# ------------------------ the selective scan ------------------------- #
def _scan_inputs(B: int, S: int, d_in: int, st: int, dtype, gen,
                 h0_zero: bool):
    """dt (softplus of N(0, 1), fp32), x, Bm, Cm (N(0, 1) in ``dtype``,
    Bm and Cm column slices of one (B, S, 16 + 2 st) tensor, as the model
    cuts them from x_proj's output), A = -(1 .. st) per channel (the
    model's init), h0 (0, or N(0, 1))."""
    import torch
    import torch.nn.functional as F
    dt = F.softplus(torch.randn((B, S, d_in), generator=gen, device=DEV))
    x = torch.randn((B, S, d_in), generator=gen, device=DEV).to(dtype)
    dbc = torch.randn((B, S, 16 + 2 * st), generator=gen,
                      device=DEV).to(dtype)
    Bm, Cm = dbc[..., 16:16 + st], dbc[..., 16 + st:]
    A = -torch.arange(1, st + 1, dtype=torch.float32,
                      device=DEV).expand(d_in, st).contiguous()
    h0 = torch.zeros((B, d_in, st), device=DEV) if h0_zero else \
        torch.randn((B, d_in, st), generator=gen, device=DEV)
    return h0, dt, Bm, Cm, A, x


def _fused_inputs(B: int, S: int, d_in: int, st: int, dtype, gen,
                  h0_zero: bool):
    """The fused entry point's arguments ``(h0, dt, Bm, Cm, A, xc, D, z,
    dt_bias)``, as ``_mamba_inner`` passes them: dt before softplus and
    its bias (N(0, 2) in ``dtype``, every 101st value 21.5, past
    softplus's threshold), z the second half of one (B, S, 2 d_in) tensor
    (in_proj's output), D N(0, 1) fp32, the bias N(0, 0.5) in ``dtype``,
    h0 None (zeros) or N(0, 1)."""
    import torch
    h0, _, Bm, Cm, A, x = _scan_inputs(B, S, d_in, st, dtype, gen, True)
    dt = torch.randn((B, S, d_in), generator=gen, device=DEV) * 2.0
    dt.view(-1)[::101] = 21.5
    xz = torch.randn((B, S, 2 * d_in), generator=gen, device=DEV).to(dtype)
    D = torch.randn((d_in,), generator=gen, device=DEV)
    b = (torch.randn((d_in,), generator=gen, device=DEV) * 0.5).to(dtype)
    h0 = None if h0_zero else torch.randn((B, d_in, st), generator=gen,
                                          device=DEV)
    return h0, dt.to(dtype), Bm, Cm, A, x, D, xz[..., d_in:], b


def _scan_close(got, want, note: str, ulp: float = 0.0) -> float:
    """max |got - want|; fails past SCAN_TOL + (SCAN_TOL + ulp) * |want|."""
    import torch
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    check(bool(torch.isfinite(got).all())
          and bool((diff <= SCAN_TOL + (SCAN_TOL + ulp) * want.abs()).all()),
          f"{note}: off by {float(diff.max())}")
    return float(diff.max())


def _grad_raises(fn, args, i: int) -> bool:
    """``fn(*args)`` with args[i] asking for a gradient raises
    NotImplementedError on the card."""
    args = list(args)
    args[i] = args[i].detach().requires_grad_(True)
    try:
        fn(*args)
    except NotImplementedError:
        return True
    return False


#: the backward against its plain version: the per-element gradients
#: (ddt, dxc, dz, dh0) within SCAN_TOL (1 + |plain|), plus one bf16 ulp on
#: a bf16 one, as the forward's out; the reduced ones (sums over channels,
#: steps or sequences: dA, dD, ddt_bias, dBm, dCm) within SCAN_TOL *
#: max|plain| of that gradient, plus one bf16 ulp of each value on a bf16
#: one (both round one fp32 sum, which may fall either side of a tie)
SCAN_BWD_ELEMENTWISE = ("dh0", "ddt", "dxc", "dz")
SCAN_BWD_REDUCED = ("dA", "dD", "ddt_bias", "dBm", "dCm")
#: the cases whose backward also starts from a gradient of h_last
SCAN_BWD_DH_LAST = ("test config, S 33, h0", "reduced falcon-mamba, S 300")
_BWD_NAMES = ("dh0", "ddt", "dBm", "dCm", "dA", "dxc", "dD", "dz",
              "ddt_bias")


def _bwd_close(got, want, note: str) -> dict:
    """Each gradient of the backward against the plain one, by
    SCAN_BWD_ELEMENTWISE / SCAN_BWD_REDUCED's rules: ``{name: max abs
    err}`` (``{name: max abs err / max|plain|}`` under ``relative``)."""
    import torch
    out, rel = {}, {}
    for name, g, w in zip(_BWD_NAMES, got, want):
        if w is None:
            check(g is None, f"{note} {name}: got a gradient of no input")
            continue
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{note} {name}: {g.dtype} {tuple(g.shape)}, want {w.dtype} "
              f"{tuple(w.shape)}")
        ulp = BF16_ULP if w.dtype == torch.bfloat16 else 0.0
        if name in SCAN_BWD_ELEMENTWISE:
            out[name] = _scan_close(g, w, f"{note} {name}", ulp)
            continue
        g, w = g.float(), w.float()
        diff = (g - w).abs()
        scale = float(w.abs().max())
        check(bool(torch.isfinite(g).all()) and bool(
            (diff <= SCAN_TOL * scale + ulp * w.abs()).all()),
            f"{note} {name}: off by {float(diff.max())} (max|plain| "
            f"{scale})")
        out[name] = float(diff.max())
        rel[name] = float(diff.max()) / max(scale, 1e-30)
    return {**out, "relative": rel}


def phase_scan() -> dict:
    """The selective-scan kernel's three entry points against their plain
    versions on the card, fp32 and bf16 inputs: the reduced shapes
    (d_state 4 and 8, S not a multiple of the 256-step chunk, S = 1) and
    one falcon-mamba-7b layer (B 2, S 2048, d_in 8192, d_state 16) from a
    state h0 != 0.  The bare scan on y and h_last (rtol = atol = 2e-4, the
    reference's own tolerance for its chunked scan against the stepwise
    decode); the fused one (softplus, dt's bias, the D skip, the silu(z)
    gate, z a strided half of in_proj's output) on h_last and out (the
    same, plus one bf16 ulp in bf16); the fused one with its tile states
    the same bits as without; the fused backward on every gradient
    (SCAN_BWD_ELEMENTWISE / SCAN_BWD_REDUCED), from h0 where the case has
    one and from a gradient of h_last on SCAN_BWD_DH_LAST's cases.  At
    the falcon-mamba-7b layer two launches of each give the same bits.
    A gradient asked of the fused entry point runs the forward and the
    backward kernel; one asked of the bare scan raises."""
    import torch
    from repro_torch.kernels import ref, selective_scan as ss

    gen = torch.Generator(device=DEV).manual_seed(SEED + 21)
    ss.reset_launches()
    err = {n: {"y": 0.0, "h_last": 0.0, "fused_out": 0.0,
               "fused_h_last": 0.0, "backward": {}}
           for n in ("float32", "bfloat16")}
    cases, calls = [], {"selective_scan_forward": 0,
                        "selective_scan_fused": 0,
                        "selective_scan_fused_backward": 0}
    for note, (B, S, d_in, st, h0_zero) in SCAN_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).replace("torch.", "")
            twice = note.startswith("falcon")
            args = _scan_inputs(B, S, d_in, st, dtype, gen, h0_zero)
            h_k, y_k = ss.selective_scan(*args)
            h_p, y_p = ref.selective_scan(*args)
            calls["selective_scan_forward"] += 1
            for what, g, w in (("y", y_k, y_p), ("h_last", h_k, h_p)):
                err[name][what] = max(err[name][what], _scan_close(
                    g, w, f"scan {note} {name} {what}"))
            if twice:
                h2, y2 = ss.selective_scan(*args)
                calls["selective_scan_forward"] += 1
                check(torch.equal(h2, h_k) and torch.equal(y2, y_k),
                      f"scan {note} {name}: two launches differ")
            del args, h_k, y_k, h_p, y_p
            # the fused entry point
            fargs = _fused_inputs(B, S, d_in, st, dtype, gen, h0_zero)
            h_k, o_k = ss.selective_scan_fused(*fargs)
            h_p, o_p = ref.selective_scan_fused(*fargs)
            calls["selective_scan_fused"] += 1
            check(o_k.dtype == dtype and tuple(o_k.shape) == (B, S, d_in),
                  f"fused {note} {name}: out {o_k.dtype} {tuple(o_k.shape)}")
            ulp = BF16_ULP if dtype == torch.bfloat16 else 0.0
            err[name]["fused_out"] = max(err[name]["fused_out"], _scan_close(
                o_k, o_p, f"fused {note} {name} out", ulp))
            err[name]["fused_h_last"] = max(
                err[name]["fused_h_last"],
                _scan_close(h_k, h_p, f"fused {note} {name} h_last"))
            if twice:
                h2, o2 = ss.selective_scan_fused(*fargs)
                calls["selective_scan_fused"] += 1
                check(torch.equal(h2, h_k) and torch.equal(o2, o_k),
                      f"fused {note} {name}: two launches differ")
            del h_p, o_p
            # the backward, from the forward's tile states
            h_s, o_s, states = ss.selective_scan_fused_forward(
                *fargs, save_states=True)
            calls["selective_scan_fused"] += 1
            check(torch.equal(h_s, h_k) and torch.equal(o_s, o_k),
                  f"fused {note} {name}: the forward with states differs")
            del h_s, o_s, h_k, o_k
            dout = torch.randn((B, S, d_in), generator=gen,
                               device=DEV).to(dtype)
            dh_last = torch.randn((B, d_in, st), generator=gen, device=DEV) \
                if note in SCAN_BWD_DH_LAST else None
            g_k = ss.selective_scan_fused_backward(*fargs, dout, dh_last,
                                                   states)
            calls["selective_scan_fused_backward"] += 1
            g_p = ref.selective_scan_fused_backward(*fargs, dout, dh_last)
            e = _bwd_close(g_k, g_p, f"backward {note} {name}")
            acc = err[name]["backward"]
            for k, v in e.items():
                if k == "relative":
                    rel = acc.setdefault("relative", {})
                    for kk, vv in v.items():
                        rel[kk] = max(rel.get(kk, 0.0), vv)
                else:
                    acc[k] = max(acc.get(k, 0.0), v)
            del g_p
            if twice:
                g2 = ss.selective_scan_fused_backward(*fargs, dout, dh_last,
                                                      states)
                calls["selective_scan_fused_backward"] += 1
                check(all((a is None and b is None) or torch.equal(a, b)
                          for a, b in zip(g2, g_k)),
                      f"backward {note} {name}: two launches differ")
                del g2
            cases.append(f"{note} {name}")
            del fargs, g_k, states, dout, dh_last
    # a gradient asked of the fused entry point: SelectiveScanFusedFn's
    # forward (with states) and backward kernels, one launch each
    fargs = list(_fused_inputs(1, 40, 64, 4, torch.float32, gen, True))
    fargs[1] = fargs[1].requires_grad_(True)
    _, out = ss.selective_scan_fused(*fargs)
    out.sum().backward()
    calls["selective_scan_fused"] += 1
    calls["selective_scan_fused_backward"] += 1
    check(bool(torch.isfinite(fargs[1].grad).all()),
          "fused: the gradient through SelectiveScanFusedFn is not finite")
    torch.cuda.synchronize()
    check(ss.launches == calls, f"scan: launches {ss.launches}, want {calls}")
    raised = _grad_raises(ss.selective_scan, _scan_inputs(
        1, 8, 64, 4, torch.float32, gen, True), 1)
    check(raised, "scan: a gradient asked of the bare scan on the card "
                  "did not raise")
    out = {"phase": "scan", "cases": cases, "max_abs_err": err,
           "launches": calls,
           "tolerance": f"{SCAN_TOL} + {SCAN_TOL} * |plain| (+ {BF16_ULP} "
                        f"* |plain| on bf16 out)",
           "backward_tolerance": {
               "elementwise": f"{SCAN_TOL} + {SCAN_TOL} * |plain| (+ "
                              f"{BF16_ULP} * |plain| in bf16): "
                              f"{', '.join(SCAN_BWD_ELEMENTWISE)}",
               "reduced": f"{SCAN_TOL} * max|plain| (+ {BF16_ULP} * |plain| "
                          f"in bf16): {', '.join(SCAN_BWD_REDUCED)}"},
           "bare_grad_on_card_raises": raised}
    emit(out)
    return out


def scan_bound_ms(B: int, S: int, d_in: int, st: int, in_bytes: int,
                  fused: bool = False) -> tuple:
    """Least time for one layer's scan.  Bare: dt (fp32), x, Bm, Cm
    (``in_bytes`` each), A and h0 read once, y (fp32) and h_last written
    once; against one exp per (b, t, channel, state) on the SFUs and 5
    fp32 operations per (b, t, channel, state) on the CUDA cores.  Fused
    (h0 = 0, as a prefill runs it): dt, x, z, Bm, Cm, dt's bias in the
    model's dtype, A and D read once, out (model dtype) and h_last written
    once; the SFUs take, besides the exps, softplus's exp and log and one
    operation for silu per (b, t, channel) (z/2 (1 + tanh(z/2)): one
    tanh; the kernel issues an exp and a reciprocal, so its own count is
    one more), and the CUDA cores 11 more operations per (b, t, channel).
    Returns (ms, bound_by, the three times)."""
    elems, chan = B * S * d_in * st, B * S * d_in
    if fused:
        nbytes = (chan * 4 * in_bytes + 2 * B * S * st * in_bytes
                  + d_in * st * 4 + d_in * (4 + in_bytes) + B * d_in * st * 4)
        sfu, fp32 = elems + 3 * chan, 5.0 * elems + 11.0 * chan
    else:
        nbytes = (chan * (4 + in_bytes + 4) + 2 * B * S * st * in_bytes
                  + d_in * st * 4 + 2 * B * d_in * st * 4)
        sfu, fp32 = elems, 5.0 * elems
    t = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
         "exp": sfu / SFU_EXP_PER_S * 1e3,
         "fp32": fp32 / FP32_FLOP_PER_S * 1e3}
    by = max(t, key=t.get)
    return t[by], ("bytes" if by == "bytes" else "operations"), t


def scan_bwd_bound_ms(B: int, S: int, d_in: int, st: int,
                      in_bytes: int) -> tuple:
    """Least time for one layer's fused-scan backward as training runs it
    (h0 = 0, no gradient of h_last), counted as ``scan_bound_ms`` counts
    the forward's.  Bytes: the entry point's inputs read once, dt, x, z,
    dout, Bm, Cm, dt's bias (model dtype), A, D and the forward's saved
    states (fp32, one (d_in, st) a 16-step tile a sequence, which the
    reverse walk needs), and its outputs written once, ddt, dx, dz, dBm,
    dCm, ddt_bias (model dtype), dA and dD (fp32).  MUFU operations: the
    recomputed state exp per (b, t, channel, state), and per (b, t,
    channel) softplus's exp and log, its derivative's reciprocal (sigmoid
    from the same exp) and one sigmoid of z for silu and silu' (as one
    tanh); fp32: 23 operations per (b, t, channel, state) (5 of the
    recompute, 18 of the adjoint and its sums), 14 per (b, t, channel).
    Returns (ms, bound_by, the three times); the times also hold
    ``design_bytes``, the ms the kernel's workspace takes at the same
    rate and the bound leaves out: dB | dC's partials, one (B, S, 2 st)
    fp32 row a cluster of ``CHANNELS_PER_PARTIAL`` channels (the
    wrapper's constant), and dA, dD, ddt_bias's per-sequence ones,
    written and read back once."""
    from repro_torch.kernels import selective_scan as ss
    elems, chan = B * S * d_in * st, B * S * d_in
    n_tiles = -(-S // ss.TILE)
    n_part = -(-d_in // ss.CHANNELS_PER_PARTIAL)
    nbytes = (chan * 7 * in_bytes + 2 * 2 * B * S * st * in_bytes
              + d_in * 2 * (st * 4 + 4 + in_bytes)
              + B * n_tiles * d_in * st * 4)
    design = (2 * n_part * B * S * 2 * st * 4 + 2 * B * d_in * (st + 2) * 4)
    sfu, fp32 = elems + 4 * chan, 23.0 * elems + 14.0 * chan
    t = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
         "exp": sfu / SFU_EXP_PER_S * 1e3,
         "fp32": fp32 / FP32_FLOP_PER_S * 1e3}
    by = max(t, key=t.get)
    t["design_bytes"] = design / HBM_BYTES_PER_S * 1e3
    return t[by], ("bytes" if by == "bytes" else "operations"), t


def _unfused(h0, dt, Bm, Cm, A, xc, D, z, dt_bias):
    """The chain the fused entry point replaces, as ``_mamba_inner`` ran
    it on the card before the fusion: dt's bias and softplus, the bare
    scan kernel from a zero state, the D skip and the gate as PyTorch
    passes (the yardstick of ``scan_numbers``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import selective_scan as ss
    dtf = F.softplus((dt + dt_bias).float())
    if h0 is None:
        h0 = torch.zeros((dt.shape[0], dt.shape[2], A.shape[1]),
                         dtype=torch.float32, device=dt.device)
    h, y = ss.selective_scan(h0, dtf, Bm, Cm, A, xc)
    y = y + D * xc.float()
    return h, (y * F.silu(z.float())).to(xc.dtype)


def scan_numbers(card: str) -> dict:
    """The selective-scan kernel at one falcon-mamba-7b prefill layer's
    shape (B 2, S 2048, d_in 8192, d_state 16, bf16, h0 = 0): the bare
    entry point (kernel ms by CUDA events, device ms by the profiler, the
    plain version's ms, the bound) and, under ``fused``, the main path's
    fused one: the same, and ``unfused_ms`` / ``unfused_device_ms``, the
    bare kernel with the PyTorch passes the fused one replaces, and its
    time with its tile states written (training's forward) and without,
    in turns; under ``backward`` the fused entry point's backward as
    training runs it (h0 = 0, no gradient of h_last): kernel ms, device
    ms by kernel (the backward and the sums of its partials), the plain
    backward's ms, its bound.  No single PyTorch call computes any of them, so there
    is no library time."""
    import torch
    from repro_torch.kernels import ref, selective_scan as ss
    from repro_torch.models import get_config

    cfg = get_config(MAMBA_ARCH)
    B, S = MAMBA_BATCH, MAMBA_PROMPT
    d_in, st = cfg.ssm.expand * cfg.d_model, cfg.ssm.d_state
    gen = torch.Generator(device=DEV).manual_seed(SEED + 22)

    def scan_ms(fn) -> float:
        runs = {n: t for n, t in _device_ms(fn).items()
                if "selective_scan" in n}
        return sum(runs.values()) if runs else None

    args = _scan_inputs(B, S, d_in, st, torch.bfloat16, gen, True)
    kern = lambda: ss.selective_scan(*args)
    b_ms, b_by, parts = scan_bound_ms(B, S, d_in, st, 2)
    rec = {"B": B, "S": S, "d_in": d_in, "d_state": st, "dtype": "bfloat16",
           "ms": _cuda_ms(kern, iters=20), "device_ms": scan_ms(kern),
           "plain_ms": _cuda_ms(lambda: ref.selective_scan(*args), iters=2,
                                warmup=1),
           "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
           "bound_parts_ms": parts, "card": card}
    del args
    fargs = _fused_inputs(B, S, d_in, st, torch.bfloat16, gen, True)
    kern = lambda: ss.selective_scan_fused(*fargs)
    unfused = lambda: _unfused(*fargs)
    b_ms, b_by, parts = scan_bound_ms(B, S, d_in, st, 2, fused=True)
    rec["fused"] = {
        "ms": _cuda_ms(kern, iters=20), "device_ms": scan_ms(kern),
        "plain_ms": _cuda_ms(lambda: ref.selective_scan_fused(*fargs),
                             iters=2, warmup=1),
        "unfused_ms": _cuda_ms(unfused, iters=20),
        "unfused_device_ms": sum(_device_ms(unfused).values()),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "bound_parts_ms": parts}
    # the forward with its tile states (as training runs it) and without
    # (a prefill's), in turns; then the backward as training runs it
    # (h0 = 0, no gradient of h_last)
    fwd = lambda: ss.selective_scan_fused_forward(*fargs)
    fwd_s = lambda: ss.selective_scan_fused_forward(*fargs,
                                                    save_states=True)
    turns = [_cuda_ms(f, iters=20) for f in (fwd, fwd_s, fwd_s, fwd)]
    rec["fused"]["without_states_ms"] = [turns[0], turns[3]]
    rec["fused"]["with_states_ms"] = [turns[1], turns[2]]
    _, _, states = fwd_s()
    dout = torch.randn((B, S, d_in), generator=gen, device=DEV).to(
        torch.bfloat16)
    bwd = lambda: ss.selective_scan_fused_backward(*fargs, dout, None,
                                                   states)
    by_kernel = _device_ms(bwd)
    b_ms, b_by, parts = scan_bwd_bound_ms(B, S, d_in, st, 2)
    rec["backward"] = {
        "ms": _cuda_ms(bwd, iters=20),
        "device_ms": sum(by_kernel.values()) if by_kernel else None,
        "device_ms_by_kernel": by_kernel,
        "plain_ms": _cuda_ms(lambda: ref.selective_scan_fused_backward(
            *fargs, dout), iters=2, warmup=1),
        "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
        "bound_parts_ms": parts}
    emit({"scan_numbers": rec})
    del fargs, states, dout
    torch.cuda.empty_cache()
    return rec


# ----------------------- the other zoo families ----------------------- #
def _consistency(model, full_batch: dict, part_batch: dict, pos: int,
                 token, counters: dict) -> dict:
    """fp32: the last logits of prefill(full_batch) against
    prefill(part_batch) + decode_step(token, pos) (the reference's TOL,
    the same argmax); each counter in ``counters`` (name -> (reset, read))
    read after each prefill."""
    import torch
    t0 = time.perf_counter()
    per_prefill = {}
    for n, (reset, _) in counters.items():
        reset()
    whole, _ = model.prefill(full_batch)
    torch.cuda.synchronize()
    per_prefill["full"] = {n: read() for n, (_, read) in counters.items()}
    for n, (reset, _) in counters.items():
        reset()
    _, cache = model.prefill(part_batch, cache_len=pos + 1)
    per_prefill["part"] = {n: read() for n, (_, read) in counters.items()}
    dec, _ = model.decode_step(cache, token, pos)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(whole).all())
          and bool(torch.isfinite(dec).all()), "fp32 logits not finite")
    diff = (dec - whole).abs()
    check(bool((diff <= LM_TOL * (1 + whole.abs())).all()),
          f"prefill(S+1) vs prefill(S) + decode: off by {float(diff.max())}")
    same = bool(torch.equal(dec.argmax(-1), whole.argmax(-1)))
    check(same, "prefill(S+1) vs prefill(S) + decode: argmax differs")
    return {"layers": model.cfg.n_layers, "max_abs_diff": float(diff.max()),
            "max_abs_logit": float(whole.abs().max()), "argmax_equal": same,
            "seconds": time.perf_counter() - t0,
            "launches_per_prefill": per_prefill}


def _launch_counters() -> dict:
    from repro_torch.kernels import selective_scan as ss, swa_attention as sw
    return {"swa": (sw.reset_launches,
                    lambda: sw.launches["swa_attention_forward"]),
            "scan": (ss.reset_launches,
                     lambda: ss.launches["selective_scan_fused"]),
            "scan_bare": (ss.reset_launches,
                          lambda: ss.launches["selective_scan_forward"])}


def _generate(argv: list, swa_want: int, scan_want: int, vocab: int,
              ids_shape: tuple, warm_up: bool = True) -> tuple:
    """``launch.generate`` with ``argv``: a warm-up run (unless the caller
    warmed the same shapes up), then the measured one, whose prefill must
    launch ``swa_want`` SWA forwards and ``scan_want`` fused scans (and no
    SWA or scan backward, no bare scan); its ids in the vocab.  Returns
    (warm-up result or None, measured result, launches)."""
    import gc
    import torch
    from repro_torch.kernels import selective_scan as ss, swa_attention as sw
    from repro_torch.launch import generate
    warm = generate.main(argv) if warm_up else None
    gc.collect()                        # the warm-up run's model, freed
    torch.cuda.empty_cache()
    sw.reset_launches()
    ss.reset_launches()
    run = generate.main(argv)
    torch.cuda.synchronize()
    launches = {**sw.launches, **ss.launches}
    check(launches == {"swa_attention_forward": swa_want,
                       "swa_attention_bwd_dot": 0,
                       "swa_attention_backward_dkdv": 0,
                       "swa_attention_backward_dq": 0,
                       "selective_scan_forward": 0,
                       "selective_scan_fused": scan_want,
                       "selective_scan_fused_backward": 0},
          f"generation launched {launches}, want {swa_want} SWA forwards "
          f"and {scan_want} scans")
    ids = np.asarray(run["ids"])
    check(ids.shape == ids_shape and ((ids >= 0) & (ids < vocab)).all(),
          f"ids {ids.shape}")
    torch.cuda.empty_cache()
    return warm, run, launches


def phase_mamba() -> dict:
    """falcon-mamba-7b at its published width and depth.

    fp32, 2 of its 64 layers: the last logits of prefill(S + 1) against
    prefill(S) + decode_step, S = 2048: the fused scan kernel (one launch
    a layer, both prefills; no bare one) against the plain one-step state
    update of decode.  bf16: the generation of ``launch.generate`` (a
    warm-up run, then the measured one): prefill ms, tokens/s, decode ms a
    token, the state's bytes, peak memory, 64 fused scan launches a
    prefill."""
    import torch
    from repro_torch.models import build, get_config

    full = get_config(MAMBA_ARCH)
    cfg = full.with_(dtype="float32", n_layers=MAMBA_CHECK_LAYERS)
    model = build(cfg).init(torch.Generator(device=DEV).manual_seed(SEED))
    rng = np.random.default_rng(SEED + 23)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (
        MAMBA_BATCH, MAMBA_PROMPT + 1), dtype=np.int32)).to(DEV)
    consistency = _consistency(model, {"tokens": toks},
                               {"tokens": toks[:, :-1]}, MAMBA_PROMPT,
                               toks[:, -1:], _launch_counters())
    check(all(c["scan"] == cfg.n_layers and c["swa"] == 0
              and c["scan_bare"] == 0
              for c in consistency["launches_per_prefill"].values()),
          f"fp32 prefills launched {consistency['launches_per_prefill']}, "
          f"want {cfg.n_layers} scans each")
    del model
    torch.cuda.empty_cache()

    argv = ["--arch", MAMBA_ARCH, "--batch", str(MAMBA_BATCH),
            "--prompt-len", str(MAMBA_PROMPT), "--steps", str(MAMBA_STEPS),
            "--seed", str(SEED), "--device", DEV]
    # ----------------- main path: bf16 generation --------------------- #
    warm, run, launches = _generate(
        argv, 0, full.n_layers, full.padded_vocab,
        (MAMBA_BATCH, MAMBA_STEPS + 1))
    check(run["state_bytes"] > 0, "no state bytes")
    out = {"phase": "mamba", "fp32_consistency": consistency,
           "generation": {k: v for k, v in run.items() if k != "ids"},
           "warmup_generation": {k: warm[k] for k in (
               "prefill_ms", "decode_ms_per_token")},
           "decode_weight_read_bound_ms":
               2.0 * full.n_params() / HBM_BYTES_PER_S * 1e3,
           "ids_row0": run["ids"][0], "launches": launches}
    emit(out)
    return out


def _hybrid_layers(cfg, kind: str) -> tuple:
    """(layers of ``kind`` in ``HybridLM``'s full periods, which it remats,
    and in its remainder, which it runs plain) of hybrid config ``cfg``."""
    from repro_torch.models import build
    m = build(cfg)
    return m.n_periods * m.pattern.count(kind), m.rem.count(kind)


def _attention_layers(arch: str, n_layers: int) -> tuple:
    """(attention layers under remat, attention layers outside it) of
    ``arch`` cut to ``n_layers``: every arch but the hybrid remats every
    layer."""
    from repro_torch.models import get_config
    cfg = get_config(arch)
    if cfg.family != "hybrid":
        return n_layers, 0
    return _hybrid_layers(cfg.with_(n_layers=n_layers), "attention")


def rglru_scan_numbers(cfg, B: int, S: int) -> dict:
    """The RG-LRU scan (``blocks._rglru_scan``: the gates, a log-depth scan
    within 256-step chunks, the carry across them; no kernel) at one
    layer's shape of ``cfg``, bf16 input: CUDA events and profiler device
    ms of the forward (a prefill's), and of the forward with its graph
    plus the backward (a training step's); then their sums over the
    recurrent layers of a prefill and of a remat "full" step (each
    recurrent layer of a period runs its forward twice, the remainder's
    once, and every one its backward)."""
    import torch
    from repro_torch.models import blocks
    gen = torch.Generator(device=DEV).manual_seed(SEED + 31)
    p = blocks.rglru_init(gen, cfg)
    w = cfg.hybrid.lru_width or cfg.d_model
    xc = torch.randn((B, S, w), generator=gen, device=DEV).to(cfg.jdtype)
    h0 = torch.zeros((B, w), dtype=torch.float32, device=DEV)
    dy = torch.randn((B, S, w), generator=gen, device=DEV)

    def fwd():
        with torch.no_grad():
            return blocks._rglru_scan(p, xc, h0)

    xg = xc.detach().requires_grad_(True)

    def fwd_bwd():
        y, _ = blocks._rglru_scan(p, xg, h0)
        y.backward(dy)

    rec = {"B": B, "S": S, "w": w, "dtype": str(cfg.jdtype).replace(
        "torch.", "")}
    for name, fn, iters in (("forward", fwd, 10), ("forward_backward",
                                                   fwd_bwd, 5)):
        dev = _device_ms(fn, iters=iters)
        rec[f"{name}_ms"] = _cuda_ms(fn, iters=iters, warmup=2)
        rec[f"{name}_device_ms"] = sum(dev.values()) if dev else None
    in_periods, in_rem = _hybrid_layers(cfg, "recurrent")
    for unit in ("ms", "device_ms"):
        f, fb = rec[f"forward_{unit}"], rec[f"forward_backward_{unit}"]
        rec[f"prefill_{unit}"] = None if f is None else \
            (in_periods + in_rem) * f
        rec[f"train_step_{unit}"] = None if f is None or fb is None else \
            in_periods * (f + fb) + in_rem * fb
    rec["recurrent_layers"] = in_periods + in_rem
    del p, xc, xg, dy
    torch.cuda.empty_cache()
    return rec


def phase_hybrid() -> dict:
    """recurrentgemma-2b at its published width and depth.

    fp32, 3 of its 26 layers (two RG-LRU layers, then local attention at
    d = 256 on the SWA kernel): the last logits of prefill(S + 1) against
    prefill(S) + decode_step, S = 4,096 > W = 2,048 (the rolling cache
    wraps); one SWA launch a prefill.  bf16: the generation of
    ``launch.generate`` (a warm-up run, then the measured one; B 2, prompt
    4,096, 16 steps): prefill ms, tokens/s, decode ms a token, the cache's
    bytes (RG-LRU states, conv tails, rolling KV), peak memory, 8 SWA
    launches a prefill; then the RG-LRU scan's time at one layer's shape
    and over a prefill's 18 recurrent layers."""
    import torch
    from repro_torch.models import build, get_config

    full = get_config(HYBRID_ARCH)
    cfg = full.with_(dtype="float32", n_layers=HYBRID_CHECK_LAYERS)
    model = build(cfg).init(torch.Generator(device=DEV).manual_seed(SEED))
    rng = np.random.default_rng(SEED + 29)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (
        HYBRID_BATCH, HYBRID_PROMPT + 1), dtype=np.int32)).to(DEV)
    consistency = _consistency(model, {"tokens": toks},
                               {"tokens": toks[:, :-1]}, HYBRID_PROMPT,
                               toks[:, -1:], _launch_counters())
    n_attn = sum(_attention_layers(HYBRID_ARCH, cfg.n_layers))
    check(n_attn == 1 and all(
        c["swa"] == n_attn and c["scan"] == 0 and c["scan_bare"] == 0
        for c in consistency["launches_per_prefill"].values()),
          f"fp32 prefills launched {consistency['launches_per_prefill']}, "
          f"want {n_attn} SWA forward each")
    del model
    torch.cuda.empty_cache()

    argv = ["--arch", HYBRID_ARCH, "--batch", str(HYBRID_BATCH),
            "--prompt-len", str(HYBRID_PROMPT), "--steps",
            str(HYBRID_STEPS), "--seed", str(SEED), "--device", DEV]
    # ----------------- main path: bf16 generation --------------------- #
    n_attn = sum(_attention_layers(HYBRID_ARCH, full.n_layers))
    warm, run, launches = _generate(
        argv, n_attn, 0, full.padded_vocab,
        (HYBRID_BATCH, HYBRID_STEPS + 1))
    window = full.hybrid.window
    want_kv = 2 * n_attn * HYBRID_BATCH * full.groups * window * full.hd * 2
    check(run["kv_cache_bytes"] == want_kv and run["lru_state_bytes"] > 0
          and run["conv_state_bytes"] > 0,
          f"cache bytes {run['kv_cache_bytes']}, want {want_kv} of rolling "
          f"KV beside the RG-LRU states")
    scan = rglru_scan_numbers(full, HYBRID_BATCH, HYBRID_PROMPT)
    out = {"phase": "hybrid", "layers": full.n_layers,
           "attention_layers": n_attn, "fp32_consistency": consistency,
           "generation": {k: v for k, v in run.items() if k != "ids"},
           "warmup_generation": {k: warm[k] for k in (
               "prefill_ms", "decode_ms_per_token")},
           "rglru_scan": scan,
           "decode_weight_read_bound_ms":
               2.0 * full.n_params() / HBM_BYTES_PER_S * 1e3,
           "ids_row0": run["ids"][0], "launches": launches}
    emit(out)
    return out


def _frames(cfg, n: int, seed: int, dtype):
    import torch
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(
        (WHISPER_BATCH, n, cfg.d_model), dtype=np.float32)).to(DEV, dtype)


def phase_whisper() -> dict:
    """whisper-base at its published width and depth.

    fp32: 1,500 encoder frames, the last logits of a 65-token decoder
    prefill against a 64-token prefill + decode_step: the SWA kernel's
    causal band (W = S, d = 64) in every decoder layer of the prefill
    against the plain decode attention over the 448-slot cache.  bf16: the
    generation of ``launch.generate`` (1,500 frames, prompt 64, 32 steps;
    a warm-up run, then the measured one), 6 SWA launches a prefill."""
    import torch
    from repro_torch.models import build, get_config

    full = get_config(WHISPER_ARCH)
    cfg = full.with_(dtype="float32")
    model = build(cfg).init(torch.Generator(device=DEV).manual_seed(SEED))
    rng = np.random.default_rng(SEED + 24)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (
        WHISPER_BATCH, WHISPER_PROMPT + 1), dtype=np.int32)).to(DEV)
    frames = _frames(cfg, WHISPER_FRAMES, SEED + 25, torch.float32)
    consistency = _consistency(
        model, {"frames": frames, "tokens": toks},
        {"frames": frames, "tokens": toks[:, :-1]}, WHISPER_PROMPT,
        toks[:, -1:], _launch_counters())
    check(all(c["swa"] == cfg.n_layers and c["scan"] == 0
              for c in consistency["launches_per_prefill"].values()),
          f"fp32 prefills launched {consistency['launches_per_prefill']}, "
          f"want {cfg.n_layers} SWA forwards each")
    del model
    torch.cuda.empty_cache()

    argv = ["--arch", WHISPER_ARCH, "--batch", str(WHISPER_BATCH),
            "--frames", str(WHISPER_FRAMES), "--prompt-len",
            str(WHISPER_PROMPT), "--steps", str(WHISPER_STEPS), "--seed",
            str(SEED), "--device", DEV]
    # ----------------- main path: bf16 generation --------------------- #
    warm, run, launches = _generate(
        argv, full.n_layers, 0, full.padded_vocab,
        (WHISPER_BATCH, WHISPER_STEPS + 1))
    out = {"phase": "whisper", "fp32_consistency": consistency,
           "generation": {k: v for k, v in run.items() if k != "ids"},
           "warmup_generation": {k: warm[k] for k in (
               "prefill_ms", "decode_ms_per_token")},
           "ids_row0": run["ids"][0], "launches": launches}
    emit(out)
    return out


def phase_llava(card: str) -> dict:
    """llava-next-34b at its published width and depth.

    fp32, 2 layers: 2,880 image embeddings and a 65-token text prompt, the
    last logits of that prefill against the 64-token one + decode_step at
    position 2,944: the SWA kernel's causal band (W = S, d = 128, 7 q
    heads a kv head) in every prefill layer against the plain decode
    attention.  bf16: where a prefill's and a decode step's device time
    goes (torch.profiler, which also warms the shapes up), then the
    generation of ``launch.generate`` (B 2, 2,880 image tokens + 64 text
    tokens, 32 steps), one SWA launch a layer of the prefill.  The weights
    alone are 68.8 GB, so the phase runs in a fresh process on a clean
    card."""
    import torch
    from repro_torch.models import build, get_config

    lap = laps("llava")
    full = get_config(LLAVA_ARCH)
    cfg = full.with_(dtype="float32", n_layers=LLAVA_CHECK_LAYERS)
    model = build(cfg).init(torch.Generator(device=DEV).manual_seed(SEED))
    rng = np.random.default_rng(SEED + 26)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (
        LLAVA_BATCH, LLAVA_PROMPT + 1), dtype=np.int32)).to(DEV)
    img = torch.from_numpy(rng.standard_normal(
        (LLAVA_BATCH, cfg.n_frontend_tokens, cfg.d_model),
        dtype=np.float32)).to(DEV)
    pos = cfg.n_frontend_tokens + LLAVA_PROMPT
    consistency = _consistency(
        model, {"tokens": toks, "image_embeds": img},
        {"tokens": toks[:, :-1], "image_embeds": img}, pos, toks[:, -1:],
        _launch_counters())
    check(all(c["swa"] == cfg.n_layers and c["scan"] == 0
              for c in consistency["launches_per_prefill"].values()),
          f"fp32 prefills launched {consistency['launches_per_prefill']}, "
          f"want {cfg.n_layers} SWA forwards each")
    consistency["decode_position"] = pos
    del model, img
    torch.cuda.empty_cache()
    lap("fp32_check")

    # where the device time of a prefill and of a decode step goes; this
    # also warms the bf16 shapes up for the measured generation below
    model = build(full).init(torch.Generator(device=DEV).manual_seed(SEED))
    batch = {"tokens": toks[:, :-1],
             "image_embeds": torch.from_numpy(rng.standard_normal(
                 (LLAVA_BATCH, full.n_frontend_tokens, full.d_model),
                 dtype=np.float32)).to(DEV, full.jdtype)}
    prefill_profile = _busy_share(
        lambda: model.prefill(batch, cache_len=pos + 32),
        steps=PREFILL_PROFILE_STEPS)
    _, cache = model.prefill(batch, cache_len=pos + 32)
    decode_profile = _decode_busy(model, cache, pos,
                                  steps=DECODE_PROFILE_STEPS)
    emit({"llava_profile": {"prefill": prefill_profile,
                            "decode_step": decode_profile, "card": card}})
    del model, cache, batch
    torch.cuda.empty_cache()
    lap("profile")

    argv = ["--arch", LLAVA_ARCH, "--batch", str(LLAVA_BATCH),
            "--prompt-len", str(LLAVA_PROMPT), "--steps", str(LLAVA_STEPS),
            "--seed", str(SEED), "--device", DEV]
    # ----------------- main path: bf16 generation --------------------- #
    _, run, launches = _generate(
        argv, full.n_layers, 0, full.padded_vocab,
        (LLAVA_BATCH, LLAVA_STEPS + 1), warm_up=False)
    lap("generation")
    out = {"phase": "llava", "layers": full.n_layers,
           "fp32_consistency": consistency,
           "generation": {k: v for k, v in run.items() if k != "ids"},
           "decode_weight_read_bound_ms":
               2.0 * full.n_params() / HBM_BYTES_PER_S * 1e3,
           "ids_row0": run["ids"][0], "launches": launches,
           "prefill_profile": prefill_profile,
           "decode_profile": decode_profile}
    emit(out)
    return out


def serve_bytes(arch: str, n_layers: int, B: int, seq: int) -> dict:
    """The bytes of ``models.steps.serve_specs`` on the meta device for
    ``arch`` cut to ``n_layers``: its params, and its cache at batch ``B``
    and ``seq`` positions."""
    from repro_torch.models import build, get_config
    from repro_torch.models.lm import cache_nbytes
    from repro_torch.models.steps import serve_specs
    params, cache, _, _ = serve_specs(
        build(get_config(arch).with_(n_layers=n_layers)), B, seq)
    return {"params": cache_nbytes(params), "cache": cache_nbytes(cache)}


def phase_zoo(card: str, deep: bool = False) -> dict:
    """The zoo's four large archs at published width (``ZOO_ARCHS``), one
    after another, each model freed before the next is built.

    Each arch, fp32, 2 layers: the last logits of prefill(S + 1) against
    prefill(S) + decode_step (grok-1-314b at capacity factor 16, no pair
    dropped), one SWA forward a layer a prefill.  bf16 at the run's depth
    (the default's, or ``zoo_deep``'s when ``deep``): the generation of
    ``launch.generate --layers`` (a warm-up run, then the measured one; B
    2, a 2,048-token prompt, 16 steps): prefill ms, decode ms a token,
    cache bytes, peak memory beside ``serve_specs``' bytes at that depth
    (which must fit ``ZOO_BUDGET_BYTES``, the cache equal to the
    generation's), one SWA launch a layer of the prefill, ids in the
    vocab, grok's dropped (token, slot) pairs."""
    import dataclasses
    import gc
    import torch
    from repro_torch.models import build, get_config

    name = "zoo_deep" if deep else "zoo"
    lap = laps(name)
    archs = {}
    for arch, depth, deep_depth in ZOO_ARCHS:
        n_layers = deep_depth if deep else depth
        full = get_config(arch)
        cfg = full.with_(dtype="float32", n_layers=ZOO_CHECK_LAYERS)
        B, S = ZOO_BATCH, ZOO_PROMPT
        if cfg.moe is not None:
            cfg = cfg.with_(moe=dataclasses.replace(
                cfg.moe, capacity_factor=MOE_CHECK_CF))
            B, S = ZOO_MOE_CHECK_BATCH, ZOO_MOE_CHECK_PROMPT
        model = build(cfg).init(torch.Generator(device=DEV).manual_seed(SEED))
        rng = np.random.default_rng(SEED + 37)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, S + 1),
                                             dtype=np.int32)).to(DEV)
        consistency = _consistency(model, {"tokens": toks},
                                   {"tokens": toks[:, :-1]}, S, toks[:, -1:],
                                   _launch_counters())
        check(all(c["swa"] == cfg.n_layers and c["scan"] == 0
                  for c in consistency["launches_per_prefill"].values()),
              f"{arch} fp32 prefills launched "
              f"{consistency['launches_per_prefill']}, want "
              f"{cfg.n_layers} SWA forwards each")
        consistency.update(batch=B, prompt=S)
        if cfg.moe is not None:
            consistency.update(capacity_factor=MOE_CHECK_CF,
                               dropped=model.take_dropped())
            check(consistency["dropped"] == 0,
                  f"{arch} fp32 at capacity factor {MOE_CHECK_CF} dropped "
                  f"{consistency['dropped']} (token, slot) pairs")
        del model, toks
        gc.collect()
        torch.cuda.empty_cache()
        lap(f"{arch} fp32_check")

        specs = serve_bytes(arch, n_layers, ZOO_BATCH, ZOO_PROMPT + ZOO_STEPS)
        check(specs["params"] + specs["cache"] <= ZOO_BUDGET_BYTES,
              f"{arch} at {n_layers} layers: serve_specs {specs} past the "
              f"budget of {ZOO_BUDGET_BYTES:.0f} bytes")
        argv = ["--arch", arch, "--layers", str(n_layers), "--batch",
                str(ZOO_BATCH), "--prompt-len", str(ZOO_PROMPT), "--steps",
                str(ZOO_STEPS), "--seed", str(SEED), "--device", DEV]
        warm, run, launches = _generate(
            argv, n_layers, 0, full.padded_vocab,
            (ZOO_BATCH, ZOO_STEPS + 1))
        check(run["cache_bytes"] == specs["cache"],
              f"{arch}: the generation's cache {run['cache_bytes']} B, "
              f"serve_specs' {specs['cache']}")
        rec = {"arch": arch, "layers": n_layers,
               "published_layers": full.n_layers,
               "fp32_consistency": consistency,
               "generation": {k: v for k, v in run.items() if k != "ids"},
               "warmup_generation": {k: warm[k] for k in (
                   "prefill_ms", "decode_ms_per_token")},
               "peak_memory_bytes": run["peak_memory_bytes"],
               "serve_specs_bytes": specs,
               "serve_specs_total_bytes": specs["params"] + specs["cache"],
               "ids_row0": run["ids"][0], "launches": launches,
               "card": card}
        emit({name: rec})
        archs[arch] = rec
        del warm, run
        gc.collect()
        torch.cuda.empty_cache()
        lap(arch)
    return {"phase": name, "card": card, "archs": archs,
            "budget_bytes": ZOO_BUDGET_BYTES}


def _decode_busy(model, cache, pos: int, steps: int) -> dict:
    """``_busy_share`` of greedy decode steps from ``pos`` on ``cache``."""
    import torch
    from repro_torch.models.steps import make_serve_step
    serve = make_serve_step(model)
    from repro_torch.models.lm import cache_leaves
    batch = cache_leaves(cache)[0].shape[1]          # (L, B, ...) tensors
    state = {"tok": torch.zeros((batch, 1), dtype=torch.int32, device=DEV),
             "pos": pos, "cache": cache}

    def step():
        state["tok"], state["cache"] = serve(state["cache"], state["tok"],
                                             state["pos"])
        state["pos"] += 1
    return _busy_share(step, steps=steps)


def zoo_numbers(card: str) -> dict:
    """Where the device time of a falcon-mamba-7b bf16 prefill (B 2, 2048
    tokens) and of a decode step goes, and of whisper-base's (1,500
    frames, a 64-token decoder prompt), with their device-busy shares."""
    import torch
    from repro_torch.models import build, get_config

    out = {}
    for arch, pos in ((MAMBA_ARCH, MAMBA_PROMPT),
                      (WHISPER_ARCH, WHISPER_PROMPT)):
        cfg = get_config(arch)
        model = build(cfg).init(torch.Generator(device=DEV).manual_seed(SEED))
        rng = np.random.default_rng(SEED + 27)
        b = {"tokens": torch.from_numpy(rng.integers(
            0, cfg.vocab, (2, pos), dtype=np.int32)).to(DEV)}
        if cfg.family == "audio":
            b["frames"] = _frames(cfg, WHISPER_FRAMES, SEED + 28, cfg.jdtype)
        prefill = _busy_share(lambda: model.prefill(b, cache_len=pos + 16),
                              steps=PREFILL_PROFILE_STEPS)
        _, cache = model.prefill(b, cache_len=pos + 16)
        decode = _decode_busy(model, cache, pos, steps=DECODE_PROFILE_STEPS)
        out[arch] = {"prefill": prefill, "decode_step": decode}
        emit({"zoo_profile": {"arch": arch, **out[arch], "card": card}})
        del model, cache
        torch.cuda.empty_cache()
    return out


def _train_batch(cfg, seed: int, B: int = TRAIN_BATCH,
                 S: int = TRAIN_SEQ) -> dict:
    import torch
    rng = np.random.default_rng(seed)
    return {name: torch.from_numpy(rng.integers(
        0, cfg.vocab, (B, S)).astype(np.int32)).to(DEV)
        for name in ("tokens", "labels")}


def _plain_swa_fn():
    """A stand-in for ``SWAAttentionFn`` built from the plain forward, its
    log-sum-exp and the plain backward (``kernels/ref.py``): the fp32
    check's substitute, made here and never a switch of the package."""
    import torch
    from repro_torch.kernels import ref

    class PlainSWA(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v, window, q_offset):
            o = ref.swa_attention_ref(q[None], k[None], v[None], window,
                                      q_offset)[0]
            lse = ref.swa_attention_lse_ref(q[None], k[None], window,
                                            q_offset)[0]
            ctx.save_for_backward(q, k, v, o, lse)
            ctx.band = (window, q_offset)
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            dq, dk, dv = ref.swa_attention_backward_ref(
                q[None], k[None], v[None], o[None], lse[None], do[None],
                *ctx.band)
            return dq[0], dk[0], dv[0], None, None

    return PlainSWA


def _plain_scan_fn():
    """A stand-in for ``SelectiveScanFusedFn`` built from the plain fused
    forward and the plain backward (``kernels/ref.py``): the falcon-mamba
    fp32 check's substitute, made here and never a switch of the
    package."""
    import torch
    from repro_torch.kernels import ref

    class PlainScan(torch.autograd.Function):
        @staticmethod
        def forward(ctx, h0, dt, Bm, Cm, A, xc, D, z, dt_bias, chunk):
            ctx.save_for_backward(h0, dt, Bm, Cm, A, xc, D, z, dt_bias)
            ctx.set_materialize_grads(False)
            return ref.selective_scan_fused(h0, dt, Bm, Cm, A, xc, D, z,
                                            dt_bias, chunk)

        @staticmethod
        def backward(ctx, dh_last, dout):
            saved = ctx.saved_tensors
            if dout is None:
                dout = torch.zeros(saved[1].shape, dtype=saved[5].dtype,
                                   device=saved[1].device)
            grads = ref.selective_scan_fused_backward(*saved, dout, dh_last)
            return (*(g if need else None
                      for g, need in zip(grads, ctx.needs_input_grad)),
                    None)

    return PlainScan


def _loss_and_grads(model, batch):
    import torch
    for p in model.params.parameters():
        p.grad = None
    loss, _ = model.loss(batch)
    loss.backward()
    torch.cuda.synchronize()
    grads = {n: p.grad.detach().clone()
             for n, p in model.params.named_parameters()}
    return float(loss.detach()), grads


def _swa_step_launches(n_layers: int, steps: int) -> dict:
    """SWA launches of ``steps`` training steps under remat "full": the
    forward twice a layer (the step and its recompute), each backward
    entry point once."""
    return {"swa_attention_forward": 2 * n_layers * steps,
            "swa_attention_bwd_dot": n_layers * steps,
            "swa_attention_backward_dkdv": n_layers * steps,
            "swa_attention_backward_dq": n_layers * steps}


def _scan_step_launches(n_layers: int, steps: int) -> dict:
    """Selective-scan launches of ``steps`` training steps under remat
    "full": the fused forward twice a layer (the step, whose saved states
    the checkpoint drops, and its recompute), its backward once, the bare
    scan never."""
    return {"selective_scan_forward": 0,
            "selective_scan_fused": 2 * n_layers * steps,
            "selective_scan_fused_backward": n_layers * steps}


def _train_launches() -> dict:
    from repro_torch.kernels import selective_scan as ss, swa_attention as sw
    return {**sw.launches, **ss.launches}


def _reset_train_launches() -> None:
    from repro_torch.kernels import selective_scan as ss, swa_attention as sw
    sw.reset_launches()
    ss.reset_launches()


def _step_launches(arch: str, n_layers: int, steps: int) -> dict:
    """Every SWA and scan entry point's launches of ``steps`` steps of
    ``arch``: its own kernel's, and none of the other's.  The hybrid's
    attention layers launch the SWA kernels (forward twice under remat,
    once in its plain remainder); its RG-LRU layers launch none."""
    if arch == MAMBA_ARCH:
        return {**_swa_step_launches(0, steps),
                **_scan_step_launches(n_layers, steps)}
    remat, plain = _attention_layers(arch, n_layers)
    swa = _swa_step_launches(remat + plain, steps)
    swa["swa_attention_forward"] -= plain * steps
    return {**swa, **_scan_step_launches(0, steps)}


def _routes(n_layers: int):
    """A context that records the expert ids ``blocks.moe_route`` chooses
    and the pairs it drops in each of the first ``n_layers`` calls (a
    step's forward; its recompute follows), into the list it yields."""
    import contextlib
    from repro_torch.models import blocks

    @contextlib.contextmanager
    def recording():
        seen, route = [], blocks.moe_route

        def recorded(*args, **kw):
            out = route(*args, **kw)
            if len(seen) < n_layers:
                seen.append((out[2].detach().clone(), (~out[3]).sum()))
            return out
        blocks.moe_route = recorded
        try:
            yield seen
        finally:
            blocks.moe_route = route
    return recording()


def _routes_differ(a: list, b: list, n_experts: int) -> int:
    """(token, expert) choices made in routes ``a`` and not in ``b``."""
    import torch.nn.functional as F
    return sum(int((F.one_hot(x, n_experts).sum(-2).bool()
                    & ~F.one_hot(y, n_experts).sum(-2).bool()).sum())
               for (x, _), (y, _) in zip(a, b))


def _train_fp32_check(arch: str, B: int, S: int, seed: int, module,
                      attr: str, plain_fn,
                      n_layers: int = TRAIN_CHECK_LAYERS,
                      capacity_factor: float = None) -> dict:
    """fp32, ``n_layers`` layers at full width: loss and every gradient
    leaf of the kernels' step against the same step with ``module.attr``
    (the kernels' autograd Function) swapped for ``plain_fn`` (the plain
    forward and backward) for one step.  An MoE arch runs at
    ``capacity_factor``, and the (token, expert) choices its router makes
    differently in the two steps are counted."""
    import dataclasses
    import torch
    from repro_torch.models import build, get_config
    t0 = time.perf_counter()
    cfg32 = get_config(arch).with_(dtype="float32", n_layers=n_layers)
    if cfg32.moe is not None:
        cfg32 = cfg32.with_(moe=dataclasses.replace(
            cfg32.moe, capacity_factor=capacity_factor))
    model = build(cfg32).init(torch.Generator(device=DEV).manual_seed(SEED))
    model.params.requires_grad_(True)
    batch = _train_batch(cfg32, seed, B, S)
    _reset_train_launches()
    with _routes(n_layers) as routes_k:
        loss_k, grads_k = _loss_and_grads(model, batch)
    launches = _train_launches()
    check(launches == _step_launches(arch, n_layers, 1),
          f"{arch} fp32 step launched {launches}")
    kernel_fn = getattr(module, attr)
    setattr(module, attr, plain_fn)
    try:
        with _routes(n_layers) as routes_p:
            loss_p, grads_p = _loss_and_grads(model, batch)
    finally:
        setattr(module, attr, kernel_fn)
    check(_train_launches() == launches,
          f"{arch}: the plain step launched a kernel")
    out = {"arch": arch, "layers": n_layers, "batch": B, "seq": S}
    if cfg32.moe is not None:
        out.update(capacity_factor=capacity_factor,
                   dropped=sum(int(n) for _, n in routes_k + routes_p),
                   routes_differ=_routes_differ(routes_k, routes_p,
                                                cfg32.moe.n_experts))
        check(out["dropped"] == 0, f"{arch} fp32 at capacity factor "
                                   f"{capacity_factor} dropped pairs: {out}")
    check(abs(loss_k - loss_p) <= TRAIN_LOSS_RTOL * abs(loss_p),
          f"{arch} fp32 loss {loss_k} against plain {loss_p} ({out})")
    worst, worst_leaf = 0.0, None
    for name, g in grads_p.items():
        scale = float(g.abs().max())
        err = float((grads_k[name] - g).abs().max())
        check(bool(torch.isfinite(grads_k[name]).all())
              and err <= TRAIN_GRAD_TOL * max(scale, 1e-30),
              f"{arch} fp32 grad {name}: off by {err} (max |g| {scale}; "
              f"{out})")
        if err / max(scale, 1e-30) > worst:
            worst, worst_leaf = err / max(scale, 1e-30), name
    out.update({"loss_kernel": loss_k, "loss_plain": loss_p,
                "leaves": len(grads_p), "worst_grad_err_over_max": worst,
                "worst_leaf": worst_leaf, "launches": launches,
                "seconds": time.perf_counter() - t0,
                "tolerance": {"loss_rtol": TRAIN_LOSS_RTOL,
                              "grad": f"{TRAIN_GRAD_TOL} * max|g_plain| "
                                      f"a leaf"}})
    del model, batch, grads_k, grads_p
    torch.cuda.empty_cache()
    return out


def _train_main_path(arch: str, B: int, S: int, warm_steps: int,
                     steps: int, seed: int, card: str,
                     falls: int = 5) -> dict:
    """bf16 at full width through ``launch.train``'s main: a warm-up run,
    then the measured one (step ms, tokens/s, peak memory, its launches:
    ``_step_launches``, every loss finite); then steps on one repeated
    batch under torch.profiler (the device-busy share, device ms by
    kernel group), whose first ``falls`` losses must each fall."""
    import torch
    from repro_torch.launch import train
    from repro_torch.models import build, get_config
    from repro_torch.models import steps as steps_mod

    argv = ["--arch", arch, "--batch", str(B), "--seq", str(S), "--seed",
            str(SEED), "--device", DEV]
    warm = train.main(argv + ["--steps", str(warm_steps)])
    torch.cuda.empty_cache()
    _reset_train_launches()
    run = train.main(argv + ["--steps", str(steps)])
    torch.cuda.synchronize()
    launches = _train_launches()
    n_layers = get_config(arch).n_layers
    want = _step_launches(arch, n_layers, steps)
    check(launches == want
          and {**run["swa_launches"], **run["scan_launches"]} == want,
          f"{arch} training launched {launches}, want {want}")
    check(all(np.isfinite(warm["losses"] + run["losses"])),
          f"{arch}: a loss is not finite: {warm['losses']} {run['losses']}")
    torch.cuda.empty_cache()

    # ------- one repeated batch: the loss falls; the profiler's view ----- #
    cfg = get_config(arch)
    model = build(cfg).init(torch.Generator(device=DEV).manual_seed(SEED))
    adam, steps_mod.adam = steps_mod.adam, _annotated_adam
    try:
        step, optimizer = steps_mod.make_train_step(model)
    finally:
        steps_mod.adam = adam
    state = optimizer.init(dict(model.params.named_parameters()))
    batch = _train_batch(cfg, seed, B, S)
    losses = []

    def one_step():
        nonlocal state
        state, metrics = step(state, batch)
        losses.append(metrics["loss"])

    busy = _busy_share(one_step, steps=TRAIN_REPEAT_STEPS)
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"{arch} repeated batch: {losses}")
    check(all(b < a for a, b in zip(losses[:falls], losses[1:falls])),
          f"{arch} repeated batch: the loss does not fall: {losses}")
    del model, state, batch, step, optimizer
    torch.cuda.empty_cache()
    return {"arch": arch, "card": card,
            "run": {k: v for k, v in run.items() if k != "accs"},
            "warmup": {k: warm[k] for k in ("step_ms", "losses")},
            "launches": launches,
            "launches_per_step": _step_launches(arch, n_layers, 1),
            "repeated_batch_losses": losses, "profile": busy}


def _annotated_adam(lr: float):
    """``optim.adam(lr)`` whose update runs inside a profiler range named
    "adam": Adam's passes apart in a profiled step (``_busy_share``)."""
    import dataclasses
    from torch.profiler import record_function
    from repro_torch.optim import adam
    opt = adam(lr)

    def update(*args):
        with record_function("adam"):
            return opt.update(*args)
    return dataclasses.replace(opt, update=update)


def phase_train(card: str) -> dict:
    """LM training at published widths: h2o-danube-1.8b (the SWA kernels),
    falcon-mamba-7b (the fused scan and its backward) and recurrentgemma-2b
    (the SWA kernels at d = 256 beside the RG-LRU scan, which autograd
    differentiates).

    Each arch, fp32: 2 layers at full width, the kernels' step against the
    same step with the plain forward and backward substituted (the SWA
    Function for h2o at B = 1, S = 6144; the scan Function for
    falcon-mamba at B = 1, S = 2048): loss and every gradient leaf.  bf16,
    the main path, all layers, remat "full": ``launch.train``'s main, a
    warm-up run then the measured one (h2o: B 1, S 6144, 48 SWA forwards
    and 24 of each backward entry point a step; falcon-mamba: B 2, S
    2048, 128 fused scans and 64 backwards a step): step ms, tokens/s,
    peak memory, every loss finite; then steps on one repeated batch under
    torch.profiler: the device-busy share, device ms by kernel group, and
    losses that fall.  recurrentgemma-2b the same way: fp32 at 3 layers
    (B 1, S 4,096; the SWA Function swapped), then bf16, all 26 layers, B
    2, S 4,096: 16 SWA forwards (its 8 attention layers, each in a
    rematerialised period) and 8 of each backward entry point a step; its
    repeated batch's first ``HYBRID_REPEAT_FALLS`` losses fall.
    olmoe-1b-7b the same way: fp32 at 2 layers (B 1, S 2,048, capacity
    factor 16; the SWA Function swapped; the (token, expert) choices the
    two steps route apart counted), then bf16, all 16 layers, B 2, S
    2,048: 32 SWA forwards at d 128, group 1, and 16 of each backward
    entry point a step."""
    from repro_torch.kernels import selective_scan as ss, swa_attention as sw

    lap = laps("train")
    fp32 = _train_fp32_check(LM_ARCH, TRAIN_BATCH, TRAIN_SEQ, SEED + 14, sw,
                             "SWAAttentionFn", _plain_swa_fn())
    emit({"train_fp32_check": fp32})
    lap("h2o fp32_check")
    h2o = _train_main_path(LM_ARCH, TRAIN_BATCH, TRAIN_SEQ,
                           TRAIN_WARM_STEPS, TRAIN_STEPS, SEED + 15, card)
    emit({"train_h2o": {k: v for k, v in h2o.items() if k != "run"}})
    lap("h2o")
    mamba32 = _train_fp32_check(MAMBA_ARCH, MAMBA_CHECK_BATCH,
                                MAMBA_TRAIN_SEQ, SEED + 16, ss,
                                "SelectiveScanFusedFn", _plain_scan_fn())
    emit({"train_mamba_fp32_check": mamba32})
    lap("mamba fp32_check")
    mamba = _train_main_path(MAMBA_ARCH, MAMBA_TRAIN_BATCH, MAMBA_TRAIN_SEQ,
                             TRAIN_WARM_STEPS, MAMBA_TRAIN_STEPS, SEED + 17,
                             card)
    emit({"train_mamba": {k: v for k, v in mamba.items() if k != "run"}})
    lap("mamba")
    hybrid32 = _train_fp32_check(HYBRID_ARCH, HYBRID_CHECK_BATCH,
                                 HYBRID_TRAIN_SEQ, SEED + 32, sw,
                                 "SWAAttentionFn", _plain_swa_fn(),
                                 n_layers=HYBRID_CHECK_LAYERS)
    emit({"train_hybrid_fp32_check": hybrid32})
    lap("hybrid fp32_check")
    hybrid = _train_main_path(HYBRID_ARCH, HYBRID_TRAIN_BATCH,
                              HYBRID_TRAIN_SEQ, TRAIN_WARM_STEPS,
                              HYBRID_TRAIN_STEPS, SEED + 33, card,
                              falls=HYBRID_REPEAT_FALLS)
    lap("hybrid")
    moe32 = _train_fp32_check(MOE_ARCH, MOE_CHECK_BATCH, MOE_TRAIN_SEQ,
                              SEED + 35, sw, "SWAAttentionFn",
                              _plain_swa_fn(), capacity_factor=MOE_CHECK_CF)
    emit({"train_moe_fp32_check": moe32})
    lap("moe fp32_check")
    moe = _train_main_path(MOE_ARCH, MOE_TRAIN_BATCH, MOE_TRAIN_SEQ,
                           TRAIN_WARM_STEPS, MOE_TRAIN_STEPS, SEED + 36,
                           card)
    emit({"train_moe": {k: v for k, v in moe.items() if k != "run"}})
    lap("moe")
    out = {"phase": "train", "card": card, "fp32_check": fp32,
           **{k: h2o[k] for k in ("run", "warmup", "launches",
                                  "launches_per_step",
                                  "repeated_batch_losses", "profile")},
           "mamba": {**mamba, "fp32_check": mamba32},
           "hybrid": {**hybrid, "fp32_check": hybrid32},
           "moe": {**moe, "fp32_check": moe32}}
    emit(out)
    return out


def _cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def _host_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _graph_ms(fn, calls: int = 50, replays: int = 5) -> float:
    """ms per call of ``fn`` over ``calls`` back-to-back calls captured in
    one CUDA graph, by CUDA events around its replays: the calls' device
    time with no host launch path between them."""
    import torch
    main = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(main)
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    main.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    b.synchronize()
    del graph
    return a.elapsed_time(b) / (replays * calls)


def _device_ms(fn, iters: int = 10) -> dict:
    """Device time per call by kernel (or copy) name, from the device
    activities (CUPTI) of a CPU + CUDA torch.profiler session over
    ``iters`` calls, as ``_busy_share`` reads them: each name's mean
    duration times its runs a call (its activities over ``iters``,
    rounded).  The mean, not the sum over ``iters``: on some cards a
    session drops an activity of a name (the SWA backward's kernels read
    2/3 of their time over 3 calls, the forward 9/10 over 10).  A session
    that records no device activity at all is run again, up to
    DEVICE_MS_SESSIONS sessions (a fresh process's session has once come
    back empty for one SWA forward).  Empty when every session reports
    none (in a process that ran the other phases first: see
    ``_phase_in_child``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    runs: dict = {}
    for _ in range(DEVICE_MS_SESSIONS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for evt in prof.events():
            if evt.device_type == DeviceType.CUDA and evt.device_time_total:
                m = re.search(r"(\w+_kernel)\b", evt.name)
                name = m.group(1) if m else evt.name[:48]
                runs.setdefault(name, []).append(evt.device_time_total)
        if runs:
            break
    return _per_call_ms(runs, iters)


#: profiler sessions ``_device_ms`` runs at most while each records no
#: device activity
DEVICE_MS_SESSIONS = 3


def _per_call_ms(runs: dict, iters: int) -> dict:
    """``{name: ms a call}`` from ``{name: [us of each activity]}`` over
    ``iters`` calls: the mean activity times the activities a call."""
    return {name: sum(us) / len(us) * max(1, round(len(us) / iters)) / 1e3
            for name, us in runs.items()}


def _phase_in_child(name: str, tmp: str, card: str) -> dict:
    """Phase ``name`` in a fresh process (``--phases name``), its lines
    passed through and its results read back.  In a process that has run
    the other phases, torch.profiler's short sessions stop reporting the
    device activity of the kge and SWA kernels, while a fresh process
    reads them (ROADMAP Queue 3, item 8): the numbers phase runs so.  The
    llava phase runs so for a clean card: its weights take 68.8 GB."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.empty_cache()            # the child needs the card's memory
    path = Path(tmp) / f"{name}.json"
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--phases",
         name, "--out", str(path)], stdout=subprocess.PIPE, text=True,
        cwd=str(ROOT))
    try:
        for line in proc.stdout:
            if line.strip() != card and not line.startswith(
                    ('{"ok"', "[chip_smoke]")):
                print(line, end="", flush=True)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    check(rc == 0, f"{name}: the child process exited with {rc}")
    return json.loads(path.read_text())["phases"][name]


def _check_device_times(numbers: dict) -> None:
    """A blind profiler fails the run: every kge, SWA and selective-scan
    row of the numbers phase must carry a device ms."""
    rows = [(f"kge_score {part} {r['model']}", r[f"{part}_device_ms"])
            for r in numbers["kge"]["kge_rows"]
            for part in ("forward", "backward")]
    fwd = numbers["swa"]["swa"]
    rows += [("swa forward bf16", fwd["device_ms"]),
             ("swa forward fp32", fwd["fp32_device_ms"]),
             ("swa forward bf16 B=1", fwd["train_batch"]["device_ms"]),
             ("swa forward causal bf16", fwd["causal"]["device_ms"]),
             ("swa forward causal bf16 llava",
              fwd["causal_llava"]["device_ms"]),
             ("swa forward causal bf16 mistral",
              fwd["causal_mistral"]["device_ms"]),
             ("swa backward causal bf16 olmoe",
              numbers["swa_backward"]["causal_olmoe"]["device_ms"])]
    rows += [(f"swa backward {r['dtype']} B={r['B']}", r["device_ms"])
             for r in numbers["swa_backward"]["rows"]]
    rows += [("swa forward bf16 d 256", numbers["hybrid"]["forward"][
        "device_ms"]), ("swa backward bf16 d 256",
                        numbers["hybrid"]["backward"]["device_ms"])]
    rows += [("selective scan", numbers["scan"]["device_ms"]),
             ("selective scan fused", numbers["scan"]["fused"]["device_ms"]),
             ("selective scan backward",
              numbers["scan"]["backward"]["device_ms"])]
    blind = [name for name, ms in rows if not ms]
    check(not blind, f"numbers: no device time for {blind}")


def bound_ms(Q: int, rows: int, k: int, k_run: int) -> tuple:
    """Least time for one top-k over ``rows`` table rows: each input read
    once (rows, norms, queries, exclusions, running list), each output
    written once; operations are the 2*Q*rows*D of the scores."""
    nbytes = (rows * D * 4 + rows * 4 + Q * D * 4 + Q * 4
              + Q * k_run * 8 + Q * k * 8)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * Q * rows * D / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


#: the top-k rows the numbers phase times: the 40k table at Q = 1 and 32,
#: k = 10 and 2000 (the kernels line reads Q 32 / k 10 and Q 1 / k 2000).
#: The 100k table and Q = 64 were timed too before the recurrentgemma
#: phase and training run joined the script: a depth cut that keeps it
#: near 820 s
NUMBERS_TOPK_ROWS, NUMBERS_TOPK_Q = GO_ROWS, (1, 32)


def phase_numbers(store_tables, card: str) -> dict:
    import torch
    from repro_torch.kernels import ops, ref, topk_similarity as ts

    dev = torch.device(DEV)
    rng = np.random.default_rng(SEED + 2)
    rows_out = []
    slab = ops.STREAM_BLOCK_ROWS
    for n_rows in (NUMBERS_TOPK_ROWS,):
        table, norms = store_tables[n_rows]
        table_dev = torch.from_numpy(np.array(table)).to(dev)
        norms_dev = torch.from_numpy(np.array(norms)).to(dev)
        unit_dev = table_dev / norms_dev[:, None].clamp(min=1e-12)
        pinned = torch.empty((n_rows, D), dtype=torch.float32,
                             pin_memory=True)
        pinned.copy_(torch.from_numpy(np.array(table)))
        landing = torch.empty((n_rows, D), dtype=torch.float32, device=dev)
        h2d_ms = _cuda_ms(lambda: landing.copy_(pinned, non_blocking=True))
        gather_ms = _host_ms(lambda: np.copyto(pinned.numpy(), table))
        del landing
        pool = ops.StagingPool()
        for Q in NUMBERS_TOPK_Q:
            rows = rng.choice(n_rows, size=Q, replace=False)
            q = unit_rows(table, norms, rows)
            excl = rows.astype(np.int32)
            q_dev = torch.from_numpy(q).to(dev)
            x_dev = torch.from_numpy(excl).to(dev)
            for k in (10, 2000):
                run_s, run_i = ts.topk_cosine_step(
                    q_dev, table_dev[:slab], norms_dev[:slab], x_dev, 0,
                    n_rows, k)
                blk, nb = table_dev[slab:2 * slab], norms_dev[slab:2 * slab]
                step = lambda: ts.topk_cosine_step(
                    q_dev, blk, nb, x_dev, slab, n_rows, k, run_s, run_i)
                plain_step = lambda: ref.stream_step_ref(
                    q_dev, blk, nb, slab, n_rows, x_dev, run_s, run_i, k)
                ublk = unit_dev[slab:2 * slab]
                lib_step = lambda: torch.topk(torch.matmul(q_dev, ublk.T), k)
                call = lambda: ops.topk_cosine(q_dev, table_dev, k,
                                               exclude_rows=excl,
                                               norms=norms_dev)
                plain_call = lambda: ref.stream_step_ref(
                    q_dev, table_dev, norms_dev, 0, n_rows, x_dev, None,
                    None, k)
                lib_call = lambda: torch.topk(torch.matmul(q_dev, unit_dev.T),
                                              k)
                stream = lambda: ops.topk_cosine(q, table, k,
                                                 exclude_rows=excl,
                                                 norms=norms, device=dev,
                                                 staging=pool)
                ours = {n: t for n, t in _device_ms(step).items()
                        if n.replace("_kernel", "") in _KERNEL_NAMES}
                ours_call = {n: t for n, t in _device_ms(call).items()
                             if n.replace("_kernel", "") in _KERNEL_NAMES}
                busy = _device_ms(stream, iters=3)
                b_step, by_step = bound_ms(Q, slab, k, k)
                b_call, by_call = bound_ms(Q, n_rows, k, 0)
                rec = {
                    "N": n_rows, "Q": Q, "k": k,
                    "step_ms": _cuda_ms(step),
                    "step_plain_ms": _cuda_ms(plain_step),
                    "step_library_ms": _cuda_ms(lib_step),
                    "step_bound_ms": b_step, "step_bound_by": by_step,
                    "call_ms": _cuda_ms(call, iters=10),
                    "call_plain_ms": _cuda_ms(plain_call, iters=10),
                    "call_library_ms": _cuda_ms(lib_call, iters=10),
                    "call_bound_ms": b_call, "call_bound_by": by_call,
                    "step_device_ms": sum(ours.values()) if ours else None,
                    "step_device_by_kernel": ours,
                    "call_device_by_kernel": ours_call,
                    "stream_call_ms": _host_ms(stream),
                    "stream_device_busy_ms": sum(busy.values()) if busy
                    else None,
                    "stream_slabs": -(-n_rows // slab),
                    "h2d_ms": h2d_ms, "host_gather_ms": gather_ms,
                    "card": card}
                emit({"numbers": rec})
                rows_out.append(rec)
        del table_dev, norms_dev, unit_dev, pinned
        torch.cuda.synchronize()
    return {"phase": "numbers", "rows": rows_out}


def kge_bound_ms(B: int, K: int, d: int, backward: bool) -> tuple:
    """Least time for one kge_score pass at (B, K, d): every input read
    once and every output written once; a few fp32 operations per
    element of ``neg``."""
    rows = (B * d * 3 + B * K * d) * 4  # h, r, t, neg; backward: + grads
    small = B * K + (B + B * K) * 4     # mask; pos + negs or their cotangents
    if backward:
        nbytes = 2 * rows + small
        ops = 8.0 * B * K * d
    else:
        nbytes = rows + small
        ops = 3.0 * B * K * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


_STEP_PARTS = ("ks.forward_backward", "ks.adam", "ks.constrain")


def _eager_step(trainer, params, opt_state, loader, gen):
    """One eager training step, its parts in profiler ranges."""
    import torch
    from torch.profiler import record_function
    from repro_torch.kge.negatives import corrupt

    ts_, model, opt = trainer.train_step, trainer.model, trainer.optimizer

    def one():
        batch = torch.from_numpy(next(loader)).to(DEV, torch.int64)
        rand, ch = corrupt(gen, batch, model.spec.n_entities,
                           trainer.cfg.num_negs)
        with record_function(_STEP_PARTS[0]):
            _, grads = ts_.loss_and_grads(params, batch, rand, ch)
        with record_function(_STEP_PARTS[1]):
            opt.update(grads, opt_state, params)
        with record_function(_STEP_PARTS[2]):
            model.constrain(params)
    return one


def _step_breakdown(one, steps: int):
    """Device time of ``steps`` training steps (calls of ``one``) by part,
    from torch.profiler: the kge_score kernels, the row gathers and their
    scatter-adds (index kernels), Adam (kernels under the ``ks.adam``
    range), TransE's norm clamp (``ks.constrain``), and the rest; and the
    busy share of the window's wall time.  A replayed graph opens no
    ranges: its Adam and clamp count in the rest.  None where the profiler
    shows no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        one()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            one()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    parts = {"kge_score": 0.0, "gather_scatter": 0.0, "adam": 0.0,
             "constrain": 0.0}
    busy = 0.0
    by_kernel: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.name in _STEP_PARTS:           # a range, not device work
                continue
            us = e.device_time_total
            busy += us
            by_kernel[e.name[:60]] = by_kernel.get(e.name[:60], 0.0) + us
            low = e.name.lower()
            if "kge_" in low:
                parts["kge_score"] += us
            elif "index" in low or "gather" in low or "scatter" in low:
                parts["gather_scatter"] += us
        elif e.name == _STEP_PARTS[1]:
            parts["adam"] += e.device_time_total
        elif e.name == _STEP_PARTS[2]:
            parts["constrain"] += e.device_time_total
    if busy == 0:
        return {"profiler": "no device time reported"}
    per = {k: v / 1e3 / steps for k, v in parts.items()}
    per["other"] = busy / 1e3 / steps - sum(per.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12]
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy / 1e3 / steps,
            "device_busy_share": busy / 1e3 / wall_ms,
            "device_ms_per_step_by_part": per,
            "top_kernels_ms_per_step": {k: v / 1e3 / steps for k, v in top}}


def _host_us(fn, calls: int, batch: int = 200) -> float:
    """Host microseconds per call of ``fn`` over ``calls`` calls, timed in
    batches of ``batch`` with a synchronise between batches (not timed),
    so launches never wait for a full queue: the host's own cost."""
    import torch
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(calls // batch):
        t0 = time.perf_counter()
        for _ in range(batch):
            fn()
        total += time.perf_counter() - t0
        torch.cuda.synchronize()
    return total * 1e6 / (calls // batch * batch)


def kge_host_breakdown(card: str, calls: int = 2000) -> dict:
    """Host time of one ``kge_score_forward`` call (DistMult at
    KGE_SHAPE) by part, each part timed alone over ``calls`` calls as
    the wrapper runs it, beside the whole call and the host time of the
    ``bmm`` yardstick."""
    import torch
    from repro_torch.kernels import _build, kge_score as tk

    B, K, d = KGE_SHAPE
    gen = torch.Generator(device=DEV).manual_seed(SEED + 6)
    h, r, t, neg, ch = _kge_inputs(B, K, d, "random", False, gen)
    dev = h.device
    fn = tk._LIB._bind()["kge_score_forward"]
    pos, negs = tk.forward_outputs(B, K, dev)
    mid = tk._model_id("distmult")
    args = (h.data_ptr(), r.data_ptr(), t.data_ptr(), neg.data_ptr(),
            ch.data_ptr(), B, K, d, mid, pos.data_ptr(), negs.data_ptr(),
            _build.stream_handle(dev))
    packer = tk._LIB.packers["kge_score_forward"]
    packed = packer.pack(*args)
    counts, lock = {"kge_score_forward": 0}, threading.Lock()

    def count():
        with lock:
            counts["kge_score_forward"] += 1

    def device_context():
        with _build.on_device(dev):
            pass

    parts = {
        "model_id": lambda: tk._model_id("distmult"),
        "checks": lambda: tk._check(h, r, t, neg, ch),
        "device_context": device_context,
        "allocation": lambda: tk.forward_outputs(B, K, dev),
        "stream_handle": lambda: _build.stream_handle(dev),
        "pointers": lambda: (h.data_ptr(), r.data_ptr(), t.data_ptr(),
                             neg.data_ptr(), ch.data_ptr(), pos.data_ptr(),
                             negs.data_ptr()),
        "pack_arguments": lambda: packer.pack(*args),
        "ctypes_call": lambda: fn(packed),
        "launch_counter": count,
    }
    us = {name: _host_us(f, calls) for name, f in parts.items()}
    qs = torch.stack([r * t, h * r], dim=2)
    rec = {"model": "distmult", "B": B, "K": K, "d": d, "calls": calls,
           "host_us_by_part": us, "host_us_parts_sum": sum(us.values()),
           "host_us_whole_call": _host_us(
               lambda: tk.kge_score_forward(h, r, t, neg, ch, "distmult"),
               calls),
           "host_us_bmm": _host_us(lambda: torch.bmm(neg, qs), calls),
           "card": card}
    emit({"kge_host_breakdown": rec})
    return rec


def phase_alloc(card: str, calls: int = 2000) -> dict:
    """Host us a call of the backward wrapper's output allocations at
    KGE_SHAPE, in turns (four, one, one, four): grad h, r, t and grad neg
    as four tensors, as ``kge_score.kge_score_backward`` allocates them,
    against one (3, B, d) buffer seen three ways plus grad neg."""
    import torch

    B, K, d = KGE_SHAPE
    h = torch.empty((B, d), dtype=torch.float32, device=DEV)
    neg = torch.empty((B, K, d), dtype=torch.float32, device=DEV)

    def four():
        return (torch.empty_like(h), torch.empty_like(h),
                torch.empty_like(h), torch.empty_like(neg))

    def one():
        return (*torch.empty((3, B, d), dtype=torch.float32,
                             device=DEV).unbind(0), torch.empty_like(neg))

    runs = {"four": [], "one": []}
    for name, fn in (("four", four), ("one", one), ("one", one),
                     ("four", four)):
        runs[name].append(_host_us(fn, calls))
    out = {"phase": "alloc", "B": B, "K": K, "d": d, "calls": calls,
           "host_us_four_tensors": runs["four"],
           "host_us_one_3bd_buffer": runs["one"], "card": card}
    emit(out)
    return out


def kge_numbers(card: str) -> dict:
    """kge_score forward/backward at (1024, 32, 200) for each model (CUDA
    events over back-to-back calls, profiler device time, and 50 calls
    replayed from one captured graph), and one GO-size eager training step
    of each model: its launches, its time and where the device time
    goes."""
    import torch
    from repro_torch.configs.go_kge import CONFIG
    from repro_torch.data import TripleLoader
    from repro_torch.kernels import kge_score as tk, ref
    from repro_torch.kge import KGETrainer, make_model

    B, K, d = KGE_SHAPE
    gen = torch.Generator(device=DEV).manual_seed(SEED + 5)
    rows = []
    for model in KGE_MODELS:
        h, r, t, neg, ch = _kge_inputs(B, K, d, "random", False, gen)
        g_pos = torch.randn((B,), generator=gen, device=DEV)
        g_negs = torch.randn((B, K), generator=gen, device=DEV)
        fwd = lambda: tk.kge_score_forward(h, r, t, neg, ch, model)
        bwd = lambda: tk.kge_score_backward(h, r, t, neg, ch, g_pos, g_negs,
                                            model)
        plain_fwd = lambda: ref.kge_score_ref(h, r, t, neg, ch, model)
        plain_bwd = lambda: ref.kge_score_backward_ref(h, r, t, neg, ch,
                                                       g_pos, g_negs, model)
        lib_fwd = None
        if model == "distmult":
            # both candidate scores of every negative in one batched product
            qs = torch.stack([r * t, h * r], dim=2)          # (B, d, 2)
            lib_fwd = lambda: torch.bmm(neg, qs)
        rec = {"model": model, "B": B, "K": K, "d": d, "card": card}
        for name, fn, plain, lib, bw in (("forward", fwd, plain_fwd, lib_fwd,
                                          False),
                                         ("backward", bwd, plain_bwd, None,
                                          True)):
            dev_ms = _device_ms(fn)
            ours = {n: v for n, v in dev_ms.items() if "kge_" in n}
            b_ms, b_by = kge_bound_ms(B, K, d, bw)
            rec.update({f"{name}_ms": _cuda_ms(fn, iters=50),
                        f"{name}_device_ms": sum(ours.values()) if ours
                        else None,
                        f"{name}_graph_ms": _graph_ms(fn),
                        f"{name}_plain_ms": _cuda_ms(plain, iters=20),
                        f"{name}_library_ms": _cuda_ms(lib, iters=50)
                        if lib else None,
                        f"{name}_bound_ms": b_ms, f"{name}_bound_by": b_by})
        emit({"numbers": rec})
        rows.append(rec)
        del h, r, t, neg, ch, g_pos, g_negs
    torch.cuda.synchronize()

    (_, kg1), _ = go_releases()
    steps = []
    for name in UPDATE_MODELS:
        model = make_model(name, kg1.num_entities, kg1.num_relations,
                           dim=CONFIG.dim)
        trainer = KGETrainer(model, CONFIG.train, device=DEV)
        params, opt_state = trainer.init()
        loader = iter(TripleLoader(kg1.triples, CONFIG.train.batch_size))
        sgen = trainer.generator(1)
        step = lambda: trainer.train_step.step(
            params, opt_state,
            torch.from_numpy(next(loader)).to(DEV, torch.int64), sgen)
        step()
        torch.cuda.synchronize()
        tk.reset_launches()
        step()
        torch.cuda.synchronize()
        per_step = dict(tk.launches)
        rec = {"model": name, "launches_per_step": per_step,
               "step_host_ms": _host_ms(step, iters=KGE_STEP_TIMED,
                                        warmup=5),
               "step_event_ms": _cuda_ms(step, iters=KGE_STEP_TIMED,
                                         warmup=5),
               **_step_breakdown(_eager_step(trainer, params, opt_state,
                                             loader, sgen),
                                 steps=KGE_STEP_PROFILED),
               "card": card}
        emit({"train_step": rec})
        steps.append(rec)
        del params, opt_state
    torch.cuda.synchronize()
    return {"kge_rows": rows, "train_steps": steps,
            "host_breakdown": kge_host_breakdown(card)}


def swa_pairs(sq: int, skv: int, window: int, q_offset: int) -> int:
    """(query, key) pairs the band holds: what the work depends on."""
    i = q_offset + np.arange(sq)
    return int(np.maximum(0, np.minimum(i, skv - 1)
                          - np.maximum(0, i - window + 1) + 1).sum())


def swa_bound_ms(B: int, hq: int, hkv: int, S: int, hd: int, W: int,
                 dtype_bytes: int, flop_per_s: float = BF16_FLOP_PER_S
                 ) -> tuple:
    """Least time for one SWA call: q, k, v read once and o written once;
    4 * hd operations per visible (query, key) pair (two products), at the
    type's peak rate (bf16 tensor cores; fp32 on the CUDA cores)."""
    nbytes = (2 * B * hq + 2 * B * hkv) * S * hd * dtype_bytes
    ops = 4.0 * hd * swa_pairs(S, S, W, 0) * B * hq
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / flop_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def swa_numbers(card: str) -> dict:
    """The SWA kernel at one h2o-danube layer's shape (B = 2, 32 q heads,
    8 kv heads, S = 6144, W = 4096, d = 80, bf16): kernel, device, plain
    and library times beside the bound; then where the device time of a
    bf16 prefill (6144 tokens) and of a decode step after it goes, and
    their device-busy shares, at full width."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref, swa_attention as sw
    from repro_torch.models import build, get_config
    from repro_torch.models.steps import make_serve_step

    cfg = get_config(LM_ARCH)
    B, hq, hkv, S, hd, W = (LM_BATCH, cfg.n_heads, cfg.n_kv_heads,
                            LM_PROMPT, cfg.hd, cfg.window)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 13)
    q, k, v = _swa_inputs(B, hq, hkv, S, S, hd, torch.bfloat16, gen)
    kern = lambda: sw.swa_attention_forward(q, k, v, W)
    plain = lambda: ref.swa_attention_ref(q[None], k[None], v[None], W)
    q4 = q.reshape(B, hq, S, hd)
    k4, v4 = k.reshape(B, hkv, S, hd), v.reshape(B, hkv, S, hd)
    pos = torch.arange(S, device=DEV)
    band = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < W)
    lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=band,
                                                 enable_gqa=True)
    # the yardstick computes the same function (outputs here are |o| < 1)
    lib_err = float((lib().reshape(B * hq, S, hd).float()
                     - kern().float()).abs().max())
    check(lib_err <= 2 * SWA_BF16_TOL,
          f"the library yardstick differs from the kernel by {lib_err}")
    dev_ms = _device_ms(kern)
    ours = {n: t for n, t in dev_ms.items() if "swa_" in n}
    b_ms, b_by = swa_bound_ms(B, hq, hkv, S, hd, W, 2)
    rec = {"B": B, "Hq": hq, "Hkv": hkv, "S": S, "d": hd, "W": W,
           "dtype": "bfloat16", "pairs_per_head": swa_pairs(S, S, W, 0),
           "ms": _cuda_ms(kern, iters=20),
           "device_ms": sum(ours.values()) if ours else None,
           "plain_ms": _cuda_ms(plain, iters=3, warmup=1),
           "library_ms": _cuda_ms(lib, iters=10, warmup=2),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_vs_kernel_max_abs": lib_err, "card": card}
    # the training shape (B = 1): the first batch row's heads
    q1, k1, v1 = q[:hq], k[:hkv], v[:hkv]
    kern1 = lambda: sw.swa_attention_forward(q1, k1, v1, W)
    lib1 = lambda: F.scaled_dot_product_attention(
        q4[:1], k4[:1], v4[:1], attn_mask=band, enable_gqa=True)
    ours1 = {n: t for n, t in _device_ms(kern1).items() if "swa_" in n}
    b1_ms, b1_by = swa_bound_ms(1, hq, hkv, S, hd, W, 2)
    rec["train_batch"] = {
        "B": 1, "ms": _cuda_ms(kern1, iters=20),
        "device_ms": sum(ours1.values()) if ours1 else None,
        "library_ms": _cuda_ms(lib1, iters=10, warmup=2),
        "bound_ms": b1_ms, "bound_by": b1_by}
    del q4, k4, v4, q1, k1, v1
    # the same layer in fp32: kernel (FMA), plain, and SDPA with the band
    # mask in fp32 (no TF32), which computes the same function
    qf, kf, vf = (x.float() for x in (q, k, v))
    del q, k, v
    torch.cuda.empty_cache()
    kern32 = lambda: sw.swa_attention_forward(qf, kf, vf, W)
    plain32 = lambda: ref.swa_attention_ref(qf[None], kf[None], vf[None], W)
    q4, k4 = qf.reshape(B, hq, S, hd), kf.reshape(B, hkv, S, hd)
    v4 = vf.reshape(B, hkv, S, hd)
    lib32 = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=band,
                                                   enable_gqa=True)
    lib32_err = float((lib32().reshape(B * hq, S, hd) - kern32()).abs().max())
    check(lib32_err <= SWA_TOL,
          f"fp32: the library yardstick differs from the kernel by "
          f"{lib32_err}")
    ours32 = {n: t for n, t in _device_ms(kern32, iters=3).items()
              if "swa_" in n}
    b32, b32_by = swa_bound_ms(B, hq, hkv, S, hd, W, 4, FP32_FLOP_PER_S)
    rec.update({"fp32_ms": _cuda_ms(kern32, iters=5, warmup=1),
                "fp32_device_ms": sum(ours32.values()) if ours32 else None,
                "fp32_plain_ms": _cuda_ms(plain32, iters=2, warmup=1),
                "fp32_library_ms": _cuda_ms(lib32, iters=5, warmup=1),
                "fp32_bound_ms": b32, "fp32_bound_by": b32_by,
                "fp32_library_vs_kernel_max_abs": lib32_err})
    del q4, k4, v4, qf, kf, vf, band
    torch.cuda.empty_cache()
    rec["causal"] = swa_causal_numbers(gen)
    rec["causal_llava"] = swa_causal_numbers(
        gen, LLAVA_ARCH, LLAVA_BATCH,
        get_config(LLAVA_ARCH).n_frontend_tokens + LLAVA_PROMPT)
    rec["causal_mistral"] = swa_causal_numbers(gen, MISTRAL_ARCH, ZOO_BATCH,
                                               ZOO_PROMPT)
    emit({"numbers": rec})

    # where the device time of a bf16 prefill and of a decode step goes
    model = build(cfg).init(torch.Generator(device=DEV).manual_seed(SEED))
    prompt = {"tokens": _lm_prompt(cfg, S)}
    prefill = _busy_share(lambda: model.prefill(prompt, cache_len=S + 64),
                          steps=PREFILL_PROFILE_STEPS)
    emit({"prefill": {**prefill, "card": card}})
    _, cache = model.prefill(prompt, cache_len=S + 64)
    serve = make_serve_step(model)
    tok = torch.zeros((B, 1), dtype=torch.int32, device=DEV)
    state = {"pos": S}

    def step():
        nonlocal tok, cache
        tok, cache = serve(cache, tok, state["pos"])
        state["pos"] += 1

    busy = _busy_share(step, steps=DECODE_PROFILE_STEPS)
    emit({"decode_step": {**busy, "card": card}})
    del model, cache
    torch.cuda.empty_cache()
    return {"swa": rec, "prefill": prefill, "decode_step": busy}


def swa_causal_numbers(gen, arch: str = MOE_ARCH, B: int = MOE_BATCH,
                       S: int = MOE_PROMPT) -> dict:
    """The SWA kernel as full causal attention (W = S) at one prefill
    layer's shape of ``arch`` (olmoe-1b-7b: B = 2, 16 q and kv heads, S =
    2048, d = 128; llava-next-34b: B = 2, 56 q over 8 kv heads, S = 2,944,
    d = 128; mistral-large-123b: B 2, 96 q over 8 kv heads, S 2048, d
    128), bf16: kernel, device, plain and library times beside the
    bound; the library is ``scaled_dot_product_attention(is_causal=True)``,
    which computes the same function."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref, swa_attention as sw
    from repro_torch.models import get_config

    cfg = get_config(arch)
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    q, k, v = _swa_inputs(B, hq, hkv, S, S, hd, torch.bfloat16, gen)
    kern = lambda: sw.swa_attention_forward(q, k, v, S)
    plain = lambda: ref.swa_attention_ref(q[None], k[None], v[None], S)
    q4 = q.reshape(B, hq, S, hd)
    k4, v4 = k.reshape(B, hkv, S, hd), v.reshape(B, hkv, S, hd)
    lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                                 enable_gqa=hq != hkv)
    lib_err = float((lib().reshape(B * hq, S, hd).float()
                     - kern().float()).abs().max())
    check(lib_err <= 2 * SWA_BF16_TOL,
          f"causal: the library yardstick differs from the kernel by "
          f"{lib_err}")
    ours = {n: t for n, t in _device_ms(kern).items() if "swa_" in n}
    b_ms, b_by = swa_bound_ms(B, hq, hkv, S, hd, S, 2)
    return {"B": B, "Hq": hq, "Hkv": hkv, "S": S, "d": hd, "W": S,
            "dtype": "bfloat16", "pairs_per_head": swa_pairs(S, S, S, 0),
            "ms": _cuda_ms(kern, iters=20),
            "device_ms": sum(ours.values()) if ours else None,
            "plain_ms": _cuda_ms(plain, iters=3, warmup=1),
            "library_ms": _cuda_ms(lib, iters=20),
            "library_is": "SDPA is_causal=True",
            "bound_ms": b_ms, "bound_by": b_by,
            "library_vs_kernel_max_abs": lib_err}


def swa_bwd_bound_ms(B: int, hq: int, hkv: int, S: int, hd: int, W: int,
                     dtype_bytes: int, flop_per_s: float = BF16_FLOP_PER_S,
                     products: int = 5) -> tuple:
    """Least time for one SWA backward: q, k, v, o, dO and lse read once,
    dq, dk and dv written once; 2 * hd operations per visible (query,
    key) pair and product, at the type's peak rate.  The function has
    five products (S, dP, dV, dK, dQ); the two-kernel design recomputes
    S and dP (``products=7``), and the bf16 kernels also take dV, dK and
    dQ twice, as bf16 hi + lo parts of P and dS (``products=10``)."""
    nbytes = ((4 * B * hq + 4 * B * hkv) * S * hd * dtype_bytes
              + 4 * B * hq * S)
    ops = 2.0 * products * hd * swa_pairs(S, S, W, 0) * B * hq
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / flop_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def moe_numbers(card: str) -> dict:
    """Where the device time of an olmoe-1b-7b bf16 prefill (B = 2, 2048
    tokens) and of a decode step after it goes, and their device-busy
    shares, at full width and depth."""
    import torch
    from repro_torch.models import build, get_config
    from repro_torch.models.steps import make_serve_step

    cfg = get_config(MOE_ARCH)
    model = build(cfg).init(torch.Generator(device=DEV).manual_seed(SEED))
    rng = np.random.default_rng(SEED + 14)
    prompt = {"tokens": torch.from_numpy(rng.integers(
        0, cfg.vocab, (MOE_BATCH, MOE_PROMPT), dtype=np.int32)).to(DEV)}
    prefill = _busy_share(lambda: model.prefill(prompt,
                                                cache_len=MOE_PROMPT + 64),
                          steps=PREFILL_PROFILE_STEPS)
    emit({"moe_prefill": {**prefill, "card": card}})
    _, cache = model.prefill(prompt, cache_len=MOE_PROMPT + 64)
    serve = make_serve_step(model)
    tok = torch.zeros((MOE_BATCH, 1), dtype=torch.int32, device=DEV)
    state = {"pos": MOE_PROMPT}

    def step():
        nonlocal tok, cache
        tok, cache = serve(cache, tok, state["pos"])
        state["pos"] += 1

    busy = _busy_share(step, steps=DECODE_PROFILE_STEPS)
    emit({"moe_decode_step": {**busy, "card": card}})
    del model, cache
    torch.cuda.empty_cache()
    return {"prefill": prefill, "decode_step": busy}


def swa_backward_numbers(card: str) -> dict:
    """The SWA backward (bwd_dot + backward_dkdv + backward_dq) at one
    h2o-danube layer's shape (32 q / 8 kv heads, S = 6144, W = 4096, d =
    80), B = 1 (the training run's) and 2, bf16 and fp32; and at one
    olmoe-1b-7b layer's training shape, causal (B 2, 16 / 16 heads, S =
    W = 2048, d 128), bf16.  Each: kernel ms (CUDA events over the three
    launches), device ms by kernel (profiler), the plain backward's ms,
    the function's bound (five products), the two-kernel design's (seven)
    and the bound of what the kernels issue, and SDPA forward + backward
    (the band mask and ``enable_gqa``; ``is_causal`` at W = S) beside our
    forward (with lse) + backward; and the forward with its log-sum-exp
    against without."""
    import torch
    from repro_torch.models import get_config

    cfg = get_config(LM_ARCH)
    gen = torch.Generator(device=DEV).manual_seed(SEED + 16)
    rows = []
    for B in (1, 2):
        for dtype, nbytes, peak in ((torch.bfloat16, 2, BF16_FLOP_PER_S),
                                    (torch.float32, 4, FP32_FLOP_PER_S)):
            rows.append(_swa_backward_row(
                B, cfg.n_heads, cfg.n_kv_heads, TRAIN_SEQ, cfg.hd,
                cfg.window, dtype, nbytes, peak, gen, card))
    moe = get_config(MOE_ARCH)
    causal = _swa_backward_row(
        MOE_TRAIN_BATCH, moe.n_heads, moe.n_kv_heads, MOE_TRAIN_SEQ, moe.hd,
        MOE_TRAIN_SEQ, torch.bfloat16, 2, BF16_FLOP_PER_S, gen, card)
    return {"rows": rows, "causal_olmoe": causal}


def _swa_backward_row(B: int, hq: int, hkv: int, S: int, hd: int, W: int,
                      dtype, nbytes: int, peak: float, gen,
                      card: str) -> dict:
    """One row of ``swa_backward_numbers`` at (B, hq, hkv, S, hd, W) in
    ``dtype``; SDPA takes the band as a boolean mask, or ``is_causal``
    when W >= S."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref, swa_attention as sw

    if W >= S:
        band = dict(is_causal=True)
    else:
        pos = torch.arange(S, device=DEV)
        band = dict(attn_mask=(pos[None, :] <= pos[:, None])
                    & (pos[:, None] - pos[None, :] < W))
    q, k, v = _swa_inputs(B, hq, hkv, S, S, hd, dtype, gen)
    do = torch.randn(q.shape, generator=gen, device=DEV).to(dtype)
    o, lse = sw.swa_attention_forward(q, k, v, W, return_lse=True)
    kern = lambda: sw.swa_attention_backward(q, k, v, o, lse, do, W)
    plain = lambda: ref.swa_attention_backward_ref(
        q[None], k[None], v[None], o[None], lse[None], do[None], W)
    ours = {n: t for n, t in _device_ms(kern, iters=3).items()
            if "swa_" in n}
    q4, k4, v4 = (x.reshape(B, -1, S, hd).detach().requires_grad_(True)
                  for x in (q, k, v))
    do4 = do.reshape(B, hq, S, hd)

    def lib():
        for x in (q4, k4, v4):
            x.grad = None
        F.scaled_dot_product_attention(
            q4, k4, v4, enable_gqa=hq != hkv, **band).backward(do4)

    def fwd_bwd():
        o2, lse2 = sw.swa_attention_forward(q, k, v, W, return_lse=True)
        return sw.swa_attention_backward(q, k, v, o2, lse2, do, W)

    # the yardstick computes the same gradients (recorded, loosely held:
    # SDPA's own kernels round bf16 differently)
    lib()
    got = kern()
    lib_err = max(float(((a.grad.reshape(b.shape).float()
                          - b.float()).abs()
                         / (1 + b.float().abs())).max())
                  for a, b in zip((q4, k4, v4), got))
    check(lib_err <= (5e-2 if dtype == torch.bfloat16 else 1e-3),
          f"SDPA's gradients differ from the kernels' by {lib_err}")
    del got
    b_ms, b_by = swa_bwd_bound_ms(B, hq, hkv, S, hd, W, nbytes, peak)
    design_ms, _ = swa_bwd_bound_ms(B, hq, hkv, S, hd, W, nbytes, peak,
                                    products=7)
    # the bf16 kernels take dV, dK and dQ as hi + lo products
    issued_ms, _ = swa_bwd_bound_ms(
        B, hq, hkv, S, hd, W, nbytes, peak,
        products=10 if dtype == torch.bfloat16 else 7)
    fwd_b_ms, fwd_b_by = swa_bound_ms(B, hq, hkv, S, hd, W, nbytes, peak)
    rec = {"B": B, "Hq": hq, "Hkv": hkv, "S": S, "d": hd, "W": W,
           "dtype": str(dtype).replace("torch.", ""),
           "ms": _cuda_ms(kern, iters=5, warmup=1),
           "device_ms_by_kernel": ours or None,
           "device_ms": sum(ours.values()) if ours else None,
           "plain_ms": _cuda_ms(plain, iters=2, warmup=1),
           "bound_ms": b_ms, "bound_by": b_by,
           "design_bound_ms": design_ms,
           "issued_bound_ms": issued_ms,
           "fwd_lse_bwd_ms": _cuda_ms(fwd_bwd, iters=3, warmup=1),
           "library_fwd_bwd_ms": _cuda_ms(lib, iters=3, warmup=1),
           "library_is": "SDPA forward + backward, "
                         + ("is_causal" if W >= S else "band mask")
                         + (", enable_gqa" if hq != hkv else ""),
           "library_vs_kernel_max_rel": lib_err,
           "fwd_ms": _cuda_ms(
               lambda: sw.swa_attention_forward(q, k, v, W),
               iters=10, warmup=2),
           "fwd_lse_ms": _cuda_ms(
               lambda: sw.swa_attention_forward(q, k, v, W,
                                                return_lse=True),
               iters=10, warmup=2),
           "fwd_bound_ms": fwd_b_ms, "fwd_bound_by": fwd_b_by,
           "card": card}
    emit({"swa_backward": rec})
    del q, k, v, do, o, lse, q4, k4, v4, do4
    torch.cuda.empty_cache()
    return rec


def hybrid_numbers(card: str) -> dict:
    """The SWA kernels at head dim 256, at one recurrentgemma-2b attention
    layer's shape (B 2, 10 q heads over 1 kv head, S 4,096, W 2,048,
    bf16; the prefill's and the training run's shape alike): the forward,
    and the forward with its log-sum-exp plus the backward, each with
    kernel (CUDA events), device (profiler), plain and SDPA (band mask,
    ``enable_gqa``) times beside its bound (4 d operations a visible pair
    forward, 10 d backward, at bf16's peak; the bf16 d = 256 backward
    issues 14 d: S and dP in both warpgroups of each kernel, dV, dK and dQ
    as hi + lo products); then where the device time of a bf16 prefill
    goes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref, swa_attention as sw
    from repro_torch.models import build, get_config

    cfg = get_config(HYBRID_ARCH)
    B, S, hd, W = HYBRID_BATCH, HYBRID_PROMPT, cfg.hd, cfg.hybrid.window
    hq, hkv = cfg.padded_heads(), cfg.groups
    gen = torch.Generator(device=DEV).manual_seed(SEED + 34)
    q, k, v = _swa_inputs(B, hq, hkv, S, S, hd, torch.bfloat16, gen)
    do = torch.randn(q.shape, generator=gen, device=DEV).to(torch.bfloat16)
    pos = torch.arange(S, device=DEV)
    band = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < W)
    q4, k4, v4 = (x.reshape(B, -1, S, hd).detach().requires_grad_(True)
                  for x in (q, k, v))
    do4 = do.reshape(B, hq, S, hd)
    kern = lambda: sw.swa_attention_forward(q, k, v, W)
    lib = lambda: F.scaled_dot_product_attention(q4, k4, v4, attn_mask=band,
                                                 enable_gqa=True)
    with torch.no_grad():
        lib_err = float((lib().reshape(B * hq, S, hd).float()
                         - kern().float()).abs().max())
    check(lib_err <= 2 * SWA_BF16_TOL,
          f"d 256: the library yardstick differs from the kernel by "
          f"{lib_err}")
    ours = {n: t for n, t in _device_ms(kern).items() if "swa_" in n}
    b_ms, b_by = swa_bound_ms(B, hq, hkv, S, hd, W, 2)
    with torch.no_grad():
        fwd = {"B": B, "Hq": hq, "Hkv": hkv, "S": S, "d": hd, "W": W,
               "dtype": "bfloat16", "pairs": B * hq * swa_pairs(S, S, W, 0),
               "ms": _cuda_ms(kern, iters=20),
               "device_ms": sum(ours.values()) if ours else None,
               "plain_ms": _cuda_ms(lambda: ref.swa_attention_ref(
                   q[None], k[None], v[None], W), iters=3, warmup=1),
               "library_ms": _cuda_ms(lib, iters=10, warmup=2),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_vs_kernel_max_abs": lib_err, "card": card}
    emit({"hybrid_swa_forward": fwd})

    o, lse = sw.swa_attention_forward(q, k, v, W, return_lse=True)
    back = lambda: sw.swa_attention_backward(q, k, v, o, lse, do, W)

    def fwd_bwd():
        o2, lse2 = sw.swa_attention_forward(q, k, v, W, return_lse=True)
        return sw.swa_attention_backward(q, k, v, o2, lse2, do, W)

    def lib_fb():
        for x in (q4, k4, v4):
            x.grad = None
        F.scaled_dot_product_attention(
            q4, k4, v4, attn_mask=band, enable_gqa=True).backward(do4)

    lib_fb()
    got = back()
    lib_err = max(float(((a.grad.reshape(b.shape).float() - b.float()).abs()
                         / (1 + b.float().abs())).max())
                  for a, b in zip((q4, k4, v4), got))
    check(lib_err <= 5e-2,
          f"d 256: SDPA's gradients differ from the kernels' by {lib_err}")
    del got
    ours = {n: t for n, t in _device_ms(back, iters=3).items()
            if "swa_" in n}
    bb_ms, bb_by = swa_bwd_bound_ms(B, hq, hkv, S, hd, W, 2)
    issued, _ = swa_bwd_bound_ms(B, hq, hkv, S, hd, W, 2, products=14)
    bwd = {"B": B, "Hq": hq, "Hkv": hkv, "S": S, "d": hd, "W": W,
           "dtype": "bfloat16", "ms": _cuda_ms(back, iters=5, warmup=1),
           "device_ms_by_kernel": ours or None,
           "device_ms": sum(ours.values()) if ours else None,
           "plain_ms": _cuda_ms(lambda: ref.swa_attention_backward_ref(
               q[None], k[None], v[None], o[None], lse[None], do[None], W),
               iters=2, warmup=1),
           "bound_ms": bb_ms, "bound_by": bb_by, "issued_bound_ms": issued,
           "fwd_lse_bwd_ms": _cuda_ms(fwd_bwd, iters=3, warmup=1),
           "fwd_lse_bwd_bound_ms": b_ms + bb_ms,
           "library_fwd_bwd_ms": _cuda_ms(lib_fb, iters=3, warmup=1),
           "library_vs_kernel_max_rel": lib_err, "card": card}
    emit({"hybrid_swa_backward": bwd})
    del q, k, v, do, o, lse, q4, k4, v4, do4, band
    torch.cuda.empty_cache()

    # where the device time of a bf16 prefill goes (its decode step's wall
    # time is the hybrid phase's)
    model = build(cfg).init(torch.Generator(device=DEV).manual_seed(SEED))
    prompt = {"tokens": _lm_prompt(cfg, S)}
    prefill = _busy_share(lambda: model.prefill(prompt),
                          steps=PREFILL_PROFILE_STEPS)
    emit({"hybrid_prefill": {**prefill, "card": card}})
    del model
    torch.cuda.empty_cache()
    return {"forward": fwd, "backward": bwd, "prefill": prefill}


def _busy_share(fn, steps: int) -> dict:
    """Wall time and device busy time per call of ``fn`` over ``steps``
    calls, from torch.profiler (kernels and copies on the device)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    by_group: dict = {}
    by_op: dict = {}
    ops = 0
    for e in prof.events():
        if getattr(e, "is_user_annotation", False) \
                and e.device_type == DeviceType.CUDA:
            continue            # a range's span on the device, no kernel
        if e.device_type == DeviceType.CUDA:
            by_name[e.name[:60]] = by_name.get(e.name[:60], 0.0) \
                + e.device_time_total
            g = _kernel_group(e.name)
            by_group[g] = by_group.get(g, 0.0) + e.device_time_total
            ops += 1
        elif e.name in _OP_RANGES or e.kernels:
            # the host op that launched each kernel; a range of
            # _OP_RANGES counts every kernel inside it (its ops count
            # under their own names too)
            t = (e.device_time_total if e.name in _OP_RANGES
                 else sum(k.duration for k in e.kernels))
            by_op[e.name] = by_op.get(e.name, 0.0) + t
    op_groups: dict = {}
    for name, t in by_op.items():
        g = _op_group(name)
        if g:
            op_groups[g] = op_groups.get(g, 0.0) + t
    top_ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:15]
    busy = sum(by_name.values())
    if busy == 0:
        return {"profiler": "no device time reported"}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_busy_ms_per_step": busy / 1e3 / steps,
            "device_busy_share": busy / 1e3 / wall_ms,
            "device_ops_per_step": ops / steps,
            "swa_kernel_ms_per_step": sum(
                v for k, v in by_name.items() if "swa_" in k) / 1e3 / steps,
            "top_kernels_ms_per_step": {k: v / 1e3 / steps for k, v in top},
            "device_ms_per_step_by_group": {
                k: v / 1e3 / steps for k, v in sorted(
                    by_group.items(), key=lambda kv: -kv[1])},
            "device_ms_per_step_by_op": {k: v / 1e3 / steps
                                         for k, v in top_ops},
            "device_ms_per_step_by_op_group": {
                k: v / 1e3 / steps for k, v in sorted(
                    op_groups.items(), key=lambda kv: -kv[1])},
            "unprofiled_ms_per_step": _host_ms(fn, iters=steps, warmup=1)}


#: profiler ranges whose device time ``_busy_share`` reads whole
_OP_RANGES = ("adam",)


def _op_group(name: str):
    """A host op's group in a step's breakdown by the op that launched
    each kernel: Adam's passes (the "adam" range), batched products (an
    MoE layer's expert einsums), other products, the MoE's scatter and
    gather (``index_add`` and its backward, the combine gather and its
    backward); None for the rest."""
    if name in _OP_RANGES:
        return name
    if name in ("aten::bmm", "aten::baddbmm"):
        return "bmm"
    if name in ("aten::mm", "aten::addmm"):
        return "mm"
    if name.startswith(("aten::index_add", "aten::index_select",
                        "aten::gather", "aten::scatter_add")):
        return "index_add / gather"
    return None


def _kernel_group(name: str) -> str:
    """A device kernel's group for the breakdowns: each SWA kernel by
    itself, then GEMMs, copies, and PyTorch's elementwise and reduction
    kernels."""
    n = name.lower()
    for key, group in (("swa_bf16_kernel", "swa forward"),
                       ("swa_f32_kernel", "swa forward"),
                       ("swa_bwd_dot", "swa bwd_dot"),
                       ("swa_bwd_dkdv", "swa backward_dkdv"),
                       ("swa_bwd_dq", "swa backward_dq"),
                       ("selective_scan_kernel", "selective scan"),
                       ("selective_scan_bwd_kernel",
                        "selective scan backward")):
        if key in n:
            return group
    if any(t in n for t in ("gemm", "xmma", "cutlass", "cublas", "nvjet",
                            "_mma", "splitk")):
        return "GEMM"
    if "memcpy" in n or "memset" in n:
        return "copies"
    if any(t in n for t in ("elementwise", "vectorized", "unrolled",
                            "reduce", "softmax", "index", "scatter",
                            "gather", "cat", "norm", "sort", "fill")):
        return "elementwise and reductions"
    return "other"


def kernels_line(kern: dict, serve_out: dict, kge: dict,
                 update_out: dict, jobs: dict, numbers: dict, swa: dict,
                 lm: dict, moe: dict, train: dict, scan: dict, mamba: dict,
                 whisper: dict, llava: dict, hybrid: dict,
                 shard: dict = None, mesh: dict = None,
                 zoo: dict = None) -> dict:
    """One entry per kernel path, at the shapes the main path gives it:
    a 8192-row slab of the 40k table with its running list, Q = 32 and
    k = 10 for the small path (the serve session's batches), Q = 1 and
    k = 2000 for the large one (the k = 2000 HTTP requests).  The top-k
    entries' ``launches_jobs`` are the launches of the jobs phase's 40k
    k = 10 join (small) and its 1,024-class k = 100 join (large), and
    their ``launches_sharded`` those of the shard phase's sharded engine
    (one a shard a call).  The SWA
    forward's ``launches`` are the generation run's prefill and its
    ``launches_train`` the measured training run's; the causal forward's
    (W = S) the olmoe-1b-7b generation run's prefill; the backward's are
    the training run's (its three entry points); the causal forward's
    ``launches_whisper`` and ``launches_llava`` those phases' measured
    prefills; at mistral-large-123b's layer, the zoo phase's measured
    mistral prefill (one a layer of its depth), ``launches_zoo`` every
    zoo arch's, and ``launches_mesh_tp`` each rank's in the mesh phase's
    measured tensor-parallel mistral prefill (on its 48 q heads).  The causal backward at olmoe-1b-7b's training shape: the
    measured olmoe training run's (16 of each entry point a step).  The
    selective scan's are the falcon-mamba-7b generation run's prefill: 64
    fused launches and none of the bare entry point, whose entry also
    carries the scan phase's launches; the fused one's
    ``launches_train`` and its backward's ``launches`` are the measured
    falcon-mamba-7b training run's (128 and 64 a step).  The SWA kernels
    at d = 256: the recurrentgemma-2b generation run's prefill (8) and
    its measured training run's (16 forwards, 8 of each backward entry
    point a step).  ``launches_mesh``: the mesh phase's, over its ranks
    (kge_score: the sharded trainer's steps; the causal SWA forward: the
    expert-parallel bf16 prefill; the SWA backward: the expert-parallel
    fp32 training step at d = 128, group 1).  The "a rank's" entries:
    the fused scan, its backward and the d = 256 SWA forward and backward
    at a rank's shapes on a model axis of 2 (the mesh phase's last
    part), their launches the mesh phase's
    channel-parallel runs over both ranks (the bf16 falcon-mamba-7b and
    recurrentgemma-2b prefills, the fp32 training steps); the SWA forward
    at whisper-base's decoder layer on a rank's heads and at h2o-danube's
    with the int8 cache on a rank's, their launches the mesh phase's bf16
    whisper-base and int8 h2o-danube prefills over both ranks; at
    whisper-base's decoder layer in one process, the whisper phase's
    measured prefill."""
    launches = serve_out["launches"]
    ml = mesh["launches"] if mesh else {}
    by = {(r["N"], r["Q"], r["k"]): r for r in numbers["rows"]}
    out = []
    for name, entries, key, err, path in (
            ("topk_cosine_step (k <= 64: score/select + merge lists)",
             SMALL_ENTRY,
             (GO_ROWS, 32, 10), kern["max_abs_err_small"], "small"),
            ("topk_cosine_step (k > 64: score + select/sort + merge path)",
             LARGE_ENTRY, (GO_ROWS, 1, 2000), kern["max_abs_err_large"],
             "large")):
        r = by[key]
        out.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": REPLACES,
            "launches": sum(launches[e] for e in entries),
            "launches_by_entry": {e: launches[e] for e in entries},
            "launches_jobs": jobs["launches_jobs"][path],
            "launches_sharded": shard and sum(shard["launches"][e]
                                              for e in entries),
            "max_abs_err": err, "ms": r["step_ms"],
            "device_ms": r["step_device_ms"],
            "plain_ms": r["step_plain_ms"], "bound_ms": r["step_bound_ms"],
            "bound_by": r["step_bound_by"],
            "library_ms": r["step_library_ms"]})
    # kge_score at the training step's shape: TransE-L1 (the GO update's
    # first model) both ways, and DistMult's forward, which one bmm
    # computes.  The entry point's launches are counted over the whole
    # update phase, one count for both models: each row says so
    k_launch = update_out["kge_launches_on_path"]
    rows = {x["model"]: x for x in numbers["kge"]["kge_rows"]}
    for name, entry, key, model, label in (
            ("kge_score forward", "kge_score_forward", "forward",
             "transe_l1", "TransE-L1"),
            ("kge_score backward", "kge_score_backward", "backward",
             "transe_l1", "TransE-L1"),
            ("kge_score forward", "kge_score_forward", "forward",
             "distmult", "DistMult")):
        r = rows[model]
        out.append({
            "name": f"{name} ({label}, B=1024 K=32 d=200)",
            "route": "cuda", "source": KGE_SOURCE, "replaces": KGE_REPLACES,
            "launches": k_launch[entry],
            "launches_over": "update phase, TransE-L1 and DistMult "
                             "together (v1, warm v2, cold v2): eager "
                             "warm-up steps plus graph replays x launches "
                             "a replay",
            "launches_mesh": ml.get(entry),
            "max_abs_err": kge[f"max_abs_err_{key}"],
            "ms": r[f"{key}_ms"], "device_ms": r[f"{key}_device_ms"],
            "graph_ms": r[f"{key}_graph_ms"],
            "plain_ms": r[f"{key}_plain_ms"],
            "bound_ms": r[f"{key}_bound_ms"],
            "bound_by": r[f"{key}_bound_by"],
            "library_ms": r[f"{key}_library_ms"]})
    # swa at one h2o-danube layer's shape in bf16; launches counted over
    # the measured generation run (one prefill of 24 layers) and the
    # measured training run (48 a step).  Beside the numbers phase's
    # device ms (a profiler session of the call alone), each entry point's
    # device ms a launch inside the profiled training step
    by_group = train["profile"].get("device_ms_per_step_by_group", {})
    per_step = train["launches_per_step"]

    def in_step(group: str, entry: str):
        return by_group[group] / per_step[entry] if group in by_group \
            else None

    r = numbers["swa"]["swa"]
    out.append({
        "name": f"swa_attention_forward (bf16, B={r['B']} Hq={r['Hq']} "
                f"Hkv={r['Hkv']} S={r['S']} W={r['W']} d={r['d']})",
        "route": "cuda", "source": SWA_SOURCE, "replaces": SWA_REPLACES,
        "launches": lm["launches"]["swa_attention_forward"],
        "launches_train": train["launches"]["swa_attention_forward"],
        "max_abs_err": swa["max_abs_err_bf16"],
        "max_abs_err_fp32": swa["max_abs_err_fp32"],
        "ms": r["ms"], "device_ms": r["device_ms"],
        "device_ms_in_train_step": in_step("swa forward",
                                           "swa_attention_forward"),
        "train_batch": TRAIN_BATCH, "at_train_batch": r["train_batch"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    # the same kernel as full causal attention (W = S) at one olmoe-1b-7b
    # prefill layer's shape; launches: the MoE generation run's prefill
    c = numbers["swa"]["swa"]["causal"]
    out.append({
        "name": f"swa_attention_forward (causal, W = S; bf16, B={c['B']} "
                f"Hq={c['Hq']} Hkv={c['Hkv']} S={c['S']} d={c['d']})",
        "route": "cuda", "source": SWA_SOURCE, "replaces": SWA_REPLACES,
        "in_place_of": "src/repro/models/blocks.py:105,140 "
                       "chunked_attention(causal=True) (jnp)",
        "launches": moe["launches"]["swa_attention_forward"],
        "launches_mesh": ml.get("swa_attention_forward_prefill"),
        "launches_whisper": whisper["launches"]["swa_attention_forward"],
        "launches_llava": llava["launches"]["swa_attention_forward"],
        "max_abs_err": swa["max_abs_err_causal"]["bfloat16"],
        "max_abs_err_fp32": swa["max_abs_err_causal"]["float32"],
        "ms": c["ms"], "device_ms": c["device_ms"],
        "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"], "library_ms": c["library_ms"],
        "library_is": c["library_is"]})
    # the backward at the training run's shape (B = 1) in bf16; library:
    # SDPA forward + backward, beside our forward with lse + backward
    r = next(x for x in numbers["swa_backward"]["rows"]
             if x["B"] == TRAIN_BATCH and x["dtype"] == "bfloat16")
    entries = ("swa_attention_bwd_dot", "swa_attention_backward_dkdv",
               "swa_attention_backward_dq")
    out.append({
        "name": f"swa_attention_backward (bwd_dot + backward_dkdv + "
                f"backward_dq; bf16, B={r['B']} Hq={r['Hq']} Hkv={r['Hkv']} "
                f"S={r['S']} W={r['W']} d={r['d']})",
        "route": "cuda", "source": SWA_SOURCE,
        "replaces": "src/repro/models/attention.py:123 (autodiff of the jnp "
                    "scan; no Pallas backward)",
        "launches": sum(train["launches"][e] for e in entries),
        "launches_by_entry": {e: train["launches"][e] for e in entries},
        "launches_mesh": ml and sum(ml[f"{e}_train"] for e in entries),
        "max_abs_err": swa["max_abs_err_backward_bf16"],
        "max_abs_err_fp32": swa["max_abs_err_backward_fp32"],
        "ms": r["ms"], "device_ms": r["device_ms"],
        "device_ms_by_kernel": r["device_ms_by_kernel"],
        "device_ms_in_train_step": {
            e: in_step(g, e) for g, e in (
                ("swa bwd_dot", "swa_attention_bwd_dot"),
                ("swa backward_dkdv", "swa_attention_backward_dkdv"),
                ("swa backward_dq", "swa_attention_backward_dq"))},
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "design_bound_ms": r["design_bound_ms"],
        "issued_bound_ms": r["issued_bound_ms"],
        "library_ms": r["library_fwd_bwd_ms"],
        "library_is": "SDPA forward + backward, band mask, enable_gqa",
        "fwd_lse_bwd_ms": r["fwd_lse_bwd_ms"]})
    # the backward as full causal attention at one olmoe-1b-7b layer's
    # training shape (W = S, d 128, group 1); library: SDPA is_causal
    # forward + backward, beside our forward with lse + backward
    r = numbers["swa_backward"]["causal_olmoe"]
    moe_t = train["moe"]
    out.append({
        "name": f"swa_attention_backward (causal, W = S: bwd_dot + "
                f"backward_dkdv + backward_dq; bf16, B={r['B']} "
                f"Hq={r['Hq']} Hkv={r['Hkv']} S={r['S']} d={r['d']})",
        "route": "cuda", "source": SWA_SOURCE,
        "replaces": "src/repro/models/attention.py:123 (autodiff of the jnp "
                    "scan; no Pallas backward)",
        "in_place_of": "src/repro/models/blocks.py:105,140 "
                       "chunked_attention(causal=True) (jnp), differentiated",
        "launches": sum(moe_t["launches"][e] for e in entries),
        "launches_by_entry": {e: moe_t["launches"][e] for e in entries},
        "launches_per_step": {e: moe_t["launches_per_step"][e]
                              for e in entries},
        "max_abs_err": swa["max_abs_err_backward_bf16"],
        "max_abs_err_fp32": swa["max_abs_err_backward_fp32"],
        "ms": r["ms"], "device_ms": r["device_ms"],
        "device_ms_by_kernel": r["device_ms_by_kernel"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "issued_bound_ms": r["issued_bound_ms"],
        "library_ms": r["library_fwd_bwd_ms"],
        "library_is": r["library_is"],
        "fwd_lse_bwd_ms": r["fwd_lse_bwd_ms"]})
    # the causal forward at one mistral-large-123b layer's shape (96 q over
    # 8 kv heads); launches: the zoo phase's measured mistral prefill
    c = numbers["swa"]["swa"]["causal_mistral"]
    zoo_l = {a: x["launches"]["swa_attention_forward"]
             for a, x in (zoo or {}).get("archs", {}).items()}
    out.append({
        "name": f"swa_attention_forward (causal, W = S; bf16, B={c['B']} "
                f"Hq={c['Hq']} Hkv={c['Hkv']} S={c['S']} d={c['d']})",
        "route": "cuda", "source": SWA_SOURCE, "replaces": SWA_REPLACES,
        "in_place_of": "src/repro/models/blocks.py:105,140 "
                       "chunked_attention(causal=True) (jnp)",
        "launches": zoo_l.get(MISTRAL_ARCH), "launches_zoo": zoo_l,
        "launches_mesh_tp": ml.get("swa_attention_forward_tp_prefill"),
        "max_abs_err": swa["max_abs_err_causal"]["bfloat16"],
        "max_abs_err_fp32": swa["max_abs_err_causal"]["float32"],
        "ms": c["ms"], "device_ms": c["device_ms"],
        "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
        "bound_by": c["bound_by"], "library_ms": c["library_ms"],
        "library_is": c["library_is"]})
    # the d = 256 instances at one recurrentgemma-2b attention layer's
    # shape, bf16: the forward (launches: the generation run's prefill and
    # the training run's), then forward with lse + backward (the training
    # run's); library: SDPA with the band mask and enable_gqa
    f, b = numbers["hybrid"]["forward"], numbers["hybrid"]["backward"]
    shape = (f"bf16, B={f['B']} Hq={f['Hq']} Hkv={f['Hkv']} S={f['S']} "
             f"W={f['W']} d={f['d']}")
    hyb = train["hybrid"]
    out.append({
        "name": f"swa_attention_forward (d = 256; {shape})",
        "route": "cuda", "source": SWA_SOURCE, "replaces": SWA_REPLACES,
        "launches": hybrid["launches"]["swa_attention_forward"],
        "launches_train": hyb["launches"]["swa_attention_forward"],
        "max_abs_err": swa["max_abs_err_d256"]["bfloat16"],
        "max_abs_err_fp32": swa["max_abs_err_d256"]["float32"],
        "ms": f["ms"], "device_ms": f["device_ms"],
        "plain_ms": f["plain_ms"], "bound_ms": f["bound_ms"],
        "bound_by": f["bound_by"], "library_ms": f["library_ms"]})
    out.append({
        "name": f"swa_attention_backward (d = 256: bwd_dot + backward_dkdv "
                f"+ backward_dq; {shape})",
        "route": "cuda", "source": SWA_SOURCE,
        "replaces": "src/repro/models/attention.py:123 (autodiff of the jnp "
                    "scan; no Pallas backward)",
        "launches": sum(hyb["launches"][e] for e in entries),
        "launches_by_entry": {e: hyb["launches"][e] for e in entries},
        "max_abs_err": swa["max_abs_err_backward_d256"]["bfloat16"],
        "max_abs_err_fp32": swa["max_abs_err_backward_d256"]["float32"],
        "ms": b["ms"], "device_ms": b["device_ms"],
        "device_ms_by_kernel": b["device_ms_by_kernel"],
        "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"], "issued_bound_ms": b["issued_bound_ms"],
        "library_ms": b["library_fwd_bwd_ms"],
        "library_is": "SDPA forward + backward, band mask, enable_gqa",
        "fwd_lse_bwd_ms": b["fwd_lse_bwd_ms"]})
    # the selective scan at one falcon-mamba-7b prefill layer's shape, bf16:
    # the fused entry point (the main path's) and the bare one (the
    # contract tests'; no longer on the main path); no single PyTorch call
    # computes either
    r = numbers["scan"]
    err = scan["max_abs_err"]
    f = r["fused"]
    shape = (f"bf16, B={r['B']} S={r['S']} d_in={r['d_in']} "
             f"d_state={r['d_state']}")
    out.append({
        "name": f"selective_scan_fused (softplus + scan + D skip + silu(z) "
                f"gate; {shape})",
        "route": "cuda", "source": SCAN_SOURCE, "replaces": SCAN_REPLACES,
        "launches": mamba["launches"]["selective_scan_fused"],
        "max_abs_err": max(err["bfloat16"]["fused_out"],
                           err["bfloat16"]["fused_h_last"]),
        "max_abs_err_fp32": max(err["float32"]["fused_out"],
                                err["float32"]["fused_h_last"]),
        "launches_train": train["mamba"]["launches"]["selective_scan_fused"],
        "ms": f["ms"], "device_ms": f["device_ms"],
        "without_states_ms": f["without_states_ms"],
        "with_states_ms": f["with_states_ms"],
        "plain_ms": f["plain_ms"], "unfused_ms": f["unfused_ms"],
        "unfused_device_ms": f["unfused_device_ms"],
        "bound_ms": f["bound_ms"], "bound_by": f["bound_by"],
        "bound_parts_ms": f["bound_parts_ms"], "library_ms": None})
    # its backward at the same shape, as training runs it; launches: the
    # measured falcon-mamba-7b training run's (one a layer a step)
    b = r["backward"]
    absolute = lambda e: max(v for k, v in e["backward"].items()
                             if k != "relative")
    out.append({
        "name": f"selective_scan_fused_backward (recompute from the tile "
                f"states, reverse scan, the gate's, D skip's and "
                f"softplus's gradients; {shape})",
        "route": "cuda", "source": SCAN_SOURCE,
        "replaces": "src/repro/models/blocks.py:605, 642-659 "
                    "(jax.value_and_grad through the jnp scan and tail; "
                    "no Pallas kernel)",
        "launches": train["mamba"]["launches"][
            "selective_scan_fused_backward"],
        "launches_per_step": train["mamba"]["launches_per_step"][
            "selective_scan_fused_backward"],
        "max_abs_err": absolute(err["bfloat16"]),
        "max_abs_err_fp32": absolute(err["float32"]),
        "max_err_over_max_reduced": err["bfloat16"]["backward"]["relative"],
        "ms": b["ms"], "device_ms": b["device_ms"],
        "device_ms_by_kernel": b["device_ms_by_kernel"],
        "plain_ms": b["plain_ms"], "bound_ms": b["bound_ms"],
        "bound_by": b["bound_by"], "bound_parts_ms": b["bound_parts_ms"],
        "library_ms": None})
    # the channel-parallel paths' kernels at a rank's shapes on a model
    # axis of 2 (the mesh phase's child): their launches are the mesh
    # phase's, over both ranks (the bf16 generations' prefills, the fp32
    # training steps)
    rk = (mesh or {}).get("rank_shape_kernels")
    if rk:
        for key, name, replaces, launch_keys in (
                ("scan_fused", "selective_scan_fused (a rank's channels",
                 SCAN_REPLACES,
                 (f"selective_scan_fused_tp_prefill_{MAMBA_ARCH}",)),
                ("scan_fused_backward", "selective_scan_fused_backward (a "
                 "rank's channels", "src/repro/models/blocks.py:605, "
                 "642-659 (jax.value_and_grad through the jnp scan and "
                 "tail; no Pallas kernel)",
                 ("selective_scan_fused_backward_tp_train",)),
                ("swa_forward_d256", "swa_attention_forward (d = 256, a "
                 "rank's heads", SWA_REPLACES,
                 (f"swa_attention_forward_tp_prefill_{HYBRID_ARCH}",)),
                ("swa_backward_d256", "swa_attention_backward (d = 256, "
                 "bwd_dot + backward_dkdv + backward_dq, a rank's heads",
                 "src/repro/models/attention.py:123 (autodiff of the jnp "
                 "scan; no Pallas backward)",
                 tuple(f"{e}_tp_train" for e in entries)),
                ("swa_forward_whisper_rank", "swa_attention_forward "
                 "(causal, whisper-base's decoder, a rank's heads",
                 SWA_REPLACES,
                 (f"swa_attention_forward_tp_prefill_{WHISPER_ARCH}",)),
                ("swa_forward_h2o_rank", "swa_attention_forward "
                 "(h2o-danube-1.8b with the int8 cache, a rank's heads",
                 SWA_REPLACES, ("swa_attention_forward_tp_prefill_int8",))):
            x = rk[key]
            dims = (f"d_in={x['d_in']} d_state={x['d_state']}"
                    if "d_in" in x else
                    f"Hq={x['Hq']} Hkv={x['Hkv']} W={x['W']} d={x['d']}")
            out.append({
                "name": f"{name} on a model axis of "
                        f"{rk['model_axis']}; bf16, B={x['B']} S={x['S']} "
                        f"{dims})",
                "route": "cuda",
                "source": SCAN_SOURCE if "d_in" in x else SWA_SOURCE,
                "replaces": replaces,
                "launches": sum(ml[k] for k in launch_keys),
                "launches_over": "the mesh phase, both ranks: "
                                 + ", ".join(launch_keys),
                "max_abs_err": x["max_abs_err"], "ms": x["ms"],
                "plain_ms": x["plain_ms"],
                "bound_ms": x["bound_ms"], "bound_by": x["bound_by"],
                "library_ms": x["library_ms"]})
        # whisper-base's decoder layer in one process: the whisper phase's
        # measured prefill
        x = rk["swa_forward_whisper"]
        out.append({
            "name": f"swa_attention_forward (causal, whisper-base's decoder "
                    f"in one process; bf16, B={x['B']} S={x['S']} "
                    f"Hq={x['Hq']} Hkv={x['Hkv']} W={x['W']} d={x['d']})",
            "route": "cuda", "source": SWA_SOURCE, "replaces": SWA_REPLACES,
            "launches": whisper["launches"]["swa_attention_forward"],
            "launches_over": "the whisper phase's measured prefill",
            "max_abs_err": x["max_abs_err"], "ms": x["ms"],
            "plain_ms": x["plain_ms"], "bound_ms": x["bound_ms"],
            "bound_by": x["bound_by"], "library_ms": x["library_ms"]})
    out.append({
        "name": f"selective_scan_forward (bare scan; {shape})",
        "route": "cuda", "source": SCAN_SOURCE, "replaces": SCAN_REPLACES,
        "launches": mamba["launches"]["selective_scan_forward"],
        "on_main_path": False,
        "launches_scan_phase": scan["launches"]["selective_scan_forward"],
        "max_abs_err": max(err["bfloat16"]["y"], err["bfloat16"]["h_last"]),
        "max_abs_err_fp32": max(err["float32"]["y"],
                                err["float32"]["h_last"]),
        "ms": r["ms"], "device_ms": r["device_ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "bound_parts_ms": r["bound_parts_ms"],
        "library_ms": None})
    return {"kernels": out}


def ended(kind: str, name: str, seconds: float) -> None:
    """One line as a phase (or a part of the numbers phase) ends, its wall
    seconds, flushed to stdout and stderr: a run stopped at its limit
    still shows where its time went."""
    line = json.dumps({"ended": f"{kind} {name}", "seconds": seconds})
    print(line, flush=True)
    print(line, file=sys.stderr, flush=True)


def laps(phase: str):
    """``lap(name)``: an ``ended`` line for part ``name`` of ``phase``, its
    seconds since the previous lap (or since ``laps``): where a long
    phase's time goes, in a run stopped at its limit too."""
    last = [time.perf_counter()]

    def lap(name: str) -> None:
        now = time.perf_counter()
        ended("part", f"{phase} {name}", now - last[0])
        last[0] = now
    return lap


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases",
                    default="build,kernels,kge,swa,scan,serve,shard,"
                            "workers,"
                            "update,jobs,lm,moe,mesh,mamba,hybrid,whisper,"
                            "llava,zoo,train,numbers",
                    help="phases to run, in the script's order; zoo_deep "
                         "(the zoo's cut archs at the deepest depth that "
                         "fits) and alloc run only when named")
    ap.add_argument("--out", default=None, help="also write results here")
    ap.add_argument("--sass-of", default=None, metavar="SOURCE.cu",
                    help="compile one CUDA source with the port's flags "
                         "and print its kernels' registers, spills and "
                         "SASS opcode counts, then exit")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))

    src = ROOT / "src"
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no port sources under {src}; run it from the "
              f"repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: this smoke "
              "run needs an NVIDIA card", file=sys.stderr)
        return 2
    if args.sass_of:
        emit({"sass_of": sass_of(args.sass_of)})
        return 0
    card = card_line()
    print(f"[chip_smoke] {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core.registry import EmbeddingRegistry

    t_start = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="biokg-smoke-") as tmp:
        store_tables = {}
        served = None
        if phases & {"kernels", "serve", "shard", "workers", "jobs",
                     "numbers"}:
            reg = EmbeddingRegistry(tmp)
            for i, version in enumerate(("2025-01", "2025-02")):
                ids, labels, emb = go_table(GO_ROWS, SEED + i)
                reg.publish("go", version, "transe", ids, labels, emb,
                            ontology_checksum=f"seed-{SEED + i}",
                            hyperparameters={"dim": D, "seed": SEED + i},
                            generated_at="2025-01-01T00:00:00+00:00")
                reg.seal("go", version)
            served = {"ids": ids, "labels": labels, "emb": emb}
            # the only phases that read it
            scale = bool(phases & {"kernels", "shard"})
            if scale:
                ids_s, labels_s, emb_s = go_table(SCALE_ROWS, SEED + 7)
                reg.publish("go-scale", "2025-01", "transe", ids_s,
                            labels_s, emb_s,
                            ontology_checksum=f"seed-{SEED + 7}",
                            hyperparameters={"dim": D, "seed": SEED + 7},
                            generated_at="2025-01-01T00:00:00+00:00")
                del emb_s
            for ont, n_rows in (("go", GO_ROWS), ("go-scale", SCALE_ROWS)
                                )[:1 + scale]:
                table, norms, _ = reg.store.open_table(
                    ont, reg.store.latest_version(ont), "transe")
                store_tables[n_rows] = (table, norms)

        def numbers():
            if set(RESULTS["phases"]) - {"build"}:
                return _phase_in_child("numbers", tmp, card)
            t0 = time.perf_counter()
            out = phase_numbers(store_tables, card)
            torch.cuda.synchronize()
            seconds = {"topk": time.perf_counter() - t0}
            ended("numbers part", "topk", seconds["topk"])
            for part, run in (("kge", kge_numbers), ("swa", swa_numbers),
                              ("swa_backward", swa_backward_numbers),
                              ("moe", moe_numbers), ("scan", scan_numbers),
                              ("zoo", zoo_numbers),
                              ("hybrid", hybrid_numbers)):
                t0 = time.perf_counter()
                out[part] = run(card)
                torch.cuda.synchronize()
                seconds[part] = time.perf_counter() - t0
                ended("numbers part", part, seconds[part])
            # each part's wall seconds: where the phase's time goes
            out["part_seconds"] = seconds
            _check_device_times(out)
            return out

        def llava():
            if set(RESULTS["phases"]) - {"build"}:
                return _phase_in_child("llava", tmp, card)
            return phase_llava(card)

        def zoo(name: str):
            if set(RESULTS["phases"]) - {"build"}:
                return _phase_in_child(name, tmp, card)
            return phase_zoo(card, deep=name == "zoo_deep")

        # in this order; each phase's wall seconds are kept beside it
        for name, run in (
                ("build", phase_build),
                ("kernels", lambda: phase_kernels(store_tables)),
                ("kge", phase_kge), ("swa", phase_swa),
                ("scan", phase_scan),
                ("serve", lambda: phase_serve(tmp, served)),
                ("shard", lambda: phase_shard(tmp, served, store_tables,
                                              card)),
                ("workers", lambda: phase_workers(tmp, served)),
                ("update", lambda: phase_update(tmp)),
                ("jobs", lambda: phase_jobs(tmp, card)),
                ("lm", phase_lm), ("moe", phase_moe),
                ("mesh", lambda: phase_mesh(card)),
                ("mamba", phase_mamba), ("hybrid", phase_hybrid),
                ("whisper", phase_whisper),
                ("llava", llava),
                ("zoo", lambda: zoo("zoo")),
                ("zoo_deep", lambda: zoo("zoo_deep")),
                ("train", lambda: phase_train(card)),
                ("numbers", numbers),
                ("alloc", lambda: phase_alloc(card))):
            if name in phases:
                t0 = time.perf_counter()
                RESULTS["phases"][name] = run()
                torch.cuda.synchronize()
                RESULTS["phase_seconds"][name] = time.perf_counter() - t0
                ended("phase", name, RESULTS["phase_seconds"][name])
        emit({"phase_seconds": RESULTS["phase_seconds"]})
        store_tables.clear()
    RESULTS["seconds"] = time.perf_counter() - t_start
    RESULTS["card"] = card
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(RESULTS, indent=1))
    print(card)
    if {"kernels", "kge", "swa", "scan", "serve", "shard", "update", "jobs",
            "lm", "moe", "mesh", "mamba", "hybrid", "whisper", "llava",
            "zoo", "train", "numbers"} <= phases:
        ph = RESULTS["phases"]
        print(json.dumps(kernels_line(ph["kernels"], ph["serve"], ph["kge"],
                                      ph["update"], ph["jobs"],
                                      ph["numbers"], ph["swa"], ph["lm"],
                                      ph["moe"], ph["train"], ph["scan"],
                                      ph["mamba"], ph["whisper"],
                                      ph["llava"], ph["hybrid"],
                                      ph["shard"], ph["mesh"], ph["zoo"])))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
