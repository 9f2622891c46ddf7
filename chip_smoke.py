#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (`src/repro_torch`) on one CUDA card,
and of the graph path over four where the machine has them.

    python3 chip_smoke.py            # every phase
    python3 chip_smoke.py --cards    # the build and the cards phase alone

Builds the hand-written kernels from `src/repro_torch/kernels/csrc/` and then:

1. kernel phase: each kernel against its plain PyTorch version on the card,
   at the main paths' shapes and at edge cases, with CUDA-event times of the
   kernel, the plain version and, where one exists, a single PyTorch library
   call.  The five graph kernels are bit-equal (tolerance zero: all values
   are integers); `flash_attention`'s two kernels (decode: split-KV with
   1-D bulk copies; prefill: wgmma + TMA) are held, row by row, to their
   error relative to the row's largest value (`flash_attention.row_error`):
   1e-5 in f32 (the sum order differs), 2^-6 in bf16 (two bf16 ulps of the
   row's largest value), in cases (a)-(i), MLA's (j)-(l) (q and k 192
   wide, v 128), zamba2's (m)-(o) (80 wide) and encdec_main's and
   vlm_main's shapes (p)-(v) (seamless's non-causal encoder and cross
   attention, llava's GQA prefill and decode), and planted faults at the
   main paths' shapes (the softmax scale 5 % off; the last 32 keys of each
   row dropped; at width 80, q.k over columns 0-63 only and output columns
   64-79 dropped) must exceed that limit.  `bucket_hist` is timed at the main
   shape, at walks_main's call, at the walk shape of capacity factor 4, at
   k 64 and with no ids (its fixed cost, beside an empty kernel), at
   serve_moe's expert dispatch (k 64: an admission's 2048 x 6 ids, a decode
   wave's 8 x 6) and at serve_moe_ep's (k 4: a sender's records in the
   exchange; k 64: every receiver's rows in the local bucketing, and a
   decode wave's gather; k 256: the load-balance counts; and the k 16
   register-bin instance at one receiver's rows), each with
   bincount beside it; it is checked on two slices that start off a 16-byte
   boundary, and a planted fault (one id skipped) must fail the comparison.
   `relabel_gather` is timed at the main path's call (one field of the ring
   relabel: 8 sorted rows of 2^27 keys against all of pv, one launch), at
   one ring round's segment (the call before that) and at a disk-tier join
   segment; `feistel_perm` at 2^30 ids and at a disk-tier chunk; the disk
   tier's calls beside an empty kernel; `merge_runs` (no Pallas kernel:
   redistribute_sorted's receive side) at the main path's exchange, bit-equal
   to its plain version, one launch, beside its byte bound and the device
   ms of its four launches.  Before that, the attention
   library's `ptxas -v` report and SASS give each kernel instance's
   registers and spills, and the run fails unless
   every prefill instance issues HGMMA and UTMALDG and every decode instance
   an asynchronous copy (UBLKCP or LDGSTS), unless no decode and no
   `bucket_hist` instance spills, and unless MLA's (192, 128) and
   zamba2's (80, 80) instances were built;
2. variant phase: every generate() variant at scale 16, nb 8, on the card
   and on the CPU, bit-equal; then walks_parity: distributed_walks (length
   80, 256 walkers per shard) and WalkLoader batches 0-2 on that graph,
   card == CPU bit for bit;
3. main phase: generate(GraphConfig(scale=26, nb=8)) (Graph500 "toy") with
   the defaults (paper shuffle, ring relabel, sorted CSR), once with an
   empty allocator cache and once warm, launch counts set to 0 just before
   and read just after each, validated on the card; then the same for the
   communication-free variant (shuffle_variant="recompute"), the main path's
   user of the Feistel kernel (the ring relabel launches relabel_gather once
   a field: 2 a run, and merge_runs 1, else the run fails).  The graph kernels' bounds count the
   per-thread SASS instructions of this build (`repro_torch.kernels.sass`);
   then walks_main: distributed_walks over the warm run's CSR, 2^20 walkers
   per shard (2^23 walks), length 80, capacity factor 8, launch counts set
   to 0 just before and read just after, zero drops, length x nb
   bucket_hist launches, every hop replayed on the card by code that shares
   nothing with the sampler; walk ms, hops/s and peak memory; then the same
   walk under torch.profiler (`walks_trace`: busy share, device time by
   kernel); then loader_main: a WalkLoader over that CSR on the card (the
   global CSR assembled there, held to the sharded one; build and batch ms,
   peak memory); then cards, with 4 cards or more (else one line that says
   it was skipped): the four-card path's shapes (Graph500 scale 28, nb 8,
   two shards a card, as the benchmark's four-card cell runs it), on the
   last of the 4 cards against the plain versions, bit for bit: merge_runs
   over one card's 2 receivers ([2, 8, 2^27 + 8] slots, the receivers'
   rows of every sender's relabelled, sorted R-MAT edges), one launch a
   call, and its time; rmat_edges over one shard's 2^29-edge block (the
   plain version in slices of 2^27); relabel_gather over two sorted rows
   of 2^29 keys (a card's share of a field) against a 2^28 pv; then generate() over cuda:0-3,
   cold and warm, launch counts set to 0 just before each and read just
   after (rmat_edges once a shard, relabel_gather twice a card, merge_runs
   once a card, bucket_hist launched), no drops, 2^32 owned edges, every
   block on its card, each card's peak;
4. disk-tier phases (the out-of-core generator, `core/external.py` and
   `core/phases.py`, whose per-chunk hot loops run the four graph kernels
   through `core/chunks.py`; each in a temporary workdir, deleted after):
   external_parity runs StreamingGenerator (external shuffle with sorted
   and scatter CSR, recompute, device shuffle) and PartitionedGenerator
   (4 workers, recompute over the filesystem; its external runs are the
   cluster phases' below) at scale 16, nb 8, chunks of 2^14, on the card
   and on the CPU,
   each run a process of its own: every file a run leaves has the same
   sha256 on both, and the card's runs launched all four graph kernels;
   external_main runs StreamingGenerator at scale 20 (2^24 edges, nb 8,
   external shuffle, sorted CSR, chunks of 2^21, I/O overlap) on the card,
   launch counts set to 0 just before and read just after: wall seconds,
   edges/s, seconds per phase, the I/O ledger, host peak rows against the
   chunk budget, peak device memory, each kernel's launches and summed
   CUDA-event ms, the card's busy share (torch.profiler); validated on the
   card against the port's distributed_shuffle (pv) and generate (sorted
   src * n + dst keys, degrees); external_recompute runs
   PartitionedGenerator (recompute, 4 workers on the card, scale 18) and
   holds its CSR files to an external+feistel StreamingGenerator run;
   the kernel phase also times the four graph kernels at these chunk shapes;
   then the cluster runtime (`core/cluster.py`, `core/jobqueue.py`: hosts
   are processes of their own, `python -m repro_torch.launch.cluster host`,
   each with its own workdir and CUDA context, exchanging over loopback
   sockets): cluster_parity runs a 2-host ClusterGenerator (scale 16,
   external shuffle, sorted CSR, a 4096 x 3 walk corpus) and a 2-host
   JobScheduler draining two jobs (the external graph; a recompute one with
   the fused generate+relabel and two fused corpora of 256 x 3) at
   max_concurrent 2, each with card hosts and with CPU hosts, the four
   drivers started beside external_parity's runs: every CSR file and
   corpus shard equal card vs CPU, the graph run's equal to
   external_parity's streaming-external-sorted run, no dead letter, no
   restart, and the card hosts' reports must show launches of rmat_edges,
   relabel_gather, bucket_hist and (the recompute job's) feistel_perm;
   cluster_main runs external_main's configuration on 2 card
   hosts with 2 pool workers each, launch counts set to 0 just before the
   hosts start and read after the run: wall seconds, edges/s, seconds per
   phase, the merged ledger, host peak rows, restarts, the hosts' launches
   and nvidia-smi's utilization.gpu over the run; zero random transfers and
   CSR files with external_main's sha256;
5. serve_parity phase: the serve path's smoke configs (internlm2, codeqwen,
   qwen3-moe; f32) and the deepseek-v2 smoke at MLA's real head widths and
   routing (q/k 192, v 128, 64 experts top-6; its own (24, 16) heads, which
   the kernel does not take, must raise on the card), the mamba2, zamba2,
   seamless and llava smokes (f32) and zamba2's at its real head width 80
   (f32, and bf16 through the (80, 80) prefill kernel) on the card and on
   the CPU: prefill and decode logits within 1e-4 (bf16: 1e-1), the
   Engine's tokens equal (the families it serves, f32);
6. serve_main phase: the continuous-batching Engine serving internlm2-1.8b
   at full width (bf16, random weights from a seeded generator on the card),
   8 slots of 4096 positions, 16 requests of 128-2048 prompt tokens and 64
   new tokens each (12 greedy, 4 sampled), admitted in waves as slots free
   up; launch counts set to 0 just before and read just after, every logit
   finite, and flash launches = layers x (prefills + decode waves), the
   prefill kernel's layers x prefills and the decode kernel's layers x
   decode waves; then a
   short window of the same engine under torch.profiler (`serve_trace`: a
   512-token request a slot, 16 new tokens each; the card's busy share,
   device time by kernel, and the window's prefill and decode ms);
7. serve_moe phase: the same Engine and requests serving deepseek-v2-lite-16b
   at full width and depth (27 layers, MLA + 64-expert MoE, bf16, random
   weights from a seeded generator on the card): every request served,
   logits finite, no decode drop, flash launches = 27 x (prefills + decode
   waves) split as in serve_main, bucket_hist launches = 26 MoE layers x
   (prefills + decode waves), no host sync inside a MoE layer (CUDA sync
   debug mode "error" around each `moe_ffn`); MoE dispatch ms (CUDA events
   around `moe_ffn`) and the drop totals of prefill and decode, the prefill
   drops recounted with plain ops from each layer's routes (equal to the
   dispatch's count) and split between prompt rows and right-padding; then
   its serve_trace window; then serve_moe_ep: the same weights (kept on
   the card) and requests behind `Engine(dist=make_dist(cfg, {"data": 1,
   "model": 4}))`, the experts dispatched over 4 expert shards (prefills by
   the capacity all_to_all, decode waves by gather; `models/moe.py`), once
   with the bf16 payload and once with the int8 one, 16 new tokens a
   request: before them the smoke's MoE layer (f32) under that dispatch on
   the card equals the CPU's (all_to_all at S 16, with and without int8,
   and gather at S 1 and 6: 1e-5, plus one quantisation step for int8;
   drops equal); each run's tokens/s, prefill and decode ms, MoE ms, drops,
   bucket_hist launches (counted per MoE call) and peak, every logit
   finite, no decode drop, the share of greedy tokens equal to serve_moe's,
   and on the first admission's first and last MoE layers (prompt rows) EP
   within 1e-1 of dense dispatch where neither drops (bf16 payload); and
   before them the gather route repeatable: serve_moe's first MoE layer on
   a decode wave, 10 runs bit-equal (`gather_ep_repeat`);
8. serve_ssm and serve_hybrid: the same Engine and requests serving
   mamba2-780m (48 Mamba2 layers, no attention: no flash launch) and
   zamba2-2.7b (54 Mamba2 layers, the shared attention block at 9 sites of
   32 heads of 80: flash launches 9 x (prefills + waves), the prefill
   kernel 9 x prefills, the decode kernel 9 x waves) at full width and
   depth, bf16, exact-length prefills; each admission's prompt tokens, SSD
   chunk and ms; for mamba2 the cost of one admission at 2048 and 2039
   prompt tokens (`chunk_cost`); their serve_trace windows;
9. encdec_main and vlm_main: seamless-m4t-large-v2 (24 + 24 layers, vocab
   256206; 4 sequences of 1024 encoder frames and a 128-token prompt) and
   llava-next-mistral-7b (32 layers; 4 sequences of 1176 image tokens and
   512 text tokens) at full width and depth, bf16, through prefill and 64
   greedy decode_steps: ms of encode + prefill and per step, peak memory,
   flash launches by kernel, every logit finite, the prefill's last logits
   held to a forward without a cache;
10. the train path (`repro_torch.train`, `launch/train.py`; attention
   through the reference's chunked attention under autograd, never the
   flash kernel, which has no backward): train_parity runs the dense, moe
   and ssm smokes (f32), and deepseek-v2's smoke under expert-parallel
   dispatch over 4 expert shards, 3 steps each on the card and on the CPU
   from the same params and batch (losses within 1e-4 relative, params
   within 1e-3, grad norms finite, no flash launch, the MoE ones launch
   bucket_hist), checks that the flash kernel
   refuses inputs that need a gradient, restores a bf16 smoke state saved
   from the card (async) leaf for leaf, and resumes launch/train.py from
   its --ckpt-dir to the uninterrupted run's losses; train_main trains
   internlm2-1.8b at full width (24 layers, d 2048, vocab 92544, bf16
   params, f32 master and Adam moments) 12 steps on WalkLoader batches of
   8 x 512 tokens from a scale-20 nb-8 graph generated on the card: loss,
   grad norm and lr per step, the median step ms from step 3 on split into
   forward + backward and optimizer (CUDA events), tokens/s over that
   median and over the host's wall time of the same steps, peak memory,
   launch counts (generate's graph kernels; no flash launch), the loss
   falling; train_external runs `launch/train.py --data external --scale 12
   --steps 20 --seq 16` on the card (StreamingGenerator, ExternalWalkLoader,
   training): the loss falls and the disk tier's hooks launched their
   graph kernels; train_moe_ep trains deepseek-v2-lite-16b at full width,
   depth cut to 4 layers (its dense first layer and 3 MoE layers), under
   expert-parallel dispatch over 4 expert shards (all_to_all, 16 experts a
   shard) through launch/perf.py's run_variant, once with the bf16 payload
   and once with int8: 8 steps of one seeded 4096-token sequence with
   train_main's optimizer settings, losses finite and falling, no flash
   launch, bucket_hist launches = MoE layers x launches a moe_ffn x steps,
   dropped, step ms, peak, mfu and the useful-flops ratio of the step's
   counted flops, the top kernels; train_main also prints its Roofline and
   mfu (model flops at B 8 x S 512 over the bf16 peak and its median step);
11. dryrun: launch/dryrun.py over every arch x shape on the meta device,
   one line a cell (params and state or cache bytes, whether they fit in
   80 GB, the largest power-of-two batch, model flops, one-card roofline
   terms) and a summary line.

Prints the card's name and power limit, one JSON line per check, a
{"kernels": [...]} line, and last {"ok": true, "device": {...}}.  Any failed
check raises and the script exits nonzero.  Without CUDA, or without the
repository beside it, it exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import re
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MAIN_SCALE = 26                    # Graph500 "toy": 2^26 vertices, 2^30 edges
NB = 8
VARIANT_SCALE = 16
# The card's peaks (bytes/s, bf16 and integer operations) and every kernel's
# bound come from repro_torch.launch.mesh and repro_torch.launch.roofline; the
# operations of a graph kernel are its per-thread SASS instructions per item
# (`repro_torch.kernels.sass`), counted in this run's build.
PLAIN_CHUNK = 1 << 27              # feistel_perm_plain's int64 temporaries, 1 GiB each
CARDS, CARDS_SCALE = 4, 28         # the four-card path: Graph500 scale 28, two shards a card
SLEEP_CYCLES = 20_000_000          # ~10 ms of card time ahead of each timed call
SERVE_ARCH = "internlm2-1.8b"      # launch/serve.py's default architecture
SERVE_SLOTS, SERVE_MAX_LEN = 8, 4096
SERVE_REQUESTS, SERVE_NEW_TOKENS = 16, 64
SERVE_PROMPT_RANGE = (128, 2048)   # prompt lengths of a 1.8B chat / code model
SERVE_SAMPLED = (3, 7, 11, 15)     # uids that sample (temperature 0.8, top-k 40)
SERVE_SEED = 0
# serve_trace's window: a 512-token request a slot, 16 new tokens each (32
# until the script neared its time limit: the profiler's processing of a
# window's kernel events took 20-48 s of host time a window at 32)
TRACE_PROMPT, TRACE_NEW_TOKENS = 512, 16
MOE_ARCH = "deepseek-v2-lite-16b"   # serve_moe: the MoE + MLA config that fits one card
# serve_moe_ep: serve_moe's weights and requests over 4 expert shards (the
# reference mesh's "model" axis on one card), each request cut to
# MOE_EP_NEW_TOKENS new tokens so that the bf16 and int8 runs together stay
# inside a minute of the script's time limit
MOE_EP_MESH = {"data": 1, "model": 4}
MOE_EP_NEW_TOKENS = 16
MOE_EP_PARITY = ((16, False), (1, False), (6, False), (16, True))   # (S, int8) of the smoke
GATHER_REPEATS = 10                # gather_ep_repeat: decode waves that must be bit-equal
SSM_ARCH = "mamba2-780m"            # serve_ssm: attention-free, 48 Mamba2 layers
HYBRID_ARCH = "zamba2-2.7b"         # serve_hybrid: 54 Mamba2 layers, 9 sites of 32 heads of 80
ENCDEC_ARCH = "seamless-m4t-large-v2"   # encdec_main: 24 + 24 layers, prefill + decode_step
VLM_ARCH = "llava-next-mistral-7b"      # vlm_main: 1176 image tokens before the text
ENCDEC_BATCH, ENCDEC_FRAMES, ENCDEC_PROMPT = 4, 1024, 128
VLM_BATCH, VLM_TEXT = 4, 512
GEN_STEPS = 64                     # greedy decode steps of encdec_main and vlm_main
# serve_ssm's admission cost by prompt length: a length 256 divides, and the
# prime beside it, where the reference's chunking (the largest divisor of S
# up to 256) falls to chunks of 1 position
CHUNK_COST_LENGTHS = (2048, 2039)
PARITY_ARCHS = ("internlm2-1.8b", "codeqwen1.5-7b", "qwen3-moe-235b-a22b", MOE_ARCH)
PARITY_FAMILIES = (SSM_ARCH, HYBRID_ARCH, ENCDEC_ARCH, VLM_ARCH)   # prefill of 20 tokens
# zamba2's smoke at its real head width 80 (d_model 320 over 4 heads), the
# rest the smoke's; its bf16 prefill of 20 tokens takes the (80, 80) prefill kernel
PARITY_D80 = dict(d_model=320, num_heads=4, num_kv_heads=4)
# The train path (`repro_torch.train`, `launch/train.py`): train_parity runs
# the dense, moe and ssm smokes (f32) TRAIN_PARITY_STEPS steps each on the card
# and on the CPU from the same seeded params and batch; train_main trains
# internlm2-1.8b at full width on WalkLoader batches of a scale-20 nb-8 graph
# generated on the card; train_external runs launch/train.py's out-of-core
# route.  Card vs CPU: f32 losses to TRAIN_LOSS_RTOL (sums in another order)
# and params to TRAIN_PARAM_ATOL (Adam's first steps are about sign(g), so a
# grad near 0 that flips moves its param by up to 2 lr)
# (arch, mesh): the deepseek-v2 smoke trains under expert-parallel dispatch
# over MOE_EP_MESH's 4 expert shards, the others without a mesh
TRAIN_PARITY_RUNS = (("internlm2-1.8b", None), ("qwen3-moe-235b-a22b", None),
                     ("mamba2-780m", None), (MOE_ARCH, MOE_EP_MESH))
TRAIN_PARITY_STEPS, TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ = 3, 4, 16
TRAIN_LOSS_RTOL, TRAIN_PARAM_ATOL = 1e-4, 1e-3
TRAIN_RESUME_STEPS = 8             # launch/train.py: 4 steps, then resumed to 8
TRAIN_ARCH = "internlm2-1.8b"
TRAIN_SCALE, TRAIN_BATCH, TRAIN_SEQ = 20, 8, 512
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_LR = 12, 2, 1e-3
TRAIN_TIMED_FROM = 3               # steps before this one warm up (allocator, cuBLAS)
TRAIN_TRACE_STEPS = 1              # train_trace: steps under torch.profiler after the timed ones
# sequences of 16 tokens: the out-of-core corpus costs about a second a hop
# on the host, so the launcher's default 64 (65 hops) took 75 s of the script
TRAIN_EXTERNAL_ARGV = ["--data", "external", "--scale", "12", "--steps", "20", "--seq", "16"]
# train_moe_ep: deepseek-v2-lite-16b at full width over MOE_EP_MESH's 4 expert
# shards, through launch/perf.py's run_variant (bf16 payload, then int8), one
# 4096-token sequence (train_4k's length) a step.  Depth cut to its dense
# first layer and 3 MoE layers: 2.25e9 parameters, about 34 GiB of bf16
# params and grads, f32 master and moments (27 layers would need about 250 GB)
TRAIN_MOE_EP_LAYERS, TRAIN_MOE_EP_BATCH, TRAIN_MOE_EP_STEPS = 4, 1, 8
TRAIN_MOE_EP_VARIANTS = ("baseline", "dispatch_int8")
TRAIN_SEED = 0
# deepseek-v2's smoke at the real MLA head widths (q/k 128 + 64, v 128) and
# routing (64 experts, top-6, unnormalised weights), a few layers; the
# smoke's own (24, 16) heads are not a width the kernel takes
PARITY_MLA = dict(qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128, num_experts=64,
                  experts_per_tok=6, norm_topk_prob=False)
PARITY_TOL = 1e-4                  # f32 logits, card vs CPU: the sum order differs
# bf16 logits, card vs CPU: activations are rounded to 8 bits after other
# sums (the kernels', cuBLAS's and the CPU's), the tests' bf16 tolerance
PARITY_BF16_TOL = 1e-1
WALK_LENGTH = 80                   # DeepWalk's walk length (Perozzi et al., KDD 2014)
WALK_WALKERS = 1 << 20             # walkers per shard in walks_main: 2^23 walks
# Before the first hop every walker is still on the shard that launched it,
# so all W walkers of a shard go to one receiver: the pair capacity
# ceil(W * factor / nb) holds them only when factor >= nb.  walks_main needs
# zero drops (factor nb); walks_parity runs factor 4, which drops half of
# them at the first hop, so that card == CPU covers the drops too.
WALK_CAPACITY_FACTOR = NB
WALK_PARITY_CAPACITY_FACTOR = 4
WALK_SEED = 0
WALK_PARITY_WALKERS = 256          # walks_parity, on the scale-16 graph
# The disk tier (StreamingGenerator / PartitionedGenerator): external_parity
# runs every driver and variant at scale 16 on the card and on the CPU, each
# run a process of its own (the partitioned external variant over sockets and
# the filesystem is left to cluster_parity's graph run, card hosts against CPU
# hosts, and cluster_main, pool workers on the card against external_main,
# which run the same partitioned phases and hooks); external_main is the
# out-of-core Graph500 run on the card; external_recompute the partitioned
# communication-free one, held to an external+feistel streaming run.
DISK_PARITY_SCALE, DISK_PARITY_CHUNK = 16, 1 << 14
DISK_MAIN_SCALE, DISK_MAIN_CHUNK = 20, 1 << 21
DISK_RECOMPUTE_SCALE, DISK_RECOMPUTE_CHUNK = 18, 1 << 20
DISK_WORKERS = 4                   # PartitionedGenerator's worker processes
DISK_PARITY_RUNS = (               # (name, driver, GraphConfig fields)
    ("partitioned-recompute-fs", "partitioned", {"shuffle_variant": "recompute"}),
    ("streaming-external-sorted", "streaming", {"shuffle_variant": "external"}),
    ("streaming-external-scatter", "streaming", {"shuffle_variant": "external",
                                                 "csr_variant": "scatter"}),
    ("streaming-recompute", "streaming", {"shuffle_variant": "recompute"}),
    ("streaming-device", "streaming", {"shuffle_variant": "device"}),
)
# the runs whose graph then feeds an out-of-core walk corpus: external_walks
# through ExternalWalkLoader (streaming) and the pool's walk_corpus
# (partitioned), DISK_WALKERS walks of DISK_WALK_LENGTH hops each (a walk's
# cost grows faster than its hop count, so the walks stay short here)
DISK_WALK_RUNS = ("streaming-external-sorted", "partitioned-recompute-fs")
DISK_WALKERS, DISK_WALK_LENGTH, DISK_WALK_BATCHES = 4096, 3, 3


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi(query: str) -> str:
    r = subprocess.run(["nvidia-smi", "-i", "0", f"--query-gpu={query}", "--format=csv,noheader"],
                       capture_output=True, text=True, timeout=60)
    require(r.returncode == 0, f"nvidia-smi failed: {r.stderr}")
    return r.stdout.strip().splitlines()[0]


_MARKS = []   # (phase, perf_counter at its end), for the timeline line


def mark(phase: str) -> None:
    """Note the end of `phase` (its seconds are the time since the last mark)."""
    _MARKS.append((phase, time.perf_counter()))


def time_ms(fn, reps=5):
    """Median CUDA-event time of fn() over `reps` runs after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        # the card sleeps while the host enqueues the call, so the
        # wrapper's host time (~0.1 ms) is not counted as kernel time
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def bucket_hist_shapes(eps: int):
    """The timed bucket_hist cases (also timed by scripts/time_bucket_hist.py):
    (case, ids, k, share of the ids that are the pad value k, or None for ids
    uniform over the k + 1 values).  redistribute's call is one shard's
    owners (eps ids, k = nb); walks_main's is one shard's rows, 7 in 8 of
    them the pad value; the walk at capacity factor 4 has 3 in 4; k 64 runs
    the shared-memory histograms; no ids gives the fixed cost of a call."""
    walk_rows = -(-WALK_WALKERS * WALK_CAPACITY_FACTOR // NB) * NB
    walk_pad = 1 - WALK_WALKERS / walk_rows
    return [("main: one shard's owners, k 8", eps, NB, 0.0),
            (f"walks_main's call: 2^{walk_rows.bit_length() - 1} ids, k 8, "
             f"{walk_pad:.1%} pad value", walk_rows, NB, walk_pad),
            ("walk at capacity factor 4: 2^22 ids, k 8, 75 % pad value", 1 << 22, NB, 0.75),
            ("2^22 ids, k 64, pad value 1 in 65", 1 << 22, 64, None),
            ("fixed cost: 0 ids, k 8", 0, NB, 0.0)]


def bucket_ids(torch, g, dev, n: int, k: int, pad):
    """int32 ids for one bucket_hist_shapes case, drawn from generator g."""
    if pad is None:
        return torch.randint(0, k + 1, (n,), generator=g, device=dev, dtype=torch.int32)
    ids = torch.randint(0, k, (n,), generator=g, device=dev, dtype=torch.int32)
    if pad:
        ids[torch.rand(n, generator=g, device=dev) < pad] = k
    return ids


def relabel_field(torch, ops, cfg, dev):
    """The keys of relabel_gather's main-path call: one field of the ring
    relabel, every shard's R-MAT src ids with each row sorted ([nb, N], as
    `core/relabel.py::_relabel_field_ring` hands them over)."""
    eps = cfg.edges_per_shard
    field = torch.empty(cfg.nb, eps, dtype=torch.int32, device=dev)
    for bid in range(cfg.nb):
        field[bid] = torch.sort(ops.rmat_edges(cfg, bid * eps, eps, dev)[0]).values
    return field


def ring_segment(torch, field, B: int):
    """The keys of shard 0's sorted src row that fall in shard 1's pv chunk
    [B, 2B): one ring round's segment, the call the ring relabel made once
    per (round, shard) before it became one launch a field."""
    bounds = torch.tensor([B, 2 * B], dtype=torch.int32, device=field.device)
    lo, hi = torch.searchsorted(field[0], bounds).tolist()
    return field[0, lo:hi]


def join_segment(torch, g, dev, dcfg):
    """One pv-join segment of the disk tier (`core/chunks.py::gather_chunk`):
    the sorted keys that fall in one pv run (one shuffle slice, B / nb rows;
    edge_factor endpoints a vertex) and that run's block.  Returns (keys,
    block, base)."""
    rows = dcfg.bucket_size // dcfg.nb
    base = 5 * rows
    block = torch.randperm(dcfg.n, generator=g, device=dev)[:rows].to(torch.int32)
    keys = torch.sort(torch.randint(base, base + rows, (dcfg.edge_factor * rows,), generator=g,
                                    device=dev, dtype=torch.int32)).values
    return keys, block, base


def gather_bytes(torch, keys, B: int, base: int) -> int:
    """The bytes relabel_gather must move for `keys` against a table of B
    entries at `base`: each key read and each output written once, and each
    table entry that some key reads, once."""
    seen = torch.zeros(B, dtype=torch.bool, device=keys.device)
    for part in keys.reshape(-1).split(PLAIN_CHUNK):
        local = part.to(torch.int64) - base
        seen[local[(local >= 0) & (local < B)]] = True
    return 8 * keys.numel() + 4 * int(seen.sum())


def relabel_plain_rows(torch, ops, keys, pv, base):
    """relabel_gather_plain over `keys` in slices of PLAIN_CHUNK ids."""
    flat = keys.reshape(-1)
    return torch.cat([ops.relabel_gather_plain(c, pv, base)
                      for c in flat.split(PLAIN_CHUNK)]).reshape(keys.shape)


def merge_exchange(torch, ops, cfg, dev, g):
    """merge_runs' main-path input: redistribute_sorted's exchange of the
    full graph's R-MAT edges relabeled by a random permutation (as the
    pipeline relabels them, so hubs spread over the shards), each sender's
    row sorted by source, stably, at generate's capacity.  Returns (data,
    valid)."""
    from repro_torch.core.redistribute import default_capacity
    from repro_torch.distributed.collectives import capacity_all_to_all

    eps = cfg.edges_per_shard
    pv = torch.randperm(cfg.n, generator=g, device=dev).to(torch.int32)
    pair = torch.empty((cfg.nb, eps, 2), dtype=torch.int32, device=dev)
    for bid in range(cfg.nb):
        src, dst = ops.rmat_edges(cfg, bid * eps, eps, dev)
        src, order = torch.sort(pv[src.long()], stable=True)
        pair[bid, :, 0], pair[bid, :, 1] = src, pv[dst.long()][order]
        del src, dst, order
    del pv
    ex = capacity_all_to_all(pair, torch.div(pair[..., 0], cfg.bucket_size, rounding_mode="floor"),
                             capacity=default_capacity(cfg))
    return ex.data, ex.valid


def merge_case(torch, ops, cfg, dev, g, int_ops_per_s) -> dict:
    """merge_runs at the main path's shape (merge_exchange: nb receivers of
    nb x (2^25 + 8) slots, about 2^27 live each) against its plain version
    (the merge the port ran before the kernel), bit for bit; one launch a
    call; CUDA-event times of both; its byte bound (each live record read
    once, every slot written once: 8 and 9 bytes); the device ms of its four
    launches by kernel from one profiled call."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import attribution, roofline

    data, valid = merge_exchange(torch, ops, cfg, dev, g)
    nb, cap = data.shape[0], data.shape[2]
    live = int(valid.sum())
    got = ops.merge_runs(data, valid, cfg.n)
    want = ops.merge_runs_plain(data, valid, cfg.n)
    require(all(torch.equal(a, b) for a, b in zip(got, want)),
            "merge_runs [main] differs from its plain version")
    del got, want
    before = ops.LAUNCHES["merge_runs"]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ops.merge_runs(data, valid, cfg.n)
        torch.cuda.synchronize()
    require(ops.LAUNCHES["merge_runs"] == before + 1, "merge_runs: not one launch a call")
    bound_ms, bound_by = roofline.kernel_bound(8 * live + 9 * nb * nb * cap, 0, int_ops_per_s)
    line = {"kernel": "merge_runs",
            "case": f"main: {nb} receivers x {nb} x {cap} slots, {live} live, scale {cfg.scale}",
            "n": live, "max_abs_diff": 0,
            "kernel_ms": time_ms(lambda: ops.merge_runs(data, valid, cfg.n)),
            "plain_ms": time_ms(lambda: ops.merge_runs_plain(data, valid, cfg.n), reps=3),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "by_kernel_ms": {name[:60]: ms for ms, name, _ in attribution.device_rows(prof)
                             if "merge_" in name}}
    emit(line)
    del data, valid
    torch.cuda.empty_cache()
    return line


def cards_merge_exchange(torch, ops, cfg, dev, receivers: int):
    """merge_runs' input on a card of the four-card path: the exchange's
    rows for receivers 0 .. receivers-1 from all nb senders, each sender's
    R-MAT edges relabelled by a random permutation and sorted by source,
    stably, the live records a prefix of each (receiver, sender) slot range
    as `bucket_by_destination` leaves them.  Returns (data, valid)."""
    from repro_torch.core.redistribute import default_capacity

    eps, cap, B = cfg.edges_per_shard, default_capacity(cfg), cfg.bucket_size
    g = torch.Generator(device=dev).manual_seed(4321)
    pv = torch.randperm(cfg.n, generator=g, device=dev).to(torch.int32)
    data = torch.zeros((receivers, cfg.nb, cap, 2), dtype=torch.int32, device=dev)
    valid = torch.zeros((receivers, cfg.nb, cap), dtype=torch.bool, device=dev)
    bounds = torch.arange(receivers + 1, dtype=torch.int32, device=dev) * B
    for bid in range(cfg.nb):
        src, dst = ops.rmat_edges(cfg, bid * eps, eps, dev)
        src, order = torch.sort(pv[src.long()], stable=True)
        dst = pv[dst.long()][order]
        del order
        cuts = torch.searchsorted(src, bounds).tolist()
        for r in range(receivers):
            lo, hi = cuts[r], cuts[r + 1]
            require(hi - lo <= cap, f"sender {bid} has {hi - lo} records for receiver {r}, "
                    f"over the capacity {cap}")
            data[r, bid, :hi - lo, 0] = src[lo:hi]
            data[r, bid, :hi - lo, 1] = dst[lo:hi]
            valid[r, bid, :hi - lo] = True
        del src, dst
    return data, valid


def cards_kernels(torch, ops, cfg, dev, receivers: int, int_ops_per_s) -> dict:
    """The four-card path's kernel shapes on one card `dev`, each against
    its plain version, bit for bit; merge_runs one launch a call, timed.
    Returns merge_runs' line."""
    from repro_torch.launch import roofline

    eps = cfg.edges_per_shard
    with torch.cuda.device(dev):
        data, valid = cards_merge_exchange(torch, ops, cfg, dev, receivers)
        live, cap = int(valid.sum()), data.shape[2]
        before = ops.LAUNCHES["merge_runs"]
        got = ops.merge_runs(data, valid, cfg.n)
        require(ops.LAUNCHES["merge_runs"] == before + 1, "merge_runs: not one launch a call")
        got = [t.cpu() for t in got]            # the plain merge needs the card's memory
        torch.cuda.empty_cache()
        for r in range(receivers):
            want = ops.merge_runs_plain(data[r:r + 1], valid[r:r + 1], cfg.n)
            require(all(torch.equal(w[0], h[r].to(dev)) for w, h in zip(want, got)),
                    f"merge_runs [cards] receiver {r} differs from its plain version")
            del want
            torch.cuda.empty_cache()
        del got
        bound_ms, bound_by = roofline.kernel_bound(8 * live + 9 * receivers * cfg.nb * cap, 0,
                                                   int_ops_per_s)
        line = {"phase": "cards", "kernel": "merge_runs",
                "case": f"cards: {receivers} receivers x {cfg.nb} x {cap} slots, {live} live, "
                        f"scale {cfg.scale}, on {dev}",
                "n": live, "max_abs_diff": 0,
                "kernel_ms": time_ms(lambda: ops.merge_runs(data, valid, cfg.n)),
                "bound_ms": bound_ms, "bound_by": bound_by}
        emit(line)
        del data, valid
        torch.cuda.empty_cache()

        start = (cfg.nb - 1) * eps              # the last shard's block
        src, dst = ops.rmat_edges(cfg, start, eps, dev)
        for i in range(0, eps, PLAIN_CHUNK):
            k = min(PLAIN_CHUNK, eps - i)
            ps, pd = ops.rmat_edges_plain(cfg, start + i, k, dev)
            require(torch.equal(ps, src[i:i + k]) and torch.equal(pd, dst[i:i + k]),
                    f"rmat_edges [cards] differs from its plain version at {start + i}")
            del ps, pd
        emit({"phase": "cards", "kernel": "rmat_edges", "n": eps, "max_abs_diff": 0,
              "case": f"cards: one shard's block, scale {cfg.scale}, start {start}, on {dev}"})
        field = torch.stack([torch.sort(src).values, torch.sort(dst).values])
        del src, dst
        pv = torch.randperm(cfg.n, device=dev).to(torch.int32)
        got = ops.relabel_gather(field, pv, 0)
        require(torch.equal(got, relabel_plain_rows(torch, ops, field, pv, 0)),
                "relabel_gather [cards] differs from its plain version")
        emit({"phase": "cards", "kernel": "relabel_gather", "n": field.numel(), "max_abs_diff": 0,
              "case": f"cards: 2 rows of {eps} keys (that block's src and dst, each row "
                      f"sorted) against pv of {cfg.n} at base 0, on {dev}"})
        del field, pv, got
        torch.cuda.empty_cache()
    return line


def cards_main(torch, ops, generate, cfg, devices, label: str) -> dict:
    """One generate() over `devices`, launch counts set to 0 just before
    and read just after; no drops, m owned edges, every block on its card,
    each card's peak.  Returns the launch counts."""
    D, uniq = len(devices), list(dict.fromkeys(devices))
    for dev in uniq:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    res = generate(cfg, device=list(devices))
    for dev in uniq:
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    checks = {
        "dropped": int(res.dropped_relabel) == 0 and int(res.dropped_redistribute) == 0,
        "owned_edges": sum(int(x.sum()) for x in res.csr.num_edges) == cfg.m,
        "blocks_on_their_cards": all(
            len(blocks) == D and all(b.device == dev for b, dev in zip(blocks, devices))
            for blocks in (res.pv, res.src, res.dst, res.owned.src, res.csr.offv,
                           res.csr.adjv)),
        "launches": (counts["rmat_edges"] == cfg.nb and counts["relabel_gather"] == 2 * D
                     and counts["merge_runs"] == D and counts["bucket_hist"] > 0),
    }
    emit({"phase": label, "scale": cfg.scale, "nb": cfg.nb, "edges": cfg.m,
          "devices": [str(d) for d in devices], "wall_s": wall, "edges_per_s": cfg.m / wall,
          "peak_gib": [torch.cuda.max_memory_allocated(d) / 2**30 for d in uniq],
          "launches": counts, "checks": checks})
    require(all(checks.values()), f"{label}: {checks}")
    del res
    for dev in uniq:
        with torch.cuda.device(dev):
            torch.cuda.empty_cache()
    return counts


def cards_phase(torch, ops, generate, int_ops_per_s) -> dict:
    """The four-card path (module docstring); nothing with fewer than
    CARDS cards.  Returns the launch counts of its generate()."""
    from repro_torch.core.types import GraphConfig

    have = torch.cuda.device_count()
    if have < CARDS:
        emit({"phase": "cards", "skipped": f"{have} CUDA devices, the phase needs {CARDS}"})
        return {}
    devices = [torch.device("cuda", i) for i in range(CARDS)]
    cfg = GraphConfig(scale=CARDS_SCALE, nb=NB)
    cards_kernels(torch, ops, cfg, devices[-1], NB // CARDS, int_ops_per_s)
    counts = {label: cards_main(torch, ops, generate, cfg, devices, label)
              for label in ("cards_main_cold", "cards_main")}
    require(counts["cards_main_cold"] == counts["cards_main"],
            "the cold and warm four-card runs launched differently")
    return {"cards_main": counts["cards_main"]}


def cards_only() -> int:
    """`--cards`: the build and the cards phase alone."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.pipeline import generate
    from repro_torch.kernels import build, ops
    from repro_torch.launch import roofline

    print(nvidia_smi("name,power.limit"), flush=True)
    props = torch.cuda.get_device_properties(0)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    t = time.perf_counter()
    build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t})
    cards_phase(torch, ops, generate, roofline.int_ops_per_s(props.multi_processor_count,
                                                             clock_mhz))
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {ROOT}; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import validate as V
    from repro_torch.core.pipeline import generate, generate_baseline_hash, generate_edges
    from repro_torch.configs import get_config
    from repro_torch.core.types import GraphConfig
    from repro_torch.kernels import bucket, build, ops, sass
    from repro_torch.launch import roofline

    mark("start")
    dev = torch.device("cuda", 0)
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    props = torch.cuda.get_device_properties(dev)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    int_ops_per_s = roofline.int_ops_per_s(props.multi_processor_count, clock_mhz)
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "sms": props.multi_processor_count, "sm_clock_max_mhz": clock_mhz,
          "int_peak_ops_per_s": int_ops_per_s})

    t = time.perf_counter()
    graph_lib, attn_lib = build.build()
    build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "libraries": [p.name for p in build.build()]})
    attention_build_phase(sass, attn_lib)
    mark("build")
    main_cfg = GraphConfig(scale=MAIN_SCALE, nb=NB)
    eps, B, rounds = main_cfg.edges_per_shard, main_cfg.bucket_size, main_cfg.feistel_rounds
    listing = sass.listing(graph_lib)
    # bucket_hist: the register-bin instance of k 8 (main and walk shapes) and
    # the shared-memory one (k 64)
    hist_k8 = f"bucket_hist_kernelILi{bucket.plan(1, NB, 1).bins}E"
    hist_k64 = f"bucket_hist_kernelILi{bucket.plan(1, 64, 1).bins}E"
    ops_per_item = {
        "rmat_edges": sass.per_item_ops(listing, f"rmat_edges_kernelILi{MAIN_SCALE}E"),
        "rmat_edges_disk": sass.per_item_ops(listing, f"rmat_edges_kernelILi{DISK_MAIN_SCALE}E"),
        # the vector instances (the scalar ones run only where the input and
        # output sit at different offsets from a 16-byte boundary)
        "feistel_perm": sass.per_item_ops(listing, f"feistel_perm_kernelILi{rounds}ELb0E"),
        "relabel_gather": sass.per_item_ops(listing, "relabel_gather_kernelILb0E"),
        hist_k8: sass.per_item_ops(listing, hist_k8),
        hist_k64: sass.per_item_ops(listing, hist_k64),
    }
    for bins in (4, 16):      # serve_moe_ep's exchange (k 4); the k 16 register bins
        name = f"bucket_hist_kernelILi{bins}E"
        ops_per_item[name] = sass.per_item_ops(listing, name)
    usage = sass.ptxas_usage(graph_lib.with_suffix(".log").read_text())
    hist_usage = {re.search(r"bucket_hist_kernelI(.*?)EE", fn).group(1): u
                  for fn, u in usage.items() if "bucket_hist_kernel" in fn}
    emit({"phase": "sass", "listing": graph_lib.with_suffix(".sass").name,
          "per_item_ops": ops_per_item, "bucket_hist_ptxas": hist_usage})
    require(all(u.get("spill_stores") == 0 and u.get("spill_loads") == 0
                for u in hist_usage.values()), f"a bucket_hist instance spills: {hist_usage}")

    def max_abs(got, want) -> int:
        if isinstance(got, tuple):
            return max(max_abs(g, w) for g, w in zip(got, want))
        require(got.shape == want.shape and got.dtype == want.dtype,
                f"shape/dtype {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
        if got.numel() == 0:
            return 0
        return int((got.to(torch.int64) - want.to(torch.int64)).abs().max())

    # ------------------------------------------------------------------
    # 1. kernel phase
    # ------------------------------------------------------------------
    g = torch.Generator(device=dev).manual_seed(1234)
    summary, shapes = {}, {}

    def check_kernel(name, case, kernel_fn, plain_fn, timed=False, n_bytes=0, n_ops=0,
                     library_fn=None, size=None, main=True):
        """Kernel == plain version; timed cases also give times and a bound.
        The main path's case goes into the summary, other timed shapes into
        its "shapes" list."""
        got, want = kernel_fn(), plain_fn()
        err = max_abs(got, want)
        require(err == 0, f"{name} [{case}] differs from its plain version: max |diff| {err}")
        line = {"kernel": name, "case": case, "n": size, "max_abs_diff": err}
        if timed:
            line["kernel_ms"] = time_ms(kernel_fn)
            line["plain_ms"] = time_ms(plain_fn, reps=3)
            line["library_ms"] = time_ms(library_fn) if library_fn else None
            line["bound_ms"], line["bound_by"] = roofline.kernel_bound(n_bytes, n_ops,
                                                                       int_ops_per_s)
            if main:
                summary[name] = line
            else:
                shapes.setdefault(name, []).append(line)
        emit(line)
        del got, want

    # rmat_edges: one shard's block of the main graph (the main path's call), and
    # a count that is no multiple of the block with a start that wraps 2**32.
    start = 3 * eps
    check_kernel("rmat_edges", f"main: scale {main_cfg.scale}, one shard", lambda: ops.rmat_edges(main_cfg, start, eps, dev),
                 lambda: ops.rmat_edges_plain(main_cfg, start, eps, dev), timed=True,
                 n_bytes=8 * eps, n_ops=eps * ops_per_item["rmat_edges"], size=eps)
    for scale in (main_cfg.scale, VARIANT_SCALE):
        c = GraphConfig(scale=scale, nb=NB)
        wrap_start = (1 << 32) - 500_000
        check_kernel("rmat_edges", f"scale {scale}, start 2^32-500000, count 1000003",
                     lambda: ops.rmat_edges(c, wrap_start, 1_000_003, dev),
                     lambda: ops.rmat_edges_plain(c, wrap_start, 1_000_003, dev), size=1_000_003)

    # feistel_perm: relabel_recompute's call (every endpoint of the graph
    # at nbits = scale), shuffle_recompute's (arange(n)), and the edge widths.
    # The plain version runs in slices of PLAIN_CHUNK ids to bound its memory.
    key = 0x5EED1234 ^ 0xFE157E11

    def feistel_plain(v, nbits):
        return torch.cat([ops.feistel_perm_plain(c, key, nbits, rounds) for c in v.split(PLAIN_CHUNK)])

    x = torch.randint(0, main_cfg.n, (main_cfg.m,), generator=g, device=dev, dtype=torch.int32)
    check_kernel("feistel_perm", f"main: relabel_recompute, all m endpoints, nbits {main_cfg.scale}",
                 lambda: ops.feistel_perm(x, key, main_cfg.scale, rounds),
                 lambda: feistel_plain(x, main_cfg.scale), timed=True,
                 n_bytes=8 * x.numel(), n_ops=x.numel() * ops_per_item["feistel_perm"],
                 size=x.numel())
    del x
    ids = torch.arange(main_cfg.n, dtype=torch.int32, device=dev)
    check_kernel("feistel_perm", f"shuffle_recompute: arange(2^{main_cfg.scale}), nbits {main_cfg.scale}",
                 lambda: ops.feistel_perm(ids, key, main_cfg.scale, rounds),
                 lambda: feistel_plain(ids, main_cfg.scale), size=ids.numel())
    del ids
    for nbits in (1, 16, 31):
        xe = torch.randint(0, 1 << nbits, (1_000_003,), generator=g, device=dev, dtype=torch.int64)
        xe = xe.to(torch.int32)
        check_kernel("feistel_perm", f"nbits {nbits}, n 1000003",
                     lambda: ops.feistel_perm(xe, key, nbits, rounds),
                     lambda: feistel_plain(xe, nbits), size=xe.numel())

    # relabel_gather: the main path's call, one field of the ring relabel
    # ([nb, N] sorted rows against all of pv at base 0; in place on the main
    # path, here into a second tensor so that every timed call reads sorted
    # keys); a ring round's segment of shard 0 against the pv chunk of shard
    # 1 (base B > 0), the main path's call before it became one launch a
    # field; row 0 whole against that chunk (pass-through); an empty
    # segment.  pv is drawn from g exactly as the chunk once was, so every
    # later draw is unchanged.
    field = relabel_field(torch, ops, main_cfg, dev)
    pv = torch.randperm(main_cfg.n, generator=g, device=dev, dtype=torch.int64).to(torch.int32)
    chunk = pv[B:2 * B]
    out = torch.empty_like(field)
    check_kernel("relabel_gather", f"main: one ring relabel field, {NB} x {eps} keys against "
                 f"pv at base 0",
                 lambda: ops.relabel_gather(field, pv, 0, out=out),
                 lambda: relabel_plain_rows(torch, ops, field, pv, 0), timed=True,
                 n_bytes=gather_bytes(torch, field, main_cfg.n, 0),
                 n_ops=ops_per_item["relabel_gather"] * field.numel(), size=field.numel())
    del out
    seg = ring_segment(torch, field, B)
    check_kernel("relabel_gather", f"ring segment (the call before one launch a field), base B, "
                 f"{seg.numel()} keys",
                 lambda: ops.relabel_gather(seg, chunk, B),
                 lambda: ops.relabel_gather_plain(seg, chunk, B), timed=True, main=False,
                 n_bytes=gather_bytes(torch, seg, B, B),
                 n_ops=ops_per_item["relabel_gather"] * seg.numel(), size=seg.numel())
    odd = field[0, : 1_000_003]
    check_kernel("relabel_gather", "pass-through keys outside the chunk, n 1000003",
                 lambda: ops.relabel_gather(odd, chunk, B),
                 lambda: ops.relabel_gather_plain(odd, chunk, B), size=odd.numel())
    before = ops.LAUNCHES["relabel_gather"]
    empty = ops.relabel_gather(field[0, :0], chunk, B)
    require(empty.numel() == 0 and ops.LAUNCHES["relabel_gather"] == before,
            "an empty segment must launch nothing")
    emit({"kernel": "relabel_gather", "case": "empty segment", "n": 0, "max_abs_diff": 0})
    del field, pv, chunk, seg, odd

    # bucket_hist: the timed shapes (bucket_hist_shapes), each beside
    # bincount (which counts the pad value as one more bin), the last (no
    # ids) beside an empty kernel; k in {2, 8, 64} with the pad value mixed
    # in; two slices whose start is not 16-byte aligned; and a planted fault:
    # the kernel run without one id that counts must differ.
    for i, (case, n, k, pad) in enumerate(bucket_hist_shapes(eps)):
        dk = bucket_ids(torch, g, dev, n, k, pad)
        per_item = ops_per_item[f"bucket_hist_kernelILi{bucket.plan(1, k, 1).bins}E"]
        check_kernel("bucket_hist", case, lambda: ops.bucket_hist(dk, k),
                     lambda: ops.bucket_hist_plain(dk, k), timed=True, main=i == 0,
                     n_bytes=4 * (dk.numel() + k), n_ops=per_item * dk.numel(),
                     library_fn=lambda: torch.bincount(dk, minlength=k), size=dk.numel())
    empty_ms = time_ms(lambda: torch.cuda._sleep(0))
    shapes["bucket_hist"][-1]["empty_kernel_ms"] = empty_ms
    emit({"kernel": "bucket_hist", "case": "an empty kernel (torch.cuda._sleep(0)), the floor "
          "of the fixed cost", "empty_kernel_ms": empty_ms})
    # serve_moe's expert dispatch: the (token, choice) records' experts, k 64
    moe_cfg = get_config(MOE_ARCH)
    for case, tokens in (("an admission's prefill, 2048 tokens", 2048),
                         ("a decode wave, 8 slots", SERVE_SLOTS)):
        n, k = tokens * moe_cfg.experts_per_tok, moe_cfg.num_experts
        dk = torch.randint(0, k, (n,), generator=g, device=dev, dtype=torch.int32)
        check_kernel("bucket_hist", f"serve_moe dispatch, {case}: {n} ids, k {k}",
                     lambda: ops.bucket_hist(dk, k), lambda: ops.bucket_hist_plain(dk, k),
                     timed=True, main=False, n_bytes=4 * (n + k), n_ops=n * ops_per_item[hist_k64],
                     library_fn=lambda: torch.bincount(dk, minlength=k), size=n)
    # serve_moe_ep's expert-parallel dispatch (moe_ep_hist_shapes)
    for case, n, k, pad in moe_ep_hist_shapes(moe_cfg):
        dk = bucket_ids(torch, g, dev, n, k, pad)
        per_item = ops_per_item[f"bucket_hist_kernelILi{bucket.plan(1, k, 1).bins}E"]
        check_kernel("bucket_hist", case, lambda: ops.bucket_hist(dk, k),
                     lambda: ops.bucket_hist_plain(dk, k), timed=True, main=False,
                     n_bytes=4 * (n + k), n_ops=n * per_item,
                     library_fn=lambda: torch.bincount(dk, minlength=k), size=n)
    for k in (2, 8, 64):
        dk = torch.randint(0, k + 1, (1_000_003,), generator=g, device=dev, dtype=torch.int32)
        check_kernel("bucket_hist", f"k {k} with pad value k, n 1000003",
                     lambda: ops.bucket_hist(dk, k), lambda: ops.bucket_hist_plain(dk, k),
                     size=dk.numel())
    for offset in (1, 3):
        part = dk[offset:]
        require(part.data_ptr() % 16 != 0, "the slice was meant to start off a 16-byte boundary")
        check_kernel("bucket_hist", f"k 64, slice from offset {offset} (not 16-byte aligned)",
                     lambda: ops.bucket_hist(part, 64), lambda: ops.bucket_hist_plain(part, 64),
                     size=part.numel())
    dk[0] = 5
    fault = max_abs(ops.bucket_hist(dk[1:], 64), ops.bucket_hist_plain(dk, 64))
    require(fault > 0, "bucket_hist: a planted fault (one id skipped) passes the comparison")
    emit({"kernel": "bucket_hist", "case": "planted fault: the first id (5) skipped",
          "max_abs_diff": fault, "rejected": True})
    del dk, part

    summary["merge_runs"] = merge_case(torch, ops, main_cfg, dev, g, int_ops_per_s)

    # the disk tier's chunk shapes (the hooks of core/chunks.py): one
    # external_main chunk (2^21 edges) for rmat_edges and for bucket_hist (a
    # partition's counts, k 8); one external_recompute chunk (2^20
    # endpoints, nbits 18) for feistel_perm; one pv-join segment for
    # relabel_gather (the sorted keys that fall in one pv run: a run holds
    # one shuffle slice, B / nb rows, and the graph has edge_factor
    # endpoints per vertex)
    dcfg = GraphConfig(scale=DISK_MAIN_SCALE, nb=NB)
    C = DISK_MAIN_CHUNK
    check_kernel("rmat_edges", f"disk tier: one chunk, 2^21 edges, scale {DISK_MAIN_SCALE}",
                 lambda: ops.rmat_edges(dcfg, 5 * C, C, dev),
                 lambda: ops.rmat_edges_plain(dcfg, 5 * C, C, dev), timed=True, main=False,
                 n_bytes=8 * C, n_ops=C * ops_per_item["rmat_edges_disk"], size=C)
    xr = torch.randint(0, 1 << DISK_RECOMPUTE_SCALE, (DISK_RECOMPUTE_CHUNK,), generator=g,
                       device=dev, dtype=torch.int32)
    check_kernel("feistel_perm", f"disk tier: one chunk, 2^20 ids, nbits {DISK_RECOMPUTE_SCALE}",
                 lambda: ops.feistel_perm(xr, key, DISK_RECOMPUTE_SCALE, rounds),
                 lambda: ops.feistel_perm_plain(xr, key, DISK_RECOMPUTE_SCALE, rounds),
                 timed=True, main=False, n_bytes=8 * xr.numel(),
                 n_ops=xr.numel() * ops_per_item["feistel_perm"], size=xr.numel())
    dk = torch.randint(0, NB, (C,), generator=g, device=dev, dtype=torch.int32)
    check_kernel("bucket_hist", "disk tier: one chunk's partition, 2^21 ids, k 8",
                 lambda: ops.bucket_hist(dk, NB), lambda: ops.bucket_hist_plain(dk, NB),
                 timed=True, main=False, n_bytes=4 * (C + NB), n_ops=C * ops_per_item[hist_k8],
                 library_fn=lambda: torch.bincount(dk, minlength=NB), size=C)
    seg, block, base = join_segment(torch, g, dev, dcfg)
    check_kernel("relabel_gather", f"disk tier: one pv-join segment, {seg.numel()} keys, "
                 f"{block.numel()} rows",
                 lambda: ops.relabel_gather(seg, block, base),
                 lambda: ops.relabel_gather_plain(seg, block, base), timed=True, main=False,
                 n_bytes=gather_bytes(torch, seg, block.numel(), base),
                 n_ops=ops_per_item["relabel_gather"] * seg.numel(), size=seg.numel())
    # the floor under the disk tier's two small calls: an empty kernel
    empty_ms = time_ms(lambda: torch.cuda._sleep(0))
    for name in ("feistel_perm", "relabel_gather"):
        shapes[name][-1]["empty_kernel_ms"] = empty_ms
    emit({"kernel": "feistel_perm, relabel_gather", "case": "an empty kernel beside the disk "
          "tier's calls (torch.cuda._sleep(0))", "empty_kernel_ms": empty_ms})
    del xr, dk, block, seg
    flash = flash_phase(torch, ops, dev, g, time_ms)
    shapes["flash_attention_prefill"] = [flash[c] for c in "jnpqru"]
    shapes["flash_attention_decode"] = [flash[c] for c in "klmostv"]
    torch.cuda.empty_cache()
    mark("kernels")

    # ------------------------------------------------------------------
    # 2. variant phase: card == CPU for every variant at scale 16
    # ------------------------------------------------------------------
    combos = [(sv, rv, cv) for sv in ("paper", "argsort") for rv in ("ring", "alltoall")
              for cv in ("sorted", "scatter")] + [("recompute", "ring", cv)
                                                  for cv in ("sorted", "scatter")]
    t_var = time.perf_counter()
    for sv, rv, cv in combos:
        c = GraphConfig(scale=VARIANT_SCALE, nb=NB, relabel_variant=rv, csr_variant=cv,
                        capacity_factor=6.0 if rv == "alltoall" else 2.0)
        on_card = generate(c, shuffle_variant=sv, device=dev)
        on_cpu = generate(c, shuffle_variant=sv, device="cpu")
        pairs = {"pv": (on_card.pv, on_cpu.pv), "src": (on_card.src, on_cpu.src),
                 "dst": (on_card.dst, on_cpu.dst), "owned_src": (on_card.owned.src, on_cpu.owned.src),
                 "owned_dst": (on_card.owned.dst, on_cpu.owned.dst),
                 "owned_valid": (on_card.owned.valid, on_cpu.owned.valid),
                 "offv": (on_card.csr.offv, on_cpu.csr.offv), "adjv": (on_card.csr.adjv, on_cpu.csr.adjv),
                 "num_edges": (on_card.csr.num_edges, on_cpu.csr.num_edges),
                 "dropped_relabel": (on_card.dropped_relabel, on_cpu.dropped_relabel),
                 "dropped_redistribute": (on_card.dropped_redistribute, on_cpu.dropped_redistribute)}
        for f, (a, b) in pairs.items():
            require(torch.equal(a.cpu(), b), f"variant {sv}/{rv}/{cv}: {f} differs card vs CPU")
        emit({"phase": "variant", "shuffle": sv, "relabel": rv, "csr": cv, "scale": VARIANT_SCALE,
              "nb": NB, "equal": True, "dropped_redistribute": int(on_cpu.dropped_redistribute),
              "dropped_relabel": int(on_cpu.dropped_relabel)})
        del on_card, on_cpu
    c = GraphConfig(scale=VARIANT_SCALE, nb=NB)
    hc, hd = generate_baseline_hash(c, device=dev)
    pc, pd = generate_baseline_hash(c, device="cpu")
    require(torch.equal(hc.cpu(), pc) and torch.equal(hd.cpu(), pd), "baseline hash differs")
    emit({"phase": "variant", "baseline_hash": True, "scale": VARIANT_SCALE, "equal": True,
          "seconds": time.perf_counter() - t_var})
    del hc, hd, pc, pd
    walks_parity_phase(torch, dev)
    torch.cuda.empty_cache()
    mark("variants, walks_parity")

    # ------------------------------------------------------------------
    # 3. main phase: the full-size graph twice, first with an empty
    # allocator cache (cold: every block is fetched from the driver), then
    # warm; then its recompute variant (warm)
    # ------------------------------------------------------------------
    main_counts = {}

    def run_main(label, shuffle_variant, cold, keep_csr=False):
        """Launch counts of one generate(), and with keep_csr its CSR (on the
        host, so that validation has the card's memory)."""
        torch.cuda.synchronize()
        if cold:
            torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        marks = []

        def hook(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            marks.append((name, e))

        ops.reset_launches()
        t0 = time.perf_counter()
        hook("start")
        res = generate(main_cfg, shuffle_variant=shuffle_variant, device=dev, phase_hook=hook)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated(dev)
        phases = {name: marks[i - 1][1].elapsed_time(e) for i, (name, e) in enumerate(marks) if i}
        total_ms = sum(phases.values())
        line = {"phase": label, "cold": cold, "scale": main_cfg.scale, "nb": main_cfg.nb, "edges": main_cfg.m,
                "shuffle": shuffle_variant, "relabel": main_cfg.relabel_variant,
                "csr": main_cfg.csr_variant, "phase_ms": phases, "total_ms": total_ms,
                "wall_s": wall, "edges_per_s": main_cfg.m / (total_ms / 1e3),
                "peak_bytes": peak, "peak_gib": peak / 2**30, "launches": counts}
        require(int(res.dropped_redistribute) == 0 and int(res.dropped_relabel) == 0,
                f"{label}: dropped records")
        t_val = time.perf_counter()
        checks = {"permutation": V.check_permutation(res.pv),
                  "ownership": V.check_ownership(res.owned.src, res.owned.valid, main_cfg)}
        csr_checks = V.check_csr(res.csr, res.owned, main_cfg)
        checks.update({f"csr_{k}": v for k, v in csr_checks.items()})
        kept = type(res.csr)(*(t.cpu() for t in res.csr)) if keep_csr else None
        owned_total = int(res.csr.num_edges.sum())
        checks["edge_count"] = owned_total == main_cfg.m
        pv, new_src, new_dst = res.pv, res.src, res.dst
        del res
        src, dst = generate_edges(main_cfg, dev)
        checks["relabel_multiset"] = V.check_relabel(src, dst, new_src, new_dst, pv)
        del src, dst, pv, new_src, new_dst
        torch.cuda.synchronize()
        line["validate_s"] = time.perf_counter() - t_val
        line["checks"] = checks
        line["peak_gib_with_validation"] = torch.cuda.max_memory_allocated(dev) / 2**30
        emit(line)
        require(all(checks.values()), f"{label}: validation failed {checks}")
        return counts, kept

    main_counts["main_cold"], _ = run_main("main_cold", "paper", cold=True)
    main_counts["main"], main_csr = run_main("main", "paper", cold=False, keep_csr=True)
    main_counts["main_recompute"], _ = run_main("main_recompute", "recompute", cold=False)
    mark("main (cold, warm, recompute)")
    require(main_counts["main_cold"] == main_counts["main"], "cold and warm runs launched differently")
    for name in ("rmat_edges", "relabel_gather", "bucket_hist"):
        require(main_counts["main"][name] > 0, f"main path never launched {name}")
    require(main_counts["main"]["relabel_gather"] == 2,
            f"the ring relabel launched relabel_gather {main_counts['main']['relabel_gather']} "
            "times, not once per field")
    require(main_counts["main_recompute"]["feistel_perm"] > 0,
            "recompute main path never launched feistel_perm")
    for label in ("main", "main_recompute"):
        require(main_counts[label]["merge_runs"] == 1,
                f"{label} launched merge_runs {main_counts[label]['merge_runs']} times, not once")
    torch.cuda.empty_cache()
    main_counts["walks_main"] = walks_main_phase(torch, ops, dev, main_cfg, main_csr)
    torch.cuda.empty_cache()
    loader_main_phase(torch, dev, main_cfg, main_csr)
    del main_csr
    torch.cuda.empty_cache()
    mark("walks_main, walks_trace, loader_main")
    main_counts.update(cards_phase(torch, ops, generate, int_ops_per_s))
    mark("cards")

    # ------------------------------------------------------------------
    # 4. the disk tier: card == CPU for every driver and variant, and
    # beside them for the cluster runtime's host processes; then the
    # out-of-core main run, the partitioned communication-free run, and
    # the out-of-core main configuration on two card hosts
    # ------------------------------------------------------------------
    cluster_parity_phase(lambda: external_parity_phase(torch, dev))
    mark("external_parity, cluster_parity")
    main_counts["external_main"], external_csr = external_main_phase(torch, ops, dev)
    torch.cuda.empty_cache()
    mark("external_main")
    main_counts["external_recompute"] = external_recompute_phase(torch, ops, dev)
    mark("external_recompute")
    main_counts["cluster_main"] = cluster_main_phase(torch, ops, dev, external_csr)
    mark("cluster_main")

    # ------------------------------------------------------------------
    # 5-9. the serve path: card == CPU on the smoke configs, then the
    # full-width Engines (dense, MoE + MLA, ssm, hybrid), then encdec and
    # vlm through prefill + decode_step
    # ------------------------------------------------------------------
    serve_parity_phase(torch, ops, dev)
    torch.cuda.empty_cache()
    mark("serve_parity")
    for label, arch in (("serve_main", SERVE_ARCH), ("serve_moe", MOE_ARCH),
                        ("serve_ssm", SSM_ARCH), ("serve_hybrid", HYBRID_ARCH)):
        main_counts[label], served, params = serve_phase(torch, ops, dev, get_config(arch), label)
        torch.cuda.empty_cache()
        mark(label)
        if label == "serve_moe":     # the same weights over 4 expert shards
            main_counts.update(serve_moe_ep_phase(torch, ops, dev, params, served))
            torch.cuda.empty_cache()
            mark("serve_moe_ep")
        del served, params
    for label, arch in (("encdec_main", ENCDEC_ARCH), ("vlm_main", VLM_ARCH)):
        main_counts[label] = generate_phase(torch, ops, dev, arch, label)
        torch.cuda.empty_cache()
        mark(label)

    # ------------------------------------------------------------------
    # 10. the train path: card == CPU on the smokes, internlm2-1.8b at full
    # width on graph-walk batches, launch/train.py's out-of-core route
    # ------------------------------------------------------------------
    train_parity_phase(torch, ops, dev)
    torch.cuda.empty_cache()
    mark("train_parity")
    for label, phase in (("train_main", train_main_phase),
                         ("train_external", train_external_phase)):
        main_counts[label] = phase(torch, ops, dev)
        torch.cuda.empty_cache()
        mark(label)
    main_counts.update(train_moe_ep_phase(torch, ops, dev))
    torch.cuda.empty_cache()
    mark("train_moe_ep")
    dryrun_phase()
    mark("dryrun")
    emit({"phase": "timeline", "seconds": {name: t - _MARKS[i - 1][1]
                                           for i, (name, t) in enumerate(_MARKS) if i},
          "total_s": _MARKS[-1][1] - _MARKS[0][1]})

    sources = {
        "rmat_edges": "src/repro/kernels/rmat.py:85",
        "feistel_perm": "src/repro/kernels/rmat.py:137",
        "relabel_gather": "src/repro/kernels/relabel_gather.py:54",
        "bucket_hist": "src/repro/kernels/bucket.py:49",
        "merge_runs": "none (the plain merge_sorted_runs rounds, "
                      "src/repro/distributed/collectives.py:222)",
        "flash_attention": "src/repro/kernels/flash_attention.py:114",
    }
    # flash_attention's two kernels, each with the numbers of its main case
    summary["flash_attention_decode"] = flash["b"]
    summary["flash_attention_prefill"] = flash["a"]
    sources["flash_attention_decode"] = sources["flash_attention_prefill"] = \
        sources.pop("flash_attention")
    kernels = []
    for name in [n for n in build.KERNELS if n != "flash_attention"] + list(build.FLASH_KERNELS):
        s = summary[name]
        by_path = {label: counts[name] for label, counts in main_counts.items()
                   if label != "main_cold"}
        launches = sum(by_path.values())
        require(launches > 0, f"{name} was launched no time on the main paths")
        entry = {"name": name, "route": "cuda",
                 "source": "src/repro_torch/kernels/csrc/" + (
                     "attention_kernels.cu" if name.startswith("flash") else "graph_kernels.cu"),
                 "replaces": sources[name], "launches": launches, "launches_by_path": by_path,
                 "max_abs_err": s["max_abs_diff"], "ms": s["kernel_ms"],
                 "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                 "bound_by": s["bound_by"], "library_ms": s["library_ms"]}
        if name.startswith("flash"):
            entry.update({k: s[k] for k in ("case", "row_error", "tolerance")})
        if name in shapes:
            entry["case"] = s["case"]
            entry["shapes"] = [{"case": x["case"], "max_abs_err": x["max_abs_diff"],
                                "ms": x["kernel_ms"], "plain_ms": x["plain_ms"],
                                "bound_ms": x["bound_ms"], "bound_by": x["bound_by"],
                                "library_ms": x["library_ms"],
                                **{k: x[k] for k in ("empty_kernel_ms", "row_error") if k in x}}
                               for x in shapes[name]]
        kernels.append(entry)
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


def walks_parity_phase(torch, dev):
    """The walk corpus at the variant scale: distributed_walks on the
    scale-16 nb-8 graph, length 80, 256 walkers per shard, capacity factor
    4 (half the walkers dropped at the first hop), on the card (whose every hop runs the bucket_hist kernel once per
    shard) and on the CPU, equal bit for bit; then the WalkLoader's batches
    0-2, sampled on the card and on the CPU, equal."""
    from repro_torch.core.pipeline import generate
    from repro_torch.core.types import GraphConfig
    from repro_torch.data import LoaderConfig, WalkLoader, distributed_walks
    from repro_torch.kernels import ops

    cfg = GraphConfig(scale=VARIANT_SCALE, nb=NB)
    t = time.perf_counter()
    got = {}
    for d in (dev, torch.device("cpu")):
        csr = generate(cfg, device=d).csr
        before = ops.LAUNCHES["bucket_hist"]
        walks = distributed_walks(cfg, csr.offv, csr.adjv, length=WALK_LENGTH, seed=WALK_SEED,
                                  walkers_per_shard=WALK_PARITY_WALKERS,
                                  capacity_factor=WALK_PARITY_CAPACITY_FACTOR)
        launched = ops.LAUNCHES["bucket_hist"] - before
        require(launched == (WALK_LENGTH * NB if d.type == "cuda" else 0),
                f"walks_parity: {launched} bucket_hist launches on {d}")
        loader = WalkLoader(cfg, csr, LoaderConfig(), device=d)
        got[d.type] = walks, [loader.batch(step) for step in range(3)]
    (walks_card, batches_card), (walks_cpu, batches_cpu) = got["cuda"], got["cpu"]
    for f, a, b in zip(("hist", "valid", "wid", "dropped"), walks_card, walks_cpu):
        require(a.is_cuda and torch.equal(a.cpu(), b), f"walks_parity: {f} differs card vs CPU")
    for step, (a, b) in enumerate(zip(batches_card, batches_cpu)):
        for f in ("tokens", "labels"):
            require(a[f].is_cuda and torch.equal(a[f].cpu(), b[f]),
                    f"walks_parity: WalkLoader batch {step} {f} differs card vs CPU")
    emit({"phase": "walks_parity", "scale": VARIANT_SCALE, "nb": NB, "length": WALK_LENGTH,
          "walkers_per_shard": WALK_PARITY_WALKERS, "capacity_factor": WALK_PARITY_CAPACITY_FACTOR,
          "live_walks": int(walks_cpu[1].sum()), "dropped": int(walks_cpu[3]),
          "walks_equal": True, "loader_batches_equal": 3, "seconds": time.perf_counter() - t})


def _mul32(x, c):
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a uint32 constant c,
    in 16-bit halves so that no int64 product overflows."""
    return (x * (c & 0xFFFF) + (((x * (c >> 16)) & 0xFFFF) << 16)) & 0xFFFFFFFF


def _mix32(x):
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _walk_rand(seed, walker, step):
    """The walk RNG from its definition: mix32(mix32(w ^ seed) + step * golden)."""
    s = seed & 0xFFFFFFFF
    return _mix32((_mix32(walker ^ s) + ((step * 0x9E3779B9) & 0xFFFFFFFF)) & 0xFFFFFFFF)


def replay_walks(torch, hist, wid, offv, adjv, cfg, walkers, seed):
    """Mismatches of every live walk against a replay on the card that shares
    no code with distributed_walks: each walker id once, each start from the
    start rule, and each hop t+1 recomputed from hop t with the walk RNG and
    the CSR row of vertex t, or the sink teleport rand % n."""
    B, n = cfg.bucket_size, cfg.n
    offv = offv.view(cfg.nb, B + 1).long()
    adjv = adjv.view(cfg.nb, -1)
    w = wid.long() & 0xFFFFFFFF
    bad = (torch.sort(w).values != torch.arange(cfg.nb * walkers, device=w.device)).sum()
    start = (w // walkers) * B + _walk_rand(seed ^ 0xA5A5, w, 0) % B
    bad += (hist[:, 0].long() != start).sum()
    for t in range(hist.shape[1] - 1):
        v = hist[:, t].long()
        shard, row = v // B, v % B
        first = offv[shard, row]
        deg = offv[shard, row + 1] - first
        r = _walk_rand(seed, w, t + 1)
        idx = (first + r % deg.clamp(min=1)).clamp(max=adjv.shape[1] - 1)
        want = torch.where(deg > 0, adjv[shard, idx].long(), r % n)
        bad += (hist[:, t + 1].long() != want).sum()
    return int(bad)


def walks_main_phase(torch, ops, dev, cfg, csr_host):
    """distributed_walks on the main graph (scale 26, nb 8): 2^20 walkers per
    shard, length 80, capacity factor 8, seed 0; launch counts set to 0 just
    before and read just after; zero drops, every hop replayed on the card,
    and length x nb bucket_hist launches.  Returns the launch counts."""
    from repro_torch.data import distributed_walks

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    offv, adjv = csr_host.offv.to(dev), csr_host.adjv.to(dev)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ops.reset_launches()
    t0 = time.perf_counter()
    a.record()
    hist, valid, wid, dropped = distributed_walks(
        cfg, offv, adjv, length=WALK_LENGTH, seed=WALK_SEED, walkers_per_shard=WALK_WALKERS,
        capacity_factor=WALK_CAPACITY_FACTOR)
    b.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    walk_ms = a.elapsed_time(b)
    peak = torch.cuda.max_memory_allocated(dev)
    live = int(valid.sum())
    line = {"phase": "walks_main", "scale": cfg.scale, "nb": cfg.nb, "length": WALK_LENGTH,
            "walkers_per_shard": WALK_WALKERS, "capacity_factor": WALK_CAPACITY_FACTOR,
            "seed": WALK_SEED, "rows": hist.shape[0], "live_walks": live,
            "dropped": int(dropped), "walk_ms": walk_ms, "wall_s": wall,
            "hops_per_s": live * WALK_LENGTH / (walk_ms / 1e3),
            "tokens": live * (WALK_LENGTH + 1), "peak_bytes": peak, "peak_gib": peak / 2**30,
            "bucket_hist_launches": counts["bucket_hist"], "launches": counts}
    require(int(dropped) == 0, f"walks_main: {int(dropped)} walkers dropped")
    require(live == cfg.nb * WALK_WALKERS, f"walks_main: {live} live walks")
    require(counts["bucket_hist"] == WALK_LENGTH * cfg.nb,
            f"walks_main: {counts['bucket_hist']} bucket_hist launches != length x nb")
    t = time.perf_counter()
    line["replay_mismatches"] = replay_walks(torch, hist[valid], wid[valid], offv, adjv, cfg,
                                             WALK_WALKERS, WALK_SEED)
    line["replay_s"] = time.perf_counter() - t
    emit(line)
    require(line["replay_mismatches"] == 0, "walks_main: the replay disagrees with the walks")
    del hist, valid, wid
    walks_trace(torch, cfg, offv, adjv)
    return counts


def walks_trace(torch, cfg, offv, adjv):
    """walks_main's walk again, under torch.profiler: the card's busy share
    (kernel and copy time over the wall time; the profiler's host cost makes
    the idle share an upper bound) and the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import distributed_walks
    from repro_torch.launch import attribution

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        distributed_walks(cfg, offv, adjv, length=WALK_LENGTH, seed=WALK_SEED,
                          walkers_per_shard=WALK_WALKERS, capacity_factor=WALK_CAPACITY_FACTOR)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    device_ms = sum(ms for ms, _, _ in attribution.device_rows(prof))
    require(device_ms > 0, "walks_trace: the profiler saw no device time")
    emit({"phase": "walks_trace", "hops": WALK_LENGTH, "wall_ms": wall_ms, "device_ms": device_ms,
          "busy_share": device_ms / wall_ms, "top_device_ms": top_device_ms(attribution, prof, 14)})


def loader_main_phase(torch, dev, cfg, csr_host):
    """WalkLoader over the main graph's CSR on the card (scale 26, nb 8): the
    time to assemble the global CSR there, one batch's time (LoaderConfig's
    defaults) and the peak memory; the global CSR is held shard by shard to
    the sharded one, and a batch is a pure function of its step."""
    from repro_torch.data import LoaderConfig, WalkLoader

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    csr = type(csr_host)(*(t.to(dev) for t in csr_host))
    torch.cuda.synchronize()
    csr_bytes = torch.cuda.memory_allocated(dev)
    lcfg = LoaderConfig()
    a, b, c = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    a.record()
    loader = WalkLoader(cfg, csr, lcfg, device=dev)
    b.record()
    batch = loader.batch(0)
    c.record()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    B, nb = cfg.bucket_size, cfg.nb
    offv_s, adjv_s = csr.offv.view(nb, B + 1).long(), csr.adjv.view(nb, -1)
    cnt = csr.num_edges.long().tolist()
    require(loader.offv.is_cuda and loader.adjv.is_cuda, "loader_main: the CSR left the card")
    require(loader.offv.numel() == cfg.n + 1 and loader.adjv.numel() == sum(cnt) == cfg.m,
            "loader_main: the global CSR has the wrong size")
    base = 0
    for s_ in range(nb):
        require(torch.equal(loader.offv[s_ * B:(s_ + 1) * B + 1], offv_s[s_] + base)
                and torch.equal(loader.adjv[base:base + cnt[s_]], adjv_s[s_, :cnt[s_]]),
                f"loader_main: shard {s_} of the global CSR differs from the sharded one")
        base += cnt[s_]
    again = loader.batch(0)
    tokens, labels = batch["tokens"], batch["labels"]
    require(tokens.is_cuda and tuple(tokens.shape) == (lcfg.batch_size, lcfg.seq_len)
            and torch.equal(labels[:, :-1], tokens[:, 1:])
            and bool(((tokens >= 0) & (tokens < lcfg.vocab)).all())
            and all(torch.equal(batch[f], again[f]) for f in ("tokens", "labels")),
            "loader_main: a batch is malformed or not a function of its step")
    emit({"phase": "loader_main", "scale": cfg.scale, "nb": nb, "batch_size": lcfg.batch_size,
          "seq_len": lcfg.seq_len, "build_ms": a.elapsed_time(b), "batch_ms": b.elapsed_time(c),
          "sharded_csr_gib": csr_bytes / 2**30, "peak_gib": peak / 2**30})
    del loader, csr, batch, again


# ----------------------------------------------------------------------
# the disk tier: StreamingGenerator / PartitionedGenerator
# ----------------------------------------------------------------------


def tree_shas(root) -> dict:
    """{path under root: sha256} of every .npy file a generator left: the CSR
    bucket files, pv.npy, and the stores no phase freed."""
    import hashlib

    out = {}
    for path in sorted(Path(root).rglob("*.npy")):
        out[str(path.relative_to(root))] = hashlib.sha256(path.read_bytes()).hexdigest()
    return out


def disk_run(driver: str, fields: dict, workdir: str, device, walks: bool = False) -> dict:
    """One disk-tier run (the repo's entry points, as a user calls them):
    its seconds, per-phase report, ledger, peak rows, launch counts (this
    process's and its workers') and the sha256 of every file it left.  With
    `walks`, a walk corpus over its CSR follows (its own seconds and launch
    counts; its shards are among the files hashed): ExternalWalkLoader's
    external_walks and the sha256 of its first batches after a streaming
    run, the generator's walk_corpus after a partitioned one."""
    import hashlib

    import numpy as np

    from repro_torch.core.external import StreamingGenerator
    from repro_torch.core.phases import PartitionedGenerator
    from repro_torch.core.types import GraphConfig
    from repro_torch.data import ExternalWalkLoader, LoaderConfig
    from repro_torch.kernels import ops

    cfg = GraphConfig(**fields)
    ops.reset_launches()
    t = time.perf_counter()
    out = {}
    if driver == "streaming":
        gen = StreamingGenerator(cfg, workdir, device=device)
        gen.run()
        orch = gen.orchestrator
        out.update(seconds=time.perf_counter() - t, launches=dict(ops.LAUNCHES))
        if walks:
            ops.reset_launches()
            t = time.perf_counter()
            loader = ExternalWalkLoader(cfg, workdir, LoaderConfig(seq_len=DISK_WALK_LENGTH),
                                        num_walkers=DISK_WALKERS, checkpoint=False,
                                        device=device)
            digest = hashlib.sha256()
            for step in range(DISK_WALK_BATCHES):
                for v in loader.batch(step).values():
                    digest.update(np.ascontiguousarray(v.cpu().numpy()).tobytes())
            out.update(walk_seconds=time.perf_counter() - t,
                       walk_launches=dict(ops.LAUNCHES), batches_sha=digest.hexdigest())
    else:
        with PartitionedGenerator(cfg, workdir, max_workers=DISK_WORKERS, device=device) as gen:
            gen.run(cfg.csr_variant)
            orch = gen.orchestrator
            out.update(seconds=time.perf_counter() - t, launches=dict(ops.LAUNCHES))
            if walks:
                ops.reset_launches()
                t = time.perf_counter()
                gen.walk_corpus(DISK_WALKERS, DISK_WALK_LENGTH)
                out.update(walk_seconds=time.perf_counter() - t,
                           walk_launches=dict(ops.LAUNCHES))
    return {**out, "report": orch.report(), "ledger": gen.ledger.as_dict(),
            "peak_rows": gen.gauge.peak_rows, "shas": tree_shas(workdir)}


def disk_run_child(argv) -> int:
    """`chip_smoke.py --disk-run DRIVER FIELDS_JSON WORKDIR DEVICE WALKS`: one
    external_parity run in a process of its own (WALKS 1 adds the walk
    corpus); its result is the last line of its standard output."""
    sys.path.insert(0, str(ROOT / "src"))
    driver, fields, workdir, device = argv[0], json.loads(argv[1]), argv[2], argv[3]
    res = disk_run(driver, fields, workdir, device, walks=argv[4] == "1")
    print(json.dumps({k: v for k, v in res.items() if k != "report"}), flush=True)
    return 0


class ChildRuns:
    """`chip_smoke.py` child processes (`--disk-run`, `--cluster-run`), one
    per (name, side, args), all started together with their output in
    `tmp`, CUDA hidden from the CPU side's; each in a session of its own, so
    that its process group holds what it starts (a cluster run's hosts).
    `results()` waits for each (at most `timeout` seconds from the start)
    and returns {(name, side): the JSON of its last line}, failing on a
    nonzero exit; leaving the block kills every group still running."""

    def __init__(self, label, tmp, jobs, timeout=None):
        self.label, self.tmp, self.jobs, self.timeout = label, tmp, jobs, timeout
        self.procs = []

    def __enter__(self):
        env = dict(os.environ, OMP_NUM_THREADS="1")
        self.t = time.perf_counter()
        try:
            for name, side, args in self.jobs:
                out = open(Path(self.tmp) / f"{name}-{side}.log", "w+")
                child_env = env if side == "cuda" else dict(env, CUDA_VISIBLE_DEVICES="")
                self.procs.append((name, side, out, subprocess.Popen(
                    [sys.executable, str(ROOT / "chip_smoke.py"), *args], stdout=out,
                    stderr=subprocess.STDOUT, env=child_env, start_new_session=True)))
        except BaseException:
            self.__exit__()
            raise
        return self

    def results(self) -> dict:
        out = {}
        for name, side, log, proc in self.procs:
            left = None if self.timeout is None else self.timeout - (time.perf_counter() - self.t)
            proc.wait(timeout=None if left is None else max(1.0, left))
            log.seek(0)
            text = log.read()
            require(proc.returncode == 0, f"{self.label}: {name} on {side} failed "
                    f"({proc.returncode}):\n{text[-3000:]}")
            out[(name, side)] = json.loads(text.strip().splitlines()[-1])
        return out

    def __exit__(self, *exc):
        for *_, log, proc in self.procs:   # stop every run and host still running
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
            log.close()


def external_parity_phase(torch, dev):
    """Every disk-tier driver and variant at scale 16, nb 8, chunks of 2^14
    edges, on the card and on the CPU: the sha256 of every file each run
    leaves (CSR bucket files, pv.npy, pv bucket stores) equal card vs CPU.
    The DISK_WALK_RUNS also walk their graph out of core (external_walks
    through ExternalWalkLoader, the pool's walk_corpus): the corpus shards
    are among the files held equal, the loader's batches too, and the card's
    walks must have launched bucket_hist.  Each run is a process of its own,
    all started together (the card's runs each with their own CUDA context;
    the host's cores are shared, so a run's seconds are not its time alone);
    the card's runs must have launched each of the four graph kernels.
    Returns every run's result by (name, "cuda" or "cpu")."""
    import tempfile

    common = {"scale": DISK_PARITY_SCALE, "nb": NB, "chunk_edges": DISK_PARITY_CHUNK}
    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="external_parity_") as tmp:
        jobs = [(name, side, ["--disk-run", driver, json.dumps({**common, **fields}),
                              str(Path(tmp) / f"{name}-{side}"),
                              "cuda:0" if side == "cuda" else "cpu",
                              str(int(name in DISK_WALK_RUNS))])
                for name, driver, fields in DISK_PARITY_RUNS for side in ("cuda", "cpu")]
        with ChildRuns("external_parity", tmp, jobs) as runs:
            results = runs.results()
    launches = {k: 0 for k in results[(jobs[0][0], "cuda")]["launches"]}
    for name, _, _ in DISK_PARITY_RUNS:
        card, cpu = results[(name, "cuda")], results[(name, "cpu")]
        require(card["shas"] == cpu["shas"] and len(card["shas"]) > NB,
                f"external_parity: {name} files differ card vs CPU")
        require(sum(cpu["launches"].values()) == 0, f"external_parity: {name} launched on the CPU")
        for k, v in card["launches"].items():
            launches[k] += v + card.get("walk_launches", {}).get(k, 0)
        line = {"phase": "external_parity", "run": name, "scale": DISK_PARITY_SCALE, "nb": NB,
                "chunk_edges": DISK_PARITY_CHUNK, "files_equal": len(card["shas"]),
                "card_s": card["seconds"], "cpu_s": cpu["seconds"],
                "card_launches": {k: v for k, v in card["launches"].items() if v}}
        if name in DISK_WALK_RUNS:
            shards = [f for f in card["shas"] if Path(f).name.startswith("walks_b")]
            require(len(shards) >= NB, f"external_parity: {name} left no walk corpus shards")
            require(card.get("batches_sha") == cpu.get("batches_sha"),
                    f"external_parity: {name} loader batches differ card vs CPU")
            require(sum(cpu["walk_launches"].values()) == 0,
                    f"external_parity: {name}'s walks launched on the CPU")
            require(card["walk_launches"]["bucket_hist"] > 0,
                    f"external_parity: {name}'s walks never launched bucket_hist")
            line.update(walkers=DISK_WALKERS, walk_length=DISK_WALK_LENGTH,
                        walk_shards_equal=len(shards), card_walk_s=card["walk_seconds"],
                        cpu_walk_s=cpu["walk_seconds"],
                        card_walk_launches={k: v for k, v in card["walk_launches"].items() if v})
        emit(line)
    for k in DISK_KERNELS:
        require(launches[k] > 0, f"external_parity: no run launched {k}")
    emit({"phase": "external_parity", "runs": len(jobs), "equal": True, "launches": launches,
          "seconds": time.perf_counter() - t})
    return results


DISK_KERNELS = ("rmat_edges", "feistel_perm", "bucket_hist", "relabel_gather")


def disk_line(label, cfg, gen, wall, extra) -> dict:
    """The numbers every disk-tier main run prints."""
    led = gen.ledger.as_dict()
    report = gen.orchestrator.report()
    pcfg = gen.pcfg if hasattr(gen, "pcfg") else gen._pcfg
    return {"phase": label, "scale": cfg.scale, "nb": cfg.nb, "edges": cfg.m,
            "chunk_edges": cfg.chunk_edges, "shuffle": cfg.shuffle_variant,
            "perm_family": pcfg.perm_family, "csr": cfg.csr_variant,
            "io_overlap": cfg.io_overlap, "wall_s": wall, "edges_per_s": cfg.m / wall,
            "phase_s": {r["phase"]: r["seconds"] for r in report},
            "ledger": {k: led[k] for k in ("seq_reads", "seq_writes", "rand_reads",
                                           "rand_writes", "bytes_read", "bytes_written",
                                           "hash_evals", "read_wait_s", "write_wait_s",
                                           "overlap_s")},
            "peak_rows": gen.gauge.peak_rows, "budget_rows": gen.gauge.budget_rows, **extra}


def external_main_phase(torch, ops, dev):
    """The out-of-core Graph500 run on the card: StreamingGenerator at scale
    20 (2^24 edges, 268 MB per edge store), nb 8, the paper's external
    shuffle, sorted CSR, chunks of 2^21 edges, I/O overlap on.  Launch
    counts set to 0 just before and read just after; torch.profiler gives
    each graph kernel's launches (which must equal the wrappers' counts) and
    device ms, and the card's busy share (kernels and copies over the wall
    time).  Validated
    on the card: pv equals the port's distributed_shuffle at nb 8, the sorted
    src * n + dst keys and the degrees of the CSR bucket files equal those of
    the port's generate(cfg, "paper").  Returns the launch counts and the
    sha256 of its CSR bucket files (cluster_main must write the same)."""
    import tempfile

    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.external import StreamingGenerator
    from repro_torch.core.pipeline import generate
    from repro_torch.core.shuffle import distributed_shuffle
    from repro_torch.core.types import GraphConfig
    from repro_torch.launch import attribution

    cfg = GraphConfig(scale=DISK_MAIN_SCALE, nb=NB, chunk_edges=DISK_MAIN_CHUNK,
                      shuffle_variant="external", csr_variant="sorted", io_overlap=True)
    with tempfile.TemporaryDirectory(prefix="external_main_") as tmp:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        gen = StreamingGenerator(cfg, tmp, device=dev)
        ops.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            pv, csr, _ = gen.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        counts = dict(ops.LAUNCHES)
        kernels = attribution.profiled_kernels(prof, DISK_KERNELS)
        device_ms = sum(ms for ms, _, _ in attribution.device_rows(prof))
        line = disk_line("external_main", cfg, gen, wall, {
            "peak_device_bytes": torch.cuda.max_memory_allocated(dev),
            "launches": counts, "kernels": kernels,
            "kernel_ms": sum(k["ms"] for k in kernels.values()), "device_ms": device_ms,
            "busy_share": device_ms / (wall * 1e3) if device_ms else "not measured"})
        line["kernel_share"] = line["kernel_ms"] / (wall * 1e3)
        for k in DISK_KERNELS:
            require(kernels[k]["launches"] == counts[k],
                    f"external_main: the profiler saw {kernels[k]['launches']} launches of {k}, "
                    f"its wrapper counted {counts[k]}")
            if k != "feistel_perm":
                require(counts[k] > 0, f"external_main never launched {k}")
        t = time.perf_counter()
        n, B = cfg.n, cfg.bucket_size
        want = generate(cfg, shuffle_variant="paper", device=dev)
        require(int(want.dropped_relabel) == 0 and int(want.dropped_redistribute) == 0,
                "external_main: the device generate dropped records")
        pv_ok = torch.equal(torch.from_numpy(np.array(pv, np.int64)).to(dev),
                            distributed_shuffle(cfg, dev).long())
        src = torch.cat([i * B + torch.repeat_interleave(
            torch.arange(B, device=dev), torch.from_numpy(np.diff(o)).to(dev))
            for i, (o, _) in enumerate(csr)])
        dst = torch.cat([torch.from_numpy(np.array(a, np.int64)).to(dev) for _, a in csr])
        valid = want.owned.valid
        wsrc, wdst = want.owned.src[valid].long(), want.owned.dst[valid].long()
        keys_ok = (src.numel() == wsrc.numel() == cfg.m
                   and torch.equal(torch.sort(src * n + dst).values,
                                   torch.sort(wsrc * n + wdst).values))
        deg_ok = torch.equal(torch.bincount(src, minlength=n), torch.bincount(wsrc, minlength=n))
        torch.cuda.synchronize()
        line["checks"] = {"pv_equals_distributed_shuffle": pv_ok, "sorted_keys_equal": keys_ok,
                          "degrees_equal": deg_ok, "random_transfers":
                          line["ledger"]["rand_reads"] + line["ledger"]["rand_writes"]}
        line["validate_s"] = time.perf_counter() - t
        csr_shas = {f: h for f, h in tree_shas(tmp).items() if f.startswith("csr_")}
        del want, src, dst, wsrc, wdst, valid, pv, csr, gen
    emit(line)
    require(pv_ok and keys_ok and deg_ok, f"external_main: validation failed {line['checks']}")
    require(line["checks"]["random_transfers"] == 0, "external_main: random I/O on the sorted path")
    require(len(csr_shas) == 2 * NB, "external_main: CSR bucket files missing")
    return counts, csr_shas


def external_recompute_phase(torch, ops, dev):
    """The communication-free variant out of core: PartitionedGenerator with
    DISK_WORKERS workers on the card, scale 18, nb 8, chunks of 2^20 (its
    kernels launch in the workers; their counts come back at each barrier,
    their times and memory are not measured).  Its CSR bucket files must
    have the sha256 of an external+feistel StreamingGenerator run of the same
    graph on the card.  Returns the partitioned run's launch counts."""
    import tempfile

    from repro_torch.core.external import StreamingGenerator
    from repro_torch.core.phases import PartitionedGenerator
    from repro_torch.core.types import GraphConfig

    cfg = GraphConfig(scale=DISK_RECOMPUTE_SCALE, nb=NB, chunk_edges=DISK_RECOMPUTE_CHUNK,
                      shuffle_variant="recompute", csr_variant="sorted", io_overlap=True)
    with tempfile.TemporaryDirectory(prefix="external_recompute_") as tmp:
        part_dir, ref_dir = Path(tmp) / "partitioned", Path(tmp) / "streaming"
        ops.reset_launches()
        t = time.perf_counter()
        with PartitionedGenerator(cfg, str(part_dir), max_workers=DISK_WORKERS,
                                  device=dev) as gen:
            gen.run()
            wall = time.perf_counter() - t
            counts = dict(ops.LAUNCHES)
            line = disk_line("external_recompute", cfg, gen, wall,
                             {"workers": DISK_WORKERS, "launches": counts})
        t = time.perf_counter()
        ref = StreamingGenerator(cfg.with_(shuffle_variant="external", perm_family="feistel"),
                                 str(ref_dir), device=dev)
        ref.run()
        line["streaming_external_feistel_s"] = time.perf_counter() - t
        csr_names = [f"csr_{w}_{i:03d}.npy" for i in range(NB) for w in ("offv", "adjv")]
        got, want = tree_shas(part_dir), tree_shas(ref_dir)
        line["csr_files_equal"] = all(got.get(f) == want.get(f) and f in want for f in csr_names)
    emit(line)
    require(line["csr_files_equal"], "external_recompute: CSR files differ from external+feistel")
    for k in ("rmat_edges", "feistel_perm", "bucket_hist"):
        require(counts[k] > 0, f"external_recompute never launched {k}")
    return counts


# The cluster runtime (`core/cluster.py`, `core/jobqueue.py`): hosts are
# processes of their own (`python -m repro_torch.launch.cluster host`), each
# with its own workdir and CUDA context, exchanging over loopback sockets.
CLUSTER_HOSTS = 2
CLUSTER_WORKERS = 2                # cluster_main's pool workers per host
# The queue's fused corpora: the fused hop leaves its frontier in many small
# runs, each partitioned apart (one partition_chunk: copies, launches and
# syncs of fixed cost on the card); at 4096 walkers each the queue made 39032
# of them and took 316.6 s on card hosts (one H100 80GB HBM3, 700 W), so its
# corpora have 256 walkers (scripts/time_cluster.py --config queue times 4096).
CLUSTER_QUEUE_WALKS = ((256, DISK_WALK_LENGTH, 0, "a.npy"),
                       (256, DISK_WALK_LENGTH, 1, "b.npy"))
CLUSTER_TIMEOUT_S = 900            # cluster_parity's drivers, external_parity beside them


def host_backend(workers: int = 0):
    """The local exec backend whose hosts import this checkout's port."""
    from repro_torch.core.cluster import LocalExecBackend

    return LocalExecBackend(workers=workers, env={"PYTHONPATH": str(ROOT / "src")})


def host_file_shas(spec, sub: str = "") -> dict:
    """{sub/file: sha256} of the .npy files each host left in its workdir (in
    its job subdir `sub`): CSR bucket files and corpus shards; no file name
    may be on two hosts."""
    import hashlib

    out = {}
    for h in spec.hosts:
        d = Path(h.workdir) / sub
        for path in sorted(d.glob("*.npy")):
            key = f"{sub}/{path.name}" if sub else path.name
            require(key not in out, f"{key} is on two hosts")
            out[key] = hashlib.sha256(path.read_bytes()).hexdigest()
    return out


def cluster_run(kind: str, device: str, workdir: str) -> dict:
    """One cluster_parity run on CLUSTER_HOSTS local hosts at scale 16, nb 8,
    chunks of 2^14, socket exchange, every host's hooks on `device`.
    "graph": a ClusterGenerator run (external shuffle, sorted CSR) and a
    DISK_WALKERS x DISK_WALK_LENGTH walk corpus.  "queue": a JobScheduler
    (max_concurrent 2) draining two submitted jobs, the external graph and a
    recompute one with the fused generate+relabel and two fused corpora.
    Returns the seconds, the launch counts the hosts reported, restarts,
    dead letters and the sha256 of every file the hosts left."""
    from repro_torch.core.cluster import ClusterGenerator, ClusterSpec
    from repro_torch.core.jobqueue import JobScheduler, submit_job
    from repro_torch.core.types import GraphConfig
    from repro_torch.kernels import ops

    cfg = GraphConfig(scale=DISK_PARITY_SCALE, nb=NB, chunk_edges=DISK_PARITY_CHUNK,
                      shuffle_variant="external", transport="socket")
    spec = ClusterSpec.local(CLUSTER_HOSTS, str(Path(workdir) / "hosts"), nb=NB)
    ctrl = str(Path(workdir) / "ctrl")
    ops.reset_launches()
    t = time.perf_counter()
    out = {}
    if kind == "graph":
        gen = ClusterGenerator(cfg, spec, ctrl, backend=host_backend(), checkpoint=True,
                               device=device)
        try:
            gen.run()
            out["graph_s"] = time.perf_counter() - t
            gen.walk_corpus(DISK_WALKERS, DISK_WALK_LENGTH)
            out["walk_s"] = time.perf_counter() - t - out["graph_s"]
            restarts, dead = gen.controller.restarts, []
        finally:
            gen.close()
        shas = host_file_shas(spec)
    else:
        submit_job(ctrl, cfg, name="external")
        submit_job(ctrl, cfg.with_(shuffle_variant="recompute"), walks=CLUSTER_QUEUE_WALKS,
                   fuse_walks=True, fuse_gen_relabel=True, name="recompute")
        with JobScheduler(spec, ctrl, backend=host_backend(), max_concurrent=2,
                          device=device) as sched:
            summary = sched.drain()
            restarts, dead = sched.controller.restarts, summary["dead_letters"]
        require([j["status"] for j in summary["jobs"]] == ["done", "done"],
                f"cluster_parity: queue jobs {summary['jobs']}")
        shas = {**host_file_shas(spec, "job0000"), **host_file_shas(spec, "job0001")}
    return {**out, "seconds": time.perf_counter() - t, "launches": dict(ops.LAUNCHES),
            "restarts": {str(h): n for h, n in restarts.items()}, "dead_letters": dead,
            "shas": shas}


def cluster_run_child(argv) -> int:
    """`chip_smoke.py --cluster-run KIND DEVICE WORKDIR`: one cluster_parity
    run (its driver and hosts) in processes of their own; its result is the
    last line of its standard output."""
    sys.path.insert(0, str(ROOT / "src"))
    print(json.dumps(cluster_run(argv[0], argv[1], argv[2])), flush=True)
    return 0


def cluster_parity_phase(alongside):
    """The cluster runtime, card hosts against CPU hosts: the "graph" and
    "queue" runs of `cluster_run`, each with hosts on the card and with hosts
    on the CPU, the four drivers (each a process with its hosts) started
    together, and `alongside()` (external_parity, which returns its runs)
    run while they run: their barriers and pool starts leave cores idle.
    Every CSR bucket file and corpus shard the hosts left must
    have equal sha256 card vs CPU; the graph run's must equal those of
    external_parity's streaming-external-sorted run on the card (the same
    graph and, through ExternalWalkLoader, the same corpus); no job may be
    dead-lettered and no host restarted; the card hosts must have launched
    rmat_edges, relabel_gather and bucket_hist, and the queue's feistel_perm
    (launched by its recompute job alone)."""
    import tempfile

    t = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="cluster_parity_") as tmp:
        jobs = [(kind, side, ["--cluster-run", kind, side, str(Path(tmp) / f"{kind}-{side}")])
                for kind in ("graph", "queue") for side in ("cuda", "cpu")]
        with ChildRuns("cluster_parity", tmp, jobs, timeout=CLUSTER_TIMEOUT_S) as runs:
            parity_runs = alongside()
            results = runs.results()
    stream = parity_runs[("streaming-external-sorted", "cuda")]["shas"]
    for kind in ("graph", "queue"):
        card, cpu = results[(kind, "cuda")], results[(kind, "cpu")]
        require(card["shas"] == cpu["shas"], f"cluster_parity: {kind} files differ card vs CPU")
        for r in (card, cpu):
            require(not r["dead_letters"],
                    f"cluster_parity: {kind} dead letters {r['dead_letters']}")
            require(not any(r["restarts"].values()),
                    f"cluster_parity: {kind} restarts {r['restarts']}")
        require(sum(cpu["launches"].values()) == 0, f"cluster_parity: {kind} launched on the CPU")
        for k in ("rmat_edges", "relabel_gather", "bucket_hist") + (
                ("feistel_perm",) if kind == "queue" else ()):
            require(card["launches"][k] > 0,
                    f"cluster_parity: {kind}'s card hosts never launched {k}")
        line = {"phase": "cluster_parity", "run": kind, "hosts": CLUSTER_HOSTS,
                "scale": DISK_PARITY_SCALE, "nb": NB, "chunk_edges": DISK_PARITY_CHUNK,
                "files_equal": len(card["shas"]), "card_s": card["seconds"],
                "cpu_s": cpu["seconds"],
                **{f"{side}_{k}": r[k] for side, r in (("card", card), ("cpu", cpu))
                   for k in ("graph_s", "walk_s") if k in r},
                "card_launches": {k: v for k, v in card["launches"].items() if v}}
        if kind == "graph":
            shared = {f for f in card["shas"] if f.startswith(("csr_", "walks_b"))}
            require(len(shared) == 3 * NB and all(card["shas"][f] == stream.get(f) for f in shared),
                    "cluster_parity: the graph run's files differ from streaming-external-sorted's")
            line["equal_to_streaming_external_sorted"] = len(shared)
        emit(line)
    emit({"phase": "cluster_parity", "runs": len(jobs), "equal": True,
          "seconds": time.perf_counter() - t})


class GpuSampler:
    """`nvidia-smi` sampling the card's utilization.gpu (the share of each
    sample period in which a kernel ran, from any process) and memory.used
    every `period_ms`, in a process of its own; stopped on exit."""

    def __init__(self, period_ms: int = 200):
        self.period_ms = period_ms

    def __enter__(self):
        import tempfile

        self.out = tempfile.TemporaryFile("w+")
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=utilization.gpu,memory.used",
             "--format=csv,noheader,nounits", "-lms", str(self.period_ms)],
            stdout=self.out, stderr=subprocess.DEVNULL)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        self.out.seek(0)
        rows = [line.split(",") for line in self.out.read().splitlines() if "," in line]
        self.out.close()
        self.util = [float(r[0]) for r in rows]
        self.mem_mib = [float(r[1]) for r in rows]

    def summary(self) -> dict:
        if not self.util:
            return {"samples": 0, "utilization_mean": "not measured"}
        return {"samples": len(self.util), "period_ms": self.period_ms,
                "utilization_mean": statistics.mean(self.util) / 100,
                "utilization_max": max(self.util) / 100,
                "memory_used_max_mib": max(self.mem_mib)}


def cluster_main_phase(torch, ops, dev, external_csr):
    """external_main's configuration (scale 20, 2^24 edges, nb 8, external
    shuffle, sorted CSR, chunks of 2^21, I/O overlap) on CLUSTER_HOSTS card
    hosts with CLUSTER_WORKERS pool workers each, socket exchange: the hosts
    start (rendezvous, timed apart), then ClusterGenerator.run, launch
    counts set to 0 just before the hosts start and read just after the
    run (the hosts' reports carry them).  Prints the wall seconds, edges/s,
    seconds per phase (fine-grained: every clean and barrier its own, and
    summed by their first word), the merged ledger, host peak rows, the
    restarts, each kernel's launches, and nvidia-smi's utilization.gpu and
    memory.used over the run (the kernels run in the host processes, which
    torch.profiler here cannot see).  Requires zero random transfers, no
    restart, and CSR bucket files with the sha256 of external_main's.
    Returns the launch counts."""
    import tempfile

    from repro_torch.core.cluster import ClusterGenerator, ClusterSpec
    from repro_torch.core.types import GraphConfig

    cfg = GraphConfig(scale=DISK_MAIN_SCALE, nb=NB, chunk_edges=DISK_MAIN_CHUNK,
                      shuffle_variant="external", csr_variant="sorted", io_overlap=True,
                      transport="socket")
    with tempfile.TemporaryDirectory(prefix="cluster_main_") as tmp:
        spec = ClusterSpec.local(CLUSTER_HOSTS, str(Path(tmp) / "hosts"), nb=NB)
        ops.reset_launches()
        with GpuSampler() as sampler:
            t = time.perf_counter()
            gen = ClusterGenerator(cfg, spec, str(Path(tmp) / "ctrl"),
                                   backend=host_backend(CLUSTER_WORKERS), checkpoint=True,
                                   device=dev)
            start_s = time.perf_counter() - t
            try:
                t = time.perf_counter()
                gen.run(cfg.csr_variant)
                wall = time.perf_counter() - t
                counts = dict(ops.LAUNCHES)
                restarts = dict(gen.controller.restarts)
                busy = dict(gen.controller.busy_seconds)
                line = disk_line("cluster_main", cfg, gen, wall, {
                    "hosts": CLUSTER_HOSTS, "workers_per_host": CLUSTER_WORKERS,
                    "start_s": start_s, "restarts": restarts, "launches": counts,
                    "host_busy_s": busy, "ledger_full": gen.ledger.as_dict()})
            finally:
                gen.close()
        csr = host_file_shas(spec)
    groups = {}
    for name, sec in line["phase_s"].items():
        groups[name.split("_")[0]] = groups.get(name.split("_")[0], 0.0) + sec
    line["phase_group_s"] = groups
    line["gpu"] = sampler.summary()
    line["cut"] = "scale 20 (external_main's), cut from Graph500 toy 26 for the script's time"
    line["csr_equal_to_external_main"] = (
        {f: h for f, h in csr.items() if f.startswith("csr_")} == external_csr)
    emit(line)
    require(line["ledger"]["rand_reads"] + line["ledger"]["rand_writes"] == 0,
            "cluster_main: random I/O on the sorted path")
    require(not any(restarts.values()), f"cluster_main: hosts restarted {restarts}")
    require(line["csr_equal_to_external_main"],
            "cluster_main: CSR files differ from external_main's")
    for k in ("rmat_edges", "relabel_gather", "bucket_hist"):
        require(counts[k] > 0, f"cluster_main: the hosts never launched {k}")
    return counts


def attention_build_phase(sass, lib):
    """Registers and spills of every instance of the two attention kernels
    (`ptxas -v`), and the instructions that show their design in the SASS:
    HGMMA (wgmma) and UTMALDG (TMA tensor loads) in every prefill instance,
    an asynchronous copy (UBLKCP, the 1-D bulk copy; or LDGSTS) in every
    decode instance.  A missing instruction or a spill in a decode instance
    fails the run."""
    usage = sass.ptxas_usage(lib.with_suffix(".log").read_text())
    listing = sass.listing(lib)
    found = []
    for kind in ("decode", "prefill"):
        ops_of = sass.opcodes(listing, f"flash_attention_{kind}_kernel")
        require(ops_of, f"no flash_attention_{kind}_kernel in the SASS of {lib.name}")
        for fn, ops_ in sorted(ops_of.items()):
            targs = re.search(r"_kernelI(.*?)EEEv", fn).group(1)   # the template arguments
            dtype = {"1": ["bf16"], "f": ["f32"]}.get(targs[:1], [])
            short = f"{kind}<{','.join(dtype + re.findall(r'Li(\d+)', targs))}>"
            u = usage.get(fn, {})
            row = {"kernel": short, "registers": u.get("registers"),
                   "spill_stores": u.get("spill_stores"), "spill_loads": u.get("spill_loads"),
                   "HGMMA": "HGMMA" in ops_, "UTMALDG": "UTMALDG" in ops_,
                   "async_copy": sorted(ops_ & {"UBLKCP", "LDGSTS"})}
            found.append(row)
            if kind == "prefill":
                require(row["HGMMA"] and row["UTMALDG"],
                        f"{short}: no HGMMA or UTMALDG in its SASS")
            else:
                require(row["async_copy"], f"{short}: no asynchronous copy in its SASS")
                require(u.get("spill_stores") == 0 and u.get("spill_loads") == 0,
                        f"{short} spills: {u}")
    # MLA's (192, 128): the prefill instance and the decode row buckets 1-8 of both types
    mla = {row["kernel"] for row in found if "192,128" in row["kernel"]}
    want = {"prefill<192,128>"} | {f"decode<{t},192,128,{r}>" for t in ("bf16", "f32")
                                   for r in (1, 2, 4, 8)}
    require(mla == want, f"MLA attention instances {sorted(mla)}, want {sorted(want)}")
    # zamba2's (80, 80): the prefill instance and the decode row buckets 1-16 of both types
    d80 = {row["kernel"] for row in found if "80,80" in row["kernel"]}
    want = {"prefill<80,80>"} | {f"decode<{t},80,80,{r}>" for t in ("bf16", "f32")
                                 for r in (1, 2, 4, 8, 16)}
    require(d80 == want, f"(80, 80) attention instances {sorted(d80)}, want {sorted(want)}")
    emit({"phase": "attention_build", "listing": lib.with_suffix(".sass").name,
          "instances": found})


def flash_phase(torch, ops, dev, g, time_ms):
    """flash_attention against its plain version at the serve path's shapes:
    (a) prefill at full width, (b) the decode wave (both timed, with the
    SDPA call over the same mask as the library yardstick), (c) non-causal
    with ragged Sq / Skv, (d) the smoke configs' D 16, (e, f) the decode
    kernel's split-KV path with ragged chunks, causal and not, (g) the
    prefill kernel with ragged tiles and GQA group 5, (h) a decode wave with
    GQA group 5 and ragged offsets (0, tile and chunk edges, the last key,
    an idle slot past the cache), (i) a timed prefill of 512 queries; MLA's
    widths (q, k 192; v 128; 16 heads, each its own kv head), as serve_moe
    runs them: (j) an admission's prefill, (k) the decode wave, (l) f32 with
    16 queries (two 8-row tiles; all timed, SDPA beside them where it takes
    v narrower than q); zamba2's 80-wide heads (32 heads, each its own kv
    head), as serve_hybrid runs them: (m) the decode wave, (n) an
    admission's prefill, (o) f32 with ragged Sq and Skv, non-causal (all
    timed); seamless's (64, 64), as encdec_main runs them: (p) the encoder's
    non-causal self-attention, (q) cross-attention at prefill, (r) the
    decoder's causal prefill, (s) the cross-attention and (t) the
    self-attention decode waves; llava's (128, 128) with GQA group 4, as
    vlm_main runs them: (u) the prefill of image and text, (v) the decode
    wave (all timed).  In (a), (b), (h) and (j)-(v) the kernel is also run
    with planted faults, which the check must reject (the softmax scale 5 %
    off; the last 32 keys of each row dropped); at width 80 also two
    kernels that kept 64-column atoms: q.k over columns 0-63 only, and
    output columns 64-79 dropped."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import TOLERANCE, plan, row_error
    from repro_torch.launch import roofline

    bf16, f32 = torch.bfloat16, torch.float32
    B = SERVE_SLOTS
    decode_off = torch.randint(127, SERVE_MAX_LEN - 1, (B,), generator=g, device=dev,
                               dtype=torch.int32)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    ragged = torch.tensor([0, 31, 480, 1500, 2999, 4094, 4095, 5096], dtype=torch.int32,
                          device=dev)
    mla = (192, 128)

    def at(n, offset):
        return torch.full((n,), offset, dtype=torch.int32, device=dev)

    # encdec_main's and vlm_main's cache lengths (prompt and decode steps)
    encdec_len = ENCDEC_PROMPT + GEN_STEPS
    vlm_prompt = get_config(VLM_ARCH).num_image_tokens + VLM_TEXT
    vlm_len = vlm_prompt + GEN_STEPS
    # B, Hq, Hkv, Sq, Skv, D (or (D, Dv)), offsets [B], causal, dtype, timed, planted faults
    cases = {
        "a": ("prefill: B 1, Sq 2048 against the 4096-slot cache, offset 0, D 128, bf16",
              1, 16, 8, 2048, SERVE_MAX_LEN, 128, zero, True, bf16, True, True),
        "b": ("decode wave: B 8, Sq 1, Skv 4096, per-slot offsets in [127, 4094], D 128, bf16",
              B, 16, 8, 1, SERVE_MAX_LEN, 128, decode_off, True, bf16, True, True),
        "c": ("non-causal: B 2, Sq 1000, Skv 1531, D 128, f32",
              2, 16, 8, 1000, 1531, 128, None, False, f32, False, False),
        "d": ("smoke: B 2, Hq 4, Hkv 2, Sq 37, Skv 64, offsets [3, 27], D 16, f32",
              2, 4, 2, 37, 64, 16, torch.tensor([3, 27], dtype=torch.int32, device=dev),
              True, f32, False, False),
        "e": ("split-KV: B 2, Hq 4, Hkv 2, Sq 3, Skv 1000, offsets [500, 990], D 64, f32",
              2, 4, 2, 3, 1000, 64, torch.tensor([500, 990], dtype=torch.int32, device=dev),
              True, f32, False, False),
        "f": ("split-KV non-causal: B 1, Hq 2, Hkv 1, Sq 1, Skv 700, D 32, f32",
              1, 2, 1, 1, 700, 32, None, False, f32, False, False),
        "g": ("tensor cores, ragged: B 2, Hq 10, Hkv 2, Sq 37, Skv 100, offsets [0, 50], "
              "D 64, bf16", 2, 10, 2, 37, 100, 64,
              torch.tensor([0, 50], dtype=torch.int32, device=dev), True, bf16, False, False),
        "h": ("decode wave, GQA group 5: B 8, Hq 40, Hkv 8, Sq 1, Skv 4096, offsets "
              "[0, 31, 480, 1500, 2999, 4094, 4095, 5096 (idle)], D 128, bf16",
              B, 40, 8, 1, SERVE_MAX_LEN, 128, ragged, True, bf16, False, True),
        "i": ("prefill: B 1, Sq 512 against the 4096-slot cache, offset 0, D 128, bf16",
              1, 16, 8, 512, SERVE_MAX_LEN, 128, zero, True, bf16, True, False),
        "j": ("MLA prefill: B 1, H 16, Sq 2048 at offset 2048 of the 4096-slot cache, "
              "D 192, Dv 128, bf16", 1, 16, 16, 2048, SERVE_MAX_LEN, mla,
              torch.tensor([2048], dtype=torch.int32, device=dev), True, bf16, True, True),
        "k": ("MLA decode wave: B 8, H 16, Sq 1, Skv 4096, per-slot offsets in [127, 4094], "
              "D 192, Dv 128, bf16", B, 16, 16, 1, SERVE_MAX_LEN, mla, decode_off, True, bf16,
              True, True),
        "l": ("MLA f32: B 2, H 16, Sq 16, Skv 4096, offsets [1000, 4080], D 192, Dv 128",
              2, 16, 16, 16, SERVE_MAX_LEN, mla,
              torch.tensor([1000, 4080], dtype=torch.int32, device=dev), True, f32, True, True),
        "m": ("zamba2 decode wave: B 8, H 32, Sq 1, Skv 4096, per-slot offsets in [127, 4094], "
              "D 80, bf16", B, 32, 32, 1, SERVE_MAX_LEN, 80, decode_off, True, bf16, True, True),
        "n": ("zamba2 prefill: B 1, H 32, Sq 2048 against the 4096-slot cache, offset 0, D 80, "
              "bf16", 1, 32, 32, 2048, SERVE_MAX_LEN, 80, zero, True, bf16, True, True),
        "o": ("D 80 f32, non-causal: B 2, H 32, Sq 37, Skv 1531", 2, 32, 32, 37, 1531, 80, None,
              False, f32, True, True),
        "p": ("seamless encoder self-attention: B 4, H 16, Sq = Skv 1024, D 64, bf16, non-causal",
              ENCDEC_BATCH, 16, 16, ENCDEC_FRAMES, ENCDEC_FRAMES, 64, None, False, bf16, True,
              True),
        "q": ("seamless cross-attention, prefill: B 4, H 16, Sq 128, Skv 1024 encoder keys, D 64, "
              "bf16, non-causal", ENCDEC_BATCH, 16, 16, ENCDEC_PROMPT, ENCDEC_FRAMES, 64, None,
              False, bf16, True, True),
        "r": ("seamless decoder self-attention, prefill: B 4, H 16, Sq 128 against the 192-slot "
              "cache, offset 0, D 64, bf16", ENCDEC_BATCH, 16, 16, ENCDEC_PROMPT, encdec_len, 64,
              at(ENCDEC_BATCH, 0), True, bf16, True, True),
        "s": ("seamless cross-attention decode wave: B 4, H 16, Sq 1, Skv 1024 encoder keys, D 64, "
              "bf16, non-causal", ENCDEC_BATCH, 16, 16, 1, ENCDEC_FRAMES, 64, None, False, bf16,
              True, True),
        "t": ("seamless self-attention decode wave: B 4, H 16, Sq 1, Skv 192, offsets 160, D 64, "
              "bf16", ENCDEC_BATCH, 16, 16, 1, encdec_len, 64,
              at(ENCDEC_BATCH, ENCDEC_PROMPT + GEN_STEPS // 2), True, bf16, True, True),
        "u": ("llava prefill: B 4, Hq 32, Hkv 8, Sq 1688 (1176 image + 512 text tokens) against "
              "the 1752-slot cache, offset 0, D 128, bf16", VLM_BATCH, 32, 8, vlm_prompt, vlm_len,
              128, at(VLM_BATCH, 0), True, bf16, True, True),
        "v": ("llava decode wave: B 4, Hq 32, Hkv 8, Sq 1, Skv 1752, offsets 1720, D 128, bf16",
              VLM_BATCH, 32, 8, 1, vlm_len, 128, at(VLM_BATCH, vlm_prompt + GEN_STEPS // 2), True,
              bf16, True, True),
    }
    out = {}
    for key, (case, B_, Hq, Hkv, Sq, Skv, D, off, causal, dtype, timed, planted) in cases.items():
        D, Dv = D if isinstance(D, tuple) else (D, D)
        q = torch.randn(B_, Hq, Sq, D, generator=g, device=dev).to(dtype)
        k = torch.randn(B_, Hkv, Skv, D, generator=g, device=dev).to(dtype)
        v = torch.randn(B_, Hkv, Skv, Dv, generator=g, device=dev).to(dtype)
        kernel = lambda: ops.flash_attention(q, k, v, causal=causal, offset=off)  # noqa: E731
        plain = lambda: ops.flash_attention_plain(q, k, v, causal=causal, offset=off)  # noqa: E731
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got).all()), f"flash_attention [{key}] not finite")
        tol, err = TOLERANCE[dtype], row_error(got, want)
        require(err <= tol, f"flash_attention [{key}] differs from its plain version: "
                            f"row error {err} > {tol}")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        path = plan(dtype, B_, Hq, Hkv, Sq, Skv, D, Dv, sms).kernel
        line = {"kernel": f"flash_attention_{path}", "case": case, "dtype": str(dtype),
                "row_error": err,
                "tolerance": tol, "max_abs_diff": float((got.float() - want.float()).abs().max())}
        if planted:
            # planted faults: the check must tell them from the sound kernel
            faults = {"softmax scale 5 % off": ops.flash_attention(
                q, k, v, causal=causal, offset=off, scale=1.05 / D ** 0.5)}
            if causal:
                faults["last 32 keys of each row dropped"] = ops.flash_attention(
                    q, k, v, causal=causal, offset=off - 32)
            else:
                faults["last 32 keys dropped"] = ops.flash_attention(
                    q, k[:, :, :-32].contiguous(), v[:, :, :-32].contiguous(), causal=False)
            if D == 80:
                # a kernel that kept 64-column atoms: the prefill's one box of
                # q and k columns, the decode kernel's 2 output columns a lane
                q64 = q.clone()
                q64[..., 64:] = 0
                faults["q.k over columns 0-63 only"] = ops.flash_attention(
                    q64, k, v, causal=causal, offset=off)
                head = ops.flash_attention(q[..., :64].contiguous(), k[..., :64].contiguous(),
                                           v[..., :64].contiguous(), causal=causal, offset=off,
                                           scale=D ** -0.5)
                faults["output columns 64-79 dropped"] = torch.cat(
                    [head, torch.zeros_like(want[..., 64:])], dim=-1)
                del q64, head
            line["planted_faults"] = {name: row_error(bad, want) for name, bad in faults.items()}
            for name, bad_err in line["planted_faults"].items():
                require(bad_err > tol, f"flash_attention [{key}]: planted fault '{name}' passes "
                                       f"the check: row error {bad_err} <= {tol}")
            del faults
        if timed:
            mask = None
            if causal:
                qpos = off[:, None] + torch.arange(Sq, device=dev)[None, :]
                mask = (torch.arange(Skv, device=dev)[None, None, :] <= qpos[:, :, None])[:, None]
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=mask, enable_gqa=True)
            line["kernel_ms"] = time_ms(kernel)
            line["plain_ms"] = time_ms(plain, reps=3)
            line["library_ms"] = time_ms(library)
            line["bound_ms"], line["bound_by"] = roofline.flash_bound(q, k, v, off, causal)
            del mask
        emit(line)
        out[key] = line
        del q, k, v, got, want
    return out


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, dev) for v in tree]
    return tree.to(dev)


def _serve_requests(n, vocab, rng, plen, max_new, sampled):
    from repro_torch.serve import Request, SamplingParams
    reqs = []
    for uid in range(n):
        prompt = rng.integers(0, vocab, int(rng.integers(plen[0], plen[1] + 1))).tolist()
        sampling = (SamplingParams(temperature=0.8, top_k=40, seed=uid) if uid in sampled
                    else SamplingParams())
        reqs.append(Request(uid=uid, prompt=prompt, max_new_tokens=max_new, sampling=sampling))
    return reqs


def serve_parity_phase(torch, ops, dev):
    """The smoke configs on the card and on the CPU: the same parameters give
    prefill and decode logits within PARITY_TOL (f32; PARITY_BF16_TOL in
    bf16) and the Engine (families it serves, f32) the same tokens, the
    card's runs launching flash_attention where the config has attention and
    bucket_hist where it has experts.  The dense and MoE smokes (f32; 8
    prompt tokens): deepseek-v2's runs at MLA's real widths (PARITY_MLA),
    and its own (24, 16) heads must raise on the card.  The ssm, hybrid,
    encdec and vlm smokes (mamba2, zamba2, seamless, llava; f32; 20 prompt
    tokens, seamless with 24 encoder frames, llava after its 16 image
    tokens) and zamba2's at its real head width 80 (PARITY_D80), f32 and
    bf16 (whose prefill must run the (80, 80) prefill kernel)."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model, init_all, input_specs
    from repro_torch.serve import Engine
    from repro_torch.serve.engine import SUPPORTED_FAMILIES

    cases = []      # (config, prompt tokens, tolerance)
    for arch in PARITY_ARCHS:
        cfg = get_smoke_config(arch)
        if cfg.kv_lora_rank:
            api = get_model(cfg)
            params = init_all(cfg, seed=SERVE_SEED, device=dev)
            try:
                api.prefill(cfg, params, {"tokens": torch.zeros((1, 8), dtype=torch.int32,
                                                                device=dev)},
                            api.init_cache(cfg, 1, 64, dev))
                raised = ""
            except ValueError as e:
                raised = str(e)
            require("head dims" in raised,
                    f"serve_parity {arch}: the smoke's MLA heads did not raise on the card")
            cfg = cfg.with_(name=f"{cfg.name}-mla-widths", **PARITY_MLA)
        cases.append((cfg, 8, PARITY_TOL))
    cases += [(get_smoke_config(arch), 20, PARITY_TOL) for arch in PARITY_FAMILIES]
    d80 = get_smoke_config(HYBRID_ARCH).with_(name="zamba2-smoke-d80", **PARITY_D80)
    cases += [(d80, 20, PARITY_TOL),
              (d80.with_(name="zamba2-smoke-d80-bf16", dtype="bfloat16"), 20, PARITY_BF16_TOL)]

    for cfg, n_pre, tol in cases:
        t0 = time.perf_counter()
        api = get_model(cfg)
        on = {"cpu": init_all(cfg, seed=SERVE_SEED, device="cpu")}
        on["cuda"] = _to(on["cpu"], dev)
        n_img = cfg.num_image_tokens
        logits = {}
        ops.reset_launches()
        for where, params in on.items():
            d = dev if where == "cuda" else torch.device("cpu")
            batch = input_specs(cfg, "prefill", 2, n_img + n_pre + 4, seed=1, device=d)
            t = batch["tokens"]
            cache = api.init_cache(cfg, 2, n_img + 64, d)
            lg, cache = api.prefill(cfg, params, dict(batch, tokens=t[:, :n_pre]), cache)
            logits[where] = [lg]
            for i in range(n_pre, n_pre + 4):
                lg, cache = api.decode_step(cfg, params, t[:, i:i + 1], cache)
                logits[where].append(lg)
        err = max(float((a.float().cpu() - b.float()).abs().max())
                  for a, b in zip(logits["cuda"], logits["cpu"]))
        require(err <= tol, f"serve_parity {cfg.name}: logits card vs CPU differ by {err} > {tol}")
        line = {"phase": "serve_parity", "arch": cfg.name, "dtype": cfg.dtype, "head_dim": cfg.hd,
                "logits_max_abs_diff": err, "tolerance": tol}
        if cfg.family in SUPPORTED_FAMILIES and cfg.dtype == "float32":
            served = {}
            for where, params in on.items():
                reqs = _serve_requests(8, cfg.vocab_size, np.random.default_rng(2), (1, 24), 8,
                                       sampled=(1, 4, 6))
                eng = Engine(cfg, params, max_batch=4, max_len=64,
                             device=dev if where == "cuda" else "cpu")
                served[where] = (eng.run(reqs), eng.steps, eng.prefill_tokens, eng.decode_tokens)
            require(served["cuda"] == served["cpu"],
                    f"serve_parity {cfg.name}: Engine differs card vs CPU")
            line.update({"tokens_equal": True, "requests": len(served["cpu"][0]),
                         "steps": served["cpu"][1]})
        launches = {n: ops.LAUNCHES[n] for n in ("flash_attention", "flash_attention_prefill",
                                                  "bucket_hist")}
        require((launches["flash_attention"] > 0) == (cfg.family != "ssm")
                and (launches["bucket_hist"] > 0) == (cfg.num_experts > 0),
                f"serve_parity {cfg.name}: card launches {launches}")
        if cfg.hd == 80 and cfg.dtype == "bfloat16":
            require(launches["flash_attention_prefill"] > 0,
                    f"serve_parity {cfg.name}: the (80, 80) prefill kernel never ran")
        line.update({"card_launches": launches, "seconds": time.perf_counter() - t0})
        emit(line)


def serve_phase(torch, ops, dev, cfg, label, *, dist=None, params=None,
                max_new=SERVE_NEW_TOKENS, trace=True, moe_inputs=None):
    """`cfg` at full width behind the continuous-batching Engine (with
    `dist`, a DistContext, if given; with `params`, else seeded random
    weights drawn on the card), then a serve_trace window unless `trace` is
    false.  For an MoE config also the MoE layers' time and drops, and
    bucket_hist's launches (`moe_hist_launches` per MoE call); with
    `moe_inputs` (a list) the (parameters, input, prompt rows) of every MoE
    call of the first admission's prefill are appended to it; for the ssm
    and hybrid families each admission's prompt tokens, SSD chunk and ms,
    and for ssm the cost of one admission by prompt length (`chunk_cost`).
    Flash launches: one per attention layer (dense, moe; hybrid: one per
    site of the shared block; ssm: none) and forward.  Returns the launch
    counts of the run, the served tokens {uid: [tokens]} and the
    parameters."""
    import numpy as np

    from repro_torch.models import init_all, layers, moe, transformer
    from repro_torch.models.ssm import _pick_chunk
    from repro_torch.serve import Engine
    # flash_attention calls of one forward
    attn_layers = {"ssm": 0, "hybrid": cfg.num_layers // max(1, cfg.shared_attn_every)}.get(
        cfg.family, cfg.num_layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    if params is None:
        params = init_all(cfg, seed=SERVE_SEED, device=dev)
    engine = Engine(cfg, params, max_batch=SERVE_SLOTS, max_len=SERVE_MAX_LEN, device=dev,
                    dist=dist)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    reqs = _serve_requests(SERVE_REQUESTS, cfg.vocab_size, np.random.default_rng(SERVE_SEED),
                           SERVE_PROMPT_RANGE, max_new, SERVE_SAMPLED)

    # CUDA events around every prefill and decode wave, and around every
    # attention and MoE call inside them; finiteness of every logit and the
    # MoE drops are folded on the card and read once at the end
    events = {"prefill": [], "decode": []}
    attn_events = {"prefill": [], "decode": []}
    moe_events = {"prefill": [], "decode": []}
    dropped = {k: torch.zeros((), dtype=torch.int64, device=dev) for k in events}
    kind_now = ["prefill"]
    finite = [torch.ones((), dtype=torch.bool, device=dev)]

    def pair():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed(fn, kind):
        def call(cfg_, params_, x, cache):
            kind_now[0] = kind
            a, b = pair()
            a.record()
            logits, cache = fn(cfg_, params_, x, cache)
            b.record()
            events[kind].append((a, b))
            finite[0] = finite[0] & torch.isfinite(logits).all()
            return logits, cache
        return call

    def timed_attention(*args, **kw):
        a, b = pair()
        a.record()
        o = flash_attention(*args, **kw)
        b.record()
        attn_events[kind_now[0]].append((a, b))
        return o

    def timed_moe(*args, **kw):
        a, b = pair()
        a.record()
        torch.cuda.set_sync_debug_mode("error")   # a MoE layer reads nothing back
        try:
            y, aux = moe_ffn(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        b.record()
        moe_events[kind_now[0]].append((a, b))
        dropped[kind_now[0]] += aux["dropped"]
        moe_hist[0] += moe_hist_launches(cfg, dist, args[2].shape[1])
        if moe_inputs is not None and kind_now[0] == "prefill" and len(admitted) == 1:
            moe_inputs.append((args[0], args[2], prompt_rows[0]))
        return y, aux

    # each prefill MoE layer's experts beside its admission's prompt rows
    # (the rest of the bucketed prefill is right-padding), for the drop split
    prompt_rows, prefill_routes, admitted, moe_hist = [0], [], [], [0]

    def admit(slot_idx, req):
        prompt_rows[0] = len(req.prompt) - 1
        admitted.append(prompt_rows[0])
        return engine_admit(slot_idx, req)

    def routed(*args, **kw):
        out = route(*args, **kw)
        if kind_now[0] == "prefill":
            prefill_routes.append((out[1], prompt_rows[0]))
        return out

    flash_attention, moe_ffn, route = layers.flash_attention, transformer.moe_ffn, moe.route
    layers.flash_attention, transformer.moe_ffn, moe.route = timed_attention, timed_moe, routed
    engine_admit, engine._admit = engine._admit, admit
    engine.api = engine.api._replace(prefill=timed(engine.api.prefill, "prefill"),
                                     decode_step=timed(engine.api.decode_step, "decode"))
    ops.reset_launches()
    t = time.perf_counter()
    try:
        out = engine.run(reqs)
        torch.cuda.synchronize()
    finally:
        layers.flash_attention, transformer.moe_ffn, moe.route = flash_attention, moe_ffn, route
        del engine._admit   # the class's method again: no cycle keeps the engine alive
    wall = time.perf_counter() - t
    counts = dict(ops.LAUNCHES)
    prefill_ms = [a.elapsed_time(b) for a, b in events["prefill"]]
    decode_ms = [a.elapsed_time(b) for a, b in events["decode"]]
    attn_ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in attn_events.items()}
    new_tokens = sum(len(v) for v in out.values())
    admissions = len(prefill_ms)
    line = {"phase": label, "arch": cfg.name, "family": cfg.family, "dtype": cfg.dtype,
            "dist": None if dist is None else {"dp": dist.dp, "ep": dist.ep,
                                               "moe_dispatch": dist.moe_dispatch,
                                               "int8_payload": cfg.moe_dispatch_int8},
            "params": cfg.param_count(), "layers": cfg.num_layers,
            "attention_layers": attn_layers, "slots": SERVE_SLOTS,
            "max_len": SERVE_MAX_LEN,
            "requests": len(out), "prompt_tokens": sum(len(r.prompt) for r in reqs),
            "prefill_tokens": engine.prefill_tokens, "decode_tokens": engine.decode_tokens,
            "max_new_tokens": max_new, "steps": engine.steps, "admissions": admissions,
            "setup_s": setup_s,
            "wall_s": wall, "output_tokens_per_s": new_tokens / wall,
            "prefill_ms_per_admission": statistics.mean(prefill_ms),
            "prefill_ms_total": sum(prefill_ms),
            "decode_ms_per_wave": statistics.mean(decode_ms),
            "decode_ms_per_wave_median": statistics.median(decode_ms),
            "decode_ms_total": sum(decode_ms),
            "attention_ms_in_prefill": attn_ms["prefill"],
            "attention_ms_in_decode": attn_ms["decode"],
            "host_ms_outside_model": wall * 1e3 - sum(prefill_ms) - sum(decode_ms),
            "peak_bytes": torch.cuda.max_memory_allocated(dev),
            "peak_gib": torch.cuda.max_memory_allocated(dev) / 2**30,
            "flash_launches": counts["flash_attention"],
            "flash_prefill_launches": counts["flash_attention_prefill"],
            "flash_decode_launches": counts["flash_attention_decode"], "launches": counts,
            "logits_finite": bool(finite[0])}
    moe_layers = sum(cfg.num_experts > 0 and l >= cfg.first_k_dense for l in range(cfg.num_layers))
    if cfg.ssm_state:
        line["prefill_by_admission"] = [
            {"tokens": n, "chunk": _pick_chunk(n, cfg.ssm_chunk), "ms": ms}
            for n, ms in zip([n for n in admitted if n > 0], prefill_ms)]
    if moe_layers:
        line.update({"moe_layers": moe_layers,
                     "moe_ms_in_prefill": sum(a.elapsed_time(b) for a, b in moe_events["prefill"]),
                     "moe_ms_in_decode": sum(a.elapsed_time(b) for a, b in moe_events["decode"]),
                     "moe_calls": sum(map(len, moe_events.values())),
                     "dropped_prefill": int(dropped["prefill"]),
                     "dropped_decode": int(dropped["decode"]),
                     "bucket_hist_launches": counts["bucket_hist"]})
        if dist is None:      # the dense dispatch's capacity: recount and split
            line.update(_prefill_drop_split(torch, prefill_routes, cfg.num_experts))
    emit(line)
    require(len(out) == SERVE_REQUESTS, f"{label}: {len(out)} of {SERVE_REQUESTS} requests served")
    require(all(len(v) == max_new for v in out.values()),
            f"{label}: a request ended short of its new tokens")
    require(line["logits_finite"], f"{label}: a logit is not finite")
    require(counts["flash_attention"] == attn_layers * (admissions + engine.steps),
            f"{label}: {counts['flash_attention']} flash launches != {attn_layers} x "
            f"({admissions} prefills + {engine.steps} decode waves)")
    require(counts["flash_attention_prefill"] == attn_layers * admissions
            and counts["flash_attention_decode"] == attn_layers * engine.steps,
            f"{label}: prefill / decode kernel launches {counts['flash_attention_prefill']} / "
            f"{counts['flash_attention_decode']}, not {attn_layers} attention layers x prefills "
            f"/ x waves")
    require(counts["bucket_hist"] == moe_hist[0]
            and len(moe_events["prefill"]) == moe_layers * admissions
            and len(moe_events["decode"]) == moe_layers * engine.steps,
            f"{label}: {counts['bucket_hist']} bucket_hist launches != {moe_hist[0]} from "
            f"{moe_layers} MoE layers x ({admissions} prefills + {engine.steps} decode waves)")
    if moe_layers:
        require(line["dropped_decode"] == 0, f"{label}: {line['dropped_decode']} decode drops")
    if moe_layers and dist is None:
        recount = line["dropped_prefill_prompt_rows"] + line["dropped_prefill_padding_rows"]
        require(recount == line["dropped_prefill"],
                f"{label}: {line['dropped_prefill']} prefill drops, {recount} recounted from the "
                f"routes")
    if cfg.family == "ssm":
        chunk_cost(torch, engine, dev)
    if trace:
        serve_trace(torch, engine, cfg, events)
    del engine
    return counts, out, params


def moe_hist_launches(cfg, dist, S: int) -> int:
    """bucket_hist launches of one `moe_ffn` over S positions (batch 1 a data
    shard): dense dispatch 1; expert parallel all_to_all (S % ep == 0, S >=
    ep) one a sender in each exchange (two exchanges with the int8 payload),
    one for every receiver's local bucketing, one for the load-balance
    counts; gather one a data shard."""
    if dist is None or dist.moe_dispatch == "dense":
        return 1
    ep = dist.ep
    if S % ep == 0 and S >= ep:
        return dist.dp * (ep * (2 if cfg.moe_dispatch_int8 else 1) + 1) + 1
    return dist.dp


def moe_ep_hist_shapes(cfg):
    """serve_moe_ep's bucket_hist calls at its longest prefill (2048 tokens,
    SERVE_PROMPT_RANGE's top) and a decode wave: (case, ids, k, share of
    the ids that are the pad value k, or None for ids uniform over k + 1
    values).  all_to_all: each sender's (token, choice) records by owner (k
    ep); every receiver's ep x capacity rows by global expert (k E, receiver
    r's local expert l being r e_local + l), the empty slots the pad value;
    the load-balance counts of every shard (k ep x E); gather (a decode
    wave): the records by global expert (k E).  Besides them one receiver's
    rows by local expert (k e_local), a register-bin instance that the
    dispatch no longer launches (it buckets every receiver at once)."""
    ep = MOE_EP_MESH["model"]
    k, E = cfg.experts_per_tok, cfg.num_experts
    e_local, S = E // ep, SERVE_PROMPT_RANGE[1]
    records = S // ep * k
    cap = int(cfg.moe_capacity_factor * (S // ep) * k / ep) + 8
    rows = ep * cap
    empty = 1 - records / rows
    return [(f"serve_moe_ep exchange, {S}-token prefill: one sender's {records} records, k {ep}",
             records, ep, 0.0),
            (f"serve_moe_ep local bucketing: every receiver's {ep * rows} rows, k {E}, "
             f"{empty:.1%} empty", ep * rows, E, empty),
            (f"serve_moe_ep load-balance counts: {ep * records} records, k {ep * E}",
             ep * records, ep * E, 0.0),
            (f"serve_moe_ep gather, a decode wave: {SERVE_SLOTS * k} records, k {E}",
             SERVE_SLOTS * k, E, 0.0),
            (f"one receiver's {rows} rows by local expert, k {e_local}, {empty:.1%} empty "
             f"(register bins; not launched by the dispatch)", rows, e_local, empty)]


def moe_ep_parity(torch, ops, dev):
    """Check (a) of serve_moe_ep: the deepseek-v2 smoke's MoE layer (f32)
    under MOE_EP_MESH's expert dispatch at each MOE_EP_PARITY case (S 16:
    all_to_all, bf16 payload and int8; S 1 and 6: gather), on the card and
    on the CPU (plain bucket_hist): y within 1e-5 (int8: plus one
    quantisation step, 1/127 of the output's largest magnitude, and farther
    than 1e-5 from the full-precision payload's y on the card), dropped
    equal, bucket_hist launched on the card, no host sync."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import make_dist
    from repro_torch.models import init_all, moe

    rows = []
    for S, int8 in MOE_EP_PARITY:
        cfg = get_smoke_config(MOE_ARCH).with_(moe_dispatch_int8=int8)
        dist = make_dist(cfg, MOE_EP_MESH)
        p = init_all(cfg, seed=SERVE_SEED, device="cpu")["blocks"][cfg.first_k_dense]["ffn"]
        x = torch.randn(2, S, cfg.d_model, generator=torch.Generator().manual_seed(S))
        want, want_aux = moe.moe_ffn(p, cfg, x, dist)
        p, x = _to(p, dev), x.to(dev)
        torch.cuda.synchronize()
        before = ops.LAUNCHES["bucket_hist"]
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux = moe.moe_ffn(p, cfg, x, dist)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        launched = ops.LAUNCHES["bucket_hist"] - before
        err = float((y.cpu() - want).abs().max())
        tol = 1e-5 + (float(want.abs().max()) / 127 if int8 else 0.0)
        row = {"S": S, "int8": int8, "route": "all_to_all" if S % dist.ep == 0 else "gather",
               "max_abs_diff": err, "tolerance": tol, "dropped": int(aux["dropped"]),
               "bucket_hist_launches": launched}
        if int8:
            # the int8 payload ran: the card's output is farther from the
            # full-precision payload's than the f32 tolerance
            full = moe.moe_ffn(p, cfg.with_(moe_dispatch_int8=False), x, dist)[0]
            row["diff_from_full_payload"] = float((y - full).abs().max())
            require(row["diff_from_full_payload"] > 1e-5,
                    f"serve_moe_ep parity S {S}: the int8 payload left y as the full one's")
        rows.append(row)
        require(err <= tol, f"serve_moe_ep parity S {S} int8 {int8}: y differs by {err} > {tol}")
        require(int(aux["dropped"]) == int(want_aux["dropped"]),
                f"serve_moe_ep parity S {S}: dropped {int(aux['dropped'])} card, "
                f"{int(want_aux['dropped'])} CPU")
        require(launched > 0, f"serve_moe_ep parity S {S}: no bucket_hist launch on the card")
    emit({"phase": "serve_moe_ep_parity", "arch": get_smoke_config(MOE_ARCH).name,
          "mesh": MOE_EP_MESH, "cases": rows})


def serve_moe_ep_phase(torch, ops, dev, params, dense_out):
    """deepseek-v2-lite-16b at full width and depth with serve_moe's weights
    (`params`, still on the card) and requests, behind the Engine with
    `make_dist(cfg, MOE_EP_MESH)`: 4 expert shards, prefills by all_to_all,
    decode waves by gather; once with the bf16 payload and once with the
    int8 one, each request cut to MOE_EP_NEW_TOKENS new tokens.  Before
    them check (a) (`moe_ep_parity`).  Each run's serve line (serve_phase:
    tokens/s, prefill and decode ms, MoE ms, drops, bucket_hist launches,
    peak) and a line with the share of its greedy tokens equal to
    serve_moe's dense-dispatch run (`dense_out`, first MOE_EP_NEW_TOKENS of
    each request; printed, not required: EP changes the capacity and the
    sums' order) and check (b): the first admission's first and last MoE
    layers on their prompt rows (cut to a multiple of 4: all_to_all), EP
    against dense dispatch within PARITY_BF16_TOL where neither drops (bf16
    payload; the int8 payload's difference is printed).  Returns the launch
    counts of the two runs."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import make_dist
    from repro_torch.models import moe

    moe_ep_parity(torch, ops, dev)
    gather_ep_repeat(torch, dev, get_config(MOE_ARCH), params)
    counts = {}
    for int8 in (False, True):
        cfg = get_config(MOE_ARCH).with_(moe_dispatch_int8=int8)
        dist = make_dist(cfg, MOE_EP_MESH)
        label = "serve_moe_ep_int8" if int8 else "serve_moe_ep"
        inputs = []
        counts[label], out, _ = serve_phase(torch, ops, dev, cfg, label, dist=dist, params=params,
                                            max_new=MOE_EP_NEW_TOKENS, trace=False,
                                            moe_inputs=inputs)
        same = sum(a == b for uid, toks in out.items()
                   for a, b in zip(toks, dense_out[uid][:MOE_EP_NEW_TOKENS]))
        greedy = [uid for uid in out if uid not in SERVE_SAMPLED]
        same_greedy = sum(a == b for uid in greedy
                          for a, b in zip(out[uid], dense_out[uid][:MOE_EP_NEW_TOKENS]))
        layers = []
        for li in (0, len(inputs) - 1):
            p, x, n = inputs[li]
            x = x[:, :n - n % dist.ep]
            y, aux = moe.moe_ffn(p, cfg, x, dist)
            want, want_aux = moe.moe_ffn(p, cfg, x)
            layers.append({"moe_call": li, "tokens": x.shape[1], "dropped": int(aux["dropped"]),
                           "dense_dropped": int(want_aux["dropped"]),
                           "max_abs_diff": float((y - want).abs().max()),
                           "dense_max_abs": float(want.abs().max())})
        line = {"phase": label + "_check", "greedy_tokens_equal_dense": same_greedy,
                "greedy_tokens": len(greedy) * MOE_EP_NEW_TOKENS,
                "greedy_share_equal_dense": same_greedy / (len(greedy) * MOE_EP_NEW_TOKENS),
                "share_equal_dense_all": same / (len(out) * MOE_EP_NEW_TOKENS),
                "ep_vs_dense_layers": layers, "tolerance": PARITY_BF16_TOL}
        emit(line)
        if not int8:
            checked = [r for r in layers if r["dropped"] == 0 == r["dense_dropped"]]
            require(checked, f"{label}: every checked layer dropped records")
            worst = max(r["max_abs_diff"] for r in checked)
            require(worst <= PARITY_BF16_TOL,
                    f"{label}: EP differs from dense dispatch by {worst} > {PARITY_BF16_TOL}")
        require(counts[label]["bucket_hist"] > 0, f"{label}: bucket_hist never launched")
    return counts


def gather_ep_repeat(torch, dev, cfg, params):
    """The gather route is repeatable on the card: serve_moe's first MoE
    layer (full width, bf16, on the card) under MOE_EP_MESH's dispatch on a
    decode wave of SERVE_SLOTS tokens, GATHER_REPEATS times: every output
    bit-equal to the first.  Six experts over four shards put at least two
    of every token's experts on one shard, whose partial row then sums
    several records (an atomic scatter-add would sum them in any order)."""
    from repro_torch.distributed.sharding import make_dist
    from repro_torch.models import moe

    dist = make_dist(cfg, MOE_EP_MESH)
    p = params["blocks"][cfg.first_k_dense]["ffn"]
    g = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    x = torch.randn(SERVE_SLOTS, 1, cfg.d_model, generator=g, device=dev).to(cfg.torch_dtype)
    with torch.no_grad():
        experts = moe.route(p, cfg, x.reshape(-1, cfg.d_model))[1]
        owners = torch.sort(experts // (cfg.num_experts // dist.ep), dim=1).values
        shared = int((owners[:, 1:] == owners[:, :-1]).any(dim=1).sum())
        ys = [moe.moe_ffn(p, cfg, x, dist)[0] for _ in range(GATHER_REPEATS)]
    differing = [i for i, y in enumerate(ys) if not torch.equal(y, ys[0])]
    emit({"phase": "serve_moe_ep_gather_repeat", "tokens": SERVE_SLOTS, "repeats": GATHER_REPEATS,
          "tokens_with_two_experts_on_a_shard": shared, "runs_differing_from_first": differing})
    require(shared > 0, "gather_ep_repeat: no token has two experts on one shard")
    require(not differing, f"gather_ep_repeat: runs {differing} differ from the first")


def chunk_cost(torch, engine, dev):
    """One admission's prefill (one slot, the engine's api and parameters)
    at each of CHUNK_COST_LENGTHS prompt tokens: the median of 3 CUDA-event
    times, beside the SSD chunk the reference's `_pick_chunk` gives that
    length (a prime length above 256 gives chunks of 1: one step of the
    inter-chunk loop per position and layer)."""
    from repro_torch.models.ssm import _pick_chunk

    cfg, api, params = engine.cfg, engine.api, engine.params
    g = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    rows = []
    for S in CHUNK_COST_LENGTHS:
        tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=g, device=dev,
                               dtype=torch.int32)
        ms = []
        for _ in range(3):
            cache = api.init_cache(cfg, 1, S, dev)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            api.prefill(cfg, params, {"tokens": tokens}, cache)
            b.record()
            b.synchronize()
            ms.append(a.elapsed_time(b))
        Q = _pick_chunk(S, cfg.ssm_chunk)
        rows.append({"tokens": S, "chunk": Q, "chunks": S // Q, "ms": statistics.median(ms)})
    emit({"phase": "chunk_cost", "arch": cfg.name, "layers": cfg.num_layers, "admissions": rows})


def generate_phase(torch, ops, dev, arch, label):
    """`arch` (encdec or vlm) at full width and depth, bf16, seeded random
    weights on the card, through `prefill` and `decode_step`, its family's
    only entry points in the reference (whose Engine does not take it):
    encdec ENCDEC_BATCH sequences of ENCDEC_FRAMES encoder frames and an
    ENCDEC_PROMPT-token decoder prompt, vlm VLM_BATCH sequences of the
    config's image tokens and VLM_TEXT text tokens (`input_specs`' random
    embeddings: the frontends are stubs, as in the reference); then
    GEN_STEPS greedy decode steps.  CUDA-event ms of encode + prefill and of
    each decode step, launch counts set to 0 just before and read just
    after, every logit finite, every token in the vocabulary, the flash
    launches: a prefill runs the prefill kernel once per attention call
    (encdec: encoder self-attention, decoder self- and cross-attention;
    vlm: each layer), a decode step the decode kernel (encdec: self and
    cross; vlm: each layer).  The prefill's last logits are held to a
    forward without a cache over the same batch (PARITY_BF16_TOL).
    Returns the launch counts of the run."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model, init_all, input_specs

    cfg = get_config(arch)
    api = get_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    params = init_all(cfg, seed=SERVE_SEED, device=dev)
    if cfg.family == "encdec":
        B = ENCDEC_BATCH
        batch = input_specs(cfg, "prefill", B, ENCDEC_FRAMES, seed=SERVE_SEED, device=dev)
        batch["tokens"] = batch["tokens"][:, :ENCDEC_PROMPT].contiguous()
        prompt = ENCDEC_PROMPT
        prefill_calls, decode_calls = cfg.encoder_layers + 2 * cfg.num_layers, 2 * cfg.num_layers
    else:
        B = VLM_BATCH
        batch = input_specs(cfg, "prefill", B, cfg.num_image_tokens + VLM_TEXT, seed=SERVE_SEED,
                            device=dev)
        prompt = cfg.num_image_tokens + VLM_TEXT
        prefill_calls = decode_calls = cfg.num_layers
    cache = api.init_cache(cfg, B, prompt + GEN_STEPS, dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t

    def pair():
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    ops.reset_launches()
    t = time.perf_counter()
    a, b = pair()
    a.record()
    logits, cache = api.prefill(cfg, params, batch, cache)
    b.record()
    prefill_events, decode_events = (a, b), []
    finite = torch.isfinite(logits).all()
    tokens = [logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)]
    for _ in range(GEN_STEPS):
        a, b = pair()
        a.record()
        logits, cache = api.decode_step(cfg, params, tokens[-1], cache)
        b.record()
        decode_events.append((a, b))
        finite = finite & torch.isfinite(logits).all()
        tokens.append(logits[:, -1].argmax(-1, keepdim=True).to(torch.int32))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = dict(ops.LAUNCHES)
    prefill_ms = prefill_events[0].elapsed_time(prefill_events[1])
    decode_ms = [a.elapsed_time(b) for a, b in decode_events]
    generated = torch.cat(tokens, dim=1)
    in_vocab = bool(((generated >= 0) & (generated < cfg.vocab_size)).all())
    peak = torch.cuda.max_memory_allocated(dev)
    first = api.prefill(cfg, params, batch, api.init_cache(cfg, B, prompt, dev))[0][:, -1]
    full = api.forward(cfg, params, batch)[0][:, -1]
    forward_err = float((first - full).abs().max())
    line = {"phase": label, "arch": cfg.name, "family": cfg.family, "dtype": cfg.dtype,
            "params": cfg.param_count(), "layers": cfg.num_layers,
            "encoder_layers": cfg.encoder_layers, "batch": B, "prompt_tokens": prompt,
            "encoder_frames": ENCDEC_FRAMES if cfg.family == "encdec" else 0,
            "image_tokens": cfg.num_image_tokens, "decode_steps": GEN_STEPS,
            "setup_s": setup_s, "wall_s": wall, "prefill_ms": prefill_ms,
            "decode_ms_per_step": statistics.mean(decode_ms),
            "decode_ms_per_step_median": statistics.median(decode_ms),
            "decode_tokens_per_s": B * GEN_STEPS / (sum(decode_ms) / 1e3),
            "peak_bytes": peak, "peak_gib": peak / 2**30,
            "flash_launches": counts["flash_attention"],
            "flash_prefill_launches": counts["flash_attention_prefill"],
            "flash_decode_launches": counts["flash_attention_decode"],
            "logits_finite": bool(finite), "tokens_in_vocab": in_vocab,
            "prefill_vs_forward_max_abs": forward_err, "tolerance": PARITY_BF16_TOL,
            "tokens_first_sequence": generated[0, :16].tolist()}
    emit(line)
    require(line["logits_finite"], f"{label}: a logit is not finite")
    require(in_vocab, f"{label}: a generated token is outside the vocabulary")
    require(forward_err <= PARITY_BF16_TOL,
            f"{label}: prefill's last logits differ from forward's by {forward_err}")
    require(counts["flash_attention_prefill"] == prefill_calls
            and counts["flash_attention_decode"] == decode_calls * GEN_STEPS
            and counts["flash_attention"] == prefill_calls + decode_calls * GEN_STEPS,
            f"{label}: flash launches {counts['flash_attention_prefill']} prefill / "
            f"{counts['flash_attention_decode']} decode, want {prefill_calls} / "
            f"{decode_calls} x {GEN_STEPS}")
    del params, cache, batch
    return counts


def _prefill_drop_split(torch, routes, E):
    """The prefill drops recounted from each MoE layer's experts [T, k] with
    plain ops, and split by row: a (token, choice) record is dropped when
    cap = max(8, T k 4 / E) records of its expert come before it in token
    order; its token is a prompt row below the admission's prompt length,
    else right-padding."""
    prompt = padding = 0
    for experts, n in routes:
        T, k = experts.shape
        cap = max(8, (T * k * 4) // E)
        flat = experts.reshape(-1)
        onehot = (flat[:, None] == torch.arange(E, device=flat.device)).int()
        rank = onehot.cumsum(0).gather(1, flat[:, None])[:, 0] - 1
        drop = rank >= cap
        real = torch.arange(T * k, device=flat.device) // k < n
        prompt += int((drop & real).sum())
        padding += int((drop & ~real).sum())
    return {"dropped_prefill_prompt_rows": prompt, "dropped_prefill_padding_rows": padding}


def serve_trace(torch, engine, cfg, events):
    """A short window of the same engine under torch.profiler (one request
    of 512 prompt tokens and 16 new tokens a slot; the card's activity only,
    which keeps the profiler's processing on the host short: the line's
    "seconds" against "wall_ms"): the card's busy share (kernel and copy
    time over the window's wall time; the profiler's own host cost makes the
    idle share an upper bound), the device time by kernel, and the window's
    prefills and decode waves with their CUDA-event ms (`events`: the
    engine's timed prefill and decode_step append to it)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import attribution

    reqs = _serve_requests(SERVE_SLOTS, cfg.vocab_size, np.random.default_rng(SERVE_SEED + 1),
                           (TRACE_PROMPT, TRACE_PROMPT), TRACE_NEW_TOKENS, ())
    before = {kind: len(v) for kind, v in events.items()}
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        engine.run(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    window = {kind: [a.elapsed_time(b) for a, b in v[before[kind]:]] for kind, v in events.items()}
    # device-side rows only (kernels, copies)
    device_ms = sum(ms for ms, _, _ in attribution.device_rows(prof))
    require(device_ms > 0, "serve_trace: the profiler saw no device time")
    emit({"phase": "serve_trace", "arch": cfg.name, "requests": len(reqs),
          "prompt_tokens": TRACE_PROMPT,
          "new_tokens": TRACE_NEW_TOKENS, "prefills": len(window["prefill"]),
          "decode_waves": len(window["decode"]), "prefill_ms": sum(window["prefill"]),
          "decode_ms": sum(window["decode"]),
          "wall_ms": wall_ms, "device_ms": device_ms, "busy_share": device_ms / wall_ms,
          "seconds": time.perf_counter() - t0,
          "top_device_ms": top_device_ms(attribution, prof, 10)})


def top_device_ms(attribution, prof, n: int) -> list:
    """The n kernels and copies with the most device time in a profile."""
    return [{"name": name[:90], "ms": ms, "calls": c}
            for ms, name, c in attribution.top_bytes(prof, n)]


def _train_state_pair(dev, arch):
    """(cfg, CPU state, card state, CPU batch, card batch) of a smoke config
    from one seeded draw on the CPU, copied to the card."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_all, input_specs
    from repro_torch.train import OptimConfig, init_state, tree

    cfg = get_smoke_config(arch)
    ocfg = OptimConfig(lr=3e-3, warmup_steps=2, total_steps=100)
    params = init_all(cfg, seed=TRAIN_SEED, device="cpu")
    on_card = tree.tree_map(lambda t: t.to(dev, copy=True), params)
    batch = input_specs(cfg, "train", TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ, seed=TRAIN_SEED,
                        device="cpu")
    return (cfg, ocfg, init_state(cfg, ocfg, params=params),
            init_state(cfg, ocfg, params=on_card), batch,
            {k: v.to(dev) for k, v in batch.items()})


def train_parity_phase(torch, ops, dev):
    """The train path on the card against the CPU: for each of
    TRAIN_PARITY_RUNS (dense, moe, ssm; f32 smokes; and deepseek-v2's
    smoke under expert-parallel dispatch over 4 expert shards)
    TRAIN_PARITY_STEPS steps of make_train_step from the same params and
    batch on both, losses
    within TRAIN_LOSS_RTOL, final params within TRAIN_PARAM_ATOL, every
    grad_norm finite, no flash_attention launch (the train route is the
    reference's chunked attention); the flash kernel refuses inputs that
    need a gradient; a bf16 smoke state saved from the card (async) and
    restored has equal leaves; launch/train.py run 4 steps, then resumed
    from its --ckpt-dir to TRAIN_RESUME_STEPS, gives the uninterrupted run's
    losses within TRAIN_LOSS_RTOL."""
    import tempfile

    from repro_torch.configs import get_smoke_config
    from repro_torch.distributed.sharding import make_dist
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.train import main as train_cli
    from repro_torch.models import input_specs
    from repro_torch.train import OptimConfig, checkpoint, init_state, make_train_step, tree

    t0 = time.perf_counter()
    rows = []
    for arch, mesh in TRAIN_PARITY_RUNS:
        cfg, ocfg, cpu_state, card_state, cpu_batch, card_batch = _train_state_pair(dev, arch)
        step_fn = make_train_step(cfg, ocfg, make_dist(cfg, mesh) if mesh else None)
        losses = {"cpu": [], "card": []}
        norms = []
        ops.reset_launches()
        for _ in range(TRAIN_PARITY_STEPS):
            card_state, m = step_fn(card_state, card_batch)
            losses["card"].append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        counts = dict(ops.LAUNCHES)
        for _ in range(TRAIN_PARITY_STEPS):
            cpu_state, m = step_fn(cpu_state, cpu_batch)
            losses["cpu"].append(float(m["loss"]))
        loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses["card"], losses["cpu"]))
        param_err = max(float((a.detach().cpu() - b.detach()).abs().max()) for a, b in
                        zip(tree.leaves(card_state.params), tree.leaves(cpu_state.params)))
        row = {"arch": arch, "family": cfg.family, "mesh": mesh, "losses_card": losses["card"],
               "losses_cpu": losses["cpu"], "loss_max_rel": loss_rel,
               "param_max_abs": param_err, "grad_norms_card": norms,
               "flash_launches": counts["flash_attention"],
               "bucket_hist_launches": counts["bucket_hist"]}
        rows.append(row)
        require(all(math.isfinite(n) for n in norms), f"train_parity {arch}: grad_norm {norms}")
        require(loss_rel <= TRAIN_LOSS_RTOL and param_err <= TRAIN_PARAM_ATOL,
                f"train_parity {arch}: losses {losses}, params max |diff| {param_err}")
        require(counts["flash_attention"] == 0, f"train_parity {arch}: flash_attention launched")
        require(cfg.family != "moe" or counts["bucket_hist"] > 0,
                f"train_parity {arch}: MoE dispatch never launched bucket_hist")

    # the flash kernel has no backward: inputs that need a gradient raise
    g = torch.Generator(device=dev).manual_seed(TRAIN_SEED)
    q, k, v = (torch.randn(1, 2, 32, 64, generator=g, device=dev, dtype=torch.bfloat16)
               for _ in range(3))
    refused = False
    try:
        flash_attention(q.requires_grad_(True), k, v)
    except RuntimeError:
        refused = True
    with torch.no_grad():
        served = flash_attention(q, k, v)
    require(refused, "flash_attention returned an output for q that requires grad")
    require(bool(torch.isfinite(served).all()), "flash_attention under no_grad")

    # a bf16 smoke state from the card through an async checkpoint
    cfg = get_smoke_config(TRAIN_ARCH).with_(dtype="bfloat16")
    ocfg = OptimConfig(lr=3e-3, warmup_steps=2, total_steps=100)
    state = init_state(cfg, ocfg, seed=TRAIN_SEED, device=dev)
    batch = input_specs(cfg, "train", TRAIN_PARITY_BATCH, TRAIN_PARITY_SEQ, seed=TRAIN_SEED,
                        device=dev)
    state, _ = make_train_step(cfg, ocfg)(state, batch)
    with tempfile.TemporaryDirectory() as d:
        checkpoint.save(d, 0, state, blocking=False)
        checkpoint.wait_for_async_saves()
        restored, step = checkpoint.restore_latest(d, state)
        leaves = tree.leaves(state)
        ckpt_equal = step == 0 and all(
            a.dtype == b.dtype and a.device == b.device and torch.equal(a, b)
            for a, b in zip(tree.leaves(restored), leaves))
    require(ckpt_equal, "train_parity: restored checkpoint differs from the saved state")

    # launch/train.py: interrupted after 4 steps, resumed from --ckpt-dir
    argv = ["--scale", "12", "--batch", "4", "--seq", "32", "--lr", "3e-3",
            "--ckpt-every", "4", "--device", "cuda"]
    with tempfile.TemporaryDirectory() as a, tempfile.TemporaryDirectory() as b:
        whole = train_cli(argv + ["--steps", str(TRAIN_RESUME_STEPS), "--ckpt-dir", a])
        first = train_cli(argv + ["--steps", "4", "--ckpt-dir", b])
        rest = train_cli(argv + ["--steps", str(TRAIN_RESUME_STEPS), "--ckpt-dir", b])
    resumed = first + rest
    resume_rel = max(abs(x - y) / abs(y) for x, y in zip(resumed, whole))
    emit({"phase": "train_parity", "runs": rows, "loss_rtol": TRAIN_LOSS_RTOL,
          "param_atol": TRAIN_PARAM_ATOL, "flash_refuses_grad": refused,
          "checkpoint_bf16_equal": ckpt_equal, "resume_losses": resumed,
          "uninterrupted_losses": whole, "resume_max_rel": resume_rel,
          "seconds": time.perf_counter() - t0})
    require(len(rest) == TRAIN_RESUME_STEPS - 4 and resume_rel <= TRAIN_LOSS_RTOL,
            f"train_parity: resumed losses {resumed} against {whole}")


def train_main_phase(torch, ops, dev):
    """internlm2-1.8b at full width (bf16 params, f32 master and Adam
    moments) trained TRAIN_STEPS steps (warmup TRAIN_WARMUP) on WalkLoader
    batches (B TRAIN_BATCH x S TRAIN_SEQ, the model's vocabulary) of a
    scale-TRAIN_SCALE nb-8 graph generated on the card; launch counts set to
    0 just before generate and read after the last step.  Per step: loss,
    grad_norm, lr and CUDA-event ms of forward + backward and of the
    optimizer (`optim.apply_updates`, timed by a wrapper); the median from
    step TRAIN_TIMED_FROM on, tokens/s = B S / step time, and the same over
    the host's wall time of those steps (their batches' production and any
    stall between steps included: the end-to-end rate), peak memory from
    the phase's start; step 0's Roofline (`roofline.from_measured`: its
    flops counted) and the measured share of the bf16 peak, mfu =
    model_flops_for_cell at B x S / (989e12 x the median step).  The losses are finite and the mean of the last 3 is
    below the first; flash_attention is never launched.  Returns the launch
    counts of the run."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.core.pipeline import generate
    from repro_torch.core.types import GraphConfig
    from repro_torch.data import LoaderConfig, WalkLoader
    from repro_torch.launch import roofline
    from repro_torch.launch.mesh import BF16_OPS_PER_S
    from repro_torch.train import OptimConfig, init_state, make_train_step, tree
    from repro_torch.train import optim as optim_lib

    cfg = get_config(TRAIN_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    gcfg = GraphConfig(scale=TRAIN_SCALE, nb=NB)
    res = generate(gcfg, device=dev)
    require(int(res.dropped_redistribute) == 0, "train_main: generate dropped records")
    loader = WalkLoader(gcfg, res.csr, LoaderConfig(batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                                    vocab=cfg.vocab_size), device=dev)
    del res
    torch.cuda.synchronize()
    graph_s = time.perf_counter() - t0
    graph_counts = dict(ops.LAUNCHES)
    t = time.perf_counter()
    ocfg = OptimConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS)
    state = init_state(cfg, ocfg, seed=TRAIN_SEED, device=dev)
    step_fn = make_train_step(cfg, ocfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    marks = []          # (start, optimizer start, end) events of each step
    apply_updates = optim_lib.apply_updates

    def timed_updates(*args, **kw):
        marks[-1].append(event())
        out = apply_updates(*args, **kw)
        marks[-1].append(event())
        return out

    metrics = []
    model_flops = roofline.model_flops_for_cell(
        cfg, ShapeSpec("train_main", TRAIN_SEQ, TRAIN_BATCH, "train"))
    optim_lib.apply_updates = timed_updates
    try:
        t = time.perf_counter()
        for step in range(TRAIN_STEPS):
            if step == TRAIN_TIMED_FROM:
                torch.cuda.synchronize()
                t_from = time.perf_counter()
            batch = loader.batch(step)
            marks.append([event()])
            if step == 0:     # a warm-up step: its flops counted (roofline.from_measured)
                roof, (state, m) = roofline.from_measured(step_fn, (state, batch),
                                                          model_flops=model_flops, kind="train")
            else:
                state, m = step_fn(state, batch)
            metrics.append(m)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t
        wall_ms = (time.perf_counter() - t_from) * 1e3 / (TRAIN_STEPS - TRAIN_TIMED_FROM)
    finally:
        optim_lib.apply_updates = apply_updates
    counts = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [float(m["loss"]) for m in metrics]
    fwd_bwd = [a.elapsed_time(b) for a, b, _ in marks]
    optim_ms = [b.elapsed_time(c) for _, b, c in marks]
    step_ms = [a.elapsed_time(c) for a, _, c in marks]
    med = statistics.median(step_ms[TRAIN_TIMED_FROM:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    line = {"phase": "train_main", "arch": cfg.name, "dtype": cfg.dtype,
            "params": sum(p.numel() for p in tree.leaves(state.params)),
            "layers": cfg.num_layers, "d_model": cfg.d_model, "vocab": cfg.vocab_size,
            "graph_scale": TRAIN_SCALE, "nb": NB, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
            "steps": TRAIN_STEPS, "warmup": TRAIN_WARMUP, "lr_peak": TRAIN_LR,
            "graph_s": graph_s, "init_s": init_s, "train_s": train_s,
            "losses": losses, "grad_norms": [float(m["grad_norm"]) for m in metrics],
            "lrs": [float(m["lr"]) for m in metrics],
            "step_ms": step_ms, "fwd_bwd_ms": fwd_bwd, "optimizer_ms": optim_ms,
            "step_ms_median": med,
            "fwd_bwd_ms_median": statistics.median(fwd_bwd[TRAIN_TIMED_FROM:]),
            "optimizer_ms_median": statistics.median(optim_ms[TRAIN_TIMED_FROM:]),
            "tokens_per_step": tokens, "tokens_per_s": tokens / (med / 1e3),
            "wall_step_ms": wall_ms, "wall_tokens_per_s": tokens / (wall_ms / 1e3),
            "peak_bytes": peak, "peak_gib": peak / 2**30,
            "graph_launches": graph_counts, "launches": counts,
            "roofline": roof.as_dict(), "mfu": model_flops / (BF16_OPS_PER_S * med / 1e3)}
    emit(line)
    train_trace(torch, step_fn, state, loader)
    require(all(math.isfinite(x) for x in losses), f"train_main: losses {losses}")
    require(statistics.mean(losses[-3:]) < losses[0], f"train_main: loss did not fall {losses}")
    require(counts["flash_attention"] == 0, "train_main: flash_attention launched")
    for name in ("rmat_edges", "relabel_gather", "bucket_hist"):
        require(graph_counts[name] > 0, f"train_main: generate never launched {name}")
    del state, loader, metrics
    return counts


def train_trace(torch, step_fn, state, loader):
    """TRAIN_TRACE_STEPS more steps of train_main under torch.profiler (the
    card's activity only): the card's busy share (kernel and copy time over
    the window's wall time) and the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import attribution

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for step in range(TRAIN_STEPS, TRAIN_STEPS + TRAIN_TRACE_STEPS):
            state, _ = step_fn(state, loader.batch(step))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    device_ms = sum(ms for ms, _, _ in attribution.device_rows(prof))
    require(device_ms > 0, "train_trace: the profiler saw no device time")
    emit({"phase": "train_trace", "steps": TRAIN_TRACE_STEPS, "wall_ms": wall_ms,
          "device_ms": device_ms, "busy_share": device_ms / wall_ms,
          "seconds": time.perf_counter() - t0,
          "top_device_ms": top_device_ms(attribution, prof, 12),
          "device_ms_by_kind": attribution.by_op(prof)})


def train_external_phase(torch, ops, dev):
    """launch/train.py's out-of-core route on the card (`main` with
    TRAIN_EXTERNAL_ARGV, its smoke config): StreamingGenerator, then
    ExternalWalkLoader, then training.  Launch counts set to 0 just before
    and read just after; the loss falls (mean of the last 5 below the
    first 5's) and the disk tier's hooks launched their graph kernels.
    Returns the launch counts of the run."""
    from repro_torch.launch.train import main as train_cli

    ops.reset_launches()
    t0 = time.perf_counter()
    losses = train_cli(TRAIN_EXTERNAL_ARGV + ["--device", "cuda"])
    wall = time.perf_counter() - t0
    counts = dict(ops.LAUNCHES)
    emit({"phase": "train_external", "argv": TRAIN_EXTERNAL_ARGV, "losses": losses,
          "wall_s": wall, "launches": counts})
    require(all(math.isfinite(x) for x in losses)
            and statistics.mean(losses[-5:]) < statistics.mean(losses[:5]),
            f"train_external: loss did not fall {losses}")
    for name in ("rmat_edges", "relabel_gather", "bucket_hist"):
        require(counts[name] > 0, f"train_external: the disk tier never launched {name}")
    require(counts["flash_attention"] == 0, "train_external: flash_attention launched")
    return counts


def train_moe_ep_phase(torch, ops, dev):
    """deepseek-v2-lite-16b at full width (d 2048, MLA 192/128, 64 experts
    top-6 + 2 shared, vocab 102400), depth cut to TRAIN_MOE_EP_LAYERS, bf16
    params with f32 master and moments, trained under expert-parallel
    dispatch over MOE_EP_MESH (16 experts a shard, all_to_all) through
    launch/perf.py::run_variant at train_4k's 4096 tokens, one sequence a
    step, train_main's optimizer settings, TRAIN_MOE_EP_STEPS steps of one
    seeded batch (`input_specs(cfg, "train", 1, 4096, seed=0)`); once per
    TRAIN_MOE_EP_VARIANTS (the bf16 payload, then the int8 one).  Launch
    counts set to 0 just before each run and read just after.  Each run's
    line: losses, lb_loss, dropped, step ms (CUDA events), peak GiB, the
    Roofline of its first step, mfu, the top kernels; the parameters against
    `param_count()`.  The losses are finite and the mean of the last 3 below
    the first; no flash launch; bucket_hist launches = MoE layers x
    `moe_hist_launches` x steps.  Returns the launch counts of the runs."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.distributed.sharding import make_dist
    from repro_torch.launch.perf import run_variant
    from repro_torch.train import OptimConfig

    cfg_update = {"num_layers": TRAIN_MOE_EP_LAYERS}
    ocfg = OptimConfig(lr=TRAIN_LR, warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS)
    shape = SHAPES["train_4k"]
    counts, step_ms = {}, {}
    for variant in TRAIN_MOE_EP_VARIANTS:
        label = "train_moe_ep" if variant == "baseline" else "train_moe_ep_int8"
        cfg = get_config(MOE_ARCH).with_(**cfg_update)
        cfg = cfg.with_(moe_dispatch_int8=variant == "dispatch_int8")
        moe_layers = cfg.num_layers - cfg.first_k_dense
        want_hist = (moe_layers * moe_hist_launches(cfg, make_dist(cfg, MOE_EP_MESH), shape.seq_len)
                     * TRAIN_MOE_EP_STEPS)
        torch.cuda.synchronize()
        ops.reset_launches()
        t = time.perf_counter()
        rec = run_variant(MOE_ARCH, shape, variant, cfg_update=cfg_update, ocfg=ocfg,
                          mesh_shape=MOE_EP_MESH, batch=TRAIN_MOE_EP_BATCH,
                          steps=TRAIN_MOE_EP_STEPS, device=dev)
        torch.cuda.synchronize()
        counts[label] = dict(ops.LAUNCHES)
        step_ms[variant] = rec["step_ms_median"]
        losses = rec["losses"]
        emit({"phase": label, "variant": variant, "mesh": MOE_EP_MESH, "layers": cfg.num_layers,
              "moe_layers": moe_layers, "params": rec["params"],
              "param_count": rec["param_count"], "batch": rec["batch"], "seq": rec["seq_len"],
              "steps": rec["steps"], "losses": losses, "lb_loss": rec["lb_loss"],
              "dropped": rec["dropped"], "grad_norms": rec["grad_norms"],
              "step_ms": rec["step_ms"], "step_ms_median": rec["step_ms_median"],
              "tokens_per_s": rec["tokens_per_s"], "peak_gib": rec["peak_gib"],
              "mfu": rec["mfu"], "useful_flops_ratio": rec["roofline"]["useful_flops_ratio"],
              "roofline": rec["roofline"], "top_kernels": rec["top_kernels"],
              "device_ms_by_kind": rec["device_ms_by_kind"], "launches": counts[label],
              "bucket_hist_want": want_hist, "wall_s": time.perf_counter() - t,
              **({"int8_step_ms_over_bf16": rec["step_ms_median"] / step_ms["baseline"]}
                 if variant != "baseline" else {})})
        require(all(math.isfinite(x) for x in losses)
                and statistics.mean(losses[-3:]) < losses[0], f"{label}: losses {losses}")
        require(counts[label]["flash_attention"] == 0, f"{label}: flash_attention launched")
        require(counts[label]["bucket_hist"] == want_hist,
                f"{label}: {counts[label]['bucket_hist']} bucket_hist launches, want {want_hist}")
        torch.cuda.empty_cache()
    return counts


def dryrun_phase():
    """launch/dryrun.py over every arch x shape on the meta device: one line
    a cell (params, state or cache bytes, fit in 80 GB, largest power-of-two
    batch, model flops and the one-card roofline terms) and a summary; no
    cell fails."""
    from repro_torch.launch import dryrun

    t = time.perf_counter()
    records = dryrun.main(["--arch", "all", "--shape", "all"])
    emit({"phase": "dryrun", "cells": len(records),
          "ok": sum(r["status"] == "ok" for r in records),
          "skipped": sum(r["status"] == "skipped" for r in records),
          "fit_80gb": [f"{r['arch']} x {r['shape']}" for r in records if r.get("fits_80gb")],
          "seconds": time.perf_counter() - t})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--disk-run"]:
        sys.exit(disk_run_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--cluster-run"]:
        sys.exit(cluster_run_child(sys.argv[2:]))
    if sys.argv[1:2] == ["--cards"]:
        sys.exit(cards_only())
    sys.exit(main())
