#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from `src/repro_torch/kernels/csrc/` and then:

1. kernel phase: each kernel against its plain PyTorch version on the card,
   at the main paths' shapes and at edge cases, with CUDA-event times of the
   kernel, the plain version and, where one exists, a single PyTorch library
   call.  The four graph kernels are bit-equal (tolerance zero: all values
   are integers); `flash_attention`'s two kernels (decode: split-KV with
   1-D bulk copies; prefill: wgmma + TMA) are held, row by row, to their
   error relative to the row's largest value (`flash_attention.row_error`):
   1e-5 in f32 (the sum order differs), 2^-6 in bf16 (two bf16 ulps of the
   row's largest value), in cases (a)-(i), and planted faults at the main
   path's shapes (the softmax scale 5 % off; the last 32 keys of each row
   dropped) must exceed that limit.  `bucket_hist` is timed at the main
   shape, at walks_main's call, at the walk shape of capacity factor 4, at
   k 64 and with no ids (its fixed cost, beside an empty kernel), each with
   bincount beside it; it is checked on two slices that start off a 16-byte
   boundary, and a planted fault (one id skipped) must fail the comparison.
   Before that, the attention library's `ptxas -v` report and SASS give
   each kernel instance's registers and spills, and the run fails unless
   every prefill instance issues HGMMA and UTMALDG and every decode instance
   an asynchronous copy (UBLKCP or LDGSTS), and unless no `bucket_hist`
   instance spills;
2. variant phase: every generate() variant at scale 16, nb 8, on the card
   and on the CPU, bit-equal; then walks_parity: distributed_walks (length
   80, 256 walkers per shard) and WalkLoader batches 0-2 on that graph,
   card == CPU bit for bit;
3. main phase: generate(GraphConfig(scale=26, nb=8)) (Graph500 "toy") with
   the defaults (paper shuffle, ring relabel, sorted CSR), once with an
   empty allocator cache and once warm, launch counts set to 0 just before
   and read just after each, validated on the card; then the same for the
   communication-free variant (shuffle_variant="recompute"), the main path's
   user of the Feistel kernel.  The graph kernels' bounds count the
   per-thread SASS instructions of this build (`repro_torch.kernels.sass`);
   then walks_main: distributed_walks over the warm run's CSR, 2^20 walkers
   per shard (2^23 walks), length 80, capacity factor 8, launch counts set
   to 0 just before and read just after, zero drops, length x nb
   bucket_hist launches, every hop replayed on the card by code that shares
   nothing with the sampler; walk ms, hops/s and peak memory; then the same
   walk under torch.profiler (`walks_trace`: busy share, device time by
   kernel); then loader_main: a WalkLoader over that CSR on the card (the
   global CSR assembled there, held to the sharded one; build and batch ms,
   peak memory);
4. serve_parity phase: the serve path's smoke configs (internlm2, codeqwen;
   f32) on the card and on the CPU: prefill and decode logits within 1e-4,
   the Engine's tokens equal;
5. serve_main phase: the continuous-batching Engine serving internlm2-1.8b
   at full width (bf16, random weights from a seeded generator on the card),
   8 slots of 4096 positions, 16 requests of 128-2048 prompt tokens and 64
   new tokens each (12 greedy, 4 sampled), admitted in waves as slots free
   up; launch counts set to 0 just before and read just after, every logit
   finite, and flash launches = layers x (prefills + decode waves), the
   prefill kernel's layers x prefills and the decode kernel's layers x
   decode waves; then a
   short window of the same engine under torch.profiler (`serve_trace`:
   the card's busy share and device time by kernel).

Prints the card's name and power limit, one JSON line per check, a
{"kernels": [...]} line, and last {"ok": true, "device": {...}}.  Any failed
check raises and the script exits nonzero.  Without CUDA, or without the
repository beside it, it exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
MAIN_SCALE = 26                    # Graph500 "toy": 2^26 vertices, 2^30 edges
NB = 8
VARIANT_SCALE = 16
MEM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3, NVIDIA data sheet
# Integer operations per SM and clock: the four schedulers issue 4 x 32
# thread-instructions, split between the INT32 pipe (64 lanes: shifts, logic,
# adds, compares) and the FP32 pipe (128 lanes), which runs the integer
# multiply-adds.  64 alone is beaten by the measured rmat_edges kernel.  The
# operations of a kernel are its per-thread SASS instructions per item
# (`repro_torch.kernels.sass`), counted in this run's build.
INT_OPS_PER_SM_CLK = 128
PLAIN_CHUNK = 1 << 27              # feistel_perm_plain's int64 temporaries, 1 GiB each
BF16_OPS_PER_S = 989e12            # H100 SXM dense bf16 tensor-core peak, NVIDIA data sheet
SLEEP_CYCLES = 20_000_000          # ~10 ms of card time ahead of each timed call
SERVE_ARCH = "internlm2-1.8b"      # launch/serve.py's default architecture
SERVE_SLOTS, SERVE_MAX_LEN = 8, 4096
SERVE_REQUESTS, SERVE_NEW_TOKENS = 16, 64
SERVE_PROMPT_RANGE = (128, 2048)   # prompt lengths of a 1.8B chat / code model
SERVE_SAMPLED = (3, 7, 11, 15)     # uids that sample (temperature 0.8, top-k 40)
SERVE_SEED = 0
TRACE_PROMPT, TRACE_NEW_TOKENS = 512, 32   # serve_trace's window
PARITY_ARCHS = ("internlm2-1.8b", "codeqwen1.5-7b")
PARITY_TOL = 1e-4                  # f32 logits, card vs CPU: the sum order differs
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
    from repro_torch.core.types import GraphConfig
    from repro_torch.kernels import bucket, build, ops, sass

    dev = torch.device("cuda", 0)
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    props = torch.cuda.get_device_properties(dev)
    clock_mhz = float(nvidia_smi("clocks.max.sm").split()[0])
    int_ops_per_s = props.multi_processor_count * INT_OPS_PER_SM_CLK * clock_mhz * 1e6
    emit({"phase": "env", "torch": torch.__version__, "cuda": torch.version.cuda,
          "sms": props.multi_processor_count, "sm_clock_max_mhz": clock_mhz,
          "int_peak_ops_per_s": int_ops_per_s})

    t = time.perf_counter()
    graph_lib, attn_lib = build.build()
    build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t,
          "libraries": [p.name for p in build.build()]})
    attention_build_phase(sass, attn_lib)
    main_cfg = GraphConfig(scale=MAIN_SCALE, nb=NB)
    eps, B, rounds = main_cfg.edges_per_shard, main_cfg.bucket_size, main_cfg.feistel_rounds
    listing = sass.listing(graph_lib)
    # bucket_hist: the register-bin instance of k 8 (main and walk shapes) and
    # the shared-memory one (k 64)
    hist_k8 = f"bucket_hist_kernelILi{bucket.plan(1, NB, 1).bins}E"
    hist_k64 = f"bucket_hist_kernelILi{bucket.plan(1, 64, 1).bins}E"
    ops_per_item = {
        "rmat_edges": sass.per_item_ops(listing, f"rmat_edges_kernelILi{MAIN_SCALE}E"),
        "feistel_perm": sass.per_item_ops(listing, f"feistel_perm_kernelILi{rounds}E"),
        "relabel_gather": sass.per_item_ops(listing, "relabel_gather_kernel"),
        hist_k8: sass.per_item_ops(listing, hist_k8),
        hist_k64: sass.per_item_ops(listing, hist_k64),
    }
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

    def bound(n_bytes: float, n_ops: float):
        t_bytes, t_ops = n_bytes / MEM_BYTES_PER_S, n_ops / int_ops_per_s
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")

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
            line["bound_ms"], line["bound_by"] = bound(n_bytes, n_ops)
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

    # relabel_gather: a ring round's segment of shard 0's sorted src field
    # (raw R-MAT ids, so the segment sizes are skewed) against the pv chunk
    # of shard 1 (base = B > 0); the unsegmented field (pass-through); an
    # empty segment.
    src0, _ = ops.rmat_edges(main_cfg, 0, eps, dev)
    field = torch.sort(src0).values
    del src0
    chunk = torch.randperm(main_cfg.n, generator=g, device=dev, dtype=torch.int64)[B:2 * B]
    chunk = chunk.to(torch.int32)
    lo, hi = torch.searchsorted(field, torch.tensor([B, 2 * B], dtype=torch.int32, device=dev)).tolist()
    seg = field[lo:hi]
    check_kernel("relabel_gather", f"main: ring segment, base B, {hi - lo} keys",
                 lambda: ops.relabel_gather(seg, chunk, B),
                 lambda: ops.relabel_gather_plain(seg, chunk, B), timed=True,
                 n_bytes=8 * seg.numel() + 4 * chunk.numel(),
                 n_ops=ops_per_item["relabel_gather"] * seg.numel(),
                 size=seg.numel())
    odd = field[: 1_000_003]
    check_kernel("relabel_gather", "pass-through keys outside the chunk, n 1000003",
                 lambda: ops.relabel_gather(odd, chunk, B),
                 lambda: ops.relabel_gather_plain(odd, chunk, B), size=odd.numel())
    before = ops.LAUNCHES["relabel_gather"]
    empty = ops.relabel_gather(field[:0], chunk, B)
    require(empty.numel() == 0 and ops.LAUNCHES["relabel_gather"] == before,
            "an empty segment must launch nothing")
    emit({"kernel": "relabel_gather", "case": "empty segment", "n": 0, "max_abs_diff": 0})
    del field, chunk, seg, odd

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
    flash = flash_phase(torch, ops, dev, g, time_ms)
    torch.cuda.empty_cache()

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
    require(main_counts["main_cold"] == main_counts["main"], "cold and warm runs launched differently")
    for name in ("rmat_edges", "relabel_gather", "bucket_hist"):
        require(main_counts["main"][name] > 0, f"main path never launched {name}")
    require(main_counts["main_recompute"]["feistel_perm"] > 0,
            "recompute main path never launched feistel_perm")
    torch.cuda.empty_cache()
    main_counts["walks_main"] = walks_main_phase(torch, ops, dev, main_cfg, main_csr)
    torch.cuda.empty_cache()
    loader_main_phase(torch, dev, main_cfg, main_csr)
    del main_csr
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    # 4-5. the serve path: card == CPU on the smoke configs, then the
    # full-width Engine
    # ------------------------------------------------------------------
    serve_parity_phase(torch, dev)
    torch.cuda.empty_cache()
    main_counts["serve_main"] = serve_main_phase(torch, ops, dev)

    sources = {
        "rmat_edges": "src/repro/kernels/rmat.py:85",
        "feistel_perm": "src/repro/kernels/rmat.py:137",
        "relabel_gather": "src/repro/kernels/relabel_gather.py:54",
        "bucket_hist": "src/repro/kernels/bucket.py:49",
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
                                **{k: x[k] for k in ("empty_kernel_ms",) if k in x}}
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data import distributed_walks

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        distributed_walks(cfg, offv, adjv, length=WALK_LENGTH, seed=WALK_SEED,
                          walkers_per_shard=WALK_WALKERS, capacity_factor=WALK_CAPACITY_FACTOR)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(ms for _, ms, _ in rows)
    require(device_ms > 0, "walks_trace: the profiler saw no device time")
    rows.sort(key=lambda r: -r[1])
    emit({"phase": "walks_trace", "hops": WALK_LENGTH, "wall_ms": wall_ms, "device_ms": device_ms,
          "busy_share": device_ms / wall_ms,
          "top_device_ms": [{"name": n[:90], "ms": ms, "calls": c} for n, ms, c in rows[:14]]})


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
    emit({"phase": "attention_build", "listing": lib.with_suffix(".sass").name,
          "instances": found})


def _flash_bound(torch, q, k, offsets, causal):
    """(ms, "bytes" or "operations") of the least time for these inputs: each
    q and output element once, the K/V rows some query sees once; 4 D Hq
    operations per visible (query, key) pair at the bf16 tensor-core peak."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if causal:
        i = offsets.cpu().long()[:, None] + 1 + torch.arange(Sq)[None, :]
        pairs = int(i.clamp(0, Skv).sum())
        kv_rows = int((offsets.cpu().long() + Sq).clamp(0, Skv).sum())
    else:
        pairs, kv_rows = B * Sq * Skv, B * Skv
    n_bytes = q.element_size() * (2 * q.numel() + 2 * Hkv * D * kv_rows)
    t_bytes, t_ops = n_bytes / MEM_BYTES_PER_S, 4 * D * Hq * pairs / BF16_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def flash_phase(torch, ops, dev, g, time_ms):
    """flash_attention against its plain version at the serve path's shapes:
    (a) prefill at full width, (b) the decode wave (both timed, with the
    SDPA call over the same mask as the library yardstick), (c) non-causal
    with ragged Sq / Skv, (d) the smoke configs' D 16, (e, f) the decode
    kernel's split-KV path with ragged chunks, causal and not, (g) the
    prefill kernel with ragged tiles and GQA group 5, (h) a decode wave with
    GQA group 5 and ragged offsets (0, tile and chunk edges, the last key,
    an idle slot past the cache), (i) a timed prefill of 512 queries.  In
    (a), (b) and (h) the kernel is also run with planted faults, which the
    check must reject."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import TOLERANCE, plan, row_error

    bf16, f32 = torch.bfloat16, torch.float32
    B = SERVE_SLOTS
    decode_off = torch.randint(127, SERVE_MAX_LEN - 1, (B,), generator=g, device=dev,
                               dtype=torch.int32)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    ragged = torch.tensor([0, 31, 480, 1500, 2999, 4094, 4095, 5096], dtype=torch.int32,
                          device=dev)
    cases = {   # B, Hq, Hkv, Sq, Skv, D, offsets [B], causal, dtype, timed, planted faults
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
    }
    out = {}
    for key, (case, B_, Hq, Hkv, Sq, Skv, D, off, causal, dtype, timed, planted) in cases.items():
        q = torch.randn(B_, Hq, Sq, D, generator=g, device=dev).to(dtype)
        k = torch.randn(B_, Hkv, Skv, D, generator=g, device=dev).to(dtype)
        v = torch.randn(B_, Hkv, Skv, D, generator=g, device=dev).to(dtype)
        kernel = lambda: ops.flash_attention(q, k, v, causal=causal, offset=off)  # noqa: E731
        plain = lambda: ops.flash_attention_plain(q, k, v, causal=causal, offset=off)  # noqa: E731
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        require(bool(torch.isfinite(got).all()), f"flash_attention [{key}] not finite")
        tol, err = TOLERANCE[dtype], row_error(got, want)
        require(err <= tol, f"flash_attention [{key}] differs from its plain version: "
                            f"row error {err} > {tol}")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        path = plan(dtype, B_, Hq, Hkv, Sq, Skv, D, sms).kernel
        line = {"kernel": f"flash_attention_{path}", "case": case, "dtype": str(dtype),
                "row_error": err,
                "tolerance": tol, "max_abs_diff": float((got.float() - want.float()).abs().max())}
        if planted:
            # planted faults: the check must tell them from the sound kernel
            faults = {"softmax scale 5 % off": ops.flash_attention(
                q, k, v, causal=causal, offset=off, scale=1.05 / D ** 0.5),
                "last 32 keys of each row dropped": ops.flash_attention(
                    q, k, v, causal=causal, offset=off - 32)}
            line["planted_faults"] = {name: row_error(bad, want) for name, bad in faults.items()}
            for name, bad_err in line["planted_faults"].items():
                require(bad_err > tol, f"flash_attention [{key}]: planted fault '{name}' passes "
                                       f"the check: row error {bad_err} <= {tol}")
            del faults
        if timed:
            qpos = off[:, None] + torch.arange(Sq, device=dev)[None, :]
            mask = (torch.arange(Skv, device=dev)[None, None, :] <= qpos[:, :, None])[:, None]
            library = lambda: F.scaled_dot_product_attention(  # noqa: E731
                q, k, v, attn_mask=mask, enable_gqa=True)
            line["kernel_ms"] = time_ms(kernel)
            line["plain_ms"] = time_ms(plain, reps=3)
            line["library_ms"] = time_ms(library)
            line["bound_ms"], line["bound_by"] = _flash_bound(torch, q, k, off, causal)
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


def serve_parity_phase(torch, dev):
    """The smoke configs (f32, D 16) on the card and on the CPU: the same
    parameters give logits within PARITY_TOL and the Engine the same tokens."""
    import numpy as np

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import get_model, init_all
    from repro_torch.serve import Engine

    for arch in PARITY_ARCHS:
        cfg = get_smoke_config(arch)
        api = get_model(cfg)
        on = {"cpu": init_all(cfg, seed=SERVE_SEED, device="cpu")}
        on["cuda"] = _to(on["cpu"], dev)
        tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 12)).astype(np.int32)
        logits = {}
        for where, params in on.items():
            d = dev if where == "cuda" else torch.device("cpu")
            t = torch.from_numpy(tokens).to(d)
            cache = api.init_cache(cfg, 2, 64, d)
            lg, cache = api.prefill(cfg, params, {"tokens": t[:, :8]}, cache)
            logits[where] = [lg]
            for i in range(8, 12):
                lg, cache = api.decode_step(cfg, params, t[:, i:i + 1], cache)
                logits[where].append(lg)
        err = max(float((a.cpu() - b).abs().max()) for a, b in zip(logits["cuda"], logits["cpu"]))
        require(err <= PARITY_TOL, f"serve_parity {arch}: logits card vs CPU differ by {err}")
        served = {}
        for where, params in on.items():
            reqs = _serve_requests(8, cfg.vocab_size, np.random.default_rng(2), (1, 24), 8,
                                   sampled=(1, 4, 6))
            eng = Engine(cfg, params, max_batch=4, max_len=64, device=dev if where == "cuda" else "cpu")
            served[where] = (eng.run(reqs), eng.steps, eng.prefill_tokens, eng.decode_tokens)
        require(served["cuda"] == served["cpu"], f"serve_parity {arch}: Engine differs card vs CPU")
        emit({"phase": "serve_parity", "arch": cfg.name, "dtype": cfg.dtype,
              "logits_max_abs_diff": err, "tolerance": PARITY_TOL, "tokens_equal": True,
              "requests": len(served["cpu"][0]), "steps": served["cpu"][1]})


def serve_main_phase(torch, ops, dev):
    """internlm2-1.8b at full width behind the continuous-batching Engine.
    Returns the launch counts of the run."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import init_all, layers
    from repro_torch.serve import Engine

    cfg = get_config(SERVE_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    params = init_all(cfg, seed=SERVE_SEED, device=dev)
    engine = Engine(cfg, params, max_batch=SERVE_SLOTS, max_len=SERVE_MAX_LEN, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t
    reqs = _serve_requests(SERVE_REQUESTS, cfg.vocab_size, np.random.default_rng(SERVE_SEED),
                           SERVE_PROMPT_RANGE, SERVE_NEW_TOKENS, SERVE_SAMPLED)

    # CUDA events around every prefill and decode wave, and around every
    # attention call inside them; finiteness of every logit is folded on the
    # card and read once at the end
    events = {"prefill": [], "decode": []}
    attn_events = {"prefill": [], "decode": []}
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

    flash_attention = layers.flash_attention
    layers.flash_attention = timed_attention
    engine.api = engine.api._replace(prefill=timed(engine.api.prefill, "prefill"),
                                     decode_step=timed(engine.api.decode_step, "decode"))
    ops.reset_launches()
    t = time.perf_counter()
    try:
        out = engine.run(reqs)
        torch.cuda.synchronize()
    finally:
        layers.flash_attention = flash_attention
    wall = time.perf_counter() - t
    counts = dict(ops.LAUNCHES)
    prefill_ms = [a.elapsed_time(b) for a, b in events["prefill"]]
    decode_ms = [a.elapsed_time(b) for a, b in events["decode"]]
    attn_ms = {k: sum(a.elapsed_time(b) for a, b in v) for k, v in attn_events.items()}
    new_tokens = sum(len(v) for v in out.values())
    line = {"phase": "serve_main", "arch": cfg.name, "dtype": cfg.dtype,
            "params": cfg.param_count(), "slots": SERVE_SLOTS, "max_len": SERVE_MAX_LEN,
            "requests": len(out), "prompt_tokens": sum(len(r.prompt) for r in reqs),
            "prefill_tokens": engine.prefill_tokens, "decode_tokens": engine.decode_tokens,
            "steps": engine.steps, "admissions": len(prefill_ms), "setup_s": setup_s,
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
    emit(line)
    require(len(out) == SERVE_REQUESTS, f"serve_main: {len(out)} of {SERVE_REQUESTS} requests served")
    require(all(len(v) == SERVE_NEW_TOKENS for v in out.values()),
            "serve_main: a request ended short of its new tokens")
    require(line["logits_finite"], "serve_main: a logit is not finite")
    require(counts["flash_attention"] == cfg.num_layers * (len(prefill_ms) + engine.steps),
            f"serve_main: {counts['flash_attention']} flash launches != {cfg.num_layers} x "
            f"({len(prefill_ms)} prefills + {engine.steps} decode waves)")
    require(counts["flash_attention_prefill"] == cfg.num_layers * len(prefill_ms)
            and counts["flash_attention_decode"] == cfg.num_layers * engine.steps,
            f"serve_main: prefill / decode kernel launches {counts['flash_attention_prefill']} / "
            f"{counts['flash_attention_decode']}, not layers x prefills / layers x waves")
    serve_trace(torch, engine, cfg)
    del engine, params
    return counts


def serve_trace(torch, engine, cfg):
    """A short window of the same engine under torch.profiler (8 requests of
    512 prompt tokens, 32 new tokens): the card's busy share (kernel and copy
    time over the window's wall time; the profiler's own host cost makes the
    idle share an upper bound) and the device time by kernel."""
    import numpy as np
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    reqs = _serve_requests(SERVE_SLOTS, cfg.vocab_size, np.random.default_rng(SERVE_SEED + 1),
                           (TRACE_PROMPT, TRACE_PROMPT), TRACE_NEW_TOKENS, ())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        engine.run(reqs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    # device-side rows only (kernels, copies): an operator's row repeats its kernels' time
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    device_ms = sum(ms for _, ms, _ in rows)
    require(device_ms > 0, "serve_trace: the profiler saw no device time")
    rows.sort(key=lambda r: -r[1])
    emit({"phase": "serve_trace", "requests": len(reqs), "prompt_tokens": TRACE_PROMPT,
          "new_tokens": TRACE_NEW_TOKENS,
          "wall_ms": wall_ms, "device_ms": device_ms, "busy_share": device_ms / wall_ms,
          "top_device_ms": [{"name": n[:90], "ms": ms, "calls": c} for n, ms, c in rows[:10]]})


if __name__ == "__main__":
    sys.exit(main())
