#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Builds the hand-written kernels from `src/repro_torch/kernels/csrc/` and then:

1. kernel phase: each kernel against its plain PyTorch version on the card,
   at the main path's shapes and at edge cases, bit-equal (tolerance zero:
   all values are integers), with CUDA-event times of the kernel, the plain
   version and, where one exists, a single PyTorch library call;
2. variant phase: every generate() variant at scale 16, nb 8, on the card
   and on the CPU, bit-equal;
3. main phase: generate(GraphConfig(scale=26, nb=8)) (Graph500 "toy") with
   the defaults (paper shuffle, ring relabel, sorted CSR), once with an
   empty allocator cache and once warm, launch counts set to 0 just before
   and read just after each, validated on the card; then the same for the
   communication-free variant (shuffle_variant="recompute"), the main path's
   user of the Feistel kernel.  The kernels' bounds count the per-thread
   SASS instructions of this build (`repro_torch.kernels.sass`).

Prints the card's name and power limit, one JSON line per check, a
{"kernels": [...]} line, and last {"ok": true, "device": {...}}.  Any failed
check raises and the script exits nonzero.  Without CUDA, or without the
repository beside it, it exits nonzero and prints no result.
"""

from __future__ import annotations

import json
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
    from repro_torch.kernels import build, ops, sass

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
    lib_path = build.build()
    build.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t, "library": lib_path.name})
    main_cfg = GraphConfig(scale=MAIN_SCALE, nb=NB)
    eps, B, rounds = main_cfg.edges_per_shard, main_cfg.bucket_size, main_cfg.feistel_rounds
    listing = sass.listing(lib_path)
    ops_per_item = {
        "rmat_edges": sass.per_item_ops(listing, f"rmat_edges_kernelILi{MAIN_SCALE}E"),
        "feistel_perm": sass.per_item_ops(listing, f"feistel_perm_kernelILi{rounds}E"),
        "relabel_gather": sass.per_item_ops(listing, "relabel_gather_kernel"),
        "bucket_hist": sass.per_item_ops(listing, "bucket_hist_kernel"),
    }
    emit({"phase": "sass", "listing": lib_path.with_suffix(".sass").name,
          "per_item_ops": ops_per_item})

    def time_ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

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
    summary = {}

    def check_kernel(name, case, kernel_fn, plain_fn, timed=False, n_bytes=0, n_ops=0,
                     library_fn=None, size=None):
        got, want = kernel_fn(), plain_fn()
        err = max_abs(got, want)
        require(err == 0, f"{name} [{case}] differs from its plain version: max |diff| {err}")
        line = {"kernel": name, "case": case, "n": size, "max_abs_diff": err}
        if timed:
            line["kernel_ms"] = time_ms(kernel_fn)
            line["plain_ms"] = time_ms(plain_fn, reps=3)
            line["library_ms"] = time_ms(library_fn) if library_fn else None
            line["bound_ms"], line["bound_by"] = bound(n_bytes, n_ops)
            summary[name] = line
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

    # bucket_hist: redistribute's call (one shard's owners, k = nb = 8),
    # and k in {2, 64} with the pad value k mixed in.
    dest = torch.randint(0, NB, (eps,), generator=g, device=dev, dtype=torch.int32)
    check_kernel("bucket_hist", "main: one shard's owners, k 8",
                 lambda: ops.bucket_hist(dest, NB), lambda: ops.bucket_hist_plain(dest, NB),
                 timed=True, n_bytes=4 * dest.numel() + 4 * NB,
                 n_ops=ops_per_item["bucket_hist"] * dest.numel(),
                 library_fn=lambda: torch.bincount(dest, minlength=NB), size=dest.numel())
    del dest
    for k in (2, 8, 64):
        dk = torch.randint(0, k + 1, (1_000_003,), generator=g, device=dev, dtype=torch.int32)
        check_kernel("bucket_hist", f"k {k} with pad value k, n 1000003",
                     lambda: ops.bucket_hist(dk, k), lambda: ops.bucket_hist_plain(dk, k),
                     size=dk.numel())
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
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    # 3. main phase: the full-size graph twice, first with an empty
    # allocator cache (cold: every block is fetched from the driver), then
    # warm; then its recompute variant (warm)
    # ------------------------------------------------------------------
    main_counts = {}

    def run_main(label, shuffle_variant, cold):
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
        return counts

    main_counts["main_cold"] = run_main("main_cold", "paper", cold=True)
    main_counts["main"] = run_main("main", "paper", cold=False)
    main_counts["main_recompute"] = run_main("main_recompute", "recompute", cold=False)
    require(main_counts["main_cold"] == main_counts["main"], "cold and warm runs launched differently")
    for name in ("rmat_edges", "relabel_gather", "bucket_hist"):
        require(main_counts["main"][name] > 0, f"main path never launched {name}")
    require(main_counts["main_recompute"]["feistel_perm"] > 0,
            "recompute main path never launched feistel_perm")

    sources = {
        "rmat_edges": "src/repro/kernels/rmat.py:85",
        "feistel_perm": "src/repro/kernels/rmat.py:137",
        "relabel_gather": "src/repro/kernels/relabel_gather.py:54",
        "bucket_hist": "src/repro/kernels/bucket.py:49",
    }
    kernels = []
    for name in build.KERNELS:
        s = summary[name]
        launches = main_counts["main"][name] + main_counts["main_recompute"][name]
        require(launches > 0, f"{name} was launched no time on the main path")
        kernels.append({"name": name, "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/graph_kernels.cu",
                        "replaces": sources[name], "launches": launches,
                        "max_abs_err": s["max_abs_diff"], "ms": s["kernel_ms"],
                        "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                        "bound_by": s["bound_by"], "library_ms": s["library_ms"]})
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
