"""The disk tier's four per-chunk hooks (`repro_torch/core/chunks.py`) on the
CPU, against the reference's numpy loops they replace, bit for bit.

On the CPU each hook runs its kernel's plain PyTorch version; the returned
arrays must equal the reference's in value, dtype (int64), layout (C order)
and the bytes `np.save` writes.  `partition_runs` and `MonotoneLookup` are
held to the reference's through the files they write and the errors they
raise.
"""

import dataclasses
import io
import os

import numpy as np
import pytest
import torch

from repro.core import blockstore as ref_bs
from repro.core import hostgen as ref_hostgen
from repro_torch.core import blockstore as bs
from repro_torch.core import chunks
from repro_torch.core.phases import PlainCfg, plain_config, result_config_key
from repro_torch.core.types import GraphConfig

from torch_parity import npy_shas


def _npy_bytes(a: np.ndarray) -> bytes:
    buf = io.BytesIO()
    np.save(buf, a)
    return buf.getvalue()


def _same_array(got: np.ndarray, want: np.ndarray) -> None:
    assert got.dtype == want.dtype == np.int64
    assert got.flags.c_contiguous
    np.testing.assert_array_equal(got, want)
    assert _npy_bytes(got) == _npy_bytes(want)


def _pcfg(scale: int, seed: int = 0x5EED_1234) -> PlainCfg:
    return plain_config(GraphConfig(scale=scale, seed=seed, nb=1), "cpu")


# ---------------------------------------------------------------------------
# hook 1: rmat_chunk == hostgen.rmat_edges_np_cfg
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("start", [0, 1000, 123457])
@pytest.mark.parametrize("count", [64, 1000, 4096])
@pytest.mark.parametrize("scale", [4, 10, 16, 20])
def test_rmat_chunk_matches_reference(scale, count, start):
    pcfg = _pcfg(scale)
    got = chunks.rmat_chunk(pcfg, start, count, "cpu")
    want = ref_hostgen.rmat_edges_np_cfg(pcfg, start, count)
    for g, w in zip(got, want):
        _same_array(g, w)


def test_rmat_chunk_wraps_at_2_32():
    """A chunk that starts just below 2^32: the kernel masks the edge id to
    32 bits, the reference adds in uint32; both wrap alike."""
    pcfg = _pcfg(16, seed=7)
    start = (1 << 32) - 700
    got = chunks.rmat_chunk(pcfg, start, 2048, "cpu")
    want = ref_hostgen.rmat_edges_np_cfg(pcfg, start, 2048)
    for g, w in zip(got, want):
        _same_array(g, w)


@pytest.mark.parametrize("start", [1 << 32, -1, 1 << 40])
def test_rmat_chunk_start_outside_uint32_raises_like_reference(start):
    """A start outside [0, 2^32) is the reference's `np.uint32(start)`
    OverflowError, message and all, never a silently wrapped chunk."""
    pcfg = _pcfg(10)
    with pytest.raises(OverflowError) as want:
        ref_hostgen.rmat_edges_np_cfg(pcfg, start, 1)
    with pytest.raises(OverflowError) as got:
        chunks.rmat_chunk(pcfg, start, 1, "cpu")
    assert str(got.value) == str(want.value)


def test_rmat_chunk_empty_and_scale_guard():
    pcfg = _pcfg(10)
    s, d = chunks.rmat_chunk(pcfg, 5, 0, "cpu")
    assert s.shape == d.shape == (0,) and s.dtype == np.int64
    with pytest.raises(ValueError, match="scale"):
        chunks.rmat_chunk(PlainCfg(scale=32, edge_factor=1, seed=0, a=0.57, b=0.19,
                                   c=0.19, d=0.05, nb=1, chunk_edges=64, rounds=1),
                          0, 8, "cpu")


# ---------------------------------------------------------------------------
# hook 2: graph_perm_chunk == hostgen.graph_perm_np
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rounds", [2, 4, 8])
@pytest.mark.parametrize("n", [1 << 10, 1 << 20, 1000, 12345])
def test_graph_perm_chunk_matches_reference(n, rounds):
    rng = np.random.default_rng(n + rounds)
    x = rng.integers(0, n, 5000, dtype=np.int64)
    got = chunks.graph_perm_chunk(0xC0FFEE, x, n, rounds, "cpu")
    _same_array(got, ref_hostgen.graph_perm_np(0xC0FFEE, x, n, rounds))
    full = chunks.graph_perm_chunk(3, np.arange(n, dtype=np.int64), n, rounds, "cpu")
    np.testing.assert_array_equal(np.sort(full), np.arange(n))


def test_graph_perm_chunk_guards():
    with pytest.raises(ValueError, match="inputs must lie"):
        chunks.graph_perm_chunk(1, np.array([0, 1024]), 1024, 4, "cpu")
    with pytest.raises(ValueError, match="n <= 2"):
        chunks.graph_perm_chunk(1, np.array([0]), (1 << 31) + 1, 4, "cpu")
    assert chunks.graph_perm_chunk(1, np.zeros(0, np.int64), 1024, 4, "cpu").shape == (0,)


def test_hooks_ask_for_cuda_by_default(monkeypatch):
    """device="cuda" without CUDA raises: no hook falls back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        chunks.rmat_chunk(_pcfg(8), 0, 16, "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        chunks.graph_perm_chunk(1, np.arange(4), 16)
    with pytest.raises(RuntimeError, match="cuda"):
        plain_config(GraphConfig(scale=8))


# ---------------------------------------------------------------------------
# hook 3: partition_runs (bucket_hist counts + stable order)
# ---------------------------------------------------------------------------


def _runs(seed: int):
    """Runs of (src, dst) with ids in [0, 256), one of them empty."""
    rng = np.random.default_rng(seed)
    sizes = [300, 0, 1, 77, 512, 0, 129]
    return [(rng.integers(0, 256, k, dtype=np.int64), rng.integers(0, 256, k, dtype=np.int64))
            for k in sizes]


def _fill(mod, workdir, name, runs):
    st = mod.BlockStore(workdir, name, mod.IOLedger(), fresh=True)
    for s, d in runs:
        st.append_run(s, d)
    return st


def _relabel(s, d):
    return (255 - s) * 1, (d * 7) % 256


@pytest.mark.parametrize("overlap", [False, True])
@pytest.mark.parametrize("transform", [None, _relabel])
@pytest.mark.parametrize("nparts", [1, 8])
def test_partition_runs_writes_the_reference_files(tmp_path, nparts, transform, overlap):
    B = 256 // nparts
    shas = []
    for label, mod, kw in (("ref", ref_bs, {}), ("port", bs, {"device": "cpu"})):
        d = str(tmp_path / label)
        src = _fill(mod, d, "edges", _runs(nparts))
        outs = [mod.BlockStore(d, f"out_{j}", mod.IOLedger(), fresh=True)
                for j in range(nparts)]
        mod.partition_runs(src, outs, lambda a, b: a // B, tag_prefix="003",
                           transform=transform, overlap=overlap, **kw)
        names = {j: sorted(os.listdir(os.path.join(d, f"out_{j}"))) for j in range(nparts)}
        shas.append((names, {j: npy_shas(os.path.join(d, f"out_{j}")) for j in range(nparts)},
                     [o.total_rows() for o in outs]))
    assert shas[0] == shas[1]
    assert sum(shas[1][2]) == sum(len(s) for s, _ in _runs(nparts))


@pytest.mark.parametrize("bad", [-1, 8, 1 << 40])
def test_partition_runs_bad_bucket_raises_like_reference(tmp_path, bad):
    msgs = []
    for label, mod, kw in (("ref", ref_bs, {}), ("port", bs, {"device": "cpu"})):
        d = str(tmp_path / label)
        runs = _runs(1)
        runs[3][0][5] = bad * 32          # one record's bucket is `bad`
        src = _fill(mod, d, "edges", runs)
        outs = [mod.BlockStore(d, f"out_{j}", mod.IOLedger(), fresh=True) for j in range(8)]
        with pytest.raises(ValueError, match="outside") as e:
            mod.partition_runs(src, outs, lambda a, b: a // 32, tag_prefix="000", **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# hook 4: MonotoneLookup's gather (pv joins) on the device
# ---------------------------------------------------------------------------


def _table(mod, workdir, ledger, rows=1000):
    st = mod.BlockStore(workdir, "pv", ledger, columns=("v",), fresh=True)
    vals = np.random.default_rng(5).permutation(4096)[:rows].astype(np.int64)
    for lo in range(0, rows, 300):
        st.append_run(vals[lo:lo + 300])
    return st


@pytest.mark.parametrize("device", [None, "cpu"])
def test_monotone_lookup_matches_reference(tmp_path, device):
    base = 3000
    rng = np.random.default_rng(11)
    probes = np.sort(rng.integers(base, base + 1000, 2500))
    calls = np.split(probes, [1, 400, 400, 1700, 2499])   # one empty call
    outs = []
    for label, mod, kw in (("ref", ref_bs, {}), ("port", bs, {"device": device})):
        led = mod.IOLedger()
        gauge = mod.MemoryGauge()
        lk = mod.MonotoneLookup([_table(mod, str(tmp_path / label), led)], block_rows=128,
                                base=base, gauge=gauge, **kw)
        outs.append(([lk.lookup(c) for c in calls], led.as_dict(), gauge.peak_rows))
    for got, want in zip(outs[1][0], outs[0][0]):
        _same_array(got, want)
    assert outs[0][1:] == outs[1][1:]


@pytest.mark.parametrize("device", [None, "cpu"])
def test_monotone_lookup_errors_match_reference(tmp_path, device):
    errors = []
    for label, mod, kw in (("ref", ref_bs, {}), ("port", bs, {"device": device})):
        got = []
        for probe in ([np.array([5, 4])], [np.array([700]), np.array([10])],
                      [np.array([999, 1000])]):
            lk = mod.MonotoneLookup([_table(mod, str(tmp_path / label), mod.IOLedger())],
                                    block_rows=128, **kw)
            with pytest.raises((ValueError, IndexError)) as e:
                for keys in probe:
                    lk.lookup(keys)
            got.append((type(e.value), str(e.value)))
        errors.append(got)
    assert errors[0] == errors[1]


def test_gather_and_table_guards():
    with pytest.raises(ValueError, match="int32"):
        chunks.table_block(np.array([1 << 31]), "cpu")
    vals = chunks.table_block(np.arange(4, dtype=np.int64), "cpu")
    with pytest.raises(ValueError, match="int32"):
        chunks.gather_chunk(np.array([1 << 31]), vals, (1 << 31) - 2)
    _same_array(chunks.gather_chunk(np.array([7, 9]), vals, 6), np.array([1, 3]))


def test_plain_config_device_and_scale():
    p = plain_config(GraphConfig(scale=9, nb=4, shuffle_variant="recompute"), "cpu")
    assert p.device == "cpu" and p.perm_family == "feistel"
    assert result_config_key(p) == result_config_key(dataclasses.replace(p, device="cuda"))
    with pytest.raises(ValueError, match="scale"):
        plain_config(GraphConfig(scale=32, nb=1, shuffle_variant="external"), "cpu")
