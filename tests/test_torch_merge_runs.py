"""`kernels/merge.py::merge_runs` on the CPU (its plain version, the merge
`redistribute_sorted` ran before the kernel): equal to the merge's closed
form on exchanges built by `capacity_all_to_all` at nb 1, 2, 4 and 8 (ties
across every sender, empty buckets, full buckets that drop, a receiver with
nothing); the bucket layout the kernel relies on (live slots a prefix,
sorted by source, in the sender's order); the wrapper's refusals; and the
constants and entry point the wrapper shares with the CUDA source.  The
kernel itself is held to the plain version on the card
(`tests/test_torch_gpu.py`)."""

import re

import pytest
import torch

from merge_cases import exchange
from repro_torch.kernels import build, merge
from repro_torch.kernels.merge import merge_runs

N = 1 << 12
KINDS = {
    "spread": dict(per_sender=600),
    "hub in every sender": dict(per_sender=600, hub=300),
    "few edges, empty buckets": dict(per_sender=2),
    "full buckets drop": dict(per_sender=600, cap_factor=0.5),
    "no edges": dict(per_sender=0),
    "a receiver with nothing": dict(per_sender=600, empty_receiver=-1),
}


def case(nb, kind):
    spec = dict(KINDS[kind])
    cap = int(spec.pop("cap_factor", 2.0) * spec["per_sender"] / nb) + 1
    if spec.get("empty_receiver") == -1:
        spec["empty_receiver"] = nb - 1
    return exchange(nb, n=N, cap=cap, seed=nb * 31 + len(kind), **spec)


def merged(data, valid):
    """The merge's closed form: each receiver's live records in sender-major
    order, stably sorted by source, then src 0, dst 0, valid False."""
    nb, cap = data.shape[0], data.shape[2]
    out_src = torch.zeros((nb, nb * cap), dtype=torch.int32)
    out_dst = torch.zeros_like(out_src)
    out_valid = torch.zeros((nb, nb * cap), dtype=torch.bool)
    for r in range(nb):
        live = data[r][valid[r]]                       # [live, 2], senders in turn
        order = torch.sort(live[:, 0], stable=True).indices
        k = live.shape[0]
        out_src[r, :k], out_dst[r, :k] = live[order, 0], live[order, 1]
        out_valid[r, :k] = True
    return out_src, out_dst, out_valid


CASES = [(nb, kind) for nb in (1, 2, 4, 8) for kind in KINDS
         if not (nb == 1 and kind == "a receiver with nothing")]


@pytest.mark.parametrize("nb,kind", CASES)
def test_plain_path_equals_the_closed_form(nb, kind):
    ex = case(nb, kind)
    if kind == "full buckets drop":
        assert int(ex.dropped) > 0 and bool((ex.valid.sum(-1) == ex.valid.shape[-1]).any())
    if kind == "a receiver with nothing":
        assert int(ex.valid[nb - 1].sum()) == 0
    if kind == "few edges, empty buckets" and nb > 1:
        assert bool((ex.valid.sum(-1) == 0).any())
    for got, want in zip(merge_runs(ex.data, ex.valid, N), merged(ex.data, ex.valid)):
        assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("nb,kind", CASES)
def test_live_slots_are_a_sorted_prefix_in_sender_order(nb, kind):
    """What the kernel relies on: bucket (r, s) holds sender s's records for
    receiver r, in the sender's (source-sorted) order, as a prefix of its
    slots, cut at the capacity."""
    ex = case(nb, kind)
    cap = ex.valid.shape[-1]
    length = ex.valid.sum(-1)
    assert torch.equal(ex.valid, torch.arange(cap) < length[..., None])
    for r in range(nb):
        for s in range(nb):
            live = ex.data[r, s, :int(length[r, s])]
            assert bool((live[1:, 0] >= live[:-1, 0]).all())
            assert bool((live[:, 0] * nb // N == r).all())


def test_wrapper_refuses_wrong_dtype_shape_and_layout():
    ex = case(4, "spread")
    data, valid = ex.data, ex.valid
    bad = [
        (TypeError, data.to(torch.int64), valid),
        (TypeError, data, valid.to(torch.uint8)),
        (ValueError, data[:, :2], valid[:, :2]),
        (ValueError, data[..., :1], valid),
        (ValueError, data, valid[..., :-1]),
        (ValueError, data.reshape(4, 4, -1), valid),
        (ValueError, data.transpose(0, 1), valid.transpose(0, 1)),
        (ValueError, data, valid.transpose(1, 2).contiguous().transpose(1, 2)),
    ]
    for err, d, v in bad:
        with pytest.raises(err):
            merge_runs(d, v, N)


def test_constants_and_entry_point_match_the_cuda_source():
    """The scratch the wrapper sizes and the arguments it passes are the
    kernel's: TILE, FAN and MAX_RUNS are its constexprs, the ctypes
    signature has its entry point's arity, and the kernel is counted."""
    src = build.CSRC.joinpath("graph_kernels.cu").read_text()
    consts = dict(re.findall(r"constexpr int (kMerge\w+) = (\d+);", src))
    assert (int(consts["kMergeTile"]), int(consts["kMergeFan"]), int(consts["kMergeMaxRuns"])) == \
        (merge.TILE, merge.FAN, merge.MAX_RUNS)
    params = re.search(r"int merge_runs_launch\((.*?)\)", src, re.S).group(1)
    assert len(params.split(",")) == len(build._SIGNATURES["merge_runs_launch"])
    assert "merge_runs" in build.KERNELS and build.LAUNCHES["merge_runs"] >= 0
