"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `gpu`: they skip where torch.cuda.is_available() is false.  This file
imports no jax, so it runs on a machine that has only the port's packages:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""

import pytest
import torch

from repro_torch.core.types import GraphConfig
from repro_torch.kernels import ops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# CUDA kernels against their plain versions (on the card only)
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("scale,start,count", [(25, 0, 1 << 20), (16, (1 << 32) - 1000, 100003)])
def test_rmat_kernel_matches_plain(cuda, scale, start, count):
    cfg = GraphConfig(scale=scale)
    got = ops.rmat_edges(cfg, start, count, device=cuda)
    want = ops.rmat_edges_plain(cfg, start, count, cuda)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("nbits", [1, 16, 25, 31])
def test_feistel_kernel_matches_plain(cuda, nbits):
    g = torch.Generator(device="cpu").manual_seed(nbits)
    x = torch.randint(0, 1 << nbits, (100003,), generator=g, dtype=torch.int64)
    x = x.to(torch.int32).to(cuda)
    assert torch.equal(ops.feistel_perm(x, 0xBEEF, nbits), ops.feistel_perm_plain(x, 0xBEEF, nbits))


@pytest.mark.gpu
@pytest.mark.parametrize("k", [2, 8, 64])
def test_bucket_hist_kernel_matches_plain(cuda, k):
    g = torch.Generator(device="cpu").manual_seed(k)
    dest = torch.randint(0, k + 1, (1_000_003,), generator=g, dtype=torch.int32).to(cuda)
    assert torch.equal(ops.bucket_hist(dest, k), ops.bucket_hist_plain(dest, k))


@pytest.mark.gpu
@pytest.mark.parametrize("base", [0, 3 << 12])
def test_relabel_gather_kernel_matches_plain(cuda, base):
    g = torch.Generator(device="cpu").manual_seed(base)
    chunk = torch.randperm(1 << 12, generator=g).to(torch.int32).to(cuda)
    keys = torch.sort(torch.randint(-1, 5 << 12, (100003,), generator=g, dtype=torch.int32)).values
    keys = keys.to(cuda)
    assert torch.equal(ops.relabel_gather(keys, chunk, base),
                       ops.relabel_gather_plain(keys, chunk, base))
    assert ops.relabel_gather(keys[:0], chunk, base).numel() == 0
