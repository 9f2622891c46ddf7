"""The port's `repro_torch.core` against the reference's `repro.core`: the
package exports the reference's names, and the four validation hooks that
the port lacked (`validate.degree_stats`, `rmat.degree_bias_stat`,
`shuffle.pv_is_permutation`, `hashing.hash_permutation_vector`) give the
reference's results on the same graph: integers and booleans equal, and
`degree_stats`' floats exact.  The reference runs in this process, jax on
the CPU, at nb 1 (one device).

Also `ExchangeServer.stop` (the disk tier's socket receiver): it returns at
once while its accept thread is blocked in accept(), and the thread ends.
"""

import tempfile
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as ref_core
import repro_torch.core as core
from repro.core import hashing as ref_hashing
from repro.core import rmat as ref_rmat
from repro.core import shuffle as ref_shuffle
from repro.core import validate as ref_validate
from repro.core.pipeline import generate as ref_generate
from repro.core.types import GraphConfig as RefGraphConfig
from repro_torch.core import hashing, rmat, shuffle, validate
from repro_torch.core.pipeline import generate
from repro_torch.core.transport import ExchangeServer
from repro_torch.core.types import GraphConfig


def _exports(module):
    return {n for n in vars(module) if not n.startswith("_")
            and not type(vars(module)[n]).__name__ == "module"}


def test_core_exports_the_reference_names():
    """Every name `repro.core` exports (apart from its submodules), and the
    imports the reference's examples use."""
    assert _exports(ref_core) <= _exports(core)
    from repro_torch.core import GraphConfig as G, feistel_permute, generate as gen  # noqa: F401
    assert G is GraphConfig and gen is generate


@pytest.mark.parametrize("scale", [9, 10])
def test_degree_stats_match_reference(scale):
    """The reference's example reads these stats of a generated graph: equal
    floats on the same CSR."""
    got = validate.degree_stats(generate(GraphConfig(scale=scale, nb=1), device="cpu").csr,
                                GraphConfig(scale=scale, nb=1))
    rcfg = RefGraphConfig(scale=scale, nb=1)
    want = ref_validate.degree_stats(ref_generate(rcfg).csr, rcfg)
    assert got == want and got["max_degree"] > got["mean_degree"] > 0


@pytest.mark.parametrize("scale", [9, 12])
def test_degree_bias_stat_matches_reference(scale):
    """Raw R-MAT endpoints are biased to low ids, relabeled ones are not;
    both statistics equal the reference's."""
    cfg, rcfg = GraphConfig(scale=scale, nb=1), RefGraphConfig(scale=scale, nb=1)
    src, dst = rmat.rmat_edge_block(cfg, 0, cfg.m, device="cpu")
    rsrc, rdst = ref_rmat.rmat_edge_block(rcfg, jnp.asarray(0), rcfg.m)
    raw = rmat.degree_bias_stat(src, dst, cfg.n)
    assert raw == ref_rmat.degree_bias_stat(rsrc, rdst, rcfg.n)
    res = generate(cfg, device="cpu")
    ref = ref_generate(rcfg)
    shuffled = rmat.degree_bias_stat(res.src, res.dst, cfg.n)
    assert shuffled == ref_rmat.degree_bias_stat(ref.src, ref.dst, rcfg.n)
    assert raw > 2 / 16 > shuffled


@pytest.mark.parametrize("broken", [False, True])
def test_pv_is_permutation_matches_reference(broken):
    cfg, rcfg = GraphConfig(scale=10, nb=1), RefGraphConfig(scale=10, nb=1)
    pv = generate(cfg, device="cpu").pv.clone()
    rpv = np.array(ref_generate(rcfg).pv)
    assert np.array_equal(pv.numpy(), rpv)
    if broken:
        pv[7], rpv[7] = pv[8], rpv[8]
    got = shuffle.pv_is_permutation(pv)
    assert got.dtype == torch.bool and got.dim() == 0
    assert bool(got) == bool(ref_shuffle.pv_is_permutation(jnp.asarray(rpv))) == (not broken)


@pytest.mark.parametrize("scale,seed", [(9, 1), (10, 7), (13, 0)])
def test_hash_permutation_vector_matches_reference(scale, seed):
    """Odd scales cycle-walk: still the reference's bijection, bit for bit."""
    cfg, rcfg = GraphConfig(scale=scale, seed=seed), RefGraphConfig(scale=scale, seed=seed)
    got = hashing.hash_permutation_vector(cfg, device="cpu")
    want = np.asarray(ref_hashing.hash_permutation_vector(rcfg))
    assert got.dtype == cfg.vertex_dtype
    assert np.array_equal(got.numpy(), want)
    assert bool(shuffle.pv_is_permutation(got))


def test_exchange_server_stop_wakes_a_blocked_accept():
    """stop() with the accept thread blocked in accept(): it returns in well
    under a second (closing alone left accept() blocked, and stop() waited
    its 5 s join), and the thread has ended."""
    with tempfile.TemporaryDirectory() as d:
        srv = ExchangeServer(d)
        thread = srv._accept_thread
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline and thread.is_alive() and not _in_accept(thread):
            time.sleep(0.01)
        time.sleep(0.2)           # from the Python frame into the blocking system call
        assert thread.is_alive() and _in_accept(thread)
        t0 = time.perf_counter()
        srv.stop()
        elapsed = time.perf_counter() - t0
        thread.join(timeout=5)
        assert elapsed < 1.0, elapsed
        assert not thread.is_alive()


def _in_accept(thread: threading.Thread) -> bool:
    """The thread's innermost Python frame is the socket's accept()."""
    import sys

    frame = sys._current_frames().get(thread.ident)
    while frame is not None:
        if frame.f_code.co_name == "accept":
            return True
        frame = frame.f_back
    return False
