"""The ring relabel and its gather's plain version against the
reference, on the CPU (tolerance zero: every value is an integer).

- `relabel_gather(..., out=view)` against `repro.kernels.ops.relabel_gather`
  in its "xla" and "interpret" modes: keys inside and outside the chunk,
  key and output views that start 1-3 elements into their buffers, the
  [rows, N] keys of the ring relabel, and the keys themselves as `out`.
- The port's `relabel_ring` against the reference's at nb 1, 2, 4 and 8 (the
  reference runs once, in a subprocess with 8 fake CPU devices), and one
  gather call per field.

`feistel_perm`'s widths and rounds are held in tests/test_torch_kernels.py.
The CUDA kernels are held against these plain versions on the card by
tests/test_torch_gpu.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro_torch.core import relabel
from repro_torch.core.types import GraphConfig
from repro_torch.kernels import ops
from torch_parity import run_reference

MODES = ["xla", "interpret"]
NBS = (1, 2, 4, 8)
SCALE, EDGE_FACTOR = 10, 4

# the ring relabel's inputs, built alike here and in the reference's process
_MAKE = f"""
def make(nb):
    rng = np.random.default_rng(nb)
    n, m = 1 << {SCALE}, {EDGE_FACTOR} << {SCALE}
    src = rng.integers(0, n, m).astype(np.int32)
    dst = rng.integers(0, n, m).astype(np.int32)
    return src, dst, rng.permutation(n).astype(np.int32)
"""
_ns = {"np": np}
exec(_MAKE, _ns)
make = _ns["make"]


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# relabel_gather with out=
# ---------------------------------------------------------------------------


def _gather_case(seed: int, n: int):
    """Sorted keys below, inside and above a chunk of 300 at base 700, and
    negatives."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(-5, 1400, n)).astype(np.int32)
    return keys, rng.permutation(1 << 12)[:300].astype(np.int32), 700


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("key_off,out_off", [(0, 0), (1, 1), (3, 3), (1, 2), (0, 3), (2, 0)])
@pytest.mark.parametrize("n", [1, 5, 1023, 1025])
def test_relabel_gather_into_a_view_matches_reference(mode, key_off, out_off, n):
    keys, chunk, base = _gather_case(n + key_off, n)
    want = ref_ops.relabel_gather(jnp.asarray(keys), jnp.asarray(chunk), base, mode=mode)
    kbuf = torch.full((n + 4,), -9, dtype=torch.int32)
    kbuf[key_off:key_off + n] = torch.from_numpy(keys)
    obuf = torch.full((n + 4,), 77, dtype=torch.int32)
    out = obuf[out_off:out_off + n]
    got = ops.relabel_gather(kbuf[key_off:key_off + n], torch.from_numpy(chunk), base, out=out)
    assert got.data_ptr() == out.data_ptr()
    _eq(out, want)
    rest = torch.cat([obuf[:out_off], obuf[out_off + n:]])
    assert bool((rest == 77).all()), "wrote outside the view"


@pytest.mark.parametrize("mode", MODES)
def test_relabel_gather_rows_and_in_place_match_reference(mode):
    """[rows, N] keys (the ring relabel's sorted field) and out = keys."""
    keys, chunk, base = _gather_case(11, 8 * 300)
    keys = np.sort(keys.reshape(8, 300), axis=1)
    want = ref_ops.relabel_gather(jnp.asarray(keys.reshape(-1)), jnp.asarray(chunk), base,
                                  mode=mode)
    t = torch.from_numpy(keys.copy())
    _eq(ops.relabel_gather(t, torch.from_numpy(chunk), base).reshape(-1), want)
    got = ops.relabel_gather(t, torch.from_numpy(chunk), base, out=t)
    assert got.data_ptr() == t.data_ptr()
    _eq(t.reshape(-1), want)


def test_relabel_gather_rejects_a_bad_out():
    keys, chunk = torch.zeros(8, dtype=torch.int32), torch.ones(4, dtype=torch.int32)
    for out in (torch.zeros(7, dtype=torch.int32), torch.zeros(8, dtype=torch.int64),
                torch.zeros(2, 4, dtype=torch.int32)):
        with pytest.raises(ValueError, match="out must be"):
            ops.relabel_gather(keys, chunk, 0, out=out)
    with pytest.raises(ValueError):
        ops.relabel_gather(torch.zeros(2, 2, 2, dtype=torch.int32), chunk, 0)


# ---------------------------------------------------------------------------
# relabel_ring against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def reference_ring():
    body = _MAKE + f"""
import jax
from repro.core.relabel import relabel_ring
from repro.core.types import GraphConfig
from repro.distributed.collectives import flat_mesh
for nb in {NBS}:
    src, dst, pv = make(nb)
    cfg = GraphConfig(scale={SCALE}, edge_factor={EDGE_FACTOR}, nb=nb)
    s, d = relabel_ring(cfg, flat_mesh(nb), jax.numpy.asarray(src), jax.numpy.asarray(dst),
                        jax.numpy.asarray(pv))
    OUT[f"src{{nb}}"], OUT[f"dst{{nb}}"] = np.asarray(s), np.asarray(d)
"""
    return run_reference(body)


@pytest.mark.parametrize("nb", NBS)
def test_relabel_ring_matches_reference(reference_ring, nb):
    src, dst, pv = make(nb)
    cfg = GraphConfig(scale=SCALE, edge_factor=EDGE_FACTOR, nb=nb)
    new_src, new_dst = relabel.relabel_ring(cfg, torch.from_numpy(src), torch.from_numpy(dst),
                                            torch.from_numpy(pv))
    assert new_src.shape == (nb, cfg.m // nb)
    np.testing.assert_array_equal(new_src.reshape(-1).numpy(), reference_ring[f"src{nb}"])
    np.testing.assert_array_equal(new_dst.reshape(-1).numpy(), reference_ring[f"dst{nb}"])
    np.testing.assert_array_equal(new_src.reshape(-1).numpy(), pv[src])


@pytest.mark.parametrize("nb", NBS)
def test_relabel_field_ring_gathers_once_per_field(monkeypatch, nb):
    """The nb ring rounds of all nb shards are one gather: two a relabel."""
    calls = []

    def counted(keys, chunk, base, out=None):
        calls.append((tuple(keys.shape), chunk.numel(), base, out is keys))
        return ops.relabel_gather(keys, chunk, base, out=out)

    monkeypatch.setattr(relabel, "relabel_gather", counted)
    src, dst, pv = make(nb)
    cfg = GraphConfig(scale=SCALE, edge_factor=EDGE_FACTOR, nb=nb)
    relabel.relabel_ring(cfg, torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(pv))
    assert calls == [((nb, cfg.m // nb), cfg.n, 0, True)] * 2
