"""The port's twin of tests/test_cluster_property.py: hypothesis property
tests for the cluster config-shape invariants of `repro_torch` —
ClusterSpec / peer_addrs parsing round-trips, bucket-ownership partition
laws, result_config_key normalizing cluster/transport fields out of
checkpoint keys (resume across cluster shapes must hit the same key), and
the shard-map laws (core/shardmap.py): partition preserved under arbitrary
assign/admit histories, strict version bumps, JSON round-trips,
stale-frame fencing, and plan_rebalance determinism/conservation.

Each law is also checked against the reference's own objects where one
exists (the same spec JSON, owners, plans and fencing answers), so the
port's copies cannot drift from the reference.  The non-hypothesis twins of
the critical cases live in tests/test_torch_cluster.py.
"""

import dataclasses

import pytest

import torch_parity  # noqa: F401  (sets hypothesis's storage directory first)

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core import cluster as ref_cluster  # noqa: E402
from repro.core import shardmap as ref_shardmap  # noqa: E402
from repro_torch.core.cluster import (  # noqa: E402
    ClusterSpec,
    HostSpec,
    format_peer_addrs,
    parse_peer_addrs,
)
from repro_torch.core.phases import PlainCfg, result_config_key  # noqa: E402
from repro_torch.core.shardmap import (  # noqa: E402
    ShardMap,
    apply_moves,
    frame_version_ok,
    plan_rebalance,
)

_SETTINGS = dict(max_examples=80, deadline=None)

_hostname = st.from_regex(r"[a-z][a-z0-9\-\.]{0,15}", fullmatch=True)


@st.composite
def cluster_specs(draw):
    num_hosts = draw(st.integers(1, 8))
    nb = draw(st.integers(num_hosts, 64))
    hosts = tuple(
        HostSpec(h, f"/data/w{h}", draw(_hostname))
        for h in range(num_hosts))
    return ClusterSpec(nb=nb, hosts=hosts,
                       controller_host=draw(_hostname),
                       controller_port=draw(st.integers(0, 65535)))


@given(spec=cluster_specs())
@settings(**_SETTINGS)
def test_cluster_spec_json_round_trip(spec):
    assert ClusterSpec.from_json(spec.to_json()) == spec
    # the reference reads the port's manifest to the same spec, and back
    assert ref_cluster.ClusterSpec.from_json(spec.to_json()).to_json() == spec.to_json()


@given(spec=cluster_specs())
@settings(**_SETTINGS)
def test_bucket_ownership_is_a_contiguous_partition(spec):
    """Every bucket owned exactly once, ranges contiguous and in host order
    (the paper's RP applied to hosts), owner_of inverts buckets_of."""
    seen = []
    for h in range(spec.num_hosts):
        r = spec.buckets_of(h)
        assert r.step == 1
        seen.extend(r)
    assert seen == list(range(spec.nb))
    ref = ref_cluster.ClusterSpec.from_json(spec.to_json())
    for b in range(spec.nb):
        assert b in spec.buckets_of(spec.owner_of(b))
        assert spec.owner_of(b) == ref.owner_of(b)


@given(addrs=st.lists(
    st.tuples(_hostname, st.integers(0, 65535)).map(
        lambda t: f"{t[0]}:{t[1]}"),
    min_size=1, max_size=16).map(tuple))
@settings(**_SETTINGS)
def test_peer_addrs_round_trip(addrs):
    assert parse_peer_addrs(format_peer_addrs(addrs)) == addrs
    assert format_peer_addrs(addrs) == ref_cluster.format_peer_addrs(addrs)


@st.composite
def plain_cfgs(draw):
    scale = draw(st.integers(6, 16))
    nb = draw(st.sampled_from([1, 2, 4]))
    return PlainCfg(
        scale=scale, edge_factor=draw(st.integers(1, 8)),
        seed=draw(st.integers(0, 2**31 - 1)),
        a=0.57, b=0.19, c=0.19, d=0.05,
        nb=nb, chunk_edges=draw(st.sampled_from([128, 256, 1 << 14])),
        rounds=draw(st.integers(1, 4)),
        merge_fanin=draw(st.sampled_from([0, 2, 64])),
    )


@given(pcfg=plain_cfgs(),
       peers=st.none() | st.lists(
           st.tuples(_hostname, st.integers(0, 65535)).map(
               lambda t: f"{t[0]}:{t[1]}"),
           min_size=1, max_size=4).map(tuple),
       transport=st.sampled_from(["fs", "socket"]),
       device=st.sampled_from(["cpu", "cuda"]))
@settings(**_SETTINGS)
def test_result_config_key_erases_transport_and_peers(pcfg, peers, transport, device):
    """The checkpoint key is invariant under everything that only moves
    bytes differently — transport choice, peer addresses (any cluster
    shape/ports), the device the hooks run on — and keyed on everything
    that changes the bytes or the phase schedule."""
    varied = dataclasses.replace(pcfg, transport=transport, peer_addrs=peers,
                                 device=device)
    assert result_config_key(varied) == result_config_key(pcfg)
    # ... but not under result-affecting fields:
    assert result_config_key(dataclasses.replace(pcfg, seed=pcfg.seed ^ 1)) \
        != result_config_key(pcfg)
    # pooled_cascade changes the phase schedule -> deliberately kept in key
    assert result_config_key(
        dataclasses.replace(pcfg, pooled_cascade=True)) \
        != result_config_key(dataclasses.replace(pcfg, pooled_cascade=False))
    # ... and the live shard-map version is pure routing state: a resumed
    # run must hit the same checkpoint keys after any number of rebalances
    assert result_config_key(
        dataclasses.replace(pcfg, shard_map_version=7)) \
        == result_config_key(pcfg)


# ---------------------------------------------------------------------------
# ShardMap laws (core/shardmap.py)
# ---------------------------------------------------------------------------


def _apply_history(nb, num_hosts, ops):
    """Replay a drawn (admit | assign) op list as VALID mutations, mapping
    raw drawn ints onto the map's current shape; returns the map plus the
    count of applied mutations and of applied assigns."""
    smap = ShardMap.contiguous(nb, num_hosts)
    mutations = assigns = 0
    for op in ops:
        if op[0] == "admit":
            hid = smap.admit_host()
            assert hid == smap.num_hosts - 1
            mutations += 1
        else:
            if smap.num_hosts < 2:
                continue   # every assign would be a rejected no-op
            b = op[1] % smap.nb
            h = op[2] % smap.num_hosts
            if h == smap.owner_of(b):
                h = (h + 1) % smap.num_hosts
            smap.assign(b, h)
            mutations += 1
            assigns += 1
    return smap, mutations, assigns


_ops = st.lists(
    st.one_of(
        st.just(("admit",)),
        st.tuples(st.just("assign"), st.integers(0, 2**32),
                  st.integers(0, 2**32))),
    max_size=24)


@given(num_hosts=st.integers(1, 8), nb=st.integers(0, 64))
@settings(**_SETTINGS)
def test_contiguous_map_reproduces_static_split(num_hosts, nb):
    nb += num_hosts   # nb >= num_hosts
    smap = ShardMap.contiguous(nb, num_hosts)
    spec = ClusterSpec(nb=nb, hosts=tuple(
        HostSpec(h, f"/data/w{h}") for h in range(num_hosts)))
    assert smap.version == 0 and smap.gens == [0] * nb
    for b in range(nb):
        assert smap.owner_of(b) == spec.owner_of(b)
    for h in range(num_hosts):
        assert smap.buckets_of(h) == list(spec.buckets_of(h))
    assert smap.to_json() == ref_shardmap.ShardMap.contiguous(nb, num_hosts).to_json()


@given(num_hosts=st.integers(1, 6), nb=st.integers(0, 26), ops=_ops)
@settings(**_SETTINGS)
def test_mutation_history_preserves_partition_and_bumps_version(
        num_hosts, nb, ops):
    nb += num_hosts
    smap, mutations, assigns = _apply_history(nb, num_hosts, ops)
    smap.validate()   # partition invariant after ANY valid history
    # every mutation bumps the version exactly once; every assign bumps
    # exactly one bucket's gen exactly once
    assert smap.version == mutations
    assert sum(smap.gens) == assigns
    # buckets_of inverts owner_of and partitions range(nb)
    seen = [b for h in range(smap.num_hosts) for b in smap.buckets_of(h)]
    assert sorted(seen) == list(range(nb))
    # JSON round-trip is exact, and the reference reads the same map
    assert ShardMap.from_json(smap.to_json()) == smap
    assert ref_shardmap.ShardMap.from_json(smap.to_json()).to_json() == smap.to_json()


@given(frame=st.none() | st.integers(0, 2**31), minv=st.integers(0, 2**31))
@settings(**_SETTINGS)
def test_frame_version_fencing_laws(frame, minv):
    # unversioned senders always pass (compat); versioned frames pass
    # iff at-or-past the ratchet, so passing is monotone in the frame
    # version and anti-monotone in the ratchet
    ok = frame_version_ok(frame, minv)
    assert ok == ref_shardmap.frame_version_ok(frame, minv)
    if frame is None:
        assert ok
    else:
        assert ok == (frame >= minv)
        if ok:
            assert frame_version_ok(frame + 1, minv)
        if minv:
            assert frame_version_ok(frame, minv - 1) or not ok


@st.composite
def rebalance_cases(draw):
    num_hosts = draw(st.integers(1, 6))
    nb = num_hosts + draw(st.integers(0, 12))
    smap, _, _ = _apply_history(nb, num_hosts, draw(_ops))
    loads = dict(enumerate(draw(st.lists(st.integers(0, 1 << 30),
                                         min_size=nb, max_size=nb))))
    return smap, loads, draw(st.integers(0, 4))


@given(case=rebalance_cases())
@settings(**_SETTINGS)
def test_plan_rebalance_laws(case):
    smap, loads, max_moves = case
    moves = plan_rebalance(smap, loads, max_moves=max_moves)
    # pure function of (map, loads): replanning from the same snapshot
    # (e.g. a resumed rebalance) yields the identical plan
    assert plan_rebalance(smap, loads, max_moves=max_moves) == moves
    # ... and the reference's plan for the same map and loads
    ref_map = ref_shardmap.ShardMap.from_json(smap.to_json())
    assert ref_shardmap.plan_rebalance(ref_map, loads, max_moves=max_moves) == moves
    # each bucket moves at most once per plan (one barrier dispatch)
    assert len({b for b, _, _ in moves}) == len(moves)
    if max_moves:
        assert len(moves) <= max_moves
    if smap.num_hosts < 2:
        assert moves == []

    def host_loads(owners):
        hl = [0] * smap.num_hosts
        for b, v in loads.items():
            hl[owners[b]] += v
        return hl

    before = host_loads(smap.owners)
    vbefore = smap.version
    # the plan applies cleanly (src fields match live owners, in order)
    apply_moves(smap, moves)
    smap.validate()
    assert smap.version == vbefore + len(moves)
    after = host_loads(smap.owners)
    # conservation: rebalancing moves bytes, never creates or drops them
    assert sum(after) == sum(before)
    # a non-empty plan strictly improves balance (sum of squared host
    # loads — the potential function that proves the planner terminates)
    if moves:
        assert sum(v * v for v in after) < sum(v * v for v in before)
