"""Helpers of the port's cluster tests (`test_torch_cluster*.py`,
`test_torch_shardmap.py`, `test_torch_jobqueue*.py`), and the job queue's
three test jobs.

The oracle of every cluster run is the reference's in-process
PartitionedGenerator fs run of the same graph (`reference`): the port's hosts
must leave its CSR bucket files and corpus shards byte for byte
(`host_shas`), and its pv bucket stores (`cluster_pv`).  Port hosts run with
`device="cpu"`.
"""

from __future__ import annotations

import os

import numpy as np

import repro_torch
from repro.core.phases import PartitionedGenerator as RefPartitioned
from repro.core.types import GraphConfig as RefConfig
from repro_torch.core.blockstore import BlockStore
from repro_torch.core.cluster import ClusterGenerator, ClusterSpec, LocalExecBackend
from repro_torch.core.jobqueue import JobScheduler
from repro_torch.core.phases import pv_store_name
from repro_torch.core.types import GraphConfig

from torch_parity import npy_shas

SRC = os.path.dirname(os.path.dirname(os.path.abspath(repro_torch.__file__)))
ENV = {"PYTHONPATH": SRC}
BASE = dict(scale=9, nb=4, chunk_edges=256, edge_factor=4)
CFG = GraphConfig(**BASE, shuffle_variant="external")
W, L, WSEED = 17, 5, 3
_REF = {}


def reference(tmp_path_factory, fields=None, walks=((W, L, WSEED, "walks.npy"),)):
    """(sha256 of every .npy file, {out_name: corpus}, pv or None) of the
    reference's in-process fs run of GraphConfig(**fields) (default: CFG's)
    and its corpora, once per configuration in a test process."""
    fields = dict(fields or {**BASE, "shuffle_variant": "external"})
    key = (tuple(sorted(fields.items())), tuple(walks))
    if key not in _REF:
        d = str(tmp_path_factory.mktemp("ref"))
        with RefPartitioned(RefConfig(**fields), d, max_workers=0) as part:
            part.run()
            corpora = {o: np.asarray(part.walk_corpus(w, n, seed=s, out_name=o)).copy()
                       for w, n, s, o in walks}
            pv = (None if fields.get("shuffle_variant") == "recompute" else
                  np.concatenate([np.concatenate([v for (v,) in b.iter_runs()])
                                  for b in part.pv_buckets()]))
        _REF[key] = (npy_shas(d), corpora, pv)
    return _REF[key]


def workdir_shas(workdirs, ns=None) -> dict:
    """{file: sha256} of the .npy files in `workdirs` (in their `ns` subdir
    when given); each file lives in one of them only."""
    out = {}
    for wd in workdirs:
        shas = npy_shas(os.path.join(wd, ns) if ns else wd)
        assert not set(shas) & set(out), "a file on two hosts"
        out.update(shas)
    return out


def host_shas(gen) -> dict:
    """`workdir_shas` of every host of `gen`, in its job subdir."""
    return workdir_shas([h.workdir for h in gen.controller.spec.hosts],
                        gen.pcfg.exchange_namespace)


def cluster_pv(gen) -> np.ndarray:
    """The final pv bucket stores, each read on its owner host."""
    p = gen.pcfg
    return np.concatenate([
        np.concatenate([v for (v,) in BlockStore.attach(
            gen._host_dir(i), pv_store_name(p.rounds, i), gen.ledger,
            columns=("v",)).iter_runs()])
        for i in range(p.nb)])


def make_cluster(tmp_path, name, cfg=CFG, backend=None, hosts=2, **kw):
    """A `hosts`-host CPU ClusterGenerator of `cfg` over sockets, with
    checkpoints, under tmp_path/name; returns (spec, generator)."""
    spec = ClusterSpec.local(hosts, str(tmp_path / name), nb=cfg.nb)
    gen = ClusterGenerator(
        cfg.with_(transport="socket"), spec, str(tmp_path / name / "ctrl"),
        backend=backend if backend is not None else LocalExecBackend(env=ENV),
        checkpoint=True, device="cpu", **kw)
    return spec, gen


class KillHostFirst(LocalExecBackend):
    """Crash injection: host `host_id`'s FIRST launch dies hard (os._exit)
    after executing `max_tasks` tasks — mid-phase, like kill -9."""

    def __init__(self, host_id=1, max_tasks=6, env=None):
        super().__init__(env={**ENV, **(env or {})})
        self.host_id = host_id
        self.max_tasks = max_tasks

    def host_args(self, host, attempt):
        if host.host_id == self.host_id and attempt == 0:
            return ["--max-tasks", str(self.max_tasks)]
        return []


# ---------------------------------------------------------------------------
# the job queue's jobs (test_torch_jobqueue*.py)
# ---------------------------------------------------------------------------

JOB_CFG = GraphConfig(scale=8, nb=4, chunk_edges=256, edge_factor=4,
                      shuffle_variant="recompute", transport="socket")
JOBS = [
    dict(cfg=JOB_CFG.with_(seed=1), fuse_gen_relabel=True, fuse_walks=True,
         walks=[(8, 3, 1, "a.npy"), (8, 3, 2, "b.npy")]),
    dict(cfg=JOB_CFG.with_(seed=2), walks=[(8, 3, 7, "c.npy")]),
    dict(cfg=JOB_CFG.with_(scale=9, seed=3), fuse_gen_relabel=True, walks=[]),
]


def job_reference(tmp_path_factory, jobdef):
    """{file: sha256} of the reference's in-process fs run of one job alone
    (its graph and its corpora, unfused: fusion changes no byte)."""
    c = jobdef["cfg"]
    fields = dict(scale=c.scale, nb=c.nb, chunk_edges=c.chunk_edges,
                  edge_factor=c.edge_factor, seed=c.seed, shuffle_variant=c.shuffle_variant)
    return reference(tmp_path_factory, fields, tuple(jobdef.get("walks", ())))[0]


def job_shas(sched, tag) -> dict:
    """{file: sha256} of the .npy files a job left in its subdir on the hosts."""
    return workdir_shas([h.workdir for h in sched.spec.hosts], tag)


def scheduler(root, backend=None, **kw):
    spec = ClusterSpec.local(2, os.path.join(root, "hosts"), nb=JOB_CFG.nb)
    kw.setdefault("heartbeat_timeout", 20.0)
    return JobScheduler(spec, os.path.join(root, "ctrl"),
                        backend=backend if backend is not None else LocalExecBackend(env=ENV),
                        device="cpu", **kw)


def submit_all(sched, jobs=JOBS):
    return [sched.submit(j["cfg"], walks=j.get("walks", ()),
                         fuse_walks=j.get("fuse_walks", False),
                         fuse_gen_relabel=j.get("fuse_gen_relabel", False))
            for j in jobs]
