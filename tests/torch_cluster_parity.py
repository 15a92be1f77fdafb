"""One harness for the cluster-layer parity tests: a scenario written once
against :class:`Pkg` (the surface of one package) runs through the JAX
package and through the port, each from a clean state, and the two runs
are compared — what the scenario returns (verdicts, memberships, epochs),
the KV keys it left (the wire format), and the ``cluster.*`` journal
records, key by key.

In-process ranks are threads over one ``FileKV`` (:func:`run_ranks`, the
JAX tests' ``_run_ranks``).
"""

import json
import os
import threading

import numpy as np

ENV_VARS = (
    "PENCILARRAYS_TPU_CLUSTER", "PENCILARRAYS_TPU_CLUSTER_RANK",
    "PENCILARRAYS_TPU_CLUSTER_WORLD", "PENCILARRAYS_TPU_CLUSTER_LEASE_TTL",
    "PENCILARRAYS_TPU_CLUSTER_LEASE_INTERVAL",
    "PENCILARRAYS_TPU_CLUSTER_JOIN_GRACE",
    "PENCILARRAYS_TPU_CLUSTER_VERDICT_TIMEOUT", "PENCILARRAYS_TPU_GUARD",
    "PENCILARRAYS_TPU_GUARD_DIR", "PENCILARRAYS_TPU_GUARD_TIMEOUT",
    "PENCILARRAYS_TPU_OBS", "PENCILARRAYS_TPU_FAULTS",
    "PENCILARRAYS_TPU_ELASTIC", "PENCILARRAYS_TPU_ELASTIC_TIMEOUT",
    "PENCILARRAYS_TPU_ELASTIC_MIN_WORLD", "PENCILARRAYS_TPU_ELASTIC_QUORUM",
    "PENCILARRAYS_TPU_OBS_AGG_S")

# journal fields that differ run to run (clocks, process ids, paths,
# measured ages and durations, message texts); every other field is held
# equal, and every record's key set too
VOLATILE = {"t", "ts", "wall", "pid", "host", "age_s", "detect_s",
            "waited_s", "interval_s", "error", "errors", "bundle", "path",
            "run", "run_id", "seq", "thread", "mono", "failed_after_s",
            # how many cache entries a reformation dropped, and how many
            # engines it reformed: each package's own caches and the live
            # engines earlier tests left in the process
            "dropped_executables", "engines"}


class Pkg:
    """The surface of one package the scenarios use."""

    def __init__(self, which: str):
        self.name = which
        if which == "jax":
            import jax

            import pencilarrays_tpu as pa
            from pencilarrays_tpu import cluster, guard, obs
            from pencilarrays_tpu.cluster import consensus, elastic, epoch
            from pencilarrays_tpu.cluster import errors, health, kv
            from pencilarrays_tpu.guard import errors as gerrors
            from pencilarrays_tpu.obs import events, metrics
            from pencilarrays_tpu.parallel import transpositions as tr
            from pencilarrays_tpu.resilience import (CheckpointManager,
                                                     RetryPolicy, faults)
            from pencilarrays_tpu.resilience.errors import InjectedFault

            self._topo = lambda: pa.Topology((1,), devices=jax.devices()[:1])
            self.gather = lambda x: np.asarray(pa.gather(x))
            self.compiled_cache = tr._compiled_transpose
        else:
            import pencilarrays_tpu_torch as pa
            from pencilarrays_tpu_torch import cluster, guard, obs
            from pencilarrays_tpu_torch.cluster import (consensus, elastic,
                                                        epoch)
            from pencilarrays_tpu_torch.cluster import errors, health, kv
            from pencilarrays_tpu_torch.guard import errors as gerrors
            from pencilarrays_tpu_torch.obs import events, metrics
            from pencilarrays_tpu_torch.parallel import transpositions as tr
            from pencilarrays_tpu_torch.resilience import (CheckpointManager,
                                                           RetryPolicy,
                                                           faults)
            from pencilarrays_tpu_torch.resilience.errors import InjectedFault

            self._topo = lambda: pa.Topology((1,), device="cpu")
            self.gather = lambda x: np.asarray(pa.gather(x))
            self.compiled_cache = tr._cached_hop_cost
        self.pa, self.cluster, self.guard, self.obs = pa, cluster, guard, obs
        self.consensus, self.elastic, self.epoch = consensus, elastic, epoch
        self.health, self.kv, self.errors = health, kv, errors
        self.Coordinator = consensus.Coordinator
        self.merge_statuses = consensus.merge_statuses
        self.LeaseBoard = health.LeaseBoard
        self.FileKV, self.FencedKV = kv.FileKV, kv.FencedKV
        self.IntegrityError = gerrors.IntegrityError
        self.HangTimeoutError = gerrors.HangTimeoutError
        self.CheckpointManager, self.RetryPolicy = CheckpointManager, RetryPolicy
        self.faults, self.InjectedFault = faults, InjectedFault
        self.events, self.metrics = events, metrics
        for name in ("ClusterAbortError", "ConsensusTimeoutError",
                     "PeerFailureError", "PeerLeftError", "ReformError",
                     "QuorumLossError", "FencedWriteError"):
            setattr(self, name, getattr(errors, name))

    def reset(self) -> None:
        self.cluster._reset_for_tests()
        self.guard._reset_for_tests()
        self.faults.clear()
        self.events._reset_for_tests()
        self.metrics.registry.reset()

    def mk_state(self, truth):
        pen = self.pa.Pencil(self._topo(), truth.shape, (1,))
        return pen, self.pa.PencilArray.from_global(pen, truth)

    def pencil_like(self, pen, decomposition):
        return self.pa.Pencil(pen.topology, pen.size_global(), decomposition)

    def transpose(self, x, pen):
        return self.pa.transpose(x, pen)


_PKGS = {}


def pkg(which: str) -> Pkg:
    if which not in _PKGS:
        _PKGS[which] = Pkg(which)
    return _PKGS[which]


def run_ranks(*thunks, timeout=120):
    """Run one callable per rank on its own thread (the in-process mesh);
    re-raises the first failure, returns rank -> result."""
    results, errors = {}, {}

    def wrap(r, fn):
        try:
            results[r] = fn()
        except BaseException as e:   # noqa: BLE001 - re-raised below
            errors[r] = e

    threads = [threading.Thread(target=wrap, args=(r, fn))
               for r, fn in enumerate(thunks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if errors:
        raise errors[min(errors)]
    return results


def kv_keys(root) -> list:
    """Every published key under a FileKV root (no in-flight scaffolding)."""
    out = []
    root = str(root)
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith((".tmp", ".lock")) or f.startswith(".tmp"):
                continue
            out.append(os.path.relpath(os.path.join(d, f), root))
    return sorted(out)


def tear(ckdir, step, offset=64):
    """Flip one byte of a committed step's data file."""
    path = os.path.join(str(ckdir), f"step-{step:08d}", "data.bin")
    with open(path, "r+b") as f:
        f.seek(offset)
        b = f.read(1)
        f.seek(offset)
        f.write(bytes([b[0] ^ 0xFF]))


def _canon(v):
    return json.loads(json.dumps(v, sort_keys=True, default=str))


def cluster_records(P: Pkg, obs_dir) -> list:
    """The ``cluster.*`` records of a journal, each as ``(ev, keys, stable
    fields)``, sorted (threads interleave their records)."""
    if not os.path.isdir(str(obs_dir)):
        return []
    out = []
    for e in P.obs.read_journal(str(obs_dir)):
        if not str(e.get("ev", "")).startswith("cluster."):
            continue
        keys = sorted(e)
        stable = {k: v for k, v in e.items()
                  if k not in VOLATILE and not k.startswith("t_")}
        if e["ev"] != "cluster.verdict":
            # the ambient epoch stamp: in-process ranks share one epoch,
            # which a peer thread may advance between two records (a
            # verdict's own epoch is the agreed one, and stays)
            stable.pop("epoch", None)
        out.append(json.dumps([e["ev"], keys, _canon(stable)],
                              sort_keys=True))
    return sorted(out)


def run_both(scenario, tmp_path, monkeypatch, *, compare=True):
    """``scenario(P, d, mp)`` through each package in its own directory
    ``d`` and a clean state; returns ``{which: result}`` after holding the
    port's result, KV keys and ``cluster.*`` records equal to JAX's (the
    result's ``kv`` entry, if any, names KV roots relative to ``d``)."""
    got = {}
    for which in ("jax", "torch"):
        P = pkg(which)
        d = tmp_path / which
        d.mkdir()
        with monkeypatch.context() as mp:
            for var in ENV_VARS:
                mp.delenv(var, raising=False)
            for other in _PKGS.values():
                other.reset()
            try:
                res = scenario(P, d, mp)
            finally:
                P.reset()
        res = dict(res or {})
        roots = res.pop("kv", [])
        res["kv_keys"] = {r: kv_keys(d / r) for r in roots}
        res["journal"] = cluster_records(P, d / "obs")
        got[which] = res
    if compare:
        assert_same(got["jax"], got["torch"])
    return got


def assert_same(want, have) -> None:
    """``have`` equal to ``want``; on a difference, name the entries (and
    the journal records) that differ."""
    want, have = _canon(want), _canon(have)
    if want == have:
        return
    diff = {}
    for k in sorted(set(want) | set(have)):
        if want.get(k) == have.get(k):
            continue
        if k == "journal":
            a, b = set(want.get(k, [])), set(have.get(k, []))
            diff[k] = {"jax only": sorted(a - b), "port only": sorted(b - a)}
        else:
            diff[k] = {"jax": want.get(k), "port": have.get(k)}
    raise AssertionError(json.dumps(diff, indent=1, sort_keys=True))
