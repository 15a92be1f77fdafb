"""PyTorch port vs JAX package: resilience (``resilience/``, the retry and
fault hooks of ``parallel/distributed.py`` and the transpose).

The cases of ``tests/test_resilience.py`` (the Orbax half of its
checksums-off case aside): fault spec parsing, deterministic counters,
retry and deadline, the rendezvous retries of ``initialize``, and the
checkpoint cases — round trip and layout, collections, retention GC,
uncommitted steps skipped, re-save safety, corruption named by dataset
and block, the truncation fuzz, cross-decomposition restore — on the
port's CPU path over 1, 2 and 4 gloo ranks of one pool
(``torch_rank_tasks.ckpt_case``).  The drills that need a real kill run
in a subprocess with a timeout of their own.  Data movement is
bit-identical; there is no tolerance here.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch.distributed as tdist

import pencilarrays_tpu.resilience.faults as jax_faults
import pencilarrays_tpu_torch as pat
import torch_rank_tasks as tasks
from pencilarrays_tpu_torch.parallel import distributed
from pencilarrays_tpu_torch.resilience import (
    CheckpointManager,
    InjectedFault,
    ResilienceError,
    RetryDeadlineExceeded,
    RetryPolicy,
    faults,
    is_transient,
)

DIMS = [(1, 1), (1, 2), (2, 2)]
DIM_IDS = ["x".join(map(str, d)) for d in DIMS]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pool():
    return tasks.shared_pool()


# -- faults ----------------------------------------------------------------

@pytest.mark.parametrize("spec", [
    "io.write_block:torn@3",
    "dist.initialize:error*3, barrier:kill@2",
    "hop.exchange:corrupt%rank1@2; fleet.route:kill%mesh1@4",
    "hop.exchange:delay*2, ckpt.commit:error",
])
def test_fault_spec_parsing_matches_jax(spec):
    """The same grammar gives the JAX package's rules."""
    def fields(rules):
        return [(r.point, r.mode, r.times, r.first, r.rank, r.mesh)
                for r in rules]

    assert fields(faults.parse(spec)) == fields(jax_faults.parse(spec))


@pytest.mark.parametrize("spec,match", [
    ("io.wrte_block:error", "unknown injection point"),
    ("barrier:explode", "mode"),
    ("barrier:error@0", "1-based"),
    ("barrier:error%node2", "selector"),
])
def test_fault_spec_errors(spec, match):
    with pytest.raises(ValueError, match=match):
        faults.parse(spec)


def test_fault_counters_are_deterministic():
    with faults.active("io.flush_meta:error*2@2"):
        faults.fire("io.flush_meta")  # hit 1: passes
        for _ in range(2):            # hits 2-3: trigger
            with pytest.raises(InjectedFault):
                faults.fire("io.flush_meta")
        faults.fire("io.flush_meta")  # hit 4: exhausted, passes
        faults.fire("io.open")        # other points untouched
    faults.fire("io.flush_meta")      # rules cleared


def test_rank_and_mesh_selectors():
    """``%rank0`` matches a process without a group (rank 0); ``%mesh``
    never matches until the fleet layer exists."""
    with faults.active("io.open:error%rank1, io.flush_meta:error%mesh0"):
        faults.fire("io.open")
        faults.fire("io.flush_meta")
    with faults.active("io.open:error%rank0"):
        with pytest.raises(InjectedFault):
            faults.fire("io.open")


def test_injected_fault_is_transient_oserror():
    with faults.active("barrier:error"):
        with pytest.raises(InjectedFault) as ei:
            distributed.sync_global_devices("probe")
    assert isinstance(ei.value, OSError)
    assert isinstance(ei.value, ResilienceError)
    assert is_transient(ei.value)


def test_fault_env_rearm(monkeypatch):
    """The env spec is re-read when it changes: a worker can arm itself
    after import."""
    monkeypatch.setenv(faults.ENV_VAR, "io.open:error")
    with pytest.raises(InjectedFault):
        faults.fire("io.open")
    monkeypatch.setenv(faults.ENV_VAR, "")
    faults.fire("io.open")


# -- retry -----------------------------------------------------------------

def test_retry_succeeds_after_transient_failures():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise ConnectionError("not up yet")
        return "ok"

    policy = RetryPolicy(max_attempts=5, base_delay=0.001, deadline=5.0)
    assert policy.call(flaky, label="flaky") == "ok"
    assert len(calls) == 3


def test_retry_does_not_touch_nontransient():
    def boom():
        raise FileNotFoundError("missing is not transient")

    with pytest.raises(FileNotFoundError):
        RetryPolicy(max_attempts=5, base_delay=0.001).call(boom)


def test_retry_deadline_exceeded():
    def always():
        raise ConnectionError("down")

    policy = RetryPolicy(max_attempts=100, base_delay=0.2, max_delay=0.2,
                         deadline=0.05)
    with pytest.raises(RetryDeadlineExceeded) as ei:
        policy.call(always, label="down-service")
    assert isinstance(ei.value.__cause__, ConnectionError)


def test_retry_exhausts_attempts_reraises_original():
    def always():
        raise ConnectionError("down")

    with pytest.raises(ConnectionError):
        RetryPolicy(max_attempts=3, base_delay=0.001).call(always)


def test_retry_policy_env_knobs(monkeypatch):
    monkeypatch.setenv("PENCILARRAYS_TPU_RETRIES", "7")
    monkeypatch.setenv("PENCILARRAYS_TPU_RETRY_DEADLINE", "1.5")
    p = RetryPolicy.from_env()
    assert p.max_attempts == 7 and p.deadline == 1.5


# -- initialize: rendezvous retries ----------------------------------------

class _FakeDist:
    """``torch.distributed``'s group state, faked: ``init`` runs
    ``behaviour(attempt)`` after marking a group as built (what a failed
    rendezvous may leave behind)."""

    def __init__(self, monkeypatch, behaviour=lambda n: None):
        self.attempts, self.destroyed, self.up = 0, 0, False
        self.behaviour = behaviour
        monkeypatch.setattr(tdist, "is_initialized", lambda: self.up)
        monkeypatch.setattr(tdist, "init_process_group", self.init)
        monkeypatch.setattr(tdist, "destroy_process_group", self.destroy)

    def init(self, *a, **k):
        self.attempts += 1
        self.up = True
        self.behaviour(self.attempts)

    def destroy(self):
        self.destroyed += 1
        self.up = False


def test_initialize_retries_injected_faults(monkeypatch):
    """``dist.initialize`` under injected transient failures joins within
    the retry deadline instead of crashing."""
    fake = _FakeDist(monkeypatch)
    policy = RetryPolicy(max_attempts=10, base_delay=0.001, deadline=10.0)
    with faults.active("dist.initialize:error*3"):
        distributed.initialize("gloo", retry=policy)
    assert fake.attempts == 1 and fake.up
    with pytest.raises(RuntimeError, match="already initialized"):
        distributed.initialize("gloo")


def test_initialize_deadline_bounds_persistent_failure(monkeypatch):
    fake = _FakeDist(monkeypatch)
    policy = RetryPolicy(max_attempts=100, base_delay=0.2, max_delay=0.2,
                         deadline=0.05)
    with faults.active("dist.initialize:error"):
        with pytest.raises(RetryDeadlineExceeded):
            distributed.initialize("gloo", retry=policy)
    assert fake.attempts == 0 and not fake.up


def test_initialize_retry_resets_partial_state(monkeypatch):
    """A rendezvous that fails after building part of the default group
    is rolled back, so the retry can join again."""
    def timed_out(n):
        if n < 3:
            raise RuntimeError("timed out waiting for the store at "
                               "tcp://localhost:1")

    fake = _FakeDist(monkeypatch, timed_out)
    fast = RetryPolicy(max_attempts=5, base_delay=0.001, deadline=5.0)
    distributed.initialize("gloo", retry=fast)
    assert fake.attempts == 3 and fake.destroyed == 2 and fake.up


@pytest.mark.parametrize("message,attempts", [
    ("Connection refused", 3),
    ("DEADLINE_EXCEEDED: timed out connecting to the store", 3),
    ("Invalid rank 7, world size 2", 1),
])
def test_initialize_runtime_error_classification(monkeypatch, message,
                                                 attempts):
    """Transient-looking rendezvous errors are retried; configuration
    errors fail at once."""
    def fail(n):
        if n < 3:
            raise RuntimeError(message)

    fake = _FakeDist(monkeypatch, fail)
    fast = RetryPolicy(max_attempts=5, base_delay=0.001, deadline=5.0)
    if attempts == 1:
        with pytest.raises(RuntimeError, match="Invalid rank"):
            distributed.initialize("gloo", retry=fast)
    else:
        distributed.initialize("gloo", retry=fast)
    assert fake.attempts == attempts


def test_election_waits_for_the_cluster_layer(tmp_path):
    """The election is ported: without a coordinator it is latest_valid();
    two ranks (a thread each over one FileKV) agree on the newest step
    valid on both, though rank 0's newest step is torn."""
    import threading

    from pencilarrays_tpu_torch.cluster.consensus import Coordinator
    from pencilarrays_tpu_torch.cluster.kv import FileKV

    assert CheckpointManager(str(tmp_path / "none")).common_latest_valid() \
        is None
    topo = pat.Topology((1, 1), device="cpu")
    pen = pat.Pencil(topo, (6, 5, 4), (1, 2))
    u = pat.PencilArray.from_global(
        pen, np.random.default_rng(2).standard_normal((6, 5, 4)))
    mgrs = [CheckpointManager(str(tmp_path / f"ck{r}"), keep=4)
            for r in range(2)]
    for m in mgrs:
        m.save(1, {"u": u})
        m.save(2, {"u": u})
    with open(str(tmp_path / "ck0" / "step-00000002" / "data.bin"),
              "r+b") as f:
        f.seek(16)
        b = f.read(1)
        f.seek(16)
        f.write(bytes([b[0] ^ 0xFF]))
    assert [m.latest_valid() for m in mgrs] == [1, 2]
    kv = FileKV(str(tmp_path / "kv"))
    coords = [Coordinator(kv, r, 2, lease_ttl=10.0, verdict_timeout=30.0)
              for r in range(2)]
    got = {}

    def elect(r):
        got[r] = mgrs[r].common_latest_valid(coordinator=coords[r])

    threads = [threading.Thread(target=elect, args=(r,)) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    for c in coords:
        c.shutdown()
    assert got == {0: 1, 1: 1}


def test_process_queries_without_a_group(monkeypatch):
    monkeypatch.setattr(tdist, "is_initialized", lambda: False)
    assert distributed.process_index() == 0
    assert distributed.process_count() == 1
    assert not distributed.is_multiprocess()


# -- the hop.exchange point --------------------------------------------------

def _hop_setup():
    """x on an x-pencil, and a y-pencil one hop away."""
    topo = pat.Topology((1, 1), device="cpu")
    shape = (6, 7, 5)
    px = pat.Pencil(topo, shape, (1, 2), permutation=pat.Permutation(1, 2, 0))
    py = pat.Pencil(topo, shape, (0, 2), permutation=pat.Permutation(0, 2, 1))
    u = np.random.default_rng(1).standard_normal(shape)
    return pat.PencilArray.from_global(px, u), py, u


def test_hop_exchange_raise_surfaces_from_transpose():
    x, py, u = _hop_setup()
    pz = pat.Pencil(py.topology, py.size_global(), (0, 1))
    with faults.active("hop.exchange:error@2"):
        y = pat.transpose(x, py)                     # hit 1 passes
        with pytest.raises(InjectedFault, match="hop.exchange"):
            pat.transpose(x, py)
        with pytest.raises(InjectedFault):
            pat.reshard(x, pz, method=pat.AllToAll())  # the routed path
        assert faults.hit_count("hop.exchange") == 3
    np.testing.assert_array_equal(pat.gather(y), u)


def test_hop_exchange_delay_keeps_bits(monkeypatch):
    monkeypatch.setenv(faults.DELAY_S_VAR, "0.01")
    x, py, u = _hop_setup()
    with faults.active("hop.exchange:delay"):
        y = pat.transpose(x, py, method=pat.Ring())
        assert faults.hit_count("hop.exchange") == 1
    np.testing.assert_array_equal(pat.gather(y), u)


# -- checkpoint cases on 1, 2 and 4 ranks -----------------------------------

@pytest.mark.parametrize("dims", DIMS, ids=DIM_IDS)
@pytest.mark.parametrize("case", sorted(tasks._CKPT_CASES))
def test_checkpoint_case(pool, tmp_path, dims, case):
    if case == "hdf5":
        pytest.importorskip("h5py")
    pool.run(tasks.ckpt_case, dims, case, str(tmp_path))


@pytest.mark.parametrize("torn", [False, True], ids=["intact", "torn"])
def test_cross_decomposition_restore(pool, tmp_path, torn):
    """A checkpoint written on (2, 2) restores onto (4, 1), (1, 2) and one
    rank bit-identically, verified in full and locally; a torn newest
    step is skipped and reading it raises a typed failure."""
    pool.run(tasks.ckpt_cross_decomposition, str(tmp_path), torn)


def test_save_reports_its_stages(pool, tmp_path):
    stats = pool.run(tasks.ckpt_case, (1, 2), "roundtrip_layout",
                     str(tmp_path))[0]
    assert {"k1_s", "d2h_s", "crc_s", "write_s", "fsync_s", "meta_s",
            "commit_s", "total_s"} <= set(stats)
    assert stats["path"] == "native_mt(1)"


@pytest.mark.parametrize("blocks", [
    # (local ranges, expected crcs of the blocks they meet)
    ([(range(0, 4), range(0, 8), range(0, 8))], [1, 2]),
    ([(range(0, 8), range(2, 6), range(0, 8))], [1, 2, 3, 4]),
    ([(range(0, 0), range(0, 8), range(0, 8))], []),
    ([(range(4, 8), range(0, 4), range(0, 8)),
      (range(0, 4), range(4, 8), range(0, 8))], [2, 3]),
])
def test_local_verify_blocks_intersection(blocks):
    """The pure mapping behind ``verify="local"``."""
    manifest = [
        {"start": [0, 0, 0], "shape": [4, 4, 8], "crc": 1},
        {"start": [0, 4, 0], "shape": [4, 4, 8], "crc": 2},
        {"start": [4, 0, 0], "shape": [4, 4, 8], "crc": 3},
        {"start": [4, 4, 0], "shape": [4, 4, 8], "crc": 4},
    ]
    local, want = blocks
    picked = CheckpointManager._blocks_intersecting(local, 3, manifest)
    assert [b["crc"] for b in picked] == want


# -- drills that kill the process --------------------------------------------

_DRILL = textwrap.dedent("""
    import sys
    import numpy as np
    sys.path.insert(0, {repo!r})
    import pencilarrays_tpu_torch as pat
    from pencilarrays_tpu_torch.resilience import CheckpointManager
    topo = pat.Topology((1, 1), device="cpu")
    pen = pat.Pencil(topo, (11, 13, 10), (1, 2),
                     permutation=pat.Permutation(2, 0, 1))
    u = np.random.default_rng({seed}).standard_normal((11, 13, 10))
    CheckpointManager({directory!r}).save({step},
                                          {{"u": pat.PencilArray.from_global(
                                              pen, u)}})
    print("saved")
""")


def _drill(directory, step, seed, spec=None):
    env = dict(os.environ)
    env.pop(faults.ENV_VAR, None)
    if spec:
        env[faults.ENV_VAR] = spec
    code = _DRILL.format(repo=REPO, seed=seed, directory=str(directory),
                         step=step)
    return subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=60)


def _truth(seed):
    return np.random.default_rng(seed).standard_normal((11, 13, 10))


@pytest.mark.parametrize("spec", ["ckpt.commit:kill", "io.write_block:torn",
                                  "io.flush_meta:kill"])
def test_killed_save_leaves_the_previous_step(tmp_path, spec):
    """A save killed at ``spec`` (SIGKILL: no cleanup runs) leaves
    ``latest_valid()`` on the previous step, and the next save's GC sweeps
    the torn temporary directory."""
    first = _drill(tmp_path, 1, 1)
    assert first.returncode == 0, first.stderr
    killed = _drill(tmp_path, 2, 2, spec)
    assert killed.returncode == -9, killed.stderr
    assert any(e.startswith(".tmp-step-00000002") for e in
               os.listdir(tmp_path))
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.latest_valid() == 1
    topo = pat.Topology((1, 1), device="cpu")
    pen = pat.Pencil(topo, (11, 13, 10), (0, 1))
    np.testing.assert_array_equal(
        pat.gather(mgr.restore().read("u", pen, verify=True)), _truth(1))
    again = _drill(tmp_path, 3, 3)
    assert again.returncode == 0, again.stderr
    assert sorted(os.listdir(tmp_path)) == ["step-00000001", "step-00000003"]


def test_concurrent_publishes_of_one_path(tmp_path):
    """Two threads publishing one path at once (two writers of one KV
    key): each writes a temporary of its own, neither fails, and the
    file holds one of the two values whole."""
    import threading

    from pencilarrays_tpu_torch.resilience.fsutil import atomic_write_text

    path = str(tmp_path / "key")
    errors = []

    def writer(c):
        try:
            for _ in range(300):
                atomic_write_text(path, c * 64)
        except Exception as e:      # noqa: BLE001 - asserted below
            errors.append(e)

    threads = [threading.Thread(target=writer, args=(c,)) for c in "ab"]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors[:2]
    with open(path) as f:
        assert f.read() in ("a" * 64, "b" * 64)
    assert os.listdir(tmp_path) == ["key"]
