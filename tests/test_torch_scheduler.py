"""Port parity: the serving runtime — cluster lanes, straggler shedding,
the replica plane's hooks, ``ServeStats``, ``PIRServeLoop``,
``n_compiles`` and the serving twins — repro_torch vs repro.

The control plane runs over a fake data plane (the "device" doubles each
item) with an injected clock, driven through both packages'
``QueryScheduler`` with the same callables: the lane of every completed
batch, ``reassignments``, every future's outcome, the ``queue_depth``
sequence, the heartbeat count and ``ServeStats`` (``wall_s``, ``qps``,
``pad_fraction``, ``bucket_counts``, the latencies) must be equal. These
are twins of ``tests/test_serving.py:88, 200, 255, 265, 284, 299, 316``.
Then ``PIRServeLoop`` (twin of ``tests/test_system.py:41``) answers keys
from ``pir.batch_queries`` with the reference's shares, ``n_compiles``
(twin of ``tests/test_serving.py:373``) builds no step for a repeated
bucket or across a publish, and the three serving twins (and the replica
plane's) run as ``python -m repro_torch.<name> --device cpu``. Cases marked ``cuda`` serve
the lanes, ``kill`` and a corrupted share's session on the card.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro.config import PIRConfig as RefPIRConfig
from repro.core import pir as ref_pir
from repro.core.server import PIRServer as RefPIRServer
from repro.launch.mesh import make_local_mesh
from repro.runtime import fault as ref_fault
from repro.runtime import serve_loop as ref_serve_loop
from repro_torch.config import PIRConfig
from repro_torch.configs import pir as configs
from repro_torch.core import pir
from repro_torch.core.server import PIRServer
from repro_torch.db import IntegrityError
from repro_torch.runtime import fault, serve_loop
from repro_torch.runtime.serve_loop import PIRServeLoop, TwoServerPIR

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGES = {"port": (serve_loop, fault),
            "reference": (ref_serve_loop, ref_fault)}
SLOW = 100          # items >= SLOW cost 10 s of fake time to finalize


# ---------------------------------------------------------------------------
# The control plane over a fake data plane, both packages
# ---------------------------------------------------------------------------

class Fake:
    """One package's ``QueryScheduler`` over a fake data plane: the device
    doubles each item; every clock read advances the fake clock by 1 ms
    and finalize advances it by each batch's cost; the monitor logs the
    lane of every completed batch and the ``queue_depth`` then."""

    def __init__(self, pkg, *, buckets=(2, 4), n_clusters=1, seed=(),
                 factor=2.0, fail_first=False, hold=None, **kw):
        serve, flt = PACKAGES[pkg]
        self.now = 0.0
        #: a threading.Event every dispatch waits for, when given
        self.hold = hold
        self.done = []              # (lane, items, queue_depth) per batch
        self.beats = 0
        self._finalized = []
        self._fail_first = fail_first
        self.monitor = flt.StragglerMonitor(factor=factor, alpha=0.2)
        for lane, latency in seed:
            self.monitor.record(lane, latency)
        record = self.monitor.record

        def logged(lane, dt):
            items = self._finalized[-1]
            record(lane, dt)
            self.done.append((lane, items, self.sched.queue_depth))

        self.monitor.record = logged
        self.buckets = buckets
        self.sched = serve.QueryScheduler(
            collate=list, stage=self.stage, dispatch=self.dispatch,
            finalize=self.finalize, buckets=buckets, n_clusters=n_clusters,
            monitor=self.monitor, clock=self.clock, heartbeat=self.beat,
            **kw)

    def clock(self):
        self.now += 0.001
        return self.now

    def beat(self):
        self.beats += 1

    def stage(self, payload):
        b = next(bb for bb in sorted(self.buckets) if bb >= len(payload))
        return payload + [payload[-1]] * (b - len(payload))

    def dispatch(self, staged):
        if self.hold is not None:
            self.hold.wait()
        return [x * 2 for x in staged]

    def finalize(self, raw, n):
        items = tuple(x // 2 for x in raw[:n])
        if self._fail_first and not self._finalized:
            self._finalized.append(items)
            raise RuntimeError("poisoned batch")
        self._finalized.append(items)
        self.now += 10.0 if max(items) >= SLOW else 1.0
        return raw[:n]

    def queues(self):
        return {lane: [(tuple(b.items), b.cluster, b.bucket) for b in q]
                for lane, q in self.sched.queues.items()}

    def stats(self):
        s = self.sched.stats
        return dict(answered=s.answered, batches=s.batches, padded=s.padded,
                    reassignments=s.reassignments, latencies=s.latencies,
                    bucket_counts=s.bucket_counts, t_first=s.t_first,
                    t_last=s.t_last, wall_s=s.wall_s, qps=s.qps,
                    pad_fraction=s.pad_fraction)


def outcome(fut, timeout=0.0):
    """A future's outcome as plain data."""
    if timeout == 0.0 and not fut.done():
        return ("pending",)
    try:
        return ("ok", fut.result(timeout=timeout))
    except TimeoutError:
        return ("pending",)
    except Exception as e:          # noqa: BLE001 - the outcome is compared
        return (type(e).__name__, str(e))


def wait_stopped(sched, timeout=30.0):
    deadline = time.monotonic() + timeout
    while sched.running and time.monotonic() < deadline:
        time.sleep(0.005)
    return not sched.running


def scenario_shedding_under_load(pkg):
    """Two lanes; cluster1's history makes it a straggler once its first
    batch completes (of two lanes the median is their mean, so ``factor``
    must be under 2 to flag one); 8 batches of 4 and a tail of 3 pumped:
    that first completion sheds cluster1's queued batches onto cluster0,
    and cluster1's batches cost 10x."""
    f = Fake(pkg, n_clusters=2, factor=1.5,
             seed=[("cluster0", 1.0), ("cluster1", 50.0)])
    items = [i + (SLOW if (i // 4) % 2 else 0) for i in range(32)] + [7, 8, 9]
    depths = []
    futs = []
    for i in items:
        futs.append(f.sched.submit(i))
        depths.append(f.sched.queue_depth)
    queued = f.queues()
    answered = f.sched.pump()
    return dict(queued=queued, answered=answered, done=f.done,
                depths=depths, final_depth=f.sched.queue_depth,
                outcomes=[outcome(x) for x in futs], beats=f.beats,
                stats=f.stats(), ewma=dict(f.monitor.ewma))


def scenario_rebalance_after_flush(pkg):
    """``tests/test_serving.py:88``: cluster0 of three flagged; six batches
    round-robin; a rebalance moves cluster0's two onto the others."""
    f = Fake(pkg, buckets=(2,), n_clusters=3,
             seed=[("cluster0", 50.0), ("cluster1", 1.0), ("cluster2", 1.1)])
    f.monitor.alpha = 1.0
    futs = [f.sched.submit(i) for i in range(12)]
    f.sched.flush()
    before = f.queues()
    moved = f.sched.rebalance()
    after = f.queues()
    return dict(before=before, moved=moved, after=after,
                answered=f.sched.pump(), done=f.done,
                outcomes=[outcome(x) for x in futs], stats=f.stats())


def scenario_no_shedding_onto_idle_stragglers(pkg):
    """``tests/test_serving.py:200`` through the scheduler: five lanes,
    cluster0 (queued work) and cluster4 (idle) flagged: cluster0's batch
    goes to a healthy lane, cluster4 receives nothing."""
    f = Fake(pkg, buckets=(2,), n_clusters=5,
             seed=[("cluster0", 100.0), ("cluster1", 1.0), ("cluster2", 1.0),
                   ("cluster3", 1.0), ("cluster4", 100.0)])
    futs = [f.sched.submit(i) for i in range(8)]
    moved = f.sched.rebalance()
    return dict(moved=moved, after=f.queues(), answered=f.sched.pump(),
                done=f.done, outcomes=[outcome(x) for x in futs],
                stats=f.stats())


def scenario_queue_depth(pkg):
    """``tests/test_serving.py:255``: pending + queued + in flight, pad
    slots excluded, at every step."""
    f = Fake(pkg, buckets=(2, 4), n_clusters=2)
    depths = [f.sched.queue_depth]
    futs = []
    for i in range(11):
        futs.append(f.sched.submit(i))
        depths.append(f.sched.queue_depth)
    f.sched.pump()
    depths.append(f.sched.queue_depth)
    return dict(depths=depths, done=f.done, stats=f.stats(),
                outcomes=[outcome(x) for x in futs], beats=f.beats)


def scenario_drain_handoff(pkg):
    """``tests/test_serving.py:265``: queued and pending pairs come back
    FIFO with their own futures and resolve on another scheduler."""
    src = Fake(pkg, buckets=(2, 4), n_clusters=2)
    futs = [src.sched.submit(i) for i in range(7)]
    pairs = src.sched.drain_handoff()
    try:
        src.sched.submit(99)
        closed = False
    except RuntimeError:
        closed = True
    dst = Fake(pkg, buckets=(2, 4))
    same = [dst.sched.submit(item, future=fut) is fut for item, fut in pairs]
    dst.sched.pump()
    return dict(items=[item for item, _ in pairs],
                handles=[fut is futs[i] for i, (_, fut) in enumerate(pairs)],
                closed=closed, src_pump=src.sched.pump(),
                src_depth=src.sched.queue_depth, same=same,
                outcomes=[outcome(x) for x in futs], done=dst.done)


def scenario_kill_first_wins(pkg):
    """``tests/test_serving.py:284``: kill fails every outstanding future;
    one resolved before it keeps its result."""
    f = Fake(pkg, buckets=(2, 4), n_clusters=2)
    futs = [f.sched.submit(i) for i in range(7)]
    futs[0].set_result("beat the kill")
    f.sched.kill(RuntimeError("replica lost"))
    try:
        f.sched.submit(9)
        closed = False
    except RuntimeError:
        closed = True
    return dict(outcomes=[outcome(x) for x in futs], closed=closed,
                depth=f.sched.queue_depth, pump=f.sched.pump())


def scenario_kill_running_session(pkg):
    """``tests/test_serving.py:299``: a kill aborts a running session and
    every future resolves with the kill's exception. The first bucket's
    dispatch waits until the kill has returned, so that it cannot resolve
    before it, however the threads are scheduled."""
    hold = threading.Event()
    f = Fake(pkg, buckets=(2,), max_wait_s=60.0, hold=hold)
    f.sched.start()
    try:
        futs = [f.sched.submit(i) for i in range(3)]
        f.sched.kill(RuntimeError("injected fault"))
        hold.set()
        outcomes = [outcome(x, timeout=30.0) for x in futs]
        stopped = wait_stopped(f.sched)
    finally:
        hold.set()
        f.sched.stop()
    return dict(outcomes=outcomes, stopped=stopped,
                depth=f.sched.queue_depth)


def scenario_heartbeat(pkg):
    """``tests/test_serving.py:316``: one beat per pump, and the session
    loop beats too."""
    f = Fake(pkg, buckets=(2,))
    f.sched.submit(0), f.sched.submit(1)
    f.sched.pump()
    after_pump = f.beats
    f.sched.start()
    try:
        fut = f.sched.submit(2)
        f.sched.submit(3)
        got = fut.result(timeout=30.0)
    finally:
        f.sched.stop()
    return dict(after_pump=after_pump, loop_beats=f.beats > after_pump,
                got=got)


def scenario_session_death(pkg):
    """``tests/test_serving.py:184``: a failed finalize kills the session,
    every outstanding future fails with it, submit raises until start()
    reopens the session."""
    f = Fake(pkg, buckets=(2,), max_wait_s=0.001, fail_first=True)
    futs = [f.sched.submit(i) for i in range(6)]
    f.sched.start()
    outcomes = [outcome(x, timeout=30.0) for x in futs]
    stopped = wait_stopped(f.sched)
    try:
        f.sched.submit(9)
        closed = False
    except RuntimeError:
        closed = True
    f.sched.start()
    try:
        fresh = f.sched.submit(10).result(timeout=30.0)
    finally:
        f.sched.stop()
    return dict(outcomes=outcomes, stopped=stopped, closed=closed,
                fresh=fresh, depth=f.sched.queue_depth)


SCENARIOS = {f.__name__[len("scenario_"):]: f for f in (
    scenario_shedding_under_load, scenario_rebalance_after_flush,
    scenario_no_shedding_onto_idle_stragglers, scenario_queue_depth,
    scenario_drain_handoff, scenario_kill_first_wins,
    scenario_kill_running_session, scenario_heartbeat,
    scenario_session_death)}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scheduler_scenario_matches_reference(name):
    mine = SCENARIOS[name]("port")
    assert mine == SCENARIOS[name]("reference")
    if name == "shedding_under_load":
        assert mine["stats"]["reassignments"] == 2
        assert [lane for lane, _, _ in mine["done"]][2:] \
            == ["cluster0"] * 7                  # shed off cluster1
        assert mine["depths"][-1] == 35 and mine["final_depth"] == 0
        assert mine["beats"] == 1
        assert mine["stats"]["qps"] == 35 / mine["stats"]["wall_s"]
    if name == "no_shedding_onto_idle_stragglers":
        assert mine["moved"] == 1 and mine["after"]["cluster4"] == []
    if name == "drain_handoff":
        assert mine["items"] == list(range(7)) and all(mine["handles"])
    if name == "session_death":
        assert mine["outcomes"] == [("RuntimeError", "poisoned batch")] * 6


def test_pump_failure_fails_launched_batches_unlike_the_reference():
    """A failed finalize in ``pump``: the batch launched behind it fails
    with the same exception in the port; the reference leaves it
    unresolved (a stated deviation). The batch not launched stays queued
    in both and the next pump answers it."""
    def run(pkg):
        f = Fake(pkg, buckets=(2,), fail_first=True)
        futs = [f.sched.submit(i) for i in range(6)]
        try:
            f.sched.pump()
            raised = None
        except RuntimeError as e:
            raised = str(e)
        first = [outcome(x) for x in futs]
        depth = f.sched.queue_depth
        f.sched.pump()
        return raised, first, depth, [outcome(x) for x in futs]

    raised, first, depth, last = run("port")
    r_raised, r_first, r_depth, r_last = run("reference")
    assert raised == r_raised == "poisoned batch"
    assert first[:2] == r_first[:2] == [("RuntimeError", "poisoned batch")] * 2
    assert first[2:4] == [("RuntimeError", "poisoned batch")] * 2
    assert r_first[2:4] == [("pending",)] * 2          # the reference's hang
    assert first[4:] == r_first[4:] == [("pending",)] * 2
    assert depth == 2 and r_depth == 4                 # its in-flight count
    assert last[4:] == r_last[4:] == [("ok", 8), ("ok", 10)]


def test_serve_stats_window_and_fractions_match_reference():
    """``qps`` is answered over the serving window, not over the latency
    sum; both packages agree on overlapping windows."""
    def run(mod):
        s = mod.ServeStats()
        for t0, t1, n, pad in ((0.0, 2.0, 4, 0), (1.0, 2.5, 3, 1),
                               (2.4, 3.0, 1, 1)):
            s.observe_window(t0, t1)
            s.latencies.append(t1 - t0)
            s.answered += n
            s.padded += pad
        return s.wall_s, s.qps, s.pad_fraction, s.t_first, s.t_last
    assert run(serve_loop) == run(ref_serve_loop) == (3.0, 8 / 3.0, 0.2, 0.0,
                                                      3.0)
    empty = serve_loop.ServeStats()
    assert (empty.wall_s, empty.qps, empty.pad_fraction) == (0.0, 0.0, 0.0)


# ---------------------------------------------------------------------------
# PIRServeLoop, batch_queries, n_compiles: the data plane on the CPU
# ---------------------------------------------------------------------------

def _u32(t):
    return t.numpy().view(np.uint32)


def test_serve_loop_answers_match_reference():
    """``tests/test_system.py:41``'s loop, ``n_clusters=2``: keys from
    ``pir.batch_queries`` equal the reference's, each batch's answer
    shares equal the reference's exactly, and ``drain_pipelined`` gives
    ``drain``'s answers (the batch of 3 drops its pad slot)."""
    n = 1 << 10
    db = pir.make_database(np.random.default_rng(1), n, 32)
    cfg = PIRConfig(n_items=n, batch_queries=4)
    ref_cfg = RefPIRConfig(n_items=n, batch_queries=4)
    ref_server = RefPIRServer(party=0, db_words=db, cfg=ref_cfg,
                              mesh=make_local_mesh(), n_queries=4,
                              path="baseline")
    server = PIRServer(0, db, cfg, device="cpu", n_queries=4)
    batches = [[s, s + 1, s + 2, s + 3] for s in range(3)] + [[9, 700, 1023]]
    rng, ref_rng = np.random.default_rng(2), np.random.default_rng(2)
    keys, ref_keys = [], []
    for idx in batches:
        k0, k1 = pir.batch_queries(rng, idx, cfg)
        r0, r1 = ref_pir.batch_queries(ref_rng, idx, ref_cfg)
        for got, want in ((k0, r0), (k1, r1)):
            assert (got.party, got.log_n, got.rounds) \
                == (want.party, want.log_n, want.rounds)
            for name in ("root_seed", "cw_seed", "cw_t"):
                np.testing.assert_array_equal(_u32(getattr(got, name)),
                                              np.asarray(getattr(want, name)))
        keys.append(k0)
        ref_keys.append(r0)

    ref_loop = ref_serve_loop.PIRServeLoop(ref_server, n_clusters=2)
    loop = PIRServeLoop(server, n_clusters=2)
    for k, r in zip(keys, ref_keys):
        loop.submit(k)
        ref_loop.submit(r)
    answers, ref_answers = loop.drain(), ref_loop.drain()
    assert len(answers) == len(ref_answers) == 4
    for got, want in zip(answers, ref_answers):
        np.testing.assert_array_equal(_u32(got), np.asarray(want))
    assert loop.stats.answered == ref_loop.stats.answered == 15
    assert loop.stats.batches == 4 and loop.stats.qps > 0
    assert sorted(loop.straggler.ewma) == sorted(ref_loop.straggler.ewma) \
        == ["cluster0", "cluster1"]

    for k, r in zip(keys, ref_keys):
        loop.submit(k)
        ref_loop.submit(r)
    piped, ref_piped = loop.drain_pipelined(), ref_loop.drain_pipelined()
    for got, want, serial in zip(piped, ref_piped, answers):
        assert torch.equal(got, serial)
        np.testing.assert_array_equal(_u32(got), np.asarray(want))
    assert [a.shape[0] for a in piped] == [4, 4, 4, 3]
    assert loop.stats.answered == 30 and loop.stats.batches == 8
    assert len(loop.stats.latencies) == 8 and loop.stats.wall_s > 0


def test_batch_queries_k3_match_reference():
    """``xor-dpf-k``: one stacked batch per party, three parties, the
    reference's keys from the same rng."""
    cfg = configs.PIR_SMOKE_K3
    ref_cfg = RefPIRConfig(**dataclasses.asdict(cfg))
    got = pir.batch_queries(np.random.default_rng(5), [1, 2, 4095], cfg)
    want = ref_pir.batch_queries(np.random.default_rng(5), [1, 2, 4095],
                                 ref_cfg)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for name in ("root_seed", "cw_seed", "cw_t"):
            np.testing.assert_array_equal(_u32(getattr(g, name)),
                                          np.asarray(getattr(w, name)))


def test_no_new_step_for_repeated_sizes_or_across_a_publish():
    """``tests/test_serving.py:373``: every ragged size maps onto a built
    bucket step, none is built again, and a publish builds none either;
    the reference's jit-cache misses follow the same sequence."""
    n = 1 << 8
    db = pir.make_database(np.random.default_rng(0), n, 32)
    cfg = PIRConfig(n_items=n, item_bytes=32, batch_queries=4)
    system = TwoServerPIR(db, cfg, device="cpu", n_queries=4, buckets=(2, 4),
                          client_rng=np.random.default_rng(1))
    ref = ref_serve_loop.TwoServerPIR(
        db, RefPIRConfig(**dataclasses.asdict(cfg)), make_local_mesh(),
        path="fused", n_queries=4, buckets=(2, 4),
        client_rng=np.random.default_rng(1))
    counts, ref_counts = [], []
    for idx in ([5], [7], [8, 9, 10], [1, 2], [4, 5, 6, 7], [250]):
        np.testing.assert_array_equal(system.query(idx), db[idx])
        np.testing.assert_array_equal(ref.query(idx), db[idx])
        counts.append([s.n_compiles for s in system.servers])
        ref_counts.append([s.n_compiles for s in ref.servers])
    assert counts == ref_counts
    assert counts[-1] == [2, 2]                        # two buckets, two steps
    row = np.arange(8, dtype=np.uint32)[None] * 3
    system.update([9], row)
    assert system.publish() == 1
    assert [s.db_epoch for s in system.servers] == [1, 1]
    np.testing.assert_array_equal(system.query([9, 10]),
                                  np.concatenate([row, db[[10]]]))
    assert [s.n_compiles for s in system.servers] == [2, 2]
    assert system.servers[0].plan_report() and system.servers[0].n_compiles == 2


# ---------------------------------------------------------------------------
# Facades with lanes, and the twins
# ---------------------------------------------------------------------------

def _lanes_session(device, n_clusters, n_queries=64, clients=4):
    cfg = PIRConfig(n_items=1 << 12, item_bytes=32)
    db = pir.make_database(np.random.default_rng(31), cfg.n_items, 32)
    system = TwoServerPIR(db, cfg, device=device, n_queries=4,
                          n_clusters=n_clusters,
                          client_rng=np.random.default_rng(32))
    out, idx = {}, np.random.default_rng(33).integers(0, cfg.n_items,
                                                      n_queries)

    def client(c):
        futs = [(i, system.submit(int(idx[i])))
                for i in range(c, n_queries, clients)]
        for i, f in futs:
            out[i] = f.result(timeout=300)

    with system:
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    np.testing.assert_array_equal(np.stack([out[i] for i in range(n_queries)]),
                                  db[idx])
    return system


@pytest.mark.parametrize("n_clusters", [1, 2, 3])
def test_lanes_serve_concurrent_clients_exactly(n_clusters):
    system = _lanes_session("cpu", n_clusters)
    stats = system.scheduler.stats
    assert system.scheduler.queue_depth == 0
    assert stats.answered == 64 and 0.0 <= stats.pad_fraction < 1.0
    assert sum(stats.bucket_counts.values()) == stats.batches
    assert set(system.scheduler.queues) == {f"cluster{i}"
                                            for i in range(n_clusters)}


def _twin_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


@pytest.mark.parametrize("name", ["multi_server", "single_server",
                                  "serving_session", "replicas"])
def test_serving_twin_runs_on_cpu(name):
    out = subprocess.run(
        [sys.executable, "-m", f"repro_torch.{name}", "--device", "cpu"],
        capture_output=True, text=True, env=_twin_env(), cwd=ROOT,
        timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "verified" in out.stdout


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the card; "
                    "chip_smoke.py's serve_runtime serves the same paths "
                    "at PIR_1G)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_clusters", [1, 2])
def test_lanes_on_the_card(card, n_clusters):
    system = _lanes_session(card, n_clusters)
    assert system.scheduler.queue_depth == 0
    assert system.scheduler.stats.answered == 64


@pytest.mark.cuda
def test_kill_under_load_on_the_card(card):
    """Every future resolves, exactly or with the kill's exception."""
    cfg = PIRConfig(n_items=1 << 12, item_bytes=32)
    db = pir.make_database(np.random.default_rng(41), cfg.n_items, 32)
    system = TwoServerPIR(db, cfg, device=card, n_queries=4, n_clusters=2,
                          client_rng=np.random.default_rng(42))
    idx = np.random.default_rng(43).integers(0, cfg.n_items, 32)
    first = threading.Event()
    system.start()
    futs = [system.submit(int(i)) for i in idx]
    futs[0].add_done_callback(lambda f: first.set())
    assert first.wait(timeout=300)
    system.scheduler.kill(RuntimeError("killed under load"))
    ok = 0
    for i, f in zip(idx, futs):
        try:
            np.testing.assert_array_equal(f.result(timeout=60), db[i])
            ok += 1
        except RuntimeError as e:
            assert str(e) == "killed under load"
    assert ok >= 1
    assert wait_stopped(system.scheduler)
    assert system.scheduler.queue_depth == 0
    with pytest.raises(RuntimeError, match="stop"):
        system.submit(1)


@pytest.mark.cuda
def test_corrupted_share_kills_the_session_on_the_card(card):
    cfg = dataclasses.replace(configs.PIR_SMOKE, checksum=True)
    db = pir.make_database(np.random.default_rng(51), cfg.n_items, 32)
    system = TwoServerPIR(db, cfg, device=card, n_queries=4,
                          client_rng=np.random.default_rng(52))
    sched, orig = system.scheduler, system.scheduler._dispatch
    calls = []

    def corrupt(staged):
        answers, epoch = orig(staged)
        calls.append(1)
        if len(calls) == 1:
            a = answers[1].clone()
            a[1, 3] ^= 0x5A
            answers = (answers[0], a)
        return answers, epoch

    sched._dispatch = corrupt
    futs = [system.submit(i) for i in range(6)]
    system.start()
    errors = []
    for f in futs:
        with pytest.raises(IntegrityError) as e:
            f.result(timeout=300)
        errors.append(e.value)
    assert all(e is errors[0] for e in errors)
    assert errors[0].bad_queries == (1,)
    assert wait_stopped(sched)
    sched._dispatch = orig
    system.start()
    try:
        np.testing.assert_array_equal(system.query([3, 4, 5]), db[[3, 4, 5]])
    finally:
        system.close()
