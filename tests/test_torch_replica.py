"""Port parity: the replica plane — ``Router``, ``ReplicaRegistry``,
``ServeReplica``, fleet metrics, ``split_devices`` and the elastic
sub-meshes of one process — repro_torch vs repro.

The control plane runs over a fake replica (the ``ServeReplica`` surface,
no data plane), built for each package from its own ``AnswerFuture``,
``ServeStats`` and ``ReplicaLost``: every scenario of
``tests/test_replica.py:155-430`` and the router cases of
``tests/test_chaos.py:304-413`` (deadline reap, hedge, expire, integrity
quarantine) runs through both packages' routers with the same seeded
``rng``, injected ``clock`` and ``sleep``, and must give the same route
per query, the same counters and the same ``metrics.snapshot``. Then
``split_devices`` / ``plan_mesh`` against the reference's, ``plan_report``'s
rows against the reference's keys, a real ``xor-dpf-2`` fleet on the CPU
(publish, kill under load, warm rejoin, graceful leave) whose records are
byte-equal to the reference's database with the update applied, the
port's twin of the reference's slow LWE fleet test, and the scheduler's
futures resolving outside its lock (the router's callbacks resubmit from
there). A case marked ``cuda`` serves a fleet on the card.
"""
import json
import threading
import types

import numpy as np
import pytest
import torch
from test_replica import FakeDB

from repro import replica as ref_replica
from repro.config import PIRConfig as RefPIRConfig
from repro.core import pir as ref_pir
from repro.core import protocol as ref_protocol
from repro.db import spec as ref_spec
from repro.engine import plan_report as ref_plan_report
from repro.launch import mesh as ref_mesh
from repro.runtime import elastic as ref_elastic
from repro.runtime import serve_loop as ref_serve_loop
from repro_torch import engine
from repro_torch import replica
from repro_torch.config import PIRConfig
from repro_torch.configs.pir import PIR_SMOKE
from repro_torch.core import pir
from repro_torch.crypto.packing import np_words_to_bytes
from repro_torch.db import spec
from repro_torch.engine import cache as cache_mod
from repro_torch.launch import mesh
from repro_torch.runtime import elastic, serve_loop
from repro_torch.runtime.serve_loop import QueryScheduler


def _api(rep, serve, spec_mod):
    return types.SimpleNamespace(
        Router=rep.Router, ReplicaRegistry=rep.ReplicaRegistry,
        ReplicaLost=rep.ReplicaLost, metrics=rep.metrics,
        AnswerFuture=serve.AnswerFuture, ServeStats=serve.ServeStats,
        QueryTimeout=serve.QueryTimeout,
        IntegrityError=spec_mod.IntegrityError)


PACKAGES = {"port": _api(replica, serve_loop, spec),
            "reference": _api(ref_replica, ref_serve_loop, ref_spec)}


# ---------------------------------------------------------------------------
# The fake replica, one per package
# ---------------------------------------------------------------------------

def fake_replica_class(api):
    """The reference test's ``FakeReplica`` over ``api``'s future, stats
    and ``ReplicaLost``: queries queue until ``pump()`` resolves them to
    ``("ans", item, replica_id)`` tagged with the DB epoch."""

    class FakeReplica:
        def __init__(self, rid):
            self.id = rid
            self.db = FakeDB()
            self.stats = api.ServeStats()
            self._q = []             # (item, future)
            self._closed = False
            self.running = False
            self.lost = False
            self.started = 0
            self.warmed = None

        @property
        def epoch(self):
            return self.db.epoch

        @property
        def queue_depth(self):
            return len(self._q)

        def submit(self, index):
            fut = api.AnswerFuture()
            self.resubmit(index, fut)
            return fut

        def resubmit(self, item, future):
            if self._closed:
                raise RuntimeError("scheduler is stopped")
            self._q.append((item, future))
            return future

        def pump(self):
            q, self._q = self._q, []
            for item, fut in q:
                fut.epoch = self.db.epoch
                fut.set_result(("ans", item, self.id))
                self.stats.answered += 1
            return len(q)

        def start(self):
            self._closed = False
            self.lost = False
            self.running = True
            self.started += 1

        def close(self):
            self._closed = True
            self.running = False

        def drain_handoff(self):
            self._closed = True
            self.running = False
            q, self._q = self._q, []
            return q

        def kill(self, reason="injected fault"):
            exc = api.ReplicaLost(self.id, reason)
            self._closed = True
            self.running = False
            self.lost = True
            victims, self._q = self._q, []
            for _, fut in victims:
                fut.set_exception(exc)
            return exc

        def set_heartbeat(self, fn):
            self.heartbeat = fn

        def subscribe_epochs(self, fn):
            return self.db.subscribe(lambda d: fn(d.epoch))

        def export_plans(self):
            return {4: "fake-plan"}

        def warm_start(self, plans, persist=False):
            self.warmed = dict(plans)
            return len(plans)

    class IntegrityFakeReplica(FakeReplica):
        """pump() fails every queued future with IntegrityError — the
        shape a corrupted answer surfaces in after verified
        reconstruction."""

        def pump(self):
            q, self._q = self._q, []
            for _item, fut in q:
                fut.set_exception(api.IntegrityError(
                    "checksum mismatch on 1/1 reconstructed record(s)",
                    bad_queries=(0,)))
            return len(q)

    return FakeReplica, IntegrityFakeReplica


def make_router(api, n=2, **kw):
    kw.setdefault("rng", np.random.default_rng(0))
    kw.setdefault("sleep", lambda s: None)
    router = api.Router(**kw)
    fake = fake_replica_class(api)[0]
    reps = [router.attach(fake(f"r{i}")) for i in range(n)]
    return router, reps


def outcome(fut):
    """A query's route: the answer (item, serving replica) and epoch tag,
    the exception's type, or pending."""
    if not fut.done():
        return "pending"
    exc = fut.exception()
    if exc is not None:
        return type(exc).__name__
    return (fut.result(0), fut.epoch)


def trace(api, router, futs=()):
    """Everything the two packages must agree on after a scenario."""
    return {"routes": [outcome(f) for f in futs],
            "counters": {k: getattr(router, k) for k in (
                "failovers", "resubmitted", "hedges", "deadline_expired",
                "integrity_failures")},
            "retry": vars(router.retry_stats).copy(),
            "epochs": dict(router.epochs),
            "sessions": {s.id: (s.replica, s.min_epoch)
                         for s in router.sessions.values()},
            "snapshot": api.metrics.snapshot(router)}


def _delta(i):
    return [i], np.full((1, 8), i, np.uint32)


SCENARIOS = {}


def scenario(fn):
    SCENARIOS[fn.__name__] = fn
    return fn


# -- routing: P2C + affinity (tests/test_replica.py:155-210) ----------------

@scenario
def round_trip_and_epoch_tag(api, tmp):
    router, (r0, r1) = make_router(api)
    futs = [router.submit(i) for i in range(8)]
    assert r0.queue_depth + r1.queue_depth == 8
    r0.pump(), r1.pump()
    for i, f in enumerate(futs):
        ans, item, rid = f.result(0)
        assert (ans, item) == ("ans", i) and rid in ("r0", "r1")
        assert f.epoch == 0
    return trace(api, router, futs)


@scenario
def p2c_always_picks_the_shallower_of_two(api, tmp):
    router, (r0, r1) = make_router(api)
    r0.resubmit("preload", api.AnswerFuture())       # depths (1, 0)
    futs = [router.submit(i) for i in range(6)]
    assert (r0.queue_depth, r1.queue_depth) == (4, 3)
    r0.pump(), r1.pump()
    assert all(f.done() for f in futs)
    return trace(api, router, futs)


@scenario
def p2c_tie_breaks_deterministically(api, tmp):
    out = []
    for seed in (0, 1, 12345):
        router, (r0, r1) = make_router(api, rng=np.random.default_rng(seed))
        assert r0.queue_depth == r1.queue_depth == 0
        router.submit(0)
        assert (r0.queue_depth, r1.queue_depth) == (1, 0)
        out.append(trace(api, router))
    return out


@scenario
def session_affinity_sticks_while_eligible(api, tmp):
    router, (r0, r1) = make_router(api)
    s = router.session("client-a")
    futs = [router.submit(0, session=s)]
    first = s.replica
    assert first in ("r0", "r1")
    pinned = router.replicas[first]
    for _ in range(5):
        pinned.resubmit("preload", api.AnswerFuture())
    futs.append(router.submit(1, session=s))
    assert s.replica == first
    router.registry.report_failure(first)
    futs.append(router.submit(2, session=s))
    assert s.replica == ({"r0", "r1"} - {first}).pop()
    r0.pump(), r1.pump()
    return trace(api, router, futs)


# -- failover: no lost query (tests/test_replica.py:217-295) ----------------

@scenario
def kill_fails_over_every_queued_query(api, tmp):
    router, (r0, r1) = make_router(api)
    s = router.session("pinned")
    s.replica = "r0"
    futs = [router.submit(i, session=s) for i in range(5)]
    assert r0.queue_depth == 5
    r0.kill()
    assert "r0" in router.registry.suspects()
    assert r1.queue_depth == 5
    r1.pump()
    for i, f in enumerate(futs):
        assert f.result(0) == ("ans", i, "r1")
    assert router.failovers == 5 and router.retry_stats.retried == 5
    return trace(api, router, futs)


@scenario
def failover_exhaustion_propagates_last_error(api, tmp):
    router, (r0,) = make_router(api, n=1, retries=2)
    fut = router.submit(7)
    r0.kill()
    assert fut.done()
    with pytest.raises(RuntimeError):
        fut.result(0)
    assert router.retry_stats.retried >= 1
    return trace(api, router, [fut])


@scenario
def submit_with_no_replicas_resolves_with_error(api, tmp):
    router = api.Router(sleep=lambda s: None, retries=1)
    fut = router.submit(0)
    assert fut.done()
    with pytest.raises(RuntimeError, match="no eligible replica"):
        fut.result(0)
    return trace(api, router, [fut])


@scenario
def backoff_is_capped(api, tmp):
    sleeps = []
    router, (r0,) = make_router(api, n=1, retries=6, base_delay=1.0,
                                max_delay=4.0, sleep=sleeps.append)
    r0.kill()
    fut = router.submit(0)
    assert sleeps == [1.0, 2.0, 4.0, 4.0, 4.0, 4.0]
    return {"sleeps": sleeps, **trace(api, router, [fut])}


@scenario
def jittered_backoff_over_three_replicas(api, tmp):
    """Not in the reference's suite: P2C over three replicas (two rng
    draws per route) and seeded backoff jitter (one draw per retry) must
    consume the router's rng in the same order."""
    sleeps = []
    router, reps = make_router(api, n=3, retries=4, base_delay=0.5,
                               max_delay=3.0, jitter=0.5,
                               sleep=sleeps.append,
                               rng=np.random.default_rng(7))
    futs = [router.submit(i) for i in range(24)]
    reps[1].kill()
    reps[0].kill()
    reps[2].pump()
    return {"sleeps": sleeps, **trace(api, router, futs)}


@scenario
def graceful_detach_hands_off_futures_unchanged(api, tmp):
    router, (r0, r1) = make_router(api)
    s = router.session("pinned")
    s.replica = "r0"
    futs = [router.submit(i, session=s) for i in range(4)]
    assert router.detach("r0") == 4
    assert router.resubmitted == 4
    assert "r0" not in router.replicas
    assert "r0" not in router.registry.members()
    assert r1.queue_depth == 4
    r1.pump()
    assert [f.result(0) for f in futs] == [("ans", i, "r1") for i in range(4)]
    assert router.failovers == 0
    return trace(api, router, futs)


# -- epochs (tests/test_replica.py:302-385) ---------------------------------

@scenario
def publish_fans_out_and_tracks_epochs(api, tmp):
    router, (r0, r1) = make_router(api)
    router.update(*_delta(1))
    assert router.publish() == 1
    assert (r0.epoch, r1.epoch) == (1, 1)
    assert router.epochs == {"r0": 1, "r1": 1}
    assert router.publish() == 1
    assert router.epoch_lag("r0") == 0
    return trace(api, router)


@scenario
def suspect_replica_skips_then_catches_up_in_order(api, tmp):
    router, (r0, r1) = make_router(api)
    router.update(*_delta(1))
    router.publish()
    router.registry.report_failure("r1")
    router.update(*_delta(2))
    router.update(*_delta(3))
    assert router.publish() == 2
    assert (r0.epoch, r1.epoch) == (2, 1)
    assert router.epoch_lag("r1") == 1
    router.registry.join(r1)
    router.update(*_delta(4))
    assert router.publish() == 3
    assert (r0.epoch, r1.epoch) == (3, 3)
    applied = [r.tolist() for r, _ in r1.db.applied]
    assert applied == [[1], [2], [3], [4]]
    return {"applied": applied, **trace(api, router)}


@scenario
def attach_replays_delta_log_for_late_joiner(api, tmp):
    router, (r0,) = make_router(api, n=1)
    for i in range(3):
        router.update(*_delta(i))
        router.publish()
    late = fake_replica_class(api)[0]("late")
    router.attach(late)
    assert late.epoch == 3 and late.running
    applied = [r.tolist() for r, _ in late.db.applied]
    assert applied == [[0], [1], [2]]
    return {"applied": applied, **trace(api, router)}


@scenario
def staleness_bound_excludes_laggards(api, tmp):
    router, (r0, r1) = make_router(api, staleness_bound=0)
    router.registry.report_failure("r1")
    router.update(*_delta(1))
    router.publish()
    router.registry.join(r1)
    assert router._eligible(0) == ["r0"]
    fut = router.submit(5)
    assert r0.queue_depth == 1 and r1.queue_depth == 0
    r0.pump()
    assert fut.result(0)[2] == "r0"
    return trace(api, router, [fut])


@scenario
def session_min_epoch_gives_monotonic_reads(api, tmp):
    router, (r0, r1) = make_router(api)
    router.registry.report_failure("r1")
    router.update(*_delta(1))
    router.publish()
    router.registry.join(r1)
    s = router.session("reader")
    futs = [router.submit(3, session=s)]
    assert s.replica == "r0"
    r0.pump()
    assert futs[0].result(0)[2] == "r0" and futs[0].epoch == 1
    assert s.min_epoch == 1
    futs += [router.submit(4, session=s) for _ in range(8)]
    assert r1.queue_depth == 0
    router.update(*_delta(2))
    router.publish()
    s2 = router.session("reader", min_epoch=2)
    assert s2 is s and s.min_epoch == 2
    assert sorted(router._eligible(2)) == ["r0", "r1"]
    r0.pump()
    return trace(api, router, futs)


@scenario
def attach_warm_from_peer_records_plans(api, tmp):
    router, (r0,) = make_router(api, n=1)
    fake = fake_replica_class(api)[0]
    joiner = fake("j")
    router.attach(joiner, warm_from=r0)
    assert joiner.warmed == {4: "fake-plan"}
    router.attach(fake("k"), warm_from={2: "p"})
    assert router.replicas["k"].warmed == {2: "p"}
    return trace(api, router)


# -- registry + metrics (tests/test_replica.py:392-430) ---------------------

@scenario
def registry_silence_and_failure_are_independent_signals(api, tmp):
    t = [0.0]
    reg = api.ReplicaRegistry(timeout=10.0, clock=lambda: t[0])
    fake = fake_replica_class(api)[0]
    a, b = fake("a"), fake("b")
    reg.join(a), reg.join(b)
    seen = [reg.suspects()]
    t[0] = 11.0
    reg.beat("b")
    seen.append(reg.suspects())
    reg.report_failure("b")
    seen.append(reg.suspects())
    reg.join(b)
    seen.append(reg.suspects())
    assert seen == [[], ["a"], ["a", "b"], ["a"]]
    return {"suspects": seen, "healthy": reg.healthy()}


@scenario
def registry_leave_is_not_failure_and_drops_late_beats(api, tmp):
    reg = api.ReplicaRegistry(timeout=10.0, clock=lambda: 0.0)
    a = fake_replica_class(api)[0]("a")
    reg.join(a)
    assert reg.leave("a") is True
    assert "a" not in reg and reg.suspects() == []
    a.heartbeat()
    assert reg.members() == []
    assert reg.leave("a") is False
    reg.report_failure("a")
    assert reg.suspects() == []
    return {"members": reg.members(), "suspects": reg.suspects()}


@scenario
def metrics_snapshot_and_export(api, tmp):
    router, (r0, r1) = make_router(api)
    s = router.session("pinned")
    s.replica = "r0"
    futs = [router.submit(i, session=s) for i in range(3)]
    router.update(*_delta(1))
    router.publish()
    r0.kill()
    r1.pump()
    assert all(f.done() for f in futs)
    snap = api.metrics.snapshot(router)
    rows = {r["id"]: r for r in snap["replicas"]}
    assert rows["r0"]["state"] == "lost"
    assert rows["r1"]["state"] == "healthy"
    assert rows["r1"]["answered"] == 3
    assert snap["router"]["failovers"] == 3
    assert snap["router"]["published_epoch"] == 1
    assert snap["router"]["retry"]["attempts"] >= 6
    path = api.metrics.export_json(router, str(tmp / "m" / "fleet.json"))
    with open(path) as f:
        exported = json.load(f)
    assert exported["router"]["failovers"] == 3
    return {"exported": exported, **trace(api, router, futs)}


# -- deadlines + integrity (tests/test_chaos.py:333-413) --------------------

@scenario
def reap_hedges_at_half_budget_then_first_answer_wins(api, tmp):
    t = [0.0]
    router, (r0, r1) = make_router(api, clock=lambda: t[0])
    s = router.session("dl")
    s.replica = "r0"
    fut = router.submit(5, session=s, deadline_s=10.0)
    sweeps = [router.reap()]
    assert (r0.queue_depth, r1.queue_depth) == (1, 0)
    t[0] = 5.0
    sweeps.append(router.reap())
    assert r1.queue_depth == 1 and router.hedges == 1
    sweeps.append(router.reap())
    r1.pump()
    assert fut.result(0) == ("ans", 5, "r1")
    r0.pump()
    assert fut.result(0) == ("ans", 5, "r1")
    sweeps.append(router.reap())
    assert sweeps == [{"expired": 0, "hedged": 0}, {"expired": 0, "hedged": 1},
                      {"expired": 0, "hedged": 0}, {"expired": 0, "hedged": 0}]
    assert router._pending_q == {}
    return {"sweeps": sweeps, **trace(api, router, [fut])}


@scenario
def reap_expires_past_deadline_with_query_context(api, tmp):
    t = [0.0]
    router, (r0, r1) = make_router(api, clock=lambda: t[0])
    s = router.session("sess-42")
    s.replica = "r0"
    fut = router.submit(9, session=s, deadline_s=4.0)
    t[0] = 4.5
    out = router.reap()
    assert out["expired"] == 1 and router.deadline_expired == 1
    with pytest.raises(api.QueryTimeout) as ei:
        fut.result(0)
    msg = str(ei.value)
    assert "session=sess-42" in msg and "deadline_over_by" in msg
    assert router._pending_q == {}
    return {"sweep": out, **trace(api, router, [fut])}


@scenario
def submit_without_deadline_stays_out_of_the_pending_table(api, tmp):
    router, (r0, r1) = make_router(api)
    fut = router.submit(1)
    assert router._pending_q == {}
    assert router.reap() == {"expired": 0, "hedged": 0}
    return trace(api, router, [fut])


@scenario
def integrity_error_quarantines_and_resubmits(api, tmp):
    fake, integrity_fake = fake_replica_class(api)
    router = api.Router(rng=np.random.default_rng(0), sleep=lambda s: None)
    bad = router.attach(integrity_fake("bad"))
    good = router.attach(fake("good"))
    s = router.session("c")
    s.replica = "bad"
    futs = [router.submit(i, session=s) for i in range(3)]
    bad.pump()
    assert "bad" in router.registry.suspects()
    assert router.integrity_failures == 3
    assert good.queue_depth == 3
    good.pump()
    assert [f.result(0) for f in futs] == [("ans", i, "good")
                                           for i in range(3)]
    return trace(api, router, futs)


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_control_plane_matches_the_reference(name, tmp_path):
    """Each scenario's own checks hold in both packages, and both routers
    route every query alike and end with the same counters and
    ``metrics.snapshot``."""
    got = {pkg: SCENARIOS[name](api, tmp_path / pkg)
           for pkg, api in PACKAGES.items()}
    assert got["port"] == got["reference"]


# ---------------------------------------------------------------------------
# split_devices, plan_mesh, device groups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_devices", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("min_per_group", [1, 2, 4])
def test_split_devices_matches_the_reference(n_devices, min_per_group):
    devices = [f"dev{i}" for i in range(n_devices)]
    for n_groups in (1, 2, 3, 4):
        assert mesh.split_devices(n_groups, devices,
                                  min_per_group=min_per_group) == \
            ref_mesh.split_devices(n_groups, devices,
                                   min_per_group=min_per_group)
    for bad in (0, -1):
        with pytest.raises(ValueError):
            mesh.split_devices(bad, devices)
        with pytest.raises(ValueError):
            ref_mesh.split_devices(bad, devices)


@pytest.mark.parametrize("model_axis", [1, 2, 4])
def test_plan_mesh_matches_the_reference(model_axis):
    for n in range(1, 17):
        for pods in (1, 2):
            if n < model_axis:
                with pytest.raises(ValueError):
                    elastic.plan_mesh(n, model_axis=model_axis,
                                      prefer_pods=pods)
                with pytest.raises(ValueError):
                    ref_elastic.plan_mesh(n, model_axis=model_axis,
                                          prefer_pods=pods)
                continue
            got = elastic.plan_mesh(n, model_axis=model_axis,
                                    prefer_pods=pods)
            want = ref_elastic.plan_mesh(n, model_axis=model_axis,
                                         prefer_pods=pods)
            assert got.to_dict() == want.to_dict()
            assert got.n_devices == want.n_devices


@pytest.mark.parametrize("n_cards", [1, 2, 4, 8])
def test_carve_submeshes_groups_devices_as_the_reference_splits(n_cards):
    # one process: each sub-mesh is this rank's (1, 1) mesh on the first
    # card of the reference's group, in the reference's axes
    cards = [f"cuda:{i}" for i in range(n_cards)]
    for n_replicas in (1, 2, 4):
        for model_axis in (1, 2):
            for pods in (1, 2):
                if n_cards < model_axis:   # the reference's plan_mesh raises
                    with pytest.raises(ValueError):
                        elastic.carve_submeshes(
                            n_replicas, model_axis=model_axis,
                            live_devices=cards, prefer_pods=pods)
                    continue
                got = elastic.carve_submeshes(
                    n_replicas, model_axis=model_axis, live_devices=cards,
                    prefer_pods=pods)
                groups = ref_mesh.split_devices(n_replicas, cards,
                                                min_per_group=model_axis)
                assert len(got) == len(groups)
                for m, g in zip(got, groups):
                    plan = ref_elastic.plan_mesh(len(g), model_axis=model_axis,
                                                 prefer_pods=pods)
                    assert isinstance(m, mesh.Mesh)
                    assert m.device == torch.device(g[0])
                    assert m.axis_names == tuple(plan.axes)
                    assert m.sizes == (1,) * len(plan.axes)
                    assert (m.ranks, m.fleet, m.multi_process) == ((0,), None,
                                                                   False)
    got = elastic.carve_submeshes(2, model_axis=1, live_devices=["cpu"])
    assert got == [mesh.single_mesh("cpu")] * 2
    assert [m.device for m in got] == [torch.device("cpu")] * 2
    assert elastic.rebuild_mesh(["cpu"], model_axis=1) == \
        mesh.single_mesh("cpu")


def test_device_groups_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: mesh.split_devices(2),
                 lambda: elastic.carve_submeshes(2, model_axis=1),
                 lambda: elastic.rebuild_mesh(model_axis=1),
                 lambda: replica.ServeReplica("r", np.zeros((4, 8), np.uint32),
                                              PIRConfig(n_items=4), None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_reshard_moves_every_tensor_of_a_tree():
    tree = {"a": torch.arange(3), "b": [np.arange(2, dtype=np.uint32),
                                        (torch.ones(1), "tag")], "c": 5}
    out = elastic.reshard(tree, "cpu")
    assert torch.equal(out["a"], tree["a"]) and out["c"] == 5
    assert isinstance(out["b"][0], torch.Tensor)
    assert out["b"][0].tolist() == [0, 1]
    assert isinstance(out["b"][1], tuple) and out["b"][1][1] == "tag"


# ---------------------------------------------------------------------------
# plan_report rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("protocol,n_servers", [
    ("xor-dpf-2", 2), ("additive-dpf-2", 2), ("lwe-simple-1", 1)])
def test_plan_report_rows_have_the_reference_keys(protocol, n_servers,
                                                  no_plan_cache):
    cfg = PIRConfig(n_items=1 << 10, item_bytes=32, protocol=protocol,
                    n_servers=n_servers, batch_queries=4)
    ref_cfg = RefPIRConfig(**cfg.to_dict())
    db = pir.make_database(np.random.default_rng(0), cfg.n_items, 32)
    system = replica.make_pir(db, cfg, _cpu_meshes()[0], n_queries=4,
                              buckets=(1, 4))
    report = system.servers[0].plan_report()
    assert sorted(report) == [1, 4]
    ref_row = ref_plan_report(ref_cfg, ref_protocol.plan_for(ref_cfg, 4), 4)
    for b, row in report.items():
        assert set(row) == set(ref_row)
        assert row["plan"] == system.servers[0].bucketed.plan_for_bucket(
            b).name
        assert row["provenance"] == "heuristic"
    plan = system.servers[0].bucketed.plan_for_bucket(4)
    timed = engine.plan_report(cfg, plan, 4, backend="cpu",
                               measured_wall_s=0.01)
    ref_timed = ref_plan_report(ref_cfg, ref_protocol.plan_for(ref_cfg, 4),
                                4, measured_wall_s=0.01)
    assert set(timed) == set(ref_timed)


def test_serve_replica_surface_on_the_cpu(no_plan_cache):
    """The lifecycle and observation surface the router calls, on one real
    replica: make_pir's facade, apply_delta with subscribe_epochs, the
    heartbeat hook, export_plans / warm_start under the ``cpu`` key, kill
    with ReplicaLost, resubmit of a handed-off payload."""
    cfg = PIRConfig(n_items=1 << 10, item_bytes=32, protocol="lwe-simple-1",
                    n_servers=1, batch_queries=4)
    host = pir.make_database(np.random.default_rng(0), cfg.n_items, 32)
    meshes = _cpu_meshes()
    rep = replica.ServeReplica("x", host, cfg, meshes[0], n_queries=4,
                               buckets=(4,), max_wait_s=0.002,
                               client_rng=np.random.default_rng(1))
    assert isinstance(rep.pir, serve_loop.SingleServerPIR)
    assert isinstance(replica.make_pir(host, PIRConfig(n_items=1 << 10),
                                       meshes[1], n_queries=4, buckets=(4,)),
                      serve_loop.MultiServerPIR)
    seen, beats = [], []
    unsub = rep.subscribe_epochs(seen.append)
    vals = np.full((1, 8), 7, np.uint32)
    assert rep.apply_delta([3], vals) == 1 and rep.epoch == 1
    unsub()
    assert rep.apply_delta([4], vals) == 2 and seen == [1]
    assert rep.db is rep.pir.db and rep.cfg is cfg
    assert rep.warm_start(rep.export_plans()) == 1     # one bucket, "cpu"
    assert engine.plan_cache().get("cpu", cfg.protocol,
                                   cache_mod.spec_signature(cfg), 4) \
        == rep.export_plans()[4]
    rep.set_heartbeat(lambda: beats.append(1))
    rep.start()
    try:
        want = pir.db_as_bytes(host)
        want[3] = want[4] = np_words_to_bytes(vals)[0]
        assert np.array_equal(rep.submit(3).result(timeout=60), want[3])
        assert beats and rep.running and not rep.lost
        assert rep.queue_depth == 0 and rep.stats.answered == 1
    finally:
        rep.close()
    assert not rep.running
    other = replica.ServeReplica("y", host, cfg, meshes[1], n_queries=4,
                                 buckets=(4,), max_wait_s=60.0,
                                 client_rng=np.random.default_rng(2))
    other.apply_delta([3], vals)
    other.apply_delta([4], vals)
    other.start()
    fut = other.submit(4)
    (item, moved), = other.drain_handoff()
    assert moved is fut and not other.running
    rep.start()
    try:
        assert rep.resubmit(item, fut) is fut
        assert np.array_equal(fut.result(timeout=60), want[4])
        exc = rep.kill("gone")
        assert isinstance(exc, replica.ReplicaLost) and exc.replica_id == "x"
        assert rep.lost and str(exc) == "gone: x"
        with pytest.raises(RuntimeError):
            rep.submit(1)
    finally:
        rep.close()


# ---------------------------------------------------------------------------
# Real fleets on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture
def no_plan_cache(monkeypatch):
    """An empty in-memory plan cache for the test (warm entries of one
    test must not reach another); the process-wide cache is re-read
    after."""
    monkeypatch.setenv(cache_mod.CACHE_ENV, "off")
    engine.plan_cache(reload=True)
    yield
    monkeypatch.undo()
    engine.plan_cache(reload=True)


def _cpu_meshes():
    """Two replicas' meshes on the CPU: without a process group, the
    ``(1, 1)`` mesh of this process on ``cpu``."""
    return elastic.carve_submeshes(2, model_axis=1, live_devices=["cpu"])


def _close_all(router, *extra):
    for r in list(router.replicas.values()) + list(extra):
        r.close()


def test_xor_fleet_publish_kill_rejoin_detach_is_byte_exact(no_plan_cache):
    """Two real xor-dpf-2 replicas at PIR_SMOKE on the CPU: a publish
    through the router, a kill under load, a warm rejoin and a graceful
    leave; every record equals the reference's database (same seed) with
    the update applied, at epoch 1."""
    cfg = PIR_SMOKE
    host = pir.make_database(np.random.default_rng(0), cfg.n_items, 32)
    ref_host = np.asarray(ref_pir.make_database(np.random.default_rng(0),
                                                cfg.n_items, 32))
    np.testing.assert_array_equal(host, ref_host)
    rows = [5, 77, cfg.n_items - 1]
    vals = np.random.default_rng(1).integers(0, 1 << 32, size=(3, 8),
                                             dtype=np.uint32)
    expect = ref_host.copy()
    expect[rows] = vals
    oracle = np.asarray(ref_pir.db_as_bytes(expect))

    def check(futs, idx, epoch=1):
        for i, f in zip(idx, futs):
            rec = np.asarray(f.result(timeout=120))
            np.testing.assert_array_equal(np_words_to_bytes(rec), oracle[i])
            assert f.epoch == epoch

    kw = dict(n_queries=4, buckets=(1, 4))
    meshes = _cpu_meshes()
    router = replica.Router(rng=np.random.default_rng(2), base_delay=0.001,
                            max_delay=0.01)
    # r0 waits 0.5 s before cutting an under-full batch, so that the queries
    # after its last full batch are still queued when it is killed
    r0 = router.attach(replica.ServeReplica(
        "r0", host, cfg, meshes[0], max_wait_s=0.5,
        client_rng=np.random.default_rng(3), **kw))
    r1 = router.attach(replica.ServeReplica(
        "r1", host, cfg, meshes[1], client_rng=np.random.default_rng(4),
        **kw))
    try:
        assert {r["provenance"] for r in r0.plan_report().values()} == \
            {"heuristic"}
        router.update(rows, vals)
        assert router.publish() == 1 and (r0.epoch, r1.epoch) == (1, 1)

        # kill under load: 10 queries pinned to r0, two full batches cut
        s = router.session("victim")
        s.replica = "r0"
        idx = [5, 0, 9, cfg.n_items - 1, 3, 77, 5, 12, 4000, 77]
        futs = [router.submit(i, session=s) for i in idx]
        r0.kill("killed under load")
        check(futs, idx)
        assert "r0" in router.registry.suspects()
        assert router.failovers >= 2

        # warm rejoin: the delta log replays, the plans come from r1
        router.detach("r0")
        r0b = router.attach(replica.ServeReplica(
            "r0", host, cfg, meshes[0], warm_plans=r1.export_plans(),
            client_rng=np.random.default_rng(5), **kw))
        assert r0b.epoch == 1
        assert {r["provenance"] for r in r0b.plan_report().values()} == \
            {"warm"}
        s2 = router.session("rejoined")
        s2.replica = "r0"
        futs = [router.submit(i, session=s2) for i in (77, 6)]
        check(futs, (77, 6))
        assert all(f.context["rid"] == "r0" for f in futs)

        # graceful leave: r2 holds every query pending (one bucket of 8,
        # a minute's wait), so detach hands all six off to the others
        r2 = router.attach(replica.ServeReplica(
            "r2", host, cfg, meshes[0], n_queries=8, buckets=(8,),
            max_wait_s=60.0, client_rng=np.random.default_rng(6)))
        assert r2.epoch == 1
        s3 = router.session("leaver")
        s3.replica = "r2"
        idx = [cfg.n_items - 1, 5, 1, 2, 3, 4]
        futs = [router.submit(i, session=s3) for i in idx]
        assert r2.queue_depth == 6
        assert router.detach("r2") == 6 and router.resubmitted == 6
        check(futs, idx)
        assert r2.stats.answered == 0
        snap = replica.metrics.snapshot(router)
        assert snap["router"]["n_replicas"] == 2
        assert snap["router"]["max_epoch_lag"] == 0
        assert snap["router"]["suspects"] == []
    finally:
        _close_all(router)


def test_lwe_fleet_failover_then_rejoin_hot(no_plan_cache):
    """The port's twin of the reference's slow
    ``test_fleet_failover_zero_lost_then_rejoin_hot`` (LWE, N = 2^10):
    every future of a killed replica resolves byte-correct at epoch 1,
    and a replica rejoined warm serves on non-heuristic plans."""
    n = 1 << 10
    db = pir.make_database(np.random.default_rng(0), n, 32)
    ref_db = np.asarray(ref_pir.make_database(np.random.default_rng(0), n,
                                              32))
    np.testing.assert_array_equal(db, ref_db)
    cfg = PIRConfig(n_items=n, item_bytes=32, protocol="lwe-simple-1",
                    n_servers=1, batch_queries=4)
    meshes = _cpu_meshes()
    router = replica.Router(rng=np.random.default_rng(0), base_delay=0.01,
                            max_delay=0.1)
    kw = dict(n_queries=4, buckets=(4,), max_wait_s=0.002,
              client_rng=np.random.default_rng(7))
    r0, r1 = [router.attach(replica.ServeReplica(f"r{i}", db, cfg,
                                                 meshes[i], **kw))
              for i in range(2)]
    try:
        new_val = np.arange(8, dtype=np.uint32).reshape(1, 8)
        router.update([5], new_val)
        assert router.publish() == 1
        assert (r0.epoch, r1.epoch) == (1, 1)

        s = router.session("victim")
        s.replica = "r0"
        indices = [5, 0, 9, n - 1, 3, 77, 5, 12]
        futs = [router.submit(i, session=s) for i in indices]
        r0.kill("injected mid-load fault")
        rows = [np.asarray(f.result(timeout=180.0)) for f in futs]
        expect = ref_db.copy()
        expect[5] = new_val
        expect_bytes = np.asarray(ref_pir.db_as_bytes(expect))
        for i, row in zip(indices, rows):
            np.testing.assert_array_equal(row, expect_bytes[i])
        assert all(f.epoch == 1 for f in futs)
        assert "r0" in router.registry.suspects()
        assert router.failovers >= 1

        router.detach("r0")
        r0b = replica.ServeReplica(
            "r0", db, cfg, meshes[0], warm_plans=r1.export_plans(),
            n_queries=4, buckets=(4,), max_wait_s=0.002,
            client_rng=np.random.default_rng(8))
        router.attach(r0b)
        assert r0b.epoch == 1
        assert all(r["provenance"] in ("tuned", "warm")
                   for r in r0b.plan_report().values())
        s2 = router.session("rejoined")
        s2.replica = "r0"
        fut = router.submit(5, session=s2)
        np.testing.assert_array_equal(np.asarray(fut.result(timeout=180.0)),
                                      expect_bytes[5])
        assert fut.epoch == 1
    finally:
        _close_all(router)


# ---------------------------------------------------------------------------
# The scheduler resolves futures outside its lock
# ---------------------------------------------------------------------------

def _fake_scheduler(finalize):
    return QueryScheduler(collate=list, stage=lambda p: p,
                          dispatch=lambda s: s, finalize=finalize,
                          buckets=(2,), max_wait_s=0.001)


def _lock_probe(sched, seen):
    """A done-callback that reads ``queue_depth`` (which takes the
    scheduler's condition) from another thread, as a router's failover
    does when it resubmits into a scheduler: it finishes only if the
    resolving thread does not hold the condition."""
    def cb(_fut):
        t = threading.Thread(target=lambda: sched.queue_depth, daemon=True)
        t.start()
        t.join(timeout=5.0)
        seen.append(not t.is_alive())
    return cb


def _boom(raw, n):
    raise RuntimeError("finalize failed")


@pytest.mark.parametrize("path", ["kill", "session_finalize", "pump"])
def test_futures_resolve_outside_the_scheduler_lock(path):
    sched = _fake_scheduler(_boom if path != "kill" else
                            (lambda raw, n: raw[:n]))
    seen = []
    futs = [sched.submit(i) for i in range(5)]
    for f in futs:
        f.add_done_callback(_lock_probe(sched, seen))
    if path == "kill":
        sched.kill(RuntimeError("killed"))
    elif path == "session_finalize":
        sched.start()
        for f in futs:
            with pytest.raises(RuntimeError, match="finalize failed"):
                f.result(timeout=10)
        sched.stop()
    else:
        with pytest.raises(RuntimeError, match="finalize failed"):
            sched.pump()
        sched.kill(RuntimeError("killed"))     # the batch never launched
    assert all(f.done() for f in futs)
    assert seen == [True] * len(futs)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the card; "
                    "chip_smoke.py's replicas phase serves a PIR_1G fleet)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_xor_fleet_kill_and_rejoin_on_the_card(card, no_plan_cache):
    cfg = PIRConfig(n_items=1 << 12, item_bytes=32)
    host = pir.make_database(np.random.default_rng(61), cfg.n_items, 32)
    meshes = elastic.carve_submeshes(2, model_axis=1)
    router = replica.Router(rng=np.random.default_rng(62), base_delay=0.001)
    kw = dict(n_queries=4, buckets=(1, 4), max_wait_s=0.5)
    r0, r1 = [router.attach(replica.ServeReplica(
        f"r{i}", host, cfg, meshes[i],
        client_rng=np.random.default_rng(63 + i), **kw)) for i in range(2)]
    try:
        s = router.session("victim")
        s.replica = "r0"
        idx = list(range(10))
        futs = [router.submit(i, session=s) for i in idx]
        r0.kill()
        for i, f in zip(idx, futs):
            np.testing.assert_array_equal(f.result(timeout=120), host[i])
        assert router.failovers >= 2
        router.detach("r0")
        r0b = router.attach(replica.ServeReplica(
            "r0", host, cfg, meshes[0], warm_plans=r1.export_plans(),
            client_rng=np.random.default_rng(65), **kw))
        assert {r["provenance"] for r in r0b.plan_report().values()} == \
            {"warm"}
        np.testing.assert_array_equal(
            router.submit(9, session=s).result(timeout=120), host[9])
    finally:
        _close_all(router)
