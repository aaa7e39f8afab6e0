"""Port parity: the chaos plane — ``FaultPlan``, ``ChaosInjector`` and its
six seams — repro_torch vs repro.

The same seeded inputs go through both packages and must give equal
results, with tolerance 0 (the PIR math is integer-only):

* mechanics (twins of ``tests/test_chaos.py:36-106``): event validation,
  ``FaultPlan.random`` for a list of seeds and arguments, the visit
  window and target matching, kill and stall;
* ``corrupt_shares`` over numpy arrays (reference) and CPU tensors (port)
  of every dtype the four protocols' answers carry: the same share, the
  same element, the same bits, and the tensor keeps its dtype and device;
* every seam (twins of ``:409-473``): ``scheduler.dispatch``,
  ``heartbeat``, ``db.publish`` on the router and on the database,
  ``plan_cache.load`` and ``router.resubmit``;
* ``replica.serve_step`` on real checksummed shares through the facades
  (``xor-dpf-2``, ``additive-dpf-2``, ``lwe-simple-1``): equal
  ``bad_queries``;
* the random-fault-plan property (``:516-619``) over fake fleets of both
  packages for a fixed list of seeds that includes 81, with the "never
  silent" half stated precisely: a corrupt counts only where no kill
  fired on the same visit (the kill raises first, so that corrupt is
  logged but never applied);
* the chaos smoke's two scenarios in both packages.

One case marked ``cuda`` flips a share on the card.
"""
import dataclasses
import json
import types

import numpy as np
import pytest
import torch
from test_torch_replica import PACKAGES, fake_replica_class, make_router, trace

from repro import chaos as ref_chaos
from repro.chaos import smoke as ref_smoke
from repro.config import PIRConfig as RefPIRConfig
from repro.core import pir as ref_pir
from repro.db import ShardedDatabase as RefDatabase
from repro.db import spec as ref_spec
from repro.engine import cache as ref_cache
from repro.launch.mesh import make_local_mesh
from repro.runtime import serve_loop as ref_serve_loop
from repro_torch import chaos, engine
from repro_torch.chaos import smoke
from repro_torch.config import PIRConfig
from repro_torch.configs.pir import PIR_SMOKE_CHK
from repro_torch.core import pir
from repro_torch.db import Database
from repro_torch.db import spec
from repro_torch.engine import cache as cache_mod
from repro_torch.runtime import serve_loop


def _api(pkg, chaos_mod, spec_mod, cache, serve):
    return types.SimpleNamespace(
        **vars(PACKAGES[pkg]), chaos=chaos_mod,
        DatabaseSpec=spec_mod.DatabaseSpec,
        verify_records=spec_mod.verify_records, PlanCache=cache.PlanCache,
        QueryScheduler=serve.QueryScheduler)


APIS = {"port": _api("port", chaos, spec, cache_mod, serve_loop),
        "reference": _api("reference", ref_chaos, ref_spec, ref_cache,
                          ref_serve_loop)}


def _both(fn):
    """``fn(api)`` in both packages: ``{"port": ..., "reference": ...}``."""
    return {pkg: fn(api) for pkg, api in APIS.items()}


def _fired(injector):
    return [(f.seam, f.target, f.action, f.visit) for f in injector.fired]


def _plan(api, *events, seed=0):
    return api.chaos.FaultPlan(seed=seed, events=tuple(
        api.chaos.FaultEvent(*ev[:2], **ev[2]) for ev in events))


def _injector(api, *events, seed=0, **kw):
    return api.chaos.ChaosInjector(_plan(api, *events, seed=seed), **kw)


# ---------------------------------------------------------------------------
# FaultPlan / ChaosInjector mechanics (tests/test_chaos.py:36-106)
# ---------------------------------------------------------------------------

def test_registries_match_the_reference():
    assert chaos.SEAMS == ref_chaos.SEAMS
    assert chaos.ACTIONS == ref_chaos.ACTIONS
    assert issubclass(chaos.InjectedFault, RuntimeError)


@pytest.mark.parametrize("kwargs", [
    dict(seam="nope", action="kill"),
    dict(seam="heartbeat", action="explode"),
    dict(seam="heartbeat", action="drop", at=-1),
    dict(seam="heartbeat", action="drop", count=0),
    dict(seam="db.publish", action="stall", duration_s=-1.0),
])
def test_fault_event_validation(kwargs):
    for api in APIS.values():
        with pytest.raises(ValueError):
            api.chaos.FaultEvent(**kwargs)


def _plan_events(plan):
    return [(e.seam, e.action, e.target, e.at, e.count, e.duration_s)
            for e in plan.events]


@pytest.mark.parametrize("seed", [0, 1, 42, 43, 81, 2**31, 2**32 - 1])
@pytest.mark.parametrize("kwargs", [
    {},
    dict(targets=("a", "b")),
    dict(targets=("r0", "r1", "r2", None),
         seams=("replica.serve_step", "heartbeat", "db.publish"),
         actions=("corrupt", "kill", "drop"), n_events=5, max_at=6),
    dict(seams=chaos.SEAMS, actions=chaos.ACTIONS, n_events=12, max_at=3),
])
def test_fault_plan_random_matches_the_reference(seed, kwargs):
    plans = _both(lambda api: api.chaos.FaultPlan.random(seed, **kwargs))
    assert plans["port"].seed == plans["reference"].seed == seed
    assert _plan_events(plans["port"]) == _plan_events(plans["reference"])
    assert plans["port"] == chaos.FaultPlan.random(seed, **kwargs)
    for ev in plans["port"].events:
        assert ev.seam in chaos.SEAMS and ev.action in chaos.ACTIONS
        if ev.action == "corrupt":     # the only share-bearing seam
            assert ev.seam == "replica.serve_step"


def test_visit_window_and_target_matching():
    def run(api):
        inj = _injector(api, ("heartbeat", "drop",
                              dict(target="a", at=2, count=2)))
        window = [inj.should_drop("heartbeat", "a") for _ in range(6)]
        other = inj.should_drop("heartbeat", "b")       # wrong target
        # target None matches any target, with independent visit counters
        inj2 = _injector(api, ("heartbeat", "drop", dict(at=0)))
        both = [inj2.should_drop("heartbeat", t) for t in ("x", "y", "x")]
        return (window, other, both, _fired(inj), _fired(inj2),
                inj2.fired_actions("heartbeat"),
                inj2.fired_actions("db.publish"))

    got = _both(run)
    assert got["port"] == got["reference"]
    window, other, both, _, _, actions, none = got["port"]
    assert window == [False, False, True, True, False, False]
    assert other is False
    assert both == [True, True, False]
    assert actions == ["drop", "drop"] and none == []


def test_kill_raises_and_stall_sleeps_through_the_injected_sleep():
    def run(api):
        inj = _injector(api, ("router.resubmit", "kill", dict(at=0)),
                        ("router.resubmit", "kill", dict(target="t", at=1)))
        with pytest.raises(api.chaos.InjectedFault) as e1:
            inj.visit("router.resubmit")
        inj.visit("router.resubmit")                    # visit 1 of None
        with pytest.raises(api.chaos.InjectedFault) as e2:
            inj.visit("router.resubmit", "t")           # visit 0 of "t"
        with pytest.raises(api.chaos.InjectedFault) as e3:
            inj.visit("router.resubmit", "t")           # visit 1 of "t"
        sleeps = []
        inj2 = _injector(api, ("db.publish", "stall",
                               dict(at=0, duration_s=1.5)),
                         ("db.publish", "delay", dict(at=1, duration_s=0.25)),
                         sleep=sleeps.append)
        hits = [len(inj2.fire("db.publish")) for _ in range(3)]
        return ([str(e.value) for e in (e1, e2, e3)], _fired(inj), sleeps,
                hits)

    got = _both(run)
    assert got["port"] == got["reference"]
    msgs, _, sleeps, hits = got["port"]
    assert msgs == ["chaos kill at router.resubmit",
                    "chaos kill at router.resubmit:t",
                    "chaos kill at router.resubmit:t"]
    assert sleeps == [1.5, 0.25] and hits == [1, 1, 0]


# ---------------------------------------------------------------------------
# corrupt_shares: the same share, element and bits in both packages
# ---------------------------------------------------------------------------

#: (reference numpy dtype, port torch dtype) of the answers the four
#: protocols carry: XOR words (u32 upstream, int32 here), additive and LWE
#: int32 sums, and the byte forms
SHARE_DTYPES = {"xor-words": (np.uint32, torch.int32),
                "int32-sums": (np.int32, torch.int32),
                "uint8": (np.uint8, torch.uint8),
                "int8": (np.int8, torch.int8),
                "int64": (np.int64, torch.int64)}

#: (number of shares, [bucket, cols]): two and three parties at the
#: checksum width, one LWE answer, a bucket of one
SHARE_SHAPES = [(2, (4, 9)), (3, (4, 9)), (1, (4, 36)), (2, (1, 8)),
                (2, (32, 9))]


def _shares(n, shape, np_dtype, seed):
    rng = np.random.default_rng(seed)
    info = np.iinfo(np_dtype)
    return tuple(rng.integers(info.min, info.max, size=shape, dtype=np_dtype,
                              endpoint=True) for _ in range(n))


@pytest.mark.parametrize("dtypes", sorted(SHARE_DTYPES))
@pytest.mark.parametrize("n,shape", SHARE_SHAPES)
def test_corrupt_shares_flips_what_the_reference_flips(dtypes, n, shape):
    np_dtype, torch_dtype = SHARE_DTYPES[dtypes]
    plan = dict(seed=9 + n + shape[0])
    host = _shares(n, shape, np_dtype, seed=plan["seed"])
    tensors = tuple(torch.from_numpy(h.view(f"i{h.itemsize}").copy())
                    .view(torch_dtype) for h in host)

    def run(api, shares):
        inj = _injector(api, ("replica.serve_step", "corrupt",
                              dict(target="r0", at=1, count=2)), **plan)
        before = inj.corrupt_shares("replica.serve_step", "r0", shares)
        other = inj.corrupt_shares("replica.serve_step", "r1", shares)
        out = [inj.corrupt_shares("replica.serve_step", "r0", shares)
               for _ in range(2)]
        after = inj.corrupt_shares("replica.serve_step", "r0", shares)
        assert before is shares and other is shares and after is shares
        return out, _fired(inj)

    ref_out, ref_fired = run(APIS["reference"], host)
    port_out, port_fired = run(APIS["port"], tensors)
    assert port_fired == ref_fired
    for got, want in zip(port_out, ref_out):
        for t, a, h in zip(got, want, host):
            assert t.dtype == torch_dtype and t.device.type == "cpu"
            assert t.shape == a.shape
            np.testing.assert_array_equal(t.numpy().view(np_dtype), a)
        flipped = [k for k, (a, h) in enumerate(zip(want, host))
                   if not np.array_equal(a, h)]
        assert len(flipped) == 1             # one element of one share
        (k,) = flipped
        diff = (want[k].view(f"u{np_dtype().itemsize}")
                ^ host[k].view(f"u{np_dtype().itemsize}"))
        assert np.count_nonzero(diff) == 1
        assert int(diff.max()) == int.from_bytes(
            b"\x80" * np_dtype().itemsize, "little")
    for t, h in zip(tensors, host):           # the input is never touched
        np.testing.assert_array_equal(t.numpy().view(np_dtype), h)


def test_corrupt_shares_draws_the_share_then_the_element():
    """The (k, pos) the injector flips are the plan rng's first two draws
    over the share count and the chosen share's element count, in both
    packages: the same formula the reference's draw order gives."""
    host = _shares(3, (4, 9), np.uint32, seed=5)
    rng = np.random.default_rng(17)
    k = int(rng.integers(3))
    pos = int(rng.integers(host[k].size))
    inj = _injector(APIS["port"], ("replica.serve_step", "corrupt",
                                   dict(at=0)), seed=17)
    out = inj.corrupt_shares("replica.serve_step", None, tuple(
        torch.from_numpy(h.copy()).view(torch.int32) for h in host))
    got = out[k].numpy().view(np.uint32).reshape(-1)
    want = host[k].reshape(-1).copy()
    want[pos] ^= np.uint32(0x80808080)
    np.testing.assert_array_equal(got, want)


def test_corrupt_shares_on_a_non_contiguous_tensor_flips_in_row_major_order():
    """A transposed tensor is flipped at the same logical (row-major)
    element as its contiguous copy. The seams carry contiguous shares; on
    a non-contiguous numpy share the reference flips a reshaped copy and
    returns the share unchanged."""
    host = _shares(1, (9, 4), np.int32, seed=3)
    outs = []
    for share in (torch.from_numpy(host[0].copy()).t(),
                  torch.from_numpy(host[0].T.copy())):
        inj = _injector(APIS["port"], ("replica.serve_step", "corrupt",
                                       dict(at=0)), seed=4)
        outs.append(inj.corrupt_shares("replica.serve_step", None,
                                       (share,))[0])
    assert not torch.from_numpy(host[0]).t().is_contiguous()
    assert torch.equal(outs[0], outs[1])
    assert int((outs[0] != torch.from_numpy(host[0].T.copy())).sum()) == 1


# ---------------------------------------------------------------------------
# the seams (tests/test_chaos.py:409-473)
# ---------------------------------------------------------------------------

def _mini_scheduler(api, chaos_inj=None, target=None):
    return api.QueryScheduler(
        collate=list, stage=lambda p: p, dispatch=lambda s: s,
        finalize=lambda raw, n: raw[:n], buckets=(2,), max_wait_s=0.001,
        chaos=chaos_inj, chaos_target=target)


@pytest.mark.parametrize("order", ["submit_then_start", "start_then_submit"])
def test_scheduler_dispatch_kill_resolves_every_future(order):
    """A kill at scheduler.dispatch ends the session as a dispatch crash
    does: every future resolves (the killed batch with InjectedFault, the
    rest with it as the session dies) and the dead session rejects new
    work. Submitting before start() makes the outcome exact: all six
    fail."""
    def run(api):
        inj = _injector(api, ("scheduler.dispatch", "kill",
                              dict(target="s", at=0)))
        sched = _mini_scheduler(api, inj, "s")
        if order == "start_then_submit":
            sched.start()
        futs = [sched.submit(i) for i in range(6)]
        if order == "submit_then_start":
            sched.start()
        outcomes = []
        for f in futs:                   # nothing hangs: every future resolves
            try:
                outcomes.append(("ok", f.result(timeout=10.0)))
            except api.chaos.InjectedFault as e:
                outcomes.append(("InjectedFault", str(e)))
        with pytest.raises(RuntimeError):
            sched.submit(99)             # the dead session rejects new work
        return outcomes, _fired(inj)

    got = _both(run)
    for outcomes, fired in got.values():
        errors = [o for o in outcomes if o[0] == "InjectedFault"]
        assert len(errors) >= 2          # at least the killed batch
        assert errors[0][1] == "chaos kill at scheduler.dispatch:s"
        assert fired == [("scheduler.dispatch", "s", "kill", 0)]
    if order == "submit_then_start":
        assert got["port"] == got["reference"]
        assert [o[0] for o in got["port"][0]] == ["InjectedFault"] * 6


def test_scheduler_without_an_injector_visits_nothing():
    sched = _mini_scheduler(APIS["port"])
    futs = [sched.submit(i) for i in range(3)]
    assert sched.pump() == 3 and [f.result(0) for f in futs] == [0, 1, 2]
    inj = _injector(APIS["port"], ("scheduler.dispatch", "kill",
                                   dict(target="other", at=0)))
    sched = _mini_scheduler(APIS["port"], inj, "mine")
    futs = [sched.submit(i) for i in range(3)]
    assert sched.pump() == 3 and inj.fired == []
    assert inj._counts == {("scheduler.dispatch", "mine"): 2}


def test_heartbeat_drop_ages_a_replica_into_suspicion():
    def run(api):
        t = [0.0]
        reg = api.ReplicaRegistry(timeout=10.0, clock=lambda: t[0])
        fake = fake_replica_class(api)[0]
        reg.join(fake("a"))
        reg.join(fake("b"))
        reg.chaos = _injector(api, ("heartbeat", "drop",
                                    dict(target="a", at=0, count=10)))
        t[0] = 11.0
        reg.beat("a")                    # dropped: never reaches last_seen
        reg.beat("b")
        suspects = reg.suspects()
        return suspects, reg.healthy(), _fired(reg.chaos)

    got = _both(run)
    assert got["port"] == got["reference"]
    assert got["port"][0] == ["a"] and got["port"][1] == ["b"]


def test_router_publish_drop_lags_a_replica_then_converges():
    def run(api):
        inj = _injector(api, ("db.publish", "drop", dict(target="r1", at=0)))
        router, (r0, r1) = make_router(api, chaos=inj)
        router.update([1], np.full((1, 8), 1, np.uint32))
        router.publish()
        lagged = (r0.epoch, r1.epoch, router.epoch_lag("r1"))
        router.update([2], np.full((1, 8), 2, np.uint32))
        router.publish()                 # the delta-log replay converges r1
        return (lagged, (r0.epoch, r1.epoch), _fired(inj),
                trace(api, router))

    got = _both(run)
    assert got["port"] == got["reference"]
    assert got["port"][0] == (1, 0, 1)
    assert got["port"][1] == (2, 2)


def _database(pkg, host, cfg):
    if pkg == "port":
        return Database(host, cfg, "cpu")
    return RefDatabase(host, RefPIRConfig(**dataclasses.asdict(cfg)),
                       make_local_mesh())


def test_database_publish_drop_reaches_no_subscriber_then_the_next_does():
    """A ``db.publish`` drop on the database itself (no target) swallows
    that epoch's fan-out, though the epoch is published; the next publish's
    fan-out reaches every subscriber (the replica's epoch subscription
    catches up there)."""
    cfg = PIRConfig(n_items=1 << 6, item_bytes=8)
    host = pir.make_database(np.random.default_rng(0), cfg.n_items, 8)
    got = {}
    for pkg, api in APIS.items():
        db = _database(pkg, host, cfg)
        db.chaos = _injector(api, ("db.publish", "drop", dict(at=0)),
                             ("db.publish", "drop", dict(target="r1", at=1)))
        heard = []
        db.subscribe(lambda d: heard.append((d.epoch, np.asarray(
            d.rows).tolist())))
        db.stage([3], np.full((1, 2), 7, np.uint32))
        first = (db.publish(), list(heard))
        row3 = np.asarray(db.view("words"))[3].tolist()
        db.stage([5], np.full((1, 2), 9, np.uint32))
        second = (db.publish(), list(heard))
        got[pkg] = (first, row3, second, _fired(db.chaos))
    assert got["port"] == got["reference"]
    first, row3, second, fired = got["port"]
    assert first == (1, [])                     # published, nobody told
    assert [int(w) & 0xFFFFFFFF for w in row3] == [7, 7]
    assert second == (2, [(2, [5])])
    assert fired == [("db.publish", None, "drop", 0)]


@pytest.mark.parametrize("action", ["drop", "kill"])
def test_plan_cache_load_fault_degrades_never_crashes(action, tmp_path):
    path = str(tmp_path / "cache.json")
    with open(path, "w") as f:
        json.dump({"schema": 1, "plans": {}}, f)

    def run(api):
        healthy = api.PlanCache(path)
        inj = _injector(api, ("plan_cache.load", action, dict(at=0)))
        pc = api.PlanCache(path, chaos=inj)
        again = api.PlanCache(path, chaos=inj)   # visit 1: outside the window
        return (healthy.load_error, pc.load_error, pc.plans,
                again.load_error, _fired(inj))

    got = _both(run)
    assert got["port"] == got["reference"]
    healthy, degraded, plans, again, fired = got["port"]
    assert healthy is None and again is None
    assert degraded.startswith("InjectedFault: chaos ")
    assert plans == {}
    assert fired == [("plan_cache.load", None, action, 0)]


def test_router_resubmit_kill_rides_the_retry_ladder():
    """r0 dies with a pinned query queued; the failover's first resubmit is
    killed at router.resubmit, the retry after it lands on r1."""
    def run(api):
        inj = _injector(api, ("router.resubmit", "kill", dict(at=0)))
        router, (r0, r1) = make_router(api, chaos=inj)
        s = router.session("c")
        s.replica = "r0"
        futs = [router.submit(i, session=s) for i in range(3)]
        r0.kill("chaos test")
        r1.pump()
        return trace(api, router, futs), _fired(inj)

    got = _both(run)
    assert got["port"] == got["reference"]
    tr, fired = got["port"]
    assert fired == [("router.resubmit", None, "kill", 0)]
    assert [r[0][2] for r in tr["routes"]] == ["r1"] * 3
    assert tr["retry"]["retried"] >= 1


# ---------------------------------------------------------------------------
# replica.serve_step on real shares through the facades
# ---------------------------------------------------------------------------

FACADES = {
    "xor-dpf-2": PIRConfig(n_items=1 << 8, item_bytes=32, checksum=True),
    "additive-dpf-2": PIRConfig(n_items=1 << 8, item_bytes=32,
                                protocol="additive-dpf-2", checksum=True),
    "xor-dpf-k": PIRConfig(n_items=1 << 8, item_bytes=32,
                           protocol="xor-dpf-k", n_servers=3, checksum=True),
    "lwe-simple-1": PIR_SMOKE_CHK,
}

#: the facade of each protocol's party count
FACADE_CLASS = {1: "SingleServerPIR", 2: "TwoServerPIR", 3: "MultiServerPIR"}


def _facade(pkg, cfg, host, inj):
    kw = dict(n_queries=4, buckets=(4,), chaos=inj, chaos_scope="s0",
              client_rng=np.random.default_rng(11))
    name = FACADE_CLASS[cfg.n_servers if cfg.protocol == "xor-dpf-k"
                        else 1 if cfg.protocol == "lwe-simple-1" else 2]
    if pkg == "port":
        return getattr(serve_loop, name)(host, cfg, device="cpu", **kw)
    return getattr(ref_serve_loop, name)(
        host, RefPIRConfig(**dataclasses.asdict(cfg)), make_local_mesh(),
        path="fused", **kw)


def _seam_shapes(inj):
    """Record the shape and element size of every share the facade hands
    to ``corrupt_shares``."""
    seen, orig = [], inj.corrupt_shares

    def corrupt_shares(seam, target, shares):
        seen.append([(tuple(a.shape), np.dtype(str(a.dtype).replace(
            "torch.", "")).itemsize) for a in shares])
        return orig(seam, target, shares)

    inj.corrupt_shares = corrupt_shares
    return seen


@pytest.mark.parametrize("protocol", sorted(FACADES))
def test_facade_serve_step_corruption_names_the_same_query(protocol):
    """A corrupt at visit 0 of ``replica.serve_step`` on a batch of four
    (a full bucket: no padding row can absorb the flip) raises
    IntegrityError with the same bad_queries in both packages; the row is
    the one the plan's draws name; the next batch (three queries, padded
    to the bucket) is exact. At the seam the shares have the reference's
    count, ``[bucket, cols]`` shape and element size."""
    cfg = FACADES[protocol]
    host = pir.make_database(np.random.default_rng(3), cfg.n_items,
                             cfg.item_bytes)
    idx = [7, 0, cfg.n_items - 1, 100]
    got = {}
    for pkg, api in APIS.items():
        inj = _injector(api, ("replica.serve_step", "corrupt",
                              dict(target="s0", at=0)), seed=23)
        shapes = _seam_shapes(inj)
        system = _facade(pkg, cfg, host, inj)
        with pytest.raises(api.IntegrityError) as e:
            system.query(idx)
        fresh = np.asarray(system.query(idx[:3]))
        got[pkg] = (e.value.bad_queries, str(e.value), _fired(inj), shapes,
                    fresh)
    assert got["port"][:4] == got["reference"][:4]
    np.testing.assert_array_equal(got["port"][4], got["reference"][4])
    assert got["port"][2] == [("replica.serve_step", "s0", "corrupt", 0)]
    words = protocol in ("xor-dpf-2", "xor-dpf-k")
    cols = cfg.item_bytes // 4 + 1 if words else cfg.item_bytes + 4
    assert got["port"][3] == [[((4, cols), 4)] * cfg.n_servers] * 2
    if protocol == "lwe-simple-1":
        # the top-bit flip shifts the residual by about Delta/2: the noise
        # bound trips before the checksum, naming no query (upstream too)
        assert got["port"][0] == () and "noise overflow" in got["port"][1]
        return
    rng = np.random.default_rng(23)
    rng.integers(cfg.n_servers)               # the share: any party
    assert got["port"][0] == (int(rng.integers(4 * cols)) // cols,)


@pytest.mark.parametrize("action", ["corrupt", "kill"])
def test_facade_injector_set_after_construction_takes_effect(action):
    """The port's facade holds its injector on the scheduler and reads it
    on every visit: one set on a built facade fires at both of its seams
    as one given at construction does in the reference, and clearing it
    serves clean again."""
    cfg = FACADES["xor-dpf-2"]
    host = pir.make_database(np.random.default_rng(3), cfg.n_items,
                             cfg.item_bytes)
    idx = [7, 0, cfg.n_items - 1, 100]
    seam = "replica.serve_step" if action == "corrupt" else \
        "scheduler.dispatch"
    got = {}
    for pkg, api in APIS.items():
        inj = _injector(api, (seam, action, dict(target="s0", at=0)),
                        seed=23)
        if pkg == "port":
            system = _facade(pkg, cfg, host, None)
            assert system.scheduler.chaos is None
            system.scheduler.chaos = inj
            system.scheduler.chaos_target = "s0"
        else:
            system = _facade(pkg, cfg, host, inj)
        err = api.IntegrityError if action == "corrupt" else \
            api.chaos.InjectedFault
        with pytest.raises(err) as e:
            system.query(idx)
        got[pkg] = (getattr(e.value, "bad_queries", None), _fired(inj))
        if pkg == "port":
            system.scheduler.chaos = None
            np.testing.assert_array_equal(
                np.asarray(system.query(idx)), host[idx])
    assert got["port"] == got["reference"]
    assert got["port"][1] == [(seam, "s0", action, 0)]


# ---------------------------------------------------------------------------
# the random-fault-plan property (tests/test_chaos.py:516-619)
# ---------------------------------------------------------------------------

def chaos_fake_replica_class(api):
    """The reference test's ``ChaosFakeReplica`` over ``api``: real
    checksummed rows served through the injector; a kill fails the queue
    with ReplicaLost, a corrupt trips ``verify_records`` into
    IntegrityError, clean rows resolve to the payload words."""
    base = fake_replica_class(api)[0]

    class ChaosFakeReplica(base):
        def __init__(self, rid, spec_, stored_words, injector):
            super().__init__(rid)
            self.spec = spec_
            self.rows = np.array(stored_words)
            self.injector = injector
            self.db.subscribe(self._apply_delta)

        def _apply_delta(self, delta):
            vals = self.spec.attach_checksums(
                self.spec.coerce_rows_to_words(np.asarray(delta.vals)))
            self.rows[np.asarray(delta.rows)] = vals

        def pump(self):
            q, self._q = self._q, []
            n = 0
            for item, fut in q:
                if self.lost:
                    fut.set_exception(api.ReplicaLost(self.id, "chaos kill"))
                    continue
                try:
                    (row,) = self.injector.corrupt_shares(
                        "replica.serve_step", self.id,
                        (self.rows[int(item)],))
                except api.chaos.InjectedFault:
                    self.kill("chaos kill")     # clears + fails the queue
                    fut.set_exception(api.ReplicaLost(self.id, "chaos kill"))
                    continue
                try:
                    payload = api.verify_records(row[None, :],
                                                 self.spec.item_bytes)[0]
                except api.IntegrityError as e:
                    fut.set_exception(e)        # never a silently wrong row
                    continue
                fut.epoch = self.db.epoch
                fut.set_result(np.array(payload))
                n += 1
            return n

    return ChaosFakeReplica


def _property_run(api, seed):
    """The reference property test's scenario for one seed in one
    package; returns what both packages must agree on."""
    spec_ = api.DatabaseSpec(n_items=32, item_bytes=8, checksum=True)
    data_rng = np.random.default_rng(123)
    logical = data_rng.integers(0, 1 << 32, size=(32, 2), dtype=np.uint32)
    stored = spec_.attach_checksums(logical)
    plan = api.chaos.FaultPlan.random(
        seed, targets=("r0", "r1", "r2", None),
        seams=("replica.serve_step", "heartbeat", "db.publish"),
        actions=("corrupt", "kill", "drop"), n_events=5, max_at=6)
    injector = api.chaos.ChaosInjector(plan)
    t = [0.0]
    reg = api.ReplicaRegistry(timeout=30.0, clock=lambda: t[0])
    reg.chaos = injector
    router = api.Router(registry=reg, rng=np.random.default_rng(1),
                        sleep=lambda s: None, retries=6, chaos=injector)
    cls = chaos_fake_replica_class(api)
    reps = [router.attach(cls(f"r{i}", spec_, stored, injector))
            for i in range(3)]
    s = router.session("prop")
    indices = [1 + (i % (spec_.n_items - 1)) for i in range(12)]
    futs = [router.submit(j, session=s) for j in indices]
    # the publish fan-out (and its chaos drops) mid-load; only row 0
    # changes, and no query reads row 0
    router.update([0], np.full((1, spec_.item_words), 7, np.uint32))
    router.publish()
    for _ in range(24):
        if all(f.done() for f in futs):
            break
        for r in reps:
            if not r.lost:
                r.pump()
    routes = []
    for f in futs:
        if not f.done():
            routes.append("pending")
        elif f.exception() is not None:
            routes.append(type(f.exception()).__name__)
        else:
            routes.append((np.asarray(f.result(0)).tolist(), f.epoch))
    return {"trace": trace(api, router), "routes": routes,
            "fired": _fired(injector), "logical": logical,
            "indices": indices, "futs": futs, "router": router,
            "session": (s.replica, s.min_epoch)}


def _applied_corrupts(fired):
    """The corrupts that flipped a share: those on a visit where no kill
    fired for the same (seam, target) — a kill there raises first."""
    kills = {(s, t, v) for s, t, a, v in fired if a == "kill"}
    return [(s, t, v) for s, t, a, v in fired
            if a == "corrupt" and (s, t, v) not in kills]


def _preempted_corrupts(fired):
    kills = {(s, t, v) for s, t, a, v in fired if a == "kill"}
    return [(s, t, v) for s, t, a, v in fired
            if a == "corrupt" and (s, t, v) in kills]


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 5, 8, 13, 42, 81, 1234,
                                  2**31 + 7, 2**32 - 1])
def test_random_fault_plans_never_lose_or_silently_corrupt(seed):
    """Under every seeded plan, in both packages alike: every future
    resolves, every resolved record is exact, the session's min_epoch
    stays within the published epoch, and a corrupt that was applied is
    counted as an integrity failure. Seed 81 (the example that fails the
    reference's own test) fires a kill and a corrupt on the same visit:
    both packages log the corrupt and never apply it, so it is never
    counted."""
    runs = {pkg: _property_run(api, seed) for pkg, api in APIS.items()}
    keys = ("trace", "routes", "fired", "session")
    assert {k: runs["port"][k] for k in keys} == \
        {k: runs["reference"][k] for k in keys}
    for run in runs.values():
        router = run["router"]
        assert all(f.done() for f in run["futs"]), "lost answers under chaos"
        for j, f in zip(run["indices"], run["futs"]):
            if f.exception() is None:
                np.testing.assert_array_equal(np.asarray(f.result(0)),
                                              run["logical"][j])
                assert f.epoch is not None
                assert f.epoch <= router.published_epoch
        assert 0 <= run["session"][1] <= router.published_epoch
        if _applied_corrupts(run["fired"]):
            assert router.integrity_failures >= 1
    if seed == 81:
        fired = runs["port"]["fired"]
        assert _preempted_corrupts(fired)
        assert not _applied_corrupts(fired)
        assert runs["port"]["router"].integrity_failures == 0
        assert runs["reference"]["router"].integrity_failures == 0


# ---------------------------------------------------------------------------
# the chaos smoke's scenarios in both packages
# ---------------------------------------------------------------------------

@pytest.fixture
def no_plan_cache(monkeypatch):
    monkeypatch.setenv(cache_mod.CACHE_ENV, "off")
    engine.plan_cache(reload=True)
    yield
    monkeypatch.undo()
    engine.plan_cache(reload=True)


def test_smoke_scenarios_match_the_reference(no_plan_cache):
    """``scenario_kill`` and ``scenario_corrupt`` of both packages on the
    CPU: each checks every record against its oracle (the same seeded
    databases), and both fire the planned fault, fail over and quarantine
    r0."""
    for seed, cfg in ((0, "PIR_SMOKE_REPL"), (2, "PIR_SMOKE_CHK")):
        from repro.configs import pir as ref_configs
        from repro_torch.configs import pir as configs
        c, rc = getattr(configs, cfg), getattr(ref_configs, cfg)
        np.testing.assert_array_equal(
            pir.db_as_bytes(pir.make_database(np.random.default_rng(seed),
                                              c.n_items, c.item_bytes)),
            np.asarray(ref_pir.db_as_bytes(ref_pir.make_database(
                np.random.default_rng(seed), rc.n_items, rc.item_bytes))))
    kill = {"port": smoke.scenario_kill(device="cpu"),
            "reference": ref_smoke.scenario_kill()}
    corrupt = {"port": smoke.scenario_corrupt(device="cpu"),
               "reference": ref_smoke.scenario_corrupt()}
    for pkg in APIS:
        assert kill[pkg]["fired"] == ["kill"]
        assert kill[pkg]["failovers"] >= 1 and kill[pkg]["answers"] == 8
        assert corrupt[pkg]["fired"] == ["corrupt"]
        assert corrupt[pkg]["integrity_failures"] >= 1
        assert corrupt[pkg]["suspects"] == ["r0"]
        assert corrupt[pkg]["answers"] == 4


def test_smoke_cli_on_the_cpu(no_plan_cache, capsys):
    from repro_torch.chaos.__main__ import main
    assert main(["--smoke", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["kill"]["fired"] == ["kill"]
    assert summary["corrupt"]["suspects"] == ["r0"]
    assert summary["plain_calls"]["lwe_gemm"] >= 1    # the CPU's plain GEMM
    assert not any(summary["launches"].values())
    with pytest.raises(SystemExit):
        main([])


def test_smoke_without_a_card_raises_rather_than_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        smoke.scenario_kill()


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_corrupt_shares_flips_on_the_card_what_numpy_flips():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m cuda on the card)")
    host = _shares(2, (32, 9), np.uint32, seed=31)
    outs = {}
    for pkg, shares in (("reference", host), ("port", tuple(
            torch.from_numpy(h.copy()).view(torch.int32).cuda()
            for h in host))):
        inj = _injector(APIS[pkg], ("replica.serve_step", "corrupt",
                                    dict(at=0)), seed=31)
        outs[pkg] = inj.corrupt_shares("replica.serve_step", None, shares)
    for t, a in zip(outs["port"], outs["reference"]):
        assert t.is_cuda and t.dtype == torch.int32
        np.testing.assert_array_equal(t.cpu().numpy().view(np.uint32), a)
