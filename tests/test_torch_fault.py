"""Port parity: the fault-tolerance policies, repro_torch vs repro.

``HeartbeatRegistry`` (with an injected clock), ``retry_step`` and
``RetryStats`` (sleeps recorded, jitter drawn from a seeded rng, capped
and exhausted schedules), ``PoisonPolicy`` on loss sequences with NaN and
Inf, and ``StragglerMonitor`` (EWMA, flags, ``reassign`` and
``shed_stragglers``, which never sheds onto an idle straggler) are driven
with the same inputs through both packages; every output is equal.
"""
import math

import numpy as np
import pytest

from repro.runtime import fault as ref_fault
from repro_torch.runtime import fault


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _heartbeats(mod, timeout, script):
    """Run ``script`` — ("beat", name), ("advance", dt), ("remove", name),
    ("forget", name) — and read suspects / healthy after every step."""
    clock = FakeClock()
    reg = mod.HeartbeatRegistry(timeout=timeout, clock=clock)
    out = []
    for op, arg in script:
        if op == "advance":
            clock.now += arg
            res = None
        else:
            res = getattr(reg, op)(arg)
        out.append((res, reg.suspects(), reg.healthy(), dict(reg.last_seen)))
    return out


HEARTBEAT_SCRIPT = [
    ("beat", "r0"), ("beat", "r1"), ("advance", 3.0), ("beat", "r0"),
    ("advance", 2.5), ("beat", "r2"), ("advance", 0.5), ("advance", 4.0),
    ("remove", "r1"), ("remove", "r1"), ("forget", "r0"), ("beat", "r1"),
    ("advance", 10.0)]


@pytest.mark.parametrize("timeout", [0.5, 3.0, 5.0, 60.0])
def test_heartbeat_registry_matches_reference(timeout):
    assert _heartbeats(fault, timeout, HEARTBEAT_SCRIPT) \
        == _heartbeats(ref_fault, timeout, HEARTBEAT_SCRIPT)


def test_heartbeat_default_clock_is_monotonic():
    reg = fault.HeartbeatRegistry(timeout=60.0)
    reg.beat("a")
    assert reg.healthy() == ["a"] and reg.suspects() == []


def _retry(mod, *, fails, retries, base_delay, max_delay, jitter, seed,
           error=RuntimeError):
    """``fn`` fails ``fails`` times with ``error`` then returns 42; returns
    the outcome, the sleeps, the stats and the rng's next draw."""
    sleeps, calls = [], []

    def fn(x, *, y):
        calls.append((x, y))
        if len(calls) <= fails:
            raise error(f"transient {len(calls)}")
        return 42

    stats = mod.RetryStats()
    rng = None if seed is None else np.random.default_rng(seed)
    try:
        outcome = mod.retry_step(fn, 1, y=2, retries=retries,
                                 base_delay=base_delay, max_delay=max_delay,
                                 sleep=sleeps.append, stats=stats,
                                 jitter=jitter, rng=rng)
    except Exception as e:          # noqa: BLE001 - the outcome is compared
        outcome = (type(e).__name__, str(e))
    after = None if rng is None else float(rng.random())
    return (outcome, sleeps, calls,
            (stats.attempts, stats.retried, stats.slept_s), after)


@pytest.mark.parametrize("case", [
    dict(fails=0, retries=3, base_delay=0.5, max_delay=30.0, jitter=0.0,
         seed=None),
    dict(fails=2, retries=3, base_delay=0.5, max_delay=30.0, jitter=0.0,
         seed=None),
    dict(fails=5, retries=6, base_delay=4.0, max_delay=10.0, jitter=0.0,
         seed=None),                                   # capped
    dict(fails=4, retries=3, base_delay=0.5, max_delay=30.0, jitter=0.0,
         seed=None),                                   # exhausted
    dict(fails=3, retries=5, base_delay=0.5, max_delay=30.0, jitter=0.25,
         seed=7),                                      # seeded jitter
    dict(fails=6, retries=6, base_delay=2.0, max_delay=5.0, jitter=0.9,
         seed=11),                                     # jitter, re-capped
    dict(fails=9, retries=4, base_delay=1.0, max_delay=3.0, jitter=0.5,
         seed=3),                                      # jitter, exhausted
], ids=["first-try", "two-retries", "capped", "exhausted", "jitter",
        "jitter-capped", "jitter-exhausted"])
def test_retry_step_matches_reference(case):
    mine = _retry(fault, **case)
    assert mine == _retry(ref_fault, **case)
    assert all(s <= case["max_delay"] for s in mine[1])


@pytest.mark.parametrize("error", [ValueError, OSError])
def test_retry_step_retriable_set_matches_reference(error):
    """An error outside ``retriable`` propagates at once; OSError is
    retried."""
    case = dict(fails=1, retries=2, base_delay=0.5, max_delay=30.0,
                jitter=0.0, seed=None, error=error)
    assert _retry(fault, **case) == _retry(ref_fault, **case)


def test_retry_stats_defaults_match_reference():
    assert vars(fault.RetryStats()) == vars(ref_fault.RetryStats())


LOSSES = [1.0, math.nan, 0.5, math.inf, -math.inf, math.nan, 2.0, math.nan,
          math.nan, math.inf, math.nan, math.nan, 0.25, -math.inf, math.inf,
          3.0]


@pytest.mark.parametrize("max_consecutive", [1, 2, 3, 5])
def test_poison_policy_matches_reference(max_consecutive):
    def run(mod):
        pol = mod.PoisonPolicy(max_consecutive=max_consecutive)
        return [(pol.observe(x), pol.consecutive, pol.total_skipped)
                for x in LOSSES]
    mine = run(fault)
    assert mine == run(ref_fault)
    assert {d for d, _, _ in mine} >= {"ok", "rewind"}


def _monitor(mod, factor, alpha, records, queues):
    mon = mod.StragglerMonitor(factor=factor, alpha=alpha)
    flags = []
    for lane, lat in records:
        mon.record(lane, lat)
        flags.append(sorted(mon.stragglers()))
    shed, moved = mon.shed_stragglers(queues)
    return (dict(mon.ewma), flags, shed, moved, mon.reassign(queues),
            queues)


MONITOR_CASES = {
    # tests/test_serving.py:200: c0 is a flagged lane with nothing queued
    "idle-straggler": (2.0, 1.0, [("c0", 100.0), ("c1", 100.0), ("c2", 1.0),
                                  ("c3", 1.0), ("c4", 1.0)],
                       {"c0": [], "c1": ["a", "b"], "c2": [], "c3": [],
                        "c4": []}),
    "ewma": (2.0, 0.2, [("cluster0", 1.0), ("cluster1", 1.0),
                        ("cluster1", 9.0), ("cluster1", 30.0),
                        ("cluster0", 1.2), ("cluster1", 40.0)],
             {"cluster0": [1], "cluster1": [2, 3, 4]}),
    "one-lane": (2.0, 0.5, [("cluster0", 5.0)], {"cluster0": [1, 2]}),
    "all-slow-but-median": (1.5, 1.0, [("a", 1.0), ("b", 2.0), ("c", 9.0)],
                            {"a": [], "b": ["x"], "c": ["y", "z"]}),
    "none-flagged": (3.0, 0.5, [("a", 1.0), ("b", 2.0), ("a", 2.5)],
                     {"a": ["x"], "b": ["y"]}),
}


@pytest.mark.parametrize("case", sorted(MONITOR_CASES))
def test_straggler_monitor_matches_reference(case):
    factor, alpha, records, queues = MONITOR_CASES[case]
    mine = _monitor(fault, factor, alpha, records,
                    {k: list(v) for k, v in queues.items()})
    theirs = _monitor(ref_fault, factor, alpha, records,
                      {k: list(v) for k, v in queues.items()})
    assert mine == theirs
    ewma, flags, shed, moved, _, original = mine
    assert original == queues                    # the input is not mutated
    assert sorted(sum(shed.values(), [])) == sorted(sum(queues.values(), []))
    for lane in flags[-1]:                       # a flagged lane receives
        assert shed[lane] == [] or moved == 0    # nothing once it sheds
    if case == "idle-straggler":
        assert moved == 2 and shed["c0"] == [] and shed["c1"] == []
