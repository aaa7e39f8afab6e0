"""Chaos and failures in a session over a database sharded on a mesh, held
against the reference's 4-device sessions where the reference has them.

Four ``gloo`` ranks (``tests/_torch_ranks.py``) play the same scripts as
the reference (``tests/_ref_sharded.py``) at ``PIR_SMOKE``'s shape, rank 0
the controller, which alone visits the chaos seams:

  * a corrupt at ``replica.serve_step``'s visit 1 under ``checksum=True``
    on ``(1, 4)`` and ``(4, 1)``: three whole buckets submitted before
    ``start()``; the first batch resolves, the second raises the
    reference's ``IntegrityError`` (message and ``bad_queries``), which
    ends the session and fails the third, already dispatched; the same
    ``fired`` log; the followers leave by ``ABORT``;
  * a kill at ``scheduler.dispatch``'s visit 1 on ``(2, 2)``: the first
    bucket resolves, the second fails with ``InjectedFault`` before any
    rank dispatched it.

Port-only: ``kill`` on the controller ends every follower's loop and
leaves the mesh consistent (a session after it serves exact records);
``queue_depth``, ``drain_handoff`` and ``heartbeat`` serve on the
controller, and a handoff ends the followers' loops by ``STOP``; and
a follower whose dispatch raises, its process kept alive, makes the
controller's futures fail and ``close()`` return on every rank within the
group timeout given to ``init_distributed`` (a run of its own: its groups
are broken after it).
"""
import json
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from _torch_ranks import run_ranks

N = 1 << 14                          # PIR_SMOKE
BLOCK = N // 4
BUCKETS = [[3, BLOCK + 1, 2 * BLOCK + 2, 3 * BLOCK + 3],
           [1, 2, BLOCK + 7, N - 1], [5, 6, 2 * BLOCK + 9, 3 * BLOCK + 9]]
BASE = {"kind": "session", "facade": "multi", "protocol": "xor-dpf-2",
        "n_items": N, "item_bytes": 32, "db_seed": 51, "key_seed": 52,
        "n_queries": 4, "max_wait_s": 60.0}
CORRUPT = {**BASE, "name": "corrupt", "checksum": True,
           "meshes": [[1, 4], [4, 1]],
           "chaos": [5, [["replica.serve_step", "corrupt", 1]]],
           "steps": [["submit", sum(BUCKETS, [])], ["start"], ["wait"],
                     ["close"]]}
KILL = {**BASE, "name": "kill", "meshes": [[2, 2]],
        "chaos": [6, [["scheduler.dispatch", "kill", 1]]],
        "steps": [["submit", BUCKETS[0]], ["start"], ["wait"],
                  ["submit", BUCKETS[1]], ["wait"], ["close"]]}
#: port-only: the controller's kill with two queries pending, then a
#: session on the same mesh
CKILL = {**BASE, "name": "ckill", "meshes": [[1, 4]],
         "steps": [["submit", BUCKETS[0]], ["start"], ["wait"],
                   ["submit", BUCKETS[1][:2]], ["kill"], ["wait"],
                   ["close"]]}
AFTER = {**BASE, "name": "after", "meshes": [[1, 4]],
         "steps": [["submit", BUCKETS[2]], ["start"], ["wait"], ["close"]]}
#: port-only: the replica hooks on the controller of a session on (2, 2):
#: two queries wait (never a whole bucket), then a graceful leave
HOOKS = {**BASE, "name": "hooks", "meshes": [[2, 2]],
         "steps": [["beat"], ["submit", BUCKETS[0]], ["start"], ["wait"],
                   ["submit", BUCKETS[1][:2]], ["hooks"], ["close"]]}
#: port-only, a run of its own: rank 3's second dispatch raises; it stays
#: alive LINGER_S, well past the group timeout TIMEOUT_S
TIMEOUT_S, LINGER_S = 10, 30
FAIL = {**BASE, "name": "fail", "meshes": [[2, 2]],
        "follower_fails": {"3": 1}, "linger_s": LINGER_S,
        "steps": [["submit", BUCKETS[0]], ["start"], ["wait"],
                  ["submit", BUCKETS[1]], ["wait"], ["close"]]}
PARITY = [("corrupt", (1, 4)), ("corrupt", (4, 1)), ("kill", (2, 2))]
COMPARED = ("groups", "epochs", "bucket_counts", "batches", "lanes",
            "fired", "epoch")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    # the broken run goes beside the other one: it waits out a timeout
    with ThreadPoolExecutor(2) as pool:
        main = pool.submit(run_ranks, "session",
                           {"cases": [CORRUPT, KILL, CKILL, AFTER, HOOKS]},
                           tmp_path_factory.mktemp("ranks"),
                           ref_spec=[CORRUPT, KILL])
        broken = pool.submit(run_ranks, "session",
                             {"cases": [FAIL], "broken": True,
                              "timeout_s": TIMEOUT_S},
                             tmp_path_factory.mktemp("broken"))
        return main.result(), broken.result()[0]


def tag(name, mesh):
    return f"{name}/{mesh[0]}x{mesh[1]}"


@pytest.fixture(scope="module")
def host():
    from repro_torch.core import pir
    return pir.make_database(np.random.default_rng(BASE["db_seed"]), N, 32)


def exact(group, want) -> bool:
    return all(o["error"] is None for o in group) and np.array_equal(
        np.asarray([o["record"] for o in group], np.uint32), want)


@pytest.mark.parametrize("name,mesh", PARITY)
def test_chaos_session_equals_the_references(runs, name, mesh):
    (results, ref), _ = runs
    want = json.loads(str(ref[tag(name, mesh)]))
    got = results[0][tag(name, mesh)]
    for key in COMPARED:
        assert got[key] == want[key], key


@pytest.mark.parametrize("mesh", [(1, 4), (4, 1)])
def test_a_corrupt_share_ends_the_session_with_integrity_error(runs, host,
                                                               mesh):
    (results, _), _ = runs
    res = results[0][tag("corrupt", mesh)]
    (group,) = res["groups"]
    assert exact(group[:4], host[BUCKETS[0]])
    errors = {o["error"] for o in group[4:]}
    assert len(errors) == 1
    (msg,) = errors
    assert msg.startswith("IntegrityError: checksum mismatch on 1/4 "
                          "reconstructed record(s) (batch indices [")
    # the flipped word's query, in its batch, and the third batch fails
    # with the same exception
    bad = {tuple(o["bad"]) for o in group[4:]}
    assert len(bad) == 1 and len(next(iter(bad))) == 1
    assert res["fired"] == [["replica.serve_step", None, "corrupt", 1]]
    assert res["sent"] == {"DISPATCH": 3, "ABORT": 1}
    for f in (r[tag("corrupt", mesh)]["follower"] for r in results[1:]):
        assert (f["dispatches"], f["ended_by"], f["exc"]) == (3, "ABORT",
                                                              None)


def test_a_dispatch_kill_fails_the_batch_before_any_rank_dispatched_it(
        runs, host):
    (results, _), _ = runs
    res = results[0][tag("kill", (2, 2))]
    first, second = res["groups"]
    assert exact(first, host[BUCKETS[0]])
    assert [o["error"] for o in second] == [
        "InjectedFault: chaos kill at scheduler.dispatch"] * 4
    assert res["fired"] == [["scheduler.dispatch", None, "kill", 1]]
    assert res["sent"] == {"DISPATCH": 1, "ABORT": 1}
    for f in (r[tag("kill", (2, 2))]["follower"] for r in results[1:]):
        assert (f["dispatches"], f["ended_by"]) == (1, "ABORT")


def test_kill_on_the_controller_ends_every_followers_loop(runs, host):
    (results, _), _ = runs
    first, second = results[0][tag("ckill", (1, 4))]["groups"]
    assert exact(first, host[BUCKETS[0]])
    assert [o["error"] for o in second] == ["RuntimeError: killed"] * 2
    for r in results[1:]:
        f = r[tag("ckill", (1, 4))]["follower"]
        assert (f["dispatches"], f["ended_by"], f["exc"]) == (1, "ABORT",
                                                              None)
    # the mesh is consistent after it: the next session serves
    (group,) = results[0][tag("after", (1, 4))]["groups"]
    assert exact(group, host[BUCKETS[2]])
    for r in results[1:]:
        assert r[tag("after", (1, 4))]["follower"]["ended_by"] == "STOP"


def test_a_failed_follower_ends_the_session_within_the_timeout(runs, host):
    _, broken = runs
    ctl = broken[0][tag("fail", (2, 2))]
    first, second = ctl["groups"]
    assert exact(first, host[BUCKETS[0]])
    assert all(o["error"] is not None for o in second)
    failed = broken[3][tag("fail", (2, 2))]["follower"]
    assert failed["exc"] == "RuntimeError: follower dispatch failed"
    assert failed["dispatches"] == 1
    for r in broken[1:3]:
        f = r[tag("fail", (2, 2))]["follower"]
        assert f["ended_by"] is None and f["exc"] is not None
    # the failing rank sends nothing further; every rank's close() returns
    # by the group timeout (the script's first batch and the host's slack
    # beside it), long before the failed rank's process ends
    for r in broken:
        assert r[tag("fail", (2, 2))]["close_s"] < TIMEOUT_S + 8


def test_the_replica_hooks_serve_on_the_controller(runs, host):
    # queue_depth counts the two waiting queries, drain_handoff hands them
    # back and ends the session gracefully (STOP on every follower); the
    # session thread beat while it turned
    (results, _), _ = runs
    res = results[0][tag("hooks", (2, 2))]
    (group,) = res["groups"]
    assert exact(group, host[BUCKETS[0]])
    hooks = res["hooks"]
    assert (hooks["queue_depth"], hooks["handed_off"]) == (2, 2)
    assert hooks["beats"] > 0
    assert res["sent"] == {"DISPATCH": 1, "STOP": 1}
    for r in results[1:]:
        f = r[tag("hooks", (2, 2))]["follower"]
        assert (f["dispatches"], f["ended_by"]) == (1, "STOP")
