"""The chaos smoke's two scenarios on a fleet of two ``(1, 2)`` sub-meshes
of four ``gloo`` ranks, held against the reference's smoke on four XLA
devices.

``repro_torch.chaos.smoke`` runs on rank 0, the fleet's controller, with
one ``ChaosInjector`` shared by the router and r0 (on ranks {0, 1}; r1 is
on {2, 3}), as upstream's smoke wires it; ranks 1-3 follow the fleet
(``smoke.follow``). Both sides run with a minute's ``max_wait_s``, so
that r0's first batch is the first whole bucket whatever the timing:

  * A (``PIR_SMOKE_REPL``): a kill at r0's ``scheduler.dispatch``: r0's
    followers never dispatch and leave by ``ABORT``; every query fails
    over to r1 and resolves byte-exact;
  * B (``PIR_SMOKE_CHK``): a corrupt at r0's ``replica.serve_step``:
    verified reconstruction raises ``IntegrityError`` for the whole
    bucket, r0 is quarantined and r1 answers.

The chaos log, the integrity failures, the suspects and the recovered
records equal the reference's. A's failover count depends on when the
first failover re-pins the session, in either package: it is at least
the bucket.

Port-only: a kill of r1, whose grid lacks the controller, right after a
whole bucket was submitted to it (its ``DISPATCH`` sent or not yet): the
bucket's records come back exact from r0, r1's followers leave by
``ABORT`` having dispatched what the controller sent, and a replica
rejoined on the same mesh serves exact records (no reply of the killed
session is left on the channel).
"""
import json

import pytest

import numpy as np

from _torch_ranks import run_ranks

SPEC = {"kind": "fleet_chaos", "name": "chaos", "model_axis": 2,
        "max_wait_s": 60.0, "scenarios": ["kill", "corrupt"]}
#: each replica's commands from the controller, by scenario: r1's grid
#: lacks the controller, whose client asks it for the epoch's hint once
SENT = {"kill": {"r0": {"START": 1, "ABORT": 1},
                 "r1": {"START": 1, "DISPATCH": 2, "HINT": 1, "STOP": 1}},
        "corrupt": {"r0": {"START": 1, "DISPATCH": 1, "ABORT": 1},
                    "r1": {"START": 1, "DISPATCH": 1, "HINT": 1,
                           "STOP": 1}}}


#: port-only: r1, outside the controller's grid, killed under a bucket
REMOTE_KILL = {
    "kind": "fleet", "name": "remote_kill", "protocol": "xor-dpf-2",
    "n_items": 1 << 10, "item_bytes": 32, "db_seed": 85, "router_seed": 86,
    "n_queries": 4, "buckets": [4], "max_wait_s": 60.0, "model_axes": [2],
    "n_clusters": {"2": 1},
    "steps": [["attach", "A", "r0", 0, 1, None],
              ["attach", "B", "r1", 1, 2, None],
              ["submit", "r1", [1, 2, 3, 1000]], ["kill", "r1"], ["wait"],
              ["detach", "r1"], ["attach", "C", "r1", 1, 3, None],
              ["submit", "r1", [4, 5, 6, 1023]], ["wait"], ["close"]]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks("fleet_chaos", SPEC, tmp_path_factory.mktemp("ranks"),
                     ref_spec=[SPEC])


@pytest.fixture(scope="module")
def remote(tmp_path_factory):
    results, _ = run_ranks("fleet", {"cases": [REMOTE_KILL]},
                           tmp_path_factory.mktemp("remote"))
    return [r["remote_kill/m2"] for r in results]


@pytest.mark.parametrize("name", SPEC["scenarios"])
def test_scenario_equals_the_references(runs, name):
    results, ref = runs
    want = json.loads(str(ref[f"chaos/{name}"]))
    got = results[0][f"chaos/{name}"]
    assert got["fired"] == want["fired"] == [name]
    assert got["records"] == want["records"]
    assert got["answers"] == want["answers"] == len(want["records"])
    if name == "corrupt":
        for key in ("integrity_failures", "suspects"):
            assert got[key] == want[key], key
        assert (got["integrity_failures"], got["suspects"]) == (4, ["r0"])
    else:
        assert got["failovers"] >= 4 and want["failovers"] >= 4


@pytest.mark.parametrize("name", SPEC["scenarios"])
def test_followers_ran_the_controllers_commands(runs, name):
    results, _ = runs
    sent = results[0][f"chaos/{name}"]["sent"]
    assert sent == SENT[name]
    for rank in (1, 2, 3):
        (f,) = results[rank][f"chaos/{name}"]["followed"]
        rid = "r0" if rank == 1 else "r1"
        assert f["id"] == rid
        assert f["dispatches"] == sent[rid].get("DISPATCH", 0)
        assert f["hints"] == sent[rid].get("HINT", 0)
        assert (f["ended_by"], f["exc"]) == (
            "ABORT" if rid == "r0" else "STOP", None)


def test_close_returns_on_every_rank(runs):
    results, _ = runs
    for name in SPEC["scenarios"]:
        ends = [r[f"chaos/{name}"]["t_done"] for r in results]
        assert max(ends) - min(ends) < 10.0


def test_a_kill_outside_the_controllers_grid_ends_its_followers(remote):
    from repro_torch.core import pir
    host = pir.make_database(np.random.default_rng(REMOTE_KILL["db_seed"]),
                             REMOTE_KILL["n_items"], 32)
    ctl = remote[0]
    assert ctl["remote"] == {"0": False, "1": True}
    first, second = ctl["groups"]
    for group, idx in ((first, [1, 2, 3, 1000]), (second, [4, 5, 6, 1023])):
        for o, i in zip(group, idx):
            assert o["error"] is None and o["epoch"] == 0
            assert np.array_equal(np.asarray(o["record"], np.uint32),
                                  host[i])
    assert [o["rid"] for o in second] == ["r1"] * 4
    assert ctl["stats"]["C"]["batches"] == 1
    for rank in (2, 3):
        killed, rejoined = remote[rank]["followed"]
        assert (killed["id"], killed["ended_by"], killed["exc"]) == (
            "r1", "ABORT", None)
        assert killed["dispatches"] == ctl["stats"]["B"]["sent"].get(
            "DISPATCH", 0)
        assert (rejoined["ended_by"], rejoined["dispatches"]) == ("STOP", 1)
    ends = [r["t_done"] for r in remote]
    assert max(ends) - min(ends) < 10.0


def test_abort_reads_the_answers_still_owed_before_it_is_sent(monkeypatch):
    # a controller outside its grid, two batches dispatched and one read:
    # the death path reads the other reply before ABORT, so that no reply
    # of the dead session is left for the next one on this control group
    import types
    import torch
    from repro_torch.runtime import serve_loop
    events = []
    replies = [("ANSWER", 0, torch.zeros(1, 4, 8, dtype=torch.int32), 0.0)
               for _ in range(2)]
    monkeypatch.setattr(serve_loop, "send_command",
                        lambda mesh, cmd, *a, **kw: events.append(cmd) or [])
    monkeypatch.setattr(serve_loop, "recv_reply",
                        lambda mesh: events.append("reply") or replies.pop())
    mesh = types.SimpleNamespace(contains_rank=False)
    channel = serve_loop._Channel(mesh, lambda payload: ((4,), []))
    channel.dispatch(None)
    channel.dispatch(None)
    assert channel.answer(0).shape == (1, 4, 8)
    channel.abort()
    assert events == ["DISPATCH", "DISPATCH", "reply", "reply", "ABORT"]
    assert channel.owed == 0 and channel.dispatched == [(4,), (4,)]
