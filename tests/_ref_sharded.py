"""The reference's sharded serving path on four XLA CPU devices.

Run as a script in its own process (the device count must be set before
JAX initializes):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \
        python tests/_ref_sharded.py SPEC.json OUT.npz

``SPEC.json`` holds a list of cases; each case writes arrays into
``OUT.npz`` under keys that start with the case's ``name``:

  serve      ``PIRServer.answer`` of every party on each mesh shape and
             collective (``{name}/{d}x{m}/{collective}/p{party}``) and on
             one device (``{name}/single/p{party}``); inputs are the
             seeded database and keys that the port's tests draw the same
             way (``make_database``, ``query_gen`` per index, or seeded
             int32 ciphertexts for ``lwe-simple-1``)
  allreduce  ``xor_allreduce_gather`` / ``xor_allreduce_butterfly`` under
             ``shard_map`` over the ``model`` axis of a ``(data, model)``
             mesh, on seeded ``[data, model, Q, W]`` u32 partials
             (``{name}/{collective}``: every device's result)
  mesh       the mesh helpers on ``MeshConfig`` shapes and
             ``make_local_mesh`` clips (``{name}/{i}``, JSON in a 0-d
             string array)
  report     ``BucketedServeFns.plan_report`` on a mesh
             (``{name}/{d}x{m}``, JSON)
  placement  ``ShardedDatabase`` on each mesh shape: every device's row
             range of each view (``{name}/{d}x{m}/{view}/rows``, device
             order), the words after each staged update is published
             (``.../words{step}``, its epoch ``.../epoch{step}``), the sum
             of the words registered as a hint (``.../hint``) and a
             checksummed database's words (``.../chk_words``)
  hint       ``ShardedDatabase`` on each mesh shape with the LWE hint
             registered twice, with its delta (``delta``) and without
             (``rebuilt``, dropped and rebuilt after a publish): both hints
             at each epoch (``{name}/{d}x{m}/{hint}{step}``) and the
             counters (``.../stats``: builds, deltas)
  single     ``SingleServerPIR`` (``lwe-simple-1``) on each mesh shape
             with a seeded client rng: the records of a query
             (``{name}/{d}x{m}/q{step}``), then after each staged update is
             published, with the epoch, the replicated hint
             (``.../hint{step}``) and the database's hint counters
             (``.../stats``: builds, deltas, client fetches)
  batch      ``BatchPIR`` on each mesh shape with its ``rounds``: the
             records of each query batch (``{name}/{d}x{m}/q{step}``, one
             of them failing cuckoo placement and halved), before and after
             a published update, the ``dispatch_log`` and the epoch; a
             ``refusals`` list of (mesh, rounds) whose construction raises
             (``{name}/refused/{d}x{m}``: the message)
  session    a streaming session of ``TwoServerPIR`` / ``MultiServerPIR``
             (``facade: "multi"``), ``SingleServerPIR`` (``"single"``) or
             ``BatchPIR`` (``"batch"``) on each mesh shape, driven by the
             script ``_torch_ranks.play_session`` plays on the port's
             controller, with a seeded client rng, ``n_clusters`` lanes and
             an optional fault plan (``chaos``: seed and events);
             ``{name}/{d}x{m}`` holds the outcome as JSON (groups of records
             or errors with their epochs, the published epochs, bucket
             counts, lanes, the chaos log, and the hint counters or the
             ``dispatch_log``)

The port's tests read the file and compare with the same cases run over
four ``gloo`` ranks.
"""
import json
import sys

import numpy as np


def _cfg(case):
    from repro.config import PIRConfig
    return PIRConfig(n_items=case["n_items"], item_bytes=case["item_bytes"],
                     protocol=case["protocol"],
                     n_servers=case.get("n_servers", 2))


def _mesh(shape):
    import jax
    devs = np.asarray(jax.devices()[:shape[0] * shape[1]]).reshape(shape)
    return jax.sharding.Mesh(devs, ("data", "model"))


_KEYS: dict = {}


def keys_for(case, cfg):
    """Every party's batched keys: one ``query_gen`` per index from one
    rng (``lwe-simple-1``: seeded int32 ciphertexts); drawn once per
    protocol, seed and indices."""
    sig = (cfg.protocol, cfg.n_servers, case["key_seed"],
           tuple(case["indices"]))
    if sig not in _KEYS:
        _KEYS[sig] = _draw_keys(case, cfg)
    return _KEYS[sig]


def _draw_keys(case, cfg):
    import jax.numpy as jnp
    from repro.core import dpf, lwe, protocol as protocol_mod
    proto = protocol_mod.for_config(cfg)
    rng = np.random.default_rng(case["key_seed"])
    idx = case["indices"]
    if proto.share_kind == "lwe":
        ct = rng.integers(-2 ** 31, 2 ** 31, size=(len(idx), cfg.n_items),
                          dtype=np.int64).astype(np.int32)
        return (lwe.LWECiphertext(ct=jnp.asarray(ct), log_n=cfg.log_n,
                                  n=lwe.params_for(cfg.n_items).n),)
    per = [proto.query_gen(rng, int(i), cfg) for i in idx]
    return tuple(dpf.stack_keys([p[b] for p in per])
                 for b in range(proto.n_parties(cfg)))


def run_serve(case, out):
    from repro.core import pir
    from repro.core.server import PIRServer
    from repro.db import ShardedDatabase
    cfg = _cfg(case)
    db = pir.make_database(np.random.default_rng(case["db_seed"]),
                           cfg.n_items, cfg.item_bytes)
    keys = keys_for(case, cfg)
    q = case.get("n_queries", len(case["indices"]))
    meshes = [("single", (1, 1), "gather")] * case.get("single", True) + [
        (f"{d}x{m}/{c}", (d, m), c) for d, m in case["meshes"]
        for c in case["collectives"]]
    for tag, shape, coll in meshes:
        mesh = _mesh(shape)
        database = ShardedDatabase(db, cfg, mesh)
        for party, k in enumerate(keys):
            server = PIRServer(party, database=database, cfg=cfg, mesh=mesh,
                               n_queries=q, path="baseline", collective=coll)
            out[f"{case['name']}/{tag}/p{party}"] = np.asarray(
                server.answer(k))


def run_allreduce(case, out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    from repro.core.protocol import (xor_allreduce_butterfly,
                                     xor_allreduce_gather)
    d, m = case["mesh"]
    rng = np.random.default_rng(case["seed"])
    parts = rng.integers(0, 2 ** 32, size=(d, m) + tuple(case["shape"]),
                         dtype=np.uint64).astype(np.uint32)
    mesh = _mesh((d, m))
    fns = {"gather": lambda x: xor_allreduce_gather(x, "model"),
           "butterfly": lambda x: xor_allreduce_butterfly(x, "model", m)}
    for coll, fn in fns.items():
        step = shard_map(lambda x, fn=fn: fn(x[0, 0])[None, None], mesh=mesh,
                         in_specs=P("data", "model"),
                         out_specs=P("data", "model"), check_vma=False)
        out[f"{case['name']}/{coll}"] = np.asarray(
            jax.jit(step)(jnp.asarray(parts)))
    out[f"{case['name']}/partials"] = parts


def run_mesh(case, out):
    from repro.config import MeshConfig
    from repro.launch import mesh as mesh_mod
    rows = []
    for shape, axes in case["configs"]:
        mesh = mesh_mod.make_mesh(MeshConfig(shape=tuple(shape),
                                             axes=tuple(axes)))
        rows.append(_mesh_row(mesh_mod, mesh))
    for data, model in case["local"]:
        rows.append(_mesh_row(mesh_mod,
                              mesh_mod.make_local_mesh(data, model)))
    out[case["name"]] = np.asarray(json.dumps(rows))


def _mesh_row(mesh_mod, mesh):
    return {"shape": dict(mesh.shape), "axis_names": list(mesh.axis_names),
            "size": {a: mesh_mod.mesh_axis_size(mesh, a)
                     for a in ("pod", "data", "model", "expert")},
            "batch_axes": list(mesh_mod.batch_axes(mesh)),
            "pir_cluster_axes": list(mesh_mod.pir_cluster_axes(mesh)),
            "pir_shard_axis": mesh_mod.pir_shard_axis(mesh)}


def run_report(case, out):
    from repro.core.server import BucketedServeFns
    cfg = _cfg(case)
    for d, m in case["meshes"]:
        fns = BucketedServeFns(cfg, _mesh((d, m)), buckets=case["buckets"],
                               path=case["path"])
        rep = fns.plan_report()
        out[f"{case['name']}/{d}x{m}"] = np.asarray(json.dumps(
            {str(b): {k: r[k] for k in ("plan", "label", "provenance",
                                        "predicted_step_bytes")}
             for b, r in rep.items()}))


def run_placement(case, out):
    from dataclasses import replace
    from repro.core import pir
    from repro.db import ShardedDatabase
    cfg = _cfg(case)
    db = pir.make_database(np.random.default_rng(case["db_seed"]),
                           cfg.n_items, cfg.item_bytes)
    for d, m in case["meshes"]:
        tag = f"{case['name']}/{d}x{m}"
        mesh = _mesh((d, m))
        database = ShardedDatabase(db, cfg, mesh)
        order = {dev: i for i, dev in enumerate(mesh.devices.flat)}
        for view in ("words", "bytes"):
            rows = [None] * mesh.size
            for shard in database.view(view).addressable_shards:
                sl = shard.index[0]
                rows[order[shard.device]] = (sl.start or 0,
                                             sl.stop or cfg.n_items)
            out[f"{tag}/{view}/rows"] = np.asarray(rows)
        for step, (rows, seed) in enumerate(case["updates"]):
            vals = np.random.default_rng(seed).integers(
                0, 2 ** 32, size=(len(rows), cfg.item_bytes // 4),
                dtype=np.uint64).astype(np.uint32)
            database.stage(rows, vals)
            out[f"{tag}/epoch{step}"] = np.asarray(database.publish())
            out[f"{tag}/words{step}"] = np.asarray(database.view("words"))
        database.register_hint("h", lambda w: w.sum())
        out[f"{tag}/hint"] = np.asarray(database.hint("h"))
        chk = ShardedDatabase(db, replace(cfg, checksum=True), mesh)
        out[f"{tag}/chk_words"] = np.asarray(chk.view("words"))


def run_hint(case, out):
    from repro.core import pir, protocol as protocol_mod
    from repro.db import ShardedDatabase
    cfg = _cfg(case)
    proto = protocol_mod.for_config(cfg)
    db = pir.make_database(np.random.default_rng(case["db_seed"]),
                           cfg.n_items, cfg.item_bytes)
    for d, m in case["meshes"]:
        tag = f"{case['name']}/{d}x{m}"
        database = ShardedDatabase(db, cfg, _mesh((d, m)))
        database.register_hint("delta", proto.hint_builder(cfg),
                               proto.hint_delta(cfg))
        database.register_hint("rebuilt", proto.hint_builder(cfg))
        for step, upd in enumerate([None] + case["updates"]):
            if upd is not None:
                rows, seed = upd
                database.stage(rows, _update_rows(cfg, rows, seed))
                out[f"{tag}/epoch{step}"] = np.asarray(database.publish())
            for name in ("delta", "rebuilt"):
                out[f"{tag}/{name}{step}"] = np.asarray(database.hint(name))
        st = database.stats
        out[f"{tag}/stats"] = np.asarray([st.n_hint_builds,
                                          st.n_hint_deltas])


def _update_rows(cfg, rows, seed) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, size=(len(rows), cfg.item_bytes // 4),
        dtype=np.uint64).astype(np.uint32)


def run_single(case, out):
    from repro.core import pir
    from repro.runtime.serve_loop import SingleServerPIR
    cfg = _cfg(case)
    db = pir.make_database(np.random.default_rng(case["db_seed"]),
                           cfg.n_items, cfg.item_bytes)
    for d, m in case["meshes"]:
        tag = f"{case['name']}/{d}x{m}"
        system = SingleServerPIR(
            db, cfg, _mesh((d, m)), n_queries=case["n_queries"],
            client_rng=np.random.default_rng(case["key_seed"]))
        out[f"{tag}/q0"] = system.query(case["indices"])
        out[f"{tag}/epoch0"] = np.asarray(system.epoch)
        out[f"{tag}/hint0"] = np.asarray(system.db.hint(cfg.protocol))
        for step, (rows, seed) in enumerate(case["updates"], start=1):
            system.update(rows, _update_rows(cfg, rows, seed))
            out[f"{tag}/epoch{step}"] = np.asarray(system.publish())
            out[f"{tag}/hint{step}"] = np.asarray(
                system.db.hint(cfg.protocol))
            out[f"{tag}/q{step}"] = system.query(rows + case["indices"])
        st = system.db.stats
        out[f"{tag}/stats"] = np.asarray(
            [st.n_hint_builds, st.n_hint_deltas, system.hint_fetches])


def _batch_cfg(case):
    from repro.config import PIRConfig
    return PIRConfig(n_items=case["n_items"], item_bytes=case["item_bytes"],
                     protocol=case["protocol"], batch_m=case["batch_m"],
                     batch_queries=1, checksum=case["checksum"])


def run_batch(case, out):
    from repro.core import pir
    from repro.runtime.batch import BatchPIR
    cfg = _batch_cfg(case)
    db = pir.make_database(np.random.default_rng(case["db_seed"]),
                           cfg.n_items, cfg.item_bytes)
    for (d, m), rounds in case["meshes"]:
        tag = f"{case['name']}/{d}x{m}"
        system = BatchPIR(db, cfg, _mesh((d, m)), rounds=tuple(rounds),
                          client_rng=np.random.default_rng(case["key_seed"]))
        for step, idx in enumerate(case["queries"]):
            out[f"{tag}/q{step}"] = system.query_batch(idx)
        rows = case["update_rows"]
        system.update(rows, _update_rows(cfg, rows, case["update_seed"]))
        out[f"{tag}/epoch"] = np.asarray(system.publish())
        out[f"{tag}/q_after"] = system.query_batch(rows)
        out[f"{tag}/dispatch_log"] = np.asarray(system.dispatch_log)
    for (d, m), rounds in case.get("refusals", ()):
        try:
            BatchPIR(db, cfg, _mesh((d, m)), rounds=tuple(rounds))
            msg = ""
        except ValueError as e:
            msg = f"ValueError: {e}"
        out[f"{case['name']}/refused/{d}x{m}"] = np.asarray(msg)


def session_config(case, PIRConfig):
    """A session case's config, in either package (``PIRConfig``)."""
    return PIRConfig(n_items=case["n_items"], item_bytes=case["item_bytes"],
                     protocol=case["protocol"],
                     n_servers=case.get("n_servers", 2),
                     checksum=case.get("checksum", False),
                     batch_m=case.get("batch_m", 0), batch_queries=1)


def run_session(case, out):
    from repro.chaos import ChaosInjector, FaultEvent, FaultPlan
    from repro.config import PIRConfig
    from repro.core import pir
    from repro.runtime.batch import BatchPIR
    from repro.runtime.serve_loop import MultiServerPIR, SingleServerPIR
    from _torch_ranks import play_session
    cfg = session_config(case, PIRConfig)
    db = pir.make_database(np.random.default_rng(case["db_seed"]),
                           cfg.n_items, cfg.item_bytes)
    for i, (d, m) in enumerate(case["meshes"]):
        rng = np.random.default_rng(case["key_seed"])
        common = dict(client_rng=rng, max_wait_s=case["max_wait_s"],
                      n_clusters=case.get("n_clusters", 1), path="baseline")
        if case["facade"] == "batch":
            system = BatchPIR(db, cfg, _mesh((d, m)),
                              rounds=tuple(case["rounds"][i]), **common)
        else:
            chaos = None
            if case.get("chaos"):
                seed, events = case["chaos"]
                chaos = ChaosInjector(FaultPlan(seed, tuple(
                    FaultEvent(seam, action, at=at)
                    for seam, action, at in events)))
            cls = SingleServerPIR if case["facade"] == "single" \
                else MultiServerPIR
            system = cls(db, cfg, _mesh((d, m)),
                         n_queries=case["n_queries"], chaos=chaos, **common)
        res = play_session(system, case)
        if case["facade"] == "single":
            st = system.db.stats
            res["hint_stats"] = [st.n_hint_builds, st.n_hint_deltas,
                                 system.hint_fetches]
        if case["facade"] == "batch":
            res["dispatch_log"] = [list(r) for r in system.dispatch_log]
        res["epoch"] = int(system.epoch)
        out[f"{case['name']}/{d}x{m}"] = np.asarray(json.dumps(res))


RUNNERS = {"serve": run_serve, "allreduce": run_allreduce,
           "mesh": run_mesh, "report": run_report,
           "placement": run_placement, "hint": run_hint,
           "single": run_single,
           "batch": run_batch, "session": run_session}


def main(argv):
    spec_path, out_path = argv
    with open(spec_path) as f:
        cases = json.load(f)
    out = {}
    for case in cases:
        RUNNERS[case["kind"]](case, out)
    np.savez(out_path, **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
