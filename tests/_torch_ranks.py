"""Four ``gloo`` ranks of the port on the CPU, and the reference beside them.

The sharded tests (``tests/test_torch_mesh.py``,
``tests/test_torch_sharded_*.py``) start, once per module:

  * ``WORLD`` processes of this file, one per rank, each joining one
    process group through a file under the module's temporary directory
    (``init_method="file://..."``: no TCP port, so concurrent test workers
    never collide); each runs one scenario below with ``device="cpu"`` and
    writes its results to ``rank{r}.pt`` there;
  * one process of ``tests/_ref_sharded.py`` with four XLA CPU devices,
    which writes the reference's answers to an ``.npz``.

Both start together. ``run_ranks`` returns the ranks' results in rank
order and the reference's arrays. As a script:

    python tests/_torch_ranks.py SCENARIO RANK WORLD TMPDIR SPEC.json
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
TIMEOUT_S = 240

#: the mesh shapes of four ranks, and the port's paths on the CPU (the
#: kernels' paths take their plain versions there)
MESHES = ((1, 4), (2, 2), (4, 1))
PATHS = ("baseline", "fused", "cuda", "fused-cuda")
#: queries at 2^10 rows: 4 indices, one in each block of four, padded
#: to a bucket of 8 that splits over 1, 2 or 4 clusters
N_ITEMS = 1 << 10
INDICES = [5, 300, 700, 1023]


def serve_case(name: str, protocol: str, meshes, collectives, *,
               single: bool = True, n_servers: int = 3) -> dict:
    """One serve case, read by both sides: the port's ranks run every
    path, the reference its baseline (``single``: also on one device)."""
    return {"kind": "serve", "name": name, "protocol": protocol,
            "n_servers": n_servers, "n_items": N_ITEMS, "item_bytes": 32,
            "db_seed": 1, "key_seed": 2, "indices": INDICES,
            "n_queries": 8, "meshes": [list(m) for m in meshes],
            "collectives": list(collectives), "paths": list(PATHS),
            "single": single}


def bits(a) -> np.ndarray:
    """An answer as comparable bits (int32 and uint32 words alike)."""
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype in (np.int32, np.uint32) else a


def assert_answers(runs, case: dict, mesh, collective: str, path: str):
    """Every rank's answers of every party on ``mesh`` under
    ``collective`` and ``path`` equal the reference's on that mesh shape,
    its one-device answers where this module ran them, and the port's
    own without a mesh."""
    results, ref = runs
    d, m = mesh
    name = case["name"]
    parties = [k.rsplit("/p", 1)[1] for k in ref.files
               if k.startswith(f"{name}/{d}x{m}/{collective}/p")]
    assert parties
    for r, res in enumerate(results):
        for p in parties:
            got = bits(res[f"{name}/{d}x{m}/{collective}/{path}/p{p}"])
            want = bits(ref[f"{name}/{d}x{m}/{collective}/p{p}"])
            assert got.shape == want.shape == (len(INDICES),) + got.shape[1:]
            assert np.array_equal(got, want), (r, p)
            if case["single"]:
                assert np.array_equal(got, bits(ref[f"{name}/single/p{p}"]))
            assert np.array_equal(got, bits(res[f"{name}/single/{path}/"
                                                f"p{p}"]))
        assert res[f"{name}/{d}x{m}/{collective}/{path}/start"] == r % m


def _env(extra=None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (str(ROOT / "src"), env.get("PYTHONPATH")) if p)
    env.update(extra or {})
    return env


def run_ranks(scenario: str, spec, tmp, *, ref_spec=None):
    """Start the ranks of ``scenario`` on ``spec`` (and the reference on
    ``ref_spec``), wait for all, and return ``(results, reference)``: a
    list of each rank's dict, and the reference's ``np.load`` (or None).
    A process that fails raises with its output."""
    tmp = Path(tmp)
    spec_path = tmp / "spec.json"
    spec_path.write_text(json.dumps(spec))
    env = _env({"OMP_NUM_THREADS": "1", "REPRO_TORCH_PLAN_CACHE": "off"})
    procs = [subprocess.Popen(
        [sys.executable, __file__, scenario, str(r), str(WORLD), str(tmp),
         str(spec_path)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(WORLD)]
    ref = None
    if ref_spec is not None:
        ref_path = tmp / "ref_spec.json"
        ref_path.write_text(json.dumps(ref_spec))
        ref = subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_ref_sharded.py"),
             str(ref_path), str(tmp / "ref.npz")], cwd=ROOT,
            env=_env({"XLA_FLAGS": "--xla_force_host_platform_device_count=4",
                      "JAX_PLATFORMS": "cpu"}),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    failed = []
    try:
        for name, proc in [(f"rank {r}", p) for r, p in enumerate(procs)] \
                + ([("reference", ref)] if ref is not None else []):
            out, _ = proc.communicate(timeout=TIMEOUT_S)
            if proc.returncode != 0:
                failed.append(f"{name} exited {proc.returncode}:\n"
                              f"{out[-6000:]}")
    finally:
        for proc in procs + ([ref] if ref is not None else []):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise AssertionError("\n".join(failed))
    import torch
    results = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
               for r in range(WORLD)]
    return results, (np.load(tmp / "ref.npz") if ref is not None else None)


# ---------------------------------------------------------------------------
# The ranks' scenarios (run in the rank processes)
# ---------------------------------------------------------------------------

_MESHES: dict = {}


def _mesh(shape, axes=("data", "model")):
    """One mesh per shape and axes in a rank: building one makes process
    groups, a collective of every rank."""
    from repro_torch.config import MeshConfig
    from repro_torch.launch.mesh import make_mesh
    key = (tuple(shape), tuple(axes))
    if key not in _MESHES:
        _MESHES[key] = make_mesh(MeshConfig(shape=tuple(shape),
                                            axes=tuple(axes)), device="cpu")
    return _MESHES[key]


def _cfg(case):
    from repro_torch.config import PIRConfig
    return PIRConfig(n_items=case["n_items"], item_bytes=case["item_bytes"],
                     protocol=case["protocol"],
                     n_servers=case.get("n_servers", 2))


def mesh_row(mesh) -> dict:
    from repro_torch.launch import mesh as mesh_mod
    return {"shape": dict(mesh.shape), "axis_names": list(mesh.axis_names),
            "size": {a: mesh_mod.mesh_axis_size(mesh, a)
                     for a in ("pod", "data", "model", "expert")},
            "batch_axes": list(mesh_mod.batch_axes(mesh)),
            "pir_cluster_axes": list(mesh_mod.pir_cluster_axes(mesh)),
            "pir_shard_axis": mesh_mod.pir_shard_axis(mesh)}


def scenario_mesh(spec) -> dict:
    """The mesh helpers on ``MeshConfig`` shapes and local clips, each
    rank's coordinates, and the XOR all-reduces on seeded partials."""
    import torch
    from repro_torch.core.protocol import (xor_allreduce_butterfly,
                                           xor_allreduce_gather)
    from repro_torch.launch.mesh import make_local_mesh
    out = {"meshes": [], "coords": [], "devices": []}
    for shape, axes in spec["configs"]:
        mesh = _mesh(shape, axes)
        out["meshes"].append(mesh_row(mesh))
        out["coords"].append(mesh.coords)
        out["devices"].append(str(mesh.device))
    for data, model in spec["local"]:
        mesh = make_local_mesh(data, model, device="cpu")
        out["meshes"].append(mesh_row(mesh))
        out["coords"].append(mesh.coords if mesh.contains_rank else None)
        out["devices"].append(str(mesh.device))
    for case in spec["allreduce"]:
        d, m = case["mesh"]
        mesh = _mesh((d, m))
        parts = np.random.default_rng(case["seed"]).integers(
            0, 2 ** 32, size=(d, m) + tuple(case["shape"]),
            dtype=np.uint64).astype(np.uint32)
        c, s = mesh.coord("data"), mesh.coord("model")
        mine = torch.from_numpy(parts[c, s].view(np.int32).copy())
        group = mesh.group("model")
        got = {"gather": xor_allreduce_gather(mine, group),
               "butterfly": xor_allreduce_butterfly(mine, group, m)}
        for coll, t in got.items():
            out[f"{case['name']}/{coll}"] = t.numpy().view(np.uint32)
        out[f"{case['name']}/coord"] = (c, s)
        out[f"{case['name']}/unchanged"] = bool(torch.equal(
            mine, torch.from_numpy(parts[c, s].view(np.int32))))
    return out


def port_keys(case, cfg):
    """Every party's batched keys, drawn as ``_ref_sharded.keys_for``
    draws the reference's."""
    import torch
    from repro_torch.core import lwe, protocol as protocol_mod
    proto = protocol_mod.for_config(cfg)
    rng = np.random.default_rng(case["key_seed"])
    idx = case["indices"]
    if proto.share_kind == "lwe":
        ct = rng.integers(-2 ** 31, 2 ** 31, size=(len(idx), cfg.n_items),
                          dtype=np.int64).astype(np.int32)
        return (lwe.LWECiphertext(ct=torch.from_numpy(ct), log_n=cfg.log_n,
                                  n=lwe.params_for(cfg.n_items).n),)
    return proto.query_gen_batch(rng, idx, cfg)


def scenario_serve(spec) -> dict:
    """``PIRServer.answer`` of every party on each case's meshes,
    collectives and paths, and on no mesh; each mesh's placement; the
    plan reports; the int32 reduce past 2^31; the bucket refusal."""
    import torch
    from repro_torch.core import pir, protocol as protocol_mod
    from repro_torch.core.server import BucketedServeFns, PIRServer
    from repro_torch.db import Database
    out = {}
    for case in spec.get("cases", ()):
        cfg = _cfg(case)
        db = pir.make_database(np.random.default_rng(case["db_seed"]),
                               cfg.n_items, cfg.item_bytes)
        keys = port_keys(case, cfg)
        q = case.get("n_queries", len(case["indices"]))
        for path in case["paths"]:
            for party, k in enumerate(keys):
                server = PIRServer(party, db, cfg, device="cpu",
                                   n_queries=q, path=path)
                out[f"{case['name']}/single/{path}/p{party}"] = \
                    _host(server.answer(k))
        for d, m in case["meshes"]:
            mesh = _mesh((d, m))
            database = Database(db, cfg, mesh=mesh)
            out[f"{case['name']}/{d}x{m}/rows"] = database.rows
            for coll in case["collectives"]:
                for path in case["paths"]:
                    for party, k in enumerate(keys):
                        server = PIRServer(
                            party, database=database, cfg=cfg, mesh=mesh,
                            n_queries=q, path=path, collective=coll)
                        out[f"{case['name']}/{d}x{m}/{coll}/{path}/"
                            f"p{party}"] = _host(server.answer(k))
                        out[f"{case['name']}/{d}x{m}/{coll}/{path}/start"] = \
                            server.bucketed.shard_index
    for case in spec.get("reports", ()):
        cfg = _cfg(case)
        for d, m in case["meshes"]:
            fns = BucketedServeFns(cfg, buckets=case["buckets"],
                                   backend="cpu", path=case["path"],
                                   mesh=_mesh((d, m)))
            out[f"{case['name']}/{d}x{m}"] = {
                b: {k: r[k] for k in ("plan", "label", "provenance",
                                      "predicted_step_bytes")}
                for b, r in fns.plan_report().items()}
    if "wrap" in spec:
        # int32 partials whose sum over the four shards passes 2^31
        mesh = _mesh((1, 4))
        rank = mesh.coord("model")
        vals = np.asarray(spec["wrap"], np.int64)[:, rank]
        mine = torch.from_numpy(vals.astype(np.int32)).reshape(1, -1)
        plan = protocol_mod.ExecutionPlan()
        for name in ("additive-dpf-2", "lwe-simple-1"):
            got = protocol_mod.get(name).reduce(mine, mesh.group("model"), 4,
                                                plan)
            out[f"wrap/{name}"] = got.numpy()
    if "bucket_refusal" in spec:
        cfg = _cfg(spec["bucket_refusal"])
        db = pir.make_database(np.random.default_rng(0), cfg.n_items,
                               cfg.item_bytes)
        database = Database(db, cfg, mesh=_mesh((2, 2)))
        refusals = {
            "bucket": lambda: BucketedServeFns(
                cfg, buckets=(2, 3), backend="cpu", mesh=_mesh((2, 2))),
            "other_mesh": lambda: PIRServer(
                0, database=database, cfg=cfg, mesh=_mesh((1, 4))),
            "no_mesh": lambda: PIRServer(0, database=database, cfg=cfg),
            "views": lambda: PIRServer(
                0, database=database, cfg=cfg, mesh=_mesh((2, 2))
            ).bucketed.answer_views([database.view()], port_keys(
                spec["bucket_refusal"], cfg)[0])}
        for what, fn in refusals.items():
            try:
                fn()
                out[f"refused/{what}"] = None
            except (ValueError, NotImplementedError) as e:
                out[f"refused/{what}"] = f"{type(e).__name__}: {e}"
        case = spec["bucket_refusal"]
        keys = port_keys(case, cfg)[0]
        db = pir.make_database(np.random.default_rng(case["db_seed"]),
                               cfg.n_items, cfg.item_bytes)
        for d, m in MESHES:
            database = Database(db, cfg, mesh=_mesh((d, m)))
            out[f"views/{d}x{m}"] = _host(PIRServer(
                0, database=database, cfg=cfg, mesh=_mesh((d, m)),
                n_queries=8, path="baseline").bucketed.answer_views(
                    [database.view()] * 2, keys))
    return out


def _host(t):
    import torch
    if t.dtype == torch.int32:
        return t.numpy().view(np.uint32).copy()
    return t.numpy().copy()


def scenario_db(spec) -> dict:
    """``Database`` on each mesh: its block, the views, the placement, a
    staged delta over every block published in lockstep, a hint summed
    over the blocks, a checksummed and a tensor-fed placement."""
    import torch
    from dataclasses import replace
    from repro_torch.core import pir
    from repro_torch.db import Database
    cfg = _cfg(spec)
    db = pir.make_database(np.random.default_rng(spec["db_seed"]),
                           cfg.n_items, cfg.item_bytes)
    out = {}
    for d, m in spec["meshes"]:
        tag = f"{d}x{m}"
        mesh = _mesh((d, m))
        database = Database(db, cfg, mesh=mesh)
        words, raw = database.view("words"), database.view("bytes")
        out[f"{tag}/rows"] = database.rows
        out[f"{tag}/words"] = _host(words)
        out[f"{tag}/bytes"] = raw.numpy().copy()
        out[f"{tag}/bytes_alias"] = (
            raw.untyped_storage().data_ptr()
            == words.untyped_storage().data_ptr())
        out[f"{tag}/resident_bytes"] = database.resident_bytes
        out[f"{tag}/sharding"] = {v: vars(database.sharding(v))
                                  for v in ("words", "bytes")}
        try:
            database.sharding("nope")
        except KeyError as e:
            out[f"{tag}/sharding_unknown"] = str(e)
        heard = []
        database.subscribe(lambda delta: heard.append(
            (delta.epoch, delta.rows.tolist())))
        for step, (rows, seed) in enumerate(spec["updates"]):
            vals = np.random.default_rng(seed).integers(
                0, 2 ** 32, size=(len(rows), cfg.item_bytes // 4),
                dtype=np.uint64).astype(np.uint32)
            database.stage(rows, vals)
            out[f"{tag}/epoch{step}"] = database.publish()
            out[f"{tag}/words{step}"] = _host(database.view("words"))
            out[f"{tag}/retired{step}"] = _host(
                database.view("words", epoch=out[f"{tag}/epoch{step}"] - 1))
        out[f"{tag}/noop_epoch"] = database.publish()
        out[f"{tag}/heard"] = heard
        out[f"{tag}/published"] = [(p.epoch, p.rows.tolist(), p.n_staged)
                                   for p in database.published]
        # the sum of the words: additive over the blocks, so on a mesh each
        # rank sums its block (row0 unused) and the partials are summed
        database.register_hint("h", lambda w, row0=0: w.sum())
        out[f"{tag}/hint"] = int(database.hint("h"))
        chk = Database(db, replace(cfg, checksum=True), mesh=mesh)
        out[f"{tag}/chk_words"] = _host(chk.view("words"))
        full = torch.from_numpy(db.view(np.int32).copy())
        out[f"{tag}/from_tensor"] = _host(
            Database(full, cfg, mesh=mesh).view("words"))
    return out


def scenario_facade(spec) -> dict:
    """``TwoServerPIR`` / ``MultiServerPIR`` on each mesh, the client rng
    seeded on rank 0 only; what needs one controller served by rank 0 in a
    session and refused by the others."""
    import torch.distributed as dist
    from dataclasses import replace
    from repro_torch.chaos import ChaosInjector, FaultPlan
    from repro_torch.core import pir
    from repro_torch.runtime.serve_loop import (MultiServerPIR,
                                                SingleServerPIR, TwoServerPIR)
    cfg = _cfg(spec)
    db = pir.make_database(np.random.default_rng(spec["db_seed"]),
                           cfg.n_items, cfg.item_bytes)
    rank = dist.get_rank()
    out = {}
    facades = {"xor-dpf-2": TwoServerPIR, "additive-dpf-2": TwoServerPIR,
               "xor-dpf-k": MultiServerPIR}
    for d, m in spec["meshes"]:
        mesh = _mesh((d, m))
        for name, cls in facades.items():
            tag = f"{d}x{m}/{name}"
            # an unseeded rng on every rank but the first: the broadcast
            # of rank 0's keys must make it harmless
            rng = np.random.default_rng(spec["key_seed"]) if rank == 0 \
                else None
            system = cls(db, replace(cfg, protocol=name, n_servers=3),
                         mesh=mesh, client_rng=rng, n_queries=8,
                         path=spec.get("path"))
            out[f"{tag}/q0"] = system.query(spec["indices"])
            out[f"{tag}/q1"] = system.query(spec["indices"][:3])
            rows = spec["update_rows"]
            vals = np.random.default_rng(spec["update_seed"]).integers(
                0, 2 ** 32, size=(len(rows), cfg.item_bytes // 4),
                dtype=np.uint64).astype(np.uint32)
            system.update(rows, vals)
            out[f"{tag}/epoch"] = system.publish()
            out[f"{tag}/q2"] = system.query(rows)
            out[f"{tag}/q3"] = system.query(spec["indices"])
    mesh = _mesh((2, 2))
    lwe_cfg = replace(cfg, protocol="lwe-simple-1", n_servers=1)
    seeded = lambda: np.random.default_rng(spec["key_seed"]) \
        if rank == 0 else None
    two = lambda **kw: TwoServerPIR(db, cfg, mesh=mesh, client_rng=seeded(),
                                    n_queries=4, **kw)
    builds = {"session": two, "submit": two,
              "lanes": lambda: two(n_clusters=2),
              "chaos": lambda: two(chaos=ChaosInjector(FaultPlan(0))),
              "single": lambda: SingleServerPIR(
                  db, lwe_cfg, mesh=mesh, client_rng=seeded(), n_queries=4)}
    idx = spec["indices"][:4]
    for what, build in builds.items():
        # what needs one controller: rank 0 serves it in a session, the
        # others refuse the client call by name
        system = build()
        system.start()
        call = "query" if what == "session" else "submit"
        if rank == 0:
            out[f"served/{what}"] = (
                system.query(idx) if what == "session" else
                np.stack([system.submit(i).result() for i in idx]))
        else:
            try:
                getattr(system, call)(idx if call == "query" else idx[0])
                out[f"refused/{what}"] = None
            except ValueError as e:
                out[f"refused/{what}"] = str(e)
        system.close()
        if what == "chaos":
            out["chaos_visits"] = sum(system.scheduler.chaos._counts.values())
    single = SingleServerPIR(
        db, lwe_cfg, mesh=mesh, n_queries=8, client_rng=np.random.default_rng(
            spec["key_seed"]) if rank == 0 else None)
    out["single/q0"] = single.query(spec["indices"])
    return out


def _counting(obj, name: str, counter: list):
    """Wrap ``obj.name`` so that each call appends to ``counter``; returns
    the original, for the caller to put back."""
    orig = getattr(obj, name)

    def wrapped(*args, **kwargs):
        counter.append(name)
        return orig(*args, **kwargs)
    setattr(obj, name, wrapped)
    return orig


def _update_vals(cfg, rows, seed) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, size=(len(rows), cfg.item_bytes // 4),
        dtype=np.uint64).astype(np.uint32)


def session_vals(item_bytes: int, rows, seed) -> np.ndarray:
    """The values a session script's publish writes (both packages)."""
    return np.random.default_rng(seed).integers(
        0, 2 ** 32, size=(len(rows), item_bytes // 4),
        dtype=np.uint64).astype(np.uint32)


def _outcome(fut, timeout: float) -> dict:
    """One resolved future as plain data: its record, or its error's type,
    message and ``bad_queries``; and its epoch."""
    try:
        rec = np.asarray(fut.result(timeout=timeout)).tolist()
        err = bad = None
    except Exception as e:   # noqa: BLE001 - the error is the outcome
        rec, err = None, f"{type(e).__name__}: {e}"
        bad = list(getattr(e, "bad_queries", ()))
    return {"record": rec, "epoch": fut.epoch, "error": err, "bad": bad}


def play_session(system, case: dict, *, controller: bool = True,
                 timeout: float = 120.0, extra=None) -> dict:
    """Run a session script (``case["steps"]``) on a facade of either
    package, the same way on both: ``start`` / ``close`` on every rank, the
    rest on the controller only (the reference has no other):

      ["submit", [i, ...]]         one ``submit`` per index
      ["submit_batch", [i, ...]]   one round (``BatchPIR``; a refused one
                                   is kept in ``submit_errors``)
      ["wait"]                     resolve every future submitted since the
                                   last wait: one group of outcomes
      ["publish", rows, seed]      ``update`` + ``publish``
      ["kill"]                     ``scheduler.kill(RuntimeError("killed"))``

    Any other step goes to ``extra(step, out)`` on every rank. Returns the groups, the published epochs, the scheduler's
    ``bucket_counts``, batches and lanes, and the chaos log."""
    out = {"groups": [], "epochs": []}
    futs = []
    for step in case["steps"]:
        op = step[0]
        if op == "start":
            system.start()
        elif op == "close":
            system.close()
        elif extra is not None and op in extra.ops:
            extra(step, out)
        elif not controller:
            continue
        elif op == "submit":
            futs += [system.submit(int(i)) for i in step[1]]
        elif op == "submit_batch":
            try:
                futs.append(system.submit_batch(step[1]))
            except Exception as e:   # noqa: BLE001 - a refused round
                out.setdefault("submit_errors", []).append(
                    f"{type(e).__name__}: {e}")
        elif op == "wait":
            out["groups"].append([_outcome(f, timeout) for f in futs])
            futs = []
        elif op == "publish":
            rows, seed = step[1], step[2]
            system.update(rows, session_vals(case["item_bytes"], rows, seed))
            out["epochs"].append(int(system.publish()))
        elif op == "kill":
            system.scheduler.kill(RuntimeError("killed"))
        else:
            raise ValueError(f"unknown step {step!r}")
    stats = system.scheduler.stats
    chaos = system.scheduler.chaos
    out.update(
        bucket_counts={str(k): v for k, v in sorted(
            stats.bucket_counts.items())},
        batches=stats.batches,
        lanes=sorted(system.scheduler.monitor.ewma),
        fired=[[f.seam, f.target, f.action, f.visit]
               for f in (chaos.fired if chaos is not None else ())])
    return out


def scenario_hint(spec) -> dict:
    """A ``Database`` on each mesh with the LWE hint registered with its
    delta and without: both at each epoch, summed over the blocks, and the
    counters."""
    from repro_torch.core import lwe, pir, protocol as protocol_mod
    from repro_torch.db import Database
    cfg = _cfg(spec)
    proto = protocol_mod.for_config(cfg)
    db = pir.make_database(np.random.default_rng(spec["db_seed"]),
                           cfg.n_items, cfg.item_bytes)
    out = {}
    for d, m in spec["meshes"]:
        tag = f"{spec['name']}/{d}x{m}"
        lwe.clear_matrix_cache()
        database = Database(db, cfg, mesh=_mesh((d, m)))
        database.register_hint("delta", proto.hint_builder(cfg),
                               proto.hint_delta(cfg))
        database.register_hint("rebuilt", proto.hint_builder(cfg))
        for step, upd in enumerate([None] + spec["updates"]):
            if upd is not None:
                rows, seed = upd
                database.stage(rows, _update_vals(cfg, rows, seed))
                out[f"{tag}/epoch{step}"] = database.publish()
            for name in ("delta", "rebuilt"):
                out[f"{tag}/{name}{step}"] = _host(database.hint(name))
        st = database.stats
        out[f"{tag}/stats"] = [st.n_hint_builds, st.n_hint_deltas]
        out[f"{tag}/a_rows"] = sorted(k[3] for k in lwe._A_CACHE)
    return out


def scenario_single(spec) -> dict:
    """``SingleServerPIR`` on each mesh with the client rng seeded on rank 0
    only: the records, the epochs, the hint after each publish, the hint
    counters, the rows of A each rank drew; a session's submit, served on
    rank 0 and refused elsewhere; a hint on a mesh without a ``model``
    group."""
    import torch
    import torch.distributed as dist
    from repro_torch.core import lwe, pir
    from repro_torch.db import Database
    from repro_torch.launch.mesh import Mesh
    from repro_torch.runtime.serve_loop import SingleServerPIR
    cfg = _cfg(spec)
    db = pir.make_database(np.random.default_rng(spec["db_seed"]),
                           cfg.n_items, cfg.item_bytes)
    rank = dist.get_rank()
    out = {}
    for d, m in spec["meshes"]:
        tag = f"{spec['name']}/{d}x{m}"
        lwe.clear_matrix_cache()
        system = SingleServerPIR(
            db, cfg, mesh=_mesh((d, m)), n_queries=spec["n_queries"],
            client_rng=np.random.default_rng(spec["key_seed"])
            if rank == 0 else None)
        out[f"{tag}/rows"] = system.db.rows
        out[f"{tag}/q0"] = system.query(spec["indices"])
        out[f"{tag}/epoch0"] = system.epoch
        out[f"{tag}/hint0"] = _host(system.db.hint(cfg.protocol))
        for step, (rows, seed) in enumerate(spec["updates"], start=1):
            system.update(rows, _update_vals(cfg, rows, seed))
            out[f"{tag}/epoch{step}"] = system.publish()
            out[f"{tag}/hint{step}"] = _host(system.db.hint(cfg.protocol))
            out[f"{tag}/q{step}"] = system.query(rows + spec["indices"])
        st = system.db.stats
        out[f"{tag}/stats"] = [st.n_hint_builds, st.n_hint_deltas,
                               system.hint_fetches]
        # the row ranges of A this rank holds: its block, or the whole
        # matrix where it encrypted (a block of it is then a view)
        out[f"{tag}/a_rows"] = sorted(k[3] for k in lwe._A_CACHE)
        # a session: rank 0 serves a submit, the others refuse it by name
        system.start()
        if rank == 0:
            out[f"{tag}/served/submit"] = system.submit(
                spec["indices"][0]).result()
        else:
            try:
                system.submit(0)
                out[f"{tag}/refused/submit"] = None
            except ValueError as e:
                out[f"{tag}/refused/submit"] = str(e)
        system.close()
        out[f"{tag}/session"] = ("controller" if system.follower is None
                                 else system.follower.ended_by)
    lwe.clear_matrix_cache()
    bare = Mesh(axis_names=("data", "model"), sizes=(1, 4),
                ranks=(0, 1, 2, 3), rank=rank, device=torch.device("cpu"))
    try:
        Database(db, cfg, mesh=bare).register_hint("h", lambda w, row0=0: w)
        out[f"{spec['name']}/refused/no_group"] = None
    except ValueError as e:
        out[f"{spec['name']}/refused/no_group"] = str(e)
    return out


def scenario_batch(spec) -> dict:
    """``BatchPIR`` on each mesh with its ``rounds`` and the client rng
    seeded on rank 0 only: the records of each batch (one of them halved
    after a failed cuckoo placement), an update over every block, the
    ``dispatch_log``, the epoch, and this rank's calls of ``plan_round``,
    of the protocol's ``reduce`` and of ``combine``; the refusals of
    buckets; a session's submit and two lanes, served on rank 0 and refused
    elsewhere."""
    import torch.distributed as dist
    from repro_torch.config import PIRConfig
    from repro_torch.core import pir, protocol as protocol_mod
    from repro_torch.core.server import BucketedServeFns
    from repro_torch.runtime import batch as runtime_batch
    from repro_torch.runtime.batch import BatchPIR
    rank = dist.get_rank()
    out = {}
    for case in spec["cases"]:
        cfg = PIRConfig(n_items=case["n_items"],
                        item_bytes=case["item_bytes"],
                        protocol=case["protocol"], batch_m=case["batch_m"],
                        batch_queries=1, checksum=case["checksum"])
        db = pir.make_database(np.random.default_rng(case["db_seed"]),
                               cfg.n_items, cfg.item_bytes)
        proto = protocol_mod.for_config(cfg)
        for (d, m), rounds in case["meshes"]:
            tag = f"{case['name']}/{d}x{m}"
            calls: list = []
            undo = [(runtime_batch, "plan_round", _counting(
                        runtime_batch, "plan_round", calls)),
                    (BucketedServeFns, "combine", _counting(
                        BucketedServeFns, "combine", calls))]
            _counting(proto, "reduce", calls)     # undone by the del below
            try:
                system = BatchPIR(
                    db, cfg, mesh=_mesh((d, m)), rounds=tuple(rounds),
                    path=case.get("path"),
                    client_rng=np.random.default_rng(case["key_seed"])
                    if rank == 0 else None)
                for step, idx in enumerate(case["queries"]):
                    out[f"{tag}/q{step}"] = system.query_batch(idx)
                rows = case["update_rows"]
                system.update(rows, _update_vals(cfg, rows,
                                                 case["update_seed"]))
                out[f"{tag}/epoch"] = system.publish()
                out[f"{tag}/q_after"] = system.query_batch(rows)
                out[f"{tag}/dispatch_log"] = list(system.dispatch_log)
                out[f"{tag}/rows"] = system.db.buckets[0].rows
                for what in ("plan_round", "combine", "reduce"):
                    out[f"{tag}/calls/{what}"] = calls.count(what)
                system.start()
                if rank == 0:
                    out[f"{tag}/served/submit"] = system.submit(0).result()
                else:
                    try:
                        system.submit(0)
                        out[f"{tag}/refused/submit"] = None
                    except ValueError as e:
                        out[f"{tag}/refused/submit"] = str(e)
                system.close()
            finally:
                for obj, name, orig in undo:
                    setattr(obj, name, orig)
                del proto.reduce
        for (d, m), rounds in case.get("refusals", ()):
            try:
                BatchPIR(db, cfg, mesh=_mesh((d, m)), rounds=tuple(rounds))
                out[f"{case['name']}/refused/{d}x{m}"] = ""
            except ValueError as e:
                out[f"{case['name']}/refused/{d}x{m}"] = f"ValueError: {e}"
        if case.get("lanes"):
            # two lanes on (1, 4): rank 0 submits two rounds in a session
            system = BatchPIR(db, cfg, mesh=_mesh((1, 4)), n_clusters=2,
                              client_rng=np.random.default_rng(
                                  case["key_seed"]) if rank == 0 else None)
            system.start()
            name = case["name"]
            if rank == 0:
                futs = [system.submit_batch(q) for q in case["queries"][::2]]
                out[f"{name}/lanes/served"] = [f.result() for f in futs]
            else:
                try:
                    system.submit_batch(case["queries"][0])
                    out[f"{name}/refused/lanes"] = None
                except ValueError as e:
                    out[f"{name}/refused/lanes"] = str(e)
            system.close()
            out[f"{name}/lanes"] = sorted(system.scheduler.monitor.ewma)
    return out


def session_facade(case, mesh, i: int, rank: int):
    """The port's facade of one session case on ``mesh`` (its ``i``-th),
    built on every rank with the client rng seeded on the controller only:
    a follower draws nothing."""
    from repro_torch.chaos import ChaosInjector, FaultEvent, FaultPlan
    from repro_torch.config import PIRConfig
    from repro_torch.core import pir
    from repro_torch.runtime.batch import BatchPIR
    from repro_torch.runtime.serve_loop import MultiServerPIR, SingleServerPIR
    from _ref_sharded import session_config
    cfg = session_config(case, PIRConfig)
    db = pir.make_database(np.random.default_rng(case["db_seed"]),
                           cfg.n_items, cfg.item_bytes)
    common = dict(mesh=mesh, max_wait_s=case["max_wait_s"],
                  n_clusters=case.get("n_clusters", 1),
                  client_rng=np.random.default_rng(case["key_seed"])
                  if rank == mesh.controller else None)
    if case["facade"] == "batch":
        return BatchPIR(db, cfg, rounds=tuple(case["rounds"][i]), **common)
    chaos = None
    if case.get("chaos"):
        seed, events = case["chaos"]
        chaos = ChaosInjector(FaultPlan(seed, tuple(
            FaultEvent(seam, action, at=at) for seam, action, at in events)))
    cls = SingleServerPIR if case["facade"] == "single" else MultiServerPIR
    return cls(db, cfg, n_queries=case["n_queries"], chaos=chaos, **common)


_REFUSED = {"submit": lambda s: s.submit(0),
            "update": lambda s: s.update([0], np.zeros((1, 8), np.uint32)),
            "publish": lambda s: s.publish(),
            "query": lambda s: s.query([0]),
            "queue_depth": lambda s: s.scheduler.queue_depth,
            "drain_handoff": lambda s: s.scheduler.drain_handoff(),
            "kill": lambda s: s.scheduler.kill(RuntimeError("x"))}


def scenario_session(spec) -> dict:
    """Each session case on each of its meshes: the controller plays the
    script (``play_session``), every rank starts and closes; then every
    rank's epoch, and on a follower the commands its loop ran, what ended
    it, and what its client calls raised during the session."""
    import torch.distributed as dist
    from repro_torch.core import lwe
    from repro_torch.kernels import ops
    rank = dist.get_rank()
    out = {}
    for case in spec["cases"]:
        for i, (d, m) in enumerate(case["meshes"]):
            mesh = _mesh((d, m))
            lwe.clear_matrix_cache()
            system = session_facade(case, mesh, i, rank)
            fail_at = case.get("follower_fails", {}).get(str(rank))
            if fail_at is not None:        # this follower's dispatch raises
                dispatch, calls = system.scheduler._dispatch, []

                def failing(staged, dispatch=dispatch, calls=calls):
                    calls.append(1)
                    if len(calls) > fail_at:
                        raise RuntimeError("follower dispatch failed")
                    return dispatch(staged)
                system.scheduler._dispatch = failing
            ops.reset_counts()
            t0 = time.monotonic()
            res = play_session(system, case, controller=mesh.is_controller,
                               extra=_PortSteps(system, case))
            res["close_s"] = time.monotonic() - t0
            if fail_at is not None:
                # alive, so that the others' collectives fail by the
                # group's timeout and not by a closed connection
                time.sleep(case.get("linger_s", 0.0))
            res["epoch"] = int(system.epoch)
            res["plain_calls"] = sum(v["plain_calls"]
                                     for v in ops.counts().values())
            if case["facade"] == "single":
                st = system.db.stats
                res["hint_stats"] = [st.n_hint_builds, st.n_hint_deltas,
                                     system.hint_fetches]
            if case["facade"] == "batch":
                res["dispatch_log"] = [list(r) for r in system.dispatch_log]
            follower = system.follower
            if follower is not None:
                res["follower"] = {
                    "dispatches": follower.dispatches,
                    "publishes": follower.publishes,
                    "ended_by": follower.ended_by,
                    "exc": None if follower.exc is None
                    else f"{type(follower.exc).__name__}: {follower.exc}",
                    "t_end": follower.t_end}
            channel = system.scheduler.channel
            if channel is not None:
                res["sent"] = dict(channel.sent)
            out[f"{case['name']}/{d}x{m}"] = res
    return out


class _PortSteps:
    """The port-only steps of a session script:

      ["refusals"]              on each follower, every client call during
                                the session (each must raise)
      ["race", indices, rows, seed]
                                on the controller, four client threads
                                submit ``indices`` while a fifth publishes
                                ``rows`` midway: each outcome with its index
      ["beat"]                  on the controller, count the scheduler's
                                heartbeats from here on
      ["hooks"]                 on the controller, ``queue_depth`` and the
                                queries ``drain_handoff`` returns, and the
                                heartbeats counted
    """
    ops = ("refusals", "race", "beat", "hooks")

    def __init__(self, system, case):
        self.system, self.case = system, case

    def __call__(self, step, out):
        system = self.system
        controller = not system.spmd or system.mesh.is_controller
        if step[0] == "refusals" and not controller:
            got = {}
            for what, fn in _REFUSED.items():
                try:
                    fn(system)
                    got[what] = None
                except ValueError as e:
                    got[what] = str(e)
            out["refused"] = got
        elif step[0] == "race" and controller:
            out["race"] = self._race(*step[1:])
        elif step[0] == "beat" and controller:
            self.beats = []
            system.scheduler.heartbeat = lambda: self.beats.append(1)
        elif step[0] == "hooks" and controller:
            depth = system.scheduler.queue_depth
            out["hooks"] = {"queue_depth": depth,
                            "handed_off": len(system.scheduler.drain_handoff()),
                            "beats": len(self.beats)}

    def _race(self, indices, rows, seed):
        import threading
        system, futs, lock = self.system, [], threading.Lock()
        half = threading.Event()

        def client(part):
            for n, i in enumerate(part):
                fut = system.submit(int(i))
                with lock:
                    futs.append((int(i), fut))
                    if len(futs) >= len(indices) // 2:
                        half.set()
                time.sleep(0.002)

        def publisher():
            half.wait()
            system.update(rows, session_vals(self.case["item_bytes"], rows,
                                             seed))
            published.append(system.publish())

        published: list = []
        threads = [threading.Thread(target=client, args=(indices[k::4],))
                   for k in range(4)] + [threading.Thread(target=publisher)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return {"published": published,
                "outcomes": [dict(_outcome(f, 120.0), index=i)
                             for i, f in futs]}


SCENARIOS = {"mesh": scenario_mesh, "serve": scenario_serve,
             "db": scenario_db, "facade": scenario_facade,
             "lwe": lambda spec: {**scenario_hint(spec["hint"]),
                                  **scenario_single(spec["single"])},
             "batch": scenario_batch, "session": scenario_session}


def main(argv) -> int:
    scenario, rank, world, tmp, spec_path = argv
    import torch
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_distributed
    import torch.distributed as dist
    with open(spec_path) as f:
        spec = json.load(f)
    init_distributed(int(rank), int(world), f"file://{tmp}/store",
                     device="cpu", timeout=spec.get("timeout_s"))
    if spec.get("broken"):
        # a scenario that leaves the groups broken: no collective after it,
        # and the process ends as soon as its result is saved
        torch.save(SCENARIOS[scenario](spec), Path(tmp) / f"rank{rank}.pt")
        os._exit(0)
    try:
        result = SCENARIOS[scenario](spec)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, Path(tmp) / f"rank{rank}.pt")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
