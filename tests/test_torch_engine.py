"""Engine-plane tests of the port: heuristic fallback, search space,
feasibility models, plan cache, the tuner and its smoke gate.

Mirrors tests/test_engine.py wherever the port has a counterpart, on the
CPU at 2^6-2^10 rows (the CUDA candidates run their kernels' plain
versions here). Two guarantees carry the plane:
  * every candidate plan answers identically (the tuner can never trade
    correctness for speed);
  * an empty, corrupted or stale plan cache resolves exactly the plans
    ``plan_for`` resolves, so default serving is unchanged.
Every test that reaches the process-wide cache points
``REPRO_TORCH_PLAN_CACHE`` at a temporary file or turns it off.
"""
import json

import numpy as np
import pytest
import torch

from repro.config import PIRConfig as RefConfig
from repro.engine import tuner as ref_tuner
from repro_torch import engine
from repro_torch.config import PIRConfig
from repro_torch.core import protocol as protocol_mod
from repro_torch.core.protocol import ExecutionPlan, plan_for, resolve_plan
from repro_torch.core.server import BucketedServeFns, PIRServer
from repro_torch.engine import cache as cache_mod
from repro_torch.engine import kernels as kernels_mod
from repro_torch.engine import tuner
from repro_torch.engine.cache import PlanCache, device_key, spec_signature
from repro_torch.engine.kernels import ProblemShape
from repro_torch.kernels import build
from repro_torch.runtime.serve_loop import TwoServerPIR

LOG_N = 6
N = 1 << LOG_N
H100 = "cuda:NVIDIA H100 80GB HBM3"

PROTOCOLS = [("xor-dpf-2", 2), ("additive-dpf-2", 2), ("xor-dpf-k", 3),
             ("lwe-simple-1", 1)]


def _cfg(protocol="xor-dpf-2", n_items=N, n_servers=None):
    if n_servers is None:
        n_servers = dict(PROTOCOLS)[protocol]
    return PIRConfig(n_items=n_items, item_bytes=32, protocol=protocol,
                     n_servers=n_servers)


@pytest.fixture
def plan_cache_at(monkeypatch, tmp_path):
    """Point the process-wide cache at a file (or "off"); restore after."""
    def point(value):
        monkeypatch.setenv(cache_mod.CACHE_ENV, value)
        return engine.plan_cache(reload=True)
    point(str(tmp_path / "plans.json"))
    yield point
    monkeypatch.undo()
    engine.plan_cache(reload=True)


# ---------------------------------------------------------------------------
# heuristic fallback == plan_for, and the reference's rule on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("protocol,n_servers", PROTOCOLS)
def test_heuristic_is_plan_for_and_the_reference_rule_on_cpu(
        protocol, n_servers, plan_cache_at):
    plan_cache_at("off")
    to_ref = {"torch": "jnp", "cuda": "pallas"}
    for n_items in (1 << 10, 1 << 14, 1 << 20):
        cfg = _cfg(protocol, n_items, n_servers)
        ref_cfg = RefConfig(n_items=n_items, item_bytes=32,
                            protocol=protocol, n_servers=n_servers)
        for n_q in (1, 4, 32):
            for be in ("cpu", "cuda"):
                got = tuner.heuristic_plan(cfg, n_q, backend=be)
                assert got == plan_for(cfg, n_q, backend=be)
                miss = engine.resolve(cfg, n_q, backend=be)
                assert miss == got and miss.provenance == "heuristic"
            ref = ref_tuner.heuristic_plan(ref_cfg, n_q, backend="cpu")
            got = tuner.heuristic_plan(cfg, n_q, backend="cpu")
            assert (got.expand, to_ref[got.scan], got.chunk_log,
                    got.tile_r) == (ref.expand, ref.scan, ref.chunk_log,
                                    ref.tile_r)


def test_resolve_plan_paths_and_provenance(plan_cache_at):
    cache = plan_cache_at("off")
    cfg = _cfg()
    forced = resolve_plan("fused", cfg, 4, backend="cpu", chunk_log=9)
    assert forced.provenance == "forced" and forced.chunk_log == 9
    add = resolve_plan("cuda", _cfg("additive-dpf-2"), 4, backend="cpu")
    assert add.tile_r == protocol_mod.GEMM_TILE_R_DEFAULT
    assert resolve_plan(None, cfg, 4, backend="cpu").provenance == \
        "heuristic"
    assert cache.path is None
    with pytest.raises(ValueError):
        resolve_plan(None, cfg, 4, backend="tpu")


def test_resolve_plan_returns_a_tuned_hit(tmp_path, plan_cache_at):
    path = str(tmp_path / "tuned.json")
    cfg = _cfg()
    tuned = ExecutionPlan(expand="fused-cuda", scan="cuda", chunk_log=5,
                          tile_r=32, provenance="tuned")
    c = PlanCache(path)
    c.put("cpu", cfg.protocol, spec_signature(cfg), 4, tuned)
    c.save()
    plan_cache_at(path)
    got = resolve_plan(None, cfg, 4, backend="cpu", device="cpu")
    assert got == tuned and got.provenance == "tuned"
    assert resolve_plan("auto", cfg, 4, backend="cpu").provenance == "tuned"
    # other buckets miss, forced paths never read the cache
    assert resolve_plan(None, cfg, 8, backend="cpu").provenance == \
        "heuristic"
    assert resolve_plan("cuda", cfg, 4, backend="cpu").provenance == \
        "forced"


# ---------------------------------------------------------------------------
# search space and feasibility
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("protocol,want", [
    ("xor-dpf-2", {("materialize", "torch"), ("materialize", "cuda"),
                   ("fused", "torch"), ("fused-cuda", "cuda")}),
    ("xor-dpf-k", {("materialize", "torch"), ("materialize", "cuda"),
                   ("fused", "torch"), ("fused-cuda", "cuda")}),
    ("additive-dpf-2", {("materialize", "torch"), ("materialize", "cuda"),
                        ("fused-cuda", "cuda")}),
    ("lwe-simple-1", {("materialize", "torch"), ("materialize", "cuda")}),
])
def test_candidates_cover_every_registered_serve_kernel(protocol, want):
    cfg = _cfg(protocol, 1 << 10)
    plans = engine.candidate_plans(cfg, 2, backend="cpu")
    assert {(p.expand, p.scan) for p in plans} == want
    kind = protocol_mod.get(protocol).share_kind
    assert {kernels_mod.descriptor_for_plan(p, kind).name for p in plans} \
        == {d.name for d in engine.serve_kernels(kind)}
    # on the card only the plans that launch a kernel are candidates
    on_card = engine.candidate_plans(cfg, 2, backend="cuda")
    assert {kernels_mod.descriptor_for_plan(p, kind).name
            for p in on_card} == {d.name for d in engine.serve_kernels(kind)
                                  if d.library is not None}
    assert on_card and all(kernels_mod.launches_kernel(p, kind)
                           for p in on_card)
    for p in plans:
        if p.expand == "fused-cuda":      # legal, canonical, in the stack
            assert p.tile_r == 1 << p.chunk_log
            assert p.chunk_log <= min(cfg.log_n, kernels_mod.FUSED_MAX_CLOG)
        elif kind in ("additive", "lwe"):
            assert p.tile_r == protocol_mod.GEMM_TILE_R_DEFAULT


def test_fused_chunk_spaces_clip_to_the_db():
    shape = ProblemShape(bucket=4, rows=N, item_bytes=32)
    for name in ("xor-fused-torch", "xor-fused-cuda", "gemm-fused-cuda"):
        logs = {p["chunk_log"] for p in engine.get_kernel(name)
                .candidates(shape)}
        assert logs == {LOG_N}, name
    # at 2^25 rows the fused kernels' ladder legalizes to clog 8..12
    big = ProblemShape(bucket=1, rows=1 << 25, item_bytes=32)
    got = engine.get_kernel("xor-fused-cuda").candidates(big)
    assert sorted(p["chunk_log"] for p in got) == [8, 9, 10, 11, 12]


def test_memory_model_matches_the_code_at_pir_1g():
    """106 B per leaf for the bits, 212 B per leaf for the shares; Q = 32
    does not fit a card at 2^25 rows, the chunk roots of fused-cuda do."""
    xor = ExecutionPlan("materialize", "cuda")
    add = ExecutionPlan("materialize", "cuda", tile_r=1024)
    fused = ExecutionPlan("fused-cuda", "cuda", chunk_log=11, tile_r=2048)
    one = ProblemShape(bucket=1, rows=1 << 25, item_bytes=32)
    many = ProblemShape(bucket=32, rows=1 << 25, item_bytes=32)
    assert engine.predicted_peak_bytes(xor, "xor", one) == 106 << 25
    assert engine.predicted_peak_bytes(add, "additive", one) == 212 << 25
    assert engine.predicted_peak_bytes(xor, "xor", many) > 80e9
    assert engine.predicted_peak_bytes(add, "additive", many) > 80e9
    assert engine.predicted_peak_bytes(fused, "xor", many) == \
        32 * (1 << 13) * 212
    # xor-dpf-k expands three trees per query
    k3 = ProblemShape(bucket=1, rows=1 << 25, item_bytes=32, components=3)
    assert engine.predicted_peak_bytes(xor, "xor", k3) == 3 * (106 << 25)


def test_memory_budget_prunes_materialize(monkeypatch):
    cfg = _cfg("xor-dpf-2", 1 << 10)
    budget = 64 << 10                     # 64 KiB of temporaries
    pruned = {}
    plans = engine.candidate_plans(cfg, 4, backend="cpu", mem_budget=budget,
                                   pruned=pruned)
    assert all(p.expand != "materialize" for p in plans)
    assert {p.expand for p in pruned} >= {"materialize"}
    assert all(b > budget for b in pruned.values())
    assert any(p.expand == "fused-cuda" for p in plans)   # never empty
    # the tuner reads the budget off the device: monkeypatched here
    monkeypatch.setattr(kernels_mod, "memory_budget", lambda dev: budget)
    res = engine.tune(cfg, 4, device="cpu", budget=engine.TuneBudget(
        max_candidates=1, warmup=0, iters=1))
    assert {"materialize/torch", "materialize/cuda"} <= set(res.mem_pruned)
    # the heuristic (materialize at 2^10 rows) is measured all the same
    assert res.heuristic.expand == "materialize"
    assert tuner.plan_label(res.heuristic) in res.timings
    assert res.heuristic_peak["predicted"] > budget
    assert res.heuristic_peak["measured"] is None          # no card


def test_no_memory_budget_off_the_card():
    assert engine.memory_budget("cpu") is None


def test_launch_limits_prune_on_registers(monkeypatch):
    desc = engine.get_kernel("ggm-expand")
    shape = ProblemShape(bucket=1, rows=1 << 16, item_bytes=4)
    assert {p["tile"] for p in desc.candidates(shape)} == \
        {128, 256, 512, 1024}
    monkeypatch.setitem(build.RECORDS, "ggm_expand", build.BuildRecord(
        "ggm_expand", "lib", ptxas=["ptxas info    : Used 80 registers"]))
    # 80 registers x 1024 threads > 65,536: the largest block is pruned
    assert {p["tile"] for p in desc.candidates(shape)} == {128, 256, 512}
    assert not engine.get_kernel("xor-fused-cuda").feasible(
        shape, {"chunk_log": 25, "tile_r": 1 << 25})


def test_ggm_descriptor_registered_with_its_space():
    desc = engine.get_kernel("ggm-expand")
    assert not desc.serve and desc.library == "ggm_expand"
    odd = desc.candidates(ProblemShape(bucket=1, rows=1000, item_bytes=4))
    assert {p["tile"] for p in odd} == {125, 250, 500, 1000}
    with pytest.raises(ValueError):
        engine.tune_standalone("xor-fused-cuda", 1 << 10, device="cpu")


def test_host_op_floor_rules_out_the_chunked_plain_path_at_scale():
    cfg = PIRConfig(n_items=1 << 25, item_bytes=32)
    shape = tuner.problem_shape(cfg, 1)
    slow = ExecutionPlan("fused", "torch", chunk_log=12)
    fast = ExecutionPlan("fused-cuda", "cuda", chunk_log=12, tile_r=4096)
    assert tuner._floor_s(slow, "xor", shape, "cuda") > 1.0
    assert tuner._floor_s(fast, "xor", shape, "cuda") < 0.01


def test_labels_name_the_levels_each_chunk_expands():
    heur = ExecutionPlan("fused-cuda", "cuda", chunk_log=12, tile_r=2048)
    assert tuner.plan_label(heur) == "fused-cuda/cuda/cl11"
    shape = ProblemShape(bucket=4, rows=1 << 20, item_bytes=32)
    canon = tuner._canonical(heur, shape, "xor")
    assert (canon.chunk_log, canon.tile_r) == (11, 2048)
    assert tuner.plan_label(canon) == tuner.plan_label(heur)
    fused = tuner._canonical(ExecutionPlan("fused", "cuda", chunk_log=30),
                             shape, "xor")
    assert (fused.scan, fused.chunk_log) == ("torch", 20)
    gemm = tuner._canonical(ExecutionPlan("fused", "cuda"), shape,
                            "additive")
    assert gemm.expand == "materialize"


# ---------------------------------------------------------------------------
# answer parity across the whole search space
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("protocol,n_servers", PROTOCOLS)
def test_every_candidate_plan_answers_identically(protocol, n_servers):
    cfg = _cfg(protocol, 1 << 10, n_servers)
    proto = protocol_mod.get(protocol)
    inputs = tuner.measurement_inputs(cfg, 2, device="cpu", seed=5)
    plans = engine.candidate_plans(cfg, 2, backend="cpu")
    assert len(plans) >= 2
    keys = inputs.keys[0]
    want = proto.answer_local(inputs.db, keys, 0, cfg.log_n,
                              tuner.heuristic_plan(cfg, 2, backend="cpu"))
    for plan in plans:
        got = proto.answer_local(inputs.db, keys, 0, cfg.log_n, plan)
        assert torch.equal(got, want), tuner.plan_label(plan)


# ---------------------------------------------------------------------------
# plan cache
# ---------------------------------------------------------------------------

def test_plan_cache_roundtrip(tmp_path):
    path = str(tmp_path / "sub" / "plans.json")
    cache = PlanCache(path)
    plan = ExecutionPlan(expand="fused-cuda", scan="cuda", chunk_log=10,
                         tile_r=1024, provenance="tuned")
    cfg = _cfg()
    cache.put(H100, cfg.protocol, spec_signature(cfg), 4, plan,
              meta={"tuned_s": 0.001})
    assert cache.save() is not None
    again = PlanCache(path)
    hit = again.get(H100, cfg.protocol, spec_signature(cfg), 4)
    assert hit == plan and hit.provenance == "tuned"
    assert again.get(H100, cfg.protocol, spec_signature(cfg), 8) is None
    assert again.get("cpu", cfg.protocol, spec_signature(cfg), 4) is None
    assert json.loads(open(path).read())["schema"] == cache_mod.SCHEMA_VERSION


@pytest.mark.parametrize("payload", [
    "{not json at all",                                        # corrupted
    json.dumps({"schema": 999, "plans": {}}),                  # stale schema
    json.dumps(["schema", 1]),                                 # not a table
    json.dumps({"schema": 1, "plans": {"k": {"plan": {
        "expand": "materialize", "scan": "torch", "warp": 9}}}}),  # field
    json.dumps({"schema": 1, "plans": {"k": {"plan": {
        "expand": "materialize", "scan": "torch",
        "chunk_log": "12"}}}}),                                # bad value
    json.dumps({"schema": 1, "plans": {"k": {"plan": {
        "scan": "torch"}}}}),                                  # no expand
    json.dumps({"schema": 1, "plans": []}),                    # malformed
])
def test_plan_cache_degrades_to_the_heuristic(tmp_path, payload,
                                               plan_cache_at):
    path = tmp_path / "plans.json"
    path.write_text(payload)
    cache = PlanCache(str(path))                   # must not raise
    assert len(cache) == 0 and cache.load_error is not None
    plan_cache_at(str(path))
    cfg = _cfg()
    got = engine.resolve(cfg, 4, backend="cpu")
    assert got == plan_for(cfg, 4, backend="cpu")
    assert got.provenance == "heuristic"


def test_plan_cache_disabled_via_env(plan_cache_at):
    for value in ("off", "none", "0", "OFF "):
        cache = plan_cache_at(value)
        assert cache_mod.cache_path() is None
        assert cache.path is None and cache.save() is None


def test_default_cache_file_is_the_ports_own(monkeypatch):
    monkeypatch.delenv(cache_mod.CACHE_ENV, raising=False)
    assert cache_mod.cache_path() == "results/plan_cache_torch.json"
    assert cache_mod.CACHE_ENV == "REPRO_TORCH_PLAN_CACHE"


def test_resolve_uses_a_hit_for_its_device_only(tmp_path, plan_cache_at):
    cfg = _cfg()
    tuned = ExecutionPlan(expand="fused-cuda", scan="cuda", chunk_log=5,
                          tile_r=32, provenance="tuned")
    cache = plan_cache_at(str(tmp_path / "p.json"))
    cache.put(H100, cfg.protocol, spec_signature(cfg), 4, tuned)
    # a plan tuned on another card is a miss here
    assert engine.resolve(cfg, 4, backend="cpu").provenance == "heuristic"
    cache.put("cpu", cfg.protocol, spec_signature(cfg), 4, tuned)
    assert engine.resolve(cfg, 4, backend="cpu") == tuned
    assert engine.resolve(cfg, 4, backend="cpu", device="cpu") == tuned
    # "cuda" and "cuda:0" name one card
    assert device_key("cuda") == device_key("cuda:0")
    assert device_key(torch.device("cpu")) == "cpu"


def test_warm_entries_never_displace_tuned_ones(tmp_path, plan_cache_at):
    cfg = _cfg()
    sig = spec_signature(cfg)
    tuned = ExecutionPlan("fused-cuda", "cuda", chunk_log=5, tile_r=32,
                          provenance="tuned")
    warm = ExecutionPlan("materialize", "cuda")
    cache = plan_cache_at(str(tmp_path / "p.json"))
    cache.put("cpu", cfg.protocol, sig, 4, tuned)
    assert not cache.warm_put("cpu", cfg.protocol, sig, 4, warm)
    assert engine.record_plans(cfg, {4: warm, 8: warm}, device="cpu",
                               persist=True) == 1
    assert engine.resolve(cfg, 4, backend="cpu").provenance == "tuned"
    got = engine.resolve(cfg, 8, backend="cpu")
    assert got == warm and got.provenance == "warm"
    assert PlanCache(cache.path).get("cpu", cfg.protocol, sig, 8) == warm


def test_the_card_caches_and_resolves_kernel_plans_only(tmp_path,
                                                         plan_cache_at):
    """Under a cuda key a plan that launches no kernel is refused: put
    raises, and an entry written around it is a miss."""
    cfg = _cfg()
    sig = spec_signature(cfg)
    plain = ExecutionPlan("materialize", "torch", provenance="tuned")
    chunked = ExecutionPlan("fused", "cuda", provenance="tuned")  # plain fold
    kernel = ExecutionPlan("materialize", "cuda", provenance="tuned")
    cache = plan_cache_at(str(tmp_path / "p.json"))
    for key in (H100, "cuda"):
        for bad in (plain, chunked):
            with pytest.raises(ValueError, match="launches no kernel"):
                cache.put(key, cfg.protocol, sig, 4, bad)
            with pytest.raises(ValueError, match="launches no kernel"):
                cache.warm_put(key, cfg.protocol, sig, 4, bad)
    cache.put("cpu", cfg.protocol, sig, 4, plain)          # the CPU's own
    cache.put(H100, cfg.protocol, sig, 8, kernel)
    for key in (H100, "cuda"):
        cache.plans[cache_mod.plan_key(key, cfg.protocol, sig, 4)] = {
            "plan": cache_mod.plan_to_dict(plain), "provenance": "tuned"}
    cache.save()
    again = PlanCache(cache.path)
    assert again.load_error is None
    assert again.get(H100, cfg.protocol, sig, 4) is None
    assert again.get(H100, cfg.protocol, sig, 8) == kernel
    assert again.get("cpu", cfg.protocol, sig, 4) == plain
    # without a card, backend "cuda" keys as "cuda": the plain entry there
    # is a miss, and the heuristic (a kernel plan) is resolved
    engine.plan_cache(reload=True)
    got = engine.resolve(cfg, 4, backend="cuda")
    assert got == plan_for(cfg, 4, backend="cuda")
    assert got.provenance == "heuristic"
    assert engine.resolve(cfg, 4, backend="cpu") == plain


def test_servers_resolve_tuned_plans_and_serve_them(tmp_path, plan_cache_at):
    """A server built with path=None serves the cached plan for its device
    (provenance "tuned"); plan_report's rows name each bucket's plan and
    its provenance."""
    cfg = _cfg("xor-dpf-2", 1 << 8)
    sig = spec_signature(cfg)
    cache = plan_cache_at(str(tmp_path / "p.json"))
    tuned = ExecutionPlan("fused-cuda", "cuda", chunk_log=4, tile_r=16,
                          provenance="tuned")
    cache.put("cpu", cfg.protocol, sig, 2, tuned)
    db = np.random.default_rng(3).integers(0, 1 << 32, size=(1 << 8, 8),
                                           dtype=np.uint32)
    system = TwoServerPIR(db, cfg, device="cpu", n_queries=2,
                          buckets=(1, 2), client_rng=np.random.default_rng(4))
    server = system.servers[0]
    report = server.plan_report()
    assert {b: r["plan"] for b, r in report.items()} == {
        1: "materialize/torch", 2: "fused-cuda/cuda"}
    assert {b: r["provenance"] for b, r in report.items()} == {
        1: "heuristic", 2: "tuned"}
    assert server.bucketed.plan_for_bucket(2).provenance == "tuned"
    assert server.bucketed.plan_for_bucket(1).provenance == "heuristic"
    np.testing.assert_array_equal(system.query([7, 200]), db[[7, 200]])
    fns = BucketedServeFns(cfg, buckets=(2,), backend="cpu", device="cpu")
    assert fns.plan_for_bucket(2) == tuned
    assert isinstance(server, PIRServer) and server.device.type == "cpu"


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------

def test_tiny_budget_tune_is_no_slower_than_the_heuristic(tmp_path):
    cfg = _cfg("xor-dpf-2", 1 << 8)
    cache = PlanCache(str(tmp_path / "plans.json"))
    budget = engine.TuneBudget(max_candidates=1, warmup=1, iters=1,
                               max_seconds=60.0)
    res = engine.tune(cfg, 2, device="cpu", budget=budget, cache=cache)
    assert res.plan.provenance == "tuned"
    assert res.tuned_s <= res.heuristic_s
    assert tuner.plan_label(res.heuristic) in res.timings
    assert res.n_timed == len(res.timings) <= res.n_candidates
    cache.save()
    hit = PlanCache(cache.path).get("cpu", cfg.protocol, spec_signature(cfg),
                                    2)
    assert hit == res.plan


@pytest.mark.parametrize("candidate_runs,wins", [
    ([0.7, 0.7, 0.7], False),        # within the heuristic's spread: noise
    ([0.5, 0.5, 0.5], True),         # faster by more than the spread
])
def test_a_plan_beats_the_heuristic_only_past_its_spread(
        monkeypatch, candidate_runs, wins):
    cfg = _cfg("xor-dpf-2", 1 << 8)
    shape = tuner.problem_shape(cfg, 2)
    heur = tuner._canonical(tuner.heuristic_plan(cfg, 2, backend="cpu"),
                            shape, "xor")

    def fake(proto, plan, db, keys, log_local, budget):
        return [0.8, 1.0, 1.2] if plan == heur else list(candidate_runs)
    monkeypatch.setattr(tuner, "time_plan", fake)
    monkeypatch.setattr(tuner, "_floor_s", lambda *a, **k: 0.0)
    res = engine.tune(cfg, 2, device="cpu", budget=engine.TuneBudget(
        max_candidates=2, warmup=0, iters=3))
    assert res.heuristic_s == 1.0
    assert res.heuristic_spread_s == pytest.approx(0.4)
    assert res.n_timed > 1
    assert (tuner.plan_label(res.plan) != tuner.plan_label(res.heuristic)) \
        == wins
    assert res.tuned_s == (0.5 if wins else 1.0)
    assert res.plan.provenance == "tuned"


def test_a_timed_run_answers_every_party_back_to_back(monkeypatch):
    cfg = _cfg("xor-dpf-k", 1 << 8)                    # three parties
    proto = protocol_mod.get(cfg.protocol)
    inputs = tuner.measurement_inputs(cfg, 2, device="cpu")
    keys = inputs.keys_for(2)
    seen = []
    real = type(proto).answer_local

    def spy(self, db, k, *args):
        seen.append(k)
        return real(self, db, k, *args)
    monkeypatch.setattr(type(proto), "answer_local", spy)
    plan = tuner.heuristic_plan(cfg, 2, backend="cpu")
    runs = tuner.time_plan(proto, plan, inputs.db, keys, cfg.log_n,
                           engine.TuneBudget(warmup=1, iters=2))
    assert len(keys) == 3 and len(runs) == 2
    assert [id(k) for k in seen] == [id(k) for k in keys] * 3


def test_autotune_persists_to_the_configured_file(tmp_path, plan_cache_at):
    path = tmp_path / "auto.json"
    plan_cache_at(str(path))
    cfg = _cfg("additive-dpf-2", 1 << 8)
    res = engine.autotune(cfg, (1, 2), device="cpu",
                          budget=engine.SMOKE_BUDGET)
    assert set(res) == {1, 2} and path.exists()
    fresh = PlanCache(str(path))
    for b, r in res.items():
        assert fresh.get("cpu", cfg.protocol, spec_signature(cfg), b) == \
            r.plan
        assert engine.resolve(cfg, b, backend="cpu").provenance == "tuned"


def test_measurement_inputs_serve_every_bucket_from_one_draw():
    cfg = _cfg("xor-dpf-2", 1 << 8)
    inputs = tuner.measurement_inputs(cfg, 4, device="cpu", seed=0)
    assert inputs.db.shape == (1 << 8, 8)
    assert len(inputs.keys) == len(inputs.keys_for(2)) == 2   # both parties
    for party, keys in enumerate(inputs.keys_for(2)):
        assert keys.root_seed.shape == (2, 4) and keys.party == party
        assert torch.equal(keys.root_seed, inputs.keys[party].root_seed[:2])
    with pytest.raises(ValueError):
        inputs.keys_for(8)


def test_tune_standalone_ggm_expand():
    out = engine.tune_standalone("ggm-expand", 1 << 10, device="cpu",
                                 budget=engine.SMOKE_BUDGET)
    assert out["params"]["tile"] in (128, 256, 512, 1024)
    assert set(out["timings"]) <= {"tile128", "tile256", "tile512",
                                   "tile1024"}
    assert len(out["timings"]) == 2          # the smoke budget's cap


def test_smoke_cli_on_cpu(capsys):
    assert tuner.main(["--smoke", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "heuristic fallback == plan_for" in out
    assert "fused kernel parity ok" in out
    assert tuner.main([]) == 2


def test_predicted_step_bytes_are_sane():
    cfg = PIRConfig(n_items=1 << 14)
    shape = tuner.problem_shape(cfg, 8)
    kernel = ExecutionPlan("fused-cuda", "cuda", chunk_log=10, tile_r=1024)
    plain = ExecutionPlan("fused", "torch", chunk_log=10)
    mat_plain = ExecutionPlan("materialize", "torch")
    mat_kernel = ExecutionPlan("materialize", "cuda")
    b = lambda p: engine.predicted_step_bytes(p, "xor", shape)
    # the fused kernel reads the DB once per batch and keeps bits on-chip
    assert b(kernel) < b(mat_kernel) < b(mat_plain)
    assert b(kernel) < b(plain)
    assert b(kernel) >= (1 << 14) * 32           # at least one DB pass
    row = engine.plan_report(cfg, kernel, 8, backend="cuda",
                             measured_wall_s=1e-3)
    assert row["predicted_step_bytes"] == b(kernel)
    assert row["provenance"] == "heuristic" and row["label"] == \
        "fused-cuda/cuda/cl10"
    assert 0 < row["achieved_frac"] == pytest.approx(
        b(kernel) / 1e-3 / 3.35e12)


@pytest.mark.cuda
def test_fused_xor_kernel_takes_odd_level_slices_on_the_card():
    """A batch of one key sliced at an odd level is contiguous but only
    8-byte aligned; the kernel reads those operands word by word."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run by chip_smoke.py's tune phase)")
    from repro_torch.core import dpf
    from repro_torch.kernels import fused_scan as kf
    keys = dpf.gen_keys_batch(np.random.default_rng(0), [5], 12)[0].to("cuda")
    db = torch.arange((1 << 12) * 8, dtype=torch.int32,
                      device="cuda").reshape(1 << 12, 8)
    roots, t = dpf.eval_roots_batch(keys, 0, 12, 9)
    got = kf.fused_scan_xor(db, roots, t, keys.cw_seed[:, 3:],
                            keys.cw_t[:, 3:], rounds=keys.rounds)
    want = kf.fused_scan_xor_plain(db, roots, t, keys.cw_seed[:, 3:],
                                   keys.cw_t[:, 3:], rounds=keys.rounds)
    assert torch.equal(got, want)
