"""Port parity: the protocol plane, plans and configs (repro_torch vs repro).

``XorDpf2.answer_local`` runs under each of the port's plans and must equal
the reference protocol under the matching plan (the Pallas bodies in
interpret mode). On the CPU the port's ``cuda`` scans take the kernels'
plain versions.
"""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp

from repro.config import PIRConfig as RefPIRConfig
from repro.configs import pir as ref_configs
from repro.core import dpf as ref_dpf
from repro.core import protocol as ref_protocol
from repro.engine.tuner import heuristic_plan
from repro_torch import convert
from repro_torch.config import PIRConfig
from repro_torch.configs import pir as configs
from repro_torch.core import protocol
from repro_torch.kernels import ops

LOG_N = 8
IDXS = [3, 200, 255]
CHUNK_LOG = 4
TILE_R = 16

#: port plan -> the reference plan it must agree with
PLAN_PAIRS = {
    ("materialize", "torch"): ("materialize", "jnp"),
    ("materialize", "cuda"): ("materialize", "pallas"),
    ("fused", "torch"): ("fused", "jnp"),
    ("fused-cuda", "cuda"): ("fused-pallas", "pallas"),
}


def _u(t):
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    db = rng.integers(0, 1 << 32, size=(1 << LOG_N, 8), dtype=np.uint32)
    pairs = [ref_dpf.gen_keys(rng, i, LOG_N) for i in IDXS]
    ref_keys = [ref_dpf.stack_keys([k[p] for k in pairs]) for p in (0, 1)]
    port_keys = [convert.keys_from_reference(
        party=k.party, log_n=k.log_n, root_seed=np.asarray(k.root_seed),
        cw_seed=np.asarray(k.cw_seed), cw_t=np.asarray(k.cw_t),
        rounds=k.rounds) for k in ref_keys]
    return db, ref_keys, port_keys


def _answers(db, ref_keys, port_keys, expand, scan, start_block=0,
             log_local=LOG_N):
    ref_plan = ref_protocol.ExecutionPlan(
        *PLAN_PAIRS[(expand, scan)], chunk_log=CHUNK_LOG, tile_r=TILE_R)
    plan = protocol.ExecutionPlan(expand, scan, chunk_log=CHUNK_LOG,
                                  tile_r=TILE_R)
    ref_proto = ref_protocol.get("xor-dpf-2")
    proto = protocol.get("xor-dpf-2")
    want = [np.asarray(ref_proto.answer_local(jnp.asarray(db), k, start_block,
                                              log_local, ref_plan))
            for k in ref_keys]
    got = [_u(proto.answer_local(convert.database_from_reference(db), k,
                                 start_block, log_local, plan))
           for k in port_keys]
    return got, want


@pytest.mark.parametrize("expand,scan", sorted(PLAN_PAIRS))
def test_answer_local_matches_reference(setup, expand, scan):
    db, ref_keys, port_keys = setup
    got, want = _answers(db, ref_keys, port_keys, expand, scan)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0] ^ got[1], db[IDXS])


def test_fused_cuda_shard_matches_reference(setup):
    """A shard with start_block != 0 under the fused kernel's plan."""
    db, ref_keys, port_keys = setup
    log_local = LOG_N - 2
    blk = 2
    shard = db[blk << log_local:(blk + 1) << log_local]
    got, want = _answers(shard, ref_keys, port_keys, "fused-cuda", "cuda",
                         start_block=blk, log_local=log_local)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_cuda_plans_route_through_the_kernel_wrappers(setup):
    db, _, port_keys = setup
    proto = protocol.get("xor-dpf-2")
    ops.reset_counts()
    for expand in ("materialize", "fused-cuda"):
        proto.answer_local(convert.database_from_reference(db), port_keys[0],
                           0, LOG_N, protocol.ExecutionPlan(expand, "cuda"))
    assert ops.counts() == {
        "dpxor": {"launches": 0, "plain_calls": 1},
        "fused_scan_xor": {"launches": 0, "plain_calls": 1},
        "pir_gemm": {"launches": 0, "plain_calls": 0},
        "fused_scan_add": {"launches": 0, "plain_calls": 0},
        "lwe_gemm": {"launches": 0, "plain_calls": 0},
        "ggm_expand": {"launches": 0, "plain_calls": 0}}


def test_reconstruct_is_xor(setup):
    db, _, _ = setup
    a = convert.database_from_reference(db[:4])
    b = convert.database_from_reference(db[4:8])
    got = protocol.get("xor-dpf-2").reconstruct([a, b])
    np.testing.assert_array_equal(_u(got), db[:4] ^ db[4:8])


# ---------------------------------------------------------------------------
# Plan selection
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_items,n_queries,want", [
    (1 << 25, 1, "materialize/cuda"),
    (1 << 25, 2, "fused-cuda/cuda"),
    (1 << 25, 32, "fused-cuda/cuda"),
    (1 << 12, 32, "materialize/cuda"),
    (1 << 13, 8, "fused-cuda/cuda"),
])
def test_plan_for_cuda_rules(n_items, n_queries, want):
    cfg = PIRConfig(n_items=n_items)
    assert protocol.plan_for(cfg, n_queries, backend="cuda").name == want


@pytest.mark.parametrize("n_items,n_queries", [
    (1 << 25, 1), (1 << 25, 4), (1 << 12, 4), (1 << 14, 2)])
def test_plan_for_cpu_follows_reference_heuristic(n_items, n_queries):
    want = heuristic_plan(RefPIRConfig(n_items=n_items), n_queries,
                          backend="cpu")
    got = protocol.plan_for(PIRConfig(n_items=n_items), n_queries,
                            backend="cpu")
    assert (got.expand, got.scan) == (want.expand, "torch")
    assert want.scan == "jnp"


def test_plan_for_rejects_unknown_backend_and_protocol():
    with pytest.raises(ValueError):
        protocol.plan_for(configs.PIR_SMOKE, 4, backend="tpu")
    with pytest.raises(KeyError):
        protocol.plan_for(PIRConfig(n_items=64, protocol="nonsense-1"),
                          4, backend="cuda")


def test_resolve_plan_paths():
    cfg = configs.PIR_1G
    auto = protocol.resolve_plan(None, cfg, 8, backend="cuda")
    assert auto.name == "fused-cuda/cuda" and auto.provenance == "heuristic"
    forced = protocol.resolve_plan("cuda", cfg, 8, backend="cuda",
                                   chunk_log=9)
    assert forced.name == "materialize/cuda"
    assert forced.provenance == "forced" and forced.chunk_log == 9
    assert forced == protocol.resolve_plan("cuda", cfg, 8, backend="cpu",
                                           chunk_log=9)
    with pytest.raises(ValueError, match="unknown path"):
        protocol.resolve_plan("fused-pallas", cfg, 8, backend="cuda")


# ---------------------------------------------------------------------------
# Config and registry
# ---------------------------------------------------------------------------

def test_pir_config_fields_match_reference():
    ref_fields = {f.name: f.default for f in dataclasses.fields(RefPIRConfig)}
    fields = {f.name: f.default for f in dataclasses.fields(PIRConfig)}
    assert fields == ref_fields


#: port configs the reference does not have: (its source point, the cut)
PORT_CUTS = {"pir-128m-lwe": ("pir-1g-lwe", {"n_items": 1 << 22})}


@pytest.mark.parametrize("name", sorted(configs.PIR_CONFIGS))
def test_config_points_match_reference(name):
    """One spec builds both sides: the same field values (a port-only
    point equals its reference source point with only the stated cut)."""
    if name in PORT_CUTS:
        source, cut = PORT_CUTS[name]
        ref_cfg = dataclasses.replace(ref_configs.PIR_CONFIGS[source], **cut)
    else:
        ref_cfg = ref_configs.PIR_CONFIGS[name]
    assert configs.PIR_CONFIGS[name].to_dict() == ref_cfg.to_dict()
    port_cfg = PIRConfig(**ref_cfg.to_dict())
    assert port_cfg.log_n == ref_cfg.log_n
    assert port_cfg.share_kind == ref_cfg.share_kind


def test_config_rejects_deprecated_mode():
    with pytest.raises(ValueError, match="protocol="):
        PIRConfig(n_items=64, mode="xor")


def test_registry():
    assert protocol.get("xor-dpf-2").name == "xor-dpf-2"
    assert protocol.for_config(configs.PIR_SMOKE).n_parties(
        configs.PIR_SMOKE) == 2
    assert protocol.get("lwe-simple-1").name == "lwe-simple-1"
    with pytest.raises(KeyError):
        protocol.get("nonsense-1")
    assert PIRConfig(n_items=64, protocol="lwe-simple-1").share_kind == "lwe"
