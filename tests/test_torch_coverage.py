"""The port's coverage of the reference, name by name.

Every public top-level name of every ``src/repro/**/*.py`` module, and
every public method of its top-level classes, is read from the source by
AST (``repro`` is never imported here). Each must either resolve in the
namesake ``repro_torch`` module (``repro/core/pir.py`` ->
``repro_torch.core.pir``; a method is looked up on the class, so an
inherited one counts) or stand in ``NOT_PORTED`` with its reason:

  jax-only   JAX or TPU machinery (pytree hooks, jit / lowering objects,
             HLO parsing, the Pallas entry points, TPU meshes); the note
             names the port's counterpart where there is one
  renamed    the port has it under another name: the note is that dotted
             name, and it must resolve
  a6b        multi-card code, for ROADMAP §A's A6b
  a19        benchmark code, for ROADMAP §A's A19
  deviation  a stated deviation: the note points to ROADMAP §C

A table entry that no longer names a reference name, or names one that
now resolves, fails the test too, so the table holds exactly what is left.
Nothing here builds a kernel or touches CUDA.
"""
import ast
import importlib
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
REF_ROOT = ROOT / "src" / "repro"
REASONS = {"jax-only", "renamed", "a6b", "a19", "deviation"}

_HLO = "HLO text parsing of a compiled XLA module; the port counts ops " \
       "on meta tensors (repro_torch.analysis.op_cost.analyze)"
_PYTREE = "JAX pytree hook; the port's keys are plain dataclasses of tensors"
_U32 = "jnp dtype alias; the port carries u32 words in torch.int32"
_SPECS = "sharding specs (ROADMAP §A, A6b)"

#: reference name (module-qualified) -> (reason, note)
NOT_PORTED = {
    # analysis: the HLO cost model is replaced by the op-level counter
    "repro.analysis.hlo_cost.COLLECTIVES": (
        "jax-only", "HLO collective opcodes; op_cost counts c10d "
                    "collectives by kind"),
    "repro.analysis.hlo_cost.Instr": ("jax-only", _HLO),
    "repro.analysis.hlo_cost.Computation": ("jax-only", _HLO),
    "repro.analysis.hlo_cost.parse_module": ("jax-only", _HLO),
    "repro.analysis.hlo_cost.HloCostAnalyzer": ("jax-only", _HLO),
    "repro.analysis.hlo_cost.HloCostAnalyzer.trip_count": ("jax-only", _HLO),
    "repro.analysis.hlo_cost.HloCostAnalyzer.cost_of": ("jax-only", _HLO),
    "repro.analysis.hlo_cost.HloCostAnalyzer.entry_cost": ("jax-only", _HLO),
    "repro.analysis.hlo_cost.Cost": (
        "renamed", "repro_torch.analysis.op_cost.Cost"),
    "repro.analysis.hlo_cost.Cost.scaled": (
        "jax-only", "scales an HLO while-loop body by its trip count; "
                    "op_cost runs loops in full"),
    "repro.analysis.hlo_cost.analyze": (
        "renamed", "repro_torch.analysis.op_cost.analyze"),
    "repro.analysis.roofline.VMEM_BYTES": (
        "jax-only", "a TPU core's vector memory"),
    "repro.analysis.roofline.parse_collectives": (
        "jax-only", "reads HLO text; repro_torch.analysis.roofline."
                    "collective_stats reads an op_cost.Cost"),
    "repro.analysis.roofline.from_compiled": (
        "renamed", "repro_torch.analysis.roofline.from_cost"),
    "repro.chaos.smoke.main": ("renamed", "repro_torch.chaos.smoke.run"),
    "repro.compat.shard_map": ("jax-only", "a jax.shard_map import shim"),
    "repro.configs.pir.PIR_1G_LWE": (
        "deviation", "ROADMAP §C: A is 128 GiB at 2^25 rows; the port "
                     "measures PIR_128M_LWE (configs/pir.py)"),
    # core
    "repro.core.dpf.U32": ("jax-only", _U32),
    "repro.core.dpf.DPFKey.tree_flatten": ("jax-only", _PYTREE),
    "repro.core.dpf.DPFKey.tree_unflatten": ("jax-only", _PYTREE),
    "repro.core.lwe.LWECiphertext.tree_flatten": ("jax-only", _PYTREE),
    "repro.core.lwe.LWECiphertext.tree_unflatten": ("jax-only", _PYTREE),
    "repro.core.pir.U32": ("jax-only", _U32),
    "repro.core.protocol.U32": ("jax-only", _U32),
    "repro.core.server.U32": ("jax-only", _U32),
    "repro.core.server.ServeFns": (
        "jax-only", "a jitted, sharded step per bucket; the port binds a "
                    "plan per bucket (BucketedServeFns.step_for)"),
    "repro.core.server.ServeFns.plan_report": (
        "jax-only", "see ServeFns; BucketedServeFns.plan_report"),
    "repro.core.server.LoweredServe": ("jax-only", "a jax lowering"),
    "repro.core.server.LoweredServe.compile": ("jax-only", "a jax lowering"),
    "repro.core.server.LoweredServe.as_text": ("jax-only", "a jax lowering"),
    "repro.core.server.build_serve_fn": (
        "jax-only", "jit + shard_map step builder; BucketedServeFns"),
    "repro.core.server.BucketedServeFns.fns_for": (
        "jax-only", "the per-bucket jit cache; BucketedServeFns.step_for"),
    "repro.core.server.PIRServer.lower": (
        "jax-only", "jax lowering; the dry run is launch/dryrun."
                    "lower_pir_cell on meta"),
    # db: one Database, a rank's block of it on a mesh
    "repro.db.sharded.ShardedDatabase": (
        "renamed", "repro_torch.db.sharded.Database"),
    **{f"repro.db.sharded.ShardedDatabase.{m}": (
        "renamed", f"repro_torch.db.sharded.Database.{m}")
       for m in ("epoch", "n_staged", "view", "snapshot", "register_hint",
                 "hint", "stage", "subscribe", "publish", "sharding")},
    # engine
    "repro.engine.backend.FORCE_BACKEND_ENV": (
        "jax-only", "forces a jax backend; the port follows the device "
                    "(engine.backend.backend_of)"),
    "repro.engine.backend.backend": (
        "jax-only", "the jax backend; repro_torch.engine.backend."
                    "backend_of"),
    "repro.engine.backend.on_tpu": ("jax-only", "TPU detection"),
    "repro.engine.backend.default_interpret": (
        "jax-only", "Pallas interpret mode"),
    "repro.engine.backend.resolve_interpret": (
        "jax-only", "Pallas interpret mode"),
    "repro.engine.kernels.GEMM_TILE_R_DEFAULT": (
        "renamed", "repro_torch.core.protocol.GEMM_TILE_R_DEFAULT"),
    "repro.engine.kernels.MATERIALIZE_JNP": (
        "renamed", "repro_torch.engine.kernels.MATERIALIZE_TORCH"),
    "repro.engine.kernels.MATERIALIZE_PALLAS": (
        "renamed", "repro_torch.engine.kernels.MATERIALIZE_CUDA"),
    "repro.engine.kernels.FUSED_XOR": (
        "renamed", "repro_torch.engine.kernels.FUSED_TORCH"),
    "repro.engine.kernels.FUSED_PALLAS_XOR": (
        "renamed", "repro_torch.engine.kernels.FUSED_CUDA"),
    "repro.engine.kernels.GEMM_JNP": (
        "renamed", "repro_torch.engine.kernels.GEMM_TORCH"),
    "repro.engine.kernels.GEMM_PALLAS": (
        "renamed", "repro_torch.engine.kernels.GEMM_CUDA"),
    "repro.engine.kernels.FUSED_PALLAS_GEMM": (
        "renamed", "repro_torch.engine.kernels.FUSED_CUDA_GEMM"),
    "repro.engine.kernels.LWE_GEMM_JNP": (
        "renamed", "repro_torch.engine.kernels.LWE_GEMM_TORCH"),
    "repro.engine.kernels.LWE_GEMM_PALLAS": (
        "renamed", "repro_torch.engine.kernels.LWE_GEMM_CUDA"),
    # kernels: the Pallas entry points; the CUDA ones read the DB row-major
    "repro.kernels.dpxor.U32": ("jax-only", _U32),
    "repro.kernels.dpxor.dpxor_t": (
        "jax-only", "Pallas entry on a [W, R] DB; kernels.dpxor.dpxor"),
    "repro.kernels.fused_scan.U32": ("jax-only", _U32),
    "repro.kernels.fused_scan.fused_scan_xor_t": (
        "jax-only", "Pallas entry on a [W, R] DB; fused_scan.fused_scan_xor"),
    "repro.kernels.ggm_expand.U32": ("jax-only", _U32),
    "repro.kernels.ggm_expand.ggm_expand_level": (
        "jax-only", "Pallas entry; kernels.ggm_expand.ggm_expand"),
    "repro.kernels.ops.U32": ("jax-only", _U32),
    "repro.kernels.ops.dpxor_transposed": (
        "jax-only", "Pallas entry on a [W, R] DB; ops.dpxor"),
    "repro.kernels.pir_matmul.I32": (
        "jax-only", "jnp dtype alias; torch.int32"),
    "repro.kernels.pir_matmul.pir_matmul": (
        "jax-only", "Pallas entry; kernels.pir_matmul.pir_gemm"),
    "repro.kernels.pir_matmul.lwe_matmul": (
        "jax-only", "Pallas entry; kernels.lwe_matmul.lwe_gemm"),
    "repro.kernels.ref.U32": ("jax-only", _U32),
    # launch: TPU pod meshes
    "repro.launch.mesh.SINGLE_POD": ("jax-only", "a TPU pod shape"),
    "repro.launch.mesh.MULTI_POD": ("jax-only", "a TPU pod shape"),
    "repro.launch.mesh.make_production_mesh": (
        "jax-only", "a TPU pod mesh; the dry run takes --mesh one"),
    # models: sharding specs
    **{f"repro.models.{m}.{c}.{s}": ("a6b", _SPECS)
       for m, c in (("encdec", "EncDecLM"), ("hybrid", "Zamba2Model"),
                    ("transformer", "TransformerLM"),
                    ("xlstm", "XLSTMModel"))
       for s in ("param_specs", "cache_specs")},
    **{f"repro.models.{n}": ("a6b", _SPECS)
       for n in ("layers.BATCH", "layers.MODEL", "layers.shard_hint",
                 "layers.gqa_specs", "layers.mla_specs", "layers.mlp_specs",
                 "layers.embed_specs", "moe.moe_specs", "ssm.mamba2_specs",
                 "ssm.mlstm_specs", "ssm.slstm_specs")},
    "repro.models.ssm.SSDState": (
        "jax-only", "a NamedTuple over a jax.Array that nothing uses; "
                    "ssd_scan returns the state tensor in both packages"),
    # optim and runtime
    "repro.optim.compression.compressed_psum": (
        "a6b", "the int8 error-feedback all-reduce"),
    "repro.optim.optimizer.spec_for_state": ("a6b", "ZeRO-1 state layouts"),
    "repro.runtime.steps.PIRStep": (
        "jax-only", "jit steps with explicit NamedShardings; "
                    "core.server.PIRServer plays its role"),
    "repro.runtime.steps.make_pir_serve_step": (
        "jax-only", "builds PIRStep; core.server.PIRServer"),
}

#: the single-card functions ported last (ROADMAP §A, A22): each must
#: resolve, and none may stand in the table
A22 = (
    "repro.crypto.packing.bytes_to_words",
    "repro.crypto.packing.pack_bits_to_words",
    "repro.crypto.packing.unpack_words_to_bits",
    "repro.crypto.aes_ref.expand_key",
    "repro.crypto.aes_ref.encrypt_block",
    "repro.crypto.aes_ref.aes_ggm_double",
    "repro.db.spec.DatabaseSpec.log_n",
    "repro.db.spec.DatabaseSpec.db_bytes",
    "repro.db.spec.DatabaseSpec.rows_per_shard",
    "repro.db.spec.DatabaseSpec.view_struct",
    "repro.db.spec.DatabaseSpec.words_to_bytes_host",
    "repro.db.spec.DatabaseSpec.bytes_to_words_host",
    "repro.db.spec.DatabaseSpec.words_to_bytes_device",
    "repro.db.spec.DatabaseSpec.words_to_view_device",
    "repro.db.spec.DatabaseSpec.pack_host",
    "repro.core.dpf.eval_all",
    "repro.core.dpf.leaf_bits",
    "repro.core.dpf.leaf_words",
    "repro.core.pir.answer_xor",
    "repro.core.pir.answer_xor_batch",
    "repro.core.pir.answer_additive_batch",
    "repro.core.pir.phase_eval_bits",
    "repro.core.pir.phase_dpxor",
    "repro.core.lwe.encrypt",
    "repro.core.protocol.available",
    "repro.core.protocol.replace_party",
    "repro.core.protocol._component_bits",
    "repro.core.protocol.ExecutionPlan.describe",
    "repro.core.protocol.PIRProtocol.query_gen_full",
    "repro.core.protocol.PIRProtocol.hint_builder",
    "repro.core.server.BucketedServeFns.plan_report",
    "repro.runtime.batch.BatchPIR",
)


def _module_name(path: Path) -> str:
    parts = list(path.relative_to(REF_ROOT.parent).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def reference_names():
    """``{qualified name: (port module, attribute path)}`` for every public
    top-level name and public method of a top-level class."""
    out = {}
    for path in sorted(REF_ROOT.rglob("*.py")):
        mod = _module_name(path)
        port_mod = "repro_torch" + mod[len("repro"):]
        for node in ast.parse(path.read_text()).body:
            names = []
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names.append((node.name,))
            elif isinstance(node, ast.ClassDef):
                names.append((node.name,))
                names += [(node.name, b.name) for b in node.body
                          if isinstance(b, (ast.FunctionDef,
                                            ast.AsyncFunctionDef))
                          and not b.name.startswith("_")]
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                names += [(t.id,) for t in targets
                          if isinstance(t, ast.Name)]
            for attrs in names:
                if not attrs[0].startswith("_"):
                    out[".".join((mod,) + attrs)] = (port_mod, attrs)
    return out


def _resolve_module(name: str):
    try:
        return importlib.import_module(name)
    except ModuleNotFoundError as e:
        if e.name is not None and name.startswith(e.name):
            return None                   # the port has no such module
        raise


def _resolves(port_mod: str, attrs) -> bool:
    obj = _resolve_module(port_mod)
    for a in attrs:
        if obj is None or not hasattr(obj, a):
            return False
        obj = getattr(obj, a)
    return True


def _resolve_dotted(dotted: str):
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        mod = _resolve_module(".".join(parts[:i]))
        if mod is not None:
            obj = mod
            for a in parts[i:]:
                obj = getattr(obj, a)
            return obj
    raise ImportError(dotted)


@pytest.fixture(scope="module")
def names():
    return reference_names()


@pytest.fixture(scope="module")
def missing(names):
    return sorted(q for q, (mod, attrs) in names.items()
                  if not _resolves(mod, attrs))


def test_every_reference_name_is_ported_or_listed(missing):
    unlisted = [q for q in missing if q not in NOT_PORTED]
    assert not unlisted, f"reference names with no counterpart and no " \
                         f"entry in NOT_PORTED: {unlisted}"


def test_the_table_names_only_what_is_missing(names, missing):
    stale = sorted(set(NOT_PORTED) - set(names))
    assert not stale, f"entries that name no reference name: {stale}"
    resolved = sorted(set(NOT_PORTED) - set(missing))
    assert not resolved, f"entries the port now has: {resolved}"


def test_the_table_gives_only_the_allowed_reasons():
    bad = {q: r for q, (r, note) in NOT_PORTED.items()
           if r not in REASONS or not note}
    assert not bad, bad
    for q, (reason, note) in NOT_PORTED.items():
        if reason == "deviation":
            assert note.startswith("ROADMAP §C"), q


@pytest.mark.parametrize("name", sorted(q for q, (r, _) in NOT_PORTED.items()
                                        if r == "renamed"))
def test_renamed_names_resolve(name):
    assert _resolve_dotted(NOT_PORTED[name][1]) is not None


@pytest.mark.parametrize("name", A22)
def test_a22_functions_are_ported(names, name):
    assert name not in NOT_PORTED
    if name in names:
        assert _resolves(*names[name]), name
    else:                                 # private: not in the AST scan
        mod, attr = name.rsplit(".", 1)
        assert hasattr(importlib.import_module(
            "repro_torch" + mod[len("repro"):]), attr)


#: the sharded serving path (ROADMAP §A, A6b-serve): each must resolve,
#: and none may stand in the table
A6B_SERVE = (
    "repro.launch.mesh.make_mesh",
    "repro.launch.mesh.make_local_mesh",
    "repro.launch.mesh.mesh_axis_size",
    "repro.launch.mesh.batch_axes",
    "repro.launch.mesh.pir_cluster_axes",
    "repro.launch.mesh.pir_shard_axis",
    "repro.core.protocol.xor_allreduce_gather",
    "repro.core.protocol.xor_allreduce_butterfly",
    "repro.core.protocol._xor_reduce",
    "repro.core.protocol._dpf_key_specs",
    "repro.core.protocol.PIRProtocol.key_specs",
    "repro.core.protocol.PIRProtocol.reduce",
    "repro.core.protocol.XorDpf2.key_specs",
    "repro.core.protocol.XorDpf2.reduce",
    "repro.core.protocol.AdditiveDpf2.key_specs",
    "repro.core.protocol.AdditiveDpf2.reduce",
    "repro.core.protocol.XorDpfK.key_specs",
    "repro.core.protocol.XorDpfK.reduce",
    "repro.core.protocol.LweSimple1.key_specs",
    "repro.core.protocol.LweSimple1.reduce",
    "repro.core.server.key_specs",
)


@pytest.mark.parametrize("name", A6B_SERVE)
def test_a6b_serve_functions_are_ported(names, name):
    assert name not in NOT_PORTED
    if name in names:
        assert _resolves(*names[name]), name
    else:              # private, or inherited: not in the AST scan
        assert _resolve_dotted("repro_torch" + name[len("repro"):])


def test_a6b_entries_left_are_the_training_half():
    left = sorted(q for q, (r, _) in NOT_PORTED.items() if r == "a6b")
    assert left and all(
        q.startswith(("repro.models.", "repro.optim.")) for q in left), left


#: the replica plane on meshes (ROADMAP §A, A6b-serve-2): each takes the
#: reference's parameters, by name and kind, in order
MESH_SIGNATURES = (
    "repro.runtime.elastic.rebuild_mesh",
    "repro.runtime.elastic.carve_submeshes",
    "repro.replica.replica.make_pir",
    "repro.replica.replica.ServeReplica.__init__",
)


def _reference_parameters(name: str) -> list:
    """``[(name, kind), ...]`` of a reference function, read by AST."""
    mod, attrs = name[len("repro."):].split("."), []
    path = REF_ROOT
    while not (path / f"{mod[0]}.py").exists():
        path, mod = path / mod[0], mod[1:]
    path, attrs = path / f"{mod[0]}.py", mod[1:]
    body = ast.parse(path.read_text()).body
    for a in attrs:
        (node,) = [n for n in body if getattr(n, "name", None) == a]
        body = getattr(node, "body", [])
    args = node.args
    out = [(a.arg, "positional") for a in args.posonlyargs + args.args]
    if args.vararg:
        out.append((args.vararg.arg, "var_positional"))
    out += [(a.arg, "keyword_only") for a in args.kwonlyargs]
    if args.kwarg:
        out.append((args.kwarg.arg, "var_keyword"))
    return out


@pytest.mark.parametrize("name", MESH_SIGNATURES)
def test_mesh_replica_plane_takes_the_references_parameters(name):
    import inspect
    kinds = {inspect.Parameter.POSITIONAL_ONLY: "positional",
             inspect.Parameter.POSITIONAL_OR_KEYWORD: "positional",
             inspect.Parameter.VAR_POSITIONAL: "var_positional",
             inspect.Parameter.KEYWORD_ONLY: "keyword_only",
             inspect.Parameter.VAR_KEYWORD: "var_keyword"}
    port = _resolve_dotted("repro_torch" + name[len("repro"):])
    got = [(p.name, kinds[p.kind])
           for p in inspect.signature(port).parameters.values()]
    assert got == _reference_parameters(name)


def test_database_sharding_is_ported_under_its_class():
    assert NOT_PORTED["repro.db.sharded.ShardedDatabase.sharding"] == (
        "renamed", "repro_torch.db.sharded.Database.sharding")


def test_batch_pir_takes_n_clusters():
    import inspect
    from repro_torch.runtime.batch import BatchPIR
    assert "n_clusters" in inspect.signature(BatchPIR).parameters


def test_the_scan_touches_no_card(names, missing):
    # every port module was imported by the fixtures above
    assert len(names) > len(missing) > 0
    assert not torch.cuda.is_initialized()
