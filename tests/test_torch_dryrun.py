"""The port's dry run (``repro_torch/launch/dryrun.py``) and its report
(``launch/report.py``) against the reference's
(``repro/launch/dryrun.py``, ``repro/launch/report.py``).

Every architecture's SMOKE config runs its train step, its prefill and a
decode on the meta device under the op-level cost counter; the memory the
record predicts is held to the bytes of the same state built on the CPU,
its model FLOPs to 6 (or 2) N D, and a PIR cell's modeled bytes to the
engine's. The reference's dry run sets JAX's device count when it is
imported, so its ``ARCH_POLICY`` is read from its source.
"""
import ast
import dataclasses
import json
import pathlib

import pytest
import torch

from repro_torch import engine
from repro_torch.config import OptimizerConfig, RunConfig
from repro_torch.configs import SMOKES
from repro_torch.configs.pir import PIR_CONFIGS
from repro_torch.configs.shapes import SMOKE_DECODE, SMOKE_PREFILL, SMOKE_TRAIN
from repro_torch.core.protocol import resolve_plan
from repro_torch.launch import dryrun, report
from repro_torch.launch.train import ONE_DEVICE
from repro_torch.runtime.steps import make_serve_step, make_train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
SHAPES = {s.name: s for s in (SMOKE_TRAIN, SMOKE_PREFILL, SMOKE_DECODE)}
ROOF_KEYS = ("hlo_flops", "hlo_bytes", "t_compute_s", "t_memory_s",
             "t_collective_s", "bottleneck", "roofline_step_s",
             "useful_flop_ratio", "mfu_bound", "model_flops")


def smoke_run(arch, shape_name):
    """A SMOKE config's run under the arch's policy (its microbatches
    capped at the smoke batch of 2)."""
    shape = SHAPES[shape_name]
    pol = dryrun.ARCH_POLICY[arch]
    micro = min(pol["micro"], shape.global_batch) \
        if shape.kind == "train" else 1
    return RunConfig(model=SMOKES[arch], shape=shape, mesh=ONE_DEVICE,
                     optimizer=OptimizerConfig(name=pol["opt"]),
                     microbatches=micro)


CELLS = [(a, s) for a in sorted(SMOKES) for s in SHAPES]


@pytest.fixture(scope="module")
def records():
    return {(a, s): dryrun.lower_cell(a, s, run=smoke_run(a, s))
            for a, s in CELLS}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_smoke_cell_runs_on_meta(records, arch, shape):
    rec = records[(arch, shape)]
    assert rec["ok"] and rec["kind"] == "lm" and rec["mesh"] == "one"
    assert rec["n_chips"] == 1 and rec["n_ops"] > 0
    mem = rec["memory"]
    assert set(mem) == {"argument_size_in_bytes", "output_size_in_bytes",
                        "temp_size_in_bytes"}
    # the peak is at least the arguments
    assert mem["temp_size_in_bytes"] >= 0
    assert rec["peak_live_bytes"] >= mem["argument_size_in_bytes"]
    assert rec["fits_one_card"] is True
    for k in ROOF_KEYS:
        assert k in rec
    assert rec["hlo_flops"] > 0 and rec["hlo_bytes"] > 0
    assert json.loads(json.dumps(rec)) == rec


def _storage_bytes(*objs) -> int:
    seen, total = set(), 0
    stack = list(objs)
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            st = x.untyped_storage()
            if st.data_ptr() not in seen:
                seen.add(st.data_ptr())
                total += st.nbytes()
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif x is not None and hasattr(x, "__dict__"):
            stack.extend(vars(x).values())
    return total


def _cpu_inputs(structs):
    return {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in structs.items()}


@pytest.mark.parametrize("arch,shape", CELLS)
def test_arguments_equal_the_cpu_state(records, arch, shape):
    """argument_size_in_bytes is the bytes of the same step's state built
    on the CPU: parameters, optimizer state and inputs (a decode's cache),
    exact."""
    run = smoke_run(arch, shape)
    if run.shape.kind == "train":
        ts = make_train_step(run, device="cpu")
        params, opt_state, ef = ts.init_state(torch.Generator()
                                              .manual_seed(0))
        want = _storage_bytes(params, opt_state, ef,
                              _cpu_inputs(ts.input_structs))
    else:
        ss = make_serve_step(run.model, run.shape, device="cpu")
        params = dict(ss.model.named_parameters())
        if run.shape.kind == "prefill":
            want = _storage_bytes(params, _cpu_inputs(ss.input_structs))
        else:
            cache = ss.model.init_cache(run.shape.global_batch,
                                        run.shape.seq_len)
            want = _storage_bytes(params, cache,
                                  _cpu_inputs(ss.input_structs))
    got = records[(arch, shape)]["memory"]["argument_size_in_bytes"]
    assert got == want


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_are_6_or_2_n_d(records, arch, shape):
    cfg, s = SMOKES[arch], SHAPES[shape]
    if s.kind == "train":
        want = 6 * cfg.n_active_params() * s.global_batch * s.seq_len
    elif s.kind == "prefill":
        want = 2 * cfg.n_active_params() * s.global_batch * s.seq_len
    else:
        want = 2 * cfg.n_active_params() * s.global_batch
    assert records[(arch, shape)]["model_flops"] == want


def _reference_policy():
    src = (ROOT / "src" / "repro" / "launch" / "dryrun.py").read_text()
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "ARCH_POLICY" for t in node.targets):
            # {arch: dict(opt=..., micro=..., fsdp=...)}
            return {ast.literal_eval(k): {kw.arg: ast.literal_eval(kw.value)
                                          for kw in v.keywords}
                    for k, v in zip(node.value.keys, node.value.values)}
    raise AssertionError("no ARCH_POLICY in the reference's dry run")


def test_arch_policy_equals_the_references():
    assert dryrun.ARCH_POLICY == _reference_policy()


@pytest.mark.parametrize("arch", sorted(dryrun.ARCH_POLICY))
def test_make_run_keeps_the_policy_on_one_card(arch):
    pol = dryrun.ARCH_POLICY[arch]
    run = dryrun.make_run(arch, "train_4k")
    assert run.microbatches == pol["micro"]      # one batch shard: no halving
    assert run.optimizer.name == pol["opt"]
    assert run.fsdp is False and run.mesh.n_devices == 1
    assert dryrun.make_run(arch, "decode_32k").microbatches == 1
    assert dryrun.make_run(arch, "train_4k", micro_override=2) \
        .microbatches == 2


@pytest.mark.parametrize("pir,path,queries", [
    ("pir-smoke", "fused-cuda", 4), ("pir-smoke", "cuda", 1),
    ("pir-smoke-add", "fused-cuda", 4), ("pir-smoke-k3", "auto", 4),
    ("pir-smoke-lwe", "cuda", 4)])
def test_pir_cell_plans_for_the_card(pir, path, queries):
    rec = dryrun.lower_pir_cell(pir, path=path, n_queries=queries)
    cfg = PIR_CONFIGS[pir]
    plan = resolve_plan(None if path == "auto" else path, cfg, queries,
                        backend="cuda")
    want = engine.plan_report(cfg, plan, queries, backend="cuda")
    assert rec["ok"] and rec["kind"] == "pir"
    assert rec["plan"] == plan.describe()
    assert rec["plan_label"] == want["label"]
    assert rec["plan_predicted_bytes"] == want["predicted_step_bytes"]
    assert rec["model_flops"] == cfg.db_bytes / 4 * queries
    assert rec["memory"]["argument_size_in_bytes"] >= cfg.db_bytes
    assert rec["hlo_bytes"] > 0


def test_cli_writes_resumable_records(tmp_path, capsys):
    out = tmp_path / "grid.jsonl"
    args = ["--arch", "granite-3-2b", "--shape", "decode_32k", "--pir",
            "pir-smoke", "--pir-queries", "4", "--out", str(out)]
    assert dryrun.main(args) == 0
    recs = [json.loads(line) for line in out.read_text().splitlines()]
    assert [(r["kind"], r["arch"], r["shape"]) for r in recs] == [
        ("lm", "granite-3-2b", "decode_32k"),
        ("pir", "pir-smoke", "fused-cuda")]
    assert all(r["ok"] for r in recs)
    assert recs[0]["memory"]["argument_size_in_bytes"] > 5e9   # 2.6 B bf16
    # resumed: nothing re-run
    assert dryrun.main(args) == 0
    assert len(out.read_text().splitlines()) == 2
    assert "[skip/done]" in capsys.readouterr().out
    # the long_500k rule records a skip
    assert dryrun.main(["--arch", "granite-3-2b", "--shape", "long_500k",
                        "--out", str(out)]) == 0
    last = json.loads(out.read_text().splitlines()[-1])
    assert last["skipped"] and last["ok"]


def test_cli_cuts_depth_and_batch(tmp_path):
    """--layers / --batch cut a cell as the card's phases cut theirs; the
    cut is in the cell's name, so a grid and its cuts resume apart."""
    out = tmp_path / "cuts.jsonl"
    args = ["--arch", "zamba2-7b", "--shape", "decode_32k", "--layers", "6",
            "--batch", "2", "--out", str(out)]
    assert dryrun.main(args) == 0
    rec = json.loads(out.read_text())
    assert rec["shape"] == "decode_32k-L6-b2"
    assert (rec["layers"], rec["global_batch"]) == (6, 2)
    full = dryrun.make_run("zamba2-7b", "decode_32k")
    cut = dryrun.make_run("zamba2-7b", "decode_32k", layers=6, batch=2)
    assert cut.model == dataclasses.replace(full.model, n_layers=6)
    assert cut.shape.global_batch == 2 and cut.shape.seq_len == 32768
    assert dryrun.main(args) == 0
    assert len(out.read_text().splitlines()) == 1
    # a cut of a cell the grid skips is skipped too
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "long_500k",
                        "--layers", "2", "--out", str(out)]) == 0
    assert json.loads(out.read_text().splitlines()[-1])["skipped"]


def test_cli_records_a_failure(tmp_path, monkeypatch):
    def host_read(*a, **k):
        raise RuntimeError("Tensor.item() cannot be called on meta tensors")
    monkeypatch.setattr(dryrun, "lower_cell", host_read)
    out = tmp_path / "fail.jsonl"
    assert dryrun.main(["--arch", "qwen3-4b", "--shape", "decode_32k",
                        "--out", str(out)]) == 1
    rec = json.loads(out.read_text())
    assert rec["ok"] is False and "meta" in rec["error"]
    assert dryrun._done_cells(str(out)) == set()


def _fixture_rows():
    """Records of the keys both dry runs write (no outputs, so the
    reference's HBM/dev and the port's bytes on the card agree)."""
    from repro.analysis import roofline as ref_rl
    rows = []
    for i, (arch, shape) in enumerate([("granite-3-2b", "train_4k"),
                                       ("qwen3-4b", "decode_32k"),
                                       ("xlstm-350m", "long_500k")]):
        roof = ref_rl.Roofline(name=f"{arch}/{shape}/one", n_chips=1,
                               hlo_flops=1e14 * (i + 1),
                               hlo_bytes=3e12 / (i + 1),
                               collective_bytes=0.0, model_flops=5e13)
        rows.append({"kind": "lm", "arch": arch, "shape": shape,
                     "mesh": "one", "ok": True, "compile_s": 1.5,
                     "memory": {"argument_size_in_bytes": (i + 1) * 10 ** 9,
                                "temp_size_in_bytes": 3 * 10 ** 8,
                                "output_size_in_bytes": 0},
                     **roof.to_dict()})
    rows.append({"kind": "lm", "arch": "qwen3-4b", "shape": "long_500k",
                 "mesh": "one", "ok": True, "skipped": True,
                 "reason": "long_500k requires sub-quadratic attention"})
    return rows


def test_report_renders_the_references_table(tmp_path):
    from repro.launch import report as ref_report
    path = tmp_path / "rows.jsonl"
    rows = _fixture_rows()
    # an older failure superseded by a later record of the same cell
    lines = [json.dumps(dict(rows[0], ok=False, error="x"))]
    lines += [json.dumps(r) for r in rows]
    path.write_text("\n".join(lines) + "\n")
    ours, theirs = report.load(str(path)), ref_report.load(str(path))
    assert ours == theirs and len(ours) == 4
    mine = report.roofline_table(ours, "one").splitlines()
    ref = ref_report.roofline_table(theirs, "one").splitlines()
    assert len(mine) == len(ref)
    for a, b in zip(mine[2:], ref[2:]):
        a_cells, b_cells = a.split("|")[1:-1], b.split("|")[1:-1]
        # every shared column, the reference's HBM/dev as bytes on the
        # card (its "GB" are GiB), and the fits column after it
        assert a_cells[:-2] == b_cells[:-1]
        assert a_cells[-2] == b_cells[-1].replace("GB", "GiB")
        assert a_cells[-1].strip() == ("-" if "skipped" in b else "yes")
    assert mine[0].startswith(ref[0].split("| HBM/dev |")[0])
    assert "bytes on the card" in mine[0] and "fits" in mine[0]
    md = report.main(["--markdown", str(path)])
    assert md == 0


def test_report_marks_what_does_not_fit(tmp_path):
    rows = _fixture_rows()
    rows[0]["memory"]["argument_size_in_bytes"] = 90 * 10 ** 9
    rows[0]["fits_one_card"] = False
    table = report.roofline_table(rows, "one")
    assert "| no |" in table
    assert "over 80 GB: granite-3-2b/train_4k/one" in report.summary(rows)
    assert "FAIL" not in report.dryrun_table(rows)
