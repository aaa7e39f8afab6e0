"""Dry run: one step of every (arch x shape) cell on PyTorch's ``meta``
device, its cost counted op by op. The port of ``repro/launch/dryrun.py``.

The reference lowers and compiles each cell's pjit step on a production
TPU mesh of placeholder devices, without allocating arrays, and records
XLA's memory analysis, the HLO's FLOPs and bytes, and its collectives.
The port builds the same step (``make_train_step`` for train shapes;
``make_serve_step``'s prefill, or one decode over ``init_cache`` with its
rows written in place, as the serving path writes them) on ``device=
"meta"``, where every tensor has a shape and a dtype and no storage, and
runs it once under ``analysis/op_cost.analyze``. For every cell it
records:

  * ``memory`` under the reference's ``memory_analysis`` names:
    ``argument_size_in_bytes`` is what is resident before the step (the
    parameters, the optimizer state, the inputs, and for a decode the
    cache); ``temp_size_in_bytes`` is the peak of live tensor bytes during
    the step less the arguments (so it holds the outputs live at the
    peak); ``output_size_in_bytes`` counts only returned storages that are
    not arguments (a step that updates its state in place returns none);
  * ``fits_one_card``: whether arguments + temp, the predicted peak of
    allocated bytes, is at most the card's 80 GB (``roofline.HBM_BYTES``);
  * the roofline's terms (``roofline.from_cost``) at the H100's data-sheet
    constants, and ``model_flops`` = 6 (train) or 2 (inference) x active
    parameters x tokens, as the reference.

``--mesh`` takes only ``one``: the port runs on one card until sharding
over several lands (ROADMAP A6b). So ``make_run`` keeps the reference's
micro-halving rule with one batch shard (it never halves), and runs the
policy's FSDP archs unsharded (``fsdp`` False; the policy's value is kept
as ``policy_fsdp``): on one card FSDP shards nothing.

PIR cells (``lower_pir_cell``) run one party's answer step of a PIR
config on a meta database and meta keys. Plans are chosen for ``"cuda"``
(the card the dry run predicts for; the engine does not serve on meta),
and the record carries the plan (``ExecutionPlan.describe()`` under
``plan``, as the reference's record; its tuner label under
``plan_label``), the engine's modeled bytes of the step
(``plan_predicted_bytes``) and the reference's PIR "model FLOPs", one XOR
word-op per 4 bytes of DB per query.

A cell that fails (a step that reads a value on the host raises on meta)
is recorded with ``ok: false`` and its error, as the reference does, and
the run goes on; the exit code is 1 if any cell failed. The dry run
allocates nothing, so it runs the same with or without a card.

Resumable: cells already present with ``ok`` in the output JSONL are
skipped.

Usage:
  python -m repro_torch.launch.dryrun --all --out build/dryrun.jsonl
  python -m repro_torch.launch.dryrun --arch granite-3-2b --shape train_4k
  python -m repro_torch.launch.dryrun --pir pir-1g --pir-queries 32
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from dataclasses import replace
from typing import Optional

import torch

from repro_torch.analysis import op_cost
from repro_torch.analysis import roofline as rl
from repro_torch.config import OptimizerConfig, RunConfig
from repro_torch.configs import ARCHS, SHAPES, cell_is_skipped, get_arch
from repro_torch.configs import get_shape
from repro_torch.configs.pir import PIR_CONFIGS
from repro_torch.launch.train import ONE_DEVICE

META = torch.device("meta")

# per-arch run policy: optimizer + microbatches + FSDP (DESIGN.md §5)
ARCH_POLICY = {
    "granite-3-2b":     dict(opt="adamw", micro=4, fsdp=False),
    "qwen3-4b":         dict(opt="adamw", micro=4, fsdp=False),
    "starcoder2-3b":    dict(opt="adamw", micro=4, fsdp=False),
    "stablelm-3b":      dict(opt="adamw", micro=4, fsdp=False),
    "whisper-small":    dict(opt="adamw", micro=2, fsdp=False),
    "xlstm-350m":       dict(opt="adamw", micro=4, fsdp=False),
    "llava-next-34b":   dict(opt="adafactor", micro=8, fsdp=True),
    "grok-1-314b":      dict(opt="adafactor", micro=8, fsdp=True),
    "deepseek-v3-671b": dict(opt="adafactor", micro=8, fsdp=True),
    "zamba2-7b":        dict(opt="adamw", micro=8, fsdp=False),
}

#: the one card's batch shards (the reference divides by its data axes)
BATCH_SHARDS = 1


def make_run(arch: str, shape_name: str, *,
             micro_override: Optional[int] = None,
             layers: Optional[int] = None,
             batch: Optional[int] = None) -> RunConfig:
    """The cell's RunConfig under ``ARCH_POLICY``; ``layers`` and ``batch``
    cut its depth and global batch as the card's phases cut theirs."""
    pol = ARCH_POLICY[arch]
    shape = get_shape(shape_name)
    cfg = get_arch(arch)
    if layers:
        cfg = replace(cfg, n_layers=layers)
    if batch:
        shape = replace(shape, global_batch=batch)
    micro = micro_override or pol["micro"]
    if shape.kind == "train":
        while shape.global_batch // micro % BATCH_SHARDS:
            micro //= 2
        micro = max(micro, 1)
    else:
        micro = 1
    return RunConfig(
        model=cfg, shape=shape, mesh=ONE_DEVICE,
        optimizer=OptimizerConfig(name=pol["opt"]),
        microbatches=micro, remat="block", fsdp=False,
    )


def meta_inputs(structs) -> dict:
    """Meta tensors of a step's ``input_structs``."""
    return {k: torch.empty(s.shape, dtype=s.dtype, device=META)
            for k, s in structs.items()}


def _cost_fields(cost: op_cost.Cost, roof: rl.Roofline) -> dict:
    """A record's counts: ops, live bytes under the reference's memory
    names, whether the peak fits the card, and the roofline's terms."""
    return {
        "n_ops": cost.n_ops, "peak_live_bytes": int(cost.peak_live_bytes),
        "memory": {"argument_size_in_bytes": int(cost.argument_bytes),
                   "output_size_in_bytes": int(cost.output_bytes),
                   "temp_size_in_bytes": int(cost.peak_live_bytes
                                             - cost.argument_bytes)},
        "fits_one_card": cost.peak_live_bytes <= rl.HBM_BYTES,
        **roof.to_dict(),
    }


def lower_cell(arch: str, shape_name: str, *,
               run: Optional[RunConfig] = None) -> dict:
    """Run one cell's step on meta under the cost counter; its JSONL
    record. ``run`` replaces ``make_run``'s (a cut configuration)."""
    from repro_torch.runtime.steps import make_serve_step, make_train_step
    if run is None:
        run = make_run(arch, shape_name)
    cfg, shape = run.model, run.shape
    t0 = time.time()
    if shape.kind == "train":
        ts = make_train_step(run, device=META)
        params, opt_state, ef = ts.init_state(None)
        batch = meta_inputs(ts.input_structs)
        t_lower = time.time() - t0
        cost = op_cost.analyze(ts.step, params, opt_state, ef, batch,
                               resident=(ts.model,))
        n_tokens = shape.global_batch * shape.seq_len
        training = True
    else:
        ss = make_serve_step(cfg, shape, device=META, decode_write=True)
        if shape.kind == "prefill":
            batch = meta_inputs(ss.input_structs)
            t_lower = time.time() - t0
            cost = op_cost.analyze(ss.prefill, batch, resident=(ss.model,))
            n_tokens = shape.global_batch * shape.seq_len
        else:   # decode
            cache = ss.model.init_cache(shape.global_batch, shape.seq_len)
            tokens = meta_inputs(ss.input_structs)["tokens"]
            t_lower = time.time() - t0
            cost = op_cost.analyze(ss.decode, cache, tokens,
                                   resident=(ss.model,))
            n_tokens = shape.global_batch
        training = False
    t_run = time.time() - t0 - t_lower
    model_flops = rl.model_flops_for(cfg.n_active_params(), n_tokens,
                                     training=training)
    roof = rl.from_cost(f"{arch}/{shape_name}/one", cost, n_chips=1,
                        model_flops=model_flops)
    return {
        "kind": "lm", "arch": arch, "shape": shape_name, "mesh": "one",
        "n_chips": 1, "ok": True,
        "lower_s": round(t_lower, 1), "compile_s": round(t_run, 1),
        "microbatches": run.microbatches, "fsdp": run.fsdp,
        "policy_fsdp": ARCH_POLICY.get(arch, {}).get("fsdp", False),
        "optimizer": run.optimizer.name,
        "layers": cfg.n_layers, "global_batch": shape.global_batch,
        "seq_len": shape.seq_len, **_cost_fields(cost, roof),
    }


def meta_keys(cfg, n_queries: int):
    """Party 0's keys for a batch of ``n_queries`` as meta tensors: the
    protocol's ``key_specs``, the one derivation of the keys' shapes."""
    from repro_torch.core.server import key_specs
    return key_specs(cfg, n_queries, party=0)


def lower_pir_cell(pir_name: str, *, path: str = "fused-cuda",
                   n_queries: int = 32, chunk_log: int = 12) -> dict:
    """One party's answer step of ``pir_name`` at a bucket of
    ``n_queries`` on meta, planned for the card; its JSONL record."""
    from repro_torch import engine
    from repro_torch.core.server import BucketedServeFns
    from repro_torch.db import DatabaseSpec
    cfg = PIR_CONFIGS[pir_name]
    t0 = time.time()
    fns = BucketedServeFns(cfg, buckets=(n_queries,), backend="cuda",
                           path=None if path == "auto" else path,
                           chunk_log=chunk_log)
    plan = fns.plan_for_bucket(n_queries)
    db = DatabaseSpec.from_config(cfg).view_struct(fns.protocol.db_view)
    keys = meta_keys(cfg, n_queries)
    t_lower = time.time() - t0
    cost = op_cost.analyze(fns.answer, db, keys)
    t_run = time.time() - t0 - t_lower
    # PIR "model flops": one pass over the DB per query batch, counted as
    # one XOR word-op per 4 bytes (the reference's bookkeeping)
    model_flops = cfg.db_bytes / 4 * n_queries
    roof = rl.from_cost(f"{pir_name}/{path}/one", cost, n_chips=1,
                        model_flops=model_flops)
    report = engine.plan_report(cfg, plan, n_queries, backend="cuda")
    return {
        "kind": "pir", "arch": pir_name, "shape": path, "mesh": "one",
        "n_chips": 1, "ok": True,
        "lower_s": round(t_lower, 1), "compile_s": round(t_run, 1),
        "n_queries": n_queries, "chunk_log": chunk_log,
        "plan": plan.describe(), "plan_label": report["label"],
        "plan_predicted_bytes": report["predicted_step_bytes"],
        **_cost_fields(cost, roof),
    }


def _done_cells(path: str) -> set:
    done = set()
    if path and os.path.exists(path):
        with open(path) as f:
            for line in f:
                try:
                    r = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if r.get("ok"):
                    done.add((r["kind"], r["arch"], r["shape"], r["mesh"]))
    return done


def main(argv=None) -> int:
    from repro_torch.core.protocol import PATH_PLANS
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="architecture id")
    ap.add_argument("--shape", default=None, help="shape cell name")
    ap.add_argument("--pir", default=None, help="PIR config name")
    ap.add_argument("--pir-path", default="fused-cuda",
                    choices=sorted(PATH_PLANS) + ["auto"])
    ap.add_argument("--pir-chunk-log", type=int, default=12)
    ap.add_argument("--pir-queries", type=int, default=32)
    ap.add_argument("--micro", type=int, default=None,
                    help="override ARCH_POLICY microbatches")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the arch's depth (the cell is named -L<n>)")
    ap.add_argument("--batch", type=int, default=None,
                    help="cut the global batch (the cell is named -b<n>)")
    ap.add_argument("--mesh", default="one", choices=["one"],
                    help="one card (several cards: ROADMAP A6b)")
    ap.add_argument("--all", action="store_true",
                    help="run the whole 40-cell grid + PIR cells")
    ap.add_argument("--out", default="results/dryrun.jsonl")
    args = ap.parse_args(argv)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = _done_cells(args.out)

    cut = ((f"-L{args.layers}" if args.layers else "")
           + (f"-b{args.batch}" if args.batch else ""))
    cells = []
    if args.all:
        for arch in ARCHS:
            for shape in SHAPES:
                cells.append(("lm", arch, shape + cut))
        cells.append(("pir", "pir-8g", args.pir_path))
        cells.append(("pir", "pir-1g", args.pir_path))
    else:
        if args.arch:
            shapes = [args.shape] if args.shape else list(SHAPES)
            for s in shapes:
                cells.append(("lm", args.arch, s + cut))
        if args.pir:
            cells.append(("pir", args.pir, args.pir_path))

    n_fail = 0
    with open(args.out, "a") as out:
        for kind, arch, shape in cells:
            key = (kind, arch, shape, args.mesh)
            if key in done:
                print(f"[skip/done] {key}")
                continue
            if kind == "lm" and cell_is_skipped(arch, shape.split("-")[0]):
                rec = {"kind": kind, "arch": arch, "shape": shape,
                       "mesh": args.mesh, "ok": True, "skipped": True,
                       "reason": "long_500k requires sub-quadratic "
                                 "attention (DESIGN.md §4)"}
                out.write(json.dumps(rec) + "\n")
                out.flush()
                print(f"[skip/rule] {key}")
                continue
            print(f"[lower] {key} ...", flush=True)
            try:
                if kind == "lm":
                    rec = lower_cell(arch, shape, run=make_run(
                        arch, shape.split("-")[0], micro_override=args.micro,
                        layers=args.layers, batch=args.batch))
                else:
                    rec = lower_pir_cell(arch, path=shape,
                                         n_queries=args.pir_queries,
                                         chunk_log=args.pir_chunk_log)
                print(f"[ok] {key}: run {rec['compile_s']}s "
                      f"bottleneck={rec.get('bottleneck')} "
                      f"fits={rec['fits_one_card']}", flush=True)
            except Exception as e:   # record failures, keep going
                rec = {"kind": kind, "arch": arch, "shape": shape,
                       "mesh": args.mesh, "ok": False,
                       "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
                n_fail += 1
                print(f"[FAIL] {key}: {e}", flush=True)
            out.write(json.dumps(rec) + "\n")
            out.flush()
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
