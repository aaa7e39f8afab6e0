"""Drive the PyTorch + CUDA port's main path on one NVIDIA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, one JSON line each:
  device      the card (nvidia-smi name and power limit), torch and CUDA
  build       nvcc for every kernel source (in parallel), with ptxas's
              register / shared-memory / spill report
  database    PIR_1G (2^25 records x 32 B = 1 GiB) made from a seed and
              placed on the card once
  check       each kernel against its plain PyTorch version on the same
              inputs at main-path shapes; integer-exact, tolerance 0
  quickstart  the quickstart twin at PIR_SMOKE
  serve       TwoServerPIR at PIR_1G on its default plans: batches of 32,
              5 (padded to 8) and 1 through query(), then a session;
              every record is checked against the database, and the
              kernel counters (zeroed just before) must show both kernels
              launched and no plain call
  timing      kernels with CUDA events beside their bounds; end-to-end
              latency and records/s for batches of 1 and 32 with keygen,
              root descent and kernel time apart; peak device memory
Then the kernel table as one JSON line, and as the last line
{"ok": true, "device": {...}}. Any failure exits non-zero without that
line. Without a CUDA card the script exits 1 at once.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

SEED = 20251016

# Bounds (PERF.md "Kernel bounds", fixed before any timing). NVIDIA H100
# SXM data sheet: 3.35 TB/s HBM3; 132 SMs; 1.98 GHz max boost clock. Integer
# issue: 4 schedulers x 32 lanes = 128 int32 lane-ops per SM per clock
# (ALU pipe for IADD3/LOP3/SHF plus the FMA pipe for IMAD-form adds).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 128 * 1.98e9
# ChaCha ARX per block: rounds/2 double rounds x 8 quarter rounds x 12 ops
# (4 add, 4 xor, 4 rotate = one SHF funnel shift each).
ARX_OPS_PER_DOUBLE_ROUND = 8 * 12


def emit(obj):
    print(json.dumps(obj), flush=True)


def dpxor_bound_ms(rows: int, words: int, queries: int) -> float:
    """Bytes bound: DB and bits read once, answers written once."""
    nbytes = rows * words * 4 + queries * rows * 4 + queries * words * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def fused_bound_ms(rows: int, queries: int, clog: int, rounds: int) -> float:
    """Operations bound: one ChaCha permutation per internal GGM node of
    every chunk subtree, (rows - chunks) per query; corrections, feed-
    forward adds and the leaf mask/XOR are left out (a lower bound)."""
    chunks = rows >> clog
    ops = queries * (rows - chunks) * (rounds // 2) * ARX_OPS_PER_DOUBLE_ROUND
    return ops / INT32_OPS_PER_S * 1e3


def cuda_time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_time_s(fn, *, sync: bool):
    t0 = time.perf_counter()
    out = fn()
    if sync:
        torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest |a - b| over u32 words carried in int32."""
    ua = a.to(torch.int64) & 0xFFFFFFFF
    ub = b.to(torch.int64) & 0xFFFFFFFF
    return int((ua - ub).abs().max().item()) if a.numel() else 0


def fused_inputs(keys, start_block: int, log_local: int, clog: int):
    """Chunk roots and correction-word levels for the fused kernel."""
    from repro_torch.core import dpf
    roots, t_roots = dpf.eval_roots_batch(keys, start_block, log_local, clog)
    lvl0 = keys.log_n - clog
    return (roots, t_roots, keys.cw_seed[:, lvl0:, :].contiguous(),
            keys.cw_t[:, lvl0:, :].contiguous())


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0].strip()
    print(card, flush=True)
    props = torch.cuda.get_device_properties(0)
    info = {"phase": "device", "card": card,
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
            "sms": props.multi_processor_count,
            "torch": torch.__version__, "cuda": torch.version.cuda}
    emit(info)
    return info


def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    records = build.build(list(build.LIBRARIES))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "builds": [{"name": r.name, "cmd": " ".join(r.cmd),
                      "seconds": r.seconds, "cached": r.cached,
                      "ptxas": r.ptxas} for r in records.values()]})


def phase_check(db, cfg, device) -> dict:
    """Each kernel against its plain version; returns each kernel's
    largest error."""
    from repro_torch.core import dpf
    from repro_torch.kernels import dpxor as kd, fused_scan as kf
    rng = np.random.default_rng(SEED + 1)
    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    rows, words = db.shape
    worst = {"dpxor": 0, "fused_scan_xor": 0}

    def record(kernel, got, want, **shape):
        err = max_abs_err(got, want)
        worst[kernel] = max(worst[kernel], err)
        emit({"phase": "check", "kernel": kernel, **shape,
              "equal": bool(torch.equal(got, want)), "max_abs_err": err})
        if err:
            raise AssertionError(f"{kernel} differs from its plain version "
                                 f"at {shape}: max_abs_err {err}")

    for q in (1, 4):
        bits = torch.randint(0, 2, (q, rows), generator=gen, device=device,
                             dtype=torch.int32)
        got = kd.dpxor(db, bits)
        torch.cuda.synchronize()
        record("dpxor", got, kd.dpxor_plain(db, bits), q=q, rows=rows,
               words=words)

    log_n = cfg.log_n
    sub = min(20, log_n - 3)          # a shard of 2^20 rows at PIR_1G
    cases = [  # (queries, clog, log_local, start_block)
        (1, 11, log_n, 0), (8, 11, log_n, 0), (32, 11, log_n, 0),
        (8, 0, sub, 5), (8, 11, sub, 5)]
    for q, clog, log_local, start_block in cases:
        keys = dpf.gen_keys_batch(
            rng, rng.integers(0, cfg.n_items, size=q), log_n)[q % 2]
        keys = keys.to(device)
        shard = db[start_block << log_local:(start_block + 1) << log_local]
        inputs = fused_inputs(keys, start_block, log_local, clog)
        got = kf.fused_scan_xor(shard, *inputs, rounds=keys.rounds)
        torch.cuda.synchronize()
        want = kf.fused_scan_xor_plain(shard, *inputs, rounds=keys.rounds)
        record("fused_scan_xor", got, want, q=q, rows=shard.shape[0],
               words=words, clog=clog, start_block=start_block)
    return worst


def check_records(got: np.ndarray, host_db: np.ndarray, idx) -> bool:
    return bool(np.array_equal(got, host_db[np.asarray(idx)]))


def phase_serve(host_db, cfg, database, device):
    from repro_torch.kernels import ops
    from repro_torch.runtime.serve_loop import TwoServerPIR
    rng = np.random.default_rng(SEED + 3)
    system = TwoServerPIR(database, cfg, device=device, n_queries=32,
                          client_rng=np.random.default_rng(SEED + 4))
    plans = system.servers[0].plan_report()
    torch.cuda.reset_peak_memory_stats()
    t_phase = time.perf_counter()
    ops.reset_counts()
    batches = []
    for n in (32, 5, 1):
        idx = rng.integers(0, cfg.n_items, size=n)
        t0 = time.perf_counter()
        recs = system.query(idx)
        batches.append({"n": n, "bucket": system.scheduler.bucket_for(n),
                        "seconds": time.perf_counter() - t0,
                        "exact": check_records(recs, host_db, idx)})
    idx = rng.integers(0, cfg.n_items, size=3)
    t0 = time.perf_counter()
    with system:
        futs = [system.submit(int(i)) for i in idx]
        recs = np.stack([f.result(timeout=600) for f in futs])
    batches.append({"n": len(idx), "session": True,
                    "seconds": time.perf_counter() - t0,
                    "exact": check_records(recs, host_db, idx)})
    counts = ops.counts()
    launches = {k: v["launches"] for k, v in counts.items()}
    plain = {k: v["plain_calls"] for k, v in counts.items()}
    info = {"phase": "serve", "config": "pir-1g", "plans": plans,
            "batches": batches, "launches": launches, "plain_calls": plain,
            "db_resident_bytes": database.resident_bytes,
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "seconds": time.perf_counter() - t_phase}
    emit(info)
    if not all(b["exact"] for b in batches):
        raise AssertionError("a served record differs from the database")
    if min(launches.values()) < 1 or any(plain.values()):
        raise AssertionError(f"main path did not run on the kernels: "
                             f"launches {launches}, plain calls {plain}")
    return launches


def phase_timing(database, cfg, card, device):
    from repro_torch.core import dpf
    from repro_torch.core.protocol import PATH_PLANS, plan_for
    from repro_torch.kernels import dpxor as kd, fused_scan as kf, ops
    from repro_torch.runtime.serve_loop import TwoServerPIR
    rng = np.random.default_rng(SEED + 5)
    system = TwoServerPIR(database, cfg, device=device, n_queries=32,
                          client_rng=np.random.default_rng(SEED + 6))
    db = database.view("words")
    rows, words = db.shape
    log_n = cfg.log_n
    proto = system.protocol
    out = {"phase": "timing", "card": card, "config": "pir-1g"}

    # dpXOR at the main path's shape: one query's selection bits
    k1 = proto.query_gen_batch(rng, [int(rng.integers(cfg.n_items))], cfg)[0]
    k1 = k1.to(device)
    bits = dpf.eval_bits_batch(k1, 0, log_n)
    d_ms = cuda_time_ms(lambda: kd.dpxor(db, bits), reps=20)
    d_plain = cuda_time_ms(lambda: kd.dpxor_plain(db, bits), reps=2)
    out["dpxor"] = {"q": 1, "rows": rows, "ms": d_ms, "plain_ms": d_plain,
                    "bound_ms": dpxor_bound_ms(rows, words, 1),
                    "bound_by": "bytes"}

    # fused scan at the main path's largest bucket (32 queries, clog 11)
    plan = plan_for(cfg, 32, backend="cuda")
    _, clog = ops.fused_tile(rows, plan.tile_r, min(plan.chunk_log, log_n))
    k32 = proto.query_gen_batch(
        rng, rng.integers(0, cfg.n_items, size=32), cfg)[0].to(device)
    inputs = fused_inputs(k32, 0, log_n, clog)
    f_ms = cuda_time_ms(lambda: kf.fused_scan_xor(db, *inputs,
                                                  rounds=k32.rounds), reps=3)
    f_plain = cuda_time_ms(lambda: kf.fused_scan_xor_plain(
        db, *inputs, rounds=k32.rounds), reps=1, warmup=0)
    out["fused_scan_xor"] = {"q": 32, "rows": rows, "clog": clog,
                             "ms": f_ms, "plain_ms": f_plain,
                             "bound_ms": fused_bound_ms(rows, 32, clog,
                                                        k32.rounds),
                             "bound_by": "operations"}
    for name in ("dpxor", "fused_scan_xor"):
        r = out[name]
        r["beats_bound"] = r["ms"] < r["bound_ms"]
        if r["beats_bound"]:
            print(f"NOTE: {name} ran in {r['ms']:.4f} ms, under its bound "
                  f"{r['bound_ms']:.4f} ms", flush=True)

    # pieces of one batch: client keygen, root descent / bit expansion
    for q in (1, 32):
        idx = rng.integers(0, cfg.n_items, size=q)
        kg_s, keys = host_time_s(
            lambda: proto.query_gen_batch(rng, idx, cfg), sync=False)
        keys = keys[0].to(device)
        if q == 1:
            desc_ms = cuda_time_ms(lambda: dpf.eval_bits_batch(keys, 0, log_n),
                                   reps=3)
            kernel_ms = d_ms
        else:
            desc_ms = cuda_time_ms(
                lambda: fused_inputs(keys, 0, log_n, clog), reps=3)
            kernel_ms = f_ms
        out[f"batch_{q}_parts"] = {
            "keygen_s": kg_s, "descent_ms_per_party": desc_ms,
            "kernel_ms_per_party": kernel_ms,
            "plan": plan_for(cfg, q, backend="cuda").name}

    # end to end through TwoServerPIR.query (host clock, result on host)
    for q, reps in ((1, 5), (32, 3)):
        lat = []
        for _ in range(reps):
            idx = rng.integers(0, cfg.n_items, size=q)
            lat.append(host_time_s(lambda: system.query(idx), sync=False)[0])
        med = float(np.median(lat))
        out[f"e2e_{q}"] = {"latency_s": lat, "median_s": med,
                           "records_per_s": q / med}

    # one party's answer step at a batch of 1, under each CUDA plan
    out["answer_1_ms_by_plan"] = {
        PATH_PLANS[path].name: cuda_time_ms(
            lambda: proto.answer_local(db, k1, 0, log_n, PATH_PLANS[path]),
            reps=3)
        for path in ("cuda", "fused-cuda")}
    out["peak_device_bytes_run"] = torch.cuda.max_memory_allocated()
    emit(out)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    # the port must import before anything is printed: a copy of this
    # script without the repo fails here, with no result
    from repro_torch import quickstart
    from repro_torch.configs.pir import PIR_1G
    from repro_torch.core import pir
    from repro_torch.db import Database
    from repro_torch.kernels import build  # noqa: F401

    t_start = time.perf_counter()
    device = torch.device("cuda")
    info = phase_device()
    phase_build()

    cfg = PIR_1G
    t0 = time.perf_counter()
    host_db = pir.make_database(np.random.default_rng(SEED), cfg.n_items,
                                cfg.item_bytes)
    database = Database(host_db, cfg, device)
    db = database.view("words")
    torch.cuda.synchronize()
    emit({"phase": "database", "rows": cfg.n_items, "words": db.shape[1],
          "bytes": database.resident_bytes,
          "seconds": time.perf_counter() - t0})

    worst = phase_check(db, cfg, device)
    qs = quickstart.run(device="cuda", verbose=False)
    emit({"phase": "quickstart", "config": "pir-smoke", **qs})
    if not all(qs["exact"]):
        raise AssertionError("quickstart returned a wrong record")

    launches = phase_serve(host_db, cfg, database, device)
    timing = phase_timing(database, cfg, info["card"], device)

    rows = []
    for name, source, replaces in (
            ("dpxor", "src/repro_torch/csrc/dpxor.cu",
             "src/repro/kernels/dpxor.py:56"),
            ("fused_scan_xor", "src/repro_torch/csrc/fused_scan_xor.cu",
             "src/repro/kernels/fused_scan.py:94")):
        t = timing[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": worst[name], "ms": t["ms"],
                     "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                     "bound_by": t["bound_by"], "library_ms": None})
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(info["card"], flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["kind"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
