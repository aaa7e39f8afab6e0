"""Render the dry run's tables from its JSONL records: the port of
``repro/launch/report.py``.

Takes the LAST record per (kind, arch, shape, mesh) so re-runs supersede
earlier failures. ``--markdown`` emits the tables; default prints a
summary. The reference's "HBM/dev" column is "bytes on the card" here:
arguments + temp, the predicted peak of allocated bytes (``temp`` already
holds the outputs live at the peak, ``launch/dryrun.py``); the ``fits``
column says whether it is at most the card's 80 GB (80e9 bytes). Byte
counts print in binary units (GiB, MiB, KiB), which the reference labels
GB, MB and KB.

Usage:
  python -m repro_torch.launch.report --markdown build/dryrun.jsonl
"""
from __future__ import annotations

import argparse
import json
from typing import Dict, List

from repro_torch.analysis.roofline import HBM_BYTES


def load(path: str) -> List[dict]:
    last: Dict[tuple, dict] = {}
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            last[(r.get("kind"), r.get("arch"), r.get("shape"),
                  r.get("mesh"))] = r
    return list(last.values())


def _fmt_s(x) -> str:
    if x is None:
        return "-"
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x*1e3:.2f}ms"
    return f"{x*1e6:.0f}µs"


def _fmt_b(x) -> str:
    if x is None:
        return "-"
    # binary units, named as such (the reference prints GiB as "GB")
    for unit, div in (("GiB", 1 << 30), ("MiB", 1 << 20), ("KiB", 1 << 10)):
        if x >= div:
            return f"{x/div:.2f}{unit}"
    return f"{x:.0f}B"


def card_bytes(r: dict) -> int:
    """Bytes on the card: arguments + temp (the predicted peak)."""
    mem = r.get("memory", {})
    return (mem.get("argument_size_in_bytes", 0)
            + mem.get("temp_size_in_bytes", 0))


def _fits(r: dict) -> str:
    return "yes" if r.get("fits_one_card", card_bytes(r) <= HBM_BYTES) \
        else "no"


def roofline_table(rows: List[dict], mesh: str = "one") -> str:
    out = ["| cell | chips | HLO FLOPs | t_comp | t_mem | t_coll | "
           "bottleneck | useful/HLO | MFU-bound | bytes on the card | fits |",
           "|---|---|---|---|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        if r.get("mesh") != mesh or not r.get("ok"):
            continue
        if r.get("skipped"):
            out.append(f"| {r['arch']}/{r['shape']} | - | - | - | - | - | "
                       f"skipped | - | - | - | - |")
            continue
        out.append(
            f"| {r['arch']}/{r['shape']} | {r['n_chips']} "
            f"| {r['hlo_flops']:.2e} "
            f"| {_fmt_s(r['t_compute_s'])} | {_fmt_s(r['t_memory_s'])} "
            f"| {_fmt_s(r['t_collective_s'])} | {r['bottleneck']} "
            f"| {r['useful_flop_ratio']:.2f} | {r['mfu_bound']*100:.2f}% "
            f"| {_fmt_b(card_bytes(r))} | {_fits(r)} |")
    return "\n".join(out)


def dryrun_table(rows: List[dict]) -> str:
    out = ["| cell | mesh | status | compile | bytes on the card (arg+tmp) "
           "| fits | collectives |",
           "|---|---|---|---|---|---|---|"]
    for r in sorted(rows, key=lambda r: (r.get("kind", ""), r["arch"],
                                         r["shape"], r["mesh"])):
        if r.get("skipped"):
            out.append(f"| {r['arch']}/{r['shape']} | {r['mesh']} | "
                       f"SKIP ({r.get('reason', '')[:40]}…) | - | - | - "
                       f"| - |")
            continue
        if not r.get("ok"):
            out.append(f"| {r['arch']}/{r['shape']} | {r['mesh']} | "
                       f"FAIL | - | - | - | {r.get('error', '')[:60]} |")
            continue
        coll = r.get("collective_breakdown", {})
        coll_s = ", ".join(f"{k.split('-')[-1][:4]}:{_fmt_b(v)}"
                           for k, v in sorted(coll.items(),
                                              key=lambda kv: -kv[1])[:3])
        out.append(f"| {r['arch']}/{r['shape']} | {r['mesh']} | ok | "
                   f"{r.get('compile_s', '-')}s | {_fmt_b(card_bytes(r))} "
                   f"| {_fits(r)} | {coll_s} |")
    return "\n".join(out)


def summary(rows: List[dict]) -> str:
    ok = sum(1 for r in rows if r.get("ok") and not r.get("skipped"))
    skip = sum(1 for r in rows if r.get("skipped"))
    fail = sum(1 for r in rows if not r.get("ok"))
    over = [r for r in rows if r.get("ok") and not r.get("skipped")
            and card_bytes(r) > HBM_BYTES]
    lines = [f"cells ok={ok} skipped={skip} failed={fail}"]
    for r in over:
        lines.append(f"  over 80 GB: {r['arch']}/{r['shape']}/{r['mesh']} "
                     f"= {card_bytes(r) / 1e9:.1f} GB on one card")
    for r in rows:
        if not r.get("ok"):
            lines.append(f"  FAIL {r['arch']}/{r['shape']}/{r['mesh']}: "
                         f"{r.get('error', '')[:120]}")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", nargs="?", default=None,
                    help="the dry run's JSONL (as --in)")
    ap.add_argument("--in", dest="inp", default="results/dryrun.jsonl")
    ap.add_argument("--markdown", action="store_true")
    args = ap.parse_args(argv)
    rows = load(args.path or args.inp)
    if args.markdown:
        print("### Dry-run grid\n")
        print(dryrun_table(rows))
        print("\n### Roofline (one H100)\n")
        print(roofline_table(rows, "one"))
    else:
        print(summary(rows))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
