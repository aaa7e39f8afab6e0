"""CLI: ``python -m repro_torch.chaos --smoke [--device cpu]`` runs the
seeded fault scenarios (a kill and a share corruption) against the port's
serve stack, on the CUDA card unless ``--device`` names another. The last
line printed is a JSON summary with the kernel counters; a failed check
exits non-zero."""
from __future__ import annotations

import argparse
import json


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.chaos",
        description="chaos-plane smoke scenarios (repro_torch/chaos/smoke.py)")
    ap.add_argument("--smoke", action="store_true",
                    help="run the seeded kill + corruption scenarios")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    if not args.smoke:
        ap.error("nothing to do (pass --smoke)")
    from repro_torch.chaos.smoke import run
    print(json.dumps(run(device=args.device)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
