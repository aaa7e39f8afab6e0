"""Training launcher — the port of ``repro/launch/train.py``.

Pick an architecture (full or smoke) and run the fault-tolerant loop on
one device (the CUDA card unless ``--device cpu``; without a card it
raises). The flags are the reference's; the mesh is the one device.

Examples:
  python -m repro_torch.launch.train --arch granite-3-2b --smoke --steps 200
  python -m repro_torch.launch.train --arch granite-3-2b --smoke \\
      --steps 20 --device cpu
  python -m repro_torch.launch.train --arch grok-1-314b --smoke \\
      --optimizer adafactor --steps 20 --device cpu
  python -m repro_torch.launch.train --arch llava-next-34b --smoke \\
      --optimizer adafactor --steps 20 --device cpu
  python -m repro_torch.launch.train --arch whisper-small --smoke \\
      --steps 20 --microbatches 2 --device cpu
  python -m repro_torch.launch.train --arch xlstm-350m --smoke \\
      --steps 20 --device cpu
  python -m repro_torch.launch.train --arch zamba2-7b --smoke \\
      --steps 20 --device cpu

A VLM's batches carry the pipeline's patch-embedding stub
(``prefix_embeds``) beside its text tokens, an audio model's its
frame-embedding stub (``frame_embeds``) beside its decoder tokens.
"""
from __future__ import annotations

import argparse

from repro_torch.config import (MeshConfig, OptimizerConfig, RunConfig,
                                ShapeConfig)
from repro_torch.configs import get_arch
from repro_torch.configs.shapes import SMOKE_TRAIN, get_shape
from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig

#: the one device, as a mesh config (what ``RunConfig.mesh`` records)
ONE_DEVICE = MeshConfig(shape=(1, 1), axes=("data", "model"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=0,
                    help="override global batch")
    ap.add_argument("--seq", type=int, default=0, help="override seq len")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    model_cfg = get_arch(args.arch, smoke=args.smoke)
    shape = SMOKE_TRAIN if args.smoke else get_shape("train_4k")
    if args.batch or args.seq:
        shape = ShapeConfig(
            name="custom",
            seq_len=args.seq or shape.seq_len,
            global_batch=args.batch or shape.global_batch,
            kind="train")

    run = RunConfig(
        model=model_cfg, shape=shape, mesh=ONE_DEVICE,
        optimizer=OptimizerConfig(
            name=args.optimizer, lr=args.lr, warmup_steps=args.steps // 20,
            total_steps=args.steps, compress_grads=args.compress_grads),
        microbatches=args.microbatches, seed=args.seed)

    loop = TrainLoop(run, TrainLoopConfig(
        total_steps=args.steps, ckpt_every=args.ckpt_every,
        ckpt_dir=args.ckpt_dir), device=args.device)
    res = loop.run_loop(resume=args.resume)
    if res.losses:
        print(f"[train] done at step {res.final_step} on {loop.device}; "
              f"loss {res.losses[0]:.4f} -> {res.losses[-1]:.4f}; "
              f"skipped {res.skipped_steps}, rewinds {res.rewinds}")
    else:
        print(f"[train] done at step {res.final_step} on {loop.device}; "
              f"no step left to run")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
