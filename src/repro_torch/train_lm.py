"""End-to-end training twin: a ~100M-parameter LM for a few hundred steps,
as ``examples/train_lm.py`` runs it on the JAX package.

Config -> data pipeline -> train step (two microbatches accumulated in
float32) -> fault-tolerant loop -> async checkpoints -> resume, on one
device.

Run:  PYTHONPATH=src python -m repro_torch.train_lm [--tiny] [--steps 200]
      [--device cpu] [--ckpt-dir DIR] [--resume]
(the default device is the CUDA card; without one it raises. The default
checkpoint directory is ``repro_torch_train_lm`` under the temporary
directory, so that ``--resume`` finds the last run's.)
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.config import (ModelConfig, OptimizerConfig, RunConfig,
                                ShapeConfig)
from repro_torch.launch.train import ONE_DEVICE
from repro_torch.runtime.train_loop import TrainLoop, TrainLoopConfig


def model_100m() -> ModelConfig:
    # ~104M params: 12L x 768, GQA 12/4, SwiGLU 2048, 32k vocab
    return ModelConfig(name="lm-100m", family="dense", n_layers=12,
                       d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
                       vocab=32000, attn_chunk=256)


def model_tiny() -> ModelConfig:
    return ModelConfig(name="lm-tiny", family="dense", n_layers=2,
                       d_model=128, n_heads=4, n_kv_heads=2, d_ff=256,
                       vocab=2048, attn_chunk=64)


def make_run(model: ModelConfig, shape: ShapeConfig, steps: int,
             **kw) -> RunConfig:
    """The example's recipe: AdamW at 3e-4, warmup steps/20, two
    microbatches."""
    return RunConfig(
        model=model, shape=shape, mesh=ONE_DEVICE,
        optimizer=OptimizerConfig(name="adamw", lr=3e-4,
                                  warmup_steps=max(steps // 20, 1),
                                  total_steps=steps),
        microbatches=2, **kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_lm"))
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    model = model_tiny() if args.tiny else model_100m()
    shape = ShapeConfig(
        name="example",
        seq_len=args.seq or (128 if args.tiny else 512),
        global_batch=args.batch or (8 if args.tiny else 16),
        kind="train")
    run = make_run(model, shape, args.steps)
    n = model.n_params()
    print(f"model {model.name}: {n/1e6:.1f}M params, "
          f"batch {shape.global_batch}x{shape.seq_len}")

    loop = TrainLoop(run, TrainLoopConfig(
        total_steps=args.steps, ckpt_every=max(args.steps // 4, 1),
        ckpt_dir=args.ckpt_dir, log_every=max(args.steps // 20, 1)),
        device=args.device)
    res = loop.run_loop(resume=args.resume)
    if res.losses:
        print(f"done: step {res.final_step}, "
              f"loss {res.losses[0]:.3f} -> {res.losses[-1]:.3f} "
              f"(skipped {res.skipped_steps}, rewinds {res.rewinds})")
    else:
        print(f"done: step {res.final_step}, no step left to run")
    print(f"checkpoints: {sorted(os.listdir(args.ckpt_dir))}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
