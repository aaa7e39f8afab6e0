"""Fault-tolerant training loop — the port of ``repro/runtime/train_loop.py``
on one device.

Wiring per step:
  data pipeline (stateless, step-keyed)  ->  train step  ->  metrics
  heartbeat + straggler EWMA             ->  policy hooks
  NaN/Inf loss                           ->  PoisonPolicy skip / rewind
  checkpoint cadence + SIGTERM           ->  async CheckpointManager

The loop takes ``device`` where the reference takes a mesh. Its train step
updates the parameters in place, so the loop runs the step's two halves:
it retries the gradients (``TrainStep.grads``, which write nothing) on a
transient failure, shows their loss to the poison policy once, and only
then applies the update (``TrainStep.apply``), which is not retried: an
update that fails part-way has written some tensors, and the error
propagates, for a resume from the last checkpoint. A skipped step so
leaves the parameters and the optimizer state as they were, as the
reference keeps its old trees. Rewind restores the last good checkpoint into the model's
parameters. The SIGTERM handler is installed for the run and the previous
one put back when it ends.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config import RunConfig
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.engine.backend import Device
from repro_torch.runtime.fault import (HeartbeatRegistry, PoisonPolicy,
                                       StragglerMonitor, retry_step)
from repro_torch.runtime.steps import TrainStep, make_train_step


@dataclass
class TrainLoopConfig:
    total_steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    keep_ckpts: int = 3


@dataclass
class TrainResult:
    losses: List[float] = field(default_factory=list)
    skipped_steps: int = 0
    rewinds: int = 0
    final_step: int = 0


class TrainLoop:
    def __init__(self, run: RunConfig, loop_cfg: TrainLoopConfig, *,
                 device: Device = None, log: Callable[[str], None] = print):
        self.run = run
        self.cfg = loop_cfg
        self.log = log
        self.ts: TrainStep = make_train_step(run, device=device)
        self.device = self.ts.device
        self.pipeline = TokenPipeline(run.model, run.shape, seed=run.seed)
        self.heartbeat = HeartbeatRegistry()
        self.poison = PoisonPolicy()
        self.straggler = StragglerMonitor()
        self.ckpt = (CheckpointManager(loop_cfg.ckpt_dir,
                                       keep=loop_cfg.keep_ckpts)
                     if loop_cfg.ckpt_dir else None)
        self._stop = False

    def _install_sigterm(self):
        """Install the handler; returns the previous one (None when not on
        the main thread, where signals cannot be handled)."""
        def handler(signum, frame):
            self.log("[train] SIGTERM — checkpointing and stopping")
            self._stop = True
        try:
            return signal.signal(signal.SIGTERM, handler)
        except ValueError:
            return None         # non-main thread (tests)

    def _save(self, step, params, opt_state, blocking=False):
        if self.ckpt is None:
            return
        self.ckpt.save(step, {"params": params, "opt": opt_state},
                       metadata={"config": self.run.to_dict()},
                       blocking=blocking)

    @torch.no_grad()
    def _restore(self, params, opt_state):
        tree, meta = self.ckpt.restore({"params": params, "opt": opt_state},
                                       device=self.device)
        for name, p in params.items():      # the model's own tensors
            p.copy_(tree["params"][name])
        return params, tree["opt"], meta["step"]

    def _batch(self, step: int) -> dict:
        n_micro = self.run.microbatches
        batch = {}
        for k, v in self.pipeline.batch(step).items():
            if n_micro > 1:     # [micro, B/micro, ...], as the step takes
                v = v.reshape((n_micro, v.shape[0] // n_micro) + v.shape[1:])
            batch[k] = torch.as_tensor(v, device=self.device)
        return batch

    def run_loop(self, *, start_step: int = 0, resume: bool = False
                 ) -> TrainResult:
        """Train to ``total_steps``: the weights drawn from a generator on
        the device seeded with ``run.seed``, or, with ``resume``, restored
        from the latest checkpoint."""
        previous = self._install_sigterm()
        try:
            return self._run(start_step, resume)
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)

    def _run(self, start_step: int, resume: bool) -> TrainResult:
        params, opt_state, ef = self.ts.init_state(
            torch.Generator(self.device).manual_seed(self.run.seed))
        step = start_step
        if resume and self.ckpt and self.ckpt.latest_step() is not None:
            params, opt_state, step = self._restore(params, opt_state)
            self.log(f"[train] resumed from step {step}")

        res = TrainResult()
        last_good = step
        while step < self.cfg.total_steps and not self._stop:
            t0 = time.monotonic()
            batch = self._batch(step)
            loss, grads = retry_step(self.ts.grads, params, batch, retries=2)
            loss = float(loss)
            verdict = self.poison.observe(loss)
            if verdict == "ok":
                params, opt_state, ef, _ = self.ts.apply(params, opt_state,
                                                         ef, grads)
                res.losses.append(loss)
            del grads
            if verdict == "skip":
                res.skipped_steps += 1
                self.log(f"[train] step {step}: non-finite loss — skipped")
            elif verdict != "ok":   # rewind
                res.rewinds += 1
                if self.ckpt and self.ckpt.latest_step() is not None:
                    self.ckpt.wait()
                    params, opt_state, last_good = self._restore(
                        params, opt_state)
                    step = last_good
                    self.log(f"[train] rewound to step {last_good}")
                    continue
            dt = time.monotonic() - t0
            self.heartbeat.beat("proc0")
            self.straggler.record("proc0", dt)
            if self.cfg.log_every and step % self.cfg.log_every == 0:
                self.log(f"[train] step {step} loss {loss:.4f} "
                         f"({dt*1e3:.0f} ms)")
            step += 1
            if self.ckpt_due(step):
                self._save(step, params, opt_state)
                last_good = step
        if self.ckpt:
            self._save(step, params, opt_state, blocking=True)
        res.final_step = step
        return res

    def ckpt_due(self, step: int) -> bool:
        return (self.ckpt is not None and self.cfg.ckpt_every
                and step % self.cfg.ckpt_every == 0)
