"""Fault-tolerant training driver (``repro/runtime/trainer.py``).

* **Checkpoint and restart**: atomic checkpoints every ``ckpt_every``
  steps and at the end; on (re)start the driver restores the latest and
  resumes from the step after it -- the data is step-addressable, so no
  batch is lost or repeated.
* **Failure injection**: ``failure_hook(step)`` may raise
  :class:`SimulatedFailure`; :func:`run_with_restarts` catches it, builds a
  new trainer, which restores from disk, and goes on; the stitched loss
  history equals an uninterrupted run's.
* **Stragglers**: a step slower than ``straggler_factor`` times the median
  of the trailing steps is logged and counted.

``float(loss)`` is the one host sync a step: it ends the step's timing.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.optim.adamw import AdamW


class SimulatedFailure(RuntimeError):
    pass


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: str = "checkpoints"
    keep: int = 3
    straggler_factor: float = 3.0
    log_every: int = 10


class Trainer:
    def __init__(self, cfg: TrainerConfig, arch_cfg, train_step: Callable,
                 optimizer: AdamW, data: SyntheticLM, init_state: Callable,
                 failure_hook: Optional[Callable[[int], None]] = None):
        self.cfg = cfg
        self.arch_cfg = arch_cfg
        self.train_step = train_step
        self.optimizer = optimizer
        self.data = data
        self.init_state = init_state
        self.failure_hook = failure_hook
        self.ckpt = CheckpointManager(cfg.ckpt_dir, keep=cfg.keep)
        self.step_times: list = []
        self.straggler_events: list = []
        self.history: list = []

    # -------------------------------------------------------------- state --

    def _fresh_state(self):
        params = self.init_state()
        return {"params": params, "opt": self.optimizer.init(params)}

    def _restore_or_init(self):
        """(state, first step): a fresh state at step 0, or the latest
        checkpoint restored into a fresh state's structure and devices
        (the fresh one is dropped as the restored one arrives)."""
        if self.ckpt.latest_step() is None:
            return self._fresh_state(), 0
        state, step = self.ckpt.restore(self._fresh_state())
        return state, step + 1

    # ---------------------------------------------------------------- run --

    def run(self) -> dict:
        state, start = self._restore_or_init()
        for step in range(start, self.cfg.total_steps):
            if self.failure_hook:
                self.failure_hook(step)      # may raise SimulatedFailure
            batch = self.data.batch_at(step)
            t0 = time.monotonic()
            params, opt, metrics = self.train_step(
                state["params"], state["opt"], batch["tokens"],
                batch.get("embeddings"))
            loss = float(metrics["loss"])    # the step's one host sync
            dt = time.monotonic() - t0
            self._watch_stragglers(step, dt)
            state = {"params": params, "opt": opt}
            self.history.append((step, loss))
            if step % self.cfg.log_every == 0:
                print(f"step {step:5d} loss {loss:.4f} ({dt*1e3:.0f} ms)")
            if (step + 1) % self.cfg.ckpt_every == 0 or \
                    step == self.cfg.total_steps - 1:
                self.ckpt.save(step, state, metadata={"loss": loss})
        return {"state": state, "history": self.history,
                "stragglers": self.straggler_events}

    def _watch_stragglers(self, step: int, dt: float):
        self.step_times.append(dt)
        window = self.step_times[-32:]
        if len(window) >= 8:
            med = float(np.median(window[:-1]))
            if dt > self.cfg.straggler_factor * med:
                self.straggler_events.append(
                    {"step": step, "dt": dt, "median": med})


def run_with_restarts(make_trainer: Callable[[], Trainer],
                      max_restarts: int = 8) -> dict:
    """Rebuild the trainer after each :class:`SimulatedFailure` (a fresh
    process at fleet scale; a fresh :class:`Trainer` here) and resume from
    the latest checkpoint."""
    restarts = 0
    while True:
        trainer = make_trainer()
        try:
            out = trainer.run()
            out["restarts"] = restarts
            return out
        except SimulatedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
