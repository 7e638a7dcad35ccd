"""The port's fault-tolerant trainer on the CPU (``runtime.trainer``).

qwen3-1.7b SMOKE at the f32 policy, ``SyntheticLM`` batches of 2 x 16,
AdamW(1e-3), checkpoints every 4 steps:

* a 12-step run checkpoints at steps 3, 7, 11 and its losses equal the
  reference ``Trainer``'s from the same params within 1e-4 (``LOSS_TOL``);
* two injected failures under ``run_with_restarts``: the stitched loss
  history equals an uninterrupted run's exactly (the CPU repeats its
  arithmetic, and a checkpoint restores every bit);
* a run resumed from a checkpoint the **reference** wrote (its trainer
  stopped after 8 steps) gives the reference's uninterrupted steps 8-11
  within 1e-4;
* the straggler watchdog, and the CLI ``python -m
  repro_torch.launch.train`` on the CPU (the card by default: refused
  without one).
"""
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.data.pipeline import SyntheticLM as RSyntheticLM
from repro.models import model as RM
from repro.optim import adamw as RA
from repro.runtime import trainer as RT

from repro_torch import configs
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.interop import params_from_jax
from repro_torch.launch.shapes import ShapeSpec
from repro_torch.launch.steps import make_train_step
from repro_torch.optim.adamw import AdamW
from repro_torch.runtime.trainer import (SimulatedFailure, Trainer,
                                         TrainerConfig, run_with_restarts)

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "qwen3-1.7b"
RCFG = dataclasses.replace(r_get_smoke(ARCH), policy="f32")
CFG = dataclasses.replace(configs.get_smoke(ARCH), policy="f32")
# port vs reference losses over 12 steps: the gradients agree to ~1e-6, but
# Adam moves a weight by about lr times the sign of its gradient, so an
# element whose gradient is near 0 can move on one side and not the other
# (measured: 1.5e-5 at most)
LOSS_TOL = 1e-4


def _rparams():
    return RM.init_params(jax.random.PRNGKey(0), RCFG)


def _trainer(tmp, total=12, hook=None) -> Trainer:
    opt = AdamW(lr=1e-3)
    step = make_train_step(CFG, ShapeSpec("t", "train", 16, 2), opt,
                           seq_chunk=8)
    return Trainer(
        TrainerConfig(total_steps=total, ckpt_every=4, ckpt_dir=str(tmp),
                      log_every=1000),
        CFG, step, opt, SyntheticLM(CFG, batch=2, seq_len=16, seed=0),
        init_state=lambda: params_from_jax(jax.device_get(_rparams()), CFG,
                                           device="cpu", train=True),
        failure_hook=hook)


def _ref_trainer(tmp, total=12) -> "RT.Trainer":
    opt = RA.AdamW(lr=1e-3)

    @jax.jit
    def step(params, opt_state, tokens):
        loss, grads = jax.value_and_grad(
            lambda p: RM.loss_fn(p, tokens, RCFG))(params)
        new_p, new_o = opt.update(grads, opt_state, params)
        return new_p, new_o, {"loss": loss,
                              "grad_norm": RA.global_norm(grads)}

    return RT.Trainer(
        RT.TrainerConfig(total_steps=total, ckpt_every=4, ckpt_dir=str(tmp),
                         log_every=1000),
        RCFG, step, opt, RSyntheticLM(RCFG, batch=2, seq_len=16, seed=0),
        init_state=_rparams)


def test_trainer_runs_checkpoints_and_matches_reference(tmp_path):
    out = _trainer(tmp_path / "port").run()
    assert [s for s, _ in out["history"]] == list(range(12))
    mgr = CheckpointManager(tmp_path / "port")
    assert sorted(mgr.all_steps()) == [3, 7, 11] and mgr.latest_step() == 11
    assert mgr.metadata(11)["loss"] == out["history"][-1][1]
    ref = _ref_trainer(tmp_path / "ref").run()
    for (s, a), (rs, b) in zip(out["history"], ref["history"]):
        assert s == rs and abs(a - b) <= LOSS_TOL, (s, a, b)


def test_restart_gives_the_identical_trajectory(tmp_path):
    clean = _trainer(tmp_path / "clean").run()
    crashes = {5: True, 9: True}

    def hook(step):
        if crashes.pop(step, None):
            raise SimulatedFailure(f"injected at {step}")

    trainers = []

    def make():
        trainers.append(_trainer(tmp_path / "ft", hook=hook))
        return trainers[-1]

    out = run_with_restarts(make)
    assert out["restarts"] == 2 and len(trainers) == 3
    # each restart resumes after the last checkpoint (steps 3 and 7)
    assert [t.history[0][0] for t in trainers] == [0, 4, 8]
    stitched = {}
    for t in trainers:
        stitched.update(dict(t.history))
    assert stitched == dict(clean["history"])


def test_resumes_from_a_reference_checkpoint(tmp_path):
    """The reference's trainer stops after 8 steps (checkpoints at 3 and
    7); the port's trainer on the same directory restores step 7 and runs
    steps 8-11, which equal the reference's uninterrupted run."""
    d = tmp_path / "shared"
    _ref_trainer(d, total=8).run()
    port = _trainer(d).run()
    assert [s for s, _ in port["history"]] == [8, 9, 10, 11]
    ref = dict(_ref_trainer(tmp_path / "ref").run()["history"])
    for s, loss in port["history"]:
        assert abs(loss - ref[s]) <= LOSS_TOL, (s, loss, ref[s])


def test_straggler_watchdog(tmp_path):
    t = _trainer(tmp_path, total=0)
    for step, dt in enumerate([1.0] * 9 + [3.5, 1.0, 2.9]):
        t._watch_stragglers(step, dt)
    assert [e["step"] for e in t.straggler_events] == [9]
    assert t.straggler_events[0]["median"] == 1.0


def test_train_cli_on_the_cpu(tmp_path):
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
           "--smoke", "--steps", "6", "--batch", "2", "--seq", "16",
           "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "3",
           "--policy", "f32"]
    r = subprocess.run(cmd + ["--device", "cpu"], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "done on cpu" in r.stdout
    assert CheckpointManager(tmp_path / "ck").latest_step() == 5
    if not torch.cuda.is_available():
        r = subprocess.run(cmd, capture_output=True, text=True, env=env,
                           cwd=ROOT, timeout=300)
        assert r.returncode != 0 and "device='cpu'" in r.stderr
