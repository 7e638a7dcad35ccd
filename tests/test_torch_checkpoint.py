"""Checkpoints across the two packages, on the CPU.

``checkpoint.manager.CheckpointManager`` writes the reference's layout:
``leaves.npz`` with one array a leaf in ``jax.tree.flatten`` order,
``meta.json`` with the byte-packed dtypes (bf16, fp8) and their shapes,
the atomic rename of ``step_<N>.tmp``, then ``LATEST``.  Held here, every
leaf compared exactly (``np.array_equal`` on the bits):

* a checkpoint the reference writes of a train state (params and an
  ``AdamWState``; f32 params, and bf16 params with an f32 master) restores
  in the port into the port's structure, and the port's into the
  reference's ``restore``; fp8 and 0-d bf16 leaves both ways too;
* the port's leaf order is ``jax.tree.leaves``';
* ``keep`` garbage collection, ``LATEST``, a crash between the rename and
  the pointer, a stale ``.tmp`` directory, and mismatched trees refused.
"""
import json
import shutil

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RManager
from repro.configs import get_smoke as r_get_smoke
from repro.launch.steps import cast_params_bf16 as r_cast_params_bf16
from repro.models import model as RM
from repro.optim import adamw as RA

from repro_torch import configs, to_tensor, tree
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.interop import opt_state_from_jax, params_from_jax
from repro_torch.launch.steps import cast_params_bf16
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamW


def _bits(x) -> np.ndarray:
    """An array's bytes, whatever its dtype (torch or numpy / jax)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        return x.reshape(-1).view(torch.uint8).numpy()
    return np.frombuffer(np.ascontiguousarray(np.asarray(x)).tobytes(),
                         np.uint8)


def _same(port_tree, ref_tree) -> None:
    a, b = tree.leaves(port_tree), jax.tree.leaves(ref_tree)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert tuple(x.shape) == tuple(np.shape(y))
        assert x.dtype == to_tensor(np.asarray(y)).dtype
        assert np.array_equal(_bits(x), _bits(y))


def _ref_state(bf16: bool):
    """A reference train state after one AdamW step (so m, v and count are
    not zeros): qwen3-1.7b SMOKE params, f32, or bf16 with a master."""
    cfg = r_get_smoke("qwen3-1.7b")
    params = RM.init_params(jax.random.PRNGKey(0), cfg)
    if bf16:
        params = r_cast_params_bf16(params)
    opt = RA.AdamW(lr=1e-3, master_weights=bf16)
    state = opt.init(params)
    grads = jax.tree.map(lambda p: jnp.full_like(p, 0.01), params)
    params, state = opt.update(grads, state, params)
    return jax.device_get({"params": params, "opt": state})


def _port_like(ref_state, bf16: bool):
    """The port's structure of the same state (leaves from interop)."""
    cfg = configs.get_smoke("qwen3-1.7b")
    return {"params": params_from_jax(ref_state["params"], cfg,
                                      device="cpu", train=True),
            "opt": opt_state_from_jax(ref_state["opt"], device="cpu")}


@pytest.mark.parametrize("bf16", [False, True])
def test_port_restores_a_reference_checkpoint(tmp_path, bf16):
    ref = _ref_state(bf16)
    RManager(tmp_path).save(4, ref, metadata={"loss": 1.5})
    like = _port_like(ref, bf16)
    like = tree.map(torch.zeros_like, like)
    got, step = CheckpointManager(tmp_path).restore(like, device="cpu")
    assert step == 4
    _same(got, ref)
    assert CheckpointManager(tmp_path).metadata(4) == {"loss": 1.5}
    if bf16:
        assert got["params"]["embed"].dtype == torch.bfloat16
        assert got["opt"].master is not None


@pytest.mark.parametrize("bf16", [False, True])
def test_reference_restores_a_port_checkpoint(tmp_path, bf16):
    cfg = configs.get_smoke("qwen3-1.7b")
    params = M.init_params(cfg, device="cpu", param_dtype=torch.float32)
    if bf16:
        params = cast_params_bf16(params)
    opt = AdamW(lr=1e-3, master_weights=bf16)
    state = opt.init(params)
    grads = tree.map(lambda p: torch.full_like(p, 0.01), params)
    params, state = opt.update(grads, state, params)
    port = {"params": params, "opt": state}
    CheckpointManager(tmp_path).save(7, port)
    meta = json.loads((tmp_path / "step_7" / "meta.json").read_text())
    assert bool(meta["leaf_dtypes"]) == bf16
    like = jax.eval_shape(lambda: _ref_state(bf16))
    got, step = RManager(tmp_path).restore(like)
    assert step == 7
    _same(port, jax.device_get(got))


def _odd_tree(e5m2: bool):
    """fp8, bf16 (0-d too), int32 and f32 leaves in dicts and a tuple;
    ``e5m2`` adds a float8_e5m2 leaf."""
    rng = np.random.default_rng(31)
    out = {"a": rng.normal(size=(3, 5)).astype(ml_dtypes.float8_e4m3fn),
           "b": (np.asarray(1.25, ml_dtypes.bfloat16),
                 rng.normal(size=(2, 3)).astype(ml_dtypes.bfloat16)),
           "c": {"n": np.asarray(3, np.int32),
                 "x": rng.normal(size=(2, 2)).astype(np.float32)}}
    if e5m2:
        out["d"] = rng.normal(size=(4,)).astype(ml_dtypes.float8_e5m2)
    return out


def test_narrow_leaves_cross_both_ways(tmp_path):
    """The reference's writer packs the ``ml_dtypes`` of numpy kind "V"
    (bf16, float8_e4m3fn); it leaves float8_e5m2 (kind "f" in this
    ml_dtypes) to ``np.savez``, which numpy cannot load back, so its
    checkpoints carry no e5m2 leaf here.  The port packs all three, and
    the reference reads the port's e5m2 leaf by its name."""
    ref = _odd_tree(e5m2=False)
    RManager(tmp_path / "r").save(1, ref)
    got, _ = CheckpointManager(tmp_path / "r").restore(
        tree.map(to_tensor, ref), device="cpu")
    _same(got, ref)
    ref = _odd_tree(e5m2=True)
    port = tree.map(to_tensor, ref)
    CheckpointManager(tmp_path / "p").save(2, port)
    meta = json.loads((tmp_path / "p" / "step_2" / "meta.json").read_text())
    assert sorted(meta["leaf_dtypes"].values()) == [
        "bfloat16", "bfloat16", "float8_e4m3fn", "float8_e5m2"]
    back, _ = RManager(tmp_path / "p").restore(ref)
    _same(port, jax.device_get(back))


def test_leaf_order_is_jax_flatten_order():
    ref = _ref_state(True)
    port = _port_like(ref, True)
    assert [tuple(t.shape) for t in tree.leaves(port)] == \
        [np.shape(x) for x in jax.tree.leaves(ref)]
    _same(port, ref)


def _tiny():
    return {"w": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "s": (torch.tensor(2, dtype=torch.int32),)}


def test_gc_keeps_the_newest_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, tree.map(lambda t: t + s, _tiny()))
    assert sorted(mgr.all_steps()) == [3, 4]
    assert mgr.latest_step() == 4
    got, step = mgr.restore(_tiny(), device="cpu")
    assert step == 4 and torch.equal(got["w"], _tiny()["w"] + 4)
    got3, _ = mgr.restore(_tiny(), step=3, device="cpu")
    assert torch.equal(got3["s"][0], torch.tensor(5, dtype=torch.int32))


def test_crash_between_rename_and_latest(tmp_path):
    """LATEST still names step 2 (gone) after step 5's rename: the newest
    complete step wins; a stale ``.tmp`` directory is never taken."""
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(2, _tiny())
    mgr.save(5, tree.map(lambda t: t * 3, _tiny()))
    (tmp_path / "LATEST").write_text("2")
    shutil.rmtree(tmp_path / "step_2")
    (tmp_path / "step_9.tmp").mkdir()
    assert mgr.latest_step() == 5
    assert RManager(tmp_path).latest_step() == 5
    got, step = mgr.restore(_tiny(), device="cpu")
    assert step == 5 and torch.equal(got["w"], _tiny()["w"] * 3)
    (tmp_path / "LATEST").unlink()
    assert mgr.latest_step() == 5


def test_restore_refuses_another_tree(tmp_path):
    mgr = CheckpointManager(tmp_path)
    with pytest.raises(FileNotFoundError):
        mgr.restore(_tiny())
    mgr.save(0, _tiny())
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore({"w": torch.zeros(2, 3)}, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        mgr.restore({"w": torch.zeros(3, 2),
                     "s": (torch.tensor(0, dtype=torch.int32),)},
                    device="cpu")
