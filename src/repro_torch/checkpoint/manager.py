"""Atomic checkpoints in the reference's layout, readable by both packages.

The port of ``repro/checkpoint/manager.py``.  A save writes
``step_<N>.tmp/leaves.npz`` (one ``leaf_<i>`` array a leaf, numbered in
``jax.tree.flatten`` order: ``tree.leaves``) and ``meta.json``, renames the
directory to ``step_<N>`` (atomic on POSIX), then points ``LATEST`` at it
and removes all but the newest ``keep`` steps.  A torn write is never taken
for a checkpoint, and a crash between the rename and ``LATEST`` is
tolerated: the newest complete step is found by its directory.

``np.savez`` cannot hold bf16 or fp8, so those leaves are stored as their
bytes (uint8, the last dim times the item size) with their dtype names in
``meta.json``'s ``leaf_dtypes`` and their shapes in ``leaf_shapes``, as the
reference stores its ``ml_dtypes`` leaves; the port reads them back with
torch views, without ``ml_dtypes``.  So the reference restores what the
port writes and the port restores what the reference writes.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, tree

# dtypes stored as bytes, by the names both packages write in leaf_dtypes
_BYTE_DTYPES = {"bfloat16": torch.bfloat16,
                "float8_e4m3fn": torch.float8_e4m3fn,
                "float8_e5m2": torch.float8_e5m2}
_BYTE_NAMES = {v: k for k, v in _BYTE_DTYPES.items()}


def _pack_leaf(t) -> Tuple[np.ndarray, Optional[str]]:
    """A leaf as a numpy array for ``np.savez``; a bf16 / fp8 tensor as its
    bytes, with its dtype name."""
    t = torch.as_tensor(t).detach().cpu().contiguous()
    name = _BYTE_NAMES.get(t.dtype)
    if name is None:
        return t.numpy(), None
    flat = t.reshape(t.shape if t.dim() else (1,))
    return flat.view(torch.uint8).numpy(), name


def _unpack_leaf(raw: np.ndarray, dtype_name: Optional[str],
                 shape) -> torch.Tensor:
    t = torch.from_numpy(np.array(raw))        # a writable copy, 0-d kept
    if dtype_name is None:
        return t
    return t.reshape(-1).view(_BYTE_DTYPES[dtype_name]).reshape(shape)


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # ----------------------------------------------------------- writing --

    def save(self, step: int, state: Any, metadata: Optional[dict] = None):
        """Write ``step_<N>.tmp``, rename it to ``step_<N>``, point
        ``LATEST`` at it, drop old steps."""
        tmp = self.dir / f"step_{step}.tmp"
        final = self.dir / f"step_{step}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir()
        packed, dtypes, shapes = [], {}, {}
        for i, leaf in enumerate(tree.leaves(state)):
            raw, name = _pack_leaf(leaf)
            packed.append(raw)
            if name is not None:
                dtypes[str(i)] = name
                shapes[str(i)] = list(leaf.shape)
        np.savez(tmp / "leaves.npz",
                 **{f"leaf_{i}": a for i, a in enumerate(packed)})
        (tmp / "meta.json").write_text(json.dumps({
            "step": step,
            "treedef": f"repro_torch tree of {len(packed)} leaves",
            "n_leaves": len(packed),
            "leaf_dtypes": dtypes,     # only the byte-packed leaves
            "leaf_shapes": shapes,
            "metadata": metadata or {},
        }))
        os.replace(tmp, final)                      # atomic on POSIX
        latest_tmp = self.dir / "LATEST.tmp"
        latest_tmp.write_text(str(step))
        os.replace(latest_tmp, self.dir / "LATEST")
        self._gc()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    # ----------------------------------------------------------- reading --

    def all_steps(self):
        return [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                if not p.name.endswith(".tmp")]

    def latest_step(self) -> Optional[int]:
        f = self.dir / "LATEST"
        if f.exists():
            step = int(f.read_text().strip())
            if (self.dir / f"step_{step}").exists():
                return step
        # no pointer, or a crash between the rename and the pointer
        steps = self.all_steps()
        return max(steps) if steps else None

    def restore(self, like: Any, step: Optional[int] = None, *,
                device=None) -> Tuple[Any, int]:
        """The checkpoint of ``step`` (default the latest) in the structure
        of ``like``, each leaf in the checkpoint's dtype on ``device``
        (default: the device of ``like``'s leaf where it is a tensor, else
        the card).  Returns (state, step)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        d = self.dir / f"step_{step}"
        meta = json.loads((d / "meta.json").read_text())
        like_leaves = tree.leaves(like)
        if meta["n_leaves"] != len(like_leaves):
            raise ValueError(f"checkpoint has {meta['n_leaves']} leaves, the "
                             f"tree has {len(like_leaves)}")
        dtypes = meta.get("leaf_dtypes", {})
        shapes = meta.get("leaf_shapes", {})
        out = []
        with np.load(d / "leaves.npz") as blob:
            for i, ref in enumerate(like_leaves):
                t = _unpack_leaf(blob[f"leaf_{i}"], dtypes.get(str(i)),
                                 tuple(shapes.get(str(i), ())))
                if tuple(t.shape) != tuple(ref.shape):
                    raise ValueError(f"leaf {i}: checkpoint shape "
                                     f"{tuple(t.shape)}, tree "
                                     f"{tuple(ref.shape)}")
                dev = (resolve_device(device) if device is not None else
                       ref.device if isinstance(ref, torch.Tensor) else
                       resolve_device("cuda"))
                out.append(t.to(dev))
        return tree.unflatten(like, out), step

    def metadata(self, step: int) -> dict:
        return json.loads(
            (self.dir / f"step_{step}" / "meta.json").read_text())["metadata"]
