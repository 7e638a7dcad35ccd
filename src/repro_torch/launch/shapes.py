"""The reference's input-shape grid (``repro/launch/shapes.py``): the
:class:`ShapeSpec` a step factory takes (the reference's abstract inputs
for its dry run are not ported).

Four shapes for each architecture (the pool's definition):
  train_4k     seq 4,096   global_batch 256   -> train_step
  prefill_32k  seq 32,768  global_batch 32    -> serve prefill
  decode_32k   seq 32,768  global_batch 128   -> serve_step (1 new token)
  long_500k    seq 524,288 global_batch 1     -> serve_step (SSM/hybrid/SWA)
"""
from __future__ import annotations

import dataclasses
from typing import Dict


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int
    microbatches: int = 1   # gradient-accumulation steps for train


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}
