"""Stream engine of the port on one device: bucket laws, the serial
in-flight buffer, and the trace-free counterpart of the reference's
``shard_spmm_batched_stream`` (no ``shard_map``: one GPU takes the batch).
"""
from __future__ import annotations

import collections
from typing import Optional

import torch

from repro_torch.core.formats import BatchedBCSR
from repro_torch.kernels.spmm.kernel import spmm_bcsr


def stream_bucket(nnzb: int, *, minimum: int = 8) -> int:
    """Snap a routed nonzero-block count to its power-of-two bucket: the
    stream stays within ``max(2 * nnzb, minimum)`` entries."""
    n = max(int(nnzb), int(minimum), 1)
    return 1 << (n - 1).bit_length()


def batch_bucket(n: int, *, minimum: int = 1, cap: Optional[int] = None) -> int:
    """The stream-bucket law applied to the batch dimension, clamped to
    ``cap`` (the allocated slot count) when given."""
    b = stream_bucket(n, minimum=minimum)
    return min(b, cap) if cap is not None else b


def _wait(handle) -> None:
    """Block until the device work producing ``handle`` has finished."""
    if isinstance(handle, torch.Tensor) and handle.device.type == "cuda":
        torch.cuda.current_stream(handle.device).synchronize()


class StreamPipeline:
    """Depth-bounded in-flight buffer of dispatched execute results.

    Only ``depth=0`` is ported: every :meth:`push` waits its result out at
    once, so each execute wall is the device's time for it.  (The reference's
    depth 1 keeps one execute in flight behind the next layer's host route.)
    """

    def __init__(self, depth: int = 0):
        if depth != 0:
            raise NotImplementedError(
                f"StreamPipeline depth {depth!r}: only depth 0 (serial) is "
                "ported")
        self.depth = depth
        self.pushes = 0
        self._inflight: collections.deque = collections.deque()

    def __len__(self) -> int:
        return len(self._inflight)

    def push(self, tag, handle: torch.Tensor) -> None:
        """Enqueue a dispatched result; wait the oldest out beyond depth.
        ``tag`` (the routed plan) is held with it while it is in flight."""
        self._inflight.append((tag, handle))
        self.pushes += 1
        while len(self._inflight) > self.depth:
            _wait(self._inflight.popleft()[1])

    def drain(self) -> None:
        """Wait every in-flight entry out."""
        while self._inflight:
            _wait(self._inflight.popleft()[1])


def spmm_batched_stream(a: BatchedBCSR, dense: torch.Tensor, *,
                        bn: Optional[int] = None,
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """Batched SpMM on a *pre-normalized* stream (every block-row already
    appears, as the routed-stream builder guarantees): the execute-phase
    entry of two-phase serving.  Never reads the index stream on the host.
    ``dense``: (B, K, N) or (K, N) broadcast; returns (B, M, N) in
    ``out_dtype`` (f32 by default, as the reference)."""
    B = a.batch
    if dense.dim() == 2:
        dense = dense.expand((B,) + tuple(dense.shape))
    if dense.shape[0] != B or dense.shape[1] != a.shape[2]:
        raise ValueError(f"spmm_batched_stream: A {a.shape} x dense "
                         f"{tuple(dense.shape)}")
    return spmm_bcsr(a.indptr, a.block_cols, a.blocks, dense.contiguous(),
                     out_dtype=out_dtype, bn=bn, scales=a.scales)
