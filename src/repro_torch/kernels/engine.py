"""Stream engine of the port on one device: bucket laws, the in-flight
buffer of pipelined serving, and the trace-free counterpart of the
reference's ``shard_spmm_batched_stream`` (no ``shard_map``: one GPU takes
the batch).
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


def _wait(event) -> None:
    """Block until the device work recorded by ``event`` has finished (a
    CPU handle carries no event: its work is done when it exists)."""
    if event is not None:
        event.synchronize()


class StreamPipeline:
    """Depth-bounded in-flight buffer of dispatched execute results: the
    serving loop's counterpart of the SpMM kernel's double-buffered K-tiles.

    :meth:`push` records a CUDA event behind a freshly *dispatched* (not
    awaited) result and keeps the routed plan that produced it -- the
    stream's tensors -- alive with it, then waits the oldest entry out
    (``event.synchronize()``, not the whole stream) while more than
    ``depth`` are in flight.

    * ``depth=0`` -- every push waits its result out at once: fully serial,
      each execute wall the device's time for it.
    * ``depth=1`` -- one execute rides in flight behind the host's route
      work for the next layer; pushing the next execute first waits out the
      previous one.

    :meth:`busy` says whether an in-flight execute is still running on the
    device (``Event.query()``): what the serving loop samples at route entry
    to count the route's fetch wait as hidden behind device work.
    """

    def __init__(self, depth: int = 0):
        if depth not in (0, 1):
            raise ValueError(
                f"StreamPipeline depth must be 0 (serial) or 1 (double "
                f"buffered), got {depth!r}")
        self.depth = depth
        self.pushes = 0
        self._inflight: collections.deque = collections.deque()

    def __len__(self) -> int:
        return len(self._inflight)

    def push(self, tag, handle) -> None:
        """Enqueue a dispatched result; wait the oldest out beyond depth.
        A failing wait (a deferred device error surfacing) releases every
        remaining entry through :meth:`abort` before it propagates."""
        event = None
        if isinstance(handle, torch.Tensor) and handle.device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(handle.device))
        self._inflight.append((tag, handle, event))
        self.pushes += 1
        try:
            while len(self._inflight) > self.depth:
                _wait(self._inflight.popleft()[2])
        except BaseException:
            self.abort()
            raise

    def busy(self) -> bool:
        """Is any in-flight entry still executing on the device?"""
        return any(ev is not None and not ev.query()
                   for _, _, ev in self._inflight)

    def drain(self) -> None:
        """Wait every in-flight entry out; exception-safe as :meth:`push`,
        so the queue is empty either way."""
        try:
            while self._inflight:
                _wait(self._inflight.popleft()[2])
        except BaseException:
            self.abort()
            raise

    def abort(self) -> None:
        """Release every in-flight entry without raising: a best-effort
        wait that swallows deferred device errors (they have surfaced or
        are being handled by the caller), so the next step starts from an
        empty pipeline."""
        while self._inflight:
            try:
                _wait(self._inflight.popleft()[2])
            except Exception:
                pass


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
