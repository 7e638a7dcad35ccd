"""Stream engine of the port: bucket laws, the in-flight buffer of
pipelined serving, the trace-free ``spmm_batched_stream`` of one device,
and the sharded engine -- the reference's "48 clusters" layer
(``repro/kernels/engine.py``) on ``torch.distributed``.

Occamy replicates one compute cluster behind two HBM stacks; each cluster
sees the *same* index stream and a different slice of the dense data.  The
sharded entry points keep the reference's API, global operands in and a
global result out: every rank is called with the same full operands, takes
its slice from its coordinate on the mesh axis, runs the port's unchanged
one-device kernel wrapper on it, and all-gathers the parts over that axis'
group (``torch.distributed.all_gather``, which gloo takes on CUDA tensors
as on CPU ones); every rank returns the whole result, the pads stripped.

  * **SpMM** (:func:`shard_spmm`) -- the BCSR stream replicated, the dense
    operand's N columns split (K2, or K2q for a quantized container).
  * **Batched SpMM** (:func:`shard_spmm_batched_stream` and its host-side
    wrappers) -- whole problems a rank, the shared stream replicated: the
    MoE dispatch split over ranks.
  * **SpMSpM** (:func:`shard_spmspm`) -- A's row streams replicated, B's
    column streams split: each rank owns a column stripe of C (K5).
  * **Block-sparse attention** (:func:`shard_attention_sparse`) -- the
    query axis split, each rank walking its sub-mask at its absolute
    ``q_offset`` (K4s).

Each rank runs the one-device kernel on the values of its own output tiles
in the same order, so a sharded result equals the one-device kernel's bit
for bit.  Mesh resolution (:func:`auto_mesh`): an explicit ``mesh=`` >
``parallel.context.MESH`` > a 1-D ("data",) mesh over the default process
group; with no group (or a mesh of one rank) the call is the one-device
wrapper's on the whole operand.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
from typing import Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from repro_torch import as_tensor
from repro_torch.core.formats import INVALID_KEY, BatchedBCSR
from repro_torch.kernels import tuning
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


# ---------------------------------------------------------------------------
# The sharded engine: meshes, parts and the gather.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _world_mesh(world_group, device_type: str):
    """The 1-D ("data",) mesh over the whole default group, built once a
    group and device type."""
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((dist.get_world_size(world_group),), ("data",),
                     device_type)


def auto_mesh(mesh=None, device_type: str = "cuda"):
    """Resolve (mesh, shard axis): ``mesh`` > ``parallel.context.MESH`` > a
    1-D ("data",) mesh over the default group (built for ``device_type``)
    > ``None`` when there is no process group (one rank).  The axis is
    "data" where the mesh has it, else its first."""
    if mesh is None:
        from repro_torch.parallel import context
        mesh = context.MESH
    if mesh is None and dist.is_available() and dist.is_initialized():
        mesh = _world_mesh(dist.group.WORLD, device_type)
    if mesh is None:
        return None, "data"
    names = mesh.mesh_dim_names
    return mesh, ("data" if "data" in names else names[0])


def mesh_axis(mesh, axis: str):
    """(ranks along ``axis``, this rank's coordinate on it); (1, 0) without
    a mesh."""
    if mesh is None:
        return 1, 0
    from repro_torch.parallel.sharding import axis_sizes
    return axis_sizes(mesh)[axis], mesh.get_local_rank(axis)


def part(x: torch.Tensor, dim: int, width: int, i: int,
         value=0) -> torch.Tensor:
    """Part ``i`` of ``x`` along ``dim``, ``width`` long, padded with
    ``value`` past the end of ``x``; contiguous.  Only this part is
    copied, so an expanded (broadcast) ``x`` stays a view."""
    n = x.shape[dim]
    lo = min(i * width, n)
    hi = min(lo + width, n)
    out = x.narrow(dim, lo, hi - lo)
    if hi - lo < width:
        shape = list(x.shape)
        shape[dim] = width - (hi - lo)
        out = torch.cat([out, x.new_full(shape, value)], dim)
    return out.contiguous()


def gather(t: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """Every rank's ``t`` along ``axis`` of ``mesh``, in coordinate order,
    concatenated on ``dim`` (``t`` itself on an axis of one rank)."""
    n, _ = mesh_axis(mesh, axis)
    if n == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=mesh.get_group(axis))
    return torch.cat(parts, dim)


class RankPart(NamedTuple):
    """One rank's share of a sharded call: ``run()`` launches the port's
    one-device kernel wrapper on the rank's part of the operands; the
    parts of all ranks, concatenated on ``dim`` in coordinate order and cut
    to ``keep``, are the whole result."""
    run: Callable[[], torch.Tensor]
    dim: int
    keep: tuple


def _sharded(plan, mesh, device_type: str, *args, **kw) -> torch.Tensor:
    """``plan(*args, n_dev, idx, **kw)`` (a ``*_part`` function) run on
    this rank of the mesh axis, gathered and cut."""
    mesh, axis = auto_mesh(mesh, device_type)
    rp = plan(*args, *mesh_axis(mesh, axis), **kw)
    return gather(rp.run(), rp.dim, mesh, axis)[rp.keep]


def _ceil_to(n: int, m: int) -> int:
    return -(-n // m) * m


def _resolve_bn(bn: Optional[int], n_local: int, tile_dtype: torch.dtype,
                dense: torch.Tensor) -> int:
    """The N-tile of a rank: an explicit ``bn`` as given (the kernel
    validates it); else the ``spmm`` row of ``kernels.tuning``, halved while
    the half still covers the rank's ``n_local`` columns and a column unit
    (the reference's clamp of the tile to the operand).  The tile does not
    change a column's sums."""
    if bn is not None:
        return int(bn)
    bn = tuning.spmm_bn(tile_dtype, dense.device)
    unit = tuning.spmm_col_unit(dense.dtype)
    while bn % 2 == 0 and bn // 2 >= max(n_local, unit):
        bn //= 2
    return bn


# ---------------------------------------------------------------------------
# SpMM: N-column split (replicated index stream, sliced dense operand).
# ---------------------------------------------------------------------------

def spmm_part(a, dense: torch.Tensor, n_dev: int, idx: int, *,
              bn: Optional[int] = None, nt: Optional[int] = None,
              out_dtype: torch.dtype = torch.float32) -> RankPart:
    """Rank ``idx`` of ``n_dev`` in :func:`shard_spmm`: ``spmm.ops.spmm``
    on the stream whole and its share of dense's padded N columns."""
    from repro_torch.kernels.spmm import ops as spmm_ops
    if dense.dim() != 2 or dense.shape[0] != a.shape[1]:
        raise ValueError(f"shard_spmm: A {a.shape} x dense "
                         f"{tuple(dense.shape)}")
    nt = 1 if nt is None else int(nt)
    if nt < 1:
        raise ValueError(f"nt={nt} must be >= 1")
    N = dense.shape[1]
    tile_dtype = a.blocks.dtype if a.scales is not None else dense.dtype
    bn = _resolve_bn(bn, max(1, N // n_dev), tile_dtype, dense)
    width = _ceil_to(N, n_dev * nt * bn) // n_dev
    local = part(dense, 1, width, idx)
    return RankPart(lambda: spmm_ops.spmm(a, local, bn=bn, nt=nt,
                                          out_dtype=out_dtype),
                    1, (slice(None), slice(0, N)))


def shard_spmm(a, dense: torch.Tensor, *, mesh=None, bn: Optional[int] = None,
               nt: Optional[int] = None,
               out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C = A @ dense (a ``BCSR``, K2; K2q when it has ``scales``) with
    dense's N columns split across the mesh axis.  N is padded to ``n_dev *
    nt * bn`` (the reference's arithmetic with the port's ``bn``; ``nt``
    as in ``spmm.ops``, default 1) and the pad stripped after the gather,
    so any N works on any mesh.  (M, N) in ``out_dtype`` on every rank."""
    return _sharded(spmm_part, mesh, dense.device.type, a, dense, bn=bn,
                    nt=nt, out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# Batched SpMM: batch split (whole problems a rank, MoE-style).
# ---------------------------------------------------------------------------

def spmm_batched_part(a: BatchedBCSR, dense: torch.Tensor, n_dev: int,
                      idx: int, *, bn: Optional[int] = None,
                      out_dtype: torch.dtype = torch.float32) -> RankPart:
    """Rank ``idx`` of ``n_dev`` in :func:`shard_spmm_batched_stream`:
    :func:`spmm_batched_stream` on problems ``[idx * w, (idx + 1) * w)`` of
    the batch padded to ``n_dev`` (zero blocks, scales 1.0, zero dense)
    and the shared stream whole."""
    B = a.batch
    if dense.dim() == 2:
        dense = dense.expand((B,) + tuple(dense.shape))
    if dense.shape[0] != B or dense.shape[1] != a.shape[2]:
        raise ValueError(f"shard_spmm_batched_stream: A {a.shape} x dense "
                         f"{tuple(dense.shape)}")
    w = -(-B // n_dev)
    local = dataclasses.replace(
        a, blocks=part(a.blocks, 0, w, idx), shape=(w,) + tuple(a.shape[1:]),
        scales=None if a.scales is None else part(a.scales, 0, w, idx, 1.0))
    x = part(dense, 0, w, idx)
    return RankPart(lambda: spmm_batched_stream(local, x, bn=bn,
                                                out_dtype=out_dtype),
                    0, (slice(0, B),))


def shard_spmm_batched_stream(a: BatchedBCSR, dense: torch.Tensor, *,
                              mesh=None, bn: Optional[int] = None,
                              out_dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """:func:`spmm_batched_stream` with the batch split across the mesh
    axis, whole problems a rank (:func:`spmm_batched_part`).  Never reads
    the index stream on the host: the execute phase of two-phase serving
    split over ranks.  ``dense``: (B, K, N) or a broadcast (K, N); no
    ``nt``, which a whole problem a rank has no use for.  (B, M, N) in
    ``out_dtype`` on every rank."""
    return _sharded(spmm_batched_part, mesh, dense.device.type, a, dense,
                    bn=bn, out_dtype=out_dtype)


def shard_spmm_batched(a: BatchedBCSR, dense: torch.Tensor, **kw
                       ) -> torch.Tensor:
    """C[b] = A[b] @ dense[b], the batch split across the mesh axis.
    Host-side entry: the stream is made to cover every block-row
    (``spmm.ops.pad_empty_rows``) first; keywords as
    :func:`shard_spmm_batched_stream`."""
    from repro_torch.kernels.spmm import ops as spmm_ops
    return shard_spmm_batched_stream(spmm_ops.pad_empty_rows(a), dense, **kw)


def shard_spmm_batched_bucketed(a: BatchedBCSR, dense: torch.Tensor, *,
                                min_bucket: int = 8, **kw) -> torch.Tensor:
    """:func:`shard_spmm_batched` with the stream padded to its
    power-of-two bucket (:func:`stream_bucket`) first, so calls of varying
    nnzb take a bounded set of stream shapes."""
    from repro_torch.kernels.spmm import ops as spmm_ops
    a = spmm_ops.pad_empty_rows(a)
    a = a.with_capacity(stream_bucket(a.nnzb, minimum=min_bucket))
    return shard_spmm_batched_stream(a, dense, **kw)


# ---------------------------------------------------------------------------
# SpMSpM: B-column split (each rank owns an output stripe).
# ---------------------------------------------------------------------------

def spmspm_part(a_keys, a_vals, b_keys, b_vals, n_dev: int, idx: int, *,
                rt: Optional[int] = None, ct: Optional[int] = None,
                nt: Optional[int] = None, a_scales=None,
                device=None) -> RankPart:
    """Rank ``idx`` of ``n_dev`` in :func:`shard_spmspm`:
    ``spmspm.ops.spmspm`` on A's rows padded to ``rt`` and its stripe of
    B's columns padded to ``n_dev * nt * ct`` (``INVALID_KEY``, zero
    values: they never match)."""
    from repro_torch.kernels.spmspm import ops as spmspm_ops
    ak, av, bk, bv = (as_tensor(x, device).contiguous()
                      for x in (a_keys, a_vals, b_keys, b_vals))
    R, C = ak.shape[0], bk.shape[0]
    c_local = max(1, C // n_dev)
    if rt is None or ct is None:
        trt, tct = tuning.spmspm_tiles(R, c_local, ak.shape[1], bk.shape[1],
                                       av.dtype, ak.device)
        rt, ct = rt or trt, ct or tct
    if nt is None:
        nt = tuning.spmspm_nt(c_local, ct, bk.shape[1], av.dtype, ak.device)
    elif int(nt) < 1:
        raise ValueError(f"nt={nt} must be >= 1")
    nt = int(nt)
    invalid = int(INVALID_KEY)
    r_pad = _ceil_to(R, rt)
    width = _ceil_to(C, n_dev * nt * ct) // n_dev
    if a_scales is not None:
        a_scales = part(as_tensor(a_scales, ak.device).to(
            torch.float32).reshape(R), 0, r_pad, 0, 1.0)
    args = (part(ak, 0, r_pad, 0, invalid), part(av, 0, r_pad, 0),
            part(bk, 0, width, idx, invalid), part(bv, 0, width, idx))
    return RankPart(lambda: spmspm_ops.spmspm(*args, rt=rt, ct=ct, nt=nt,
                                              a_scales=a_scales),
                    1, (slice(0, R), slice(0, C)))


def shard_spmspm(a_keys, a_vals, b_keys, b_vals, *, mesh=None,
                 rt: Optional[int] = None, ct: Optional[int] = None,
                 nt: Optional[int] = None, a_scales=None,
                 device=None) -> torch.Tensor:
    """SpMSpM (K5) with A's row streams replicated and B's column streams
    split: rank i computes C's columns of its B stripe
    (:func:`spmspm_part`); both pads are stripped.  ``a_scales`` ((R,)
    f32) carries per-row BlockQuant scales of narrow ``a_vals``.  Inputs
    as ``spmspm.ops.spmspm``; (R, C) f32 on every rank."""
    ak, av, bk, bv = (as_tensor(x, device)
                      for x in (a_keys, a_vals, b_keys, b_vals))
    return _sharded(spmspm_part, mesh, ak.device.type, ak, av, bk, bv,
                    rt=rt, ct=ct, nt=nt, a_scales=a_scales)


# ---------------------------------------------------------------------------
# Block-sparse attention: the query axis split, the BlockMask walked a shard.
# ---------------------------------------------------------------------------

def attention_sparse_part(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          mask, n_dev: int, idx: int, *,
                          scale: Optional[float] = None) -> RankPart:
    """Rank ``idx`` of ``n_dev`` in :func:`shard_attention_sparse`: K4s
    (``flash_attention.kernel.flash_attention_sparse``) on the rank's
    query rows against K / V whole (padded to ``bk``), walking its row
    sub-mask (``mask.shard_rows``) lowered to the capacity every rank
    shares (the power-of-two bucket of the largest) at its absolute
    ``q_offset``."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ops import pad_seq
    Sq, Skv = q.shape[2], k.shape[2]
    if mask.sq != Sq or mask.skv != Skv or mask.q_offset != 0:
        raise ValueError(f"shard_attention_sparse: the mask covers "
                         f"({mask.sq}, {mask.skv}) from {mask.q_offset}, "
                         f"not ({Sq}, {Skv}) from 0")
    if Sq % (n_dev * mask.bq):
        raise ValueError(f"shard_attention_sparse: Sq {Sq} is no multiple "
                         f"of {n_dev} ranks x bq {mask.bq}")
    kp = (-Skv) % mask.bk
    subs = mask.shard_rows(n_dev)
    cap = stream_bucket(max(s.lower(bucket=False).capacity for s in subs))
    stream = subs[idx].lower(capacity=cap)
    args = (part(q, 2, Sq // n_dev, idx), pad_seq(k, kp), pad_seq(v, kp),
            stream.rows, stream.cols, stream.kinds)
    return RankPart(lambda: fk.flash_attention_sparse(
        *args, skv=Skv, window=mask.window, scale=scale, bq=mask.bq,
        bk=mask.bk, q_offset=subs[idx].q_offset), 2, (slice(None),))


def shard_attention_sparse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           mask, *, mesh=None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Block-sparse flash attention (K4s) with the query axis split across
    the mesh axis (:func:`attention_sparse_part`): every part walked at its
    absolute ``q_offset``, so causal / window refinements stay exact.
    ``mask`` must cover (Sq, Skv) from position 0, with Sq a multiple of
    ``n_dev * mask.bq``.  (B, Hq, Sq, D) on every rank."""
    return _sharded(attention_sparse_part, mesh, q.device.type, q, k, v,
                    mask, scale=scale)
