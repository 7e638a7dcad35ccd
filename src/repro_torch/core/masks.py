"""Block-granular attention masks: the pattern type behind sparse flash.

A numpy-only copy of the reference's ``core/masks.py`` (the port imports
nothing of the JAX package).  A ``BlockMask`` records which (bq x bk) score
tiles of an attention matrix are visible, plus the *intra-tile* refinement
each visible tile still needs (causal edge, sliding-window edge).  It lowers
to a sorted per-row (block_row, block_col, kind) index stream, the same
shape of stream the BCSR SpMM walks, so the sparse flash kernel visits
visible tiles only.

Representation: ``tile_kinds`` is an (n_q_tiles, n_kv_tiles) int8 map:

  * ``KIND_DEAD`` (-1): tile invisible -- never walked.
  * ``0``: fully visible, no intra-tile mask needed.
  * bit ``KIND_CAUSAL`` (1): apply ``q_pos >= k_pos`` inside the tile.
  * bit ``KIND_WINDOW`` (2): apply ``q_pos - k_pos < window`` inside the tile.

Bits compose, and composition of masks (``a & b`` / ``a | b``) composes the
bits per tile, which is what makes unions like ``local | global`` exactly
representable (the global-column tiles keep causal-only refinement while the
local band keeps the window edge).  Everything here is host-side numpy on
static shapes; the lowered streams reach the kernels as int32 tensors.
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np

# The one masking constant of the port.
NEG_INF = -1e30

KIND_DEAD = -1
KIND_CAUSAL = 1
KIND_WINDOW = 2


def next_pow2(n: int, minimum: int = 8) -> int:
    """Smallest power of two >= max(n, minimum) (the stream bucket law)."""
    n = max(int(n), minimum, 1)
    return 1 << (n - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class MaskStream:
    """Lowered block-index stream: the attention analogue of BCSR indices.

    ``rows``/``cols``/``kinds`` are (capacity,) int32, sorted by (row, col);
    every block-row appears at least once (empty rows carry one KIND_DEAD
    entry, like ``spmm.ops.pad_empty_rows``), and bucket padding repeats the
    last (row, col) with KIND_DEAD so pad steps are exact no-ops.
    """
    rows: np.ndarray
    cols: np.ndarray
    kinds: np.ndarray
    n_q_tiles: int
    nnzb: int            # live entries before bucket padding

    @property
    def capacity(self) -> int:
        return int(self.rows.shape[0])


class BlockMask:
    """Block-sparse attention visibility pattern over a (sq, skv) score grid.

    ``q_offset`` is the absolute position of local q row 0 (nonzero for
    sequence-sharded sub-masks); causal/window refinements always compare
    *absolute* positions, so a shard's sub-mask stays exact.
    """

    def __init__(self, sq: int, skv: int, bq: int, bk: int,
                 tile_kinds: np.ndarray, *, window: int | None = None,
                 q_offset: int = 0):
        assert sq >= 1 and skv >= 1 and bq >= 1 and bk >= 1
        n_q = -(-sq // bq)
        n_kv = -(-skv // bk)
        tile_kinds = np.asarray(tile_kinds, np.int8)
        assert tile_kinds.shape == (n_q, n_kv), (tile_kinds.shape, n_q, n_kv)
        if window is None:
            assert not ((tile_kinds >= 0)
                        & ((tile_kinds & KIND_WINDOW) > 0)).any(), \
                "window-refined tiles need an explicit window length"
        self.sq, self.skv, self.bq, self.bk = sq, skv, bq, bk
        self.window = window
        self.q_offset = q_offset
        self.tile_kinds = tile_kinds

    # ------------------------------------------------------------ geometry
    @property
    def n_q_tiles(self) -> int:
        return self.tile_kinds.shape[0]

    @property
    def n_kv_tiles(self) -> int:
        return self.tile_kinds.shape[1]

    @property
    def nnzb(self) -> int:
        return int((self.tile_kinds >= 0).sum())

    # -------------------------------------------------------- constructors
    @classmethod
    def full(cls, sq: int, skv: int, *, bq: int = 128, bk: int = 128,
             causal: bool = False, window: int | None = None,
             q_offset: int = 0) -> "BlockMask":
        """All in-range tiles, refined by the analytic causal/window edges;
        tiles with no visible (q, k) pair are pruned from the walk."""
        kind = 0
        if causal:
            kind |= KIND_CAUSAL
        if window is not None:
            kind |= KIND_WINDOW
        n_q, n_kv = -(-sq // bq), -(-skv // bk)
        kinds = np.full((n_q, n_kv), kind, np.int8)
        m = cls(sq, skv, bq, bk, kinds, window=window, q_offset=q_offset)
        return m._pruned()

    @classmethod
    def causal(cls, sq: int, skv: int, *, bq: int = 128, bk: int = 128,
               q_offset: int = 0) -> "BlockMask":
        return cls.full(sq, skv, bq=bq, bk=bk, causal=True, q_offset=q_offset)

    @classmethod
    def sliding_window(cls, sq: int, skv: int, window: int, *, bq: int = 128,
                       bk: int = 128, causal: bool = True,
                       q_offset: int = 0) -> "BlockMask":
        return cls.full(sq, skv, bq=bq, bk=bk, causal=causal, window=window,
                        q_offset=q_offset)

    @classmethod
    def strided(cls, sq: int, skv: int, stride: int, *, bq: int = 128,
                bk: int = 128, causal: bool = True,
                q_offset: int = 0) -> "BlockMask":
        """Every ``stride``-th KV block tile (the last of each group) is
        visible to all rows -- the Sparse-Transformer column pattern; compose
        with ``sliding_window`` for the usual local+strided mask."""
        m = cls.full(sq, skv, bq=bq, bk=bk, causal=causal, q_offset=q_offset)
        kinds = m.tile_kinds.copy()
        keep = (np.arange(m.n_kv_tiles) % stride) == (stride - 1)
        kinds[:, ~keep] = KIND_DEAD
        return cls(sq, skv, bq, bk, kinds, q_offset=q_offset)

    @classmethod
    def global_cols(cls, sq: int, skv: int, n_global: int, *, bq: int = 128,
                    bk: int = 128, causal: bool = True,
                    q_offset: int = 0) -> "BlockMask":
        """The first ``n_global`` KV block tiles visible to every row
        ("global token" sinks)."""
        m = cls.full(sq, skv, bq=bq, bk=bk, causal=causal, q_offset=q_offset)
        kinds = m.tile_kinds.copy()
        kinds[:, n_global:] = KIND_DEAD
        return cls(sq, skv, bq, bk, kinds, q_offset=q_offset)

    @classmethod
    def from_dense(cls, dense, *, bq: int = 128, bk: int = 128,
                   q_offset: int = 0) -> "BlockMask":
        """Arbitrary per-row block lists from a dense boolean (sq, skv) mask.

        Block-granular: a tile with any visible element becomes fully
        visible (sub-tile structure rounds UP to the tile) -- the oracle
        (``dense_mask``) reflects the rounded semantics.
        """
        dense = np.asarray(dense, bool)
        sq, skv = dense.shape
        n_q, n_kv = -(-sq // bq), -(-skv // bk)
        padded = np.zeros((n_q * bq, n_kv * bk), bool)
        padded[:sq, :skv] = dense
        any_vis = padded.reshape(n_q, bq, n_kv, bk).any(axis=(1, 3))
        kinds = np.where(any_vis, 0, KIND_DEAD).astype(np.int8)
        return cls(sq, skv, bq, bk, kinds, q_offset=q_offset)

    # -------------------------------------------------------------- pruning
    def _bbox_visible(self) -> np.ndarray:
        """(n_q, n_kv) bool: does each tile contain >= 1 visible pair under
        its own refinement bits?  Interval tests only (no S^2 materialize);
        for the causal+window combination bbox satisfiability of each edge
        implies a jointly-visible pair, so this is exact."""
        k = self.tile_kinds
        r = np.arange(self.n_q_tiles)[:, None]
        c = np.arange(self.n_kv_tiles)[None, :]
        q_lo = self.q_offset + r * self.bq
        q_hi = self.q_offset + np.minimum(r * self.bq + self.bq, self.sq) - 1
        k_lo = c * self.bk
        k_hi = np.minimum(c * self.bk + self.bk, self.skv) - 1
        vis = (k >= 0) & (r * self.bq < self.sq) & (c * self.bk < self.skv)
        vis &= np.where((k & KIND_CAUSAL) > 0, k_lo <= q_hi, True)
        if self.window is not None:
            vis &= np.where((k & KIND_WINDOW) > 0,
                            k_hi >= q_lo - self.window + 1, True)
        return vis

    def _pruned(self) -> "BlockMask":
        kinds = np.where(self._bbox_visible(), self.tile_kinds,
                         KIND_DEAD).astype(np.int8)
        return BlockMask(self.sq, self.skv, self.bq, self.bk, kinds,
                         window=self.window, q_offset=self.q_offset)

    # --------------------------------------------------------- composition
    def _compat_window(self, other: "BlockMask") -> int | None:
        if (self.sq, self.skv, self.bq, self.bk, self.q_offset) != \
                (other.sq, other.skv, other.bq, other.bk, other.q_offset):
            raise ValueError("BlockMask geometry mismatch")
        a_w = self.window if self._uses_window() else None
        b_w = other.window if other._uses_window() else None
        if a_w is not None and b_w is not None and a_w != b_w:
            raise ValueError(
                f"cannot compose masks with different windows ({a_w} vs {b_w})")
        return a_w if a_w is not None else b_w

    def _uses_window(self) -> bool:
        k = self.tile_kinds
        return bool(((k >= 0) & ((k & KIND_WINDOW) > 0)).any())

    def __and__(self, other: "BlockMask") -> "BlockMask":
        w = self._compat_window(other)
        a, b = self.tile_kinds, other.tile_kinds
        vis = (a >= 0) & (b >= 0)
        kinds = np.where(vis, a | b, KIND_DEAD).astype(np.int8)
        m = BlockMask(self.sq, self.skv, self.bq, self.bk, kinds, window=w,
                      q_offset=self.q_offset)
        return m._pruned()   # combined bits may empty a tile

    def __or__(self, other: "BlockMask") -> "BlockMask":
        w = self._compat_window(other)
        a, b = self.tile_kinds, other.tile_kinds
        va, vb = a >= 0, b >= 0
        kinds = np.full_like(a, KIND_DEAD)
        both = va & vb
        kinds[both] = (a & b)[both]          # union keeps the laxer refinement
        kinds[va & ~vb] = a[va & ~vb]
        kinds[vb & ~va] = b[vb & ~va]
        return BlockMask(self.sq, self.skv, self.bq, self.bk, kinds, window=w,
                         q_offset=self.q_offset)

    # --------------------------------------------------------------- oracle
    def dense_mask(self) -> np.ndarray:
        """(sq, skv) boolean oracle of exactly what the kernels compute."""
        q = self.q_offset + np.arange(self.sq)[:, None]
        k = np.arange(self.skv)[None, :]
        kinds = np.repeat(np.repeat(self.tile_kinds, self.bq, axis=0),
                          self.bk, axis=1)[:self.sq, :self.skv]
        vis = kinds >= 0
        vis &= np.where((kinds & KIND_CAUSAL) > 0, q >= k, True)
        if self.window is not None:
            vis &= np.where((kinds & KIND_WINDOW) > 0,
                            q - k < self.window, True)
        return vis

    def density(self) -> dict:
        vis = self.tile_kinds >= 0
        per_row = vis.sum(axis=1)
        dense = vis.size
        return {
            "n_q_tiles": self.n_q_tiles,
            "n_kv_tiles": self.n_kv_tiles,
            "nnzb": int(vis.sum()),
            "dense_tiles": int(dense),
            "block_fill": float(vis.sum() / dense),
            "row_blocks_min": int(per_row.min()),
            "row_blocks_max": int(per_row.max()),
            "row_blocks_mean": float(per_row.mean()),
        }

    # ------------------------------------------------------------- lowering
    def lower(self, *, bucket: bool = True, min_bucket: int = 8,
              capacity: int | None = None) -> MaskStream:
        """Lower to the sorted (row, col, kind) walk stream.

        Matches the BCSR stream contract: sorted by (row, col), every
        block-row present (empty rows get one KIND_DEAD entry at col 0), and
        bucket padding repeats the last (row, col) with KIND_DEAD so padded
        steps neither init, compute, nor finalize early.
        """
        vis = self.tile_kinds >= 0
        rows, cols = np.nonzero(vis)                 # row-major == (row, col)
        kinds = self.tile_kinds[rows, cols].astype(np.int64)
        present = np.zeros(self.n_q_tiles, bool)
        present[rows] = True
        missing = np.nonzero(~present)[0]
        if missing.size:
            rows = np.concatenate([rows, missing])
            cols = np.concatenate([cols, np.zeros_like(missing)])
            kinds = np.concatenate(
                [kinds, np.full(missing.size, KIND_DEAD, np.int64)])
            order = np.argsort(rows, kind="stable")
            rows, cols, kinds = rows[order], cols[order], kinds[order]
        n = int(rows.shape[0])
        if capacity is None:
            capacity = next_pow2(n, min_bucket) if bucket else n
        assert capacity >= n, (capacity, n)
        pad = capacity - n
        if pad:
            rows = np.concatenate([rows, np.full(pad, rows[-1])])
            cols = np.concatenate([cols, np.full(pad, cols[-1])])
            kinds = np.concatenate([kinds, np.full(pad, KIND_DEAD, np.int64)])
        return MaskStream(rows.astype(np.int32), cols.astype(np.int32),
                          kinds.astype(np.int32), self.n_q_tiles, n)

    # ------------------------------------------------------------- sharding
    def shard_rows(self, n_shards: int) -> list["BlockMask"]:
        """Split into per-shard sub-masks over contiguous q-tile ranges; each
        carries its absolute ``q_offset`` so refinements stay exact."""
        nq = self.n_q_tiles
        assert nq % n_shards == 0, (nq, n_shards)
        assert self.sq == nq * self.bq, \
            "sharding requires sq aligned to bq tiles (pad first)"
        per = nq // n_shards
        sq_loc = per * self.bq
        return [
            BlockMask(sq_loc, self.skv, self.bq, self.bk,
                      self.tile_kinds[d * per:(d + 1) * per],
                      window=self.window,
                      q_offset=self.q_offset + d * sq_loc)
            for d in range(n_shards)
        ]

    # ----------------------------------------------------------- accounting
    def signature(self) -> tuple:
        """Stable pattern signature for compile accounting: two masks with
        equal signatures walk identical streams."""
        digest = zlib.crc32(np.ascontiguousarray(self.tile_kinds).tobytes())
        return ("blockmask", self.sq, self.skv, self.bq, self.bk,
                self.window, self.q_offset, int(digest))

    def __repr__(self) -> str:
        d = self.density()
        return (f"BlockMask({self.sq}x{self.skv}, tiles {self.bq}x{self.bk}, "
                f"nnzb={d['nnzb']}/{d['dense_tiles']}, window={self.window}, "
                f"q_offset={self.q_offset})")


@dataclasses.dataclass(frozen=True)
class AttnMaskSpec:
    """Hashable serving-level mask config: what serving threads to every
    layer.  ``build`` expands it to a concrete ``BlockMask`` from the
    layer's sequence length and tiles.

    * ``local=True``: route sliding-window prefill layers through the sparse
      walk (the layer's own window length applies).
    * ``pattern``: opt-in long-context mask for full-attention layers:
      ``"sliding"`` | ``"strided"`` | ``"local_global"`` (window+stride/
      n_global parameters below).
    * ``impl``: ``"sparse"`` (stream walk) | ``"dense"`` (masked full grid,
      the parity baseline) | ``"ref"`` (the materialized oracle).
    """
    local: bool = True
    pattern: str | None = None
    window: int | None = None
    stride: int | None = None
    n_global: int = 1
    impl: str = "sparse"
    bq: int | None = None
    bk: int | None = None

    def build(self, sq: int, skv: int, *, layer_window: int | None,
              bq: int, bk: int) -> BlockMask | None:
        """Concrete mask for one layer, or None if the spec doesn't apply.
        The default window ``max(bk, skv // 4)`` depends on the tiles, so
        callers that compare runs pass ``window`` (and ``bq``/``bk``)."""
        if layer_window is not None:
            if not self.local:
                return None
            return BlockMask.sliding_window(sq, skv, layer_window,
                                            bq=bq, bk=bk)
        if self.pattern is None:
            return None
        if self.pattern == "sliding":
            w = self.window or max(bk, skv // 4)
            return BlockMask.sliding_window(sq, skv, w, bq=bq, bk=bk)
        if self.pattern == "strided":
            local = BlockMask.sliding_window(sq, skv, self.window or bq,
                                             bq=bq, bk=bk)
            return BlockMask.strided(sq, skv, self.stride or 2,
                                     bq=bq, bk=bk) | local
        if self.pattern == "local_global":
            local = BlockMask.sliding_window(sq, skv,
                                             self.window or max(bk, skv // 4),
                                             bq=bq, bk=bk)
            return local | BlockMask.global_cols(sq, skv, self.n_global,
                                                 bq=bq, bk=bk)
        raise ValueError(f"unknown attn mask pattern: {self.pattern!r}")
