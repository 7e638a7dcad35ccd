"""Tile table for the port's kernels, keyed by (op, dtype bucket, platform).

The ``cpu`` rows are the reference's CPU rows (``repro/kernels/tuning.py``):
on the CPU the port runs the plain PyTorch versions, and the MoE dispatch
geometry (``block``, ``min_bucket``) must equal the reference's so the routed
stream matches it entry for entry.  The ``cuda`` rows are this port's own
choice for the Hopper kernels, not carried over from the TPU rows:

* ``block`` (8, 8): the 0/1 (slot, token) dispatch matrix has one nonzero per
  token column, so small square blocks keep the routed stream sparse.
* ``bn``: the output columns of one SpMM thread block
  (``spmm/csrc/spmm_bcsr.cu``).  Each thread owns one 16-byte vector of
  dense along N (8 bf16 or 4 f32 columns) of the block's 8 or 16 rows, so
  ``bn`` is a multiple of :func:`spmm_col_unit` (a warp of vectors: 256
  bf16, 128 f32 columns) and at most 8 of them.  1024 for the MoE dispatch
  and wide blocks: 128 threads on bf16 (5 tiles at d_model 5120), four
  blocks an SM; on the dispatch streams 256 and 512 were 1.3-2x slower and
  2048 5-11 % slower (``tools/compare_spmm.py``, NVIDIA H100 80GB HBM3,
  700 W).
* K2q (narrow blocks) has a tile of its own, the ``fp8`` row: ``bn`` 128
  and ``group`` 8.  Its thread block of eight warps owns a group of
  consecutive block-rows x ``bn`` columns, each warp 8 output rows x 128
  columns, so ``group`` = 8 / (bm / 8) / (bn / 128) (:func:`spmm_quant_group`:
  8 block-rows of 8 x 8 blocks at bn 128, 4 of 16 x 8); every dense K-tile
  is staged once for the whole group.
* ``min_bucket`` 8: the port compiles nothing per stream shape, so the nnzb
  bucket floor only bounds zero-block work on one-token decode streams.
* ``flash`` (bq, bk) 64 x 64, for K3 and the masked kernels K4m / K4s
  alike, f32 and bf16: the flash kernels
  (``flash_attention/csrc/flash_attention.cu``) take tiles of at most 64 x
  64 (``flash_smem_bytes``).  bf16 runs on the tensor cores: one 64-row
  wgmma per q tile, the bf16 Q tile and a three-stage K / V ring in swizzled
  shared memory, 113 KB at D = 128 whatever the tile (a smaller tile is
  computed 64 wide and masked), so that two blocks share an SM; 173,056
  bytes at D = 192 and 230,400 at D = 256, one block an SM.  f32 runs on
  the CUDA cores, with f32 Q, K, V and score tiles, 115 KB at D = 128,
  164,608 bytes at D = 192 and 213,760 at D = 256 (``_flash_clamp`` would
  halve ``bk`` past :data:`SMEM_BUDGET`).
  At S = 2048 a 64-wide tile also resolves a local window finer than a
  128-wide one (275 of 528 causal tiles visible under a local window of
  512 plus one global tile, against 81 of 136).
* ``stencil2d`` ``tile`` (and the 3-D ``general_tile``, for a 3-D spec
  that is neither j3d27pt's nor j3d7pt's pattern): the output tile of one
  block of the general stencil kernel (32 x 8 threads, 16 outputs each),
  whose (tile + 2r) halo is staged in f32 shared memory: 19 KB at (32,
  128), 26 KB at (8, 8, 64).  The kernels bound-check the ragged edge, so
  a tile needs no alignment.
* ``stencil3d`` ``tile`` (tz, ty, tx): K6b's march, a block of (tx / 4) x
  ty threads, 4 x outputs a thread, walking tz output planes over a (ty,
  tx) footprint with a ring of 4 staged planes of (ty + 2) x (tx + 4)
  values.  (64, 16, 64): 256 threads, the most a march block takes, so
  that 4 blocks of j3d27pt (at most 64 registers) share an SM; a 19.6 KB
  f32 ring; the z halo 2 / 64 of the planes.  At 512^3 f32 every tile
  from (32, 16, 64) to (256, 16, 64), (64, 4, 256) or (64, 32, 32) took
  within 4 % of it on j3d27pt and 8 % on j3d7pt, and marching all 512
  planes in one block was slower (``tools/compare_stencil.py --tiles``,
  NVIDIA H100 80GB HBM3, 700 W).  No tile changes a bit.
* ``spmspm``: ``rt`` A rows per thread block, one warp each, and ``nt *
  ct`` the slab width W: the output columns one warp accumulates in f32
  shared memory while it walks its row's keys (``spmspm/csrc/
  spmspm_ell.cu``, a row-wise product over B bucketed by key and slab).
  W = 2048 (8 KB a warp) cuts an 8192-column B into 4 slabs, so that a
  bucket holds ~20 entries at 1 % density (most of a warp's 32 lanes) and
  24 warps fit an SM: at 8192^2, A 5 % x B 1 %, the product took 1.34 /
  0.89 / 1.49 ms at W 1024 / 2048 / 4096 (more keys of fewer entries each
  at 1024, too few warps in flight at 4096; ``tools/compare_spmspm.py``,
  H100).  ``rt`` 1 (a block of one warp) was 1.5-3 % faster than 2, 4 or
  8 there: each warp reads its own row, so ``rt`` changes no traffic, only
  how finely the blocks fill the SMs.  No value of either changes a bit.
* ``wkv`` ``chunk`` 128: the WKV kernel (``wkv/csrc/wkv.cu``) gives each
  of its 8 warps a 16-row strip of the chunk and keeps the scores in
  registers; shared memory (``wkv_smem_bytes``) holds the chunk's r and w,
  its k and v and the next chunk's (fetched behind the products), the
  (64, 64) state, all f32, and a few rows: 215,040 bytes at 128, one block
  an SM.  It is the kernel's one chunk: the chunk changes no result beyond
  rounding, so on the card T is padded to it and never clamped (the
  reference's clamp holds on the CPU).

The ``cpu`` rows of these ops are the reference's CPU rows, and the
helpers give the reference's CPU tiles for them (``tests/test_torch_stencil``
and ``tests/test_torch_spmspm`` hold them equal); the plain versions that run
on the CPU take no tile.  1-byte dtypes key the ``fp8`` rows, as quantized
``spmm`` keys its tile on the narrow block dtype.

* ``router_tiles``: R1's tile (``router/csrc/router.cu``), from the token
  count T, the experts E and the card's SM count, not a table row: at most
  :data:`ROUTER_FEW_TOKENS` tokens take the few-token kernel (a warp a
  token and a few experts, W read straight from memory), more take the
  many-token kernel (W and x staged in shared memory, several tokens a
  warp).  No tile changes a bit.

The ``cpu`` flash rows keep the reference's 128 x 128 (its ``flash`` and
``flash_sparse`` CPU rows are equal) and its sublane / VMEM clamp, so that
CPU tiles, and with them every tile-granular mask, equal the reference's.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

# The reference's CPU clamp (``repro/kernels/tuning.py``): sequences round
# up to the 8-row sublane, and a K/V tile halves while its working set would
# exceed the VMEM budget.
SUBLANE = 8
LANE = 128
VMEM_BUDGET = 8 * 2**20
# Shared memory one CUDA thread block may use on Hopper (227 KB).
SMEM_BUDGET = 232448
# Largest (bq, bk) tile the flash kernels take.
FLASH_MAX_TILE = 64
# The one chunk the WKV kernel takes.
WKV_CHUNK = 128

_TABLE: Dict[Tuple[str, str, str], Dict[str, Any]] = {
    ("spmm", "f32", "cpu"): {"bn": 128},
    ("spmm", "bf16", "cpu"): {"bn": 128},
    ("spmm", "fp8", "cpu"): {"bn": 128},
    ("spmm", "f32", "cuda"): {"bn": 1024},
    ("spmm", "bf16", "cuda"): {"bn": 1024},
    ("spmm", "fp8", "cuda"): {"bn": 128, "group": 8},
    ("moe_dispatch", "f32", "cpu"): {"block": (8, 8), "bn": 128,
                                     "min_bucket": 8},
    ("moe_dispatch", "bf16", "cpu"): {"block": (8, 8), "bn": 128,
                                      "min_bucket": 8},
    ("moe_dispatch", "f32", "cuda"): {"block": (8, 8), "bn": 1024,
                                      "min_bucket": 8},
    ("moe_dispatch", "bf16", "cuda"): {"block": (8, 8), "bn": 1024,
                                       "min_bucket": 8},
    ("wkv", "f32", "cpu"): {"chunk": 128},
    ("wkv", "bf16", "cpu"): {"chunk": 128},
    ("wkv", "fp8", "cpu"): {"chunk": 128},
    ("wkv", "f32", "cuda"): {"chunk": WKV_CHUNK},
    ("wkv", "bf16", "cuda"): {"chunk": WKV_CHUNK},
    ("flash", "f32", "cpu"): {"bq": 128, "bk": 128},
    ("flash", "bf16", "cpu"): {"bq": 128, "bk": 128},
    ("flash", "f32", "cuda"): {"bq": 64, "bk": 64},
    ("flash", "bf16", "cuda"): {"bq": 64, "bk": 64},
    ("stencil2d", "f32", "cpu"): {"tile": (64, 128)},
    ("stencil2d", "bf16", "cpu"): {"tile": (64, 128)},
    ("stencil2d", "f32", "cuda"): {"tile": (32, 128)},
    ("stencil2d", "bf16", "cuda"): {"tile": (32, 128)},
    ("stencil3d", "f32", "cpu"): {"tile": (8, 16, 128)},
    ("stencil3d", "bf16", "cpu"): {"tile": (8, 16, 128)},
    ("stencil3d", "f32", "cuda"): {"tile": (64, 16, 64),
                                   "general_tile": (8, 8, 64)},
    ("stencil3d", "bf16", "cuda"): {"tile": (64, 16, 64),
                                    "general_tile": (8, 8, 64)},
    ("spmspm", "f32", "cpu"): {"rt": 8, "ct": 8, "nt": 1},
    ("spmspm", "bf16", "cpu"): {"rt": 8, "ct": 8, "nt": 1},
    ("spmspm", "fp8", "cpu"): {"rt": 8, "ct": 8, "nt": 1},
    ("spmspm", "f32", "cuda"): {"rt": 1, "ct": 256, "nt": 8},
    ("spmspm", "bf16", "cuda"): {"rt": 1, "ct": 256, "nt": 8},
    ("spmspm", "fp8", "cuda"): {"rt": 1, "ct": 256, "nt": 8},
}


def _bucket(dtype: torch.dtype) -> str:
    b = dtype.itemsize
    return "f32" if b >= 4 else ("bf16" if b == 2 else "fp8")


def _row(op: str, dtype: torch.dtype, device) -> Dict[str, Any]:
    plat = torch.device(device).type
    return dict(_TABLE[(op, _bucket(dtype), plat)])


def spmm_bn(dtype=torch.float32, device="cpu") -> int:
    """N-tile (output columns per thread block) of the BCSR SpMM kernel."""
    return int(_row("spmm", dtype, device)["bn"])


# K2q's thread block: eight warps of 8 output rows x 128 columns each, and
# its dense tile (bk x bn values) at most 32 KB, one stage of its ring.
SPMM_QUANT_WARPS, SPMM_QUANT_WARP_COLS = 8, 128
SPMM_QUANT_TILE_BYTES = 32768


def spmm_quant_group(bm: int, bk: int, bn: int,
                     dense_dtype=torch.float32) -> int:
    """The block-rows of one K2q thread block at tile (bm, bk) and ``bn``
    columns; raises ValueError where the kernel does not take the tile:
    ``bn`` must be 128 x a power of two with (bm / 8) x (bn / 128) <= 8
    warps, and the (bk, bn) dense tile at most 32 KB."""
    cols = bn // SPMM_QUANT_WARP_COLS
    if bm not in (8, 16) or not 1 <= bk <= 32 or bn < 1 \
            or bn % SPMM_QUANT_WARP_COLS or cols & (cols - 1) \
            or cols * bm // 8 > SPMM_QUANT_WARPS \
            or bk * bn * dense_dtype.itemsize > SPMM_QUANT_TILE_BYTES:
        raise ValueError(
            f"spmm_bcsr: unsupported K2q tile bm={bm} bk={bk} bn={bn} for "
            f"{dense_dtype} dense (bn must be 128 x a power of two, at most "
            f"{SPMM_QUANT_WARPS * 128 * 8 // bm} at bm {bm}, with bk x bn "
            f"dense values in {SPMM_QUANT_TILE_BYTES} bytes)")
    return SPMM_QUANT_WARPS // cols // (bm // 8)


def spmm_col_unit(dense_dtype=torch.float32) -> int:
    """The granule of the SpMM kernel's ``bn``: one warp of 16-byte vectors
    of ``dense_dtype`` (128 f32 or 256 bf16 columns)."""
    return 32 * (16 // dense_dtype.itemsize)


def moe_dispatch_tiles(d_model: int, dtype=torch.float32,
                       device="cpu") -> Dict[str, Any]:
    """{"block": (bm, bk), "bn": int, "min_bucket": int} for the MoE
    dispatch-as-SpMM path; ``min_bucket`` is the floor of the power-of-two
    nnzb bucket the routed stream is padded to (``engine.stream_bucket``).
    ``bn`` is never wider than ``d_model`` rounded up to a warp (on the
    card, to the kernel's :func:`spmm_col_unit`)."""
    row = _row("moe_dispatch", dtype, device)
    bm, bk = row["block"]
    unit = 32
    if torch.device(device).type == "cuda":
        unit = spmm_col_unit(dtype)
    bn = min(int(row["bn"]), max(unit, -(-d_model // unit) * unit))
    return {"block": (int(bm), int(bk)), "bn": bn,
            "min_bucket": int(row["min_bucket"])}


def wkv_smem_bytes(chunk: int, hd: int = 64) -> int:
    """Shared memory of one WKV thread block, all f32 and unpadded (an XOR
    swizzle keeps the fragment loads free of bank conflicts): six (chunk,
    hd) tiles (r, w, and k and v of this chunk and the next), the (hd, hd)
    state, the scan's four partial rows, the decay rows of two chunks, the
    next chunk's exp(mid) and ``u``.  No (chunk, chunk) tile: the scores
    stay in registers."""
    return 4 * (6 * chunk * hd + hd * hd + 4 * hd + 4 * hd)


def clamp_wkv_chunk(chunk: int, t: int, device="cpu") -> int:
    """The reference's clamp of a WKV chunk to the sequence,
    ``min(chunk, max(8, T))``, on the CPU; on the card the chunk as it is
    (the kernel pads T to its one chunk instead)."""
    if torch.device(device).type == "cuda":
        return int(chunk)
    return min(int(chunk), max(SUBLANE, int(t)))


def wkv_chunk(t: int, dtype=torch.float32, device="cpu") -> int:
    """Chunk length of the WKV recurrence for a sequence of ``t``: the
    ``wkv`` row, clamped by :func:`clamp_wkv_chunk`."""
    return clamp_wkv_chunk(int(_row("wkv", dtype, device)["chunk"]), t,
                           device)


def flash_smem_bytes(bq: int, bk: int, d: int,
                     dtype=torch.float32) -> int:
    """Shared memory of one flash thread block.  bf16: the (64, d) Q tile
    and three stages of (64, d) K and V tiles, with 1 KB to align them to
    the swizzle pattern, whatever the tile.  f32: f32 Q and K tiles with rows
    padded by one word, the V tile, and the padded (bq, bk) score tile."""
    if dtype == torch.bfloat16:
        return 1024 + 7 * 64 * d * 2
    return 4 * (bq * (d + 1) + bk * (d + 1) + bk * d + bq * (bk + 1))


def _flash_clamp(bq: int, bk: int, sq: int, skv: int, d: int,
                 dtype: torch.dtype, device) -> Tuple[int, int]:
    """No longer than the sublane-aligned sequences; then the platform's
    memory clamp: the reference's VMEM budget on the CPU, the block's shared
    memory on the card."""
    bq = min(bq, -(-max(sq, 1) // SUBLANE) * SUBLANE)
    bk = min(bk, -(-max(skv, 1) // SUBLANE) * SUBLANE)
    if torch.device(device).type == "cpu":
        eb = dtype.itemsize
        while bk > LANE and (4 * bk * d * eb + bq * d * 4
                             + 2 * bq * d * eb) > VMEM_BUDGET:
            bk //= 2
    else:
        while bk > SUBLANE and flash_smem_bytes(bq, bk, d,
                                                dtype) > SMEM_BUDGET:
            bk //= 2
    return bq, bk


def flash_tiles(sq: int, skv: int, d: int, dtype=torch.float32,
                device="cpu") -> Tuple[int, int]:
    """(bq, bk) tile lengths of the flash-attention kernels (K3, and the
    masked K4m / K4s where a mask spec gives no tiles); ``ops`` applies its
    divisibility-aware re-clamp on top of K3's."""
    row = _row("flash", dtype, device)
    return _flash_clamp(int(row["bq"]), int(row["bk"]), sq, skv, d, dtype,
                        device)


def stencil_tile(interior: Tuple[int, ...], dtype=torch.float32,
                 device="cpu", general: bool = False) -> Tuple[int, ...]:
    """Output tile of the 2-D / 3-D stencil kernels.  On the CPU, the
    reference's clamp (each dim to the interior rounded up to 8, the minor
    one to 128); on the card, each dim to the interior itself.
    ``general``: a 3-D spec that takes the general kernel rather than K6b's
    march (the card's ``general_tile``)."""
    ndim = len(interior)
    row = _row(f"stencil{ndim}d", dtype, device)
    tile = row["general_tile"] if general and "general_tile" in row \
        else row["tile"]
    if torch.device(device).type == "cpu":
        return tuple(min(t, -(-max(n, 1) // q) * q) for t, n, q in zip(
            tile, interior, (SUBLANE,) * (ndim - 1) + (LANE,)))
    return tuple(min(t, max(n, 1)) for t, n in zip(tile, interior))


def spmspm_tiles(r: int, c: int, la: int, lb: int, dtype=torch.float32,
                 device="cpu") -> Tuple[int, int]:
    """(rt, ct) of the SpMSpM kernel: on the CPU the reference's CPU row
    (its clamps, to the sublane-padded problem and to the VMEM budget, leave
    8 x 8 as it is); on the card ``rt`` rows (warps) per block, no more than
    ``r``, and ``ct`` columns, ``nt`` of which make the slab width."""
    row = _row("spmspm", dtype, device)
    rt, ct = int(row["rt"]), int(row["ct"])
    if torch.device(device).type == "cpu":
        return rt, ct
    return min(rt, max(r, 1)), ct


def spmspm_nt(c: int, ct: int, lb: int, dtype=torch.float32,
              device="cpu") -> int:
    """Output-column residency: how many ``ct``-column tiles one step (on
    the card, one warp's slab) covers, so an A row is walked once per ``nt``
    tiles; never wider than the problem (the reference's VMEM clamp
    leaves its CPU row's 1 as it is).  Any value gives the same result."""
    nt = max(1, int(_row("spmspm", dtype, device)["nt"]))
    c_aligned = -(-max(c, 1) // SUBLANE) * SUBLANE
    while nt > 1 and (nt - 1) * ct >= c_aligned:
        nt //= 2
    return nt


# R1 (``router/csrc/router.cu``): the instances its launcher takes.  The
# many-token kernel: (tokens a warp, experts a block), 8 warps a block; the
# few-token kernel: experts a block, 1-8 warps (tokens) a block.
ROUTER_FEW_TOKENS = 64
ROUTER_MANY_TILES = tuple((tpw, ec) for tpw in (1, 2, 4, 8)
                          for ec in (4, 8, 16))
ROUTER_FEW_EXPERTS = (1, 2)
ROUTER_FEW_WARPS = (8, 4, 2, 1)


class RouterTiles(NamedTuple):
    """One launch of R1.  ``staged`` 1: the many-token kernel (W and x
    staged in shared memory), blocks of 8 warps of ``tokens`` tokens each,
    ``experts`` experts a block.  ``staged`` 0: the few-token kernel,
    blocks of ``tokens`` warps of one token each, every warp taking the
    block's ``experts`` experts."""
    staged: int
    tokens: int
    experts: int


def router_warps(tiles: RouterTiles) -> Tuple[int, int]:
    """(warps a block, tokens a warp) of a launch at ``tiles``."""
    return (8, tiles.tokens) if tiles.staged else (tiles.tokens, 1)


def router_grid(T: int, E: int, tiles: RouterTiles) -> Tuple[int, int]:
    """R1's grid at ``tiles``: (blocks over the tokens, blocks over the
    experts)."""
    per_block = math.prod(router_warps(tiles))
    return -(-T // per_block), -(-E // tiles.experts)


@functools.lru_cache(maxsize=4096)
def router_tiles(T: int, E: int, sms: int) -> RouterTiles:
    """R1's tile for T tokens of E experts on a card of ``sms`` SMs.

    A wave is ``sms - sms // 32`` blocks (at most one SM in 32 idle).  Many
    tokens (T > :data:`ROUTER_FEW_TOKENS`): of the tiles whose grid still
    gives a wave, the one with the most sums a lane (tokens a warp x
    experts a block: each W value read from shared memory feeds a warp's
    tokens, each x value its experts), then the fewest shared-memory loads
    a step (tokens a warp + experts a block / 4), then the most tokens a
    warp; the experts a block at most the least of 4, 8, 16 that covers E.
    Where no tile gives a wave, the one with the most blocks.  A few
    tokens: 2 experts a warp where E is even (1 where it is odd, and the
    launcher takes 1 where W's start is not aligned to a pair), and the
    most warps (tokens) a block whose grid still gives a wave, else one.
    (NVIDIA H100, 132 SMs: 4 x 256 tokens take (2, 8) and 4 x 2048 (8,
    16), 128 blocks each; ``tools/compare_router.py --tiles`` times the
    others.)"""
    if T < 1 or not 1 <= E <= 65535 or sms < 1:
        raise ValueError(f"router_tiles: T {T}, E {E}, sms {sms}")
    wave = sms - sms // 32
    if T <= ROUTER_FEW_TOKENS:
        ef = max(e for e in ROUTER_FEW_EXPERTS if E % e == 0)
        for warps in ROUTER_FEW_WARPS:
            tiles = RouterTiles(0, warps, ef)
            gx, gy = router_grid(T, E, tiles)
            if gx * gy >= wave:
                return tiles
        return RouterTiles(0, 1, ef)
    widest = min(e for _, e in ROUTER_MANY_TILES if e >= min(E, 16))
    tiles = [RouterTiles(1, tpw, ec) for tpw, ec in ROUTER_MANY_TILES
             if ec <= widest]
    blocks = {t: math.prod(router_grid(T, E, t)) for t in tiles}
    fit = [t for t in tiles if blocks[t] >= wave]
    if not fit:
        return max(tiles, key=lambda t: (blocks[t], -t.experts))
    return max(fit, key=lambda t: (
        t.tokens * t.experts, -(t.tokens + t.experts // 4), t.tokens))
