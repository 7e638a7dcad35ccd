"""Port vs reference: block masks (``core/masks.py``).

The port keeps a numpy-only copy of the reference's masks, so every
tile-kind map, lowered stream, dense oracle and ``AttnMaskSpec.build``
must equal the reference's exactly, for the pattern zoo of
``tests/test_attention_sparse.py`` and for composition.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import masks as R

from repro_torch.core import masks as P
from repro_torch.models import layers

torch.set_num_threads(2)


def _zoo(m, sq, skv, bq, bk):
    """The reference test suite's pattern zoo, built with module ``m``."""
    local = m.BlockMask.sliding_window(sq, skv, 3 * bk, bq=bq, bk=bk)
    return {
        "causal": m.BlockMask.causal(sq, skv, bq=bq, bk=bk),
        "window": m.BlockMask.sliding_window(sq, skv, 2 * bk, bq=bq, bk=bk),
        "strided": m.BlockMask.strided(sq, skv, 2, bq=bq, bk=bk),
        "global": m.BlockMask.global_cols(sq, skv, 1, bq=bq, bk=bk),
        "local|global": local | m.BlockMask.global_cols(sq, skv, 1,
                                                        bq=bq, bk=bk),
        "strided&causal": (m.BlockMask.strided(sq, skv, 2, bq=bq, bk=bk)
                           & m.BlockMask.causal(sq, skv, bq=bq, bk=bk)),
    }


NAMES = list(_zoo(R, 64, 64, 16, 16))
GEOMETRIES = [(64, 96, 16, 16), (52, 40, 16, 8), (2048, 2048, 64, 64)]


def _assert_same(got, want):
    np.testing.assert_array_equal(got.tile_kinds, want.tile_kinds)
    assert (got.sq, got.skv, got.bq, got.bk, got.window, got.q_offset) == \
        (want.sq, want.skv, want.bq, want.bk, want.window, want.q_offset)
    assert got.signature() == want.signature()
    assert got.density() == want.density()
    np.testing.assert_array_equal(got.dense_mask(), want.dense_mask())
    for kw in ({"bucket": False}, {"bucket": True},
               {"bucket": True, "min_bucket": 32}):
        gs, ws = got.lower(**kw), want.lower(**kw)
        for f in ("rows", "cols", "kinds"):
            np.testing.assert_array_equal(getattr(gs, f), getattr(ws, f))
        assert (gs.n_q_tiles, gs.nnzb, gs.capacity) == \
            (ws.n_q_tiles, ws.nnzb, ws.capacity)


@pytest.mark.parametrize("geom", GEOMETRIES, ids=str)
@pytest.mark.parametrize("name", NAMES)
def test_pattern_zoo_equals_reference(name, geom):
    _assert_same(_zoo(P, *geom)[name], _zoo(R, *geom)[name])


@pytest.mark.parametrize("q_offset", [0, 32])
def test_composition_offsets_and_shards_equal_reference(q_offset):
    def build(m):
        kw = dict(bq=16, bk=16, q_offset=q_offset)
        a = m.BlockMask.sliding_window(64, 96, 32, **kw)
        b = m.BlockMask.strided(64, 96, 3, **kw)
        g = m.BlockMask.global_cols(64, 96, 2, **kw)
        c = m.BlockMask.full(64, 96, causal=False, **kw)
        return [a & b, a | g, (a | g) & c, b | g, a & c]
    for got, want in zip(build(P), build(R)):
        _assert_same(got, want)
    for got, want in zip(build(P)[0].shard_rows(2), build(R)[0].shard_rows(2)):
        _assert_same(got, want)
    with pytest.raises(ValueError):
        _ = (P.BlockMask.sliding_window(64, 64, 32, bq=16, bk=16)
             & P.BlockMask.sliding_window(64, 64, 16, bq=16, bk=16))


def test_from_dense_equals_reference():
    dense = np.random.default_rng(0).random((52, 40)) < 0.2
    _assert_same(P.BlockMask.from_dense(dense, bq=16, bk=8),
                 R.BlockMask.from_dense(dense, bq=16, bk=8))


@pytest.mark.parametrize("spec", [
    dict(pattern="local_global", window=8, bq=8, bk=8),
    dict(pattern="local_global", n_global=2),
    dict(pattern="sliding"),
    dict(pattern="strided", stride=3, window=16),
    dict(pattern=None),
    dict(local=False, pattern="sliding"),
], ids=str)
@pytest.mark.parametrize("layer_window", [None, 24])
def test_attn_mask_spec_build_equals_reference(spec, layer_window):
    got_spec, want_spec = P.AttnMaskSpec(**spec), R.AttnMaskSpec(**spec)
    assert dataclasses.asdict(got_spec) == dataclasses.asdict(want_spec)
    assert hash(got_spec) == hash(P.AttnMaskSpec(**spec))
    for sq, bq, bk in ((32, 8, 8), (200, 16, 32), (2048, 64, 64)):
        got = got_spec.build(sq, sq, layer_window=layer_window, bq=bq, bk=bk)
        want = want_spec.build(sq, sq, layer_window=layer_window, bq=bq,
                               bk=bk)
        assert (got is None) == (want is None)
        if want is not None:
            _assert_same(got, want)


def test_constants_and_bucket_law():
    assert (P.NEG_INF, P.KIND_DEAD, P.KIND_CAUSAL, P.KIND_WINDOW) == \
        (R.NEG_INF, R.KIND_DEAD, R.KIND_CAUSAL, R.KIND_WINDOW)
    for n in (0, 1, 7, 8, 9, 100, 1024, 1025):
        assert P.next_pow2(n) == R.next_pow2(n)
        assert P.next_pow2(n, 32) == R.next_pow2(n, 32)
    assert layers.NEG_INF is P.NEG_INF     # the port's one masking constant


def test_scout_long_context_mask_is_sparse():
    """llama4-scout's masked serving pattern at S=2048: the walk really
    skips tiles (81 of 136 causal tiles at 128, 275 of 528 at 64)."""
    for tile, visible, causal in ((128, 81, 136), (64, 275, 528)):
        m = P.AttnMaskSpec(pattern="local_global", window=512).build(
            2048, 2048, layer_window=None, bq=tile, bk=tile)
        assert m.nnzb == visible
        assert P.BlockMask.causal(2048, 2048, bq=tile, bk=tile).nnzb == causal
