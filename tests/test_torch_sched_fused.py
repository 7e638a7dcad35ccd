"""Port vs reference: the fused mode of the continuous-batching
``ServeScheduler``, on the CPU.

``ServeScheduler(two_phase=False)`` (the default for gather dispatch and for
stacks without attn+moe layers) admits with ``model.prefill`` and decodes
each batch bucket with ``model.decode_step`` over the slot pool's own rows
``[0, bucket)`` (``serve._FusedDecode``).  On the card that step is one
CUDA graph a bucket (``chip_smoke.py`` phase 6); on the CPU it runs
eagerly, after the same two warm-up steps under the same guard, which
restores the rows it advanced.

Held here, on TINY, llama4-scout SMOKE and rwkv6-7b SMOKE (f32 policy;
weights from the reference's ``init_params`` through
``interop.params_from_jax``, prompts from numpy seeds):

* greedy tokens per uid equal to the reference's gather ``ServeScheduler``
  (itself fused) on a staggered trace into 2 slots, fused gather and fused
  bcsr at depths 0 and 1; rwkv6-7b SMOKE equal to the reference's RWKV
  scheduler, and each request equal to itself served alone;
* fused == ``two_phase=True`` at temperature 0.7;
* the ``two_phase`` default equal to the reference's;
* one step a bucket, made once, over the pool's own storage;
* the capture guard: a bucket first used while rows are resident leaves
  every pool leaf ``torch.equal`` to before, and the residents' tokens
  those they get alone;
* a fused step reads the host once, for its token fetch;
* ``--continuous --two-phase off|on`` on the CLI.

Tokens and pool leaves are compared exactly, never within a tolerance.
"""
import dataclasses
import functools
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.launch.serve import ServeScheduler as RServeScheduler
from repro.models import model as RM
from repro.models.config import ArchConfig as RArchConfig

from repro_torch import configs
from repro_torch.interop import params_from_jax
from repro_torch.kernels.spmm import ref as spmm_ref
from repro_torch.launch import serve
from repro_torch.launch.serve import ServeLoop, ServeScheduler
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig

torch.set_num_threads(2)

SCOUT, RWKV = "llama4-scout-17b-a16e", "rwkv6-7b"
TINY_KW = dict(
    name="tiny-serve", family="moe", d_model=32, n_heads=2, n_kv_heads=1,
    d_ff=48, vocab_size=64, block_unit=("attn", "attn+moe"), n_repeats=2,
    head_dim=16, n_experts=4, top_k=1, capacity_factor=1.0,
    moe_shared_expert=True, policy="f32")
MAX_SEQ = 24
N_REQ, LATE_STEP = 5, 2          # requests 3.. arrive after step 2


def _cfgs(name):
    if name == "tiny":
        return RArchConfig(**TINY_KW), ArchConfig(**TINY_KW)
    arch = SCOUT if name == "scout-smoke" else RWKV
    return (dataclasses.replace(r_get_smoke(arch), policy="f32"),
            dataclasses.replace(configs.get_smoke(arch), policy="f32"))


@functools.lru_cache(maxsize=None)
def _build(name):
    rcfg, cfg = _cfgs(name)
    rparams = jax.jit(RM.init_params, static_argnums=1)(jax.random.PRNGKey(0),
                                                        rcfg)
    params = params_from_jax(jax.device_get(rparams), cfg, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(4, 10))
                          ).astype(np.int32), int(rng.integers(3, 8)))
            for _ in range(N_REQ)]
    return rcfg, cfg, rparams, params, reqs


@pytest.fixture(scope="module", params=["tiny", "scout-smoke"])
def model(request):
    return _build(request.param)


def _drive(sched, reqs):
    """Three requests at step 0, the rest after step ``LATE_STEP``, then
    until the queue and the slots are empty; {uid: tokens}."""
    for prompt, gen in reqs[:3]:
        sched.submit(prompt, gen)
    late = False
    while sched.has_work():
        sched.step()
        if sched.step_idx == LATE_STEP and not late:
            for prompt, gen in reqs[3:]:
                sched.submit(prompt, gen)
            late = True
    return sched.run()


@functools.lru_cache(maxsize=None)
def _reference_tokens(name):
    """The reference's default scheduler on the trace (2 slots): gather
    for the MoE models, which the reference serves fused."""
    rcfg, _, rparams, _, reqs = _build(name)
    dispatch = None if name == "rwkv-smoke" else "gather"
    return _drive(RServeScheduler(rparams, rcfg, max_seq=MAX_SEQ,
                                  max_slots=2, dispatch=dispatch), reqs)


def _sched(params, cfg, **kw):
    kw.setdefault("max_seq", MAX_SEQ)
    return ServeScheduler(params, cfg, device="cpu", **kw)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _alone(params, cfg, reqs, **kw):
    """Each request served alone (B = 1) through ``ServeLoop``."""
    return [ServeLoop(params, cfg, max_seq=MAX_SEQ, device="cpu", **kw)
            .run(prompt[None], gen)[0] for prompt, gen in reqs]


def _assert_tokens(got, want):
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid])


# ------------------------------------------------------- reference parity --


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("dispatch", ["gather", "bcsr"])
def test_fused_scheduler_matches_reference(model, dispatch, depth):
    """Fused gather (the default) and fused bcsr (``two_phase=False``, the
    full-grid stream): greedy tokens per uid == the reference's gather
    scheduler's, each request exactly its budget; admissions are
    ``model.prefill`` (no route stat), a step a bucket, no capture on the
    CPU and no routed-stream buckets in the summary."""
    name = "tiny" if model[1].name == "tiny-serve" else "scout-smoke"
    _, cfg, _, params, reqs = model
    kw = {} if dispatch == "gather" else {"two_phase": False}
    sched = _sched(params, cfg, max_slots=2, dispatch=dispatch,
                   pipeline_depth=depth, **kw)
    assert not sched.two_phase
    got = _drive(sched, reqs)
    _assert_tokens(got, _reference_tokens(name))
    assert [len(got[uid]) for uid in range(N_REQ)] == [g for _, g in reqs]
    s = sched.summary()
    assert "route" not in s and "execute" not in s
    assert "nnzb_buckets" not in s
    assert s["capture"] == {"calls": 0, "ms": 0.0}
    assert set(sched._fused) == sched.batch_buckets == {1, 2}
    assert any(st.extra["active"] == 2 for st in sched.stats
               if st.phase == "decode")


def test_rwkv_fused_scheduler_matches_reference_and_alone():
    """rwkv6-7b SMOKE (recurrent state per row, no attention cache): the
    default, fused scheduler's tokens == the reference's RWKV scheduler's,
    and each request's == that request served alone; the RWKV leaves stay
    in the dtypes a decode step writes."""
    _, cfg, _, params, reqs = _build("rwkv-smoke")
    sched = _sched(params, cfg, max_slots=2)
    assert not sched.two_phase
    got = _drive(sched, reqs)
    _assert_tokens(got, _reference_tokens("rwkv-smoke"))
    for uid, alone in enumerate(_alone(params, cfg, reqs)):
        np.testing.assert_array_equal(got[uid], alone)
    for leaf in sched.cache["slots"][0].values():
        assert leaf.dtype == torch.float32


@pytest.mark.parametrize("name,dispatch", [("tiny", "gather"),
                                           ("tiny", "bcsr"),
                                           ("rwkv-smoke", None)])
def test_fused_equals_layered_at_temperature(name, dispatch):
    """At temperature 0.7, fused and ``two_phase=True`` schedulers sample
    the same tokens per uid (each request's own generator)."""
    _, cfg, _, params, reqs = _build(name)
    out = {}
    for two_phase in (False, True):
        out[two_phase] = _drive(_sched(params, cfg, max_slots=3,
                                       dispatch=dispatch, temperature=0.7,
                                       sample_seed=11, two_phase=two_phase),
                                reqs)
    _assert_tokens(out[False], out[True])


@pytest.mark.parametrize("name,dispatch", [("scout-smoke", "gather"),
                                           ("scout-smoke", "bcsr"),
                                           ("rwkv-smoke", None),
                                           ("rwkv-smoke", "bcsr")])
def test_default_two_phase_is_the_reference(name, dispatch):
    rcfg, cfg, rparams, params, _ = _build(name)
    for two_phase in (None, True, False):
        want = RServeScheduler(rparams, rcfg, max_seq=MAX_SEQ,
                               dispatch=dispatch, two_phase=two_phase)
        got = _sched(params, cfg, dispatch=dispatch, two_phase=two_phase)
        assert got.two_phase == want.two_phase, two_phase
    assert _sched(params, cfg, dispatch=dispatch).two_phase == (
        dispatch == "bcsr" and name == "scout-smoke")


# ---------------------------------------------------------- steps & guard --


def test_one_step_a_bucket_over_the_pool(monkeypatch):
    """Each batch bucket's step is made once, at its first use, and kept;
    its cache leaves are views of the slot pool's own storage (rows
    ``[0, bucket)``), so nothing is copied in or out."""
    _, cfg, _, params, reqs = _build("tiny")
    made = []
    init = serve._FusedDecode.__init__

    def counted(self, *a, **kw):
        made.append(a[2])                       # the batch
        init(self, *a, **kw)

    monkeypatch.setattr(serve._FusedDecode, "__init__", counted)
    sched = _sched(params, cfg, max_slots=4)
    seen = {}
    for prompt, gen in reqs:
        sched.submit(prompt, gen)
    while sched.has_work():
        sched.step()
        for b, step in sched._fused.items():
            assert seen.setdefault(b, step) is step
    assert sorted(made) == sorted(sched.batch_buckets) == sorted(seen)
    for b, step in seen.items():
        for leaf, pool in zip(_leaves(step.cache), _leaves(sched.cache)):
            assert leaf.shape[1] == b and leaf.data_ptr() == pool.data_ptr()
            assert leaf.stride() == pool.stride()


def test_rows_kept_restores_on_exit_and_on_error():
    """``_rows_kept`` puts every leaf back in place, after a clean exit
    and after an exception, and the warm-up it guards does write."""
    _, cfg, _, params, reqs = _build("tiny")
    sched = _sched(params, cfg, max_slots=2)
    sched.submit(*reqs[0])
    sched.admit()
    rows = serve._row_views(sched.cache, 2)
    before = [x.clone() for x in _leaves(sched.cache)]
    step = lambda: M.decode_step(  # noqa: E731
        params, cfg, rows, torch.zeros(2, dtype=torch.long),
        torch.zeros((2, 1), dtype=torch.int32))
    with serve._rows_kept(rows):
        step()
        assert not all(torch.equal(a, b) for a, b in
                       zip(before, _leaves(sched.cache)))
    assert all(torch.equal(a, b) for a, b in
               zip(before, _leaves(sched.cache)))
    with pytest.raises(RuntimeError, match="mid-warm-up"):
        with serve._rows_kept(rows):
            step()
            raise RuntimeError("mid-warm-up")
    assert all(torch.equal(a, b) for a, b in
               zip(before, _leaves(sched.cache)))


@pytest.mark.parametrize("name,dispatch", [("scout-smoke", "gather"),
                                           ("scout-smoke", "bcsr"),
                                           ("rwkv-smoke", None)])
def test_capture_guard_keeps_resident_rows(name, dispatch):
    """Buckets 1, 2 and 4 first used while requests are resident: making
    each bucket's step (its two warm-up steps, which advance K/V, the MoE
    occupancy and the RWKV state of every row) leaves every pool leaf
    ``torch.equal`` to before, and every request's tokens are those it
    gets served alone."""
    _, cfg, _, params, reqs = _build(name)
    sched = _sched(params, cfg, max_slots=4, dispatch=dispatch,
                   two_phase=False)
    made = serve.ServeScheduler._fused_decode
    checked = []

    def guarded(self, bucket):
        if bucket in self._fused:
            return made(self, bucket)
        before = [x.clone() for x in _leaves(self.cache)]
        step = made(self, bucket)
        assert all(torch.equal(a, b) for a, b in
                   zip(before, _leaves(self.cache))), bucket
        checked.append((bucket, len(self.active)))
        return step

    sched._fused_decode = functools.partial(guarded, sched)
    arrivals = {0: reqs[:1], 1: reqs[1:2], 2: reqs[2:]}
    while sched.step_idx in arrivals or sched.has_work():
        for prompt, gen in arrivals.get(sched.step_idx, []):
            sched.submit(prompt, gen)
        sched.step()
    got = sched.run()
    assert [b for b, _ in checked] == [1, 2, 4]
    assert all(n > 0 for _, n in checked)       # residents at each capture
    alone = _alone(params, cfg, reqs, dispatch=dispatch)
    for uid, want in enumerate(alone):
        np.testing.assert_array_equal(got[uid], want)


# ------------------------------------------------------------ host reads --


def _count_host_reads():
    """Every way a tensor reaches the host (``item``, ``tolist``,
    ``numpy``, ``cpu``, ``int()``, ``float()``, ``bool()``, use as an
    index), counted by name, except inside the plain version of K2
    (``spmm_bcsr_ref``), which stands on the CPU for a kernel that reads
    nothing on the host.  Returns (patch, restore, counts)."""
    names = ("item", "tolist", "numpy", "cpu", "__int__", "__index__",
             "__float__", "__bool__")
    saved = {n: getattr(torch.Tensor, n) for n in names}
    plain = spmm_ref.spmm_bcsr_ref.__code__
    counts = []

    def counter(name):
        def read(self, *a, **kw):
            f = sys._getframe(1)
            while f is not None and f.f_code is not plain:
                f = f.f_back
            if f is None:
                counts.append(name)
            return saved[name](self, *a, **kw)
        return read

    def patch():
        for n in names:
            setattr(torch.Tensor, n, counter(n))

    def restore():
        for n, fn in saved.items():
            setattr(torch.Tensor, n, fn)
    return patch, restore, counts


@pytest.mark.parametrize("depth", [0, 1])
@pytest.mark.parametrize("name,dispatch", [("scout-smoke", "gather"),
                                           ("scout-smoke", "bcsr"),
                                           ("rwkv-smoke", None)])
def test_fused_step_reads_the_host_once(name, dispatch, depth):
    """A fused decode step (its bucket's step made) reads the host only
    for its token fetch (``.cpu().numpy()``): one sync on the card, at
    either depth."""
    _, cfg, _, params, reqs = _build(name)
    sched = _sched(params, cfg, max_slots=2, dispatch=dispatch,
                   two_phase=False, pipeline_depth=depth)
    for prompt, _ in reqs[:2]:
        sched.submit(prompt, 8)
    sched.step()                          # admits both, makes bucket 2
    patch, restore, counts = _count_host_reads()
    patch()
    try:
        emitted = sched.decode_step()
    finally:
        restore()
    assert len(emitted) == 2
    assert counts == ["cpu", "numpy"]


def test_cli_continuous_two_phase_flag(capsys):
    args = ["--arch", SCOUT, "--smoke", "--prompt-len", "8", "--gen", "4",
            "--device", "cpu", "--continuous", "--requests", "3",
            "--slots", "2", "--dispatch", "bcsr"]
    off = serve.main(args + ["--two-phase", "off"])
    assert "[fused, capture 0.0 ms]" in capsys.readouterr().out
    on = serve.main(args + ["--two-phase", "on"])
    out = capsys.readouterr().out
    assert "[two-phase]" in out and "nnzb buckets" in out
    auto = serve.main(args[:-2])                 # gather: fused by default
    assert "[fused, capture 0.0 ms]" in capsys.readouterr().out
    assert sorted(off) == sorted(on) == sorted(auto) == [0, 1, 2]
    for uid in on:
        np.testing.assert_array_equal(off[uid], on[uid])
        np.testing.assert_array_equal(auto[uid], on[uid])
