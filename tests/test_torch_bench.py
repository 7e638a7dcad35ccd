"""Port vs reference: the port's serving benchmarks
(``repro_torch.benchmarks``) and the drivers' ``compile_signatures``, on
the CPU.

Held here:

* ``bench_serve.synth_trace`` array-equal to the reference's for both modes'
  arguments and for the full-width law (seed 24);
* ``bench_serve.run(smoke=True, fault_rate=0.5, device="cpu")`` against
  every assertion of the reference's bench-tier smoke tests
  (``tests/test_bench_smoke.py``), one test a backend;
* with the reference's TINY weights carried across
  (``interop.params_from_jax``): the port's gather (fused) and bcsr
  (two-phase) tokens per uid equal to the reference's **gather**
  ``ServeScheduler`` on the same trace (its bcsr serving raises on this
  jax), exactly;
* ``compile_signatures``: the port's two-phase gather ``ServeScheduler`` and
  ``ServeLoop`` equal to the reference's (5 on the ``--smoke`` trace at
  depth 0); on bcsr the count equal to the distinct execute shapes counted
  from the run's own route stats, and within ``signature_bound``;
* ``bench_moe.run(smoke=True)`` (its three ``torch.equal`` checks raise
  inside), its routed-stream counts equal to the reference's ``route_moe``
  info on the same numpy input and converted weights, and its gather layer
  output within 1e-5 (absolute, f32 output) of the reference's
  ``apply_moe(dispatch="gather")``;
* ``emit_bench``'s header and directory; the CLIs; and, by AST, that nothing
  under ``src/repro_torch/benchmarks/`` imports ``jax``, ``repro`` or
  ``benchmarks``.
"""
import ast
import dataclasses
import functools
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as r_get_smoke
from repro.launch.serve import ServeLoop as RServeLoop
from repro.launch.serve import ServeScheduler as RServeScheduler
from repro.models import model as RM
from repro.models import moe as rmoe
from repro.models.config import ArchConfig as RArchConfig

from repro_torch.benchmarks import bench_moe, bench_serve, common
from repro_torch.interop import params_from_jax
from repro_torch.launch.serve import ServeLoop, ServeScheduler

torch.set_num_threads(2)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BACKENDS = ("gather", "bcsr")
SMOKE_TRACE = dict(n_requests=6, prompt_lo=4, prompt_hi=8, gen_lo=3,
                   gen_hi=6, vocab=64, arrival_every=2)


def _reference_bench_serve():
    sys.path.insert(0, REPO_ROOT)  # benchmarks/ is not a package on sys.path
    try:
        from benchmarks import bench_serve as rbench
    finally:
        sys.path.pop(0)
    return rbench


def _rcfg(cfg):
    return RArchConfig(**{f.name: getattr(cfg, f.name)
                          for f in dataclasses.fields(cfg)})


@functools.lru_cache(maxsize=None)
def _tiny_params():
    """The reference's TINY weights, and the port's copy of them."""
    rcfg = _rcfg(bench_serve.TINY)
    rparams = RM.init_params(jax.random.PRNGKey(0), rcfg)
    return rcfg, rparams, params_from_jax(jax.device_get(rparams),
                                          bench_serve.TINY, device="cpu")


@functools.lru_cache(maxsize=None)
def _reference_scheduler(depth):
    """The reference's two-phase gather scheduler on the smoke trace:
    (tokens per uid, compile_signatures)."""
    rbench = _reference_bench_serve()
    rcfg, rparams, _ = _tiny_params()
    sched = RServeScheduler(rparams, rcfg, max_seq=24, max_slots=2,
                            dispatch="gather", two_phase=True,
                            pipeline_depth=depth)
    s = rbench.drive(sched, rbench.synth_trace(**SMOKE_TRACE))
    return ({r.uid: list(map(int, r.tokens)) for r in sched.finished},
            s["compile_signatures"])


@pytest.fixture(scope="module")
def serve_results():
    return bench_serve.run(smoke=True, fault_rate=0.5, device="cpu")


@pytest.fixture(scope="module")
def serve_converted():
    """The smoke benchmark on the reference's TINY weights."""
    return bench_serve.run(smoke=True, fault_rate=0.5,
                           params=_tiny_params()[2], device="cpu")


# ------------------------------------------------------------- the trace --

@pytest.mark.parametrize("kw", [
    SMOKE_TRACE,
    dict(n_requests=12, prompt_lo=8, prompt_hi=24, gen_lo=8, gen_hi=16,
         vocab=256, arrival_every=3),
    dict(n_requests=16, prompt_lo=64, prompt_hi=512, gen_lo=8, gen_hi=32,
         vocab=202048, arrival_every=2, seed=24)],
    ids=["smoke", "default", "full-width"])
def test_synth_trace_matches_reference(kw):
    want = _reference_bench_serve().synth_trace(**kw)
    got = bench_serve.synth_trace(**kw)
    assert len(got) == len(want) == kw["n_requests"]
    for (ga, gp, gg), (wa, wp, wg) in zip(got, want):
        assert (ga, gg) == (wa, wg)
        assert gp.dtype == wp.dtype
        np.testing.assert_array_equal(gp, wp)


# ------------------------------------- the reference's bench-tier asserts --

@pytest.mark.parametrize("backend", BACKENDS)
def test_bench_serve_smoke(serve_results, backend):
    """The reference's ``test_bench_serve_smoke``: the trace drains and the
    throughput / latency numbers are sane."""
    e = serve_results[backend]
    t = e["trace"]
    assert e["requests_finished"] == t["requests"]
    assert t["generated_tokens"] > 0
    assert e["decode_tok_per_s"] > 0
    lat = e["token_latency_ms"]
    assert lat["n"] == t["generated_tokens"]
    assert 0 < lat["p50"] <= lat["p99"]
    ftl = e["first_token_ms"]
    assert ftl["n"] == t["requests"] and ftl["p50"] > 0
    assert e["two_phase"] == (backend == "bcsr")   # the reference's default
    assert e["peak_gb"] is None                    # no card


@pytest.mark.parametrize("backend", BACKENDS)
def test_bench_serve_pipelined_ab(serve_results, backend):
    """The reference's ``test_bench_serve_pipelined_ab``: the pipelined run
    drains the same trace and emits the same tokens."""
    e = serve_results[backend]
    assert e["pipeline_depth"] == 0
    pip, ab = e["pipelined"], e["ab"]
    assert pip["pipeline_depth"] == 1
    assert pip["requests_finished"] == pip["trace"]["requests"]
    assert pip["trace"]["generated_tokens"] == e["trace"]["generated_tokens"]
    assert ab["tokens_match"] is True
    assert ab["pipelined_tok_per_s"] > 0 and ab["serial_tok_per_s"] > 0
    assert ab["decode_speedup"] > 0
    assert 0.0 <= ab["route_hidden_frac"] <= 1.0
    if e["two_phase"]:   # gather is fused: no route/execute stats
        assert pip["timing"]["execute_dispatch_ms"] >= 0.0


@pytest.mark.parametrize("backend", BACKENDS)
def test_bench_serve_fault_ab(serve_results, backend):
    """The reference's ``test_bench_serve_fault_ab``: every request reaches
    a terminal state and the survivors emit their healthy-run tokens."""
    fl = serve_results[backend]["fault"]
    assert fl["fault_rate"] == 0.5
    assert fl["faults_injected"] > 0
    assert fl["faults_triggered"] >= 1
    assert fl["survivor_tokens_match"] is True
    n_req = serve_results[backend]["trace"]["requests"]
    assert fl["finished"] + fl["failed"] + fl["shed"] == n_req
    assert fl["faulty_tok_per_s"] > 0
    assert set(fl["ladder"]) >= {"failures", "applied"}


def test_bench_serve_signature_bound(serve_results):
    """The reference's ``test_bench_serve_signature_bound``."""
    e = serve_results["bcsr"]
    assert e["two_phase"]
    assert 0 < e["compile_signatures"] <= e["signature_bound"]
    for b in e["batch_buckets"]:
        assert b & (b - 1) == 0 and b > 0
    assert "compile_signatures" not in serve_results["gather"]   # fused


def test_fault_plan_is_the_references(serve_results):
    """``FaultPlan.random(17, uids, 0.5)`` injects the reference's specs:
    its count is the reference's."""
    from repro.runtime import resilience as RR
    want = RR.FaultPlan.random(17, list(range(6)), 0.5)
    assert serve_results["gather"]["fault"]["faults_injected"] == \
        len(want.specs)


# ------------------------------------------------ tokens vs the reference --

@pytest.mark.parametrize("backend", BACKENDS)
def test_bench_serve_tokens_match_reference(serve_converted, backend):
    """On the reference's weights, each backend's tokens per uid (serial
    and pipelined, which ``tokens_match`` ties) equal the reference's
    gather scheduler's, exactly."""
    want, _ = _reference_scheduler(0)
    e = serve_converted[backend]
    assert e["tokens"] == want
    assert e["ab"]["tokens_match"] is True
    assert e["fault"]["survivor_tokens_match"] is True


# ------------------------------------------------------- the signatures --

@pytest.mark.parametrize("depth", [0, 1])
def test_two_phase_gather_scheduler_signatures(depth):
    """The port's two-phase gather scheduler: the reference's tokens and
    its ``compile_signatures`` (5 at depth 0 on this trace)."""
    want_tokens, want = _reference_scheduler(depth)
    sched = ServeScheduler(_tiny_params()[2], bench_serve.TINY, max_seq=24,
                           max_slots=2, dispatch="gather", two_phase=True,
                           pipeline_depth=depth, device="cpu")
    s = bench_serve.drive(sched, bench_serve.synth_trace(**SMOKE_TRACE))
    assert s["compile_signatures"] == want
    if depth == 0:
        assert want == 5
    assert {r.uid: list(map(int, r.tokens))
            for r in sched.finished} == want_tokens
    execs = [st for st in sched.stats if st.phase == "execute"]
    assert not execs     # gather makes one call a layer: no execute stats


def test_two_phase_gather_loop_signatures():
    """The two-phase gather ``ServeLoop``: the reference's count, cleared
    at each run (a second run with other shapes counts its own)."""
    rcfg, rparams, params = _tiny_params()
    rng = np.random.default_rng(5)
    loop = ServeLoop(params, bench_serve.TINY, max_seq=16, dispatch="gather",
                     two_phase=True, device="cpu")
    rloop = RServeLoop(rparams, rcfg, max_seq=16, dispatch="gather",
                       two_phase=True)
    for shape, gen in (((2, 6), 5), ((1, 4), 3)):
        prompts = rng.integers(0, 64, shape).astype(np.int32)
        got = loop.run(prompts, gen)
        want = rloop.run(jnp.asarray(prompts), gen)
        np.testing.assert_array_equal(got, np.asarray(want))
        # one prefill shape and one decode shape, each at its capacity
        assert loop.summary()["compile_signatures"] == \
            rloop.summary()["compile_signatures"] == 2


def test_bcsr_signatures_are_the_route_shapes(serve_converted):
    """Two-phase bcsr, where the reference cannot execute here: the count
    equals the distinct (capacity, batch, tokens, nnzb, grid) of the run's
    own route stats, the benchmark's value on the same weights and trace,
    and stays within the bucket law's bound."""
    sched = ServeScheduler(_tiny_params()[2], bench_serve.TINY, max_seq=24,
                           max_slots=2, dispatch="bcsr", device="cpu")
    s = bench_serve.drive(sched, bench_serve.synth_trace(**SMOKE_TRACE))
    routes = [st for st in sched.stats if st.phase == "route"]
    shapes = {(st.extra["capacity"], st.tokens // st.extra["tokens"],
               st.extra["tokens"], st.extra["nnzb_stream"],
               st.extra["grid_nnzb"]) for st in routes}
    assert s["compile_signatures"] == len(shapes) > 1
    e = serve_converted["bcsr"]
    assert e["compile_signatures"] == len(shapes) <= e["signature_bound"]
    assert e["execute_calls"] == len(routes)
    assert [st.extra["compile_signatures"] for st in sched.stats
            if st.phase == "execute"][-1] == len(shapes)


# -------------------------------------------------------------- bench_moe --

def _converted_layer(cfg, device):
    """The reference's ``init_moe(PRNGKey(0), cfg)`` as the port's params,
    f32 as the reference's are (``bench_moe.init_layer``'s dtype)."""
    rp = rmoe.init_moe(jax.random.PRNGKey(0), _rcfg(cfg))
    return params_from_jax(jax.device_get(rp),
                           dataclasses.replace(cfg, policy="f32"),
                           device=device)


def _smoke_inputs():
    """The smoke run's (1, T, D) and (1, TB, DB) inputs, drawn in its
    order."""
    s = bench_moe.SHAPES[True]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, s["T"], s["D"])).astype(np.float32)
    xb = rng.standard_normal((1, s["TB"], s["DB"])).astype(np.float32)
    return x, xb


def test_bench_moe_smoke_matches_reference_streams():
    """``bench_moe.run(smoke=True)`` on the reference's weights: its
    ``torch.equal`` checks hold (they raise inside), and the routed stream
    it reports is the reference's ``route_moe`` info on the same input."""
    bench_json = {}
    rows = bench_moe.run(bench_json, smoke=True, device="cpu",
                         init=_converted_layer)
    names = [r.split(",")[0] for r in rows]
    assert names == [
        "moe/su_gather_dispatch", "moe/onehot_einsum_dispatch",
        "moe/backend_gather(jit)", "moe/backend_bcsr_engine(plain)",
        "moe/backend_bcsr_two_phase(jit)", "moe/two_phase_chain_pipelined",
        "moe/bcsr_kernel_dispatch(plain)", "moe/bcsr_batched_dispatch(plain)"]
    tp = bench_json["two_phase"]
    cfg_b = bench_moe.layer_cfg(bench_moe.SHAPES[True]["DB"])
    rcfg_b = _rcfg(cfg_b)
    _, xb = _smoke_inputs()
    _, info = rmoe.route_moe(rmoe.init_moe(jax.random.PRNGKey(0), rcfg_b),
                             jnp.asarray(xb), rcfg_b, dispatch="bcsr")
    for key in ("nnzb_stream", "nnzb_routed", "grid_nnzb"):
        assert tp[key] == info[key], key
    assert tp["nnzb_stream"] < tp["grid_nnzb"]
    assert tp["modes"] == {"gather": "eager", "exec": "eager"}


def test_bench_moe_gather_layer_matches_reference():
    """The in-layer A/B's gather output vs the reference's
    ``apply_moe(dispatch="gather")`` on the same input and weights: within
    1e-5 absolute (f32 tokens and weights on both sides; the frameworks
    sum in other orders)."""
    cfg_b = bench_moe.layer_cfg(bench_moe.SHAPES[True]["DB"])
    rcfg_b = _rcfg(cfg_b)
    _, xb = _smoke_inputs()
    rp = rmoe.init_moe(jax.random.PRNGKey(0), rcfg_b)
    ab = bench_moe.layer_ab(_converted_layer(cfg_b, "cpu"),
                            torch.from_numpy(xb), cfg_b, torch.device("cpu"))
    want, _ = rmoe.apply_moe(rp, jnp.asarray(xb), rcfg_b, dispatch="gather")
    np.testing.assert_allclose(ab["out"].numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)


def test_bench_moe_host_dispatch_schema():
    bench_json = {}
    rows = bench_moe.run_host_dispatch(bench_json, smoke=True, device="cpu")
    assert [r.split(",")[0] for r in rows] == [
        "moe/route_host_dispatch(eager_pr3)", "moe/route_host_dispatch(jit)",
        "moe/decode_step_layered(eager_pr3)",
        "moe/decode_step_layered(jit_layers)"]
    hd = bench_json["host_dispatch"]
    assert hd["route_jit_us"] > 0 and hd["decode_step_jit_layers_us"] > 0
    assert hd["shapes"]["decode_layers"] == 4


# ------------------------------------------------- artifact, CLI, imports --

def test_emit_bench_header(tmp_path):
    before = sorted(os.listdir(os.path.join(REPO_ROOT, "benchmarks")))
    path = common.emit_bench("smoke_test", {"x": np.float32(1.5),
                                            "t": torch.tensor(2),
                                            "k": {3: (np.int64(4),)}},
                             device="cpu", directory=str(tmp_path))
    assert path == os.path.join(str(tmp_path), "BENCH_torch_smoke_test.json")
    with open(path) as f:
        doc = json.load(f)
    assert doc["bench"] == "smoke_test"
    assert {"backend", "device_count", "torch_version", "platform"} <= set(doc)
    assert doc["backend"] == "cpu" and "card" not in doc
    assert doc["x"] == 1.5 and doc["t"] == 2 and doc["k"] == {"3": [4]}
    assert sorted(os.listdir(os.path.join(REPO_ROOT, "benchmarks"))) == before
    assert common.BENCH_DIR == os.path.join(REPO_ROOT, "build", "bench")


def test_cli_without_a_card_raises():
    """``--device`` defaults to cuda: without a GPU both CLIs raise before
    any work."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda would run")
    for main in (bench_serve.main, bench_moe.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--smoke"])


def test_cli_smoke_on_cpu(monkeypatch, tmp_path, capsys):
    """``bench_serve --smoke --device cpu`` prints the reference's rows and
    writes its artifact (into a temporary directory here)."""
    monkeypatch.setattr(common, "BENCH_DIR", str(tmp_path))
    bench_serve.main(["--smoke", "--device", "cpu"])
    out = capsys.readouterr().out
    for name in ("serve/gather/decode_tok_per_s",
                 "serve/bcsr/decode_tok_per_s",
                 "serve/bcsr/compile_signatures",
                 "serve/gather/pipelined_tok_per_s"):
        assert name in out
    with open(tmp_path / "BENCH_torch_serve.json") as f:
        doc = json.load(f)
    assert doc["gather"]["ab"]["tokens_match"] is True
    assert doc["bcsr"]["ab"]["tokens_match"] is True


def test_benchmarks_import_no_reference():
    """No module of the port's benchmarks imports jax, the reference
    package or the reference's benchmarks."""
    pkg = os.path.join(REPO_ROOT, "src", "repro_torch", "benchmarks")
    files = sorted(f for f in os.listdir(pkg) if f.endswith(".py"))
    assert {"__init__.py", "common.py", "bench_serve.py",
            "bench_moe.py"} <= set(files)
    for name in files:
        with open(os.path.join(pkg, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                assert m.split(".")[0] not in ("jax", "repro", "benchmarks"), \
                    f"{name} imports {m}"
