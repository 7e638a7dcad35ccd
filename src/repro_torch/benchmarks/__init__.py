"""The port's benchmarks: ``bench_serve`` (continuous-batching serving) and
``bench_moe`` (MoE dispatch as SpMM), the counterparts of the reference's
``benchmarks/bench_serve.py`` and ``benchmarks/bench_moe.py``.

    python -m repro_torch.benchmarks.bench_serve [--smoke] [--device cpu]
    python -m repro_torch.benchmarks.bench_moe [--smoke] [--device cpu]

Each prints the reference's CSV rows and writes ``BENCH_torch_<name>.json``
under ``build/bench/`` (:func:`common.emit_bench`), never into the
reference's ``benchmarks/``.  ``--device`` defaults to ``cuda`` and raises
without a GPU.
"""
