"""The port's kernels.  Each wrapper counts its launches in an attribute of
its own function (``spmm_bcsr.launches`` and so on); :func:`launch_counters`
names them all, so a caller that replays a CUDA graph
(:func:`capture_graph`), which runs no wrapper, can add the launches its
capture recorded."""
from __future__ import annotations

from typing import Any, Callable, Dict, Tuple


def launch_counters() -> Dict[str, Tuple[Callable, str]]:
    """Every kernel of the port, by name: its wrapper and the attribute in
    which the wrapper counts its launches (K2 and K2q share a wrapper)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.router import kernel as rk
    from repro_torch.kernels.spmm import kernel as sk
    from repro_torch.kernels.spmspm import kernel as pk
    from repro_torch.kernels.ssd import kernel as mk
    from repro_torch.kernels.stencil import kernel as tk
    from repro_torch.kernels.wkv import kernel as wk
    return {"spmm_bcsr": (sk.spmm_bcsr, "launches"),
            "spmm_bcsr_quant": (sk.spmm_bcsr, "quant_launches"),
            "flash_attention": (fk.flash_attention, "launches"),
            "flash_attention_masked": (fk.flash_attention_masked, "launches"),
            "flash_attention_sparse": (fk.flash_attention_sparse, "launches"),
            "decode_attention": (fk.decode_attention, "launches"),
            "decode_attention_max": (fk.decode_attention_max, "launches"),
            "decode_attention_partial": (fk.decode_attention_partial,
                                         "launches"),
            "router_logits": (rk.router_logits, "launches"),
            "spmspm_ell": (pk.spmspm_ell, "launches"),
            "stencil_2d": (tk.stencil_2d, "launches"),
            "stencil_3d": (tk.stencil_3d, "launches"),
            "wkv_kernel": (wk.wkv_kernel, "launches"),
            "wkv_step": (wk.wkv_step, "launches"),
            "ssd_step": (mk.ssd_step, "launches")}


def read_launches() -> Dict[str, int]:
    """Every kernel's launch count, by name."""
    return {name: getattr(fn, attr)
            for name, (fn, attr) in launch_counters().items()}


def add_launches(counts: Dict[str, int]) -> None:
    """Add ``counts`` (by kernel name) to the kernels' launch counts."""
    for name, (fn, attr) in launch_counters().items():
        if counts.get(name):
            setattr(fn, attr, getattr(fn, attr) + counts[name])


def reset_launches() -> None:
    """Every kernel's launch count to 0."""
    for fn, attr in launch_counters().values():
        setattr(fn, attr, 0)


def capture_graph(fn: Callable, device, *, pool=None,
                  warmup: int = 2) -> Tuple[Any, Any, Dict[str, int]]:
    """``fn()`` as one CUDA graph on ``device``, in the memory pool
    ``pool`` when given.  ``warmup`` calls run first on a side stream under
    ``torch.cuda.set_sync_debug_mode("error")``: a host sync inside ``fn``
    raises there, before it could break the capture, and each kernel's
    first-use build is done.  The warm-up and the capture add nothing to
    the launch counts.  Returns (graph, the captured call's output, the
    launches the capture recorded by kernel name): a replay runs no
    wrapper, so its caller adds those (:func:`add_launches`)."""
    import torch
    counts = read_launches()
    try:
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.stream(side):
                for _ in range(warmup):
                    fn()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        torch.cuda.current_stream(device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = read_launches()
        with torch.cuda.graph(graph, pool=pool):
            out = fn()
        after = read_launches()
    finally:
        add_launches({k: counts[k] - v for k, v in read_launches().items()})
    return graph, out, {k: after[k] - before[k] for k in after
                        if after[k] != before[k]}
