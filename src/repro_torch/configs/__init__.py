"""Config registry of the port: one module per architecture, each defining
CONFIG (the exact configuration) and SMOKE (a reduced same-family config for
CPU tests).  Only the architectures listed in ``ARCH_NAMES`` are ported; any
other name of the reference registry raises."""
from __future__ import annotations

import importlib

ARCH_NAMES = [
    "gemma3-12b",
    "internvl2-26b",
    "llama4-maverick-400b-a17b",
    "llama4-scout-17b-a16e",
    "musicgen-large",
    "nemotron-4-340b",
    "qwen2-1.5b",
    "qwen3-1.7b",
    "rwkv6-7b",
    "zamba2-1.2b",
]

_MODULES = {n: "repro_torch.configs." + n.replace("-", "_").replace(".", "_")
            for n in ARCH_NAMES}


def _load(name: str):
    if name not in _MODULES:
        raise KeyError(f"arch {name!r} is not yet ported to repro_torch; "
                       f"ported: {ARCH_NAMES}")
    return importlib.import_module(_MODULES[name])


def get_config(name: str):
    return _load(name).CONFIG


def get_smoke(name: str):
    return _load(name).SMOKE
