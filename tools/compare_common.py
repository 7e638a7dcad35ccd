"""What the ``tools/compare_*.py`` scripts that time builds of one kernel source share.

* :func:`ablate`: copies of an in-tree source, each with one named set of
  text edits (a part removed, to time what it costs);
* :func:`build_all`: several sources built with the in-tree ``nvcc`` flags,
  one process each, all started together, each library bound by the
  caller's function, with each build's ``-Xptxas -v`` resources;
* :func:`load_wrapper`: a function of another version of a kernel's
  wrapper module, launching on a given library.

The scripts run from the repository root with ``src`` and the root on
``sys.path`` (they set it before calling these).
"""
from __future__ import annotations

import ctypes
import importlib.util
import os
import subprocess


def ablate(source: str, table: dict, names, out_dir: str) -> list:
    """Copies of the in-tree source ``source`` (a key of
    ``build.SOURCES``), one for each of ``names``, each with the edits
    ``table[name]``: ``((old text, its replacement), ...)``, each old text
    found exactly once.  Returns the copies' paths, ``abl_NAME.cu`` in
    ``out_dir``."""
    from repro_torch.kernels import build
    src = build.SOURCES[source].read_text()
    paths = []
    for name in names:
        text = src
        for old, new in table[name]:
            if text.count(old) != 1:
                raise SystemExit(f"--ablate {name}: the text to replace is "
                                 "not in the source exactly once")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"abl_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        paths.append(path)
    return paths


def build_all(srcs, out_dir: str, bind) -> dict:
    """Every source built with the in-tree flags, one ``nvcc`` each, all
    started together: ``{src: (bind(library, source text), resource
    rows)}`` (``chip_smoke.kernel_resources`` of the build's log)."""
    import chip_smoke as cs
    from repro_torch.kernels import build
    procs = {}
    for i, src in enumerate(srcs):
        out = os.path.join(out_dir, f"lib{i}.so")
        procs[src] = (out, subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", out, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for src, (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{src}: nvcc exited {proc.returncode}\n{log}")
        with open(src) as f:
            text = f.read()
        built[src] = (bind(ctypes.CDLL(out), text), cs.kernel_resources(log))
    return built


def load_wrapper(path: str, lib_attr: str, lib, fn: str):
    """``fn`` of another version of a kernel's wrapper module at ``path``,
    its library loader ``lib_attr`` replaced by one that returns ``lib``."""
    name = "other_" + os.path.splitext(os.path.basename(path))[0]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    setattr(mod, lib_attr, lambda: lib)
    return getattr(mod, fn)
