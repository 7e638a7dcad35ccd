"""Run one function on N ranks of a gloo process group, each its own
process on this host: the CPU tests' ranks, and ``chip_smoke.py``'s ranks
that share one card.

:func:`run_ranks` spawns the processes (``spawn``, not ``fork``), joins them
through a ``FileStore`` in a temporary directory with the group timeout
given, and returns each rank's result.  A rank that raises sends its
traceback; the others, blocked in a collective, fail when it leaves or at
the group timeout.  The parent waits at most ``limit`` seconds for them
all, and at most ``GRACE_S`` more once a rank has failed (a collective
cannot finish without it, and a group being formed would only fail at the
timeout); then it kills what is left and raises :class:`RankError` with
every traceback it got.  Nothing is left running either way.
"""
from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable, List, Optional

# Seconds the parent still waits for the other ranks' own tracebacks once
# one rank has failed.
GRACE_S = 2.0


class RankError(RuntimeError):
    """One or more ranks failed or gave no result in time; the message
    holds each failing rank's traceback."""


def _rank_main(fn, rank: int, world: int, store: str, timeout: float,
               args: tuple, out) -> None:
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)    # the ranks share the host's cores
    try:
        dist.init_process_group(
            "gloo", store=dist.FileStore(store, world), rank=rank,
            world_size=world, timeout=datetime.timedelta(seconds=timeout))
        out.put((rank, True, pickle.dumps(fn(rank, world, *args))))
    except Exception:     # the process boundary: the parent gets the trace
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world: int, *args, timeout: float = 60.0,
              limit: Optional[float] = None) -> List:
    """``[fn(rank, world, *args) for rank in range(world)]``, each call in
    its own process, a rank of one gloo group (``timeout`` seconds a
    collective).  ``fn`` must be importable by name (a module-level
    function) and return a picklable value; it runs with one CPU thread.
    ``limit``: the seconds the parent waits for every rank (default 3 x
    ``timeout``)."""
    limit = 3 * timeout if limit is None else limit
    ctx = multiprocessing.get_context("spawn")
    out = ctx.Queue()
    results, errors = {}, {}
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world, os.path.join(tmp, "store"),
                                   timeout, args, out))
                 for r in range(world)]
        deadline = time.monotonic() + limit
        started = []
        try:
            for p in procs:
                p.start()
                started.append(p)
            while len(results) + len(errors) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    rank, ok, payload = out.get(timeout=min(left, 1.0))
                except queue_mod.Empty:
                    for r, p in enumerate(procs):
                        if p.exitcode not in (None, 0) and r not in errors \
                                and r not in results:
                            errors[r] = f"exited with code {p.exitcode}"
                            deadline = min(deadline,
                                           time.monotonic() + GRACE_S)
                    continue
                if ok:
                    results[rank] = pickle.loads(payload)
                else:
                    errors[rank] = payload
                    deadline = min(deadline, time.monotonic() + GRACE_S)
        finally:
            for r, p in enumerate(started):
                if r not in results:     # failed, hung or never heard from
                    p.kill()
                p.join(timeout=10.0)     # the others are on their way out
                if p.is_alive():
                    p.kill()
                    p.join()
            out.close()
    missing = sorted(set(range(world)) - set(results) - set(errors))
    if errors or missing:
        msg = [f"rank {r}:\n{errors[r]}" for r in sorted(errors)]
        if missing:
            msg.append(f"ranks {missing} gave no result (stopped "
                       f"{'after a failure' if errors else f'at {limit} s'})")
        raise RankError("\n".join(msg))
    return [results[r] for r in range(world)]
