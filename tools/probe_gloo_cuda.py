"""Which ``torch.distributed`` collectives does gloo take on CUDA tensors,
and how long do they take on ranks that share one card?

The expert-parallel MoE (``models/moe_shard_map.py``) and the sparse
gradient exchange (``grad_comp/sparse_allreduce.py``) run their
collectives over gloo: NCCL puts no two ranks on one device, and the
card's checks run 4 ranks on ``cuda:0``.  This script spawns ``--ranks``
gloo ranks (``parallel.ranks.run_ranks``) on ``cuda:0`` (``--device cpu``:
on the CPU) and, for f32 and bf16 tensors of ``--mb`` MiB a rank, calls
``all_to_all_single``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``
(sum), ``all_reduce`` (sum), and the list forms ``all_gather`` and
``reduce_scatter`` (sum) once to check the result against the same
sum on the host, then ``--iters`` more times on the host clock with a
synchronise after each.  A collective that gloo refuses is reported with
its error, not timed.  Prints one JSON line a rank count::

    python3 tools/probe_gloo_cuda.py [--ranks 4] [--mb 64] [--iters 3]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

OPS = ("all_to_all_single", "all_gather_into_tensor", "reduce_scatter_tensor",
       "all_reduce", "all_gather", "reduce_scatter")


def _call(op: str, t, world: int):
    """The collective ``op`` on ``t`` (a (world * k,) tensor); returns its
    output."""
    import torch
    import torch.distributed as dist
    if op == "all_to_all_single":
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t)
    elif op == "all_gather_into_tensor":
        out = t.new_empty((world * t.numel(),))
        dist.all_gather_into_tensor(out, t)
    elif op == "reduce_scatter_tensor":
        out = t.new_empty((t.numel() // world,))
        dist.reduce_scatter_tensor(out, t)
    elif op == "all_gather":
        parts = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(parts, t)
        out = torch.cat(parts)
    elif op == "reduce_scatter":
        out = t.new_empty((t.numel() // world,))
        dist.reduce_scatter(out, list(t.chunk(world)))
    else:
        out = t.clone()
        dist.all_reduce(out)
    return out


def _want(op: str, rank: int, world: int, make):
    """What ``op`` gives rank ``rank`` when rank r contributes ``make(r)``,
    computed on the host."""
    import torch
    parts = [make(r).cpu() for r in range(world)]
    k = parts[0].numel() // world
    if op == "all_to_all_single":
        return torch.cat([p[rank * k:(rank + 1) * k] for p in parts])
    if op in ("all_gather_into_tensor", "all_gather"):
        return torch.cat(parts)
    total = parts[0].clone()
    for p in parts[1:]:
        total += p
    return total if op == "all_reduce" else total[rank * k:(rank + 1) * k]


def _rank(rank: int, world: int, device: str, mb: float, iters: int) -> dict:
    import torch
    import torch.distributed as dist
    if device == "cuda":
        torch.cuda.set_device(0)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        n = int(mb * 2 ** 20) // dtype.itemsize // world * world

        def make(r, n=n, dtype=dtype):
            g = torch.Generator().manual_seed(r)
            # small integers: every sum is exact in either type
            return torch.randint(-8, 8, (n,), generator=g).to(dtype)

        t = make(rank).to(device)
        for op in OPS:
            key = f"{op} {str(dtype)[6:]}"
            dist.barrier()
            try:
                got = _call(op, t, world)
            except (RuntimeError, ValueError) as e:  # gloo refused the op
                rows[key] = {"ok": False, "error": str(e).splitlines()[0]}
                dist.barrier()
                continue
            equal = bool(torch.equal(got.cpu(), _want(op, rank, world,
                                                      make)))
            secs = []
            for _ in range(iters):
                dist.barrier()
                t0 = time.perf_counter()
                _call(op, t, world)
                if device == "cuda":
                    torch.cuda.synchronize()
                secs.append(time.perf_counter() - t0)
            rows[key] = {"ok": True, "equal": equal, "seconds": secs,
                         "mib_a_rank": t.numel() * t.element_size() / 2 ** 20}
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--mb", type=float, default=64.0)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    import torch
    from repro_torch.parallel.ranks import run_ranks
    if args.device == "cuda" and not torch.cuda.is_available():
        print("probe_gloo_cuda: no card (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    per_rank = run_ranks(_rank, args.ranks, args.device, args.mb, args.iters,
                         timeout=120.0, limit=600.0)
    card = (torch.cuda.get_device_name(0) if args.device == "cuda"
            else "cpu")
    print(json.dumps({"torch": torch.__version__, "device": card,
                      "ranks": args.ranks, "per_rank": per_rank}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
