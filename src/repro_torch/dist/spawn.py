"""Run a function as k ranks of one ``torch.distributed`` group.

``run_ranks(fn, k, backend, device, timeout_s, *args)`` starts k processes
(the ``spawn`` start method: each imports what ``fn`` needs and nothing of
its parent), joins them into one group through a ``file://`` store in a
fresh temporary directory (TCP ports would collide between concurrent test
workers), sets one intra-op thread per rank, calls ``fn(rank, k, *args)``
in each and returns the k results in rank order. ``fn`` must be a
module-level function, and its arguments and result picklable. The
arguments are pickled once into that directory and each rank reads them
there: through the start pipe, a parent blocks in each ``start()`` until
that child has imported its parent's main module and read them, so the
ranks would start one after another.

A rank that raises fails the call with its traceback; ranks still running
after ``timeout_s`` seconds (a deadlock, a collective one rank never
reached) are killed and the call raises ``TimeoutError``, so a fault costs
bounded time. Every process started here is ended before it returns.

``device`` is "cuda" (the default; the call raises where there is no
card) or "cpu": on "cuda" every rank selects card
``rank % torch.cuda.device_count()``, so k ranks share one card when there
is one (the group must then be gloo: NCCL refuses two ranks on one device).
"""

from __future__ import annotations

import multiprocessing
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List


def _rank_main(fn: Callable, rank: int, k: int, backend: str, device: str, store: str,
               results, args_path: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        with open(args_path, "rb") as f:
            args = pickle.load(f)
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f"file://{store}", world_size=k,
                                rank=rank)
        try:
            out = fn(rank, k, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:                                   # reported to the parent
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, k: int, backend: str = "gloo", device: str = "cuda",
              timeout_s: float = 120.0, *args: Any) -> List[Any]:
    """``fn(rank, k, *args)`` on k ranks of a fresh process group; the
    results in rank order (the module's docstring)."""
    from repro_torch.device import resolve_device

    resolve_device(device)                 # no card: raise here, before any rank starts
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    results = ctx.Queue()
    args_path = os.path.join(tmp, "args.pkl")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, k, backend, device, os.path.join(tmp, "store"), results,
                               args_path))
             for r in range(k)]
    try:
        with open(args_path, "wb") as f:
            pickle.dump(args, f, protocol=pickle.HIGHEST_PROTOCOL)
        for p in procs:
            p.start()
        got, deadline = {}, time.monotonic() + timeout_s
        while len(got) < k:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{k - len(got)} of {k} ranks had not finished after "
                                   f"{timeout_s} s (ranks done: {sorted(got)})")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
        return [got[r] for r in range(k)]
    finally:
        for p in procs:
            if p.pid is None:                                 # never started
                continue
            if p.is_alive():
                p.kill()
            p.join(timeout=5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
