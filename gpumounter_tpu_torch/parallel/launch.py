"""Start one process per rank, run a function in each, collect the results.

The ranks are started with multiprocessing's spawn method and join a
process group of the backend the caller names, over a TCP store on a free
localhost port (never a fixed one, so several launches can run at once).
Collectives time out after ``timeout_s``, and the launcher stops waiting
then too: a rank that raises, dies or hangs makes ``run_ranks`` raise and
name it, and every rank still running is killed.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import socket
import time
import traceback
from datetime import timedelta

import torch.distributed as dist

FAILURE_GRACE_S = 3.0


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world_size, backend, init_method, timeout_s, args,
               results) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    try:
        dist.init_process_group(backend, init_method=init_method, rank=rank,
                                world_size=world_size,
                                timeout=timedelta(seconds=timeout_s))
        try:
            value = fn(*args)
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    results.put((rank, True, value))


def run_ranks(fn, world_size: int, *, backend: str, args: tuple = (),
              timeout_s: float = 300.0) -> list:
    """[fn(*args) of rank 0, ..., of rank world_size − 1].

    fn must be importable by name (a module-level function) and is called
    in each rank after ``init_process_group``; its return value must
    pickle without tensors (numpy arrays and Python values): tensors would
    travel as shared-memory handles that die with the rank. Raises
    RuntimeError naming every rank that raised or died, each with its
    traceback (a rank's failure often breaks its peers' collectives too,
    so the ranks that fail within FAILURE_GRACE_S of the first are named
    together), and TimeoutError naming the ranks that had not finished
    after timeout_s seconds.
    """
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init_method = f"tcp://127.0.0.1:{free_port()}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, rank, world_size, backend, init_method,
                               timeout_s, args, results))
             for rank in range(world_size)]
    for p in procs:
        p.start()
    out, failed, grace_end = {}, {}, None
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) + len(failed) < world_size:
            now = time.monotonic()
            if grace_end is not None and now > grace_end:
                break
            if now > deadline:
                missing = [r for r in range(world_size) if r not in out and r not in failed]
                raise TimeoutError(f"ranks {missing} of {world_size} gave no result "
                                   f"within {timeout_s} s")
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                silent = [r for r, p in enumerate(procs)
                          if p.exitcode is not None and r not in out and r not in failed]
                if not silent:
                    continue
                try:  # a report written just before its rank exited
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    failed.update((r, f"exited with code {procs[r].exitcode} and no result")
                                  for r in silent)
                    grace_end = grace_end or time.monotonic() + FAILURE_GRACE_S
                    continue
            if ok:
                out[rank] = value
            else:
                failed[rank] = value
                grace_end = grace_end or time.monotonic() + FAILURE_GRACE_S
        if failed:
            raise RuntimeError(f"ranks {sorted(failed)} of {world_size} failed:\n" + "\n".join(
                f"--- rank {r} ---\n{failed[r]}" for r in sorted(failed)))
    finally:
        for p in procs:
            p.join(timeout=10.0 if len(out) == world_size else 0.0)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
    return [out[rank] for rank in range(world_size)]
