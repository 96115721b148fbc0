"""Launch an N-rank job of processes on this host.

The reference is single-controller: one process drives every device of a
mesh.  PyTorch runs one process per rank, so :func:`run` starts ``n``
ranks with ``torch.multiprocessing`` (the ``spawn`` method), each of which
joins one process group over a free loopback port, runs ``fn(rank,
*args)`` and sends its (picklable) result back; :func:`run` returns the
results in rank order.

Failure is loud and bounded in time, never a hang:

* a rank that raises makes :func:`run` raise, naming the rank that failed
  first and its traceback (the other ranks are terminated, whatever
  collective they wait in);
* every collective gives up after ``timeout_s`` (the process group's
  timeout), so ranks that disagree on their collectives fail, not wait;
* the whole job must end by ``deadline_s``, or every rank is terminated and
  :func:`run` raises ``TimeoutError``.

A rank that finishes waits for the others before it leaves (a rank that
exits early would cut its peers' last collective short), on the job's
store rather than in a collective: a rank that an elastic reshape left out
of the mesh may wait there for the rest of the run, longer than any one
collective may take.  A rank that dies instead ends the job through the
parent, which sees its process fail.

Rank r runs on ``cuda:(r % device_count)``, or on the CPU.  The backend is
chosen once, from those devices: NCCL when every rank has a GPU of its own,
else gloo (NCCL refuses two ranks on one GPU).  A rank asked for CUDA on a
host without it raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import dataclasses
import datetime
import queue
import socket
import time
import traceback
from typing import Any, Callable

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.multiprocessing.spawn import ProcessException


def free_port() -> int:
    """A TCP port on the loopback interface that is free right now."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_device(rank: int, device_type: str) -> torch.device:
    """The device rank ``rank`` runs on: ``cuda:(rank % device_count)``, or
    the CPU.  Raises when CUDA is asked for and there is none."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"device must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if not torch.cuda.is_available():
        raise RuntimeError(f"rank {rank}: CUDA requested but not available; "
                           f"pass device='cpu' to run on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def backend_for(device_type: str, n: int) -> str:
    """The process-group backend for ``n`` ranks on ``device_type``: NCCL
    when each rank has a GPU of its own, else gloo."""
    if device_type == "cuda" and n <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


@dataclasses.dataclass
class _Failure:
    """A rank's exception: when it was raised and its traceback."""

    at: float
    trace: str


def _count(store, key: str, n: int) -> None:
    """Add this rank to ``key`` on the store and wait until all ``n`` have
    (bounded by the job's deadline, not the collectives' timeout)."""
    store.add(key, 1)
    while store.add(key, 0) < n:
        time.sleep(0.02)


def _finish(rank: int, n: int) -> None:
    """Every rank reaches here before any leaves.  Rank 0 holds the store,
    so it leaves last: after the others have seen the count complete."""
    store = dist.distributed_c10d._get_default_store()
    _count(store, "repro_torch/finished", n)
    if rank == 0:
        _count(store, "repro_torch/left", n)
    else:
        store.add("repro_torch/left", 1)


def _rank_main(rank: int, n: int, port: int, device_type: str,
               timeout_s: float, fn: Callable, args: tuple,
               results) -> None:
    dev = rank_device(rank, device_type)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.init()
    else:
        # one thread a CPU rank: ranks whose intra-op threads spin while a
        # peer computes oversubscribe the cores, and a job of small ops
        # then runs many times slower than on one thread a rank
        torch.set_num_threads(1)
    dist.init_process_group(
        backend_for(device_type, n), init_method=f"tcp://127.0.0.1:{port}",
        world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, *args)
        _finish(rank, n)
    except Exception:
        # its peers fail next, on the broken connection: the first failure
        # is the one to report
        results.put((rank, _Failure(time.time(), traceback.format_exc())))
        raise
    finally:
        dist.destroy_process_group()
    results.put((rank, out))


def run(fn: Callable[..., Any], n: int, *, args: tuple = (),
        device: str = "cpu", timeout_s: float = 120.0,
        deadline_s: float = 3600.0) -> list[Any]:
    """Run ``fn(rank, *args)`` on ``n`` ranks (see the module docstring) and
    return each rank's result, in rank order.  ``fn`` must be importable
    (a module-level function) and its result picklable."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    job = mp.start_processes(
        _rank_main, args=(n, free_port(), device, timeout_s, fn, args,
                          results),
        nprocs=n, join=False, start_method="spawn")
    got: dict[int, Any] = {}
    end = time.monotonic() + deadline_s

    def drain(wait: float) -> None:
        try:
            while True:
                rank, out = results.get(timeout=wait)
                got[rank] = out
        except queue.Empty:
            pass

    try:
        while True:
            # drain before joining: a rank blocks on exit until its results
            # are read
            drain(0.1)
            try:
                if job.join(timeout=0.1):
                    break
            except ProcessException as e:
                drain(1.0)
                first = min(((f.at, r, f.trace) for r, f in got.items()
                             if isinstance(f, _Failure)), default=None)
                if first is None:
                    raise
                raise RuntimeError(f"rank {first[1]} of {n} failed "
                                   f"first:\n{first[2]}") from e
            if time.monotonic() > end:
                raise TimeoutError(f"{n}-rank job still running after "
                                   f"{deadline_s} s")
        while len(got) < n:
            rank, out = results.get(timeout=max(end - time.monotonic(), 1))
            got[rank] = out
    finally:
        for p in job.processes:
            if p.is_alive():
                p.terminate()
        for p in job.processes:
            p.join(timeout=10)
    return [got[r] for r in range(n)]
