"""What gloo does with CUDA tensors when two ranks share one card: which
collectives run, and how long a bf16 all-reduce of a decode step's and a
prefill's seam takes.  Needs a CUDA card.

    python3 tools/gloo_probe.py [--ranks 2]

Prints the card's name and power limit, then one JSON line per rank:
``ok``/``err`` of all-reduce in four dtypes, the list form of all-gather
(int8 and float32, as ``compressed_all_reduce`` calls it), broadcast and
``init_device_mesh("cuda")``, and ``all_reduce_ms`` at (8, 1, 2048) and
(1, 384, 2048) bf16: the mean of 20 calls after 3, host clock around a
synchronized loop.  Then what sharded training uses: ``ok``/``err`` of
``reduce_scatter``, ``reduce_scatter_tensor``,
``all_gather_into_tensor`` and ``all_to_all_single`` (uneven splits,
float32 and bfloat16) on CUDA tensors, and
``bulk_ms``: all-gather (list form), all-reduce and all-to-all (even
splits) of 256 MB and 1 GB
float32 and bfloat16 buffers, the mean of 2 calls after 1, with the rate
in GB/s of buffer bytes a rank; each rank prints these at once.  Last,
``send``/``recv`` of a CPU tensor and of a CUDA tensor, and one more line
a rank (or ``job_failed`` when the CUDA send broke the connection).  Ranks
run through
``repro_torch.dist.spawn``, which picks gloo for ranks that share a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.dist import spawn  # noqa: E402


def _trial(out: dict, name: str, fn) -> None:
    try:
        out[name] = {"ok": True, "r": fn()}
    except RuntimeError as e:       # a collective gloo does not run
        out[name] = {"ok": False, "err": f"{e}"[:300]}


def _rank(rank: int, n: int) -> dict:
    dev = torch.device("cuda", torch.cuda.current_device())
    out = {"rank": rank, "backend": dist.get_backend()}

    def all_reduce(dtype):
        x = torch.full((4, 5), rank + 1, dtype=dtype, device=dev)
        dist.all_reduce(x)
        return x.float().sum().item()

    def all_gather(dtype):
        x = torch.full((3,), rank + 1, dtype=dtype, device=dev)
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x)
        return [p.tolist() for p in parts]

    def broadcast():
        x = torch.full((2,), rank + 7, dtype=torch.int64, device=dev)
        dist.broadcast(x, 0)
        return x.tolist()

    def device_mesh():
        from torch.distributed.device_mesh import init_device_mesh
        mesh = init_device_mesh("cuda", (n,), mesh_dim_names=("model",))
        return dist.get_backend(mesh.get_group("model"))

    def seconds(shape):
        x = torch.randn(shape, device=dev).bfloat16()
        for _ in range(3):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            dist.all_reduce(x)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / 20 * 1e3

    for dt in (torch.float32, torch.bfloat16, torch.int8, torch.int32):
        _trial(out, f"all_reduce_{dt}", lambda dt=dt: all_reduce(dt))
    for dt in (torch.int8, torch.float32):
        _trial(out, f"all_gather_{dt}", lambda dt=dt: all_gather(dt))
    _trial(out, "broadcast_int64", broadcast)
    _trial(out, "init_device_mesh", device_mesh)
    out["all_reduce_ms"] = {str(s): seconds(s)
                            for s in ((8, 1, 2048), (1, 384, 2048))}

    def reduce_scatter():
        parts = [torch.full((3,), rank + 1.0, device=dev) for _ in range(n)]
        x = torch.empty(3, device=dev)
        dist.reduce_scatter(x, parts)
        return x.tolist()

    def reduce_scatter_tensor():
        x = torch.empty(3, device=dev)
        dist.reduce_scatter_tensor(x, torch.full((3 * n,), rank + 1.0,
                                                 device=dev))
        return x.tolist()

    def all_gather_into_tensor():
        x = torch.empty(3 * n, device=dev)
        dist.all_gather_into_tensor(x, torch.full((3,), rank + 1.0,
                                                  device=dev))
        return x.tolist()

    def send_recv():
        x = torch.full((4,), rank + 1.0, device=dev)
        if rank == 0:
            dist.send(x, 1)
        elif rank == 1:
            dist.recv(x, 0)
        return x.tolist()

    def send_recv_staged():
        x = torch.full((4,), rank + 1.0)
        if rank == 0:
            dist.send(x, 1)
        elif rank == 1:
            dist.recv(x, 0)
        return x.to(dev).tolist()

    _trial(out, "reduce_scatter", reduce_scatter)
    _trial(out, "reduce_scatter_tensor", reduce_scatter_tensor)
    _trial(out, "all_gather_into_tensor", all_gather_into_tensor)

    def all_to_all_single(dtype):
        # uneven splits, nothing sent to itself: rank r sends r + q + 1
        # rows of 3 to each rank q != r (the SSM mixer's re-lay)
        ins = [0 if q == rank else rank + q + 1 for q in range(n)]
        outs = [0 if s == rank else s + rank + 1 for s in range(n)]
        x = torch.full((sum(ins), 3), rank + 1.0, dtype=dtype, device=dev)
        y = torch.empty((sum(outs), 3), dtype=dtype, device=dev)
        dist.all_to_all_single(y, x, outs, ins)
        return y[:, 0].float().tolist()

    for dt in (torch.float32, torch.bfloat16):
        _trial(out, f"all_to_all_single_{dt}",
               lambda dt=dt: all_to_all_single(dt))

    def bulk(op, nbytes, dtype):
        x = torch.ones(nbytes // dtype.itemsize, dtype=dtype, device=dev)
        if op == "all_gather":
            parts = [torch.empty_like(x) for _ in range(n)]
            call = lambda: dist.all_gather(parts, x)   # noqa: E731
        elif op == "all_to_all":
            y = torch.empty_like(x)
            call = lambda: dist.all_to_all_single(y, x)  # noqa: E731
        else:
            call = lambda: dist.all_reduce(x)          # noqa: E731
        call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            call()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / 2 * 1e3
        del x
        torch.cuda.empty_cache()
        return {"ms": ms, "gb_s": nbytes / ms / 1e6}

    out["bulk_ms"] = {}
    for op in ("all_gather", "all_reduce", "all_to_all"):
        for nbytes in (256 << 20, 1 << 30):
            for dt in (torch.float32, torch.bfloat16):
                key = f"{op}_{nbytes >> 20}MB_{dt}"
                try:
                    out["bulk_ms"][key] = bulk(op, nbytes, dt)
                except RuntimeError as e:
                    out["bulk_ms"][key] = {"err": f"{e}"[:300]}
    # last: a failed send can break the ranks' connection for good, so
    # what came before is printed first
    print(json.dumps(out), flush=True)
    _trial(out, "send_recv_cpu_staged",
           lambda: send_recv_staged())
    _trial(out, "send_recv", send_recv)
    dist.barrier()
    return {"rank": rank, "send_recv_cpu_staged":
            out["send_recv_cpu_staged"], "send_recv": out["send_recv"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("gloo_probe: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "device_count": torch.cuda.device_count()}))
    try:
        for out in spawn.run(_rank, args.ranks, args=(args.ranks,),
                             device="cuda", timeout_s=300, deadline_s=900):
            print(json.dumps(out))
    except RuntimeError as e:      # a send/recv that broke the connection
        print(json.dumps({"job_failed": f"{e}"[-600:]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
