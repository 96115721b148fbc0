"""Checkpoints with integrity hashes, async save and fallback restore (the
port of ``repro/checkpoint/ckpt.py``), in the reference's layout, so that
either package restores what the other wrote.

Layout: ``<dir>/step_<n>/{arrays.npz, manifest.json}`` + ``<dir>/LATEST``.
Arrays are full numpy buffers keyed by their '/'-joined tree path
(``params/blocks/attn/wq``, ``opt/mu/...``, ``opt/nu/...``, ``opt/step``);
the manifest holds the step and each array's SHA-256, shape and dtype.  A
bfloat16 leaf is stored as float32 (numpy has no bfloat16) and cast back on
restore.

Integrity: every hash is verified on restore, as the file is read (one
pass: each array is read once and hashed on a worker thread while the
next is read); a truncated or corrupt step is skipped, falling back to the
previous one, and ``LATEST`` flips only after a complete write.  GC never
deletes the only verified step.

Sharded trees (a rank's shards on a mesh, with their
:class:`~repro_torch.dist.partition.NamedSharding` tree): every rank of
the mesh joins the save, which gathers the whole of each leaf in turn and
moves it into the host memory of the mesh's first rank (job rank 0), one
leaf on a device at a time; that rank alone writes, in the same layout,
and the others wait for its write in :meth:`CheckpointManager.wait`.  A
restore reads the whole arrays and gives each rank its shard, so a step
saved on one mesh restores on any other, on one device, and through the
reference's reader.

Async save: the caller's thread enqueues a copy of every device tensor
into pinned host memory on a side stream and records an event; the
current stream waits for that event on the device, so a later in-place
optimizer update cannot reach the snapshot, and the host goes on at once.
A writer thread waits for the event, then hashes and writes.  CPU tensors
are cloned instead.
"""

from __future__ import annotations

import contextvars
import concurrent.futures
import hashlib
import json
import os
import shutil
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.models.model import map_params
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace


def flatten(tree: Any, prefix: str = "") -> dict[str, torch.Tensor]:
    """Leaves of a nested dict keyed by their '/'-joined path."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(flatten(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _snapshot(flat: dict[str, torch.Tensor], stream_for):
    """(host copies of ``flat``, one event per device marking its copies
    done).  Device tensors go to pinned memory on the side stream that
    ``stream_for(device)`` gives, after the work already queued on the
    device's current stream, which waits for the copies before any later
    work."""
    host, devices = {}, []
    for k, t in flat.items():
        t = t.detach()
        if t.device.type != "cuda":
            host[k] = t.clone()
            continue
        side = stream_for(t.device)
        if t.device not in devices:
            side.wait_stream(torch.cuda.current_stream(t.device))
            devices.append(t.device)
        with torch.cuda.stream(side):
            host[k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host[k].copy_(t, non_blocking=True)
    events = []
    for dev in devices:
        done = torch.cuda.Event()
        done.record(stream_for(dev))
        torch.cuda.current_stream(dev).wait_event(done)
        events.append(done)
    return host, events


def _sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a)).hexdigest()


#: threads that hash arrays beside the reads and writes (hashlib lets go of
#: the GIL over large buffers)
HASH_THREADS = 4


class CorruptCheckpoint(IOError):
    """A step whose files are missing, unreadable or fail their hashes."""


def _gather_to_host(flat: dict[str, torch.Tensor], shardings: dict,
                    writer: bool) -> dict[str, torch.Tensor]:
    """Every leaf gathered whole in turn (a collective of the mesh) and, on
    the writing rank, moved to host memory before the next one."""
    host = {}
    for k, t in flat.items():
        t = t.detach()
        full = shardings[k].gather(t)
        if writer:      # a leaf no axis cuts is the caller's own tensor
            host[k] = full.to("cpu", copy=full is t)
        del full
    return host


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._io_lock = threading.Lock()   # serializes _write + _gc
        self._streams: dict[torch.device, torch.cuda.Stream] = {}
        self._mesh = None                  # of a sharded save not yet waited

    def _stream(self, device: torch.device) -> torch.cuda.Stream:
        if device not in self._streams:
            self._streams[device] = torch.cuda.Stream(device)
        return self._streams[device]

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree: Any, *, blocking: bool = True,
             shardings: Any = None) -> float:
        """Persist ``tree`` as ``step``.  Returns the seconds the caller was
        blocked: for ``blocking=False`` the time to join the previous save
        (one is in flight at a time) and to enqueue the snapshot; hashing,
        serialization and file I/O run on the writer thread.  The writer
        records its seconds in the ``ckpt.write_s`` histogram and a
        ``ckpt.write`` span.  With ``shardings`` (``tree``'s tree of
        NamedShardings) ``tree`` is this rank's shards and every rank of
        the mesh must call this: the leaves are gathered here, on the
        caller's thread (``ckpt.gather`` span, ``ckpt.gather_s``
        histogram; part of the blocked seconds, async or not), and only
        the mesh's first rank writes."""
        reg = obs_metrics.active_registry()
        t0 = time.perf_counter()
        if shardings is None and blocking:
            self._write(step, flatten(tree), [])
        else:
            self.wait()
            if shardings is None:
                host, events = _snapshot(flatten(tree), self._stream)
            else:
                host, events = self._gather(step, tree, shardings), []
            if host is not None:
                ctx = contextvars.copy_context()   # caller's registry/tracer
                self._thread = threading.Thread(
                    target=ctx.run,
                    args=(self._write_async, step, host, events), daemon=True)
                self._thread.start()
            if blocking:
                self.wait()
        blocked = time.perf_counter() - t0
        reg.counter("ckpt.saves").inc()
        reg.histogram("ckpt.save_block_s").record(blocked)
        return blocked

    def _gather(self, step: int, tree: Any, shardings: Any):
        """Every leaf of this rank's shards gathered whole, leaf by leaf,
        into the first rank's host memory -> those host tensors on the mesh's
        first rank, None on the others (which the next :meth:`wait` tells
        how the write went)."""
        t0 = time.perf_counter()
        flat_sh = flatten(shardings)
        mesh = next(iter(flat_sh.values())).mesh
        with obs_trace.span("ckpt.gather", step=step):
            host = _gather_to_host(flatten(tree), flat_sh, mesh.rank == 0)
        obs_metrics.active_registry().histogram("ckpt.gather_s").record(
            time.perf_counter() - t0)
        self._mesh = mesh
        return host if mesh.rank == 0 else None

    def wait(self) -> None:
        """Join the in-flight save; re-raise what it raised.  After a
        sharded save every rank of the mesh must call it: the writing rank
        tells the others whether its write succeeded, and each raises if it
        did not."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        mesh, self._mesh = self._mesh, None
        if mesh is not None:
            failed = mesh.broadcast_object(
                None if self._error is None else repr(self._error))
            if failed is not None and self._error is None:
                raise IOError(f"rank 0's checkpoint write failed: {failed}")
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _write_async(self, step: int, host: dict[str, torch.Tensor],
                     events: list) -> None:
        try:
            self._write(step, host, events)
        except BaseException as e:          # handed to the caller by wait()
            self._error = e

    def _write(self, step: int, tensors: dict[str, torch.Tensor],
               events: list) -> None:
        t0 = time.perf_counter()
        with obs_trace.span("ckpt.write", step=step), self._io_lock:
            for ev in events:
                ev.synchronize()
            flat = {k: _numpy(v) for k, v in tensors.items()}
            self._write_arrays(step, flat)
        obs_metrics.active_registry().histogram("ckpt.write_s").record(
            time.perf_counter() - t0)

    def _write_arrays(self, step: int, flat: dict[str, np.ndarray]) -> None:
        path = os.path.join(self.dir, f"step_{step:08d}")
        tmp = path + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        with concurrent.futures.ThreadPoolExecutor(HASH_THREADS) as pool:
            hashes = {k: pool.submit(_sha, v) for k, v in flat.items()}
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            hashes = {k: h.result() for k, h in hashes.items()}
        manifest = {
            "step": step,
            "hashes": hashes,
            "shapes": {k: list(v.shape) for k, v in flat.items()},
            "dtypes": {k: str(v.dtype) for k, v in flat.items()},
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.replace(tmp, path)
        # LATEST flips only after a complete, verifiable write
        latest_tmp = os.path.join(self.dir, "LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(os.path.basename(path))
        os.replace(latest_tmp, os.path.join(self.dir, "LATEST"))
        self._gc()

    def _gc(self) -> None:
        """Delete old steps, but never the only *verified* checkpoint: if
        none of the ``keep`` newest steps verifies, the newest verified
        older step is kept.  The common case verifies only the newest."""
        steps = sorted(self.all_steps())
        doomed = steps[:-self.keep] if self.keep > 0 else list(steps)
        if not doomed:
            return
        kept = steps[len(doomed):]
        if not any(self.verify(s) for s in reversed(kept)):
            for s in reversed(doomed):
                if self.verify(s):
                    doomed = [d for d in doomed if d != s]
                    break
        for s in doomed:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except (IndexError, ValueError):
                    continue           # stray file racing the async writer
        return sorted(out)

    def latest_step(self) -> int | None:
        latest = os.path.join(self.dir, "LATEST")
        if os.path.exists(latest):
            with open(latest) as f:
                name = f.read().strip()
            if os.path.exists(os.path.join(self.dir, name)):
                try:
                    return int(name.split("_")[1])
                except (IndexError, ValueError):
                    pass
        steps = self.all_steps()
        return steps[-1] if steps else None

    def verify(self, step: int) -> bool:
        path = os.path.join(self.dir, f"step_{step:08d}")
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            with np.load(os.path.join(path, "arrays.npz")) as z:
                for k, h in manifest["hashes"].items():
                    if _sha(z[k]) != h:
                        return False
            return True
        except Exception:               # any damage reads as unverified
            return False

    def _read(self, step: int) -> dict[str, np.ndarray]:
        """Every array of ``step``, read once and checked against the
        manifest's hashes.  Raises :class:`CorruptCheckpoint` on any
        damage."""
        path = os.path.join(self.dir, f"step_{step:08d}")
        try:
            with open(os.path.join(path, "manifest.json")) as f:
                manifest = json.load(f)
            want = manifest["hashes"]
            flat = {}
            pool = concurrent.futures.ThreadPoolExecutor(HASH_THREADS)
            with np.load(os.path.join(path, "arrays.npz")) as z, pool:
                hashes = {}
                for k in want:
                    flat[k] = z[k]
                    hashes[k] = pool.submit(_sha, flat[k])
                bad = [k for k, h in hashes.items() if h.result() != want[k]]
        except Exception as e:          # any damage reads as unverified
            raise CorruptCheckpoint(f"checkpoint {path} is unreadable: "
                                    f"{e!r}") from e
        if bad:
            raise CorruptCheckpoint(f"checkpoint {path} failed integrity "
                                    f"verification: {bad[:4]}")
        return flat

    def restore(self, step: int, template: Any,
                shardings: Any = None) -> Any:
        """Restore onto ``template``'s structure: each leaf a new tensor
        with the template leaf's dtype and device, and with ``shardings``
        (the template's tree of NamedShardings) this rank's shard of it.
        Raises :class:`CorruptCheckpoint` (an ``IOError``) if the step does
        not verify."""
        flat = self._read(step)
        flat_sh = None if shardings is None else flatten(shardings)

        def load(path: tuple[str, ...], leaf: torch.Tensor) -> torch.Tensor:
            key = "/".join(path)
            if key not in flat:
                raise KeyError(f"checkpoint missing leaf {key}")
            full = torch.from_numpy(flat.pop(key))
            if flat_sh is not None:
                full = flat_sh[key].local(full)
            return full.to(device=leaf.device, dtype=leaf.dtype)
        return map_params(load, template)

    def restore_latest(self, template: Any, shardings: Any = None,
                       on_corrupt: Callable[[int], None] | None = None):
        """Restore the newest verifiable checkpoint (skipping corrupt ones,
        each read once).  Returns (step, tree) or (None, None)."""
        for step in reversed(self.all_steps()):
            try:
                return step, self.restore(step, template, shardings)
            except CorruptCheckpoint:
                if on_corrupt:
                    on_corrupt(step)
        return None, None
