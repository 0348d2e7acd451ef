"""Start ranks on one host: ``n`` spawned processes around one process group.

``run(fn, n, *args)`` spawns ``n`` processes (the ``spawn`` start method: a
CUDA context does not survive ``fork``), joins them to a process group
through a FileStore in a temporary directory (no TCP port to collide), and
calls ``fn(mesh, *args)`` in each; it returns the ranks' results in rank
order.  ``fn`` must be importable by name from a module that does not
import JAX (``parallel/checks.py`` holds the package's rank programs), and
its results picklable (numpy arrays, numbers).  Each rank runs one CPU
thread.  On the card the kernel library is built once here, before the
spawn, so that the ranks load it instead of racing to build it.

A rank that raises fails the run: the others are stopped and its traceback
is raised here.  ``spawn`` is the same without the process group, for rank
programs that join one themselves (``multihost.initialize``).
"""
from __future__ import annotations

import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist

from .spmd import backend_for, make_mesh, rank_device

DEFAULT_TIMEOUT_S = 120.0   # a collective's wait
RUN_TIMEOUT_S = 1800.0      # a whole run


def _child(fn, rank: int, world_size: int, results, args) -> None:
    torch.set_num_threads(1)
    try:
        results.put((rank, True, fn(rank, world_size, *args)))
    except Exception:   # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, world_size: int, *args, timeout_s: float = RUN_TIMEOUT_S) -> list:
    """``fn(rank, world_size, *args)`` in ``world_size`` spawned processes;
    their results in rank order.  Raises the first failure, or
    TimeoutError after ``timeout_s``; stops every process it started."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_child, args=(fn, rank, world_size, results, args),
                         daemon=True) for rank in range(world_size)]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(out) < world_size:
            if time.monotonic() > deadline:
                raise TimeoutError(f"ranks {sorted(set(range(world_size)) - set(out))} "
                                   f"did not finish in {timeout_s} s")
            try:
                rank, ok, payload = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode is not None and r not in out]
                if dead and results.empty():
                    time.sleep(1.0)     # a result may still be in the pipe
                    if results.empty():
                        raise RuntimeError(f"rank {dead[0]} exited with code "
                                           f"{procs[dead[0]].exitcode} and no result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {world_size} failed:\n{payload}")
            out[rank] = payload
        for p in procs:
            p.join(timeout=60.0)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(world_size)]


def _rank_main(rank: int, world_size: int, fn, device_type: str, backend: str,
               store_path: str, timeout_s: float, *args):
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                            timeout=timedelta(seconds=timeout_s))
    try:
        mesh = make_mesh([rank_device(r, device_type) for r in range(world_size)])
        return fn(mesh, *args)
    finally:
        dist.destroy_process_group()


def run(fn, world_size: int, *args, device="cuda", timeout_s: float = DEFAULT_TIMEOUT_S,
        store_dir: str = None) -> list:
    """``fn(mesh, *args)`` on ``world_size`` ranks of one process group:
    rank r on ``cuda:(r % device_count)`` (``device="cpu"``: the CPU), the
    backend NCCL when every rank has a card of its own and gloo otherwise.
    Every collective fails after ``timeout_s``, the run after
    ``RUN_TIMEOUT_S``; the FileStore lives in a temporary directory (under
    ``store_dir`` if given).  Returns the ranks' results in rank order."""
    device = torch.device(device)
    if device.type == "cuda":
        from ..kernels import _build

        _build.library()
    backend = backend_for(world_size, device)
    tmp = tempfile.mkdtemp(prefix="proslam_store_", dir=store_dir)
    try:
        return spawn(_rank_main, world_size, fn, device.type, backend,
                     os.path.join(tmp, "store"), timeout_s, *args)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
