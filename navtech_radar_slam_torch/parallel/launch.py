"""Run a function on N ranks of a process group, one process per rank.

JAX's single controller needs no launcher; ``torch.distributed`` runs one
process per rank.  ``launch(fn, n, *args)`` starts ``n`` processes with
``torch.multiprocessing`` (spawn), joins them into one group through a
``FileStore`` in a temporary directory, calls ``fn(mesh, *args)`` on each
with its ``parallel.mesh.Mesh`` and returns rank 0's result (or every
rank's, with ``all_ranks=True``).  A rank's exception is raised again in
the caller with that rank's traceback; a rank that dies or outlasts
``timeout`` fails the call, and every process is stopped before it returns.

``fn`` and its arguments cross the process boundary by pickle, written
once to a file in the temporary directory that every rank reads (through
the spawn pipe each rank's start would wait for the one before it to read
its copy), so ``fn`` must be a module-level function; tensors in the
result come back as numpy arrays.
"""

from __future__ import annotations

import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch
import torch.multiprocessing as mp

from navtech_radar_slam_torch.parallel import mesh as mesh_mod


def _to_host(x: Any) -> Any:
    """Tensors (also inside tuples, lists, dicts and NamedTuples) as numpy,
    so that a result pickles by value."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_host(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_host(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    return x


def _rank_main(rank: int, world: int, backend: str, device: str, store_path: str,
               timeout: float, threads: Optional[int], call_path: str, results) -> None:
    import torch.distributed as dist

    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)
        if threads is not None:
            torch.set_num_threads(threads)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.FileStore(store_path, world)
        mesh_mod.init_distributed(backend, rank=rank, world_size=world, timeout=timeout,
                                  store=store)
        try:
            out = _to_host(fn(mesh_mod.make_mesh(dev), *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def launch(fn: Callable, world_size: int, *args, backend: str = "gloo",
           devices: str | Sequence[str] = "cpu", all_ranks: bool = False,
           timeout: float = 600.0, threads: Optional[int] = None,
           deadline: Optional[float] = -1.0) -> Any:
    """``fn(mesh, *args)`` on ``world_size`` ranks.

    ``backend``: ``gloo`` or ``nccl``, as ``mesh.init_distributed`` takes
    it (also the collectives' timeout, ``timeout`` seconds).  ``devices``:
    one device for every rank, or one per rank (``nccl`` needs a card per
    rank).  ``threads``: torch threads per rank (None leaves torch's
    default).  ``deadline``: seconds the whole call may take (default
    ``timeout``; None: no bound but the collectives' timeout).  Returns rank 0's result, or the list of every rank's with
    ``all_ranks``."""
    if isinstance(devices, str):
        devices = [devices] * world_size
    if len(devices) != world_size:
        raise ValueError(f"launch: {len(devices)} devices for {world_size} ranks")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="nrs_launch_")
    call_path = os.path.join(tmp, "call.pkl")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, backend, str(devices[r]),
                               os.path.join(tmp, "store"), timeout, threads, call_path,
                               results))
             for r in range(world_size)]
    got, started = {}, []
    try:
        with open(call_path, "wb") as f:
            pickle.dump((fn, args), f, protocol=pickle.HIGHEST_PROTOCOL)
        for p in procs:
            p.start()
            started.append(p)
        if deadline is not None:
            deadline = time.monotonic() + (timeout if deadline < 0 else deadline)
        while len(got) < world_size:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead and results.empty():
                    raise RuntimeError(f"launch: rank {dead[0]} ended with exit code "
                                       f"{procs[dead[0]].exitcode} without a result")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"launch: ranks {sorted(set(range(world_size)) - set(got))} "
                                       f"did not finish in time")
                continue
            if not ok:
                raise RuntimeError(f"launch: rank {rank} of {world_size} failed:\n{out}")
            got[rank] = out
    finally:
        for p in started:
            p.join(timeout=10.0 if len(got) == world_size else 0.5)
        for p in started:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(world_size)] if all_ranks else got[0]
