"""Spawn ranks joined in one ``torch.distributed`` group.

The JAX package drives every device of a mesh from one process. PyTorch's
idiom is one process per mesh position: ``spawn(fn, n)`` starts ``n``
processes (``multiprocessing``'s ``spawn`` method), joins them in one
group through a ``file://`` rendezvous in a fresh temporary directory (no
TCP port, so concurrent test workers never collide), runs ``fn(*args)`` on
every rank and returns the ranks' results in rank order.

Each rank sets ``torch.cuda.set_device(rank)`` when the backend is NCCL
and runs torch's CPU ops on one thread (ranks share the host's cores). The
group gets ``timeout_s``
as its collective timeout, and the parent joins the children against the
same deadline: past it every child is killed and ``spawn`` raises, so a
deadlocked collective fails its caller instead of hanging. A rank that
raises makes ``spawn`` raise with that rank's traceback.

``fn`` must be importable by name (a module-level function): the children
start from a fresh interpreter. ``fn``, its arguments and the results travel
pickled through the temporary directory: a payload in the start pipe would
make each start wait for the previous child to read it.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist


def init_group(backend: str, world_size: int, rank: int, init_method: str,
               timeout_s: float) -> None:
    """Join the default group; NCCL ranks first take card ``rank``."""
    if backend == "nccl":
        torch.cuda.set_device(rank)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=datetime.timedelta(seconds=timeout_s))


def _rank_main(rank: int, world_size: int, backend: str, init_method: str,
               timeout_s: float, out_dir: str) -> None:
    torch.set_num_threads(1)
    try:
        with open(os.path.join(out_dir, "payload.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        init_group(backend, world_size, rank, init_method, timeout_s)
        try:
            result = fn(*args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out_dir, f"result-{rank}.pkl"), "wb") as f:
            pickle.dump(result, f)
    except BaseException:
        with open(os.path.join(out_dir, f"error-{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def spawn(fn: Callable[..., Any], world_size: int, args: Sequence[Any] = (),
          backend: str = "gloo", timeout_s: float = 120.0) -> List[Any]:
    """Run ``fn(*args)`` on ``world_size`` ranks of one group; returns
    every rank's result, rank 0 first. Raises ``TimeoutError`` when the
    ranks have not all ended ``timeout_s`` seconds after the start, and
    ``RuntimeError`` (with the first failing rank's traceback) when one
    fails."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="b2t_spawn_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        with open(os.path.join(tmp, "payload.pkl"), "wb") as f:
            pickle.dump((fn, tuple(args)), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(rank, world_size, backend, init_method, timeout_s, tmp))
                 for rank in range(world_size)]
        deadline = time.monotonic() + timeout_s
        for p in procs:
            p.start()
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            alive = [p for p in procs if p.is_alive()]
            for p in alive:
                p.kill()
            for p in alive:
                p.join()
        failed = [r for r in range(world_size)
                  if os.path.exists(os.path.join(tmp, f"error-{r}.txt"))]
        if failed:
            with open(os.path.join(tmp, f"error-{failed[0]}.txt")) as f:
                raise RuntimeError(f"rank {failed[0]} of {world_size} failed:\n{f.read()}")
        if alive:
            raise TimeoutError(f"ranks {[procs.index(p) for p in alive]} of {world_size} "
                               f"still running after {timeout_s} s; killed")
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"ranks exited with codes {codes}")
        results = []
        for rank in range(world_size):
            with open(os.path.join(tmp, f"result-{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
