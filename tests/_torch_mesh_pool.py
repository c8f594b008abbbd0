"""A pool of gloo ranks for the port's mesh tests.

`RankPool(n, tmp_dir)` spawns ``n`` worker processes once (a
module-scoped fixture per test file), each with one BLAS thread
(``OMP_NUM_THREADS=1``), joined into one gloo world through a file store
under ``tmp_dir``.  ``pool.run("module:function", *args, **kwargs)`` runs the
function on every rank (SPMD) and returns each rank's result, in rank
order; a failure on any rank raises with that rank's traceback.  The
functions live in `torch_mesh_ranks`, which imports the port only, so
the ranks never load JAX.
"""
from __future__ import annotations

import importlib
import multiprocessing as mp
import os
import queue
import sys
import traceback

_TESTS = os.path.dirname(os.path.abspath(__file__))
_REPO = os.path.dirname(_TESTS)


def _worker(rank, world, store, tasks, results):
    os.environ["OMP_NUM_THREADS"] = "1"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    for p in (_REPO, _TESTS):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    while True:
        task = tasks.get()
        if task is None:
            break
        target, args, kwargs = task
        try:
            mod_name, fn_name = target.split(":")
            fn = getattr(importlib.import_module(mod_name), fn_name)
            results.put((rank, True, fn(*args, **kwargs)))
        except BaseException:  # noqa: BLE001 - reported to the test
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    def __init__(self, world: int, tmp_dir: str):
        ctx = mp.get_context("spawn")
        self.world = world
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        store = os.path.join(str(tmp_dir), "gloo_store")
        self.procs = [ctx.Process(target=_worker,
                                  args=(r, world, store, self.tasks[r],
                                        self.results), daemon=True)
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, target: str, *args, timeout: float = 120.0, **kwargs):
        """``target`` ("module:function") on every rank -> the results in
        rank order."""
        for q in self.tasks:
            q.put((target, args, kwargs))
        out, errors = [None] * self.world, []
        for _ in range(self.world):
            try:
                rank, ok, value = self.results.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError(f"{target}: a rank gave no result in "
                                   f"{timeout} s") from None
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise AssertionError(f"{target} failed\n" + "\n".join(errors))
        return out

    def close(self):
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
