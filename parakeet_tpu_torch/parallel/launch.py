"""Run a function SPMD on spawned ranks of one host (no counterpart in
parakeet_tpu: a JAX program is one controller over every device).

`spawn_ranks(fn, world, ...)` starts `world` processes with the spawn
method, each of which initialises the default process group (rendezvous
through a file in a temporary directory, so concurrent runs never share a
port),
calls fn(rank, *args) and sends back its return value. Every rank's result
comes back in rank order; if a rank raises, or the ranks run past
`timeout` seconds, the others are killed and RuntimeError carries each
failing rank's traceback (the others' reports are awaited a few seconds
after the first failure), so a rank that hangs in a collective fails the
caller instead of blocking it.
"""

from __future__ import annotations

import os
import queue as queue_mod
import tempfile
import time
import traceback


_GRACE_S = 5.0  # after a rank fails, how long the others' reports are awaited


def _rank_main(rank: int, world: int, init_method: str, backend: str, threads: int, fn, args, results) -> None:
    import torch
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
        results.put((rank, True, fn(rank, *args)))
    except BaseException:  # reported to the parent (before any teardown), which fails the run
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world: int, *args, backend: str = "gloo", timeout: float = 120.0, threads: int = 1) -> list:
    """fn(rank, *args) on `world` spawned ranks; their return values in rank
    order. fn and args are pickled (fn importable by name). threads: torch
    threads per rank (0 leaves torch's default)."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = f"file://{os.path.join(tmp, 'rdzv')}"
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, args=(r, world, init_method, backend, threads, fn, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        out, errors = {}, {}
        deadline = time.monotonic() + timeout
        try:
            while len(out) + len(errors) < world and time.monotonic() < deadline:
                try:
                    rank, ok, value = results.get(timeout=max(0.1, deadline - time.monotonic()))
                except queue_mod.Empty:
                    continue
                (out if ok else errors)[rank] = value
                if not ok:  # the others may wait in a collective: collect their reports briefly
                    deadline = min(deadline, time.monotonic() + _GRACE_S)
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()) if not errors else 1.0)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
            results.close()
    if errors or len(out) < world:
        lines = [f"rank {r}:\n{tb}" for r, tb in sorted(errors.items())]
        missing = sorted(set(range(world)) - set(out) - set(errors))
        if missing:
            lines.append(f"ranks {missing} gave no result within {timeout:.0f} s")
        raise RuntimeError(f"spawn_ranks({getattr(fn, '__name__', fn)}, world={world}) failed:\n" + "\n".join(lines))
    return [out[r] for r in range(world)]


__all__ = ["spawn_ranks"]
