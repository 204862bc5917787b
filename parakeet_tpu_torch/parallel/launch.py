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
caller instead of blocking it. A rank whose process ends without a report
(a signal, or a crash in its start) fails the call within a second.

`timeout` counts from the moment every rank has joined the process group:
a rank's start (a fresh interpreter importing torch and fn's module, then
the rendezvous) takes seconds on an idle host and many times that on a
loaded one, and is bounded on its own (START_TIMEOUT_S).
"""

from __future__ import annotations

import os
import queue as queue_mod
import tempfile
import time
import traceback


_GRACE_S = 5.0  # after a rank fails, how long the others' reports are awaited
START_TIMEOUT_S = 600.0  # for every rank to join the process group
_POLL_S = 0.5  # how often the wait looks for a rank that ended without a report


def _rank_main(rank: int, world: int, init_method: str, backend: str, threads: int, fn, args, results) -> None:
    import torch
    import torch.distributed as dist

    if threads:
        torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank)
        results.put((rank, "joined", None))
        results.put((rank, "result", fn(rank, *args)))
    except BaseException:  # reported to the parent (before any teardown), which fails the run
        results.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world: int, *args, backend: str = "gloo", timeout: float = 120.0, threads: int = 1) -> list:
    """fn(rank, *args) on `world` spawned ranks; their return values in rank
    order. fn and args are pickled (fn importable by name). threads: torch
    threads per rank (0 leaves torch's default). timeout: seconds from the
    moment every rank has joined the process group."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = f"file://{os.path.join(tmp, 'rdzv')}"
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, args=(r, world, init_method, backend, threads, fn, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        joined, out, errors = set(), {}, {}
        deadline = time.monotonic() + START_TIMEOUT_S
        try:
            while len(out) + len(errors) < world and time.monotonic() < deadline:
                ended = [r for r, p in enumerate(procs) if p.exitcode is not None]
                try:
                    rank, kind, value = results.get(timeout=min(_POLL_S, max(0.01, deadline - time.monotonic())))
                except queue_mod.Empty:
                    # a rank's reports are in the queue before its process ends, so a rank that had
                    # ended before this empty read sent none (killed, or died in its start)
                    for r in ended:
                        if r not in out and r not in errors:
                            errors[r] = f"ended with exit code {procs[r].exitcode} without a report\n"
                            deadline = min(deadline, time.monotonic() + _GRACE_S)
                    continue
                if kind == "joined":
                    joined.add(rank)
                    if len(joined) == world and not errors:  # every rank is in: fn's clock starts
                        deadline = time.monotonic() + timeout
                    continue
                (out if kind == "result" else errors)[rank] = value
                if kind == "error":  # the others may wait in a collective: collect their reports briefly
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
        if missing and len(joined) < world:
            lines.append(f"ranks {sorted(set(range(world)) - joined)} did not join the process group "
                         f"within {START_TIMEOUT_S:g} s")
        elif missing:
            lines.append(f"ranks {missing} gave no result within {timeout:g} s")
        raise RuntimeError(f"spawn_ranks({getattr(fn, '__name__', fn)}, world={world}) failed:\n" + "\n".join(lines))
    return [out[r] for r in range(world)]


__all__ = ["spawn_ranks"]
