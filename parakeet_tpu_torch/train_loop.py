"""Shared train-CLI machinery (port of parakeet_tpu/train_loop.py): resume
placement, on one device or a mesh, and the step / log / checkpoint loop
of both train CLIs."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from parakeet_tpu_torch.checkpoint import save_train_state
from parakeet_tpu_torch.parallel.mesh import global_rank
from parakeet_tpu_torch.train import OptState, TrainState, flatten_params, unflatten_params


def place_train_state(mesh, params_host: dict, opt_host: OptState, step: int, ref_state: TrainState) -> TrainState:
    """Host-loaded whole state placed as the trainer's fresh state
    `ref_state` holds it: each tensor in its dtype, on `mesh`'s device and
    sharded as its `MeshLayout` says (the reference re-applies its
    shardings here), or on `mesh` itself when that is a device (a trainer
    without a mesh). `params_host` has the trainer's structure (the
    pipeline trainer's {layers, rest}); vocabularies already padded."""
    layout = ref_state.opt_state.layout
    device = mesh if layout is None else mesh.device

    def placed(key, host, ref):
        v = torch.as_tensor(np.asarray(host))
        v = v if layout is None else layout.shard(key, v)
        return v.to(device=device, dtype=ref.dtype)

    ref_flat, host_flat = flatten_params(ref_state.params), flatten_params(params_host)
    params = unflatten_params({k: placed(k, host_flat[k], v) for k, v in ref_flat.items()})
    ref = ref_state.opt_state
    leaves = [leaf.to(r.dtype) for leaf, r in zip(opt_host.leaves(), ref.leaves())]
    opt = opt_host.with_leaves(leaves)
    opt.mu = {k: placed(k, v, ref.mu[k]) for k, v in opt.mu.items()}
    opt.nu = {k: placed(k, v, ref.nu[k]) for k, v in opt.nu.items()}
    opt.layout = layout
    return TrainState(params, opt.to(device), step)


def run_training(
    mesh,
    loader,
    state: TrainState,
    step_fn,
    place_batch,
    *,
    steps: int,
    log_every: int,
    checkpoint_dir=None,
    checkpoint_every: int = 100,
    as_schema=lambda p: p,
):
    """Run optimizer steps from `state.step` to `steps`, logging every
    `log_every` (the loss read from the card there) and checkpointing every
    `checkpoint_every`. On a mesh (`mesh`; the device without one) every
    rank runs the loop, rank 0 alone logs, and the checkpoint gathers the
    state (checkpoint.save_train_state, which rank 0 writes). `as_schema`
    is the reference's hook for the pipeline trainer's {layers, rest};
    here the gather merges them, and it applies to a trainer without a
    mesh. Returns (params, opt_state, step)."""
    params, opt_state, step = state.params, state.opt_state, state.step
    t0 = time.perf_counter()
    while step < steps:
        for batch in loader:
            if step >= steps:
                break
            params, opt_state, lval = step_fn(params, opt_state, place_batch(batch))
            step += 1
            if (step % log_every == 0 or step == steps) and global_rank() == 0:
                dt = time.perf_counter() - t0
                print(f"step {step}/{steps}  loss {float(lval):.4f}  "
                      f"{dt / max(1, step - state.step):.2f}s/step", file=sys.stderr)
            if checkpoint_dir and step % checkpoint_every == 0:
                save_train_state(checkpoint_dir, params if opt_state.layout else as_schema(params), opt_state, step)
    return params, opt_state, step


__all__ = ["place_train_state", "run_training"]
