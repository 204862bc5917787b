"""Shared train-CLI machinery (port of parakeet_tpu/train_loop.py):
resume placement and the step / log / checkpoint loop of both train
CLIs, on one device."""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from parakeet_tpu_torch.checkpoint import save_train_state
from parakeet_tpu_torch.train import OptState, TrainState


def place_train_state(device, params_host: dict, opt_host: OptState, step: int, ref_state: TrainState) -> TrainState:
    """Host-loaded state moved to `device`, each tensor in the dtype of the
    trainer's fresh state `ref_state` (the reference places it on its mesh
    here)."""
    params = {k: torch.as_tensor(np.asarray(params_host[k])).to(device=device, dtype=v.dtype)
              for k, v in ref_state.params.items()}
    leaves = [leaf.to(ref.dtype) for leaf, ref in zip(opt_host.leaves(), ref_state.opt_state.leaves())]
    return TrainState(params, opt_host.with_leaves(leaves).to(device), step)


def run_training(
    loader,
    state: TrainState,
    step_fn,
    place_batch,
    *,
    steps: int,
    log_every: int,
    checkpoint_dir=None,
    checkpoint_every: int = 100,
):
    """Run optimizer steps from `state.step` to `steps`, logging every
    `log_every` (the loss read from the card there) and checkpointing every
    `checkpoint_every`. Returns (params, opt_state, step)."""
    params, opt_state, step = state.params, state.opt_state, state.step
    t0 = time.perf_counter()
    while step < steps:
        for batch in loader:
            if step >= steps:
                break
            params, opt_state, lval = step_fn(params, opt_state, place_batch(batch))
            step += 1
            if step % log_every == 0 or step == steps:
                dt = time.perf_counter() - t0
                print(f"step {step}/{steps}  loss {float(lval):.4f}  "
                      f"{dt / max(1, step - state.step):.2f}s/step", file=sys.stderr)
            if checkpoint_dir and step % checkpoint_every == 0:
                save_train_state(checkpoint_dir, params, opt_state, step)
    return params, opt_state, step


__all__ = ["place_train_state", "run_training"]
