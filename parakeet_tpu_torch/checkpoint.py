"""Training checkpoint and resume (port of parakeet_tpu/checkpoint.py).

The reference's single-file layout: params, the optimizer state and the
step packed into one `state.safetensors` — param keys as they are, the
optimizer's leaves as `##opt.N` in optax's flatten order (train.OptState),
`##meta.step`, and `##meta.treedef`, optax's treedef string, which
train.Adam writes exactly as optax prints it. So a checkpoint of either
package resumes in the other, and `export_weights` of either reads both.
The reference's older three-file layout still loads.

On a mesh (an optimizer state with a `train.MeshLayout`) every rank calls
`save_train_state`: the shards are gathered whole (vocabularies padded,
the pipeline trainer's stages stacked and merged back to the schema), so
the file is what the reference writes at the same step, and global rank 0
writes it. `load_train_state` checks the leaves against the whole shapes;
train_loop.place_train_state shards them again.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np
import torch

from parakeet_tpu_torch.io.safetensors import load_safetensors, save_safetensors
from parakeet_tpu_torch.train import OptState

#: key prefixes reserved inside the single-file train state (the reference
#: schema never uses '##', so param keys cannot collide)
_OPT_PREFIX = "##opt."
_META_STEP = "##meta.step"
_META_TREEDEF = "##meta.treedef"


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def whole_train_state(params: dict, opt_state: OptState) -> tuple[dict, list]:
    """The params in the checkpoint schema and the optimizer's leaves, whole:
    on a mesh gathered over it (a collective every rank calls), the
    pipeline trainer's {layers, rest} merged back into schema keys."""
    from parakeet_tpu_torch.train import flatten_params

    layout = opt_state.layout
    if layout is None:
        return params, opt_state.leaves()
    flat = layout.gather(flatten_params(params))
    if flat and isinstance(next(iter(flat)), tuple):
        from parakeet_tpu_torch.parallel.pipeline import merge_layer_params

        flat = merge_layer_params({k: v for (o, k), v in flat.items() if o == "layers"},
                                  {k: v for (o, k), v in flat.items() if o == "rest"})
    mu, nu = layout.gather(opt_state.mu), layout.gather(opt_state.nu)
    leaves = [opt_state.count, *(mu[k] for k in sorted(mu)), *(nu[k] for k in sorted(nu))]
    if opt_state.schedule_count is not None:
        leaves.append(opt_state.schedule_count)
    return flat, leaves


def save_train_state(path: str | Path, params: dict, opt_state: OptState, step: int) -> None:
    """Atomic overwrite: params, opt state and step go into one
    `state.safetensors` written to a temporary sibling, fsynced, then
    committed with one `os.replace`, so a crash leaves either the old or the
    new complete checkpoint. On a mesh every rank calls it; the state is
    gathered whole and global rank 0 writes, the others waiting until the
    file is there."""
    from parakeet_tpu_torch.parallel.mesh import global_rank

    params, leaves = whole_train_state(params, opt_state)
    if global_rank() == 0:
        _write(Path(path), params, leaves, opt_state.treedef, step)
    if opt_state.layout is not None:
        import torch.distributed as dist

        dist.barrier()


def _write(path: Path, params: dict, leaves: list, treedef: str, step: int) -> None:
    path.mkdir(parents=True, exist_ok=True)
    state: dict[str, np.ndarray] = {k: _host(v) for k, v in params.items()}
    for i, leaf in enumerate(leaves):
        state[f"{_OPT_PREFIX}{i}"] = _host(leaf)
    state[_META_STEP] = np.asarray([int(step)], np.int64)
    state[_META_TREEDEF] = np.frombuffer(treedef.encode("utf-8"), np.uint8)
    tmp = path / ".state.safetensors.tmp"
    save_safetensors(state, tmp)
    with open(tmp, "rb") as f:  # data durable before the rename commits it
        os.fsync(f.fileno())
    os.replace(tmp, path / "state.safetensors")
    for legacy in ("params.safetensors", "opt_state.safetensors", "meta.json"):
        try:  # no stale files of the older layout beside the new one
            (path / legacy).unlink()
        except OSError:
            pass


def _load_raw_state(path: Path) -> tuple[dict, dict[str, np.ndarray], dict]:
    """Read either layout → (params, flat opt arrays keyed 'opt.N', meta)."""
    single = path / "state.safetensors"
    if single.exists():
        blob = load_safetensors(single)
        params = {k: v.copy() for k, v in blob.items() if not k.startswith("##")}
        flat = {k[2:]: v for k, v in blob.items() if k.startswith(_OPT_PREFIX)}
        meta = {
            "step": int(blob[_META_STEP][0]),
            "treedef": bytes(blob[_META_TREEDEF]).decode("utf-8"),
        }
        return params, flat, meta
    params = {k: v.copy() for k, v in load_safetensors(path / "params.safetensors").items()}
    flat = load_safetensors(path / "opt_state.safetensors")
    meta = json.loads((path / "meta.json").read_text())
    return params, flat, meta


def load_train_state(path: str | Path, opt_state_template: OptState) -> tuple[dict, OptState, int]:
    """Restore (params as numpy, opt state on the CPU, step).
    `opt_state_template` (e.g. the trainer's fresh state) gives the
    structure, on a mesh the whole shapes of its shards; a checkpoint of
    another optimizer configuration raises."""
    path = Path(path)
    params, flat, meta = _load_raw_state(path)
    leaves_t = opt_state_template.leaves()
    if len(flat) != len(leaves_t):
        raise ValueError(
            f"opt state leaf count mismatch: checkpoint {len(flat)} vs template {len(leaves_t)}"
        )
    saved_treedef = meta.get("treedef")
    if saved_treedef is not None and saved_treedef != opt_state_template.treedef:
        raise ValueError(
            "opt state structure mismatch: the checkpoint was saved "
            "with a different optimizer configuration; "
            f"saved={saved_treedef!r} template={opt_state_template.treedef!r}"
        )
    leaves = []
    for i, tmpl_shape in enumerate(opt_state_template.whole_shapes()):
        leaf = np.asarray(flat[f"opt.{i}"])
        if tuple(leaf.shape) != tmpl_shape:
            if tmpl_shape == () and leaf.size == 1:
                leaf = leaf.reshape(())  # safetensors stores the 0-d count as (1,)
            else:
                raise ValueError(
                    f"opt state leaf {i} shape mismatch: checkpoint "
                    f"{tuple(leaf.shape)} vs template {tmpl_shape} — wrong "
                    "model or optimizer for this checkpoint"
                )
        leaves.append(leaf)
    return params, opt_state_template.with_leaves(leaves), int(meta["step"])


def export_weights(train_ckpt: str | Path, weights_path: str | Path) -> None:
    """Train checkpoint → plain inference safetensors (reference schema);
    needs only the params."""
    path = Path(train_ckpt)
    single = path / "state.safetensors"
    if single.exists():
        blob = load_safetensors(single)
        params = {k: v for k, v in blob.items() if not k.startswith("##")}
    else:
        params = load_safetensors(path / "params.safetensors")
    save_safetensors(dict(params), weights_path, metadata={"format": "pt"})


__all__ = ["save_train_state", "whole_train_state", "load_train_state", "export_weights"]
