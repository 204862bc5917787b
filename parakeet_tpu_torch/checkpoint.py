"""Training checkpoint and resume (port of parakeet_tpu/checkpoint.py).

The reference's single-file layout: params, the optimizer state and the
step packed into one `state.safetensors` — param keys as they are, the
optimizer's leaves as `##opt.N` in optax's flatten order (train.OptState),
`##meta.step`, and `##meta.treedef`, optax's treedef string, which
train.Adam writes exactly as optax prints it. So a checkpoint of either
package resumes in the other, and `export_weights` of either reads both.
The reference's older three-file layout still loads.
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


def save_train_state(path: str | Path, params: dict, opt_state: OptState, step: int) -> None:
    """Atomic overwrite: params, opt state and step go into one
    `state.safetensors` written to a temporary sibling, fsynced, then
    committed with one `os.replace`, so a crash leaves either the old or the
    new complete checkpoint."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    state: dict[str, np.ndarray] = {k: _host(v) for k, v in params.items()}
    for i, leaf in enumerate(opt_state.leaves()):
        state[f"{_OPT_PREFIX}{i}"] = _host(leaf)
    state[_META_STEP] = np.asarray([int(step)], np.int64)
    state[_META_TREEDEF] = np.frombuffer(opt_state.treedef.encode("utf-8"), np.uint8)
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
    structure; a checkpoint of another optimizer configuration raises."""
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
    for i, tmpl in enumerate(leaves_t):
        leaf = np.asarray(flat[f"opt.{i}"])
        tmpl_shape = tuple(tmpl.shape)
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


__all__ = ["save_train_state", "load_train_state", "export_weights"]
