"""The device an entry point of the port runs on.

Every entry point (the transcriber facades, `preprocess_audio`,
`preprocess_audio_batch`, `preprocess_audio_fused`) runs on the CUDA card
unless the caller names another device. There is no silent CPU fallback:
without a card, a CUDA device raises and says how to ask for the CPU.
Under torch.distributed each rank takes its own card (`rank_device`).
"""

from __future__ import annotations

import os

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """`device` as a torch.device; RuntimeError for a CUDA device when no
    card is available."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but no CUDA device is available; "
            "pass device=\"cpu\" to run on the CPU"
        )
    return dev


def rank_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """This rank's device: a CUDA device without an index becomes
    cuda:(local rank % device count), the local rank read from LOCAL_RANK
    (as torchrun sets it), else the rank of the initialised default group,
    else 0. Any other device is `resolve_device`'s."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    import torch.distributed as dist

    local = os.environ.get("LOCAL_RANK")
    rank = int(local) if local is not None else (dist.get_rank() if dist.is_initialized() else 0)
    return torch.device("cuda", rank % torch.cuda.device_count())


__all__ = ["DEFAULT_DEVICE", "resolve_device", "rank_device"]
