"""The device an entry point of the port runs on.

Every entry point (the transcriber facades, `preprocess_audio`,
`preprocess_audio_batch`, `preprocess_audio_fused`) runs on the CUDA card
unless the caller names another device. There is no silent CPU fallback:
without a card, a CUDA device raises and says how to ask for the CPU.
"""

from __future__ import annotations

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


__all__ = ["DEFAULT_DEVICE", "resolve_device"]
