"""Primitive NN ops (the reference's parakeet_tpu/ops/__init__.py names).

Only the plain layers are imported here; the kernel modules (ops/*.py over
csrc/*.cu) import on use and build nothing until a CUDA tensor reaches
them."""

from parakeet_tpu_torch.ops.layers import (
    batch_norm_1d,
    conv1d,
    conv2d,
    embedding,
    glu,
    layer_norm,
    linear,
)
from parakeet_tpu_torch.ops.lstm import lstm_step, lstm_zero_state

__all__ = [
    "linear",
    "conv1d",
    "conv2d",
    "layer_norm",
    "batch_norm_1d",
    "embedding",
    "glu",
    "lstm_step",
    "lstm_zero_state",
]
