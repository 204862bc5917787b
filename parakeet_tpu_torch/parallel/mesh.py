"""Device mesh and parameter sharding (port of parakeet_tpu/parallel/mesh.py).

A `Mesh` names the axes of a grid of torch.distributed ranks, one device
each: ('data', 'model'), ('data', 'seq', 'model') with sequence
parallelism, or ('data', 'pipe') with pipeline parallelism, in the
reference's order (row-major over the ranks, as the reference reshapes its
device list). Each axis has a process group (`Mesh.axis`). The reference's
mesh is a layout that XLA's partitioner reads and fills with collectives;
here every collective is explicit (parallel/collectives.py) and every rank
runs the same program on the same inputs (SPMD).

The tensor-parallel rules are the reference's, as (regex, split dim) pairs
over the converter-schema names: the FFN intermediate, the attention
heads, the conv module's pointwise_conv1 channels and the vocab rows of the
joint, CTC and prediction heads. `shard_params` returns this rank's shard
of each parameter, the data the reference's `shard_params(...)[k]` holds on
the device at this rank's mesh coordinate: odd vocabularies padded first
(`pad_vocab_dim`), a dimension that does not divide replicated with a
warning.
"""

from __future__ import annotations

import os
import re
import warnings
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from parakeet_tpu_torch.device import rank_device

@dataclass(frozen=True)
class AxisGroup:
    """One mesh axis as this rank sees it: its process group (None for an
    axis the mesh does not have), its size, this rank's index along it and
    the backend of the group."""

    group: object
    size: int
    index: int
    backend: str = "gloo"

    @classmethod
    def single(cls) -> "AxisGroup":
        return cls(None, 1, 0)

    @property
    def split(self) -> bool:
        return self.size > 1


class Mesh:
    """A grid of ranks with named axes over
    `torch.distributed.device_mesh.init_device_mesh`. `shape` maps axis
    name to size in axis order, as the reference's `mesh.shape`; `device`
    is this rank's device and `backend` the process groups' backend."""

    def __init__(self, device_mesh, device: torch.device, backend: str):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = dict(zip(self.axis_names, device_mesh.mesh.shape))
        self.device = device
        self.backend = backend
        coord = device_mesh.get_coordinate()
        self._axes = {
            name: AxisGroup(device_mesh.get_group(name), self.shape[name], int(coord[i]), backend)
            for i, name in enumerate(self.axis_names)
        }

    def axis(self, name: str) -> AxisGroup:
        """The named axis; an axis the mesh does not have is one rank wide."""
        return self._axes.get(name) or AxisGroup.single()

    def coordinate(self) -> dict[str, int]:
        return {name: a.index for name, a in self._axes.items()}

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device}, backend={self.backend!r})"


def mesh_device(mesh, device) -> torch.device:
    """The device a facade built on `mesh` runs on, this rank's: TypeError
    for anything but a `Mesh`, ValueError when `device` names another kind
    of device than the mesh's."""
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parakeet_tpu_torch.parallel.Mesh (make_mesh), got {type(mesh).__name__}")
    if torch.device(device).type != mesh.device.type:
        raise ValueError(f"device={str(device)!r} but the mesh runs on {mesh.device}")
    return mesh.device


def global_rank() -> int:
    """This process's rank in the default process group, 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def _local_world(world: int) -> int:
    return int(os.environ.get("LOCAL_WORLD_SIZE", world))


def make_mesh(
    n_devices: int | None = None,
    model_parallel: int = 1,
    devices=None,
    seq_parallel: int = 1,
    pipeline_parallel: int = 1,
    *,
    backend: str | None = None,
) -> Mesh:
    """Create a ('data', 'model') mesh over the ranks of the default process
    group, one device a rank.

    seq_parallel > 1 adds a 'seq' axis, ('data', 'seq', 'model'), model
    innermost; pipeline_parallel > 1 builds ('data', 'pipe') instead and
    composes with data parallelism only (the reference's rules and errors).

    devices: this rank's device, None for the card (`device.rank_device`:
    cuda:local_rank % device_count) or "cpu". n_devices: the ranks the mesh
    spans, all of them (a mesh spans every rank of the group). backend:
    "nccl" when each rank owns a card, "gloo" on the CPU (the defaults);
    gloo on CUDA tensors stages each collective through host memory.
    NCCL refuses two ranks on one card, so more ranks than cards raise
    unless backend="gloo" is named. Without an initialised default group
    the group is initialised here from the environment (env://: RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT, as torchrun sets them)."""
    device = rank_device("cuda" if devices is None else devices)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("backend 'nccl' needs CUDA devices; use backend='gloo' on the CPU")
    if dist.is_initialized():
        world = dist.get_world_size()
        if dist.get_backend() != backend:
            raise ValueError(f"the default process group runs {dist.get_backend()!r}, the mesh asks for {backend!r}")
    else:
        world = int(os.environ.get("WORLD_SIZE", "1"))
    if backend == "nccl" and _local_world(world) > torch.cuda.device_count():
        raise ValueError(
            f"{_local_world(world)} ranks on {torch.cuda.device_count()} card(s): NCCL refuses two ranks on "
            "one device; pass backend='gloo' to share a card (its CUDA collectives stage through host memory)"
        )
    if device.type == "cuda":  # before any communicator: NCCL binds to the current device
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
        world = dist.get_world_size()
    if n_devices is None:
        n_devices = world
    if n_devices > world:
        raise ValueError(f"requested {n_devices} devices but only {world} available")
    if n_devices < world:
        raise ValueError(f"a mesh spans every rank: {n_devices} devices of a world of {world}")
    if pipeline_parallel > 1:
        if model_parallel > 1 or seq_parallel > 1:
            raise ValueError("pipeline_parallel composes with data parallelism only")
        if n_devices % pipeline_parallel:
            raise ValueError(f"{n_devices} devices not divisible by pipeline_parallel={pipeline_parallel}")
        shape, names = (n_devices // pipeline_parallel, pipeline_parallel), ("data", "pipe")
    else:
        if n_devices % (model_parallel * seq_parallel) != 0:
            raise ValueError(
                f"{n_devices} devices not divisible by model_parallel={model_parallel}"
                f" × seq_parallel={seq_parallel}"
            )
        if seq_parallel > 1:
            shape = (n_devices // (model_parallel * seq_parallel), seq_parallel, model_parallel)
            names = ("data", "seq", "model")
        else:
            shape, names = (n_devices // model_parallel, model_parallel), ("data", "model")
    from torch.distributed.device_mesh import init_device_mesh

    # the mesh's device type only matters to DTensor, which the port does
    # not use; gloo groups are made for the CPU device type
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu", shape, mesh_dim_names=names)
    return Mesh(dm, device, backend)


# Tensor-parallel partition rules over the converter-schema key names:
# (regex, the dim split over 'model'); first match wins, default replicated.
_TP_RULES: list[tuple[str, int]] = [
    # Macaron FFN: split the intermediate dim
    (r"\.ffn[12]_\.fc1_\.weight$", 0),
    (r"\.ffn[12]_\.fc1_\.bias$", 0),
    (r"\.ffn[12]_\.fc2_\.weight$", 1),
    # Attention: split heads (rows of q/k/v, cols of out)
    (r"\.mha_\.[qkv]_proj\.weight$", 0),
    (r"\.mha_\.[qkv]_proj\.bias$", 0),
    (r"\.mha_\.out_proj\.weight$", 1),
    (r"\.pos_proj_\.weight$", 0),
    # Conv module pointwise convs: split channels
    (r"\.pointwise_conv1_\.weight$", 0),
    (r"\.pointwise_conv1_\.bias$", 0),
    # Sortformer transformer FFN
    (r"\.fc1_\.weight$", 0),
    (r"\.fc1_\.bias$", 0),
    (r"\.fc2_\.weight$", 1),
    # Joint / CTC heads: split the vocab rows
    (r"(label_proj_|out_proj_)\.weight$", 0),
    (r"(label_proj_|out_proj_)\.bias$", 0),
    (r"ctc_decoder_\.proj_\.weight$", 0),
    (r"ctc_decoder_\.proj_\.bias$", 0),
    # Prediction net embedding: split vocab rows
    (r"prediction_\.embed_\.weight$", 0),
]

# Vocab-dimension rules where padding to the next multiple of
# model_parallel preserves the semantics: appended weight rows are zero and
# appended bias lanes -1e9, so the extra logit lanes carry probability
# exp(-1e9) = 0 (log_softmax, argmax, top-k and the losses unchanged), and
# blank stays at vocab_size - 1 (the padding comes after it).
_VOCAB_PAD_PATTERN = re.compile(
    r"((label_proj_|out_proj_)\.(weight|bias)$"
    r"|ctc_decoder_\.proj_\.(weight|bias)$"
    r"|prediction_\.embed_\.weight$)"
)

#: logit value of padded vocab lanes: exp(pad - max) is exactly 0 in f32
#: and bf16, and the value stays finite
_PAD_BIAS = -1e9


def _model_size(mesh) -> int:
    return 1 if mesh is None else mesh.shape.get("model", 1)


def pad_vocab_dim(key: str, v, tp: int):
    """Pad the vocab ('model'-split) dim of an eligible parameter to divide
    tp (numpy or torch in, the same kind out). None when not eligible or
    not needed."""
    if tp <= 1 or not _VOCAB_PAD_PATTERN.search(key):
        return None
    vocab = v.shape[0]
    pad = (-vocab) % tp
    if pad == 0:
        return None
    fill = _PAD_BIAS if key.endswith(".bias") else 0.0
    if isinstance(v, torch.Tensor):
        return torch.cat([v, torch.full((pad, *v.shape[1:]), fill, dtype=v.dtype, device=v.device)])
    v = np.asarray(v)
    return np.pad(v, [(0, pad)] + [(0, 0)] * (v.ndim - 1), constant_values=fill)


def unpad_vocab_params(params: dict, vocab_size: int, ctc_vocab_size: int | None = None) -> dict:
    """Slice vocab-padded parameters back to the schema sizes (to export a
    reference-schema checkpoint)."""
    out = {}
    for k, v in params.items():
        if _VOCAB_PAD_PATTERN.search(k):
            size = ctc_vocab_size if (ctc_vocab_size and k.startswith("ctc_decoder_")) else vocab_size
            out[k] = v[:size]
        else:
            out[k] = v
    return out


def param_sharding_rules(key: str, mesh) -> int | None:
    """The dim of parameter `key` split over 'model' on `mesh`, or None
    (replicated): no rule hits, or the mesh has no 'model' axis > 1."""
    if _model_size(mesh) > 1:
        for pattern, dim in _TP_RULES:
            if re.search(pattern, key):
                return dim
    return None


def shard_params(params: dict, mesh, pad_vocab: bool = True) -> dict:
    """This rank's shard of a flat parameter dict (numpy arrays or tensors;
    the same kind back): the slice of each 'model'-split parameter at this
    rank's 'model' index, every other parameter whole.

    pad_vocab: vocab-dim parameters whose leading dim does not divide
    model_parallel are first padded (`pad_vocab_dim`), so the odd flagship
    vocabularies (1025, 8193) shard. Any other rule whose dim does not
    divide replicates, with a warning (as in the reference)."""
    tp = _model_size(mesh)
    index = mesh.axis("model").index if tp > 1 else 0
    out = {}
    for k, v in params.items():
        if pad_vocab:
            padded = pad_vocab_dim(k, v, tp)
            if padded is not None:
                v = padded
        dim = param_sharding_rules(k, mesh)
        if dim is not None and v.shape[dim] % tp != 0:
            spec = tuple("model" if i == dim else None for i in range(v.ndim))
            warnings.warn(
                f"TP rule for {k!r} (PartitionSpec{spec!r}) skipped: shape {tuple(v.shape)} "
                f"does not divide model_parallel={tp}; replicating",
                stacklevel=2,
            )
            dim = None
        if dim is not None:
            n = v.shape[dim] // tp
            v = v[(slice(None),) * dim + (slice(index * n, (index + 1) * n),)]
        out[k] = v
    return out


def batch_sharding(mesh, batch: int) -> slice:
    """This rank's rows of a batch-leading array sharded over 'data'
    (`batch` must divide the 'data' axis)."""
    data = mesh.axis("data")
    if batch % data.size:
        raise ValueError(f"batch {batch} does not divide the mesh's data axis ({data.size})")
    n = batch // data.size
    return slice(data.index * n, (data.index + 1) * n)


def activation_sharding(mesh) -> AxisGroup | None:
    """The 'seq' axis that splits the encoder's (B, T, D) activations over
    time, or None when the mesh has no 'seq' axis > 1 (callers then run
    the encoder unsplit in time)."""
    if mesh is not None and mesh.shape.get("seq", 1) > 1:
        return mesh.axis("seq")
    return None


__all__ = [
    "AxisGroup",
    "Mesh",
    "make_mesh",
    "mesh_device",
    "global_rank",
    "pad_vocab_dim",
    "unpad_vocab_params",
    "param_sharding_rules",
    "shard_params",
    "batch_sharding",
    "activation_sharding",
]
