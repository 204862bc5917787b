"""The collectives that XLA's partitioner inserts for the reference's mesh,
written out over torch.distributed (no counterpart in parakeet_tpu).

Each takes the `AxisGroup` of the mesh axis it runs over
(parallel/mesh.py); over an axis one rank wide it communicates nothing and
returns its input's value. Over gloo, CUDA tensors go through host memory:
copied to the CPU, reduced or gathered there, copied back.

  * row-parallel linear: the product of this rank's input columns and
    weight columns in f32, summed over 'model', then the bias, rounded
    once (ops/layers.py `linear(..., row_group=)`); a column-parallel
    linear is `linear` on the local weight rows and needs none;
  * `gather_last` / `gather_dim`: the blocks of a tensor split over an
    axis, concatenated in axis order (vocab-split logits over 'model', the
    pw1 channels before the GLU, K/V inputs and the encoder output over
    'seq');
  * `parallel_embedding`: the lookup in this rank's vocab rows, zero for
    ids outside them, summed over 'model' (exact: one rank is nonzero);
  * `halo_exchange`: each 'seq' rank's block of frames widened by its
    neighbours' edge frames (zeros past the ends), for the depthwise conv;
  * `gather_results`: Python objects over 'data' (`all_gather_object`).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from parakeet_tpu_torch.parallel.mesh import AxisGroup


def _staged(axis: AxisGroup, x: torch.Tensor) -> torch.Tensor:
    """x where the axis's backend can reduce it: on the CPU for gloo."""
    x = x.contiguous()
    return x.cpu() if axis.backend == "gloo" and x.is_cuda else x


def all_reduce_sum(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """The sum of x over the axis (every rank gets the same values)."""
    if not axis.split:
        return x
    y = _staged(axis, x).clone()
    dist.all_reduce(y, group=axis.group)
    return y.to(x.device)


def gather_dim(x: torch.Tensor, axis: AxisGroup, dim: int) -> torch.Tensor:
    """The axis's blocks of x (equal shapes) concatenated along `dim` in
    axis order."""
    if not axis.split:
        return x
    y = _staged(axis, x)
    parts = [torch.empty_like(y) for _ in range(axis.size)]
    dist.all_gather(parts, y, group=axis.group)
    return torch.cat(parts, dim=dim).to(x.device)


def gather_last(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """Vocab-split logits (..., V/P) → (..., V) over 'model'."""
    return gather_dim(x, axis, -1)


def parallel_embedding(weight: torch.Tensor, ids: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """Rows `ids` of an embedding whose vocab rows are split over `axis`:
    this rank holds rows [index·n, (index+1)·n). Exact: the sum over the
    axis adds zeros to the one rank's row."""
    if not axis.split:
        return weight[ids]
    n = weight.shape[0]
    local = ids - axis.index * n
    mine = (local >= 0) & (local < n)
    rows = weight[local.clamp(0, n - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    return all_reduce_sum(rows, axis)


def halo_exchange(x: torch.Tensor, axis: AxisGroup, halo: int, dim: int = -1) -> torch.Tensor:
    """x (this rank's block of frames along `dim`) with `halo` frames of the
    previous rank's block before it and of the next rank's after it; zeros
    at the first and last rank, as a zero-padded convolution sees them."""
    if not axis.split:
        pad = [0, 0] * (x.ndim - 1 - dim % x.ndim) + [halo, halo]
        return torch.nn.functional.pad(x, pad)
    edges = torch.cat([x.narrow(dim, 0, halo), x.narrow(dim, x.shape[dim] - halo, halo)], dim=dim)
    every = gather_dim(edges.unsqueeze(0), axis, 0)  # (P, ..., 2·halo, ...)
    zeros = torch.zeros_like(x.narrow(dim, 0, halo))
    before = every[axis.index - 1].narrow(dim, halo, halo) if axis.index > 0 else zeros
    after = every[axis.index + 1].narrow(dim, 0, halo) if axis.index + 1 < axis.size else zeros
    return torch.cat([before, x, after], dim=dim)


def gather_results(items: list, axis: AxisGroup, device: torch.device | None = None) -> list:
    """Every rank's list of Python objects over the axis, concatenated in
    axis order. Runs the collective even over an axis one rank wide, so a
    one-rank mesh still drives its backend. NCCL moves the pickles through
    `device`, the rank's card."""
    if axis.group is None:
        return list(items)
    out = [None] * axis.size
    if device is not None and device.type == "cuda":
        with torch.cuda.device(device):
            dist.all_gather_object(out, items, group=axis.group)
    else:
        dist.all_gather_object(out, items, group=axis.group)
    return [x for part in out for x in part]


def gather_params(local: dict, mesh, keys) -> dict:
    """Whole parameters `keys` from this rank's shards (`shard_params`, every
    rule's dim dividing the axis): each 'model'-split parameter gathered
    over 'model' along its split dim, every other one as it is. Runs once,
    when a facade on a model > 1 mesh is built, for the kernels that take
    whole weights."""
    from parakeet_tpu_torch.parallel.mesh import param_sharding_rules

    axis = mesh.axis("model")
    out = {}
    for k in keys:
        v = local[k]
        dim = param_sharding_rules(k, mesh)
        out[k] = v if dim is None or not axis.split else gather_dim(v, axis, dim)
    return out


__all__ = [
    "all_reduce_sum",
    "gather_dim",
    "gather_last",
    "parallel_embedding",
    "halo_exchange",
    "gather_results",
    "gather_params",
]
