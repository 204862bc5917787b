"""The collectives that XLA's partitioner inserts for the reference's mesh,
written out over torch.distributed (no counterpart in parakeet_tpu), each
with its backward.

Each takes the `AxisGroup` of the mesh axis it runs over
(parallel/mesh.py); over an axis one rank wide it communicates nothing and
returns its input's value. Over gloo, CUDA tensors go through host memory:
copied to the CPU, reduced or gathered there, copied back (`_staged`). A
collective that fails raises; nothing falls back.

Every rank of a 'model', 'seq' or 'pipe' group ends a training step with
the same loss, so a gradient that reaches a collective is the same on each
of them where the value after it is replicated, and differs where it is
not. The backward of each collective follows from that (the Megatron f/g
pair over 'model'):

  * `copy_to_model`: identity forward; backward, the gradient summed over
    'model'. It sits at the input of every column-parallel linear and of
    K1 head-sharded: each rank's gradient of that replicated input holds
    only its own columns' or heads' share;
  * `reduce_from_model`: the sum over 'model' forward; backward, the
    identity. The row-parallel linear (ops/layers.py `linear(...,
    row_group=)`: the f32 products of this rank's input columns and weight
    columns summed, then the bias, rounded once) and K1 head-sharded's
    partial out-projection: the sum is replicated, so each rank's gradient
    of it is already the gradient of its own partial;
  * `gather_dim` with backward "slice": the blocks of a tensor split over
    an axis, concatenated in axis order, where the loss after it is
    replicated over that axis (vocab-split logits over 'model', the pw1
    channels before the GLU, the encoder output over 'seq'): the backward
    takes this rank's block of the (replicated) gradient;
  * `gather_dim` with backward "reduce_scatter": the K/V frames over
    'seq' inside attention, where each rank's queries read every rank's
    keys: the backward sums every rank's gradient of the gathered frames
    and keeps this rank's block;
  * `parallel_embedding`: the lookup in this rank's vocab rows, zero for
    ids outside them, summed over 'model' (exact: one rank is nonzero);
    its backward reaches this rank's rows only;
  * `halo_exchange`: each 'seq' rank's block of frames widened by its
    neighbours' edge frames (zeros past the ends), for the depthwise conv;
    its adjoint sends each halo's gradient back to the rank it came from,
    which adds it to its edge frames;
  * `mean_over` / `sum_over`: gradients (no autograd) averaged over 'data'
    or summed over an axis, flattened into one buffer per dtype;
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
    """The sum of x over the axis (every rank gets the same values); no
    gradient (`reduce_from_model` is the differentiable form)."""
    if not axis.split:
        return x
    y = _staged(axis, x).clone()
    dist.all_reduce(y, group=axis.group)
    return y.to(x.device)


def _all_gather(x: torch.Tensor, axis: AxisGroup, dim: int) -> torch.Tensor:
    y = _staged(axis, x)
    parts = [torch.empty_like(y) for _ in range(axis.size)]
    dist.all_gather(parts, y, group=axis.group)
    return torch.cat(parts, dim=dim).to(x.device)


def _reduce_scatter(g: torch.Tensor, axis: AxisGroup, dim: int) -> torch.Tensor:
    """The sum over the axis of g (every rank's blocks along `dim`), this
    rank's block of it."""
    y = _staged(axis, g)
    parts = [p.contiguous() for p in torch.chunk(y, axis.size, dim=dim)]
    out = torch.empty_like(parts[axis.index])
    dist.reduce_scatter(out, parts, group=axis.group)
    return out.to(g.device)


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum(g, ctx.axis), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce_sum(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, backward):
        ctx.axis, ctx.dim, ctx.backward = axis, dim % x.ndim, backward
        return _all_gather(x, axis, ctx.dim)

    @staticmethod
    def backward(ctx, g):
        axis, dim = ctx.axis, ctx.dim
        if ctx.backward == "reduce_scatter":
            return _reduce_scatter(g, axis, dim), None, None, None
        n = g.shape[dim] // axis.size
        return g.narrow(dim, axis.index * n, n), None, None, None


def copy_to_model(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """x unchanged; its gradient summed over the axis. The input of a
    column-parallel linear, of K1 head-sharded, and any replicated weight
    that enters a rank's share of a split computation (the attention's
    LayerNorm and position biases)."""
    return _CopyTo.apply(x, axis) if axis.split else x


def reduce_from_model(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """The sum of x over the axis; its gradient passes unchanged to each
    rank's x (row-parallel partial products, K1 head-sharded's partials)."""
    return _ReduceFrom.apply(x, axis) if axis.split else x


def gather_dim(x: torch.Tensor, axis: AxisGroup, dim: int, backward: str = "slice") -> torch.Tensor:
    """The axis's blocks of x (equal shapes) concatenated along `dim` in
    axis order. backward "slice": the loss after the gather is replicated
    over the axis, so this rank's gradient is its block of the gathered
    gradient; "reduce_scatter": it is not (the K/V frames over 'seq'), so
    every rank's gradients of the whole are summed and this rank keeps its
    block."""
    if not axis.split:
        return x
    if backward not in ("slice", "reduce_scatter"):
        raise ValueError(f"gather_dim backward must be 'slice' or 'reduce_scatter', got {backward!r}")
    return _Gather.apply(x, axis, dim, backward)


def gather_last(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """Vocab-split logits (..., V/P) → (..., V) over 'model'."""
    return gather_dim(x, axis, -1)


def parallel_embedding(weight: torch.Tensor, ids: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """Rows `ids` of an embedding whose vocab rows are split over `axis`:
    this rank holds rows [index·n, (index+1)·n). Exact: the sum over the
    axis adds zeros to the one rank's row. The gradient reaches this
    rank's rows only."""
    if not axis.split:
        return weight[ids]
    n = weight.shape[0]
    local = ids - axis.index * n
    mine = (local >= 0) & (local < n)
    rows = weight[local.clamp(0, n - 1)]
    rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=rows.dtype, device=rows.device))
    return reduce_from_model(rows, axis)


def _exchange(x: torch.Tensor, axis: AxisGroup, halo: int, dim: int) -> torch.Tensor:
    """Each rank's first and last `halo` frames of x along dim, from every
    rank: (P, ..., 2·halo, ...)."""
    edges = torch.cat([x.narrow(dim, 0, halo), x.narrow(dim, x.shape[dim] - halo, halo)], dim=dim)
    return _all_gather(edges.unsqueeze(0), axis, 0)


class _Halo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, halo, dim):
        ctx.axis, ctx.halo, ctx.dim = axis, halo, dim
        every = _exchange(x, axis, halo, dim)
        zeros = torch.zeros_like(x.narrow(dim, 0, halo))
        before = every[axis.index - 1].narrow(dim, halo, halo) if axis.index > 0 else zeros
        after = every[axis.index + 1].narrow(dim, 0, halo) if axis.index + 1 < axis.size else zeros
        return torch.cat([before, x, after], dim=dim)

    @staticmethod
    def backward(ctx, g):
        axis, halo, dim = ctx.axis, ctx.halo, ctx.dim
        n = g.shape[dim] - 2 * halo
        # this rank's halos' gradients go back to the neighbours they came
        # from: the one before gets `before`'s on its last frames, the one
        # after gets `after`'s on its first
        every = _exchange(g, axis, halo, dim)  # [before's grad, after's grad] of each rank
        gx = g.narrow(dim, halo, n).clone()
        if axis.index > 0:  # the previous rank's `after` was our first frames
            gx.narrow(dim, 0, halo).add_(every[axis.index - 1].narrow(dim, halo, halo))
        if axis.index + 1 < axis.size:  # the next rank's `before` was our last frames
            gx.narrow(dim, n - halo, halo).add_(every[axis.index + 1].narrow(dim, 0, halo))
        return gx, None, None, None


def halo_exchange(x: torch.Tensor, axis: AxisGroup, halo: int, dim: int = -1) -> torch.Tensor:
    """x (this rank's block of frames along `dim`) with `halo` frames of the
    previous rank's block before it and of the next rank's after it; zeros
    at the first and last rank, as a zero-padded convolution sees them."""
    dim = dim % x.ndim
    if not axis.split:
        pad = [0, 0] * (x.ndim - 1 - dim) + [halo, halo]
        return torch.nn.functional.pad(x, pad)
    return _Halo.apply(x, axis, halo, dim)


def _flat_all_reduce(tensors: list[torch.Tensor], axis: AxisGroup) -> list[torch.Tensor]:
    """The sums over the axis of a list of tensors, in one all-reduce per
    dtype (a flattened buffer)."""
    out = list(tensors)
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = all_reduce_sum(torch.cat([tensors[i].reshape(-1) for i in idx]), axis)
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view_as(tensors[i])
            off += n
    return out


def sum_over(grads: dict, keys, axis: AxisGroup) -> dict:
    """`grads` with the entries `keys` summed over the axis (no gradient)."""
    keys = [k for k in keys if k in grads]
    if not axis.split or not keys:
        return grads
    return {**grads, **dict(zip(keys, _flat_all_reduce([grads[k] for k in keys], axis)))}


def mean_over(grads: dict, axis: AxisGroup) -> dict:
    """Every entry of `grads` averaged over the axis (the 'data' ranks'
    gradients of their local mean losses; no gradient)."""
    if not axis.split:
        return grads
    keys = list(grads)
    return {k: v / axis.size for k, v in zip(keys, _flat_all_reduce([grads[k] for k in keys], axis))}


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
    "copy_to_model",
    "reduce_from_model",
    "sum_over",
    "mean_over",
    "gather_dim",
    "gather_last",
    "parallel_embedding",
    "halo_exchange",
    "gather_results",
    "gather_params",
]
