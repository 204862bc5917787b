"""Pipeline parallelism (GPipe) over the conformer stack (port of
parakeet_tpu/parallel/pipeline.py).

The encoder's conformer blocks are split over a 'pipe' mesh axis: each
rank holds ``num_layers / P`` blocks' weights, and microbatches stream
through the stages. The schedule is GPipe's fill-drain: ``n_micro + P - 1``
steps, stage *s* working on microbatch ``t - s`` at step *t*; after each
step every stage hands its activation to the next by point-to-point
send/recv (`batch_isend_irecv`, posted together so two ranks sharing a
card never wait on each other's order; through host memory over gloo).
The last stage's outputs go to every 'pipe' rank, so the heads see a
replicated encoding, as the reference's psum gives them.

Differentiation is written out, as XLA derives it from the reference's
scan: the forward keeps only each microbatch's stage input (the
reference's jax.checkpoint around each stage, torch.utils.checkpoint's
rule), and the backward runs the schedule in reverse, recomputing each
stage's microbatch under grad mode and handing the input's gradient to
the previous stage. The gradient of the replicated encoding is taken from
the last stage only: every 'pipe' rank computes the same loss from it, so
summing the ranks' gradients would count it P times. The first stage's
input gradient goes to every 'pipe' rank, whose subsampling (run on each
of them) then gets the whole gradient. K1 runs in each block of a stage
(its Function under grad mode), so a step launches it twice a block and
microbatch.

Parameter layout: the flat schema dict's per-layer keys
(``encoder_.layers_.{i}.{suffix}``) are stacked into ``(L, …)`` arrays
keyed by suffix (`split_layer_params`), of which a rank holds its stage's
``L / P`` rows; everything else stays flat and whole on every rank.
`merge_layer_params` restores the exact schema for checkpoint export.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from parakeet_tpu_torch.models.encoder import FusedLayers, conformer_block, encode_prologue, encoded_lengths
from parakeet_tpu_torch.parallel.collectives import _staged
from parakeet_tpu_torch.params import Params

LAYER_PREFIX = "encoder_.layers_."


def split_layer_params(params: dict, num_layers: int) -> tuple[dict, dict]:
    """Flat schema dict → (stacked {suffix: (L, …)}, rest flat dict);
    numpy arrays or tensors, the same kind back."""
    per_layer: list[dict] = [{} for _ in range(num_layers)]
    rest: dict = {}
    for k, v in params.items():
        if k.startswith(LAYER_PREFIX):
            idx, suffix = k[len(LAYER_PREFIX):].split(".", 1)
            per_layer[int(idx)][suffix] = v
        else:
            rest[k] = v
    if not all(per_layer[0].keys() == layer.keys() for layer in per_layer):
        raise ValueError("conformer layers are not schema-uniform; cannot stack")

    def stack(vs):
        return torch.stack(vs) if isinstance(vs[0], torch.Tensor) else np.stack([np.asarray(v) for v in vs])

    stacked = {s: stack([per_layer[i][s] for i in range(num_layers)]) for s in sorted(per_layer[0])}
    return stacked, rest


def merge_layer_params(stacked: dict, rest: dict) -> dict:
    """Inverse of `split_layer_params`: exact schema keys restored."""
    out = dict(rest)
    for suffix, v in stacked.items():
        for i in range(v.shape[0]):
            out[f"{LAYER_PREFIX}{i}.{suffix}"] = v[i]
    return out


def _pipe_axis(mesh):
    if "pipe" not in dict(mesh.shape):
        raise ValueError("mesh has no 'pipe' axis; build one with make_mesh(pipeline_parallel=…)")
    return mesh.axis("pipe")


class _Schedule:
    """One pipeline call: the 'pipe' axis, the microbatches' masks and
    lengths, and this rank's stage of blocks."""

    def __init__(self, axis, cfg, n_micro: int, suffixes, pad_mask, lengths):
        self.axis, self.cfg, self.n_micro, self.suffixes = axis, cfg, n_micro, suffixes
        self.masks = pad_mask.chunk(n_micro)
        self.lengths = lengths.chunk(n_micro)
        ranks = dist.get_process_group_ranks(axis.group)
        self.prev = ranks[axis.index - 1] if axis.index > 0 else None
        self.next = ranks[axis.index + 1] if axis.index + 1 < axis.size else None
        self.first, self.last = ranks[0], ranks[-1]

    def stage(self, x, m: int, weights) -> torch.Tensor:
        for j in range(weights[0].shape[0]):
            p = Params({s: w[j] for s, w in zip(self.suffixes, weights)})
            x = conformer_block(p, x, None, self.cfg, None, self.masks[m], self.lengths[m], fused=FusedLayers())
        return x

    def hand_over(self, send: torch.Tensor | None, to, recv_like: torch.Tensor | None, frm):
        """Send `send` to rank `to` and receive a tensor like `recv_like`
        from rank `frm`, posted together; the received tensor (or None)."""
        ops, buf = [], None
        if send is not None:
            ops.append(dist.P2POp(dist.isend, _staged(self.axis, send), to, group=self.axis.group))
        if recv_like is not None:
            buf = torch.empty_like(_staged(self.axis, recv_like))
            ops.append(dist.P2POp(dist.irecv, buf, frm, group=self.axis.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return None if buf is None else buf.to(recv_like.device)

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        y = _staged(self.axis, x).clone()
        dist.broadcast(y, src=src, group=self.axis.group)
        return y.to(x.device)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sched: _Schedule, x, *weights):
        p, s, n = sched.axis.size, sched.axis.index, sched.n_micro
        xm = x.chunk(n)
        inputs, outs, buf = [None] * n, [None] * n, None
        for t in range(n + p - 1):
            m, out = t - s, None
            if 0 <= m < n:
                inputs[m] = xm[m] if s == 0 else buf
                out = sched.stage(inputs[m], m, weights)
                if s == p - 1:
                    outs[m] = out
            # stage s hands microbatch t − s on; it takes t + 1 − s from s − 1
            takes = s > 0 and 0 <= t + 1 - s < n
            buf = sched.hand_over(out if s < p - 1 else None, sched.next, xm[0] if takes else None, sched.prev)
        y = torch.cat(outs) if s == p - 1 else torch.empty_like(x)
        ctx.sched, ctx.inputs = sched, inputs
        ctx.save_for_backward(*weights)
        return sched.broadcast(y, sched.last)

    @staticmethod
    def backward(ctx, grad):
        sched, inputs = ctx.sched, ctx.inputs
        weights = ctx.saved_tensors
        p, s, n = sched.axis.size, sched.axis.index, sched.n_micro
        gm = grad.chunk(n)  # the last stage's own: every rank's loss is the same
        wgrads = [torch.zeros_like(w) for w in weights]
        gin, buf = [None] * n, None
        for t in range(n + p - 1):
            m, gsend = t - (p - 1 - s), None
            if 0 <= m < n:
                gy = gm[m] if s == p - 1 else buf
                inp = inputs[m].detach().requires_grad_()
                ws = [w.detach().requires_grad_() for w in weights]
                with torch.enable_grad():
                    out = sched.stage(inp, m, ws)
                    g = torch.autograd.grad(out, [inp, *ws], gy, allow_unused=True, materialize_grads=True)
                for acc, gw in zip(wgrads, g[1:]):
                    acc.add_(gw)
                if s == 0:
                    gin[m] = g[0]
                else:
                    gsend = g[0]
            # stage s hands its input's gradient back; it takes the next one from s + 1
            takes = s < p - 1 and 0 <= t + 1 - (p - 1 - s) < n
            buf = sched.hand_over(gsend, sched.prev, gm[0] if takes else None, sched.next)
        gx = torch.cat(gin) if s == 0 else torch.empty_like(grad)
        return (None, sched.broadcast(gx, sched.first), *wgrads)


def pipeline_encode(stacked: dict, rest: dict, enc_cfg, features: torch.Tensor, mel_lengths, *, mesh,
                    n_micro: int) -> torch.Tensor:
    """(B, T, mel) → (B, T', D) with the conformer stack pipelined over the
    mesh's 'pipe' axis: `stacked` holds this rank's stage ({suffix: (L/P,
    …)}), `rest` the flat non-layer weights. Numerically the dense
    `fastconformer_encode` (the same blocks in the same order;
    microbatching is per-example exact), on every 'pipe' rank. The local
    batch (this 'data' rank's rows) must divide into `n_micro`."""
    axis = _pipe_axis(mesh)
    if enc_cfg.num_layers % axis.size:
        raise ValueError(f"{enc_cfg.num_layers} layers not divisible by pipe={axis.size}")
    mel_lengths = torch.as_tensor(mel_lengths, device=features.device)
    x, pad_mask, lengths = encode_prologue(Params(rest).sub("encoder_"), enc_cfg, features, mel_lengths)
    blocal = x.shape[0]
    if blocal % n_micro:
        raise ValueError(f"local batch {blocal} not divisible by n_micro={n_micro}")
    suffixes = sorted(stacked)
    sched = _Schedule(axis, enc_cfg, n_micro, suffixes, pad_mask, lengths)
    return _GPipe.apply(sched, x, *(stacked[k] for k in suffixes))


def make_pp_trainer(
    cfg,
    params: dict,
    mesh,
    *,
    n_micro: int = 2,
    learning_rate: float = 1e-4,
    loss: str = "hybrid",
    sigma: float = 0.0,
    ctc_weight: float = 0.3,
    schedule: str = "constant",
    warmup_steps: int = 0,
    decay_steps: int | None = None,
    clip_norm: float | None = None,
):
    """Pipeline-parallel trainer over a ('data', 'pipe') mesh, on the
    mesh's device.

    Returns (state, step, place_batch, export_params): `state.params` is
    {'layers': this rank's stage of the stacked layers, 'rest': the flat
    rest, whole}, its optimizer state optax's over that nesting (so
    checkpoints cross packages); `export_params(state.params)` gathers the
    stages and restores the reference checkpoint schema (a collective).
    The loss and the gradients are the plain `make_sharded_trainer`'s; the
    loss each step returns is the global mean over 'data'."""
    from parakeet_tpu_torch.parallel.mesh import batch_sharding
    from parakeet_tpu_torch.train import (
        MeshLayout,
        TrainState,
        adamw,
        encoded_loss_fn,
        make_lr_schedule,
        mesh_step,
        value_and_grad_accum,
    )

    axes = dict(mesh.shape)
    if axes.get("model", 1) > 1 or axes.get("seq", 1) > 1:
        raise ValueError(
            "pipeline trainer composes with data parallelism only "
            f"(mesh axes {axes}); use make_mesh(pipeline_parallel=…)"
        )
    axis = _pipe_axis(mesh)
    num_layers = cfg.encoder.num_layers
    if num_layers % axis.size:
        raise ValueError(f"{num_layers} layers not divisible by pipe={axis.size}")
    host = {k: (v.detach() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v)))
            for k, v in params.items()}
    stacked, rest = split_layer_params(host, num_layers)
    layout = MeshLayout(mesh, {("layers", k): ("pipe", 0) for k in stacked})
    dev = mesh.device
    train_params = {
        "layers": {k: layout.shard(("layers", k), v).to(device=dev, dtype=torch.float32, copy=True)
                   for k, v in stacked.items()},
        "rest": {k: v.to(device=dev, dtype=torch.float32, copy=True) for k, v in rest.items()},
    }
    optimizer = adamw(make_lr_schedule(learning_rate, schedule=schedule, warmup_steps=warmup_steps,
                                       decay_steps=decay_steps), clip_norm=clip_norm)
    opt_state = optimizer.init(train_params)
    opt_state.layout = layout

    def loss_fn(tp, batch):
        enc = pipeline_encode(tp["layers"], tp["rest"], cfg.encoder, batch["features"], batch["mel_lengths"],
                              mesh=mesh, n_micro=n_micro)
        enc_lens = torch.clamp(encoded_lengths(batch["mel_lengths"].long()), max=enc.shape[1])
        return encoded_loss_fn(tp["rest"], cfg, enc, enc_lens, batch, loss=loss, sigma=sigma, ctc_weight=ctc_weight)

    # each stage's layers are its own and the rest is replicated over 'pipe' (the first stage's input
    # gradient goes to every stage): only 'data' reduces
    step = mesh_step(value_and_grad_accum(loss_fn), optimizer, mesh)

    def place_batch(batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            v = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
            out[k] = v[batch_sharding(mesh, v.shape[0])].to(dev)
        return out

    def export_params(tp) -> dict:
        whole = layout.gather({("layers", k): v for k, v in tp["layers"].items()})
        return merge_layer_params({k: v.cpu().numpy() for (_, k), v in whole.items()},
                                  {k: v.detach().cpu().numpy() for k, v in tp["rest"].items()})

    return TrainState(train_params, opt_state), step, place_batch, export_params


__all__ = [
    "LAYER_PREFIX",
    "split_layer_params",
    "merge_layer_params",
    "pipeline_encode",
    "make_pp_trainer",
]
