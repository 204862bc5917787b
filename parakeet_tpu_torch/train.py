"""Training steps (port of parakeet_tpu/train.py) on one device.

Losses, as in the reference:
- CTC: `F.ctc_loss` over the encoder + CTC head (the reference's optax
  ctc_loss, a plain XLA op there too).
- RNNT / TDT: the lattice losses of ops/transducer_loss.py over the full
  (B, T', U+1) joint. The joint runs under torch.utils.checkpoint, so
  backward recomputes the (B, T', U+1, joint_hidden) activation instead of
  keeping it (the reference's jax.checkpoint).
- hybrid: (1 − w)·TDT + w·CTC over one encoder pass (the reference calls
  the encoder twice and XLA merges the calls).
- Sortformer: Sort Loss + PIL over per-frame speaker activity.

The encoder runs `FusedLayers()`: its attention is the kernel K1 on the
card, differentiated through ops/rel_attention.py's autograd Function.
Every other kernel refuses inputs that require grad.

The optimizer is optax's adamw (or adam), written out so that one step on
the same gradients gives the same parameters and the state flattens to
optax's leaves in optax's order (checkpoint.py reads and writes both
packages' checkpoints): b1 0.9, b2 0.999, eps 1e-8, weight decay 1e-4 on
every parameter (norms and BatchNorm statistics included, which the
reference trains by gradient like any other key), the learning rate read
at the count before its increment, and optional global-norm clipping
without an epsilon.

On a mesh (`make_sharded_trainer(mesh=...)`, parallel/mesh.py) every rank
runs the same step on its shards (SPMD over torch.distributed): this
rank's rows of the batch over 'data', its shards of the weights over
'model' (the reference's rules, vocabularies padded), its block of frames
over 'seq'. The collectives the reference's partitioner inserts are
written out with their backward (parallel/collectives.py), so each rank's
gradient of a key split over 'model' is its shard of the whole gradient
and of a replicated key the whole gradient; the step then averages every
gradient over 'data' and sums over 'seq' the encoder's, whose rank saw
only its own frames. `MeshLayout` says how the state lies over the mesh:
it gathers it whole for a checkpoint and shards a loaded one.
"""

from __future__ import annotations

import itertools
import os
import warnings
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from parakeet_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from parakeet_tpu_torch.models.ctc import ctc_log_probs
from parakeet_tpu_torch.models.encoder import EncoderSplit, encoded_lengths, fastconformer_encode, subsample_length
from parakeet_tpu_torch.models.rnnt import prediction_forward, prediction_zero_state, rnnt_joint, tdt_joint
from parakeet_tpu_torch.ops.transducer_loss import rnnt_loss, tdt_loss
from parakeet_tpu_torch.params import Params, cast_params

_F32 = torch.float32


def flatten_params(params: dict) -> dict:
    """A flat {key: tensor} dict as it is; the pipeline trainer's nested
    {"layers": {...}, "rest": {...}} as {(outer, inner): tensor}, in
    optax's flatten order once sorted."""
    if any(isinstance(v, dict) for v in params.values()):
        return {(o, k): v for o, sub in params.items() for k, v in sub.items()}
    return params


def unflatten_params(flat: dict) -> dict:
    """The inverse of `flatten_params`."""
    if flat and isinstance(next(iter(flat)), tuple):
        out: dict = {}
        for (o, k), v in flat.items():
            out.setdefault(o, {})[k] = v
        return out
    return flat


# ─── Optimizer: optax's adam / adamw, leaf for leaf ─────────────────────────


@dataclass
class OptState:
    """An Adam state in optax's flattened leaf order: `count` (int32, ()),
    `mu` and `nu` (one tensor per parameter key), and `schedule_count` when
    the learning rate is a schedule. `steps` is `count` as a host int, so a
    step reads the schedule and the bias correction without waiting for the
    card; `treedef` is the note optax's checkpoints carry for this state."""

    count: torch.Tensor
    mu: dict
    nu: dict
    schedule_count: torch.Tensor | None
    steps: int
    treedef: str
    layout: "MeshLayout | None" = None

    def leaves(self) -> list[torch.Tensor]:
        out = [self.count, *(self.mu[k] for k in sorted(self.mu)), *(self.nu[k] for k in sorted(self.nu))]
        return out if self.schedule_count is None else [*out, self.schedule_count]

    def whole_shapes(self) -> list[tuple[int, ...]]:
        """The leaves' shapes as a checkpoint holds them: on a mesh, the
        whole (vocab-padded) arrays of which this rank holds shards."""
        whole = (lambda k, t: tuple(t.shape)) if self.layout is None else self.layout.whole_shape
        out = [(), *(whole(k, self.mu[k]) for k in sorted(self.mu)), *(whole(k, self.nu[k]) for k in sorted(self.nu))]
        return out if self.schedule_count is None else [*out, ()]

    def with_leaves(self, leaves) -> "OptState":
        """This structure over other leaves (arrays or tensors), on the CPU."""
        leaves = [torch.as_tensor(np.array(v)) for v in leaves]
        if len(leaves) != len(self.leaves()):
            raise ValueError(f"opt state has {len(self.leaves())} leaves, got {len(leaves)}")
        keys = sorted(self.mu)
        n = len(keys)
        return OptState(leaves[0], dict(zip(keys, leaves[1:1 + n])), dict(zip(keys, leaves[1 + n:1 + 2 * n])),
                        leaves[-1] if self.schedule_count is not None else None, int(leaves[0]), self.treedef,
                        self.layout)

    def to(self, device) -> "OptState":
        move = lambda d: {k: v.to(device) for k, v in d.items()}  # noqa: E731
        sc = None if self.schedule_count is None else self.schedule_count.to(device)
        return OptState(self.count.to(device), move(self.mu), move(self.nu), sc, self.steps, self.treedef,
                        self.layout)


def _f32(x: float) -> float:
    return float(np.float32(x))


# optax's adam defaults, and adamw's weight decay
B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 1e-4


class Adam:
    """optax.adamw(learning_rate) (or optax.adam when weight_decay is None),
    optionally chained after optax.clip_by_global_norm(clip_norm).
    `learning_rate` is a float or a schedule count → float
    (make_lr_schedule)."""

    def __init__(self, learning_rate, *, weight_decay: float | None = WEIGHT_DECAY,
                 clip_norm: float | None = None):
        self.learning_rate = learning_rate
        self.weight_decay = weight_decay
        self.clip_norm = clip_norm

    def treedef(self, keys) -> str:
        """str(treedef) of the optax state of this optimizer over a param
        dict with `keys` (optax 0.2 under jax 0.9): flat string keys, or
        (outer, inner) pairs for the pipeline trainer's nested dict."""
        keys = sorted(keys)
        if keys and isinstance(keys[0], tuple):
            outer = sorted({o for o, _ in keys})
            leaves = "{" + ", ".join(
                f"{o!r}: " + "{" + ", ".join(f"{k!r}: *" for oo, k in keys if oo == o) + "}" for o in outer) + "}"
        else:
            leaves = "{" + ", ".join(f"{k!r}: *" for k in keys) + "}"
        empty = "CustomNode(namedtuple[EmptyState], [])"
        parts = [f"CustomNode(namedtuple[ScaleByAdamState], [*, {leaves}, {leaves}])"]
        if self.weight_decay is not None:
            parts.append(empty)
        parts.append("CustomNode(namedtuple[ScaleByScheduleState], [*])" if callable(self.learning_rate) else empty)
        tree = "(" + ", ".join(parts) + ")"
        if self.clip_norm is not None:
            tree = f"({empty}, {tree})"
        return f"PyTreeDef({tree})"

    def init(self, params: dict) -> OptState:
        params = flatten_params(params)
        keys = sorted(params)
        dev = next(iter(params.values())).device
        zero = lambda: torch.zeros((), dtype=torch.int32, device=dev)  # noqa: E731
        return OptState(zero(), {k: torch.zeros_like(params[k]) for k in keys},
                        {k: torch.zeros_like(params[k]) for k in keys},
                        zero() if callable(self.learning_rate) else None, 0, self.treedef(keys))

    @torch.no_grad()
    def update(self, params: dict, grads: dict, state: OptState) -> None:
        """One step, in place on `params` and `state`, with optax's order of
        operations: clip (t / ‖g‖ · max_norm when ‖g‖ ≥ max_norm), the
        moments (1 − b)·g + b·m, the bias corrections at the incremented
        count, m̂ / (√v̂ + eps), + weight_decay · p, × −lr(count), p + u.
        On a mesh (`state.layout`) ‖g‖ is the whole gradient's norm."""
        params, grads = flatten_params(params), flatten_params(grads)
        keys = sorted(state.mu)
        g = [grads[k] for k in keys]
        p = [params[k] for k in keys]
        mu = [state.mu[k] for k in keys]
        nu = [state.nu[k] for k in keys]
        if self.clip_norm is not None:
            if state.layout is not None:
                norm = state.layout.global_norm(keys, g)
            else:
                norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
            factor = torch.where(norm < self.clip_norm, torch.ones_like(norm), self.clip_norm / norm)
            g = torch._foreach_mul(g, factor)
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, torch._foreach_mul(g, _f32(1 - B1)))
        torch._foreach_mul_(nu, B2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), _f32(1 - B2)))
        count = state.steps + 1
        bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(count))
        bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(count))
        den = torch._foreach_sqrt(torch._foreach_div(nu, bc2))
        torch._foreach_add_(den, EPS)
        upd = torch._foreach_div(torch._foreach_div(mu, bc1), den)
        if self.weight_decay is not None:
            torch._foreach_add_(upd, torch._foreach_mul(p, _f32(self.weight_decay)))
        lr = self.learning_rate(state.steps) if callable(self.learning_rate) else self.learning_rate
        torch._foreach_mul_(upd, -_f32(lr))
        torch._foreach_add_(p, upd)
        state.count += 1
        if state.schedule_count is not None:
            state.schedule_count += 1
        state.steps = count


def adamw(learning_rate, *, clip_norm: float | None = None) -> Adam:
    """optax.adamw(learning_rate) (after clip_by_global_norm(clip_norm))."""
    return Adam(learning_rate, clip_norm=clip_norm)


def adam(learning_rate) -> Adam:
    """optax.adam(learning_rate)."""
    return Adam(learning_rate, weight_decay=None)


# ─── Losses ─────────────────────────────────────────────────────────────────


@dataclass
class TrainState:
    params: dict
    opt_state: OptState
    step: int = 0


def _long(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).long()


def _model(split: EncoderSplit | None):
    return None if split is None else split.model


def _encode(params: dict, cfg, feats, mel_lengths, remat: bool, split: EncoderSplit | None = None):
    enc = fastconformer_encode(Params(params).sub("encoder_"), cfg.encoder, feats, mel_lengths, remat=remat,
                               split=split)
    enc_lens = torch.clamp(encoded_lengths(_long(mel_lengths, enc.device)), max=enc.shape[1])
    return enc, enc_lens


def ctc_forward(params: dict, cfg, feats, mel_lengths, remat: bool = False, split: EncoderSplit | None = None):
    """(B, T, mel) → (B, T', V) log-probs + (B,) encoder lengths. split:
    this rank's split over a mesh (`params` its shards; the reference's
    act_sharding and tensor-parallel rules)."""
    enc, enc_lens = _encode(params, cfg, feats, mel_lengths, remat, split)
    return ctc_log_probs(Params(params).sub("ctc_decoder_"), enc, _model(split)), enc_lens


def ctc_loss_from_log_probs(log_probs, enc_lens, labels, label_lengths, blank_id: int):
    """Mean CTC NLL from (B, T', V) log-probs. A label sequence the frames
    cannot hold gives an infinite NLL (torch's ctc_loss; optax gives a
    large finite one)."""
    dev = log_probs.device
    per_seq = F.ctc_loss(log_probs.transpose(0, 1), _long(labels, dev), _long(enc_lens, dev),
                         _long(label_lengths, dev), blank=blank_id, reduction="none", zero_infinity=False)
    return per_seq.mean()


def ctc_loss_fn(params, cfg, batch, blank_id: int, remat: bool = False, split: EncoderSplit | None = None):
    log_probs, enc_lens = ctc_forward(params, cfg, batch["features"], batch["mel_lengths"], remat=remat, split=split)
    return ctc_loss_from_log_probs(log_probs, enc_lens, batch["labels"], batch["label_lengths"], blank_id)


def transducer_lattice(params: dict, cfg, enc, labels, *, loss: str = "tdt", joint_prefix: str | None = None,
                       model=None):
    """Prediction net + joint over a (B, T', H) encoding: TDT → ((B, T',
    U+1, V), (B, T', U+1, D)) log-probs, RNNT → (B, T', U+1, V). The
    prediction net reads [SOS = blank; labels]; without `joint_prefix` the
    joint is found from the weight schema (tdt-ctc keys it "tdt_joint_",
    the 600m presets "joint_"). model: the 'model' axis over which the
    embedding's and the vocab heads' rows are split."""
    if joint_prefix is None:
        head = "label_proj_" if loss == "tdt" else "out_proj_"
        prefs = ("tdt_joint_", "joint_") if loss == "tdt" else ("joint_", "tdt_joint_")
        joint_prefix = next((p for p in prefs if f"{p}.{head}.weight" in params), prefs[0])
    root = Params(params)
    b = labels.shape[0]
    blank = cfg.joint.vocab_size - 1
    labels = _long(labels, enc.device)
    pred_in = torch.cat([torch.full((b, 1), blank, dtype=torch.long, device=enc.device), labels], dim=1)
    state0 = prediction_zero_state(cfg.prediction.num_lstm_layers, b, cfg.prediction.pred_hidden, enc.dtype,
                                   enc.device)
    pred, _ = prediction_forward(root.sub("prediction_"), pred_in, state0, cfg.prediction.num_lstm_layers, model)
    joint_fn = tdt_joint if loss == "tdt" else rnnt_joint
    # enc_proj and pred_proj run before the (T' × U+1) broadcast; only the
    # joint hidden and the heads live on the full lattice
    return torch.utils.checkpoint.checkpoint(joint_fn, root.sub(joint_prefix), enc[:, :, None, :],
                                             pred[:, None, :, :], model, use_reentrant=False)


def _transducer_nll(params, cfg, enc, enc_lens, batch, kind: str, sigma: float, joint_prefix=None, model=None):
    labels, label_lengths = batch["labels"], batch["label_lengths"]
    out = transducer_lattice(params, cfg, enc, labels, loss=kind, joint_prefix=joint_prefix, model=model)
    blank = cfg.joint.vocab_size - 1
    if kind == "tdt":
        lab_lp, dur_lp = out
        per_seq = tdt_loss(lab_lp, dur_lp, labels, enc_lens, label_lengths, blank, tuple(cfg.durations),
                           sigma=sigma)
    else:
        per_seq = rnnt_loss(out, labels, enc_lens, label_lengths, blank)
    return per_seq.mean()


def encoded_loss_fn(params: dict, cfg, enc, enc_lens, batch, *, loss: str = "hybrid", sigma: float = 0.0,
                    ctc_weight: float = 0.3, model=None):
    """Training loss from a computed encoding, loss ∈ {'ctc', 'rnnt',
    'tdt', 'hybrid'}; model: the 'model' axis of the heads' split."""

    def _ctc():
        lp = ctc_log_probs(Params(params).sub("ctc_decoder_"), enc, model)
        return ctc_loss_from_log_probs(lp, enc_lens, batch["labels"], batch["label_lengths"],
                                       cfg.ctc_vocab_size - 1)

    if loss == "ctc":
        return _ctc()
    if loss in ("rnnt", "tdt"):
        return _transducer_nll(params, cfg, enc, enc_lens, batch, loss, sigma, model=model)
    if loss == "hybrid":
        return (1.0 - ctc_weight) * _transducer_nll(params, cfg, enc, enc_lens, batch, "tdt", sigma, model=model) \
            + ctc_weight * _ctc()
    raise ValueError(f"unknown loss {loss!r}")


def transducer_forward(params: dict, cfg, feats, mel_lengths, labels, *, loss: str = "tdt",
                       joint_prefix: str | None = None, remat: bool = False, split: EncoderSplit | None = None):
    """Full-lattice transducer forward: the lattice of `transducer_lattice`
    and the (B,) encoder lengths."""
    enc, enc_lens = _encode(params, cfg, feats, mel_lengths, remat, split)
    return transducer_lattice(params, cfg, enc, labels, loss=loss, joint_prefix=joint_prefix,
                              model=_model(split)), enc_lens


def transducer_loss_fn(params, cfg, batch, *, loss: str = "tdt", sigma: float = 0.0,
                       joint_prefix: str | None = None, remat: bool = False, split: EncoderSplit | None = None):
    """Mean RNNT/TDT negative log-likelihood over a padded batch."""
    enc, enc_lens = _encode(params, cfg, batch["features"], batch["mel_lengths"], remat, split)
    return _transducer_nll(params, cfg, enc, enc_lens, batch, loss, sigma, joint_prefix, _model(split))


def hybrid_loss_fn(params, cfg, batch, *, ctc_weight: float = 0.3, sigma: float = 0.0, remat: bool = False,
                   split: EncoderSplit | None = None):
    """(1 − w)·TDT + w·CTC over the shared encoder (the flagship objective)."""
    enc, enc_lens = _encode(params, cfg, batch["features"], batch["mel_lengths"], remat, split)
    return encoded_loss_fn(params, cfg, enc, enc_lens, batch, loss="hybrid", sigma=sigma, ctc_weight=ctc_weight,
                           model=_model(split))


# ─── Schedules, dtype, gradients ────────────────────────────────────────────


def make_lr_schedule(learning_rate: float, *, schedule: str = "constant", warmup_steps: int = 0,
                     decay_steps: int | None = None):
    """The reference's schedules, evaluated in float32 as optax does:
    'constant' (a float, or a linear warmup from 0 when warmup_steps > 0),
    'cosine' (linear warmup, then cosine decay to 0 over decay_steps, the
    run's total steps) and 'noam' (peak at warmup_steps, then
    lr·sqrt(warmup/step)). A schedule maps the optimizer count to the
    learning rate."""
    f32 = np.float32

    def linear(count, init, end, steps):
        c = f32(min(max(count, 0), steps))
        return float((f32(init) - f32(end)) * (f32(1) - c / f32(steps)) + f32(end))

    if schedule == "constant":
        if warmup_steps > 0:
            return lambda count: linear(count, 0.0, learning_rate, warmup_steps)
        return learning_rate
    if schedule == "cosine":
        if not decay_steps or decay_steps < 2:
            raise ValueError(
                "cosine schedule needs decay_steps >= 2 (total steps; optax "
                f"requires warmup < total), got {decay_steps!r}"
            )
        warm = max(1, min(warmup_steps, decay_steps - 1))
        if warmup_steps >= decay_steps:
            warnings.warn(
                f"cosine schedule: warmup_steps={warmup_steps} >= "
                f"decay_steps={decay_steps}; clamping warmup to {warm}. "
                "If this is not a smoke run, fix the schedule "
                "(warmup should be a small fraction of total steps).",
                stacklevel=2,
            )
        span = decay_steps - warm

        def cosine(count):
            if count < warm:
                return linear(count, 0.0, learning_rate, warm)
            c = f32(min(count - warm, span))
            decay = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(span), dtype=f32))
            return float(f32(learning_rate) * decay)

        return cosine
    if schedule == "noam":
        warm = max(warmup_steps, 1)

        def noam(count):
            step = f32(max(count, 1))
            return float(f32(learning_rate) * min(step / f32(warm), np.sqrt(f32(warm) / step, dtype=f32)))

        return noam
    raise ValueError(f"unknown schedule {schedule!r}")


def with_compute_dtype(loss_fn, compute_dtype):
    """A (params, batch) loss that runs the model in `compute_dtype` (e.g.
    "bfloat16") while the caller keeps float32 master params: the cast runs
    inside the differentiated function, so gradients come back float32.
    Norm params stay float32 (params.cast_params)."""
    if compute_dtype in (None, "float32", torch.float32):
        return loss_fn
    dt = torch.bfloat16 if compute_dtype == "bfloat16" else compute_dtype
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"compute_dtype must be 'float32', 'bfloat16' or a torch dtype, got {compute_dtype!r}")

    def f(params, batch):
        return loss_fn(cast_params(params, dt), dict(batch, features=batch["features"].to(dt)))

    return f


def _value_and_grad(loss_fn, params: dict, batch: dict):
    flat = flatten_params(params)
    leaves = {k: v.detach().requires_grad_() for k, v in flat.items() if v.is_floating_point()}
    with torch.enable_grad():
        loss = loss_fn(unflatten_params({**flat, **leaves}), batch)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True, materialize_grads=True)
    return loss.detach(), dict(zip(leaves, grads))


def value_and_grad_accum(loss_fn, accum_steps: int = 1):
    """(params, batch) → (loss, {key: gradient}) of a loss; a parameter the
    loss does not read gets a zero gradient, as jax.value_and_grad gives.
    With accum_steps > 1 the batch splits on its leading dim into equal
    chunks whose losses and gradients average into one pair (gradient
    accumulation): the same result as the whole batch, with one chunk's
    activations alive at a time."""
    if accum_steps <= 1:
        return lambda params, batch: _value_and_grad(loss_fn, params, batch)
    n = accum_steps

    def f(params, batch):
        for v in batch.values():
            if v.shape[0] % n:
                raise ValueError(f"batch dim {v.shape[0]} not divisible by accum_steps={n}")
        lval, grads = None, None
        for i in range(n):
            chunk = {k: v[i * (v.shape[0] // n):(i + 1) * (v.shape[0] // n)] for k, v in batch.items()}
            cl, cg = _value_and_grad(loss_fn, params, chunk)
            if grads is None:
                lval = torch.zeros((), dtype=_F32, device=cl.device)
                grads = {k: torch.zeros_like(g) for k, g in cg.items()}
            lval = lval + cl / n
            keys = list(grads)
            summed = torch._foreach_add([grads[k] for k in keys], torch._foreach_div([cg[k] for k in keys], n))
            grads = dict(zip(keys, summed))
        return lval, grads

    return f


def _step_fn(vag, optimizer: Adam):
    def step(params, opt_state, batch):
        lval, grads = vag(params, batch)
        optimizer.update(params, grads, opt_state)
        return params, opt_state, lval

    return step


def objective(cfg, loss: str, *, sigma: float = 0.0, ctc_weight: float = 0.3, sort_weight: float = 0.5,
              blank_id=None, joint_prefix: str | None = None, remat: bool = False,
              split: EncoderSplit | None = None):
    """(params, batch) → the loss of `loss` ∈ {'ctc', 'rnnt', 'tdt',
    'hybrid', 'sortformer'}: the one place each trainer's objective is
    written, on one device or on a mesh's `split`."""
    if loss == "ctc":
        blank = cfg.ctc_vocab_size - 1 if blank_id is None else blank_id
        return lambda p, b: ctc_loss_fn(p, cfg, b, blank, remat=remat, split=split)
    if loss == "hybrid":
        return lambda p, b: hybrid_loss_fn(p, cfg, b, ctc_weight=ctc_weight, sigma=sigma, remat=remat, split=split)
    if loss == "sortformer":
        return lambda p, b: sortformer_loss_fn(p, cfg, b, sort_weight=sort_weight, remat=remat, split=split)
    if loss in ("rnnt", "tdt"):
        return lambda p, b: transducer_loss_fn(p, cfg, b, loss=loss, sigma=sigma, joint_prefix=joint_prefix,
                                               remat=remat, split=split)
    raise ValueError(f"loss must be 'ctc', 'rnnt', 'tdt', 'hybrid' or 'sortformer', got {loss!r}")


def _train_step(fn, optimizer: Adam, accum_steps: int, compute_dtype: str):
    return _step_fn(value_and_grad_accum(with_compute_dtype(fn, compute_dtype), accum_steps), optimizer)


def make_transducer_train_step(cfg, optimizer: Adam, *, loss: str = "tdt", sigma: float = 0.0,
                               joint_prefix: str | None = None, remat: bool = False, accum_steps: int = 1,
                               compute_dtype: str = "float32"):
    """(params, opt_state, batch) → (params, opt_state, loss) for the
    RNNT/TDT stacks (loss 'rnnt' or 'tdt'); params and state update in
    place."""
    if loss not in ("rnnt", "tdt"):
        raise ValueError(f"loss must be 'rnnt' or 'tdt', got {loss!r}")
    fn = objective(cfg, loss, sigma=sigma, joint_prefix=joint_prefix, remat=remat)
    return _train_step(fn, optimizer, accum_steps, compute_dtype)


def make_hybrid_train_step(cfg, optimizer: Adam, *, ctc_weight: float = 0.3, sigma: float = 0.0,
                           remat: bool = False, accum_steps: int = 1, compute_dtype: str = "float32"):
    """The hybrid TDT + CTC train step (the flagship objective)."""
    fn = objective(cfg, "hybrid", ctc_weight=ctc_weight, sigma=sigma, remat=remat)
    return _train_step(fn, optimizer, accum_steps, compute_dtype)


def make_train_step(cfg, optimizer: Adam, blank_id=None, remat: bool = False, accum_steps: int = 1,
                    compute_dtype: str = "float32"):
    """The CTC train step."""
    return _train_step(objective(cfg, "ctc", blank_id=blank_id, remat=remat), optimizer, accum_steps, compute_dtype)


class MeshLayout:
    """How a trainer's state lies over a mesh: `dims` maps each key that is
    split to (axis name, dim): 'model' for parallel/mesh.py's rules (the
    vocab dims padded first), 'pipe' for the pipeline trainer's stacked
    layers. Every other key is whole on every rank."""

    def __init__(self, mesh, dims: dict):
        self.mesh, self.dims = mesh, dims

    def whole_shape(self, key, local) -> tuple[int, ...]:
        shape = list(local.shape)
        if key in self.dims:
            name, dim = self.dims[key]
            shape[dim] *= self.mesh.axis(name).size
        return tuple(shape)

    def shard(self, key, whole):
        """This rank's shard of a whole array or tensor of `key`."""
        if key not in self.dims:
            return whole
        name, dim = self.dims[key]
        axis = self.mesh.axis(name)
        n = whole.shape[dim] // axis.size
        return whole[(slice(None),) * dim + (slice(axis.index * n, (axis.index + 1) * n),)]

    def gather(self, flat: dict) -> dict:
        """The whole tensors of a flat {key: shard} dict, on every rank (a
        collective: every rank calls it with the same keys)."""
        from parakeet_tpu_torch.parallel.collectives import gather_dim

        out = {}
        for k in sorted(flat):
            v = flat[k].detach()
            if k in self.dims:
                name, dim = self.dims[k]
                v = gather_dim(v, self.mesh.axis(name), dim)
            out[k] = v
        return out

    def global_norm(self, keys, grads) -> torch.Tensor:
        """‖g‖ of the whole gradient: each split key's squares summed over
        its axis, each whole key counted once."""
        from parakeet_tpu_torch.parallel.collectives import all_reduce_sum

        sq = {}
        for k, g in zip(keys, grads):
            name = self.dims[k][0] if k in self.dims else None
            sq[name] = sq.get(name, 0.0) + g.to(_F32).square().sum()
        total = sq.pop(None, torch.zeros((), dtype=_F32, device=grads[0].device))
        for name in sorted(sq):
            total = total + all_reduce_sum(sq[name], self.mesh.axis(name))
        return torch.sqrt(total)


def mesh_step(vag, optimizer: Adam, mesh, seq_keys=()):
    """The step on a mesh from `vag`, this rank's (loss, gradients): the
    gradients of `seq_keys` (the encoder's, whose rank saw only its own
    frames) summed over 'seq', then the loss and every gradient averaged
    over 'data' (one all-reduce: the global mean, since the ranks' batch
    shards are equal), then the optimizer on this rank's shards.
    `step.value_and_grad(params, batch)` gives the reduced loss and
    gradients without the update, `step.local_value_and_grad` this rank's
    own before any reduction."""
    from parakeet_tpu_torch.parallel.collectives import mean_over, sum_over

    data, seq = mesh.axis("data"), mesh.axis("seq")

    def value_and_grad(params, batch):
        lval, grads = vag(params, batch)
        grads = mean_over({**sum_over(grads, seq_keys, seq), "##loss": lval.reshape(1)}, data)
        return grads.pop("##loss")[0], grads

    def step(params, opt_state, batch):
        lval, grads = value_and_grad(params, batch)
        optimizer.update(params, grads, opt_state)
        return params, opt_state, lval

    step.value_and_grad, step.local_value_and_grad = value_and_grad, vag
    return step


def make_sharded_trainer(
    cfg,
    params: dict,
    mesh=None,
    *,
    learning_rate: float = 1e-4,
    model_parallel: int = 1,
    seq_parallel: int = 1,
    loss: str = "ctc",
    sigma: float = 0.0,
    remat: bool = False,
    accum_steps: int = 1,
    sort_weight: float = 0.5,
    compute_dtype: str = "float32",
    schedule: str = "constant",
    warmup_steps: int = 0,
    decay_steps: int | None = None,
    clip_norm: float | None = None,
    device: str | torch.device = DEFAULT_DEVICE,
):
    """Set up a trainer: float32 params copied to the device, adamw (after
    clip_by_global_norm when clip_norm), the step of `loss` ∈ {'ctc',
    'rnnt', 'tdt', 'hybrid', 'sortformer'}. remat / accum_steps: the
    memory levers (numerically the plain step); compute_dtype 'bfloat16'
    runs the model in bf16 with float32 masters; schedule / warmup_steps /
    decay_steps: make_lr_schedule.

    mesh (parallel/mesh.py make_mesh; built with model_parallel and
    seq_parallel when not given and this process runs in a process group
    or asks for either): the step runs SPMD on this rank's shards of the
    params (`shard_params`, vocabularies padded) and its rows of each
    batch over 'data' (`place_batch`), over 'seq' its block of the
    encoder's frames (ASR objectives only, as in the reference); the loss
    it returns is the global mean and each gradient the single-device
    one's shard. Without a mesh or a process group it trains on `device`
    (the card unless given). Returns (mesh, state, step_fn, place_batch),
    the device in place of the mesh when there is none; on a mesh
    `step_fn.value_and_grad(params, batch)` gives the step's reduced loss
    and gradients without updating."""
    import torch.distributed as dist

    from parakeet_tpu_torch.parallel.mesh import (
        activation_sharding,
        batch_sharding,
        make_mesh,
        mesh_device,
        pad_vocab_dim,
        shard_params,
    )

    if loss not in ("ctc", "hybrid", "sortformer", "rnnt", "tdt"):
        raise ValueError(f"loss must be 'ctc', 'rnnt', 'tdt', 'hybrid' or 'sortformer', got {loss!r}")
    if mesh is None and (model_parallel > 1 or seq_parallel > 1 or dist.is_initialized()):
        if not dist.is_initialized() and "WORLD_SIZE" not in os.environ:
            raise ValueError(
                f"model_parallel={model_parallel} × seq_parallel={seq_parallel} needs that many ranks; this "
                "process is one rank with no process group: start the ranks with python -m "
                "torch.distributed.run (or parallel/launch.py spawn_ranks), or pass a mesh")
        mesh = make_mesh(model_parallel=model_parallel, seq_parallel=seq_parallel,
                         devices="cpu" if torch.device(device).type == "cpu" else None)
    host = {k: (v.detach() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v)))
            for k, v in params.items()}
    split, local, dims = None, host, {}
    if mesh is None:
        dev = resolve_device(device)
    else:
        dev = mesh_device(mesh, device)
        if mesh.shape.get("pipe", 1) > 1:
            raise ValueError("a ('data', 'pipe') mesh trains with parallel/pipeline.py make_pp_trainer")
        if loss == "sortformer" and activation_sharding(mesh) is not None:
            raise ValueError("sequence parallelism is not supported for the sortformer objective")
        split = EncoderSplit(mesh.axis("model"), mesh.axis("seq"))
        local = shard_params(host, mesh)
        tp = mesh.axis("model").size
        for k, v in local.items():  # the keys shard_params split: their (vocab-padded) whole shape differs
            whole = pad_vocab_dim(k, host[k], tp)
            diff = [i for i, (a, b) in enumerate(zip(v.shape, (host[k] if whole is None else whole).shape)) if a != b]
            if diff:
                dims[k] = ("model", diff[0])
    placed = {k: v.to(device=dev, dtype=_F32, copy=True) for k, v in local.items()}
    fn = objective(cfg, loss, sigma=sigma, sort_weight=sort_weight, remat=remat, split=split)
    vag = value_and_grad_accum(with_compute_dtype(fn, compute_dtype), accum_steps)
    optimizer = adamw(make_lr_schedule(learning_rate, schedule=schedule, warmup_steps=warmup_steps,
                                       decay_steps=decay_steps), clip_norm=clip_norm)
    opt_state = optimizer.init(placed)
    if mesh is None:
        step = _step_fn(vag, optimizer)
    else:
        step = mesh_step(vag, optimizer, mesh, [k for k in placed if k.startswith("encoder_.")])
        opt_state.layout = MeshLayout(mesh, dims)

    def place_batch(batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            v = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))
            out[k] = (v if mesh is None else v[batch_sharding(mesh, v.shape[0])]).to(dev)
        return out

    return dev if mesh is None else mesh, TrainState(placed, opt_state), step, place_batch


# ─── Sortformer (diarization) training ──────────────────────────────────────
# BCE on per-frame per-speaker activity, a weighted sum of the Sort Loss
# (targets ordered by arrival) and PIL (the least BCE over all speaker
# permutations; S=4 gives 24), the Sortformer recipe (arXiv:2409.06656).


def sort_speakers_by_arrival(targets: torch.Tensor) -> torch.Tensor:
    """(B, T, S) 0/1 activity → channels ordered by each speaker's first
    active frame (never-active speakers last, ties in channel order)."""
    t = targets.shape[1]
    active = targets > 0.5
    first = torch.where(active.any(dim=1), active.to(torch.uint8).argmax(dim=1), t)  # (B, S)
    order = torch.argsort(first, dim=1, stable=True)
    return targets.gather(2, order[:, None, :].expand_as(targets))


def sortformer_bce(logits: torch.Tensor, targets: torch.Tensor, frame_mask: torch.Tensor) -> torch.Tensor:
    """Per-sequence mean sigmoid BCE over valid frames: (B, T, S) logits ×
    targets, (B, T) mask → (B,)."""
    per = -targets * F.logsigmoid(logits) - (1.0 - targets) * F.logsigmoid(-logits)
    per = per * frame_mask[:, :, None]
    denom = torch.clamp(frame_mask.sum(dim=1), min=1.0) * targets.shape[-1]
    return per.sum(dim=(1, 2)) / denom


def sortformer_loss_fn(params: dict, cfg, batch, *, sort_weight: float = 0.5, remat: bool = False,
                       split: EncoderSplit | None = None):
    """sort_weight·SortLoss + (1 − sort_weight)·PIL over a padded batch:
    features (B, mel_len, mel_bins), mel_lengths (B,), targets (B, T', S)
    at the encoder frame rate."""
    from parakeet_tpu_torch.models.sortformer import sortformer_logits

    mel_lengths = batch["mel_lengths"]
    logits = sortformer_logits(params, batch["features"], cfg=cfg, mel_lengths=mel_lengths, remat=remat,
                               split=split)
    t = logits.shape[1]
    enc_lens = torch.clamp(encoded_lengths(_long(mel_lengths, logits.device)), max=t)
    mask = (torch.arange(t, device=logits.device)[None, :] < enc_lens[:, None]).to(_F32)
    tgt = batch["targets"][:, :t].to(_F32) * mask[:, :, None]
    total = 0.0
    if sort_weight > 0.0:
        total = total + sort_weight * sortformer_bce(logits, sort_speakers_by_arrival(tgt), mask)
    if sort_weight < 1.0:
        s = tgt.shape[-1]
        pil = torch.stack([sortformer_bce(logits, tgt[:, :, list(p)], mask)
                           for p in itertools.permutations(range(s))], dim=1).amin(dim=1)
        total = total + (1.0 - sort_weight) * pil
    return total.mean()


def make_sortformer_train_step(cfg, optimizer: Adam, *, sort_weight: float = 0.5, remat: bool = False,
                               accum_steps: int = 1, compute_dtype: str = "float32"):
    """The Sortformer diarization train step."""
    return _train_step(objective(cfg, "sortformer", sort_weight=sort_weight, remat=remat), optimizer, accum_steps,
                       compute_dtype)


def synthetic_sortformer_batch(cfg, batch: int, mel_frames: int, seed=0):
    """Random mel features + block-structured 0/1 activity targets at the
    encoder frame rate (numpy; the reference's draws)."""
    rng = np.random.RandomState(seed)
    t = subsample_length(mel_frames)
    s = cfg.max_speakers
    targets = np.zeros((batch, t, s), np.float32)
    for b in range(batch):
        for k in range(rng.randint(1, s + 1)):
            start = rng.randint(0, max(1, t - 2))
            end = rng.randint(start + 1, t + 1)
            targets[b, start:end, k] = 1.0
    return {
        "features": rng.randn(batch, mel_frames, cfg.nest_encoder.mel_bins).astype(np.float32),
        "mel_lengths": np.full((batch,), mel_frames, np.int32),
        "targets": targets,
    }


def synthetic_batch(cfg, batch: int, mel_frames: int, max_labels: int, seed=0):
    """Random features and labels (numpy; the reference's draws)."""
    rng = np.random.RandomState(seed)
    vocab = getattr(cfg, "ctc_vocab_size", cfg.joint.vocab_size) - 1  # labels exclude blank
    return {
        "features": rng.randn(batch, mel_frames, cfg.encoder.mel_bins).astype(np.float32),
        "mel_lengths": np.full((batch,), mel_frames, np.int32),
        "labels": rng.randint(0, vocab, size=(batch, max_labels)).astype(np.int32),
        "label_lengths": np.full((batch,), max_labels, np.int32),
    }


__all__ = [
    "Adam",
    "MeshLayout",
    "mesh_step",
    "OptState",
    "TrainState",
    "adam",
    "adamw",
    "ctc_forward",
    "ctc_loss_fn",
    "ctc_loss_from_log_probs",
    "encoded_loss_fn",
    "objective",
    "transducer_lattice",
    "hybrid_loss_fn",
    "make_hybrid_train_step",
    "make_train_step",
    "make_sharded_trainer",
    "make_sortformer_train_step",
    "make_transducer_train_step",
    "sort_speakers_by_arrival",
    "sortformer_bce",
    "sortformer_loss_fn",
    "make_lr_schedule",
    "flatten_params",
    "unflatten_params",
    "synthetic_batch",
    "synthetic_sortformer_batch",
    "transducer_forward",
    "transducer_loss_fn",
    "value_and_grad_accum",
    "with_compute_dtype",
]
