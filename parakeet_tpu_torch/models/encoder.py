"""Offline FastConformer encoder (port of parakeet_tpu/models/encoder.py).

ConvSubsampling (8×, ReLU) → conformer blocks of macaron FFN (0.5
half-step) → rel-pos MHSA → conv module (inference BatchNorm) → FFN →
final LayerNorm. Each block's attention runs the fused rel-pos attention
block (ops/rel_attention.py): the hand-written CUDA kernel on CUDA tensors,
its plain torch version on CPU. The other sublayers are plain torch by
default; `FusedLayers` picks the fused kernels per sublayer, as the
reference's bench.py flags do: the FFNs, the conv module and the front of
the subsampling (--fused-ffn --conv-layout pallas --fused-subsample:
ops/feed_forward.py, ops/conv_module.py, ops/subsample.py), ffn1 with the
attention in one kernel (--fused-mode mega: ops/ffn_attention.py), the
attention core alone with the projections in torch (--fused-mode v1:
ops/rel_attention.py fused_rel_attention), and the conv module, ffn2 and
the final LayerNorm in one kernel (--fused-block2: ops/conv_ffn_final.py).

Padded batches carry per-item mel lengths; pad frames are masked out of
attention by key length and zeroed before the depthwise conv.

On a mesh (`EncoderSplit`, the reference's act_sharding seam with its
tensor-parallel rules) each collective is explicit
(parallel/collectives.py). Tensor parallelism ('model'): the FFN's fc1
rows and fc2 columns (fc2 row-parallel: the partial products summed, then
the bias); the attention heads through K1's head-sharded mode (its f32
partial out-projection summed, then the bias and the residual once); the
conv module's pointwise_conv1 channels, gathered before the GLU (the
contiguous row split puts the GLU's value and gate halves on different
ranks), the depthwise conv, BatchNorm and pointwise_conv2 whole on every
rank. The other kernels take the whole weights (`EncoderSplit.full`) and
compute their sublayer replicated over 'model', as XLA's partitioner does
around a kernel it has no rule for. Sequence parallelism ('seq'): after
the subsampling, T' is padded to a multiple of the axis and each rank
keeps its block of frames; the attention (plain, as the reference
requires) gathers the normed frames for its keys and values and shifts the
relative positions by its block's offset, the depthwise conv takes 4-frame
halos from its neighbours, and the blocks' output is gathered at the end.
Every split trains: each collective carries its backward
(parallel/collectives.py: the inputs of the column-parallel linears, of
pw1 and of K1 head-sharded, and the replicated weights inside a head
share, through `copy_to_model`; the partial sums through
`reduce_from_model`; the K/V gather's gradient reduce-scattered, the
halos' sent back, the output gather's sliced), and K1 head-sharded runs
under grad through its autograd Function. The whole-weight kernels
(`EncoderSplit.full`) are inference only; a trainer never builds them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.utils.checkpoint

from parakeet_tpu_torch.config import EncoderConfig
from parakeet_tpu_torch.ops.layers import (
    batch_norm_1d,
    conv1d,
    conv2d,
    glu,
    layer_norm,
    linear,
    require_ieee_f32,
    silu,
)
from parakeet_tpu_torch.ops.conv_ffn_final import fused_conv_ffn_final
from parakeet_tpu_torch.ops.conv_module import fused_conv_module
from parakeet_tpu_torch.ops.feed_forward import fused_feed_forward
from parakeet_tpu_torch.ops.ffn_attention import fused_ffn_attention
from parakeet_tpu_torch.ops.rel_attention import (
    fused_rel_attention,
    position_table,
    position_table_np,
    rel_attention_block,
    rel_attention_block_heads,
    rel_attention_block_reference,
)
from parakeet_tpu_torch.ops.subsample import fused_subsample_block1
from parakeet_tpu_torch.parallel.collectives import copy_to_model, gather_dim, halo_exchange, reduce_from_model
from parakeet_tpu_torch.parallel.mesh import AxisGroup
from parakeet_tpu_torch.params import Params


ATTENTION_MODES = ("block", "mega", "v1")

# The reference's input guards (parakeet_tpu/models/encoder.py
# _subsample_fusable, _ffn_fusable): below them it runs the XLA layers,
# which round where the kernels do not, so the port takes its plain layers
# there too.
_SUBSAMPLE_T4_TILE = 32  # K8: stage-2 frames T4 at least this, F2 even
_FFN_MIN_FRAMES = 64  # K6, K7, K4: T' at least this


@dataclass(frozen=True)
class FusedLayers:
    """Which encoder sublayers run through their fused kernel, named after
    the reference's bench.py flags: `ffn` (--fused-ffn: both FFNs, ffn2
    with the block's final LayerNorm), `conv` (--conv-layout pallas: the
    conv module), `subsample` (--fused-subsample: conv1 → dw1 → conv2),
    `attention` (--fused-mode: "block" runs the attention block kernel K1,
    "mega" runs ffn1 and the attention as one kernel K7, "v1" runs the
    projections in torch around the attention-core kernel K2) and `block2`
    (--fused-block2: the conv module, ffn2 and the final LayerNorm as one
    kernel K4). All off, with attention "block", is the plain path.

    Precedence follows the reference's conformer_block: "mega" takes ffn1
    and the attention whatever `ffn` says; `block2` takes the conv module,
    ffn2 and the final LayerNorm whatever `ffn` and `conv` say. The
    reference's input guards hold as there: the subsampling kernel runs
    only when T4 ≥ _SUBSAMPLE_T4_TILE and F2 is even, and the FFN, mega and
    block2 kernels only when T' ≥ _FFN_MIN_FRAMES; otherwise those layers
    run plain, as with the field off ("mega" then runs the attention block
    kernel K1, as the reference does). Its weight guards hold too: a
    sublayer with quantized weights (int8 or packed int4) runs plain, and
    an attention with quantized projections takes the v1 route around K2
    whatever the mode. Its VMEM budgets (weight sizes,
    score buffers, v1's T ≤ 768) size the TPU's memory, not the input, and
    are not ported: on CUDA a configuration launches its kernels or
    raises."""

    ffn: bool = False
    conv: bool = False
    subsample: bool = False
    attention: str = "block"
    block2: bool = False

    def __post_init__(self):
        if self.attention not in ATTENTION_MODES:
            raise ValueError(f"FusedLayers.attention must be one of {ATTENTION_MODES}, got {self.attention!r}")


@dataclass(frozen=True)
class EncoderSplit:
    """How one encoder call is split over a mesh: `model`, the 'model' axis
    (its group, size and this rank's index; parallel/mesh.py AxisGroup),
    over which the weights the encoder is given are split by
    parallel/mesh.py's rules; `seq`, the 'seq' axis, over which time is
    split; `full`, the whole weights (a view at the encoder prefix) for the
    sublayers that run a kernel other than K1 on a 'model' axis > 1, None
    when the configuration runs none."""

    model: AxisGroup
    seq: AxisGroup
    full: Params | None = None


def sinusoidal_position_embedding(seq_len: int, d_model: int) -> torch.Tensor:
    """(2*seq_len-1, d_model): relative positions +(L-1) … -(L-1)."""
    return torch.from_numpy(position_table_np(seq_len, d_model))


def subsample_length(t: int) -> int:
    """Output frames after three k3/s2/p1 convs."""
    for _ in range(3):
        t = (t - 1) // 2 + 1
    return t


def encoded_lengths(lengths: torch.Tensor) -> torch.Tensor:
    l = lengths
    for _ in range(3):
        l = torch.div(l - 1, 2, rounding_mode="floor") + 1
    return l


def _flatten_proj(p: Params, h: torch.Tensor) -> torch.Tensor:
    b, ch, t, f = h.shape
    return linear(p.sub("proj_"), h.permute(0, 2, 1, 3).reshape(b, t, ch * f))


def conv_subsampling_stages(
    p: Params, x: torch.Tensor, activation: str = "relu"
) -> dict[str, torch.Tensor]:
    """conv_subsampling with named intermediates, as the reference's
    conv_subsampling_stages: after_conv1 = conv1 + act, after_block1 =
    dw1 + conv2 + act, after_block2 = dw2 + conv3 + act, subsampling_out.
    Conv stages are NCHW (the reference's are NHWC)."""
    act = torch.relu if activation == "relu" else silu
    c = p["conv1_.weight"].shape[0]
    h = act(conv2d(p.sub("conv1_"), x[:, None, :, :], stride=(2, 2), padding=(1, 1)))
    after_conv1 = h
    h = conv2d(p.sub("dw1_"), h, stride=(2, 2), padding=(1, 1), groups=c)
    h = act(conv2d(p.sub("conv2_"), h))
    after_block1 = h
    h = conv2d(p.sub("dw2_"), h, stride=(2, 2), padding=(1, 1), groups=c)
    h = act(conv2d(p.sub("conv3_"), h))
    return {
        "after_conv1": after_conv1,
        "after_block1": after_block1,
        "after_block2": h,
        "subsampling_out": _flatten_proj(p, h),
    }


def _float_weights(p: Params, keys: tuple[str, ...]) -> bool:
    """No quantized (int8 or packed int4) weight among `keys`: the kernels
    read float weights, and the reference sends a sublayer with integer
    weights to its plain layers (quantize_params' include= can quantize any
    subset)."""
    return all(p[k].is_floating_point() for k in keys)


_ATTN_WEIGHTS = ("mha_.q_proj.weight", "mha_.k_proj.weight", "mha_.v_proj.weight", "mha_.out_proj.weight",
                 "pos_proj_.weight")


def _subsample_fusable(p: Params, x: torch.Tensor) -> bool:
    """The reference's guard on K8 (models/encoder.py _subsample_fusable):
    input (B, T, mel) with T4 ≥ 32 and F2 even, float conv1, dw1, conv2."""
    t4 = ((x.shape[1] - 1) // 2) // 2 + 1
    f2 = (x.shape[2] - 1) // 2 + 1
    return (t4 >= _SUBSAMPLE_T4_TILE and f2 % 2 == 0
            and _float_weights(p, ("conv1_.weight", "dw1_.weight", "conv2_.weight")))


def _ffn_fusable(p: Params, x: torch.Tensor) -> bool:
    """The reference's guard on the FFN kernels (_ffn_fusable): input
    (B, T', D) with T' ≥ 64, float fc1 and fc2 (`p` at the FFN prefix)."""
    return x.shape[1] >= _FFN_MIN_FRAMES and _float_weights(p, ("fc1_.weight", "fc2_.weight"))


def _attention_fusable(p: Params) -> bool:
    """The reference's weight guard on the attention block kernels
    (_attn_block_fusable): float q, k, v, out and pos projections (`p` at
    the attention prefix)."""
    return _float_weights(p, _ATTN_WEIGHTS)


def conv_subsampling(
    p: Params, x: torch.Tensor, activation: str = "relu", fused: bool = False
) -> torch.Tensor:
    """(B, T, mel) → (B, T/8, d_model) (encoder.cpp:208-241). NCHW convs;
    the flatten stays channel-major (C·F), as in the reference. With
    `fused` and an input the reference's guard takes, conv1 → dw1 → conv2
    run as one kernel (ops/subsample.py); dw2, conv3 and proj stay plain
    either way."""
    if not (fused and _subsample_fusable(p, x)):
        return conv_subsampling_stages(p, x, activation)["subsampling_out"]
    act = torch.relu if activation == "relu" else silu
    c = p["conv1_.weight"].shape[0]
    h = fused_subsample_block1(
        x,
        p["conv1_.weight"], p["conv1_.bias"],
        p["dw1_.weight"], p["dw1_.bias"],
        p["conv2_.weight"], p["conv2_.bias"],
        activation=activation,
    )
    h = conv2d(p.sub("dw2_"), h, stride=(2, 2), padding=(1, 1), groups=c)
    h = act(conv2d(p.sub("conv3_"), h))
    return _flatten_proj(p, h)


def feed_forward(
    p: Params, x: torch.Tensor, eps: float, fused: bool = False, final_norm: Params | None = None,
    model=None,
) -> torch.Tensor:
    """Macaron FFN with 0.5 half-step residual (encoder.cpp:39-46), then
    `final_norm` (the block's final LayerNorm) when given. With `fused` and
    T' ≥ _FFN_MIN_FRAMES it runs the fused FFN kernel, the final LayerNorm
    included. model: the 'model' axis over which fc1's rows and fc2's
    columns are split (plain path only; fc2 row-parallel)."""
    if fused and _ffn_fusable(p, x):
        kw = {}
        if final_norm is not None:
            kw = dict(final_norm_w=final_norm["weight"], final_norm_b=final_norm["bias"])
        return fused_feed_forward(
            x,
            p["norm_.weight"], p["norm_.bias"],
            p["fc1_.weight"], p["fc1_.bias"],
            p["fc2_.weight"], p["fc2_.bias"],
            eps=eps, **kw,
        )
    h = layer_norm(p.sub("norm_"), x, eps)
    h = silu(linear(p.sub("fc1_"), h, col_group=model))
    h = linear(p.sub("fc2_"), h, row_group=model)
    x = x + 0.5 * h
    return x if final_norm is None else layer_norm(final_norm, x, eps)


def conv_module(
    p: Params,
    x: torch.Tensor,
    kernel_size: int,
    eps: float,
    pad_mask: torch.Tensor | None = None,
    fused: bool = False,
    lengths: torch.Tensor | None = None,
    model=None,
    seq=None,
) -> torch.Tensor:
    """Pointwise→GLU→depthwise→BN(inference)→SiLU→pointwise, residual
    (encoder.cpp:59-75). pad_mask (B, T) bool, True = padding: those rows
    are zeroed before the depthwise conv so pad garbage cannot reach valid
    frames. With `fused` the conv-module kernel runs instead and masks by
    `lengths` (valid rows per item), taken from pad_mask when not given.
    Plain path on a mesh: model, the axis over which pointwise_conv1's
    channels are split (gathered before the GLU); seq, the axis over which
    the frames are split (x and pad_mask this rank's block; the depthwise
    conv reads (k−1)/2 frames of each neighbour's)."""
    if fused:
        if lengths is None and pad_mask is not None:
            lengths = (~pad_mask).sum(dim=1).to(torch.int32)
        return fused_conv_module(
            x,
            p["norm_.weight"], p["norm_.bias"],
            p["pointwise_conv1_.weight"], p["pointwise_conv1_.bias"],
            p["depthwise_conv_.weight"], p["depthwise_conv_.bias"],
            p["batch_norm_.weight"], p["batch_norm_.bias"],
            p["batch_norm_.running_mean"], p["batch_norm_.running_var"],
            p["pointwise_conv2_.weight"], p["pointwise_conv2_.bias"],
            lengths=lengths, eps=eps,
        )
    d = x.shape[-1]
    h = layer_norm(p.sub("norm_"), x, eps).transpose(1, 2)  # (B, d, T)
    if model is not None and model.split:  # column-parallel pw1, its channels gathered before the GLU
        h = gather_dim(conv1d(p.sub("pointwise_conv1_"), copy_to_model(h, model)).contiguous(), model, 1)
    else:
        h = conv1d(p.sub("pointwise_conv1_"), h)
    h = glu(h, axis=1)
    if pad_mask is not None:
        h = h.masked_fill(pad_mask[:, None, :], 0.0)
    if seq is not None and seq.split:
        h = halo_exchange(h, seq, (kernel_size - 1) // 2, dim=2)
        h = conv1d(p.sub("depthwise_conv_"), h, groups=d)
    else:
        h = conv1d(p.sub("depthwise_conv_"), h, padding=(kernel_size - 1) // 2, groups=d)
    h = batch_norm_1d(p.sub("batch_norm_"), h)
    h = silu(h)
    h = conv1d(p.sub("pointwise_conv2_"), h)
    return x + h.transpose(1, 2)


def _attention(p: Params, x, lengths, norm: Params | None = None, eps: float = 1e-5):
    """K1 on float projections (with the pre-LN and the residual when `norm`
    is given); on quantized ones the reference's fallback, the v1 route
    with the attention core K2."""
    if not _attention_fusable(p):
        if norm is None:
            return rel_position_attention_v1(p, x, lengths)
        return x + rel_position_attention_v1(p, layer_norm(norm, x, eps), lengths)
    mha = p.sub("mha_")
    kw = {}
    if norm is not None:
        kw = dict(norm_w=norm["weight"], norm_b=norm["bias"], eps=eps)
    return rel_attention_block(
        x,
        mha["q_proj.weight"], mha["q_proj.bias"],
        mha["k_proj.weight"], mha["k_proj.bias"],
        mha["v_proj.weight"], mha["v_proj.bias"],
        p["pos_bias_u_"].to(x.dtype), p["pos_bias_v_"].to(x.dtype),
        p["pos_proj_.weight"],
        mha["out_proj.weight"], mha["out_proj.bias"],
        lengths=lengths,
        **kw,
    )


def _head_share(p: Params, x, norm: Params, model):
    """This 'model' rank's share of the attention's replicated inputs: x,
    the LayerNorm and its heads' rows of pos_bias_u/v (which the rules
    keep whole), each through `copy_to_model`, so that their gradients sum
    every rank's heads."""
    hd = p["pos_bias_u_"].shape[1]
    local = p.sub("mha_")["q_proj.weight"].shape[0] // hd
    h0 = model.index * local
    u, v = (copy_to_model(p[k], model)[h0:h0 + local].to(x.dtype) for k in ("pos_bias_u_", "pos_bias_v_"))
    return copy_to_model(x, model), copy_to_model(norm["weight"], model), copy_to_model(norm["bias"], model), u, v


def _attention_heads(p: Params, x, lengths, norm: Params, eps: float, model) -> torch.Tensor:
    """The attention block under tensor parallelism over heads: K1's
    head-sharded mode on this rank's heads, the f32 partials summed over
    'model', then the out-projection's bias and the residual, rounded
    once."""
    mha = p.sub("mha_")
    xs, nw, nb, u, v = _head_share(p, x, norm, model)
    partial = rel_attention_block_heads(
        xs,
        mha["q_proj.weight"], mha["q_proj.bias"],
        mha["k_proj.weight"], mha["k_proj.bias"],
        mha["v_proj.weight"], mha["v_proj.bias"],
        u, v,
        p["pos_proj_.weight"],
        mha["out_proj.weight"],
        lengths=lengths, norm_w=nw, norm_b=nb, eps=eps,
    )
    y = reduce_from_model(partial, model) + mha["out_proj.bias"].to(torch.float32)
    return (x.to(torch.float32) + y).to(x.dtype)


def _attention_seq(p: Params, x, lengths, norm: Params, eps: float, model, seq) -> torch.Tensor:
    """The attention block under sequence parallelism, plain (as the
    reference requires): x is this rank's block of Ts frames; every rank's
    frames are gathered for the keys and values (their gradient
    reduce-scattered back), the queries sit at offset index·Ts in the
    relative shift, and `lengths` (global) mask the keys. K1's plain
    version in its head-sharded mode on this rank's heads (all of them
    without a 'model' axis), the partials summed over 'model', then the
    bias and the residual, as in `_attention_heads`."""
    mha = p.sub("mha_")
    xs, nw, nb, u, v = _head_share(p, x, norm, model)
    partial = rel_attention_block_reference(
        xs,
        mha["q_proj.weight"], mha["q_proj.bias"],
        mha["k_proj.weight"], mha["k_proj.bias"],
        mha["v_proj.weight"], mha["v_proj.bias"],
        u, v,
        p["pos_proj_.weight"],
        mha["out_proj.weight"], None,
        lengths, nw, nb, eps,
        heads_partial=True, x_kv=gather_dim(xs.contiguous(), seq, 1, backward="reduce_scatter"),
        q_offset=seq.index * x.shape[1],
    )
    y = reduce_from_model(partial, model) + mha["out_proj.bias"].to(torch.float32)
    return (x.to(torch.float32) + y).to(x.dtype)


def _is_key_length_mask(mask: torch.Tensor, lengths, t: int) -> bool:
    """Whether the bool attention mask (True = masked, broadcastable to
    (B, 1, T, T)) masks exactly the keys at or past `lengths` on every
    valid query row: what the kernels apply from `lengths` alone (the
    reference's `length_mask` is one). Pad query rows are not read."""
    if lengths is None:
        return False
    lengths = torch.as_tensor(lengths, device=mask.device).clamp(max=t)
    pad = torch.arange(t, device=mask.device)[None, :] >= lengths[:, None]  # (B, T), True = pad
    rows = mask.expand(lengths.shape[0], 1, t, t)[:, 0]
    return bool(((rows == pad[:, None, :]) | pad[:, :, None]).all())


def _masked_attention(p: Params, x: torch.Tensor, pos_emb, num_heads: int, mask) -> torch.Tensor:
    """The reference's XLA attention (models/encoder.py rel_position_attention)
    under any mask: content (q+u)kᵀ plus rel_shift((q+v)Pᵀ) accumulated in
    f32, scaled after the sum, masked entries set to −1e9, an f32 softmax
    rounded to x.dtype, AV accumulated in f32, the out-projection."""
    b, t, d = x.shape
    hd = d // num_heads
    mha = p.sub("mha_")

    def split(y):  # (B, T, D) → (B, H, T, hd)
        return y.view(b, t, num_heads, hd).transpose(1, 2)

    q = split(linear(mha.sub("q_proj"), x))
    k = split(linear(mha.sub("k_proj"), x))
    v = split(linear(mha.sub("v_proj"), x))
    f32 = torch.float32
    bias_u = p["pos_bias_u_"].to(x.dtype)[None, :, None, :]
    bias_v = p["pos_bias_v_"].to(x.dtype)[None, :, None, :]
    content = (q + bias_u).to(f32) @ k.to(f32).transpose(-1, -2)
    if pos_emb is None:
        pos_emb = position_table(t, d, x.device, x.dtype)
    pos = linear(p.sub("pos_proj_"), pos_emb.to(device=x.device, dtype=x.dtype))
    pos = pos.view(2 * t - 1, num_heads, hd).transpose(0, 1)  # (H, 2T−1, hd)
    raw = (q + bias_v).to(f32) @ pos.to(f32).transpose(-1, -2)  # (B, H, T, 2T−1)
    rows = torch.arange(t, device=x.device)
    shift = (t - 1 - rows[:, None] + rows[None, :]).expand(b, num_heads, t, t)  # rel_shift as an index
    scores = (content + raw.gather(-1, shift)) * (1.0 / math.sqrt(hd))
    scores = scores.masked_fill(mask.to(torch.bool), -1e9)
    attn = torch.softmax(scores, dim=-1).to(x.dtype)
    out = (attn.to(f32) @ v.to(f32)).to(x.dtype)
    return linear(mha.sub("out_proj"), out.transpose(1, 2).reshape(b, t, d))


def rel_position_attention(
    p: Params,
    x: torch.Tensor,
    pos_emb: torch.Tensor | None,
    num_heads: int,
    mask: torch.Tensor | None = None,
    lengths: torch.Tensor | None = None,
) -> torch.Tensor:
    """NeMo-style relative-position MHSA (encoder.cpp:112-181) on an
    already-normed input: content (q+u)kᵀ plus rel_shift((q+v)Pᵀ), scaled,
    masked. `p` is the attention prefix (…attn_); the arguments are the
    reference's: `pos_emb` the (2T−1, d) sinusoidal table, `mask` (B, 1,
    T, T) bool, True = masked, `lengths` (B,) valid frames.

    With no mask, or a mask that masks the keys past `lengths`
    (`_is_key_length_mask`, as the reference's `length_mask` does), the
    attention kernel runs (K1; K2 on quantized projections) with its own
    position table; any other mask takes the plain route, the mask applied
    as the reference applies it, on `pos_emb` (built when None)."""
    heads = p["pos_bias_u_"].shape[0]
    if num_heads != heads:
        raise ValueError(f"num_heads={num_heads} but the weights hold {heads} heads")
    if mask is not None and not _is_key_length_mask(mask, lengths, x.shape[1]):
        return _masked_attention(p, x, pos_emb, num_heads, mask)
    return _attention(p, x, lengths)


def rel_position_attention_v1(
    p: Params, x: torch.Tensor, lengths: torch.Tensor | None = None
) -> torch.Tensor:
    """The reference's v1 attention (models/encoder.py:597-625) on an
    already-normed input: q/k/v and the position table projected in torch,
    q+u and q+v rounded to x.dtype, the core as the v1 kernel
    (`fused_rel_attention`: scale after the sum, softmax normalised before
    AV), out-projection in torch. `p` is the attention prefix (…attn_)."""
    b, t, d = x.shape
    heads, hd = p["pos_bias_u_"].shape
    mha = p.sub("mha_")

    def split(y):  # (B, T, D) → (B, H, T, hd)
        return y.view(b, t, heads, hd).transpose(1, 2)

    q = split(linear(mha.sub("q_proj"), x))
    k = split(linear(mha.sub("k_proj"), x))
    v = split(linear(mha.sub("v_proj"), x))
    bias_u = p["pos_bias_u_"].to(x.dtype)[None, :, None, :]
    bias_v = p["pos_bias_v_"].to(x.dtype)[None, :, None, :]
    pe = position_table(t, d, x.device, x.dtype)
    pos = linear(p.sub("pos_proj_"), pe).view(2 * t - 1, heads, hd).transpose(0, 1)  # (H, 2T−1, hd)
    out = fused_rel_attention(q + bias_u, q + bias_v, k, v, pos, lengths)
    return linear(mha.sub("out_proj"), out.transpose(1, 2).reshape(b, t, d))


def conformer_block(
    p: Params,
    x: torch.Tensor,
    pos_emb: torch.Tensor | None,
    cfg: EncoderConfig,
    mask: torch.Tensor | None = None,
    pad_mask: torch.Tensor | None = None,
    lengths: torch.Tensor | None = None,
    *,
    fused: FusedLayers = FusedLayers(),
    split: EncoderSplit | None = None,
    whole: Params | None = None,
) -> torch.Tensor:
    """ffn1 → attn → conv → ffn2 → final LayerNorm (encoder.cpp:196-204),
    on the reference's arguments (`pos_emb`, `mask`, `pad_mask`, `lengths`:
    see `rel_position_attention`; the encoder passes pos_emb and mask as
    None, its kernels masking by `lengths`). A mask that is not a
    key-length mask sends the attention to the plain route with that mask
    (and ffn1 as fused.ffn says, as when the reference's "mega" guard
    refuses); the rest of the block is unchanged.

    The sublayers run the kernels chosen by `fused` with the reference's
    precedence (models/encoder.py:663-744): attention "mega" runs ffn1 and
    the attention as K7; otherwise ffn1 follows fused.ffn and the attention is
    K1 with the pre-LN and residual fused ("block") or LN, projections and
    out-projection in torch around K2 ("v1"). block2 runs the conv module,
    ffn2 and the final LayerNorm as K4; otherwise the conv module follows
    fused.conv and ffn2 fused.ffn, the final LayerNorm inside ffn2's
    kernel when it is fused, as in the reference. Below the FFN guard
    (T' < _FFN_MIN_FRAMES) "mega" and block2 give way as there: ffn1 and
    ffn2 plain, the attention as K1, the conv module as fused.conv says.

    On a mesh (`split`; p this rank's shards, `whole` the layer's whole
    weights): the plain sublayers and K1 run split as the module note
    says, the other kernels on `whole`, replicated over 'model'."""
    eps = cfg.layer_norm_eps
    a = p.sub("attn_")
    model = seq = None
    if split is not None:
        model, seq = split.model, split.seq
    masked = mask is not None and not _is_key_length_mask(mask, lengths, x.shape[1])
    if masked and ((model is not None and model.split) or (seq is not None and seq.split)):
        raise ValueError("a mask other than the key-length mask runs only without a 'model' or 'seq' split")
    w = p if whole is None else whole  # the kernels other than K1 take whole weights
    if (fused.attention == "mega" and not masked and _ffn_fusable(p.sub("ffn1_"), x)
            and _attention_fusable(a)):
        f, a, mha = w.sub("ffn1_"), w.sub("attn_"), w.sub("attn_").sub("mha_")
        x = fused_ffn_attention(
            x,
            f["norm_.weight"], f["norm_.bias"],
            f["fc1_.weight"], f["fc1_.bias"],
            f["fc2_.weight"], f["fc2_.bias"],
            a["norm_.weight"], a["norm_.bias"],
            mha["q_proj.weight"], mha["q_proj.bias"],
            mha["k_proj.weight"], mha["k_proj.bias"],
            mha["v_proj.weight"], mha["v_proj.bias"],
            a["pos_bias_u_"].to(x.dtype), a["pos_bias_v_"].to(x.dtype),
            a["pos_proj_.weight"],
            mha["out_proj.weight"], mha["out_proj.bias"],
            lengths=lengths, eps=eps,
        )
    else:
        x = _feed_forward_on(p, w, "ffn1_", x, eps, fused.ffn, None, model)
        if masked:
            x = x + _masked_attention(a, layer_norm(a.sub("norm_"), x, eps), pos_emb, cfg.num_heads, mask)
        elif fused.attention == "v1":
            x = x + rel_position_attention_v1(w.sub("attn_"), layer_norm(a.sub("norm_"), x, eps), lengths)
        elif seq is not None and seq.split:
            x = _attention_seq(a, x, lengths, a.sub("norm_"), eps, model, seq)
        elif model is not None and model.split and _attention_fusable(a):
            x = _attention_heads(a, x, lengths, a.sub("norm_"), eps, model)
        else:
            x = _attention(w.sub("attn_"), x, lengths, norm=a.sub("norm_"), eps=eps)
    if fused.block2 and _ffn_fusable(p.sub("ffn2_"), x):
        c, f = w.sub("conv_"), w.sub("ffn2_")
        if lengths is None and pad_mask is not None:
            lengths = (~pad_mask).sum(dim=1).to(torch.int32)
        return fused_conv_ffn_final(
            x,
            c["norm_.weight"], c["norm_.bias"],
            c["pointwise_conv1_.weight"], c["pointwise_conv1_.bias"],
            c["depthwise_conv_.weight"], c["depthwise_conv_.bias"],
            c["batch_norm_.weight"], c["batch_norm_.bias"],
            c["batch_norm_.running_mean"], c["batch_norm_.running_var"],
            c["pointwise_conv2_.weight"], c["pointwise_conv2_.bias"],
            f["norm_.weight"], f["norm_.bias"],
            f["fc1_.weight"], f["fc1_.bias"],
            f["fc2_.weight"], f["fc2_.bias"],
            p["final_norm_.weight"], p["final_norm_.bias"],
            lengths=lengths, eps=eps,
        )
    if fused.conv:
        x = conv_module(w.sub("conv_"), x, cfg.conv_kernel_size, eps, pad_mask, fused=True, lengths=lengths)
    else:
        x = conv_module(p.sub("conv_"), x, cfg.conv_kernel_size, eps, pad_mask, model=model, seq=seq)
    return _feed_forward_on(p, w, "ffn2_", x, eps, fused.ffn, p.sub("final_norm_"), model)


def _feed_forward_on(p: Params, whole: Params, name: str, x, eps: float, fused: bool, final_norm, model):
    """An FFN of the block: its kernel on the whole weights when `fused` and
    the reference's guard take it, else the plain path on this rank's
    shards (fc2 row-parallel over `model`)."""
    if fused and _ffn_fusable(whole.sub(name), x):
        return feed_forward(whole.sub(name), x, eps, fused=True, final_norm=final_norm)
    return feed_forward(p.sub(name), x, eps, final_norm=final_norm, model=model)


def length_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(B,) valid encoder-frame counts → (B, 1, T, T) bool attention mask,
    True = masked: the dense form the reference's XLA attention takes. The
    port's attention masks by key length instead, which gives the same
    valid rows."""
    valid = torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]
    return ~(valid[:, None, :] & valid[:, :, None])[:, None, :, :]


def encode_prologue(
    p: Params,
    cfg: EncoderConfig,
    features: torch.Tensor,
    lengths: torch.Tensor | None = None,
    fused: FusedLayers = FusedLayers(),
):
    """Subsampling (+xscaling) and the padding masks.
    Returns (x, pad_mask, enc_lengths)."""
    activation = getattr(cfg, "subsampling_activation", "relu")
    x = conv_subsampling(p.sub("subsampling_"), features, activation, fused=fused.subsample)
    if getattr(cfg, "xscaling", False):
        x = x * math.sqrt(cfg.hidden_size)
    t = x.shape[1]
    pad_mask = enc_lengths = None
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=x.device)
        enc_lengths = torch.clamp(encoded_lengths(lengths), max=t).to(torch.int32)
        pad_mask = torch.arange(t, device=x.device)[None, :] >= enc_lengths[:, None]
    return x, pad_mask, enc_lengths


def fastconformer_encode(
    p: Params,
    cfg: EncoderConfig,
    features: torch.Tensor,
    lengths: torch.Tensor | None = None,
    fused: FusedLayers = FusedLayers(),
    remat: bool = False,
    split: EncoderSplit | None = None,
) -> torch.Tensor:
    """(B, T, mel) → (B, T', d_model) (encoder.cpp:245-271). `p` is the
    view at the encoder prefix; `lengths` optional per-item mel frames;
    `fused` picks the sublayers that run their fused kernels. `remat`, a
    training-memory lever: each conformer block runs under
    torch.utils.checkpoint, so backward keeps only the block inputs and
    recomputes the rest (K1 launches again); the blocks then run
    `FusedLayers()`, as the reference's remat forces its XLA layers.

    `split`: the call's split over a mesh (`EncoderSplit`; `p` then holds
    this rank's shards). With a 'seq' axis the subsampled frames are
    padded to a multiple of the axis, each rank runs the blocks on its
    block of them, and the output is gathered: every rank returns the
    whole (B, T', d_model). `remat` on a split checkpoints each block with
    the split, whose collectives run again in the recompute."""
    if features.is_cuda:
        require_ieee_f32()
    x, pad_mask, enc_lengths = encode_prologue(p, cfg, features, lengths, fused)
    layers = p.sub("layers_")
    t = x.shape[1]
    seq = None if split is None else split.seq
    if seq is not None and seq.split:
        if enc_lengths is None:
            enc_lengths = torch.full((x.shape[0],), t, dtype=torch.int32, device=x.device)
        ts = -(-t // seq.size)
        x = torch.nn.functional.pad(x, (0, 0, 0, ts * seq.size - t))
        lo = seq.index * ts
        x = x[:, lo:lo + ts]
        pad_mask = torch.arange(lo, lo + ts, device=x.device)[None, :] >= enc_lengths[:, None]
    whole = None if split is None or split.full is None else split.full.sub("layers_")
    for i in range(cfg.num_layers):
        if remat:
            x = torch.utils.checkpoint.checkpoint(conformer_block, layers.sub(str(i)), x, None, cfg, None,
                                                  pad_mask, enc_lengths, fused=FusedLayers(), split=split,
                                                  use_reentrant=False)
        else:
            x = conformer_block(layers.sub(str(i)), x, None, cfg, None, pad_mask, enc_lengths, fused=fused,
                                split=split, whole=None if whole is None else whole.sub(str(i)))
    if seq is not None and seq.split:
        x = gather_dim(x.contiguous(), seq, 1)[:, :t]
    return x


__all__ = [
    "ATTENTION_MODES",
    "EncoderSplit",
    "FusedLayers",
    "sinusoidal_position_embedding",
    "subsample_length",
    "encoded_lengths",
    "conv_subsampling_stages",
    "conv_subsampling",
    "feed_forward",
    "conv_module",
    "rel_position_attention",
    "rel_position_attention_v1",
    "conformer_block",
    "length_mask",
    "encode_prologue",
    "fastconformer_encode",
]
