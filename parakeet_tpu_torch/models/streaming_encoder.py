"""Streaming FastConformer encoder with fixed-shape rolling caches (port of
parakeet_tpu/models/streaming_encoder.py).

Every cache keeps a static shape, so a chunk of any latency mode {0, 1, 6,
13} runs the same sequence of torch ops:

  * KV cache: (L, B, H, left, hd), right-aligned: slot left-1 is the most
    recent pre-chunk frame, and a per-item `valid` counter counts the
    filled slots. With this alignment the reference's warm-up dependent
    position-bias slice reduces to the static, query-independent mapping
    pos_score[:, qi, ki] = (q+v)·P[tc-1+ki] (tc = left + chunk).
  * attention mask: dist = (left + qi) - ki; masked where dist > left,
    -dist > right or ki names an unfilled cache slot; filled with -1e9.
  * conv cache: (L, B, d, k-1) of post-GLU activations, zeros at first
    (the reference's first-chunk zero pad).
  * mel remainder for the subsampling stays on the host (0-7 frames):
    each chunk consumes floor(total/8)·8 frames.

The cached attention applies no rel_shift, as in the reference's cached
path; the offline encoder's does. It runs no kernel: its position mapping
is static and its keys span the cache, which K1 and K2 do not compute, and
the subsampling and FFNs run plain as the reference's guards send chunk
sizes (T4 < 32, T' < 64).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from parakeet_tpu_torch.config import StreamingEncoderConfig
from parakeet_tpu_torch.models.encoder import conv_subsampling, feed_forward
from parakeet_tpu_torch.ops.layers import batch_norm_1d, conv1d, glu, layer_norm, linear, require_ieee_f32, silu
from parakeet_tpu_torch.ops.rel_attention import position_table
from parakeet_tpu_torch.params import Params, is_norm_param

_F32 = torch.float32
_NEG_INF = -1e9


def encoder_compute_dtype(params: dict, prefix: str = "encoder_", default: torch.dtype = _F32) -> torch.dtype:
    """The streaming encoder's compute dtype: the dtype of the first
    floating weight under `prefix`. Keys holding "##" (quantization
    sidecars such as "##scale", f32 whatever the compute dtype) and
    normalisation parameters (kept f32 under bf16) are skipped, so a bf16
    session gets bf16 whatever order the dict has. It sets the dtype of the
    mel cast and of the caches: an f32 cache around bf16 weights would
    promote every K/V concatenation back to f32."""
    return next(
        (v.dtype for k, v in params.items()
         if k.startswith(prefix) and "##" not in k and not is_norm_param(k) and v.is_floating_point()),
        default,
    )


def init_encoder_cache(
    cfg: StreamingEncoderConfig, batch: int, dtype: torch.dtype = _F32, device: str | torch.device = "cpu"
) -> dict:
    """Fixed-shape caches: conv (L, B, d, k-1), key and value (L, B, H,
    left, hd), and valid (B,) filled KV slots (≤ left)."""
    l, d, h = cfg.num_layers, cfg.hidden_size, cfg.num_heads
    hd = d // h
    left, k = cfg.att_context_left, cfg.conv_kernel_size
    return {
        "conv": torch.zeros((l, batch, d, k - 1), dtype=dtype, device=device),
        "key": torch.zeros((l, batch, h, left, hd), dtype=dtype, device=device),
        "value": torch.zeros((l, batch, h, left, hd), dtype=dtype, device=device),
        "valid": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def _matmul_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with float32 accumulation (bf16 products are exact in f32)."""
    return torch.matmul(a.to(_F32), b.to(_F32))


def _streaming_attention(
    p: Params,
    x: torch.Tensor,  # (B, chunk, d), already layer-normed
    pos_tail: torch.Tensor,  # (tc, d): P rows tc-1 … 2tc-2 (positions 0 … -(tc-1))
    k_cache: torch.Tensor,  # (B, H, left, hd)
    v_cache: torch.Tensor,
    valid: torch.Tensor,  # (B,) int32 filled cache slots
    num_heads: int,
    att_left: int,
    att_right: int,
):
    b, chunk, d = x.shape
    hd = d // num_heads
    scale = 1.0 / math.sqrt(hd)
    mha = p.sub("mha_")

    def split(t):
        return t.reshape(b, chunk, num_heads, hd).transpose(1, 2)

    q = split(linear(mha.sub("q_proj"), x))
    k_new = split(linear(mha.sub("k_proj"), x))
    v_new = split(linear(mha.sub("v_proj"), x))

    k_full = torch.cat([k_cache, k_new], dim=2)  # (B, H, tc, hd)
    v_full = torch.cat([v_cache, v_new], dim=2)
    tc = k_full.shape[2]
    left = k_cache.shape[2]
    new_k_cache = k_full[:, :, tc - left:] if left > 0 else k_cache
    new_v_cache = v_full[:, :, tc - left:] if left > 0 else v_cache

    bias_u = p["pos_bias_u_"].to(x.dtype)[None, :, None, :]
    bias_v = p["pos_bias_v_"].to(x.dtype)[None, :, None, :]
    content = _matmul_f32(q + bias_u, k_full.transpose(-1, -2))  # (B, H, chunk, tc)
    # the query-independent position bias (module docstring)
    pproj = linear(p.sub("pos_proj_"), pos_tail.to(x.dtype))  # (tc, d)
    pproj = pproj.reshape(tc, num_heads, hd).transpose(0, 1)  # (H, tc, hd)
    pos_score = _matmul_f32(q + bias_v, pproj.transpose(-1, -2))
    scores = (content + pos_score) * scale

    qi = torch.arange(chunk, device=x.device)[:, None]
    ki = torch.arange(tc, device=x.device)[None, :]
    dist = (left + qi) - ki
    mask = (dist > att_left) | (-dist > att_right)  # (chunk, tc)
    unfilled = ki[None] < (left - valid.to(torch.int64))[:, None, None]  # (B, 1, tc)
    scores = scores.masked_fill(mask[None, None] | unfilled[:, None], _NEG_INF)

    attn = torch.softmax(scores, dim=-1).to(x.dtype)
    out = _matmul_f32(attn, v_full).to(x.dtype)
    out = out.transpose(1, 2).reshape(b, chunk, d)
    return linear(mha.sub("out_proj"), out), new_k_cache, new_v_cache


def _causal_conv_module(p: Params, x: torch.Tensor, conv_cache: torch.Tensor, kernel_size: int, eps: float):
    """Causal conv module with the cache prepended (streaming_encoder.cpp:41-78)."""
    d = x.shape[-1]
    h = layer_norm(p.sub("norm_"), x, eps).transpose(1, 2)  # (B, d, chunk)
    h = glu(conv1d(p.sub("pointwise_conv1_"), h), axis=1)
    h = torch.cat([conv_cache, h], dim=2)  # (B, d, k-1+chunk)
    new_cache = h[:, :, h.shape[2] - (kernel_size - 1):]
    h = conv1d(p.sub("depthwise_conv_"), h, groups=d)  # VALID → (B, d, chunk)
    h = silu(batch_norm_1d(p.sub("batch_norm_"), h))
    h = conv1d(p.sub("pointwise_conv2_"), h)
    return x + h.transpose(1, 2), new_cache


def _streaming_block(p: Params, x: torch.Tensor, pos_tail: torch.Tensor, cache_slice: tuple,
                     cfg: StreamingEncoderConfig):
    conv_c, k_c, v_c, valid = cache_slice
    eps = cfg.layer_norm_eps
    x = feed_forward(p.sub("ffn1_"), x, eps)
    attn_in = layer_norm(p.sub("attn_").sub("norm_"), x, eps)
    attn_out, k_c, v_c = _streaming_attention(
        p.sub("attn_"), attn_in, pos_tail, k_c, v_c, valid,
        cfg.num_heads, cfg.att_context_left, cfg.att_context_right,
    )
    x = x + attn_out
    x, conv_c = _causal_conv_module(p.sub("conv_"), x, conv_c, cfg.conv_kernel_size, eps)
    x = feed_forward(p.sub("ffn2_"), x, eps, final_norm=p.sub("final_norm_"))
    return x, (conv_c, k_c, v_c)


@torch.inference_mode()
def streaming_encoder_chunk(
    params: dict, mel: torch.Tensor, cache: dict, *, cfg: StreamingEncoderConfig, prefix: str = "encoder_"
) -> tuple[torch.Tensor, dict]:
    """One chunk through the streaming encoder: mel (B, Tmel, mel_bins) with
    Tmel divisible by 8 (the session guarantees it) → (enc (B, Tmel/8, d),
    new cache). Runs at the encoder weights' dtype: the streaming mel is
    f32, so a bf16 session casts it (encoder_compute_dtype)."""
    if mel.is_cuda:
        require_ieee_f32()
    p = Params(params).sub(prefix)
    wdt = encoder_compute_dtype(params, prefix, mel.dtype)
    x = conv_subsampling(p.sub("subsampling_"), mel.to(wdt), cfg.subsampling_activation)
    if cfg.xscaling:
        x = x * math.sqrt(cfg.hidden_size)

    chunk = x.shape[1]
    tc = cfg.att_context_left + chunk
    # P rows tc-1 … 2tc-2 ↔ relative positions 0 … -(tc-1)
    pos_tail = position_table(tc, cfg.hidden_size, x.device, _F32)[tc - 1:]

    layers = p.sub("layers_")
    new_conv, new_k, new_v = [], [], []
    for i in range(cfg.num_layers):
        x, (cc, kc, vc) = _streaming_block(
            layers.sub(str(i)), x, pos_tail,
            (cache["conv"][i], cache["key"][i], cache["value"][i], cache["valid"]), cfg,
        )
        new_conv.append(cc)
        new_k.append(kc)
        new_v.append(vc)
    new_cache = {
        "conv": torch.stack(new_conv),
        "key": torch.stack(new_k),
        "value": torch.stack(new_v),
        "valid": torch.clamp(cache["valid"] + chunk, max=cfg.att_context_left),
    }
    return x, new_cache


@dataclass
class StreamingEncoderSession:
    """Host wrapper: the mel remainder on the host and one chunk step per
    call (the reference's StreamingFastConformerEncoder::forward_chunk).
    Runs on the device the weights are on."""

    params: dict
    cfg: StreamingEncoderConfig
    batch: int = 1
    prefix: str = "encoder_"

    def __post_init__(self):
        self.device = next(v.device for k, v in self.params.items() if k.startswith(self.prefix))
        self.reset()

    def reset(self) -> None:
        # the caches follow the weights' dtype, so bf16 sessions keep bf16 K/V
        wdt = encoder_compute_dtype(self.params, self.prefix)
        self.cache = init_encoder_cache(self.cfg, self.batch, wdt, self.device)
        self._mel_rem = np.zeros((self.batch, 0, self.cfg.mel_bins), np.float32)
        self.frames_seen = 0

    def forward_chunk(self, mel_chunk) -> torch.Tensor | None:
        """(B, T, mel) → (B, T'/8, d), or None while under 8 mel frames are
        buffered."""
        if isinstance(mel_chunk, torch.Tensor):
            mel_chunk = mel_chunk.detach().cpu().numpy()
        mel = np.concatenate([self._mel_rem, np.asarray(mel_chunk, np.float32)], axis=1)
        consumable = (mel.shape[1] // 8) * 8
        if consumable == 0:
            self._mel_rem = mel
            return None
        self._mel_rem = mel[:, consumable:]
        out, self.cache = streaming_encoder_chunk(
            self.params, torch.from_numpy(np.ascontiguousarray(mel[:, :consumable])).to(self.device),
            self.cache, cfg=self.cfg, prefix=self.prefix,
        )
        self.frames_seen += out.shape[1]
        return out


__all__ = [
    "encoder_compute_dtype",
    "init_encoder_cache",
    "streaming_encoder_chunk",
    "StreamingEncoderSession",
]
