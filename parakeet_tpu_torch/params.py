"""Parameter schema, initialization, and loading (port of parakeet_tpu/params.py).

Parameters are a FLAT dict keyed by the reference converter's safetensors
names (e.g. ``encoder_.layers_.0.attn_.mha_.q_proj.weight``), so the JAX
reference and the port read one schema. The spec functions below produce the
same keys and shapes as the reference's (tests hold them equal); weights keep
torch layout (Linear (out, in), Conv (out, in/groups, *k)).

Random init draws from a numpy RandomState in sorted key order, exactly like
the reference, so both packages build identical weights from one seed.
`params_from_numpy` carries a flat numpy dict onto a device; `device_params`
casts, quantizes (quantize.py) and carries, in the reference's order.
Quantized checkpoints dequantise on load.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from parakeet_tpu_torch.config import (
    EncoderConfig,
    JointConfig,
    PredictionConfig,
    SortformerConfig,
    TransformerConfig,
)
from parakeet_tpu_torch.io.safetensors import load_safetensors


class Params:
    """Read-only prefix view over a flat {name: tensor} dict."""

    __slots__ = ("data", "prefix")

    def __init__(self, data: dict, prefix: str = ""):
        self.data = data
        self.prefix = prefix

    def __getitem__(self, key: str):
        return self.data[self.prefix + key]

    def __contains__(self, key: str) -> bool:
        return (self.prefix + key) in self.data

    def get(self, key: str, default=None):
        return self.data.get(self.prefix + key, default)

    def sub(self, name: str) -> "Params":
        return Params(self.data, f"{self.prefix}{name}.")

    def __repr__(self):
        return f"Params(prefix={self.prefix!r}, {len(self.data)} tensors)"


# ─── Spec functions ──────────────────────────────────────────────────────────
# A spec is {key: (shape, kind)}; `kind` selects the initializer.
# Kinds: w (fan-in scaled normal), b (zeros), norm_w (ones), norm_b (zeros),
#        bn_mean (zeros), bn_var (ones), emb (normal 0.02), bias_param (small).

Spec = dict[str, tuple[tuple[int, ...], str]]


def _linear(spec: Spec, name: str, out_dim: int, in_dim: int, bias: bool = True) -> None:
    spec[f"{name}.weight"] = ((out_dim, in_dim), "w")
    if bias:
        spec[f"{name}.bias"] = ((out_dim,), "b")


def _conv2d(spec: Spec, name: str, out_ch: int, in_ch: int, k: int = 3) -> None:
    spec[f"{name}.weight"] = ((out_ch, in_ch, k, k), "w")
    spec[f"{name}.bias"] = ((out_ch,), "b")


def _conv1d(spec: Spec, name: str, out_ch: int, in_ch: int, k: int) -> None:
    spec[f"{name}.weight"] = ((out_ch, in_ch, k), "w")
    spec[f"{name}.bias"] = ((out_ch,), "b")


def _norm(spec: Spec, name: str, dim: int) -> None:
    spec[f"{name}.weight"] = ((dim,), "norm_w")
    spec[f"{name}.bias"] = ((dim,), "norm_b")


def subsampled_freq(mel_bins: int) -> int:
    """Frequency dim after three k3/s2/p1 convs: (f - 1)//2 + 1, thrice."""
    f = mel_bins
    for _ in range(3):
        f = (f - 1) // 2 + 1
    return f


def encoder_spec(cfg: EncoderConfig, prefix: str = "encoder_") -> Spec:
    """FastConformer encoder schema (convert_nemo.py:98-184)."""
    spec: Spec = {}
    d = cfg.hidden_size
    c = cfg.subsampling_channels
    sub = f"{prefix}.subsampling_"

    _conv2d(spec, f"{sub}.conv1_", c, 1, 3)
    spec[f"{sub}.dw1_.weight"] = ((c, 1, 3, 3), "w")
    spec[f"{sub}.dw1_.bias"] = ((c,), "b")
    _conv2d(spec, f"{sub}.conv2_", c, c, 1)
    spec[f"{sub}.dw2_.weight"] = ((c, 1, 3, 3), "w")
    spec[f"{sub}.dw2_.bias"] = ((c,), "b")
    _conv2d(spec, f"{sub}.conv3_", c, c, 1)
    _linear(spec, f"{sub}.proj_", d, c * subsampled_freq(cfg.mel_bins))

    head_dim = d // cfg.num_heads
    for i in range(cfg.num_layers):
        a = f"{prefix}.layers_.{i}"
        _norm(spec, f"{a}.ffn1_.norm_", d)
        _linear(spec, f"{a}.ffn1_.fc1_", cfg.ffn_intermediate, d)
        _linear(spec, f"{a}.ffn1_.fc2_", d, cfg.ffn_intermediate)
        _norm(spec, f"{a}.attn_.norm_", d)
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(spec, f"{a}.attn_.mha_.{p}", d, d)
        spec[f"{a}.attn_.pos_proj_.weight"] = ((d, d), "w")  # bias-free
        spec[f"{a}.attn_.pos_bias_u_"] = ((cfg.num_heads, head_dim), "bias_param")
        spec[f"{a}.attn_.pos_bias_v_"] = ((cfg.num_heads, head_dim), "bias_param")
        _norm(spec, f"{a}.conv_.norm_", d)
        _conv1d(spec, f"{a}.conv_.pointwise_conv1_", 2 * d, d, 1)
        spec[f"{a}.conv_.depthwise_conv_.weight"] = ((d, 1, cfg.conv_kernel_size), "w")
        spec[f"{a}.conv_.depthwise_conv_.bias"] = ((d,), "b")
        spec[f"{a}.conv_.batch_norm_.weight"] = ((d,), "norm_w")
        spec[f"{a}.conv_.batch_norm_.bias"] = ((d,), "norm_b")
        spec[f"{a}.conv_.batch_norm_.running_mean"] = ((d,), "bn_mean")
        spec[f"{a}.conv_.batch_norm_.running_var"] = ((d,), "bn_var")
        _conv1d(spec, f"{a}.conv_.pointwise_conv2_", d, d, 1)
        _norm(spec, f"{a}.ffn2_.norm_", d)
        _linear(spec, f"{a}.ffn2_.fc1_", cfg.ffn_intermediate, d)
        _linear(spec, f"{a}.ffn2_.fc2_", d, cfg.ffn_intermediate)
        _norm(spec, f"{a}.final_norm_", d)
    return spec


def prediction_spec(cfg: PredictionConfig, prefix: str = "prediction_") -> Spec:
    """RNNT prediction net schema: input_proj_ carries the merged NeMo bias,
    hidden_proj_ is bias-free (lstm.cpp:7, convert_nemo.py:409-417)."""
    spec: Spec = {}
    ph = cfg.pred_hidden
    spec[f"{prefix}.embed_.weight"] = ((cfg.vocab_size, ph), "emb")
    for l in range(cfg.num_lstm_layers):
        cell = f"{prefix}.lstm_.cells_.{l}"
        _linear(spec, f"{cell}.input_proj_", 4 * ph, ph)
        spec[f"{cell}.hidden_proj_.weight"] = ((4 * ph, ph), "w")
    return spec


def tdt_joint_spec(cfg: JointConfig, num_durations: int, prefix: str = "tdt_joint_") -> Spec:
    """TDT dual-head joint schema (tdt.cpp:9-24, convert_nemo.py:421-446)."""
    spec: Spec = {}
    jh = cfg.joint_hidden
    _linear(spec, f"{prefix}.enc_proj_", jh, cfg.encoder_hidden)
    spec[f"{prefix}.pred_proj_.weight"] = ((jh, cfg.pred_hidden), "w")  # bias-free
    _linear(spec, f"{prefix}.label_proj_", cfg.vocab_size, jh)
    _linear(spec, f"{prefix}.duration_proj_", num_durations, jh)
    return spec


def rnnt_joint_spec(cfg: JointConfig, prefix: str = "joint_") -> Spec:
    """RNNT single-head joint schema (rnnt.cpp:32-44)."""
    spec: Spec = {}
    jh = cfg.joint_hidden
    _linear(spec, f"{prefix}.enc_proj_", jh, cfg.encoder_hidden)
    spec[f"{prefix}.pred_proj_.weight"] = ((jh, cfg.pred_hidden), "w")
    _linear(spec, f"{prefix}.out_proj_", cfg.vocab_size, jh)
    return spec


def ctc_spec(vocab_size: int, encoder_hidden: int, prefix: str = "ctc_decoder_") -> Spec:
    """CTC head: 1×1 Conv1d (ctc.cpp:10-25)."""
    spec: Spec = {}
    _conv1d(spec, f"{prefix}.proj_", vocab_size, encoder_hidden, 1)
    return spec


def transformer_spec(cfg: TransformerConfig, prefix: str = "transformer_") -> Spec:
    """Sortformer transformer head schema (convert_nemo.py:241-265)."""
    spec: Spec = {}
    d = cfg.hidden_size
    for i in range(cfg.num_layers):
        a = f"{prefix}.layers_.{i}"
        _norm(spec, f"{a}.norm1_", d)
        _norm(spec, f"{a}.norm2_", d)
        for p in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(spec, f"{a}.mha_.{p}", d, d)
        _linear(spec, f"{a}.fc1_", cfg.ffn_intermediate, d)
        _linear(spec, f"{a}.fc2_", d, cfg.ffn_intermediate)
    if cfg.has_final_norm:
        _norm(spec, f"{prefix}.final_norm_", d)
    return spec


# ─── Full-model specs ────────────────────────────────────────────────────────


def tdt_ctc_spec(cfg) -> Spec:
    spec = encoder_spec(cfg.encoder, "encoder_")
    spec.update(prediction_spec(cfg.prediction, "prediction_"))
    spec.update(tdt_joint_spec(cfg.joint, len(cfg.durations), "tdt_joint_"))
    spec.update(ctc_spec(cfg.ctc_vocab_size, cfg.encoder.hidden_size, "ctc_decoder_"))
    return spec


def tdt_spec(cfg) -> Spec:
    spec = encoder_spec(cfg.encoder, "encoder_")
    spec.update(prediction_spec(cfg.prediction, "prediction_"))
    spec.update(tdt_joint_spec(cfg.joint, len(cfg.durations), "joint_"))
    return spec


def rnnt_spec(cfg) -> Spec:
    spec = encoder_spec(cfg.encoder, "encoder_")
    spec.update(prediction_spec(cfg.prediction, "prediction_"))
    spec.update(rnnt_joint_spec(cfg.joint, "joint_"))
    return spec


def eou_spec(cfg) -> Spec:
    return tdt_ctc_spec(cfg) if hasattr(cfg, "ctc_vocab_size") else tdt_spec(cfg)


def nemotron_spec(cfg) -> Spec:
    return tdt_spec(cfg)


def sortformer_spec(cfg: SortformerConfig) -> Spec:
    spec = encoder_spec(cfg.nest_encoder, "nest_encoder_")
    _linear(spec, "projection_", cfg.transformer_hidden, cfg.encoder_hidden)
    spec.update(transformer_spec(cfg.transformer, "transformer_"))
    _linear(spec, "first_hidden_", cfg.transformer_hidden, cfg.transformer_hidden)
    _linear(spec, "output_proj_", cfg.max_speakers, cfg.transformer_hidden)
    # registered-but-unused concat path, kept for state_dict compatibility
    _linear(spec, "hidden_to_spks_", cfg.max_speakers, 2 * cfg.transformer_hidden)
    return spec


# ─── Initialization / loading ───────────────────────────────────────────────


def init_params_numpy(spec: Spec, seed: int = 0) -> dict[str, np.ndarray]:
    """Random-init a flat float32 numpy dict from a spec. Same draws, in the
    same (sorted-key) order, as the reference's init_params."""
    rng = np.random.RandomState(seed)
    out: dict[str, np.ndarray] = {}
    for key in sorted(spec):
        shape, kind = spec[key]
        if kind == "w":
            fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
            arr = rng.normal(0.0, 1.0 / np.sqrt(max(fan_in, 1)), size=shape)
        elif kind in ("emb", "bias_param"):
            arr = rng.normal(0.0, 0.02, size=shape)
        elif kind in ("b", "norm_b", "bn_mean"):
            arr = np.zeros(shape)
        elif kind in ("norm_w", "bn_var"):
            arr = np.ones(shape)
        else:  # pragma: no cover
            raise ValueError(f"unknown init kind {kind}")
        out[key] = arr.astype(np.float32)
    return out


def is_norm_param(key: str) -> bool:
    # LayerNorm/BatchNorm weights, biases and running stats feed f32
    # normalization math, so they stay f32 under a bf16 compute dtype
    return "norm" in key


def params_from_numpy(
    flat: dict[str, np.ndarray],
    device: str | torch.device = "cpu",
    dtype: torch.dtype = torch.float32,
) -> dict[str, torch.Tensor]:
    """Carry a flat {name: array} dict onto `device`. Floating weights take
    `dtype`, except normalization parameters and quantization sidecars
    (`##scale`, `##scale4`), which stay float32 (the reference's
    cast_params rule; its sidecars are made after the cast, in float32).
    int8 and uint8 arrays (quantized codes) keep their dtype."""
    out: dict[str, torch.Tensor] = {}
    for key, val in flat.items():
        arr = np.asarray(val)
        if arr.dtype in (np.int8, np.uint8):
            out[key] = torch.from_numpy(np.ascontiguousarray(arr)).to(device)
            continue
        if arr.dtype.kind in "iub":
            raise ValueError(f"{key}: {arr.dtype} weights are neither float nor quantized codes (int8, uint8)")
        target = torch.float32 if is_norm_param(key) or "##" in key else dtype
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32)).to(device=device, dtype=target)
    return out


def cast_params(params: dict[str, torch.Tensor], dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """Floating weights cast to a compute dtype, normalization parameters
    kept float32 (the reference's cast_params). The cast is differentiable,
    so a trainer that casts inside its loss gets float32 gradients."""
    return {k: v.to(dtype) if v.is_floating_point() and not is_norm_param(k) else v for k, v in params.items()}


def round_to_dtype(flat: dict[str, np.ndarray], dtype: torch.dtype) -> dict[str, np.ndarray]:
    """The float32 numpy dict whose floating weights hold the values they
    take under the compute dtype (normalization parameters excluded): the
    reference's cast_params, kept on the host so quantize_params sees the
    weights it would see there."""
    if dtype == torch.float32:
        return flat
    out = {}
    for key, val in flat.items():
        arr = np.asarray(val)
        if arr.dtype.kind == "f" and not is_norm_param(key):
            arr = torch.from_numpy(np.array(arr, dtype=np.float32)).to(dtype).to(torch.float32).numpy()
        out[key] = arr
    return out


def device_params(
    flat: dict[str, np.ndarray],
    device: str | torch.device = "cpu",
    dtype: torch.dtype = torch.float32,
    quantize: str | None = None,
) -> dict[str, torch.Tensor]:
    """A facade's parameters on its device, in the reference's order: cast
    to the compute dtype, then (with `quantize` "int8" or "int4")
    quantize_params, then onto the device."""
    if quantize:
        from parakeet_tpu_torch.quantize import quantize_params

        flat = quantize_params(round_to_dtype(flat, dtype), mode=quantize)
    return params_from_numpy(flat, device, dtype)


def init_params(
    spec: Spec,
    seed: int = 0,
    dtype: torch.dtype = torch.float32,
    *,
    device: str | torch.device = "cpu",
) -> dict[str, torch.Tensor]:
    """Random-init parameters on `device` (tests, benchmarks; real use loads
    safetensors). Deterministic given `seed`."""
    return params_from_numpy(init_params_numpy(spec, seed), device, dtype)


def load_params_numpy(
    spec: Spec,
    weights_path: str | None = None,
    *,
    weights: dict[str, np.ndarray] | None = None,
    seed: int = 0,
    strict: bool = False,
    warn: Callable[[str], None] | None = None,
) -> dict[str, np.ndarray]:
    """Load safetensors (or the given `weights` dict) over a random-init
    base, as the reference does (load_state_dict(strict=false): a missing
    CTC head stays random, with a warning through `warn`; with `strict` a
    missing key raises KeyError)."""
    params = init_params_numpy(spec, seed)
    if weights is None:
        if weights_path is None:
            return params
        weights = load_safetensors(weights_path)
    missing = []
    for key, (shape, _) in spec.items():
        w = weights.get(key)
        if w is None:
            missing.append(key)
            continue
        w = np.asarray(w)
        if w.dtype == np.int8:
            # an int8 checkpoint (tools/quantize_ckpt.py) dequantises on
            # load; Transcriber(quantize="int8") quantizes again for runtime
            from parakeet_tpu_torch.quantize import SCALE_SUFFIX

            scale = weights.get(key + SCALE_SUFFIX)
            if scale is None:
                raise ValueError(f"int8 tensor {key} has no '{key}{SCALE_SUFFIX}' sidecar")
            w = w.astype(np.float32) * np.asarray(scale, np.float32)[:, None]
        elif w.dtype == np.uint8:
            from parakeet_tpu_torch.quantize import SCALE4_SUFFIX, dequantize_tensor_int4

            scale = weights.get(key + SCALE4_SUFFIX)
            if scale is None:
                raise ValueError(f"int4 tensor {key} has no '{key}{SCALE4_SUFFIX}' sidecar")
            w = dequantize_tensor_int4(w, scale)
        if tuple(w.shape) != tuple(shape):
            raise ValueError(f"shape mismatch for {key}: file {tuple(w.shape)} vs spec {shape}")
        params[key] = np.asarray(w, np.float32)
    if missing:
        msg = f"{len(missing)} parameters missing from checkpoint (kept random init): {missing[:4]}..."
        if strict:
            raise KeyError(msg)
        if warn:
            warn(msg)
    return params


def load_params(
    spec: Spec,
    weights_path: str | None = None,
    *,
    weights: dict[str, np.ndarray] | None = None,
    dtype: torch.dtype = torch.float32,
    seed: int = 0,
    strict: bool = False,
    warn: Callable[[str], None] | None = None,
    device: str | torch.device = "cpu",
) -> dict[str, torch.Tensor]:
    """`load_params_numpy` on `device` in `dtype`: safetensors (or
    `weights`) over the random base of `seed`; `strict` raises KeyError on
    a missing key, otherwise `warn` hears of it."""
    flat = load_params_numpy(spec, weights_path, weights=weights, seed=seed, strict=strict, warn=warn)
    return params_from_numpy(flat, device, dtype)


__all__ = [
    "Params",
    "Spec",
    "subsampled_freq",
    "encoder_spec",
    "prediction_spec",
    "tdt_joint_spec",
    "rnnt_joint_spec",
    "ctc_spec",
    "transformer_spec",
    "tdt_ctc_spec",
    "tdt_spec",
    "rnnt_spec",
    "nemotron_spec",
    "eou_spec",
    "sortformer_spec",
    "init_params_numpy",
    "init_params",
    "is_norm_param",
    "params_from_numpy",
    "cast_params",
    "round_to_dtype",
    "device_params",
    "load_params_numpy",
    "load_params",
]
