"""Plain PyTorch FastConformer encoder, prediction LSTM, TDT joint and
scalar greedy TDT decode, from the flat parameter dict keyed by the
safetensors schema.

A frozen copy of the repo's independent oracle (the JAX package's
tools/torch_ref.py, itself written from the C++ reference and NeMo, not
from either Python implementation), with two changes:

* the sinusoidal position table is built here (the oracle imported it
  from the JAX package);
* every product with a weight goes through an `Arith`, so that the same
  code runs as the reference (float32, TF32 off), as the benchmark's
  control (each product's operands rounded through float8 e4m3 with a
  per-row scale, the precision below the configuration's bfloat16) and as
  its bf16 witness (operands and products rounded to bfloat16: a sound
  encoder that computes every weight product in the configuration's
  bfloat16).

It imports numpy and torch only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as TF

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def round_fp8(x: torch.Tensor, dims) -> torch.Tensor:
    """x rounded through float8 e4m3 with one absmax scale per slice over
    `dims` (the usual per-channel / per-token fp8 scaling), back in x's
    dtype."""
    scale = x.abs().amax(dim=dims, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def round_weight_fp8(w: torch.Tensor) -> torch.Tensor:
    """A weight rounded through float8 e4m3, one scale per output channel."""
    return round_fp8(w, tuple(range(1, w.dim())))


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16 (to nearest even), back in x's dtype."""
    return x.to(torch.bfloat16).to(x.dtype)


@dataclass(frozen=True)
class Arith:
    """How the reference multiplies by its weights: "f32" (the reference),
    "fp8" (the control: weights per output channel and activations per
    row or per tensor rounded through float8 e4m3, products in float32)
    or "bf16" (the witness: weights, activations and each product's
    result rounded to bfloat16, the attention core's operands and
    results too, the sums in float32). `weights_rounded`:
    the weights were rounded once beforehand (rounding again would give
    the same values)."""

    mode: str = "f32"
    weights_rounded: bool = False

    def _w(self, w: torch.Tensor) -> torch.Tensor:
        if self.mode == "f32" or self.weights_rounded:
            return w
        return round_bf16(w) if self.mode == "bf16" else round_weight_fp8(w)

    def _x(self, x: torch.Tensor, dims) -> torch.Tensor:
        if self.mode == "f32":
            return x
        return round_bf16(x) if self.mode == "bf16" else round_fp8(x, dims)

    def _y(self, y: torch.Tensor) -> torch.Tensor:
        return round_bf16(y) if self.mode == "bf16" else y

    def core(self, x: torch.Tensor) -> torch.Tensor:
        """An operand or result of the attention core's products: rounded
        to bfloat16 in the witness, as it is; the control's core stays
        float32."""
        return self._y(x)

    def linear(self, x, w, b=None):
        return self._y(TF.linear(self._x(x, -1), self._w(w), b))

    def conv2d(self, x, w, b, **kw):
        return self._y(TF.conv2d(self._x(x, (1, 2, 3)), self._w(w), b, **kw))

    def conv1d(self, x, w, b, **kw):
        return self._y(TF.conv1d(self._x(x, (1, 2)), self._w(w), b, **kw))

    def weight(self, w):
        return self._w(w)


F32 = Arith("f32")


def position_table(seq_len: int, d_model: int) -> torch.Tensor:
    """(2T−1, d) sinusoidal relative-position table, row r = position
    T−1−r (Transformer-XL / NeMo RelPositionalEncoding), built in f64."""
    pos = (seq_len - 1 - np.arange(2 * seq_len - 1, dtype=np.float64))[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float64) * (-math.log(10000.0) / d_model))[None, :]
    pe = np.zeros((2 * seq_len - 1, d_model), dtype=np.float64)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)[:, : pe[:, 1::2].shape[1]]
    return torch.from_numpy(pe.astype(np.float32))


def subsampling(params, x, prefix="encoder_.subsampling_", ar: Arith = F32):
    """x: (B, T, mel) → (B, T/8, d). NCHW convs, ReLU, channel-major
    flatten (encoder.cpp:208-241)."""
    p = prefix
    h = x.unsqueeze(1)
    c = params[f"{p}.conv1_.weight"].shape[0]
    h = TF.relu(ar.conv2d(h, params[f"{p}.conv1_.weight"], params[f"{p}.conv1_.bias"], stride=2, padding=1))
    h = ar.conv2d(h, params[f"{p}.dw1_.weight"], params[f"{p}.dw1_.bias"], stride=2, padding=1, groups=c)
    h = TF.relu(ar.conv2d(h, params[f"{p}.conv2_.weight"], params[f"{p}.conv2_.bias"]))
    h = ar.conv2d(h, params[f"{p}.dw2_.weight"], params[f"{p}.dw2_.bias"], stride=2, padding=1, groups=c)
    h = TF.relu(ar.conv2d(h, params[f"{p}.conv3_.weight"], params[f"{p}.conv3_.bias"]))
    b, ch, tt, f = h.shape
    h = h.permute(0, 2, 1, 3).reshape(b, tt, ch * f)
    return ar.linear(h, params[f"{p}.proj_.weight"], params[f"{p}.proj_.bias"])


def rel_shift(x):
    """(B, H, T, 2T-1) → (B, H, T, T) pad-reshape trick (encoder.cpp:85-109)."""
    b, h, tt, pos = x.shape
    x = TF.pad(x, (1, 0))
    x = x.reshape(b, h, pos + 1, tt)[:, :, 1:, :].reshape(b, h, tt, pos)
    return x[:, :, :, :tt]


def attention(params, x, pos_emb, heads, a, ar: Arith = F32):
    """Rel-pos MHSA (encoder.cpp:79-186): content (Q+u)Kᵀ + shifted pos
    (Q+v)Pᵀ, scale AFTER the sum."""
    b, tt, d = x.shape
    hd = d // heads
    q = ar.linear(x, params[f"{a}.mha_.q_proj.weight"], params[f"{a}.mha_.q_proj.bias"])
    k = ar.linear(x, params[f"{a}.mha_.k_proj.weight"], params[f"{a}.mha_.k_proj.bias"])
    v = ar.linear(x, params[f"{a}.mha_.v_proj.weight"], params[f"{a}.mha_.v_proj.bias"])
    q = q.view(b, tt, heads, hd).transpose(1, 2)
    k = k.view(b, tt, heads, hd).transpose(1, 2)
    v = v.view(b, tt, heads, hd).transpose(1, 2)
    u = params[f"{a}.pos_bias_u_"][None, :, None, :]
    vb = params[f"{a}.pos_bias_v_"][None, :, None, :]
    p = ar.linear(pos_emb, params[f"{a}.pos_proj_.weight"])
    p = p.view(-1, heads, hd).transpose(0, 1)  # (H, 2T-1, hd)
    c = ar.core
    content = c(c(q + u) @ c(k).transpose(-2, -1))
    pos_score = c(torch.einsum("bhtd,hsd->bhts", c(q + vb), c(p)))
    scores = (content + rel_shift(pos_score)) / np.sqrt(hd)
    attn = c(TF.softmax(scores, dim=-1))
    out = c(attn @ c(v)).transpose(1, 2).reshape(b, tt, d)
    return ar.linear(out, params[f"{a}.mha_.out_proj.weight"], params[f"{a}.mha_.out_proj.bias"])


def ffn(params, x, a, eps, ar: Arith = F32):
    """Macaron FFN with 0.5 half-step residual (encoder.cpp:34-46)."""
    h = TF.layer_norm(x, (x.shape[-1],), params[f"{a}.norm_.weight"], params[f"{a}.norm_.bias"], eps)
    h = TF.silu(ar.linear(h, params[f"{a}.fc1_.weight"], params[f"{a}.fc1_.bias"]))
    h = ar.linear(h, params[f"{a}.fc2_.weight"], params[f"{a}.fc2_.bias"])
    return x + 0.5 * h


def conv_module(params, x, kernel, a, eps, ar: Arith = F32):
    """Pointwise→GLU→depthwise→inference-BN→SiLU→pointwise (encoder.cpp:50-75)."""
    d = x.shape[-1]
    h = TF.layer_norm(x, (d,), params[f"{a}.norm_.weight"], params[f"{a}.norm_.bias"], eps)
    h = h.transpose(1, 2)  # (B, d, T)
    h = ar.conv1d(h, params[f"{a}.pointwise_conv1_.weight"], params[f"{a}.pointwise_conv1_.bias"])
    h = TF.glu(h, dim=1)
    h = ar.conv1d(h, params[f"{a}.depthwise_conv_.weight"], params[f"{a}.depthwise_conv_.bias"],
                  padding=(kernel - 1) // 2, groups=d)
    h = TF.batch_norm(h, params[f"{a}.batch_norm_.running_mean"], params[f"{a}.batch_norm_.running_var"],
                      params[f"{a}.batch_norm_.weight"], params[f"{a}.batch_norm_.bias"],
                      training=False, eps=1e-5)
    h = TF.silu(h)
    h = ar.conv1d(h, params[f"{a}.pointwise_conv2_.weight"], params[f"{a}.pointwise_conv2_.bias"])
    return x + h.transpose(1, 2)


def conformer_layers(params, enc: dict, h, ar: Arith = F32, prefix="encoder_"):
    """The conformer blocks over (B, T', d) subsampled frames, none padded."""
    d, eps = enc["hidden_size"], enc["layer_norm_eps"]
    pos = position_table(h.shape[1], d).to(h.device)
    for i in range(enc["num_layers"]):
        a = f"{prefix}.layers_.{i}"
        h = ffn(params, h, f"{a}.ffn1_", eps, ar)
        attn_in = TF.layer_norm(h, (d,), params[f"{a}.attn_.norm_.weight"], params[f"{a}.attn_.norm_.bias"], eps)
        h = h + attention(params, attn_in, pos, enc["num_heads"], f"{a}.attn_", ar)
        h = conv_module(params, h, enc["conv_kernel_size"], f"{a}.conv_", eps, ar)
        h = ffn(params, h, f"{a}.ffn2_", eps, ar)
        h = TF.layer_norm(h, (d,), params[f"{a}.final_norm_.weight"], params[f"{a}.final_norm_.bias"], eps)
    return h


def ctc_log_probs(params, h, ar: Arith = F32, prefix="ctc_decoder_"):
    """(B, T', d) → (B, T', V) f32 log-probs of the 1×1 Conv1d CTC head."""
    x = ar.conv1d(h.transpose(1, 2), params[f"{prefix}.proj_.weight"], params[f"{prefix}.proj_.bias"])
    return TF.log_softmax(x.transpose(1, 2).float(), dim=-1)


# ─── Transducer side (prediction LSTM + joint + scalar greedy decode) ────────


def prediction_lstm(params, ar: Arith = F32, prefix="prediction_"):
    """torch.nn.LSTM from the schema weights. input_proj_ carries the merged
    NeMo bias (convert_nemo.py:409-417) → bias_ih; bias_hh = 0."""
    n = 0
    while f"{prefix}.lstm_.cells_.{n}.input_proj_.weight" in params:
        n += 1
    w0 = params[f"{prefix}.lstm_.cells_.0.input_proj_.weight"]
    hidden = w0.shape[0] // 4
    lstm = torch.nn.LSTM(w0.shape[1], hidden, num_layers=n, batch_first=True).to(w0.device)
    sd = {}
    for i in range(n):
        cell = f"{prefix}.lstm_.cells_.{i}"
        sd[f"weight_ih_l{i}"] = ar.weight(params[f"{cell}.input_proj_.weight"])
        sd[f"weight_hh_l{i}"] = ar.weight(params[f"{cell}.hidden_proj_.weight"])
        sd[f"bias_ih_l{i}"] = params[f"{cell}.input_proj_.bias"]
        sd[f"bias_hh_l{i}"] = torch.zeros(4 * hidden, device=w0.device)
    lstm.load_state_dict(sd)
    lstm.eval()
    return lstm, n, hidden


def joint(params, enc_t, pred, joint_prefix, ar: Arith = F32):
    """TDT joint: (label log-probs, duration log-probs). enc_proj has a
    bias; pred_proj is bias-free (rnnt.cpp:33)."""
    j = joint_prefix
    hidden = TF.relu(ar.linear(enc_t, params[f"{j}.enc_proj_.weight"], params[f"{j}.enc_proj_.bias"])
                     + ar.linear(pred, params[f"{j}.pred_proj_.weight"]))
    label = ar.linear(hidden, params[f"{j}.label_proj_.weight"], params[f"{j}.label_proj_.bias"])
    dur = ar.linear(hidden, params[f"{j}.duration_proj_.weight"], params[f"{j}.duration_proj_.bias"])
    return TF.log_softmax(label, dim=-1), TF.log_softmax(dur, dim=-1)


def greedy_tdt(params, enc, *, durations, blank_id, joint_prefix, max_symbols=10, ar: Arith = F32):
    """Scalar TDT greedy decode of ONE utterance's (T, d) frames to
    [(token, start, end)] (tdt.cpp:36-118): SOS = blank; blank → LSTM state
    not committed, t += max(skip, 1); non-blank → emit and feed back,
    t += skip if skip > 0, else another symbol on the same frame, capped
    at max_symbols (forced t += 1 at the cap); end = t + max(skip, 1) − 1
    clamped to len − 1."""
    lstm, n_layers, hidden = prediction_lstm(params, ar)
    emb = params["prediction_.embed_.weight"]
    tt_len = enc.shape[0]
    dev = enc.device
    h = torch.zeros(n_layers, 1, hidden, device=dev)
    c = torch.zeros(n_layers, 1, hidden, device=dev)
    last, out = blank_id, []
    tpos = sym = 0
    while tpos < tt_len:
        o, (h2, c2) = lstm(emb[last][None, None, :], (h, c))
        label_lp, dur_lp = joint(params, enc[tpos], o[0, 0], joint_prefix, ar)
        tok = int(torch.argmax(label_lp).item())
        skip = int(durations[int(torch.argmax(dur_lp).item())])
        if tok == blank_id:
            tpos += max(skip, 1)
            sym = 0
            continue
        h, c, last = h2, c2, tok
        out.append((tok, tpos, min(tpos + max(skip, 1) - 1, tt_len - 1)))
        if skip > 0:
            tpos += skip
            sym = 0
        elif sym + 1 >= max_symbols:
            tpos += 1
            sym = 0
        else:
            sym += 1
    return out
