"""Weight-only int8 / int4 quantization (port of parakeet_tpu/quantize.py).

int8: symmetric per-output-channel scales, which commute with the product:

    y = x @ (q · s[:, None]).T  ==  (x @ q.T) · s[None, :]

so ops/layers.linear scales the (..., out) result, never the weight.

int4: symmetric codes in [-7, 7] with one scale per (output channel, group
of `group_size` inputs); two codes per uint8 byte, element 2j in the low
nibble of byte j and 2j+1 in the high nibble, so the stored tensor is
(out, in/2). In-dim group scales do not commute with the contraction, so
ops/layers.linear dequantises to the activation dtype before the product
(`dequantize_int4_torch`). Shapes carry all the bookkeeping: in =
2·packed.shape[1], group = in / scales.shape[1].

Quantized tensors live in the flat params dict: the int8 or uint8 array
keeps the schema key, its float32 scale rides at `<key>##scale` (int8) or
`<key>##scale4` (int4). Only 2-D `.weight` tensors are eligible:
embeddings, normalisation parameters, biases and convolutions stay float.

numpy in, numpy out, as in the reference; the facades carry the result
onto their device (params.params_from_numpy).
"""

from __future__ import annotations

import functools
import re

import numpy as np
import torch

SCALE_SUFFIX = "##scale"
SCALE4_SUFFIX = "##scale4"
MODES = ("int8", "int4")

# never quantized: embeddings (gathers), normalisation, biases
_EXCLUDE = re.compile(r"embed_|norm|bias")


def quantize_tensor(w: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(out, in) float → (int8 q, float32 per-output-channel scale s) with
    w ≈ q · s[:, None]; symmetric, max-abs calibrated."""
    w32 = np.asarray(w, np.float32)
    s = np.abs(w32).max(axis=1) / 127.0
    s = np.maximum(s, 1e-12)
    q = np.clip(np.rint(w32 / s[:, None]), -127, 127).astype(np.int8)
    return q, s.astype(np.float32)


def dequantize_tensor(q: np.ndarray, s: np.ndarray) -> np.ndarray:
    return np.asarray(q, np.float32) * np.asarray(s, np.float32)[:, None]


def _int4_group(in_dim: int, group_size: int) -> int:
    """The effective group size: the largest divisor of in_dim ≤ group_size."""
    if group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    return max(g for g in range(1, min(group_size, in_dim) + 1) if in_dim % g == 0)


def quantize_tensor_int4(w: np.ndarray, group_size: int = 64) -> tuple[np.ndarray, np.ndarray]:
    """(out, in) float → (packed uint8 (out, in/2), float32 scales (out, in/g)).
    Needs an even in-dim."""
    w32 = np.asarray(w, np.float32)
    out, in_dim = w32.shape
    if in_dim % 2:
        raise ValueError(f"int4 packing needs an even in-dim, got {w32.shape}")
    g = _int4_group(in_dim, group_size)
    grouped = w32.reshape(out, in_dim // g, g)
    s = np.abs(grouped).max(axis=2) / 7.0
    s = np.maximum(s, 1e-12)
    q = np.clip(np.rint(grouped / s[:, :, None]), -7, 7).astype(np.int8).reshape(out, in_dim)
    nib = (q & 0xF).astype(np.uint8)
    packed = nib[:, 0::2] | (nib[:, 1::2] << 4)
    return packed, s.astype(np.float32)


def unpack_int4(packed: np.ndarray) -> np.ndarray:
    """(out, in/2) uint8 → (out, in) int8 codes in [-7, 7]."""
    p = np.asarray(packed, np.uint8)
    lo = (p & 0xF).astype(np.int8)
    hi = (p >> 4).astype(np.int8)
    lo = np.where(lo > 7, lo - 16, lo).astype(np.int8)
    hi = np.where(hi > 7, hi - 16, hi).astype(np.int8)
    codes = np.empty((p.shape[0], p.shape[1] * 2), np.int8)
    codes[:, 0::2] = lo
    codes[:, 1::2] = hi
    return codes


def dequantize_tensor_int4(packed: np.ndarray, s: np.ndarray) -> np.ndarray:
    """Invert quantize_tensor_int4; the group size comes from the shapes."""
    codes = unpack_int4(packed)
    out, in_dim = codes.shape
    n_groups = np.asarray(s).shape[1]
    grouped = codes.reshape(out, n_groups, in_dim // n_groups).astype(np.float32)
    return (grouped * np.asarray(s, np.float32)[:, :, None]).reshape(out, in_dim)


@functools.lru_cache(maxsize=None)
def _nibble_table(device: torch.device) -> torch.Tensor:
    """(256, 2) int8 on `device`: the signed (low, high) nibble codes of
    every byte value."""
    b = torch.arange(256, dtype=torch.int16)
    lo, hi = b & 0xF, b >> 4
    return torch.stack([lo - 16 * (lo > 7), hi - 16 * (hi > 7)], dim=1).to(device=device, dtype=torch.int8)


def dequantize_int4_torch(packed: torch.Tensor, s: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The runtime dequant of ops/layers.linear, on the tensors' device:
    each byte's two codes by table lookup, codes × group scale in float32,
    then one cast to the activation dtype (the reference's
    dequantize_int4_jnp rounding point)."""
    out, half = packed.shape
    n_groups = s.shape[1]
    codes = _nibble_table(packed.device)[packed.to(torch.int32)]  # (out, in/2, 2): element 2j, 2j+1
    wf = codes.reshape(out, n_groups, 2 * half // n_groups).to(torch.float32) * s.to(torch.float32)[:, :, None]
    return wf.reshape(out, 2 * half).to(dtype)


def quantize_params(
    params: dict,
    *,
    mode: str = "int8",
    min_elems: int = 4096,
    include: str | None = None,
    group_size: int = 64,
    as_numpy: bool = True,
) -> dict:
    """Quantize the eligible 2-D `.weight` arrays of a flat numpy dict to
    int8 (+ `##scale`) or packed int4 (+ `##scale4`); everything else passes
    through unchanged.

    min_elems: skip smaller matrices. include: only keys matching this
    regex. group_size: int4 inputs sharing one scale (clamped to a
    divisor). Already-quantized int8 and uint8 arrays are never quantized
    again, and under int4 an odd in-dim stays float. as_numpy is the
    reference's switch between host and device arrays; here the result is
    numpy either way, and the facades carry it onto their device.

    On a mesh (parallel/mesh.py), as the reference notes: shard_params
    splits a quantized weight by the tensor-parallel rules but replicates
    its scale sidecar (the rules match `.weight` only), so a split weight
    has no matching scale. The facades therefore take quantize= on data
    and seq meshes, where nothing is split, and refuse it with a 'model'
    axis > 1."""
    if mode not in MODES:
        raise ValueError(f"unsupported quantize mode {mode!r} (want 'int8' or 'int4')")
    out: dict = {}
    for k, v in params.items():
        arr = np.asarray(v)
        eligible = (
            k.endswith(".weight")
            and arr.dtype not in (np.int8, np.uint8)
            and arr.ndim == 2
            and arr.size >= min_elems
            and not _EXCLUDE.search(k)
            and (include is None or re.search(include, k))
            and (mode == "int8" or arr.shape[1] % 2 == 0)
        )
        if not eligible:
            out[k] = v
        elif mode == "int4":
            out[k], out[k + SCALE4_SUFFIX] = quantize_tensor_int4(arr, group_size=group_size)
        else:
            out[k], out[k + SCALE_SUFFIX] = quantize_tensor(arr)
    return out


def quantized_fraction(params: dict) -> float:
    """Fraction of parameter ELEMENTS stored quantized; a packed int4 byte
    holds two elements. Sidecars are not counted."""
    q = total = 0
    for k, v in params.items():
        if k.endswith(SCALE_SUFFIX) or k.endswith(SCALE4_SUFFIX):
            continue
        n = int(np.prod(v.shape))
        dt = str(v.dtype).replace("torch.", "")  # numpy arrays and torch tensors alike
        if dt == "uint8":
            n *= 2
            q += n
        elif dt == "int8":
            q += n
        total += n
    return q / total if total else 0.0


__all__ = [
    "SCALE_SUFFIX",
    "SCALE4_SUFFIX",
    "MODES",
    "quantize_tensor",
    "dequantize_tensor",
    "quantize_tensor_int4",
    "dequantize_tensor_int4",
    "dequantize_int4_torch",
    "unpack_int4",
    "quantize_params",
    "quantized_fraction",
]
