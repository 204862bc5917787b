"""The yardstick's arithmetic: published H100 peaks, a function's least
time on them, and the operations the model's layers need.

`bound`, `tensor_bytes`, `core_flops`, `attention_flops`, `ffn_flops`,
`conv_flops` and `subsample_flops` are copies of the repo's chip_smoke.py
arithmetic (the table of kernels in PERF.md was computed with it), kept
here so that the benchmark's measure cannot change with the program or
its smoke script. `k1_flops` and `k1_call_bound` count the work one K1
call needs for `k1_roofline`, and `encoder_flops`, `ctc_flops` and
`transducer_flops` the model FLOPs that `batch_mfu` divides by the wall
time: each clip at its own valid length, with no padded row, and the
position projection, which a call shares, once a call at its longest
clip.
"""

from __future__ import annotations

# published H100 SXM peaks (NVIDIA's data sheet, dense): f32 FMA on the
# CUDA cores, bf16 on the tensor cores, HBM3 bandwidth; all at 700 W
F32_PEAK, BF16_PEAK, MEM_RATE = 67e12, 989e12, 3.35e12


def bound(flops: float, nbytes: float, peak: float = F32_PEAK) -> dict:
    """The least time the card could take for a function: the larger of its
    operations over the peak rate and its bytes (each input read once,
    each output written once) over the memory rate."""
    ops_ms, bytes_ms = flops / peak * 1e3, nbytes / MEM_RATE * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "gflop": flops / 1e9, "mbyte": nbytes / 1e6}


def tensor_bytes(*tensors) -> int:
    """Bytes of the given tensors (None skipped), each counted once."""
    return sum(a.numel() * a.element_size() for a in tensors if a is not None)


def core_flops(t: int, hd: int, heads: int, key_lens) -> float:
    """The attention cores (K2, and K1's): score (content + position) and
    AV FMAs over the valid keys of each item (an item with no valid key
    averages all T)."""
    keys = sum(min(int(n), t) if int(n) > 0 else t for n in key_lens)
    return 6 * hd * heads * t * keys


def attention_flops(b: int, t: int, d: int, heads: int, key_lens) -> float:
    """K1: QKV 2·M·D·3D, position 2·(2T−1)·D², out 2·M·D², and the core."""
    m = b * t
    return 2 * m * d * 3 * d + 2 * (2 * t - 1) * d * d + core_flops(t, d // heads, heads, key_lens) + 2 * m * d * d


def ffn_flops(m: int, d: int, f: int) -> float:
    return 4 * m * d * f


def conv_flops(m: int, d: int, k: int) -> float:
    return 2 * m * d * 2 * d + 2 * m * d * d + 2 * m * d * k


def subsample_flops(b: int, t: int, f: int, c: int) -> float:
    """K8: conv1 (1→C, 3x3, stride 2) at (T2, F2), dw1 (3x3, stride 2) and
    conv2 (C→C pointwise) at (T4, F4)."""
    t2, f2 = (t - 1) // 2 + 1, (f - 1) // 2 + 1
    t4, f4 = (t2 - 1) // 2 + 1, (f2 - 1) // 2 + 1
    return 2 * b * t2 * f2 * c * 9 + 2 * b * t4 * f4 * c * 9 + 2 * b * t4 * f4 * c * c


def _half(n: int) -> int:
    return (n - 1) // 2 + 1


def subsampled_length(mel_frames: int) -> int:
    """Encoder frames of a clip: three k3/s2/p1 convolutions."""
    for _ in range(3):
        mel_frames = _half(mel_frames)
    return mel_frames


def k1_bound(b: int, t: int, d: int, heads: int, key_lens, itemsize: int) -> dict:
    """K1's least time for one call (B, T', D) as PERF.md's table of kernels
    counts it: the GEMMs and the core's queries over every padded row, the
    clips' own key lengths; bytes x, the five weight matrices, the biases,
    pos_bias_u/v, the key lengths, the f32 LayerNorm, the output and the
    position table. Kept to reproduce that table; `k1_roofline` takes
    `k1_call_bound`."""
    w = 5 * d * d + 4 * d + 2 * d  # q, k, v, pos, out; four biases; bias_u, bias_v
    nbytes = (2 * b * t * d + w + (2 * t - 1) * d) * itemsize + 4 * b + 2 * 4 * d
    peak = F32_PEAK if itemsize == 4 else BF16_PEAK
    return bound(attention_flops(b, t, d, heads, key_lens), nbytes, peak)


def k1_flops(lens, d: int, heads: int) -> float:
    """The work one K1 call over clips of encoder lengths `lens` needs: per
    clip at its own length t the QKV and out-projection GEMMs over its t
    rows and the core over t queries and t keys; the position projection
    once, over the 2·max(lens)−1 positions the longest clip needs."""
    hd, t_max = d // heads, max(lens)
    per_clip = sum(2 * t * d * 3 * d + core_flops(t, hd, heads, [t]) + 2 * t * d * d for t in lens)
    return per_clip + 2 * (2 * t_max - 1) * d * d


def k1_call_bound(lens, d: int, heads: int, itemsize: int) -> dict:
    """K1's least time for one call over clips of encoder lengths `lens`:
    `k1_flops` at the peak of its dtype, and the bytes of each clip's own
    rows in and out, the weights once, the position table of the longest
    clip, the key lengths and the f32 LayerNorm."""
    w = 5 * d * d + 4 * d + 2 * d  # q, k, v, pos, out; four biases; bias_u, bias_v
    rows = sum(lens)
    nbytes = (2 * rows * d + w + (2 * max(lens) - 1) * d) * itemsize + 4 * len(lens) + 2 * 4 * d
    peak = F32_PEAK if itemsize == 4 else BF16_PEAK
    return bound(k1_flops(lens, d, heads), nbytes, peak)


def encoder_flops(enc: dict, mel_frames) -> float:
    """FLOPs of one call's clips (`mel_frames` each clip's feature frames)
    through the encoder, each at its own length: the subsampling (conv1,
    dw1, conv2, dw2, conv3, the projection), then each conformer block's
    two FFNs, attention (`k1_flops`) and conv module (pw1, the depthwise
    conv, pw2). `enc` holds the configuration's encoder widths."""
    c, mel, d, heads = enc["subsampling_channels"], enc["mel_bins"], enc["hidden_size"], enc["num_heads"]
    f2 = _half(mel)
    f4 = _half(f2)
    f8 = _half(f4)
    sub, lens = 0.0, []
    for n in mel_frames:
        t8 = subsampled_length(n)
        sub += subsample_flops(1, n, mel, c) + 2 * t8 * f8 * c * 9 + 2 * t8 * f8 * c * c + 2 * t8 * c * f8 * d
        lens.append(t8)
    block = sum(2 * ffn_flops(t, d, enc["ffn_intermediate"]) + conv_flops(t, d, enc["conv_kernel_size"])
                for t in lens) + k1_flops(lens, d, heads)
    return sub + enc["num_layers"] * block


def ctc_flops(enc_frames: int, d: int, vocab: int) -> float:
    return 2 * enc_frames * d * vocab


def transducer_flops(cfg: dict, enc_frames: int, steps: int) -> float:
    """The joint's encoder projection over a clip's frames, then per decode
    step the prediction LSTM's layers, the prediction projection and both
    joint heads (labels and durations)."""
    pred, joint = cfg["prediction"], cfg["joint"]
    h, jh = pred["pred_hidden"], joint["joint_hidden"]
    lstm = pred["num_lstm_layers"] * 2 * 4 * h * (h + h)
    heads = 2 * jh * (joint["vocab_size"] + len(cfg.get("durations", [])))
    return 2 * enc_frames * joint["encoder_hidden"] * jh + steps * (lstm + 2 * h * jh + heads)
