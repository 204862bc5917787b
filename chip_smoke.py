#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (parakeet_tpu_torch) on one card.

    python3 chip_smoke.py        # needs one CUDA device
    python3 chip_smoke.py --phases streaming,diarize   # a subset, no result lines

Phases, each of which raises (exit code 1) on failure:
  1. device   require CUDA; print the card's name and power limit
  2. build    compile every CUDA library from parakeet_tpu_torch/csrc, all
              at once, and print each build's seconds
  3. kernels  each hand-written kernel against its plain torch version on
              the same CUDA tensors at the 110m widths, in f32 and bf16:
              K1 rel-pos attention block (B=8, D=512, H=8, T'=126 and 751,
              with and without the fused LayerNorm + residual, timed in f32
              and bf16; the 600m widths D=1024, hd=128 at T'=126; B=1 at
              T'=3000, one kernel for every length), K6 FFN (T'=126 and
              751, with and without the final LayerNorm, timed in f32 and
              bf16; and D=1024, F=4096 at T'=126), K5 conv module (T'=126
              and 751, mixed lengths and none, timed in f32 and bf16; and
              D=1024 at T'=126), K8 subsampling front (mel (8, 1001, 80)
              and (8, 6001, 80), C=256, ReLU timed in f32 and bf16, SiLU
              checked at T=1001), K4 conv
              module + ffn2 + final LayerNorm and K7 ffn1 + attention block
              (T'=126 and 751, mixed lengths), K2 v1 attention core (H=8,
              hd=64, T'=126, 751 and 1001, mixed lengths, one pass, timed
              in f32 and bf16; B=1 at T'=3000, past the one-pass limit, two
              passes), K3 log-mel (10 s and 60 s clips, f32 only, atol 2e-2
              in log space); median CUDA-event ms and device ms
              (torch.profiler kernel time) of kernel and plain version; a
              call whose profile shows no device time is profiled again,
              and fails the run if it still shows none. For K1 and K5 in
              f32 at T'=126 and 751, K8 at T=1001 and 6001 (f32 and bf16)
              and K3 at 10 and 60 s also each launch's device time by
              kernel name, torch.matmul on each GEMM stage's shapes as a
              yardstick (never a port path), and the whole call under the
              other block-row choices of the QKV / pw1 / conv2 GEMM (K3:
              each DFT plan of 64 or 128 rows and 1-8 k slices). Each
              kernel's bound at every timed shape: its operations (FMAs
              counted over the valid keys in the attention cores) at the
              published f32 peak (bf16: tensor-core peak) against its
              bytes (inputs read once, outputs written once) at the
              memory rate
  4. paths    Transcriber at full tdt-ctc-110m width (17 layers, d=512),
              seeded random weights, f32, 8 synthetic clips of 2-10 s
              through transcribe_batch with TDT + timestamps and with CTC,
              in four configurations: the default (attention kernel only),
              FusedLayers(ffn, conv, subsample), the whole-block
              FusedLayers(attention="mega", block2=True, subsample=True)
              and FusedLayers(attention="v1"). Launch counts per encoder
              call must be exact (the reference's input guards
              included), and the tokens must equal a CPU
              Transcriber's with the same option; then the fused
              frontend: preprocess_audio_fused on each clip (K3) and
              transcribe_features, tokens equal to a CPU Transcriber's on
              the same features; then a bf16 run of the fused
              configuration, its token edit distance against f32 reported
              (not a gate)
  5. kernels600m  the kernels at the 600m presets' shapes against their
              plain versions in f32 and bf16, timed, each with its bound:
              K8 on mel (8, 1001, 128), K7 and K4 at D=1024, F=4096, H=8,
              T'=126 with mixed lengths, K2 at hd=128 and T'=126 and 751,
              K1 at D=1024, B=1, T'=1188 (a dense 95 s clip)
  6. paths600m  TDTTranscriber at full tdt-600m width (24 layers, d=1024,
              128 mel, vocab 8193, two LSTM layers) in the default, fused,
              whole-block and v1 configurations, and RNNTTranscriber at
              full rnnt-600m width (80 mel, vocab 1025) in the default and
              fused ones; seeded random weights, f32, the 8 clips; exact
              launch counts, tokens and frames equal to a CPU facade's,
              Decoder.CTC raising ValueError
  7. long     tdt-600m, default configuration, clips of 95, 62 and 7 s
              through transcribe_batch: long_audio="window" (20 windows of
              10 s overlapping by 2 s in one call at B=20, the 7 s clip
              densely) and long_audio="dense" (the 95 s clip alone at
              T'=1188); tokens and frames equal to the CPU's
  8. streaming  eou-120m (StreamingTranscriber) at full width, B=1, 8 s in
              160 ms pushes, f32 (and bf16: edit distance against f32);
              StreamingBatchTranscriber eou-120m at B=8, fused frontend,
              int16 wire, with held steps and a reset_slot; nemotron-600m
              (NemotronTranscriber) in latency modes 0, 1, 6 and 13, 4 s
              each; tokens and frames equal to a CPU facade fed the same
              pushes, no kernel launched (the streaming encoder is plain in
              the reference too), per-push wall ms (median, p95) and the
              device busy share
  9. diarize  Sortformer-117m at full width: forward on 10 s and 60 s clips
              (K1 17 times a forward), diarize_chunk over 10 s in 160 ms
              chunks, DiarizedTranscriber.transcribe on 10 s (tdt-ctc-110m +
              Sortformer); probabilities against the CPU, segments and
              speakers identical except frames within 1e-4 of the threshold
              (reported); K1 at B=1, T'=751, D=512 against its plain version,
              timed, with its bound
 10. options  (runs after long, while the tdt-600m weights are drawn)
              quantized weights and the decode options at full width,
              seeded random weights, f32, against CPU facades with the same
              options: tdt-ctc-110m with quantize="int8" and "int4" in the
              default and fused configurations, tdt-600m int8 default,
              each a path as in 4 with exact launch counts under
              the reference's weight guards (K2 17 or 24, K8 1 and K5 17
              fused, never K1, K6, K7, K4); W8A8 (set_int8_compute(True),
              int8, default): every integer product of an encoder call
              equal to the CPU's, the encoder's mean error against
              weight-only int8 within 1.25x the CPU's, the W8A8 TDT and CTC decodes from
              one encoder output identical on card and CPU, the whole
              pipeline's token edit distance reported (W8A8 is a step
              function of the activations: the card's ~1e-6 differences
              move codes); each quantized encoder's device
              ms against f32 (and W8A8) in turns and the resident weight
              bytes (torch.cuda.memory_allocated after load); on 4 clips of
              tdt-ctc-110m (default, a synthetic vocab under build/): TDT
              and CTC boost_phrases (must change tokens), TDT beam 4 and
              beam 1 (must equal greedy), CTC beam 8 with a bigram ARPA LM
              written under build/, TDT beam 4 rescored by NeuralLM.random,
              tokens and frames equal to the CPU's, beam path scores within
              1e-4; eou-120m streaming with int8, B=1, 50 pushes, no kernel
              launched, and its push wall against f32 in turns
 11. serve    (runs after paths, with the 110m weights) tdt-ctc-110m at full
              width behind the port's HTTP server (make_server on
              127.0.0.1, an ephemeral port) over TranscriptionService(
              max_batch=8, max_wait_ms=25) on the card, pipelined and not
              (first K1 against its plain version at the served shapes:
              the cohort of 8 padded to a multiple of 200 mel frames with
              its clips' lengths, and B=1 at the lengths /align, the C API
              and the CLI run, the cohort's shape timed with its bound):
              8 concurrent clients POST the 8 clips as WAV (clip 0 as
              44.1 kHz stereo, so downmix and the native resampler run),
              then the same clips all as 16 kHz mono; tokens equal to the
              CPU facade's transcribe_batch on the same decoded samples, K1
              17 launches a cohort and no other kernel, the burst's
              request wall median and max, cohorts, mean batch, RTFx,
              beside the warm
              transcribe_batch wall; /align of one clip beside a
              /transcribe round, equal to the card facade's align;
              StreamingService over StreamingBatchTranscriber(8, eou-120m,
              fused frontend, int16 wire): four chunked /stream sessions
              at once, tokens equal to direct lockstep runs on the card
              and the CPU, no kernel, the wall of each device step; the C
              API (build_capi, ctypes into this process) on clip 0 as f32
              16 kHz and s16 44.1 kHz, tokens equal to the card facade's;
              `python -m parakeet_tpu_torch.cli` with --random-weights,
              its (token ids) line equal to the card facade's;
              `python -m parakeet_tpu_torch.benchmark --models 110m
              --durations 10`, its row; read_audio of a 60 s 44.1 kHz
              stereo WAV in fresh processes, native and PARAKEET_NO_NATIVE
              (the chunked numpy form): host seconds and peak-RSS growth,
              outputs bit-identical
Each phase prints its seconds, and the run its total. The card's name and
power limit, a JSON line of per-kernel numbers (with bound_ms, bound_by
and the bound's share of the kernel time at the headline shape, under
"shapes" every timed shape with its bound, launches_quantized, the
kernel's launches in one encoder call of the int8 fused 110m path, and
launches_serve, its launches per cohort served over HTTP) and
{"ok": true, "device": {...}} are the last three lines of output.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
LIBRARIES = ("rel_attention", "feed_forward", "conv_module", "subsample", "conv_ffn_final",
             "ffn_attention", "rel_attention_v1", "log_mel")
F32_RTOL, F32_ATOL = 1e-3, 1e-5  # the reference's block-kernel tolerance
LOG_MEL_ATOL = 2e-2  # K3: the reference frontend kernel's tolerance, in log space
BF16_SCALE_FRAC = 0.02  # bf16: max |diff| within 2% of the output scale
ENC_SCALE_FRAC = 1e-3  # f32 encoder, card vs CPU, 17 layers of reordered sums
DIAR_PROB_ATOL = 1e-3  # f32 Sortformer probabilities, card vs CPU
BEAM_SCORE_RTOL = 1e-4  # beam path scores, card vs CPU
W8A8_ERR_RATIO = 1.25  # W8A8 encoder's mean error against weight-only int8, card over CPU:
#   the same rounding noise drawn twice (the card's ~1e-6 differences move codes)
B, D, H, FFN = 8, 512, 8, 2048  # tdt-ctc-110m widths
MEL, SUB_C = 80, 256
# published H100 SXM peaks (NVIDIA's data sheet): f32 FMA on the CUDA cores
# (the f32 kernels use IEEE FMA, not TF32), bf16 dense on the tensor cores,
# HBM3 bandwidth
F32_PEAK, BF16_PEAK, MEM_RATE = 67e12, 989e12, 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def median_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def profile_device(fn, calls: int, host_ops: bool = True):
    """Device events of `calls` calls of fn under torch.profiler, as
    {kernel name: device ms per call}. Only device events are summed: the
    profiler also books each kernel's time on the host op that launched
    it. Without `host_ops` only the device is traced, which keeps a profile
    of tens of thousands of launches cheap."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops else [ProfilerActivity.CUDA]
    with profile(activities=activities) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total > 0:
            times[evt.key] = times.get(evt.key, 0.0) + evt.self_device_time_total / 1e3 / calls
    return times


def device_ms(fn, calls: int = 10, profiles: int = 2) -> float:
    """Device time per call from torch.profiler: the summed durations of
    the device events (kernels, copies, fills) over `calls` calls, the
    device alone traced. The largest of `profiles` profiles (two by
    default; one for whole decode batches), since a profile that drops
    events can only read low. While no profile has seen device time, up to
    three more are taken, tracing host ops too; then the measurement
    fails."""
    import torch

    fn()
    torch.cuda.synchronize()
    best = 0.0
    for attempt in range(profiles + 3):
        if attempt >= profiles and best > 0:
            break
        best = max(best, sum(profile_device(fn, calls, host_ops=attempt >= profiles).values()))
    if best <= 0:
        raise RuntimeError("the profiler saw no device time in 5 profiles")
    return best


def time_pair(tag: str, kernel_fn, plain_fn, card: str) -> dict:
    """CUDA-event median and profiler device time of a kernel and its plain
    version, measured in turns on the same inputs."""
    import torch

    with torch.inference_mode():
        ms = {"plain_ms": median_ms(plain_fn), "ms": median_ms(kernel_fn)}
        ms["ms"] = min(ms["ms"], median_ms(kernel_fn))
        ms["plain_ms"] = min(ms["plain_ms"], median_ms(plain_fn))
        ms["dev_ms"] = device_ms(kernel_fn)  # raises when the profiler sees none
        ms["plain_dev_ms"] = device_ms(plain_fn)
    slower = [name for name, k, p in (("CUDA events", ms["ms"], ms["plain_ms"]),
                                      ("device time", ms["dev_ms"], ms["plain_dev_ms"])) if k > p]
    verdict = f"kernel SLOWER than plain by {' and '.join(slower)}" if slower else "kernel not slower"
    log(f"  {tag} times, kernel / plain: CUDA events {ms['ms']:.4f} / {ms['plain_ms']:.4f} ms "
        f"(median of 20, best of 2 turns); device {ms['dev_ms']:.4f} / {ms['plain_dev_ms']:.4f} ms; "
        f"{verdict} [{card}]")
    return ms


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


def _kernel_label(key: str) -> str:
    import re

    key = key.replace("(anonymous namespace)::", "").replace("void ", "")
    depth, out = 0, []
    for ch in key:  # drop the argument list, keep the template arguments
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return re.sub(r"\s+", " ", "".join(out))[:90]


def stage_times(tag: str, fn, gemms, card: str, calls: int = 10, dtype=None) -> dict:
    """Device time per call of each kernel `fn` launches (torch.profiler,
    by kernel name), and beside it the device time of torch.matmul on each
    GEMM stage's shapes in `dtype` (f32 with TF32 off unless given): a
    yardstick for that stage, which the port never calls. A profile that
    sees no device time is taken again, then fails."""
    import torch

    dtype = dtype or torch.float32
    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            raw = profile_device(fn, calls)
            if raw:
                break
        else:
            raise RuntimeError(f"{tag}: the profiler saw no device time in 3 profiles")
        stages = {}
        for key, ms in raw.items():
            label = _kernel_label(key)
            stages[label] = stages.get(label, 0.0) + ms
        yard = {}
        for name, m, n, k in gemms:
            a = torch.randn(m, k, device="cuda", dtype=dtype)
            w = torch.randn(n, k, device="cuda", dtype=dtype)
            yard[f"{name} ({m}x{k} @ {k}x{n})"] = device_ms(lambda: torch.matmul(a, w.t()))
    name = "f32 (TF32 off)" if dtype == torch.float32 else str(dtype).replace("torch.", "")
    log(f"  {tag} stages, device ms per call [{card}]:")
    for label, ms in stages.items():
        log(f"    {ms:.4f}  {label}")
    for label, ms in yard.items():
        log(f"    yardstick torch.matmul {name}, not a port path: {label} {ms:.4f}")
    return {"stages": stages, "yardstick": yard}


def tile_choice(tag: str, fn, module, plan_fn: str, field, card: str, itemsize: int = 4) -> dict:
    """Device time of `fn` with the launch plan's block rows for one
    nonlinear-epilogue GEMM (`field` of the plan that `module.plan_fn`
    returns, or the plan itself when None) and with each other choice of
    64, 96 and 128 rows, each timed twice. Only this measurement swaps the
    plan; the port always runs the plan's choice."""
    import dataclasses

    import torch

    from parakeet_tpu_torch.ops.gemm_plan import GEMM_ROWS, gemm_smem

    planner = getattr(module, plan_fn)
    chosen = {}

    def with_rows(rows):
        def plan_fn_rows(*args, **kw):
            plan = planner(*args, **kw)
            g = plan if field is None else getattr(plan, field)
            chosen.setdefault("plan", g.rows)
            if rows is None:
                return plan
            g = dataclasses.replace(g, rows=rows, smem=gemm_smem(rows, itemsize))
            return g if field is None else dataclasses.replace(plan, **{field: g})
        return plan_fn_rows

    ms = {}
    with torch.inference_mode():
        for rows in (None, *GEMM_ROWS, *reversed(GEMM_ROWS), None):
            setattr(module, plan_fn, with_rows(rows))
            try:
                t = device_ms(fn)
            finally:
                setattr(module, plan_fn, planner)
            key = chosen["plan"] if rows is None else rows
            ms[key] = min(ms.get(key, float("inf")), t)
    log(f"  {tag} {field or 'the'} GEMM block rows, device ms of the whole call (best of 2): "
        + ", ".join(f"{r} rows {ms[r]:.4f}{' (the plan)' if r == chosen['plan'] else ''}" for r in GEMM_ROWS)
        + f" [{card}]")
    return ms


def check_close(tag: str, got, ref, rows=None, atol: float = F32_ATOL, rtol: float = F32_RTOL) -> float:
    """Hold a kernel's output against its plain version; returns max |diff|."""
    import torch

    torch.cuda.synchronize()
    g, r = got.float(), ref.float()
    if rows is not None:
        g, r = g[rows], r[rows]
    if g.shape != r.shape:
        raise RuntimeError(f"{tag}: kernel shape {tuple(g.shape)} vs plain {tuple(r.shape)}")
    if not torch.isfinite(g).all():
        raise RuntimeError(f"kernel output not finite at {tag}")
    err = (g - r).abs()
    if got.dtype == torch.float32:
        bad = int((err > atol + rtol * r.abs()).sum())
        log(f"  {tag}: max|diff| {float(err.max()):.3e}, {bad} values outside rtol {rtol} / atol {atol}")
        if bad:
            raise RuntimeError(f"kernel disagrees with its plain version at {tag}")
    else:
        scale = float(r.abs().max())
        log(f"  {tag}: max|diff| {float(err.max()):.3e} = {float(err.max()) / scale:.3%} of output scale {scale:.3f}")
        if float(err.max()) > BF16_SCALE_FRAC * scale:
            raise RuntimeError(f"kernel disagrees with its plain version at {tag}")
    return float(err.max())


def _dev(rng, dtype):
    import torch

    def dev(a, dt=dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to("cuda", dt)

    return dev


def _mixed_lengths(rng, t: int):
    lengths = rng.randint(max(1, t // 4), t + 1, size=B)
    lengths[0] = t
    return np.asarray(lengths)


def _valid_rows(lengths, t: int):
    import torch

    rows = torch.zeros((len(lengths), t), dtype=torch.bool, device="cuda")
    for i, n in enumerate(lengths):
        rows[i, :n] = True
    return rows


def _dtypes():
    import torch

    return ((torch.float32, "f32"), (torch.bfloat16, "bf16"))


def _attention_args(rng, dev, b, t, d, heads):
    x = dev(rng.randn(b, t, d))
    return [x, *_attention_weights(rng, dev, d, heads)]


def attention_phase(card: str) -> dict:
    import torch

    from parakeet_tpu_torch.ops import rel_attention as RA

    log(f"== K1 rel_attention_block vs rel_attention_block_reference (B={B}, D={D}, H={H})")
    out = {"max_abs_err": 0.0, "times": {}, "bf16_times": {}, "work": {}, "bf16_work": {}, "stages": {}}
    for t in (126, 751):
        for dtype, name in _dtypes():
            for with_norm in (True, False):
                rng = np.random.RandomState(t + with_norm)
                dev = _dev(rng, dtype)
                args = _attention_args(rng, dev, B, t, D, H)
                lengths = _mixed_lengths(rng, t)
                kw = dict(lengths=torch.as_tensor(lengths, dtype=torch.int32, device="cuda"))
                if with_norm:
                    kw.update(norm_w=dev(1 + rng.normal(0, 0.1, D), torch.float32),
                              norm_b=dev(rng.normal(0, 0.1, D), torch.float32))
                with torch.inference_mode():
                    got = RA.rel_attention_block(*args, **kw)
                    ref = RA.rel_attention_block_reference(*args, **kw)
                tag = f"K1 T'={t} {name} norm+residual={with_norm}"
                err = check_close(tag, got, ref, _valid_rows(lengths, t))
                if dtype == torch.float32:
                    out["max_abs_err"] = max(out["max_abs_err"], err)
                if with_norm:
                    fn = lambda: RA.rel_attention_block(*args, **kw)  # noqa: E731
                    key = "times" if dtype == torch.float32 else "bf16_times"
                    out[key][t] = time_pair(tag, fn, lambda: RA.rel_attention_block_reference(*args, **kw), card)
                    pe_bytes = (2 * t - 1) * D * got.element_size()
                    out[key.replace("times", "work")][t] = (attention_flops(B, t, D, H, lengths),
                                                            tensor_bytes(*args, *kw.values(), got) + pe_bytes)
                    if dtype == torch.float32:
                        m = B * t
                        out["stages"][t] = stage_times(tag, fn, [("QKV", m, 3 * D, D), ("P", 2 * t - 1, D, D),
                                                                 ("out", m, D, D)], card)
                        out["stages"][t]["tiles"] = tile_choice(tag, fn, RA, "block_plan", "qkv", card)
    # the 600m widths (D=1024, H=8, hd=128), and one long item past any
    # length cap (B=1, T'=3000, a mixed length): one kernel for every T
    for b, t, d in ((B, 126, 1024), (1, 3000, D)):
        for dtype, name in _dtypes():
            rng = np.random.RandomState(40 + t + d)
            dev = _dev(rng, dtype)
            args = _attention_args(rng, dev, b, t, d, H)
            lengths = _mixed_lengths(rng, t) if b == B else np.asarray([rng.randint(t // 2, t)])
            kw = dict(lengths=torch.as_tensor(lengths, dtype=torch.int32, device="cuda"),
                      norm_w=dev(1 + rng.normal(0, 0.1, d), torch.float32),
                      norm_b=dev(rng.normal(0, 0.1, d), torch.float32))
            with torch.inference_mode():
                got = RA.rel_attention_block(*args, **kw)
                ref = RA.rel_attention_block_reference(*args, **kw)
            tag = f"K1 B={b} T'={t} D={d} hd={d // H} {name} lengths {lengths.min()}-{lengths.max()}"
            err = check_close(tag, got, ref, _valid_rows(lengths, t))
            if dtype == torch.float32:
                out["max_abs_err"] = max(out["max_abs_err"], err)
    return out


def feed_forward_phase(card: str) -> dict:
    import torch

    from parakeet_tpu_torch.ops import feed_forward as FF

    log(f"== K6 fused_feed_forward vs fused_feed_forward_reference (B={B}, D={D}, F={FFN})")
    out = {"max_abs_err": 0.0, "times": {}, "bf16_times": {}, "work": {}, "bf16_work": {}}
    for t in (126, 751):
        for dtype, name in _dtypes():
            rng = np.random.RandomState(100 + t)
            dev = _dev(rng, dtype)
            x = dev(rng.randn(B, t, D))
            norms = [dev(1 + 0.1 * rng.randn(D), torch.float32), dev(0.1 * rng.randn(D), torch.float32)]
            weights = [dev(rng.randn(FFN, D) / np.sqrt(D)), dev(0.05 * rng.randn(FFN)),
                       dev(rng.randn(D, FFN) / np.sqrt(FFN)), dev(0.05 * rng.randn(D))]
            final = dict(final_norm_w=dev(1 + 0.1 * rng.randn(D), torch.float32),
                         final_norm_b=dev(0.1 * rng.randn(D), torch.float32))
            for with_final in (False, True):
                kw = final if with_final else {}
                args = (x, *norms, *weights)
                with torch.inference_mode():
                    got = FF.fused_feed_forward(*args, **kw)
                    ref = FF.fused_feed_forward_reference(*args, **kw)
                plan = FF.ffn_plan(B * t, D, FFN, got.element_size())
                tag = f"K6 T'={t} {name} final_norm={with_final} (fc2 in {plan.splits} k slices)"
                err = check_close(tag, got, ref)
                if dtype == torch.float32:
                    out["max_abs_err"] = max(out["max_abs_err"], err)
                if not with_final:
                    key = "times" if dtype == torch.float32 else "bf16_times"
                    out[key][t] = time_pair(tag, lambda: FF.fused_feed_forward(*args, **kw),
                                            lambda: FF.fused_feed_forward_reference(*args, **kw), card)
                    out[key.replace("times", "work")][t] = (ffn_flops(B * t, D, FFN), tensor_bytes(*args, got))
    # the 600m presets' widths (config.py make_600m_config: d=1024, ffn 4096)
    d6, f6 = 1024, 4096
    for dtype, name in _dtypes():
        rng = np.random.RandomState(1100)
        dev = _dev(rng, dtype)
        args = (dev(rng.randn(B, 126, d6)), dev(1 + 0.1 * rng.randn(d6), torch.float32),
                dev(0.1 * rng.randn(d6), torch.float32), dev(rng.randn(f6, d6) / np.sqrt(d6)),
                dev(0.05 * rng.randn(f6)), dev(rng.randn(d6, f6) / np.sqrt(f6)), dev(0.05 * rng.randn(d6)))
        kw = dict(final_norm_w=dev(1 + 0.1 * rng.randn(d6), torch.float32),
                  final_norm_b=dev(0.1 * rng.randn(d6), torch.float32))
        with torch.inference_mode():
            got = FF.fused_feed_forward(*args, **kw)
            ref = FF.fused_feed_forward_reference(*args, **kw)
        err = check_close(f"K6 T'=126 D={d6} F={f6} {name} final_norm=True", got, ref)
        if dtype == torch.float32:
            out["max_abs_err"] = max(out["max_abs_err"], err)
    return out


def _conv_args(rng, dev, b, t, d):
    x = dev(rng.randn(b, t, d))
    return (x, *_conv_weights(rng, dev, d))


def conv_module_phase(card: str) -> dict:
    import torch

    from parakeet_tpu_torch.ops import conv_module as CM

    log(f"== K5 fused_conv_module vs fused_conv_module_reference (B={B}, D={D}, k=9)")
    out = {"max_abs_err": 0.0, "times": {}, "bf16_times": {}, "work": {}, "bf16_work": {}, "stages": {}}
    for t in (126, 751):
        for dtype, name in _dtypes():
            rng = np.random.RandomState(200 + t)
            args = _conv_args(rng, _dev(rng, dtype), B, t, D)
            lengths = _mixed_lengths(rng, t)
            for masked in (True, False):
                lt = torch.as_tensor(lengths, dtype=torch.int32, device="cuda") if masked else None
                with torch.inference_mode():
                    got = CM.fused_conv_module(*args, lengths=lt)
                    ref = CM.fused_conv_module_reference(*args, lengths=lt)
                tag = f"K5 T'={t} {name} mixed_lengths={masked}"
                err = check_close(tag, got, ref)
                if dtype == torch.float32:
                    out["max_abs_err"] = max(out["max_abs_err"], err)
                if masked:
                    fn = lambda: CM.fused_conv_module(*args, lengths=lt)  # noqa: E731
                    key = "times" if dtype == torch.float32 else "bf16_times"
                    out[key][t] = time_pair(tag, fn, lambda: CM.fused_conv_module_reference(*args, lengths=lt), card)
                    out[key.replace("times", "work")][t] = (conv_flops(B * t, D, 9), tensor_bytes(*args, lt, got))
                    if dtype == torch.float32:
                        m = B * t
                        out["stages"][t] = stage_times(tag, fn, [("pw1", m, 2 * D, D), ("pw2", m, D, D)], card)
                        out["stages"][t]["tiles"] = tile_choice(tag, fn, CM, "conv_plan", "pw1", card)
    # the 600m widths (D=1024)
    d6 = 1024
    for dtype, name in _dtypes():
        rng = np.random.RandomState(1200)
        args = _conv_args(rng, _dev(rng, dtype), B, 126, d6)
        lt = torch.as_tensor(_mixed_lengths(rng, 126), dtype=torch.int32, device="cuda")
        with torch.inference_mode():
            got = CM.fused_conv_module(*args, lengths=lt)
            ref = CM.fused_conv_module_reference(*args, lengths=lt)
        err = check_close(f"K5 T'=126 D={d6} {name} mixed_lengths=True", got, ref)
        if dtype == torch.float32:
            out["max_abs_err"] = max(out["max_abs_err"], err)
    return out


def subsample_phase(card: str) -> dict:
    import torch

    from parakeet_tpu_torch.ops import subsample as SS

    log(f"== K8 fused_subsample_block1 vs fused_subsample_block1_reference (B={B}, mel {MEL}, C={SUB_C})")
    out = {"max_abs_err": 0.0, "times": {}, "bf16_times": {}, "work": {}, "bf16_work": {}, "stages": {}}
    cases = [(t, dtype, name, "relu") for t in (1001, 6001) for dtype, name in _dtypes()]
    cases += [(1001, dtype, name, "silu") for dtype, name in _dtypes()]
    for t, dtype, name, act in cases:
        rng = np.random.RandomState(300 + t)
        dev = _dev(rng, dtype)
        args = (dev(rng.randn(B, t, MEL)),
                dev(rng.randn(SUB_C, 1, 3, 3) / 3), dev(0.1 * rng.randn(SUB_C)),
                dev(rng.randn(SUB_C, 1, 3, 3) / 3), dev(0.1 * rng.randn(SUB_C)),
                dev(rng.randn(SUB_C, SUB_C, 1, 1) / 16), dev(0.1 * rng.randn(SUB_C)))
        with torch.inference_mode():
            got = SS.fused_subsample_block1(*args, activation=act)
            ref = SS.fused_subsample_block1_reference(*args, activation=act)
        m = B * SS.out_size(t) * SS.out_size(MEL)
        plan = SS.subsample_plan(m, SUB_C, got.element_size())
        tag = f"K8 T={t} {name} {act} -> {tuple(got.shape)} (conv2 on {plan.rows}-row tiles)"
        err = check_close(tag, got, ref)
        if dtype == torch.float32:
            out["max_abs_err"] = max(out["max_abs_err"], err)
        if act != "relu":
            continue
        fn = lambda: SS.fused_subsample_block1(*args, activation=act)  # noqa: E731
        key = "times" if dtype == torch.float32 else "bf16_times"
        out[key][t] = time_pair(tag, fn, lambda: SS.fused_subsample_block1_reference(*args, activation=act), card)
        out[key.replace("times", "work")][t] = (subsample_flops(B, t, MEL, SUB_C), tensor_bytes(*args, got))
        stages = stage_times(tag, fn, [("conv2", m, SUB_C, SUB_C)], card, dtype=dtype)
        out["stages"][(t, name)] = stages
        if dtype == torch.float32 and t == 1001:
            stages["tiles"] = tile_choice(tag, fn, SS, "subsample_plan", None, card)
    return out


def _ffn_weights(rng, dev, d=D, f=FFN):
    import torch

    f32 = torch.float32
    return [dev(1 + 0.1 * rng.randn(d), f32), dev(0.1 * rng.randn(d), f32),
            dev(rng.randn(f, d) / np.sqrt(d)), dev(0.05 * rng.randn(f)),
            dev(rng.randn(d, f) / np.sqrt(f)), dev(0.05 * rng.randn(d))]


def _conv_weights(rng, dev, d=D):
    import torch

    f32 = torch.float32
    return [dev(1 + 0.1 * rng.randn(d), f32), dev(0.1 * rng.randn(d), f32),
            dev(rng.randn(2 * d, d, 1) / np.sqrt(d)), dev(0.05 * rng.randn(2 * d)),
            dev(rng.randn(d, 1, 9) / 3), dev(0.05 * rng.randn(d)),
            dev(1 + 0.1 * rng.randn(d), f32), dev(0.1 * rng.randn(d), f32),
            dev(0.1 * rng.randn(d), f32), dev(1 + 0.2 * np.abs(rng.randn(d)), f32),
            dev(rng.randn(d, d, 1) / np.sqrt(d)), dev(0.05 * rng.randn(d))]


def _attention_weights(rng, dev, d=D, heads=H):
    hd = d // heads
    out = []
    for _ in range(3):
        out += [dev(rng.normal(0, 1 / np.sqrt(d), (d, d))), dev(rng.normal(0, 0.02, d))]
    return out + [dev(rng.normal(0, 0.02, (heads, hd))), dev(rng.normal(0, 0.02, (heads, hd))),
                  dev(rng.normal(0, 1 / np.sqrt(d), (d, d))), dev(rng.normal(0, 1 / np.sqrt(d), (d, d))),
                  dev(rng.normal(0, 0.02, d))]


def conv_ffn_final_phase(card: str) -> dict:
    import torch

    from parakeet_tpu_torch.ops import conv_ffn_final as K4

    log(f"== K4 fused_conv_ffn_final vs fused_conv_ffn_final_reference (B={B}, D={D}, F={FFN}, k=9)")
    out = {"max_abs_err": 0.0, "times": {}, "work": {}}
    for t in (126, 751):
        for dtype, name in _dtypes():
            rng = np.random.RandomState(400 + t)
            dev = _dev(rng, dtype)
            args = (dev(rng.randn(B, t, D)), *_conv_weights(rng, dev), *_ffn_weights(rng, dev),
                    dev(1 + 0.1 * rng.randn(D), torch.float32), dev(0.1 * rng.randn(D), torch.float32))
            lengths = _mixed_lengths(rng, t)
            lt = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
            with torch.inference_mode():
                got = K4.fused_conv_ffn_final(*args, lengths=lt)
                ref = K4.fused_conv_ffn_final_reference(*args, lengths=lt)
            tag = f"K4 T'={t} {name} mixed lengths"
            err = check_close(tag, got, ref)
            if dtype == torch.float32:
                out["max_abs_err"] = max(out["max_abs_err"], err)
                out["times"][t] = time_pair(tag, lambda: K4.fused_conv_ffn_final(*args, lengths=lt),
                                            lambda: K4.fused_conv_ffn_final_reference(*args, lengths=lt), card)
                out["work"][t] = (conv_flops(B * t, D, 9) + ffn_flops(B * t, D, FFN), tensor_bytes(*args, lt, got))
    return out


def ffn_attention_phase(card: str) -> dict:
    import torch

    from parakeet_tpu_torch.ops import ffn_attention as K7

    log(f"== K7 fused_ffn_attention vs fused_ffn_attention_reference (B={B}, D={D}, H={H}, F={FFN})")
    out = {"max_abs_err": 0.0, "times": {}, "work": {}}
    for t in (126, 751):
        for dtype, name in _dtypes():
            rng = np.random.RandomState(500 + t)
            dev = _dev(rng, dtype)
            args = (dev(rng.randn(B, t, D)), *_ffn_weights(rng, dev),
                    dev(1 + 0.1 * rng.randn(D), torch.float32), dev(0.1 * rng.randn(D), torch.float32),
                    *_attention_weights(rng, dev))
            lengths = _mixed_lengths(rng, t)
            lt = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
            with torch.inference_mode():
                got = K7.fused_ffn_attention(*args, lengths=lt)
                ref = K7.fused_ffn_attention_reference(*args, lengths=lt)
            tag = f"K7 T'={t} {name} mixed lengths"
            err = check_close(tag, got, ref, _valid_rows(lengths, t))
            if dtype == torch.float32:
                out["max_abs_err"] = max(out["max_abs_err"], err)
                out["times"][t] = time_pair(tag, lambda: K7.fused_ffn_attention(*args, lengths=lt),
                                            lambda: K7.fused_ffn_attention_reference(*args, lengths=lt), card)
                pe_bytes = (2 * t - 1) * D * got.element_size()
                out["work"][t] = (ffn_flops(B * t, D, FFN) + attention_flops(B, t, D, H, lengths),
                                  tensor_bytes(*args, lt, got) + pe_bytes)
    return out


def rel_attention_v1_phase(card: str) -> dict:
    import torch

    from parakeet_tpu_torch.ops import rel_attention as RA

    hd = D // H
    log(f"== K2 fused_rel_attention vs fused_rel_attention_reference (B={B}, H={H}, hd={hd})")
    out = {"max_abs_err": 0.0, "times": {}, "bf16_times": {}, "work": {}, "bf16_work": {}}
    # 126, 751, 1001: one pass over the keys (1001 is past the reference's
    # T <= 768 cap); B=1 at 3000: past the one-pass limit, the two-pass kernel
    for b, t in ((B, 126), (B, 751), (B, 1001), (1, 3000)):
        for dtype, name in _dtypes():
            rng = np.random.RandomState(600 + t)
            dev = _dev(rng, dtype)
            args = (*(dev(rng.randn(b, H, t, hd)) for _ in range(4)), dev(rng.randn(H, 2 * t - 1, hd)))
            lengths = _mixed_lengths(rng, t) if b == B else np.asarray([rng.randint(t // 2, t)])
            lt = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
            with torch.inference_mode():
                got = RA.fused_rel_attention(*args, lengths=lt)
                ref = RA.fused_rel_attention_reference(*args, lengths=lt)
            plan = RA.v1_plan(t, hd, got.element_size())
            if plan.one_pass != (t <= 1001):
                raise RuntimeError(f"K2 T'={t}: plan {plan} (one pass expected for T' <= 1001 only)")
            passes = f"one pass, {plan.rows} rows per block" if plan.one_pass else "two passes"
            tag = f"K2 B={b} T'={t} {name} lengths {lengths.min()}-{lengths.max()} ({passes})"
            err = check_close(tag, got.transpose(1, 2), ref.transpose(1, 2), _valid_rows(lengths, t))
            if dtype == torch.float32:
                out["max_abs_err"] = max(out["max_abs_err"], err)
            if b == B:
                key = "times" if dtype == torch.float32 else "bf16_times"
                out[key][t] = time_pair(tag, lambda: RA.fused_rel_attention(*args, lengths=lt),
                                        lambda: RA.fused_rel_attention_reference(*args, lengths=lt), card)
                out[key.replace("times", "work")][t] = (core_flops(t, hd, H, lengths), tensor_bytes(*args, lt, got))
    return out


def kernels_600m_phase(card: str) -> dict:
    """The kernels at the 600m presets' shapes (d=1024, F=4096, H=8,
    hd=128, 128 mel bins), each against its plain version in f32 and bf16,
    timed, with its bound: K8 on mel (8, 1001, 128); K7 and K4 at T'=126
    with mixed lengths; K2 at T'=126 and 751; K1 at B=1, T'=1188 (a dense
    95 s clip). Returns per kernel the entries its phase above returns,
    keyed by a shape label."""
    import torch

    from parakeet_tpu_torch.ops import conv_ffn_final as K4
    from parakeet_tpu_torch.ops import ffn_attention as K7
    from parakeet_tpu_torch.ops import rel_attention as RA
    from parakeet_tpu_torch.ops import subsample as SS

    d6, f6, hd6, mel6 = 1024, 4096, 1024 // H, 128
    log(f"== 600m shapes: K8 mel {mel6}, K7 and K4 D={d6} F={f6}, K2 hd={hd6}, K1 D={d6} at T'=1188")
    out = {name: {"max_abs_err": 0.0, "times": {}, "bf16_times": {}, "work": {}, "bf16_work": {}}
           for name in ("fused_subsample_block1", "fused_ffn_attention", "fused_conv_ffn_final",
                        "fused_rel_attention", "rel_attention_block")}

    def run(name, shape, dtype, dtname, fn, plain_fn, work, rows=None, view=None):
        with torch.inference_mode():
            got, ref = fn(), plain_fn()
        if view is not None:
            got, ref = view(got), view(ref)
        tag = f"{name} 600m {shape} {dtname}"
        err = check_close(tag, got, ref, rows)
        entry = out[name]
        if dtype == torch.float32:
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
        key = "times" if dtype == torch.float32 else "bf16_times"
        entry[key][shape] = time_pair(tag, fn, plain_fn, card)
        entry[key.replace("times", "work")][shape] = work(got)
        bd = bound(*entry[key.replace("times", "work")][shape], F32_PEAK if dtype == torch.float32 else BF16_PEAK)
        ms = entry[key][shape]
        log(f"  bound {tag}: {bd['gflop']:.3f} GFLOP, {bd['mbyte']:.2f} MB -> {bd['bound_ms']:.4f} ms by "
            f"{bd['bound_by']}; kernel / plain device {ms['dev_ms']:.4f} / {ms['plain_dev_ms']:.4f} ms "
            f"[{card}]")

    for dtype, name in _dtypes():
        rng = np.random.RandomState(1300)
        dev = _dev(rng, dtype)
        t = 1001
        args = (dev(rng.randn(B, t, mel6)),
                dev(rng.randn(SUB_C, 1, 3, 3) / 3), dev(0.1 * rng.randn(SUB_C)),
                dev(rng.randn(SUB_C, 1, 3, 3) / 3), dev(0.1 * rng.randn(SUB_C)),
                dev(rng.randn(SUB_C, SUB_C, 1, 1) / 16), dev(0.1 * rng.randn(SUB_C)))
        plan = SS.subsample_plan(B * SS.out_size(t) * SS.out_size(mel6), SUB_C, args[0].element_size())
        run("fused_subsample_block1", f"mel ({B}, {t}, {mel6}) C={SUB_C} (conv2 {plan.rows}-row tiles)", dtype,
            name, lambda: SS.fused_subsample_block1(*args), lambda: SS.fused_subsample_block1_reference(*args),
            lambda got: (subsample_flops(B, t, mel6, SUB_C), tensor_bytes(*args, got)))

        t = 126
        rng = np.random.RandomState(1400)
        dev = _dev(rng, dtype)
        lengths = _mixed_lengths(rng, t)
        lt = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
        k7 = (dev(rng.randn(B, t, d6)), *_ffn_weights(rng, dev, d6, f6),
              dev(1 + 0.1 * rng.randn(d6), torch.float32), dev(0.1 * rng.randn(d6), torch.float32),
              *_attention_weights(rng, dev, d6, H))
        run("fused_ffn_attention", f"B={B} T'={t} D={d6} F={f6}", dtype, name,
            lambda: K7.fused_ffn_attention(*k7, lengths=lt), lambda: K7.fused_ffn_attention_reference(*k7, lengths=lt),
            lambda got: (ffn_flops(B * t, d6, f6) + attention_flops(B, t, d6, H, lengths),
                         tensor_bytes(*k7, lt, got) + (2 * t - 1) * d6 * got.element_size()),
            rows=_valid_rows(lengths, t))
        k4 = (dev(rng.randn(B, t, d6)), *_conv_weights(rng, dev, d6), *_ffn_weights(rng, dev, d6, f6),
              dev(1 + 0.1 * rng.randn(d6), torch.float32), dev(0.1 * rng.randn(d6), torch.float32))
        run("fused_conv_ffn_final", f"B={B} T'={t} D={d6} F={f6}", dtype, name,
            lambda: K4.fused_conv_ffn_final(*k4, lengths=lt),
            lambda: K4.fused_conv_ffn_final_reference(*k4, lengths=lt),
            lambda got: (conv_flops(B * t, d6, 9) + ffn_flops(B * t, d6, f6), tensor_bytes(*k4, lt, got)))

        for t in (126, 751):
            rng = np.random.RandomState(1500 + t)
            dev = _dev(rng, dtype)
            k2 = (*(dev(rng.randn(B, H, t, hd6)) for _ in range(4)), dev(rng.randn(H, 2 * t - 1, hd6)))
            lengths = _mixed_lengths(rng, t)
            lt2 = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
            plan = RA.v1_plan(t, hd6, k2[0].element_size())
            passes = f"one pass, {plan.rows} rows per block" if plan.one_pass else "two passes"
            run("fused_rel_attention", f"B={B} T'={t} hd={hd6} ({passes})", dtype, name,
                lambda: RA.fused_rel_attention(*k2, lengths=lt2),
                lambda: RA.fused_rel_attention_reference(*k2, lengths=lt2),
                lambda got: (core_flops(t, hd6, H, lengths), tensor_bytes(*k2, lt2, got)),
                rows=_valid_rows(lengths, t), view=lambda a: a.transpose(1, 2))

        t = 1188
        rng = np.random.RandomState(1600)
        dev = _dev(rng, dtype)
        k1 = _attention_args(rng, dev, 1, t, d6, H)
        lengths = np.asarray([t])
        kw = dict(lengths=torch.as_tensor(lengths, dtype=torch.int32, device="cuda"),
                  norm_w=dev(1 + rng.normal(0, 0.1, d6), torch.float32),
                  norm_b=dev(rng.normal(0, 0.1, d6), torch.float32))
        run("rel_attention_block", f"B=1 T'={t} D={d6} hd={hd6}", dtype, name,
            lambda: RA.rel_attention_block(*k1, **kw), lambda: RA.rel_attention_block_reference(*k1, **kw),
            lambda got: (attention_flops(1, t, d6, H, lengths),
                         tensor_bytes(*k1, *kw.values(), got) + (2 * t - 1) * d6 * got.element_size()))
        if dtype == torch.float32:  # where K1's time goes at the dense 95 s shape
            stage_times(f"K1 600m B=1 T'={t} f32", lambda: RA.rel_attention_block(*k1, **kw),
                        [("QKV", t, 3 * d6, d6), ("P", 2 * t - 1, d6, d6), ("out", t, d6, d6)], card)
    return out


def dft_choice(tag: str, fn, module, card: str) -> dict:
    """Device time of `fn` under each DFT launch plan of 64 or 128 rows and
    1, 2, 4 or 8 k slices (one slice: the power epilogue, no partials),
    each timed twice; the port always runs `dft_plan`'s choice."""
    import torch

    from parakeet_tpu_torch.ops.gemm_plan import GemmPlan, gemm_smem

    planner = module.dft_plan
    ms = {}
    options = [(rows, splits) for rows in (64, 128) for splits in (1, 2, 4, 8)]
    with torch.inference_mode():
        for rows, splits in options + options[::-1]:
            module.dft_plan = lambda t, n_fft, r=rows, z=splits: GemmPlan(r, z, gemm_smem(r, 4), 0)
            try:
                t = device_ms(fn)
            finally:
                module.dft_plan = planner
            ms[(rows, splits)] = min(ms.get((rows, splits), float("inf")), t)
    log(f"  {tag} DFT plans, device ms of the whole call (best of 2): "
        + ", ".join(f"{r} rows x {z} slices {v:.4f}" for (r, z), v in ms.items()) + f" [{card}]")
    return ms


def log_mel_phase(card: str) -> dict:
    import torch

    from parakeet_tpu_torch.audio.frontend import _preemphasize_and_pad
    from parakeet_tpu_torch.config import AudioConfig
    from parakeet_tpu_torch.ops import log_mel as K3

    log("== K3 fused_log_mel vs fused_log_mel_reference (one clip, n_fft 512, hop 160, 80 mels)")
    out = {"max_abs_err": 0.0, "times": {}, "work": {}, "stages": {}}
    for seconds in (10, 60):
        clip = synthetic_clips(1, seed=700 + seconds, min_s=seconds, max_s=seconds)[0]
        x = torch.from_numpy(_preemphasize_and_pad(clip, AudioConfig())).to("cuda")
        with torch.inference_mode():
            got = K3.fused_log_mel(x)
            ref = K3.fused_log_mel_reference(x)
        frames, bins = got.shape[0], 512 // 2 + 1
        plan = K3.dft_plan(frames, 512)
        tag = (f"K3 {seconds} s clip -> {tuple(got.shape)} f32 (DFT on {plan.rows}-row tiles, "
               f"{plan.splits} k slice{'s' if plan.splits > 1 else ''})")
        err = check_close(tag, got, ref, atol=LOG_MEL_ATOL, rtol=0.0)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        fn = lambda: K3.fused_log_mel(x)  # noqa: E731
        out["times"][seconds] = time_pair(tag, fn, lambda: K3.fused_log_mel_reference(x), card)
        # the DFT (frames x n_fft @ n_fft x 2·257) and the mel product over the
        # filterbank's nonzero weights (501 of 257 x 80; the dense product
        # adds exact zeros); bytes: samples, the window·cos/sin matrices, the
        # nonzero weights, the log-mel
        nnz = K3.filterbank_bands(K3._filterbank(512, MEL, 16000.0, 0.0, None))[0].size
        out["work"][seconds] = (2 * frames * 512 * 2 * bins + 2 * frames * nnz,
                                tensor_bytes(x, got) + 4 * (2 * bins * 512 + nnz))
        stages = stage_times(tag, fn, [("DFT", frames, 2 * bins, 512), ("mel", frames, MEL, bins)], card)
        stages["plans"] = dft_choice(tag, fn, K3, card)
        out["stages"][seconds] = stages
    return out


def synthetic_clips(n: int, seed: int, sr: int = 16000, min_s: float = 2.0, max_s: float = 10.0):
    rng = np.random.RandomState(seed)
    clips = []
    for _ in range(n):
        dur = rng.uniform(min_s, max_s)
        tt = np.arange(int(dur * sr)) / sr
        f0 = rng.uniform(90, 250)
        env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2, 5) * tt))
        voice = sum(np.sin(2 * np.pi * f0 * k * tt) / k for k in range(1, 6))
        clips.append((0.1 * env * voice + 0.01 * rng.randn(tt.size)).astype(np.float32))
    return clips


def transducer_margin(tr, enc, item: int, tokens: list[int], step: int, frame: int) -> float:
    """Top-2 label log-prob gap of the transducer decision after `step`
    emissions of `tokens`, at encoder frame `frame`, on `tr`'s device: the
    TDT joint's label head, or the RNNT joint's."""
    import torch

    from parakeet_tpu_torch.models.rnnt import (
        joint_encoder_projection, prediction_step, prediction_zero_state, rnnt_joint_precomputed,
        tdt_joint_precomputed)
    from parakeet_tpu_torch.params import Params

    cfg = tr.config
    root = Params(tr.params)
    pred_p, joint_p = root.sub("prediction_"), root.sub(tr.joint_prefix)
    with torch.inference_mode():
        state = prediction_zero_state(cfg.prediction.num_lstm_layers, 1, cfg.prediction.pred_hidden,
                                      device=tr.device)
        for tok in [tr._blank_id] + tokens[:step]:
            pred, state = prediction_step(pred_p, torch.tensor([tok], device=tr.device), state,
                                          cfg.prediction.num_lstm_layers)
        enc_pre = joint_encoder_projection(joint_p, enc[item: item + 1, frame])
        if tr.is_tdt:
            label_lp, _ = tdt_joint_precomputed(joint_p, enc_pre, pred)
        else:
            label_lp = rnnt_joint_precomputed(joint_p, enc_pre, pred)
        top2 = torch.topk(label_lp[0], 2).values
    return float(top2[0] - top2[1])


def _spans(res) -> list[tuple[int, int, int]]:
    return [(t.token_id, t.start_frame, t.end_frame) for t in res.timestamped_tokens]


def compare_tokens(name: str, gpu_res, cpu_res, margin_fn) -> None:
    """Card and CPU tokens identical (and their frames, where timestamped);
    at the first difference, its top-2 margin on the CPU, then a failure."""
    for i, (g, c) in enumerate(zip(gpu_res, cpu_res)):
        if g.token_ids == c.token_ids:
            if _spans(g) != _spans(c):
                j = next(k for k, (a, b) in enumerate(zip(_spans(g), _spans(c))) if a != b)
                raise RuntimeError(f"{name}: item {i} token {j} frames differ: gpu {_spans(g)[j]} vs cpu "
                                   f"{_spans(c)[j]}")
            continue
        j = next((k for k, (a, b) in enumerate(zip(g.token_ids, c.token_ids)) if a != b),
                 min(len(g.token_ids), len(c.token_ids)))
        log(f"  {name}: item {i} differs first at token {j}: "
            f"gpu {g.token_ids[j:j + 3]} vs cpu {c.token_ids[j:j + 3]}")
        log(f"  {name}: top-2 log-prob margin there (cpu) {margin_fn(i, j, c):.3e}")
        raise RuntimeError(f"{name}: card and CPU tokens differ")


def edit_distance(a: list[int], b: list[int]) -> int:
    row = list(range(len(b) + 1))
    for i, x in enumerate(a, 1):
        prev, row[0] = row[0], i
        for j, y in enumerate(b, 1):
            prev, row[j] = row[j], min(row[j] + 1, row[j - 1] + 1, prev + (x != y))
    return row[-1]


def counters():
    from parakeet_tpu_torch.ops import (
        conv_ffn_final, conv_module, feed_forward, ffn_attention, log_mel, rel_attention, subsample)

    return {"rel_attention_block": rel_attention.rel_attention_block,
            "fused_feed_forward": feed_forward.fused_feed_forward,
            "fused_conv_module": conv_module.fused_conv_module,
            "fused_subsample_block1": subsample.fused_subsample_block1,
            "fused_conv_ffn_final": conv_ffn_final.fused_conv_ffn_final,
            "fused_ffn_attention": ffn_attention.fused_ffn_attention,
            "fused_rel_attention": rel_attention.fused_rel_attention,
            "fused_log_mel": log_mel.fused_log_mel}


def reset_counts() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_counts() -> dict:
    return {k: fn.launches for k, fn in counters().items()}


def launches_per_encoder_call(fused, layers: int, mel_frames: int, mel_bins: int, quantized: bool = False) -> dict:
    """Each kernel's launches in one encoder call under `fused` on a batch
    padded to `mel_frames`, with the reference's precedence (mega over
    ffn1; block2 over conv and ffn2) and its input guards (the subsampling
    kernel at T4 >= 32 and even F2; the FFN, mega and block2 kernels at
    T' >= 64, "mega" giving way to the attention block kernel). On a
    `quantized` model (every linear weight int8 or int4) its weight guards
    too: the FFN, mega and block2 kernels and K1 decline, every attention
    takes the v1 route (K2), the conv modules follow fused.conv."""
    if quantized:
        plain = {k: 0 for k in launches_per_encoder_call(fused, layers, mel_frames, mel_bins)}
        sub = launches_per_encoder_call(fused, layers, mel_frames, mel_bins)["fused_subsample_block1"]
        return dict(plain, fused_subsample_block1=sub, fused_rel_attention=layers,
                    fused_conv_module=layers if fused.conv else 0)
    t4 = ((mel_frames - 1) // 2) // 2 + 1
    long_enough = (t4 - 1) // 2 + 1 >= 64
    sub = fused.subsample and t4 >= 32 and ((mel_bins - 1) // 2 + 1) % 2 == 0
    ffn, block2 = fused.ffn and long_enough, fused.block2 and long_enough
    mega = fused.attention == "mega" and long_enough
    return {"rel_attention_block": layers if fused.attention != "v1" and not mega else 0,
            "fused_feed_forward": layers * ((ffn and not mega) + (ffn and not block2)),
            "fused_conv_module": layers if fused.conv and not block2 else 0,
            "fused_subsample_block1": 1 if sub else 0,
            "fused_conv_ffn_final": layers if block2 else 0,
            "fused_ffn_attention": layers if mega else 0,
            "fused_rel_attention": layers if fused.attention == "v1" else 0,
            "fused_log_mel": 0}


# the facades chip_smoke drives: class, config preset, the decoders it checks
MODELS = {
    "tdt-ctc-110m": ("Transcriber", "make_110m_config", ("TDT", "CTC")),
    "tdt-600m": ("TDTTranscriber", "make_tdt_600m_config", ("TDT",)),
    "rnnt-600m": ("RNNTTranscriber", "make_rnnt_600m_config", ("RNNT",)),
}


def model_params(model: str) -> dict:
    """Seeded random weights (seed 0) of a model at full width, as numpy."""
    from parakeet_tpu_torch import config as C
    from parakeet_tpu_torch import params as P

    spec = {"tdt-ctc-110m": P.tdt_ctc_spec, "tdt-600m": P.tdt_spec, "rnnt-600m": P.rnnt_spec}[model]
    return P.init_params_numpy(spec(getattr(C, MODELS[model][1])()), seed=0)


def facade(model: str, device: str, **kw):
    from parakeet_tpu_torch import config as C
    from parakeet_tpu_torch import transcribe as T

    cls, cfg, _ = MODELS[model]
    return getattr(T, cls)(config=getattr(C, cfg)(), device=device, **kw)


def wall_ms(fn, n: int) -> float:
    """Median host-clock ms of n synchronised calls."""
    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[n // 2]


def resident(make):
    """(make(), the device bytes it holds): torch.cuda.memory_allocated
    before and after make() builds a facade."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    obj = make()
    torch.cuda.synchronize()
    return obj, torch.cuda.memory_allocated() - before


def path_phase(name: str, fused, flat, clips, card: str, model: str = "tdt-ctc-110m", quantize=None) -> dict:
    """One model and encoder configuration end to end on the card against
    the CPU: each of the model's decoders (TDT and CTC for tdt-ctc, the
    transducer alone for TDT-only and RNNT, where CTC must raise). With
    `quantize` ("int8" or "int4") both facades quantize the weights and the
    launch counts follow the reference's weight guards."""
    import torch

    from parakeet_tpu_torch.audio.frontend import preprocess_audio_batch
    from parakeet_tpu_torch.models.encoder import encoded_lengths
    from parakeet_tpu_torch.transcribe import Decoder, TranscribeOptions

    gpu, weight_bytes = resident(lambda: facade(model, "cuda", params=flat, fused=fused, quantize=quantize))
    cpu = facade(model, "cpu", params=flat, fused=fused, quantize=quantize)
    cfg = gpu.config
    layers = cfg.encoder.num_layers
    log(f"== path {name}: {model}, {layers} layers, d={cfg.encoder.hidden_size}, {cfg.encoder.mel_bins} mel, "
        f"vocab {cfg.joint.vocab_size}, {cfg.prediction.num_lstm_layers} LSTM layers, random weights (seed 0), "
        f"f32, {fused}, weights {quantize or 'f32'}: {weight_bytes / 1e9:.3f} GB on the card "
        f"(torch.cuda.memory_allocated after load)")
    audio_s = sum(len(c) for c in clips) / 16000.0
    decoders = MODELS[model][2]
    opts = {dec: TranscribeOptions(Decoder.CTC) if dec == "CTC" else TranscribeOptions(Decoder.TDT, timestamps=True)
            for dec in decoders}
    tdt = opts[decoders[0]]
    if not gpu.has_ctc:
        try:
            gpu.transcribe_batch(clips, TranscribeOptions(Decoder.CTC))
        except ValueError as e:
            log(f"  Decoder.CTC raises ValueError as it should: {e}")
        else:
            raise RuntimeError(f"{name}: Decoder.CTC on a model without a CTC head did not raise")

    gpu.transcribe_batch(clips, tdt)  # warm-up (cuDNN autotune, allocator)
    torch.cuda.synchronize()
    feats, n_frames = preprocess_audio_batch(clips, cpu._audio_cfg, "cpu")
    per_call = launches_per_encoder_call(fused, layers, feats.shape[1], feats.shape[2], quantized=bool(quantize))
    reset_counts()
    gpu_res, steps = {}, []
    for dec in decoders:
        gpu_res[dec] = gpu.transcribe_batch(clips, opts[dec])
        steps.append(read_counts())
    launches = steps[-1]
    per_dec = [{k: c[k] - (steps[i - 1][k] if i else 0) for k in c} for i, c in enumerate(steps)]
    log(f"  kernel launches ({' call, '.join(decoders)} call; one encoder call each): "
        + ", ".join(f"{k} {' + '.join(str(d[k]) for d in per_dec)}" for k in launches if per_call[k]))
    for dec, counts in zip(decoders, per_dec):
        for k, n in per_call.items():
            if counts[k] != n:
                raise RuntimeError(f"{name}: expected {n} {k} launches per encoder call, got {counts[k]} in the "
                                   f"{dec} call")

    for res in gpu_res.values():
        for r in res:
            if not r.token_ids:
                raise RuntimeError(f"{name}: an item decoded to no tokens")
            for tok in r.timestamped_tokens:
                if not (0 <= tok.token_id < cfg.joint.vocab_size - 1 and tok.start_frame <= tok.end_frame
                        and 0.0 < tok.confidence <= 1.0):
                    raise RuntimeError(f"{name}: malformed timestamped token {tok}")

    cpu_res = {dec: cpu.transcribe_batch(clips, opts[dec]) for dec in decoders}
    enc_cpu = cpu.encode(feats, n_frames)
    enc_gpu = gpu.encode(feats, n_frames).cpu()
    enc_lens = encoded_lengths(torch.as_tensor(n_frames)).tolist()
    enc_diff = max(float((enc_gpu[i, :n] - enc_cpu[i, :n]).abs().max()) for i, n in enumerate(enc_lens))
    enc_scale = max(float(enc_cpu[i, :n].abs().max()) for i, n in enumerate(enc_lens))
    if not torch.isfinite(enc_gpu).all():
        raise RuntimeError(f"{name}: encoder output on the card is not finite")
    if tuple(enc_gpu.shape) != (len(clips), max(enc_lens), cfg.encoder.hidden_size):
        raise RuntimeError(f"{name}: encoder output shape {tuple(enc_gpu.shape)}")
    log(f"  encoder card vs CPU: max|diff| {enc_diff:.3e} over valid frames (scale {enc_scale:.3f})")

    def transducer_margin_at(i, j, res):
        ts = res.timestamped_tokens
        frame = ts[j].start_frame if j < len(ts) else enc_lens[i] - 1
        return transducer_margin(cpu, enc_cpu, i, res.token_ids, j, frame)

    def ctc_margin_at(i, j, res):
        lp = cpu.ctc_log_probs(enc_cpu)[i, : enc_lens[i]]
        best = lp.argmax(-1)
        gpu_best = gpu.ctc_log_probs(enc_gpu.to("cuda"))[i, : enc_lens[i]].argmax(-1).cpu()
        frame = int(torch.nonzero(best != gpu_best)[0]) if bool((best != gpu_best).any()) else 0
        top2 = torch.topk(lp[frame], 2).values
        return float(top2[0] - top2[1])

    for dec in decoders:
        compare_tokens(f"{name} {dec}", gpu_res[dec], cpu_res[dec],
                       ctc_margin_at if dec == "CTC" else transducer_margin_at)
    log("  tokens identical on card and CPU: " + ", ".join(
        f"{dec} {sum(len(r.token_ids) for r in gpu_res[dec])} tokens" for dec in decoders))
    if enc_diff > ENC_SCALE_FRAC * enc_scale:
        raise RuntimeError(f"{name}: encoder on the card differs from the CPU by more than "
                           f"{ENC_SCALE_FRAC:.0e} of scale")

    wall = wall_ms(lambda: gpu.transcribe_batch(clips, tdt), 3)
    out = {"launches": launches, "per_call": per_dec[0], "wall_s": wall / 1e3, "rtfx": audio_s / (wall / 1e3),
           "enc_diff": enc_diff, "weight_bytes": weight_bytes,
           "tdt": [r.token_ids for r in gpu_res[decoders[0]]], "ctc": [r.token_ids for r in gpu_res.get("CTC", [])]}
    if quantize:  # its encoder's device time is taken in turns with f32's (options_phase)
        log(f"  warm {decoders[0]} batch {wall:.1f} ms (median of 3), {out['rtfx']:.1f} audio s per wall s [{card}]")
        return out
    feats_gpu = feats.to(gpu.device)
    with torch.inference_mode():
        front = wall_ms(lambda: gpu.prepare_batch(clips, tdt), 5)
        enc = wall_ms(lambda: gpu.encode(feats_gpu, n_frames), 5)
        enc_dev = device_ms(lambda: gpu.encode(feats_gpu, n_frames), calls=3)
    batch_dev = device_ms(lambda: gpu.transcribe_batch(clips, tdt), calls=1, profiles=1)
    log(f"  stages, wall ms (median of 5): frontend {front:.3f}, encoder {enc:.3f} "
        f"(device time {enc_dev:.3f}); warm {decoders[0]} batch {wall:.1f} ms (median of 3), "
        f"{out['rtfx']:.1f} audio s per wall s; one profiled batch: device time "
        f"{batch_dev:.3f} ms, busy {batch_dev / wall:.1%} of the median wall [{card}]")
    return dict(out, enc_ms=enc, enc_dev_ms=enc_dev)


def long_audio_phase(flat, card: str) -> dict:
    """tdt-600m at full width on long clips of 95, 62 and 7 s through
    transcribe_batch, in the default configuration, against the CPU:
    long_audio="window" (the 12 + 8 = 20 windows of 10 s overlapping by
    2 s in one call at B=20, the 7 s clip densely), then long_audio="dense"
    (the 95 s clip alone, T' = 1188). Tokens and frames identical to the
    CPU's, per call and merged; launch counts exact."""
    import torch

    from parakeet_tpu_torch.audio.frontend import preprocess_audio_batch
    from parakeet_tpu_torch.models.encoder import FusedLayers, encoded_lengths
    from parakeet_tpu_torch.transcribe import Decoder, TranscribeOptions

    model = "tdt-600m"
    lengths_s = (95.0, 62.0, 7.0)
    clips = [synthetic_clips(1, seed=900 + i, min_s=sec, max_s=sec)[0] for i, sec in enumerate(lengths_s)]
    opts = TranscribeOptions(Decoder.TDT, timestamps=True)
    out = {}
    for mode, batch in (("window", clips), ("dense", clips[:1])):
        gpu = facade(model, "cuda", params=flat, long_audio=mode)
        cpu = facade(model, "cpu", params=flat, long_audio=mode)
        layers = gpu.config.encoder.num_layers
        log(f"== long audio, long_audio={mode!r}: {model} default configuration, clips of "
            f"{', '.join(f'{len(c) / 16000:.0f}' for c in batch)} s")

        def capture(tr):
            calls = []
            real = tr._transcribe_batch_dense

            def dense(sources, o=None, **kw):
                res = real(sources, o, **kw)
                calls.append(([np.asarray(x) for x in sources], res))
                return res

            tr._transcribe_batch_dense = dense
            return calls

        gpu.transcribe_batch(batch, opts)  # warm-up
        torch.cuda.synchronize()
        gpu_calls, cpu_calls = capture(gpu), capture(cpu)
        reset_counts()
        gpu_res = gpu.transcribe_batch(batch, opts)
        launches = read_counts()
        sizes = [len(srcs) for srcs, _ in gpu_calls]
        want_sizes = [1, 20] if mode == "window" else [1]
        t_primes = [int(encoded_lengths(torch.as_tensor([max(len(x) for x in srcs) // 160 + 1]))[0])
                    for srcs, _ in gpu_calls]
        log(f"  dense calls: batch sizes {sizes}, padded T' {t_primes}; kernel launches {launches}")
        if sizes != want_sizes:
            raise RuntimeError(f"long audio {mode}: dense calls of {sizes} items, want {want_sizes}")
        want = launches_per_encoder_call(FusedLayers(), layers, 1, gpu.config.encoder.mel_bins)
        for k, n in want.items():
            if launches[k] != n * len(sizes):
                raise RuntimeError(f"long audio {mode}: {launches[k]} {k} launches, want {n * len(sizes)}")
        cpu_res = cpu.transcribe_batch(batch, opts)
        for (srcs, g), (_, c) in zip(gpu_calls, cpu_calls):
            enc_cache = {}

            def margin_at(i, j, res, srcs=srcs, enc_cache=enc_cache):
                if not enc_cache:
                    feats, n_frames = preprocess_audio_batch(srcs, cpu._audio_cfg, "cpu")
                    enc_cache["enc"] = cpu.encode(feats, n_frames)
                ts = res.timestamped_tokens
                frame = ts[j].start_frame if j < len(ts) else enc_cache["enc"].shape[1] - 1
                return transducer_margin(cpu, enc_cache["enc"], i, res.token_ids, j, frame)

            compare_tokens(f"long audio {mode}, dense call of {len(srcs)}", g, c, margin_at)
        for i, (g, c) in enumerate(zip(gpu_res, cpu_res)):
            if g.token_ids != c.token_ids or _spans(g) != _spans(c):
                raise RuntimeError(f"long audio {mode}: clip {i} merged tokens or frames differ on card and CPU")
            if not g.token_ids:
                raise RuntimeError(f"long audio {mode}: clip {i} decoded to no tokens")
        log(f"  tokens and frames identical on card and CPU: {[len(r.token_ids) for r in gpu_res]} tokens per clip, "
            f"each dense call too")
        audio_s = sum(len(c) for c in batch) / 16000.0
        wall = wall_ms(lambda: gpu.transcribe_batch(batch, opts), 3)
        dev = device_ms(lambda: gpu.transcribe_batch(batch, opts), calls=1, profiles=1)
        log(f"  warm call {wall:.1f} ms (median of 3), {audio_s / (wall / 1e3):.1f} audio s per wall s; one profiled "
            f"call: device time {dev:.3f} ms, busy {dev / wall:.1%} of the median wall [{card}]")
        out[mode] = {"launches": launches, "wall_ms": wall, "dev_ms": dev, "sizes": sizes, "t_primes": t_primes}
        del gpu, cpu
        torch.cuda.empty_cache()
    return out


def fused_frontend_phase(flat, clips, card: str) -> dict:
    """preprocess_audio_fused (K3) on each clip on the card, then
    transcribe_features; tokens against a CPU Transcriber on the same
    features, and the card's features against the CPU's."""
    import torch

    from parakeet_tpu_torch.audio.frontend import preprocess_audio_fused
    from parakeet_tpu_torch.config import make_110m_config
    from parakeet_tpu_torch.transcribe import Decoder, TranscribeOptions, Transcriber

    cfg = make_110m_config()
    log(f"== path fused frontend: preprocess_audio_fused per clip (K3), then transcribe_features "
        f"(tdt-ctc-110m, default encoder configuration), f32")
    gpu = Transcriber(config=cfg, params=flat, device="cuda")
    cpu = Transcriber(config=cfg, params=flat, device="cpu")
    audio_cfg = gpu._audio_cfg
    preprocess_audio_fused(clips[0], audio_cfg, "cuda")  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    feats = [preprocess_audio_fused(c, audio_cfg, "cuda") for c in clips]
    torch.cuda.synchronize()
    launches = read_counts()
    log(f"  kernel launches: fused_log_mel {launches['fused_log_mel']} for {len(clips)} clips")
    if launches["fused_log_mel"] != len(clips):
        raise RuntimeError(f"fused frontend: expected {len(clips)} fused_log_mel launches, got "
                           f"{launches['fused_log_mel']}")
    feat_diff = 0.0
    for c, f in zip(clips, feats):
        want_t = len(c) // audio_cfg.hop_length + 1
        if tuple(f.shape) != (1, want_t, audio_cfg.n_mels) or not torch.isfinite(f).all():
            raise RuntimeError(f"fused frontend: features of shape {tuple(f.shape)} (want "
                               f"{(1, want_t, audio_cfg.n_mels)}) or not finite")
        feat_diff = max(feat_diff, float((f.cpu() - preprocess_audio_fused(c, audio_cfg, "cpu")).abs().max()))
    log(f"  features card vs CPU (plain log-mel): max|diff| {feat_diff:.3e} (normalised features)")
    if feat_diff > 2 * LOG_MEL_ATOL:
        raise RuntimeError("fused frontend: card features differ from the CPU's")
    opts = TranscribeOptions(Decoder.TDT)
    host = [f[0].cpu().numpy() for f in feats]
    gpu_res = [gpu.transcribe_features(f, opts) for f in host]
    cpu_res = [cpu.transcribe_features(f, opts) for f in host]
    for i, (g, c) in enumerate(zip(gpu_res, cpu_res)):
        if not g.token_ids:
            raise RuntimeError(f"fused frontend: item {i} decoded to no tokens")
        if g.token_ids != c.token_ids:
            raise RuntimeError(f"fused frontend: item {i} tokens differ on card and CPU")
    log(f"  tokens identical on card and CPU: TDT {sum(len(r.token_ids) for r in gpu_res)} tokens")
    with torch.inference_mode():
        fused_ms = median_ms(lambda: [preprocess_audio_fused(c, audio_cfg, "cuda") for c in clips], iters=5)
        batch_ms = median_ms(lambda: gpu.prepare_batch(clips), iters=5)
    log(f"  frontend for the 8 clips, CUDA-event ms (median of 5): fused per clip {fused_ms:.3f}, "
        f"batched plain {batch_ms:.3f} [{card}]")
    return {"launches": launches}


def bf16_phase(fused, flat, clips, f32_tdt) -> None:
    from parakeet_tpu_torch.config import make_110m_config
    from parakeet_tpu_torch.transcribe import Decoder, TranscribeOptions, Transcriber

    log("== bf16: the fused path in bf16 on the card, TDT tokens against f32 (reported, not a gate)")
    tr = Transcriber(config=make_110m_config(), params=flat, device="cuda", compute_dtype="bfloat16",
                     fused=fused)
    res = tr.transcribe_batch(clips, TranscribeOptions(Decoder.TDT))
    dists = [edit_distance(r.token_ids, ref) for r, ref in zip(res, f32_tdt)]
    log(f"  per-clip token edit distance bf16 vs f32: {dists} "
        f"({sum(dists)} over {sum(len(t) for t in f32_tdt)} f32 tokens)")


def _percentile(values, q: float) -> float:
    s = sorted(values)
    return s[min(len(s) - 1, int(round(q * (len(s) - 1))))]


def _stream_pushes(audio, size: int = 2560):
    """160 ms pushes of a 16 kHz clip."""
    return [audio[i: i + size] for i in range(0, len(audio), size)]


def _run_stream(tr, pushes, times=None):
    """A streaming facade from reset() through `pushes`; each chunk's
    synchronised wall ms into `times` when given. Returns (tokens, spans)."""
    import torch

    tr.reset()
    for x in pushes:
        if times is not None:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        tr.transcribe_chunk(x)
        if times is not None:
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
    return tr.get_tokens(), [(t.token_id, t.start_frame, t.end_frame) for t in tr.get_timestamped_tokens()]


def _same_spans(name: str, gpu_spans, cpu_spans) -> None:
    if gpu_spans != cpu_spans:
        j = next((k for k, (a, b) in enumerate(zip(gpu_spans, cpu_spans)) if a != b),
                 min(len(gpu_spans), len(cpu_spans)))
        raise RuntimeError(f"{name}: card and CPU differ first at token {j}: gpu {gpu_spans[j:j + 3]} vs cpu "
                           f"{cpu_spans[j:j + 3]} ({len(gpu_spans)} vs {len(cpu_spans)} tokens)")


def _no_launches(name: str, launches: dict) -> None:
    """The streaming encoder runs no kernel, as in the reference (its
    cached attention and chunk-sized layers are plain XLA there)."""
    if any(launches.values()):
        raise RuntimeError(f"{name}: kernel launches on the streaming path: {launches}")


def streaming_facade_check(name: str, gpu, cpu, pushes, card: str) -> dict:
    """One streaming facade on the card against the CPU facade fed the same
    pushes: tokens and frames identical, no kernel launched, per-chunk
    synchronised wall ms, and the device busy share over the first 6
    chunks (a profile of tens of thousands of host ops is slow)."""
    t0 = time.perf_counter()
    _run_stream(gpu, pushes)  # warm-up (cuDNN autotune, allocator)
    reset_counts()
    times = []
    toks, spans = _run_stream(gpu, pushes, times)
    launches = read_counts()
    _no_launches(name, launches)
    _, cpu_spans = _run_stream(cpu, pushes)
    _same_spans(name, spans, cpu_spans)
    if not toks:
        raise RuntimeError(f"{name}: no tokens")
    head = pushes[:6]
    wall = wall_ms(lambda: _run_stream(gpu, head), 3)
    dev = device_ms(lambda: _run_stream(gpu, head), calls=1, profiles=1)
    res = {"launches": launches, "tokens": toks, "chunk_ms": float(np.median(times)),
           "chunk_p95_ms": _percentile(times, 0.95), "busy": dev / wall}
    log(f"  {name}: {len(toks)} tokens, identical to the CPU with their frames; kernel launches none; per 160 ms "
        f"push, synchronised wall ms: median {res['chunk_ms']:.3f}, p95 {res['chunk_p95_ms']:.3f} over "
        f"{len(times)} pushes; first {len(head)} pushes {wall:.1f} ms wall, {dev:.3f} ms device, busy "
        f"{res['busy']:.1%} [{card}] ({time.perf_counter() - t0:.1f} s)")
    return res


def batch_stream_scenario(bt, pcm, times=None) -> tuple[list, int]:
    """B slots of int16 PCM in 160 ms pushes: slot 3's push 10 arrives one
    push late (its lag is held), slot 5 is reset at push 20 and replays its
    audio from the start; steps run whenever a slot can step, the lagging
    slots held. Returns (each slot's spans, held steps)."""
    import torch

    bt.reset()
    pushes = [_stream_pushes(p) for p in pcm]
    held = 0

    def drain():
        nonlocal held
        while bt.ready_any():
            hold = bt.lagging_slots()
            held += bool(hold)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bt.step(hold=hold)
            torch.cuda.synchronize()
            if times is not None:
                times.append((time.perf_counter() - t0) * 1e3)

    for k in range(len(pushes[0])):
        for i in range(bt.batch):
            if (i, k) == (3, 10):
                continue
            if (i, k) == (3, 11):
                bt.push(i, pushes[i][10])
            bt.push(i, pushes[i][k])
        if k == 20:
            bt.reset_slot(5)
            for x in pushes[5][: k + 1]:
                bt.push(5, x)
        drain()
    return [[(t.token_id, t.start_frame, t.end_frame) for t in bt.get_timestamped_tokens(i)]
            for i in range(bt.batch)], held


def streaming_phase(card: str) -> dict:
    """Streaming ASR at full width: eou-120m (StreamingTranscriber, B=1, 8 s
    in 160 ms pushes, f32 and bf16), nemotron-600m (NemotronTranscriber) in
    latency modes 0, 1, 6 and 13 (4 s each), and StreamingBatchTranscriber
    eou-120m at B=8 with the fused frontend and the int16 wire (a held step
    and a reset_slot); each against a CPU facade fed the same pushes."""
    import torch

    from parakeet_tpu_torch import config as C
    from parakeet_tpu_torch import params as P
    from parakeet_tpu_torch.streaming import NemotronTranscriber, StreamingBatchTranscriber, StreamingTranscriber

    out = {}
    eou_cfg = C.make_eou_120m_config()
    flat = P.init_params_numpy(P.eou_spec(eou_cfg), seed=0)
    audio = synthetic_clips(1, seed=1700, min_s=8, max_s=8)[0]
    pushes = _stream_pushes(audio)
    log(f"== streaming eou-120m: {eou_cfg.encoder.num_layers} layers, d={eou_cfg.encoder.hidden_size}, "
        f"left {eou_cfg.encoder.att_context_left}, right {eou_cfg.encoder.att_context_right}, random weights "
        f"(seed 0), f32, B=1, 8 s in {len(pushes)} pushes")
    gpu = StreamingTranscriber(config=eou_cfg, params=flat, device="cuda")
    cpu = StreamingTranscriber(config=eou_cfg, params=flat, device="cpu")
    out["eou"] = streaming_facade_check("eou-120m B=1", gpu, cpu, pushes, card)
    b16 = StreamingTranscriber(config=eou_cfg, params=flat, device="cuda", compute_dtype="bfloat16")
    b16_toks, _ = _run_stream(b16, pushes)
    dist = edit_distance(b16_toks, out["eou"]["tokens"])
    log(f"  eou-120m bf16 on the card: {len(b16_toks)} tokens, edit distance {dist} against the "
        f"{len(out['eou']['tokens'])} f32 tokens (reported, not a gate)")
    out["eou"]["bf16_edit_distance"] = dist
    del gpu, cpu, b16

    t0 = time.perf_counter()
    log("== streaming StreamingBatchTranscriber eou-120m: B=8, fused frontend, int16 wire, 8 s per slot")
    clips = synthetic_clips(8, seed=1800, min_s=8, max_s=8)
    pcm = [np.clip(c * 32768, -32768, 32767).astype(np.int16) for c in clips]
    kw = dict(config=eou_cfg, params=flat, frontend="fused", wire_dtype="int16")
    gpu = StreamingBatchTranscriber(8, device="cuda", **kw)
    cpu = StreamingBatchTranscriber(8, device="cpu", **kw)
    batch_stream_scenario(gpu, pcm)  # warm-up
    reset_counts()
    times = []
    spans, held = batch_stream_scenario(gpu, pcm, times)
    launches = read_counts()
    _no_launches("batch B=8", launches)
    cpu_spans, cpu_held = batch_stream_scenario(cpu, pcm)
    for i, (g, c) in enumerate(zip(spans, cpu_spans)):
        _same_spans(f"batch B=8 slot {i}", g, c)
    if not held or held != cpu_held or not all(spans):
        raise RuntimeError(f"batch B=8: {held} held steps (CPU {cpu_held}), tokens per slot "
                           f"{[len(s) for s in spans]}")
    head = [p[: 6 * 2560] for p in pcm]
    wall = wall_ms(lambda: batch_stream_scenario(gpu, head), 3)
    dev = device_ms(lambda: batch_stream_scenario(gpu, head), calls=1, profiles=1)
    out["batch"] = {"launches": launches, "step_ms": float(np.median(times)),
                    "step_p95_ms": _percentile(times, 0.95), "busy": dev / wall}
    log(f"  tokens per slot {[len(s) for s in spans]}, identical to the CPU with their frames; {held} steps with "
        f"held slots; kernel launches none; per step, synchronised wall ms: median {out['batch']['step_ms']:.3f}, "
        f"p95 {out['batch']['step_p95_ms']:.3f} over {len(times)} steps; 6 pushes per slot {wall:.1f} ms wall, "
        f"{dev:.3f} ms device, busy {out['batch']['busy']:.1%} [{card}] ({time.perf_counter() - t0:.1f} s)")
    del gpu, cpu, flat

    t0 = time.perf_counter()
    nemo_flat = P.init_params_numpy(P.nemotron_spec(C.make_nemotron_600m_config()), seed=0)
    nemo_audio = synthetic_clips(1, seed=1750, min_s=4, max_s=4)[0]
    log(f"== streaming nemotron-600m: {sum(a.size for a in nemo_flat.values()) / 1e6:.1f} M parameters "
        f"({time.perf_counter() - t0:.1f} s to draw), f32, B=1, 4 s in {len(_stream_pushes(nemo_audio))} pushes "
        f"per latency mode")
    for mode in (0, 1, 6, 13):
        cfg = C.make_nemotron_600m_config(mode)
        gpu = NemotronTranscriber(config=cfg, params=nemo_flat, device="cuda")
        cpu = NemotronTranscriber(config=cfg, params=nemo_flat, device="cpu")
        out[f"nemotron-{mode}"] = streaming_facade_check(f"nemotron-600m latency {mode} (right {mode})", gpu, cpu,
                                                         _stream_pushes(nemo_audio), card)
        del gpu, cpu
        torch.cuda.empty_cache()
    return out


def _diarization_agrees(name: str, gpu_probs, cpu_probs, gpu_segs, cpu_segs, thr: float) -> dict:
    """Probabilities within DIAR_PROB_ATOL of the CPU's; frames active on
    the card and the CPU alike except where the CPU's probability lies
    within 1e-4 of the threshold (reported); the segments identical when no
    frame lies there."""
    g, c = np.asarray(gpu_probs), np.asarray(cpu_probs)
    if g.shape != c.shape or not np.isfinite(g).all():
        raise RuntimeError(f"{name}: probabilities of shape {g.shape} vs {c.shape}, or not finite")
    diff = float(np.abs(g - c).max()) if g.size else 0.0
    near = np.abs(c - thr) < 1e-4
    if diff > DIAR_PROB_ATOL or not np.array_equal((g > thr)[~near], (c > thr)[~near]):
        raise RuntimeError(f"{name}: probabilities differ by {diff:.3e} or frames flip away from the threshold")
    seg = lambda s: [(x.speaker_id, x.start, x.end) for x in s]  # noqa: E731
    if not near.any() and seg(gpu_segs) != seg(cpu_segs):
        raise RuntimeError(f"{name}: segments differ on card and CPU")
    return {"max_abs_diff": diff, "near_threshold": int(near.sum()), "segments": len(gpu_segs)}


def diarize_phase(card: str) -> dict:
    """Sortformer-117m at full width (17 NEST layers, d=512, 128 mel, 18
    post-norm transformer layers): forward on 10 s and 60 s clips (K1 17
    times a forward), diarize_chunk over 10 s in 160 ms chunks (the
    streaming NEST session, no kernel), DiarizedTranscriber.transcribe on a
    10 s clip (tdt-ctc-110m and Sortformer, K1 17 + 17), each against the
    CPU; then K1 at Sortformer's B=1, T'=751, D=512 against its plain
    version, timed, with its bound."""
    import torch

    from parakeet_tpu_torch import config as C
    from parakeet_tpu_torch import params as P
    from parakeet_tpu_torch.audio.frontend import preprocess_audio
    from parakeet_tpu_torch.diarize import DiarizedTranscriber
    from parakeet_tpu_torch.models import sortformer as SF
    from parakeet_tpu_torch.ops import rel_attention as RA

    cfg = C.make_sortformer_117m_config()
    thr = cfg.activity_threshold
    flat = P.init_params_numpy(P.sortformer_spec(cfg), seed=0)
    gpu = SF.Sortformer(config=cfg, params=flat, device="cuda")
    cpu = SF.Sortformer(config=cfg, params=flat, device="cpu")
    acfg = C.AudioConfig(n_mels=cfg.nest_encoder.mel_bins, normalize=False)
    layers = cfg.nest_encoder.num_layers
    log(f"== diarize: Sortformer-117m, NEST {layers} layers d={cfg.nest_encoder.hidden_size}, "
        f"{cfg.nest_encoder.mel_bins} mel, transformer {cfg.transformer.num_layers} layers d="
        f"{cfg.transformer.hidden_size}, random weights (seed 0), f32")
    out = {"forward": {}}
    clips = {sec: synthetic_clips(1, seed=1900 + sec, min_s=sec, max_s=sec)[0] for sec in (10, 60)}
    for sec, clip in clips.items():
        feats = preprocess_audio(clip, acfg, "cpu")
        gpu.forward(feats)  # warm-up
        torch.cuda.synchronize()
        reset_counts()
        probs = gpu.forward(feats)[0].cpu().numpy()
        launches = read_counts()
        want = {k: (layers if k == "rel_attention_block" else 0) for k in launches}
        if launches != want:
            raise RuntimeError(f"Sortformer {sec} s: kernel launches {launches}, want {want}")
        cpu_probs = cpu.forward(feats)[0].numpy()
        agree = _diarization_agrees(f"Sortformer {sec} s", probs, cpu_probs, SF.probs_to_segments(probs, thr),
                                    SF.probs_to_segments(cpu_probs, thr), thr)
        with torch.inference_mode():
            wall = wall_ms(lambda: gpu.forward(feats), 5)
            dev = device_ms(lambda: gpu.forward(feats), calls=3)
        out["forward"][sec] = dict(agree, launches=launches, wall_ms=wall, dev_ms=dev, frames=probs.shape[0])
        log(f"  forward {sec} s (T'={probs.shape[0]}): K1 launches {launches['rel_attention_block']}; probabilities "
            f"max|diff| {agree['max_abs_diff']:.3e} vs the CPU; {agree['segments']} segments, "
            f"{agree['near_threshold']} frame-speakers within 1e-4 of the threshold; wall {wall:.3f} ms (median "
            f"of 5), device {dev:.3f} ms, busy {dev / wall:.1%} [{card}]")
    out["launches"] = out["forward"][60]["launches"]

    feats10 = preprocess_audio(clips[10], acfg, "cpu").numpy()
    chunks = [feats10[:, i: i + 16] for i in range(0, feats10.shape[1], 16)]

    def run_chunks(sf, times=None):
        sf.reset_stream()
        aosc, segs, probs = SF.AOSCCache(cfg.max_speakers), [], []
        real = SF.probs_to_segments
        SF.probs_to_segments = lambda p, t=0.5: (probs.append(np.asarray(p)), real(p, t))[1]
        try:
            for ch in chunks:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                segs.append(sf.diarize_chunk(ch, aosc))
                torch.cuda.synchronize()
                if times is not None:
                    times.append((time.perf_counter() - t0) * 1e3)
        finally:
            SF.probs_to_segments = real
        return segs, probs, aosc.speaker_order()

    run_chunks(gpu)  # warm-up
    reset_counts()
    times = []
    g_segs, g_probs, g_order = run_chunks(gpu, times)
    launches = read_counts()
    _no_launches("diarize_chunk", launches)
    c_segs, c_probs, c_order = run_chunks(cpu)
    near = 0
    for i, (gs, gp, cs, cp) in enumerate(zip(g_segs, g_probs, c_segs, c_probs)):
        near += _diarization_agrees(f"diarize_chunk {i}", gp, cp, gs, cs, thr)["near_threshold"]
    if len(g_probs) != len(c_probs) or (not near and g_order != c_order):
        raise RuntimeError(f"diarize_chunk: {len(g_probs)} vs {len(c_probs)} chunks decoded, arrival order "
                           f"{g_order} vs {c_order}")
    diff = max(float(np.abs(g - c).max()) for g, c in zip(g_probs, c_probs) if g.size)
    out["chunks"] = {"launches": launches, "chunk_ms": float(np.median(times)),
                     "chunk_p95_ms": _percentile(times, 0.95)}
    log(f"  diarize_chunk over 10 s in {len(chunks)} chunks of 16 mel frames: kernel launches none; probabilities "
        f"max|diff| {diff:.3e}; {sum(map(len, g_segs))} segments, {near} frame-speakers within 1e-4 of the "
        f"threshold; arrival order {g_order}; per chunk, synchronised wall ms: median {out['chunks']['chunk_ms']:.3f}, "
        f"p95 {out['chunks']['chunk_p95_ms']:.3f} [{card}]")
    del gpu, cpu

    asr_flat = model_params("tdt-ctc-110m")
    asr_cfg = C.make_110m_config()
    vocab = smoke_vocab(asr_cfg.joint.vocab_size)
    dts = {dev: DiarizedTranscriber(vocab_path=str(vocab), config=asr_cfg, sf_config=cfg, asr_params=asr_flat,
                                    sortformer_params=flat, device=dev) for dev in ("cuda", "cpu")}
    probs = {}
    for dev, dt in dts.items():
        real = dt.sortformer.forward
        dt.sortformer.forward = lambda f, real=real, dev=dev: probs.setdefault(dev, real(f))
    dts["cuda"].transcribe(clips[10])  # warm-up
    probs.clear()
    reset_counts()
    res = dts["cuda"].transcribe(clips[10])
    launches = read_counts()
    want = {k: (2 * layers if k == "rel_attention_block" else 0) for k in launches}
    if launches != want:
        raise RuntimeError(f"DiarizedTranscriber: kernel launches {launches}, want {want}")
    cres = dts["cpu"].transcribe(clips[10])
    words = lambda r: [(w.word, w.start, w.end) for w in r.word_timestamps]  # noqa: E731
    if words(res) != words(cres) or not res.words:
        raise RuntimeError("DiarizedTranscriber: words or their times differ on card and CPU, or none")
    agree = _diarization_agrees("DiarizedTranscriber", probs["cuda"][0].cpu().numpy(), probs["cpu"][0].numpy(),
                                res.segments, cres.segments, thr)
    speakers = [w.speaker_id for w in res.words]
    if not agree["near_threshold"] and speakers != [w.speaker_id for w in cres.words]:
        raise RuntimeError("DiarizedTranscriber: speakers differ on card and CPU")
    wall = wall_ms(lambda: dts["cuda"].transcribe(clips[10]), 3)
    out["transcriber"] = {"launches": launches, "wall_ms": wall}
    log(f"  DiarizedTranscriber.transcribe 10 s: {len(res.words)} words, identical to the CPU with their times and "
        f"speakers {sorted(set(speakers))}; K1 launches {launches['rel_attention_block']} (ASR {layers} + "
        f"Sortformer {layers}); warm call {wall:.1f} ms (median of 3) [{card}]")
    del dts

    t = out["forward"][60]["frames"]
    rng = np.random.RandomState(1950)
    dev = _dev(rng, torch.float32)
    d = cfg.nest_encoder.hidden_size
    k1 = _attention_args(rng, dev, 1, t, d, H)
    lengths = np.asarray([t])
    kw = dict(lengths=torch.as_tensor(lengths, dtype=torch.int32, device="cuda"),
              norm_w=dev(1 + rng.normal(0, 0.1, d), torch.float32), norm_b=dev(rng.normal(0, 0.1, d), torch.float32))
    with torch.inference_mode():
        got = RA.rel_attention_block(*k1, **kw)
        ref = RA.rel_attention_block_reference(*k1, **kw)
    shape = f"B=1 T'={t} D={d} hd={d // H} (Sortformer 60 s)"
    tag = f"K1 {shape} f32"
    err = check_close(tag, got, ref)
    ms = time_pair(tag, lambda: RA.rel_attention_block(*k1, **kw), lambda: RA.rel_attention_block_reference(*k1, **kw),
                   card)
    work = (attention_flops(1, t, d, H, lengths), tensor_bytes(*k1, *kw.values(), got) + (2 * t - 1) * d * 4)
    bd = bound(*work)
    log(f"  bound {tag}: {bd['gflop']:.3f} GFLOP, {bd['mbyte']:.2f} MB -> {bd['bound_ms']:.4f} ms by "
        f"{bd['bound_by']}; kernel / plain device {ms['dev_ms']:.4f} / {ms['plain_dev_ms']:.4f} ms [{card}]")
    out["k1"] = {"max_abs_err": err, "times": {shape: ms}, "work": {shape: work}}
    return out


def smoke_vocab(vocab_size: int) -> Path:
    """No vocabulary ships with the repo: a synthetic one under build/, one
    word piece per token, so each token is a word with its own times."""
    path = ROOT / "build" / "parakeet_tpu_torch" / "smoke_vocab.txt"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("".join(f"▁w{i}\n" for i in range(vocab_size - 1)), encoding="utf-8")
    return path


def smoke_arpa(pieces: list[str], seed: int = 2100) -> Path:
    """A bigram ARPA LM over `pieces` under build/, drawn from a seed:
    every piece a unigram with a backoff, 4000 random bigrams."""
    rng = np.random.RandomState(seed)
    uni = np.log10(rng.dirichlet(np.ones(len(pieces) + 1)))
    pairs = sorted({(int(a), int(b)) for a, b in rng.randint(0, len(pieces), size=(4000, 2))})
    lines = ["\\data\\", f"ngram 1={len(pieces) + 2}", f"ngram 2={len(pairs)}", "", "\\1-grams:",
             "-99 <s> -0.3"]
    lines += [f"{lp:.4f} {p} -0.3" for lp, p in zip(uni, pieces)] + [f"{uni[-1]:.4f} </s>", "", "\\2-grams:"]
    lines += [f"{np.log10(rng.uniform(0.05, 0.5)):.4f} {pieces[a]} {pieces[b]}" for a, b in pairs]
    path = ROOT / "build" / "parakeet_tpu_torch" / "smoke_lm.arpa"
    path.write_text("\n".join(lines + ["", "\\end\\", ""]), encoding="utf-8")
    return path


def encoder_turns(tag: str, facades: dict, feats, n_frames, card: str) -> dict:
    """Device ms of each facade's encoder on the same features, in turns
    (every facade, then again in reverse order), the lesser of the two."""
    import torch

    feats = feats.to(next(iter(facades.values())).device)
    ms = {}
    with torch.inference_mode():
        for name in [*facades, *reversed(facades)]:
            t = device_ms(lambda: facades[name].encode(feats, n_frames), calls=3)
            ms[name] = min(ms.get(name, float("inf")), t)
    log(f"  {tag} encoder device ms (torch.profiler, best of 2 turns): "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f" [{card}]")
    return ms


def decode_options_phase(flat, clips, card: str) -> dict:
    """Phrase boosting, beam search and LMs on tdt-ctc-110m (default
    configuration, f32, a synthetic vocab under build/) against the CPU:
    TDT and CTC with boost_phrases, TDT beam 4 (and beam 1, which must
    equal greedy), CTC beam 8 with an n-gram LM written by this script,
    TDT beam 4 rescored by NeuralLM.random. Beam scores from the same
    encoder output (the CPU's) on the card and the CPU within
    BEAM_SCORE_RTOL, the CTC beam's from each device's log-probs."""
    import torch

    from parakeet_tpu_torch.audio.frontend import preprocess_audio_batch
    from parakeet_tpu_torch.decode.beam_transducer import transducer_beam_decode
    from parakeet_tpu_torch.decode.ctc_beam import ctc_beam_search
    from parakeet_tpu_torch.models.encoder import FusedLayers, encoded_lengths
    from parakeet_tpu_torch.text.neural_lm import NeuralLM, NeuralLMConfig
    from parakeet_tpu_torch.text.ngram_lm import NgramLM
    from parakeet_tpu_torch.transcribe import Decoder, TranscribeOptions

    vocab = smoke_vocab(1025)
    gpu = facade("tdt-ctc-110m", "cuda", params=flat, vocab_path=str(vocab))
    cpu = facade("tdt-ctc-110m", "cpu", params=flat, vocab_path=str(vocab))
    cfg = gpu.config
    layers = cfg.encoder.num_layers
    feats, n_frames = preprocess_audio_batch(clips, cpu._audio_cfg, "cpu")
    per_call = launches_per_encoder_call(FusedLayers(), layers, feats.shape[1], feats.shape[2])
    pieces = gpu.tokenizer.pieces
    ngram = NgramLM.from_arpa(smoke_arpa(pieces)).bind(pieces)
    lm_cfg = NeuralLMConfig(vocab_size=cfg.joint.vocab_size)
    lms = {tr: NeuralLM.random(lm_cfg, seed=0, device=tr.device) for tr in (gpu, cpu)}
    log(f"== decode options: tdt-ctc-110m default configuration, f32, {len(clips)} clips, synthetic vocab "
        f"({len(pieces)} pieces), n-gram LM {ngram.lm.order}-gram ({len(ngram.lm.probs)} n-grams), "
        f"NeuralLM.random d={lm_cfg.hidden} {lm_cfg.num_layers} layers")
    boost = dict(boost_phrases=["w10 w20 w30", "w7 w8", "w512"], boost_score=5.0)
    # name: (options, LM, checked against the CPU); greedy and beam 1 are the card's own baselines
    runs = {
        "TDT greedy": (TranscribeOptions(Decoder.TDT, timestamps=True), None, False),
        "TDT boost": (TranscribeOptions(Decoder.TDT, timestamps=True, **boost), None, True),
        "CTC greedy": (TranscribeOptions(Decoder.CTC, timestamps=True), None, False),
        "CTC boost": (TranscribeOptions(Decoder.CTC, timestamps=True, **boost), None, True),
        "TDT beam 1": (TranscribeOptions(Decoder.TDT, timestamps=True, beam_size=1), None, False),
        "TDT beam 4": (TranscribeOptions(Decoder.TDT, timestamps=True, beam_size=4), None, True),
        "CTC beam 8 + n-gram LM": (TranscribeOptions(Decoder.CTC, timestamps=True, beam_size=8, lm=ngram,
                                                     lm_weight=0.2), None, True),
        "TDT beam 4 + neural LM": (TranscribeOptions(Decoder.TDT, timestamps=True, beam_size=4, lm_weight=0.5),
                                   "neural", True),
    }
    out = {}
    for name, (opts, lm, on_cpu) in runs.items():
        cpu_opts = opts
        if lm == "neural":
            opts, cpu_opts = replace(opts, lm=lms[gpu]), replace(opts, lm=lms[cpu])
        gpu.transcribe_batch(clips, opts)  # warm-up
        reset_counts()
        res = gpu.transcribe_batch(clips, opts)
        launches = read_counts()
        if launches != per_call:
            raise RuntimeError(f"{name}: kernel launches {launches}, want {per_call}")
        for i, (g, c) in enumerate(zip(res, cpu.transcribe_batch(clips, cpu_opts) if on_cpu else res)):
            if g.token_ids != c.token_ids or _spans(g) != _spans(c):
                raise RuntimeError(f"{name}: item {i} tokens or frames differ on card and CPU")
        if not any(r.token_ids for r in res):
            raise RuntimeError(f"{name}: no tokens in the batch")
        wall = wall_ms(lambda: gpu.transcribe_batch(clips, opts), 3)
        out[name] = {"wall_ms": wall, "tokens": [r.token_ids for r in res], "starts": [
            [t.start_frame for t in r.timestamped_tokens] for r in res]}
        same = ", identical to the CPU with their frames" if on_cpu else ""
        log(f"  {name}: {sum(len(r.token_ids) for r in res)} tokens{same}; K1 launches "
            f"{launches['rel_attention_block']}; warm batch of {len(clips)} {wall:.1f} ms wall (median of 3) [{card}]")
    for dec in ("TDT", "CTC"):
        changed = sum(a != b for a, b in zip(out[f"{dec} boost"]["tokens"], out[f"{dec} greedy"]["tokens"]))
        log(f"  {dec} boost changed the tokens of {changed}/{len(clips)} clips against greedy")
        if not changed:
            raise RuntimeError(f"{dec} boost changed no clip: the boost did not reach the decode")
    if (out["TDT beam 1"]["tokens"], out["TDT beam 1"]["starts"]) != (out["TDT greedy"]["tokens"],
                                                                      out["TDT greedy"]["starts"]):
        raise RuntimeError("TDT beam 1 differs from the greedy decode on the card")
    log("  TDT beam 1 equals greedy on the card (tokens and emission frames)")

    # path scores: the transducer beam from the CPU's encoder output on both
    # devices; the CTC beam from each device's own log-probs
    enc_lens = encoded_lengths(torch.as_tensor(n_frames)).tolist()
    enc_cpu = cpu.encode(feats, n_frames)
    kw = dict(num_lstm_layers=cfg.prediction.num_lstm_layers, durations=tuple(cfg.durations),
              blank_id=gpu._blank_id, joint_prefix=gpu.joint_prefix, enc_lengths=enc_lens, beam_size=4, n_best=4)
    g_hyps = transducer_beam_decode(gpu.params, enc_cpu.to(gpu.device), **kw)
    c_hyps = transducer_beam_decode(cpu.params, enc_cpu, **kw)
    worst = 0.0
    for i, (gl, cl) in enumerate(zip(g_hyps, c_hyps)):
        if [(h.tokens, h.frames) for h in gl] != [(h.tokens, h.frames) for h in cl]:
            raise RuntimeError(f"TDT beam 4: item {i} n-best tokens or frames differ on card and CPU")
        worst = max([worst] + [abs(g.score - c.score) / abs(c.score) for g, c in zip(gl, cl)])
    ctc_worst = 0.0
    lp_g = gpu.ctc_log_probs(gpu.encode(feats, n_frames)).cpu().numpy()
    lp_c = cpu.ctc_log_probs(enc_cpu).numpy()
    for i, t in enumerate(enc_lens):
        g = ctc_beam_search(lp_g[i, :t], gpu._blank_id, beam_size=8, lm=ngram, lm_weight=0.2)[0]
        c = ctc_beam_search(lp_c[i, :t], cpu._blank_id, beam_size=8, lm=ngram, lm_weight=0.2)[0]
        if g.tokens != c.tokens:
            raise RuntimeError(f"CTC beam 8 + n-gram LM: item {i} tokens differ on card and CPU")
        ctc_worst = max(ctc_worst, abs(g.score - c.score) / abs(c.score))
    log(f"  beam path scores card vs CPU, worst relative difference: TDT beam 4 n-best {worst:.2e} (same encoder "
        f"output), CTC beam 8 + LM {ctc_worst:.2e} (each device's log-probs); limit {BEAM_SCORE_RTOL:.0e}")
    if max(worst, ctc_worst) > BEAM_SCORE_RTOL:
        raise RuntimeError("beam path scores differ on card and CPU")
    return {name: {"wall_ms": r["wall_ms"]} for name, r in out.items()} | {
        "tdt_beam_score_rel": worst, "ctc_beam_score_rel": ctc_worst}


def w8a8_phase(flat, clips, card: str) -> dict:
    """W8A8 (set_int8_compute(True)) on tdt-ctc-110m int8, default
    configuration, against the CPU. W8A8 rounds every activation to an int8
    code, a step function: the card's and the CPU's encoders differ by
    ~1e-6 before the first rounding, which moves some codes by one, so
    their tokens need not be identical. What must agree: every integer
    product of one encoder call bit for bit (torch._int_mm on the card's
    codes against the CPU's float64 product of the same codes), the launch
    counts, W8A8's mean error against weight-only int8 (on the CPU) on the
    card within W8A8_ERR_RATIO of the CPU's own, and the
    decoders under W8A8 from one encoder output (the card's, on both
    devices): TDT tokens with their frames and CTC tokens identical. The
    whole pipeline's token edit distances are reported."""
    import torch

    from parakeet_tpu_torch.audio.frontend import preprocess_audio_batch
    from parakeet_tpu_torch.decode.transducer import transducer_greedy_decode
    from parakeet_tpu_torch.models.ctc import ctc_greedy_decode
    from parakeet_tpu_torch.models.encoder import FusedLayers, encoded_lengths
    from parakeet_tpu_torch.ops import layers as L
    from parakeet_tpu_torch.transcribe import Decoder, TranscribeOptions

    gpu = facade("tdt-ctc-110m", "cuda", params=flat, quantize="int8")
    cpu = facade("tdt-ctc-110m", "cpu", params=flat, quantize="int8")
    layers = gpu.config.encoder.num_layers
    feats, n_frames = preprocess_audio_batch(clips, cpu._audio_cfg, "cpu")
    valid = encoded_lengths(torch.as_tensor(n_frames)).tolist()
    per_call = launches_per_encoder_call(FusedLayers(), layers, feats.shape[1], feats.shape[2], quantized=True)
    opts = {"TDT": TranscribeOptions(Decoder.TDT, timestamps=True), "CTC": TranscribeOptions(Decoder.CTC)}
    weight_only = cpu.encode(feats, n_frames)
    log("== W8A8: tdt-ctc-110m int8 weights, set_int8_compute(True), default configuration, f32 activations")

    def diffs(a, b):
        d = [(a[i, :n] - b[i, :n]).abs() for i, n in enumerate(valid)]
        return max(float(x.max()) for x in d), float(torch.cat([x.flatten() for x in d]).mean())

    L.set_int8_compute(True)
    real = L.int8_matmul
    try:
        exact = []

        def checked(xq, w):
            y = real(xq, w)
            exact.append(torch.equal(y.cpu(), real(xq.cpu(), w.cpu())))
            return y

        L.int8_matmul = checked
        try:
            enc_gpu = gpu.encode(feats, n_frames).cpu()
        finally:
            L.int8_matmul = real
        if not exact or not all(exact):
            raise RuntimeError(f"W8A8: {exact.count(False)} of {len(exact)} integer products differ from the CPU's")
        enc_cpu = cpu.encode(feats, n_frames)
        if not torch.isfinite(enc_gpu).all():
            raise RuntimeError("W8A8: encoder output on the card is not finite")
        card_max, card_mean = diffs(enc_gpu, enc_cpu)
        own_max, own_mean = diffs(enc_cpu, weight_only)
        card_own_max, card_own_mean = diffs(enc_gpu, weight_only)
        log(f"  {len(exact)} integer products of one encoder call identical on card and CPU (torch._int_mm vs "
            f"float64); encoder card vs CPU max|diff| {card_max:.3e}, mean {card_mean:.3e}; W8A8's error against "
            f"weight-only int8 (CPU): on the CPU max {own_max:.3e}, mean {own_mean:.3e}, on the card max "
            f"{card_own_max:.3e}, mean {card_own_mean:.3e} (limit {W8A8_ERR_RATIO} x the CPU's mean)")
        if card_own_mean > W8A8_ERR_RATIO * own_mean:
            raise RuntimeError("W8A8: the card's error against weight-only int8 exceeds the CPU's")

        # the decoders under W8A8 from one encoder output (the card's, on
        # both devices): TDT tokens and frames, CTC tokens identical
        kw = dict(pred_hidden=gpu.config.prediction.pred_hidden, durations=tuple(gpu.config.durations),
                  num_lstm_layers=gpu.config.prediction.num_lstm_layers, blank_id=gpu._blank_id,
                  enc_lengths=valid)
        same_enc = []  # (card, CPU): TDT spans, CTC tokens
        for tr, enc in ((gpu, enc_gpu.to(gpu.device)), (cpu, enc_gpu)):
            with torch.inference_mode():
                tdt = transducer_greedy_decode(tr.params, enc, **kw)
                ctc = ctc_greedy_decode(tr.ctc_log_probs(enc), tr._blank_id, valid)
            same_enc.append(([[(t.token_id, t.start_frame, t.end_frame) for t in ts] for ts in tdt.timestamped],
                             ctc))
        if same_enc[0] != same_enc[1]:
            raise RuntimeError("W8A8: from one encoder output, the card's TDT or CTC decode differs from the CPU's")
        log(f"  from one encoder output (the card's): W8A8 TDT decode {sum(map(len, same_enc[1][0]))} tokens "
            f"with frames, CTC {sum(map(len, same_enc[1][1]))} tokens, identical on card and CPU")

        gpu.transcribe_batch(clips, opts["TDT"])  # warm-up
        reset_counts()
        res, steps = {}, []
        for dec, o in opts.items():
            res[dec] = gpu.transcribe_batch(clips, o)
            steps.append(read_counts())
        for i, (dec, counts) in enumerate(zip(opts, steps)):
            got = {k: v - (steps[i - 1][k] if i else 0) for k, v in counts.items()}
            if got != per_call:
                raise RuntimeError(f"W8A8 {dec}: kernel launches {got}, want {per_call}")
        dist = {dec: [edit_distance(g.token_ids, c.token_ids)
                      for g, c in zip(res[dec], cpu.transcribe_batch(clips, o))] for dec, o in opts.items()}
        enc_dev = device_ms(lambda: gpu.encode(feats.to(gpu.device), n_frames), calls=3)
        wall = wall_ms(lambda: gpu.transcribe_batch(clips, opts["TDT"]), 3)
    finally:
        L.set_int8_compute(False)
    log(f"  launches per encoder call {', '.join(f'{k} {v}' for k, v in per_call.items() if v)}; token edit "
        f"distance card vs CPU per clip: " + "; ".join(
            f"{dec} {d} of {sum(len(r.token_ids) for r in res[dec])}" for dec, d in dist.items())
        + f" (reported); encoder device {enc_dev:.3f} ms, warm TDT batch {wall:.1f} ms wall [{card}]")
    return {"per_call": steps[0], "enc_dev_ms": enc_dev, "wall_ms": wall, "edit_distance": dist,
            "products": len(exact), "enc_mean_diff": card_mean, "own_mean_err": own_mean,
            "card_own_mean_err": card_own_mean}


def options_phase(flat6, clips, card: str) -> dict:
    """Quantized weights and the decode options at full width: tdt-ctc-110m
    with quantize="int8" and "int4" in the default and fused
    configurations and W8A8 (int8, default), tdt-600m with int8 (default),
    each a path against the CPU with exact launch counts under the weight
    guards; each quantized encoder's device ms against f32 in turns, with
    resident weight bytes; the decode options (decode_options_phase); and
    eou-120m streaming with int8, no kernel launched."""
    import torch

    from parakeet_tpu_torch import config as C
    from parakeet_tpu_torch import params as P
    from parakeet_tpu_torch.audio.frontend import preprocess_audio_batch
    from parakeet_tpu_torch.models.encoder import FusedLayers
    from parakeet_tpu_torch.ops.layers import set_int8_compute
    from parakeet_tpu_torch.streaming import StreamingTranscriber

    t0 = time.perf_counter()

    def part(name):
        log(f"  ({name}: {time.perf_counter() - t0:.1f} s into the phase)")

    flat = model_params("tdt-ctc-110m")
    fused_cfg = FusedLayers(ffn=True, conv=True, subsample=True)
    out = {}
    for mode in ("int8", "int4"):
        for label, cfg in (("default", FusedLayers()), ("fused", fused_cfg)):
            out[f"{mode} {label}"] = path_phase(f"{mode} {label}", cfg, flat, clips, card, quantize=mode)
    part("110m quantized paths")
    out["w8a8 default"] = w8a8_phase(flat, clips, card)
    part("W8A8")

    feats, n_frames = preprocess_audio_batch(clips, C.AudioConfig(n_mels=80), "cpu")
    for label, cfg in (("default", FusedLayers()), ("fused", fused_cfg)):
        facades, held = {}, {}
        for mode in ("f32", "int8", "int4"):
            facades[mode], held[mode] = resident(lambda: facade("tdt-ctc-110m", "cuda", params=flat, fused=cfg,
                                                                quantize=None if mode == "f32" else mode))
        set_int8_compute(True)
        try:
            w8 = encoder_turns(f"110m {label} W8A8", {"w8a8": facades["int8"]}, feats, n_frames, card)
        finally:
            set_int8_compute(False)
        out[f"110m {label} encoder"] = dict(encoder_turns(f"110m {label}", facades, feats, n_frames, card), **w8,
                                            bytes=held)
        log(f"  110m weights on the card: " + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in held.items()))
        del facades
    del flat
    part("110m encoder times")

    out["600m int8 default"] = path_phase("tdt-600m int8 default", FusedLayers(), flat6, clips, card,
                                          model="tdt-600m", quantize="int8")
    feats, n_frames = preprocess_audio_batch(clips, C.AudioConfig(n_mels=128), "cpu")
    facades, held = {}, {}
    for mode in ("f32", "int8"):
        facades[mode], held[mode] = resident(lambda: facade("tdt-600m", "cuda", params=flat6,
                                                            quantize=None if mode == "f32" else mode))
    out["600m default encoder"] = dict(encoder_turns("tdt-600m default", facades, feats, n_frames, card), bytes=held)
    log(f"  tdt-600m weights on the card: " + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in held.items()))
    del facades
    torch.cuda.empty_cache()
    part("tdt-600m int8")

    out["decode"] = decode_options_phase(model_params("tdt-ctc-110m"), clips[:4], card)
    part("decode options")

    eou_cfg = C.make_eou_120m_config()
    flat_e = P.init_params_numpy(P.eou_spec(eou_cfg), seed=0)
    pushes = _stream_pushes(synthetic_clips(1, seed=1700, min_s=8, max_s=8)[0])[:50]
    log(f"== options streaming: eou-120m quantize='int8', f32, B=1, {len(pushes)} pushes of 160 ms")
    gpu = StreamingTranscriber(config=eou_cfg, params=flat_e, device="cuda", quantize="int8")
    cpu = StreamingTranscriber(config=eou_cfg, params=flat_e, device="cpu", quantize="int8")
    out["streaming int8"] = streaming_facade_check("eou-120m int8 B=1", gpu, cpu, pushes, card)
    # int8 against f32 on this host: wall per push over the first 20 pushes
    # in turns (f32, int8, int8, f32), the lesser of each; device ms over 6
    trs = {"f32": StreamingTranscriber(config=eou_cfg, params=flat_e, device="cuda"), "int8": gpu}
    push_ms, dev_ms = {}, {}
    for name in [*trs, *reversed(trs)]:
        t = wall_ms(lambda: _run_stream(trs[name], pushes[:20]), 1) / 20
        push_ms[name] = min(push_ms.get(name, float("inf")), t)
    for name, tr in trs.items():
        dev_ms[name] = device_ms(lambda: _run_stream(tr, pushes[:6]), calls=1, profiles=1) / 6
    log("  eou-120m B=1 per push, f32 vs int8 in turns: wall ms (mean of the first 20 pushes, best of 2 turns) "
        + ", ".join(f"{k} {v:.3f}" for k, v in push_ms.items()) + "; device ms (first 6 pushes) "
        + ", ".join(f"{k} {v:.3f}" for k, v in dev_ms.items()) + f" [{card}]")
    out["streaming int8"].update(push_ms=push_ms, push_dev_ms=dev_ms)
    part("streaming")
    return out


# ── serving: the HTTP server, the streaming service, the C API, the CLI, parakeet-bench ──

SERVE_MAX_BATCH, SERVE_WAIT_MS = 8, 25.0


def wav_bytes(samples, rate: int = 16000) -> bytes:
    """16-bit PCM WAV of float samples, (n,) mono or (n, channels)."""
    import io
    import wave

    x = np.asarray(samples, np.float32)
    x = x[:, None] if x.ndim == 1 else x
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(x.shape[1])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(x, -1, 1) * 32767).astype("<i2").tobytes())
    return buf.getvalue()


def http_post(addr, path: str, body: bytes, chunk: int | None = None, times=None):
    """(status, JSON) of one POST; with `chunk` the body goes as chunked
    transfer-encoding in pieces of that many bytes. The request's wall ms
    is appended to `times` when given."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection(*addr, timeout=600)
    try:
        if chunk is None:
            conn.request("POST", path, body=body)
        else:
            conn.putrequest("POST", path)
            conn.putheader("Transfer-Encoding", "chunked")
            conn.endheaders()
            for i in range(0, len(body), chunk):
                piece = body[i: i + chunk]
                conn.send(b"%x\r\n" % len(piece) + piece + b"\r\n")
            conn.send(b"0\r\n\r\n")
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    if times is not None:
        times.append((time.perf_counter() - t0) * 1e3)
    if resp.status != 200:
        raise RuntimeError(f"POST {path}: HTTP {resp.status}: {data[:300]!r}")
    return json.loads(data)


def http_stats(addr) -> dict:
    """GET /stats."""
    import http.client

    conn = http.client.HTTPConnection(*addr, timeout=60)
    try:
        conn.request("GET", "/stats")
        resp = conn.getresponse()
        data = resp.read()
    finally:
        conn.close()
    if resp.status != 200:
        raise RuntimeError(f"GET /stats: HTTP {resp.status}")
    return json.loads(data)


def serve_http_server(service, stream_service=None):
    """The port's make_server on 127.0.0.1, an ephemeral port, in a thread."""
    import threading

    from parakeet_tpu_torch.serve_http import make_server

    httpd = make_server(service, stream_service, host="127.0.0.1", port=0, quiet=True)
    threading.Thread(target=httpd.serve_forever, daemon=True, name="smoke-http").start()
    return httpd


def concurrently(fns):
    """Run each fn on its own thread, all started together; their results
    in order (a failure in any re-raises here)."""
    with ThreadPoolExecutor(len(fns)) as ex:
        futs = [ex.submit(fn) for fn in fns]
        return [f.result() for f in futs]


def http_round(addr, bodies, times=None) -> list[list[int]]:
    """One concurrent POST /transcribe per body; each response's token ids."""
    return [r["token_ids"] for r in concurrently(
        [lambda b=b: http_post(addr, "/transcribe", b, times=times) for b in bodies])]


def settled(read, batched, n: int, tag: str, wait_s: float = 10.0):
    """read() once batched(read()), the requests the service has recorded in
    cohorts since the round began, reaches the round's n. The worker
    records a cohort just after it sets the cohort's results, so the last
    response can arrive before its cohort is counted. Raises after wait_s."""
    deadline = time.perf_counter() + wait_s
    while True:
        s = read()
        if batched(s) >= n:
            return s
        if time.perf_counter() > deadline:
            raise RuntimeError(f"{tag}: the service recorded {batched(s)} of {n} requests in cohorts after "
                               f"{wait_s:.0f} s")
        time.sleep(0.005)


def serve_round(httpd, gpu, bodies, audio_s: float, tag: str, card: str) -> dict:
    """One counted and timed round of concurrent POST /transcribe, one per
    body: token ids, cohorts and requests from GET /stats, K1 launches
    (once a layer a cohort, no other kernel), the burst's request wall
    median and max (a handful of requests: no tail percentile), RTFx over
    the round's wall."""
    before = http_stats(httpd.server_address)
    times = []
    reset_counts()
    t0 = time.perf_counter()
    tokens = http_round(httpd.server_address, bodies, times)
    wall = time.perf_counter() - t0
    launches = read_counts()
    after = settled(lambda: http_stats(httpd.server_address),
                    lambda s: round(s["mean_batch"] * s["batches"]) - round(before["mean_batch"] * before["batches"]),
                    len(bodies), f"serve {tag}")
    cohorts, requests = after["batches"] - before["batches"], after["requests"] - before["requests"]
    if requests != len(bodies) or after["errors"] != before["errors"]:
        raise RuntimeError(f"serve {tag}: /stats counts {requests} requests, {after['errors'] - before['errors']} "
                           f"errors")
    layers = gpu.config.encoder.num_layers
    expect = {k: layers * cohorts if k == "rel_attention_block" else 0 for k in launches}
    if launches != expect:
        raise RuntimeError(f"serve {tag}: launches {launches}, expected {expect} for {cohorts} cohorts")
    out = {"tokens": tokens, "launches": launches, "cohorts": cohorts, "wall_s": wall,
           "latency_ms": float(np.median(times)), "latency_max_ms": max(times),
           "mean_batch": requests / cohorts, "rtfx": audio_s / wall}
    log(f"  HTTP /transcribe {tag}: one burst of {len(bodies)} concurrent requests in {cohorts} cohorts (mean batch "
        f"{out['mean_batch']:.2f}); request wall ms median {out['latency_ms']:.1f}, max {out['latency_max_ms']:.1f}; "
        f"round {wall * 1e3:.1f} ms, {out['rtfx']:.1f} audio s per wall s; K1 {launches['rel_attention_block']} "
        f"launches = {layers} x {cohorts} cohorts, no other kernel [{card}]")
    return out


def serve_offline(gpu, bodies, audio_s: float, pipeline: bool, card: str) -> dict:
    """TranscriptionService(max_batch=8, max_wait_ms=25) under the HTTP
    server: a warm-up round of concurrent requests, then a counted and
    timed one (serve_round). Returns the round with the server and the
    service, still running."""
    from parakeet_tpu_torch.serve import TranscriptionService

    svc = TranscriptionService(gpu, max_batch=SERVE_MAX_BATCH, max_wait_ms=SERVE_WAIT_MS, pipeline=pipeline)
    httpd = serve_http_server(svc)
    try:
        http_round(httpd.server_address, bodies)  # warm-up (cuDNN autotune, allocator)
        out = serve_round(httpd, gpu, bodies, audio_s, f"pipeline={pipeline}", card)
    except BaseException:
        httpd.shutdown()
        svc.close()
        raise
    return dict(out, httpd=httpd, service=svc)


def serve_align_overlap(httpd, svc, gpu, bodies, text: str, card: str) -> None:
    """POST /align of clip 1 on a handler thread while a second round of 8
    /transcribe requests runs through the service: the alignment equals the
    card facade's align on the same bytes; K1 launches once a layer for
    each cohort and for the alignment."""
    from urllib.parse import quote

    before, batched = svc.stats.batches, svc.stats.total_batched
    reset_counts()
    res = concurrently([lambda: http_post(httpd.server_address, f"/align?text={quote(text)}", bodies[1]),
                        lambda: http_round(httpd.server_address, bodies)])
    launches = read_counts()
    settled(lambda: svc.stats, lambda st: st.total_batched - batched, len(bodies), "serve /align overlap")
    cohorts = svc.stats.batches - before
    got = res[0]
    want = gpu.align(bodies[1], text)
    spans = [(w.word, w.start, w.end) for w in want.word_timestamps]
    if got["token_ids"] != want.token_ids or [(w["word"], w["start"], w["end"]) for w in got["words"]] != spans:
        raise RuntimeError("serve /align: the alignment differs from the card facade's align")
    conf = max(abs(w["confidence"] - x.confidence) for w, x in zip(got["words"], want.word_timestamps))
    if conf > 1e-6 or not spans:
        raise RuntimeError(f"serve /align: {len(spans)} words, confidences differ by {conf:.3e}")
    layers = gpu.config.encoder.num_layers
    expect = {k: layers * (cohorts + 1) if k == "rel_attention_block" else 0 for k in launches}
    if launches != expect:
        raise RuntimeError(f"serve /align overlap: launches {launches}, expected {expect}")
    log(f"  HTTP /align of clip 1 ({len(spans)} words) beside a /transcribe round of {cohorts} cohorts: equal to "
        f"the card facade's align; K1 {launches['rel_attention_block']} launches, no other kernel [{card}]")


def serve_streaming(card: str) -> dict:
    """StreamingService over StreamingBatchTranscriber(8, eou-120m, fused
    frontend, int16 wire) on the card under the HTTP server: four chunked
    /stream sessions at once; each session's final tokens equal to a
    direct lockstep run on the card and on the CPU, no kernel launched, and
    the synchronised wall of every device step (a 160 ms chunk of each
    live stream)."""
    import torch

    from parakeet_tpu_torch import config as C
    from parakeet_tpu_torch import params as P
    from parakeet_tpu_torch.serve import StreamingService, TranscriptionService
    from parakeet_tpu_torch.streaming import StreamingBatchTranscriber

    cfg = C.make_eou_120m_config()
    flat = P.init_params_numpy(P.eou_spec(cfg), seed=0)
    kw = dict(config=cfg, params=flat, frontend="fused", wire_dtype="int16")
    pcm = [np.clip(c * 32768, -32768, 32767).astype(np.int16) for c in synthetic_clips(4, seed=2300, min_s=6,
                                                                                          max_s=6)]
    flush = np.zeros((16 + 8) * 160, np.float32)  # what StreamingService pushes at close

    def direct(device):
        bt = StreamingBatchTranscriber(8, device=device, **kw)
        for slot in range(len(pcm), 8):
            bt.deactivate_slot(slot)
        for slot, x in enumerate(pcm):
            bt.push(slot, x)
            bt.push(slot, flush)
        while bt.ready_any():
            bt.step(hold=bt.lagging_slots())
        return [list(bt._tokens[i]) for i in range(len(pcm))]

    bt = StreamingBatchTranscriber(8, device="cuda", **kw)
    step_ms = []
    step = bt.step

    def timed_step(hold=()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = step(hold=hold)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return res

    bt.step = timed_step
    stream = StreamingService(bt, poll_ms=1.0)
    offline = TranscriptionService(None, pipeline=False)  # /transcribe unused here
    httpd = serve_http_server(offline, stream)
    try:
        bodies = [x.tobytes() for x in pcm]
        concurrently([lambda b=b: http_post(httpd.server_address, "/stream", b, chunk=5120) for b in bodies[:1]])
        step_ms.clear()  # the first session warmed the step up
        reset_counts()
        done_ms = []
        res = concurrently([lambda b=b: http_post(httpd.server_address, "/stream", b, chunk=5120, times=done_ms)
                            for b in bodies])
        launches = read_counts()
    finally:
        httpd.shutdown()
        stream.close()
        offline.close()
    _no_launches("serve /stream", launches)
    got = [r["token_ids"] for r in res]
    gpu, cpu = direct("cuda"), direct("cpu")
    for i, (g, d, c) in enumerate(zip(got, gpu, cpu)):
        if not (g == d == c) or not g:
            raise RuntimeError(f"serve /stream session {i}: {len(g)} tokens, equal to the direct card run "
                               f"{g == d}, to the CPU run {g == c}")
    out = {"launches": launches, "step_ms": float(np.median(step_ms)), "step_p95_ms": _percentile(step_ms, 0.95),
           "steps": len(step_ms), "session_ms": float(np.median(done_ms))}
    log(f"  HTTP /stream: 4 chunked sessions at once (6 s of int16 each in 160 ms chunks), eou-120m B=8 fused "
        f"int16; tokens per session {[len(g) for g in got]}, equal to a direct lockstep run on the card and on "
        f"the CPU; kernel launches none; per device step (one 160 ms chunk of each live stream), synchronised "
        f"wall ms: median {out['step_ms']:.3f}, p95 {out['step_p95_ms']:.3f} over {out['steps']} steps; a "
        f"session's whole request {out['session_ms']:.1f} ms median [{card}]")
    return out


def serve_capi(gpu, clip, card: str) -> dict | None:
    """The port's C API (build_capi) loaded into this process with ctypes:
    create tdt-ctc-110m on the card from seed 0, transcribe_pcm on clip 0 as
    f32 at 16 kHz and as s16 at 44.1 kHz; token ids equal to the card
    facade's on the same samples, K1 once a layer a call."""
    import ctypes

    from parakeet_tpu_torch.audio.io import read_audio, resample
    from parakeet_tpu_torch.ops._build import build_capi

    t0 = time.perf_counter()
    path = build_capi()
    if path is None:
        log("  C API: not built: this Python has no shared libpython (Py_ENABLE_SHARED != 1), so the "
            "interpreter cannot be embedded")
        return None
    lib = ctypes.CDLL(str(path))
    build_s = time.perf_counter() - t0
    lib.parakeet_create.restype = ctypes.c_int64
    lib.parakeet_create.argtypes = [ctypes.c_char_p] * 4
    for name, ptr in (("parakeet_transcribe_pcm", ctypes.c_float), ("parakeet_transcribe_pcm_s16", ctypes.c_int16)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_void_p
        fn.argtypes = [ctypes.c_int64, ctypes.POINTER(ptr), ctypes.c_int64, ctypes.c_int32]
    lib.parakeet_last_error.restype = ctypes.c_char_p
    lib.parakeet_free_string.argtypes = [ctypes.c_void_p]
    lib.parakeet_destroy.argtypes = [ctypes.c_int64]

    def take(p):
        if not p:
            raise RuntimeError(f"C API: {lib.parakeet_last_error().decode()}")
        try:
            return json.loads(ctypes.string_at(p).decode())
        finally:
            lib.parakeet_free_string(p)

    h = lib.parakeet_create(b"tdt-ctc-110m", None, None, b'{"device": "cuda", "seed": 0}')
    if h <= 0:
        raise RuntimeError(f"C API create: {lib.parakeet_last_error().decode()}")
    f32 = np.ascontiguousarray(clip, np.float32)
    s16 = np.clip(resample(clip, 16000, 44100) * 32768, -32768, 32767).astype(np.int16)
    reset_counts()
    try:
        r_f = take(lib.parakeet_transcribe_pcm(h, f32.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(f32),
                                               16000))
        r_s = take(lib.parakeet_transcribe_pcm_s16(h, s16.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                                                   len(s16), 44100))
    finally:
        lib.parakeet_destroy(h)
    launches = read_counts()
    want_f = gpu.transcribe(f32).token_ids
    want_s = gpu.transcribe(read_audio(s16, 16000, sample_rate=44100).samples).token_ids
    if r_f["token_ids"] != want_f or r_s["token_ids"] != want_s or not want_f:
        raise RuntimeError("C API: token ids differ from the card facade's")
    expect = {k: 2 * gpu.config.encoder.num_layers if k == "rel_attention_block" else 0 for k in launches}
    if launches != expect:
        raise RuntimeError(f"C API: launches {launches}, expected {expect}")
    log(f"  C API (library {build_s:.1f} s to build and load): transcribe_pcm f32 16 kHz {len(want_f)} tokens and "
        f"s16 44.1 kHz {len(want_s)} tokens, equal to the card facade's; K1 {launches['rel_attention_block']} "
        f"launches in the two calls, no other kernel [{card}]")
    return {"launches": launches}


RESAMPLE_PROBE = r"""
import hashlib, io, json, os, sys, threading, time, tracemalloc, wave
sys.path.insert(0, sys.argv[1])
import numpy as np
from parakeet_tpu_torch.audio.io import read_audio
from parakeet_tpu_torch import native
pcm = (0.2 * np.random.RandomState(0).randn(60 * 44100, 2) * 32767).astype("<i2")
buf = io.BytesIO()
with wave.open(buf, "wb") as w:
    w.setnchannels(2); w.setsampwidth(2); w.setframerate(44100); w.writeframes(pcm.tobytes())
data = buf.getvalue()
read_audio(np.zeros(4410, np.float32), sample_rate=44100)  # builds and loads the library
def rss():
    try:
        return int(open("/proc/self/statm").read().split()[1]) * os.sysconf("SC_PAGE_SIZE")
    except (OSError, ValueError, IndexError):
        return None
rss0, peak, done = rss(), [0], threading.Event()
def sample():  # the resident set every millisecond (the native call and numpy release the GIL)
    while not done.is_set():
        peak[0] = max(peak[0], rss() or 0)
        time.sleep(0.001)
sampler = threading.Thread(target=sample)
sampler.start()
t0 = time.perf_counter()
out = read_audio(data).samples
dt = time.perf_counter() - t0
done.set()
sampler.join()
tracemalloc.start()  # a second call, traced: numpy's buffers and Python objects
read_audio(data)
heap = tracemalloc.get_traced_memory()[1]
tracemalloc.stop()
print(json.dumps({"native": native.available(), "seconds": dt, "samples": len(out),
                  "rss_mb": None if rss0 is None else (peak[0] - rss0) / 2**20, "heap_mb": heap / 2**20,
                  "sha256": hashlib.sha256(out.tobytes()).hexdigest()}))
"""


def serve_resampler() -> dict:
    """read_audio of a synthetic 60 s 44.1 kHz stereo WAV in a fresh
    process, native and with PARAKEET_NO_NATIVE (the chunked numpy form):
    host seconds, the growth of the resident set (sampled each ms from
    /proc/self/statm, where the host has it) and tracemalloc's peak of a
    second call, outputs bit-identical."""
    import os

    out = {}
    for name, env in (("native", {}), ("numpy", {"PARAKEET_NO_NATIVE": "1"})):
        proc = subprocess.run([sys.executable, "-c", RESAMPLE_PROBE, str(ROOT)], capture_output=True, text=True,
                              timeout=300, env=dict(os.environ, **env))
        if proc.returncode != 0:
            raise RuntimeError(f"resampler probe ({name}) failed:\n{proc.stderr[-2000:]}")
        out[name] = json.loads(proc.stdout.strip().splitlines()[-1])
    if out["native"]["sha256"] != out["numpy"]["sha256"] or not out["native"]["native"] or out["numpy"]["native"]:
        raise RuntimeError(f"resampler: native and numpy outputs differ, or the wrong path ran: {out}")
    mb = lambda r: "not readable" if r["rss_mb"] is None else f"+{r['rss_mb']:.1f} MB"  # noqa: E731
    log(f"  read_audio 60 s 44.1 kHz stereo WAV -> {out['native']['samples']} samples at 16 kHz, bit-identical; "
        f"native {out['native']['seconds']:.3f} s, peak RSS {mb(out['native'])} (sampled each ms), traced heap "
        f"peak {out['native']['heap_mb']:.1f} MB; chunked numpy {out['numpy']['seconds']:.3f} s, peak RSS "
        f"{mb(out['numpy'])}, traced heap peak {out['numpy']['heap_mb']:.1f} MB (host of the card, "
        f"{os.cpu_count()} CPUs, one process each)")
    return out


def served_k1_shapes(cpu, cohort, singles) -> list:
    """(B, T', key lengths, what runs it) of the K1 launches the served
    paths make: the cohort of `cohort` padded to a multiple of 200 mel
    frames (TranscriptionService's pad_to_multiple), and each of `singles`
    alone at its own length (/align, the C API, the CLI)."""
    import torch

    from parakeet_tpu_torch.audio.frontend import preprocess_audio_batch
    from parakeet_tpu_torch.models.encoder import encoded_lengths

    def frames(waves):
        return preprocess_audio_batch(waves, cpu._audio_cfg, "cpu")[1]

    n = frames(cohort)
    padded = -(-max(n) // 200) * 200
    shapes = {(len(cohort), int(encoded_lengths(torch.as_tensor([padded]))[0])):
              [encoded_lengths(torch.as_tensor(n)).numpy(), "served cohort"]}
    for wave, what in singles:
        t = int(encoded_lengths(torch.as_tensor(frames([wave])))[0])
        if (1, t) in shapes:
            shapes[1, t][1] += f"; {what}"
        else:
            shapes[1, t] = [np.asarray([t]), what]
    return [(b, t, lengths, what) for (b, t), (lengths, what) in shapes.items()]


def served_k1_phase(shapes, card: str) -> dict:
    """K1 against its plain version at each of the served paths' shapes
    (seeded inputs at the 110m widths, f32, the kernels phase's
    tolerance); the served cohort's shape timed, with its bound."""
    import torch

    from parakeet_tpu_torch.ops import rel_attention as RA

    out = {"max_abs_err": 0.0, "times": {}, "work": {}}
    for i, (b, t, lengths, what) in enumerate(shapes):
        rng = np.random.RandomState(2400 + i)
        dev = _dev(rng, torch.float32)
        args = _attention_args(rng, dev, b, t, D, H)
        kw = dict(lengths=torch.as_tensor(lengths, dtype=torch.int32, device="cuda"),
                  norm_w=dev(1 + rng.normal(0, 0.1, D)), norm_b=dev(rng.normal(0, 0.1, D)))
        with torch.inference_mode():
            got = RA.rel_attention_block(*args, **kw)
            ref = RA.rel_attention_block_reference(*args, **kw)
        shape = f"B={b} T'={t} D={D} hd={D // H} ({what})"
        tag = f"K1 {shape} f32 lengths {lengths.min()}-{lengths.max()}"
        out["max_abs_err"] = max(out["max_abs_err"], check_close(tag, got, ref, _valid_rows(lengths, t)))
        if i == 0:
            out["times"][shape] = time_pair(tag, lambda: RA.rel_attention_block(*args, **kw),
                                            lambda: RA.rel_attention_block_reference(*args, **kw), card)
            out["work"][shape] = (attention_flops(b, t, D, H, lengths),
                                  tensor_bytes(*args, *kw.values(), got) + (2 * t - 1) * D * 4)
    return out


def serve_phase(flat, clips, card: str) -> dict:
    """Serving at full tdt-ctc-110m width (seed-0 random weights, f32, a
    synthetic vocab): K1 against its plain version at the shapes the served
    paths give it; the HTTP server over TranscriptionService on the card,
    pipelined and not, 8 concurrent clips with clip 0 as 44.1 kHz stereo;
    /align beside a /transcribe round; /stream over the streaming service;
    the C API; the CLI; parakeet-bench; the native resampler."""
    from parakeet_tpu_torch.audio.io import read_audio, resample
    from parakeet_tpu_torch.transcribe import Decoder

    vocab = smoke_vocab(1025)
    gpu = facade("tdt-ctc-110m", "cuda", params=flat, vocab_path=str(vocab))
    cpu = facade("tdt-ctc-110m", "cpu", params=flat, vocab_path=str(vocab))
    stereo = resample(clips[0], 16000, 44100)
    bodies = [wav_bytes(np.stack([stereo, 0.5 * stereo], axis=1), 44100)] + [wav_bytes(c) for c in clips[1:]]
    decoded = [read_audio(b).samples for b in bodies]
    audio_s = sum(len(x) for x in decoded) / 16000.0
    log(f"== serve: tdt-ctc-110m at full width, random weights (seed 0), f32, synthetic vocab; 8 WAV bodies "
        f"({audio_s:.2f} s; clip 0 as 44.1 kHz stereo, decoded by read_audio with the native resampler)")
    cpu_res = cpu.transcribe_batch(decoded, pad_to_multiple=200)
    cpu_tokens = [r.token_ids for r in cpu_res]
    bodies16 = [wav_bytes(c) for c in clips]
    decoded16 = [read_audio(b).samples for b in bodies16]
    audio16_s = sum(len(x) for x in decoded16) / 16000.0
    cpu16_tokens = [r.token_ids for r in cpu.transcribe_batch(decoded16, pad_to_multiple=200)]
    # a transcript that fits clip 1's frames: its CTC decode's first words
    align_text = " ".join(cpu.transcribe(decoded[1], Decoder.CTC).text.split()[:10])
    if not align_text:
        raise RuntimeError("serve: clip 1's CTC decode is empty; nothing to align")
    gpu.transcribe_batch(decoded, pad_to_multiple=200)  # warm-up
    direct_ms = wall_ms(lambda: gpu.transcribe_batch(decoded, pad_to_multiple=200), 3)
    s16 = np.clip(resample(clips[0], 16000, 44100) * 32768, -32768, 32767).astype(np.int16)
    out = {"k1": served_k1_phase(served_k1_shapes(cpu, decoded, [
        (decoded[1], "/align of clip 1"), (clips[0], "clip 0: C API f32, CLI"),
        (read_audio(s16, 16000, sample_rate=44100).samples, "clip 0: C API s16 44.1 kHz")]), card)}
    for pipeline in (True, False):
        res = serve_offline(gpu, bodies, audio_s, pipeline, card)
        if res["tokens"] != cpu_tokens:
            i = next(k for k, (a, b) in enumerate(zip(res["tokens"], cpu_tokens)) if a != b)
            raise RuntimeError(f"serve pipeline={pipeline}: clip {i} tokens differ from the CPU's transcribe_batch")
        if pipeline:
            serve_align_overlap(res["httpd"], res["service"], gpu, bodies, align_text, card)
            # the same clips, all as 16 kHz mono: no resample on the request path
            mono = serve_round(res["httpd"], gpu, bodies16, audio16_s, "all 16 kHz mono", card)
            if mono["tokens"] != cpu16_tokens:
                raise RuntimeError("serve all 16 kHz mono: tokens differ from the CPU's transcribe_batch")
            out["mono16"] = mono
        res["httpd"].shutdown()
        res["service"].close()
        out[f"pipeline={pipeline}"] = {k: v for k, v in res.items() if k not in ("httpd", "service")}
    log(f"  served tokens equal to the CPU's transcribe_batch ({sum(map(len, cpu_tokens))} tokens), pipelined and "
        f"not; the warm transcribe_batch of the same 8 clips takes {direct_ms:.1f} ms (median of 3) [{card}]")
    out["direct_ms"] = direct_ms
    cohorts = out["pipeline=True"]["cohorts"]
    out["launches_per_cohort"] = {k: v // cohorts for k, v in out["pipeline=True"]["launches"].items()}

    out["stream"] = serve_streaming(card)

    clip_path = ROOT / "build" / "parakeet_tpu_torch" / "serve_clip.wav"
    clip_path.write_bytes(wav_bytes(clips[0]))
    cli = subprocess.Popen([sys.executable, "-m", "parakeet_tpu_torch.cli", str(clip_path), "--random-weights"],
                           cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        out["capi"] = serve_capi(gpu, clips[0], card)
        cli_out, cli_err = cli.communicate(timeout=300)
    finally:
        if cli.poll() is None:
            cli.kill()
            cli.wait()
    want = gpu.transcribe(read_audio(clip_path).samples).token_ids
    line = next((l for l in cli_out.splitlines() if l.startswith("(token ids) ")), None)
    if cli.returncode != 0 or line is None or json.loads(line.removeprefix("(token ids) ")) != want:
        raise RuntimeError(f"CLI: rc {cli.returncode}, token line {line!r}, expected {want[:8]}...\n{cli_err[-2000:]}")
    log(f"  CLI `python -m parakeet_tpu_torch.cli serve_clip.wav --random-weights`: its (token ids) line "
        f"({len(want)} tokens) equals the card facade's")

    bench = subprocess.run([sys.executable, "-m", "parakeet_tpu_torch.benchmark", "--models", "110m",
                            "--durations", "10", "--markdown"], cwd=ROOT, capture_output=True, text=True,
                           timeout=300)
    row = [l for l in bench.stdout.splitlines() if l.startswith("| 110m ")]
    if bench.returncode != 0 or len(row) != 1:
        raise RuntimeError(f"parakeet-bench: rc {bench.returncode}\n{bench.stdout[-1000:]}\n{bench.stderr[-2000:]}")
    out["bench_row"] = row[0]
    log(f"  parakeet-bench --models 110m --durations 10 (batch 1, f32, K1 in every block): {row[0]} [{card}]")

    out["resampler"] = serve_resampler()
    return out


def build_phase() -> None:
    from parakeet_tpu_torch.ops import _build

    def timed(name):
        t0 = time.perf_counter()
        _build.build(name)
        return name, time.perf_counter() - t0

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as ex:
        done = list(ex.map(timed, LIBRARIES))
    log(f"== build: {len(done)} libraries in parallel, {time.perf_counter() - t0:.1f} s wall: "
        + ", ".join(f"{name}.cu {s:.1f} s" for name, s in done))
    for name in LIBRARIES:
        _build.load(name)


PHASES = ("kernels", "kernels600m", "paths110m", "serve", "paths600m", "long", "streaming", "diarize", "options")


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ", ".join(PHASES) + " (the default runs all and prints "
                         "the result lines; a subset prints no result)")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    if set(phases) - set(PHASES):
        raise SystemExit(f"chip_smoke: unknown phases {sorted(set(phases) - set(PHASES))}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA card")
    if not (ROOT / "parakeet_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no parakeet_tpu_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))
    t_start = time.perf_counter()
    seconds = {}

    def timed(label, fn, *a, **kw):
        t0 = time.perf_counter()
        res = fn(*a, **kw)
        seconds[label] = time.perf_counter() - t0
        log(f"== phase {label}: {seconds[label]:.1f} s (run so far {time.perf_counter() - t_start:.1f} s)")
        return res

    from parakeet_tpu_torch.models.encoder import FusedLayers
    from parakeet_tpu_torch.ops.layers import require_ieee_f32

    require_ieee_f32()  # the plain versions' f32 GEMMs and convs in IEEE f32
    card = card_line()
    log(f"== device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {card}")
    timed("build", build_phase)

    kernel = {}
    if "kernels" in phases:
        kernel = {"rel_attention_block": timed("K1", attention_phase, card),
                  "fused_feed_forward": timed("K6", feed_forward_phase, card),
                  "fused_conv_module": timed("K5", conv_module_phase, card),
                  "fused_subsample_block1": timed("K8", subsample_phase, card),
                  "fused_conv_ffn_final": timed("K4", conv_ffn_final_phase, card),
                  "fused_ffn_attention": timed("K7", ffn_attention_phase, card),
                  "fused_rel_attention": timed("K2", rel_attention_v1_phase, card),
                  "fused_log_mel": timed("K3", log_mel_phase, card)}
    if "kernels600m" in phases:
        for name, k6 in timed("kernels at 600m shapes", kernels_600m_phase, card).items():
            k = kernel.setdefault(name, {"max_abs_err": 0.0})
            k["max_abs_err"] = max(k["max_abs_err"], k6["max_abs_err"])
            for key in ("times", "bf16_times", "work", "bf16_work"):
                k.setdefault(key, {}).update(k6[key])

    clips = synthetic_clips(8, seed=1234)
    log(f"== clips: 8, {', '.join(f'{len(c) / 16000:.2f}' for c in clips)} s "
        f"({sum(len(c) for c in clips) / 16000.0:.2f} s audio)")
    fused_cfg = FusedLayers(ffn=True, conv=True, subsample=True)
    whole_cfg = FusedLayers(attention="mega", block2=True, subsample=True)
    v1_cfg = FusedLayers(attention="v1")
    paths = {}
    if "paths110m" in phases or "serve" in phases:
        flat = model_params("tdt-ctc-110m")
    if "paths110m" in phases:
        default = paths["default"] = timed("path default", path_phase, "default", FusedLayers(), flat, clips, card)
        fused = paths["fused"] = timed("path fused", path_phase, "fused", fused_cfg, flat, clips, card)
        same = sum(a == b for a, b in zip(fused["tdt"] + fused["ctc"], default["tdt"] + default["ctc"]))
        log(f"== fused vs default on the card: {same}/16 items with identical tokens (TDT + CTC); "
            f"encoder stage {fused['enc_ms']:.3f} vs {default['enc_ms']:.3f} ms; warm TDT batch "
            f"{fused['wall_s'] * 1e3:.1f} vs {default['wall_s'] * 1e3:.1f} ms, RTFx {fused['rtfx']:.1f} vs "
            f"{default['rtfx']:.1f} [{card}]")
        whole = paths["whole"] = timed("path whole-block", path_phase, "whole-block", whole_cfg, flat, clips, card)
        v1 = paths["v1"] = timed("path v1", path_phase, "v1", v1_cfg, flat, clips, card)
        for name, res in (("whole-block", whole), ("v1", v1)):
            same = sum(a == b for a, b in zip(res["tdt"] + res["ctc"], fused["tdt"] + fused["ctc"]))
            log(f"== {name} vs fused on the card: {same}/16 items with identical tokens; encoder stage "
                f"{res['enc_ms']:.3f} vs {fused['enc_ms']:.3f} ms wall, {res['enc_dev_ms']:.3f} vs "
                f"{fused['enc_dev_ms']:.3f} ms device [{card}]")
        paths["frontend"] = timed("path fused frontend", fused_frontend_phase, flat, clips, card)
        timed("bf16", bf16_phase, fused_cfg, flat, clips, fused["tdt"])
    if "serve" in phases:
        paths["serve"] = timed("serve", serve_phase, flat, clips, card)
        torch.cuda.empty_cache()
        k1 = kernel.setdefault("rel_attention_block", {"max_abs_err": 0.0})
        k1["max_abs_err"] = max(k1["max_abs_err"], paths["serve"]["k1"]["max_abs_err"])
        for key in ("times", "work"):
            k1.setdefault(key, {}).update(paths["serve"]["k1"][key])
    if "paths110m" in phases or "serve" in phases:
        del flat
    if "paths600m" in phases or "long" in phases or "options" in phases:
        t0 = time.perf_counter()
        flat6 = model_params("tdt-600m")
        log(f"== tdt-600m weights: {sum(a.size for a in flat6.values()) / 1e6:.1f} M parameters, "
            f"{time.perf_counter() - t0:.1f} s to draw")
        if "paths600m" in phases:
            for label, cfg in (("default", FusedLayers()), ("fused", fused_cfg), ("whole-block", whole_cfg),
                               ("v1", v1_cfg)):
                paths[f"tdt-600m {label}"] = timed(f"path tdt-600m {label}", path_phase, f"tdt-600m {label}", cfg,
                                                   flat6, clips, card, model="tdt-600m")
        if "long" in phases:
            paths["long"] = timed("long audio tdt-600m", long_audio_phase, flat6, card)
        if "options" in phases:
            paths["options"] = timed("options", options_phase, flat6, clips, card)
            torch.cuda.empty_cache()
        del flat6
        if "paths600m" in phases:
            flat6 = model_params("rnnt-600m")
            for label, cfg in (("default", FusedLayers()), ("fused", fused_cfg)):
                paths[f"rnnt-600m {label}"] = timed(f"path rnnt-600m {label}", path_phase, f"rnnt-600m {label}",
                                                    cfg, flat6, clips, card, model="rnnt-600m")
            del flat6
    if "streaming" in phases:
        paths["streaming"] = timed("streaming", streaming_phase, card)
        torch.cuda.empty_cache()
    if "diarize" in phases:
        paths["diarize"] = timed("diarize", diarize_phase, card)
        k1 = kernel.setdefault("rel_attention_block", {"max_abs_err": 0.0})
        k1["max_abs_err"] = max(k1["max_abs_err"], paths["diarize"]["k1"]["max_abs_err"])
        for key in ("times", "work"):
            k1.setdefault(key, {}).update(paths["diarize"]["k1"][key])
    log(f"== all phases passed in {time.perf_counter() - t_start:.1f} s: "
        + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()))
    if phases != list(PHASES):
        return 0

    # kernel: (source, the TPU kernel it replaces, the path whose launches count, timed shape)
    sources = {
        "rel_attention_block": ("rel_attention.cu", "parakeet_tpu/ops/pallas_attention.py:510", "fused", 126),
        "fused_feed_forward": ("feed_forward.cu", "parakeet_tpu/ops/pallas_ffn.py:62", "fused", 126),
        "fused_conv_module": ("conv_module.cu", "parakeet_tpu/ops/pallas_conv.py:68", "fused", 126),
        "fused_subsample_block1": ("subsample.cu", "parakeet_tpu/ops/pallas_subsample.py:168", "fused", 1001),
        "fused_conv_ffn_final": ("conv_ffn_final.cu", "parakeet_tpu/ops/pallas_block.py:75", "whole", 126),
        "fused_ffn_attention": ("ffn_attention.cu", "parakeet_tpu/ops/pallas_attention.py:630", "whole", 126),
        "fused_rel_attention": ("rel_attention_v1.cu", "parakeet_tpu/ops/pallas_attention.py:100", "v1", 126),
        "fused_log_mel": ("log_mel.cu", "parakeet_tpu/ops/pallas_frontend.py:88", "frontend", 10),
    }
    # each kernel's launches on the 600m paths (the 110m paths' are "launches")
    on_600m = {"rel_attention_block": "tdt-600m default", "fused_feed_forward": "tdt-600m fused",
               "fused_conv_module": "tdt-600m fused", "fused_subsample_block1": "tdt-600m fused",
               "fused_conv_ffn_final": "tdt-600m whole-block", "fused_ffn_attention": "tdt-600m whole-block",
               "fused_rel_attention": "tdt-600m v1", "fused_log_mel": None}
    rows = []
    for name, (src, replaces, path, t) in sources.items():
        k = kernel[name]
        f32_bound = bound(*k["work"][t])
        row = {"name": name, "route": "cuda", "source": f"parakeet_tpu_torch/csrc/{src}",
               "replaces": replaces, "launches": paths[path]["launches"][name],
               "launches_600m": paths[on_600m[name]]["launches"][name] if on_600m[name] else 0,
               # one Sortformer-117m forward; the streaming paths launch no kernel
               "launches_sortformer": paths["diarize"]["launches"][name],
               "launches_streaming": sum(paths["streaming"][p]["launches"][name] for p in paths["streaming"]),
               # one encoder call of the quantized (int8) fused 110m path
               "launches_quantized": paths["options"]["int8 fused"]["per_call"][name],
               # one cohort served by TranscriptionService over HTTP (tdt-ctc-110m default)
               "launches_serve": paths["serve"]["launches_per_cohort"][name],
               "max_abs_err": k["max_abs_err"], "ms": k["times"][t]["ms"],
               "plain_ms": k["times"][t]["plain_ms"], "dev_ms": k["times"][t]["dev_ms"],
               "plain_dev_ms": k["times"][t]["plain_dev_ms"],
               "bound_ms": f32_bound["bound_ms"], "bound_by": f32_bound["bound_by"],
               "bound_share": f32_bound["bound_ms"] / k["times"][t]["ms"],
               "gflop": f32_bound["gflop"], "mbyte": f32_bound["mbyte"],
               # no single PyTorch call computes any of these fused functions
               "library_ms": None, "shapes": []}
        if t in k.get("bf16_times", {}):
            # bf16 bound: this run's bf16 inputs, every operation at the tensor-core rate
            b16 = bound(*k["bf16_work"][t], BF16_PEAK)
            row.update(bf16_ms=k["bf16_times"][t]["ms"], bf16_plain_ms=k["bf16_times"][t]["plain_ms"],
                       bf16_bound_ms=b16["bound_ms"], bf16_bound_by=b16["bound_by"])
        # every timed shape with its bound, computed from that shape's inputs
        for dtype, times, work, peak in (("f32", "times", "work", F32_PEAK),
                                         ("bf16", "bf16_times", "bf16_work", BF16_PEAK)):
            for shape, ms in k.get(times, {}).items():
                bd = bound(*k[work][shape], peak)
                row["shapes"].append({"shape": shape, "dtype": dtype, "ms": ms["ms"], "plain_ms": ms["plain_ms"],
                                      "dev_ms": ms["dev_ms"], "plain_dev_ms": ms["plain_dev_ms"],
                                      "bound_ms": bd["bound_ms"], "bound_by": bd["bound_by"]})
                log(f"  bound {name} {dtype} at {shape}: {bd['gflop']:.3f} GFLOP, {bd['mbyte']:.2f} MB -> "
                    f"{bd['bound_ms']:.4f} ms by {bd['bound_by']}; kernel / plain device "
                    f"{ms['dev_ms']:.4f} / {ms['plain_dev_ms']:.4f} ms, CUDA events {ms['ms']:.4f} / "
                    f"{ms['plain_ms']:.4f}; bound {bd['bound_ms'] / ms['dev_ms']:.1%} of the kernel's "
                    f"device time [{card}]")
        rows.append(row)
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
