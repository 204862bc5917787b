#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (parakeet_tpu_torch) on one card.

    python3 chip_smoke.py        # needs one CUDA device

Phases, each of which raises (exit code 1) on failure:
  1. device   require CUDA; print the card's name and power limit
  2. build    compile the CUDA kernels from parakeet_tpu_torch/csrc
  3. kernel   the rel-pos attention kernel against its plain torch version
              at the 110m widths (D=512, H=8, B=8), T'=126 (10 s) and
              T'=751 (60 s), mixed lengths, with and without the fused
              LayerNorm + residual, in f32 and bf16; median CUDA-event
              times of both
  4. slice    Transcriber at full tdt-ctc-110m width (17 layers, d=512),
              seeded random weights, f32: 8 synthetic clips of 2-10 s
              through transcribe_batch with TDT + timestamps and with CTC;
              the kernel must run once per conformer block per encoder
              call, and the tokens must equal a CPU Transcriber's
The last two lines of output are a JSON line of per-kernel numbers and
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
KERNEL_SOURCE = "parakeet_tpu_torch/csrc/rel_attention.cu"
KERNEL_REPLACES = "parakeet_tpu/ops/pallas_attention.py:510"
F32_RTOL, F32_ATOL = 1e-3, 1e-5  # the reference's block-kernel tolerance
BF16_SCALE_FRAC = 0.02  # bf16: max |diff| within 2% of the output scale
ENC_SCALE_FRAC = 1e-3  # f32 encoder, card vs CPU, 17 layers of reordered sums


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


def attention_inputs(t: int, dtype, with_norm: bool, seed: int, b: int = 8, d: int = 512, h: int = 8):
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    hd = d // h

    def dev(a, dt=dtype):
        return torch.from_numpy(np.asarray(a, np.float32)).to("cuda", dt)

    def mat():
        return dev(rng.normal(0, 1 / np.sqrt(d), (d, d)))

    def vec(scale=0.02):
        return dev(rng.normal(0, scale, d))

    args = [dev(rng.randn(b, t, d))]
    for _ in range(3):
        args += [mat(), vec()]
    args += [dev(rng.normal(0, 0.02, (h, hd))), dev(rng.normal(0, 0.02, (h, hd))), mat(), mat(), vec()]
    lengths = rng.randint(max(1, t // 4), t + 1, size=b)
    lengths[0] = t
    kw = dict(lengths=torch.as_tensor(lengths, dtype=torch.int32, device="cuda"))
    if with_norm:
        kw.update(norm_w=dev(1 + rng.normal(0, 0.1, d), torch.float32),
                  norm_b=dev(rng.normal(0, 0.1, d), torch.float32))
    return args, kw, lengths


def kernel_phase() -> dict:
    import torch

    from parakeet_tpu_torch.ops import rel_attention as RA

    log("== kernel: rel_attention_block vs rel_attention_block_reference (B=8, D=512, H=8)")
    max_err_f32 = 0.0
    times = {}
    for t in (126, 751):
        for dtype in (torch.float32, torch.bfloat16):
            for with_norm in (True, False):
                args, kw, lengths = attention_inputs(t, dtype, with_norm, seed=t + with_norm)
                with torch.inference_mode():
                    got = RA.rel_attention_block(*args, **kw)
                    ref = RA.rel_attention_block_reference(*args, **kw)
                torch.cuda.synchronize()
                rows = torch.zeros(got.shape[:2], dtype=torch.bool, device="cuda")
                for i, n in enumerate(lengths):
                    rows[i, :n] = True
                g, r = got.float()[rows], ref.float()[rows]
                if not torch.isfinite(g).all():
                    raise RuntimeError(f"kernel output not finite at T={t} {dtype} norm={with_norm}")
                err = (g - r).abs()
                tag = f"T={t} {str(dtype).replace('torch.', '')} norm+residual={with_norm}"
                if dtype == torch.float32:
                    bad = int((err > F32_ATOL + F32_RTOL * r.abs()).sum())
                    max_err_f32 = max(max_err_f32, float(err.max()))
                    log(f"  {tag}: max|diff| {float(err.max()):.3e}, {bad} values outside "
                        f"rtol {F32_RTOL} / atol {F32_ATOL}")
                    if bad:
                        raise RuntimeError(f"kernel disagrees with its plain version at {tag}")
                else:
                    scale = float(r.abs().max())
                    log(f"  {tag}: max|diff| {float(err.max()):.3e} = "
                        f"{float(err.max()) / scale:.3%} of output scale {scale:.3f}")
                    if float(err.max()) > BF16_SCALE_FRAC * scale:
                        raise RuntimeError(f"kernel disagrees with its plain version at {tag}")
                if dtype == torch.float32 and with_norm:
                    with torch.inference_mode():
                        k_ms = median_ms(lambda: RA.rel_attention_block(*args, **kw))
                        p_ms = median_ms(lambda: RA.rel_attention_block_reference(*args, **kw))
                    times[t] = (k_ms, p_ms)
                    verdict = "SLOWER than" if k_ms > p_ms else "faster than"
                    log(f"  {tag}: kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms (median of 20): "
                        f"kernel {verdict} plain")
    return {"max_abs_err": max_err_f32, "times": times}


def synthetic_clips(n: int, seed: int, sr: int = 16000):
    import numpy as np

    rng = np.random.RandomState(seed)
    clips = []
    for _ in range(n):
        dur = rng.uniform(2.0, 10.0)
        tt = np.arange(int(dur * sr)) / sr
        f0 = rng.uniform(90, 250)
        env = 0.5 * (1 + np.sin(2 * np.pi * rng.uniform(2, 5) * tt))
        voice = sum(np.sin(2 * np.pi * f0 * k * tt) / k for k in range(1, 6))
        clips.append((0.1 * env * voice + 0.01 * rng.randn(tt.size)).astype(np.float32))
    return clips


def tdt_margin(tr, enc, item: int, tokens: list[int], step: int, frame: int) -> float:
    """Top-2 label log-prob gap of the TDT decision after `step` emissions
    of `tokens`, at encoder frame `frame`, on `tr`'s device."""
    import torch

    from parakeet_tpu_torch.models.rnnt import (
        joint_encoder_projection, prediction_step, prediction_zero_state, tdt_joint_precomputed)
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
        label_lp, _ = tdt_joint_precomputed(joint_p, enc_pre, pred)
        top2 = torch.topk(label_lp[0], 2).values
    return float(top2[0] - top2[1])


def compare_tokens(name: str, gpu_res, cpu_res, margin_fn) -> None:
    for i, (g, c) in enumerate(zip(gpu_res, cpu_res)):
        if g.token_ids == c.token_ids:
            continue
        j = next((k for k, (a, b) in enumerate(zip(g.token_ids, c.token_ids)) if a != b),
                 min(len(g.token_ids), len(c.token_ids)))
        log(f"  {name}: item {i} differs first at token {j}: "
            f"gpu {g.token_ids[j:j + 3]} vs cpu {c.token_ids[j:j + 3]}")
        log(f"  {name}: top-2 log-prob margin there (cpu) {margin_fn(i, j, c):.3e}")
        raise RuntimeError(f"{name}: card and CPU tokens differ")


def slice_phase(card: str) -> dict:
    import numpy as np
    import torch

    from parakeet_tpu_torch import params as P
    from parakeet_tpu_torch.audio.frontend import preprocess_audio_batch
    from parakeet_tpu_torch.config import make_110m_config
    from parakeet_tpu_torch.models.encoder import encoded_lengths
    from parakeet_tpu_torch.ops.rel_attention import rel_attention_block
    from parakeet_tpu_torch.transcribe import Decoder, TranscribeOptions, Transcriber

    cfg = make_110m_config()
    layers = cfg.encoder.num_layers
    log(f"== slice: tdt-ctc-110m, {layers} layers, d={cfg.encoder.hidden_size}, "
        f"random weights (seed 0), f32")
    flat = P.init_params_numpy(P.tdt_ctc_spec(cfg), seed=0)
    gpu = Transcriber(config=cfg, params=flat, device="cuda")
    cpu = Transcriber(config=cfg, params=flat, device="cpu")
    clips = synthetic_clips(8, seed=1234)
    audio_s = sum(len(c) for c in clips) / 16000.0
    log(f"  8 clips, {', '.join(f'{len(c) / 16000:.2f}' for c in clips)} s ({audio_s:.2f} s audio)")
    tdt = TranscribeOptions(Decoder.TDT, timestamps=True)
    ctc = TranscribeOptions(Decoder.CTC)

    gpu.transcribe_batch(clips, tdt)  # warm-up (cuDNN autotune, allocator)
    torch.cuda.synchronize()
    rel_attention_block.launches = 0
    gpu_tdt = gpu.transcribe_batch(clips, tdt)
    after_tdt = rel_attention_block.launches
    gpu_ctc = gpu.transcribe_batch(clips, ctc)
    launches = rel_attention_block.launches
    log(f"  kernel launches: {after_tdt} in the TDT call, {launches - after_tdt} in the CTC call "
        f"(one encoder call each, {layers} conformer blocks)")
    if after_tdt != layers or launches != 2 * layers:
        raise RuntimeError(f"expected {layers} kernel launches per encoder call, got "
                           f"{after_tdt} and {launches - after_tdt}")

    for r in gpu_tdt + gpu_ctc:
        if not r.token_ids:
            raise RuntimeError("an item decoded to no tokens")
    for r in gpu_tdt:
        for tok in r.timestamped_tokens:
            if not (0 <= tok.token_id < cfg.joint.vocab_size - 1 and tok.start_frame <= tok.end_frame
                    and 0.0 < tok.confidence <= 1.0):
                raise RuntimeError(f"malformed timestamped token {tok}")

    cpu_tdt = cpu.transcribe_batch(clips, tdt)
    cpu_ctc = cpu.transcribe_batch(clips, ctc)
    feats, n_frames = preprocess_audio_batch(clips, cpu._audio_cfg, "cpu")
    enc_cpu = cpu.encode(feats, n_frames)
    enc_gpu = gpu.encode(feats, n_frames).cpu()
    enc_lens = encoded_lengths(torch.as_tensor(n_frames)).tolist()
    enc_diff = max(float((enc_gpu[i, :n] - enc_cpu[i, :n]).abs().max()) for i, n in enumerate(enc_lens))
    enc_scale = max(float(enc_cpu[i, :n].abs().max()) for i, n in enumerate(enc_lens))
    if not torch.isfinite(enc_gpu).all():
        raise RuntimeError("encoder output on the card is not finite")
    if tuple(enc_gpu.shape) != (8, max(enc_lens), cfg.encoder.hidden_size):
        raise RuntimeError(f"encoder output shape {tuple(enc_gpu.shape)}")
    log(f"  encoder card vs CPU: max|diff| {enc_diff:.3e} over valid frames (scale {enc_scale:.3f})")
    if enc_diff > ENC_SCALE_FRAC * enc_scale:
        raise RuntimeError(f"encoder on the card differs from the CPU by more than {ENC_SCALE_FRAC:.0e} of scale")

    def tdt_margin_at(i, j, res):
        ts = res.timestamped_tokens
        frame = ts[j].start_frame if j < len(ts) else enc_lens[i] - 1
        return tdt_margin(cpu, enc_cpu, i, res.token_ids, j, frame)

    def ctc_margin_at(i, j, res):
        lp = cpu.ctc_log_probs(enc_cpu)[i, : enc_lens[i]]
        best = lp.argmax(-1)
        gpu_best = gpu.ctc_log_probs(enc_gpu.to("cuda"))[i, : enc_lens[i]].argmax(-1).cpu()
        frame = int(torch.nonzero(best != gpu_best)[0]) if bool((best != gpu_best).any()) else 0
        top2 = torch.topk(lp[frame], 2).values
        return float(top2[0] - top2[1])

    compare_tokens("TDT", gpu_tdt, cpu_tdt, tdt_margin_at)
    compare_tokens("CTC", gpu_ctc, cpu_ctc, ctc_margin_at)
    n_tdt = sum(len(r.token_ids) for r in gpu_tdt)
    n_ctc = sum(len(r.token_ids) for r in gpu_ctc)
    log(f"  tokens identical on card and CPU: TDT {n_tdt} tokens, CTC {n_ctc} tokens")

    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gpu.transcribe_batch(clips, tdt)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall = sorted(walls)[1]
    log(f"  warm TDT batch wall time {wall * 1e3:.1f} ms (median of 3), "
        f"{audio_s / wall:.1f} audio s per wall s [{card}]")
    return {"launches": launches, "wall_s": wall, "rtfx": audio_s / wall, "enc_diff": enc_diff}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this check needs a CUDA card")
    if not (ROOT / "parakeet_tpu_torch" / "csrc").is_dir():
        raise SystemExit(f"chip_smoke: no parakeet_tpu_torch package beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT))

    card = card_line()
    log(f"== device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; nvidia-smi: {card}")

    from parakeet_tpu_torch.ops import rel_attention as RA

    t0 = time.perf_counter()
    RA.build()
    log(f"== build: rel_attention.cu built and loaded in {time.perf_counter() - t0:.1f} s")

    kern = kernel_phase()
    k_ms, p_ms = kern["times"][126]
    k_long, p_long = kern["times"][751]
    log(f"  times [{card}]: T=126 kernel {k_ms:.4f} / plain {p_ms:.4f} ms; "
        f"T=751 kernel {k_long:.4f} / plain {p_long:.4f} ms")

    launches = slice_phase(card)["launches"]

    print(card)
    print(json.dumps({"kernels": [{
        "name": "rel_attention_block",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": kern["max_abs_err"],
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
