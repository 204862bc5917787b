"""`parakeet-bench` of the port — encoder throughput benchmark harness (port
of parakeet_tpu/benchmark.py).

Mirrors the C++ harness (src/bench.cpp): per model × duration
{1,5,10,30,60}s, synthetic `randn(batch, sec*100, mel)` features, warm-up
excluded from timing, RTF + throughput columns, optional markdown
reporter (:76-117); a batch sweep and bfloat16 mode. The ASR encoders run
`fastconformer_encode` under the `FusedLayers` the flags pick (default:
the attention kernel K1 in every block); Sortformer runs its whole forward.

On the card, the iterations are chained (each input depends on the
previous output) and timed with CUDA events after a warm-up; on the CPU
(`--device cpu`) with the host clock. Run as
`python -m parakeet_tpu_torch.benchmark`.
"""

from __future__ import annotations

import argparse
import sys
import time

MODELS = {
    "110m": ("make_110m_config", "encoder"),
    "tdt-600m": ("make_tdt_600m_config", "encoder"),
    "rnnt-600m": ("make_rnnt_600m_config", "encoder"),
    "sortformer": ("make_sortformer_117m_config", "nest_encoder"),
}


def fused_layers(fused_attention=None, conv_layout=None, fused_subsample=False, fused_ffn=False):
    """The reference's encoder flags as a FusedLayers: --fused-attention
    through the facades' kernels= mapping, --conv-layout pallas as the conv
    kernel (nhc and nch are layouts of the plain conv, which the port has
    one of), --fused-subsample and --fused-ffn."""
    from dataclasses import replace

    from parakeet_tpu_torch.transcribe import fused_layers_for

    fused = fused_layers_for(fused_attention, None)
    return replace(fused, conv=conv_layout == "pallas", subsample=fused_subsample, ffn=fused_ffn)


def bench_encoder(model: str, seconds: int, batch: int, dtype_name: str, iters: int,
                  weights_path: str | None = None, device: str = "cuda", fused=None) -> float:
    """Seconds per batch forward of `model`'s encoder (Sortformer: its whole
    forward) on `batch` × `seconds` s of synthetic features."""
    import numpy as np
    import torch

    from parakeet_tpu_torch import config as C
    from parakeet_tpu_torch import params as P
    from parakeet_tpu_torch.device import resolve_device
    from parakeet_tpu_torch.models.encoder import FusedLayers, fastconformer_encode
    from parakeet_tpu_torch.models.sortformer import sortformer_forward
    from parakeet_tpu_torch.params import Params

    if model not in MODELS:
        raise SystemExit(f"unknown model {model!r}; choose from {', '.join(MODELS)}")
    dev = resolve_device(device)
    factory_name, enc_attr = MODELS[model]
    cfg = getattr(C, factory_name)()
    enc_cfg = getattr(cfg, enc_attr)
    dtype = torch.bfloat16 if dtype_name == "bfloat16" else torch.float32
    fused = fused or FusedLayers()

    if model == "sortformer":
        spec = P.sortformer_spec(cfg)
    else:
        spec = P.encoder_spec(enc_cfg, "encoder_")
    params = P.device_params(P.load_params_numpy(spec, weights_path, seed=0), dev, dtype)

    if model == "sortformer":
        def fwd(x):
            return sortformer_forward(params, x, cfg=cfg)
    else:
        enc_params = Params(params).sub("encoder_")

        def fwd(x):
            return fastconformer_encode(enc_params, enc_cfg, x, None, fused)

    feats = torch.from_numpy(
        np.random.RandomState(0).randn(batch, seconds * 100, enc_cfg.mel_bins).astype(np.float32)
    ).to(device=dev, dtype=dtype)

    # chained on the device: each iteration's input depends on the last
    # output, so no forward can be skipped or overlapped
    @torch.inference_mode()
    def chained():
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(iters):
            out = fwd(feats + (acc * 1e-12).to(dtype))
            acc = out.float().sum()
        return acc

    chained()  # warm-up excluded
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        chained()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    t0 = time.perf_counter()
    float(chained())
    return (time.perf_counter() - t0) / iters  # seconds per batch forward


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="parakeet-bench")
    ap.add_argument("--models", default="110m", help=f"comma list from {list(MODELS)}")
    ap.add_argument("--durations", default="1,5,10,30,60")
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--markdown", action="store_true")
    ap.add_argument("--device", default=None, choices=[None, "cpu", "cuda"],
                    help="where the encoder runs (default: the CUDA card)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler trace of the bench into DIR")
    ap.add_argument("--weights", default=None,
                    help="bench with real weights (timing-identical to random init)")
    ap.add_argument("--fused-attention", default=None,
                    choices=["v1", "block", "block2", "block4", "block8", "mega",
                             "blockhp", "block2hp", "block4hp", "block8hp"],
                    help="attention kernel (every block* mode is K1; mega is K7, v1 is K2)")
    ap.add_argument("--conv-layout", default=None, choices=["nhc", "nch", "pallas"],
                    help="pallas: the conv module kernel K5")
    ap.add_argument("--fused-subsample", action="store_true",
                    help="fused conv1+dw1+conv2 subsampling kernel")
    ap.add_argument("--fused-ffn", action="store_true")
    args = ap.parse_args(argv)

    from parakeet_tpu_torch.device import DEFAULT_DEVICE

    device = args.device or DEFAULT_DEVICE
    fused = fused_layers(args.fused_attention, args.conv_layout, args.fused_subsample, args.fused_ffn)
    models = [m.strip() for m in args.models.split(",")]
    durations = [int(d) for d in args.durations.split(",")]

    profiler = None
    if args.profile:
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if device != "cpu":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.__enter__()
        print(f"# profiling to {args.profile}", file=sys.stderr)

    rows = []
    try:
        for model in models:
            for sec in durations:
                dt = bench_encoder(model, sec, args.batch, args.dtype, args.iters, args.weights, device, fused)
                audio_s = args.batch * sec
                rows.append((model, sec, dt * 1e3, dt / audio_s, audio_s / dt))
                print(
                    f"{model:12s} {sec:3d}s batch={args.batch} {args.dtype}: "
                    f"{dt * 1e3:8.1f} ms  RTF {dt / audio_s:.5f}  {audio_s / dt:8.1f}x realtime",
                    file=sys.stderr,
                )
    finally:
        if profiler is not None:
            from pathlib import Path

            profiler.__exit__(None, None, None)
            Path(args.profile).mkdir(parents=True, exist_ok=True)
            profiler.export_chrome_trace(str(Path(args.profile) / "parakeet_bench_trace.json"))

    if args.markdown:
        print("| Model | Audio | Time (ms) | RTF | Throughput |")
        print("|-------|-------|-----------|-----|------------|")
        for model, sec, ms, rtf, tput in rows:
            print(f"| {model} | {sec} s | {ms:.1f} | {rtf:.5f} | {tput:.0f}x |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
