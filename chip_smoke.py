#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (parakeet_tpu_torch) on one card.

    python3 chip_smoke.py        # needs one CUDA device
    python3 chip_smoke.py --phases streaming,diarize   # a subset, no result lines

Phases, each of which raises (exit code 1) on failure:
  1. device   require CUDA; print the card's name and power limit
  2. build    compile every CUDA library (nvcc) and the host libraries
              (g++: parakeet_native.cpp, flac_decoder.cpp) from
              parakeet_tpu_torch/csrc, all at once, and print each build's
              seconds, and ptxas's registers and spills of the Hopper GEMM
              and K2's cores
  3. kernels  each hand-written kernel against its plain torch version on
              the same CUDA tensors at the 110m widths, in f32 and bf16:
              K1 rel-pos attention block (B=8, D=512, H=8, T'=126 and 751,
              with and without the fused LayerNorm + residual, timed in f32
              and bf16, each launch's device time and the launches per
              call against the plan's: 3 in bf16, 7 tiled; the 600m widths
              D=1024, hd=128 at T'=126 and B=1, T'=300; hd=32 at B=2,
              T'=77; Sortformer's B=1, T'=751, timed; B=1 at T'=3000, one
              kernel for every length; at each shape the core's plan, its
              key splits and the blocks an SM holds, by the plan and by
              cudaOccupancyMaxActiveBlocksPerMultiprocessor), K6 FFN (T'=126 and
              751 and D=1024, F=4096 at T'=126, with and without the final
              LayerNorm, timed in f32 and bf16) and K5 conv module (the
              same shapes, mixed lengths and none), each with its launches
              by kernel beside torch.matmul on its GEMMs and its launches
              per call against its plan's (bf16: the Hopper route, 2 and 3,
              no LayerNorm or closing launch; f32: the tiled route, 4 and
              5), in bf16 timed in turns with the tiled route (mma.sync,
              the design they ran before), with fc1's and pw1's LayerNorm
              cluster at 1, 2, 4 and 8 column tiles, and K6's fc1 with the
              LayerNorm on its A path against a LayerNorm launch plus fc1
              on a plain A; both at the card tests' shapes (odd widths,
              D=1280, a short T'), K8 subsampling front (mel (8, 1001, 80)
              and (8, 6001, 80), C=256, ReLU timed in f32 and bf16, SiLU
              checked at T=1001), K4 conv
              module + ffn2 + final LayerNorm and K7 ffn1 + attention block
              (T'=126 and 751, mixed lengths), K2 v1 attention core (H=8:
              hd=64 at B=8, T'=126, 751 and 1001 with mixed lengths and
              B=1, T'=3000; hd 32 at T'=126; T'=37 with lengths 37, 21, 1
              and 0 at hd 32, 64 and 128; in f32 and bf16, each timed with
              its bound and bound share, its plan's key splits, kept score
              tiles and resident blocks against the card's occupancy, one
              launch a call by the profiler, K1's core stage at the same
              shape, and in bf16 its two designs in turns: the scores kept
              between the sweeps and computed again), K3 log-mel (10 s and
              60 s clips, f32 only, atol 2e-2 in log space); median
              CUDA-event ms and device ms
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
              memory rate. Then K7 and K4 at edge shapes in f32 and bf16
              with lengths below T' (odd widths that TMA cannot load; D =
              1280, past a cluster's column tiles), and the Hopper GEMM's
              clusters held at once beside the plans' table
  4. paths    (while the build runs: the weights, tdt-ctc-110m's written
              with io.save_safetensors and loaded onto the card through
              params.load_params(weights=..., strict=True, device="cuda"),
              every tensor equal to what was written) Transcriber at full
              tdt-ctc-110m width (17 layers, d=512),
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
              (not a gate); the whole-block configuration's encoder in
              bf16 beside f32 (device ms in turns, K7's and K4's launches
              per call, the bf16 output's largest difference from f32 as a
              share of scale), here and in paths600m
  5. kernels600m  the kernels at the 600m presets' shapes against their
              plain versions in f32 and bf16, timed, each with its bound:
              K8 on mel (8, 1001, 128), K7 and K4 at D=1024, F=4096, H=8,
              T'=126 with mixed lengths, K2 at hd=128 and T'=126 and 751
              (as in phase 3),
              K1 at D=1024, B=1, T'=1188 (a dense 95 s clip) and the 600m
              trainer's B=4 and B=2 at T'=125 (each launch's time, the
              core's plan). K7 and K4,
              here and in phase 3 at T'=126 and 751 (f32 and bf16): each
              launch's device time (torch.matmul in the same dtype beside
              each GEMM), the launches per call against k7_plan / k4_plan
              (bf16: the Hopper design, 5 each, no LayerNorm, closing or
              clamp launch may appear; f32: the tiled sequences, 11 and
              9), and the old design, the standalone kernels in sequence
              (K6 then K1; K5 then K6 with the final LayerNorm), timed in
              turns with it on the same inputs. The build phase prints
              ptxas's registers and spills of K7's and K4's Hopper GEMMs
  6. paths600m  TDTTranscriber at full tdt-600m width (24 layers, d=1024,
              128 mel, vocab 8193, two LSTM layers) in the default, fused,
              whole-block and v1 configurations, and RNNTTranscriber at
              full rnnt-600m width (80 mel, vocab 1025) in the default and
              fused ones; seeded random weights (the 600m models' drawn on
              the card), f32, the 8 clips (rnnt-600m: the 4 under 6 s); exact
              launch counts; tokens and frames equal to a CPU facade's on
              the 4 clips under 6 s,
              Decoder.CTC raising ValueError
  7. long     tdt-600m, default configuration, clips of 95, 62 and 7 s
              through transcribe_batch: long_audio="window" (20 windows of
              10 s overlapping by 2 s in one call at B=20, the 7 s clip
              densely) and long_audio="dense" (the 95 s clip alone at
              T'=1188); tokens and frames equal to the CPU's
  8. streaming  eou-120m (StreamingTranscriber) at full width, B=1, 5 s in
              160 ms pushes, f32 (and bf16: edit distance against f32);
              StreamingBatchTranscriber eou-120m at B=8, fused frontend,
              int16 wire, with held steps and a reset_slot; nemotron-600m
              (NemotronTranscriber, weights drawn on the card) in latency
              modes 0, 1, 6 and 13, 2 s each; tokens and frames equal to
              a CPU facade fed the same
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
              default and fused configurations, tdt-600m int8 default
              (each held to the CPU on the 4 clips under 6 s), each a path
              as in 4 with exact launch counts under
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
              1e-4; eou-120m streaming with int8, B=1, 8 pushes, no kernel
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
              --durations 10`, its row; read_audio of a 20 s 44.1 kHz
              stereo WAV in fresh processes, native and PARAKEET_NO_NATIVE
              (the chunked numpy form): host seconds and peak-RSS growth,
              outputs bit-identical; native int16_to_float, preemphasis
              and flac_decode against their numpy forms
 12. train    (f32, IEEE) (a) tdt-ctc-110m hybrid (sigma 0.05) through
              parakeet_tpu_torch.train_cli.main on 16 voiced WAVs of 2-12 s
              and a synthetic vocabulary, batch 8: steps 1-3 with a
              checkpoint, then --resume to step 6 and --export; K1 exactly
              17 launches a step and no other kernel; the export loaded in
              Transcriber on the card and on the CPU (tokens equal, encoder
              within 1e-3 of scale); then on each of the loader's two
              buckets (the 8 shortest clips, the 8 longest) the median
              synchronised step wall, the device busy share, the peak
              memory, each kernel's launches a step (K1 17, no other),
              the share of the step in the TDT lattice loss's forward and
              backward and in K1's backward, the step's top device
              kernels; one bf16 step (loss within 2% of f32's, K1 the only
              kernel); (b) one hybrid loss and every gradient at full width
              on a B=2 batch of 3 s clips, card against CPU (loss 1e-4
              relative, each key within 1e-3 of its own max |g|; keys whose
              CPU max |g| is below 1e-6 of the largest key's are zero up to
              rounding, left out and named); (e) tdt-600m loss tdt with
              remat 2 steps at B=4 and rnnt-600m 1 step at B=2 (weights
              drawn on the card), K1 24 a step (48 under remat); (f)
              Sortformer-117m through train_diar_cli.main, 2 steps at B=4
              on 10 s clips with synthetic RTTMs, K1 17 a step; (c) K1's
              autograd Function, forward against the plain version on the
              valid rows (the kernels phase's tolerance) and input
              gradients against autograd through the plain version on the
              same CUDA tensors (1e-4 of scale in f32, 2% in bf16), f32
              and bf16, at B=8 T'=126 D=512 with and without the fused
              LayerNorm + residual and at every shape (a), (e) and (f)
              give K1, each of those timed against the plain version in
              f32; (g) K6 on an input that requires grad raises; (d) ten
              steps at lr 1e-3 (linear warmup over 3) on one 110m batch
              end below the first loss
 13. mesh     (last) inference over torch.distributed on the one card:
              K1's head-sharded mode (one 'model' rank's 4 of 8 heads,
              B=8, T'=126, mixed lengths, D=512 and D=1024 hd=128, B=1,
              T'=300 at D=1024 (the core's keys split), and
              the shape dp1×tp2 gives it on the 8 clips, with their key
              lengths) against its plain version in f32 (timed, with its
              bound) and bf16;
              make_mesh with two NCCL ranks on one card raising; then two
              ranks spawned on the card over gloo (named explicitly; its
              CUDA collectives stage through host memory): (i) dp2
              tdt-ctc-110m default on the 8 clips, TDT and CTC, (ii)
              dp1×tp2 (K1 head-sharded, 17 launches a batch a rank, no
              other kernel), (iii) dp1×sp2 with kernels=False (no kernel),
              (iv) eou-120m StreamingBatchTranscriber B=8 dp2, fused
              frontend, int16 wire, a deactivated, a late (held) and a
              reset slot; and (v) one NCCL rank on a dp1 mesh; every
              rank's tokens and frames identical to the single-device
              card run, and in (ii) a TDT decode with impl="lookahead"
              (window 8, each window's vocab logits gathered over
              'model') too; in (i)-(iii) one more batch a decoder with each
              rank's time inside the collectives. Coverage on one card,
              not a scaling figure
 14. train_mesh  (last; f32, IEEE) training over torch.distributed on the
              one card: the single-device card steps saved (tdt-ctc-110m
              hybrid on the loader's batch of 8 synthetic clips, B=8;
              Sortformer-117m, B=4 on 10 s; tdt-600m tdt with remat, B=4),
              with each key's spread (its change under a seeded 1e-6
              change of the features); K1 at each case's own (B, T', key
              lengths), head-sharded (dp1×tp2) and whole (each dp2 rank's
              rows, each pipe2 microbatch, B=8), forward and input
              gradients through its autograd Function against the plain
              version, f32 and bf16, f32 timed; two gloo ranks on the
              card: (i) dp2, dp1×tp2 (K1 head-sharded) and dp1×sp2 110m
              steps, (iii) Sortformer dp2 and dp1×tp2, (ii) dp1×pipe2
              tdt-600m at full depth (12 layers a stage, 2 microbatches);
              (iv) one NCCL rank (world 1, in the script's process), a dp1
              110m step; each case's loss (1e-5 relative) and every
              gradient key, gathered and unpadded (each within the larger
              of 1e-4 of the key's max |g| and 4 times the key's spread;
              keys zero up to rounding left out and named), against the
              single-device step's; on dp2 and dp1×sp2 a rank's
              unreduced gradients (a missing 'data' mean or 'seq' sum)
              must fail that check; K1's launches a step a
              rank (whole heads and head-sharded) exactly as predicted,
              the wall of a step with the collective clock on, its share
              inside the collectives and the peak memory a rank; (v)
              train_cli under python -m torch.distributed.run (two gloo
              ranks each, two clips, one a rank) with
              --data-parallel 2 and with --model-parallel 2 (110m): 1
              step and a checkpoint, --resume to 2 and --export (vocab
              rows 1025 in the export, 1026 in the tp checkpoint), and
              train_diar_cli --data-parallel 2; the launches of a round
              at once, the first round beside the gloo cases (whose step
              walls it shares the host and the card with). Coverage on
              one card, not a scaling figure
 15. lookahead  (tdt-ctc-110m after serve, with its weights; tdt-600m
              and rnnt-600m beside paths600m, with theirs) the greedy
              decode loops on one encoder output of each model (the
              default encoder, K1 its only kernel, launches exact):
              first the offset on the blank's label bias that brings
              the step loop on the card to ~3.5 tokens per audio second
              (the reference bench.py's 10 halvings of [0, 30]), printed
              and reused for every impl; then the step loop and
              impl="lookahead" at windows 4, 8 and 16 (tdt-ctc-110m and
              tdt-600m on the 8 clips), window 8 (rnnt-600m on the 4
              clips under 6 s); on tdt-ctc-110m also a boosted batch
              and the unbiased (dense) batch at window 8, and the step
              loop at unroll 4. Every decode's tokens and frames equal
              the step loop's on the card (confidences within 1e-5
              relative) and the CPU port's step loop on the same encoder
              output and weights; each prints its iterations, decode
              wall (median of 5 warm synchronised calls), device busy
              share and tokens per audio second
Opt-in (only in a --phases list):
     v1       K2's encoders on the 8 clips: tdt-ctc-110m under
              FusedLayers(attention="v1") in f32 and bf16 and int8 fused,
              tdt-600m v1 in f32 and bf16; device ms in turns, K2's
              launches a call (17, 24). It uses only entry points every
              tree of the port has, so a copy of this script in an older
              checkout times that tree's K2 the same way.
Each phase prints its seconds, and the run its total. The card's name and
power limit, a JSON line of per-kernel numbers (with bound_ms, bound_by
and the bound's share of the kernel time at the headline shape, under
"shapes" every timed shape with its bound, launches_quantized, the
kernel's launches in one encoder call of the int8 fused 110m path,
launches_serve, its launches per cohort served over HTTP,
launches_train, its launches per train step of each trainer, and
launches_train_mesh, its launches a step a rank of each mesh trainer;
beside the eight, K1's head-sharded entry with its launches a batch per
rank on each mesh run) and
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
HOST_LIBRARIES = ("parakeet_native", "flac_decoder")  # g++, beside the kernels
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
    """A line of output, stamped with the host's clock (the parts of a
    phase read their seconds from it)."""
    print(f"{time.strftime('%H:%M:%S')} {msg}", flush=True)


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


def kernel_launches(fn, calls: int = 5, profiles: int = 3) -> float:
    """Device launches per call of fn (kernels, copies and fills), from
    torch.profiler's event counts; the device alone traced. A profile can
    drop events (one counted 34 of K1's 35 launches in 5 calls), never add
    them: the most of `profiles` profiles, and up to three more while none
    saw a device event (fn launches at least one kernel); 0 only if all saw
    none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    most = 0
    with torch.inference_mode():
        fn()
        torch.cuda.synchronize()
        for attempt in range(profiles + 3):
            if attempt >= profiles and most > 0:
                break
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
            most = max(most, sum(evt.count for evt in prof.key_averages() if evt.device_type == DeviceType.CUDA))
    return most / calls


# the launches K7's and K4's Hopper design leaves out: a LayerNorm pass, a split-K closing pass, a torch clamp
OLD_STAGES = ("layer_norm_rows_kernel", "gemm_reduce_kernel", "clamp")


def redesign_times(tag: str, fn, old_fn, gemms, dtype, plan, card: str) -> dict:
    """K7's or K4's stage lines (torch.matmul in the same dtype beside each
    GEMM), its launches per call against its plan's, and its device time in
    turns with the old design on the same inputs: the standalone kernels in
    sequence (K6 then K1 for K7; K5 then K6 with the final LayerNorm for
    K4), which is exactly what the old K7 and K4 launched. The Hopper design
    (plan.hopper, bf16) may launch no LayerNorm, closing or clamp pass; the
    tiled plan (f32) is those sequences in one C call. Best of 2 turns."""
    st = stage_times(tag, fn, gemms, card, dtype=dtype)
    old = [label for label in st["stages"] if any(word in label for word in OLD_STAGES)]
    if plan.hopper and old:
        raise RuntimeError(f"{tag}: the Hopper design still launches {old}")
    n = kernel_launches(fn)
    if n != plan.launches:
        raise RuntimeError(f"{tag}: {n} launches per call, the plan says {plan.launches}")
    import torch

    turns = {"new": [], "old": []}
    with torch.inference_mode():
        for _ in range(2):
            turns["new"].append(device_ms(fn))
            turns["old"].append(device_ms(old_fn))
    new_ms, old_ms = min(turns["new"]), min(turns["old"])
    design = "the Hopper design" if plan.hopper else "the tiled sequences"
    log(f"  {tag}: {n:g} launches per call ({design}); device ms in turns (best of 2): this kernel "
        f"{new_ms:.4f}, the standalone kernels in sequence {old_ms:.4f} (old / new {old_ms / new_ms:.2f}x) [{card}]")
    return {"ms": new_ms, "old_ms": old_ms, "launches": n, "stages": st["stages"], "hopper": plan.hopper}


def edge_shapes_phase(card: str) -> None:
    """K7 and K4 against their plain versions at the shapes the main path
    does not give them, in f32 and bf16 with lengths below T': odd widths
    (rows that TMA cannot load, filled element by element; QKV segments of
    96 rows) and D = 1280, whose rows span more than a cluster's column
    tiles (the tiled sequences in bf16 too). Then the Hopper GEMM's clusters
    the card holds at once beside the plans' table."""
    import torch

    from parakeet_tpu_torch.ops import conv_ffn_final as K4
    from parakeet_tpu_torch.ops import ffn_attention as K7
    from parakeet_tpu_torch.ops import gemm_plan as GP

    log("== K7 and K4 at edge shapes vs their plain versions")
    f32 = torch.float32
    for b, t, d, f, heads in ((3, 37, 96, 100, 3), (2, 64, 1280, 1280, 10)):
        lengths = [t, *(max(1, t - 7 * i - 3) for i in range(1, b))]
        for dtype, name in _dtypes():
            rng = np.random.RandomState(d + f)
            dev = _dev(rng, dtype)
            lt = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
            k7 = (dev(rng.randn(b, t, d)), *_ffn_weights(rng, dev, d, f), dev(1 + 0.1 * rng.randn(d), f32),
                  dev(0.1 * rng.randn(d), f32), *_attention_weights(rng, dev, d, heads))
            k4 = (dev(rng.randn(b, t, d)), *_conv_weights(rng, dev, d), *_ffn_weights(rng, dev, d, f),
                  dev(1 + 0.1 * rng.randn(d), f32), dev(0.1 * rng.randn(d), f32))
            hopper = K7.k7_plan(b, t, d, f, k7[0].element_size(), heads).hopper
            with torch.inference_mode():
                got7, ref7 = K7.fused_ffn_attention(*k7, lengths=lt), K7.fused_ffn_attention_reference(*k7, lengths=lt)
                got4 = K4.fused_conv_ffn_final(*k4, lengths=lt)
                ref4 = K4.fused_conv_ffn_final_reference(*k4, lengths=lt)
            design = "Hopper design" if hopper else "tiled sequences"
            check_close(f"K7 B={b} T'={t} D={d} F={f} H={heads} {name} ({design})", got7, ref7,
                        _valid_rows(lengths, t))
            check_close(f"K4 B={b} T'={t} D={d} F={f} {name} ({design})", got4, ref4)
    card_clusters = {n: K7.hopper_active_clusters(n) for n in range(1, GP.MAX_CLUSTER + 1)}
    same = card_clusters == GP.HOPPER_ACTIVE_CLUSTERS
    log(f"  Hopper GEMM clusters held at once, by size (cudaOccupancyMaxActiveClusters): {card_clusters}; "
        f"{'the same as' if same else 'NOT the same as'} the plans' table {GP.HOPPER_ACTIVE_CLUSTERS} [{card}]")


def k7_old(args, lt):
    """The old K7: K6 (no final LayerNorm) then K1 with its fused pre-LN."""
    from parakeet_tpu_torch.ops import feed_forward as K6
    from parakeet_tpu_torch.ops import rel_attention as RA

    x2 = K6.fused_feed_forward(*args[:7])
    return RA.rel_attention_block(x2, *args[9:], lengths=lt, norm_w=args[7], norm_b=args[8])


def k4_old(args, lt):
    """The old K4: K5 then K6 with the final LayerNorm."""
    from parakeet_tpu_torch.ops import conv_module as K5
    from parakeet_tpu_torch.ops import feed_forward as K6

    x2 = K5.fused_conv_module(*args[:13], lengths=lt)
    return K6.fused_feed_forward(x2, *args[13:19], args[19], args[20])


def k7_gemms(b: int, t: int, d: int, f: int) -> list:
    m = b * t
    return [("fc1", m, f, d), ("fc2", m, d, f), ("QKV", m, 3 * d, d), ("P", 2 * t - 1, d, d), ("out", m, d, d)]


def k4_gemms(b: int, t: int, d: int, f: int) -> list:
    m = b * t
    return [("pw1", m, 2 * d, d), ("pw2", m, d, d), ("fc1", m, f, d), ("fc2", m, d, f)]


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


# K1's launches the bf16 Hopper design leaves out: the LayerNorm pass, the tiled GEMMs and their closing passes
K1_TILED_STAGES = ("layer_norm_rows_kernel", "gemm_reduce_kernel", "ffn_gemm")


def k1_core_line(tag: str, b: int, t: int, d: int, heads: int, itemsize: int, card: str, dl: int | None = None) -> dict:
    """K1's core plan at a shape: blocks, key splits (the cluster width),
    key tiles a split, blocks an SM holds by the plan and by the card's
    cudaOccupancyMaxActiveBlocksPerMultiprocessor (they must agree)."""
    from parakeet_tpu_torch.ops import rel_attention as RA

    plan = RA.heads_plan(b, t, d, dl or d, itemsize, heads).core
    card_resident = RA.core_resident(itemsize, plan.hd)
    log(f"  {tag} core plan: {plan.blocks} blocks x {plan.splits} key splits (clusters of {plan.splits}), "
        f"{plan.tiles_per_split} of {plan.tiles} key tiles of {plan.key_tile} a split, {plan.threads} threads, "
        f"{plan.smem} B shared; resident blocks an SM: plan {plan.resident}, card {card_resident} "
        f"({card_resident * plan.threads // 32} warps) [{card}]")
    if card_resident != plan.resident:
        raise RuntimeError(f"{tag}: the card holds {card_resident} core blocks an SM, the plan says {plan.resident}")
    return {"blocks": plan.blocks, "splits": plan.splits, "resident": card_resident}


def k1_stage_lines(tag: str, fn, b: int, t: int, d: int, heads: int, dtype, card: str) -> dict:
    """K1's launches by kernel (device ms per call) beside torch.matmul on
    each GEMM's shapes in the same dtype, and its launches per call against
    the plan's: in bf16 at D <= 1024 the Hopper design's 3 (QKV with the
    LayerNorm and P, the core, the out-projection), with no LayerNorm pass,
    tiled GEMM or closing pass; else the tiled design's 7."""
    import torch

    from parakeet_tpu_torch.ops import rel_attention as RA

    m = b * t
    plan = RA.block_plan(b, t, d, torch.empty((), dtype=dtype).element_size(), heads)
    st = stage_times(tag, fn, [("QKV", m, 3 * d, d), ("P", 2 * t - 1, d, d), ("out", m, d, d)], card, dtype=dtype)
    tiled = [label for label in st["stages"] if any(word in label for word in K1_TILED_STAGES)]
    if plan.hopper and tiled:
        raise RuntimeError(f"{tag}: the Hopper design still launches {tiled}")
    n = kernel_launches(fn)
    if n != plan.launches:
        raise RuntimeError(f"{tag}: {n:g} launches per call, the plan says {plan.launches}")
    core = sum(ms for label, ms in st["stages"].items() if "rel_attn_" in label)
    log(f"  {tag}: {n:g} launches per call ({'the Hopper design' if plan.hopper else 'the tiled design'}); "
        f"the core alone {core:.4f} ms [{card}]")
    return {**st, "launches": n, "core_ms": core}


def attention_phase(card: str) -> dict:
    import torch

    from parakeet_tpu_torch.ops import rel_attention as RA

    log(f"== K1 rel_attention_block vs rel_attention_block_reference (B={B}, D={D}, H={H})")
    out = {"max_abs_err": 0.0, "times": {}, "bf16_times": {}, "work": {}, "bf16_work": {}, "stages": {},
           "bf16_stages": {}, "core": {}}
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
                    out["core"][f"T'={t} {name}"] = k1_core_line(tag, B, t, D, H, got.element_size(), card)
                    stages = "stages" if dtype == torch.float32 else "bf16_stages"
                    out[stages][t] = k1_stage_lines(tag, fn, B, t, D, H, dtype, card)
                    if dtype == torch.float32:
                        out["stages"][t]["tiles"] = tile_choice(tag, fn, RA, "block_plan", "qkv", card)
    # every head dim, split and unsplit: hd 32 (B=2, T'=77: 2 key splits),
    # the 600m widths (D=1024, hd=128) at T'=126 (no split) and B=1, T'=300
    # (4 splits), Sortformer's B=1, T'=751 (4 splits, timed), and one long
    # item past any length cap (B=1, T'=3000): one kernel for every T
    for b, t, d, heads in ((2, 77, 256, 8), (B, 126, 1024, H), (1, 300, 1024, H), (1, 751, D, H), (1, 3000, D, H)):
        for dtype, name in _dtypes():
            rng = np.random.RandomState(40 + t + d)
            dev = _dev(rng, dtype)
            args = _attention_args(rng, dev, b, t, d, heads)
            lengths = _mixed_lengths(rng, t) if b == B else np.asarray([rng.randint(t // 2, t), t][:b])
            kw = dict(lengths=torch.as_tensor(lengths, dtype=torch.int32, device="cuda"),
                      norm_w=dev(1 + rng.normal(0, 0.1, d), torch.float32),
                      norm_b=dev(rng.normal(0, 0.1, d), torch.float32))
            with torch.inference_mode():
                got = RA.rel_attention_block(*args, **kw)
                ref = RA.rel_attention_block_reference(*args, **kw)
            shape = f"B={b} T'={t} D={d} hd={d // heads}"
            tag = f"K1 {shape} {name} lengths {lengths.min()}-{lengths.max()}"
            err = check_close(tag, got, ref, _valid_rows(lengths, t))
            if dtype == torch.float32:
                out["max_abs_err"] = max(out["max_abs_err"], err)
            out["core"][f"{shape} {name}"] = k1_core_line(tag, b, t, d, heads, got.element_size(), card)
            if (b, t) == (1, 751):
                key = "times" if dtype == torch.float32 else "bf16_times"
                fn = lambda: RA.rel_attention_block(*args, **kw)  # noqa: E731
                out[key][shape] = time_pair(tag, fn, lambda: RA.rel_attention_block_reference(*args, **kw), card)
                out[key.replace("times", "work")][shape] = (
                    attention_flops(b, t, d, heads, lengths),
                    tensor_bytes(*args, *kw.values(), got) + (2 * t - 1) * d * got.element_size())
                k1_stage_lines(tag, fn, b, t, d, heads, dtype, card)
    return out


# K6 and K5 at the shapes the card tests name (tests/test_torch_hopper_gemm.py
# K6_K5_SHAPES): (B, T', D, F) at the 110m widths, odd widths (rows TMA
# cannot load), D = 1280 (bf16's tiled route) and a short T'
K6_K5_EDGE = ((2, 64, 512, 2048), (3, 37, 36, 70), (3, 37, 96, 100), (2, 64, 1280, 1280), (2, 20, 64, 128))


def route_lines(tag: str, fn, gemms, dtype, plan, card: str) -> dict:
    """K6's or K5's launches by kernel (device ms per call, torch.matmul in
    the same dtype beside each GEMM) and its launches per call against its
    plan's; the Hopper route launches no LayerNorm and no closing pass."""
    st = stage_times(tag, fn, gemms, card, dtype=dtype)
    bad = [label for label in st["stages"] if plan.route == "hopper" and any(
        word in label for word in ("layer_norm_rows_kernel", "gemm_reduce_kernel", "ffn_gemm_"))]
    if bad:
        raise RuntimeError(f"{tag}: the Hopper route launches {bad}")
    n = kernel_launches(fn)
    if n != plan.launches:
        raise RuntimeError(f"{tag}: {n:g} launches per call, the plan says {plan.launches}")
    log(f"  {tag}: {n:g} launches per call (the {plan.route} route) [{card}]")
    return {**st, "launches": n, "route": plan.route}


def tiled_turns(tag: str, fn, module, plan_fn: str, tiled_plan, card: str) -> dict:
    """bf16: the device time of `fn` on the Hopper route and on the tiled
    route (mma.sync with the LayerNorm and closing launches: the design K6
    and K5 ran in bf16 before), in turns, best of 2; only this measurement
    swaps the plan."""
    import torch

    planner = getattr(module, plan_fn)
    turns = {"hopper": [], "tiled": []}
    with torch.inference_mode():
        for _ in range(2):
            turns["hopper"].append(device_ms(fn))
            setattr(module, plan_fn, lambda *a, **kw: tiled_plan)
            try:
                turns["tiled"].append(device_ms(fn))
            finally:
                setattr(module, plan_fn, planner)
    new, old = min(turns["hopper"]), min(turns["tiled"])
    log(f"  {tag}: device ms in turns (best of 2): the Hopper route {new:.4f}, the tiled route (mma.sync) {old:.4f} "
        f"(old / new {old / new:.2f}x) [{card}]")
    return {"ms": new, "old_ms": old}


def lna_choice(tag: str, fn, module, plan_fn: str, field: str, card: str) -> dict:
    """bf16: the device time of `fn` with the LayerNorm'd GEMM (`field` of
    the plan `module.plan_fn` returns) run in clusters of 1, 2, 4 and 8
    column tiles (the fewest that exist when a row has fewer), each timed
    twice; the plan's own width is marked. Only this measurement swaps the
    plan; the port always runs the plan's choice."""
    import dataclasses

    import torch

    planner = getattr(module, plan_fn)
    chosen = {}

    def with_cols(cols):
        def plan_fn_cols(*a, **kw):
            plan = planner(*a, **kw)
            g = getattr(plan, field)
            chosen.setdefault("plan", g.cluster_cols)
            return plan if cols is None else dataclasses.replace(plan, **{field: dataclasses.replace(g, cluster_cols=cols)})
        return plan_fn_cols

    ms = {}
    with torch.inference_mode():
        fn()
        widths = (1, 2, 4, 8)
        for cols in (None, *widths, *reversed(widths)):
            setattr(module, plan_fn, with_cols(cols))
            try:
                t = device_ms(fn)
            finally:
                setattr(module, plan_fn, planner)
            key = chosen["plan"] if cols is None else cols
            ms[key] = min(ms.get(key, float("inf")), t)
    log(f"  {tag} {field} LayerNorm cluster widths, device ms of the whole call (best of 2): "
        + ", ".join(f"{c} {ms[c]:.4f}{' (the plan)' if c == chosen['plan'] else ''}" for c in sorted(ms)) + f" [{card}]")
    return ms


def lna_line(tag: str, args, card: str) -> dict:
    """bf16 fc1 at K6's shapes three ways: with the LayerNorm on its A path
    (K6's Hopper route), on A as given (K6's Hopper route without norm
    weights, as K4's fc1 runs), and the LayerNorm launch that a plain-A
    fc1 would need before it (layer_norm_rows_kernel on the same rows, as
    K1's head-sharded design launches it): device ms per call."""
    import torch

    from parakeet_tpu_torch.ops import feed_forward as FF
    from parakeet_tpu_torch.ops import rel_attention as RA

    x, nw, nb, w1, b1, w2, b2 = args
    b, t, d = x.shape
    heads = 8
    rng = np.random.RandomState(7)
    dev = _dev(rng, torch.bfloat16)
    att = _attention_args(rng, dev, b, t, d, heads)[1:]
    wq, bq, wk, bk, wv, bv, bu, bvv, pos_w, wo = att[:10]

    def fc1_ms(fn):
        return sum(ms for label, ms in profile_device(fn, 10).items() if "hopper_gemm_kernel<0," in label)

    with torch.inference_mode():
        FF.fused_feed_forward(*args)
        lna = fc1_ms(lambda: FF.fused_feed_forward(*args))
        plain = fc1_ms(lambda: FF.fused_feed_forward(x, None, None, w1, b1, w2, b2))
        heads_fn = lambda: RA.rel_attention_block_heads(x, wq, bq, wk, bk, wv, bv, bu, bvv, pos_w, wo,  # noqa: E731
                                                         norm_w=nw, norm_b=nb)
        heads_fn()
        ln = sum(ms for label, ms in profile_device(heads_fn, 10).items() if "layer_norm_rows_kernel" in label)
    verdict = "LNA wins" if lna < ln + plain else "LNA LOSES"
    log(f"  {tag} fc1 ({b * t}x{d} @ {d}x{w1.shape[0]}), device ms: with the LayerNorm on its A path {lna:.4f}; "
        f"a LayerNorm launch {ln:.4f} + fc1 on a plain A {plain:.4f} = {ln + plain:.4f}; {verdict} [{card}]")
    return {"lna_ms": lna, "ln_ms": ln, "plain_ms": plain}


def feed_forward_phase(card: str) -> dict:
    import torch

    from parakeet_tpu_torch.ops import feed_forward as FF
    from parakeet_tpu_torch.ops import gemm_plan as GP

    log(f"== K6 fused_feed_forward vs fused_feed_forward_reference (B={B}, D={D}, F={FFN})")
    out = {"max_abs_err": 0.0, "times": {}, "bf16_times": {}, "work": {}, "bf16_work": {}, "stages": {},
           "redesign": {}, "lna": {}}

    def cases(t, d, f, dtype, name, seed, label=None):
        rng = np.random.RandomState(seed)
        dev = _dev(rng, dtype)
        x = dev(rng.randn(B, t, d))
        norms = [dev(1 + 0.1 * rng.randn(d), torch.float32), dev(0.1 * rng.randn(d), torch.float32)]
        weights = [dev(rng.randn(f, d) / np.sqrt(d)), dev(0.05 * rng.randn(f)),
                   dev(rng.randn(d, f) / np.sqrt(f)), dev(0.05 * rng.randn(d))]
        final = dict(final_norm_w=dev(1 + 0.1 * rng.randn(d), torch.float32),
                     final_norm_b=dev(0.1 * rng.randn(d), torch.float32))
        args = (x, *norms, *weights)
        shape = label or t
        size = x.element_size()
        for with_final in (False, True):
            kw = final if with_final else {}
            with torch.inference_mode():
                got = FF.fused_feed_forward(*args, **kw)
                ref = FF.fused_feed_forward_reference(*args, **kw)
            plan = FF.ffn_plan(B * t, d, f, size, with_final)
            tag = f"K6 T'={t} D={d} F={f} {name} final_norm={with_final} ({plan.route}, fc2 in {plan.splits} k slices)"
            err = check_close(tag, got, ref)
            if dtype == torch.float32:
                out["max_abs_err"] = max(out["max_abs_err"], err)
            fn = lambda: FF.fused_feed_forward(*args, **kw)  # noqa: E731
            gemms = [("fc1", B * t, f, d), ("fc2", B * t, d, f)]
            key = f"T'={t} D={d} {name} final_norm={with_final}"
            out["stages"][key] = route_lines(tag, fn, gemms, dtype, plan, card)
            if not with_final:
                times = "times" if dtype == torch.float32 else "bf16_times"
                out[times][shape] = time_pair(tag, fn, lambda: FF.fused_feed_forward_reference(*args, **kw), card)
                out[times.replace("times", "work")][shape] = (ffn_flops(B * t, d, f), tensor_bytes(*args, got))
                if plan.route == "hopper":
                    m, fc2 = B * t, GP.gemm_plan(B * t, d, f, 2)
                    tiled = FF.FfnPlan("tiled", 4, GP.GemmPlan(128, 1, GP.gemm_smem(128, 2), GP.tiles(m, f)), fc2,
                                       (m * d + m * f) * 2 + fc2.splits * m * d * 4)
                    out["redesign"][key] = tiled_turns(tag, fn, FF, "ffn_plan", tiled, card)
                    out["redesign"][key]["launches"] = out["stages"][key]["launches"]
                    out["lna"][key] = lna_line(tag, args, card)
                    out["lna"][key]["widths"] = lna_choice(tag, fn, FF, "ffn_plan", "fc1", card)

    for t in (126, 751):
        for dtype, name in _dtypes():
            cases(t, D, FFN, dtype, name, 100 + t)
    # the 600m presets' widths (config.py make_600m_config: d=1024, ffn 4096)
    for dtype, name in _dtypes():
        cases(126, 1024, 4096, dtype, name, 1100, label="600m B=8 T'=126 D=1024 F=4096")
    # the card tests' shapes: odd widths, the tiled route in bf16, a short T'
    for b, t, d, f in K6_K5_EDGE:
        for dtype, name in _dtypes():
            rng = np.random.RandomState(b + t + d + f)
            dev = _dev(rng, dtype)
            args = (dev(rng.randn(b, t, d)), dev(1 + 0.1 * rng.randn(d), torch.float32),
                    dev(0.1 * rng.randn(d), torch.float32), dev(rng.randn(f, d) / np.sqrt(d)),
                    dev(0.05 * rng.randn(f)), dev(rng.randn(d, f) / np.sqrt(f)), dev(0.05 * rng.randn(d)))
            for kw in ({}, dict(final_norm_w=dev(1 + 0.1 * rng.randn(d), torch.float32),
                                final_norm_b=dev(0.1 * rng.randn(d), torch.float32))):
                with torch.inference_mode():
                    got, ref = FF.fused_feed_forward(*args, **kw), FF.fused_feed_forward_reference(*args, **kw)
                route = FF.ffn_plan(b * t, d, f, args[0].element_size(), bool(kw)).route
                err = check_close(f"K6 B={b} T'={t} D={d} F={f} {name} final_norm={bool(kw)} ({route})", got, ref)
                if dtype == torch.float32:
                    out["max_abs_err"] = max(out["max_abs_err"], err)
    return out


def _conv_args(rng, dev, b, t, d):
    x = dev(rng.randn(b, t, d))
    return (x, *_conv_weights(rng, dev, d))


def conv_module_phase(card: str) -> dict:
    import torch

    from parakeet_tpu_torch.ops import conv_module as CM
    from parakeet_tpu_torch.ops import gemm_plan as GP

    log(f"== K5 fused_conv_module vs fused_conv_module_reference (B={B}, D={D}, k=9)")
    out = {"max_abs_err": 0.0, "times": {}, "bf16_times": {}, "work": {}, "bf16_work": {}, "stages": {},
           "redesign": {}}

    def cases(t, d, dtype, name, seed, label=None):
        rng = np.random.RandomState(seed)
        args = _conv_args(rng, _dev(rng, dtype), B, t, d)
        lengths = _mixed_lengths(rng, t)
        plan = CM.conv_plan(B * t, d, args[0].element_size())
        for masked in (True, False):
            lt = torch.as_tensor(lengths, dtype=torch.int32, device="cuda") if masked else None
            with torch.inference_mode():
                got = CM.fused_conv_module(*args, lengths=lt)
                ref = CM.fused_conv_module_reference(*args, lengths=lt)
            tag = f"K5 T'={t} D={d} {name} mixed_lengths={masked} ({plan.route}, pw2 in {plan.pw2.splits} k slices)"
            err = check_close(tag, got, ref)
            if dtype == torch.float32:
                out["max_abs_err"] = max(out["max_abs_err"], err)
            if not masked:
                continue
            fn = lambda: CM.fused_conv_module(*args, lengths=lt)  # noqa: E731
            times = "times" if dtype == torch.float32 else "bf16_times"
            shape = label or t
            out[times][shape] = time_pair(tag, fn, lambda: CM.fused_conv_module_reference(*args, lengths=lt), card)
            out[times.replace("times", "work")][shape] = (conv_flops(B * t, d, 9), tensor_bytes(*args, lt, got))
            m = B * t
            key = f"T'={t} D={d} {name}"
            out["stages"][key] = route_lines(tag, fn, [("pw1", m, 2 * d, d), ("pw2", m, d, d)], dtype, plan, card)
            if plan.route == "tiled" and label is None:
                out["stages"][key]["tiles"] = tile_choice(tag, fn, CM, "conv_plan", "pw1", card)
            if plan.route == "hopper":
                pw2 = GP.gemm_plan(m, d, d, 2)
                tiled = CM.ConvPlan("tiled", 5, GP.gemm_plan(m, 2 * d, d, 2, split_k=False), pw2, pw2.splits * m * d)
                out["redesign"][key] = tiled_turns(tag, fn, CM, "conv_plan", tiled, card)
                out["redesign"][key]["launches"] = out["stages"][key]["launches"]
                out["stages"][key]["widths"] = lna_choice(tag, fn, CM, "conv_plan", "pw1", card)

    for t in (126, 751):
        for dtype, name in _dtypes():
            cases(t, D, dtype, name, 200 + t)
    # the 600m widths (D=1024)
    for dtype, name in _dtypes():
        cases(126, 1024, dtype, name, 1200, label="600m B=8 T'=126 D=1024")
    # the card tests' shapes: odd widths, the tiled route in bf16, a short T'
    for b, t, d, _ in K6_K5_EDGE:
        for dtype, name in _dtypes():
            rng = np.random.RandomState(b + t + d)
            args = _conv_args(rng, _dev(rng, dtype), b, t, d)
            lt = torch.as_tensor([t, *(max(1, t - 9 * i - 2) for i in range(1, b))], dtype=torch.int32, device="cuda")
            with torch.inference_mode():
                got, ref = CM.fused_conv_module(*args, lengths=lt), CM.fused_conv_module_reference(*args, lengths=lt)
            route = CM.conv_plan(b * t, d, args[0].element_size()).route
            err = check_close(f"K5 B={b} T'={t} D={d} {name} lengths below T' ({route})", got, ref)
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
    out = {"max_abs_err": 0.0, "times": {}, "bf16_times": {}, "work": {}, "bf16_work": {}}
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
            key = "times" if dtype == torch.float32 else "bf16_times"
            fn = lambda: K4.fused_conv_ffn_final(*args, lengths=lt)
            out[key][t] = time_pair(tag, fn, lambda: K4.fused_conv_ffn_final_reference(*args, lengths=lt), card)
            out[key.replace("times", "work")][t] = (conv_flops(B * t, D, 9) + ffn_flops(B * t, D, FFN),
                                                    tensor_bytes(*args, lt, got))
            out.setdefault("redesign", {})[f"T'={t} {name}"] = redesign_times(
                tag, fn, lambda: k4_old(args, lt), k4_gemms(B, t, D, FFN), dtype,
                K4.k4_plan(B, t, D, FFN, got.element_size()), card)
    return out


def ffn_attention_phase(card: str) -> dict:
    import torch

    from parakeet_tpu_torch.ops import ffn_attention as K7

    log(f"== K7 fused_ffn_attention vs fused_ffn_attention_reference (B={B}, D={D}, H={H}, F={FFN})")
    out = {"max_abs_err": 0.0, "times": {}, "bf16_times": {}, "work": {}, "bf16_work": {}}
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
            key = "times" if dtype == torch.float32 else "bf16_times"
            fn = lambda: K7.fused_ffn_attention(*args, lengths=lt)
            out[key][t] = time_pair(tag, fn, lambda: K7.fused_ffn_attention_reference(*args, lengths=lt), card)
            pe_bytes = (2 * t - 1) * D * got.element_size()
            out[key.replace("times", "work")][t] = (ffn_flops(B * t, D, FFN) + attention_flops(B, t, D, H, lengths),
                                                    tensor_bytes(*args, lt, got) + pe_bytes)
            out.setdefault("redesign", {})[f"T'={t} {name}"] = redesign_times(
                tag, fn, lambda: k7_old(args, lt), k7_gemms(B, t, D, FFN), dtype,
                K7.k7_plan(B, t, D, FFN, got.element_size()), card)
    return out


# K2's shapes (B, T', hd, lengths or None for mixed): the 110m v1 batch at
# 10 s, 60 s and past the reference's T' <= 768 cap, one long item, hd 32,
# and a ragged T' with lengths of one key and none at every head dim
K2_SHAPES = ((B, 126, 64, None), (B, 751, 64, None), (B, 1001, 64, None), (1, 3000, 64, (2047,)),
             (B, 126, 32, None), (4, 37, 32, (37, 21, 1, 0)), (4, 37, 64, (37, 21, 1, 0)),
             (4, 37, 128, (37, 21, 1, 0)))


def _k2_rows(lengths, t: int):
    """The rows a caller reads: t < length, every row of an item with no
    valid key (which averages all T' keys)."""
    return _valid_rows([n if n > 0 else t for n in lengths], t)


def k1_core_ms(b: int, t: int, heads: int, hd: int, lengths, dtype) -> float:
    """K1's core stage at K2's shape: K1's block at D = H·hd on random
    inputs with the same key lengths, profiled by kernel, its core's
    launches (rel_attn_*) summed, device ms a call, the most of two
    profiles (a profile can drop events: one read 0.0020 ms against
    0.0205): the yardstick of what the same scores and AV cost in the
    one-sweep core."""
    import torch

    from parakeet_tpu_torch.ops import rel_attention as RA

    rng = np.random.RandomState(70 + t + hd)
    dev = _dev(rng, dtype)
    args = _attention_args(rng, dev, b, t, heads * hd, heads)
    lt = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
    core = 0.0
    with torch.inference_mode():
        fn = lambda: RA.rel_attention_block(*args, lengths=lt)  # noqa: E731
        fn()
        for attempt in range(5):
            if attempt >= 2 and core > 0:
                break
            raw = profile_device(fn, 10)
            core = max(core, sum(ms for key, ms in raw.items() if "rel_attn_" in _kernel_label(key)))
    if core <= 0:
        raise RuntimeError("K1 core stage: the profiler saw no core launch in 5 profiles")
    return core


def k2_design_turns(tag: str, fn, plan, card: str) -> dict:
    """bf16: K2's two designs on the same inputs, device ms in turns (best
    of 2): a split's scores kept in shared memory between the sweeps
    (v1_core_plan's keep=True, where a split's tiles fit) and computed
    again in sweep 2 (keep=False); `plan` is the one the port runs."""
    import functools

    import torch

    from parakeet_tpu_torch.ops import rel_attention as RA

    planner, turns = RA.v1_core_plan, {True: [], False: []}
    try:
        with torch.inference_mode():
            for _ in range(2):
                for keep in (True, False):
                    RA.v1_core_plan = functools.partial(planner, keep=keep)
                    turns[keep].append(device_ms(fn))
    finally:
        RA.v1_core_plan = planner
    kept, again = min(turns[True]), min(turns[False])
    log(f"  {tag} bf16 designs, device ms in turns (best of 2): scores kept {kept:.4f}, computed again {again:.4f}; "
        f"the plan runs {'kept' if plan.kept else 'computed again'} [{card}]")
    return {"kept_ms": kept, "again_ms": again}


def k2_shape(b: int, t: int, hd: int, lengths, dtype, name: str, card: str, seed: int) -> dict:
    """K2 at one shape against its plain version on the same inputs: the
    plan (splits, kept tiles, resident blocks by the plan and the card),
    the check, the launches a call (profiler: one), the kernel / plain times
    with the bound and its share, K1's core stage at the same shape, and in
    bf16 the two designs in turns."""
    import torch

    from parakeet_tpu_torch.ops import rel_attention as RA

    rng = np.random.RandomState(seed)
    dev = _dev(rng, dtype)
    args = (*(dev(rng.randn(b, H, t, hd)) for _ in range(4)), dev(rng.randn(H, 2 * t - 1, hd)))
    lengths = _mixed_lengths(rng, t) if lengths is None else np.asarray(lengths)
    lt = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
    fn = lambda: RA.fused_rel_attention(*args, lengths=lt)  # noqa: E731
    plain = lambda: RA.fused_rel_attention_reference(*args, lengths=lt)  # noqa: E731
    with torch.inference_mode():
        got, ref = fn(), plain()
    size = got.element_size()
    plan = RA.v1_core_plan(b, t, H, hd, size)
    resident = RA.v1_core_resident(size, hd, plan.kept)
    shape = f"B={b} T'={t} hd={hd}"
    tag = f"K2 {shape} {name} lengths {lengths.min()}-{lengths.max()}"
    log(f"  {tag} plan: {plan.blocks} blocks x {plan.splits} key splits, {plan.tiles_per_split} of {plan.tiles} key "
        f"tiles a split, {plan.kept} kept, {plan.threads} threads, {plan.smem} B shared; resident blocks an SM: plan "
        f"{plan.resident}, card {resident} [{card}]")
    if resident != plan.resident:
        raise RuntimeError(f"{tag}: the card holds {resident} blocks an SM, the plan says {plan.resident}")
    err = check_close(tag, got.transpose(1, 2), ref.transpose(1, 2), _k2_rows(lengths, t))
    n = kernel_launches(fn)
    if n != 1:
        raise RuntimeError(f"{tag}: {n:g} device launches a call, K2 is one")
    ms = time_pair(tag, fn, plain, card)
    work = (core_flops(t, hd, H, lengths), tensor_bytes(*args, lt, got))
    bd = bound(*work, F32_PEAK if dtype == torch.float32 else BF16_PEAK)
    k1 = k1_core_ms(b, t, H, hd, lengths, dtype)
    log(f"  bound {tag}: {bd['gflop']:.3f} GFLOP, {bd['mbyte']:.2f} MB -> {bd['bound_ms']:.4f} ms by "
        f"{bd['bound_by']}, {bd['bound_ms'] / ms['dev_ms']:.1%} of the kernel's device {ms['dev_ms']:.4f} ms "
        f"(plain {ms['plain_dev_ms']:.4f}); {n:g} launch a call; K1's core stage at this shape {k1:.4f} ms [{card}]")
    res = {"err": err, "ms": ms, "work": work, "k1_core_ms": k1, "launches": n, "plan": plan}
    if dtype == torch.bfloat16:
        res["designs"] = k2_design_turns(tag, fn, plan, card)
    return res


def rel_attention_v1_phase(card: str) -> dict:
    import torch

    log(f"== K2 fused_rel_attention vs fused_rel_attention_reference (H={H})")
    out = {"max_abs_err": 0.0, "times": {}, "bf16_times": {}, "work": {}, "bf16_work": {}, "k1_core": {},
           "designs": {}}
    for b, t, hd, lengths in K2_SHAPES:
        for dtype, name in _dtypes():
            r = k2_shape(b, t, hd, lengths, dtype, name, card, seed=600 + t)  # the inputs the earlier K2 designs were timed on
            if dtype == torch.float32:
                out["max_abs_err"] = max(out["max_abs_err"], r["err"])
            key = "times" if dtype == torch.float32 else "bf16_times"
            label = t if (b, hd) == (B, 64) else f"B={b} T'={t} hd={hd}"
            out[key][label] = r["ms"]
            out[key.replace("times", "work")][label] = r["work"]
            out["k1_core"][f"{label} {name}"] = r["k1_core_ms"]
            if "designs" in r:
                out["designs"][label] = r["designs"]
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

    def run(name, shape, dtype, dtname, fn, plain_fn, work, rows=None):
        with torch.inference_mode():
            got, ref = fn(), plain_fn()
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
        size = 4 if dtype == torch.float32 else 2
        out["fused_ffn_attention"].setdefault("redesign", {})[f"600m T'={t} {name}"] = redesign_times(
            f"K7 600m T'={t} {name}", lambda: K7.fused_ffn_attention(*k7, lengths=lt), lambda: k7_old(k7, lt),
            k7_gemms(B, t, d6, f6), dtype, K7.k7_plan(B, t, d6, f6, size), card)
        out["fused_conv_ffn_final"].setdefault("redesign", {})[f"600m T'={t} {name}"] = redesign_times(
            f"K4 600m T'={t} {name}", lambda: K4.fused_conv_ffn_final(*k4, lengths=lt), lambda: k4_old(k4, lt),
            k4_gemms(B, t, d6, f6), dtype, K4.k4_plan(B, t, d6, f6, size), card)

        for t in (126, 751):
            r = k2_shape(B, t, hd6, None, dtype, name, card, seed=1500 + t)
            entry, shape = out["fused_rel_attention"], f"B={B} T'={t} hd={hd6}"
            if dtype == torch.float32:
                entry["max_abs_err"] = max(entry["max_abs_err"], r["err"])
            key = "times" if dtype == torch.float32 else "bf16_times"
            entry[key][shape] = r["ms"]
            entry[key.replace("times", "work")][shape] = r["work"]
            entry.setdefault("k1_core", {})[f"{shape} {name}"] = r["k1_core_ms"]
            if "designs" in r:
                entry.setdefault("designs", {})[shape] = r["designs"]

        # K1 at the dense 95 s call (B=1, T'=1188) and the 600m trainer's
        # batches (B=4 and B=2 at T'=125, mixed lengths): split keys
        for b, t in ((1, 1188), (4, 125), (2, 125)):
            rng = np.random.RandomState(1600 + b)
            dev = _dev(rng, dtype)
            k1 = _attention_args(rng, dev, b, t, d6, H)
            lengths = np.asarray([t]) if b == 1 else np.asarray([t, *rng.randint(t // 4, t + 1, size=b - 1)])
            kw = dict(lengths=torch.as_tensor(lengths, dtype=torch.int32, device="cuda"),
                      norm_w=dev(1 + rng.normal(0, 0.1, d6), torch.float32),
                      norm_b=dev(rng.normal(0, 0.1, d6), torch.float32))
            shape = f"B={b} T'={t} D={d6} hd={hd6}"
            run("rel_attention_block", shape, dtype, name,
                lambda: RA.rel_attention_block(*k1, **kw), lambda: RA.rel_attention_block_reference(*k1, **kw),
                lambda got: (attention_flops(b, t, d6, H, lengths),
                             tensor_bytes(*k1, *kw.values(), got) + (2 * t - 1) * d6 * got.element_size()),
                rows=_valid_rows(lengths, t))
            tag = f"K1 600m {shape} {name}"
            k1_core_line(tag, b, t, d6, H, k1[0].element_size(), card)
            # where K1's time goes: each launch, the core alone
            k1_stage_lines(tag, lambda: RA.rel_attention_block(*k1, **kw), b, t, d6, H, dtype, card)
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
            "rel_attention_block_heads": rel_attention.rel_attention_block_heads,
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
            "rel_attention_block_heads": 0,  # a 'model' mesh's (phase mesh)
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


def short_clips(clips) -> list:
    """The clips under 6 s (4 of the 8): the 600m paths whose CPU decode
    sets their time run on these."""
    return [c for c in clips if len(c) < 6 * 16000]


def model_params(model: str) -> dict:
    """Seeded random weights (seed 0) of a model at full width, as numpy:
    the 110m's from numpy's generator, the 600m models' drawn on the card
    (`host_params`)."""
    from parakeet_tpu_torch import config as C
    from parakeet_tpu_torch import params as P

    spec = {"tdt-ctc-110m": P.tdt_ctc_spec, "tdt-600m": P.tdt_spec, "rnnt-600m": P.rnnt_spec}[model]
    spec = spec(getattr(C, MODELS[model][1])())
    return P.init_params_numpy(spec, seed=0) if model == "tdt-ctc-110m" else host_params(spec, seed=0)


def weights_phase(flat: dict, card: str) -> dict:
    """tdt-ctc-110m's seeded weights written with the port's
    io.save_safetensors, read back with load_safetensors and loaded onto
    the card through params.load_params(spec, weights=..., strict=True,
    device="cuda"): every tensor float32 on the card and equal to what was
    written."""
    import torch

    from parakeet_tpu_torch import config as C
    from parakeet_tpu_torch import params as P
    from parakeet_tpu_torch.io import load_safetensors, save_safetensors

    spec = P.tdt_ctc_spec(C.make_110m_config())
    path = ROOT / "build" / "parakeet_tpu_torch" / "smoke_110m.safetensors"
    path.parent.mkdir(parents=True, exist_ok=True)
    out = {}
    try:
        t0 = time.perf_counter()
        save_safetensors(flat, path)
        out["write_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        weights = load_safetensors(path)
        out["read_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = P.load_params(spec, weights=weights, strict=True, device="cuda")
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
    finally:
        path.unlink(missing_ok=True)
    if set(loaded) != set(spec) or set(flat) != set(spec):
        raise RuntimeError("weights: the loaded keys are not the spec's")
    for key, got in loaded.items():
        if got.device.type != "cuda" or got.dtype != torch.float32 or not np.array_equal(got.cpu().numpy(), flat[key]):
            raise RuntimeError(f"weights: {key} on the card differs from what was written")
    nbytes = sum(a.nbytes for a in flat.values())
    log(f"== weights: {len(spec)} tensors, {nbytes / 1e6:.1f} MB written with save_safetensors in "
        f"{out['write_s']:.2f} s, read in {out['read_s']:.2f} s, load_params(weights=..., strict=True, "
        f"device='cuda') in {out['load_s']:.2f} s (while the kernels build); every tensor on the card equal to "
        f"what was written [{card}]")
    return out


def host_params(spec: dict, seed: int) -> dict:
    """`card_params` copied to the host as numpy: numpy's draw of a 600m
    model's weights took ~20 s, this one ~2 s."""
    return {k: v.cpu().numpy() for k, v in card_params(spec, seed).items()}


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


def path_phase(name: str, fused, flat, clips, card: str, model: str = "tdt-ctc-110m", quantize=None,
               compare_clips=None, profile_batch: bool = True) -> dict:
    """One model and encoder configuration end to end on the card against
    the CPU: each of the model's decoders (TDT and CTC for tdt-ctc, the
    transducer alone for TDT-only and RNNT, where CTC must raise). With
    `quantize` ("int8" or "int4") both facades quantize the weights and the
    launch counts follow the reference's weight guards. `compare_clips`:
    the clips on which card and CPU are held to each other (all of them
    unless given; the card's launches and times are on all)."""
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

    cmp_clips, gpu_cmp, cfeats, cframes = clips, gpu_res, feats, n_frames
    if compare_clips is not None:
        cmp_clips = compare_clips
        gpu_cmp = {dec: gpu.transcribe_batch(cmp_clips, opts[dec]) for dec in decoders}
        cfeats, cframes = preprocess_audio_batch(cmp_clips, cpu._audio_cfg, "cpu")
    cpu_res = {dec: cpu.transcribe_batch(cmp_clips, opts[dec]) for dec in decoders}
    enc_cpu = cpu.encode(cfeats, cframes)
    enc_gpu = gpu.encode(cfeats, cframes).cpu()
    enc_lens = encoded_lengths(torch.as_tensor(cframes)).tolist()
    enc_diff = max(float((enc_gpu[i, :n] - enc_cpu[i, :n]).abs().max()) for i, n in enumerate(enc_lens))
    enc_scale = max(float(enc_cpu[i, :n].abs().max()) for i, n in enumerate(enc_lens))
    if not torch.isfinite(enc_gpu).all():
        raise RuntimeError(f"{name}: encoder output on the card is not finite")
    if tuple(enc_gpu.shape) != (len(cmp_clips), max(enc_lens), cfg.encoder.hidden_size):
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
        compare_tokens(f"{name} {dec}", gpu_cmp[dec], cpu_res[dec],
                       ctc_margin_at if dec == "CTC" else transducer_margin_at)
    log(f"  tokens identical on card and CPU ({len(cmp_clips)} clips): " + ", ".join(
        f"{dec} {sum(len(r.token_ids) for r in gpu_cmp[dec])} tokens" for dec in decoders))
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
    busy = "the batch not profiled"
    if profile_batch:
        batch_dev = device_ms(lambda: gpu.transcribe_batch(clips, tdt), calls=1, profiles=1)
        busy = f"one profiled batch: device time {batch_dev:.3f} ms, busy {batch_dev / wall:.1%} of the median wall"
    log(f"  stages, wall ms (median of 5): frontend {front:.3f}, encoder {enc:.3f} "
        f"(device time {enc_dev:.3f}); warm {decoders[0]} batch {wall:.1f} ms (median of 3), "
        f"{out['rtfx']:.1f} audio s per wall s; {busy} [{card}]")
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


STREAM_EOU_S = 3  # eou-120m B=1 seconds of audio
STREAM_BATCH_S = 4  # eou-120m B=8 seconds a slot (at least 3.4: the scenario resets slot 5 at push 20)
NEMO_LAYERS = 8  # nemotron-600m's streaming encoder depth here, of its 24 (the CPU facade sets the time)


def streaming_phase(card: str) -> dict:
    """Streaming ASR at full width: eou-120m (StreamingTranscriber, B=1, 3 s
    in 160 ms pushes, f32 and bf16), nemotron-600m (NemotronTranscriber, 8
    of its 24 layers) in latency modes 0, 1, 6 and 13 (2 s each), and
    StreamingBatchTranscriber eou-120m at B=8 with the fused frontend and
    the int16 wire (a held step and a reset_slot; 4 s a slot); each against
    a CPU facade fed the same pushes."""
    import torch

    from parakeet_tpu_torch import config as C
    from parakeet_tpu_torch import params as P
    from parakeet_tpu_torch.streaming import NemotronTranscriber, StreamingBatchTranscriber, StreamingTranscriber

    out = {}
    eou_cfg = C.make_eou_120m_config()
    flat = P.init_params_numpy(P.eou_spec(eou_cfg), seed=0)
    audio = synthetic_clips(1, seed=1700, min_s=STREAM_EOU_S, max_s=STREAM_EOU_S)[0]
    pushes = _stream_pushes(audio)
    log(f"== streaming eou-120m: {eou_cfg.encoder.num_layers} layers, d={eou_cfg.encoder.hidden_size}, "
        f"left {eou_cfg.encoder.att_context_left}, right {eou_cfg.encoder.att_context_right}, random weights "
        f"(seed 0), f32, B=1, {STREAM_EOU_S} s in {len(pushes)} pushes")
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
    log(f"== streaming StreamingBatchTranscriber eou-120m: B=8, fused frontend, int16 wire, {STREAM_BATCH_S} s per "
        "slot")
    clips = synthetic_clips(8, seed=1800, min_s=STREAM_BATCH_S, max_s=STREAM_BATCH_S)
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

    def nemotron(mode):  # full width, NEMO_LAYERS of the 24 layers
        cfg = C.make_nemotron_600m_config(mode)
        return replace(cfg, encoder=replace(cfg.encoder, num_layers=NEMO_LAYERS))

    nemo_flat = host_params(P.nemotron_spec(nemotron(0)), seed=0)
    nemo_audio = synthetic_clips(1, seed=1750, min_s=2, max_s=2)[0]
    log(f"== streaming nemotron-600m at {NEMO_LAYERS} of its 24 layers (full width): "
        f"{sum(a.size for a in nemo_flat.values()) / 1e6:.1f} M parameters ({time.perf_counter() - t0:.1f} s to "
        f"draw), f32, B=1, 2 s in {len(_stream_pushes(nemo_audio))} pushes per latency mode")
    for mode in (0, 1, 6, 13):
        cfg = nemotron(mode)
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
    (every facade, then again in reverse order), one profile of 3 calls a
    turn, the lesser of the two."""
    import torch

    feats = feats.to(next(iter(facades.values())).device)
    ms = {}
    with torch.inference_mode():
        for name in [*facades, *reversed(facades)]:
            t = device_ms(lambda: facades[name].encode(feats, n_frames), calls=3, profiles=1)
            ms[name] = min(ms.get(name, float("inf")), t)
    log(f"  {tag} encoder device ms (torch.profiler, best of 2 turns): "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + f" [{card}]")
    return ms


def v1_encoders_phase(card: str) -> dict:
    """K2's encoders (the opt-in phase `v1`): one encoder call on the 8
    clips' features, device ms in turns (`encoder_turns`), and K2's
    launches a call (17, 24): tdt-ctc-110m under FusedLayers(attention=
    "v1") in f32 and bf16 and with int8 weights, fused (every attention on
    K2); tdt-600m v1 in f32 and bf16. No CPU comparison (the paths phases
    hold those configurations' tokens to the CPU). It uses only entry points
    that every tree of the port has, so it also times an older tree's K2
    when run from that tree's root."""
    import torch

    from parakeet_tpu_torch import config as C
    from parakeet_tpu_torch.audio.frontend import preprocess_audio_batch
    from parakeet_tpu_torch.models.encoder import FusedLayers

    clips = synthetic_clips(8, seed=1234)
    v1_cfg, fused_cfg = FusedLayers(attention="v1"), FusedLayers(ffn=True, conv=True, subsample=True)
    out = {}
    for model, mel, layers in (("tdt-ctc-110m", 80, 17), ("tdt-600m", 128, 24)):
        flat = model_params(model)
        facades = {"v1 f32": facade(model, "cuda", params=flat, fused=v1_cfg),
                   "v1 bf16": facade(model, "cuda", params=flat, fused=v1_cfg, compute_dtype="bfloat16")}
        if model == "tdt-ctc-110m":
            facades["int8 fused"] = facade(model, "cuda", params=flat, fused=fused_cfg, quantize="int8")
        del flat
        feats, n_frames = preprocess_audio_batch(clips, C.AudioConfig(n_mels=mel), "cpu")
        feats = feats.to("cuda")
        launches = {}
        with torch.inference_mode():
            for name, f in facades.items():
                reset_counts()
                f.encode(feats, n_frames)
                launches[name] = read_counts()["fused_rel_attention"]
                if launches[name] != layers:
                    raise RuntimeError(f"{model} {name}: {launches[name]} K2 launches an encoder call, want {layers}")
        out[model] = {"ms": encoder_turns(model, facades, feats, n_frames, card), "launches": launches}
        log(f"  {model}: K2 {layers} launches an encoder call in each [{card}]")
        del facades
        torch.cuda.empty_cache()
    return out


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
    # each held to the CPU on the 4 clips under 6 s (the CPU's decodes set the part's time)
    for mode in ("int8", "int4"):
        for label, cfg in (("default", FusedLayers()), ("fused", fused_cfg)):
            out[f"{mode} {label}"] = path_phase(f"{mode} {label}", cfg, flat, clips, card, quantize=mode,
                                                compare_clips=short_clips(clips))
    part("110m quantized paths")
    out["w8a8 default"] = w8a8_phase(flat, clips, card)
    part("W8A8")

    feats, n_frames = preprocess_audio_batch(clips, C.AudioConfig(n_mels=80), "cpu")
    for label, cfg in (("fused", fused_cfg),):
        facades, held = {}, {}
        for mode in ("f32", "int8", "int4"):
            facades[mode], held[mode] = resident(lambda: facade("tdt-ctc-110m", "cuda", params=flat, fused=cfg,
                                                                quantize=None if mode == "f32" else mode))
        part(f"110m {label} facades built")
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

    out["600m int8 default"] = path_phase("tdt-600m int8 default", FusedLayers(), flat6, short_clips(clips), card,
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
    pushes = _stream_pushes(synthetic_clips(1, seed=1700, min_s=8, max_s=8)[0])[:8]
    log(f"== options streaming: eou-120m quantize='int8', f32, B=1, {len(pushes)} pushes of 160 ms")
    gpu = StreamingTranscriber(config=eou_cfg, params=flat_e, device="cuda", quantize="int8")
    cpu = StreamingTranscriber(config=eou_cfg, params=flat_e, device="cpu", quantize="int8")
    out["streaming int8"] = streaming_facade_check("eou-120m int8 B=1", gpu, cpu, pushes, card)
    # int8 against f32 on this host: wall per push over the first 4 pushes
    # in turns (f32, int8, int8, f32), the lesser of each; device ms over 4
    trs = {"f32": StreamingTranscriber(config=eou_cfg, params=flat_e, device="cuda"), "int8": gpu}
    push_ms, dev_ms = {}, {}
    for name in [*trs, *reversed(trs)]:
        t = wall_ms(lambda: _run_stream(trs[name], pushes[:4]), 1) / 4
        push_ms[name] = min(push_ms.get(name, float("inf")), t)
    for name, tr in trs.items():
        dev_ms[name] = device_ms(lambda: _run_stream(tr, pushes[:4]), calls=1, profiles=1) / 4
    log("  eou-120m B=1 per push, f32 vs int8 in turns: wall ms (mean of the first 4 pushes, best of 2 turns) "
        + ", ".join(f"{k} {v:.3f}" for k, v in push_ms.items()) + "; device ms (first 4 pushes) "
        + ", ".join(f"{k} {v:.3f}" for k, v in dev_ms.items()) + f" [{card}]")
    out["streaming int8"].update(push_ms=push_ms, push_dev_ms=dev_ms)
    part("streaming")
    return out


# ── lookahead: the reference's decode-loop family (impl, window, unroll) ──

LOOKAHEAD_TOKENS_PER_S = 3.5  # bench.py _e2e_setup's speech-like emission density
LOOKAHEAD_WINDOWS = (4, 8, 16)
LOOKAHEAD_CONF_RTOL = 1e-5  # confidences, each loop on the card against the step loop on the card


def with_blank_bias(params: dict, key: str, blank: int, offset: float) -> dict:
    """params with `offset` added to the blank's entry of the label bias."""
    bias = params[key].clone()
    bias[blank] += offset
    return dict(params, **{key: bias})


def blank_bias_offset(count, params: dict, key: str, blank: int, audio_s: float) -> tuple[float, dict]:
    """The offset on the blank's label bias that brings random weights to a
    speech-like density, bisected as the reference's bench.py (:114-140)
    does: 10 halvings of [0, 30], toward LOOKAHEAD_TOKENS_PER_S tokens per
    audio second over the batch; `count(params)` is the batch's token
    count. The offset tried whose count came nearest the target (the
    reference keeps the last one tried: on a cliff, where random RNNT
    weights go from ~10 symbols a frame to a few within one halving, that
    one may lie far on the other side), and every offset tried with its
    count."""
    target = LOOKAHEAD_TOKENS_PER_S * audio_s
    lo, hi, tried = 0.0, 30.0, {}
    for _ in range(10):
        mid = (lo + hi) / 2
        tried[mid] = count(with_blank_bias(params, key, blank, mid))
        lo, hi = (mid, hi) if tried[mid] > target else (lo, mid)
    return min(tried, key=lambda m: abs(np.log((tried[m] + 1) / (target + 1)))), tried


def same_decode(name: str, got, ref, conf_rtol: float | None) -> float:
    """Two greedy decodes' tokens and frames identical, item by item; with
    `conf_rtol`, their confidences within it. The worst relative
    confidence difference."""
    worst = 0.0
    for i, (g, r) in enumerate(zip(got.timestamped, ref.timestamped)):
        gs, rs = ([(t.token_id, t.start_frame, t.end_frame) for t in x] for x in (g, r))
        if gs != rs:
            j = next((k for k, (a, b) in enumerate(zip(gs, rs)) if a != b), min(len(gs), len(rs)))
            raise RuntimeError(f"{name}: item {i} differs first at token {j}: {gs[j:j + 3]} vs {rs[j:j + 3]}")
        gc, rc = (np.array([t.confidence for t in x], np.float64) for x in (g, r))
        if len(rc):
            worst = max(worst, float((np.abs(gc - rc) / np.abs(rc)).max()))
    if conf_rtol is not None and worst > conf_rtol:
        raise RuntimeError(f"{name}: confidences differ by {worst:.3e} relative (limit {conf_rtol:.0e})")
    return worst


def lookahead_phase(model: str, flat, clips, card: str, windows=LOOKAHEAD_WINDOWS, extras: bool = False) -> dict:
    """The greedy decode loops of one model on one encoder output (the
    default encoder, K1, on the card): the step loop and impl="lookahead"
    at each window, on the blank bias that gives ~3.5 tokens per audio
    second (blank_bias_offset, found with the step loop on the card and
    reused for every impl). With `extras` (tdt-ctc-110m) also a boosted
    batch and the unbiased (dense) batch at window 8, and the step loop at
    unroll 4. Every card decode's tokens and frames equal the card's step
    loop (confidences within LOOKAHEAD_CONF_RTOL) and the CPU port's step
    loop on the same encoder output and weights. Each: iterations, decode
    wall (median of 5 warm synchronised calls, every impl of a batch timed
    in turns, then again in reverse order, the lesser median kept), device
    busy share (the device time of one more call under the profiler over
    that wall), tokens per audio second."""
    import torch

    from parakeet_tpu_torch.audio.frontend import preprocess_audio_batch
    from parakeet_tpu_torch.decode.phrase_boost import ContextTrie
    from parakeet_tpu_torch.decode.transducer import transducer_greedy_decode
    from parakeet_tpu_torch.models.encoder import encoded_lengths
    from parakeet_tpu_torch.transcribe import DEFAULT_BOOST_SCORE

    gpu = facade(model, "cuda", params=flat)
    cfg = gpu.config
    layers = cfg.encoder.num_layers
    feats, n_frames = preprocess_audio_batch(clips, gpu._audio_cfg, "cpu")
    enc_lens = encoded_lengths(torch.as_tensor(n_frames)).tolist()
    audio_s = sum(len(c) for c in clips) / 16000.0
    reset_counts()
    with torch.inference_mode():
        enc = gpu.encode(feats.to(gpu.device), n_frames)
    torch.cuda.synchronize()
    launches = read_counts()
    if {k: v for k, v in launches.items() if v} != {"rel_attention_block": layers}:
        raise RuntimeError(f"lookahead {model}: encoder launches {launches}, want K1 {layers} and nothing else")
    if not torch.isfinite(enc).all():
        raise RuntimeError(f"lookahead {model}: encoder output on the card is not finite")
    enc_cpu = enc.cpu()
    blank = gpu._blank_id
    kw = dict(pred_hidden=cfg.prediction.pred_hidden, num_lstm_layers=cfg.prediction.num_lstm_layers,
              durations=gpu._durations(), blank_id=blank, is_tdt=gpu.is_tdt, joint_prefix=gpu.joint_prefix,
              enc_lengths=enc_lens)
    key = f"{gpu.joint_prefix}.{'label_proj_' if gpu.is_tdt else 'out_proj_'}.bias"
    decoder_keys = [k for k in gpu.params if k.startswith(("prediction_", gpu.joint_prefix))]

    def run(params, e, **impl):
        with torch.inference_mode():
            return transducer_greedy_decode(params, e, **kw, **impl)

    t0 = time.perf_counter()
    offset, tried = blank_bias_offset(lambda p: sum(len(t) for t in run(p, enc).tokens), gpu.params, key, blank,
                                      audio_s)
    log(f"== lookahead {model}: {len(clips)} clips ({audio_s:.2f} s, T' up to {max(enc_lens)}), blank bias offset "
        f"{offset:.4f} on {key}[{blank}] (10 halvings of [0, 30], {time.perf_counter() - t0:.1f} s): "
        f"{tried[offset]} tokens, {tried[offset] / audio_s:.2f} per audio s (target {LOOKAHEAD_TOKENS_PER_S}); "
        f"tried {', '.join(f'{m:.4f}: {n}' for m, n in tried.items())}; encoder K1 "
        f"{launches['rel_attention_block']} launches, no other kernel")

    batches = {"biased": (with_blank_bias(gpu.params, key, blank, offset), None,
                          [dict(impl="lookahead", window=w) for w in windows])}
    if extras:
        step_toks = run(batches["biased"][0], enc).tokens
        trie = ContextTrie()
        phrases = sorted({tuple(toks[:2]) for toks in step_toks[:4] if len(toks) >= 2})  # from the biased decodes
        for ids in phrases:
            trie.insert(ids)
        boost = trie.device_boost(cfg.joint.vocab_size, len(clips), DEFAULT_BOOST_SCORE, gpu.device)
        batches["boosted"] = (batches["biased"][0], boost, [dict(impl="lookahead", window=8)])
        batches["dense"] = (gpu.params, None, [dict(impl="lookahead", window=8)])
        batches["biased"][2].append(dict(unroll=4))
    out = {"offset": offset, "tokens_per_s": tried[offset] / audio_s, "launches": launches, "cases": {}}
    for batch, (params, boost, variants) in batches.items():
        cpu_boost = None if boost is None else (boost[0].cpu(), boost[1].cpu(), boost[2])
        cpu_ref = run({k: params[k].cpu() for k in decoder_keys}, enc_cpu, boost=cpu_boost)
        impls = {", ".join(f"{k} {v}" for k, v in impl.items()) or "step": impl for impl in [{}] + variants}
        calls = {label: (lambda impl=impl: run(params, enc, boost=boost, **impl)) for label, impl in impls.items()}
        results = {label: call() for label, call in calls.items()}
        step = results["step"]
        walls = {}
        for label in [*calls, *reversed(calls)]:
            walls[label] = min(walls.get(label, float("inf")), wall_ms(calls[label], 5))
        for label, res in results.items():
            name = f"lookahead {model} {batch} {label}"
            conf = same_decode(f"{name} vs step on the card", res, step, LOOKAHEAD_CONF_RTOL)
            cpu_conf = same_decode(f"{name} vs the CPU's step loop", res, cpu_ref, None)
            if boost is not None and not torch.equal(res.boost_active.cpu(), cpu_ref.boost_active):
                raise RuntimeError(f"{name}: trie states differ from the CPU's")
            wall, dev = walls[label], device_ms(calls[label], calls=1, profiles=1)
            n = sum(len(t) for t in res.tokens)
            out["cases"][f"{batch} {label}"] = dict(steps=res.steps, wall_ms=wall, dev_ms=dev, busy=dev / wall,
                                                    tokens_per_s=n / audio_s)
            log(f"  {batch} {label}: {res.steps} iterations, decode wall {wall:.3f} ms (median of 5, best of 2 "
                f"turns), device {dev:.3f} ms, busy {dev / wall:.1%}, {n} tokens ({n / audio_s:.2f} per audio s); "
                f"tokens and frames = step on the card (confidences within {conf:.1e}) = the CPU's step loop "
                f"(within {cpu_conf:.1e}) [{card}]")
        if boost is not None:
            plain = run(params, enc).tokens
            log(f"  boosted: phrases {phrases} at score {DEFAULT_BOOST_SCORE}, tokens changed in "
                f"{sum(a != b for a, b in zip(step.tokens, plain))}/{len(clips)} items against the unboosted decode")
    base = out["cases"]["biased step"]
    log(f"  lookahead {model} against step on the biased batch ({out['tokens_per_s']:.2f} tokens per audio s), "
        "iterations and decode wall: " + ", ".join(f"window {w} {c['steps'] / base['steps']:.3f}x, {c['wall_ms'] / base['wall_ms']:.3f}x"
                             for w in windows for c in [out["cases"][f"biased impl lookahead, window {w}"]])
        + f" [{card}]")
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


SERVE_STREAM_S = 3  # seconds of audio a /stream session


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
    pcm = [np.clip(c * 32768, -32768, 32767).astype(np.int16)
           for c in synthetic_clips(4, seed=2300, min_s=SERVE_STREAM_S, max_s=SERVE_STREAM_S)]
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
    log(f"  HTTP /stream: 4 chunked sessions at once ({SERVE_STREAM_S} s of int16 each in 160 ms chunks), eou-120m "
        f"B=8 fused "
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
pcm = (0.2 * np.random.RandomState(0).randn(int(sys.argv[2]) * 44100, 2) * 32767).astype("<i2")
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


RESAMPLE_PROBE_S = 20  # seconds of 44.1 kHz stereo the resampler probe reads


def serve_resampler() -> dict:
    """read_audio of a synthetic 20 s 44.1 kHz stereo WAV in a fresh
    process, native and with PARAKEET_NO_NATIVE (the chunked numpy form):
    host seconds, the growth of the resident set (sampled each ms from
    /proc/self/statm, where the host has it) and tracemalloc's peak of a
    second call, outputs bit-identical."""
    import os

    out = {}
    for name, env in (("native", {}), ("numpy", {"PARAKEET_NO_NATIVE": "1"})):
        proc = subprocess.run([sys.executable, "-c", RESAMPLE_PROBE, str(ROOT), str(RESAMPLE_PROBE_S)],
                              capture_output=True, text=True,
                              timeout=300, env=dict(os.environ, **env))
        if proc.returncode != 0:
            raise RuntimeError(f"resampler probe ({name}) failed:\n{proc.stderr[-2000:]}")
        out[name] = json.loads(proc.stdout.strip().splitlines()[-1])
    if out["native"]["sha256"] != out["numpy"]["sha256"] or not out["native"]["native"] or out["numpy"]["native"]:
        raise RuntimeError(f"resampler: native and numpy outputs differ, or the wrong path ran: {out}")
    mb = lambda r: "not readable" if r["rss_mb"] is None else f"+{r['rss_mb']:.1f} MB"  # noqa: E731
    log(f"  read_audio {RESAMPLE_PROBE_S} s 44.1 kHz stereo WAV -> {out['native']['samples']} samples at 16 kHz, bit-identical; "
        f"native {out['native']['seconds']:.3f} s, peak RSS {mb(out['native'])} (sampled each ms), traced heap "
        f"peak {out['native']['heap_mb']:.1f} MB; chunked numpy {out['numpy']['seconds']:.3f} s, peak RSS "
        f"{mb(out['numpy'])}, traced heap peak {out['numpy']['heap_mb']:.1f} MB (host of the card, "
        f"{os.cpu_count()} CPUs, one process each)")
    return out


def native_extras_part() -> dict:
    """The native library's int16 conversion, preemphasis and FLAC decode
    (native.py over csrc/parakeet_native.cpp and csrc/flac_decoder.cpp,
    built on this host) against their numpy forms on 60 s of audio:
    int16 / 32768 exactly; preemphasis within one f32 ulp of x − coeff·prev
    computed in float64 and rounded once (the library rounds once, a fused
    multiply-add), its carry the last raw sample; the decode of a 16-bit
    stereo FLAC stream (tests/helpers/flac_writer.py) exactly its PCM /
    32768; bytes that are no FLAC raise ValueError."""
    import importlib.util

    from parakeet_tpu_torch import native

    # by path: a `tests` package installed on the machine would shadow the checkout's
    spec = importlib.util.spec_from_file_location("flac_writer", ROOT / "tests" / "helpers" / "flac_writer.py")
    flac_writer = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(flac_writer)
    encode_flac = flac_writer.encode_flac
    rng = np.random.RandomState(1600)
    pcm = rng.randint(-32768, 32768, 60 * 16000).astype(np.int16)
    out = {}
    t0 = time.perf_counter()
    x = native.int16_to_float(pcm)
    out["int16_ms"] = (time.perf_counter() - t0) * 1e3
    if x is None or not np.array_equal(x, pcm.astype(np.float32) / np.float32(32768)):
        raise RuntimeError("native int16_to_float: not pcm / 32768")
    coeff, prev = np.float32(0.97), np.float32(0.25)
    t0 = time.perf_counter()
    y, last = native.preemphasis(x, float(coeff), float(prev))
    out["preemphasis_ms"] = (time.perf_counter() - t0) * 1e3
    want = (x.astype(np.float64) - np.float64(coeff) * np.concatenate([[prev], x[:-1]]).astype(np.float64))
    want = want.astype(np.float32)
    ulps = np.abs(y.astype(np.float64) - want) / np.spacing(np.abs(want))
    out["preemphasis_max_ulp"] = float(ulps.max())
    out["preemphasis_exact"] = float(np.mean(y == want))
    if ulps.max() > 1.0 or last != float(x[-1]):
        raise RuntimeError(f"native preemphasis: {ulps.max()} ulp from its numpy form, carry {last} vs {x[-1]}")
    stereo = pcm[: 2 * 2 * 16000].astype(np.int64).reshape(-1, 2)
    data = encode_flac(stereo, 16000, block_size=4096, subframe_mode="fixed2")
    t0 = time.perf_counter()
    dec = native.flac_decode(data)
    out["flac_ms"] = (time.perf_counter() - t0) * 1e3
    if dec is None or dec[1:] != (16000, 2) or not np.array_equal(dec[0], stereo.reshape(-1) / np.float32(32768)):
        raise RuntimeError("native flac_decode: not the stream's PCM / 32768")
    try:
        native.flac_decode(b"fLaC" + bytes(64))
    except ValueError as err:
        if "FLAC decode failed" not in str(err):
            raise
    else:
        raise RuntimeError("native flac_decode: no ValueError on bytes that are no FLAC")
    log(f"  native extras against their numpy forms: int16_to_float of 60 s exact ({out['int16_ms']:.2f} ms), "
        f"preemphasis within {out['preemphasis_max_ulp']:.2f} ulp ({out['preemphasis_exact']:.2%} exact, "
        f"{out['preemphasis_ms']:.2f} ms), flac_decode of 2 s stereo exact ({out['flac_ms']:.2f} ms), garbage "
        f"raises ValueError (host of the card)")
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
    out["native_extras"] = native_extras_part()
    return out


# ─── phase train: the trainers on the card ──────────────────────────────────

TRAIN_DIR = ROOT / "build" / "parakeet_tpu_torch" / "train_smoke"
GRAD_SCALE_FRAC = 1e-3  # each key's gradient, card vs CPU, within 1e-3 of that key's max |g|
GRAD_ZERO_FRAC = 1e-6  # a key whose CPU max |g| is below 1e-6 of the largest key's is zero up to
#   rounding (each attention's k_proj bias: softmax ignores a shift common to all keys), its
#   values f32 rounding of sums whose terms are of the model's gradient scale; such keys are
#   left out of the per-key check and named
K1_GRAD_F32_FRAC = 1e-4  # K1's Function vs plain autograd, each input gradient, f32
LOSS_RTOL = 1e-4  # the hybrid loss, card vs CPU


def sync() -> None:
    import torch

    if torch.cuda.is_available():
        torch.cuda.synchronize()


def train_corpus(root: Path, n: int, seed: int, min_s: float, max_s: float, rttm: bool = False) -> Path:
    """n voiced WAVs under root and a JSONL manifest: transcripts of random
    smoke-vocabulary words (2 a second, so every label sequence fits its
    12.5 encoder frames a second), or with rttm, per-clip RTTMs of 2-4
    speakers in turns."""
    from parakeet_tpu_torch.audio.io import write_wav

    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed + 1)
    lines = []
    for i, clip in enumerate(synthetic_clips(n, seed, min_s=min_s, max_s=max_s)):
        wav = root / f"clip{i}.wav"
        write_wav(wav, clip)
        dur = len(clip) / 16000
        entry = {"audio_filepath": wav.name, "duration": dur}
        if rttm:
            spk, t0, rows = rng.randint(2, 5), 0.0, []
            while t0 < dur - 0.5:
                seg = min(rng.uniform(0.8, 3.0), dur - t0)
                rows.append(f"SPEAKER clip{i} 1 {t0:.2f} {seg:.2f} <NA> <NA> s{rng.randint(spk)} <NA> <NA>")
                t0 += seg + rng.uniform(0.0, 0.4)
            (root / f"clip{i}.rttm").write_text("\n".join(rows) + "\n")
            entry["rttm_filepath"] = f"clip{i}.rttm"
        else:
            entry["text"] = " ".join(f"w{rng.randint(0, 1024)}" for _ in range(max(1, int(dur * 2))))
        lines.append(json.dumps(entry))
    manifest = root / "manifest.jsonl"
    manifest.write_text("\n".join(lines) + "\n")
    return manifest


def run_cli(main, argv: list[str]) -> str:
    """Run a train CLI's main in this process; its stderr, echoed."""
    import contextlib
    import io

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = main(argv)
    text = err.getvalue()
    for line in text.splitlines():
        log(f"    {line}")
    if rc != 0:
        raise RuntimeError(f"train CLI exited {rc}")
    return text


def cli_losses(text: str) -> dict[int, float]:
    """{step: loss} from the loop's `step k/n  loss x` lines."""
    out = {}
    for line in text.splitlines():
        if line.startswith("step "):
            parts = line.split()
            out[int(parts[1].split("/")[0])] = float(parts[3])
    return out


def launches_only(name: str, counts: dict, want: dict) -> None:
    """Every kernel's launch count in a run is `want`'s (0 where absent)."""
    got = {k: v for k, v in counts.items() if v}
    if got != {k: v for k, v in want.items() if v}:
        raise RuntimeError(f"{name}: kernel launches {got}, want {want}")


def card_params(spec: dict, seed: int) -> dict:
    """A spec's random weights drawn on the card from a seeded generator
    (the numpy draw of 600M weights takes tens of seconds on the host); the
    init_params kinds and scales."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = {}
    for key in sorted(spec):
        shape, kind = spec[key]
        if kind == "w":
            fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else shape[0]
            t = torch.randn(shape, generator=gen, device="cuda") / np.sqrt(max(fan_in, 1))
        elif kind in ("emb", "bias_param"):
            t = 0.02 * torch.randn(shape, generator=gen, device="cuda")
        elif kind in ("b", "norm_b", "bn_mean"):
            t = torch.zeros(shape, device="cuda")
        else:
            t = torch.ones(shape, device="cuda")
        out[key] = t
    return out


def step_metrics(name: str, step, state, batch, layers: int, card: str) -> dict:
    """Median synchronised wall of 5 steps, the device busy share
    (profiled device time of 2 steps over that wall), peak memory of one
    step, each kernel's launches a step (counted over the 5 steps: K1 once
    a layer, no other kernel)."""
    import torch

    step(state.params, state.opt_state, batch)
    sync()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        _, _, loss = step(state.params, state.opt_state, batch)
        float(loss)
        walls.append((time.perf_counter() - t0) * 1e3)
    counts = read_counts()
    launches_only(name, counts, {"rel_attention_block": layers * 5})
    per_step = {k: v // 5 for k, v in counts.items()}
    k1 = per_step["rel_attention_block"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    wall = float(np.median(walls))
    kernels = profile_device(lambda: step(state.params, state.opt_state, batch), 2, host_ops=False)
    dev = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:6]
    log(f"  {name}: device ms a step by kernel, the top 6: " + "; ".join(f"{k[:60]} {v:.2f}" for k, v in top))
    audio_s = float(batch["mel_lengths"].sum()) * 0.01  # 10 ms mel hop
    out = {"step_ms": wall, "step_ms_all": walls, "device_ms": dev, "busy": dev / wall, "peak_gb": peak,
           "launches": per_step, "audio_s_per_s": audio_s / (wall / 1e3)}
    log(f"  {name}: step wall median {wall:.1f} ms of 5 ({', '.join(f'{w:.1f}' for w in walls)}), "
        f"{audio_s:.2f} s of audio a step, {out['audio_s_per_s']:.1f} audio s per wall s; device {dev:.1f} ms a "
        f"step, busy {out['busy']:.1%}, peak memory {peak:.3f} GB, K1 {k1} a step [{card}]")
    return out


def loss_share(cfg, state, batch, step_ms: float, card: str) -> dict:
    """Wall of the TDT lattice loss's forward and backward alone on the
    step's lattice (median of 5, synchronised), and its share of the step."""
    import torch

    from parakeet_tpu_torch import train as T
    from parakeet_tpu_torch.ops.transducer_loss import tdt_loss

    with torch.no_grad():
        (lab, dur), enc_lens = T.transducer_forward(state.params, cfg, batch["features"], batch["mel_lengths"],
                                                    batch["labels"], loss="tdt")
    lab, dur = lab.detach().requires_grad_(), dur.detach().requires_grad_()

    def fwd_bwd():
        per = tdt_loss(lab, dur, batch["labels"], enc_lens, batch["label_lengths"], cfg.joint.vocab_size - 1,
                       tuple(cfg.durations), sigma=0.05)
        per.mean().backward()

    fwd_bwd()
    walls = []
    for _ in range(5):
        sync()
        t0 = time.perf_counter()
        fwd_bwd()
        sync()
        walls.append((time.perf_counter() - t0) * 1e3)
    ms = float(np.median(walls))
    u1 = lab.shape[2]
    log(f"  TDT lattice loss forward + backward on the step's lattice {tuple(lab.shape)} ({lab.shape[1] + u1 - 1} "
        f"diagonals): {ms:.1f} ms median of 5, {ms / step_ms:.1%} of the {step_ms:.1f} ms step [{card}]")
    return {"loss_ms": ms, "share": ms / step_ms, "lattice": list(lab.shape)}


def k1_backward_cost(b: int, t: int, step_ms: float, layers: int, card: str) -> dict:
    """Wall of K1's backward (the plain version's recompute and autograd) at
    a step's shape, 110m widths: the Function's forward + backward less its
    forward alone (median of 5 each, synchronised), times the layers, and
    its share of the step."""
    import torch

    from parakeet_tpu_torch.ops import rel_attention as RA

    rng = np.random.RandomState(31)
    dev = _dev(rng, torch.float32)
    args = [a.requires_grad_() for a in _attention_args(rng, dev, b, t, D, H)]
    norm = [dev(1 + rng.normal(0, 0.1, D)).requires_grad_(), dev(rng.normal(0, 0.1, D)).requires_grad_()]
    lengths = torch.full((b,), t, dtype=torch.int32, device="cuda")
    g = torch.randn(b, t, D, device="cuda")

    def fwd():
        return RA.RelAttentionBlockFunction.apply(*args, lengths, *norm, 1e-5)

    def both():
        torch.autograd.grad(fwd(), [*args, *norm], g)

    def wall(fn):
        fn()
        times = []
        for _ in range(5):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    fwd_ms, both_ms = wall(fwd), wall(both)
    bwd = max(both_ms - fwd_ms, 0.0) * layers
    log(f"  K1 backward (plain recompute + autograd) at B={b} T'={t} D={D}: {both_ms - fwd_ms:.2f} ms a layer "
        f"(forward {fwd_ms:.2f}), x{layers} = {bwd:.1f} ms, {bwd / step_ms:.1%} of the {step_ms:.1f} ms step [{card}]")
    return {"ms_per_layer": both_ms - fwd_ms, "share": bwd / step_ms}


def train_cli_part(card: str) -> dict:
    """(a) tdt-ctc-110m hybrid through train_cli.main: 3 steps and a
    checkpoint, --resume to 6 and --export; the export transcribes a clip
    on the card, tokens equal to a CPU Transcriber's on the same file. Then
    the step's metrics on each of the loader's two buckets (the shortest
    clips and the longest), and a bf16 step."""
    import shutil

    import torch

    from parakeet_tpu_torch import train_cli
    from parakeet_tpu_torch.config import AudioConfig, make_110m_config
    from parakeet_tpu_torch.data import ManifestDataset, TrainDataLoader
    from parakeet_tpu_torch.models.encoder import encoded_lengths, subsample_length
    from parakeet_tpu_torch.text.tokenizer import Tokenizer
    from parakeet_tpu_torch.train import make_sharded_trainer
    from parakeet_tpu_torch.transcribe import Transcriber

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    work = TRAIN_DIR / "asr"
    manifest = train_corpus(work, 16, seed=2024, min_s=2.0, max_s=12.0)
    vocab = smoke_vocab(1025)
    ck, export = work / "ck", work / "export.safetensors"
    base = ["--manifest", str(manifest), "--vocab", str(vocab), "--model", "110m", "--batch-size", "8",
            "--checkpoint-dir", str(ck), "--log-every", "1"]
    log("== (a) tdt-ctc-110m hybrid (sigma 0.05) through train_cli: 16 clips of 2-12 s, batch 8, steps 1-3 "
        "with a checkpoint, then --resume to step 6 and --export")
    reset_counts()
    first = run_cli(train_cli.main, base + ["--steps", "3"])
    launches_only("train_cli steps 1-3", read_counts(), {"rel_attention_block": 17 * 3})
    reset_counts()
    second = run_cli(train_cli.main, base + ["--steps", "6", "--resume", "--export", str(export)])
    main_counts = read_counts()
    launches_only("train_cli steps 4-6", main_counts, {"rel_attention_block": 17 * 3})
    l1, l2 = cli_losses(first), cli_losses(second)
    if sorted(l1) != [1, 2, 3] or sorted(l2) != [4, 5, 6] or "# resumed at step 3" not in second:
        raise RuntimeError(f"train_cli: steps {sorted(l1)} then {sorted(l2)}; the resumed run must go on from 3")
    losses = {**l1, **l2}
    if not all(np.isfinite(v) for v in losses.values()):
        raise RuntimeError(f"train_cli: losses {losses}")
    log(f"  losses by step: {losses}; K1 launches 17 a step, no other kernel")

    from parakeet_tpu_torch.audio.frontend import preprocess_audio

    clip = synthetic_clips(1, seed=2024, min_s=2.0, max_s=12.0)[0]
    facades = {dev: Transcriber(str(export), str(vocab), device=dev) for dev in ("cuda", "cpu")}
    got, want = (facades[dev].transcribe(clip).token_ids for dev in ("cuda", "cpu"))
    with torch.inference_mode():
        feats = {dev: preprocess_audio(clip, device=dev) for dev in facades}
        enc = {dev: tr.encode(feats[dev], [feats[dev].shape[1]]).cpu() for dev, tr in facades.items()}
    enc_diff = float((enc["cuda"] - enc["cpu"]).abs().max())
    enc_scale = float(enc["cpu"].abs().max())
    if got != want or enc_diff > ENC_SCALE_FRAC * enc_scale:
        raise RuntimeError(f"exported weights: card tokens {got[:20]} vs CPU {want[:20]}, encoder max |diff| "
                           f"{enc_diff:.3e} of scale {enc_scale:.3f}")
    log(f"  export loads in Transcriber on the card: {len(got)} tokens on clip 0 ({len(clip) / 16000:.2f} s), "
        f"equal to the CPU's; encoder max |diff| {enc_diff:.3e} of scale {enc_scale:.3f}")

    cfg = make_110m_config()
    loader = TrainDataLoader(ManifestDataset(manifest), Tokenizer(vocab), batch_size=8,
                             audio_config=AudioConfig(n_mels=cfg.encoder.mel_bins), shuffle=False, device="cuda")
    # the loader's two buckets in order, the 8 shortest clips and the 8
    # longest: the two batches the CLI run above trains on
    batches = iter(loader)
    buckets = {"shortest": next(batches), "longest": next(batches)}
    del batches
    flat = model_params("tdt-ctc-110m")
    _, state, step, _ = make_sharded_trainer(cfg, flat, loss="hybrid", sigma=0.05, learning_rate=1e-4,
                                             device="cuda")
    out = {"losses": losses, "launches": main_counts, "metrics": {}, "k1_shapes": []}
    layers = cfg.encoder.num_layers
    for bucket, batch in buckets.items():
        t = subsample_length(int(batch["features"].shape[1]))
        lengths = torch.clamp(encoded_lengths(batch["mel_lengths"]), max=t).cpu().numpy()
        log(f"  metrics batch, the {bucket} bucket: features {tuple(batch['features'].shape)}, labels "
            f"{tuple(batch['labels'].shape)}, T'={t}, encoded lengths {lengths.min()}-{lengths.max()}")
        m = step_metrics(f"110m hybrid step, B=8, {bucket} bucket", step, state, batch, layers, card)
        m["loss"] = loss_share(cfg, state, batch, m["step_ms"], card)
        m["k1_backward"] = k1_backward_cost(8, t, m["step_ms"], layers, card)
        out["metrics"][bucket] = m
        out["k1_shapes"].append((8, t, D, H, lengths, f"tdt-ctc-110m step, {bucket} bucket"))
    batch = buckets["shortest"]
    del state, step, buckets
    torch.cuda.empty_cache()

    # bf16: the model cast inside the differentiated loss, K1 the only kernel seeing grad-requiring bf16
    first = {}
    for dtype in ("float32", "bfloat16"):
        _, state, step, _ = make_sharded_trainer(cfg, flat, loss="hybrid", sigma=0.05, learning_rate=1e-4,
                                                 compute_dtype=dtype, device="cuda")
        reset_counts()
        first[dtype] = float(step(state.params, state.opt_state, batch)[2])
        launches_only(f"{dtype} step", read_counts(), {"rel_attention_block": 17})
        del state, step
    rel = abs(first["bfloat16"] - first["float32"]) / abs(first["float32"])
    log(f"  bf16 step (model in bf16, f32 masters): loss {first['bfloat16']:.4f} against f32's "
        f"{first['float32']:.4f}, {rel:.2%} apart (limit {BF16_SCALE_FRAC:.0%}); K1 17, no other kernel")
    if not np.isfinite(first["bfloat16"]) or rel > BF16_SCALE_FRAC:
        raise RuntimeError("bf16 train step: loss not finite or not within 2% of f32")
    out["bf16_rel"] = rel
    torch.cuda.empty_cache()

    out["batch"], out["flat"] = batch, flat
    return out


def overfit_part(cfg, flat, batch) -> list[float]:
    """(d) ten steps at lr 1e-3 (a linear warmup over the first 3) on one
    batch: the loss must end below the first. Without the warmup the random
    110m falls for 9 steps and jumps at the 10th, on the card and on the
    CPU alike (PERF.md §6)."""
    import torch

    from parakeet_tpu_torch.train import make_sharded_trainer

    log("== (d) fixed-batch overfit: 10 steps at lr 1e-3 (3 steps of warmup) on 110m, one batch")
    _, state, step, _ = make_sharded_trainer(cfg, flat, loss="hybrid", sigma=0.05, learning_rate=1e-3,
                                             warmup_steps=3, device="cuda")
    fit = [float(step(state.params, state.opt_state, batch)[2]) for _ in range(10)]
    log(f"  losses: {', '.join(f'{v:.4f}' for v in fit)}")
    if not (np.isfinite(fit).all() and fit[-1] < fit[0]):
        raise RuntimeError(f"overfit: the loss did not fall ({fit[0]} -> {fit[-1]})")
    del state, step
    torch.cuda.empty_cache()
    return fit


def train_parity_part(card: str) -> dict:
    """(b) one hybrid loss and its gradients at full 110m width on a fixed
    B=2 batch of 3 s clips, card against CPU."""
    import torch

    from parakeet_tpu_torch.audio.frontend import preprocess_audio_batch
    from parakeet_tpu_torch.config import AudioConfig, make_110m_config
    from parakeet_tpu_torch.train import hybrid_loss_fn, value_and_grad_accum

    cfg = make_110m_config()
    flat = model_params("tdt-ctc-110m")
    feats, n_frames = preprocess_audio_batch(synthetic_clips(2, seed=77, min_s=3.0, max_s=3.0), AudioConfig(), "cpu")
    rng = np.random.RandomState(77)
    batch = {"features": feats, "mel_lengths": torch.tensor(n_frames, dtype=torch.int32),
             "labels": torch.from_numpy(rng.randint(0, 1024, (2, 6)).astype(np.int32)),
             "label_lengths": torch.tensor([6, 4], dtype=torch.int32)}
    vag = value_and_grad_accum(lambda p, b: hybrid_loss_fn(p, cfg, b, sigma=0.05))
    res = {}
    for dev in ("cpu", "cuda"):
        t0 = time.perf_counter()
        loss, grads = vag({k: torch.from_numpy(v).to(dev) for k, v in flat.items()},
                          {k: v.to(dev) for k, v in batch.items()})
        res[dev] = (float(loss), {k: g.cpu() for k, g in grads.items()})
        log(f"  hybrid loss and gradient on {dev}: {res[dev][0]:.6f} ({time.perf_counter() - t0:.1f} s)")
    rel = abs(res["cuda"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    scales = {k: float(g.abs().max()) for k, g in res["cpu"][1].items()}
    zero = GRAD_ZERO_FRAC * max(scales.values())
    left_out = sorted(k for k, s in scales.items() if s < zero)
    fracs = sorted(((float((res["cuda"][1][k] - res["cpu"][1][k]).abs().max()) / scales[k], k)
                    for k in scales if k not in left_out), reverse=True)
    worst = fracs[0][0]
    log(f"== (b) card vs CPU, 110m hybrid, B=2 3 s: loss rel diff {rel:.2e} (limit {LOSS_RTOL:g}); worst gradients "
        f"against the key's max |g|: " + ", ".join(f"{k} {f:.2e} (scale {scales[k]:.3e})" for f, k in fracs[:3])
        + f" (limit {GRAD_SCALE_FRAC:g}), {len(fracs)} keys")
    log(f"  left out as zero up to rounding (CPU max |g| below {zero:.3e}, {GRAD_ZERO_FRAC:g} of the largest key's): "
        + (", ".join(f"{k} (max |g| {scales[k]:.3e}, card - CPU "
                     f"{float((res['cuda'][1][k] - res['cpu'][1][k]).abs().max()):.3e})" for k in left_out)
           or "none"))
    if rel > LOSS_RTOL or worst > GRAD_SCALE_FRAC:
        raise RuntimeError("card vs CPU hybrid loss or gradient out of tolerance")
    return {"loss_rel": rel, "grad_frac": worst, "left_out": left_out}


def k1_backward_part(shapes, card: str, base: bool = True) -> dict:
    """(c) K1's autograd Function on the card, forward and backward: its
    output against rel_attention_block_reference on the valid rows (the
    kernels phase's tolerance), and its input gradients against autograd
    through the plain version on the same CUDA tensors, f32 and bf16. At
    B=8 T'=126 D=512 with mixed key lengths, with and without the fused
    LayerNorm + residual (with `base`), and at each shape the trainers give
    K1 (`shapes`: (B, T', D, heads, key lengths, what), with the LayerNorm
    + residual, as the encoder calls it); each trainer shape's f32 forward
    timed against the plain version, with its bound."""
    import torch

    from parakeet_tpu_torch.ops import rel_attention as RA

    cases = [(B, 126, D, H, None, "mixed lengths", with_norm) for with_norm in (False, True)] if base else []
    cases += [(*shape, True) for shape in shapes]
    out = {"max_abs_err": 0.0, "grads": {}, "times": {}, "work": {}}
    for i, (b, t, d, heads, lengths, what, with_norm) in enumerate(cases):
        for dtype, name in _dtypes():
            rng = np.random.RandomState(300 + i)
            dev = _dev(rng, dtype)
            args = [a.requires_grad_() for a in _attention_args(rng, dev, b, t, d, heads)]
            lens = _mixed_lengths(rng, t) if lengths is None else np.asarray(lengths)
            kv = torch.as_tensor(lens, dtype=torch.int32, device="cuda")
            norm = [None, None]
            if with_norm:
                norm = [dev(1 + rng.normal(0, 0.1, d), torch.float32).requires_grad_(),
                        dev(rng.normal(0, 0.1, d), torch.float32).requires_grad_()]
            inputs = [*args, *(n for n in norm if n is not None)]
            g = dev(rng.randn(b, t, d))
            shape = f"B={b} T'={t} D={d} hd={d // heads} ({what})"
            tag = f"(c) K1 Function {shape} {name} norm+residual={with_norm} lengths {lens.min()}-{lens.max()}"
            got_out = RA.RelAttentionBlockFunction.apply(*args, kv, *norm, 1e-5)
            want_out = RA.rel_attention_block_reference(*args, kv, *norm, 1e-5)
            err = check_close(f"{tag}, forward", got_out.detach(), want_out.detach(), _valid_rows(lens, t))
            if dtype == torch.float32:
                out["max_abs_err"] = max(out["max_abs_err"], err)
            got = torch.autograd.grad(got_out, inputs, g)
            want = torch.autograd.grad(want_out, inputs, g)
            worst = max(float((a.float() - w.float()).abs().max()) / max(float(w.float().abs().max()), 1e-30)
                        for a, w in zip(got, want))
            limit = K1_GRAD_F32_FRAC if dtype == torch.float32 else BF16_SCALE_FRAC
            log(f"  {tag}, backward: worst input gradient {worst:.2e} of its scale (limit {limit:g}), "
                f"{len(inputs)} inputs")
            if worst > limit:
                raise RuntimeError(f"K1 Function backward at {shape} {name} norm={with_norm} out of tolerance")
            out["grads"][f"{shape} {name} norm={with_norm}"] = worst
            if lengths is not None and dtype == torch.float32:
                plain = [a.detach() for a in args]
                kw = dict(lengths=kv, norm_w=norm[0].detach(), norm_b=norm[1].detach())
                out["times"][shape] = time_pair(tag, lambda: RA.rel_attention_block(*plain, **kw),
                                                lambda: RA.rel_attention_block_reference(*plain, **kw), card)
                out["work"][shape] = (attention_flops(b, t, d, heads, lens),
                                      tensor_bytes(*plain, *kw.values(), got_out) + (2 * t - 1) * d * 4)
    return out


def big_schema_part(card: str) -> dict:
    """(e) tdt-600m (loss tdt, remat) 2 steps at B=4 and rnnt-600m 1 step
    at B=2, full width, weights drawn on the card, synthetic 10 s batches."""
    import torch

    from parakeet_tpu_torch import config as C
    from parakeet_tpu_torch import params as P
    from parakeet_tpu_torch.models.encoder import encoded_lengths, subsample_length
    from parakeet_tpu_torch.train import make_sharded_trainer, synthetic_batch

    out = {}
    for model, loss, b, steps, remat in (("tdt-600m", "tdt", 4, 2, True), ("rnnt-600m", "rnnt", 2, 1, False)):
        cfg = getattr(C, MODELS[model][1])()
        spec = (P.tdt_spec if loss == "tdt" else P.rnnt_spec)(cfg)
        t0 = time.perf_counter()
        _, state, step, place = make_sharded_trainer(cfg, card_params(spec, seed=0), loss=loss, sigma=0.05,
                                                     remat=remat, learning_rate=1e-4, device="cuda")
        batch = place(synthetic_batch(cfg, b, mel_frames=1000, max_labels=40, seed=5))
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        losses = [float(step(state.params, state.opt_state, batch)[2]) for _ in range(steps)]
        counts = read_counts()
        layers = cfg.encoder.num_layers
        launches_only(f"{model} {loss}", counts, {"rel_attention_block": layers * (2 if remat else 1) * steps})
        if not np.isfinite(losses).all():
            raise RuntimeError(f"{model}: losses {losses}")
        peak = torch.cuda.max_memory_allocated() / 1e9
        per_step = {k: v // steps for k, v in counts.items()}
        t = subsample_length(int(batch["features"].shape[1]))
        lengths = torch.clamp(encoded_lengths(batch["mel_lengths"]), max=t).cpu().numpy()
        log(f"== (e) {model} loss={loss} remat={remat} B={b} T'={t} U=40: losses {losses}, K1 "
            f"{per_step['rel_attention_block']} a step, peak memory {peak:.2f} GB, {time.perf_counter() - t0:.1f} s "
            f"[{card}]")
        out[model] = {"losses": losses, "launches": per_step, "peak_gb": peak,
                      "k1_shape": (b, t, cfg.encoder.hidden_size, cfg.encoder.num_heads, lengths, f"{model} step")}
        del state, step
        torch.cuda.empty_cache()
    return out


def diar_cli_part(card: str) -> dict:
    """(f) Sortformer-117m through train_diar_cli.main: 2 steps at B=4 on
    10 s clips with synthetic RTTMs; the shape its encoder gives K1, from
    a batch of the CLI's loader."""
    import torch

    from parakeet_tpu_torch import train_diar_cli
    from parakeet_tpu_torch.config import AudioConfig
    from parakeet_tpu_torch.data import DiarizationDataLoader, DiarizationDataset
    from parakeet_tpu_torch.models.encoder import encoded_lengths, subsample_length

    manifest = train_corpus(TRAIN_DIR / "diar", 4, seed=99, min_s=10.0, max_s=10.0, rttm=True)
    argv = ["--manifest", str(manifest), "--batch-size", "4", "--steps", "2", "--log-every", "1",
            "--export", str(TRAIN_DIR / "diar" / "sf.safetensors")]
    log("== (f) Sortformer-117m through train_diar_cli: 4 clips of 10 s, B=4, 2 steps")
    reset_counts()
    text = run_cli(train_diar_cli.main, argv)
    counts = read_counts()
    args = train_diar_cli.build_argparser().parse_args(argv)
    cfg = train_diar_cli._preset(args.model)
    enc = cfg.nest_encoder
    launches_only("train_diar_cli", counts, {"rel_attention_block": enc.num_layers * 2})
    losses = cli_losses(text)
    if sorted(losses) != [1, 2] or not all(np.isfinite(v) for v in losses.values()):
        raise RuntimeError(f"train_diar_cli: losses {losses}")
    loader = DiarizationDataLoader(DiarizationDataset(str(manifest)), batch_size=args.batch_size,
                                   audio_config=AudioConfig(n_mels=enc.mel_bins, normalize=False),
                                   max_speakers=cfg.max_speakers, frame_multiple=args.frame_multiple,
                                   seed=args.seed, device="cuda")
    batch = next(iter(loader))
    t = subsample_length(int(batch["features"].shape[1]))
    lengths = torch.clamp(encoded_lengths(batch["mel_lengths"]), max=t).cpu().numpy()
    log(f"  the CLI's batch: features {tuple(batch['features'].shape)}, T'={t}, encoded lengths "
        f"{lengths.min()}-{lengths.max()}; K1 {counts['rel_attention_block'] // 2} a step")
    return {"losses": losses, "launches": {k: v // 2 for k, v in counts.items()},
            "k1_shape": (args.batch_size, t, enc.hidden_size, enc.num_heads, lengths, "sortformer-117m step")}


def guard_part() -> None:
    """(g) K6 under grad mode on an input that requires grad raises before
    it launches."""
    import torch

    from parakeet_tpu_torch.ops.feed_forward import fused_feed_forward

    rng = np.random.RandomState(8)
    dev = _dev(rng, torch.float32)
    x = dev(rng.randn(2, 64, D)).requires_grad_()
    before = read_counts()["fused_feed_forward"]
    try:
        fused_feed_forward(x, *_ffn_weights(rng, dev))
    except RuntimeError as exc:
        if "no backward" not in str(exc):
            raise
        log(f"== (g) K6 under grad with an input that requires grad: raised ({exc})")
    else:
        raise RuntimeError("K6 ran on an input that requires grad")
    if read_counts()["fused_feed_forward"] != before:
        raise RuntimeError("K6 launched on an input that requires grad")


def train_phase(card: str) -> dict:
    """Phase train: (a) and (d), (b), (c), (e), (f), (g); f32, IEEE."""
    from parakeet_tpu_torch.ops.layers import require_ieee_f32

    require_ieee_f32()
    from parakeet_tpu_torch.config import make_110m_config

    out = {"cli": train_cli_part(card), "parity": train_parity_part(card), "schemas": big_schema_part(card),
           "diar": diar_cli_part(card)}
    shapes = [*out["cli"]["k1_shapes"], *(out["schemas"][m]["k1_shape"] for m in ("tdt-600m", "rnnt-600m")),
              out["diar"]["k1_shape"]]
    out["k1_backward"] = k1_backward_part(shapes, card)
    guard_part()
    out["overfit"] = overfit_part(make_110m_config(), out["cli"].pop("flat"), out["cli"].pop("batch"))
    # each kernel's launches a step of each trainer, as counted in its run
    out["launches_train"] = {"tdt-ctc-110m hybrid step": out["cli"]["metrics"]["shortest"]["launches"],
                             "tdt-600m tdt step, remat": out["schemas"]["tdt-600m"]["launches"],
                             "rnnt-600m rnnt step": out["schemas"]["rnnt-600m"]["launches"],
                             "sortformer-117m step": out["diar"]["launches"]}
    return out


# ── mesh: inference over torch.distributed on the one card ──

MESH_STREAM_S = 4.0  # seconds of audio a slot in (iv)


def heads_flops(b: int, t: int, d: int, local: int, hd: int, key_lens) -> float:
    """K1 head-sharded, one rank's work: QKV 2·M·D·3DL, position
    2·(2T−1)·D·DL, out 2·M·DL·D (DL = local·hd) and the core of its heads."""
    m, dl = b * t, local * hd
    return 2 * m * d * 3 * dl + 2 * (2 * t - 1) * d * dl + core_flops(t, hd, local, key_lens) + 2 * m * dl * d


def k1_heads_part(card: str, shapes, base: bool = True) -> dict:
    """K1's head-sharded mode against its plain version on the same CUDA
    tensors, one 'model' rank's 4 heads of an 8-head layer with the fused
    LayerNorm: with `base`, B=8, T'=126, mixed lengths, at D=512 (hd 64)
    and D=1024 (hd 128), and B=1, T'=300 at D=1024 (the core's keys split
    in clusters); and at each of `shapes`, (B, T', key lengths,
    what) of a mesh run's launches (D=512). Each f32 by check_close and
    timed with its bound, each bf16 checked; and each through
    RelAttentionBlockHeadsFunction under grad (one launch counted), its
    output against the plain version's and its input gradients against
    autograd through the plain version."""
    import torch

    from parakeet_tpu_torch.ops import rel_attention as RA

    out = {"max_abs_err": 0.0, "times": {}, "work": {}, "bf16_times": {}, "bf16_work": {}, "grads": {}}
    local = 4
    cases = [(B, 126, D, None, D, 90 + D), (B, 126, 1024, None, "D=1024", 90 + 1024),
             (1, 300, 1024, [263], "B=1 T'=300 D=1024", 90 + 300)] if base else []
    cases += [(b, t, D, lens, f"B={b} T'={t} D={D} hd={D // H} ({what})", 2490 + i)
              for i, (b, t, lens, what) in enumerate(shapes)]
    for b, t, d, given, key, seed in cases:
        hd = d // H
        dl = local * hd
        for dtype, name in _dtypes():
            rng = np.random.RandomState(seed)
            dev = _dev(rng, dtype)
            x = dev(rng.randn(b, t, d))
            w = [dev(rng.normal(0, 1 / np.sqrt(d), shape)) for shape in ((dl, d), (dl,), (dl, d), (dl,), (dl, d),
                                                                          (dl,))]
            w = [a if a.ndim == 2 else a * 0.02 * np.sqrt(d) for a in w]
            bu, bv = dev(rng.normal(0, 0.02, (local, hd))), dev(rng.normal(0, 0.02, (local, hd)))
            pos_w, wo = dev(rng.normal(0, 1 / np.sqrt(d), (dl, d))), dev(rng.normal(0, 1 / np.sqrt(dl), (d, dl)))
            args = [x, *w, bu, bv, pos_w, wo]
            lengths = _mixed_lengths(rng, t) if given is None else np.asarray(given)
            kw = dict(lengths=torch.as_tensor(lengths, dtype=torch.int32, device="cuda"),
                      norm_w=dev(1 + rng.normal(0, 0.1, d), torch.float32),
                      norm_b=dev(rng.normal(0, 0.1, d), torch.float32))
            with torch.inference_mode():
                got = RA.rel_attention_block_heads(*args, **kw)
                ref = RA.rel_attention_block_reference(*args[:11], None, heads_partial=True, **kw)
            tag = (f"K1 head-sharded B={b} T'={t} D={d} hd={hd} local heads {local} {name} lengths "
                   f"{lengths.min()}-{lengths.max()}")
            k1_core_line(tag, b, t, d, local, x.element_size(), card, dl=dl)
            if got.dtype != torch.float32 or tuple(got.shape) != (b, t, d):
                raise RuntimeError(f"{tag}: partial is {got.dtype} {tuple(got.shape)}, want f32 {(b, t, d)}")
            rows = _valid_rows(lengths, t)

            def agree(what, g, r):
                """f32 by check_close; bf16 operands give an f32 partial, held as bf16 outputs are."""
                if dtype == torch.float32:
                    out["max_abs_err"] = max(out["max_abs_err"], check_close(f"{tag}{what}", g, r, rows))
                    return
                err, scale = float((g[rows] - r[rows]).abs().max()), float(r[rows].abs().max())
                log(f"  {tag}{what}: max|diff| {err:.3e} = {err / scale:.3%} of output scale {scale:.3f}")
                if not torch.isfinite(g[rows]).all() or err > BF16_SCALE_FRAC * scale:
                    raise RuntimeError(f"kernel disagrees with its plain version at {tag}{what}")

            agree("", got, ref)
            # the same inputs through the autograd Function, as a 'model' rank's trainer calls it
            leaves = [a.detach().requires_grad_() for a in (*args, kw["norm_w"], kw["norm_b"])]
            gkw = dict(lengths=kw["lengths"], norm_w=leaves[-2], norm_b=leaves[-1])
            before = RA.rel_attention_block_heads.launches
            got_g = RA.rel_attention_block_heads(*leaves[:11], **gkw)
            if RA.rel_attention_block_heads.launches != before + 1:
                raise RuntimeError(f"{tag}: under grad the Function launched the kernel "
                                   f"{RA.rel_attention_block_heads.launches - before} times, want 1")
            want_g = RA.rel_attention_block_reference(*leaves[:11], None, heads_partial=True, **gkw)
            agree(", Function forward under grad", got_g.detach(), want_g.detach())
            g_out = dev(rng.randn(b, t, d), torch.float32)
            ga, gw = torch.autograd.grad(got_g, leaves, g_out), torch.autograd.grad(want_g, leaves, g_out)
            worst = max(float((a.float() - v.float()).abs().max()) / max(float(v.float().abs().max()), 1e-30)
                        for a, v in zip(ga, gw))
            limit = K1_GRAD_F32_FRAC if dtype == torch.float32 else BF16_SCALE_FRAC
            log(f"  {tag}, Function backward: worst input gradient {worst:.2e} of its scale (limit {limit:g}), "
                f"{len(leaves)} inputs")
            if worst > limit:
                raise RuntimeError(f"{tag}: the Function's input gradients differ from the plain version's")
            out["grads"][f"{key} {name}"] = worst
            times = "times" if dtype == torch.float32 else "bf16_times"
            out[times][key] = time_pair(tag, lambda: RA.rel_attention_block_heads(*args, **kw),
                                        lambda: RA.rel_attention_block_reference(*args[:11], None,
                                                                                 heads_partial=True, **kw),
                                        card)
            pe_bytes = (2 * t - 1) * d * x.element_size()
            work = times.replace("times", "work")
            out[work][key] = (heads_flops(b, t, d, local, hd, lengths),
                              tensor_bytes(*args, *kw.values(), got) + pe_bytes)
            bd = bound(*out[work][key], F32_PEAK if dtype == torch.float32 else BF16_PEAK)
            log(f"  bound {tag}: {bd['gflop']:.3f} GFLOP, {bd['mbyte']:.2f} MB -> {bd['bound_ms']:.4f} ms by "
                f"{bd['bound_by']}; kernel / plain device {out[times][key]['dev_ms']:.4f} / "
                f"{out[times][key]['plain_dev_ms']:.4f} ms [{card}]")
    return out


class CollectiveClock:
    """Host time inside the mesh's collectives on one rank, while `on`: each
    call of torch.distributed's all_reduce, all_gather, all_gather_object,
    reduce_scatter and broadcast and each pipeline hand-over
    (parallel/pipeline.py, its send and receive posted together), waiting
    for the peer included, and each staging copy of a CUDA tensor to the
    host (parallel/collectives.py `_staged`). Each is timed after a device
    synchronize, so that the device work queued before it is not counted;
    a call inside a timed one (the staging of a hand-over) counts once, in
    the outer; the copies back to the card are not counted."""

    def __init__(self):
        import torch
        import torch.distributed as dist

        from parakeet_tpu_torch.parallel import collectives as CO
        from parakeet_tpu_torch.parallel import pipeline as PP

        self.on, self.calls, self.gloo_s, self.staging_s = False, 0, 0.0, 0.0
        self._depth = 0

        def wrap(owner, name, kind):
            fn = getattr(owner, name)

            def timed(*a, **kw):
                if not self.on or self._depth:
                    return fn(*a, **kw)
                torch.cuda.synchronize()
                self._depth += 1
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    dt = time.perf_counter() - t0
                    self._depth -= 1
                    if kind == "gloo":
                        self.calls += 1
                        self.gloo_s += dt
                    else:
                        self.staging_s += dt

            setattr(owner, name, timed)

        for name in ("all_reduce", "all_gather", "all_gather_object", "reduce_scatter", "broadcast"):
            wrap(dist, name, "gloo")
        for name in ("hand_over", "broadcast"):
            wrap(PP._Schedule, name, "gloo")
        wrap(CO, "_staged", "staging")


def _token_summary(results) -> list:
    return [(r.token_ids, _spans(r)) for r in results]


def mesh_stream_scenario(bt, pcm) -> list:
    """B=8 int16 PCM in 160 ms pushes: slot 6 deactivated, slot 3's push 5
    one push late (its lag held), slot 5 reset at push 12 and replayed from
    the start. Returns each slot's (token, start, end) spans."""
    bt.reset()
    bt.deactivate_slot(6)
    pushes = [_stream_pushes(p) for p in pcm]
    for k in range(len(pushes[0])):
        for i in range(bt.batch):
            if i == 6 or (i, k) == (3, 5):
                continue
            if (i, k) == (3, 6):
                bt.push(i, pushes[i][5])
            bt.push(i, pushes[i][k])
        if k == 12:
            bt.reset_slot(5)
            for x in pushes[5][: k + 1]:
                bt.push(5, x)
        while bt.ready_any():
            bt.step(hold=bt.lagging_slots())
    return [[(t.token_id, t.start_frame, t.end_frame) for t in bt.get_timestamped_tokens(i)]
            for i in range(bt.batch)]


def _mesh_decode(tr, clips, clock=None) -> dict:
    """TDT (timestamps) and CTC on the clips, each call's kernel launches
    and synchronised wall ms (after a warm-up call of each); with a
    CollectiveClock, one more call of each with the clock on: its wall, and
    its time inside the collectives."""
    import torch

    from parakeet_tpu_torch.transcribe import Decoder, TranscribeOptions

    out, launches, wall, coll = {}, {}, {}, {}
    for dec, opts in (("TDT", TranscribeOptions(Decoder.TDT, timestamps=True)), ("CTC", TranscribeOptions(Decoder.CTC))):
        tr.transcribe_batch(clips, opts)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        out[dec] = _token_summary(tr.transcribe_batch(clips, opts))
        torch.cuda.synchronize()
        wall[dec] = (time.perf_counter() - t0) * 1e3
        launches[dec] = read_counts()
        if clock is not None:
            clock.on, clock.calls, clock.gloo_s, clock.staging_s = True, 0, 0.0, 0.0
            t0 = time.perf_counter()
            tr.transcribe_batch(clips, opts)
            torch.cuda.synchronize()
            clock.on = False
            coll[dec] = {"wall_ms": (time.perf_counter() - t0) * 1e3, "calls": clock.calls,
                         "gloo_ms": clock.gloo_s * 1e3, "staging_ms": clock.staging_s * 1e3}
    out["launches"], out["wall_ms"], out["collectives"] = launches, wall, coll
    return out


def _mesh_lookahead(tr, clips) -> list:
    """The clips' TDT decode with impl="lookahead", window 8, on `tr`'s
    encoder output and mesh (the vocab heads split over 'model', each
    window's logits gathered): each item's token ids and spans."""
    import torch

    from parakeet_tpu_torch.audio.frontend import preprocess_audio_batch
    from parakeet_tpu_torch.decode.transducer import transducer_greedy_decode
    from parakeet_tpu_torch.models.encoder import encoded_lengths

    feats, n_frames = preprocess_audio_batch(clips, tr._audio_cfg, tr.device)
    pred = tr.config.prediction
    with torch.inference_mode():
        res = transducer_greedy_decode(
            tr.params, tr.encode(feats, n_frames), pred_hidden=pred.pred_hidden, num_lstm_layers=pred.num_lstm_layers,
            durations=tr._durations(), blank_id=tr._blank_id, joint_prefix=tr.joint_prefix,
            enc_lengths=encoded_lengths(torch.as_tensor(n_frames)).tolist(), model=tr._model, impl="lookahead",
            window=8)
    return [(toks, [(t.token_id, t.start_frame, t.end_frame) for t in ts])
            for toks, ts in zip(res.tokens, res.timestamped)]


def mesh_rank(rank: int, flat, eou_flat, clips, pcm) -> dict:
    """One of two ranks on the card over gloo: (i) dp2 tdt-ctc-110m default,
    (ii) dp1×tp2 (K1 head-sharded; and a TDT decode with impl="lookahead"),
    (iii) dp1×sp2 with kernels=False, (iv) eou-120m
    StreamingBatchTranscriber B=8 dp2; each scenario's tokens, launches and
    seconds, and in (i)-(iii) the time a batch spends inside the
    collectives (CollectiveClock)."""
    import torch

    from parakeet_tpu_torch import config as C
    from parakeet_tpu_torch.ops.layers import require_ieee_f32
    from parakeet_tpu_torch.parallel.mesh import make_mesh
    from parakeet_tpu_torch.streaming import StreamingBatchTranscriber
    from parakeet_tpu_torch.transcribe import Transcriber

    require_ieee_f32()
    clock = CollectiveClock()
    out = {}
    for name, mesh_kw, kw in (("dp2", {}, {}), ("dp1xtp2", dict(model_parallel=2), {}),
                              ("dp1xsp2", dict(seq_parallel=2), dict(kernels=False))):
        t0 = time.perf_counter()
        mesh = make_mesh(backend="gloo", **mesh_kw)
        tr = Transcriber(config=C.make_110m_config(), params=flat, mesh=mesh, **kw)
        out[name] = dict(_mesh_decode(tr, clips, clock), device=str(mesh.device), shape=dict(mesh.shape))
        if name == "dp1xtp2":
            out[name]["lookahead"] = _mesh_lookahead(tr, clips)
        out[name]["seconds"] = time.perf_counter() - t0
        del tr
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh = make_mesh(backend="gloo")
    bt = StreamingBatchTranscriber(8, config=C.make_eou_120m_config(), params=eou_flat, frontend="fused",
                                   wire_dtype="int16", mesh=mesh)
    reset_counts()
    out["stream dp2"] = {"spans": mesh_stream_scenario(bt, pcm), "launches": read_counts(),
                         "slots": (bt._slots.start, bt._slots.stop), "seconds": time.perf_counter() - t0}
    return out


def nccl_rank(rank: int, flat, clips) -> dict:
    """(v) one rank over NCCL (world 1): a dp1 mesh, tdt-ctc-110m default."""
    from parakeet_tpu_torch import config as C
    from parakeet_tpu_torch.ops.layers import require_ieee_f32
    from parakeet_tpu_torch.parallel.mesh import make_mesh
    from parakeet_tpu_torch.transcribe import Transcriber

    require_ieee_f32()
    t0 = time.perf_counter()
    mesh = make_mesh()
    tr = Transcriber(config=C.make_110m_config(), params=flat, mesh=mesh)
    return dict(_mesh_decode(tr, clips), backend=mesh.backend, shape=dict(mesh.shape), seconds=time.perf_counter() - t0)


def mesh_phase(clips, card: str) -> dict:
    """Inference on a mesh, on the one card: K1 head-sharded against its
    plain version; two spawned ranks sharing the card over gloo run (i)-(iv)
    (mesh_rank); one NCCL rank runs (v); tokens and frames of every rank
    identical to the single-device card run; launches per rank. Two ranks
    on one card over NCCL must raise. Coverage, not scaling: both ranks
    share one card, and gloo stages each collective through host memory."""
    import os

    import torch
    import torch.distributed as dist

    from parakeet_tpu_torch import config as C
    from parakeet_tpu_torch import params as P
    from parakeet_tpu_torch.audio.frontend import preprocess_audio_batch
    from parakeet_tpu_torch.models.encoder import encoded_lengths
    from parakeet_tpu_torch.parallel.launch import spawn_ranks
    from parakeet_tpu_torch.parallel.mesh import make_mesh
    from parakeet_tpu_torch.streaming import StreamingBatchTranscriber

    t0 = time.perf_counter()
    flat = model_params("tdt-ctc-110m")
    single = facade("tdt-ctc-110m", "cuda", params=flat)
    # dp1×tp2 launches K1 head-sharded on the whole batch of clips, unpadded
    enc_lens = encoded_lengths(torch.as_tensor(preprocess_audio_batch(clips, single._audio_cfg, "cpu")[1])).numpy()
    out = {"k1": k1_heads_part(card, [(len(clips), int(enc_lens.max()), enc_lens, "dp1×tp2 on the clips")])}
    log(f"  (K1 head-sharded: {time.perf_counter() - t0:.1f} s into the phase)")

    os.environ["WORLD_SIZE"] = "2"
    try:
        make_mesh()
    except ValueError as e:
        log(f"  two NCCL ranks on one card raise as they should: {e}")
    else:
        raise RuntimeError("make_mesh() with two NCCL ranks on one card did not raise")
    finally:
        del os.environ["WORLD_SIZE"]

    eou_flat = P.init_params_numpy(P.eou_spec(C.make_eou_120m_config()), seed=0)
    stream_clips = synthetic_clips(8, seed=1900, min_s=MESH_STREAM_S, max_s=MESH_STREAM_S)
    pcm = [np.clip(c * 32768, -32768, 32767).astype(np.int16) for c in stream_clips]
    ref = _mesh_decode(single, clips)
    del single
    bt = StreamingBatchTranscriber(8, config=C.make_eou_120m_config(), params=eou_flat, frontend="fused",
                                   wire_dtype="int16", device="cuda")
    ref_stream = mesh_stream_scenario(bt, pcm)
    del bt
    torch.cuda.empty_cache()
    log(f"== mesh: single-device card runs: tdt-ctc-110m default TDT {sum(len(t) for t, _ in ref['TDT'])} tokens, "
        f"CTC {sum(len(t) for t, _ in ref['CTC'])}; eou-120m B=8 {[len(s) for s in ref_stream]} tokens per slot "
        f"({time.perf_counter() - t0:.1f} s into the phase)")

    t1 = time.perf_counter()
    ranks = spawn_ranks(mesh_rank, 2, flat, eou_flat, clips, pcm, backend="gloo", timeout=600, threads=0)
    log(f"  two gloo ranks on the card: {time.perf_counter() - t1:.1f} s")
    # (v) in this process: a world of one needs no second process, and a spawned rank's start-up cost ~10 s
    t1 = time.perf_counter()
    MESH_DIR.mkdir(parents=True, exist_ok=True)
    rdzv = MESH_DIR / "nccl_rdzv_inference"
    rdzv.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{rdzv}", world_size=1, rank=0)
    try:
        nccl = nccl_rank(0, flat, clips)
    finally:
        dist.destroy_process_group()
    log(f"  one NCCL rank (this process): {time.perf_counter() - t1:.1f} s")

    layers = C.make_110m_config().encoder.num_layers
    want = {"dp2": {"rel_attention_block": layers}, "dp1xtp2": {"rel_attention_block_heads": layers},
            "dp1xsp2": {}, "nccl dp1": {"rel_attention_block": layers}}
    runs = [(f"rank {r} {name}", name, res[name]) for r, res in enumerate(ranks) for name in ("dp2", "dp1xtp2", "dp1xsp2")]
    runs.append(("NCCL rank dp1", "nccl dp1", nccl))
    for tag, name, res in runs:
        for dec in ("TDT", "CTC"):
            if res[dec] != ref[dec]:
                i = next(i for i, (a, b) in enumerate(zip(res[dec], ref[dec])) if a != b)
                raise RuntimeError(f"mesh {tag} {dec}: item {i} differs from the single-device card run")
            counts = {k: v for k, v in res["launches"][dec].items() if v}
            if counts != want[name]:
                raise RuntimeError(f"mesh {tag} {dec}: launches {counts}, want {want[name]} a batch")
        log(f"  {tag} ({res.get('shape')}, {res.get('device', res.get('backend'))}): TDT and CTC tokens and frames "
            f"identical to the single-device card run; launches a batch per rank {want[name] or 'none'}; warm "
            f"batch wall TDT {res['wall_ms']['TDT']:.1f} ms, CTC {res['wall_ms']['CTC']:.1f} ms (single device "
            f"{ref['wall_ms']['TDT']:.1f}, {ref['wall_ms']['CTC']:.1f}) [{card}] ({res['seconds']:.1f} s)")
        for dec, c in res["collectives"].items():
            inside = c["gloo_ms"] + c["staging_ms"]
            log(f"    {dec} batch with the collective clock on: wall {c['wall_ms']:.1f} ms, {c['calls']} gloo calls "
                f"{c['gloo_ms']:.1f} ms + staging to the host {c['staging_ms']:.1f} ms = {inside:.1f} ms, "
                f"{inside / c['wall_ms']:.1%} of the wall [{card}]")
    for r, res in enumerate(ranks):
        if res["dp1xtp2"]["lookahead"] != ref["TDT"]:
            i = next(i for i, (a, b) in enumerate(zip(res["dp1xtp2"]["lookahead"], ref["TDT"])) if a != b)
            raise RuntimeError(f"mesh rank {r} dp1xtp2 lookahead: item {i} differs from the single-device card run")
        log(f"  rank {r} dp1xtp2 impl='lookahead' window 8 (each window's vocab logits gathered over 'model'): "
            "tokens and frames identical to the single-device card run's TDT")
    for r, res in enumerate(ranks):
        s = res["stream dp2"]
        if s["spans"] != ref_stream or any(s["launches"].values()):
            raise RuntimeError(f"mesh rank {r} streaming dp2: spans differ from the single-device run or a kernel "
                               f"launched ({s['launches']})")
        log(f"  rank {r} eou-120m B=8 dp2 (slots {s['slots'][0]}-{s['slots'][1] - 1}): every slot's tokens and "
            f"frames identical to the single-device card run, no kernel ({s['seconds']:.1f} s)")
    out["wall_ms"] = {"single": ref["wall_ms"], "nccl dp1": nccl["wall_ms"],
                      **{name: [res[name]["wall_ms"] for res in ranks] for name in ("dp2", "dp1xtp2", "dp1xsp2")}}
    out["collectives"] = {name: [res[name]["collectives"] for res in ranks] for name in ("dp2", "dp1xtp2", "dp1xsp2")}
    out["launches_heads"] = ranks[0]["dp1xtp2"]["launches"]["TDT"]
    out["launches"] = {name: ranks[0][name]["launches"]["TDT"] for name in ("dp2", "dp1xtp2", "dp1xsp2")}
    out["launches"]["nccl dp1"] = nccl["launches"]["TDT"]
    return out


# ── train_mesh: training over torch.distributed on the one card ──

MESH_DIR = ROOT / "build" / "parakeet_tpu_torch" / "train_mesh_smoke"
MESH_GRAD_FRAC = 1e-4  # each key's gradient, mesh vs the single-device card step, within 1e-4 of the key's
#   max |g|, or within MESH_SPREAD_K times that key's own spread if that is wider: K1's kernel (whole
#   or head-sharded, its split-K plan set by the batch) and its plain version (under 'seq') round
#   differently, so the CPU tests' 1e-5 (both sides the plain version) is not the card's bound
MESH_SPREAD_REL = 1e-6  # a key's spread: its single-device gradient again on features × (1 + 1e-6·noise)
#   (seeded noise), the change over the key's max |g|; a key whose gradient moves more than that
#   under a 1e-6 change of the input cannot be held closer through f32 rounding of the same sums
MESH_SPREAD_K = 4.0  # the margin on a key's spread
MESH_LOSS_RTOL = 1e-5  # the step's loss, mesh vs the single-device card step
MESH_600M_B, MESH_600M_MICRO = 4, 2


def mesh_train_launches(case: str, layers: int, pipe: int = 1, n_micro: int = 1) -> dict:
    """K1's launches a step a rank on a mesh trainer: whole heads once a
    block on a 'data' mesh, head-sharded once a block on a 'model' one,
    none under 'seq' (its attention is K1's plain version, as the
    reference requires); a 'pipe' stage's blocks twice a microbatch (the
    forward, and the recompute in backward)."""
    if "sp2" in case:
        return {}
    if "tp2" in case:
        return {"rel_attention_block_heads": layers}
    if "pipe" in case:
        return {"rel_attention_block": 2 * layers // pipe * n_micro}
    return {"rel_attention_block": layers}


def grad_fractions(got: dict, ref: dict) -> tuple[list, list]:
    """Each key's max |got − ref| over the key's max |ref|, worst first, and
    the keys zero up to rounding (ref max |g| below GRAD_ZERO_FRAC of the
    largest key's), left out."""
    scales = {k: float(v.abs().max()) for k, v in ref.items()}
    zero = GRAD_ZERO_FRAC * max(scales.values())
    left_out = sorted(k for k, s in scales.items() if s < zero)
    fracs = sorted(((float((got[k].to(ref[k].device) - ref[k]).abs().max()) / scales[k], k)
                    for k in got if k not in left_out), reverse=True)
    return fracs, left_out


def key_limits(ref: dict) -> dict:
    """Each key's limit: the larger of MESH_GRAD_FRAC and MESH_SPREAD_K
    times the key's spread in the single-device card step (`ref`)."""
    return {k: max(MESH_GRAD_FRAC, MESH_SPREAD_K * s) for k, s in ref["spreads"].items()}


def grad_agreement(name: str, got: dict, ref: dict) -> dict:
    """`grad_fractions` of a mesh case against the single-device card step
    (`ref`, with each key's spread), each key against its `key_limits`:
    the worst three over their limits, the keys left out, and the keys
    whose limit is their spread's. Raises past any key's limit."""
    fracs, left_out = grad_fractions(got, ref["grads"])
    limits = key_limits(ref)
    over = sorted(((f / limits[k], f, limits[k], k) for f, k in fracs), reverse=True)
    wide = sorted((limits[k], k) for _, k in fracs if limits[k] > MESH_GRAD_FRAC)
    if not over or over[0][0] > 1.0:
        raise RuntimeError(f"{name}: gradients differ from the single-device card step beyond their keys' limits "
                           f"(over limit, |diff| / max |g|, limit, key): {over[:5]}")
    return {"worst": fracs[0][0], "worst_key": fracs[0][1], "over": over[:3], "keys": len(fracs),
            "left_out": left_out, "wide": wide}


def fault_reading(name: str, got: dict, ref: dict) -> dict:
    """A rank's unreduced gradients (`step.local_value_and_grad`: what a
    step missing its 'data' mean or 'seq' sum would apply) against the
    single-device card step, by `grad_agreement`'s limits: the keys past
    their limit and the median |diff| / max |g|. Raises unless the gate
    would catch the fault."""
    fracs, _ = grad_fractions(got, ref["grads"])
    limits = key_limits(ref)
    caught = sum(f > limits[k] for f, k in fracs)
    if not caught:
        raise RuntimeError(f"{name}: the gradient gate does not see a missing reduction")
    return {"caught": caught, "keys": len(fracs), "median": fracs[len(fracs) // 2][0], "worst": fracs[0][0]}


def key_patterns(keys) -> str:
    """Keys with their layer indices folded: 'encoder_.layers_.*.attn_… ×17'."""
    import collections
    import re

    count = collections.Counter(re.sub(r"layers_\.\d+\.", "layers_.*.", k) for k in keys)
    return ", ".join(f"{k} ×{n}" if n > 1 else k for k, n in sorted(count.items())) or "none"


def _timed_step(step, state, batch, clock) -> dict:
    """One synchronised step with the collective clock on: its wall, time
    inside the collectives, launches and peak memory (the clock's
    synchronisations around each collective are inside the wall)."""
    import torch

    sync()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    clock.on, clock.calls, clock.gloo_s, clock.staging_s = True, 0, 0.0, 0.0
    t0 = time.perf_counter()
    float(step(state.params, state.opt_state, batch)[2])
    sync()
    clock.on = False
    wall = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in read_counts().items() if v}
    peak = torch.cuda.max_memory_allocated() / 1e9
    coll = {"wall_ms": wall, "calls": clock.calls, "gloo_ms": clock.gloo_s * 1e3, "staging_ms": clock.staging_s * 1e3}
    return {"step_ms": wall, "launches": launches, "peak_gb": peak, "collectives": coll}


def _mesh_case(name: str, trainer, batch, ref: dict, clock, unpad) -> dict:
    """One mesh trainer's step: its reduced loss and whole gradients
    (gathered over 'model', cut to the schema's shapes) against the
    single-device card step's; on a 'data' or 'seq' axis of 2, the rank's
    unreduced gradients too (`fault_reading`); then `_timed_step`."""
    _, state, step, place = trainer
    b = place(batch)
    loss, grads = step.value_and_grad(state.params, b)
    whole = unpad(state.opt_state.layout.gather(grads))
    rel = abs(float(loss) - ref["loss"]) / abs(ref["loss"])
    if rel > MESH_LOSS_RTOL:
        raise RuntimeError(f"{name}: loss {float(loss)} vs single-device {ref['loss']} ({rel:.2e})")
    out = {"loss": float(loss), "loss_rel": rel, "grads": grad_agreement(name, whole, ref)}
    del whole, grads
    if "dp2" in name or "sp2" in name:
        local = unpad(state.opt_state.layout.gather(step.local_value_and_grad(state.params, b)[1]))
        out["fault"] = fault_reading(name, local, ref)
        del local
    out.update(_timed_step(step, state, b, clock))
    return out


def _load_ref(path: Path) -> dict:
    import torch

    return torch.load(path, mmap=True)


def train_mesh_rank(rank: int, files: dict) -> dict:
    """One of two ranks on the card over gloo: (i) dp2, dp1×tp2, dp1×sp2
    tdt-ctc-110m hybrid steps on the loader's batch; (iii) Sortformer-117m
    on dp2 and dp1×tp2; (ii) dp1×pipe2 tdt-600m (tdt, B=4, 2 microbatches):
    each against the single-device card step's loss and gradients, then
    a timed step with the collective clock on."""
    import torch

    from parakeet_tpu_torch import config as C
    from parakeet_tpu_torch import params as P
    from parakeet_tpu_torch.ops.layers import require_ieee_f32
    from parakeet_tpu_torch.parallel.mesh import make_mesh
    from parakeet_tpu_torch.parallel.pipeline import LAYER_PREFIX, make_pp_trainer
    from parakeet_tpu_torch.train import make_sharded_trainer, synthetic_sortformer_batch

    require_ieee_f32()
    clock = CollectiveClock()
    out = {}
    for model, spec_fn, loss, batch, cases in (
            ("tdt-ctc-110m", P.tdt_ctc_spec, "hybrid", torch.load(files["batch"]),
             (("dp2", {}), ("dp1xtp2", dict(model_parallel=2)), ("dp1xsp2", dict(seq_parallel=2)))),
            ("sortformer-117m", P.sortformer_spec, "sortformer", None,
             (("sortformer dp2", {}), ("sortformer dp1xtp2", dict(model_parallel=2))))):
        cfg = C.make_110m_config() if loss == "hybrid" else C.make_sortformer_117m_config()
        if batch is None:
            batch = synthetic_sortformer_batch(cfg, 4, 1000, seed=5)
        params = card_params(spec_fn(cfg), seed=0)
        ref = _load_ref(files[model])
        shapes = {k: tuple(v.shape) for k, v in params.items()}
        unpad = lambda g: {k: v[tuple(slice(0, n) for n in shapes[k])] for k, v in g.items()}  # noqa: E731
        for name, kw in cases:
            t0 = time.perf_counter()
            mesh = make_mesh(backend="gloo", **kw)
            trainer = make_sharded_trainer(cfg, params, mesh, loss=loss, sigma=0.05, device="cuda")
            out[name] = _mesh_case(name, trainer, batch, ref, clock, unpad)
            out[name].update(shape=dict(mesh.shape), seconds=time.perf_counter() - t0)
            del trainer
            torch.cuda.empty_cache()
        del params, ref
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    cfg = C.make_tdt_600m_config()
    params = card_params(P.tdt_spec(cfg), seed=0)
    mesh = make_mesh(backend="gloo", pipeline_parallel=2)
    state, step, place, _ = make_pp_trainer(cfg, params, mesh, n_micro=MESH_600M_MICRO, loss="tdt", sigma=0.05)
    del params
    ref = _load_ref(files["tdt-600m"])
    b = place(torch.load(files["batch600m"]))
    loss, grads = step.value_and_grad(state.params, b)
    rel = abs(float(loss) - ref["loss"]) / abs(ref["loss"])
    if rel > MESH_LOSS_RTOL:
        raise RuntimeError(f"dp1xpipe2: loss {float(loss)} vs single-device {ref['loss']} ({rel:.2e})")
    # this stage's rows of each stacked layer key against the single-device gradients of those layers
    axis = mesh.axis("pipe")
    n_local = cfg.encoder.num_layers // axis.size
    mine = {}
    for (outer, key), g in grads.items():
        if outer == "rest":
            mine[key] = g
        else:
            for j in range(n_local):
                mine[f"{LAYER_PREFIX}{axis.index * n_local + j}.{key}"] = g[j]
    agree = grad_agreement("dp1xpipe2", mine, {"grads": {k: ref["grads"][k] for k in mine},
                                               "spreads": {k: v for k, v in ref["spreads"].items() if k in mine}})
    del mine, grads, ref
    out["dp1xpipe2"] = {"loss": float(loss), "loss_rel": rel, "grads": agree, "shape": dict(mesh.shape),
                        **_timed_step(step, state, b, clock), "seconds": time.perf_counter() - t0}
    return out


def nccl_train_rank(rank: int, files: dict) -> dict:
    """(iv) one rank over NCCL (world 1): a dp1 mesh, a tdt-ctc-110m hybrid
    step against the single-device card step."""
    import torch

    from parakeet_tpu_torch import config as C
    from parakeet_tpu_torch import params as P
    from parakeet_tpu_torch.ops.layers import require_ieee_f32
    from parakeet_tpu_torch.parallel.mesh import make_mesh
    from parakeet_tpu_torch.train import make_sharded_trainer

    require_ieee_f32()
    t0 = time.perf_counter()
    cfg = C.make_110m_config()
    params = card_params(P.tdt_ctc_spec(cfg), seed=0)
    mesh = make_mesh()
    trainer = make_sharded_trainer(cfg, params, mesh, loss="hybrid", sigma=0.05, device="cuda")
    out = _mesh_case("nccl dp1", trainer, torch.load(files["batch"]), _load_ref(files["tdt-ctc-110m"]),
                     CollectiveClock(), lambda g: g)
    return dict(out, backend=mesh.backend, shape=dict(mesh.shape), seconds=time.perf_counter() - t0)


def single_train_reference(model: str, batch: dict, path: Path, card: str, remat: bool = False) -> dict:
    """The single-device card step's loss and gradients (the trainer's
    loss through value_and_grad_accum), saved for the ranks; and that
    step's synchronised wall, launches and peak memory."""
    import torch

    from parakeet_tpu_torch import config as C
    from parakeet_tpu_torch import params as P
    from parakeet_tpu_torch import train as T

    cfg, spec, loss = {"tdt-ctc-110m": (C.make_110m_config(), P.tdt_ctc_spec, "hybrid"),
                       "sortformer-117m": (C.make_sortformer_117m_config(), P.sortformer_spec, "sortformer"),
                       "tdt-600m": (C.make_tdt_600m_config(), P.tdt_spec, "tdt")}[model]
    fn = T.objective(cfg, loss, sigma=0.05, remat=remat)
    _, state, step, place = T.make_sharded_trainer(cfg, card_params(spec(cfg), seed=0), loss=loss, sigma=0.05,
                                                   remat=remat, device="cuda")
    b = place(batch)
    vag = T.value_and_grad_accum(fn)
    lval, grads = vag(state.params, b)
    grads = {k: g.cpu() for k, g in grads.items()}
    gen = torch.Generator(device="cuda").manual_seed(11)
    noise = torch.randn(b["features"].shape, generator=gen, device="cuda")
    moved = vag(state.params, dict(b, features=b["features"] * (1 + MESH_SPREAD_REL * noise)))[1]
    moved = {k: g.cpu() for k, g in moved.items()}
    fracs, _ = grad_fractions(moved, grads)
    spreads = {k: f for f, k in fracs}
    torch.save({"loss": float(lval), "grads": grads, "spreads": spreads}, path)
    del grads, moved
    sync()
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    float(step(state.params, state.opt_state, b)[2])
    sync()
    wall = (time.perf_counter() - t0) * 1e3
    out = {"loss": float(lval), "step_ms": wall, "launches": {k: v for k, v in read_counts().items() if v},
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "spread": fracs[0][0],
           "spread_median": fracs[len(fracs) // 2][0]}
    log(f"  single-device card step, {model} {loss}{' remat' if remat else ''}: loss {out['loss']:.6f}, step wall "
        f"{wall:.1f} ms, K1 {out['launches']}, peak {out['peak_gb']:.2f} GB; its gradients on features × (1 + "
        f"{MESH_SPREAD_REL:g}·noise) move by up to {fracs[0][0]:.2e} of a key's max |g| ({fracs[0][1]}), median key "
        f"{out['spread_median']:.2e} [{card}]")
    del state, step
    torch.cuda.empty_cache()
    return out


def torchrun_start(jobs: dict, logs: Path) -> dict:
    """Start each job {tag: (module, argv)} as `python -m torch.distributed.run
    --standalone --nproc-per-node 2 -m module argv` from the repo root
    (rendezvous on localhost, a free port each), all at once so that the
    ranks' start-up overlaps, their output to files under `logs`; returns
    {tag: (process, stderr file)} for `torchrun_wait`."""
    logs.mkdir(parents=True, exist_ok=True)
    procs = {}
    for tag, (module, argv) in jobs.items():
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node=2", "-m", module,
               *argv]
        err = logs / f"{len(list(logs.iterdir()))}.err"
        with open(err, "w") as f:
            procs[tag] = (subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.DEVNULL, stderr=f, text=True), err)
    return procs


def torchrun_wait(procs: dict) -> dict:
    """Each started job's stderr (rank 0 logs), echoed; a failing rank fails
    the run."""
    out = {}
    for tag, (proc, path) in procs.items():
        proc.wait(timeout=600)
        err = path.read_text()
        for line in err.splitlines():
            if line.startswith(("step ", "# ")):
                log(f"    [{tag}] {line}")
        if proc.returncode != 0:
            raise RuntimeError(f"{tag} under python -m torch.distributed.run exited {proc.returncode}:\n{err[-3000:]}")
        out[tag] = err
    return out


def train_mesh_cli_start() -> dict:
    """(v)'s first round, started: train_cli under python -m
    torch.distributed.run, two gloo ranks on the card, tdt-ctc-110m with
    --data-parallel 2 and with --model-parallel 2 (the 1025 vocabulary
    padded to 1026), 1 step and a checkpoint each, and train_diar_cli
    --data-parallel 2 (Sortformer-117m), 1 step, all at once. The phase
    runs its gloo cases while these start (their start-up dominates: ~40 s
    a 110m launch alone, PR 14's first card runs); `train_mesh_cli_part`
    waits for them and runs the second round."""
    from parakeet_tpu_torch import config as C
    from parakeet_tpu_torch import params as P
    from parakeet_tpu_torch.io.safetensors import save_safetensors

    t0 = time.perf_counter()
    # two clips a run, one a rank: the launches' start-up, not the step, sets the part's time
    manifest = train_corpus(MESH_DIR / "cli", 2, seed=31, min_s=2.0, max_s=4.0)
    diar = train_corpus(MESH_DIR / "diar", 2, seed=99, min_s=4.0, max_s=4.0, rttm=True)
    vocab = smoke_vocab(1025)
    # the runs start from weights drawn here on the card: each rank's numpy draw cost seconds
    init, init_sf = MESH_DIR / "init110m.safetensors", MESH_DIR / "init_sortformer.safetensors"
    save_safetensors(host_params(P.tdt_ctc_spec(C.make_110m_config()), seed=0), init)
    save_safetensors(host_params(P.sortformer_spec(C.make_sortformer_117m_config()), seed=0), init_sf)
    flags = {"--data-parallel 2": ["--data-parallel", "2"], "--model-parallel 2": ["--model-parallel", "2"]}
    base = {tag: ["--manifest", str(manifest), "--vocab", str(vocab), "--init-weights", str(init), "--batch-size", "2",
                  "--log-every", "1", "--dist-backend", "gloo", "--checkpoint-dir", str(MESH_DIR / f"ck{f[0]}"), *f]
            for tag, f in flags.items()}
    log("== (v) train_cli --data-parallel 2 and --model-parallel 2 (1 step and a checkpoint) and train_diar_cli "
        "--data-parallel 2 (1 step) under python -m torch.distributed.run, two gloo ranks on the card each, at once, "
        "started beside the gloo cases")
    jobs = {tag: ("parakeet_tpu_torch.train_cli", argv + ["--steps", "1"]) for tag, argv in base.items()}
    jobs["diar"] = ("parakeet_tpu_torch.train_diar_cli", ["--manifest", str(diar), "--init-weights", str(init_sf),
                                                          "--batch-size", "2", "--steps", "1", "--log-every", "1",
                                                          "--data-parallel", "2", "--dist-backend", "gloo"])
    return {"t0": t0, "flags": flags, "base": base, "first": torchrun_start(jobs, MESH_DIR / "cli_logs")}


def train_mesh_cli_part(started: dict) -> dict:
    """(v) after `train_mesh_cli_start`: its round waited for, then the two
    train_cli runs again, --resume to 2 and --export, at once; the losses,
    the export's vocab rows unpadded (1025) and the tp checkpoint's padded
    (1026)."""
    from parakeet_tpu_torch.io.safetensors import load_safetensors

    flags, base = started["flags"], started["base"]
    first = torchrun_wait(started["first"])
    export = {tag: MESH_DIR / f"export{f[0]}.safetensors" for tag, f in flags.items()}
    log("== (v) the two train_cli runs again: --resume to step 2 and --export, at once")
    second = torchrun_wait(torchrun_start({tag: ("parakeet_tpu_torch.train_cli",
                                                 argv + ["--steps", "2", "--resume", "--export", str(export[tag])])
                                           for tag, argv in base.items()}, MESH_DIR / "cli_logs"))
    out = {}
    for tag in flags:
        l1, l2 = cli_losses(first[tag]), cli_losses(second[tag])
        if sorted(l1) != [1] or sorted(l2) != [2] or "# resumed at step 1" not in second[tag]:
            raise RuntimeError(f"train_cli {tag}: steps {sorted(l1)} then {sorted(l2)}")
        state = load_safetensors(MESH_DIR / f"ck{flags[tag][0]}" / "state.safetensors")
        exported = load_safetensors(export[tag])
        rows = (state["tdt_joint_.label_proj_.weight"].shape[0], exported["tdt_joint_.label_proj_.weight"].shape[0],
                exported["ctc_decoder_.proj_.weight"].shape[0])
        want = (1026 if "model" in tag else 1025, 1025, 1025)
        if rows != want or not all(np.isfinite(v) for v in {**l1, **l2}.values()):
            raise RuntimeError(f"train_cli {tag}: vocab rows (checkpoint, export label, export ctc) {rows}, want "
                               f"{want}; losses {l1} {l2}")
        out[tag] = {"losses": {**l1, **l2}, "rows": rows}
        log(f"  train_cli {tag}: losses {out[tag]['losses']}; checkpoint vocab rows {rows[0]} (whole, padded as the "
            f"reference writes them under 'model'), export {rows[1]} / {rows[2]}")
    losses = cli_losses(first["diar"])
    if sorted(losses) != [1] or not all(np.isfinite(v) for v in losses.values()):
        raise RuntimeError(f"train_diar_cli --data-parallel 2: losses {losses}")
    out["diar"] = {"losses": losses}
    out["seconds"] = time.perf_counter() - started["t0"]
    log(f"  train_diar_cli --data-parallel 2: losses {losses}; the CLIs {out['seconds']:.1f} s from their start, "
        f"beside the gloo cases")
    return out


def train_mesh_k1_part(batches: dict, card: str) -> dict:
    """K1 against its plain version at the shapes the train_mesh cases give
    it, (B, T', key lengths) from each case's own batch: head-sharded, as
    dp1×tp2 runs it (110m B=8, Sortformer B=4), by `k1_heads_part`; whole
    heads through RelAttentionBlockFunction, as each dp2 rank (110m B=4,
    Sortformer B=2), the NCCL dp1 and single-device 110m steps (B=8) and
    each pipe2 microbatch (600m B=2) run it, by `k1_backward_part`."""
    import torch

    from parakeet_tpu_torch import config as C
    from parakeet_tpu_torch.models.encoder import encoded_lengths, subsample_length

    def geometry(batch, rows=slice(None)):
        t = subsample_length(int(batch["features"].shape[1]))
        lens = torch.clamp(encoded_lengths(torch.as_tensor(np.asarray(batch["mel_lengths"]))), max=t).numpy()
        return t, lens[rows]

    t110, l110 = geometry(batches["110m"])
    tsf, lsf = geometry(batches["sortformer"])
    t600, l600 = geometry(batches["600m"])
    half = MESH_600M_B // MESH_600M_MICRO
    enc6 = C.make_tdt_600m_config().encoder
    heads = [(8, t110, l110, "train_mesh 110m dp1×tp2"), (4, tsf, lsf, "train_mesh Sortformer dp1×tp2")]
    whole = [(8, t110, D, H, l110, "train_mesh 110m NCCL dp1 and one card"),
             *((4, t110, D, H, l110[r * 4:(r + 1) * 4], f"train_mesh 110m dp2 rank {r}") for r in range(2)),
             *((2, tsf, D, H, lsf[r * 2:(r + 1) * 2], f"train_mesh Sortformer dp2 rank {r}") for r in range(2)),
             *((half, t600, enc6.hidden_size, enc6.num_heads, l600[m * half:(m + 1) * half],
                f"train_mesh 600m pipe2 microbatch {m}") for m in range(MESH_600M_MICRO))]
    log(f"== train_mesh: K1 at its mesh shapes: head-sharded B=8 T'={t110} (lengths {l110.min()}-{l110.max()}) and "
        f"B=4 T'={tsf}; whole heads at {len(whole)} shapes")
    return {"k1_heads": k1_heads_part(card, heads, base=False), "k1": k1_backward_part(whole, card, base=False)}


def train_mesh_phase(card: str) -> dict:
    """Training on a mesh, on the one card: the single-device card steps
    (tdt-ctc-110m hybrid on the loader's batch of 8 clips, Sortformer-117m
    B=4 on 10 s, tdt-600m tdt with remat B=4) saved; two spawned gloo
    ranks run (i) dp2, dp1×tp2, dp1×sp2 (110m), (iii) Sortformer dp2 and
    dp1×tp2, (ii) dp1×pipe2 (600m, 2 microbatches); one NCCL rank (iv) a
    dp1 110m step; each case's loss and every gradient against the
    single-device step's, K1's launches a step a rank against
    `mesh_train_launches`, the step wall, the share inside the
    collectives and the peak memory a rank; then (v) both train CLIs under
    the launcher. Coverage on one card, not a scaling figure: both ranks
    share the card, and gloo stages every collective through host memory."""
    import shutil

    import torch
    import torch.distributed as dist

    from parakeet_tpu_torch import config as C
    from parakeet_tpu_torch.config import AudioConfig
    from parakeet_tpu_torch.data import ManifestDataset, TrainDataLoader
    from parakeet_tpu_torch.ops.layers import require_ieee_f32
    from parakeet_tpu_torch.parallel.launch import spawn_ranks
    from parakeet_tpu_torch.text.tokenizer import Tokenizer
    from parakeet_tpu_torch.train import synthetic_batch, synthetic_sortformer_batch

    require_ieee_f32()
    t0 = time.perf_counter()
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    MESH_DIR.mkdir(parents=True)
    manifest = train_corpus(MESH_DIR / "asr", 8, seed=2024, min_s=2.0, max_s=12.0)
    loader = TrainDataLoader(ManifestDataset(manifest), Tokenizer(smoke_vocab(1025)), batch_size=8,
                             audio_config=AudioConfig(n_mels=80), shuffle=False, device="cpu")
    batch = next(iter(loader))
    del loader
    log(f"== train_mesh: the loader's batch of 8 clips: features {tuple(batch['features'].shape)}, labels "
        f"{tuple(batch['labels'].shape)}")
    files = {"batch": MESH_DIR / "batch110m.pt", "batch600m": MESH_DIR / "batch600m.pt",
             **{m: MESH_DIR / f"ref_{m}.pt" for m in ("tdt-ctc-110m", "sortformer-117m", "tdt-600m")}}
    torch.save(batch, files["batch"])
    b600 = {k: torch.from_numpy(v) for k, v in synthetic_batch(C.make_tdt_600m_config(), MESH_600M_B, mel_frames=1000,
                                                                 max_labels=40, seed=5).items()}
    torch.save(b600, files["batch600m"])
    sf_batch = synthetic_sortformer_batch(C.make_sortformer_117m_config(), 4, 1000, seed=5)
    single = {"tdt-ctc-110m": single_train_reference("tdt-ctc-110m", batch, files["tdt-ctc-110m"], card),
              "sortformer-117m": single_train_reference("sortformer-117m", sf_batch, files["sortformer-117m"], card),
              "tdt-600m": single_train_reference("tdt-600m", b600, files["tdt-600m"], card, remat=True)}
    log(f"  (references saved, {time.perf_counter() - t0:.1f} s into the phase)")
    out = {"single": single, **train_mesh_k1_part({"110m": batch, "sortformer": sf_batch, "600m": b600}, card)}

    cli = train_mesh_cli_start()  # (v)'s first round runs beside the gloo cases
    t1 = time.perf_counter()
    ranks = spawn_ranks(train_mesh_rank, 2, {k: str(v) for k, v in files.items()}, backend="gloo", timeout=900,
                        threads=0)
    log(f"  two gloo ranks on the card: {time.perf_counter() - t1:.1f} s")
    # (iv) in this process: a world of one needs no second process, and a spawned rank's start-up cost ~20 s
    t1 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{MESH_DIR / 'nccl_rdzv'}", world_size=1, rank=0)
    try:
        nccl = nccl_train_rank(0, {k: str(v) for k, v in files.items()})
    finally:
        dist.destroy_process_group()
    log(f"  one NCCL rank (this process): {time.perf_counter() - t1:.1f} s")

    layers = {"tdt-ctc-110m": 17, "sortformer-117m": 17, "tdt-600m": 24}
    runs = [(f"rank {r} {name}", name, res[name]) for r, res in enumerate(ranks) for name in res]
    runs.append(("NCCL rank dp1", "nccl dp1", nccl))
    out["cases"] = {}
    for tag, name, res in runs:
        model = "sortformer-117m" if "sortformer" in name else "tdt-600m" if "pipe" in name else "tdt-ctc-110m"
        want = mesh_train_launches(name, layers[model], 2 if "pipe" in name else 1, MESH_600M_MICRO)
        if res["launches"] != want:
            raise RuntimeError(f"train_mesh {tag}: launches a step {res['launches']}, want {want}")
        c, g = res["collectives"], res["grads"]
        inside = c["gloo_ms"] + c["staging_ms"]
        fault = res.get("fault")
        log(f"  {tag} ({res['shape']}): loss {res['loss']:.6f} ({res['loss_rel']:.1e} from the single-device card "
            f"step's), gradients of {g['keys']} keys within {g['worst']:.2e} of each key's max |g| ({g['worst_key']}); "
            f"against each key's limit (the larger of {MESH_GRAD_FRAC:g} and {MESH_SPREAD_K:g}× its spread) at most "
            + ", ".join(f"{o:.2f} ({k}: {f:.2e} of limit {lim:.2e})" for o, f, lim, k in g["over"])
            + f"; {len(g['wide'])} keys' limits above {MESH_GRAD_FRAC:g}, the widest "
            + (f"{g['wide'][-1][0]:.2e} ({g['wide'][-1][1]})" if g["wide"] else "none")
            + f"; zero up to rounding, left out: {key_patterns(g['left_out'])}"
            + (f"; the rank's unreduced gradients (a missing reduction) past their limit in {fault['caught']} of "
               f"{fault['keys']} keys, median {fault['median']:.2e}, worst {fault['worst']:.2e}" if fault else "")
            + f"); K1 a step {want or 'none'}; step wall {res['step_ms']:.1f} ms "
            f"(single device {single[model]['step_ms']:.1f}), peak {res['peak_gb']:.2f} GB; with the collective "
            f"clock on: wall {c['wall_ms']:.1f} ms, {c['calls']} calls {c['gloo_ms']:.1f} ms + staging "
            f"{c['staging_ms']:.1f} ms = {inside / c['wall_ms']:.1%} of the wall [{card}] ({res['seconds']:.1f} s)")
        out["cases"].setdefault(name, []).append({k: v for k, v in res.items() if k != "grads"}
                                                 | {"worst": g["worst"], "over": g["over"][0][0]})
    out["cli"] = train_mesh_cli_part(cli)
    # K1's launches a step a rank on each mesh trainer, as counted in the runs above
    out["launches"] = {name: cases[0]["launches"] for name, cases in out["cases"].items()}
    return out


def bf16_encoder_phase(model: str, fused, flat, clips, card: str) -> dict:
    """The whole-block configuration's encoder in bf16 beside f32 on the
    card: device ms of each (torch.profiler, best of 2 turns), K7's and K4's
    launches per bf16 encoder call, and the bf16 encoder's largest
    difference from f32 over the valid frames as a share of the f32
    output's scale."""
    import torch

    from parakeet_tpu_torch.audio.frontend import preprocess_audio_batch
    from parakeet_tpu_torch.models.encoder import encoded_lengths

    f32 = facade(model, "cuda", params=flat, fused=fused)
    b16 = facade(model, "cuda", params=flat, fused=fused, compute_dtype="bfloat16")
    feats, n_frames = preprocess_audio_batch(clips, f32._audio_cfg, "cpu")
    feats = feats.to("cuda")
    with torch.inference_mode():
        e32 = f32.encode(feats, n_frames).float()
        reset_counts()
        e16 = b16.encode(feats, n_frames).float()
        counts = read_counts()
        dev = {"f32": [], "bf16": []}
        for _ in range(2):
            dev["f32"].append(device_ms(lambda: f32.encode(feats, n_frames), calls=3))
            dev["bf16"].append(device_ms(lambda: b16.encode(feats, n_frames), calls=3))
    lens = encoded_lengths(torch.as_tensor(n_frames)).tolist()
    diff = max(float((e16[i, :n] - e32[i, :n]).abs().max()) for i, n in enumerate(lens))
    scale = max(float(e32[i, :n].abs().max()) for i, n in enumerate(lens))
    if not torch.isfinite(e16).all():
        raise RuntimeError(f"{model} bf16 whole-block encoder: output not finite")
    f32_ms, b16_ms = min(dev["f32"]), min(dev["bf16"])
    log(f"== {model} whole-block encoder, bf16 beside f32: device {b16_ms:.3f} vs {f32_ms:.3f} ms (best of 2 "
        f"turns); K7 {counts['fused_ffn_attention']} and K4 {counts['fused_conv_ffn_final']} launches per bf16 "
        f"encoder call; bf16 - f32 max |diff| {diff:.4f} = {diff / scale:.2%} of the f32 scale {scale:.3f} [{card}]")
    return {"bf16_ms": b16_ms, "f32_ms": f32_ms, "launches": counts, "delta_share": diff / scale}


def build_phase() -> None:
    """Every CUDA library (nvcc) and the host libraries (g++), each from
    its source under parakeet_tpu_torch/csrc/, all started together."""
    from parakeet_tpu_torch import native
    from parakeet_tpu_torch.audio import codecs
    from parakeet_tpu_torch.ops import _build

    def timed(job):
        name, build, suffix = job
        t0 = time.perf_counter()
        build(name)
        return f"{name}{suffix}", time.perf_counter() - t0

    jobs = [(name, _build.build, ".cu") for name in LIBRARIES] + [(name, _build.build_host, ".cpp")
                                                                   for name in HOST_LIBRARIES]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as ex:
        done = list(ex.map(timed, jobs))
    log(f"== build: {len(done)} libraries in parallel from {_build._CSRC.relative_to(ROOT)}, "
        f"{time.perf_counter() - t0:.1f} s wall: " + ", ".join(f"{name} {s:.1f} s" for name, s in done))
    for name in LIBRARIES:
        _build.load(name)
    # what ptxas made of the Hopper GEMM and K2's cores (no ncu on this machine)
    for name, kernels in (("ffn_attention", ("hopper_gemm_kernel",)), ("conv_ffn_final", ("hopper_gemm_kernel",)),
                          ("feed_forward", ("hopper_gemm_kernel",)), ("conv_module", ("hopper_gemm_kernel",)),
                          ("rel_attention_v1", ("rel_attn_v1_wgmma_kernel", "rel_attn_f32_kernelILi32ELb1",
                                                "rel_attn_f32_kernelILi64ELb1", "rel_attn_f32_kernelILi128ELb1"))):
        lines = _build.BUILD_LOG.get(name, "").splitlines()
        for i, line in enumerate(lines):
            kernel = next((k for k in kernels if "Compiling entry" in line and k in line), None)
            if kernel is not None:
                usage = [x.split(":", 1)[-1].strip() for x in lines[i + 1:i + 4] if "Used" in x or "spill" in x]
                log(f"  ptxas {name}: {kernel}{line.split(kernel, 1)[1].split('EEEv')[0].split('EEv')[0]}: "
                    + "; ".join(usage[:2]))
            elif "warning" in line.lower():
                log(f"  ptxas {name}: {line.strip()}")
    if not (native.available() and codecs.flac_available()):
        raise RuntimeError("build: the host libraries built but did not load")


PHASES = ("kernels", "kernels600m", "paths110m", "serve", "lookahead", "paths600m", "long", "streaming", "diarize",
          "options", "train", "mesh", "train_mesh")
OPT_IN = ("v1",)  # phases only a --phases list runs


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ", ".join(PHASES + OPT_IN) + " (the default runs all but "
                         + ", ".join(OPT_IN) + " and prints the result lines; a subset prints no result)")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    if set(phases) - set(PHASES) - set(OPT_IN):
        raise SystemExit(f"chip_smoke: unknown phases {sorted(set(phases) - set(PHASES) - set(OPT_IN))}")
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
    paths = {}
    with ThreadPoolExecutor(1) as pool:
        building = pool.submit(build_phase)
        # while nvcc runs: the 110m weights drawn, and written and loaded onto the card through load_params
        if "paths110m" in phases or "serve" in phases or "lookahead" in phases:
            flat = model_params("tdt-ctc-110m")
        if "paths110m" in phases:
            paths["weights"] = timed("weights", weights_phase, flat, card)
        timed("build", building.result)

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
        timed("K7 and K4 edge shapes", edge_shapes_phase, card)
    if "kernels600m" in phases:
        for name, k6 in timed("kernels at 600m shapes", kernels_600m_phase, card).items():
            k = kernel.setdefault(name, {"max_abs_err": 0.0})
            k["max_abs_err"] = max(k["max_abs_err"], k6["max_abs_err"])
            for key in ("times", "bf16_times", "work", "bf16_work", "redesign", "k1_core", "designs"):
                k.setdefault(key, {}).update(k6.get(key, {}))

    clips = synthetic_clips(8, seed=1234)
    log(f"== clips: 8, {', '.join(f'{len(c) / 16000:.2f}' for c in clips)} s "
        f"({sum(len(c) for c in clips) / 16000.0:.2f} s audio)")
    fused_cfg = FusedLayers(ffn=True, conv=True, subsample=True)
    whole_cfg = FusedLayers(attention="mega", block2=True, subsample=True)
    v1_cfg = FusedLayers(attention="v1")
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
        paths["whole_bf16"] = timed("whole-block bf16 encoder", bf16_encoder_phase, "tdt-ctc-110m", whole_cfg,
                                    flat, clips, card)
        paths["frontend"] = timed("path fused frontend", fused_frontend_phase, flat, clips, card)
        timed("bf16", bf16_phase, fused_cfg, flat, clips, fused["tdt"])
    if "serve" in phases:
        paths["serve"] = timed("serve", serve_phase, flat, clips, card)
        torch.cuda.empty_cache()
        k1 = kernel.setdefault("rel_attention_block", {"max_abs_err": 0.0})
        k1["max_abs_err"] = max(k1["max_abs_err"], paths["serve"]["k1"]["max_abs_err"])
        for key in ("times", "work"):
            k1.setdefault(key, {}).update(paths["serve"]["k1"][key])
    if "lookahead" in phases:
        paths["lookahead"] = {"tdt-ctc-110m": timed("lookahead tdt-ctc-110m", lookahead_phase, "tdt-ctc-110m", flat,
                                                    clips, card, extras=True)}
        torch.cuda.empty_cache()
    if "paths110m" in phases or "serve" in phases or "lookahead" in phases:
        del flat
    if "paths600m" in phases or "long" in phases or "options" in phases or "lookahead" in phases:
        t0 = time.perf_counter()
        flat6 = model_params("tdt-600m")
        log(f"== tdt-600m weights: {sum(a.size for a in flat6.values()) / 1e6:.1f} M parameters, "
            f"{time.perf_counter() - t0:.1f} s to draw")
        if "paths600m" in phases:
            # held to the CPU on the 4 clips under 6 s (the CPU's 600m runs set the phase's time)
            for label, cfg in (("default", FusedLayers()), ("fused", fused_cfg), ("whole-block", whole_cfg),
                               ("v1", v1_cfg)):
                paths[f"tdt-600m {label}"] = timed(f"path tdt-600m {label}", path_phase, f"tdt-600m {label}", cfg,
                                                   flat6, clips, card, model="tdt-600m",
                                                   compare_clips=short_clips(clips))
            paths["tdt-600m whole_bf16"] = timed("tdt-600m whole-block bf16 encoder", bf16_encoder_phase, "tdt-600m",
                                                 whole_cfg, flat6, clips, card)
        if "lookahead" in phases:
            paths["lookahead"]["tdt-600m"] = timed("lookahead tdt-600m", lookahead_phase, "tdt-600m", flat6, clips,
                                                   card)
            torch.cuda.empty_cache()
        if "long" in phases:
            paths["long"] = timed("long audio tdt-600m", long_audio_phase, flat6, card)
        if "options" in phases:
            paths["options"] = timed("options", options_phase, flat6, clips, card)
            torch.cuda.empty_cache()
        del flat6
        if "paths600m" in phases or "lookahead" in phases:
            flat6 = model_params("rnnt-600m")
            # the 4 clips under 6 s: random weights emit ~10 symbols a frame, so the decode loop runs as
            # long as the longest clip, and the CPU facade's RNNT decode of all 8 took 30-50 s a configuration
            for label, cfg in (("default", FusedLayers()), ("fused", fused_cfg)) if "paths600m" in phases else ():
                # no profile of the whole batch: at ~10 symbols a frame its trace takes ~12 s
                paths[f"rnnt-600m {label}"] = timed(f"path rnnt-600m {label}", path_phase, f"rnnt-600m {label}",
                                                    cfg, flat6, short_clips(clips), card, model="rnnt-600m",
                                                    profile_batch=False)
            if "lookahead" in phases:
                paths["lookahead"]["rnnt-600m"] = timed("lookahead rnnt-600m", lookahead_phase, "rnnt-600m", flat6,
                                                        short_clips(clips), card, windows=(8,))
                torch.cuda.empty_cache()
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
    if "train" in phases:
        paths["train"] = timed("train", train_phase, card)
        torch.cuda.empty_cache()
        k1 = kernel.setdefault("rel_attention_block", {"max_abs_err": 0.0})
        k1["max_abs_err"] = max(k1["max_abs_err"], paths["train"]["k1_backward"]["max_abs_err"])
        for key in ("times", "work"):
            k1.setdefault(key, {}).update(paths["train"]["k1_backward"][key])
    if "mesh" in phases:
        paths["mesh"] = timed("mesh", mesh_phase, clips, card)
        torch.cuda.empty_cache()
    if "train_mesh" in phases:
        paths["train_mesh"] = timed("train_mesh", train_mesh_phase, card)
        torch.cuda.empty_cache()
        k1 = kernel.setdefault("rel_attention_block", {"max_abs_err": 0.0})
        k1["max_abs_err"] = max(k1["max_abs_err"], paths["train_mesh"]["k1"]["max_abs_err"])
        for key in ("times", "work"):
            k1.setdefault(key, {}).update(paths["train_mesh"]["k1"][key])
    if "v1" in phases:
        paths["v1 encoders"] = timed("v1 encoders", v1_encoders_phase, card)
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
               # launches a step of each trainer (remat launches K1's forward again in backward)
               "launches_train": {trainer: per_step[name]
                                  for trainer, per_step in paths["train"]["launches_train"].items()},
               # launches a step a rank of each mesh trainer (phase train_mesh)
               "launches_train_mesh": {case: c.get(name, 0) for case, c in paths["train_mesh"]["launches"].items()},
               # the one encoder call under each model's decode loops (phase lookahead)
               "launches_lookahead": {m: r["launches"][name] for m, r in paths["lookahead"].items()},
               "max_abs_err": k["max_abs_err"], "ms": k["times"][t]["ms"],
               "plain_ms": k["times"][t]["plain_ms"], "dev_ms": k["times"][t]["dev_ms"],
               "plain_dev_ms": k["times"][t]["plain_dev_ms"],
               "bound_ms": f32_bound["bound_ms"], "bound_by": f32_bound["bound_by"],
               "bound_share": f32_bound["bound_ms"] / k["times"][t]["ms"],
               "gflop": f32_bound["gflop"], "mbyte": f32_bound["mbyte"],
               # no single PyTorch call computes any of these fused functions
               "library_ms": None, "shapes": []}
        if k.get("designs"):  # K2 in bf16: its two designs in turns, and K1's core stage at each shape
            row["designs"] = k["designs"]
            row["k1_core_ms"] = k["k1_core"]
        if "redesign" in k:  # K7 and K4: in turns with the old design, launches per call
            row["redesign"] = {shape: {"ms": r["ms"], "old_ms": r["old_ms"], "launches": r["launches"]}
                               for shape, r in k["redesign"].items()}
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
    # K1's head-sharded mode (tensor parallelism over heads, phase mesh):
    # one rank's 4 of 8 heads at B=8, T'=126 (and under "shapes" D=1024 and
    # dp1×tp2's shape on the clips, and the train_mesh dp1×tp2 shapes);
    # launches a TDT batch per rank on dp1×tp2 (two ranks sharing the card
    # over gloo)
    kh, mesh, tm = paths["mesh"]["k1"], paths["mesh"], paths["train_mesh"]["k1_heads"]
    kh["max_abs_err"] = max(kh["max_abs_err"], tm["max_abs_err"])
    for key in ("times", "work", "bf16_times", "bf16_work"):
        kh[key].update(tm[key])
    hb = bound(*kh["work"][D])
    hb16 = bound(*kh["bf16_work"][D], BF16_PEAK)
    rows.append({"name": "rel_attention_block_heads", "route": "cuda",
                 "source": "parakeet_tpu_torch/csrc/rel_attention.cu",
                 "replaces": "parakeet_tpu/ops/pallas_attention.py:510",
                 "launches": mesh["launches_heads"]["rel_attention_block_heads"],
                 "launches_mesh": {run: c["rel_attention_block_heads"] for run, c in mesh["launches"].items()},
                 "launches_train_mesh": {case: c.get("rel_attention_block_heads", 0)
                                         for case, c in paths["train_mesh"]["launches"].items()},
                 "max_abs_err": kh["max_abs_err"], "ms": kh["times"][D]["ms"], "plain_ms": kh["times"][D]["plain_ms"],
                 "dev_ms": kh["times"][D]["dev_ms"], "plain_dev_ms": kh["times"][D]["plain_dev_ms"],
                 "bound_ms": hb["bound_ms"], "bound_by": hb["bound_by"],
                 "bound_share": hb["bound_ms"] / kh["times"][D]["ms"], "gflop": hb["gflop"], "mbyte": hb["mbyte"],
                 "library_ms": None,
                 "bf16_ms": kh["bf16_times"][D]["ms"], "bf16_plain_ms": kh["bf16_times"][D]["plain_ms"],
                 "bf16_bound_ms": hb16["bound_ms"], "bf16_bound_by": hb16["bound_by"],
                 "shapes": [dict(shape=shape, dtype=dtype, ms=ms["ms"], plain_ms=ms["plain_ms"], dev_ms=ms["dev_ms"],
                                 plain_dev_ms=ms["plain_dev_ms"], bound_ms=bound(*kh[work][shape], peak)["bound_ms"],
                                 bound_by=bound(*kh[work][shape], peak)["bound_by"])
                            for dtype, times, work, peak in (("f32", "times", "work", F32_PEAK),
                                                             ("bf16", "bf16_times", "bf16_work", BF16_PEAK))
                            for shape, ms in kh[times].items()]})
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
