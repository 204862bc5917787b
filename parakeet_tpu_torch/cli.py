"""`parakeet` CLI of the port (port of parakeet_tpu/cli.py) — model-mode
dispatch mirroring the C++ binary (src/main.cpp:642-735): seven modes,
per-stage timings, the same flags. Run as `python -m parakeet_tpu_torch.cli`.

    parakeet <audio> --model tdt-ctc-110m --weights model.safetensors \
        --vocab vocab.txt [--ctc|--tdt] [--timestamps] \
        [--boost "phrase1,phrase2"] [--boost-score 5.0] [--latency 1] \
        [--sortformer-weights sf.safetensors] [--dtype bfloat16]

Differences from the C++ binary: `--gpu` is replaced by `--device
cuda|cpu` (default: the CUDA card) and `--dtype`; several audio files
decode as one batch.
"""

from __future__ import annotations

import argparse
import sys
import time


def _stage(label: str, t0: float) -> float:
    t1 = time.perf_counter()
    print(f"  {label}: {(t1 - t0) * 1e3:.1f} ms")
    return t1


def _write_subtitles(out_path, fmt, render, paths, results) -> None:
    """--srt/--vtt output: '-' = stdout; one input = exact file path;
    several inputs = directory of <input-stem>.<fmt> files."""
    import os

    if out_path == "-":
        for path, res in zip(paths, results):
            if len(paths) > 1:
                print(f"== {path}")
            sys.stdout.write(render(res.word_timestamps))
        return
    if len(paths) > 1:
        os.makedirs(out_path, exist_ok=True)
        stems = [os.path.splitext(os.path.basename(p))[0] for p in paths]
        # colliding stems (same basename in two dirs, or --features pseudo
        # names 'x.npy[i]' which all share one stem) get the input index
        # appended so no clip's subtitles silently overwrite another's
        dup = {s for s in stems if stems.count(s) > 1}
        stems = [f"{s}.{i}" if s in dup else s for i, s in enumerate(stems)]
        for stem, res in zip(stems, results):
            target = os.path.join(out_path, f"{stem}.{fmt}")
            with open(target, "w", encoding="utf-8") as f:
                f.write(render(res.word_timestamps))
            print(f"  wrote {target}", file=sys.stderr)
    else:
        with open(out_path, "w", encoding="utf-8") as f:
            f.write(render(results[0].word_timestamps))
        print(f"  wrote {out_path}", file=sys.stderr)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="parakeet", description=__doc__)
    ap.add_argument("audio", nargs="*", help="audio file(s): wav/flac/mp3/ogg "
                                             "(omit when using --features)")
    ap.add_argument("--model", default="tdt-ctc-110m",
                    choices=["tdt-ctc-110m", "tdt-600m", "rnnt-600m", "eou-120m",
                             "nemotron-600m", "sortformer", "diarized"])
    ap.add_argument("--weights", default="models/model.safetensors")
    ap.add_argument("--vocab", default="models/vocab.txt")
    ap.add_argument("--sortformer-weights", default="models/sortformer.safetensors")
    ap.add_argument("--ctc", action="store_true", help="use CTC head (tdt-ctc only)")
    ap.add_argument("--tdt", action="store_true", help="use TDT head (default)")
    # NOTE: --timestamps must stay a plain flag (nargs='?' makes argparse
    # swallow a following positional audio path as the mode value)
    ap.add_argument("--timestamps", action="store_true",
                    help="emit word timestamps")
    ap.add_argument("--timestamp-mode", default="words",
                    choices=["words", "sentences"],
                    help="timestamp grouping: words (default) or sentences "
                         "(merge at ./?/! — timestamp.cpp Sentences mode); "
                         "implies --timestamps")
    ap.add_argument("--srt", default=None, metavar="FILE",
                    help="write an SRT subtitle file (implies --timestamps; "
                         "'-' = stdout; with several inputs FILE is a "
                         "directory and files are named <input>.srt)")
    ap.add_argument("--vtt", default=None, metavar="FILE",
                    help="write a WebVTT subtitle file (same rules as --srt)")
    ap.add_argument("--boost", default="", help="comma-separated boost phrases")
    ap.add_argument("--boost-score", type=float, default=5.0)
    ap.add_argument("--beam-size", type=int, default=0,
                    help="beam width, 0 = greedy (CTC prefix beam with --ctc, "
                         "device-side transducer beam otherwise)")
    ap.add_argument("--vad", action="store_true",
                    help="energy VAD: transcribe only detected speech regions "
                         "(timestamps stay absolute)")
    ap.add_argument("--lm", default=None, metavar="ARPA",
                    help="ARPA n-gram LM over tokenizer pieces: shallow fusion "
                         "in the CTC beam, n-best rescoring in the transducer "
                         "beam (needs --beam-size > 0)")
    ap.add_argument("--lm-weight", type=float, default=0.5,
                    help="LM fusion/rescoring weight λ")
    ap.add_argument("--latency", type=int, default=0, choices=[0, 1, 6, 13],
                    help="nemotron latency mode (right-context frames)")
    ap.add_argument("--chunk-samples", type=int, default=2560,
                    help="streaming chunk size (samples; 2560 = 160 ms)")
    ap.add_argument("--features", default=None, metavar="NPY",
                    help="bypass audio loading: decode precomputed mel features "
                         "from a .npy file (reference --features flag)")
    ap.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    ap.add_argument("--quantize", default=None, choices=["int8", "int4"],
                    help="weight-only quantized inference (offline models): "
                         "int8 = per-channel scales, int4 = packed group-wise")
    ap.add_argument("--align", default=None, metavar="TEXT",
                    help="forced alignment: print word timings for this "
                         "known transcript instead of decoding (tdt-ctc "
                         "models; composes with --srt/--vtt)")
    ap.add_argument("--align-window", type=float, default=None, metavar="S",
                    help="window seconds for long-form --align (audio past "
                         "the ~4-5 min dense limit; overlap-stitched "
                         "windows, one Viterbi pass)")
    ap.add_argument("--progress", action="store_true",
                    help="print pipeline-stage progress to stderr "
                         "(load/preprocess/decode; offline models only)")
    ap.add_argument("--device", default=None, choices=[None, "cpu", "cuda"],
                    help="where the models run (default: the CUDA card)")
    ap.add_argument("--random-weights", action="store_true",
                    help="run with random-initialized weights (pipeline smoke test)")
    args = ap.parse_args(argv)
    if args.timestamp_mode != "words":
        args.timestamps = True  # --timestamp-mode implies --timestamps
    if args.srt or args.vtt:
        args.timestamps = True  # subtitle output needs word timestamps

    if args.features and args.audio:
        print("Error: pass either audio files or --features, not both", file=sys.stderr)
        return 1
    if args.align is not None and args.features:
        print("Error: --align aligns audio files, not --features", file=sys.stderr)
        return 1
    if args.align is not None:
        # decode-path flags don't apply to forced alignment — fail loudly
        # rather than let the user believe they took effect
        ignored = [name for name, on in (
            ("--vad", args.vad),
            ("--beam-size", args.beam_size > 0),
            ("--lm", bool(args.lm)),
            ("--boost", bool(args.boost.strip())),
        ) if on]
        if ignored:
            print(f"Error: {', '.join(ignored)} do not apply to --align "
                  "(forced alignment decodes nothing)", file=sys.stderr)
            return 1
    if not args.features and not args.audio:
        ap.error("audio file(s) required (or --features)")

    if args.random_weights:
        import os

        args.weights = None
        args.sortformer_weights = None
        if not os.path.isfile(args.vocab):
            args.vocab = None  # decode falls back to raw token ids
    else:
        import os

        for p, flag in ((args.weights, "--weights"),
                        (args.sortformer_weights, "--sortformer-weights")):
            # sortformer mode never loads the ASR weights; every other mode
            # needs --weights, and only sortformer/diarized need the
            # sortformer file
            if flag == "--weights":
                needed = args.model != "sortformer"
            else:
                needed = args.model in ("sortformer", "diarized")
            if needed and p and not os.path.isfile(p):
                print(
                    f"Error: {flag} file not found: {p}\n"
                    "Convert a NeMo checkpoint with scripts/convert_nemo.py, "
                    "or pass --random-weights for a pipeline smoke test.",
                    file=sys.stderr,
                )
                return 1

    from parakeet_tpu_torch.audio.io import read_audio
    from parakeet_tpu_torch.device import DEFAULT_DEVICE
    from parakeet_tpu_torch.transcribe import Decoder

    device = args.device or DEFAULT_DEVICE
    boost = [p.strip() for p in args.boost.split(",") if p.strip()]
    decoder = Decoder.CTC if args.ctc else Decoder.TDT
    kw = dict(compute_dtype=args.dtype, device=device)

    # offline-only flags must fail loudly on streaming/diarization modes —
    # silently ignoring them would let the user believe VAD/LM/beam applied
    if args.model not in ("tdt-ctc-110m", "tdt-600m", "rnnt-600m"):
        unsupported = [
            name for name, on in (
                ("--features", bool(args.features)),
                ("--vad", args.vad),
                ("--beam-size", args.beam_size > 0),
                ("--lm", bool(args.lm)),
                ("--boost", bool(boost)),
                ("--progress", args.progress),
                ("--srt", bool(args.srt)),
                ("--vtt", bool(args.vtt)),
                ("--quantize", bool(args.quantize)),
                ("--align", args.align is not None),
            ) if on
        ]
        if unsupported:
            print(
                f"Error: {', '.join(unsupported)} only supported for the "
                f"offline models (tdt-ctc-110m/tdt-600m/rnnt-600m), "
                f"not --model {args.model}",
                file=sys.stderr,
            )
            return 1

    if args.quantize:
        # guard above rejects --quantize for non-offline models, so kw is
        # only ever consumed by the offline facades here
        kw["quantize"] = args.quantize

    try:
        t0 = time.perf_counter()
        if args.model in ("tdt-ctc-110m", "tdt-600m", "rnnt-600m"):
            if args.model == "tdt-ctc-110m":
                from parakeet_tpu_torch.transcribe import Transcriber

                tr = Transcriber(args.weights, args.vocab, **kw)
            elif args.model == "tdt-600m":
                from parakeet_tpu_torch.transcribe import TDTTranscriber

                tr = TDTTranscriber(args.weights, args.vocab, **kw)
            else:
                from parakeet_tpu_torch.transcribe import RNNTTranscriber

                tr = RNNTTranscriber(args.weights, args.vocab, **kw)
            t0 = _stage("model load", t0)

            from parakeet_tpu_torch.transcribe import TranscribeOptions

            from parakeet_tpu_torch.decode.timestamp import TimestampMode

            lm = None
            if args.lm:
                if args.beam_size <= 0:
                    raise SystemExit("--lm needs --beam-size > 0")
                from parakeet_tpu_torch.text.ngram_lm import NgramLM

                lm = NgramLM.from_arpa(args.lm).bind(tr.tokenizer.pieces)
            on_progress = None
            if args.progress:
                def on_progress(stage, done, total):
                    print(f"[progress] {stage} {done}/{total}", file=sys.stderr)
            opts = TranscribeOptions(
                decoder,
                args.timestamps,
                boost,
                args.boost_score,
                TimestampMode(args.timestamp_mode),
                beam_size=args.beam_size,
                lm=lm,
                lm_weight=args.lm_weight,
                on_progress=on_progress,
            )
            if args.align is not None:
                # forced alignment: word timings for a KNOWN transcript
                # (one padded batch = one compile, like transcribe_batch)
                mode = TimestampMode(args.timestamp_mode)
                if args.align_window:
                    results = [tr.align_long(a, args.align,
                                             window_s=args.align_window,
                                             timestamp_mode=mode)
                               for a in args.audio]
                else:
                    results = tr.align_batch(
                        args.audio, [args.align] * len(args.audio),
                        timestamp_mode=mode)
                args.timestamps = True  # spans are the whole point
            elif args.features:
                import numpy as _np

                out = tr.transcribe_features(_np.load(args.features), opts)
                results = out if isinstance(out, list) else [out]
                args.audio = [f"{args.features}[{i}]" for i in range(len(results))]
            elif args.vad:
                # full opts ride along so --beam-size/--lm apply under --vad
                results = [tr.transcribe_vad(a, decoder, opts=opts) for a in args.audio]
            else:
                results = tr.transcribe_batch(args.audio, opts)
            t0 = _stage("transcribe", t0)
            for path, res in zip(args.audio, results):
                if len(args.audio) > 1:
                    print(f"\n== {path}")
                print(res.text if res.text else f"(token ids) {res.token_ids}")
                if args.timestamps:
                    for w in res.word_timestamps:
                        print(f"  [{w.start:6.2f} - {w.end:6.2f}] ({w.confidence:.2f}) {w.word}")
            if args.srt or args.vtt:
                from parakeet_tpu_torch.text.subtitles import format_srt, format_vtt

                for out_path, fmt, render in (
                    (args.srt, "srt", format_srt), (args.vtt, "vtt", format_vtt)
                ):
                    if out_path:
                        _write_subtitles(out_path, fmt, render, args.audio, results)

        elif args.model in ("eou-120m", "nemotron-600m"):
            if args.model == "eou-120m":
                from parakeet_tpu_torch.streaming import StreamingTranscriber

                st = StreamingTranscriber(args.weights, args.vocab, **kw)
            else:
                from parakeet_tpu_torch.config import make_nemotron_600m_config
                from parakeet_tpu_torch.streaming import NemotronTranscriber

                st = NemotronTranscriber(
                    args.weights, args.vocab, make_nemotron_600m_config(args.latency), **kw
                )
            t0 = _stage("model load", t0)
            for path in args.audio:
                audio = read_audio(path)
                st.reset()
                n = args.chunk_samples
                for s in range(0, len(audio.samples), n):
                    delta = st.transcribe_chunk(audio.samples[s : s + n])
                    if delta:
                        print(delta, end=" ", flush=True)
                print()
                if args.timestamps:
                    for t in st.get_timestamped_tokens():
                        print(f"  tok {t.token_id} [{t.start_frame}-{t.end_frame}] {t.confidence:.2f}")
            t0 = _stage("stream", t0)

        elif args.model == "sortformer":
            from parakeet_tpu_torch.audio.frontend import preprocess_audio
            from parakeet_tpu_torch.config import AudioConfig
            from parakeet_tpu_torch.models.sortformer import Sortformer

            sf = Sortformer(args.sortformer_weights, device=device)
            t0 = _stage("model load", t0)
            for path in args.audio:
                audio = read_audio(path)
                feats = preprocess_audio(
                    audio.samples,
                    AudioConfig(n_mels=sf.config.nest_encoder.mel_bins, normalize=False),
                    device,
                )
                segments = sf.diarize(feats)
                t0 = _stage("diarize", t0)
                for seg in segments:
                    print(f"  speaker {seg.speaker_id}: {seg.start:.2f}s - {seg.end:.2f}s")

        elif args.model == "diarized":
            from parakeet_tpu_torch.diarize import DiarizedTranscriber

            dt = DiarizedTranscriber(args.weights, args.sortformer_weights, args.vocab,
                                     compute_dtype=args.dtype, device=device)
            t0 = _stage("model load", t0)
            for path in args.audio:
                res = dt.transcribe(path, decoder)
                t0 = _stage("transcribe+diarize", t0)
                print(res.text)
                for w in res.words:
                    spk = f"spk{w.speaker_id}" if w.speaker_id >= 0 else "----"
                    print(f"  [{w.start:6.2f} - {w.end:6.2f}] {spk}  {w.word}")

    except Exception as e:  # mirror reference: errors to stderr, exit 1 (main.cpp:729-732)
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
