"""Offline batch transcription: a closed loop of back-to-back
`transcribe_batch` calls, as an archive job feeds the card.

Set-up draws the weights on the device, builds the facade the
configuration names (or the reference in its place: the control in the
precision below it, or the bf16 witness), synthesises the mix's pool of
clips, cuts it into the seed's batches and runs each batch once, which
builds the kernels on a checkout's first run and warms every shape the
window will use. The blank biases are set from the reference's scores of
a few clips (`emission_margins`); those seconds are the reference's, and
the run keeps them out of `setup_s` (`reference_s`). The
window then sends the batches round and round until `seconds` have passed.

The check recomputes, for the clips of the window's first call (a batch
the seed drew), the reference's log-mel, encoder frames and (CTC)
log-probs and compares the program's own tensors of that call with them;
and it judges every served transcript of that call, of a seeded sample of
the other calls and of the latest call that served the pool's longest
clip against the reference's best choices (reference/judge.py).
"""

from __future__ import annotations

import dataclasses
import itertools
import math
import time
import traceback
import typing
from contextlib import nullcontext

import torch

from port_bench import roofline as RF
from port_bench import traffic as TR
from port_bench import weights as W
from port_bench.probe import CallRecord, Probe
from port_bench.reference import judge
from port_bench.reference import torch_ref as R
from port_bench.reference.pipeline import Control, Reference

MARGIN_CLIPS = 8  # clips of the seed's first batch that set the blank offsets
TRACE_FROM = 0.4  # the traced stretch starts at this share of the window ...
TRACE_S = 1.5  # ... and closes after the call that passes this many seconds
EXTRA_JUDGED = 16  # served clips judged beyond the compared call's


def emission_margins(conf: dict, params: dict, clips, blank: int, joint_prefix: str, device, keys) -> tuple:
    """{bias key: margin of the best token over the blank on each frame of
    `clips`} as the reference scores them (float32 `params`, no blank
    offset yet): the TDT label head at the decode's start state (blank fed
    once), the CTC head as it is; and the reference's encoder frames."""
    ref = Reference(params, conf["config"], conf["audio"], device)
    pad = max(len(c) for c in clips) // ref.frontend.hop + 1
    with torch.no_grad():
        encs = [ref.encode(ref.mel(c), pad) for c in clips]
        frames = torch.cat(encs)
        lstm, _, _ = R.prediction_lstm(params)
        start, _ = lstm(params["prediction_.embed_.weight"][blank][None, None])
        out = {}
        for key in keys:
            if key.startswith(joint_prefix):
                lp, _ = R.joint(params, frames, start[0].expand(len(frames), -1), joint_prefix)
            else:
                lp = R.ctc_log_probs(params, frames[None])[0]
            out[key] = lp[:, :blank].max(dim=-1).values - lp[:, blank]
    return out, encs


def build_config(cls, numbers: dict):
    """A (nested) config dataclass of the program from the file's numbers."""
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in numbers:
            v, t = numbers[f.name], hints[f.name]
            kw[f.name] = build_config(t, v) if dataclasses.is_dataclass(t) else (tuple(v) if isinstance(v, list) else v)
    return cls(**kw)


class Offline:
    def __init__(self, cell, seed: int, device, *, system: str = "program", trace: bool = False, log=print):
        self.seed, self.device, self.log = seed, torch.device(device), log
        self.conf, self.mix = cell.config, cell.traffic
        self.system_kind, self.trace = system, trace

    # ── set-up ───────────────────────────────────────────────────────────

    def setup(self) -> None:
        from parakeet_tpu_torch import config as C
        from parakeet_tpu_torch import params as P
        from parakeet_tpu_torch import transcribe as T

        conf, mix = self.conf, self.mix
        facade_cls = getattr(T, conf["facade"])
        cfg = build_config(getattr(C, conf["config_class"]), conf["config"])
        if conf.get("preset") and getattr(C, conf["preset"])() != cfg:
            raise ValueError(f"{conf['name']}: the file's config is not the program's {conf['preset']}()")
        self.blank = cfg.joint.vocab_size - 1
        self.joint_prefix = facade_cls.joint_prefix
        dtype = getattr(torch, conf["compute_dtype"])
        self.pool = TR.make_pool(mix, self.seed, self.device)
        self.batches = TR.batches(mix, self.seed)
        self.weights = W.make_weights(getattr(P, conf["spec"])(cfg), self.seed, self.device, dtype, self.blank,
                                      conf["assumed"])
        shares = conf["assumed"]["emitting_share"]
        clips = [self.pool[c] for c in self.batches[0][:MARGIN_CLIPS]]
        t0 = time.perf_counter()
        margins, _ = emission_margins(conf, self.reference_params(), clips, self.blank, self.joint_prefix,
                                      self.device, shares)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.reference_s = time.perf_counter() - t0  # the reference's own seconds, kept out of setup_s
        for key, offset in W.blank_offsets(margins, shares).items():
            self.weights[key][self.blank] += offset
        if self.system_kind == "program":
            self.system = facade_cls(config=cfg, params=W.host_copy(self.weights), compute_dtype=conf["compute_dtype"],
                                     device=self.device)
            self.system.tokenizer.load_pieces(W.vocab_pieces(cfg.joint.vocab_size))
        else:  # "control" (fp8) or "witness" (bf16): the reference in the program's place
            self.system = Control(self.reference_params(), conf["config"], conf["audio"], self.device,
                                  decoder=mix["decoder"], joint_prefix=self.joint_prefix, blank=self.blank,
                                  precision="fp8" if self.system_kind == "control" else "bf16")
        self.opts = T.TranscribeOptions(decoder=T.Decoder(mix["decoder"]), timestamps=mix["timestamps"])
        self.probe = Probe(self.trace)
        self.probe.keep_call = 0  # the window's first call: its batch is the seed's first draw
        self.probe.install(self.system, self.system_kind == "program")

    def reference_params(self) -> dict:
        return {k: v.to(torch.float32) for k, v in self.weights.items()}

    def warm(self) -> None:
        """Every batch once: the window's shapes, no others."""
        for clips in self.batches:
            self.system.transcribe_batch([self.pool[c] for c in clips], self.opts)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # ── the window ───────────────────────────────────────────────────────

    def window(self, seconds: float, trace_window=None, min_calls: int = 1):
        """Back-to-back calls until `seconds` have passed and `min_calls`
        (at least the compared first one) are done; with `trace_window` (a
        devtrace.TraceWindow) the profiler covers a short stretch from
        TRACE_FROM of the window. Returns (calls, window start, trace
        summary or None)."""
        calls: list[CallRecord] = []
        traced_from, traced = None, False
        order = itertools.cycle(range(len(self.batches)))
        t_start = time.perf_counter()
        for i in itertools.count():
            now = time.perf_counter()
            if now - t_start >= seconds and len(calls) >= min_calls and (trace_window is None or traced):
                break
            b = next(order)
            clips = self.batches[b]
            rec = CallRecord(i, b, clips, sum(len(self.pool[c]) for c in clips) / TR.SAMPLE_RATE)
            if trace_window is not None and traced_from is None and now - t_start >= TRACE_FROM * seconds:
                trace_window.start()
                traced_from = now
            rec.profiled = traced_from is not None and not traced
            self.probe.call = rec
            rec.t0 = time.perf_counter()
            try:
                with torch.profiler.record_function("port_bench.call") if self.trace else nullcontext():
                    rec.results = self.system.transcribe_batch([self.pool[c] for c in clips], self.opts)
            except Exception:  # the run goes on; a failed call counts its clips as failed
                rec.error = traceback.format_exc()
                self.log(f"call {i} failed:\n{rec.error}")
            rec.t1 = time.perf_counter()
            self.probe.call = None
            calls.append(rec)
            if rec.profiled and rec.t1 - traced_from >= TRACE_S:
                trace_window.stop()
                traced = True
        return calls, t_start, trace_window.summarize() if traced else None

    def release(self) -> None:
        """Free the system under test (the compared tensors stay)."""
        self.probe.uninstall()
        self.system = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ── the check ────────────────────────────────────────────────────────

    @staticmethod
    def failed(rec: CallRecord) -> bool:
        return rec.error is not None or rec.results is None or len(rec.results) != len(rec.clips)

    def emissions(self, rec: CallRecord, j: int):
        """The served transcript of clip j of a call, as (token, start, end)
        emissions: the result's own timestamps, or the decode layer's frames
        beside the served tokens; None when they do not pair up."""
        res = rec.results[j]
        if self.opts.timestamps or not rec.decoded:
            return [(t.token_id, t.start_frame, t.end_frame) for t in res.timestamped_tokens]
        if len(rec.decoded) != len(rec.clips) or len(rec.decoded[j]) != len(res.token_ids):
            return None
        frames = rec.decoded[j]
        return [(tok, t.start_frame, t.end_frame) for tok, t in zip(res.token_ids, frames)]

    def judged(self, calls: list[CallRecord]) -> list[tuple[CallRecord, int]]:
        """(call, clip position) of every served transcript to judge."""
        done = [r for r in calls if not self.failed(r)]
        kept = [r for r in done if r.index == self.probe.keep_call]
        out = [(r, j) for r in kept for j in range(len(r.clips))]
        others = [(r, j) for r in done if r.index != self.probe.keep_call for j in range(len(r.clips))]
        rng = TR.rng_for(self.seed, 4)
        for k in rng.choice(len(others), size=min(EXTRA_JUDGED, len(others)), replace=False):
            out.append(others[int(k)])
        longest = max(range(len(self.pool)), key=lambda c: len(self.pool[c]))
        serving = [(r, r.clips.index(longest)) for r in done if longest in r.clips]
        if serving:
            out.append(serving[-1])
        return out

    def check(self, calls: list[CallRecord]) -> dict:
        """The compared numbers of the run (a missing one reads None)."""
        ctc = self.mix["decoder"] == "ctc"
        ref = Reference(self.reference_params(), self.conf["config"], self.conf["audio"], self.device)
        pad = {c: max(len(self.pool[x]) for x in clips) // ref.frontend.hop + 1
               for clips in self.batches for c in clips}
        cache: dict[int, tuple] = {}

        def reference(c):
            if c not in cache:
                mel = ref.mel(self.pool[c])
                enc = ref.encode(mel, pad[c])
                cache[c] = (mel, enc, ref.ctc_log_probs(enc) if ctc else None)
            return cache[c]

        out = {}
        kept = self.probe.kept
        rec = next((r for r in calls if r.index == self.probe.keep_call and not self.failed(r)), None)

        def widest(key: str, gap) -> float | None:
            """The widest gap(got, reference) over the compared call's clips;
            None when the program's tensor is missing or short of rows."""
            got = kept.get(key)
            if rec is None or got is None or got.shape[0] != len(rec.clips):
                return None
            return max(gap(got[j], *reference(c)) for j, c in enumerate(rec.clips))

        out["mel_err"] = widest("feats", lambda got, mel, enc, lp: float(
            (got[: mel.shape[0]].double() - mel).abs().max()))
        out["enc_err"] = widest("enc", lambda got, mel, enc, lp: float(
            (got[: enc.shape[0]].double() - enc.double()).norm() / enc.double().norm()))
        if ctc:
            out["ctc_lp_err"] = widest("log_probs", lambda got, mel, enc, lp: float(
                (got[: lp.shape[0]].double() - lp.double()).pow(2).mean().sqrt()))
        gaps = []
        for r, j in self.judged(calls):
            c = r.clips[j]
            _, enc, lp = reference(c)
            if ctc:
                gaps.append(judge.ctc_gap(lp.double().cpu().numpy(), r.results[j].token_ids, self.blank))
                continue
            em = self.emissions(r, j)
            gaps.append(judge.UNREACHABLE if em is None else judge.tdt_gap(
                ref.params, enc, em, blank=self.blank, durations=self.conf["config"]["durations"],
                joint_prefix=self.joint_prefix))
        out["token_gap"] = max(gaps) if gaps and rec is not None else None
        return out

    def tokens_per_audio_s(self, calls: list[CallRecord]) -> float:
        done = [r for r in calls if not self.failed(r)]
        toks = sum(len(res.token_ids) for r in done for res in r.results)
        audio = sum(r.audio_s for r in done)
        return toks / audio if audio else math.nan

    def flops(self, rec: CallRecord) -> float:
        """Model FLOPs a call's valid frames need (roofline.py): the
        encoder at each clip's own length, then the CTC head, or the joint
        with the prediction net for the decode steps taken (each emission,
        and the fewest blank steps that cover the frames from the end of one
        emission to the start of the next)."""
        cfg, hop = self.conf["config"], self.conf["audio"]["hop_length"]
        max_adv = max(max(cfg["durations"]), 1)
        frames = [len(self.pool[c]) // hop + 1 for c in rec.clips]
        total = RF.encoder_flops(cfg["encoder"], frames)
        for j, n in enumerate(frames):
            t = RF.subsampled_length(n)
            if self.mix["decoder"] == "ctc":
                total += RF.ctc_flops(t, cfg["encoder"]["hidden_size"], cfg["ctc_vocab_size"])
                continue
            em = self.emissions(rec, j) or []
            pos, blanks = 0, 0
            for _, start, end in em:
                blanks += math.ceil(max(start - pos, 0) / max_adv)
                pos = max(pos, end + 1)
            blanks += math.ceil(max(t - pos, 0) / max_adv)
            total += RF.transducer_flops(cfg, t, len(em) + blanks)
        return total


Driver = Offline
