"""The port's per-call record (parakeet_tpu_torch/trace.py) on the CPU, on a
toy facade: the spans' names and nesting, the counts against what they
count, results unchanged under a running profiler, the profiler's
annotations nested as the record says, nothing device-side off the
profiler, a pipelined service's records, the kept records' bound and the
stage means over the newest of them."""

import copy

import json
import threading

import numpy as np
import pytest
import torch

from parakeet_tpu_torch import config as TC
from parakeet_tpu_torch import trace
from parakeet_tpu_torch import transcribe as T
from parakeet_tpu_torch.decode.transducer import CHECK_EVERY
from parakeet_tpu_torch.models.encoder import encoded_lengths
from parakeet_tpu_torch.serve import TranscriptionService
from tests.test_torch_layers_bf16 import spy_products

PIECES = ["<unk>", "▁a", "b", "▁c", "d", ".", "▁e", "f"]  # + blank = vocab 9

# (name, parent's name) of every span a greedy call records, in opening order
TDT_TREE = [("batch", None), ("frontend", "batch"), ("frontend.load", "frontend"), ("frontend.host", "frontend"),
            ("frontend.copy", "frontend"), ("encoder", "batch"), ("decode", "batch"), ("decode.upload", "decode"),
            ("decode.loop", "decode")]
TDT_TAIL = [("decode.fetch", "decode"), ("decode.unpack", "decode"), ("results", "batch")]
CTC_TREE = TDT_TREE[:6] + [("ctc_head", "batch"), ("ctc_decode", "batch"), ("results", "batch")]


def _cfg(C):
    return C.TDTCTCConfig(
        encoder=C.EncoderConfig(mel_bins=80, subsampling_channels=8, hidden_size=32,
                                num_layers=2, num_heads=4, ffn_intermediate=64),
        prediction=C.PredictionConfig(vocab_size=9, pred_hidden=16, num_lstm_layers=1),
        joint=C.JointConfig(encoder_hidden=32, pred_hidden=16, joint_hidden=16, vocab_size=9),
        ctc_vocab_size=9,
    )


def _waves(rng):
    """Gated chirps: frame-to-frame variation a random model can tell apart."""
    out = []
    for n in (16000, 11000, 23456):
        t = np.arange(n) / 16000
        f = rng.uniform(100, 3000) * (1 + 2 * t)
        gate = (np.sin(2 * np.pi * rng.uniform(1, 4) * t) > 0).astype(np.float32)
        out.append((0.3 * gate * np.sin(2 * np.pi * f * t) + 0.02 * rng.randn(n)).astype(np.float32))
    return out


@pytest.fixture(scope="module")
def waves():
    return _waves(np.random.RandomState(6))


@pytest.fixture(scope="module")
def tr(tmp_path_factory):
    vocab = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    vocab.write_text("\n".join(f"{p}\t0" for p in PIECES), encoding="utf-8")
    return T.Transcriber(None, str(vocab), _cfg(TC), seed=6, device="cpu")


def _opts(decoder="TDT"):
    return T.TranscribeOptions(getattr(T.Decoder, decoder), timestamps=True)


def _spy_decode(monkeypatch):
    """The TransducerResults the facade's greedy decodes return."""
    got = []
    orig = T.transducer_greedy_decode

    def spy(*a, **kw):
        got.append(orig(*a, **kw))
        return got[-1]

    monkeypatch.setattr(T, "transducer_greedy_decode", spy)
    return got


def _tree(rec):
    return [(s.name, rec.spans[s.parent].name if s.parent >= 0 else None) for s in rec.spans]


def _served(results):
    return [[(t.token_id, t.start_frame, t.end_frame, t.confidence) for t in r.timestamped_tokens]
            for r in results]


@pytest.mark.parametrize("decoder", ["TDT", "CTC"])
def test_spans_nest_in_their_parents(tr, waves, monkeypatch, decoder):
    decoded = _spy_decode(monkeypatch)
    n = len(tr.traces)
    tr.transcribe_batch(waves, _opts(decoder))
    assert len(tr.traces) == n + 1
    rec = tr.traces[-1]
    if decoder == "TDT":
        checks = decoded[0].steps // CHECK_EVERY + 1
        assert _tree(rec) == TDT_TREE + [("decode.check", "decode.loop")] * checks + TDT_TAIL
    else:
        assert _tree(rec) == CTC_TREE
    assert rec.spans[0].parent == -1 and (rec.t0, rec.t1) == (rec.spans[0].t0, rec.spans[0].t1)
    for i, s in enumerate(rec.spans):
        assert s.t0 <= s.t1, s
        if s.parent >= 0:
            p = rec.spans[s.parent]
            assert s.parent < i and p.t0 <= s.t0 and s.t1 <= p.t1, (s, p)
    # siblings follow one another
    for a, b in zip(rec.spans, rec.spans[1:]):
        if a.parent == b.parent:
            assert a.t1 <= b.t0


def test_counts_are_what_they_count(tr, waves, monkeypatch):
    decoded = _spy_decode(monkeypatch)
    products = spy_products(monkeypatch)
    handle = tr.prepare_batch(waves, _opts())
    feats, n_frames = handle[3], handle[4]
    tr.decode_prepared(handle)
    rec = tr.traces[-1]
    n_products = len(products)
    enc = tr.encode(feats, n_frames)
    assert rec.counts == {
        "encoder.frames": enc.shape[0] * enc.shape[1],
        "encoder.valid_frames": int(encoded_lengths(torch.as_tensor(n_frames)).sum()),
        "decode.steps": decoded[0].steps,
        "layers.f32_products": n_products,  # a float32 facade: every product float32
    }
    assert decoded[0].steps > 0
    checks = [s for s in rec.spans if s.name == "decode.check"]
    assert len(checks) == decoded[0].steps // CHECK_EVERY + 1
    loop = next(s for s in rec.spans if s.name == "decode.loop")
    assert all(loop.t0 <= c.t0 and c.t1 <= loop.t1 for c in checks)
    assert len(tr.traces) == len(set(r.id for r in tr.traces))


def test_no_call_open_records_nothing(tr, waves):
    n = len(tr.traces)
    feats = np.zeros((64, 80), np.float32)
    tr.transcribe_features(feats)
    tr.encode(torch.zeros(1, 64, 80), [64])
    assert len(tr.traces) == n
    assert trace.span("decode.loop") is trace.span("results")  # the shared no-op
    trace.count("decode.steps", 3)  # no call open: nothing to add to, no error


def _profiled(fn, tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return out, [e for e in events if e.get("ph") == "X" and str(e.get("name", "")).startswith("parakeet.")]


@pytest.mark.parametrize("decoder", ["TDT", "CTC"])
def test_results_identical_under_the_profiler(tr, waves, tmp_path, decoder):
    plain = tr.transcribe_batch(waves, _opts(decoder))
    profiled, events = _profiled(lambda: tr.transcribe_batch(waves, _opts(decoder)), tmp_path)
    assert events
    assert _served(profiled) == _served(plain)
    assert [r.token_ids for r in profiled] == [r.token_ids for r in plain]
    assert any(_served(plain)), "degenerate case: nothing served"


def test_profiler_annotations_nest_as_the_record(tr, waves, monkeypatch, tmp_path):
    decoded = _spy_decode(monkeypatch)
    _, events = _profiled(lambda: tr.transcribe_batch(waves, _opts()), tmp_path)
    rec = tr.traces[-1]
    assert rec.counts["decode.steps"] == decoded[0].steps > 0
    by_name: dict[str, list] = {}
    for e in sorted(events, key=lambda e: e["ts"]):
        by_name.setdefault(e["name"], []).append(e)
    assert sorted(by_name) == sorted({trace.PREFIX + s.name for s in rec.spans})
    matched = []
    seen: dict[str, int] = {}
    for s in rec.spans:  # the k-th span of a name is the k-th annotation of that name
        k = seen.get(s.name, 0)
        seen[s.name] = k + 1
        matched.append(by_name[trace.PREFIX + s.name][k])
    assert all(len(v) == seen[k[len(trace.PREFIX):]] for k, v in by_name.items())

    def inside(e, p):
        return p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"]

    for s, e in zip(rec.spans, matched):
        if s.parent >= 0:
            assert inside(e, matched[s.parent]), (s.name, rec.spans[s.parent].name)
    checks = [e for s, e in zip(rec.spans, matched) if s.name == "decode.check"]
    assert len(checks) == decoded[0].steps // CHECK_EVERY + 1


def test_nothing_device_side_off_the_profiler(tr, waves, monkeypatch):
    called = []

    def spy(name):
        def fn(*a, **kw):
            called.append(name)
            raise AssertionError(f"{name} called off the profiler")
        return fn

    monkeypatch.setattr(torch.profiler, "record_function", spy("record_function"))
    monkeypatch.setattr(torch.cuda, "synchronize", spy("synchronize"))
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", spy("reset_peak_memory_stats"))
    monkeypatch.setattr(torch.cuda, "Event", spy("Event"))
    monkeypatch.setattr(torch.cuda, "memory_allocated", spy("memory_allocated"))
    for decoder in ("TDT", "CTC"):
        tr.transcribe_batch(waves, _opts(decoder))
    assert called == []
    assert tr.traces[-1].spans


def test_a_failed_call_leaves_no_record(tr, waves, monkeypatch):
    n = len(tr.traces)

    def broken(*a, **kw):
        raise RuntimeError("decode failed")

    with monkeypatch.context() as m:
        m.setattr(T, "transducer_greedy_decode", broken)
        with pytest.raises(RuntimeError, match="decode failed"):
            tr.transcribe_batch(waves, _opts())
    assert len(tr.traces) == n
    tr.transcribe_batch(waves, _opts())  # the thread holds no stale call
    assert len(tr.traces) == n + 1 and tr.traces[-1].spans[0].parent == -1
    assert tr.transcribe_batch([]) == [] and len(tr.traces) == n + 1


def test_pipelined_service_keeps_one_record_a_batch(tr, waves, monkeypatch):
    stage_threads: dict[str, set] = {"prepare": set(), "decode": set()}
    handles = []
    orig_prepare, orig_decode = tr.prepare_batch, tr.decode_prepared

    def prepare_batch(*a, **kw):
        stage_threads["prepare"].add(threading.current_thread().name)
        handles.append(orig_prepare(*a, **kw))
        return handles[-1]

    def decode_prepared(prepared):
        stage_threads["decode"].add(threading.current_thread().name)
        return orig_decode(prepared)

    monkeypatch.setattr(tr, "prepare_batch", prepare_batch)
    monkeypatch.setattr(tr, "decode_prepared", decode_prepared)
    n = len(tr.traces)
    with TranscriptionService(tr, max_batch=2, max_wait_ms=50, pipeline=True) as svc:
        got = [f.result(timeout=120) for f in [svc.submit(w) for w in waves]]
    assert all(isinstance(r, T.TranscribeResult) for r in got)
    assert stage_threads == {"prepare": {"parakeet-serve-prep"}, "decode": {"parakeet-serve"}}
    recs = list(tr.traces)[n:]
    assert len(recs) == svc.stats.batches == len(handles) >= 2
    for h, rec in zip(handles, recs):
        kind, opts, pad, feats, n_frames = h
        assert kind == "padded" and h.trace is rec and len(h) == 5
        names = {s.name for s in rec.spans}
        assert {"frontend", "frontend.copy", "encoder", "decode", "decode.check", "results"} <= names
        assert all(rec.t0 <= s.t0 and s.t1 <= rec.t1 for s in rec.spans)
        assert rec.counts["encoder.valid_frames"] == int(encoded_lengths(torch.as_tensor(n_frames)).sum())


def test_the_deque_stays_at_its_bound(tr, waves):
    assert tr.traces.maxlen == trace.KEEP >= 4096
    filler = trace.CallTrace()
    filler.close()
    tr.traces.extend([filler] * (trace.KEEP - len(tr.traces)))
    tr.transcribe_batch(waves[:1], _opts())
    tr.transcribe_batch(waves[1:], _opts())
    assert len(tr.traces) == trace.KEEP
    assert tr.traces[-2] is not filler and tr.traces[-1] is not filler and tr.traces[-3] is filler
    assert tr.traces[-2].counts["encoder.frames"] < tr.traces[-1].counts["encoder.frames"]
    tr.traces.clear()


def _mean_ms(recs, name):
    """A span's mean ms a call over the records that hold it, summed anew."""
    per = [sum(s.t1 - s.t0 for s in r.spans if s.name == name) for r in recs if any(s.name == name
                                                                                 for s in r.spans)]
    return sum(per) / len(per) * 1e3


def test_stage_ms_means_each_span_over_the_records(tr, waves):
    tr.traces.clear()
    for decoder in ("TDT", "CTC", "TDT"):
        tr.transcribe_batch(waves, _opts(decoder))
    got = trace.stage_ms(tr.traces)
    recs = list(tr.traces)
    assert set(got) == {s.name for r in recs for s in r.spans}
    for name in ("batch", "decode.check", "ctc_head", "results"):
        assert got[name] == pytest.approx(_mean_ms(recs, name))
    assert trace.stage_ms([]) == {}
    tr.traces.clear()


class _Spans(list):
    """A record's spans that note each read of them."""

    reads: list = []

    def __iter__(self):
        _Spans.reads.append(self)
        return super().__iter__()


def test_stage_ms_reads_the_newest_records_only(tr, waves):
    """stage_ms reads the newest RECENT records, however many are kept: its
    cost does not grow with the deque."""
    tr.transcribe_batch(waves, _opts())
    tr.transcribe_batch(waves, _opts("CTC"))
    tdt, ctc = tr.traces[-2], tr.traces[-1]
    recs = []
    for k in range(trace.KEEP + 5):  # distinct durations, the CTC tree every third record
        rec = copy.copy(ctc if k % 3 == 2 else tdt)
        rec.spans = _Spans(trace.Span(s.name, s.parent, s.t0, s.t0 + (k % 7 + 1) * (s.t1 - s.t0))
                           for s in rec.spans)
        recs.append(rec)
    kept = type(tr.traces)(recs, maxlen=tr.traces.maxlen)
    assert len(kept) == trace.KEEP > trace.RECENT
    _Spans.reads.clear()
    got = trace.stage_ms(kept)
    newest = recs[-trace.RECENT:]
    assert sorted(map(id, _Spans.reads)) == sorted(id(r.spans) for r in newest)
    assert set(got) == {s.name for r in newest for s in r.spans}
    for name in got:
        assert got[name] == pytest.approx(_mean_ms(newest, name))
