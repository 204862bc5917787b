"""The port's training data pipeline (data.py, augment.py) against the JAX
package's on the same manifests, WAVs and RTTMs, on the CPU: manifest
parsing, bucket order across epochs, padding and labels (equal), features
(within 1e-5), SpecAugment and the RTTM functions (bit-identical), the
diarization loader, and the errors."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from parakeet_tpu import augment as RA
from parakeet_tpu import data as RD
from parakeet_tpu.audio.io import write_wav
from parakeet_tpu.config import AudioConfig as RAudioConfig
from parakeet_tpu.text.tokenizer import Tokenizer as RTokenizer
from parakeet_tpu_torch import augment as A
from parakeet_tpu_torch import data as D
from parakeet_tpu_torch.config import AudioConfig
from parakeet_tpu_torch.text.tokenizer import Tokenizer

FEATURE_ATOL = 1e-5
PIECES = ["<unk>", "▁a", "▁b", "▁c", "▁", "a", "b", "c", "d"]


def tokenizers():
    r, p = RTokenizer(), Tokenizer()
    r.load_pieces(PIECES)
    p.load_pieces(PIECES)
    return r, p


def write_corpus(tmp_path, n=7, seed=0):
    rng = np.random.RandomState(seed)
    lines = []
    for i in range(n):
        dur = 0.2 + 0.37 * ((i * 3) % n) / n
        wav = tmp_path / f"clip{i}.wav"
        write_wav(wav, 0.1 * rng.randn(int(dur * 16000)).astype(np.float32))
        entry = {"audio_filepath": wav.name, "text": " ".join("abc"[rng.randint(3)] for _ in range(1 + i % 4))}
        if i % 2 == 0:  # half carry a duration, half are probed
            entry["duration"] = dur
        lines.append(json.dumps(entry))
    m = tmp_path / "manifest.jsonl"
    m.write_text("\n".join(lines) + "\n")
    return m


def write_diar_corpus(tmp_path, n=4):
    rng = np.random.RandomState(1)
    lines = []
    for i in range(n):
        dur = 0.5 + 0.15 * i
        wav = tmp_path / f"d{i}.wav"
        write_wav(wav, 0.1 * rng.randn(int(16000 * dur)).astype(np.float32))
        (tmp_path / f"d{i}.rttm").write_text(
            f"SPEAKER d{i} 1 0.05 {dur / 3:.2f} <NA> <NA> spk_b <NA> <NA>\n"
            f"NON-SPEECH d{i} 1 0.00 0.05 <NA> <NA> <NA> <NA> <NA>\n"
            f"SPEAKER d{i} 1 {dur / 3:.2f} {dur / 2:.2f} <NA> <NA> spk_a <NA> <NA>\n"
            f"SPEAKER d{i} 1 {dur / 4:.2f} {dur / 5:.2f} <NA> <NA> spk_c <NA> <NA>\n")
        lines.append(json.dumps({"audio_filepath": wav.name, "rttm_filepath": f"d{i}.rttm"}))
    m = tmp_path / "diar.jsonl"
    m.write_text("\n".join(lines) + "\n")
    return m


def assert_batches_equal(ours, theirs, feature_keys=("features",)):
    assert len(ours) == len(theirs)
    for got, want in zip(ours, theirs):
        assert sorted(got) == sorted(want)
        for k, v in want.items():
            g = got[k].cpu().numpy()
            assert g.shape == v.shape and g.dtype == v.dtype, k
            if k in feature_keys:
                np.testing.assert_allclose(g, v, rtol=0, atol=FEATURE_ATOL, err_msg=k)
            else:
                np.testing.assert_array_equal(g, v, err_msg=k)


def test_manifest_entries_equal_the_reference(tmp_path):
    m = write_corpus(tmp_path)
    ours, theirs = D.ManifestDataset(m), RD.ManifestDataset(m)
    assert len(ours) == len(theirs)
    for i in range(len(ours)):
        assert ours.duration(i) == theirs.duration(i)
        assert ours[i] == theirs[i]


@pytest.mark.parametrize("line,match", [("{not json", "invalid JSON"), ('{"text": "a"}', "entry needs")])
def test_manifest_errors_equal_the_reference(tmp_path, line, match):
    m = tmp_path / "bad.jsonl"
    m.write_text(line + "\n")
    for cls in (D.ManifestDataset, RD.ManifestDataset):
        with pytest.raises(ValueError, match=match):
            cls(m)
    m.write_text("\n")
    with pytest.raises(ValueError, match="empty manifest"):
        D.ManifestDataset(m)


@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_batches_equal_the_reference_over_two_epochs(tmp_path, shuffle):
    m = write_corpus(tmp_path)
    rtok, tok = tokenizers()
    kw = dict(batch_size=2, frame_multiple=32, label_multiple=4, shuffle=shuffle, seed=3)
    theirs = RD.TrainDataLoader(RD.ManifestDataset(m), rtok, audio_config=RAudioConfig(), **kw)
    ours = D.TrainDataLoader(D.ManifestDataset(m), tok, audio_config=AudioConfig(), device="cpu", **kw)
    assert len(ours) == len(theirs) == 3  # 7 clips, the last partial bucket dropped
    for _ in range(2):
        got, want = list(ours), list(theirs)
        assert_batches_equal(got, want)
        for b in got:
            assert b["features"].shape[1] % 32 == 0 and b["labels"].shape[1] % 4 == 0
            assert b["features"].device.type == "cpu"


def test_loader_spec_augment_equals_the_reference(tmp_path):
    m = write_corpus(tmp_path)
    rtok, tok = tokenizers()
    kw = dict(batch_size=3, frame_multiple=16, label_multiple=4, seed=5, drop_last=False,
              spec_augment=True)
    theirs = list(RD.TrainDataLoader(RD.ManifestDataset(m), rtok, **kw))
    ours = list(D.TrainDataLoader(D.ManifestDataset(m), tok, device="cpu", **kw))
    assert_batches_equal(ours, theirs)
    for got, want in zip(ours, theirs):  # the same cells masked
        np.testing.assert_array_equal(got["features"].numpy() == 0, want["features"] == 0)


def test_spec_augment_is_bit_identical():
    rng = np.random.RandomState(0)
    feats = rng.randn(3, 120, 80).astype(np.float32)
    lengths = np.array([120, 77, 5])
    for cfg in (A.SpecAugmentConfig(), A.SpecAugmentConfig(freq_masks=3, freq_width=90, time_masks=4, time_width=0.2)):
        rcfg = RA.SpecAugmentConfig(**cfg.__dict__)
        got = A.spec_augment(np.random.RandomState(9), feats, lengths, cfg)
        want = RA.spec_augment(np.random.RandomState(9), feats, lengths, rcfg)
        np.testing.assert_array_equal(got, want)
        assert not np.shares_memory(got, feats)


def test_loader_errors(tmp_path):
    m = write_corpus(tmp_path, n=3)
    rtok, tok = tokenizers()
    with pytest.raises(ValueError, match="smaller than"):
        D.TrainDataLoader(D.ManifestDataset(m), tok, batch_size=4, device="cpu")
    with pytest.raises(ValueError, match="loaded"):
        D.TrainDataLoader(D.ManifestDataset(m), Tokenizer(), batch_size=1, device="cpu")
    # a producer error (a missing file) surfaces in the consumer
    (tmp_path / "clip0.wav").unlink()  # its duration is in the manifest
    loader = D.TrainDataLoader(D.ManifestDataset(m), tok, batch_size=1, shuffle=False, device="cpu")
    with pytest.raises(Exception) as ours:
        list(loader)
    with pytest.raises(Exception) as theirs:
        list(RD.TrainDataLoader(RD.ManifestDataset(m), rtok, batch_size=1, shuffle=False))
    assert type(ours.value) is type(theirs.value)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            D.TrainDataLoader(D.ManifestDataset(m), tok, batch_size=1)


def test_rttm_functions_are_bit_identical(tmp_path):
    write_diar_corpus(tmp_path, n=2)
    for i in range(2):
        segs = D.read_rttm(tmp_path / f"d{i}.rttm")
        assert segs == RD.read_rttm(tmp_path / f"d{i}.rttm")
        for frames, fs, spk in ((9, 0.08, 4), (30, 0.02, 2), (3, 0.5, 1)):
            np.testing.assert_array_equal(D.rttm_to_targets(segs, frames, fs, spk),
                                          RD.rttm_to_targets(segs, frames, fs, spk))
    bad = tmp_path / "bad.rttm"
    for text in ("SPEAKER x 1 0.0\n", "SPEAKER x 1 a 1.0 <NA> <NA> s <NA>\n", "SPEAKER x 1 0.0 -1 <NA> <NA> s <NA>\n"):
        bad.write_text(text)
        with pytest.raises(ValueError):
            RD.read_rttm(bad)
        with pytest.raises(ValueError):
            D.read_rttm(bad)


def test_diarization_loader_equals_the_reference(tmp_path):
    m = write_diar_corpus(tmp_path)
    kw = dict(batch_size=2, max_speakers=4, frame_multiple=32, seed=2)
    theirs = list(RD.DiarizationDataLoader(RD.DiarizationDataset(m),
                                           audio_config=RAudioConfig(n_mels=128, normalize=False), **kw))
    ours = list(D.DiarizationDataLoader(D.DiarizationDataset(m), audio_config=AudioConfig(n_mels=128, normalize=False),
                                        device="cpu", **kw))
    assert_batches_equal(ours, theirs)
    assert any(b["targets"][..., 2].sum() > 0 for b in ours)  # the third speaker arrives too
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"audio_filepath": "x.wav"}) + "\n")
    with pytest.raises(ValueError, match="rttm_filepath"):
        D.DiarizationDataset(bad)
