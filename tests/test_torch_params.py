"""The torch port's numpy-level copies against the JAX reference: config
presets, parameter specs and init, safetensors, tokenizer, timestamp
grouping, audio I/O — and that importing the port pulls in no JAX."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from parakeet_tpu import config as RC
from parakeet_tpu import params as RP
from parakeet_tpu.audio import io as RIO
from parakeet_tpu.decode import timestamp as RTS
from parakeet_tpu.io.safetensors import save_safetensors
from parakeet_tpu.text.tokenizer import Tokenizer as RTokenizer
from parakeet_tpu_torch import config as TC
from parakeet_tpu_torch import params as TP
from parakeet_tpu_torch.audio import io as TIO
from parakeet_tpu_torch.decode import timestamp as TTS
from parakeet_tpu_torch.io.safetensors import load_safetensors
from parakeet_tpu_torch.text.tokenizer import Tokenizer as TTokenizer

REPO = Path(__file__).resolve().parent.parent

PRESETS = [
    ("make_110m_config", "tdt_ctc_spec"),
    ("make_tdt_600m_config", "tdt_spec"),
    ("make_rnnt_600m_config", "rnnt_spec"),
    ("make_eou_120m_config", "eou_spec"),
    ("make_nemotron_600m_config", "nemotron_spec"),
    ("make_sortformer_117m_config", "sortformer_spec"),
]


@pytest.mark.parametrize("preset,spec_fn", PRESETS)
def test_spec_keys_and_shapes_match_reference(preset, spec_fn):
    ref = getattr(RP, spec_fn)(getattr(RC, preset)())
    port = getattr(TP, spec_fn)(getattr(TC, preset)())
    assert port == ref


@pytest.mark.parametrize("preset", [p for p, _ in PRESETS])
def test_config_presets_match_reference(preset):
    ref, port = getattr(RC, preset)(), getattr(TC, preset)()
    assert type(port).__name__ == type(ref).__name__
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_init_params_identical_to_reference():
    cfg = RC.TDTCTCConfig(
        encoder=RC.EncoderConfig(mel_bins=80, subsampling_channels=8, hidden_size=32,
                                 num_layers=2, num_heads=4, ffn_intermediate=64),
        prediction=RC.PredictionConfig(vocab_size=9, pred_hidden=8, num_lstm_layers=1),
        joint=RC.JointConfig(encoder_hidden=32, pred_hidden=8, joint_hidden=8, vocab_size=9),
        ctc_vocab_size=9,
    )
    ref = RP.init_params(RP.tdt_ctc_spec(cfg), seed=7)
    port = TP.init_params(TP.tdt_ctc_spec(cfg), seed=7)
    assert port.keys() == ref.keys()
    for k in ref:
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_params_from_numpy_dtypes_and_quantized_rejection():
    flat = {
        "a.weight": np.ones((2, 3), np.float64),
        "a.norm_.weight": np.ones(3, np.float32),
        "conv_.batch_norm_.running_var": np.ones(3, np.float32),
    }
    out = TP.params_from_numpy(flat, "cpu", torch.bfloat16)
    assert out["a.weight"].dtype == torch.bfloat16
    assert out["a.norm_.weight"].dtype == torch.float32  # norm params stay f32
    assert out["conv_.batch_norm_.running_var"].dtype == torch.float32
    # quantized codes keep their dtype and their sidecars stay f32, as the
    # reference's cast-then-quantize order leaves them; other integers raise
    q = {"w": np.ones((2, 2), np.int8), "w##scale": np.ones(2, np.float32), "v": np.ones((2, 1), np.uint8),
         "v##scale4": np.ones((2, 1), np.float32)}
    out = TP.params_from_numpy(q, "cpu", torch.bfloat16)
    assert [out[k].dtype for k in q] == [torch.int8, torch.float32, torch.uint8, torch.float32]
    with pytest.raises(ValueError, match="neither float nor quantized"):
        TP.params_from_numpy({"w": np.ones((2, 2), np.int32)})


def test_safetensors_roundtrip_with_reference_writer(tmp_path):
    arrays = {"x": np.arange(6, dtype=np.float32).reshape(2, 3), "y": np.ones(4, np.int32)}
    path = tmp_path / "w.safetensors"
    save_safetensors(arrays, path)
    got = load_safetensors(path)
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k], v)


def test_safetensors_bf16_without_ml_dtypes(tmp_path, monkeypatch):
    """BF16 tensors decode exactly to float32 when ml_dtypes is absent."""
    import json
    import struct

    from parakeet_tpu_torch.io import safetensors as S

    vals = np.array([1.0, -2.5, 3.140625], np.float32)
    raw = (vals.view(np.uint32) >> 16).astype("<u2").tobytes()
    header = json.dumps({"w": {"dtype": "BF16", "shape": [3], "data_offsets": [0, len(raw)]}}).encode()
    path = tmp_path / "bf16.safetensors"
    path.write_bytes(struct.pack("<Q", len(header)) + header + raw)
    monkeypatch.delitem(S._DTYPES, "BF16", raising=False)
    np.testing.assert_array_equal(S.load_safetensors(path)["w"], vals)


def test_load_params_numpy_over_random_base(tmp_path):
    cfg = TC.PredictionConfig(vocab_size=5, pred_hidden=4, num_lstm_layers=1)
    spec = TP.prediction_spec(cfg)
    key = "prediction_.embed_.weight"
    path = tmp_path / "p.safetensors"
    save_safetensors({key: np.full((5, 4), 0.5, np.float32)}, path)
    warned = []
    got = TP.load_params_numpy(spec, str(path), seed=3, warn=warned.append)
    np.testing.assert_array_equal(got[key], np.full((5, 4), 0.5, np.float32))
    assert warned and "missing" in warned[0]
    ref = RP.load_params(spec, str(path), seed=3)
    for k in spec:
        np.testing.assert_array_equal(got[k], np.asarray(ref[k]), err_msg=k)


def _tiny_tdt_ctc(mod):
    return mod.TDTCTCConfig(
        encoder=mod.EncoderConfig(mel_bins=80, subsampling_channels=8, hidden_size=32,
                                  num_layers=1, num_heads=4, ffn_intermediate=64),
        prediction=mod.PredictionConfig(vocab_size=9, pred_hidden=8, num_lstm_layers=1),
        joint=mod.JointConfig(encoder_hidden=32, pred_hidden=8, joint_hidden=8, vocab_size=9),
        ctc_vocab_size=9,
    )


def _assert_params_equal(port, ref):
    assert port.keys() == ref.keys()
    for k in ref:
        assert port[k].dtype == torch.float32 and port[k].device.type == "cpu", k
        np.testing.assert_array_equal(port[k].numpy(), np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("source", ["weights_path", "weights"])
def test_load_params_matches_reference(tmp_path, source):
    """load_params over a seed-5 random base from a file or a dict of the
    seed-9 weights without the CTC head: the same values and the same
    warning in both packages."""
    rspec, tspec = RP.tdt_ctc_spec(_tiny_tdt_ctc(RC)), TP.tdt_ctc_spec(_tiny_tdt_ctc(TC))
    weights = {k: np.asarray(v) for k, v in RP.init_params(rspec, seed=9).items() if not k.startswith("ctc_")}
    path = tmp_path / "w.safetensors"
    save_safetensors(weights, path)
    arg = dict(weights_path=str(path)) if source == "weights_path" else dict(weights=weights)
    warned = {"ref": [], "port": []}
    ref = RP.load_params(rspec, **arg, seed=5, warn=warned["ref"].append)
    port = TP.load_params(tspec, **arg, seed=5, warn=warned["port"].append, device="cpu")
    _assert_params_equal(port, ref)
    assert warned["port"] == warned["ref"] and len(warned["ref"]) == 1 and "missing" in warned["ref"][0]
    ctc = [k for k in rspec if k.startswith("ctc_")]
    assert ctc and all(np.array_equal(port[k].numpy(), np.asarray(RP.init_params(rspec, seed=5)[k])) for k in ctc)
    for k, w in weights.items():
        np.testing.assert_array_equal(port[k].numpy(), w, err_msg=k)


def test_load_params_strict_raises_as_the_reference(tmp_path):
    rspec, tspec = RP.tdt_ctc_spec(_tiny_tdt_ctc(RC)), TP.tdt_ctc_spec(_tiny_tdt_ctc(TC))
    weights = {k: np.asarray(v) for k, v in RP.init_params(rspec, seed=9).items()}
    missing = sorted(weights)[3]
    del weights[missing]
    messages = []
    for load, spec in ((RP.load_params, rspec), (TP.load_params, tspec)):
        with pytest.raises(KeyError, match="1 parameters missing") as err:
            load(spec, weights=weights, strict=True)
        messages.append(str(err.value))
    assert messages[0] == messages[1] and missing in messages[1]
    full = {k: np.asarray(v) for k, v in RP.init_params(rspec, seed=9).items()}
    _assert_params_equal(TP.load_params(tspec, weights=full, strict=True), RP.load_params(rspec, weights=full, strict=True))
    # no file and no dict: the random base itself; init_params takes dtype third, as the reference's
    _assert_params_equal(TP.load_params(tspec, seed=4), RP.init_params(rspec, 4))
    _assert_params_equal(TP.init_params(tspec, 4, torch.float32), RP.init_params(rspec, 4, np.float32))


def test_tokenizer_and_timestamps_match_reference(tmp_path):
    pieces = ["<unk>", "▁he", "llo", "▁wor", "ld", ".", "▁a", "b"]
    vocab = tmp_path / "vocab.txt"
    vocab.write_text("\n".join(f"{p}\t0" for p in pieces), encoding="utf-8")
    ref, port = RTokenizer(vocab), TTokenizer(vocab)
    for text in ("hello world.", "ab ab", "xyz hello"):
        assert port.encode(text) == ref.encode(text)
    ids = [1, 2, 3, 4, 5, 6, 7, 42]
    assert port.decode(ids) == ref.decode(ids)

    toks = [(1, 0, 1, 0.9), (2, 2, 2, 0.8), (3, 4, 5, 0.7), (4, 6, 6, 0.95), (5, 7, 7, 0.5), (6, 9, 9, 0.6)]
    for mode in ("WORDS", "SENTENCES"):
        r = RTS.group_timestamps([RTS.TimestampedToken(*t) for t in toks], pieces, RTS.TimestampMode[mode])
        p = TTS.group_timestamps([TTS.TimestampedToken(*t) for t in toks], pieces, TTS.TimestampMode[mode])
        assert [dataclasses.astuple(w) for w in p] == [dataclasses.astuple(w) for w in r]


def test_audio_io_matches_reference(tmp_path):
    rng = np.random.RandomState(0)
    x = (rng.randn(4410) * 0.2).astype(np.float32)
    path = tmp_path / "a.wav"
    RIO.write_wav(path, x, 44100)
    ref, port = RIO.read_audio(path), TIO.read_audio(path)
    np.testing.assert_array_equal(port.samples, ref.samples)
    assert (port.sample_rate, port.num_channels, port.num_samples) == (
        ref.sample_rate, ref.num_channels, ref.num_samples)
    stereo = (rng.randn(800, 2) * 0.1).astype(np.float32)
    np.testing.assert_array_equal(
        TIO.read_audio(stereo, sample_rate=8000).samples,
        RIO.read_audio(stereo, sample_rate=8000).samples,
    )
    # a corrupt FLAC stream fails in the port's decode chain as in the
    # reference's: a RuntimeError that names the format
    for reader in (RIO.read_audio, TIO.read_audio):
        with pytest.raises(RuntimeError, match="flac"):
            reader(b"fLaC" + bytes(64))


def test_port_import_pulls_in_no_jax():
    code = (
        "import importlib, pkgutil, sys, parakeet_tpu_torch\n"
        "for m in pkgutil.walk_packages(parakeet_tpu_torch.__path__, 'parakeet_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "for name in ('audio.codecs', 'decode.align', 'streaming', 'models.streaming_encoder',\n"
        "             'models.transformer', 'models.sortformer', 'diarize', 'quantize', 'tools.quantize_ckpt',\n"
        "             'decode.phrase_boost', 'decode.beam_transducer', 'decode.ctc_beam', 'decode.keyword',\n"
        "             'text.ngram_lm', 'text.neural_lm', 'text.subtitles', 'metrics', 'native', 'serve',\n"
        "             'serve_http', 'cli', 'capi', 'benchmark', 'tools.convert', 'ops.transducer_loss',\n"
        "             'train', 'train_loop', 'train_cli', 'train_diar_cli', 'data', 'checkpoint', 'augment',\n"
        "             'parallel', 'parallel.mesh', 'parallel.collectives', 'parallel.launch',\n"
        "             'parallel.pipeline'):\n"
        "    assert 'parakeet_tpu_torch.' + name in sys.modules, name\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'optax', 'parakeet_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
