"""The port's NeMo converter (parakeet_tpu_torch/tools/convert.py) against
the JAX package's tool: on the test's own synthetic NeMo checkpoints (a
state dict and a .nemo archive, every preset cut to two layers), the
written safetensors files are byte-identical and the returned dicts equal;
extract_vocab writes the same vocab file from a .vocab or a SentencePiece
.model member; the same inputs are refused with the same errors."""

import struct
import tarfile

import numpy as np
import pytest
import torch

import parakeet_tpu.tools.convert as RCV
import parakeet_tpu_torch.tools.convert as TCV

SMALL = {
    "110m-tdt-ctc": dict(num_layers=2, vocab_size=11),
    "600m-tdt": dict(num_layers=2, vocab_size=9),
    "rnnt-600m": dict(num_layers=2, vocab_size=9),
    "sortformer": dict(num_layers=2, num_transformer_layers=2),
}


@pytest.fixture()
def small_presets(monkeypatch):
    """Every preset cut to two layers, in both tools."""
    for mod in (RCV, TCV):
        for name, cut in SMALL.items():
            monkeypatch.setitem(mod.PRESETS, name, dict(mod.PRESETS[name], **cut))


def synthetic_state_dict(preset_name: str, seed: int = 0) -> dict[str, np.ndarray]:
    """A NeMo-named state dict covering the preset's key map: every mapped
    key, the LSTM biases to merge, the joint output to split (or pass
    through), the CTC head and a preprocessor key to skip."""
    preset = TCV.PRESETS[preset_name]
    rng = np.random.RandomState(seed)
    sd = {k: rng.randn(3, 4).astype(np.float32) for k in TCV.build_mapping(preset)
          if not k.startswith("ctc_decoder.0.")}
    sd["preprocessor.featurizer.window"] = rng.randn(400).astype(np.float32)
    for l in range(preset["num_lstm_layers"]):
        for b in ("ih", "hh"):
            sd[f"decoder.prediction.dec_rnn.lstm.bias_{b}_l{l}"] = rng.randn(32).astype(np.float32)
    if preset.get("has_decoder", True) and preset["joint_prefix"]:
        rows = preset["vocab_size"] + preset["num_durations"]
        sd["joint.joint_net.2.weight"] = rng.randn(rows, 8).astype(np.float32)
        sd["joint.joint_net.2.bias"] = rng.randn(rows).astype(np.float32)
    return sd


def _convert_both(tmp_path, preset, source, **kw):
    outs = {}
    for tag, mod in (("port", TCV), ("ref", RCV)):
        path = tmp_path / f"{tag}.safetensors"
        outs[tag] = (mod.convert(source, path, preset, verbose=False, **kw), path.read_bytes())
    (port, port_bytes), (ref, ref_bytes) = outs["port"], outs["ref"]
    assert port_bytes == ref_bytes
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(port[k], ref[k])
        assert port[k].dtype == ref[k].dtype == np.float32
    return port


@pytest.mark.parametrize("preset", sorted(SMALL))
def test_state_dict_conversion_is_byte_identical(small_presets, tmp_path, preset):
    sd = synthetic_state_dict(preset)
    out = _convert_both(tmp_path, preset, None, state_dict=sd)
    assert "preprocessor.featurizer.window" not in out and len(out) > 20


def test_nemo_archive_conversion_is_byte_identical(small_presets, tmp_path):
    sd = synthetic_state_dict("110m-tdt-ctc", seed=3)
    ckpt = tmp_path / "model_weights.ckpt"
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, ckpt)
    nemo = tmp_path / "model.nemo"
    with tarfile.open(nemo, "w") as tar:
        tar.add(ckpt, arcname="./model_weights.ckpt")
    out = _convert_both(tmp_path, "110m-tdt-ctc", nemo)
    np.testing.assert_array_equal(
        out["prediction_.lstm_.cells_.0.input_proj_.bias"],
        sd["decoder.prediction.dec_rnn.lstm.bias_ih_l0"] + sd["decoder.prediction.dec_rnn.lstm.bias_hh_l0"])


def _spm_model_bytes(pieces):
    """A hand-encoded SentencePiece ModelProto: repeated field 1 =
    SentencePiece{1: piece, 2: score (f32), 3: type}, then a field to skip."""
    def varint(v):
        out = b""
        while True:
            b7, v = v & 0x7F, v >> 7
            out += bytes([b7 | (0x80 if v else 0)])
            if not v:
                return out

    blob = b""
    for i, piece in enumerate(pieces):
        raw = piece.encode("utf-8")
        sub = b"\x0a" + varint(len(raw)) + raw + b"\x15" + struct.pack("<f", -float(i)) + b"\x18" + varint(1)
        blob += b"\x0a" + varint(len(sub)) + sub
    return blob + b"\x22" + varint(3) + b"abc"


@pytest.mark.parametrize("members", [
    {"tokenizer.vocab": "▁hello\t-1.0\n▁world\t-2.0\nxx\t-3.0\n".encode()},
    {"abc_tokenizer.model": _spm_model_bytes(["<unk>", "▁hi", "▁there", "!"])},
    {"t.vocab": "▁a\t-1.0\n▁b\t-2.0\n".encode(), "t.model": _spm_model_bytes(["x", "y"])},
], ids=["vocab", "sentencepiece-model", "vocab-preferred"])
def test_extract_vocab_matches_reference(tmp_path, members):
    nemo = tmp_path / "m.nemo"
    with tarfile.open(nemo, "w") as tar:
        for name, data in members.items():
            (tmp_path / name).write_bytes(data)
            tar.add(tmp_path / name, arcname=name)
    n_port = TCV.extract_vocab(nemo, tmp_path / "port.txt")
    n_ref = RCV.extract_vocab(nemo, tmp_path / "ref.txt")
    assert n_port == n_ref > 0
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "ref.txt").read_bytes()


def test_parse_sentencepiece_model_matches_reference():
    data = _spm_model_bytes(["<unk>", "▁hello", "▁wor", "ld", "▁"])
    assert TCV.parse_sentencepiece_model(data) == RCV.parse_sentencepiece_model(data) == [
        "<unk>", "▁hello", "▁wor", "ld", "▁"]


def test_refusals_match_reference(small_presets, tmp_path):
    sd = synthetic_state_dict("110m-tdt-ctc")
    bad_joint = dict(sd, **{"joint.joint_net.2.weight": np.zeros((20, 8), np.float32)})
    unmapped = dict(sd, **{"encoder.mystery.weight": np.zeros(3, np.float32)})
    for mod in (TCV, RCV):
        with pytest.raises(ValueError, match="wrong --model preset"):
            mod.convert(None, None, "110m-tdt-ctc", state_dict=bad_joint, verbose=False)
        with pytest.raises(ValueError, match="1 unmapped NeMo keys"):
            mod.convert(None, None, "110m-tdt-ctc", state_dict=unmapped, verbose=False)
    (tmp_path / "readme.txt").write_text("nothing here")
    nemo = tmp_path / "empty.nemo"
    with tarfile.open(nemo, "w") as tar:
        tar.add(tmp_path / "readme.txt", arcname="readme.txt")
    for mod in (TCV, RCV):
        with pytest.raises(FileNotFoundError):
            mod.extract_vocab(nemo, tmp_path / "v.txt")
