"""The port's `parakeet` CLI (parakeet_tpu_torch/cli.py) against the JAX
package's: the parse cases of tests/test_cli_args.py with the same exit
codes and messages, and the offline and streaming routes with
--random-weights on tiny models (the default presets patched small in both
packages), whose printed tokens must be equal."""

import wave

import numpy as np
import pytest

from parakeet_tpu import cli as RCLI
from parakeet_tpu import config as RC
from parakeet_tpu_torch import cli as TCLI
from parakeet_tpu_torch import config as TC

# (argv, expected exit code or SystemExit, a text the error must name)
PARSE_CASES = {
    "timestamps_before_positional": (["--timestamps", "clip.wav", "--features", "f.npy"], 1, None),
    "timestamp_mode_implies_timestamps": (["--timestamp-mode", "sentences", "clip.wav", "--features", "f.npy"],
                                          1, None),
    "bad_timestamp_mode": (["--timestamp-mode", "bogus", "clip.wav"], SystemExit, None),
    "bad_quantize": (["--quantize", "int2", "clip.wav"], SystemExit, None),
    "quantize_int4_parses": (["--quantize", "int4", "clip.wav", "--features", "f.npy"], 1, None),
    "align_with_features": (["--align", "hello world", "--features", "f.npy"], 1, "--align"),
    "align_decode_flags": (["--align", "hi", "--beam-size", "4", "clip.wav"], 1, "--beam-size"),
    "align_streaming_model": (["--model", "eou-120m", "--align", "hi", "--random-weights", "clip.wav"],
                              1, "--align"),
    "quantize_streaming_model": (["--model", "eou-120m", "--quantize", "int4", "--random-weights", "clip.wav"],
                                 1, "--quantize"),
    "no_audio": ([], SystemExit, None),
    "missing_weights": (["clip.wav", "--weights", "/nonexistent/model.safetensors"], 1, "--weights"),
}


def _run(main, argv, capsys):
    try:
        rc = main(argv)
    except SystemExit as e:
        rc = ("exit", e.code)
    out = capsys.readouterr()
    return rc, out.out, out.err


@pytest.mark.parametrize("case", sorted(PARSE_CASES))
def test_parse_cases_match_reference(case, capsys):
    argv, want, names = PARSE_CASES[case]
    port = _run(TCLI.main, argv, capsys)
    ref = _run(RCLI.main, argv, capsys)
    if want is SystemExit:
        # argparse: the same exit code and error line (the usage above it
        # lists the port's --device choices)
        assert port[0][0] == "exit" and port[0][1] != 0
        assert port[:2] == ref[:2]
        assert port[2].splitlines()[-1] == ref[2].splitlines()[-1]
    else:
        assert port[0] == want
        assert port == ref
    if names:
        assert names in port[2]


def test_device_choices():
    with pytest.raises(SystemExit):
        TCLI.main(["--device", "tpu", "clip.wav"])


def _tiny_offline(C):
    return C.TDTCTCConfig(
        encoder=C.EncoderConfig(mel_bins=80, subsampling_channels=16, hidden_size=32,
                                num_layers=2, num_heads=4, ffn_intermediate=64),
        prediction=C.PredictionConfig(vocab_size=21, pred_hidden=16, num_lstm_layers=1),
        joint=C.JointConfig(encoder_hidden=32, pred_hidden=16, joint_hidden=16, vocab_size=21),
        ctc_vocab_size=21,
    )


def _tiny_stream(C):
    return C.EOUConfig(
        encoder=C.StreamingEncoderConfig(
            mel_bins=80, subsampling_channels=8, hidden_size=16, num_layers=1,
            num_heads=2, ffn_intermediate=32, conv_kernel_size=9,
            att_context_left=4, att_context_right=0, chunk_size=2),
        prediction=C.PredictionConfig(vocab_size=13, pred_hidden=8, num_lstm_layers=1),
        joint=C.JointConfig(encoder_hidden=16, pred_hidden=8, joint_hidden=8, vocab_size=13),
        ctc_vocab_size=13,
    )


@pytest.fixture()
def tiny_presets(monkeypatch, tmp_path):
    """Both packages' default presets made tiny; two WAV clips; the working
    directory moved so that no models/vocab.txt is found."""
    import parakeet_tpu.streaming as RS
    import parakeet_tpu.transcribe as RT
    import parakeet_tpu_torch.streaming as TS
    import parakeet_tpu_torch.transcribe as TT

    monkeypatch.setattr(RT, "make_110m_config", lambda: _tiny_offline(RC))
    monkeypatch.setattr(TT, "make_110m_config", lambda: _tiny_offline(TC))
    monkeypatch.setattr(RS, "make_eou_120m_config", lambda: _tiny_stream(RC))
    monkeypatch.setattr(TS, "make_eou_120m_config", lambda: _tiny_stream(TC))
    monkeypatch.chdir(tmp_path)
    paths = []
    rng = np.random.RandomState(4)
    for i, n in enumerate((12000, 17000)):
        path = tmp_path / f"clip{i}.wav"
        with wave.open(str(path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(16000)
            w.writeframes((0.1 * rng.randn(n) * 32767).astype("<i2").tobytes())
        paths.append(str(path))
    return paths


def _result_lines(out: str) -> list[str]:
    """The printed results without the per-stage timings."""
    return [l for l in out.splitlines() if not l.startswith("  ") or l.startswith("  tok ")
            or l.startswith("  [")]


@pytest.mark.parametrize("flags", [[], ["--ctc"]], ids=["tdt", "ctc"])
def test_offline_random_weights_match_reference(tiny_presets, capsys, flags):
    argv = [*tiny_presets, "--random-weights", "--device", "cpu", *flags]
    port = _run(TCLI.main, argv, capsys)
    ref = _run(RCLI.main, argv, capsys)
    assert port[0] == ref[0] == 0, port[2]
    lines = _result_lines(port[1])
    assert lines == _result_lines(ref[1])
    assert sum(l.startswith("(token ids) [") for l in lines) == 2


def test_streaming_random_weights_match_reference(tiny_presets, capsys):
    argv = [tiny_presets[0], "--model", "eou-120m", "--random-weights", "--device", "cpu", "--timestamps"]
    port = _run(TCLI.main, argv, capsys)
    ref = _run(RCLI.main, argv, capsys)
    assert port[0] == ref[0] == 0, port[2]
    lines = [l for l in port[1].splitlines() if l.startswith("  tok ")]
    assert lines and lines == [l for l in ref[1].splitlines() if l.startswith("  tok ")]
