"""The port's `parakeet-bench` (parakeet_tpu_torch/benchmark.py) on the CPU:
the reference's encoder flags as a FusedLayers, and a run of the model ×
duration matrix on a tiny encoder (the 110m preset patched small) that
prints the reference's markdown table and writes a torch.profiler trace."""

import pytest

from parakeet_tpu_torch import benchmark as TB
from parakeet_tpu_torch import config as TC
from parakeet_tpu_torch.models.encoder import FusedLayers


@pytest.mark.parametrize("flags,want", [
    ((None, None, False, False), FusedLayers()),
    (("block4hp", "pallas", True, True), FusedLayers(ffn=True, conv=True, subsample=True)),
    (("mega", "nhc", False, False), FusedLayers(attention="mega")),
    (("v1", None, False, True), FusedLayers(attention="v1", ffn=True)),
])
def test_encoder_flags(flags, want):
    assert TB.fused_layers(*flags) == want


def test_bench_markdown_and_profile(monkeypatch, tmp_path, capsys):
    tiny = TC.EncoderConfig(mel_bins=80, subsampling_channels=16, hidden_size=32, num_layers=2, num_heads=4,
                            ffn_intermediate=64)
    monkeypatch.setattr(TC, "make_110m_config", lambda: TC.TDTCTCConfig(encoder=tiny))
    trace = tmp_path / "trace"
    rc = TB.main(["--device", "cpu", "--models", "110m", "--durations", "1,2", "--iters", "2", "--markdown",
                  "--batch", "2", "--profile", str(trace)])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == ["| Model | Audio | Time (ms) | RTF | Throughput |",
                       "|-------|-------|-----------|-----|------------|"]
    assert [row.split(" | ")[:2] for row in out[2:]] == [["| 110m", "1 s"], ["| 110m", "2 s"]]
    assert (trace / "parakeet_bench_trace.json").stat().st_size > 0


def test_unknown_model_and_device():
    with pytest.raises(SystemExit):
        TB.bench_encoder("no-such-model", 1, 1, "float32", 1, device="cpu")
    with pytest.raises(SystemExit):
        TB.main(["--device", "tpu"])
