"""The port's train CLIs (train_cli.py, train_diar_cli.py) on the CPU:
argument parsing against the JAX package's parsers, the parallelism flags
and head checks that exit, a tiny train + resume + export whose loss lines
equal the JAX CLI's (within 1e-4), and exports that both packages'
Transcriber and Sortformer load."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from parakeet_tpu import train_cli as RCLI
from parakeet_tpu import train_diar_cli as RDCLI
from parakeet_tpu.audio.io import write_wav
from parakeet_tpu_torch import train_cli as CLI
from parakeet_tpu_torch import train_diar_cli as DCLI

LOSS_ATOL = 1e-4


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Tiny CPU ops run far faster on one thread than on a pool that shares
    the host's cores with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def write_corpus(tmp_path, n=4):
    rng = np.random.RandomState(0)
    lines = []
    for i in range(n):
        p = tmp_path / f"c{i}.wav"
        write_wav(p, 0.1 * rng.randn(int(16000 * (0.3 + 0.1 * i))).astype(np.float32))
        lines.append(json.dumps({"audio_filepath": p.name, "text": "a b" if i % 2 else "b a b"}))
    m = tmp_path / "train.jsonl"
    m.write_text("\n".join(lines) + "\n")
    v = tmp_path / "vocab.txt"
    v.write_text("\n".join(["<unk>", "▁a", "▁b", "a", "b"]) + "\n")
    return m, v


def write_diar_corpus(tmp_path, n=4):
    rng = np.random.RandomState(0)
    lines = []
    for i in range(n):
        dur = 0.4 + 0.1 * i
        wav = tmp_path / f"d{i}.wav"
        write_wav(wav, 0.1 * rng.randn(int(16000 * dur)).astype(np.float32))
        (tmp_path / f"d{i}.rttm").write_text(
            f"SPEAKER d{i} 1 0.00 {dur / 2:.2f} <NA> <NA> spk_a <NA> <NA>\n"
            f"SPEAKER d{i} 1 {dur / 2:.2f} {dur / 2:.2f} <NA> <NA> spk_b <NA> <NA>\n")
        lines.append(json.dumps({"audio_filepath": wav.name, "rttm_filepath": f"d{i}.rttm"}))
    m = tmp_path / "diar.jsonl"
    m.write_text("\n".join(lines) + "\n")
    return m


def losses(err: str) -> dict[int, float]:
    out = {}
    for line in err.splitlines():
        if line.startswith("step "):
            parts = line.split()
            out[int(parts[1].split("/")[0])] = float(parts[3])
    return out


@pytest.mark.parametrize("ours,theirs,argv", [
    (CLI, RCLI, ["--manifest", "m.jsonl", "--vocab", "v.txt"]),
    (DCLI, RDCLI, ["--manifest", "m.jsonl"]),
])
def test_parsers_keep_the_reference_flags_and_defaults(ours, theirs, argv):
    got, want = vars(ours.build_argparser().parse_args(argv)), vars(theirs.build_argparser().parse_args(argv))
    assert got.pop("device") == "cuda"
    want.pop("device")
    want.pop("cpu_devices")
    assert got == want


@pytest.mark.parametrize("flag", ["--model-parallel", "--seq-parallel", "--pipeline-parallel", "--data-parallel"])
def test_parallel_flags_exit(tmp_path, flag):
    m, v = write_corpus(tmp_path)
    with pytest.raises(SystemExit, match="Queue 1 item 6"):
        CLI.main(["--manifest", str(m), "--vocab", str(v), "--model", "tiny", flag, "2", "--device", "cpu"])
    if flag == "--data-parallel":
        with pytest.raises(SystemExit, match="Queue 1 item 6"):
            DCLI.main(["--manifest", str(write_diar_corpus(tmp_path)), "--model", "tiny", flag, "2",
                       "--device", "cpu"])


def test_head_checks_and_the_default_device(tmp_path):
    m, v = write_corpus(tmp_path)
    with pytest.raises(SystemExit, match="needs a TDT/CTC head"):
        CLI.main(["--manifest", str(m), "--vocab", str(v), "--model", "rnnt-600m", "--loss", "hybrid",
                  "--device", "cpu"])
    with pytest.raises(SystemExit, match="must divide"):
        CLI.main(["--manifest", str(m), "--vocab", str(v), "--model", "tiny", "--batch-size", "2",
                  "--accum-steps", "3", "--device", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CLI.main(["--manifest", str(m), "--vocab", str(v), "--model", "tiny"])


def test_tiny_train_resume_export_equal_the_jax_cli(tmp_path, capsys):
    m, v = write_corpus(tmp_path)
    common = ["--manifest", str(m), "--vocab", str(v), "--model", "tiny", "--batch-size", "2",
              "--frame-multiple", "32", "--label-multiple", "8", "--log-every", "1", "--schedule", "cosine",
              "--warmup-steps", "1", "--clip-norm", "5.0"]
    runs = {}
    for name, main, extra in (("jax", RCLI.main, ["--data-parallel", "1"]), ("port", CLI.main, ["--device", "cpu"])):
        ck = tmp_path / f"ck_{name}"
        base = common + extra + ["--checkpoint-dir", str(ck)]
        capsys.readouterr()
        assert main(base + ["--steps", "3", "--checkpoint-every", "2"]) == 0
        first = capsys.readouterr().err
        assert main(base + ["--steps", "5", "--resume", "--export", str(tmp_path / f"{name}.safetensors")]) == 0
        second = capsys.readouterr().err
        assert "# resumed at step 3" in second
        runs[name] = {**losses(first), **losses(second)}
    assert sorted(runs["port"]) == sorted(runs["jax"]) == [1, 2, 3, 4, 5]
    for k in runs["jax"]:
        assert runs["port"][k] == pytest.approx(runs["jax"][k], abs=LOSS_ATOL), k

    # the port's export loads in both packages' Transcriber, with the same tokens
    from parakeet_tpu.transcribe import Transcriber as RTranscriber
    from parakeet_tpu_torch.text.tokenizer import Tokenizer
    from parakeet_tpu_torch.transcribe import Transcriber

    cfg, kind, _ = CLI._preset("tiny")
    cfg = CLI._fit_vocab(cfg, kind, Tokenizer(v))
    rcfg, rkind, _ = RCLI._preset("tiny")
    from parakeet_tpu.text.tokenizer import Tokenizer as RTokenizer

    rcfg = RCLI._fit_vocab(rcfg, rkind, RTokenizer(v))
    clip = 0.1 * np.random.RandomState(3).randn(16000).astype(np.float32)
    export = str(tmp_path / "port.safetensors")
    got = Transcriber(export, str(v), cfg, device="cpu").transcribe(clip).token_ids
    want = RTranscriber(export, str(v), rcfg).transcribe(clip).token_ids
    assert got == want


def test_diar_cli_trains_resumes_and_exports_for_both_sortformers(tmp_path, capsys):
    m = write_diar_corpus(tmp_path)
    ck, out = tmp_path / "ck", tmp_path / "sf.safetensors"
    base = ["--manifest", str(m), "--model", "tiny", "--batch-size", "2", "--frame-multiple", "32",
            "--checkpoint-dir", str(ck), "--device", "cpu", "--log-every", "1"]
    assert DCLI.main(base + ["--steps", "2", "--checkpoint-every", "1", "--export", str(out)]) == 0
    assert sorted(losses(capsys.readouterr().err)) == [1, 2]
    assert DCLI.main(base + ["--steps", "3", "--resume", "--remat", "--accum-steps", "2"]) == 0
    err = capsys.readouterr().err
    assert "# resumed at step 2" in err and sorted(losses(err)) == [3]

    from parakeet_tpu.models.sortformer import Sortformer as RSortformer
    from parakeet_tpu_torch.models.sortformer import Sortformer

    feats = np.random.RandomState(1).randn(1, 64, 128).astype(np.float32)
    got = Sortformer(str(out), config=DCLI._preset("tiny"), device="cpu").forward(feats).numpy()
    want = np.asarray(RSortformer(str(out), config=RDCLI._preset("tiny")).forward(feats))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
