"""The port's train CLIs (train_cli.py, train_diar_cli.py) on the CPU:
argument parsing against the JAX package's parsers, the parallelism flags
and head checks that exit, a tiny train + resume + export whose loss lines
equal the JAX CLI's (within 1e-4), and exports that both packages'
Transcriber and Sortformer load. On a mesh, each CLI in spawned gloo ranks
as python -m torch.distributed.run starts them (parallel/launch.py
spawn_ranks): every parallel flag's loss lines equal the single-device
CLI's and the JAX CLI's with the same flags on its virtual CPU devices
(within 1e-4); a tensor-parallel run checkpoints its odd vocabulary
padded, resumes from that, and exports the schema shapes, unpadded, and
its checkpoint and export are the JAX tensor-parallel run's: the same
leaves and shapes, each optimizer moment within 1e-4 of its scale (the
moments of keys whose gradient is zero up to rounding left out), each
parameter within Adam's largest move over the run (an element whose
gradient is zero up to rounding moves by up to that in either run).

This module imports JAX only inside its tests: the spawned ranks import it
by name to reach its worker function, and run the port alone."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from parakeet_tpu_torch import train_cli as CLI
from parakeet_tpu_torch import train_diar_cli as DCLI
from parakeet_tpu_torch.audio.io import write_wav
from parakeet_tpu_torch.parallel.launch import spawn_ranks

LOSS_ATOL = 1e-4
MOMENT_FRAC = 1e-4  # each optimizer moment leaf against the JAX run's, over the leaf's max |value|
MOMENT_ZERO_FRAC = 1e-6  # moment leaves below this fraction of the largest are zero up to rounding
ADAM_MOVE = (1 - 0.9) / (1 - 0.999) ** 0.5  # an Adam step moves an element by at most this times the lr


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
    (CLI, "train_cli", ["--manifest", "m.jsonl", "--vocab", "v.txt"]),
    (DCLI, "train_diar_cli", ["--manifest", "m.jsonl"]),
])
def test_parsers_keep_the_reference_flags_and_defaults(ours, theirs, argv):
    import importlib

    theirs = importlib.import_module(f"parakeet_tpu.{theirs}")
    got, want = vars(ours.build_argparser().parse_args(argv)), vars(theirs.build_argparser().parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got.pop("dist_backend") is None  # the port's: the process-group backend of a mesh
    want.pop("device")
    want.pop("cpu_devices")
    assert got == want


@pytest.mark.parametrize("flag", ["--model-parallel", "--seq-parallel", "--pipeline-parallel", "--data-parallel"])
def test_parallel_flags_exit(tmp_path, flag):
    """A parallelism flag above 1 in a process that runs alone exits and
    names the launcher that starts the ranks."""
    m, v = write_corpus(tmp_path)
    with pytest.raises(SystemExit, match="python -m torch.distributed.run --nproc-per-node 2 "
                                         "-m parakeet_tpu_torch.train_cli"):
        CLI.main(["--manifest", str(m), "--vocab", str(v), "--model", "tiny", flag, "2", "--device", "cpu"])
    if flag == "--data-parallel":
        with pytest.raises(SystemExit, match="-m parakeet_tpu_torch.train_diar_cli"):
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
    from parakeet_tpu import train_cli as RCLI

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
    from parakeet_tpu import train_diar_cli as RDCLI

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


# ─── the CLIs on a mesh ──────────────────────────────────────────────────────

TIMEOUT_S = 120.0


def _cli_worker(rank, diar, argv):
    """One rank of a CLI run in a process group (as python -m
    torch.distributed.run starts it): its exit code and its stderr."""
    import contextlib
    import io

    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = (DCLI if diar else CLI).main(argv)
    return rc, err.getvalue()


def _mesh_cli(world, diar, argv) -> str:
    """Rank 0's stderr; every rank exits 0 and only rank 0 logs."""
    got = spawn_ranks(_cli_worker, world, diar, argv, timeout=TIMEOUT_S)
    assert all(rc == 0 for rc, _ in got)
    assert all(not losses(err) for _, err in got[1:])
    return got[0][1]


def write_odd_vocab(tmp_path):
    """Four pieces and the blank: a vocabulary of 5, which a 'model' axis
    of 2 pads to 6."""
    v = tmp_path / "vocab5.txt"
    v.write_text("\n".join(["<unk>", "▁a", "▁b", "a"]) + "\n")
    return v


def _jax_cli(main, argv, capsys) -> str:
    """The JAX CLI's stderr, on the test session's virtual CPU devices."""
    capsys.readouterr()
    assert main(argv) == 0
    return capsys.readouterr().err


def _jax_mesh(flags) -> list[str]:
    """The JAX CLI's flags for the port's mesh: the port's 'data' axis
    defaults to the ranks left over (1 here), the JAX CLI's to its devices
    left over, so it is named."""
    return flags if "--data-parallel" in flags else flags + ["--data-parallel", "1"]


@pytest.mark.parametrize("flags", [["--data-parallel", "2"], ["--model-parallel", "2"], ["--seq-parallel", "2"],
                                   ["--pipeline-parallel", "2", "--micro-batches", "2"]])
def test_mesh_cli_losses_equal_the_single_device_cli(tmp_path, capsys, flags):
    """And the JAX CLI's, run with the same flags on the same corpus."""
    from parakeet_tpu import train_cli as RCLI

    m, _ = write_corpus(tmp_path)
    v = write_odd_vocab(tmp_path)
    common = ["--manifest", str(m), "--vocab", str(v), "--model", "tiny", "--batch-size", "4",
              "--frame-multiple", "32", "--label-multiple", "8", "--log-every", "1", "--steps", "2", "--lr", "1e-2"]
    theirs = losses(_jax_cli(RCLI.main, common + _jax_mesh(flags), capsys))
    assert CLI.main(common + ["--device", "cpu"]) == 0
    want = losses(capsys.readouterr().err)
    got = losses(_mesh_cli(2, False, common + ["--device", "cpu"] + flags))
    assert sorted(got) == sorted(want) == sorted(theirs) == [1, 2]
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=LOSS_ATOL), (flags, k)
        assert got[k] == pytest.approx(theirs[k], abs=LOSS_ATOL), (flags, k)


def test_tp_cli_resumes_its_padded_checkpoint_and_exports_unpadded(tmp_path, capsys):
    """--model-parallel 2 checkpoints the whole state with the vocab (5)
    padded to 6, as the reference writes it, resumes from it (the
    reference's re-pad of schema-shaped params a no-op), and exports the
    schema shapes; its loss lines are the single-device run's and the JAX
    CLI's on the same mesh, and its checkpoint and export the JAX run's."""
    from parakeet_tpu import train_cli as RCLI
    from parakeet_tpu_torch.io.safetensors import load_safetensors

    m, _ = write_corpus(tmp_path)
    v = write_odd_vocab(tmp_path)
    common = ["--manifest", str(m), "--vocab", str(v), "--model", "tiny", "--batch-size", "2",
              "--frame-multiple", "32", "--label-multiple", "8", "--log-every", "1"]
    jax_run = common + ["--data-parallel", "1", "--model-parallel", "2", "--checkpoint-dir", str(tmp_path / "ck_jax")]
    theirs = losses(_jax_cli(RCLI.main, jax_run + ["--steps", "2"], capsys))
    theirs.update(losses(_jax_cli(RCLI.main, jax_run + ["--steps", "4", "--resume", "--export",
                                                          str(tmp_path / "jax.safetensors")], capsys)))
    common += ["--device", "cpu"]
    single = common + ["--checkpoint-dir", str(tmp_path / "ck_single")]
    assert CLI.main(single + ["--steps", "2"]) == 0
    assert CLI.main(single + ["--steps", "4", "--resume", "--export", str(tmp_path / "single.safetensors")]) == 0
    want = losses(capsys.readouterr().err)  # a resumed run restarts the loader's epochs, on a mesh as well
    mesh = common + ["--model-parallel", "2", "--checkpoint-dir", str(tmp_path / "ck")]
    got = losses(_mesh_cli(2, False, mesh + ["--steps", "2"]))
    assert load_safetensors(tmp_path / "ck" / "state.safetensors")["tdt_joint_.label_proj_.weight"].shape[0] == 6
    err = _mesh_cli(2, False, mesh + ["--steps", "4", "--resume", "--export", str(tmp_path / "mesh.safetensors")])
    assert "# resumed at step 2" in err
    got.update(losses(err))
    assert sorted(got) == sorted(want) == sorted(theirs) == [1, 2, 3, 4]
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=LOSS_ATOL), k
        assert got[k] == pytest.approx(theirs[k], abs=LOSS_ATOL), k
    ref, out = load_safetensors(tmp_path / "single.safetensors"), load_safetensors(tmp_path / "mesh.safetensors")
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape, k
    assert out["tdt_joint_.label_proj_.weight"].shape[0] == 5

    # the tp checkpoint and the export against the JAX tensor-parallel run's
    move = 2 * ADAM_MOVE * 1e-4 * 4  # two runs, the default lr, 4 steps
    ours, jax_ck = load_safetensors(tmp_path / "ck" / "state.safetensors"), load_safetensors(tmp_path / "ck_jax" /
                                                                                              "state.safetensors")
    assert sorted(ours) == sorted(jax_ck)
    for k in ("##meta.step", "##meta.treedef"):
        np.testing.assert_array_equal(ours[k], jax_ck[k])
    keys = sorted(k for k in jax_ck if not k.startswith("##"))
    assert [k for k in ours if k.startswith("##opt")] == [k for k in jax_ck if k.startswith("##opt")]
    # optax's leaf order: the count, then mu and nu of each key in sorted order
    mu = {k: f"##opt.{1 + i}" for i, k in enumerate(keys)}
    nu = {k: f"##opt.{1 + len(keys) + i}" for i, k in enumerate(keys)}
    largest = max(float(np.abs(jax_ck[mu[k]]).max()) for k in keys)
    left_out = []
    for k in keys:
        assert ours[k].shape == jax_ck[k].shape, k
        np.testing.assert_allclose(ours[k], jax_ck[k], rtol=0, atol=move, err_msg=k)
        if float(np.abs(jax_ck[mu[k]]).max()) < MOMENT_ZERO_FRAC * largest:
            left_out.append(k)
            continue
        for leaf in (mu[k], nu[k]):
            assert ours[leaf].shape == jax_ck[leaf].shape, (k, leaf)
            np.testing.assert_allclose(ours[leaf], jax_ck[leaf], rtol=0,
                                       atol=MOMENT_FRAC * float(np.abs(jax_ck[leaf]).max()), err_msg=(k, leaf))
    for i in (0, *range(1 + 2 * len(keys), len(mu) * 2 + 2)):  # the count, the schedule's count if any
        if f"##opt.{i}" in jax_ck:
            np.testing.assert_array_equal(ours[f"##opt.{i}"], jax_ck[f"##opt.{i}"])
    # softmax ignores a shift common to every key: each attention's k_proj bias
    assert left_out == [f"encoder_.layers_.{i}.attn_.mha_.k_proj.bias" for i in range(2)], left_out
    assert ours["tdt_joint_.label_proj_.weight"].shape[0] == 6
    jax_out = load_safetensors(tmp_path / "jax.safetensors")
    assert sorted(jax_out) == sorted(out)
    for k in jax_out:
        assert out[k].shape == jax_out[k].shape, k
        np.testing.assert_allclose(out[k], jax_out[k], rtol=0, atol=move, err_msg=k)


def test_diar_cli_data_parallel_equals_the_single_device_cli(tmp_path, capsys):
    """And the JAX CLI's with --data-parallel 2."""
    from parakeet_tpu import train_diar_cli as RDCLI

    m = write_diar_corpus(tmp_path)
    common = ["--manifest", str(m), "--model", "tiny", "--batch-size", "2", "--frame-multiple", "32",
              "--log-every", "1", "--steps", "2", "--lr", "1e-2"]
    theirs = losses(_jax_cli(RDCLI.main, common + ["--data-parallel", "2"], capsys))
    common += ["--device", "cpu"]
    assert DCLI.main(common) == 0
    want = losses(capsys.readouterr().err)
    got = losses(_mesh_cli(2, True, common + ["--data-parallel", "2"]))
    assert sorted(got) == sorted(want) == sorted(theirs) == [1, 2]
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=LOSS_ATOL), k
        assert got[k] == pytest.approx(theirs[k], abs=LOSS_ATOL), k
