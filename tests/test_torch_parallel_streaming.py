"""The port's StreamingBatchTranscriber with its cohort sharded over a dp2
mesh (two ranks spawned on the CPU over gloo, parallel/launch.py) against
the JAX reference's unsharded run on the same weights and audio: the
scenario of tests/test_serve_streaming.py
test_streaming_batch_dp_sharded_matches_single_device (B=8, fused
frontend, a deactivated slot, a held slot, then the lagging ones held),
and a B=4 cohort with late audio, holds and a reset_slot in each frontend
and wire type; every step's output and each slot's tokens and timestamps
identical on every rank. Also the mesh errors.

JAX is imported only inside the tests: the spawned ranks import this
module by name for its worker functions and run the port alone."""

import numpy as np
import pytest
import torch

from parakeet_tpu_torch import config as TC
from parakeet_tpu_torch import streaming as TS
from parakeet_tpu_torch.parallel import mesh as TM
from parakeet_tpu_torch.parallel.launch import spawn_ranks

MEL_STEP = 16
TIMEOUT_S = 90.0


def _cfg(C):
    """tests/test_serve_streaming.py's tiny_cfg."""
    return C.EOUConfig(
        encoder=C.StreamingEncoderConfig(
            mel_bins=80, subsampling_channels=8, hidden_size=16, num_layers=1,
            num_heads=2, ffn_intermediate=32, conv_kernel_size=9,
            att_context_left=4, att_context_right=0, chunk_size=2,
        ),
        prediction=C.PredictionConfig(vocab_size=13, pred_hidden=8, num_lstm_layers=1),
        joint=C.JointConfig(encoder_hidden=16, pred_hidden=8, joint_hidden=8, vocab_size=13),
        ctc_vocab_size=13,
    )


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def flat():
    from parakeet_tpu import config as RC
    from parakeet_tpu import params as RP

    return {k: np.asarray(v) for k, v in RP.init_params(RP.eou_spec(_cfg(RC)), seed=31).items()}


def _serve_scenario(bt):
    """tests/test_serve_streaming.py:180-216 on an 8-slot cohort."""
    rng = np.random.RandomState(41)
    clips = [(rng.randn(12800) * 0.1).astype(np.float32) for _ in range(bt.batch)]
    bt.deactivate_slot(5)
    for i, clip in enumerate(clips):
        bt.push(i, clip)
    steps = []
    while bt.ready_any():
        hold = {2} if not steps else set(bt.lagging_slots())
        steps.append(bt.step(hold=hold))
    return steps


def _late_scenario(bt):
    """B=4: slot 3 vacant, then joining with reset_slot; slot 1's audio late
    (held); odd push sizes."""
    rng = np.random.RandomState(7)
    a, b, c, d = ((rng.randn(n) * 0.1).astype(np.float32) for n in (9600, 9600, 8000, 6400))
    steps = []

    def drain():
        while bt.ready_any():
            steps.append(bt.step(hold=bt.lagging_slots()))

    bt.deactivate_slot(3)
    for lo in range(0, 4800, 1600):
        bt.push(0, a[lo: lo + 1600])
        bt.push(2, c[lo: lo + 1600])
        drain()
    bt.reset_slot(3)
    bt.push(1, (b[:4800] * 32768).astype(np.int16))
    bt.push(3, d[:3001])
    for lo in range(4800, 9600, 1200):
        bt.push(0, a[lo: lo + 1200])
        bt.push(1, b[lo: lo + 1200])
        bt.push(2, c[lo: lo + 1200])
        drain()
    bt.push(3, d[3001:])
    drain()
    return steps


SCENARIOS = {
    "serve-b8-fused": (8, "fused", "float32", _serve_scenario),
    "late-b4-per_push": (4, "per_push", "float32", _late_scenario),
    "late-b4-fused-int16": (4, "fused", "int16", _late_scenario),
}


def _run(bt, scenario):
    steps = scenario(bt)
    return {"steps": steps, "tokens": [list(t) for t in bt._tokens],
            "ts": [[(t.token_id, t.start_frame, t.end_frame, t.confidence) for t in bt.get_timestamped_tokens(i)]
                   for i in range(bt.batch)]}


def _cohort_worker(rank, flat, name):
    batch, frontend, wire, scenario = SCENARIOS[name]
    mesh = TM.make_mesh(devices="cpu")
    bt = TS.StreamingBatchTranscriber(batch, None, None, _cfg(TC), params=flat, mel_frames_per_step=MEL_STEP,
                                      frontend=frontend, wire_dtype=wire, mesh=mesh, device="cpu")
    out = _run(bt, scenario)
    out["slots"] = (bt._slots.start, bt._slots.stop, int(bt._lstm.shape[2]), int(bt._cache["valid"].shape[0]))
    return out


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_streaming_cohort_dp2_matches_unsharded_reference(flat, name):
    from parakeet_tpu import config as RC
    from parakeet_tpu.streaming import StreamingBatchTranscriber

    batch, frontend, wire, scenario = SCENARIOS[name]
    ref = _run(StreamingBatchTranscriber(batch, None, None, _cfg(RC), params=flat, mel_frames_per_step=MEL_STEP,
                                         frontend=frontend, wire_dtype=wire), scenario)
    got = spawn_ranks(_cohort_worker, 2, flat, name, timeout=TIMEOUT_S)
    half = batch // 2
    for rank, g in enumerate(got):
        assert g["slots"] == (rank * half, (rank + 1) * half, half, half)
        assert g["steps"] == ref["steps"], (name, rank)
        assert g["tokens"] == ref["tokens"], (name, rank)
        for mine, want in zip(g["ts"], ref["ts"]):
            assert [t[:3] for t in mine] == [t[:3] for t in want]
            np.testing.assert_allclose([t[3] for t in mine], [t[3] for t in want], rtol=1e-5)
    assert len(ref["steps"]) > 1 and sum(len(t) for t in ref["tokens"]) > 5, "degenerate case: few tokens"
    if name.startswith("serve"):
        assert ref["tokens"][5] == []  # the deactivated slot stayed silent


def _errors_worker(rank, flat):
    errors = []
    for mesh_kw, batch in ((dict(), 3), (dict(model_parallel=2), 4), (dict(seq_parallel=2), 4)):
        mesh = TM.make_mesh(devices="cpu", **mesh_kw)
        try:
            TS.StreamingBatchTranscriber(batch, None, None, _cfg(TC), params=flat, mesh=mesh, device="cpu")
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    return errors


def test_streaming_cohort_mesh_errors(flat):
    """batch must divide the 'data' axis; the cohort shards over 'data'
    only; mesh= takes a parallel.Mesh."""
    for errors in spawn_ranks(_errors_worker, 2, flat, timeout=TIMEOUT_S):
        assert "must divide by the mesh's data axis (2)" in errors[0]
        assert all("over 'data' only" in e for e in errors[1:])
    with pytest.raises(TypeError, match="parakeet_tpu_torch.parallel.Mesh"):
        TS.StreamingBatchTranscriber(2, None, None, _cfg(TC), params=flat, mesh=object(), device="cpu")
