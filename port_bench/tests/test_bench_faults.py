"""The check fails what it must and passes what is sound: the control (the
reference in the precision below the program's, in the program's place)
and the program with its timed path broken underneath (a token altered
where it is produced; half of each batch left out) come out not correct,
under each real cell's limits; the sound program and the bf16 witness
(the reference with every weight product in bfloat16) come out correct.
(A decode step that returns its LSTM state unchanged is no fault these
random weights can show: the prediction net's input embeddings, std
0.02, move no choice, so such a decode serves the same transcripts;
PERF.md.) The run skips the look for a card and runs on the CPU at toy
widths."""

import json
import time

import pytest
import torch

from port_bench import harness
from port_bench.tests.tiny import CELL, REPO, tiny_root

# each real cell's decode, and its limits
CELLS = {
    "tdt600m.archive": dict(decoder="tdt", timestamps=True),
    "tdt110m.ctc_archive": dict(decoder="ctc", timestamps=False),
    "tdt110m.snippets": dict(decoder="tdt", timestamps=False),
}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def run(tmp_path, cell: str, system: str = "program") -> dict:
    limits = json.loads((REPO / "port_bench/limits" / f"{cell}.json").read_text())
    root = tiny_root(tmp_path, limits=limits, **CELLS[cell])
    return harness.run(root, CELL, 2**31 + 7, 0.3, False, time.perf_counter(), device="cpu", system=system)


def alter_first_token(tokens: list, blank: int) -> None:
    for toks in tokens:
        if toks:
            toks[0] = (toks[0] + 1) % blank
            return


@pytest.mark.parametrize("cell", CELLS)
def test_sound_program_is_correct(tmp_path, cell):
    res = run(tmp_path, cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tmp_path, cell):
    res = run(tmp_path, cell, system="control")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_bf16_witness_is_correct(tmp_path, cell):
    res = run(tmp_path, cell, system="witness")
    assert res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_token_altered_where_produced(tmp_path, monkeypatch, cell):
    from parakeet_tpu_torch import transcribe as T
    from parakeet_tpu_torch.decode.timestamp import TimestampedToken

    blank = 32  # the toy vocabulary's last id
    if CELLS[cell]["decoder"] == "ctc":
        orig_ctc = T.ctc_greedy_decode

        def ctc_greedy_decode(*a, **kw):
            out = orig_ctc(*a, **kw)
            alter_first_token(out, blank)
            return out

        monkeypatch.setattr(T, "ctc_greedy_decode", ctc_greedy_decode)
    else:
        orig = T.transducer_greedy_decode

        def transducer_greedy_decode(*a, **kw):
            res = orig(*a, **kw)
            for i, ts in enumerate(res.timestamped):
                if ts:
                    t = ts[0]
                    ts[0] = TimestampedToken((t.token_id + 1) % blank, t.start_frame, t.end_frame, t.confidence)
                    res.tokens[i][0] = ts[0].token_id
                    break
            return res

        monkeypatch.setattr(T, "transducer_greedy_decode", transducer_greedy_decode)
    res = run(tmp_path, cell)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_half_of_each_batch_left_out(tmp_path, monkeypatch, cell):
    from parakeet_tpu_torch import transcribe as T

    orig = T._TranscriberBase._decode_rows

    def _decode_rows(self, batch, mel_lens, opts):
        k = max(1, batch.shape[0] // 2)
        return orig(self, batch[:k], mel_lens[:k], opts) + [T.TranscribeResult() for _ in range(batch.shape[0] - k)]

    monkeypatch.setattr(T._TranscriberBase, "_decode_rows", _decode_rows)
    res = run(tmp_path, cell)
    assert not res["correct"], res["checks"]
