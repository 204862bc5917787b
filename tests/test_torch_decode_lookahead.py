"""The port's second greedy loop, impl="lookahead" with its `window`, and the
step loop's `unroll`, against the JAX package's transducer_greedy_decode on
the same numpy inputs, and against the port's own step loop: tokens, start
and end frames identical, confidences within rtol 1e-5, the last token
equal, the LSTM state within rtol 1e-5, atol 1e-6 (tests/test_torch_decode.py
_assert_same_decode)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parakeet_tpu import quantize as RQ
from parakeet_tpu.decode.phrase_boost import ContextTrie as RTrie
from parakeet_tpu.decode.transducer import transducer_greedy_decode as r_decode
from parakeet_tpu_torch.decode import transducer as TD
from parakeet_tpu_torch.decode.phrase_boost import ContextTrie as TTrie
from parakeet_tpu_torch.decode.transducer import transducer_greedy_decode as t_decode
from parakeet_tpu_torch.params import params_from_numpy
from tests.test_torch_decode import BLANK, ENC_H, PRED_H, VOCAB, _assert_same_decode as _same, _model

PHRASES = [[3, 4], [3, 7, 2], [5]]

# name: model seed, encoder batch (B, T), lengths, window and the decode's options
CASES = {
    **{f"window{w}": dict(seed=11, shape=(4, 30), lengths=[30, 25, 13, 1], window=w) for w in (1, 2, 3, 8, 64)},
    # the blank logit raised by 3: random weights emit on most frames, this leaves blank stretches
    "sparse": dict(seed=11, shape=(4, 30), lengths=[30, 25, 13, 1], window=8, blank_bias=3.0),
    "boosted": dict(seed=13, shape=(2, 20), lengths=[20, 14], window=8, boost=4.0),
    "rnnt": dict(seed=14, shape=(3, 18), lengths=[18, 11, 4], window=4, is_tdt=False,
                 kw=dict(durations=(0,))),
    "two_layers_noclamp": dict(seed=4, shape=(3, 22), lengths=[22, 17, 3], window=5, layers=2,
                               kw=dict(clamp_end=False)),
    "max_symbols": dict(seed=5, shape=(3, 12), lengths=[12, 9, 4], window=8, kw=dict(durations=(0,), max_symbols=3)),
    "int8": dict(seed=6, shape=(3, 24), lengths=[24, 16, 9], window=8, quantize=True),
    # two chunks of 14 and 10 frames, the decode state carried, 40 slots a chunk
    "streaming": dict(seed=7, shape=(2, 24), lengths=None, window=6, chunks=(14, 10),
                      kw=dict(clamp_end=False, max_out=40)),
}


def _params(c):
    flat = _model(c["seed"], c.get("layers", 1), c.get("kw", {}).get("durations", (0, 1, 2, 3, 4)),
                  c.get("is_tdt", True))
    if c.get("blank_bias"):
        flat["tdt_joint_.label_proj_.bias"][BLANK] += c["blank_bias"]
    if c.get("quantize"):
        flat = RQ.quantize_params(flat, mode="int8", min_elems=0, as_numpy=True)
        assert any(v.dtype == np.int8 for v in flat.values())
    return flat


def _enc(c):
    return (np.random.RandomState(c["seed"] + 100).randn(*c["shape"], ENC_H) * 2).astype(np.float32)


def _run(c, port: bool, **impl):
    """Each chunk's result (one chunk unless the case streams) from one
    package; a streaming chunk starts from the last one's token and LSTM
    state and reports frames from its offset."""
    is_tdt = c.get("is_tdt", True)
    flat, enc = _params(c), _enc(c)
    kw = dict(pred_hidden=PRED_H, num_lstm_layers=c.get("layers", 1), blank_id=BLANK, is_tdt=is_tdt,
              joint_prefix="tdt_joint_" if is_tdt else "joint_", **c.get("kw", {}), **impl)
    if port:
        decode, params, tensor = t_decode, params_from_numpy(flat), torch.from_numpy
    else:
        decode, params, tensor = r_decode, {k: jnp.asarray(v) for k, v in flat.items()}, jnp.asarray
    if "boost" in c:
        trie = TTrie() if port else RTrie()
        for ids in PHRASES:
            trie.insert(ids)
        kw["boost"] = trie.device_boost(VOCAB, c["shape"][0], c["boost"])
    out, start, carry = [], 0, {}
    for n in c.get("chunks", (c["shape"][1],)):
        res = decode(params, tensor(enc[:, start:start + n]), enc_lengths=c["lengths"], frame_offset=start,
                     **carry, **kw)
        out.append(res)
        carry = dict(init_token=res.last_token, init_lstm=res.lstm_state)
        start += n
    return out


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("case", list(CASES))
def test_lookahead_matches_reference(case):
    c = CASES[case]
    got = _run(c, True, impl="lookahead", window=c["window"])
    ref = _run(c, False, impl="lookahead", window=c["window"])
    for g, r in zip(got, ref):
        _same(g, r)
    assert any(r.tokens for r in got), "degenerate case: nothing was emitted"
    if case == "max_symbols":  # every item reaches the 3-emission cap on some frame
        for item in got[0].timestamped:
            frames = [t.start_frame for t in item]
            assert max(frames.count(f) for f in set(frames)) == 3


@pytest.mark.parametrize("case", list(CASES))
def test_lookahead_matches_the_step_loop(case):
    """The port's two loops give the same decode; lookahead takes no more
    iterations (a blank stretch inside the window costs one), the same at
    window 1."""
    c = CASES[case]
    looks = _run(c, True, impl="lookahead", window=c["window"])
    steps = _run(c, True)
    for look, step in zip(looks, steps):
        _same(look, step)
        assert look.steps <= step.steps
        if c["window"] == 1:
            assert look.steps == step.steps
    if case == "sparse":
        assert looks[0].steps < steps[0].steps, "no blank stretch was skipped"


def test_lookahead_overwrites_the_last_slot_as_the_step_loop_does():
    """Past max_out emissions an item's last slot is overwritten, by both
    loops alike (the reference's own unpack cannot read that state)."""
    c = dict(CASES["streaming"], kw=dict(clamp_end=False, max_out=6))
    looks = _run(c, True, impl="lookahead", window=c["window"])
    for look, step in zip(looks, _run(c, True)):
        _same(look, step)
    assert any(len(toks) == 6 for r in looks for toks in r.tokens)


@pytest.mark.parametrize("impl", ["step", "lookahead"])
def test_unroll_keeps_results_and_the_default_schedule(impl):
    """unroll stretches the host check to CHECK_EVERY · unroll iterations:
    identical results, the JAX package's too; unroll=1 is today's schedule."""
    c = dict(CASES["window8"], seed=9, layers=2)
    default = _run(c, True, impl=impl)[0]
    ref = _run(c, False, impl=impl, unroll=4)[0]
    for n in (1, 2, 4):
        got = _run(c, True, impl=impl, unroll=n)[0]
        _same(got, default)
        _same(got, ref)
        assert got.steps % (TD.CHECK_EVERY * n) == 0
        assert got.steps >= default.steps
        if n == 1:
            assert got.steps == default.steps
    assert _run(c, True, impl=impl, unroll=0)[0].steps == default.steps  # clamped to 1


def test_impl_and_window_validation():
    """An unknown impl raises the reference's ValueError; a window clamps to
    [1, T]."""
    c = CASES["window1"]
    flat, enc = _params(c), _enc(c)
    with pytest.raises(ValueError) as ref_err:
        r_decode({k: jnp.asarray(v) for k, v in flat.items()}, jnp.asarray(enc), pred_hidden=PRED_H,
                 num_lstm_layers=1, blank_id=BLANK, impl="scan")
    with pytest.raises(ValueError) as got_err:
        t_decode(params_from_numpy(flat), torch.from_numpy(enc), pred_hidden=PRED_H, num_lstm_layers=1,
                 blank_id=BLANK, impl="scan")
    assert str(got_err.value) == str(ref_err.value) == "unknown decode impl 'scan' (want 'lookahead' or 'step')"
    one = _run(c, True, impl="lookahead", window=1)[0]
    for w, same_as in ((0, one), (-3, one), (30, _run(c, True, impl="lookahead", window=64)[0])):
        got = _run(c, True, impl="lookahead", window=w)[0]
        _same(got, same_as)
        assert got.steps == same_as.steps


def test_blank_chase_walks_like_the_reference():
    """The chase's composed successor table stops where the reference's K
    unrolled steps stop, for every window and item."""
    rng = np.random.RandomState(3)
    for k in (1, 2, 3, 5, 8, 16):
        blank = torch.from_numpy(rng.rand(64, k) < 0.7)
        skip = torch.from_numpy(rng.randint(0, 5, (64, k)))
        t = torch.from_numpy(rng.randint(0, 20, 64))
        enc_len = torch.from_numpy(rng.randint(0, 25, 64))
        got = TD._blank_chase(blank, skip, t, enc_len, torch.arange(k + 4))
        off = torch.zeros(64, dtype=torch.int64)
        found = torch.zeros(64, dtype=torch.bool)
        for _ in range(k):
            scanning = (off < k) & (t + off < enc_len) & ~found
            oix = off.clamp(0, k - 1)[:, None]
            cur_blank = blank.gather(1, oix)[:, 0]
            found |= scanning & ~cur_blank
            off = torch.where(scanning & cur_blank, off + skip.gather(1, oix)[:, 0].clamp(min=1), off)
        assert torch.equal(got, off), k
