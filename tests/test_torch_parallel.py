"""The port's mesh layer and mesh inference against the JAX reference, on the
CPU over gloo: ranks spawned with parallel/launch.py spawn_ranks (file
rendezvous, a timeout, a failing rank fails the test).

make_mesh's shapes and errors, the tensor-parallel rules, pad_vocab_dim and
unpad_vocab_params, and shard_params (bit-equal to the reference's shards
at the same mesh coordinates, the non-dividing warning included) against
parakeet_tpu.parallel.mesh on its 8 virtual devices; K1's plain
head-sharded mode summed over ranks against the unsharded block; the
Transcriber on dp2, dp1×tp2 (default and with whole-weight kernels) and
dp1×sp2×tp2: TDT and CTC tokens and frames identical to the JAX
single-device Transcriber, the encoder within 1e-5 of scale of the port's
single-device output; the seq-mesh × kernels errors; the greedy decode
(step and lookahead loops) with the vocab heads split over dp1×tp2
against one process; spawn_ranks' failure, hang and start bounds.

This module imports JAX only inside its tests: the spawned ranks import it
by name to reach its worker functions, and run the port alone."""

import warnings

import numpy as np
import pytest
import torch

from parakeet_tpu_torch import config as TC
from parakeet_tpu_torch.audio.frontend import preprocess_audio_batch
from parakeet_tpu_torch.models import encoder as TE
from parakeet_tpu_torch.models.encoder import FusedLayers
from parakeet_tpu_torch.ops.rel_attention import rel_attention_block_heads, rel_attention_block_reference
from parakeet_tpu_torch.parallel import mesh as TM
from parakeet_tpu_torch.parallel.launch import spawn_ranks
from parakeet_tpu_torch.transcribe import Decoder as TDecoder
from parakeet_tpu_torch.transcribe import TranscribeOptions as TOptions
from parakeet_tpu_torch.transcribe import Transcriber as TTranscriber

ENC_SCALE_TOL = 1e-5  # f32: the row-parallel and head partials summed in another order
TIMEOUT_S = 90.0


def _cfg(C):
    """tests/test_parallel.py's tiny_cfg with two layers."""
    return C.TDTCTCConfig(
        encoder=C.EncoderConfig(mel_bins=80, subsampling_channels=8, hidden_size=16,
                                num_layers=2, num_heads=2, ffn_intermediate=32),
        prediction=C.PredictionConfig(vocab_size=9, pred_hidden=8, num_lstm_layers=1),
        joint=C.JointConfig(encoder_hidden=16, pred_hidden=8, joint_hidden=8, vocab_size=9),
        ctc_vocab_size=9,
    )


def _clips():
    """Five clips: a dp2 batch pads to six."""
    rng = np.random.RandomState(11)
    out = []
    for i in range(5):
        n = 8000 + 1600 * i
        t = np.arange(n) / 16000
        gate = (np.sin(2 * np.pi * rng.uniform(1, 4) * t) > 0).astype(np.float32)
        f = rng.uniform(100, 3000) * (1 + 2 * t)
        out.append((0.3 * gate * np.sin(2 * np.pi * f * t) + 0.05 * rng.randn(n)).astype(np.float32))
    return out


def _summary(results):
    return [(r.token_ids, [(t.start_frame, t.end_frame) for t in r.timestamped_tokens]) for r in results]


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

    return {k: np.asarray(v) for k, v in RP.init_params(RP.tdt_ctc_spec(_cfg(RC)), seed=29).items()}


@pytest.fixture(scope="module")
def reference(flat):
    """The JAX single-device Transcriber (its XLA path) and the port's
    single-device encoder output."""
    from parakeet_tpu import config as RC
    from parakeet_tpu.transcribe import Decoder, TranscribeOptions, Transcriber

    tr = Transcriber(None, None, _cfg(RC), params=flat)
    out = {dec: _summary(tr.transcribe_batch(_clips(), TranscribeOptions(getattr(Decoder, dec), timestamps=True)))
           for dec in ("TDT", "CTC")}
    port = TTranscriber(None, None, _cfg(TC), params=flat, device="cpu")
    feats, n = preprocess_audio_batch(_clips(), port._audio_cfg, port.device)
    with torch.inference_mode():
        out["enc"] = port.encode(feats, n).numpy()
    out["enc_lens"] = TE.encoded_lengths(torch.as_tensor(n)).tolist()
    return out


# ─── mesh, rules, shards ─────────────────────────────────────────────────────


def _mesh_worker(rank, flat):
    """make_mesh's shapes and errors, shard_params on a dp2×tp2 mesh (with
    and without vocab padding, its warnings) and activation_sharding."""
    out = {}
    mesh = TM.make_mesh(model_parallel=2, devices="cpu")
    out["shape"] = dict(mesh.shape)
    out["coord"] = mesh.coordinate()
    out["act"] = TM.activation_sharding(mesh)
    out["seq_shape"] = dict(TM.make_mesh(model_parallel=2, seq_parallel=2, devices="cpu").shape)
    seq_mesh = TM.make_mesh(seq_parallel=2, devices="cpu")
    out["seq_act"] = (TM.activation_sharding(seq_mesh).size, TM.activation_sharding(seq_mesh).index)
    out["pipe_shape"] = dict(TM.make_mesh(pipeline_parallel=2, devices="cpu").shape)
    errors = {}
    for name, kw in (("divisible", dict(model_parallel=3)), ("more", dict(n_devices=8)),
                     ("pipe_tp", dict(pipeline_parallel=2, model_parallel=2)),
                     ("pipe_div", dict(pipeline_parallel=3)), ("nccl_cpu", dict(backend="nccl"))):
        try:
            TM.make_mesh(devices="cpu", **kw)
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    out["errors"] = errors
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out["shards"] = TM.shard_params(flat, mesh)
    out["warnings"] = [str(c.message) for c in caught]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        out["shards_nopad"] = TM.shard_params(flat, mesh, pad_vocab=False)
    out["warnings_nopad"] = [str(c.message) for c in caught]
    out["torch_shards"] = {k: v.numpy() for k, v in TM.shard_params(
        {k: torch.from_numpy(v) for k, v in flat.items()}, mesh).items()}
    return out


def _reference_shards(jax_params, mesh):
    """{(data, model) coordinate: {key: numpy shard}} of the reference's
    sharded params on its mesh."""
    devices = np.asarray(mesh.devices)
    coords = {d: idx for idx, d in np.ndenumerate(devices)}
    out = {}
    for k, arr in jax_params.items():
        for sh in arr.addressable_shards:
            out.setdefault(coords[sh.device], {})[k] = np.asarray(sh.data)
    return out


def test_mesh_shapes_rules_and_shards_match_reference(flat):
    import jax
    from jax.sharding import PartitionSpec as PS

    from parakeet_tpu.parallel import mesh as RM

    got = spawn_ranks(_mesh_worker, 4, flat, timeout=TIMEOUT_S)
    rmesh = RM.make_mesh(4, model_parallel=2)
    assert got[0]["shape"] == dict(rmesh.shape) == {"data": 2, "model": 2}
    assert got[0]["seq_shape"] == dict(RM.make_mesh(4, model_parallel=2, seq_parallel=2).shape)
    assert got[0]["pipe_shape"] == {"data": 2, "pipe": 2}
    assert [g["coord"] for g in got] == [{"data": d, "model": m} for d in range(2) for m in range(2)]
    assert all(g["act"] is None for g in got) and RM.activation_sharding(rmesh) is None
    assert [g["seq_act"] for g in got] == [(2, 0), (2, 1), (2, 0), (2, 1)]  # (data 2, seq 2, model 1)
    assert RM.activation_sharding(RM.make_mesh(8, seq_parallel=2)).spec == PS("data", "seq", None)

    # the same arguments over the reference's 4 (of 8) devices give its errors
    ref_errors = {}
    for name, kw in (("divisible", dict(model_parallel=3)), ("more", dict(n_devices=16)),
                     ("pipe_tp", dict(pipeline_parallel=2, model_parallel=2)), ("pipe_div", dict(pipeline_parallel=3))):
        n = kw.pop("n_devices", 4)
        with pytest.raises(ValueError) as e:
            RM.make_mesh(n, devices=jax.devices()[:4] if n == 4 else None, **kw)
        ref_errors[name] = str(e.value)
    errors = got[0]["errors"]
    for name in ("divisible", "pipe_tp", "pipe_div"):
        assert errors[name] == ref_errors[name], name
    assert errors["more"] == "requested 8 devices but only 4 available"
    assert ref_errors["more"] == f"requested 16 devices but only {len(jax.devices())} available"
    assert "nccl" in errors["nccl_cpu"]

    # rules: every key of the schema gets the reference's split dim
    for key in flat:
        spec = RM.param_sharding_rules(key, rmesh).spec
        dims = [i for i, ax in enumerate(spec) if ax == "model"]
        assert TM.param_sharding_rules(key, type("M", (), {"shape": {"model": 2}})()) == (dims[0] if dims else None), key

    # shards: bit-equal to the reference's at each rank's coordinate
    for pad, tag in ((True, "shards"), (False, "shards_nopad")):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ref = _reference_shards(RM.shard_params(flat, rmesh, pad_vocab=pad), rmesh)
        ref_msgs = sorted(str(c.message) for c in caught)
        for rank, g in enumerate(got):
            coord = (rank // 2, rank % 2)
            assert sorted(g[tag]) == sorted(ref[coord])
            for k, shard in g[tag].items():
                assert shard.dtype == ref[coord][k].dtype and shard.shape == ref[coord][k].shape, k
                np.testing.assert_array_equal(shard, ref[coord][k], err_msg=k)
            if tag == "shards":
                for k, shard in g["torch_shards"].items():
                    np.testing.assert_array_equal(shard, ref[coord][k], err_msg=k)
            assert sorted(g["warnings" if pad else "warnings_nopad"]) == ref_msgs
    assert not got[0]["warnings"]  # vocab 9 pads to 10 and shards
    assert any("does not divide model_parallel=2" in m for m in got[0]["warnings_nopad"])
    assert got[0]["shards"]["tdt_joint_.label_proj_.weight"].shape == (5, 8)


def test_vocab_pad_unpad_match_reference():
    from parakeet_tpu.parallel import mesh as RM

    rng = np.random.RandomState(3)
    w = rng.randn(9, 8).astype(np.float32)
    b = rng.randn(9).astype(np.float32)
    c = rng.randn(9, 8, 1).astype(np.float32)
    for key, arr in (("tdt_joint_.label_proj_.weight", w), ("tdt_joint_.label_proj_.bias", b),
                     ("ctc_decoder_.proj_.weight", c), ("prediction_.embed_.weight", w)):
        for tp in (2, 4):
            want = np.asarray(RM.pad_vocab_dim(key, arr, tp))
            np.testing.assert_array_equal(TM.pad_vocab_dim(key, arr, tp), want)
            np.testing.assert_array_equal(TM.pad_vocab_dim(key, torch.from_numpy(arr), tp).numpy(), want)
    assert TM.pad_vocab_dim("encoder_.layers_.0.ffn1_.fc1_.weight", w, 2) is None
    assert TM.pad_vocab_dim("tdt_joint_.label_proj_.weight", rng.randn(10, 8), 2) is None
    assert TM.pad_vocab_dim("tdt_joint_.label_proj_.weight", w, 1) is None
    padded = {"tdt_joint_.label_proj_.weight": TM.pad_vocab_dim("tdt_joint_.label_proj_.weight", w, 2),
              "ctc_decoder_.proj_.weight": TM.pad_vocab_dim("ctc_decoder_.proj_.weight", c, 2),
              "encoder_.norm.weight": b}
    got, want = TM.unpad_vocab_params(padded, 9, ctc_vocab_size=9), RM.unpad_vocab_params(padded, 9, ctc_vocab_size=9)
    for k in padded:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
    np.testing.assert_array_equal(got["tdt_joint_.label_proj_.weight"], w)


def test_pipeline_names_are_lazy_and_refuse():
    """The pipeline names load lazily, as in the reference, and are
    parallel/pipeline.py's; any other name is refused."""
    import parakeet_tpu_torch.parallel as TPAR
    from parakeet_tpu_torch.parallel import pipeline as TPP

    for name in ("make_pp_trainer", "merge_layer_params", "pipeline_encode", "split_layer_params"):
        assert name in TPAR.__all__
        assert getattr(TPAR, name) is getattr(TPP, name)
    with pytest.raises(AttributeError):
        TPAR.no_such_name  # noqa: B018


def test_nccl_refuses_two_ranks_on_one_card(monkeypatch):
    """More ranks than cards raise before any process group is made, unless
    the caller names gloo."""
    monkeypatch.setattr(TM, "rank_device", lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="NCCL refuses two ranks on one device; pass backend='gloo'"):
        TM.make_mesh()
    with pytest.raises(ValueError, match="NCCL refuses"):
        TM.make_mesh(backend="nccl")


# ─── K1 head-sharded ────────────────────────────────────────────────────────


@pytest.mark.parametrize("parts", [2, 4])
def test_k1_heads_partials_sum_to_the_block(parts):
    """The plain head-sharded mode of each 'model' rank (its rows of q, k,
    v, pos_proj, its columns of out_proj, its heads of pos_bias_u/v),
    summed, plus bo and the residual: the unsharded plain block."""
    rng = np.random.RandomState(5)
    b, t, d, heads = 3, 19, 64, 4
    hd = d // heads

    def r(*shape, s=1.0):
        return torch.from_numpy((rng.randn(*shape) * s).astype(np.float32))

    x = r(b, t, d)
    wq, wk, wv, wp, wo = (r(d, d, s=0.15) for _ in range(5))
    bq, bk, bv, bo = (r(d, s=0.1) for _ in range(4))
    bu, bw = r(heads, hd, s=0.1), r(heads, hd, s=0.1)
    nw, nb = 1 + r(d, s=0.1), r(d, s=0.1)
    lengths = torch.tensor([19, 11, 1])
    for norm in ((nw, nb), (None, None)):
        full = rel_attention_block_reference(x, wq, bq, wk, bk, wv, bv, bu, bw, wp, wo, bo, lengths, *norm)
        acc = torch.zeros(b, t, d)
        for i in range(parts):
            rows, hs = slice(i * d // parts, (i + 1) * d // parts), slice(i * heads // parts, (i + 1) * heads // parts)
            part = rel_attention_block_heads(x, wq[rows], bq[rows], wk[rows], bk[rows], wv[rows], bv[rows],
                                             bu[hs], bw[hs], wp[rows], wo[:, rows], lengths, *norm)
            assert part.dtype == torch.float32 and part.shape == (b, t, d)
            acc += part
        got = acc + bo if norm[0] is None else x + (acc + bo)
        valid = torch.arange(t)[None, :] < lengths[:, None]
        scale = float(full[valid].abs().max())
        assert float((got - full)[valid].abs().max()) <= 1e-5 * scale
    assert rel_attention_block_heads.launches == 0  # the plain version launches nothing


def test_reference_query_blocks_against_every_key_match_the_whole():
    """K1's plain version with x_kv and q_offset (the 'seq' rank's form,
    models/encoder.py): each block of query frames against every frame's
    keys equals those rows of the whole block, in every mode."""
    rng = np.random.RandomState(6)
    b, t, d, heads = 2, 12, 32, 2

    def r(*shape, s=1.0):
        return torch.from_numpy((rng.randn(*shape) * s).astype(np.float32))

    x = r(b, t, d)
    w = [r(d, d, s=0.2) if i % 2 == 0 else r(d, s=0.1) for i in range(6)]
    bu, bw = r(heads, d // heads, s=0.1), r(heads, d // heads, s=0.1)
    wp, wo, bo = r(d, d, s=0.2), r(d, d, s=0.2), r(d, s=0.1)
    lengths = torch.tensor([12, 7])
    for norm, partial in (((1 + r(d, s=0.1), r(d, s=0.1)), False), ((None, None), False),
                          ((1 + r(d, s=0.1), r(d, s=0.1)), True)):
        full = rel_attention_block_reference(x, *w, bu, bw, wp, wo, bo, lengths, *norm, heads_partial=partial)
        for start, stop in ((0, 5), (5, 12)):
            got = rel_attention_block_reference(x[:, start:stop], *w, bu, bw, wp, wo, bo, lengths, *norm,
                                                heads_partial=partial, x_kv=x, q_offset=start)
            torch.testing.assert_close(got, full[:, start:stop], rtol=1e-5, atol=1e-6)


def test_k1_heads_checks_shapes_on_cuda_only_path():
    """The kernel's operand checks: a shard wider than the layer or a
    missing head dim raise before any launch (checked_args)."""
    from parakeet_tpu_torch.ops.rel_attention import checked_args, heads_plan

    x = torch.zeros(2, 5, 64)
    w = torch.zeros(32, 64)
    v = torch.zeros(32)
    u = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="head dim"):
        checked_args(x, w, v, w, v, w, v, u, u, w, torch.zeros(64, 32), None, None, None, None,
                     heads_partial=True)
    u = torch.zeros(1, 32)
    a = checked_args(x, w, v, w, v, w, v, u, u, w, torch.zeros(64, 32), None, None, None, None, heads_partial=True)
    assert a["wo"].shape == (64, 32) and "bo" not in a
    with pytest.raises(ValueError, match="wo has shape"):
        checked_args(x, w, v, w, v, w, v, u, u, w, torch.zeros(32, 64), None, None, None, None, heads_partial=True)
    plan = heads_plan(8, 126, 512, 256)
    assert plan.qkv.splits == 1 and plan.partials >= 8 * 126 * 512


# ─── Transcriber on a mesh ───────────────────────────────────────────────────


def _transcribe_worker(rank, flat, mesh_kw, facade_kw):
    mesh = TM.make_mesh(devices="cpu", **mesh_kw)
    heads_calls = []
    real = TE.rel_attention_block_heads
    TE.rel_attention_block_heads = lambda *a, **k: heads_calls.append(1) or real(*a, **k)
    try:
        tr = TTranscriber(None, None, _cfg(TC), params=flat, device="cpu", mesh=mesh, **facade_kw)
        out = {dec: _summary(tr.transcribe_batch(_clips(), TOptions(getattr(TDecoder, dec), timestamps=True)))
               for dec in ("TDT", "CTC")}
        out["ctc_plain"] = [r.token_ids for r in tr.transcribe_batch(_clips(), TOptions(TDecoder.CTC))]
        feats, n = preprocess_audio_batch(_clips(), tr._audio_cfg, tr.device)
        calls = len(heads_calls)
        with torch.inference_mode():
            out["enc"] = tr.encode(feats, n).numpy()
        out["heads_calls_per_encode"] = len(heads_calls) - calls
        out["whole_weights"] = tr._split is not None and tr._split.full is not None
    finally:
        TE.rel_attention_block_heads = real
    return out


MESHES = {
    "dp2": (2, dict(), dict(), 0),
    "dp1xtp2": (2, dict(model_parallel=2), dict(), 2),
    "dp1xtp2-whole-weight-kernels": (2, dict(model_parallel=2), dict(fused=FusedLayers(conv=True, attention="v1")), 0),
    "dp1xsp2xtp2": (4, dict(model_parallel=2, seq_parallel=2), dict(kernels=False), 0),
}


@pytest.mark.parametrize("name", list(MESHES))
def test_transcriber_on_mesh_matches_single_device(flat, reference, name):
    world, mesh_kw, facade_kw, heads_per_encode = MESHES[name]
    got = spawn_ranks(_transcribe_worker, world, flat, mesh_kw, facade_kw, timeout=TIMEOUT_S)
    for rank, g in enumerate(got):
        assert g["TDT"] == reference["TDT"], (name, rank)
        assert g["CTC"] == reference["CTC"], (name, rank)
        assert g["ctc_plain"] == [toks for toks, _ in reference["CTC"]]
        assert g["heads_calls_per_encode"] == heads_per_encode, (name, rank)
        assert g["whole_weights"] == ("whole" in name)
        enc, ref = g["enc"], reference["enc"]
        assert enc.shape == ref.shape
        for i, n in enumerate(reference["enc_lens"]):
            scale = float(np.abs(ref[i, :n]).max())
            assert float(np.abs(enc[i, :n] - ref[i, :n]).max()) <= ENC_SCALE_TOL * scale, (name, rank, i)
    assert any(toks for toks, _ in reference["TDT"]) and any(toks for toks, _ in reference["CTC"])


def _decode_worker(rank, flat, enc, lens, boosted):
    """The greedy decode of one encoder output on a dp1×tp2 mesh: the
    vocab heads split over 'model' (the vocab padded to 10 lanes), every
    rank gathering the logits of each window."""
    from parakeet_tpu_torch.decode.phrase_boost import ContextTrie
    from parakeet_tpu_torch.decode.transducer import transducer_greedy_decode
    from parakeet_tpu_torch.params import params_from_numpy

    mesh = TM.make_mesh(model_parallel=2, devices="cpu")
    params = params_from_numpy(TM.shard_params(flat, mesh))
    assert params["tdt_joint_.label_proj_.weight"].shape[0] == 5  # this rank's half of 10 lanes
    return {impl: _decode_summary(transducer_greedy_decode(
        params, torch.from_numpy(enc), model=mesh.axis("model"), boost=_decode_boost(ContextTrie, boosted),
        **_decode_kw(lens, impl))) for impl in ("step", "lookahead")}


def _decode_kw(lens, impl):
    return dict(pred_hidden=8, num_lstm_layers=1, blank_id=8, enc_lengths=lens, impl=impl, window=4)


def _decode_boost(trie_cls, boosted):
    if not boosted:
        return None
    trie = trie_cls()
    for ids in ([2, 5], [3, 1, 7]):
        trie.insert(ids)
    return trie.device_boost(9, 3, 3.0)


def _decode_summary(res):
    """A decode result with its arrays in numpy, to cross from a rank."""
    from types import SimpleNamespace

    return SimpleNamespace(
        tokens=res.tokens, timestamped=res.timestamped, last_token=np.asarray(res.last_token),
        lstm_state=np.asarray(res.lstm_state), steps=getattr(res, "steps", None),
        boost_active=None if res.boost_active is None else np.asarray(res.boost_active))


@pytest.mark.parametrize("boosted", [False, True], ids=["plain", "boosted"])
def test_lookahead_decode_on_mesh_matches_single_process(flat, boosted):
    """impl="lookahead" with `model=` on dp1×tp2 (the boost mask padded to
    the vocab's padded lanes) gives each rank the JAX package's
    single-device decode (its lookahead and its step loop alike) and the
    port's single-process one, iterations included; the step loop too
    (tests/test_torch_decode.py _assert_same_decode's tolerances)."""
    import jax.numpy as jnp

    from parakeet_tpu.decode.phrase_boost import ContextTrie as RTrie
    from parakeet_tpu.decode.transducer import transducer_greedy_decode as r_decode
    from parakeet_tpu_torch.decode.phrase_boost import ContextTrie
    from parakeet_tpu_torch.decode.transducer import transducer_greedy_decode
    from parakeet_tpu_torch.params import params_from_numpy
    from tests.test_torch_decode import _assert_same_decode

    enc = (np.random.RandomState(31).randn(3, 20, 16) * 2).astype(np.float32)
    lens = [20, 14, 6]
    ref = {impl: r_decode({k: jnp.asarray(v) for k, v in flat.items()}, jnp.asarray(enc),
                          boost=_decode_boost(RTrie, boosted), **_decode_kw(lens, impl))
           for impl in ("step", "lookahead")}
    _assert_same_decode(ref["lookahead"], ref["step"])
    assert any(ref["step"].tokens)
    single = {impl: _decode_summary(transducer_greedy_decode(
        params_from_numpy(flat), torch.from_numpy(enc), boost=_decode_boost(ContextTrie, boosted),
        **_decode_kw(lens, impl))) for impl in ("step", "lookahead")}
    for impl in single:
        _assert_same_decode(single[impl], ref[impl])
    for rank, got in enumerate(spawn_ranks(_decode_worker, 2, flat, enc, lens, boosted, timeout=TIMEOUT_S)):
        for impl in single:
            _assert_same_decode(got[impl], ref[impl])
            assert got[impl].steps == single[impl].steps, (impl, rank)


def _seq_kernels_worker(rank, flat):
    mesh = TM.make_mesh(seq_parallel=2, devices="cpu")
    errors = []
    for kw in (dict(kernels="block"), dict(), dict(kernels=True), dict(fused=FusedLayers(ffn=True)),
               dict(kernels=False, fused=FusedLayers())):
        try:
            TTranscriber(None, None, _cfg(TC), params=flat, device="cpu", mesh=mesh, **kw)
            errors.append(None)
        except ValueError as e:
            errors.append(str(e))
    tr = TTranscriber(None, None, _cfg(TC), params=flat, device="cpu", mesh=mesh, kernels=False)
    quantize_errors = []
    for m, kw in ((mesh, dict(kernels=False)), (TM.make_mesh(model_parallel=2, devices="cpu"), {})):
        try:
            TTranscriber(None, None, _cfg(TC), params=flat, device="cpu", mesh=m, quantize="int8", **kw)
            quantize_errors.append(None)
        except ValueError as e:
            quantize_errors.append(str(e))
    return errors, tr.fused == FusedLayers(), tr._split.seq.size, quantize_errors


def test_seq_parallel_rejects_kernels(flat):
    """A seq mesh takes only kernels=False, the plain path (the reference's
    test_seq_parallel_rejects_pallas_kernels); kernels=False still raises
    without a seq mesh."""
    got = spawn_ranks(_seq_kernels_worker, 2, flat, timeout=TIMEOUT_S)
    for errors, plain, seq, quantize_errors in got:
        assert all(e is not None and "XLA attention path" in e and "plain attention path" in e for e in errors)
        assert plain and seq == 2
        seq_q, model_q = quantize_errors  # quantize takes a data mesh only
        assert seq_q is not None and "'seq' axis" in seq_q and "float weights" in seq_q
        assert model_q is not None and "'model' axis > 1" in model_q
    with pytest.raises(ValueError, match="kernel-free path"):
        TTranscriber(None, None, _cfg(TC), params=flat, device="cpu", kernels=False)
    with pytest.raises(TypeError, match="parakeet_tpu_torch.parallel.Mesh"):
        TTranscriber(None, None, _cfg(TC), params=flat, device="cpu", mesh=object())


# ─── the collectives ─────────────────────────────────────────────────────────


def _collectives_worker(rank):
    from parakeet_tpu_torch.parallel import collectives as CO

    mesh = TM.make_mesh(devices="cpu")  # ('data' 2, 'model' 1)
    data, one = mesh.axis("data"), mesh.axis("model")
    x = torch.arange(12, dtype=torch.float32).reshape(1, 3, 4) + 100 * rank  # this rank's block of frames
    emb = torch.arange(10, dtype=torch.float32).reshape(5, 2) + 10 * rank  # vocab rows [5·rank, 5·rank + 5)
    ids = torch.tensor([[0, 4, 5], [9, 7, 2]])
    return {
        "sum": CO.all_reduce_sum(torch.full((2,), rank + 1.0), data).tolist(),
        "gather": CO.gather_dim(x, data, 2).tolist(),
        "last": CO.gather_last(x[0, :1], data).tolist(),
        "halo": CO.halo_exchange(x, data, 1, dim=2).tolist(),
        "halo_one": CO.halo_exchange(x, one, 1, dim=2).tolist(),
        "embed": CO.parallel_embedding(emb, ids, data).tolist(),
        "results": CO.gather_results([f"r{rank}a", f"r{rank}b"], data),
        "single": CO.all_reduce_sum(torch.ones(2), one).tolist(),
    }


def test_collectives_match_their_single_process_forms():
    """Each collective over a 2-rank axis against what one process holding
    both blocks computes: the sum, the concatenation in axis order, halos
    of the neighbours' edge frames (zeros at the ends, as a zero-padded
    conv sees them), the masked embedding lookup, the result gather."""
    got = spawn_ranks(_collectives_worker, 2, timeout=TIMEOUT_S)
    blocks = [torch.arange(12, dtype=torch.float32).reshape(1, 3, 4) + 100 * r for r in range(2)]
    whole = torch.cat(blocks, dim=2)
    padded = torch.nn.functional.pad(whole, (1, 1))
    table = torch.cat([torch.arange(10, dtype=torch.float32).reshape(5, 2) + 10 * r for r in range(2)])
    for rank, g in enumerate(got):
        assert g["sum"] == [3.0, 3.0]
        assert g["gather"] == whole.tolist()
        assert g["last"] == torch.cat([b[0, :1] for b in blocks], dim=-1).tolist()
        assert g["halo"] == padded[:, :, 4 * rank: 4 * rank + 6].tolist()
        assert g["halo_one"] == torch.nn.functional.pad(blocks[rank], (1, 1)).tolist()
        assert g["embed"] == table[torch.tensor([[0, 4, 5], [9, 7, 2]])].tolist()
        assert g["results"] == ["r0a", "r0b", "r1a", "r1b"]
        assert g["single"] == [1.0, 1.0]


def _failing_worker(rank):
    import torch.distributed as dist

    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    dist.barrier()  # rank 0 waits in a collective rank 1 never reaches
    return rank


def _sleeping_worker(rank, seconds):
    import time

    time.sleep(seconds if rank == 0 else 0)
    return rank


def _killed_worker(rank):
    import os
    import signal

    import torch.distributed as dist

    if rank == 1:
        os.kill(os.getpid(), signal.SIGKILL)
    dist.barrier()  # rank 0 waits in a collective rank 1 never reaches
    return rank


def _fail_in_start():
    raise ValueError("this argument cannot be unpickled")


class _NoUnpickling:
    """An argument whose unpickling raises: a rank holding it dies in its
    start, before it joins the process group or runs fn."""

    def __reduce__(self):
        return _fail_in_start, ()


@pytest.mark.parametrize("how", ["killed", "start"])
def test_spawn_ranks_fails_on_a_rank_that_ends_without_a_report(how):
    """A rank whose process ends without a report (killed by a signal while
    the other waits in a collective, or dead in its start) fails the call
    within its grace, not at the timeout nor at START_TIMEOUT_S."""
    import time

    t0 = time.monotonic()
    if how == "killed":
        with pytest.raises(RuntimeError, match=r"rank 1:\nended with exit code -9 without a report"):
            spawn_ranks(_killed_worker, 2, timeout=300.0)
    else:
        with pytest.raises(RuntimeError, match=r"rank 0:\nended with exit code 1 without a report"):
            spawn_ranks(_sleeping_worker, 2, _NoUnpickling(), timeout=300.0)
    assert time.monotonic() - t0 < 150.0  # as in the test below: the ranks' start, then at most 5.5 s


def test_spawn_ranks_fails_on_a_failing_or_hanging_rank():
    """A rank's exception fails the call with its traceback while the other
    rank waits in a collective (killed, not waited for); a rank past the
    timeout fails it too; a clean run returns every rank's value. The
    timeouts count from the ranks' joining the process group; the clock
    around the first call also holds the ranks' start, which a loaded host
    stretches many times over, hence its room."""
    import time

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        spawn_ranks(_failing_worker, 2, timeout=300.0)
    assert time.monotonic() - t0 < 150.0  # not the timeout: the failure ended the wait
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"ranks \[0(, 1)?\] gave no result within 8 s"):
        spawn_ranks(_sleeping_worker, 2, 120.0, timeout=8.0)
    assert time.monotonic() - t0 >= 8.0  # at the timeout, not before it
    assert spawn_ranks(_sleeping_worker, 2, 0.0, timeout=60.0) == [0, 1]


def test_spawn_ranks_bounds_the_ranks_start(monkeypatch):
    """Ranks that have not joined the process group by START_TIMEOUT_S fail
    the call, named as such (no rank starts within 10 ms)."""
    from parakeet_tpu_torch.parallel import launch

    monkeypatch.setattr(launch, "START_TIMEOUT_S", 0.01)
    with pytest.raises(RuntimeError, match=r"ranks \[0, 1\] did not join the process group within 0.01 s"):
        spawn_ranks(_sleeping_worker, 2, 0.0, timeout=60.0)
