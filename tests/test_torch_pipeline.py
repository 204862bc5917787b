"""The port's GPipe pipeline (parallel/pipeline.py) against the JAX
reference's, on the CPU over gloo: ranks spawned with parallel/launch.py
spawn_ranks on a ('data', 'pipe') mesh.

split_layer_params / merge_layer_params (the reference's stacks, exact
inverses, its error); pipeline_encode on ragged lengths against the
reference's dense encoder (valid frames: pad rows hold garbage, as in the
port's encoder tests); the pipelined hybrid loss and every gradient
against `jax.value_and_grad` of the reference's dense loss, and the loss
against the reference's own make_pp_trainer step on the same mesh shape;
export_params; the reference's guards with its messages; a pp checkpoint
({layers, rest}, optax's nested treedef) read by the reference's
load_train_state, and the reverse.

Tolerances are the reference's own for its pipeline
(tests/test_pipeline.py): the encoding rtol 2e-4, atol 2e-5; gradients
rtol 2e-3, atol 1e-5, `*.mha_.k_proj.bias` (zero up to rounding: softmax
ignores a shift common to every key) below 1e-4; the loss within 1e-5 of
the reference's.

This module imports JAX only inside its tests: the spawned ranks import it
by name to reach its worker functions, and run the port alone."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from parakeet_tpu_torch import config as C
from parakeet_tpu_torch import params as P
from parakeet_tpu_torch import train as T
from parakeet_tpu_torch.parallel import mesh as TM
from parakeet_tpu_torch.parallel import pipeline as PP
from parakeet_tpu_torch.parallel.launch import spawn_ranks

ENC_RTOL, ENC_ATOL = 2e-4, 2e-5
GRAD_RTOL, GRAD_ATOL = 2e-3, 1e-5
ZERO_GRAD = 1e-4
LOSS_RTOL = 1e-5
TIMEOUT_S = 120.0
LENGTHS = [64, 37, 50, 64, 22, 64, 41, 9]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_cfg(M, num_layers=4):
    return M.TDTCTCConfig(
        encoder=M.EncoderConfig(mel_bins=80, subsampling_channels=8, hidden_size=16, num_layers=num_layers,
                                num_heads=2, ffn_intermediate=32),
        prediction=M.PredictionConfig(vocab_size=9, pred_hidden=8, num_lstm_layers=1),
        joint=M.JointConfig(encoder_hidden=16, pred_hidden=8, joint_hidden=8, vocab_size=9),
        ctc_vocab_size=9,
    )


def setup():
    cfg = tiny_cfg(C)
    flat = P.init_params_numpy(P.tdt_ctc_spec(cfg), seed=0)
    batch = T.synthetic_batch(cfg, 8, 64, 4, seed=1)
    batch["mel_lengths"] = np.array(LENGTHS, np.int32)
    batch["label_lengths"] = np.array([4, 2, 3, 4, 1, 2, 3, 1], np.int32)
    return cfg, flat, batch


# ─── workers (run in spawned ranks, port only) ───────────────────────────────


def _pp_worker(rank, pp, n_micro, ckpt_dir=None):
    """This rank's pipelined encoding of its 'data' rows, the reduced loss
    and whole gradients (schema keys), export_params, and with ckpt_dir a
    checkpoint after one step."""
    from parakeet_tpu_torch import checkpoint as CK

    cfg, flat, batch = setup()
    mesh = TM.make_mesh(pipeline_parallel=pp, devices="cpu")
    state, step, place, export = PP.make_pp_trainer(cfg, flat, mesh, n_micro=n_micro, loss="hybrid", sigma=0.05)
    b = place(batch)
    layers, rest = state.params["layers"], state.params["rest"]
    with torch.no_grad():
        enc = PP.pipeline_encode(layers, rest, cfg.encoder, b["features"], b["mel_lengths"], mesh=mesh,
                                 n_micro=n_micro)
    lval, grads = step.value_and_grad(state.params, b)
    whole = state.opt_state.layout.gather(grads)
    merged = PP.merge_layer_params({k: v.numpy() for (o, k), v in whole.items() if o == "layers"},
                                   {k: v.numpy() for (o, k), v in whole.items() if o == "rest"})
    exported = export(state.params)
    out = {"enc": enc.numpy(), "rows": (mesh.axis("data").index, mesh.axis("data").size), "loss": float(lval),
           "grads": merged, "export_ok": sorted(exported) == sorted(flat)
           and all(np.array_equal(exported[k], flat[k]) for k in flat),
           "local_layers": next(iter(layers.values())).shape[0]}
    if ckpt_dir is not None:
        step(state.params, state.opt_state, b)
        CK.save_train_state(ckpt_dir, state.params, state.opt_state, 1)
        out["params_after"] = export(state.params)
    return out


def _guard_worker(rank):
    cfg, flat, batch = setup()
    errors = {}
    for name, mesh_kw, cfg_i, kw in (("tp", dict(model_parallel=2), cfg, {}),
                                     ("layers", dict(pipeline_parallel=2), tiny_cfg(C, 3), {}),
                                     ("no_pipe", dict(), cfg, {})):
        mesh = TM.make_mesh(devices="cpu", **mesh_kw)
        try:
            params = flat if cfg_i is cfg else P.init_params_numpy(P.tdt_ctc_spec(cfg_i), seed=0)
            PP.make_pp_trainer(cfg_i, params, mesh, **kw)
            errors[name] = None
        except ValueError as e:
            errors[name] = str(e)
    mesh = TM.make_mesh(pipeline_parallel=2, devices="cpu")
    state, step, place, _ = PP.make_pp_trainer(cfg, flat, mesh, n_micro=3)
    try:
        step(state.params, state.opt_state, place(batch))
        errors["micro"] = None
    except ValueError as e:
        errors["micro"] = str(e)
    return errors


# ─── tests ───────────────────────────────────────────────────────────────────


def test_split_merge_round_trip_matches_reference():
    from parakeet_tpu.parallel import pipeline as RPP

    cfg, flat, _ = setup()
    stacked, rest = PP.split_layer_params(flat, cfg.encoder.num_layers)
    rstacked, rrest = RPP.split_layer_params(flat, cfg.encoder.num_layers)
    assert sorted(stacked) == sorted(rstacked) and sorted(rest) == sorted(rrest)
    for k in rstacked:
        np.testing.assert_array_equal(stacked[k], np.asarray(rstacked[k]))
    assert all(v.shape[0] == cfg.encoder.num_layers for v in stacked.values())
    assert not any(k.startswith(PP.LAYER_PREFIX) for k in rest)
    for merged in (PP.merge_layer_params(stacked, rest),
                   PP.merge_layer_params(*PP.split_layer_params({k: torch.from_numpy(v) for k, v in flat.items()},
                                                                cfg.encoder.num_layers))):
        assert sorted(merged) == sorted(flat)
        for k in flat:
            np.testing.assert_array_equal(np.asarray(merged[k]), flat[k])
    broken = {k: v for k, v in flat.items() if not k.startswith("encoder_.layers_.1.ffn1_.")}
    with pytest.raises(ValueError) as want:
        RPP.split_layer_params(broken, cfg.encoder.num_layers)
    with pytest.raises(ValueError, match="not schema-uniform") as got:
        PP.split_layer_params(broken, cfg.encoder.num_layers)
    assert str(got.value) == str(want.value)


_REF = {}


def _reference():
    """The reference's dense encoding and jax.value_and_grad of its hybrid
    loss (once in this process)."""
    if not _REF:
        import jax
        import jax.numpy as jnp

        from parakeet_tpu import config as RC
        from parakeet_tpu import train as RT
        from parakeet_tpu.models.encoder import encoded_lengths, fastconformer_encode
        from parakeet_tpu.params import Params

        rcfg = tiny_cfg(RC)
        _, flat, batch = setup()
        jp = {k: jnp.asarray(v) for k, v in flat.items()}
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        _REF["enc"] = np.asarray(fastconformer_encode(Params(jp).sub("encoder_"), rcfg.encoder, jb["features"],
                                                      jb["mel_lengths"]))
        _REF["enc_lens"] = np.asarray(encoded_lengths(jb["mel_lengths"]))
        loss, grads = jax.jit(jax.value_and_grad(lambda p, b: RT.hybrid_loss_fn(p, rcfg, b, sigma=0.05)))(jp, jb)
        _REF["loss"], _REF["grads"] = float(loss), {k: np.asarray(g) for k, g in grads.items()}
    return _REF


@pytest.mark.parametrize("world,pp,n_micro", [(2, 2, 2), (4, 4, 1), (4, 2, 2)])
def test_pipeline_encode_loss_and_grads_match_reference(world, pp, n_micro):
    """Ragged lengths ride the microbatches; every rank's encoding of its
    'data' rows is the dense encoder's, every key's gradient the dense
    loss's (the factor of P a replicated encoding's gradient could pick up
    is pinned here), export_params the schema params."""
    ref = _reference()
    got = spawn_ranks(_pp_worker, world, pp, n_micro, timeout=TIMEOUT_S)
    for rank, g in enumerate(got):
        index, size = g["rows"]
        for i in range(index * 8 // size, (index + 1) * 8 // size):  # valid frames (pad rows hold garbage)
            n = int(ref["enc_lens"][i])
            np.testing.assert_allclose(g["enc"][i - index * 8 // size, :n], ref["enc"][i, :n], rtol=ENC_RTOL,
                                       atol=ENC_ATOL)
        assert g["local_layers"] == 4 // pp and g["export_ok"]
        assert g["loss"] == pytest.approx(ref["loss"], rel=LOSS_RTOL), rank
        assert sorted(g["grads"]) == sorted(ref["grads"])
        for k, want in ref["grads"].items():
            if k.endswith(".mha_.k_proj.bias"):
                assert float(np.abs(want).max()) < ZERO_GRAD and float(np.abs(g["grads"][k]).max()) < ZERO_GRAD
                continue
            np.testing.assert_allclose(g["grads"][k], want, rtol=GRAD_RTOL, atol=GRAD_ATOL, err_msg=f"{rank} {k}")


def test_pp_trainer_loss_matches_reference_trainer():
    """The reference's make_pp_trainer on its virtual devices, ('data' 2,
    'pipe' 2): the same step loss as the port's."""
    import jax

    from parakeet_tpu import config as RC
    from parakeet_tpu.parallel import mesh as RM
    from parakeet_tpu.parallel import pipeline as RPP

    _, flat, batch = setup()
    rmesh = RM.make_mesh(4, devices=jax.devices()[:4], pipeline_parallel=2)
    state, step, place, _ = RPP.make_pp_trainer(tiny_cfg(RC), flat, rmesh, n_micro=2, loss="hybrid", sigma=0.05)
    want = float(step(state.params, state.opt_state, place(batch))[2])
    got = spawn_ranks(_pp_worker, 4, 2, 2, timeout=TIMEOUT_S)
    for g in got:
        assert g["loss"] == pytest.approx(want, rel=LOSS_RTOL)


def test_pp_guards_raise_the_reference_errors():
    import jax

    from parakeet_tpu import config as RC
    from parakeet_tpu.parallel import mesh as RM
    from parakeet_tpu.parallel import pipeline as RPP

    got = spawn_ranks(_guard_worker, 2, timeout=TIMEOUT_S)[0]
    cfg, flat, _ = setup()
    devs = jax.devices()[:2]
    with pytest.raises(ValueError) as e:
        RPP.make_pp_trainer(tiny_cfg(RC), flat, RM.make_mesh(2, devices=devs, model_parallel=2))
    assert got["tp"] == str(e.value)
    stacked, rest = RPP.split_layer_params(flat, 4)
    with pytest.raises(ValueError) as e:
        RPP.pipeline_encode(stacked, rest, tiny_cfg(RC, 3).encoder, None, None,
                            mesh=RM.make_mesh(2, devices=devs, pipeline_parallel=2), n_micro=2)
    assert got["layers"] == str(e.value) == "3 layers not divisible by pipe=2"
    with pytest.raises(ValueError) as e:
        RPP.pipeline_encode(stacked, rest, tiny_cfg(RC).encoder, None, None, mesh=RM.make_mesh(2, devices=devs),
                            n_micro=2)
    assert got["no_pipe"] == str(e.value)
    # the reference raises this one while tracing its shard_map stage: the same words
    assert got["micro"] == "local batch 8 not divisible by n_micro=3"


def test_pp_checkpoint_crosses_packages(tmp_path):
    """A pp2 checkpoint: the port writes the schema params and optax's
    leaves over {layers, rest} (stages gathered), which the reference's
    load_train_state reads under its pp trainer's treedef; the reference's
    loads in the port and splits into each stage's layers."""
    import jax

    from parakeet_tpu import checkpoint as RCK
    from parakeet_tpu import config as RC
    from parakeet_tpu.parallel import mesh as RM
    from parakeet_tpu.parallel import pipeline as RPP

    got = spawn_ranks(_pp_worker, 2, 2, 2, str(tmp_path / "port"), timeout=TIMEOUT_S)
    _, flat, batch = setup()
    rmesh = RM.make_mesh(2, devices=jax.devices()[:2], pipeline_parallel=2)
    rstate, rstep, rplace, rexport = RPP.make_pp_trainer(tiny_cfg(RC), flat, rmesh, n_micro=2, loss="hybrid",
                                                         sigma=0.05)
    p, o, s = RCK.load_train_state(tmp_path / "port", rstate.opt_state)
    assert s == 1 and sorted(p) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(p[k], got[0]["params_after"][k], err_msg=k)
    assert int(jax.tree_util.tree_leaves(o)[0]) == 1

    tp, ro, _ = rstep(rstate.params, rstate.opt_state, rplace(batch))
    RCK.save_train_state(tmp_path / "ref", rexport(tp), ro, 5)
    ref_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(ro)]
    back = spawn_ranks(_load_worker, 2, str(tmp_path / "ref"), timeout=TIMEOUT_S)
    whole_params = rexport(tp)
    for rank, (params, leaves, step) in enumerate(back):
        assert step == 5
        assert len(leaves) == len(ref_leaves)
        stacked, rest = PP.split_layer_params(whole_params, 4)
        for k, v in rest.items():
            np.testing.assert_array_equal(params["rest"][k], np.asarray(v))
        for k, v in stacked.items():
            np.testing.assert_array_equal(params["layers"][k], np.asarray(v)[rank * 2:(rank + 1) * 2])
        np.testing.assert_array_equal(leaves[0], ref_leaves[0])
        for got_leaf, want in zip(leaves[1:], ref_leaves[1:]):
            if got_leaf.shape == want.shape:
                np.testing.assert_array_equal(got_leaf, want)
            else:  # a stacked layer's moments: this stage's rows
                np.testing.assert_array_equal(got_leaf, want[rank * 2:(rank + 1) * 2])


def _load_worker(rank, ref_dir):
    from parakeet_tpu_torch import checkpoint as CK
    from parakeet_tpu_torch.train_loop import place_train_state

    cfg, flat, _ = setup()
    mesh = TM.make_mesh(pipeline_parallel=2, devices="cpu")
    state, _, _, _ = PP.make_pp_trainer(cfg, flat, mesh, n_micro=2, loss="hybrid", sigma=0.05)
    p2, o2, s2 = CK.load_train_state(ref_dir, state.opt_state)
    layers, rest = PP.split_layer_params(p2, cfg.encoder.num_layers)
    loaded = place_train_state(mesh, {"layers": layers, "rest": rest}, o2, s2, state)
    return ({o: {k: v.numpy() for k, v in d.items()} for o, d in loaded.params.items()},
            [x.numpy() for x in loaded.opt_state.leaves()], loaded.step)
