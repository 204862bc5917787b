"""The port's training on a mesh (train.py make_sharded_trainer with a mesh,
parallel/collectives.py's backward rules, the mesh-aware checkpoint and
place_train_state) against the JAX reference, on the CPU over gloo: ranks
spawned with parallel/launch.py spawn_ranks.

On dp2, dp1×tp2, dp2×tp2, dp1×sp2 and dp1×sp2×tp2 every rank's loss and
every key's gradient (gathered over 'model', vocab padding cut) of the
CTC, TDT, RNNT and hybrid objectives, and of Sortformer on dp2 and
dp1×tp2, against `jax.value_and_grad` of the reference's loss on the same
params and batch, and the CTC loss against the reference's own
`make_sharded_trainer` step on the same mesh shape over its 8 virtual
devices (CTC: the cheapest step to compile). Clipping on a tp mesh (the
whole gradient's norm, and the loss three steps on against the
single-device port trainer's), remat with
gradient accumulation on a mesh, and a tp checkpoint (vocab padded) read
by the reference's `load_train_state` and the reverse.

Tolerances: each key's gradient within 1e-5 of that key's max |g| (the
single-device bound of tests/test_torch_train.py, here for every
objective); `*.mha_.k_proj.bias`, whose gradient is zero up to rounding
(softmax ignores a shift common to every key), below 1e-4 on both sides;
losses rtol 1e-5 (CTC: 1e-4, torch's ctc_loss and optax's are two
algorithms with their own f32 rounding, as in tests/test_torch_train.py).

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
from parakeet_tpu_torch.parallel.launch import spawn_ranks

GRAD_SCALE_FRAC = 1e-5
ZERO_GRAD = 1e-4
LOSS_RTOL = {"ctc": 1e-4}
LOSS_RTOL_DEFAULT = 1e-5
TIMEOUT_S = 120.0
ASR = ("ctc", "tdt", "rnnt", "hybrid")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _enc(M):
    return M.EncoderConfig(mel_bins=80, subsampling_channels=8, hidden_size=16, num_layers=2, num_heads=2,
                           ffn_intermediate=32)


def _heads(M):
    # vocab 17: a 'model' axis of 2 pads it to 18
    return dict(prediction=M.PredictionConfig(vocab_size=17, pred_hidden=8, num_lstm_layers=1),
                joint=M.JointConfig(encoder_hidden=16, pred_hidden=8, joint_hidden=8, vocab_size=17))


def tdt_ctc_cfg(M):
    return M.TDTCTCConfig(encoder=_enc(M), ctc_vocab_size=17, **_heads(M))


def rnnt_cfg(M):
    return M.RNNTConfig(encoder=_enc(M), **_heads(M))


def sortformer_cfg(M):
    # heads and FFN widths that divide a 'model' axis of 2
    return M.SortformerConfig(
        nest_encoder=M.StreamingEncoderConfig(
            mel_bins=128, subsampling_channels=8, hidden_size=24, num_layers=2, num_heads=2, ffn_intermediate=32,
            conv_kernel_size=5, att_context_left=6, att_context_right=0, subsampling_activation="relu",
            xscaling=True),
        encoder_hidden=24, transformer_hidden=12,
        transformer=M.TransformerConfig(hidden_size=12, num_layers=2, num_heads=2, ffn_intermediate=24,
                                        pre_ln=False, has_final_norm=False),
        max_speakers=4)


def asr_batch(cfg):
    """Four items with mixed mel and label lengths (pads exercised)."""
    b = T.synthetic_batch(cfg, 4, 96, 7, seed=3)
    b["mel_lengths"] = np.array([96, 80, 71, 57], np.int32)
    b["label_lengths"] = np.array([7, 5, 3, 6], np.int32)
    return b


def sortformer_batch(cfg):
    b = T.synthetic_sortformer_batch(cfg, 4, 96, seed=3)
    b["mel_lengths"] = np.array([96, 81, 60, 77], np.int32)
    return b


# objective → (config maker, spec name, batch maker)
OBJECTIVES = {
    "ctc": (tdt_ctc_cfg, "tdt_ctc_spec", asr_batch),
    "tdt": (tdt_ctc_cfg, "tdt_ctc_spec", asr_batch),
    "rnnt": (rnnt_cfg, "rnnt_spec", asr_batch),
    "hybrid": (tdt_ctc_cfg, "tdt_ctc_spec", asr_batch),
    "sortformer": (sortformer_cfg, "sortformer_spec", sortformer_batch),
}


def objective(name: str, M=C):
    make_cfg, spec, make_batch = OBJECTIVES[name]
    cfg = make_cfg(M)
    flat = P.init_params_numpy(getattr(P, spec)(make_cfg(C)), seed=7)
    return cfg, flat, make_batch(make_cfg(C))


def _unpad(grads: dict, flat: dict) -> dict:
    """Whole gradients cut to the schema shapes (the vocab padding off)."""
    return {k: v[tuple(slice(0, n) for n in flat[k].shape)] for k, v in grads.items()}


# ─── workers (run in spawned ranks, port only) ───────────────────────────────


def _grads_worker(rank, mesh_kw, names, trainer_kw):
    """Each objective's reduced loss and whole gradients on this rank's mesh."""
    mesh = TM.make_mesh(devices="cpu", **mesh_kw)
    out = {}
    for name in names:
        cfg, flat, batch = objective(name)
        _, state, step, place = T.make_sharded_trainer(cfg, flat, mesh, loss=name, sigma=0.05, device="cpu",
                                                       **trainer_kw)
        lval, grads = step.value_and_grad(state.params, place(batch))
        whole = state.opt_state.layout.gather(grads)
        out[name] = (float(lval), {k: v.numpy() for k, v in _unpad(whole, flat).items()})
    return out


MESHES = {
    "dp2": (2, dict(), ASR + ("sortformer",)),
    "dp1xtp2": (2, dict(model_parallel=2), ASR + ("sortformer",)),
    "dp2xtp2": (4, dict(model_parallel=2), ASR),
    "dp1xsp2": (2, dict(seq_parallel=2), ASR),
    "dp1xsp2xtp2": (4, dict(model_parallel=2, seq_parallel=2), ASR),
}


# ─── the reference ───────────────────────────────────────────────────────────

_REFERENCE = {}


def reference(name: str):
    """jax.value_and_grad of the reference's loss on the objective's params
    and batch (once per objective in this process)."""
    if name not in _REFERENCE:
        import jax
        import jax.numpy as jnp

        from parakeet_tpu import config as RC
        from parakeet_tpu import train as RT

        cfg, flat, batch = objective(name, RC)
        fn = {"ctc": lambda p, b: RT.ctc_loss_fn(p, cfg, b, cfg.ctc_vocab_size - 1),
              "tdt": lambda p, b: RT.transducer_loss_fn(p, cfg, b, loss="tdt", sigma=0.05),
              "rnnt": lambda p, b: RT.transducer_loss_fn(p, cfg, b, loss="rnnt", sigma=0.05),
              "hybrid": lambda p, b: RT.hybrid_loss_fn(p, cfg, b, sigma=0.05),
              "sortformer": lambda p, b: RT.sortformer_loss_fn(p, cfg, b, sort_weight=0.5)}[name]
        lval, grads = jax.jit(jax.value_and_grad(fn))({k: jnp.asarray(v) for k, v in flat.items()},
                                                      {k: jnp.asarray(v) for k, v in batch.items()})
        _REFERENCE[name] = (float(lval), {k: np.asarray(g) for k, g in grads.items()})
    return _REFERENCE[name]


def assert_matches(tag: str, got_loss: float, got: dict, want_loss: float, want: dict, name: str) -> None:
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL.get(name, LOSS_RTOL_DEFAULT)), tag
    assert sorted(got) == sorted(want), tag
    for k in want:
        g, w = got[k], want[k]
        assert g.shape == w.shape, (tag, k)
        if k.endswith(".mha_.k_proj.bias"):
            assert float(np.abs(w).max()) < ZERO_GRAD and float(np.abs(g).max()) < ZERO_GRAD, (tag, k)
            continue
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= GRAD_SCALE_FRAC * scale, f"{tag} {k}: {err:.3e} vs scale {scale:.3e}"


def _reference_mesh_loss(name: str, world: int, mesh_kw: dict) -> float:
    """The loss of the reference's make_sharded_trainer step on its virtual
    devices, a mesh of the same shape."""
    import jax

    from parakeet_tpu import config as RC
    from parakeet_tpu import train as RT
    from parakeet_tpu.parallel import mesh as RM

    cfg, flat, batch = objective(name, RC)
    mesh = RM.make_mesh(world, devices=jax.devices()[:world], **mesh_kw)
    _, state, step, place = RT.make_sharded_trainer(cfg, flat, mesh, loss=name, sigma=0.05)
    return float(step(state.params, state.opt_state, place(batch))[2])


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_loss_and_every_gradient_match_reference(name):
    world, mesh_kw, names = MESHES[name]
    got = spawn_ranks(_grads_worker, world, mesh_kw, names, {}, timeout=TIMEOUT_S)
    for obj in names:
        want_loss, want = reference(obj)
        for rank, res in enumerate(got):
            assert_matches(f"{name} rank {rank} {obj}", *res[obj], want_loss, want, obj)
    # the reference's own trainer on the same mesh shape: the same global loss
    ref_mesh = _reference_mesh_loss("ctc", world, mesh_kw)
    assert got[0]["ctc"][0] == pytest.approx(ref_mesh, rel=LOSS_RTOL["ctc"])


def test_remat_and_accumulation_on_a_mesh_match_reference():
    """remat (each block under torch.utils.checkpoint, its collectives run
    again in backward) and accum_steps=2 over each rank's rows, dp2×tp2."""
    got = spawn_ranks(_grads_worker, 4, dict(model_parallel=2), ("hybrid", "rnnt"),
                      dict(remat=True, accum_steps=2), timeout=TIMEOUT_S)
    for obj in ("hybrid", "rnnt"):
        want_loss, want = reference(obj)
        for rank, res in enumerate(got):
            assert_matches(f"remat+accum rank {rank} {obj}", *res[obj], want_loss, want, obj)


def _clip_worker(rank, steps, clip):
    """The whole gradient's norm from a tp mesh's shards, and the losses of
    `steps` clipped steps."""
    mesh = TM.make_mesh(model_parallel=2, devices="cpu")
    cfg, flat, batch = objective("hybrid")
    _, state, step, place = T.make_sharded_trainer(cfg, flat, mesh, loss="hybrid", sigma=0.05, device="cpu",
                                                   clip_norm=clip, learning_rate=1e-2)
    b = place(batch)
    _, grads = step.value_and_grad(state.params, b)
    keys = sorted(grads)
    norm = float(state.opt_state.layout.global_norm(keys, [grads[k] for k in keys]))
    losses = [float(step(state.params, state.opt_state, b)[2]) for _ in range(steps)]
    return norm, losses


def test_clip_norm_on_a_tp_mesh_uses_the_whole_gradient():
    """Clipping scales by the whole gradient's norm (each 'model' shard's
    squares summed over the axis, padding adding zeros): the norm equals
    the single-device gradient's, and three clipped steps give the
    single-device trainer's losses (Adam's first step ignores a global
    scale, its second does not)."""
    cfg, flat, batch = objective("hybrid")
    _, state, step, place = T.make_sharded_trainer(cfg, flat, loss="hybrid", sigma=0.05, device="cpu",
                                                   clip_norm=0.5, learning_rate=1e-2)
    b = place(batch)
    _, grads = T.value_and_grad_accum(lambda p, x: T.hybrid_loss_fn(p, cfg, x, sigma=0.05))(state.params, b)
    want_norm = float(torch.linalg.vector_norm(torch.stack([g.norm() for g in grads.values()])))
    want = [float(step(state.params, state.opt_state, b)[2]) for _ in range(3)]
    for norm, losses in spawn_ranks(_clip_worker, 2, 3, 0.5, timeout=TIMEOUT_S):
        assert norm == pytest.approx(want_norm, rel=1e-5)
        assert want_norm > 0.5  # the clip is active
        np.testing.assert_allclose(losses, want, rtol=1e-5)


# ─── checkpoints across packages ─────────────────────────────────────────────


def _ckpt_worker(rank, out_dir, ref_dir):
    """A tp2 step, saved (gathered, padded); then the reference's padded
    checkpoint loaded and sharded: this rank's shards back."""
    from parakeet_tpu_torch import checkpoint as CK
    from parakeet_tpu_torch.train_loop import place_train_state

    mesh = TM.make_mesh(model_parallel=2, devices="cpu")
    cfg, flat, batch = objective("hybrid")
    _, state, step, place = T.make_sharded_trainer(cfg, flat, mesh, loss="hybrid", sigma=0.05, device="cpu")
    step(state.params, state.opt_state, place(batch))
    CK.save_train_state(out_dir, state.params, state.opt_state, 1)
    p2, o2, s2 = CK.load_train_state(ref_dir, state.opt_state)
    loaded = place_train_state(mesh, p2, o2, s2, state)
    return ({k: v.numpy() for k, v in loaded.params.items()},
            [x.numpy() for x in loaded.opt_state.leaves()], loaded.step, loaded.opt_state.steps)


def test_tp_checkpoint_crosses_packages(tmp_path):
    """The port's tp2 checkpoint holds the whole vocab-padded arrays the
    reference's trainer holds, under optax's treedef: the reference's
    load_train_state reads it; the reference's own tp2 checkpoint loads in
    the port and shards to each rank's slices."""
    import jax

    from parakeet_tpu import checkpoint as RCK
    from parakeet_tpu import config as RC
    from parakeet_tpu import train as RT
    from parakeet_tpu.parallel import mesh as RM

    rcfg, flat, batch = objective("hybrid", RC)
    rmesh = RM.make_mesh(2, devices=jax.devices()[:2], model_parallel=2)
    _, rstate, rstep, rplace = RT.make_sharded_trainer(rcfg, flat, rmesh, loss="hybrid", sigma=0.05)
    rp, ro, _ = rstep(rstate.params, rstate.opt_state, rplace(batch))
    RCK.save_train_state(tmp_path / "ref", rp, ro, 3)
    got = spawn_ranks(_ckpt_worker, 2, str(tmp_path / "port"), str(tmp_path / "ref"), timeout=TIMEOUT_S)

    # the reference reads the port's file: whole padded params, the same leaves' shapes
    p, o, s = RCK.load_train_state(tmp_path / "port", ro)
    assert s == 1
    assert sorted(p) == sorted(rp)
    for k in rp:
        assert p[k].shape == rp[k].shape, k
    assert p["tdt_joint_.label_proj_.weight"].shape == (18, 8)
    for a, b in zip(jax.tree_util.tree_leaves(o), jax.tree_util.tree_leaves(ro)):
        assert np.shape(a) == np.shape(b)

    # the port reads the reference's and shards it: each rank's slices of the whole
    ref_params = {k: np.asarray(v) for k, v in rp.items()}
    ref_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(ro)]
    mesh_rules = type("M", (), {"shape": {"model": 2}})()
    keys = sorted(ref_params)
    for rank, (params, leaves, step, steps) in enumerate(got):
        assert step == 3 and steps == 1
        for k in keys:
            dim = TM.param_sharding_rules(k, mesh_rules)
            want = ref_params[k]
            if dim is not None:
                n = want.shape[dim] // 2
                want = want[(slice(None),) * dim + (slice(rank * n, (rank + 1) * n),)]
            np.testing.assert_array_equal(params[k], want, err_msg=k)
        n = len(keys)
        for i, k in enumerate(keys):  # mu, then nu: the same slices
            dim = TM.param_sharding_rules(k, mesh_rules)
            for j in (1 + i, 1 + n + i):
                want = ref_leaves[j]
                if dim is not None:
                    m = want.shape[dim] // 2
                    want = want[(slice(None),) * dim + (slice(rank * m, (rank + 1) * m),)]
                np.testing.assert_array_equal(leaves[j], want, err_msg=k)
