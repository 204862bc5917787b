"""The port's training steps (parakeet_tpu_torch/train.py) against the JAX
package's on the same seeded numpy params and batches, on the CPU: every
objective's loss and every key's gradient, remat and gradient
accumulation, bf16, the optimizer against optax step for step, the
checkpoint layout in both directions, train_neural_lm, the encoder under
grad with K1's autograd Function, and the guard on the other kernels."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from parakeet_tpu import config as RC
from parakeet_tpu import params as RP
from parakeet_tpu import train as RT
from parakeet_tpu import checkpoint as RCK
from parakeet_tpu_torch import config as C
from parakeet_tpu_torch import params as P
from parakeet_tpu_torch import train as T
from parakeet_tpu_torch import checkpoint as CK



@pytest.fixture(autouse=True)
def one_torch_thread():
    """The port's tiny CPU ops run ~40x faster on one thread than on a pool
    that shares the host's cores with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


LOSS_RTOL = 1e-4
# every key's gradient: rtol 1e-4 and an atol of 1e-6 times the key's scale
# (max |g|, at least 1): f32 sums over B·T' terms leave ~1e-6 of the scale
# in both packages, which an element near zero in a key of scale ~3
# exceeds. CTC's gradients are formed by two algorithms (optax
# differentiates its forward recursion, torch's ctc_loss uses the
# alpha-beta posteriors), each with its own f32 rounding: measured 5.8e-6
# of the scale at most here, so CTC alone gets 1e-5.
GRAD_RTOL = 1e-4
GRAD_ATOL = {"ctc": 1e-5}
GRAD_ATOL_DEFAULT = 1e-6


def _enc(M, layers=2):
    return M.EncoderConfig(mel_bins=80, subsampling_channels=8, hidden_size=16, num_layers=layers, num_heads=2,
                           ffn_intermediate=32)


def _heads(M):
    return dict(prediction=M.PredictionConfig(vocab_size=17, pred_hidden=8, num_lstm_layers=1),
                joint=M.JointConfig(encoder_hidden=16, pred_hidden=8, joint_hidden=8, vocab_size=17))


def tdt_ctc_cfg(M):
    return M.TDTCTCConfig(encoder=_enc(M), ctc_vocab_size=17, **_heads(M))


def rnnt_cfg(M):
    return M.RNNTConfig(encoder=_enc(M), **_heads(M))


def sortformer_cfg(M):
    return M.SortformerConfig(
        nest_encoder=M.StreamingEncoderConfig(
            mel_bins=128, subsampling_channels=8, hidden_size=24, num_layers=2, num_heads=2, ffn_intermediate=32,
            conv_kernel_size=5, att_context_left=6, att_context_right=0, subsampling_activation="relu",
            xscaling=True),
        encoder_hidden=24, transformer_hidden=12,
        transformer=M.TransformerConfig(hidden_size=12, num_layers=2, num_heads=2, ffn_intermediate=24,
                                        pre_ln=False, has_final_norm=False),
        max_speakers=4)


def asr_batch(cfg, seed=3):
    """synthetic_batch with mixed mel and label lengths (pads exercised)."""
    b = RT.synthetic_batch(cfg, batch=4, mel_frames=96, max_labels=7, seed=seed)
    b["mel_lengths"] = np.array([96, 80, 71, 57], np.int32)
    b["label_lengths"] = np.array([7, 5, 3, 6], np.int32)
    return b


def sortformer_batch(cfg, seed=3):
    b = RT.synthetic_sortformer_batch(cfg, batch=3, mel_frames=96, seed=seed)
    b["mel_lengths"] = np.array([96, 81, 60], np.int32)
    return b


# objective → (config maker, spec, batch maker, reference loss, port loss)
OBJECTIVES = {
    "ctc": (tdt_ctc_cfg, "tdt_ctc_spec", asr_batch,
            lambda M, cfg: lambda p, b: M.ctc_loss_fn(p, cfg, b, cfg.ctc_vocab_size - 1)),
    "rnnt": (rnnt_cfg, "rnnt_spec", asr_batch,
             lambda M, cfg: lambda p, b: M.transducer_loss_fn(p, cfg, b, loss="rnnt")),
    "tdt": (tdt_ctc_cfg, "tdt_ctc_spec", asr_batch,
            lambda M, cfg: lambda p, b: M.transducer_loss_fn(p, cfg, b, loss="tdt", sigma=0.05)),
    "hybrid": (tdt_ctc_cfg, "tdt_ctc_spec", asr_batch,
               lambda M, cfg: lambda p, b: M.hybrid_loss_fn(p, cfg, b, sigma=0.05)),
    "sortformer": (sortformer_cfg, "sortformer_spec", sortformer_batch,
                   lambda M, cfg: lambda p, b: M.sortformer_loss_fn(p, cfg, b, sort_weight=0.5)),
}


def setup(objective, seed=0):
    make_cfg, spec_name, make_batch, make_loss = OBJECTIVES[objective]
    rcfg, cfg = make_cfg(RC), make_cfg(C)
    flat = P.init_params_numpy(getattr(P, spec_name)(cfg), seed=seed)
    batch = make_batch(rcfg)
    return rcfg, cfg, flat, batch, make_loss(RT, rcfg), make_loss(T, cfg)


def torch_params(flat):
    return {k: torch.from_numpy(v.copy()) for k, v in flat.items()}


def torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


_REFERENCE_VAG = {}


def reference_grads(objective, flat, batch, ref_loss):
    """jax.value_and_grad of the reference's loss, jitted once per objective
    in this process (a compile costs seconds; eager scans cost more)."""
    vag = _REFERENCE_VAG.setdefault(objective, jax.jit(jax.value_and_grad(ref_loss)))
    lval, grads = vag({k: jnp.asarray(v) for k, v in flat.items()}, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(lval), {k: np.asarray(g) for k, g in grads.items()}


@pytest.mark.parametrize("objective", sorted(OBJECTIVES))
def test_objective_loss_and_every_gradient_match_reference(objective):
    rcfg, cfg, flat, batch, ref_loss, port_loss = setup(objective)
    want_l, want_g = reference_grads(objective, flat, batch, ref_loss)
    got_l, got_g = T.value_and_grad_accum(port_loss)(torch_params(flat), torch_batch(batch))
    assert float(got_l) == pytest.approx(want_l, rel=LOSS_RTOL)
    assert sorted(got_g) == sorted(want_g)
    for k in want_g:
        atol = GRAD_ATOL.get(objective, GRAD_ATOL_DEFAULT) * max(1.0, float(np.abs(want_g[k]).max()))
        np.testing.assert_allclose(got_g[k].numpy(), want_g[k], rtol=GRAD_RTOL, atol=atol, err_msg=k)


@pytest.mark.parametrize("objective", ["hybrid", "sortformer"])
def test_remat_and_accum_equal_the_plain_gradients(objective):
    _, cfg, flat, batch, _, _ = setup(objective)
    kw = dict(sigma=0.05) if objective == "hybrid" else {}
    fn = T.hybrid_loss_fn if objective == "hybrid" else T.sortformer_loss_fn
    params, tb = torch_params(flat), torch_batch(batch)
    if objective == "sortformer":  # an even batch for two chunks
        tb = {k: torch.cat([v, v[:1]]) for k, v in tb.items()}
    plain_l, plain_g = T.value_and_grad_accum(lambda p, b: fn(p, cfg, b, **kw))(params, tb)
    remat_l, remat_g = T.value_and_grad_accum(lambda p, b: fn(p, cfg, b, remat=True, **kw))(params, tb)
    acc_l, acc_g = T.value_and_grad_accum(lambda p, b: fn(p, cfg, b, **kw), accum_steps=2)(params, tb)
    for l, g in ((remat_l, remat_g), (acc_l, acc_g)):
        assert float(l) == pytest.approx(float(plain_l), rel=1e-6)
        for k in plain_g:
            np.testing.assert_allclose(g[k].numpy(), plain_g[k].numpy(), rtol=1e-6, atol=1e-6, err_msg=k)


def test_accum_rejects_an_indivisible_batch():
    _, cfg, flat, batch, _, port_loss = setup("ctc")
    with pytest.raises(ValueError, match="not divisible"):
        T.value_and_grad_accum(port_loss, accum_steps=3)(torch_params(flat), torch_batch(batch))


def test_bf16_step_is_finite_and_near_f32():
    _, cfg, flat, batch, _, _ = setup("hybrid")
    fn = lambda p, b: T.hybrid_loss_fn(p, cfg, b, sigma=0.05)  # noqa: E731
    f32_l, _ = T.value_and_grad_accum(fn)(torch_params(flat), torch_batch(batch))
    bf_l, bf_g = T.value_and_grad_accum(T.with_compute_dtype(fn, "bfloat16"))(torch_params(flat), torch_batch(batch))
    assert np.isfinite(float(bf_l))
    assert all(g.dtype == torch.float32 and torch.isfinite(g).all() for g in bf_g.values())
    assert abs(float(bf_l) - float(f32_l)) <= 0.02 * abs(float(f32_l))


def test_transducer_lattice_sniffs_the_joint_prefix():
    _, cfg, flat, batch, _, _ = setup("rnnt")
    tb = torch_batch(batch)
    enc = torch.randn(4, 12, 16)
    out = T.transducer_lattice(torch_params(flat), cfg, enc, tb["labels"], loss="rnnt")
    assert out.shape == (4, 12, 8, 17)


# ─── the optimizer against optax ────────────────────────────────────────────

SCHEDULES = [("constant", 0), ("constant", 2), ("cosine", 2), ("noam", 2)]


@pytest.mark.parametrize("clip", [None, 0.05])
@pytest.mark.parametrize("schedule,warmup", SCHEDULES)
def test_adamw_matches_optax_for_five_steps(schedule, warmup, clip):
    rng = np.random.RandomState(11)
    flat = {"a.weight": rng.randn(5, 3).astype(np.float32), "b.norm_.bias": rng.randn(4).astype(np.float32),
            "c": rng.randn(2, 2, 2).astype(np.float32)}
    grads = [{k: (0.1 * rng.randn(*v.shape)).astype(np.float32) for k, v in flat.items()} for _ in range(5)]
    lr_ref = RT.make_lr_schedule(1e-2, schedule=schedule, warmup_steps=warmup, decay_steps=5)
    lr = T.make_lr_schedule(1e-2, schedule=schedule, warmup_steps=warmup, decay_steps=5)
    opt_ref = optax.adamw(lr_ref)
    if clip is not None:
        opt_ref = optax.chain(optax.clip_by_global_norm(clip), opt_ref)
    opt = T.adamw(lr, clip_norm=clip)
    ref_p = {k: jnp.asarray(v) for k, v in flat.items()}
    ref_s = opt_ref.init(ref_p)
    params = torch_params(flat)
    state = opt.init(params)
    assert state.treedef == str(jax.tree_util.tree_structure(ref_s))
    for g in grads:
        upd, ref_s = opt_ref.update({k: jnp.asarray(v) for k, v in g.items()}, ref_s, ref_p)
        ref_p = optax.apply_updates(ref_p, upd)
        opt.update(params, torch_params(g), state)
        for k in flat:
            np.testing.assert_allclose(params[k].numpy(), np.asarray(ref_p[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    ref_leaves = jax.tree_util.tree_leaves(ref_s)
    assert len(ref_leaves) == len(state.leaves())
    for want, got in zip(ref_leaves, state.leaves()):
        assert np.asarray(want).dtype == got.numpy().dtype
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-9)


def test_warmup_from_zero_leaves_step_one_unchanged():
    flat = {"w": np.ones((3,), np.float32)}
    params = torch_params(flat)
    opt = T.adamw(T.make_lr_schedule(1e-2, warmup_steps=4))
    state = opt.init(params)
    opt.update(params, {"w": torch.ones(3)}, state)
    assert torch.equal(params["w"], torch.ones(3))
    opt.update(params, {"w": torch.ones(3)}, state)
    assert not torch.equal(params["w"], torch.ones(3))


# ─── checkpoints in both directions ─────────────────────────────────────────


def test_jax_checkpoint_resumes_in_the_port_and_port_checkpoint_reads_in_the_reference(tmp_path):
    rcfg, cfg, flat, batch, ref_loss, _ = setup("hybrid")
    sched = dict(schedule="cosine", warmup_steps=1, decay_steps=6)
    opt_ref = optax.chain(optax.clip_by_global_norm(1.0), optax.adamw(RT.make_lr_schedule(1e-3, **sched)))

    @jax.jit
    def ref_step(g, o, p):
        upd, o = opt_ref.update(g, o, p)
        return optax.apply_updates(p, upd), o

    rp = {k: jnp.asarray(v) for k, v in flat.items()}
    ro = opt_ref.init(rp)
    for _ in range(2):  # a JAX run: one step, saved at step 1, then the step after it
        rl, g = reference_grads("hybrid", {k: np.asarray(v) for k, v in rp.items()}, batch, ref_loss)
        if _ == 0:
            rp, ro = ref_step(g, ro, rp)
            RCK.save_train_state(tmp_path / "jax", rp, ro, 1)
            saved_leaves = [np.asarray(x) for x in jax.tree_util.tree_leaves(ro)]
            saved_params = {k: np.asarray(v) for k, v in rp.items()}

    dev, state, step, place = T.make_sharded_trainer(cfg, flat, loss="hybrid", sigma=0.05, device="cpu",
                                                     learning_rate=1e-3, clip_norm=1.0, **sched)
    from parakeet_tpu_torch.train_loop import place_train_state

    p2, o2, s2 = CK.load_train_state(tmp_path / "jax", state.opt_state)
    assert s2 == 1 and o2.steps == 1
    state = place_train_state(dev, p2, o2, s2, state)
    for want, got in zip(saved_leaves, state.opt_state.leaves()):
        np.testing.assert_array_equal(got.numpy(), want)
    for k in flat:
        np.testing.assert_array_equal(state.params[k].numpy(), saved_params[k])

    # one more step on each side from the loaded state: the same gradients
    # (the reference's) give the same params; the port's own step the same loss
    rp, ro = ref_step(g, ro, rp)
    opt = T.adamw(T.make_lr_schedule(1e-3, **sched), clip_norm=1.0)
    params = {k: v.clone() for k, v in state.params.items()}
    opt_state = state.opt_state.with_leaves([x.clone() for x in state.opt_state.leaves()])
    opt.update(params, {k: torch.from_numpy(v.copy()) for k, v in g.items()}, opt_state)
    for k in flat:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(rp[k]), rtol=1e-6, atol=1e-7, err_msg=k)
    _, _, loss = step(state.params, state.opt_state, place(batch))
    assert float(loss) == pytest.approx(rl, rel=LOSS_RTOL)

    # the port's save reads in the reference's loader and its export
    CK.save_train_state(tmp_path / "port", params, opt_state, 2)
    _, ro2, rs2 = RCK.load_train_state(tmp_path / "port", ro)
    assert rs2 == 2
    for want, got in zip(jax.tree_util.tree_leaves(ro2), opt_state.leaves()):
        np.testing.assert_array_equal(np.asarray(want).reshape(got.shape), got.numpy())
    RCK.export_weights(tmp_path / "port", tmp_path / "w.safetensors")
    from parakeet_tpu.io.safetensors import load_safetensors

    exported = load_safetensors(tmp_path / "w.safetensors")
    assert sorted(exported) == sorted(flat)
    for k in flat:
        np.testing.assert_array_equal(exported[k], params[k].numpy())


def test_checkpoint_of_another_optimizer_configuration_raises(tmp_path):
    _, cfg, flat, batch, _, _ = setup("ctc")
    _, state, step, place = T.make_sharded_trainer(cfg, flat, loss="ctc", device="cpu")
    CK.save_train_state(tmp_path, state.params, state.opt_state, 0)
    _, clipped, _, _ = T.make_sharded_trainer(cfg, flat, loss="ctc", clip_norm=1.0, device="cpu")
    with pytest.raises(ValueError, match="structure mismatch"):
        CK.load_train_state(tmp_path, clipped.opt_state)


@pytest.mark.parametrize("with_treedef", [True, False])
def test_legacy_three_file_checkpoint_resumes_and_exports_as_in_the_reference(tmp_path, with_treedef):
    """The reference's pre-single-file layout (params.safetensors,
    opt_state.safetensors keyed opt.N, meta.json), written from a JAX save:
    the port resumes it as the reference does, exports the same weights,
    and its own save replaces the three files."""
    import json

    from parakeet_tpu.io.safetensors import load_safetensors, save_safetensors

    rng = np.random.RandomState(21)
    flat = {"a.weight": rng.randn(5, 3).astype(np.float32), "b.norm_.bias": rng.randn(4).astype(np.float32)}
    grads = [{k: (0.1 * rng.randn(*v.shape)).astype(np.float32) for k, v in flat.items()} for _ in range(2)]
    opt_ref = optax.adamw(1e-2)
    rp = {k: jnp.asarray(v) for k, v in flat.items()}
    ro = opt_ref.init(rp)
    upd, ro = opt_ref.update({k: jnp.asarray(v) for k, v in grads[0].items()}, ro, rp)
    rp = optax.apply_updates(rp, upd)
    RCK.save_train_state(tmp_path / "single", rp, ro, 4)
    blob = load_safetensors(tmp_path / "single" / "state.safetensors")
    legacy = tmp_path / "legacy"
    legacy.mkdir()
    save_safetensors({k: v for k, v in blob.items() if not k.startswith("##")}, legacy / "params.safetensors")
    save_safetensors({k[2:]: v for k, v in blob.items() if k.startswith("##opt.")}, legacy / "opt_state.safetensors")
    meta = {"step": 4}
    if with_treedef:
        meta["treedef"] = bytes(blob["##meta.treedef"]).decode("utf-8")
    (legacy / "meta.json").write_text(json.dumps(meta))

    rp_l, ro_l, rs = RCK.load_train_state(legacy, opt_ref.init(rp))
    opt = T.adamw(1e-2)
    params = torch_params(flat)
    fresh = opt.init(params)
    p, o, s = CK.load_train_state(legacy, fresh)
    assert s == rs == 4 and o.steps == 1
    for want, got in zip(jax.tree_util.tree_leaves(ro_l), o.leaves()):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want).reshape(got.shape))
    assert sorted(p) == sorted(rp_l)
    for k in flat:
        np.testing.assert_array_equal(p[k], np.asarray(rp_l[k]))

    # one step on each side from the loaded state: the same params
    params = torch_params(p)
    upd, ro_l = opt_ref.update({k: jnp.asarray(v) for k, v in grads[1].items()}, ro_l,
                               {k: jnp.asarray(v) for k, v in rp_l.items()})
    rp2 = optax.apply_updates({k: jnp.asarray(v) for k, v in rp_l.items()}, upd)
    opt.update(params, torch_params(grads[1]), o)
    for k in flat:
        np.testing.assert_allclose(params[k].numpy(), np.asarray(rp2[k]), rtol=1e-6, atol=1e-7, err_msg=k)

    # both exports, and a dir with only params.safetensors, give the same weights
    for only_params in (False, True):
        if only_params:
            (legacy / "opt_state.safetensors").unlink()
            (legacy / "meta.json").unlink()
        RCK.export_weights(legacy, tmp_path / "ref.safetensors")
        CK.export_weights(legacy, tmp_path / "port.safetensors")
        want, got = load_safetensors(tmp_path / "ref.safetensors"), load_safetensors(tmp_path / "port.safetensors")
        assert sorted(got) == sorted(want) == sorted(flat)
        for k in flat:
            np.testing.assert_array_equal(got[k], want[k])

    # the port's save replaces the legacy files; the reference reads it
    CK.save_train_state(legacy, params, o, 5)
    assert sorted(x.name for x in legacy.iterdir()) == ["state.safetensors"]
    _, ro5, rs5 = RCK.load_train_state(legacy, ro_l)
    assert rs5 == 5
    for want, got in zip(jax.tree_util.tree_leaves(ro5), o.leaves()):
        np.testing.assert_array_equal(np.asarray(want).reshape(got.shape), got.numpy())


def test_trainer_refuses_parallelism_and_defaults_to_the_card():
    """A mesh that is not one raises; tensor or sequence parallelism in a
    process that is not a rank of a process group says how to start the
    ranks (tests/test_torch_parallel_train.py trains on meshes)."""
    _, cfg, flat, _, _, _ = setup("ctc")
    with pytest.raises(TypeError, match="mesh must be a parakeet_tpu_torch.parallel.Mesh"):
        T.make_sharded_trainer(cfg, flat, mesh=object(), device="cpu")
    for kw in (dict(model_parallel=2), dict(seq_parallel=2)):
        with pytest.raises(ValueError, match="python -m torch.distributed.run"):
            T.make_sharded_trainer(cfg, flat, device="cpu", **kw)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.make_sharded_trainer(cfg, flat)


# ─── train_neural_lm ────────────────────────────────────────────────────────


def test_train_neural_lm_matches_reference():
    from parakeet_tpu.text import neural_lm as RL
    from parakeet_tpu_torch.text import neural_lm as L

    seqs = [list(np.random.RandomState(i).randint(0, 20, size=3 + i % 5)) for i in range(12)]
    kw = dict(steps=6, learning_rate=3e-3, batch_size=4, seed=2)
    want = RL.train_neural_lm(seqs, RL.NeuralLMConfig(vocab_size=21, hidden=16, num_layers=1, num_heads=2,
                                                       ffn_intermediate=32, max_len=16), **kw)
    got = L.train_neural_lm(seqs, L.NeuralLMConfig(vocab_size=21, hidden=16, num_layers=1, num_heads=2,
                                                    ffn_intermediate=32, max_len=16), device="cpu", **kw)
    assert got.final_loss == pytest.approx(want.final_loss, rel=1e-4)
    assert got.score_sequence([3, 4, 5]) == pytest.approx(want.score_sequence([3, 4, 5]), rel=1e-4)


# ─── K1 under grad, and the guard on the other kernels ──────────────────────


def _attention_inputs(rng, b=2, t=9, d=16, heads=2):
    hd = d // heads
    mk = lambda *s: torch.from_numpy((0.3 * rng.randn(*s)).astype(np.float32)).requires_grad_()  # noqa: E731
    x = mk(b, t, d)
    args = [mk(d, d), mk(d), mk(d, d), mk(d), mk(d, d), mk(d), mk(heads, hd), mk(heads, hd), mk(d, d), mk(d, d),
            mk(d)]
    return x, args, mk(d), mk(d), torch.tensor([t, t - 3], dtype=torch.int32)


@pytest.mark.parametrize("fused_norm", [False, True])
def test_k1_function_backward_equals_plain_autograd(monkeypatch, fused_norm):
    """The Function's forward is the kernel; here `_launch` is patched to the
    plain forward (the kernel runs only on the card), so the Function's
    gradients must equal autograd through the plain version."""
    from parakeet_tpu_torch.ops import rel_attention as RA

    rng = np.random.RandomState(5)
    x, args, nw, nb, lengths = _attention_inputs(rng)
    norm = (nw, nb) if fused_norm else (None, None)
    g = torch.from_numpy(rng.randn(*x.shape).astype(np.float32))
    inputs = [x, *args, *(n for n in norm if n is not None)]

    want_out = RA.rel_attention_block_reference(x, *args, lengths, *norm, 1e-5)
    want = torch.autograd.grad(want_out, inputs, g)

    launches = []
    monkeypatch.setattr(RA, "_launch", lambda *a: launches.append(1) or RA.rel_attention_block_reference(
        *(t.detach() if isinstance(t, torch.Tensor) else t for t in a)))
    out = RA.RelAttentionBlockFunction.apply(x, *args, lengths, *norm, 1e-5)
    got = torch.autograd.grad(out, inputs, g)
    assert launches == [1]
    torch.testing.assert_close(out, want_out.detach(), rtol=0, atol=0)
    for w, h in zip(want, got):
        torch.testing.assert_close(h, w, rtol=1e-6, atol=1e-7)


def test_encoder_gradient_reaches_the_first_layer_through_k1(monkeypatch):
    """With the Function wired as on the card (the kernel patched to its
    plain version), the hybrid gradients equal the CPU path's."""
    from parakeet_tpu_torch.ops import rel_attention as RA

    _, cfg, flat, batch, _, port_loss = setup("hybrid")
    want_l, want_g = T.value_and_grad_accum(port_loss)(torch_params(flat), torch_batch(batch))
    calls = []

    def on_card(x, *a, lengths=None, norm_w=None, norm_b=None, eps=1e-5, score_bf16=False):
        calls.append(1)
        kv = RA._key_lengths(lengths, x.shape[0], x.shape[1], x.device)
        return RA.RelAttentionBlockFunction.apply(x, *a, kv, norm_w, norm_b, eps)

    monkeypatch.setattr(RA, "_launch", lambda *a: RA.rel_attention_block_reference(
        *(t.detach() if isinstance(t, torch.Tensor) else t for t in a)))
    from parakeet_tpu_torch.models import encoder as E

    monkeypatch.setattr(E, "rel_attention_block", on_card)
    got_l, got_g = T.value_and_grad_accum(port_loss)(torch_params(flat), torch_batch(batch))
    assert len(calls) == cfg.encoder.num_layers
    assert float(got_l) == pytest.approx(float(want_l), rel=1e-6)
    first = "encoder_.layers_.0.attn_.mha_.q_proj.weight"
    assert float(got_g[first].abs().max()) > 0
    for k in want_g:
        torch.testing.assert_close(got_g[k], want_g[k], rtol=1e-5, atol=1e-7)


def test_kernel_guard_refuses_inputs_that_require_grad():
    from parakeet_tpu_torch.ops import feed_forward as FF
    from parakeet_tpu_torch.ops._build import refuse_grad

    x = torch.zeros(2, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        refuse_grad("fused_feed_forward", x)
    with torch.no_grad():
        refuse_grad("fused_feed_forward", x)
    refuse_grad("fused_feed_forward", x.detach(), None)
    with pytest.raises(RuntimeError, match="no backward"):  # before any build or launch
        FF._launch(x, None, None, x, x, x, x, None, None, 1e-5)


@pytest.mark.cuda
def test_k1_function_on_the_card_matches_plain_autograd():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from parakeet_tpu_torch.ops import rel_attention as RA

    rng = np.random.RandomState(6)
    x, args, nw, nb, lengths = _attention_inputs(rng, b=2, t=40, d=128, heads=2)
    cuda = [t.detach().cuda().requires_grad_() for t in (x, *args, nw, nb)]
    g = torch.from_numpy(rng.randn(*x.shape).astype(np.float32)).cuda()
    before = RA.rel_attention_block.launches
    out = RA.rel_attention_block(*cuda[:12], lengths=lengths.cuda(), norm_w=cuda[12], norm_b=cuda[13])
    assert RA.rel_attention_block.launches == before + 1 and out.grad_fn is not None
    got = torch.autograd.grad(out, cuda, g)
    want = torch.autograd.grad(RA.rel_attention_block_reference(*cuda[:12], lengths.cuda(), cuda[12], cuda[13]),
                               cuda, g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_training_after_inference_at_the_same_length():
    """The position table is cached per (T', width, device, dtype); one made
    under inference_mode (a facade's forward) must still serve autograd."""
    from parakeet_tpu_torch.ops.rel_attention import position_table

    _, cfg, flat, batch, _, port_loss = setup("hybrid")
    position_table.cache_clear()
    params, tb = torch_params(flat), torch_batch(batch)
    with torch.inference_mode():
        want = port_loss(params, tb)
    got, grads = T.value_and_grad_accum(port_loss)(params, tb)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert all(torch.isfinite(g).all() for g in grads.values())
