"""The port's RNNT and TDT lattice losses (ops/transducer_loss.py, an
anti-diagonal wavefront) against the JAX package's (a scan over frames
with an associative scan in each row) on the same seeded numpy inputs:
per-sequence NLL, gradients against jax.grad, padding invariance, the
duration checks and the finite sentinel."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from parakeet_tpu.ops import transducer_loss as R
from parakeet_tpu_torch.ops import transducer_loss as P

NLL_RTOL, NLL_ATOL = 1e-5, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def log_softmax(x):
    return x - np.log(np.exp(x - x.max(-1, keepdims=True)).sum(-1, keepdims=True)) - x.max(-1, keepdims=True)


def inputs(seed, b=3, t=9, u=5, v=7, n_dur=None):
    rng = np.random.RandomState(seed)
    lp = log_softmax(2 * rng.randn(b, t, u + 1, v)).astype(np.float32)
    dur = None if n_dur is None else log_softmax(rng.randn(b, t, u + 1, n_dur)).astype(np.float32)
    labels = rng.randint(0, v - 1, (b, u)).astype(np.int32)
    frames = np.array([t] + list(rng.randint(max(1, t // 3), t + 1, b - 1)), np.int32)
    label_lengths = np.array([u] + list(rng.randint(0, u + 1, b - 1)), np.int32)
    return lp, dur, labels, frames, label_lengths


def t_(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rnnt_nll_and_gradient_match_reference(seed):
    lp, _, labels, frames, lens = inputs(seed)
    blank = lp.shape[-1] - 1
    want = np.asarray(R.rnnt_loss(jnp.asarray(lp), labels, frames, lens, blank))
    want_g = np.asarray(jax.grad(lambda x: R.rnnt_loss(x, labels, frames, lens, blank).sum())(jnp.asarray(lp)))
    x = t_(lp).requires_grad_()
    got = P.rnnt_loss(x, t_(labels), t_(frames), t_(lens), blank)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=NLL_RTOL, atol=NLL_ATOL)
    np.testing.assert_allclose(x.grad.numpy(), want_g, rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("durations,sigma", [((0, 1, 2, 3, 4), 0.0), ((0, 1, 2, 3, 4), 0.05), ((1, 2), 0.0),
                                             ((0, 2, 3), 0.05), ((1,), 0.0), ((0, 1), 0.02)])
def test_tdt_nll_and_gradients_match_reference(durations, sigma):
    lp, dur, labels, frames, lens = inputs(len(durations) + int(100 * sigma), n_dur=len(durations))
    blank = lp.shape[-1] - 1

    def ref(a, d):
        return R.tdt_loss(a, d, labels, frames, lens, blank, durations, sigma=sigma)

    want = np.asarray(ref(jnp.asarray(lp), jnp.asarray(dur)))
    # an item no path reaches (NLL at the 1e30 sentinel) has no gradient to
    # compare: both packages give finite values of the sentinel arithmetic
    feasible = (want < 1e29).astype(np.float32)
    want_g = [np.asarray(g) for g in jax.grad(lambda a, d: (ref(a, d) * feasible).sum(), (0, 1))(
        jnp.asarray(lp), jnp.asarray(dur))]
    x, d = t_(lp).requires_grad_(), t_(dur).requires_grad_()
    got = P.tdt_loss(x, d, t_(labels), t_(frames), t_(lens), blank, durations, sigma=sigma)
    (got * t_(feasible)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=NLL_RTOL, atol=NLL_ATOL)
    np.testing.assert_allclose(x.grad.numpy(), want_g[0], rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(d.grad.numpy(), want_g[1], rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("kind", ["rnnt", "tdt"])
def test_padding_does_not_change_the_nll(kind):
    """Extra frames past every frame length and extra label columns past
    every label length change nothing."""
    durations = (0, 1, 2)
    lp, dur, labels, frames, lens = inputs(7, t=8, u=4, n_dur=len(durations))
    rng = np.random.RandomState(8)
    lp_pad = log_softmax(rng.randn(3, 11, 7, 7)).astype(np.float32)
    lp_pad[:, :8, :5] = lp
    dur_pad = log_softmax(rng.randn(3, 11, 7, 3)).astype(np.float32)
    dur_pad[:, :8, :5] = dur
    labels_pad = np.concatenate([labels, rng.randint(0, 6, (3, 2)).astype(np.int32)], axis=1)
    blank = 6
    if kind == "rnnt":
        a = P.rnnt_loss(t_(lp), t_(labels), t_(frames), t_(lens), blank)
        b = P.rnnt_loss(t_(lp_pad), t_(labels_pad), t_(frames), t_(lens), blank)
    else:
        a = P.tdt_loss(t_(lp), t_(dur), t_(labels), t_(frames), t_(lens), blank, durations, sigma=0.05)
        b = P.tdt_loss(t_(lp_pad), t_(dur_pad), t_(labels_pad), t_(frames), t_(lens), blank, durations, sigma=0.05)
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("durations", [(), (2, 1), (0, 0, 1), (-1, 1), (0,)])
def test_bad_durations_raise_as_in_the_reference(durations):
    lp, dur, labels, frames, lens = inputs(3, n_dur=max(1, len(durations)))
    with pytest.raises(ValueError):
        R.tdt_loss(jnp.asarray(lp), jnp.asarray(dur), labels, frames, lens, 6, durations)
    with pytest.raises(ValueError):
        P.tdt_loss(t_(lp), t_(dur), t_(labels), t_(frames), t_(lens), 6, durations)


def test_impossible_alignment_stays_finite_with_finite_gradients():
    """A TDT path must end on a blank landing exactly on the frame length:
    with only d=2 and an odd frame count no path exists, and the finite
    sentinel keeps the NLL (huge) and the gradients finite, as in the
    reference."""
    lp, dur, labels, frames, lens = inputs(5, b=2, t=7, n_dur=1)
    frames = np.array([7, 5], np.int32)
    lens = np.array([0, 0], np.int32)
    x = t_(lp).requires_grad_()
    got = P.tdt_loss(x, t_(dur), t_(labels), t_(frames), t_(lens), 6, (2,))
    want = np.asarray(R.tdt_loss(jnp.asarray(lp), jnp.asarray(dur), labels, frames, lens, 6, (2,)))
    got.sum().backward()
    assert np.all(want > 1e29)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6)
    assert torch.isfinite(x.grad).all()


def test_package_exports_the_losses():
    import parakeet_tpu_torch as T

    assert T.rnnt_loss is P.rnnt_loss and T.tdt_loss is P.tdt_loss
