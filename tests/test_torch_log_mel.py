"""The port's fused log-mel (K3) and preprocess_audio_fused against the
reference's Pallas kernel pallas_frontend.fused_log_mel in interpret mode.
On the CPU the port's dispatch runs the plain torch version; the CUDA
kernel itself is held against that plain version on the card (marked
`cuda`)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parakeet_tpu.audio import frontend as RF
from parakeet_tpu.audio.frontend import _hann_symmetric
from parakeet_tpu.config import AudioConfig as RAudioConfig
from parakeet_tpu.ops import pallas_frontend as RPF
from parakeet_tpu_torch.audio import frontend as TF
from parakeet_tpu_torch.config import AudioConfig
from parakeet_tpu_torch.ops import log_mel as TK

ATOL = 2e-2  # tests/test_pallas_frontend.py's tolerance, in log space


def _padded(n_samples: int, seed: int = 0) -> np.ndarray:
    """Preemphasized, reflect-padded samples, as preprocess_audio_fused
    hands them to the kernel."""
    wave = (0.2 * np.random.RandomState(seed).randn(n_samples)).astype(np.float32)
    pre = np.asarray(RF._preemphasis(jnp.asarray(wave)))
    return np.pad(pre, (256, 256), mode="reflect")


@pytest.mark.parametrize("n_samples", [16000, 40000])
def test_plain_version_matches_pallas_kernel(n_samples):
    x = _padded(n_samples)
    ref = np.asarray(RPF.fused_log_mel(jnp.asarray(x), interpret=True))
    got = TK.fused_log_mel_reference(torch.from_numpy(x)).numpy()
    assert got.shape == ref.shape == (n_samples // 160 + 1, 80)
    err = float(np.abs(got - ref).max())
    print(f"K3 plain vs Pallas interpret, {n_samples} samples: max|diff| {err:.3e} (log space)")
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_window_dft_matrices_are_the_references_bit_for_bit():
    cos_m, sin_m = RPF._dft_mats(512)
    window = np.zeros(512, np.float32)
    window[56: 56 + 400] = _hann_symmetric(400)
    wcos, wsin = TK.window_dft_matrices(512, 400)
    assert wcos.dtype == wsin.dtype == np.float32
    np.testing.assert_array_equal(wcos, window[:, None] * cos_m)
    np.testing.assert_array_equal(wsin, window[:, None] * sin_m)


def test_n_fft_past_four_hops_is_rejected():
    x = torch.zeros(4000)
    with pytest.raises(ValueError, match="n_fft <= 4\\*hop"):
        TK.fused_log_mel(x, n_fft=512, hop=100)
    with pytest.raises(ValueError, match="n_fft <= 4\\*hop"):
        RPF.fused_log_mel(jnp.zeros(4000), n_fft=512, hop=100, interpret=True)


def test_128_mels_and_unset_f_max():
    x = torch.from_numpy(np.random.RandomState(1).randn(8000).astype(np.float32))
    out = TK.fused_log_mel(x, n_mels=128)
    assert out.shape == ((8000 - 512) // 160 + 1, 128)
    assert torch.isfinite(out).all()
    assert torch.equal(out, TK.fused_log_mel(x, n_mels=128, f_max=8000.0))


@pytest.mark.parametrize("n_samples", [16000, 40000])
def test_preprocess_audio_fused_matches_reference(n_samples, monkeypatch):
    orig = RPF.fused_log_mel
    calls = []

    def interp(*args, **kw):
        calls.append(1)
        return orig(*args, interpret=True, **kw)

    monkeypatch.setattr(RPF, "fused_log_mel", interp)
    wave = (0.3 * np.random.RandomState(2).randn(n_samples)).astype(np.float32)
    ref = np.asarray(RF.preprocess_audio_fused(wave, RAudioConfig()))
    assert calls == [1]
    got = TF.preprocess_audio_fused(wave, AudioConfig()).numpy()
    assert got.shape == ref.shape == (1, n_samples // 160 + 1, 80)
    # normalised features: the log-space tolerance scaled by 1/std of the
    # features (std ≥ 0.5 on this noise)
    np.testing.assert_allclose(got, ref, atol=2 * ATOL)
    # and the unfused frontend computes the same features
    plain = TF.preprocess_audio(wave, AudioConfig()).numpy()
    np.testing.assert_allclose(got, plain, atol=2 * ATOL)


def test_cpu_dispatch_runs_plain_version_and_counts_nothing():
    x = torch.from_numpy(_padded(8000, seed=4))
    before = TK.fused_log_mel.launches
    assert torch.equal(TK.fused_log_mel(x), TK.fused_log_mel_reference(x))
    assert TK.fused_log_mel.launches == before


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_version():
    """The hand-written kernel against its plain version on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    from parakeet_tpu_torch.ops.layers import require_ieee_f32

    require_ieee_f32()
    x = torch.from_numpy(_padded(40000, seed=5)).to("cuda")
    before = TK.fused_log_mel.launches
    got = TK.fused_log_mel(x).cpu().numpy()
    assert TK.fused_log_mel.launches == before + 1
    ref = TK.fused_log_mel_reference(x).cpu().numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)
