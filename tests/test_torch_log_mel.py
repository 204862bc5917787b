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
    got = TF.preprocess_audio_fused(wave, AudioConfig(), "cpu").numpy()
    assert got.shape == ref.shape == (1, n_samples // 160 + 1, 80)
    # normalised features: the log-space tolerance scaled by 1/std of the
    # features (std ≥ 0.5 on this noise)
    np.testing.assert_allclose(got, ref, atol=2 * ATOL)
    # and the unfused frontend computes the same features
    plain = TF.preprocess_audio(wave, AudioConfig(), "cpu").numpy()
    np.testing.assert_allclose(got, plain, atol=2 * ATOL)


@pytest.mark.parametrize("n_samples", [16000, 40000])
def test_kernel_operands_reproduce_the_pallas_kernel(n_samples):
    """The CUDA kernel's arithmetic on its own operands, in torch: the DFT
    against the tile-laid-out W (64 cos then 64 sin rows per 128 columns),
    re and im read back from that layout, the Nyquist bin from its own two
    rows, then the filterbank and the log."""
    x = _padded(n_samples, seed=3)
    ref = np.asarray(RPF.fused_log_mel(jnp.asarray(x), interpret=True))
    wdft, nyq, band_w, band_lo, band_off = TK._device_mats(512, 400, 80, 16000.0, 0.0, None, torch.device("cpu"))
    assert tuple(wdft.shape) == (512, 512) and tuple(nyq.shape) == (2, 512)
    assert band_lo.dtype == band_off.dtype == torch.int32 and band_off[-1] == band_w.numel()
    frames = torch.from_numpy(x).unfold(0, 512, 160)
    tiles = (frames @ wdft.T).view(-1, 4, 2, 64)
    re, im = tiles[:, :, 0].reshape(-1, 256), tiles[:, :, 1].reshape(-1, 256)
    nyq_re, nyq_im = frames @ nyq[0], frames @ nyq[1]
    power = torch.cat([re * re + im * im, (nyq_re * nyq_re + nyq_im * nyq_im)[:, None]], dim=1)
    mel = torch.stack([power[:, lo: lo + hi - o] @ band_w[o: hi]
                       for lo, o, hi in zip(band_lo.tolist(), band_off[:-1].tolist(), band_off[1:].tolist())], 1)
    got = torch.log(mel + 2.0 ** -24).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("n_mels", [80, 128])
def test_filterbank_bands_hold_every_nonzero_weight(n_mels):
    """Each mel filter's band runs from its first to its last nonzero
    weight; rebuilt densely, the bands are the filterbank bit for bit."""
    fb = TK._filterbank(512, n_mels, 16000.0, 0.0, None)
    w, lo, off = TK.filterbank_bands(fb)
    dense = np.zeros_like(fb)
    for m in range(n_mels):
        dense[lo[m]: lo[m] + off[m + 1] - off[m], m] = w[off[m]: off[m + 1]]
    np.testing.assert_array_equal(dense, fb)
    assert off[-1] == w.size < fb.size // 20  # a sparse product: under 5% of the weights


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
