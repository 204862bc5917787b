"""The one generator of offline traffic: a pool of synthetic clips drawn
from the seed, cut into the batches that the calls send.

A mix file (traffic/<name>.json) gives the batch size, the pool size and
the clip lengths (a lognormal's median and sigma, clipped to a range).
Every seed gets the same set of lengths, one at each quantile
(j + 0.5) / pool of the clipped lognormal, dealt so that every batch
spans the whole range (`batches`): no seed brings more or less work or
padding. The seed decides which of neighbouring lengths share a batch,
the order inside each batch, and the audio. A clip is speech-like: five harmonics of a pitch
drawn in 90-250 Hz under a 2-5 Hz syllable envelope, plus white noise
(the repo's chip_smoke.py synthetic_clips, drawn here on the card in one
pass with the phase in float64).
"""

from __future__ import annotations

import math
from statistics import NormalDist

import numpy as np
import torch

SAMPLE_RATE = 16000


def pool_seconds(mix: dict) -> list[float]:
    """The pool's clip lengths in seconds: the same for every seed."""
    n, spec = mix["pool"], mix["lengths"]
    z = [NormalDist().inv_cdf((j + 0.5) / n) for j in range(n)]
    return [min(max(spec["median_s"] * math.exp(spec["sigma"] * zj), spec["min_s"]), spec["max_s"]) for zj in z]


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy stream of the seed (any size of whole number)."""
    return np.random.default_rng([stream, seed])


def batches(mix: dict, seed: int) -> list[list[int]]:
    """The pool's clip indices (in order of length) cut into whole batches:
    each run of as many consecutive lengths as there are batches is dealt
    one to a batch in a seeded order, and each batch is then shuffled. So
    every batch holds a sample of the whole length range and pads as a
    random batch would, and every seed's batches pad alike."""
    n, b = mix["pool"], mix["batch"]
    if n % b:
        raise ValueError(f"pool {n} is not a whole number of batches of {b}")
    k = n // b
    rng = rng_for(seed, 1)
    out: list[list[int]] = [[] for _ in range(k)]
    for start in range(0, n, k):
        for clip, batch in zip(range(start, start + k), rng.permutation(k)):
            out[batch].append(clip)
    return [rng.permutation(batch).tolist() for batch in out]


def make_pool(mix: dict, seed: int, device) -> list[np.ndarray]:
    """The pool's clips as float32 host arrays (what a caller hands the
    facade), synthesised on `device` in one pass."""
    lengths = [int(s * SAMPLE_RATE) for s in pool_seconds(mix)]
    rng = rng_for(seed, 2)
    f0 = rng.uniform(90.0, 250.0, len(lengths))
    rate = rng.uniform(2.0, 5.0, len(lengths))
    gen = torch.Generator(device=device).manual_seed(int(rng.integers(2**62)))
    idx = torch.repeat_interleave(torch.arange(len(lengths), device=device),
                                  torch.tensor(lengths, device=device))
    starts = torch.tensor(np.concatenate([[0], np.cumsum(lengths)[:-1]]), device=device)
    tt = (torch.arange(idx.numel(), device=device) - starts[idx]).to(torch.float64) / SAMPLE_RATE
    f0_t = torch.tensor(f0, device=device)[idx]
    voice = torch.zeros_like(tt)
    for k in range(1, 6):
        voice += torch.sin(2 * math.pi * torch.remainder(f0_t * k * tt, 1.0)) / k
    env = 0.5 * (1 + torch.sin(2 * math.pi * torch.remainder(torch.tensor(rate, device=device)[idx] * tt, 1.0)))
    noise = torch.randn(idx.numel(), generator=gen, device=device, dtype=torch.float32)
    audio = (0.1 * env * voice).to(torch.float32) + 0.01 * noise
    flat = audio.cpu().numpy()
    return np.split(flat, np.cumsum(lengths)[:-1])
