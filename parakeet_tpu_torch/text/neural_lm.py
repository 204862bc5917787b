"""Neural (transformer) language model for n-best rescoring and fusion (port
of parakeet_tpu/text/neural_lm.py).

A small causal transformer LM over tokenizer ids: the Sortformer-head
transformer blocks (models/transformer.py) under a causal mask, persisted
as safetensors with its configuration in a `##config` blob, with the
scoring protocol of the n-gram LM (`score_sequence`, `start_state` /
`advance`), so it plugs into `rescore_nbest`, the transducer beam's
rescoring and the CTC beam's shallow fusion unchanged.

Vocab convention: ids 0..vocab_size-1 are the tokenizer's (the blank row
exists but never appears in a hypothesis); BOS = vocab_size and EOS =
vocab_size + 1 are appended to the embedding and output tables.

`train_neural_lm` trains one with the port's Adam (train.py), on the card
unless given device="cpu".
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from pathlib import Path

import numpy as np
import torch

from parakeet_tpu_torch.config import TransformerConfig
from parakeet_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from parakeet_tpu_torch.models.transformer import transformer_encode
from parakeet_tpu_torch.ops.layers import embedding, linear
from parakeet_tpu_torch.params import Params, init_params_numpy, params_from_numpy, transformer_spec

_F32 = torch.float32


@dataclass(frozen=True)
class NeuralLMConfig:
    vocab_size: int  # tokenizer vocab (with the blank); BOS and EOS appended after it
    hidden: int = 128
    num_layers: int = 2
    num_heads: int = 4
    ffn_intermediate: int = 256
    max_len: int = 128  # longest scored sequence, BOS included

    @property
    def bos(self) -> int:
        return self.vocab_size

    @property
    def eos(self) -> int:
        return self.vocab_size + 1

    def transformer(self) -> TransformerConfig:
        return TransformerConfig(
            hidden_size=self.hidden, num_layers=self.num_layers, num_heads=self.num_heads,
            ffn_intermediate=self.ffn_intermediate, pre_ln=True, has_final_norm=True,
        )


def neural_lm_spec(cfg: NeuralLMConfig, prefix: str = "lm_") -> dict:
    spec: dict = {
        f"{prefix}.embed_.weight": ((cfg.vocab_size + 2, cfg.hidden), "emb"),
        f"{prefix}.pos_.weight": ((cfg.max_len, cfg.hidden), "emb"),
        f"{prefix}.out_.weight": ((cfg.vocab_size + 2, cfg.hidden), "w"),
        f"{prefix}.out_.bias": ((cfg.vocab_size + 2,), "b"),
    }
    spec.update(transformer_spec(cfg.transformer(), f"{prefix}.transformer_"))
    return spec


def lm_log_probs(params: dict, cfg: NeuralLMConfig, ids: torch.Tensor) -> torch.Tensor:
    """ids (B, U) integer (BOS-prefixed inputs) → (B, U, V+2) next-token
    log-probs under a causal mask."""
    p = Params(params).sub("lm_")
    u = ids.shape[1]
    x = embedding(p.sub("embed_"), ids) + p["pos_.weight"][:u][None]
    causal = torch.triu(torch.ones((u, u), dtype=torch.bool, device=ids.device), diagonal=1)[None, None]
    h = transformer_encode(p.sub("transformer_"), cfg.transformer(), x, causal)
    return torch.log_softmax(linear(p.sub("out_"), h).to(_F32), dim=-1)


class NeuralLM:
    """Scoring facade over an LM param dict, on `device` (the card unless
    given). Protocol-compatible with BoundNgramLM: `score_sequence(token_ids,
    eos=False)`, `start_state()`, `advance(state, token_id)`."""

    def __init__(self, params: dict, cfg: NeuralLMConfig, device: str | torch.device = DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params_from_numpy({k: np.asarray(v) for k, v in params.items()}, self.device)
        self._next_cache: dict[tuple, np.ndarray] = {}

    # ── construction / persistence ───────────────────────────────────────

    @classmethod
    def random(cls, cfg: NeuralLMConfig, seed: int = 0, device: str | torch.device = DEFAULT_DEVICE) -> "NeuralLM":
        return cls(init_params_numpy(neural_lm_spec(cfg), seed=seed), cfg, device)

    def save(self, path: str | Path) -> None:
        from parakeet_tpu_torch.io.safetensors import save_safetensors

        blob = {k: v.cpu().numpy() for k, v in self.params.items()}
        blob["##config"] = np.frombuffer(json.dumps(asdict(self.cfg)).encode("utf-8"), np.uint8).copy()
        save_safetensors(blob, path)

    @classmethod
    def load(cls, path: str | Path, device: str | torch.device = DEFAULT_DEVICE) -> "NeuralLM":
        from parakeet_tpu_torch.io.safetensors import load_safetensors

        blob = dict(load_safetensors(path))
        cfg = NeuralLMConfig(**json.loads(bytes(blob.pop("##config")).decode("utf-8")))
        return cls(blob, cfg, device)

    # ── scoring ──────────────────────────────────────────────────────────

    def _bucket(self, u: int) -> int:
        """Scored lengths padded to multiples of 16 (the reference's compile
        buckets; the padding changes no causal score)."""
        return min(self.cfg.max_len, -(-u // 16) * 16)

    @torch.inference_mode()
    def _log_probs(self, ids: np.ndarray) -> np.ndarray:
        return lm_log_probs(self.params, self.cfg, torch.from_numpy(ids).to(self.device)).cpu().numpy()

    def score_batch(self, sequences, *, eos: bool = False) -> list[float]:
        """Sum of next-token log-probs per sequence, one device call for the
        whole n-best list."""
        if not any(len(s) for s in sequences) and not eos:
            return [0.0] * len(sequences)
        cfg = self.cfg
        n = max((len(s) for s in sequences), default=0)
        u = self._bucket(n + 1)  # BOS + tokens (+ the EOS target slot)
        ids = np.full((len(sequences), u), cfg.eos, np.int64)
        tgt = np.full((len(sequences), u), -1, np.int64)
        for i, seq in enumerate(sequences):
            seq = [min(int(t), cfg.vocab_size - 1) for t in seq][: u - 1]
            ids[i, 0] = cfg.bos
            ids[i, 1: 1 + len(seq)] = seq
            tgt[i, : len(seq)] = seq
            if eos:
                tgt[i, len(seq)] = cfg.eos
        lp = self._log_probs(ids)
        out = []
        for i in range(len(sequences)):
            valid = tgt[i] >= 0
            out.append(float(lp[i, valid, tgt[i, valid]].sum()) if valid.any() else 0.0)
        return out

    def score_sequence(self, token_ids, *, bos: bool = True, eos: bool = False) -> float:
        # bos: the NgramLM signature; BOS is always implicit here
        return self.score_batch([list(token_ids)], eos=eos)[0]

    # ── incremental protocol (CTC shallow fusion) ────────────────────────

    def start_state(self) -> tuple:
        return ()

    def _next_logprobs(self, prefix: tuple) -> np.ndarray:
        cached = self._next_cache.get(prefix)
        if cached is not None:
            return cached
        cfg = self.cfg
        u = self._bucket(len(prefix) + 1)
        ids = np.full((1, u), cfg.eos, np.int64)
        ids[0, 0] = cfg.bos
        seq = [min(int(t), cfg.vocab_size - 1) for t in prefix][-(u - 1):]
        ids[0, 1: 1 + len(seq)] = seq
        lp = self._log_probs(ids)[0, len(seq)]
        if len(self._next_cache) > 4096:  # bound beam-search memory
            self._next_cache.clear()
        self._next_cache[prefix] = lp
        return lp

    def advance(self, state: tuple, token_id: int):
        lp = self._next_logprobs(tuple(state))
        tok = min(int(token_id), self.cfg.vocab_size - 1)
        return tuple(state) + (tok,), float(lp[tok])


def train_neural_lm(
    sequences,
    cfg: NeuralLMConfig,
    *,
    steps: int = 200,
    learning_rate: float = 3e-3,
    batch_size: int = 32,
    seed: int = 0,
    device: str | torch.device = DEFAULT_DEVICE,
) -> NeuralLM:
    """Train a NeuralLM on token-id sequences: next-token cross-entropy
    (EOS included) under optax.adam's update (train.adam), the reference's
    initial weights and batch draws. Returns the trained facade on
    `device`, `final_loss` set; `.save()` persists it."""
    from parakeet_tpu_torch.train import adam, value_and_grad_accum

    dev = resolve_device(device)
    params = params_from_numpy(init_params_numpy(neural_lm_spec(cfg), seed=seed), dev)
    u = min(cfg.max_len, max(max((len(s) for s in sequences), default=1) + 1, 2))
    ids = np.full((len(sequences), u), cfg.eos, np.int64)
    tgt = np.full((len(sequences), u), -1, np.int64)
    for i, seq in enumerate(sequences):
        seq = [min(int(t), cfg.vocab_size - 1) for t in seq][: u - 1]
        ids[i, 0] = cfg.bos
        ids[i, 1: 1 + len(seq)] = seq
        tgt[i, : len(seq)] = seq
        tgt[i, len(seq)] = cfg.eos

    def loss_fn(p, batch):
        lp = lm_log_probs(p, cfg, batch["ids"])
        bt = batch["targets"]
        mask = (bt >= 0).to(_F32)
        picked = lp.gather(-1, bt.clamp(min=0)[..., None])[..., 0]
        return -(picked * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    opt = adam(learning_rate)
    opt_state = opt.init(params)
    vag = value_and_grad_accum(loss_fn)
    rng = np.random.RandomState(seed)
    loss = torch.tensor(float("inf"))
    for _ in range(steps):
        pick = rng.randint(0, len(sequences), size=min(batch_size, len(sequences)))
        loss, grads = vag(params, {"ids": torch.from_numpy(ids[pick]).to(dev),
                                   "targets": torch.from_numpy(tgt[pick]).to(dev)})
        opt.update(params, grads, opt_state)
    lm = NeuralLM({k: v.cpu().numpy() for k, v in params.items()}, cfg, dev)
    lm.final_loss = float(loss)
    return lm


__all__ = ["NeuralLM", "NeuralLMConfig", "neural_lm_spec", "lm_log_probs", "train_neural_lm"]
