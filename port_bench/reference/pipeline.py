"""The reference run of one clip, and the control that stands in the
program's place.

`Reference` recomputes, from the audio and the weights the benchmark made,
what the program derives: the clip's log-mel (float64), its encoder frames
(float32, TF32 off) and its CTC log-probs. The encoder sees the clip's
features zero-padded to the length of the batch the program served it in,
as the program's subsampling does; every later layer runs on the clip's
valid frames alone, which is what the program's key-length masks and
zeroed conv padding compute.

`Control` is the same reference behind the facade's stage methods
(prepare_batch, encode, ctc_log_probs, transcribe_batch), each clip
decoded by the scalar greedy loop, in one of two precisions:

* "fp8", the control, the precision below the program's: the frontend's
  DFT in TF32 and every weight product in float8 e4m3. Put in the
  program's place it must come out not correct;
* "bf16", the witness: the frontend in float32 as the program's, every
  weight product's operands and result in bfloat16. It stands for a sound
  program that computes the encoder's sublayers in the configuration's
  bfloat16, and has to come out correct.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from . import torch_ref as R
from .log_mel import LogMel


def is_product_weight(key: str) -> bool:
    """A weight that multiplies (linears, convs, the LSTM's projections),
    not a norm's scale or the embedding table."""
    return key.endswith(".weight") and "norm" not in key and "embed_" not in key


def subsampled_length(n: int) -> int:
    for _ in range(3):
        n = (n - 1) // 2 + 1
    return n


class Reference:
    """Reference stages for one configuration; `params` float32 tensors on
    `device`, `cfg` the configuration file's model numbers."""

    def __init__(self, params: dict, cfg: dict, audio: dict, device, ar: R.Arith = R.F32):
        if torch.device(device).type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.params, self.cfg, self.enc_cfg, self.ar = params, cfg, cfg["encoder"], ar
        self.frontend = LogMel(audio, cfg["encoder"]["mel_bins"], device)
        self.device = device

    @torch.no_grad()
    def mel(self, samples, tf32_dft: bool = False) -> torch.Tensor:
        return self.frontend(samples, tf32_dft)

    @torch.no_grad()
    def encode(self, feats: torch.Tensor, pad_to: int) -> torch.Tensor:
        """(T, mel) features of one clip → (T', d) frames, T' its own."""
        x = torch.zeros((1, pad_to, feats.shape[1]), dtype=torch.float32, device=self.device)
        x[0, : feats.shape[0]] = feats.to(torch.float32)
        h = R.subsampling(self.params, x, ar=self.ar)[:, : subsampled_length(feats.shape[0])]
        return R.conformer_layers(self.params, self.enc_cfg, h, self.ar)[0]

    @torch.no_grad()
    def ctc_log_probs(self, enc: torch.Tensor) -> torch.Tensor:
        return R.ctc_log_probs(self.params, enc[None], self.ar)[0]


@dataclass
class Emission:
    token_id: int
    start_frame: int
    end_frame: int


@dataclass
class Served:
    token_ids: list[int]
    timestamped_tokens: list[Emission] = field(default_factory=list)


class Control:
    """The reference in `precision` ("fp8" the control, "bf16" the witness;
    module note), behind the facade's stage methods. `decoder` "ctc" or
    "tdt"."""

    def __init__(self, params: dict, cfg: dict, audio: dict, device, *, decoder: str, joint_prefix: str,
                 blank: int, precision: str = "fp8"):
        round_weight = R.round_weight_fp8 if precision == "fp8" else R.round_bf16
        rounded = {k: round_weight(v) if is_product_weight(k) else v for k, v in params.items()}
        self.ref = Reference(rounded, cfg, audio, device, R.Arith(precision, weights_rounded=True))
        self.decoder, self.joint_prefix, self.blank = decoder, joint_prefix, blank
        self.tf32_dft = precision == "fp8"
        self.device = device

    def prepare_batch(self, waves, opts=None):
        feats = [self.ref.mel(w, tf32_dft=self.tf32_dft).to(torch.float32) for w in waves]
        t_max = max(f.shape[0] for f in feats)
        batch = torch.zeros((len(feats), t_max, feats[0].shape[1]), device=self.device)
        for i, f in enumerate(feats):
            batch[i, : f.shape[0]] = f
        return batch, [f.shape[0] for f in feats]

    def encode(self, feats, lengths):
        frames = [self.ref.encode(feats[i, :n], feats.shape[1]) for i, n in enumerate(lengths)]
        out = torch.zeros((len(frames), max(f.shape[0] for f in frames), frames[0].shape[1]), device=self.device)
        for i, f in enumerate(frames):
            out[i, : f.shape[0]] = f
        return out

    def ctc_log_probs(self, enc):
        return R.ctc_log_probs(self.ref.params, enc, self.ref.ar)

    @torch.no_grad()
    def transcribe_batch(self, waves, opts=None) -> list[Served]:
        feats, n_frames = self.prepare_batch(waves, opts)
        enc = self.encode(feats, n_frames)
        lens = [subsampled_length(n) for n in n_frames]
        if self.decoder == "ctc":
            best = self.ctc_log_probs(enc).argmax(dim=-1).cpu().numpy()
            out = []
            for i, n in enumerate(lens):
                b = best[i, :n]
                keep = (b != self.blank) & (b != np.concatenate([[-1], b[:-1]]))
                out.append(Served(b[keep].tolist()))
            return out
        out = []
        for i, n in enumerate(lens):
            path = R.greedy_tdt(self.ref.params, enc[i, :n], durations=self.ref.cfg["durations"],
                                blank_id=self.blank, joint_prefix=self.joint_prefix, ar=self.ref.ar)
            out.append(Served([p[0] for p in path], [Emission(*p) for p in path]))
        return out
