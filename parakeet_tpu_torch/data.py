"""Training data pipeline (port of parakeet_tpu/data.py): manifest →
bucketed, padded, prefetched batches on the trainer's device.

- **Length bucketing**: entries sorted by duration and cut into contiguous
  batches, so every batch pads to its own longest clip.
- **Shape quantization**: the mel-frame and label axes round up to
  multiples (`frame_multiple`, `label_multiple`), as in the reference.
- **Background prefetch**: a producer thread decodes audio, runs the
  batched mel frontend (`preprocess_audio_batch`, one call a batch, on the
  loader's device: the card unless given) and tokenizes transcripts while
  the card is inside the previous step. Its errors surface in the consumer.

Batches are dicts of tensors on the loader's device (the reference's are
numpy); the order of buckets and epochs, the padding and the labels are
the reference's.

Manifest format: NeMo-style JSONL, one object per line with
`audio_filepath`, `text`, and optional `duration` (seconds; probed from
the header when absent).
"""

from __future__ import annotations

import json
import queue
import threading
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from parakeet_tpu_torch.audio.frontend import preprocess_audio_batch
from parakeet_tpu_torch.audio.io import get_audio_duration, read_audio
from parakeet_tpu_torch.config import AudioConfig
from parakeet_tpu_torch.device import DEFAULT_DEVICE, resolve_device


class ManifestDataset:
    """JSONL manifest of (audio file, transcript) pairs."""

    _REQUIRED: tuple[str, ...] = ("audio_filepath", "text")

    def __init__(self, manifest_path: str | Path):
        self.manifest_path = Path(manifest_path)
        self.entries: list[dict] = []
        base = self.manifest_path.parent
        with open(self.manifest_path, "r", encoding="utf-8") as f:
            for line_no, line in enumerate(f, 1):
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                except json.JSONDecodeError as err:
                    raise ValueError(
                        f"{self.manifest_path}:{line_no}: invalid JSON ({err})"
                    ) from err
                missing = [k for k in self._REQUIRED if k not in e]
                if missing:
                    raise ValueError(
                        f"{self.manifest_path}:{line_no}: entry needs "
                        f"{list(self._REQUIRED)}, got keys {sorted(e)}"
                    )
                p = Path(e["audio_filepath"])
                if not p.is_absolute():
                    p = base / p
                e["audio_filepath"] = str(p)
                self.entries.append(e)
        if not self.entries:
            raise ValueError(f"{self.manifest_path}: empty manifest")

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i: int) -> dict:
        return self.entries[i]

    def duration(self, i: int) -> float:
        e = self.entries[i]
        if "duration" not in e:
            e["duration"] = get_audio_duration(e["audio_filepath"])
        return float(e["duration"])


def _round_up(n: int, multiple: int) -> int:
    return max(multiple, -(-n // multiple) * multiple)


class _BucketedLoader:
    """Shared machinery of the training loaders: duration-sorted contiguous
    bucketing, per-epoch bucket shuffling, and the background-prefetch
    iterator. Subclasses implement `_build_batch(indices, rng) -> dict`;
    `rng` is a fresh per-epoch RandomState owned by that epoch's producer
    thread (an abandoned mid-epoch producer can outlive its iterator, so
    nothing random may be shared across epochs)."""

    def __init__(
        self,
        dataset,
        *,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = int(prefetch)
        self._epoch = 0

        order = sorted(range(len(dataset)), key=dataset.duration)
        self._buckets = [
            order[i : i + self.batch_size]
            for i in range(0, len(order), self.batch_size)
        ]
        if drop_last and self._buckets and len(self._buckets[-1]) < self.batch_size:
            self._buckets = self._buckets[:-1]
            if not self._buckets:
                # a lone partial bucket is the reference's error too
                raise ValueError(
                    f"dataset ({len(dataset)} clips) is smaller than "
                    f"batch_size ({batch_size}) with drop_last=True; shrink "
                    "batch_size or pass drop_last=False"
                )

    def __len__(self) -> int:
        return len(self._buckets)

    def _build_batch(self, indices: list[int], rng: np.random.RandomState) -> dict:
        raise NotImplementedError

    def _epoch_bucket_order(self, epoch: int) -> list[list[int]]:
        buckets = list(self._buckets)
        if self.shuffle:
            rng = np.random.RandomState(self.seed + epoch)
            rng.shuffle(buckets)
        return buckets

    def __iter__(self):
        """One epoch of batches, produced by a background prefetch thread."""
        epoch = self._epoch
        buckets = self._epoch_bucket_order(epoch)
        self._epoch += 1
        # per-epoch, producer-thread-owned RNG (augmentation etc.) — never
        # shared with a previous epoch's possibly-still-running producer
        batch_rng = np.random.RandomState((self.seed + 0x5A + 0x9E37 * epoch) & 0x7FFFFFFF)
        q: queue.Queue = queue.Queue(maxsize=max(1, self.prefetch))
        _END, _ERR = object(), object()
        stop = threading.Event()

        def _put(item) -> bool:
            # bounded put that gives up when the consumer abandoned the
            # iterator — otherwise the producer blocks on a full queue
            # forever, leaking the thread and `prefetch` decoded batches
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for idx in buckets:
                    if not _put(self._build_batch(idx, batch_rng)):
                        return
                _put(_END)
            except BaseException as exc:  # surface in the consumer
                _put((_ERR, exc))

        worker = threading.Thread(target=produce, daemon=True, name="parakeet-data")
        worker.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    break
                if isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
                    raise item[1]
                yield item
        finally:
            stop.set()  # runs on GeneratorExit too (abandoned iterator)


class TrainDataLoader(_BucketedLoader):
    """Iterate padded training batches (the dict schema of
    train.synthetic_batch: features / mel_lengths / labels / label_lengths,
    as tensors on `device`).

    Args:
      dataset: ManifestDataset (or any sequence of manifest-entry dicts
        with a `duration(i)` helper).
      tokenizer: text.Tokenizer (loaded); transcripts are encoded per
        batch in the producer thread.
      batch_size: clips per batch. The last short batch is dropped when
        drop_last (default: True, as in the reference).
      audio_config: mel frontend config (must match the model preset).
      frame_multiple / label_multiple: pad the mel-frame / label axes of
        every batch up to these multiples (the reference's shapes).
      shuffle: shuffle BATCH ORDER each epoch (entries stay
        duration-sorted inside batches so padding waste stays low).
      seed: shuffle seed; epoch e uses seed + e.
      prefetch: producer queue depth (batches decoded ahead).
      device: where the frontend runs and the batches live (the card
        unless given).
    """

    def __init__(
        self,
        dataset: ManifestDataset,
        tokenizer,
        *,
        batch_size: int,
        audio_config: AudioConfig = AudioConfig(),
        frame_multiple: int = 160,
        label_multiple: int = 16,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        prefetch: int = 2,
        target_sample_rate: int = 16000,
        spec_augment=None,
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        if not tokenizer.loaded:
            raise ValueError("tokenizer must be loaded before building batches")
        super().__init__(
            dataset, batch_size=batch_size, shuffle=shuffle, seed=seed,
            drop_last=drop_last, prefetch=prefetch,
        )
        self.tokenizer = tokenizer
        self.audio_config = audio_config
        self.frame_multiple = int(frame_multiple)
        self.label_multiple = int(label_multiple)
        self.target_sample_rate = int(target_sample_rate)
        self.device = resolve_device(device)
        # SpecAugmentConfig (or True for defaults) → masks applied in the
        # prefetch thread; None/False = off (evaluation / default)
        if spec_augment is True:
            from parakeet_tpu_torch.augment import SpecAugmentConfig

            spec_augment = SpecAugmentConfig()
        self.spec_augment = spec_augment or None

    def _build_batch(self, indices: list[int], rng: np.random.RandomState) -> dict:
        cfg = self.audio_config
        waves, token_ids = [], []
        for i in indices:
            e = self.dataset[i]
            audio = read_audio(e["audio_filepath"], self.target_sample_rate)
            waves.append(np.asarray(audio.samples, np.float32))
            token_ids.append(self.tokenizer.encode(e["text"]))

        feats, n_frames = preprocess_audio_batch(waves, cfg, self.device)
        b, t_have, _ = feats.shape
        t_pad = _round_up(t_have, self.frame_multiple)
        feats = F.pad(feats, (0, 0, 0, t_pad - t_have))

        u_pad = _round_up(max((len(t) for t in token_ids), default=1), self.label_multiple)
        labels = np.zeros((b, u_pad), np.int32)
        label_lengths = np.zeros((b,), np.int32)
        for r, ids in enumerate(token_ids):
            labels[r, : len(ids)] = ids
            label_lengths[r] = len(ids)

        if self.spec_augment is not None:
            from parakeet_tpu_torch.augment import spec_augment

            feats = torch.from_numpy(spec_augment(rng, feats.cpu().numpy(), np.asarray(n_frames),
                                                  self.spec_augment)).to(self.device)

        return {
            "features": feats,
            "mel_lengths": torch.tensor(n_frames, dtype=torch.int32, device=self.device),
            "labels": torch.from_numpy(labels).to(self.device),
            "label_lengths": torch.from_numpy(label_lengths).to(self.device),
        }

# ─── Diarization training data (RTTM) ───────────────────────────────────────


def read_rttm(path: str | Path) -> list[tuple[str, float, float]]:
    """Parse RTTM SPEAKER lines → [(speaker_id, tbeg_s, tdur_s)].

    RTTM (NIST Rich Transcription Time Marked): whitespace-separated
    `SPEAKER <file> <chan> <tbeg> <tdur> <ortho> <stype> <name> <conf> ...`.
    Non-SPEAKER record types are skipped (the format also carries
    NON-LEX/NON-SPEECH rows)."""
    segments: list[tuple[str, float, float]] = []
    with open(path, "r", encoding="utf-8") as f:
        for line_no, line in enumerate(f, 1):
            parts = line.split()
            if not parts or parts[0] != "SPEAKER":
                continue
            if len(parts) < 8:
                raise ValueError(
                    f"{path}:{line_no}: SPEAKER line needs >=8 fields, got {len(parts)}"
                )
            try:
                tbeg, tdur = float(parts[3]), float(parts[4])
            except ValueError as err:
                raise ValueError(f"{path}:{line_no}: bad tbeg/tdur ({err})") from err
            if tdur < 0:
                raise ValueError(f"{path}:{line_no}: negative duration {tdur}")
            segments.append((parts[7], tbeg, tdur))
    return segments


def rttm_to_targets(
    segments: list[tuple[str, float, float]],
    num_frames: int,
    frame_seconds: float,
    max_speakers: int = 4,
) -> np.ndarray:
    """RTTM segments → (num_frames, max_speakers) 0/1 activity targets with
    channels in ARRIVAL order (first-onset speaker = channel 0) — the Sort
    Loss convention (train.sortformer_loss_fn; Sortformer's output channels
    are arrival-ordered by construction). Speakers beyond max_speakers (by
    arrival) are dropped, matching the model's fixed speaker capacity."""
    first: dict[str, float] = {}
    for spk, tbeg, _ in segments:
        first[spk] = min(first.get(spk, float("inf")), tbeg)
    order = sorted(first, key=lambda s: (first[s], s))[:max_speakers]
    chan = {s: i for i, s in enumerate(order)}
    tgt = np.zeros((num_frames, max_speakers), np.float32)
    for spk, tbeg, tdur in segments:
        c = chan.get(spk)
        if c is None:
            continue
        a = max(0, int(round(tbeg / frame_seconds)))
        b = min(num_frames, int(round((tbeg + tdur) / frame_seconds)))
        tgt[a:b, c] = 1.0
    return tgt


class DiarizationDataset(ManifestDataset):
    """JSONL manifest of (audio file, RTTM file) pairs: entries need
    `audio_filepath` and `rttm_filepath` (relative paths resolve against
    the manifest's directory), optional `duration`."""

    _REQUIRED = ("audio_filepath", "rttm_filepath")

    def __init__(self, manifest_path: str | Path):
        super().__init__(manifest_path)
        base = self.manifest_path.parent
        for e in self.entries:
            p = Path(e["rttm_filepath"])
            if not p.is_absolute():
                p = base / p
            e["rttm_filepath"] = str(p)


class DiarizationDataLoader(_BucketedLoader):
    """Padded diarization batches for train.make_sortformer_train_step:
    features (B, T, mel) / mel_lengths (B,) / targets (B, T', S) at the
    encoder frame rate (8× subsampled mel; 80 ms at the standard 10 ms
    hop). audio_config must match the Sortformer frontend (128 mels,
    normalize=False). Tensors on `device` (the card unless given)."""

    def __init__(
        self,
        dataset: DiarizationDataset,
        *,
        batch_size: int,
        audio_config: AudioConfig,
        max_speakers: int = 4,
        frame_multiple: int = 160,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        prefetch: int = 2,
        target_sample_rate: int = 16000,
        device: str | torch.device = DEFAULT_DEVICE,
    ):
        super().__init__(
            dataset, batch_size=batch_size, shuffle=shuffle, seed=seed,
            drop_last=drop_last, prefetch=prefetch,
        )
        self.device = resolve_device(device)
        self.audio_config = audio_config
        self.max_speakers = int(max_speakers)
        self.frame_multiple = int(frame_multiple)
        self.target_sample_rate = int(target_sample_rate)

    def _build_batch(self, indices: list[int], rng: np.random.RandomState) -> dict:
        from parakeet_tpu_torch.models.encoder import subsample_length

        cfg = self.audio_config
        waves, rttms = [], []
        for i in indices:
            e = self.dataset[i]
            audio = read_audio(e["audio_filepath"], self.target_sample_rate)
            waves.append(np.asarray(audio.samples, np.float32))
            rttms.append(read_rttm(e["rttm_filepath"]))

        feats, n_frames = preprocess_audio_batch(waves, cfg, self.device)
        b, t_have, _ = feats.shape
        t_pad = _round_up(t_have, self.frame_multiple)
        feats = F.pad(feats, (0, 0, 0, t_pad - t_have))

        enc_t = subsample_length(t_pad)
        frame_seconds = cfg.hop_length * 8 / cfg.sample_rate
        targets = np.zeros((b, enc_t, self.max_speakers), np.float32)
        for r, segs in enumerate(rttms):
            valid = subsample_length(int(n_frames[r]))
            targets[r, :valid] = rttm_to_targets(
                segs, valid, frame_seconds, self.max_speakers
            )

        return {
            "features": feats,
            "mel_lengths": torch.tensor(n_frames, dtype=torch.int32, device=self.device),
            "targets": torch.from_numpy(targets).to(self.device),
        }


__all__ = [
    "DiarizationDataLoader",
    "DiarizationDataset",
    "ManifestDataset",
    "TrainDataLoader",
    "read_rttm",
    "rttm_to_targets",
]
