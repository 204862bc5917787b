"""NeMo checkpoint → safetensors conversion (port of
parakeet_tpu/tools/convert.py; a copy that writes through the port's own
io/safetensors.py, so both tools write byte-identical files).

Produces weight files in the SAME schema as the reference converter
(scripts/convert_nemo.py — the key map there is the on-disk contract this
framework loads, see parakeet_tpu_torch/params.py), so files converted by
either tool are interchangeable:

  * subsampling conv indices {0,2,3,5,6,8} → conv1_/dw1_/conv2_/dw2_/conv3_/dw3_
  * per-layer conformer mapping (ffn1/attn/conv/ffn2/final norm)
  * LSTM bias merge: bias_ih + bias_hh → input_proj_.bias
  * TDT joint split: joint.joint_net.2 → label_proj_[:vocab] + duration_proj_[vocab:]
    (RNNT: unsplit → out_proj_)
  * skip preprocessor.*; hard error on unmapped keys; missing CTC head
    tolerated with a warning; everything cast to float32.

Torch reads the pickled checkpoint. Call `convert` and `extract_vocab`
from Python.
"""

from __future__ import annotations

import tarfile
import tempfile
from pathlib import Path

import numpy as np

from parakeet_tpu_torch.io.safetensors import save_safetensors

# ─── NeMo → schema name maps ────────────────────────────────────────────────


def _subsampling_map(prefix: str) -> dict[str, str]:
    m = {}
    conv_names = {"0": "conv1_", "2": "dw1_", "3": "conv2_", "5": "dw2_", "6": "conv3_", "8": "dw3_"}
    for idx, name in conv_names.items():
        for p in ("weight", "bias"):
            m[f"encoder.pre_encode.conv.{idx}.{p}"] = f"{prefix}.subsampling_.{name}.{p}"
    for p in ("weight", "bias"):
        m[f"encoder.pre_encode.out.{p}"] = f"{prefix}.subsampling_.proj_.{p}"
    return m


def _conformer_layer_map(i: int, prefix: str) -> dict[str, str]:
    n, a = f"encoder.layers.{i}", f"{prefix}.layers_.{i}"
    m = {}
    pairs = [
        ("norm_feed_forward1", "ffn1_.norm_"),
        ("feed_forward1.linear1", "ffn1_.fc1_"),
        ("feed_forward1.linear2", "ffn1_.fc2_"),
        ("norm_self_att", "attn_.norm_"),
        ("self_attn.linear_q", "attn_.mha_.q_proj"),
        ("self_attn.linear_k", "attn_.mha_.k_proj"),
        ("self_attn.linear_v", "attn_.mha_.v_proj"),
        ("self_attn.linear_out", "attn_.mha_.out_proj"),
        ("norm_conv", "conv_.norm_"),
        ("conv.pointwise_conv1", "conv_.pointwise_conv1_"),
        ("conv.depthwise_conv", "conv_.depthwise_conv_"),
        ("conv.batch_norm", "conv_.batch_norm_"),
        ("conv.pointwise_conv2", "conv_.pointwise_conv2_"),
        ("norm_feed_forward2", "ffn2_.norm_"),
        ("feed_forward2.linear1", "ffn2_.fc1_"),
        ("feed_forward2.linear2", "ffn2_.fc2_"),
        ("norm_out", "final_norm_"),
    ]
    for nemo, ours in pairs:
        for p in ("weight", "bias"):
            m[f"{n}.{nemo}.{p}"] = f"{a}.{ours}.{p}"
    m[f"{n}.self_attn.linear_pos.weight"] = f"{a}.attn_.pos_proj_.weight"
    m[f"{n}.self_attn.pos_bias_u"] = f"{a}.attn_.pos_bias_u_"
    m[f"{n}.self_attn.pos_bias_v"] = f"{a}.attn_.pos_bias_v_"
    for stat in ("running_mean", "running_var", "num_batches_tracked"):
        m[f"{n}.conv.batch_norm.{stat}"] = f"{a}.conv_.batch_norm_.{stat}"
    return m


def _prediction_map(num_lstm_layers: int) -> dict[str, str]:
    m = {"decoder.prediction.embed.weight": "prediction_.embed_.weight"}
    for l in range(num_lstm_layers):
        m[f"decoder.prediction.dec_rnn.lstm.weight_ih_l{l}"] = (
            f"prediction_.lstm_.cells_.{l}.input_proj_.weight"
        )
        m[f"decoder.prediction.dec_rnn.lstm.weight_hh_l{l}"] = (
            f"prediction_.lstm_.cells_.{l}.hidden_proj_.weight"
        )
    return m


def _joint_map(joint_prefix: str) -> dict[str, str]:
    m = {}
    for p in ("weight", "bias"):
        m[f"joint.enc.{p}"] = f"{joint_prefix}.enc_proj_.{p}"
        m[f"joint.pred.{p}"] = f"{joint_prefix}.pred_proj_.{p}"
    return m


def _ctc_map() -> dict[str, str]:
    m = {}
    for prefix in ("ctc_decoder.decoder_layers.0", "ctc_decoder.0"):
        for p in ("weight", "bias"):
            m[f"{prefix}.{p}"] = f"ctc_decoder_.proj_.{p}"
    return m


def _transformer_map(num_layers: int) -> dict[str, str]:
    m = {}
    for i in range(num_layers):
        n, a = f"transformer_encoder.layers.{i}", f"transformer_.layers_.{i}"
        pairs = [
            ("layer_norm_1", "norm1_"),
            ("layer_norm_2", "norm2_"),
            ("first_sub_layer.query_net", "mha_.q_proj"),
            ("first_sub_layer.key_net", "mha_.k_proj"),
            ("first_sub_layer.value_net", "mha_.v_proj"),
            ("first_sub_layer.out_projection", "mha_.out_proj"),
            ("second_sub_layer.dense_in", "fc1_"),
            ("second_sub_layer.dense_out", "fc2_"),
        ]
        for nemo, ours in pairs:
            for p in ("weight", "bias"):
                m[f"{n}.{nemo}.{p}"] = f"{a}.{ours}.{p}"
    return m


def _sortformer_modules_map() -> dict[str, str]:
    m = {}
    pairs = [
        ("sortformer_modules.encoder_proj", "projection_"),
        ("sortformer_modules.single_hidden_to_spks", "output_proj_"),
        ("sortformer_modules.first_hidden_to_hidden", "first_hidden_"),
        ("sortformer_modules.hidden_to_spks", "hidden_to_spks_"),
    ]
    for nemo, ours in pairs:
        for p in ("weight", "bias"):
            m[f"{nemo}.{p}"] = f"{ours}.{p}"
    return m


PRESETS = {
    "110m-tdt-ctc": dict(num_layers=17, vocab_size=1025, num_durations=5,
                         num_lstm_layers=1, has_ctc=True, joint_prefix="tdt_joint_"),
    "600m-tdt": dict(num_layers=24, vocab_size=8193, num_durations=5,
                     num_lstm_layers=2, has_ctc=False, joint_prefix="joint_"),
    "rnnt-600m": dict(num_layers=24, vocab_size=1025, num_durations=0,
                      num_lstm_layers=2, has_ctc=False, joint_prefix="joint_", is_rnnt=True),
    "eou-120m": dict(num_layers=17, vocab_size=1025, num_durations=5,
                     num_lstm_layers=1, has_ctc=True, joint_prefix="tdt_joint_"),
    "nemotron-600m": dict(num_layers=24, vocab_size=8193, num_durations=5,
                          num_lstm_layers=2, has_ctc=False, joint_prefix="joint_"),
    "sortformer": dict(num_layers=17, num_transformer_layers=18, vocab_size=0,
                       num_durations=0, num_lstm_layers=0, has_ctc=False,
                       has_decoder=False, joint_prefix="", encoder_prefix="nest_encoder_"),
}


def build_mapping(preset: dict) -> dict[str, str]:
    prefix = preset.get("encoder_prefix", "encoder_")
    m = _subsampling_map(prefix)
    for i in range(preset["num_layers"]):
        m.update(_conformer_layer_map(i, prefix))
    if preset.get("has_decoder", True) and preset["num_lstm_layers"] > 0:
        m.update(_prediction_map(preset["num_lstm_layers"]))
    if preset.get("has_decoder", True) and preset["joint_prefix"]:
        m.update(_joint_map(preset["joint_prefix"]))
    if preset.get("has_ctc"):
        m.update(_ctc_map())
    if preset.get("num_transformer_layers", 0) > 0:
        m.update(_transformer_map(preset["num_transformer_layers"]))
        m.update(_sortformer_modules_map())
    return m


# ─── Conversion ──────────────────────────────────────────────────────────────


def _load_state_dict(path: Path) -> dict[str, np.ndarray]:
    import torch

    if path.suffix == ".nemo" or tarfile.is_tarfile(path):
        with tarfile.open(path) as tar, tempfile.TemporaryDirectory() as tmp:
            member = next(
                (m for m in tar.getmembers() if m.name.endswith("model_weights.ckpt")), None
            )
            if member is None:
                raise FileNotFoundError("model_weights.ckpt not found inside .nemo archive")
            tar.extract(member, tmp, filter="data")
            sd = torch.load(Path(tmp) / member.name, map_location="cpu", weights_only=True)
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    if "state_dict" in sd and isinstance(sd["state_dict"], dict):
        sd = sd["state_dict"]
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in sd.items()}


def convert(
    nemo_path: str | Path,
    output_path: str | Path,
    model: str = "110m-tdt-ctc",
    *,
    state_dict: dict[str, np.ndarray] | None = None,
    verbose: bool = True,
) -> dict[str, np.ndarray]:
    """Convert a NeMo checkpoint; returns and writes the converted dict."""
    preset = PRESETS[model]
    if state_dict is None:
        state_dict = _load_state_dict(Path(nemo_path))
    mapping = build_mapping(preset)
    vocab_size = preset["vocab_size"]
    num_durations = preset["num_durations"]
    joint_prefix = preset["joint_prefix"]
    is_rnnt = preset.get("is_rnnt", False)

    out: dict[str, np.ndarray] = {}
    handled: set[str] = set()
    skipped, unmapped = [], []

    # LSTM bias merge
    for l in range(preset["num_lstm_layers"]):
        ih = state_dict.get(f"decoder.prediction.dec_rnn.lstm.bias_ih_l{l}")
        hh = state_dict.get(f"decoder.prediction.dec_rnn.lstm.bias_hh_l{l}")
        if ih is not None and hh is not None:
            out[f"prediction_.lstm_.cells_.{l}.input_proj_.bias"] = ih + hh
            handled.add(f"decoder.prediction.dec_rnn.lstm.bias_ih_l{l}")
            handled.add(f"decoder.prediction.dec_rnn.lstm.bias_hh_l{l}")

    # Joint output split (TDT) / passthrough (RNNT)
    jw = state_dict.get("joint.joint_net.2.weight")
    jb = state_dict.get("joint.joint_net.2.bias")
    if jw is not None and joint_prefix and not is_rnnt:
        # guard the split: a preset/vocab mismatch would silently slice the
        # joint into plausibly-shaped but wrong label/duration heads
        expected = vocab_size + num_durations
        if jw.shape[0] != expected:
            raise ValueError(
                f"joint output dim {jw.shape[0]} != vocab_size ({vocab_size}) + "
                f"durations ({num_durations}) = {expected} — wrong --model preset "
                "for this checkpoint?"
            )
    if jw is not None and joint_prefix:
        if is_rnnt:
            out[f"{joint_prefix}.out_proj_.weight"] = jw
        else:
            out[f"{joint_prefix}.label_proj_.weight"] = jw[:vocab_size]
            out[f"{joint_prefix}.duration_proj_.weight"] = jw[vocab_size:]
        handled.add("joint.joint_net.2.weight")
    if jb is not None and joint_prefix:
        if is_rnnt:
            out[f"{joint_prefix}.out_proj_.bias"] = jb
        else:
            out[f"{joint_prefix}.label_proj_.bias"] = jb[:vocab_size]
            out[f"{joint_prefix}.duration_proj_.bias"] = jb[vocab_size:]
        handled.add("joint.joint_net.2.bias")

    for key, tensor in state_dict.items():
        if key in handled:
            continue
        if key.startswith("preprocessor."):
            skipped.append(key)
            continue
        target = mapping.get(key)
        if target is None:
            unmapped.append(key)
            continue
        if target not in out:
            out[target] = tensor

    if verbose:
        print(f"[convert] mapped {len(out)} tensors, skipped {len(skipped)}")
    if unmapped:
        raise ValueError(f"{len(unmapped)} unmapped NeMo keys, e.g. {unmapped[:5]}")
    if preset.get("has_ctc") and "ctc_decoder_.proj_.weight" not in out and verbose:
        print("[convert] WARNING: CTC head missing from checkpoint; it will be random-init at load")

    out = {k: np.ascontiguousarray(v, dtype=np.float32) for k, v in out.items()}
    if output_path:
        save_safetensors(out, output_path, metadata={"format": "pt"})
        if verbose:
            print(f"[convert] wrote {output_path}")
    return out


def _read_varint(data: bytes, pos: int) -> tuple[int, int]:
    val = shift = 0
    while True:
        b = data[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def parse_sentencepiece_model(data: bytes) -> list[str]:
    """Extract pieces from a SentencePiece `.model` file (ModelProto) with a
    minimal protobuf walk — no sentencepiece dependency.

    ModelProto layout (sentencepiece_model.proto): repeated field 1 =
    SentencePiece message, whose field 1 is the piece string. All other
    fields/wire types are skipped. Piece order is vocab-id order."""
    pieces: list[str] = []
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            _, pos = _read_varint(data, pos)
        elif wire == 1:
            pos += 8
        elif wire == 5:
            pos += 4
        elif wire == 2:
            ln, pos = _read_varint(data, pos)
            body = data[pos : pos + ln]
            pos += ln
            if field != 1:
                continue
            p, piece = 0, None
            while p < len(body):
                t2, p = _read_varint(body, p)
                f2, w2 = t2 >> 3, t2 & 7
                if w2 == 0:
                    _, p = _read_varint(body, p)
                elif w2 == 1:
                    p += 8
                elif w2 == 5:
                    p += 4
                elif w2 == 2:
                    l2, p = _read_varint(body, p)
                    if f2 == 1:
                        piece = body[p : p + l2].decode("utf-8", errors="surrogateescape")
                    p += l2
                else:
                    raise ValueError(f"unsupported protobuf wire type {w2}")
            if piece is not None:
                pieces.append(piece)
        else:
            raise ValueError(f"unsupported protobuf wire type {wire}")
    return pieces


def extract_vocab(nemo_path: str | Path, output_path: str | Path) -> int:
    """Pull the SentencePiece vocab out of a .nemo tar; one piece per line.

    Prefers a `tokenizer.vocab`/`vocab.txt` member (reference
    scripts/extract_vocab.py:18-49); archives shipping only the
    `tokenizer.model` sentencepiece protobuf are handled by parsing the
    ModelProto pieces directly."""
    with tarfile.open(nemo_path) as tar:
        members = tar.getmembers()
        member = next(
            (m for m in members
             if m.name.endswith(".vocab") or m.name.endswith("vocab.txt")), None
        )
        if member is not None:
            data = tar.extractfile(member).read().decode("utf-8", errors="surrogateescape")
            lines = [l.split("\t")[0] for l in data.splitlines() if l]
        else:
            model = next((m for m in members if m.name.endswith(".model")), None)
            if model is None:
                raise FileNotFoundError(
                    "no tokenizer.vocab / vocab.txt / tokenizer.model inside .nemo archive"
                )
            lines = parse_sentencepiece_model(tar.extractfile(model).read())
            if not lines:
                raise ValueError(f"{model.name}: no pieces parsed from sentencepiece model")
    Path(output_path).write_text("\n".join(lines) + "\n", encoding="utf-8", errors="surrogateescape")
    return len(lines)


__all__ = ["PRESETS", "build_mapping", "convert", "extract_vocab", "parse_sentencepiece_model"]
