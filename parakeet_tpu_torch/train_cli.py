"""`python -m parakeet_tpu_torch.train_cli`: fine-tune a Parakeet stack from
a JSONL manifest on one device (port of parakeet_tpu/train_cli.py).

Data flows ManifestDataset → TrainDataLoader (duration bucketing, shape
quantization, background prefetch, the frontend on the trainer's device) →
the train step of train.py (CTC / RNNT / TDT lattice / hybrid TDT+CTC),
with periodic checkpoint and resume (checkpoint.py, the reference's
layout) and a final safetensors export in the converter's schema, which
both packages' Transcriber load. It runs on the card unless given
--device cpu. The parallelism flags above 1 exit: ROADMAP Queue 1 item 6b.

Example:
    python -m parakeet_tpu_torch.train_cli --manifest train.jsonl --vocab vocab.txt \\
        --model 110m --loss hybrid --batch-size 16 --steps 1000 \\
        --checkpoint-dir ckpt/ --export model.safetensors
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import replace
from pathlib import Path

from parakeet_tpu_torch.train import PARALLELISM_NOT_PORTED


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="parakeet-train", description="Fine-tune a Parakeet model on one CUDA card."
    )
    ap.add_argument("--manifest", required=True, help="JSONL manifest (audio_filepath/text)")
    ap.add_argument("--vocab", required=True, help="vocab.txt (tokenizer pieces)")
    ap.add_argument("--model", default="110m",
                    choices=["110m", "tdt-600m", "rnnt-600m", "tiny"],
                    help="model preset (sets encoder/prediction/joint shapes); "
                         "'tiny' is a 2-layer smoke-test model")
    ap.add_argument("--loss", default=None,
                    choices=["ctc", "tdt", "rnnt", "hybrid"],
                    help="objective (default: hybrid for 110m, tdt for tdt-600m, "
                         "rnnt for rnnt-600m)")
    ap.add_argument("--init-weights", default=None,
                    help="safetensors to start from (e.g. a converted NeMo ckpt); "
                         "default: random init")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--steps", type=int, default=100, help="optimizer steps to run")
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--schedule", default="constant",
                    choices=["constant", "cosine", "noam"],
                    help="learning-rate schedule (cosine decays over --steps; "
                         "noam = Transformer inverse-sqrt)")
    ap.add_argument("--warmup-steps", type=int, default=0)
    ap.add_argument("--clip-norm", type=float, default=None,
                    help="global-norm gradient clipping (default: off)")
    ap.add_argument("--bf16", action="store_true",
                    help="run the model in bfloat16; Adam keeps f32 master params")
    ap.add_argument("--sigma", type=float, default=0.05, help="TDT logit under-normalization")
    ap.add_argument("--model-parallel", type=int, default=1, help="tensor-parallel ways (not ported: 1 only)")
    ap.add_argument("--data-parallel", type=int, default=None, help="data-parallel ways (not ported: 1 only)")
    ap.add_argument("--seq-parallel", type=int, default=1, help="sequence-parallel ways (not ported: 1 only)")
    ap.add_argument("--pipeline-parallel", type=int, default=1,
                    help="pipeline-parallel stages (not ported: 1 only)")
    ap.add_argument("--micro-batches", type=int, default=2,
                    help="GPipe microbatches per step with --pipeline-parallel (not ported)")
    ap.add_argument("--remat", action="store_true",
                    help="rematerialize each conformer block in backward "
                         "(less activation memory, same numerics)")
    ap.add_argument("--accum-steps", type=int, default=1,
                    help="gradient accumulation: split each batch into N equal "
                         "chunks run one after another (same numerics, less "
                         "activation memory; N must divide --batch-size)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frame-multiple", type=int, default=160,
                    help="pad mel frames per batch up to this multiple")
    ap.add_argument("--label-multiple", type=int, default=16)
    ap.add_argument("--spec-augment", action="store_true",
                    help="SpecAugment on training batches (NeMo recipe: "
                         "2 freq masks <=27 bins, 10 time masks <=5%%)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true",
                    help="resume from --checkpoint-dir if a checkpoint exists")
    ap.add_argument("--export", default=None,
                    help="write final weights as safetensors (reference schema)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains (default: the CUDA card)")
    return ap


def check_single_device(args) -> None:
    """SystemExit for a parallelism flag above 1 (ROADMAP Queue 1 item 6b)."""
    for flag in ("model_parallel", "seq_parallel", "pipeline_parallel", "data_parallel"):
        ways = getattr(args, flag, None)
        if ways is not None and ways > 1:
            raise SystemExit(f"--{flag.replace('_', '-')} {ways}: {PARALLELISM_NOT_PORTED}")


def _preset(name: str):
    from parakeet_tpu_torch import config as C

    if name == "110m":
        return C.make_110m_config(), "tdt_ctc", "hybrid"
    if name == "tdt-600m":
        return C.make_tdt_600m_config(), "tdt", "tdt"
    if name == "rnnt-600m":
        return C.make_rnnt_600m_config(), "rnnt", "rnnt"
    # 'tiny': pipeline smoke tests / install checks
    tiny = C.TDTCTCConfig(
        encoder=C.EncoderConfig(mel_bins=80, subsampling_channels=8, hidden_size=16,
                                num_layers=2, num_heads=2, ffn_intermediate=32),
        prediction=C.PredictionConfig(vocab_size=33, pred_hidden=8, num_lstm_layers=1),
        joint=C.JointConfig(encoder_hidden=16, pred_hidden=8, joint_hidden=8,
                            vocab_size=33),
        ctc_vocab_size=33,
    )
    return tiny, "tdt_ctc", "hybrid"


def _spec_for(cfg, kind: str):
    from parakeet_tpu_torch import params as P

    return {"tdt_ctc": P.tdt_ctc_spec, "tdt": P.tdt_spec, "rnnt": P.rnnt_spec}[kind](cfg)


def _fit_vocab(cfg, kind: str, tokenizer):
    """Resize prediction/joint/ctc vocab dims to the tokenizer (+1 blank)."""
    want = tokenizer.vocab_size() + 1
    if cfg.joint.vocab_size == want:
        return cfg
    print(f"# preset vocab {cfg.joint.vocab_size} != tokenizer+blank {want}; resizing",
          file=sys.stderr)
    cfg = replace(cfg, prediction=replace(cfg.prediction, vocab_size=want),
                  joint=replace(cfg.joint, vocab_size=want))
    if kind == "tdt_ctc":
        cfg = replace(cfg, ctc_vocab_size=want)
    return cfg


def resume_state(args, device, state):
    """The trainer's state from --checkpoint-dir under --resume (unchanged
    when there is no checkpoint yet)."""
    from parakeet_tpu_torch.checkpoint import load_train_state
    from parakeet_tpu_torch.train_loop import place_train_state

    if not args.checkpoint_dir:
        raise SystemExit("--resume needs --checkpoint-dir")
    ck = Path(args.checkpoint_dir)
    if (ck / "state.safetensors").exists() or (ck / "params.safetensors").exists():
        p2, o2, s2 = load_train_state(ck, state.opt_state)
        state = place_train_state(device, p2, o2, s2, state)
        print(f"# resumed at step {s2}", file=sys.stderr)
    return state


def finish(args, params, opt_state, step) -> None:
    """The final checkpoint and the --export file."""
    from parakeet_tpu_torch.checkpoint import save_train_state
    from parakeet_tpu_torch.io.safetensors import save_safetensors

    if args.checkpoint_dir:
        save_train_state(args.checkpoint_dir, params, opt_state, step)
        print(f"# checkpoint: {args.checkpoint_dir} (step {step})", file=sys.stderr)
    if args.export:
        save_safetensors({k: v.detach().cpu().numpy() for k, v in params.items()}, args.export,
                         metadata={"format": "pt"})
        print(f"# exported: {args.export}", file=sys.stderr)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    check_single_device(args)

    from parakeet_tpu_torch import params as P
    from parakeet_tpu_torch.config import AudioConfig
    from parakeet_tpu_torch.data import ManifestDataset, TrainDataLoader
    from parakeet_tpu_torch.device import resolve_device
    from parakeet_tpu_torch.text.tokenizer import Tokenizer
    from parakeet_tpu_torch.train import make_sharded_trainer
    from parakeet_tpu_torch.train_loop import run_training

    device = resolve_device(args.device)
    tokenizer = Tokenizer(args.vocab)
    cfg, kind, default_loss = _preset(args.model)
    loss = args.loss or default_loss
    if kind == "rnnt" and loss in ("tdt", "hybrid", "ctc"):
        raise SystemExit(f"--loss {loss} needs a TDT/CTC head; rnnt-600m trains with --loss rnnt")
    if kind == "tdt" and loss in ("hybrid", "ctc"):
        raise SystemExit(f"--loss {loss} needs a CTC head; tdt-600m trains with --loss tdt/rnnt")
    cfg = _fit_vocab(cfg, kind, tokenizer)
    spec = _spec_for(cfg, kind)
    if args.init_weights:
        params = P.load_params_numpy(spec, args.init_weights, warn=lambda m: print(f"# {m}", file=sys.stderr))
    else:
        params = P.init_params_numpy(spec, seed=args.seed)

    dataset = ManifestDataset(args.manifest)
    loader = TrainDataLoader(
        dataset, tokenizer, batch_size=args.batch_size,
        audio_config=AudioConfig(n_mels=cfg.encoder.mel_bins),
        frame_multiple=args.frame_multiple, label_multiple=args.label_multiple,
        seed=args.seed, spec_augment=args.spec_augment, device=device,
    )
    print(f"# {len(dataset)} clips, {len(loader)} batches/epoch, loss={loss}",
          file=sys.stderr)
    if args.batch_size % max(args.accum_steps, 1):
        raise SystemExit(f"--accum-steps {args.accum_steps} must divide --batch-size")
    device, state, step_fn, place_batch = make_sharded_trainer(
        cfg, params, learning_rate=args.lr, loss=loss, sigma=args.sigma,
        remat=args.remat, accum_steps=args.accum_steps,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        schedule=args.schedule, warmup_steps=args.warmup_steps,
        decay_steps=args.steps, clip_norm=args.clip_norm, device=device,
    )
    if args.resume:
        state = resume_state(args, device, state)
    params, opt_state, step = run_training(
        loader, state, step_fn, place_batch,
        steps=args.steps, log_every=args.log_every,
        checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
    )
    finish(args, params, opt_state, step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
