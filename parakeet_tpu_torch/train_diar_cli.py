"""`python -m parakeet_tpu_torch.train_diar_cli`: fine-tune Sortformer
diarization from RTTM labels on one device (port of
parakeet_tpu/train_diar_cli.py).

Data flows DiarizationDataset (JSONL manifest of audio_filepath /
rttm_filepath) → DiarizationDataLoader (duration bucketing, the 128-mel
unnormalized frontend on the trainer's device, arrival-ordered frame
targets) → the Sort Loss + PIL train step (train.make_sortformer_train_step),
with checkpoint and resume and a safetensors export that both packages'
Sortformer load. It runs on the card unless given --device cpu; with
--data-parallel each rank is a process that python -m
torch.distributed.run starts (train_cli.py's mesh rules and
--dist-backend).

Example:
    python -m parakeet_tpu_torch.train_diar_cli --manifest diar.jsonl --steps 500 \\
        --batch-size 8 --checkpoint-dir ckpt/ --export sortformer.safetensors
"""

from __future__ import annotations

import argparse
import sys

from parakeet_tpu_torch.train_cli import add_device_flags, finish, open_mesh, resume_state, say, world_size


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="parakeet-train-diar",
        description="Fine-tune Sortformer diarization on CUDA cards.",
    )
    ap.add_argument("--manifest", required=True,
                    help="JSONL manifest (audio_filepath/rttm_filepath)")
    ap.add_argument("--model", default="sortformer-117m",
                    choices=["sortformer-117m", "tiny"],
                    help="'tiny' is a 2-layer smoke-test model")
    ap.add_argument("--init-weights", default=None,
                    help="safetensors to start from (converted NeMo Sortformer); "
                         "default: random init")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--schedule", default="constant",
                    choices=["constant", "cosine", "noam"])
    ap.add_argument("--warmup-steps", type=int, default=0)
    ap.add_argument("--clip-norm", type=float, default=None,
                    help="global-norm gradient clipping (default: off)")
    ap.add_argument("--bf16", action="store_true",
                    help="run the model in bfloat16; Adam keeps f32 masters")
    ap.add_argument("--sort-weight", type=float, default=0.5,
                    help="Sort Loss weight; (1-w) goes to PIL")
    ap.add_argument("--data-parallel", type=int, default=None,
                    help="data-parallel ways (default: all ranks); must divide "
                         "--batch-size")
    ap.add_argument("--remat", action="store_true",
                    help="rematerialize encoder blocks in backward")
    ap.add_argument("--accum-steps", type=int, default=1,
                    help="gradient accumulation chunks (must divide --batch-size)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--frame-multiple", type=int, default=160)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--export", default=None,
                    help="write final weights as safetensors (converter schema)")
    ap.add_argument("--log-every", type=int, default=10)
    add_device_flags(ap)
    return ap


def _preset(name: str):
    from parakeet_tpu_torch import config as C

    if name == "sortformer-117m":
        return C.make_sortformer_117m_config()
    return C.SortformerConfig(
        nest_encoder=C.StreamingEncoderConfig(
            mel_bins=128, subsampling_channels=8, hidden_size=24, num_layers=2,
            num_heads=2, ffn_intermediate=32, conv_kernel_size=5,
            att_context_left=6, att_context_right=0,
            subsampling_activation="relu", xscaling=True,
        ),
        encoder_hidden=24,
        transformer_hidden=12,
        transformer=C.TransformerConfig(
            hidden_size=12, num_layers=2, num_heads=2, ffn_intermediate=24,
            pre_ln=False, has_final_norm=False,
        ),
        max_speakers=4,
    )


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

    from parakeet_tpu_torch import params as P
    from parakeet_tpu_torch.config import AudioConfig
    from parakeet_tpu_torch.data import DiarizationDataLoader, DiarizationDataset
    from parakeet_tpu_torch.device import resolve_device
    from parakeet_tpu_torch.train import make_sharded_trainer
    from parakeet_tpu_torch.train_loop import run_training

    device = resolve_device(args.device)
    cfg = _preset(args.model)
    dp = args.data_parallel or world_size()
    if args.batch_size % dp:
        raise SystemExit(
            f"--batch-size {args.batch_size} must be divisible by the data-parallel "
            f"ways ({dp}); pass --data-parallel explicitly to shrink the mesh"
        )
    if args.batch_size % max(args.accum_steps, 1):
        raise SystemExit(f"--accum-steps {args.accum_steps} must divide --batch-size")
    mesh = open_mesh(args, dp, device, "parakeet_tpu_torch.train_diar_cli")
    if mesh is not None:
        device = mesh.device
    spec = P.sortformer_spec(cfg)
    params = (
        P.load_params_numpy(spec, args.init_weights, warn=lambda m: say(f"# {m}"))
        if args.init_weights
        else P.init_params_numpy(spec, seed=args.seed)
    )

    dataset = DiarizationDataset(args.manifest)
    loader = DiarizationDataLoader(
        dataset,
        batch_size=args.batch_size,
        # Sortformer frontend: 128 unnormalized mels (sortformer.cpp parity)
        audio_config=AudioConfig(n_mels=cfg.nest_encoder.mel_bins, normalize=False),
        max_speakers=cfg.max_speakers,
        frame_multiple=args.frame_multiple,
        seed=args.seed,
        device=device,
    )
    say(f"# {len(dataset)} clips, {len(loader)} batches/epoch")
    mesh, state, step_fn, place_batch = make_sharded_trainer(
        cfg, params, mesh, learning_rate=args.lr, loss="sortformer",
        sort_weight=args.sort_weight, remat=args.remat, accum_steps=args.accum_steps,
        compute_dtype="bfloat16" if args.bf16 else "float32",
        schedule=args.schedule, warmup_steps=args.warmup_steps, decay_steps=args.steps,
        clip_norm=args.clip_norm, device=device,
    )
    if args.resume:
        state = resume_state(args, mesh, state)
    params, opt_state, step = run_training(
        mesh, loader, state, step_fn, place_batch,
        steps=args.steps, log_every=args.log_every,
        checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
    )
    finish(args, cfg, params, opt_state, step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
