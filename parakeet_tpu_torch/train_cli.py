"""`python -m parakeet_tpu_torch.train_cli`: fine-tune a Parakeet stack from
a JSONL manifest (port of parakeet_tpu/train_cli.py).

Data flows ManifestDataset → TrainDataLoader (duration bucketing, shape
quantization, background prefetch, the frontend on the trainer's device) →
the train step of train.py (CTC / RNNT / TDT lattice / hybrid TDT+CTC),
with periodic checkpoint and resume (checkpoint.py, the reference's
layout) and a final safetensors export in the converter's schema, which
both packages' Transcriber load. It runs on the card unless given
--device cpu.

On a mesh (--data-parallel, --model-parallel, --seq-parallel,
--pipeline-parallel) each rank is a process started by
`python -m torch.distributed.run`, which sets RANK, WORLD_SIZE,
LOCAL_RANK and the rendezvous; each rank takes card LOCAL_RANK and the
mesh spans them all (parallel/mesh.py make_mesh), the data-parallel ways
defaulting to the world over the other axes, as the reference's do from
its device count. --dist-backend names the process-group backend: NCCL
when each rank has its own card (the default on the card), gloo on the
CPU and for ranks that share one card (NCCL refuses that).

Example:
    python -m parakeet_tpu_torch.train_cli --manifest train.jsonl --vocab vocab.txt \\
        --model 110m --loss hybrid --batch-size 16 --steps 1000 \\
        --checkpoint-dir ckpt/ --export model.safetensors
    python -m torch.distributed.run --nproc-per-node 4 -m parakeet_tpu_torch.train_cli \\
        --manifest train.jsonl --vocab vocab.txt --model-parallel 2 --batch-size 16
"""

from __future__ import annotations

import argparse
import os
import sys
from dataclasses import replace
from pathlib import Path


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="parakeet-train", description="Fine-tune a Parakeet model on CUDA cards."
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
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="tensor-parallel ways (mesh = data × model)")
    ap.add_argument("--data-parallel", type=int, default=None,
                    help="data-parallel ways (default: ranks / (model×seq×pipeline parallel)); "
                         "must divide --batch-size")
    ap.add_argument("--seq-parallel", type=int, default=1,
                    help="sequence-parallel ways: encoder activations split over "
                         "time (mesh = data × seq × model)")
    ap.add_argument("--pipeline-parallel", type=int, default=1,
                    help="pipeline-parallel stages: conformer layers split over a "
                         "'pipe' mesh axis, GPipe microbatch schedule "
                         "(mesh = data × pipe; excludes --model/--seq-parallel)")
    ap.add_argument("--micro-batches", type=int, default=2,
                    help="GPipe microbatches per step with --pipeline-parallel "
                         "(must divide the per-data-shard batch)")
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
    add_device_flags(ap)
    return ap


def add_device_flags(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the model trains (default: the CUDA card; on a mesh each rank's)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend on a mesh (default: nccl on CUDA, gloo on the CPU); "
                         "ranks that share one card need gloo")


def launched() -> bool:
    """This process is a rank that python -m torch.distributed.run started
    (or one of a process group already initialised)."""
    import torch.distributed as dist

    return "RANK" in os.environ or dist.is_initialized()


def say(msg: str) -> None:
    """A `# …` line on stderr, from rank 0 only on a mesh."""
    from parakeet_tpu_torch.parallel.mesh import global_rank

    if global_rank() == 0:
        print(msg, file=sys.stderr)


def open_mesh(args, ways: int, device, module: str = "parakeet_tpu_torch.train_cli", **axes):
    """The mesh of this run's ranks (parallel/mesh.py make_mesh), or None
    when this process was not started as a rank and asks for one way; a
    parallel flag above 1 in a world of one process exits, naming the
    launcher."""
    if not launched():
        if ways > 1:
            raise SystemExit(
                f"the mesh asked for has {ways} ranks but this process runs alone: start one process a rank "
                f"with python -m torch.distributed.run --nproc-per-node {ways} -m {module} …"
            )
        return None
    from parakeet_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(ways, devices="cpu" if device.type == "cpu" else None, backend=args.dist_backend, **axes)


def world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else int(os.environ.get("WORLD_SIZE", "1"))


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


def resume_state(args, mesh, state, from_schema=lambda p: p, model_parallel: int = 1):
    """The trainer's state from --checkpoint-dir under --resume (unchanged
    when there is no checkpoint yet). `mesh`: the trainer's mesh, or its
    device; from_schema: the pipeline trainer's split of schema params
    into {layers, rest}; under model_parallel the vocab dims of a
    schema-shaped checkpoint are padded again (a no-op when it was saved
    padded), as the reference does."""
    from parakeet_tpu_torch.checkpoint import load_train_state
    from parakeet_tpu_torch.train_loop import place_train_state

    if not args.checkpoint_dir:
        raise SystemExit("--resume needs --checkpoint-dir")
    ck = Path(args.checkpoint_dir)
    if (ck / "state.safetensors").exists() or (ck / "params.safetensors").exists():
        p2, o2, s2 = load_train_state(ck, state.opt_state)
        p2 = from_schema(p2)
        if model_parallel > 1:
            from parakeet_tpu_torch.parallel.mesh import pad_vocab_dim

            p2 = {k: (pad_vocab_dim(k, v, model_parallel) if pad_vocab_dim(k, v, model_parallel) is not None
                      else v) for k, v in p2.items()}
        state = place_train_state(mesh, p2, o2, s2, state)
        say(f"# resumed at step {s2}")
    return state


def finish(args, cfg, params, opt_state, step) -> None:
    """The final checkpoint and the --export file: on a mesh the state
    gathered whole (every rank takes part) and written by rank 0, the
    export with the vocab padding sliced back off."""
    from parakeet_tpu_torch.checkpoint import save_train_state, whole_train_state
    from parakeet_tpu_torch.io.safetensors import save_safetensors
    from parakeet_tpu_torch.parallel.mesh import global_rank, unpad_vocab_params

    if args.checkpoint_dir:
        save_train_state(args.checkpoint_dir, params, opt_state, step)
        say(f"# checkpoint: {args.checkpoint_dir} (step {step})")
    if args.export:
        whole = whole_train_state(params, opt_state)[0]
        if global_rank() == 0:
            host = {k: v.detach().cpu().numpy() for k, v in whole.items()}
            vocab = getattr(getattr(cfg, "joint", None), "vocab_size", None)
            if vocab is not None:
                host = unpad_vocab_params(host, vocab, getattr(cfg, "ctc_vocab_size", None))
            save_safetensors(host, args.export, metadata={"format": "pt"})
        say(f"# exported: {args.export}")


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)

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

    mp, sp, pp = args.model_parallel, args.seq_parallel, args.pipeline_parallel
    if pp > 1 and (mp > 1 or sp > 1):
        raise SystemExit("--pipeline-parallel composes with data parallelism only")
    dp = args.data_parallel or max(1, world_size() // (mp * sp * pp))
    if args.batch_size % dp:
        raise SystemExit(
            f"--batch-size {args.batch_size} must be divisible by the data-parallel "
            f"ways ({dp}); pass --data-parallel explicitly to shrink the mesh"
        )
    if pp > 1:
        if (args.batch_size // dp) % args.micro_batches:
            raise SystemExit(
                f"per-shard batch {args.batch_size // dp} must be divisible by "
                f"--micro-batches {args.micro_batches}"
            )
        if args.remat or args.accum_steps > 1 or args.bf16:
            raise SystemExit(
                "--remat/--accum-steps/--bf16 don't apply with "
                "--pipeline-parallel (the GPipe trainer rematerializes each "
                "stage and microbatches via --micro-batches)"
            )
    elif args.batch_size % max(args.accum_steps, 1):
        raise SystemExit(f"--accum-steps {args.accum_steps} must divide --batch-size")
    mesh = open_mesh(args, dp * mp * sp * pp, device, model_parallel=mp, seq_parallel=sp, pipeline_parallel=pp)
    if mesh is not None:
        device = mesh.device

    if args.init_weights:
        params = P.load_params_numpy(spec, args.init_weights, warn=lambda m: say(f"# {m}"))
    else:
        params = P.init_params_numpy(spec, seed=args.seed)

    dataset = ManifestDataset(args.manifest)
    loader = TrainDataLoader(
        dataset, tokenizer, batch_size=args.batch_size,
        audio_config=AudioConfig(n_mels=cfg.encoder.mel_bins),
        frame_multiple=args.frame_multiple, label_multiple=args.label_multiple,
        seed=args.seed, spec_augment=args.spec_augment, device=device,
    )
    say(f"# {len(dataset)} clips, {len(loader)} batches/epoch, loss={loss}")
    from_schema = lambda p: p  # noqa: E731
    if pp > 1:
        from parakeet_tpu_torch.parallel.pipeline import make_pp_trainer, split_layer_params

        state, step_fn, place_batch, _ = make_pp_trainer(
            cfg, params, mesh, n_micro=args.micro_batches,
            learning_rate=args.lr, loss=loss, sigma=args.sigma,
            schedule=args.schedule, warmup_steps=args.warmup_steps,
            decay_steps=args.steps, clip_norm=args.clip_norm,
        )

        def from_schema(p):
            layers, rest = split_layer_params(p, cfg.encoder.num_layers)
            return {"layers": layers, "rest": rest}
    else:
        mesh, state, step_fn, place_batch = make_sharded_trainer(
            cfg, params, mesh, learning_rate=args.lr, loss=loss, sigma=args.sigma,
            remat=args.remat, accum_steps=args.accum_steps,
            compute_dtype="bfloat16" if args.bf16 else "float32",
            schedule=args.schedule, warmup_steps=args.warmup_steps,
            decay_steps=args.steps, clip_norm=args.clip_norm, device=device,
        )
    if args.resume:
        state = resume_state(args, mesh, state, from_schema, mp)
    params, opt_state, step = run_training(
        mesh, loader, state, step_fn, place_batch,
        steps=args.steps, log_every=args.log_every,
        checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every,
    )
    finish(args, cfg, params, opt_state, step)
    return 0


if __name__ == "__main__":
    sys.exit(main())
