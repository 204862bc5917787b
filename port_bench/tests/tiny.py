"""A tiny cell in a scratch checkout, for the CPU tests: the real drivers
and metric readers (linked), a tdt-ctc configuration at toy widths, a mix
of short clips in batches of 2, and any limits."""

from __future__ import annotations

import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
CELL = "tiny.cell"


def tiny_config(dtype: str = "bfloat16") -> dict:
    conf = json.loads((REPO / "port_bench/configs/tdt-ctc-110m.json").read_text())
    conf.update(name="tiny", preset=None, compute_dtype=dtype)
    c = conf["config"]
    c["encoder"].update(hidden_size=64, num_layers=2, num_heads=4, ffn_intermediate=128, subsampling_channels=16)
    c["prediction"].update(vocab_size=33, pred_hidden=32)
    c["joint"].update(encoder_hidden=64, pred_hidden=32, joint_hidden=32, vocab_size=33)
    c["ctc_vocab_size"] = 33
    conf["assumed"]["emitting_share"] = {"tdt_joint_.label_proj_.bias": 0.3, "ctc_decoder_.proj_.bias": 0.3}
    return conf


def tiny_root(root: Path, *, decoder: str = "tdt", timestamps: bool = True, limits: dict | None = None,
              dtype: str = "bfloat16") -> Path:
    bench_dir = root / "port_bench"
    for d in ("configs", "traffic", "limits"):
        (bench_dir / d).mkdir(parents=True, exist_ok=True)
    for d in ("drivers", "metrics"):
        if not (bench_dir / d).exists():
            (bench_dir / d).symlink_to(REPO / "port_bench" / d)
    (bench_dir / "configs/tiny.json").write_text(json.dumps(tiny_config(dtype)))
    mix = {"kind": "offline", "batch": 2, "pool": 4,
           "lengths": {"median_s": 1.5, "sigma": 0.5, "min_s": 0.8, "max_s": 3.0},
           "decoder": decoder, "timestamps": timestamps}
    (bench_dir / "traffic/tiny_mix.json").write_text(json.dumps(mix))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"] = [{"name": "tiny", "source": "toy widths", "file": "port_bench/configs/tiny.json",
                         "reduced": [], "why": "CPU tests"}]
    bench["workloads"] = [{"name": CELL, "config": "tiny", "traffic": "tiny_mix", "chips": 1, "why": "CPU tests"}]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    if limits is not None:
        (bench_dir / f"limits/{CELL}.json").write_text(json.dumps(limits))
    return root
