"""Offline checkpoint quantizer: safetensors → int8/int4 safetensors (port
of parakeet_tpu/tools/quantize_ckpt.py, same arguments, messages and
output bytes).

    python -m parakeet_tpu_torch.tools.quantize_ckpt model.safetensors model.int4.safetensors --mode int4

Every loader of the port (`Transcriber(path)`, `load_params_numpy`)
dequantises such a file on load; `Transcriber(..., quantize=...)` keeps the
codes for runtime.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Quantize a parakeet safetensors checkpoint (weights only)")
    ap.add_argument("input", help="source .safetensors (f32/bf16 weights)")
    ap.add_argument("output", help="quantized .safetensors to write")
    ap.add_argument("--mode", default="int8", choices=["int8", "int4"])
    ap.add_argument("--group-size", type=int, default=64,
                    help="int4 inputs sharing one scale (clamped per-tensor "
                         "to a divisor of the in-dim)")
    ap.add_argument("--min-elems", type=int, default=4096,
                    help="skip matrices smaller than this many elements")
    ap.add_argument("--include", default=None, metavar="REGEX",
                    help="only quantize keys matching this regex")
    args = ap.parse_args(argv)
    if args.group_size < 1:
        ap.error("--group-size must be >= 1")
    if args.min_elems < 0:
        ap.error("--min-elems must be >= 0")

    import numpy as np

    from parakeet_tpu_torch.io.safetensors import load_safetensors, save_safetensors
    from parakeet_tpu_torch.quantize import quantize_params, quantized_fraction

    weights = load_safetensors(args.input)
    if any(v.dtype in (np.int8, np.uint8) for v in weights.values()):
        print("Error: input is already quantized", file=sys.stderr)
        return 1
    q = quantize_params(weights, mode=args.mode, min_elems=args.min_elems,
                        include=args.include, group_size=args.group_size)
    save_safetensors({k: np.asarray(v) for k, v in q.items()}, args.output)

    frac = quantized_fraction(q)
    in_b, out_b = os.path.getsize(args.input), os.path.getsize(args.output)
    print(f"{args.output}: {args.mode}, {frac:.1%} of elements quantized, "
          f"{in_b / 1e6:.1f} MB -> {out_b / 1e6:.1f} MB "
          f"({out_b / in_b:.2f}x)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
