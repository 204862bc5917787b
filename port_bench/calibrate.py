"""Readings that the benchmark's fixed numbers were set from, taken on the
card. Not run by the benchmark's runs.

    python3 port_bench/calibrate.py shares --config <name> [--key <bias key>]
        For one configuration, the emitting share (weights.py: the share of
        frames set above the blank) of each key of its "emitting_share"
        (or of the one key given) that brings seed 1 nearest 3.5 tokens
        per audio second under the reference's own decode: 10 halvings of
        [0, 1] on the first 8 clips of the mix its "share_mix" names; then
        the density at that share on other seeds. Writes the shares into
        that configuration's file in this checkout, and no other.

    python3 port_bench/calibrate.py readings --workload <cell> --seeds a,b,... \
            [--control-seeds c,...] [--witness-seeds w,...]
        The compared numbers of sound program runs on each seed (a short
        window at the cell's own batches; the check as in a run), then of
        the control (the reference in the precision below the program's,
        put in the program's place) and of the bf16 witness (the reference
        with every weight product in bfloat16, a sound program's stand-in)
        on their seeds: a cell's limits lie above the program's and the
        witness's readings and below the control's.

Each reading is a JSON line on standard output and in
chiprun_out/calibrate_<what>.jsonl.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)

TARGET_TOKENS_PER_S = 3.5
SHARE_SEED = 1
CHECK_SEEDS = (1, 2, 3, 3000000001, 3000000002)  # the chosen share's density is read on each


def emit(out, line: dict) -> None:
    text = json.dumps(line)
    print(text, flush=True)
    out.write(text + "\n")
    out.flush()


def bisect_share(count, target: float):
    """The share in [0, 1] whose count came nearest the target after 10
    halvings (the count rises with the share), and every share tried."""
    lo, hi, tried = 0.0, 1.0, {}
    for _ in range(10):
        mid = (lo + hi) / 2
        tried[mid] = count(mid)
        lo, hi = (lo, mid) if tried[mid] > target else (mid, hi)
    best = min(tried, key=lambda m: abs(tried[m] - target))
    return best, tried


def shares(out, config: str, only_key: str | None) -> None:
    import torch

    from parakeet_tpu_torch import config as C
    from parakeet_tpu_torch import params as P
    from parakeet_tpu_torch import transcribe as T
    from port_bench import harness, traffic as TR, weights as W
    from port_bench.drivers.offline import MARGIN_CLIPS, emission_margins
    from port_bench.reference import torch_ref as R

    reg = harness.Registry(ROOT)
    entry = next(c for c in reg.bench["configs"] if c["name"] == config)
    path = ROOT / entry["file"]
    conf = json.loads(path.read_text())
    mix = json.loads((ROOT / "port_bench/traffic" / f"{conf['assumed']['share_mix']}.json").read_text())
    cfg = getattr(C, conf["preset"])()
    spec = getattr(P, conf["spec"])(cfg)
    blank = cfg.joint.vocab_size - 1
    prefix = getattr(T, conf["facade"]).joint_prefix
    dtype = getattr(torch, conf["compute_dtype"])
    keys = [only_key] if only_key else list(conf["assumed"]["emitting_share"])
    seeds = {}
    for seed in CHECK_SEEDS:
        params = {k: v.float() for k, v in W.make_weights(spec, seed, "cuda", dtype, blank, conf["assumed"]).items()}
        pool = TR.make_pool(mix, seed, "cuda")
        clips = [pool[c] for c in TR.batches(mix, seed)[0][:MARGIN_CLIPS]]
        margins, encs = emission_margins(conf, params, clips, blank, prefix, "cuda", keys)
        seeds[seed] = (params, margins, encs, sum(len(c) for c in clips) / TR.SAMPLE_RATE)

    def count(seed, key, share):
        """Tokens the reference's decode emits on the seed's clips with
        the offset of `share` (rounded to the served dtype, as served)."""
        params, margins, encs, _ = seeds[seed]
        offset = W.blank_offsets(margins, {key: share})[key]
        p = dict(params, **{key: params[key].clone()})
        p[key][blank] += torch.tensor(offset).to(dtype).float()
        with torch.no_grad():
            if not key.startswith(prefix):
                n = 0
                for e in encs:
                    b = R.ctc_log_probs(p, e[None])[0].argmax(-1).tolist()
                    n += sum(1 for i, x in enumerate(b) if x != blank and (i == 0 or b[i - 1] != x))
                return n
            return sum(len(R.greedy_tdt(p, e, durations=conf["config"]["durations"], blank_id=blank,
                                        joint_prefix=prefix)) for e in encs)

    for key in keys:
        t0 = time.perf_counter()
        audio_s = seeds[SHARE_SEED][3]
        best, tried = bisect_share(lambda sh: count(SHARE_SEED, key, sh), TARGET_TOKENS_PER_S * audio_s)
        rates = {s: count(s, key, best) / seeds[s][3] for s in seeds}
        conf["assumed"]["emitting_share"][key] = best
        emit(out, {"config": conf["name"], "key": key, "share": best, "tokens_per_s_by_seed": rates,
                   "audio_s": audio_s, "tried": tried, "seconds": time.perf_counter() - t0})
    path.write_text(json.dumps(conf, indent=1, ensure_ascii=False) + "\n")


def readings(out, workload: str, seeds: list[int], control_seeds: list[int], witness_seeds: list[int]) -> None:
    import torch

    from port_bench import harness

    reg = harness.Registry(ROOT)
    cell = reg.cell(workload)
    for system, group in (("program", seeds), ("control", control_seeds), ("witness", witness_seeds)):
        for seed in group:
            t0 = time.perf_counter()
            drv = reg.driver(cell.traffic["kind"]).Driver(cell, seed, "cuda", system=system, log=harness.log)
            drv.setup()
            calls, _, _ = drv.window(0.0, min_calls=len(drv.batches))
            toks = drv.tokens_per_audio_s(calls)
            drv.release()
            numbers = drv.check(calls)
            emit(out, {"workload": workload, "system": system, "seed": seed, "numbers": numbers,
                       "tokens_per_s": toks, "seconds": time.perf_counter() - t0})
            del drv
            torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("shares", "readings"))
    ap.add_argument("--config")
    ap.add_argument("--key")
    ap.add_argument("--workload")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness-seeds", default="")
    args = ap.parse_args()
    outdir = ROOT / "chiprun_out"
    outdir.mkdir(exist_ok=True)
    name = f"shares_{args.config}" if args.what == "shares" else f"readings_{args.workload}"
    with open(outdir / f"calibrate_{name}.jsonl", "a") as out:
        if args.what == "shares":
            shares(out, args.config, args.key)
        else:
            ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
            readings(out, args.workload, ints(args.seeds), ints(args.control_seeds), ints(args.witness_seeds))
    return 0


if __name__ == "__main__":
    sys.exit(main())
