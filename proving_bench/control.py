#!/usr/bin/env python3
"""The control of a cell's comparison, on the card at the cell's own size.

    python3 proving_bench/control.py --workload v1-fib-2e22 --seeds 11 12 13

For each seed: one prove of the seed's first window input by one warmed-up
prover, then the comparison of its proof with the reference of the cell's
protocol (the sound reading) and of that reference's control in the
program's place (`control` of `reference/v<protocol_version>.py`: the proof
with the reference's own shortcut). Prints one JSON line a seed with both
readings. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from benchlib import cell, judge, window

    c = cell.load(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    c.mix = dict(c.mix, check_sample=1)
    for seed in args.seeds:
        run = window.run_cell(c, seed, 0.0, False, "cuda")  # warm-up, then one prove
        inputs = {p.i: p.n for p in run.proves}
        common = (c.reference, run.kept, inputs, c.guest, 1 << c.mix["log2_trace"], c.config, "cuda")
        sound, _ = judge.judge(*common)
        control, _ = judge.judge(*common, control=True)
        print(json.dumps({"workload": c.name, "seed": seed, "n": list(inputs.values()),
                          "errors": [p.error for p in run.proves if p.error], "sound": sound,
                          "control": control}), flush=True)
        del run
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
