"""The controls of a cell's comparison, read at the cell's own size, seed
after seed in one process; each seed prints one JSON line. The benchmark's
own runs never run this.

By default each seed runs the program as the cell runs it and prints its
numbers (the lower readings) beside the controls' (the family's
``control``): the reference put in the program's place one precision
below the configuration's, against the float32 reference (for FLUX: the
prior in TF32; the encode with float8 operands; the MMDiT with float8
operands, or int4 under the mode ``w8a8``; the Euler update in
bfloat16). With ``--int8`` it runs the program's own int8 path in its
place: the serving modes ``w8a8``, ``int8_qk`` and ``int8_pv`` (int8
weights, activations and both attention products in place of bfloat16)
in place of the traffic's, and prints that path's numbers. A window long
enough to reach the sampled step will do.

    python -m gpubench.control --workload flux-dev.gen1024 \\
        --seconds 32 --seeds 101 102 103
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from . import run

INT8 = ["w8a8", "int8_qk", "int8_pv"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--int8", action="store_true",
                   help="run the program's int8 path in its place")
    args = p.parse_args(argv)
    run._environment()
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    from .harness import Cell
    cell = Cell.load(bench, args.workload)
    if args.int8:
        cell.traffic = dict(cell.traffic, modes=INT8)
    for seed in args.seeds:
        fields, numbers = run.measure(cell, seed, args.seconds, trace=False,
                                      controls=not args.int8)
        line = {"workload": cell.name, "seed": seed,
                "int8_program" if args.int8 else "program": numbers}
        if not args.int8:
            line["control"] = fields["control"]
        line["limits"] = cell.spec["limits"]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
