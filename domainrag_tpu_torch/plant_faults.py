"""Plant faults in the fused top-k kernel (B8, ``csrc/topk.cu``) and check
that the card tests and ``chip_smoke.py`` both catch each one.

Run on a machine with the card, from the repository root::

    python3 -m domainrag_tpu_torch.plant_faults [fault ...]

For each fault (all by default) the repository is copied into a new
temporary directory (``tempfile.mkdtemp``, which honours ``TMPDIR``), one
line of the copy's ``csrc/topk.cu`` is replaced, and the B8 card tests
(``tests/test_torch_cuda.py -k "topk or first_stage"``) and the whole
``chip_smoke.py`` run in the copy. A fault is caught when both exit
non-zero. The temporary directory is deleted afterwards; the repository
is not touched.
Exits 1 if any fault went uncaught.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = "domainrag_tpu_torch/csrc/topk.cu"
FAULTS = {
    # the ragged last bank tile of each split is never scored
    "ragged_tile_dropped": (
        "const int ntiles = (n_end - nb + TN - 1) / TN;",
        "const int ntiles = (n_end - nb) / TN;"),
    # equal scores ordered by index descending
    "ties_index_descending": (
        "return sa > sb || (sa == sb && ia < ib);",
        "return sa > sb || (sa == sb && ia > ib);"),
    # both operands rounded to TF32 (10-bit mantissa) before the FMA
    "tf32_operands": (
        "acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);",
        "acc[i][j] = fmaf(__uint_as_float((__float_as_uint(av[i]) + 0x1000u)"
        " & 0xffffe000u), __uint_as_float((__float_as_uint(bv[j]) + 0x1000u)"
        " & 0xffffe000u), acc[i][j]);"),
}


def run(name: str) -> bool:
    old, new = FAULTS[name]
    tmp = Path(tempfile.mkdtemp(prefix=f"b8_fault_{name}_"))
    copy = tmp / "repo"
    shutil.copytree(ROOT, copy, ignore=shutil.ignore_patterns(
        "build", "chiprun_out", ".git", "__pycache__", "local"))
    try:
        text = (copy / SRC).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the line to replace is not unique")
        (copy / SRC).write_text(text.replace(old, new))
        t0 = time.perf_counter()
        tests = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m",
             "cuda", "-p", "no:cacheprovider", "tests/test_torch_cuda.py",
             "-k", "topk or first_stage"], cwd=copy, capture_output=True,
            text=True, timeout=900)
        smoke = subprocess.run([sys.executable, "chip_smoke.py"], cwd=copy,
                               capture_output=True, text=True, timeout=1500)
        summary = (tests.stdout.strip().splitlines() or [""])[-1]
        errors = [line for line in smoke.stderr.splitlines()
                  if "Error" in line][-1:]
        caught = tests.returncode != 0 and smoke.returncode != 0
        print(f"fault {name}: card tests rc {tests.returncode} ({summary}); "
              f"chip_smoke.py rc {smoke.returncode} {errors}; "
              f"{'caught' if caught else 'NOT CAUGHT'} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
        return caught
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main() -> int:
    names = sys.argv[1:] or list(FAULTS)
    unknown = [n for n in names if n not in FAULTS]
    if unknown:
        print(f"unknown faults {unknown}; known: {list(FAULTS)}",
              file=sys.stderr)
        return 2
    results = [run(name) for name in names]
    return 0 if all(results) else 1


if __name__ == "__main__":
    sys.exit(main())
