"""Plant faults in the hand-written kernels, the fused top-k (B8,
``csrc/topk.cu``), the int8 MMDiT attention (B7,
``csrc/int8_attention.cu``), the bf16 and f32 flash backward (B6,
``csrc/flash_attention.cu``) and the front-ends of the shared bf16
forward (``csrc/flash_fwd.cuh``): the fused MMDiT attention behind B1-B3
(``csrc/mmdit_attention.cu``) and the generic forward B5
(``csrc/flash_attention.cu``), and check that the card tests and
``chip_smoke.py`` both catch each one.

Run on a machine with the card, from the repository root::

    python3 -m domainrag_tpu_torch.plant_faults [fault ...]

For each fault (all by default) the repository is copied into a new
temporary directory (``tempfile.mkdtemp``, which honours ``TMPDIR``), one
line of the copy's kernel source is replaced, and the kernel's card tests
(``tests/test_torch_cuda.py -k "topk or first_stage"`` for B8, ``-k i8``
for B7, ``-k flash`` for B6, ``-k "kernel or flash"`` for the forward)
and the whole ``chip_smoke.py`` run in the copy. A fault is
caught when both exit non-zero. The temporary directory is deleted
afterwards; the repository is not touched.
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
B8 = ("domainrag_tpu_torch/csrc/topk.cu", "topk or first_stage")
B7 = ("domainrag_tpu_torch/csrc/int8_attention.cu", "i8")
B6 = ("domainrag_tpu_torch/csrc/flash_attention.cu", "flash")
FWD_MMDIT = ("domainrag_tpu_torch/csrc/mmdit_attention.cu", "kernel or flash")
FWD_B5 = ("domainrag_tpu_torch/csrc/flash_attention.cu", "kernel or flash")
# name: ((source, card tests' -k), line as it is, line with the fault)
FAULTS = {
    # B8: the ragged last bank tile of each split is never scored
    "ragged_tile_dropped": (
        B8, "const int ntiles = (n_end - nb + TN - 1) / TN;",
        "const int ntiles = (n_end - nb) / TN;"),
    # B8: equal scores ordered by index descending
    "ties_index_descending": (
        B8, "return sa > sb || (sa == sb && ia < ib);",
        "return sa > sb || (sa == sb && ia > ib);"),
    # B8: both operands rounded to TF32 (10-bit mantissa) before the FMA
    "tf32_operands": (
        B8, "                                          float4 (&b)[N]) {",
        "                                          float4 (&b)[N]) {\n"
        "  auto t = [](float x) { return __uint_as_float("
        "(__float_as_uint(x) + 0x1000u) & 0xffffe000u); };\n"
        "  for (float4& v : a) v = make_float4(t(v.x), t(v.y), t(v.z), "
        "t(v.w));\n"
        "  for (float4& v : b) v = make_float4(t(v.x), t(v.y), t(v.z), "
        "t(v.w));"),
    # B8: a buffer merged without its last slot (the last candidate
    # appended before the merge is lost)
    "flush_drops_last_slot": (
        B8, "const int held = cnt[r];", "const int held = cnt[r] - 1;"),
    # B7: V8^T's keys permuted off by one pair within each 32-key group
    "v8t_permutation_off_by_a_pair": (
        B7, "return 16 * ((c >> 4) & 1) + 4 * ((c >> 1) & 3) + "
            "2 * ((c >> 3) & 1) +",
        "return 16 * ((c >> 4) & 1) + 4 * (((c >> 1) + 1) & 3) + "
        "2 * ((c >> 3) & 1) +"),
    # B7: the last ragged key tile (and the gap) left unmasked
    "ragged_key_tile_unmasked": (
        B7, "*nv = max(0, min(BN, n));", "*nv = BN;"),
    # B7: sweep A's integer max taken per tile instead of per window
    "sweep_a_max_per_tile": (
        B7, "if (t == w0) {", "if (true) {"),
    # B6: delta read from another q row of the tile (8 columns over)
    "delta_wrong_q_row": (
        B6, "const float2 dl = *reinterpret_cast<const float2*>(td + c);",
        "const float2 dl = *reinterpret_cast<const float2*>(td + (c ^ 8));"),
    # B6: the causal mask's comparison flipped at the diagonal
    "causal_diagonal_masked": (
        B6, "(P.causal && kr > qc)", "(P.causal && kr >= qc)"),
    # B6: kv rows of blocks that no q reaches left unwritten, not zero
    "unreached_kv_rows_unwritten": (
        B6, "if (kr >= P.s_kv) continue;",
        "if (kr >= P.s_kv || n_it == 0) continue;"),
    # B6 f32: the lo terms dropped, so every product is one TF32 product
    "tf32_lo_dropped": (
        B6, "lo = __float_as_uint(x - __uint_as_float(hi));", "lo = 0u;"),
    # B6 f32: the causal mask's comparison flipped at the diagonal
    "causal_diagonal_masked_f32": (
        B6, "(P.causal && qc < kr)", "(P.causal && qc <= kr)"),
    # B1-B3: the keys in the gap after stream a (zero rows) left unmasked
    "gap_keys_unmasked": (
        FWD_MMDIT, "const int n = key0 < b0 ? s_a - key0 : b0 + s_b - key0;",
        "const int n = key0 < b0 ? b0 - key0 : b0 + s_b - key0;"),
    # B5: causal blocks stop one kv tile short of the last they reach
    "causal_stop_one_tile_short": (
        FWD_B5, "if (causal) n = min(n, (min(q0_ + fwd::BM, s_q) - 1) / "
                "fwd::BN + 1);",
        "if (causal) n = min(n, (min(q0_ + fwd::BM, s_q) - 1) / fwd::BN);"),
    # B5: lse written in the exp2 domain, without the ln2 factor
    "lse_without_ln2": (
        FWD_B5, "if (tig == 0) lse[row] = m * LN_2 + logf(l);",
        "if (tig == 0) lse[row] = m + logf(l);"),
}


def run(name: str) -> bool:
    (src, tests_k), old, new = FAULTS[name]
    tmp = Path(tempfile.mkdtemp(prefix=f"fault_{name}_"))
    copy = tmp / "repo"
    shutil.copytree(ROOT, copy, ignore=shutil.ignore_patterns(
        "build", "chiprun_out", ".git", "__pycache__", "local"))
    try:
        text = (copy / src).read_text()
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the line to replace is not unique")
        (copy / src).write_text(text.replace(old, new))
        t0 = time.perf_counter()
        tests = subprocess.run(
            [sys.executable, "-m", "pytest", "--noconftest", "-q", "-m",
             "cuda", "-p", "no:cacheprovider", "tests/test_torch_cuda.py",
             "-k", tests_k], cwd=copy, capture_output=True,
            text=True, timeout=900)
        smoke = subprocess.run([sys.executable, "chip_smoke.py"], cwd=copy,
                               capture_output=True, text=True, timeout=1500)
        summary = (tests.stdout.strip().splitlines() or [""])[-1]
        # the card test cases that failed, without the file and the reason
        failed = [line.split("::", 1)[-1].split(" - ")[0]
                  for line in tests.stdout.splitlines()
                  if line.startswith("FAILED ")]
        errors = [line for line in smoke.stderr.splitlines()
                  if "Error" in line][-1:]
        # the last kernel check chip_smoke.py printed: the one that failed
        checked = [line for line in smoke.stdout.splitlines()
                   if line.startswith("kernel ")][-1:]
        caught = tests.returncode != 0 and smoke.returncode != 0
        print(f"fault {name}: card tests rc {tests.returncode} ({summary}); "
              f"chip_smoke.py rc {smoke.returncode} {errors} {checked}; "
              f"{'caught' if caught else 'NOT CAUGHT'} "
              f"({time.perf_counter() - t0:.0f} s); failed card tests "
              f"{failed}", flush=True)
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
