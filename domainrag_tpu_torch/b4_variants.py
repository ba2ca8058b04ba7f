"""Measure the W8A8 GEMM (B4, ``csrc/int8_gemm.cu``, the ``wgmma``
instance) against variants of its epilogue and ring, on the card, at the
large shapes of the int8 serving paths.

Run on a machine with the card, from the repository root::

    python3 -m domainrag_tpu_torch.b4_variants

Variants, each a copy of the source built in a ``tempfile.mkdtemp()``
directory (the repository is not touched):

- ``committed``: the bf16 epilogue staged in shared memory a 64 x 128 half
  at a time and stored by the TMA unit, the tile's w_s, bias and x_s read
  before its mainloop, a 4-stage ring;
- ``registers_epilogue``: every bf16 output stored from registers, 16
  bytes per row per warp, with w_s and the bias read from global memory
  in the epilogue (the path f32 output takes);
- ``stages3``: a 3-stage ring;
- ``no_epilogue``: the mainloop alone (nothing stored: a bound on what
  the epilogue costs, not a kernel; its output is not checked).

Each is held ``torch.equal`` to the plain version (``w8a8_reference``)
and timed in two rounds in turns at each shape.
"""

from __future__ import annotations

import ctypes
import math
import shutil
import statistics
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from .ops import int8_gemm as ig

# (M, K, N): linear1 and linear2 of the single blocks at 1024 px, the
# image stream's qkv, and the fill's mlp up-projection at 2048 px
SHAPES = ((5337, 3072, 21504), (5337, 15360, 3072), (4096, 3072, 9216),
          (16384, 3072, 12288))
STORE = ("      store_half(P, acc0, sx, m0, n0, 0, cw, warp, g, tig, issuer, "
         "sw, sb,\n                 stg);\n"
         "      store_half(P, acc1, sx, m0, n0, 128, cw, warp, g, tig, "
         "issuer, sw, sb,\n                 stg);")
SINK = ("      if (acc0[0] == 123456789 && acc1[5] == 7)\n"
        "        static_cast<float*>(P.out)[n0 + tig] = sx[0];")


def variants(src: str) -> dict:
    out = {"committed": src}
    for name, old, new in (
            ("registers_epilogue",
             "const bool tma_out = !F32OUT && n % 8 == 0 &&",
             "const bool tma_out = false && n % 8 == 0 &&"),
            ("stages3", "constexpr int WG_STAGES = 4;",
             "constexpr int WG_STAGES = 3;"),
            ("no_epilogue", STORE, SINK)):
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not unique")
        out[name] = src.replace(old, new)
    return out


def main() -> int:
    import torch
    from .ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip())
    tmp = Path(tempfile.mkdtemp(prefix="b4_variants_"))
    try:
        for header in _build.CSRC.glob("*.cuh"):
            shutil.copy(header, tmp)
        srcs = variants((_build.CSRC / "int8_gemm.cu").read_text())

        def build(name):
            (tmp / f"{name}.cu").write_text(srcs[name])
            lib = tmp / f"lib{name}.so"
            proc = subprocess.run([_build._nvcc(), *_build.FLAGS, "-o",
                                   str(lib), str(tmp / f"{name}.cu")],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}"
                                   f"{proc.stderr}")
            return name, ctypes.CDLL(str(lib))

        with ThreadPoolExecutor(len(srcs)) as pool:
            libs = dict(pool.map(build, srcs))
        g = torch.Generator(device="cuda")
        g.manual_seed(3)
        for m, k, n in SHAPES:
            x = torch.randn((m, k), generator=g, device="cuda").to(
                torch.bfloat16)
            wq = torch.randint(-127, 128, (n, k), generator=g,
                               device="cuda", dtype=torch.int8)
            ws = torch.rand(n, generator=g, device="cuda") / (
                127 * math.sqrt(k))
            b = torch.randn(n, generator=g, device="cuda").to(torch.bfloat16)
            xq, xs = ig.quantize_rowwise(x)
            want = ig.w8a8_reference(xq, wq, xs, ws, b, torch.bfloat16)
            times = {name: [] for name in libs}
            for name in list(libs) + list(libs)[::-1]:
                ig._LIB = None
                _build._LOADED["int8_gemm"] = libs[name]
                ig._lib()

                def run():
                    return ig._launch(xq, wq, xs, ws, b, torch.bfloat16)[0]
                equal = torch.equal(run(), want)
                for _ in range(3):
                    run()
                ev = [(torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
                      for _ in range(20)]
                for a, e in ev:
                    a.record()
                    run()
                    e.record()
                torch.cuda.synchronize()
                times[name].append(statistics.median(
                    a.elapsed_time(e) for a, e in ev))
                if name != "no_epilogue" and not equal:
                    raise AssertionError(f"{name} at {(m, k, n)} differs "
                                         f"from the plain version")
            ops = 2.0 * m * k * n
            print(f"B4 {(m, k, n)}: " + "; ".join(
                f"{name} {t[0]:.4f} / {t[1]:.4f} ms "
                f"({ops / statistics.mean(t) / 1e9:.0f} TOP/s)"
                for name, t in times.items()), flush=True)
            del x, wq, xq, want
            torch.cuda.empty_cache()
    finally:
        ig._LIB = None
        _build._LOADED.pop("int8_gemm", None)
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
