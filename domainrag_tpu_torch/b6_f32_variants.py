"""Measure the error and the time of the f32 flash backward (B6 f32,
``csrc/flash_attention.cu`` ``bwd_f32_kernel``, every product as 3xTF32)
against variants of its product, on the card, at the trainer's attention
shape (2, 24, 4608, 128).

Run on a machine with the card, from the repository root::

    python3 -m domainrag_tpu_torch.b6_f32_variants

Variants, each a copy of the source built in a ``tempfile.mkdtemp()``
directory (the repository is not touched):

- ``3xtf32``: the committed kernel (a_lo b_hi + a_hi b_lo + a_hi b_hi, hi
  rounded to TF32);
- ``3xtf32_trunc``: hi truncated to TF32 instead of rounded;
- ``3xtf32_cvt``: hi rounded by ``cvt.rna.tf32.f32`` (to nearest, ties
  away) instead of the integer add and mask;
- ``1xtf32``: the two small products dropped (plain TF32).

Each runs the whole backward through ``launch_backward``; dq, dk and dv
are held against the plain f32 version (``flash_backward_reference``)
under the card tests' bar (``F32_REL``: relative Frobenius norm and
F32_REL * max|ref| per element), and timed in two rounds in turns.
"""

from __future__ import annotations

import ctypes
import shutil
import statistics
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

from .ops import attention as attn

F32_REL = 1e-5            # tests/test_torch_cuda.py and chip_smoke.py
ROUND = "  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;"
SMALL = ("  mma_tf32(d, al, bh[0], bh[1]);\n"
         "  mma_tf32(d, ah, bl[0], bl[1]);\n")


def variants(src: str) -> dict:
    out = {"3xtf32": src}
    for name, old, new in (
            ("3xtf32_trunc", ROUND,
             "  hi = __float_as_uint(x) & 0xffffe000u;"),
            ("3xtf32_cvt", ROUND,
             '  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));'),
            ("1xtf32", SMALL, "")):
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: {old!r} is not unique")
        out[name] = src.replace(old, new)
    return out


def _errors(got, want):
    """(relative norm, max |err| / max |ref|) of each of dq, dk, dv."""
    out = []
    for a, b in zip(got, want):
        err = (a.float() - b.float()).abs()
        out.append(((err.norm() / b.float().norm()).item(),
                    (err.max() / b.float().abs().max()).item()))
    return out


def main() -> int:
    import torch
    from .ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip())
    tmp = Path(tempfile.mkdtemp(prefix="b6_f32_variants_"))
    try:
        for header in _build.CSRC.glob("*.cuh"):
            shutil.copy(header, tmp)
        srcs = variants((_build.CSRC / "flash_attention.cu").read_text())

        def build(name):
            (tmp / f"{name}.cu").write_text(srcs[name])
            lib = tmp / f"lib{name}.so"
            subprocess.run([_build._nvcc(), *_build.FLAGS, "-o", str(lib),
                            str(tmp / f"{name}.cu")], check=True,
                           capture_output=True)
            return name, ctypes.CDLL(str(lib))

        with ThreadPoolExecutor(len(srcs)) as pool:
            libs = dict(pool.map(build, srcs))
        g = torch.Generator(device="cuda")
        g.manual_seed(1)
        q, k, v, do = (torch.randn((2, 24, 4608, 128), generator=g,
                                   device="cuda") for _ in range(4))
        out, lse = attn.flash_forward_reference(q, k, v)
        want = attn.flash_backward_reference(q, k, v, out, lse, do)
        buf = attn.backward_buffers(q, k, v, out, lse, do, False)
        shape = q.shape
        times = {n: [] for n in libs}
        for name in list(libs) + list(libs)[::-1]:
            attn._LIB = None
            _build._LOADED["flash_attention"] = libs[name]
            attn._lib()
            attn.launch_backward(buf)
            torch.cuda.synchronize()
            errs = _errors((buf.dq.reshape(shape), buf.dk.reshape(shape),
                            buf.dv.reshape(shape)), want)
            ok = all(r < F32_REL and m <= F32_REL for r, m in errs)
            for _ in range(2):
                attn.launch_backward(buf)
            torch.cuda.synchronize()
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(5)]
            for a, b in ev:
                a.record()
                attn.launch_backward(buf)
                b.record()
            torch.cuda.synchronize()
            times[name].append(statistics.median(a.elapsed_time(b)
                                                 for a, b in ev))
            print(f"{name}: {times[name][-1]:.3f} ms; against the plain f32 "
                  "version dq / dk / dv rel_norm "
                  + " / ".join(f"{r:.3e}" for r, _ in errs)
                  + ", max|err|/max|ref| "
                  + " / ".join(f"{m:.3e}" for _, m in errs)
                  + f" ({'within' if ok else 'OUTSIDE'} F32_REL {F32_REL})",
                  flush=True)
        for name, t in times.items():
            print(f"B6 f32 2x24x4608x128 {name}: {t[0]:.3f} / {t[1]:.3f} ms")
    finally:
        attn._LIB = None
        _build._LOADED.pop("flash_attention", None)
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
