"""Measure the error and the time of the f32 flash forward (B5 f32,
``csrc/flash_attention.cu`` ``fwd_f32_kernel``: three bf16 terms per f32
value, six products on ``wgmma``) against variants of its products, on the
card, at the trainer's attention shape (2, 24, 4608, 128).

Run on a machine with the card, from the repository root::

    python3 -m domainrag_tpu_torch.b5_f32_variants

Variants, each a copy of the source built in a ``tempfile.mkdtemp()``
directory (the repository is not touched):

- ``bf16x3``: the committed kernel (x = x0 + x1 + x2 in bf16, the six
  products whose term indices add to <= 2);
- ``bf16x2``: two terms, x0 y0 + x0 y1 + x1 y0 (three products; two K/V
  stages fit the shared memory);
- ``3xtf32``: every product as 3xTF32 on ``mma.sync`` m16n8k8 from f32
  tiles (``csrc/fwd_f32_tf32.cuh``, the f32 backward's route).

Each runs the forward through ``ops.attention._kernel_forward``, non-causal
and causal; out is held against the plain f32 version
(``flash_forward_reference``) under the card tests' bar (``F32_REL``:
relative Frobenius norm and F32_REL * max|ref| per element), lse within
``LSE_ATOL``, and each is timed in two rounds in turns.
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
LSE_ATOL = 1e-3
TERMS = "constexpr int F32_TERMS = 3;"
ROUTE = "// B5 f32: the split pass over q, k and v into `terms`, then the kernel."
CALL = ("return fwd_f32(q, k, v, out, lse, bh, s_q, s_kv, kv_valid, causal, "
        "terms,\n                   st);")


def variants(src: str) -> dict:
    out = {"bf16x3": src}
    for name, edits in (
            ("bf16x2", [(TERMS, "constexpr int F32_TERMS = 2;")]),
            ("3xtf32", [(ROUTE, '#include "fwd_f32_tf32.cuh"\n\n' + ROUTE),
                        (CALL, "return fwd_tf32(q, k, v, out, lse, bh, s_q, "
                               "s_kv, kv_valid, causal, st);")])):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not unique")
            text = text.replace(old, new)
        out[name] = text
    return out


def _errors(out, lse, want, want_lse):
    """(relative norm, max |err| / max |ref|, max |lse err|)."""
    err = (out - want).abs()
    return ((err.norm() / want.norm()).item(),
            (err.max() / want.abs().max()).item(),
            (lse - want_lse).abs().max().item())


def main() -> int:
    import torch
    from .ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip())
    tmp = Path(tempfile.mkdtemp(prefix="b5_f32_variants_"))
    try:
        for header in _build.CSRC.glob("*.cuh"):
            shutil.copy(header, tmp)
        srcs = variants((_build.CSRC / "flash_attention.cu").read_text())

        def build(name):
            (tmp / f"{name}.cu").write_text(srcs[name])
            lib = tmp / f"lib{name}.so"
            proc = subprocess.run([_build._nvcc(), *_build.FLAGS, "-o",
                                   str(lib), str(tmp / f"{name}.cu")],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {name}:\n{proc.stdout}"
                                   f"{proc.stderr}")
            for line in proc.stdout.splitlines():
                if "fwd_" in line or "spill" in line or "registers" in line:
                    print(f"  {name} ptxas: {line.strip()[:150]}")
            return name, ctypes.CDLL(str(lib))

        with ThreadPoolExecutor(len(srcs)) as pool:
            libs = dict(pool.map(build, srcs))
        g = torch.Generator(device="cuda")
        g.manual_seed(1)
        q, k, v = (torch.randn((2, 24, 4608, 128), generator=g,
                               device="cuda") for _ in range(3))
        want = {c: attn.flash_forward_reference(q, k, v, c)
                for c in (False, True)}
        times = {(n, c): [] for n in libs for c in (False, True)}
        for name in list(libs) + list(libs)[::-1]:
            attn._LIB = None
            _build._LOADED["flash_attention"] = libs[name]
            attn._lib()
            for causal in (False, True):
                out, lse = attn._kernel_forward(q, k, v, causal, None)
                torch.cuda.synchronize()
                rel, top, lse_err = _errors(out, lse, *want[causal])
                ok = rel < F32_REL and top <= F32_REL and lse_err < LSE_ATOL
                ev = [(torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
                      for _ in range(5)]
                for _ in range(2):
                    attn._kernel_forward(q, k, v, causal, None)
                for a, b in ev:
                    a.record()
                    attn._kernel_forward(q, k, v, causal, None)
                    b.record()
                torch.cuda.synchronize()
                t = statistics.median(a.elapsed_time(b) for a, b in ev)
                times[(name, causal)].append(t)
                print(f"{name} causal {causal}: {t:.3f} ms; against the "
                      f"plain f32 version rel_norm {rel:.3e}, "
                      f"max|err|/max|ref| {top:.3e}, lse {lse_err:.3e} "
                      f"({'within' if ok else 'OUTSIDE'} F32_REL {F32_REL})",
                      flush=True)
                del out, lse
        for (name, causal), t in times.items():
            print(f"B5 f32 2x24x4608x128 causal {causal} {name}: "
                  f"{t[0]:.3f} / {t[1]:.3f} ms")
    finally:
        attn._LIB = None
        _build._LOADED.pop("flash_attention", None)
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
