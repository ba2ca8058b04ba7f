"""Time the bf16 flash backward (B6, ``csrc/flash_attention.cu``) against
variants of its dq accumulation, on the card, at the trainer's attention
shape (2, 24, 4608, 128).

Run on a machine with the card, from the repository root::

    python3 -m domainrag_tpu_torch.b6_variants

The kernel stages each 64 x 64 dQ half in shared memory; its dQ writer
has the TMA unit add the tile into the f32 dq_accum in the kv block's
turn (ascending block order, the same bits every run). The variants, in
copies of the source built in a ``tempfile.mkdtemp()`` directory (the
repository is not touched): ``tma_unordered`` drops the turns, so the
writer adds each tile as soon as it is staged (in an order that varies
from run to run: the cost of the order); ``atomic_scalar`` and
``atomic_float2`` replace the staging and the writer by ``atomicAdd``
from registers. Each build runs the whole backward through
``launch_backward`` (dq_accum and turns zeroed, kernel, scale and cast),
two rounds in turns; dq is compared with the committed kernel's, which
must repeat itself bit for bit.
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

# the consumers' dQ staging, to the end of their loop over q tiles
STAGE_START = "      // stage this dQ half"
STAGE_END = "      if (leader) mbar_arrive(&dq_full[b]);\n    }\n"
# the dQ writer (the bf16 kernel's comes first in the source)
WRITER_START = "    } else if (threadIdx.x == 32 && n_it > 0) {\n"
WRITER_END = "        pass_turn(turn, blockIdx.x + 1);\n      }\n"
# the writer's turns
TURNS = ("        wait_turn(turn, blockIdx.x);\n",
         "        bulk_wait0();\n        pass_turn(turn, blockIdx.x + 1);\n")
SCALAR = """\
          atomicAdd(dst + 8 * j, dqa[4 * j + 2 * hr]);
          atomicAdd(dst + 8 * j + 1, dqa[4 * j + 2 * hr + 1]);
"""
FLOAT2 = """\
          atomicAdd(reinterpret_cast<float2*>(dst + 8 * j),
                    make_float2(dqa[4 * j + 2 * hr], dqa[4 * j + 2 * hr + 1]));
"""
LOOP = """\
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int q = q0 + 16 * warp + g + 8 * hr;
        if (q >= P.s_q) continue;
        float* dst = P.dq + ((long long)bh * P.s_q + q) * D + 64 * cw + 2 * tig;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
%s        }
      }
    }
"""
# the dq_accum pointer the atomic variants write through (the bf16
# kernel's struct and entry)
FIELD = ("  bf16* dk;  ", "  float* dq;\n  bf16* dk;  ")
HOST = ("  P.dk = static_cast<bf16*>(dk);",
        "  P.dq = static_cast<float*>(dq_accum);\n"
        "  P.dk = static_cast<bf16*>(dk);")


def _cut(src: str, start: str, end: str, body: str) -> str:
    """``src`` with the first ``start`` .. ``end`` (both included)
    replaced by ``body``."""
    a = src.index(start)
    b = src.index(end, a) + len(end)
    return src[:a] + body + src[b:]


def variants(src: str) -> dict:
    out = {"tma_ordered": src}
    v = src
    for old in TURNS:
        if v.index(old) > v.index(WRITER_END):
            raise RuntimeError(f"tma_unordered: {old!r} is not the bf16 "
                               "writer's")
        v = v.replace(old, "", 1)
    out["tma_unordered"] = v
    for name, body in (("atomic_scalar", SCALAR), ("atomic_float2", FLOAT2)):
        v = _cut(src, STAGE_START, STAGE_END, LOOP % body)
        v = _cut(v, WRITER_START, WRITER_END, "")
        for old, new in (FIELD, HOST):
            if v.count(old) != 1:
                raise RuntimeError(f"{name}: {old!r} is not unique")
            v = v.replace(old, new)
        out[name] = v
    return out


def main() -> int:
    import torch
    from .ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip())
    tmp = Path(tempfile.mkdtemp(prefix="b6_variants_"))
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
                                   device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        out, lse = attn.flash_forward_reference(q, k, v)
        buf = attn.backward_buffers(q, k, v, out, lse, do, False)
        times, ref = {n: [] for n in libs}, None
        for name in list(libs) + list(libs)[::-1]:
            attn._LIB = None
            _build._LOADED["flash_attention"] = libs[name]
            attn._lib()
            attn.launch_backward(buf)
            torch.cuda.synchronize()
            if ref is None:
                ref = buf.dq.float().clone()
            rel = ((buf.dq.float() - ref).norm() / ref.norm()).item()
            for _ in range(3):
                attn.launch_backward(buf)
            torch.cuda.synchronize()
            ev = [(torch.cuda.Event(enable_timing=True),
                   torch.cuda.Event(enable_timing=True)) for _ in range(20)]
            for a, b in ev:
                a.record()
                attn.launch_backward(buf)
                b.record()
            torch.cuda.synchronize()
            times[name].append(statistics.median(a.elapsed_time(b)
                                                 for a, b in ev))
            print(f"{name}: {times[name][-1]:.3f} ms (dq within {rel:.2e} "
                  f"of tma_ordered's)", flush=True)
            if name == "tma_ordered" and rel != 0.0:
                raise AssertionError("tma_ordered: dq does not repeat itself")
        for name, t in times.items():
            print(f"B6 bf16 2x24x4608x128 {name}: {t[0]:.3f} / {t[1]:.3f} ms")
    finally:
        attn._LIB = None
        _build._LOADED.pop("flash_attention", None)
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
