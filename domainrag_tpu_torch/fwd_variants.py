"""Time the shared bf16 attention forward (``csrc/flash_fwd.cuh``: B1-B3
through ``csrc/mmdit_attention.cu``, B5 through ``csrc/flash_attention.cu``)
against a variant with a third K/V stage in its TMA ring (224 KB of
shared memory instead of 160 KB), on the card.

Run on a machine with the card, from the repository root::

    python3 -m domainrag_tpu_torch.fwd_variants

The variant is built from a copy of ``csrc/`` in a ``tempfile.mkdtemp()``
directory with ``STAGES`` set to 3; the repository is not touched. Each
build runs, through the wrappers, the joint MMDiT attention at 1241 + 4096
tokens (B1), the single block's at 1241 + 16384 (B3), and B5 at (2, 24,
4608, 128), in turns: committed, variant, variant, committed. Outputs are
compared with the committed build's.
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
from .ops import mmdit_attention as mma

STAGES = ("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")
SOURCES = ("flash_attention", "mmdit_attention")


def _ms(fn, reps=10):
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in ev:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


def _use(libs):
    """Route both wrappers to ``libs`` (name -> CDLL)."""
    from .ops import _build
    for mod, name in ((attn, "flash_attention"), (mma, "mmdit_attention")):
        mod._LIB = None
        _build._LOADED[name] = libs[name]
        mod._lib()


def main() -> int:
    import torch
    from .ops import _build
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip())
    tmp = Path(tempfile.mkdtemp(prefix="fwd_variants_"))
    try:
        for f in _build.CSRC.iterdir():
            shutil.copy(f, tmp)
        header = (tmp / "flash_fwd.cuh").read_text()
        if header.count(STAGES[0]) != 1:
            raise RuntimeError("the stage count is not where expected")
        (tmp / "flash_fwd.cuh").write_text(header.replace(*STAGES))

        def build(name):
            lib = tmp / f"lib{name}.so"
            subprocess.run([_build._nvcc(), *_build.FLAGS, "-o", str(lib),
                            str(tmp / f"{name}.cu")], check=True,
                           capture_output=True)
            return name, ctypes.CDLL(str(lib))

        with ThreadPoolExecutor(len(SOURCES)) as pool:
            variant = dict(pool.map(build, SOURCES))
            committed = dict(pool.map(lambda n: (n, _build.load(n)),
                                      SOURCES))
        builds = {"2 stages": committed, "3 stages": variant}

        g = torch.Generator(device="cuda")
        g.manual_seed(3)

        def randn(*shape):
            return torch.randn(shape, generator=g, device="cuda").to(
                torch.bfloat16)

        heads, s_txt = 24, 1241
        norm = {"q": {"scale": torch.ones(128, device="cuda")},
                "k": {"scale": torch.ones(128, device="cuda")}}
        txt, img = randn(1, s_txt, 3 * heads * 128), randn(1, 4096,
                                                           3 * heads * 128)
        proj = randn(1, s_txt + 16384, 7 * heads * 128)
        ang = torch.rand((s_txt + 16384, 64), generator=g, device="cuda")
        cos, sin = torch.cos(ang), torch.sin(ang)
        q, k, v = (randn(2, 24, 4608, 128) for _ in range(3))
        calls = {
            "B1 joint 1x5337": lambda: torch.cat(mma.mmdit_double_attention(
                txt, img, norm, norm, cos[:5337], sin[:5337], heads, 128),
                1),
            "B3 single 1x17625": lambda: mma.mmdit_single_attention(
                proj, norm, cos, sin, heads, 128),
            "B5 2x24x4608": lambda: attn._kernel_forward(q, k, v, False,
                                                         None)[0],
        }
        times = {(c, b): [] for c in calls for b in builds}
        ref = {}
        for build_name in ("2 stages", "3 stages", "3 stages", "2 stages"):
            _use(builds[build_name])
            for call, fn in calls.items():
                out = fn()
                torch.cuda.synchronize()
                ref.setdefault(call, out.float().clone())
                rel = ((out.float() - ref[call]).norm()
                       / ref[call].norm()).item()
                times[(call, build_name)].append(_ms(fn))
                print(f"{call} {build_name}: "
                      f"{times[(call, build_name)][-1]:.3f} ms (within "
                      f"{rel:.2e} of the committed build)", flush=True)
        for (call, build_name), t in times.items():
            print(f"{call} {build_name}: {t[0]:.3f} / {t[1]:.3f} ms")
    finally:
        for mod, name in ((attn, "flash_attention"), (mma, "mmdit_attention")):
            mod._LIB = None
            _build._LOADED.pop(name, None)
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
