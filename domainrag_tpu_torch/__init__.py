"""PyTorch/CUDA port of domainrag_tpu for NVIDIA Hopper (H100).

Mirrors ``domainrag_tpu``'s layout and names module for module. Plain
tensor code is PyTorch; every Pallas kernel of the JAX package that the
ported path reaches is a hand-written CUDA kernel under ``csrc/``, built
with ``nvcc`` on first use (``ops/_build.py``). The package imports
nothing of JAX or of ``domainrag_tpu``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a CUDA device they raise instead of falling back to the CPU.
"""
