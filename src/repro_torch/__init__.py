"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

It mirrors the reference package's layout (``core``, ``configs``,
``models``, ``kernels``, ``serving``, ``launch``) and imports neither JAX
nor ``repro``: what it needs of the reference's framework-free modules
it keeps as its own copies.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""
