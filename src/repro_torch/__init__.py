"""LOCO ported to PyTorch and CUDA (one NVIDIA H100).

The JAX package ``repro`` is the reference; this package mirrors its layout
(``core/``, ``kernels/``) and imports neither JAX nor ``repro``.  Entry
points run on the card (``device=None`` means ``"cuda"``) unless the caller
passes ``device="cpu"``, where every kernel runs its plain PyTorch version.
"""
