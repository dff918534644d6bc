"""PyTorch / CUDA port of the Clutch PuD reproduction (NVIDIA Hopper).

The package keeps the layout and names of the JAX package ``repro`` so
each module's counterpart is easy to find, and imports nothing of it:
the small NumPy pieces it needs (chunk plans, index resolution, the
benchmark table and forest, the queries) are copied here.

Main path: :class:`repro_torch.pud.PudSession` runs ``query`` (Q1-Q5,
``Compound``) and ``predict`` (GBDT) through four hand-written CUDA
kernels (:mod:`repro_torch.kernels`).  Entry points run on the card
unless the caller passes ``device="cpu"``, where every kernel wrapper
takes its plain PyTorch version.
"""
