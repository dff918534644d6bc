"""Gradient compression and the compressed data-parallel step, on one
card: the gradient all-reduce of the reference's mesh is the identity
here.  ``pipeline_forward`` and ``sp_decode`` are not ported yet
(``ROADMAP.md`` Queue 1)."""
