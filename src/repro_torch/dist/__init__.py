"""Distribution on one card: gradient compression and the compressed
data-parallel step (the gradient all-reduce of the reference's mesh is
the identity here), the flash decode of the long-context cell
(``sp_decode``) and the GPipe schedule (``pipeline``) over a list of
devices."""
