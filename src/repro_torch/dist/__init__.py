"""Distribution: partition specs on a ``torch.distributed`` device mesh
(``sharding``), gradient compression and the compressed data-parallel
step (``compression``, ``ddp``), the flash decode of the long-context
cell (``sp_decode``) and the GPipe schedule (``pipeline``) over a list
of devices."""
