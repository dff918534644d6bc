"""The command-level PuD model (machine, device, scheduler, cost model),
chunked temporal coding, Clutch and the bit-serial baseline."""
