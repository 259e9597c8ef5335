"""Scale tools of the port, twins of the JAX package's tools/:
ecoli_scale (the whole assembly3 at upstream's E. coli operating point,
quality-gated) and spill_scale (the out-of-core sorter and count at a
real library's size).  Run as `python -m
turingassembler_tpu_torch.tools.<name> --help`."""
