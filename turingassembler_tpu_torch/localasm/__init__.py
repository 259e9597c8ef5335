"""Local assembly / gap bridging (port of turingassembler_tpu/localasm)."""
