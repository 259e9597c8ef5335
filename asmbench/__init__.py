"""The benchmark of turingassembler_tpu_torch on one NVIDIA H100: a
harness driven by data (configs/, traffic/, entries/, metrics/), the
byte arithmetic and peaks of its rooflines (roofline/), and the plain
reference that decides `correct` (reference/).  See README.md."""
