"""Graph and sequence file formats, byte-compatible with the JAX package's
(asmg binary graph, headered FASTA, GFA) and the FASTQ reader."""
