"""Outputs, dumps and checkpoints (reference: src/output.c and friends), as
in ``atmospheric_athena_tpu/io``: the files are the JAX package's, byte for
byte (history values to the last digits of the sums' order)."""
