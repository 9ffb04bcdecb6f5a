"""DADA file I/O (copy of the JAX package's ``io.dada`` generic path)."""
