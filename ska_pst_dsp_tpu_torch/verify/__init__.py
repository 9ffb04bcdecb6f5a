"""Spurious-power metrics (copy of the JAX package's ``verify.util``)."""
