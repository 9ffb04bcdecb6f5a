"""Prototype FIR filter design (copy of the JAX package's ``design``)."""
