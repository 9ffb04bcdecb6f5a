"""Host helpers of the port: rational arithmetic, block geometry, windows,
configs (copies of the JAX package's ``utils``)."""
