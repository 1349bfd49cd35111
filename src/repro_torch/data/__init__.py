"""Data pipeline of the port: copies of the JAX package's numpy-only
corpus and sharding modules."""
