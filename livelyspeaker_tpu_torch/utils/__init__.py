"""Weight bridge from the JAX package and checkpoint reading."""
