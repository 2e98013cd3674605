"""Weight bridge from the JAX package's variables (numpy only)."""
