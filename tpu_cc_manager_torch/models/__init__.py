"""Models of the port (Llama family), in the JAX package's parameter layout."""
