"""Models of the port: the llama-style decoder, its weight bridge from the
JAX package, sampling, the decode window and the decode engine."""
