"""Models of the port: the llama-style decoder, its weight bridge from the
JAX package, its losses and optimizer recipe, sampling, the decode
window and the decode engine."""
