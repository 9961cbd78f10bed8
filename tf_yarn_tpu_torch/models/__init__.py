"""Models of the port: the llama-style decoder, the BERT, ViT and ResNet
families, their weight bridges from the JAX package, the losses and
optimizer recipes, sampling, the decode window and the decode engine."""
