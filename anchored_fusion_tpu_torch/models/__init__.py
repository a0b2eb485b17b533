"""False-positive filter: the CNN+Transformer model, its training, its inputs."""
