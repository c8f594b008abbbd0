"""Models of the port: the transformer LM (generation and training) and
ResNet (training)."""
