"""Models of the port: the transformer LM (generation and training),
ResNet (training) and the stacked dynamic LSTM (training)."""
