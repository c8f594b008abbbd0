"""Models of the port: the transformer LM (generation and training),
ResNet, the stacked dynamic LSTM, LeNet-5 and VGG-16 (training)."""
