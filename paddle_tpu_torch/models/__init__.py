"""Models of the port: the transformer LM (generation and training),
ResNet, the stacked dynamic LSTM, LeNet-5, VGG-16 and the seq2seq
attention NMT model (training and beam-search generation)."""
