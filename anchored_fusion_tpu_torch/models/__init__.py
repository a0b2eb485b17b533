"""False-positive filters: the CNN+Transformer model, its training, its
inputs; the bi-LSTM and SVM variants."""
