"""Models: the paper's MNIST MLP."""
