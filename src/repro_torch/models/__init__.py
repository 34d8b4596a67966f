"""Models: the paper's MNIST MLP and the decoder stack of the LLM
configurations (attention mixer, dense SwiGLU FFN)."""
