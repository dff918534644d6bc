"""LM serving: the continuous-batching engine and its min-p sampler."""
