"""Training on one card: AdamW, the train step, checkpoints, the loop."""
