"""Training: optimizer, train step, checkpoints and the train loop."""
