"""Checkpoints, the dense Predictor, the optimizer, the train step and loop, validation."""
