"""Checkpoints and the dense Predictor."""
