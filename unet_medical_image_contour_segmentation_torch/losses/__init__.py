"""The training criterion: cross-entropy + Dice, as the JAX package's ``losses/``."""
