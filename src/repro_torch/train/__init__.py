"""Training (the train step, the LM loss, checkpoints) and the serving
step functions."""
