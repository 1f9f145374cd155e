"""LM training of the port: optimizers, the train step, the lr schedule."""
