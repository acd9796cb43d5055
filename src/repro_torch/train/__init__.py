"""Training substrate of the port (counterpart of ``repro.train``):
optimizers, the train step and checkpoints."""
