"""Models of the port (counterparts of ``repro.models``): the dense LM
stack and the two-tower retrieval model, for serving and training."""
