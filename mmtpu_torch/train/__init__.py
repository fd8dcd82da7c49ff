"""Training of the port: steps, losses, optimizers, the epoch loop and the
metric recorder (counterpart of `mmtpu/train`)."""
