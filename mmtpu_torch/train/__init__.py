"""Training of the port: steps, losses, optimizers, the epoch loop and the
metric recorder, and C-MAM's frozen-teacher steps and composite loss
(counterpart of `mmtpu/train`)."""
