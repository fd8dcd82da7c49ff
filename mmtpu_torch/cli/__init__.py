"""Entry points of the port: `python -m mmtpu_torch.cli.train_monomodal`,
`train_multimodal`, `train_avmnist`, `train_cmam`, `predict` and `serve`."""
