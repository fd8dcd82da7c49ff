"""Entry points of the port: `python -m mmtpu_torch.cli.predict` and
`python -m mmtpu_torch.cli.serve`."""
