"""sgg_torch.cli — command-line entry points (``python -m sgg_torch.cli.X``)."""
