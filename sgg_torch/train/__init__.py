"""sgg_torch.train — workdir and weights IO (training comes in a later slice)."""
