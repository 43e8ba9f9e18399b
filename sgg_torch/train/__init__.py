"""sgg_torch.train — workdir and weights IO, and building the generator from a
config (training comes in a later slice)."""
