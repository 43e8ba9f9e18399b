"""sgg_torch.utils — noise helpers."""
