"""sgg_torch.utils — noise, profiling and numerics-debugging helpers."""
