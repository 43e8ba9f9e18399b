"""sgg_torch.eval — K-sample scene-graph sampling and recall@k."""
