"""sgg_torch — the PyTorch/CUDA port of ``sgg`` for NVIDIA Hopper.

A package of its own beside ``sgg``: it imports torch and numpy, never JAX,
and nothing of ``sgg``. Module names mirror ``sgg``'s. Ported so far: the
generate path on precomputed features (config, vocab, shards, the
attention-LSTM generator, the flax weight converter, the K-sample sampler on
the hand-written CUDA ``fused_decode`` kernel, recall@k, and
``python -m sgg_torch.cli.generate``), and on pixels (the VGG-19 and
ResNet-50 encoders on the hand-written CUDA ``conv_direct`` and
``fused_matmul`` kernels; ViT-B/16 on the hand-written CUDA
``flash_attention`` forward, with the transformer triple decoder and the
generator-forward sampler).
"""

__version__ = "0.1.0"
