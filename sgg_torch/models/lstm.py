"""LSTM cell with TF1 weight conventions, from ``sgg/models/lstm.py``.

One kernel of shape ``[input_dim + hidden, 4*hidden]`` applied to
``concat([x, h])``; gate order i, j, f, o (input, candidate, forget, output);
the forget bias (1.0) is added to the forget-gate pre-activation and is not
stored in the bias. Reference kernels drop in unchanged.
"""

from __future__ import annotations

import torch
from torch import nn


class TF1LSTMCell(nn.Module):
    """LSTM cell matching tf.compat.v1.nn.rnn_cell.BasicLSTMCell semantics.

    Parameters are float32; the cell computes in ``dtype``.
    """

    def __init__(self, input_dim: int, hidden: int, forget_bias: float = 1.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.hidden = hidden
        self.forget_bias = forget_bias
        self.dtype = dtype
        self.kernel = nn.Parameter(torch.empty(input_dim + hidden, 4 * hidden))
        self.bias = nn.Parameter(torch.zeros(4 * hidden))
        nn.init.xavier_uniform_(self.kernel)

    def forward(self, carry, x):
        c, h = carry
        concat = torch.cat([x, h], dim=-1).to(self.dtype)
        gates = concat @ self.kernel.to(self.dtype) + self.bias.to(self.dtype)
        i, j, f, o = torch.chunk(gates, 4, dim=-1)  # TF1 i,j,f,o order
        new_c = c * torch.sigmoid(f + self.forget_bias) + torch.sigmoid(i) * torch.tanh(j)
        new_h = torch.tanh(new_c) * torch.sigmoid(o)
        return (new_c, new_h), new_h
