"""sgg_torch.models — the attention-LSTM generator and its parts."""

from sgg_torch.models.attention import AdditiveAttention
from sgg_torch.models.generator import AttentionLSTMGenerator
from sgg_torch.models.lstm import TF1LSTMCell

__all__ = ["AdditiveAttention", "AttentionLSTMGenerator", "TF1LSTMCell"]
