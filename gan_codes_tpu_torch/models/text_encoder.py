"""DAMSM-style bidirectional-LSTM sentence encoder (the port of
`gan_codes_tpu/models/text_encoder.py`).

Reference RNNEncoder (`src/text_encoder/model.py:6-63`): Embedding(vocab,
300) -> Dropout(0.5) -> packed bidirectional 1-layer LSTM (300 -> 128 per
direction); the sentence embedding is the two directions' final hidden
states concatenated, [B, 256]. Parameters carry the reference's names
(`encoder.weight`, `rnn.{weight,bias}_{ih,hh}_l0{,_reverse}`), so
`text_encoder.pth` loads with `load_state_dict(strict=True)`.

The JAX package runs a masked scan; here `pack_padded_sequence(
enforce_sorted=False)` gives the same packed final states without sorting
the batch. The encoder is frozen for serving, so dropout never applies.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.nn.utils.rnn import pack_padded_sequence

from ..config import TextEncoderConfig


class RNNEncoder(nn.Module):
    def __init__(self, cfg: TextEncoderConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = nn.Embedding(cfg.vocab_size, cfg.embed_dim)
        self.rnn = nn.LSTM(cfg.embed_dim, cfg.per_direction_hidden,
                           num_layers=1, batch_first=True,
                           bidirectional=cfg.bidirectional)

    def forward(self, captions: torch.Tensor,
                cap_lens: torch.Tensor) -> torch.Tensor:
        """captions [B, T] int, cap_lens [B] int (each in 1..T) ->
        sentence embeddings [B, hidden_dim]."""
        emb = self.encoder(captions.long())
        # pack_padded_sequence takes its lengths on the CPU
        packed = pack_padded_sequence(emb, cap_lens.detach().to("cpu",
                                                                torch.int64),
                                      batch_first=True, enforce_sorted=False)
        _, (h_n, _) = self.rnn(packed)
        # h_n [directions, B, H] in the batch's original order
        return torch.cat(list(h_n), dim=-1)
