"""Synthetic token pipeline for LM training (twin of
``repro.data.tokens``).

Sequences come from a fixed random bigram chain over the vocabulary, so
there is real learnable structure without any external data. The numpy
code is the reference's, with the same ``default_rng(seed)`` draws in the
same order, so a stream gives the reference's batches bit for bit; each
batch is handed over as int32 tensors on the caller's device.
"""
from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch


class BigramStream:
    def __init__(self, vocab: int, seed: int = 0, branching: int = 4):
        rng = np.random.default_rng(seed)
        # each token can be followed by `branching` candidates
        self.next_tok = rng.integers(0, vocab, size=(vocab, branching))
        self.vocab = vocab
        self.branching = branching
        self.rng = rng

    def batch(self, batch_size: int, seq_len: int,
              device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
        """(tokens, labels), int32 (B, S) on ``device``; labels are the
        next tokens."""
        toks = np.empty((batch_size, seq_len + 1), np.int64)
        toks[:, 0] = self.rng.integers(0, self.vocab, size=batch_size)
        choices = self.rng.integers(0, self.branching,
                                    size=(batch_size, seq_len))
        for t in range(seq_len):
            toks[:, t + 1] = self.next_tok[toks[:, t], choices[:, t]]
        return (torch.from_numpy(toks[:, :-1].astype(np.int32)).to(device),
                torch.from_numpy(toks[:, 1:].astype(np.int32)).to(device))

    def batches(self, batch_size: int, seq_len: int,
                device="cpu") -> Iterator:
        while True:
            yield self.batch(batch_size, seq_len, device)
