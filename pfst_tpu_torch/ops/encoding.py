"""EncNet's encoding layer (port of ``pfst_tpu/ops/encoding.py``).

``num_codes`` learned codewords d_k and smoothing factors s_k; each of
the N features x is softly assigned to the codewords by
``softmax_k(s_k * ||x - d_k||^2)`` and the residuals x - d_k are summed
with those weights: (B, N, C) -> (B, K, C). The JAX file's formula, which
forms every residual: a (B, N, K, C) fp32 tensor that autograd keeps
(268 MB at EncNet's 64^2 features, 32 codes, 512 channels, batch 2).
It runs in fp32 with autocast off (XLA computes it there, not a Pallas
kernel) and returns the input's type.
"""
from __future__ import annotations

import torch
import torch.nn as nn


class Encoding(nn.Module):

    def __init__(self, channels: int, num_codes: int):
        super().__init__()
        self.channels, self.num_codes = channels, num_codes
        self.codewords = nn.Parameter(torch.zeros(num_codes, channels))
        self.scale = nn.Parameter(torch.zeros(num_codes))

    def draw_(self, generator: torch.Generator):
        """The JAX file's initializers: codewords U[-std, std] with std
        1/sqrt(K C), smoothing factors U[-1, 0)."""
        std = 1.0 / (self.num_codes * self.channels)**0.5
        with torch.no_grad():
            self.codewords.uniform_(-std, std, generator=generator)
            self.scale.uniform_(-1.0, 0.0, generator=generator)

    def forward(self, x):
        with torch.autocast(x.device.type, enabled=False):
            expanded = x.float()[:, :, None, :] - self.codewords
            dist = expanded.pow(2).sum(-1)                    # (B, N, K)
            assign = torch.softmax(self.scale * dist, dim=-1)
            encoded = torch.einsum('bnk,bnkc->bkc', assign, expanded)
        return encoded.to(x.dtype)
