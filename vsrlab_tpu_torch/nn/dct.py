"""Fixed DCT patch tokeniser / detokeniser (port of ``vsrlab_tpu/nn/dct.py``).

A type-II orthonormal 2-D DCT over each ``ps x ps`` patch of each colour
channel gives tokens ``(B, T, P, C*ps*ps)``; the decoder inverts it. The
forward is one ``einsum`` against the basis; the basis is orthogonal, so
the inverse contracts with it the other way.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch
from torch import nn


@lru_cache(maxsize=8)
def _dct_basis(ps: int) -> np.ndarray:
    """``(ps*ps, ps, ps)`` orthonormal type-II 2-D DCT basis, built in
    float64 and stored in float32."""

    def filt(pos, freq, n):
        r = math.cos(math.pi * freq * (pos + 0.5) / n) / math.sqrt(n)
        return r * math.sqrt(2) if freq else r

    m = np.zeros((ps, ps, ps, ps), dtype=np.float64)
    for u in range(ps):
        for v in range(ps):
            for i in range(ps):
                for j in range(ps):
                    m[u, v, i, j] = filt(i, u, ps) * filt(j, v, ps)
    return m.reshape(ps * ps, ps, ps).astype(np.float32)


class _DCT(nn.Module):
    def __init__(self, ps: int):
        super().__init__()
        self.ps = ps
        self.register_buffer("basis", torch.from_numpy(_dct_basis(ps).copy()), persistent=False)

    def _basis(self, x: torch.Tensor) -> torch.Tensor:
        """The basis on ``x``'s device, in the promotion of ``x``'s type and fp32."""
        return self.basis.to(x.device, torch.promote_types(x.dtype, self.basis.dtype))


class EncoderDCT(_DCT):
    """Clip ``(B, T, H, W, C)`` -> DCT tokens ``(B, T, (H/ps)*(W/ps), C*ps*ps)``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        ps = self.ps
        hp, wp = h // ps, w // ps
        basis = self._basis(x)
        # (B, T, hp, ps, wp, ps, C) -> (B, T, hp, wp, C, ps, ps)
        x = x.to(basis.dtype).reshape(b, t, hp, ps, wp, ps, c).permute(0, 1, 2, 4, 6, 3, 5)
        tok = torch.einsum("bthwcij,kij->bthwck", x, basis)
        return tok.reshape(b, t, hp * wp, c * ps * ps)


class DecoderIDCT(_DCT):
    """Inverse of :class:`EncoderDCT` back to ``(B, T, h, w, C)``."""

    def __init__(self, ps: int, h: int, w: int):
        super().__init__(ps)
        self.hp, self.wp = h // ps, w // ps

    def forward(self, tok: torch.Tensor) -> torch.Tensor:
        b, t, _, ck = tok.shape
        ps = self.ps
        c = ck // (ps * ps)
        basis = self._basis(tok)
        tok = tok.to(basis.dtype).reshape(b, t, self.hp, self.wp, c, ps * ps)
        x = torch.einsum("bthwck,kij->bthwcij", tok, basis)
        x = x.permute(0, 1, 2, 5, 3, 6, 4)  # (B, T, hp, ps, wp, ps, C)
        return x.reshape(b, t, self.hp * ps, self.wp * ps, c)
