"""Philox4x32-10 (Salmon et al., "Parallel random numbers: as easy as
1, 2, 3", SC 2011) in plain PyTorch integer arithmetic, and the brand
dropout's keep mask drawn from it.

The mask of element (b, a, c) of a (B, A, C) product is word e & 3 of the
Philox block at counter e >> 2, e = (b A + a) C + c, keyed by two 32-bit
seed words; the element is kept where the word is at most
keep * 2^32 - 1. 32-bit products are formed from 16-bit limbs in int64,
so nothing leaves int64's range.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
U32 = 0xFFFFFFFF


def mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    m_lo, m_hi = m & 0xFFFF, m >> 16
    x_lo, x_hi = x & 0xFFFF, x >> 16
    ll, lh = x_lo * m_lo, x_lo * m_hi
    hl, hh = x_hi * m_lo, x_hi * m_hi
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def philox(counter: Sequence[torch.Tensor], key: Sequence[int]):
    c0, c1, c2, c3 = counter
    k0, k1 = int(key[0]) & U32, int(key[1]) & U32
    for r in range(10):
        if r:
            k0, k1 = (k0 + W0) & U32, (k1 + W1) & U32
        hi0, lo0 = mulhilo(M0, c0)
        hi1, lo1 = mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_mask(seed: Sequence[int], keep: float, b: int, a: int, c: int,
              a_lo: int, a_hi: int, device) -> torch.Tensor:
    """bool (b, a_hi - a_lo, c): the kept elements of aspects [a_lo, a_hi)
    of a (b, a, c) product."""
    thr = min(int(keep * 2 ** 32) - 1, U32)
    rows = torch.arange(b, dtype=torch.int64, device=device)[:, None, None]
    asps = torch.arange(a_lo, a_hi, dtype=torch.int64,
                        device=device)[None, :, None]
    cols = torch.arange(c, dtype=torch.int64, device=device)[None, None, :]
    e = (rows * a + asps) * c + cols
    q = e >> 2
    zero = torch.zeros_like(q)
    words = torch.stack(philox((q & U32, q >> 32, zero, zero), seed), dim=-1)
    return torch.gather(words, -1, (e & 3)[..., None])[..., 0] <= thr
