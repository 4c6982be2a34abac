"""Vectorized FirstFit variants (paper Alg. 4) over padded neighbor colors.

Every variant takes ``neigh_colors`` of shape ``(w, W)`` int32 — the
gathered colors of up to ``W`` neighbors per worklist vertex, 0 meaning
"no neighbor / uncolored" — and returns the smallest permissible color in
``[1, W+1]`` per row, as ``repro.core.firstfit`` does.

* ``scan``   — per-row forbidden counts, then the first zero.
* ``sort``   — sort the row and walk the first gap.
* ``bitset`` — forbidden colors packed into 32-bit words, first free bit.
  PyTorch has no uint32 shifts and no popcount on the CPU, so the words are
  int32 (bit 31 is the sign bit, harmless to bitwise ops) and the first
  free bit is found structurally, as the Pallas kernels do.
"""
from __future__ import annotations

import torch

__all__ = ["firstfit_scan", "firstfit_sort", "firstfit_bitset", "FF_FUNCS", "ffs_u32"]


def firstfit_scan(neigh_colors: torch.Tensor) -> torch.Tensor:
    """colorMask analogue: per-row forbidden counts + first-zero scan."""
    w, W = neigh_colors.shape
    C = W + 1  # candidate colors 1..C
    cols = torch.where((neigh_colors >= 1) & (neigh_colors <= C), neigh_colors, 0)
    mask = torch.zeros((w, C + 1), dtype=torch.int32, device=neigh_colors.device)
    rows = torch.arange(w, device=neigh_colors.device)[:, None].expand(w, W)
    ones = torch.ones((w, W), dtype=torch.int32, device=neigh_colors.device)
    mask.index_put_((rows, cols.long()), ones, accumulate=True)  # col 0: trash
    permissible = (mask[:, 1:] == 0).to(torch.int32)
    return permissible.argmax(dim=1).to(torch.int32) + 1


def firstfit_sort(neigh_colors: torch.Tensor) -> torch.Tensor:
    """Sort + first-gap walk: f advances past each sorted color it meets."""
    s = torch.sort(neigh_colors, dim=1).values
    f = torch.ones((s.shape[0],), dtype=torch.int32, device=s.device)
    for d in range(s.shape[1]):
        f = torch.where(s[:, d] == f, f + 1, f)
    return f


def ffs_u32(x: torch.Tensor) -> torch.Tensor:
    """Find-first-set per 32-bit word: the index of its lowest 1 bit, 32
    where the word is 0 (``repro``'s ``ffs_u32``), as int32.  Words are
    int32 here (bit 31 the sign bit; torch's uint32 has no shifts on the
    CPU), or wider integers whose low 32 bits are taken; torch has no
    popcount, so the index is the least set position over a table of the
    32 bits, as the Pallas kernels find a first free bit."""
    bitpos = torch.arange(32, dtype=torch.int32, device=x.device)
    hit = ((x.to(torch.int32)[..., None] >> bitpos) & 1) == 1  # arithmetic shift
    return torch.where(hit, bitpos, 32).amin(dim=-1).to(torch.int32)


def first_free_bit(words: torch.Tensor, limit: int) -> torch.Tensor:
    """Index of the lowest zero bit at position ``<= limit`` per row.

    ``words`` is ``(w, nwords)`` int32 with bit ``p % 32`` of word
    ``p // 32`` standing for position ``p``; rows with no free position
    return ``limit + 1``.
    """
    w, nwords = words.shape
    bitpos = torch.arange(32, dtype=torch.int32, device=words.device)
    free = ((~words)[:, :, None] >> bitpos) & 1  # arithmetic shift: bit 31 ok
    pos = (torch.arange(nwords, dtype=torch.int32, device=words.device)[:, None]
           * 32 + bitpos)[None].expand(w, nwords, 32)
    pos = torch.where((free == 1) & (pos <= limit), pos, limit + 1)
    return pos.reshape(w, -1).amin(dim=1) if w else pos.new_zeros((0,))


def forbidden_words(neigh_colors: torch.Tensor, nwords: int) -> torch.Tensor:
    """Pack forbidden colors ``1..32*nwords`` into int32 words (bit c-1)."""
    idx = neigh_colors.to(torch.int32) - 1  # -1 for "no color"
    valid = (idx >= 0) & (idx < 32 * nwords)
    word_of = torch.where(valid, idx >> 5, nwords)  # nwords: trash word
    bits = torch.where(valid, torch.ones_like(idx) << (idx.clamp(min=0) & 31), 0)
    words = torch.zeros((idx.shape[0], nwords + 1), dtype=torch.int32,
                        device=idx.device)
    # OR each lane's bit into its word, one lane at a time
    for d in range(idx.shape[1]):
        col = word_of[:, d : d + 1].long()
        words.scatter_(1, col, words.gather(1, col) | bits[:, d : d + 1])
    return words[:, :nwords]


def firstfit_bitset(neigh_colors: torch.Tensor) -> torch.Tensor:
    """The paper's bitset FirstFit: bit words + first free bit."""
    W = neigh_colors.shape[1]
    nwords = (W + 1 + 31) // 32
    words = forbidden_words(neigh_colors, nwords)
    return first_free_bit(words, W).to(torch.int32) + 1


FF_FUNCS = {
    "scan": firstfit_scan,
    "sort": firstfit_sort,
    "bitset": firstfit_bitset,
}
