"""Sequence encoding (counterpart of ``immunostruct_tpu/data/encoding.py``;
reference: data/utils.py:70-89, immmunopred_dataloader.py:12-13).

Alphabet: 20 standard amino acids + padding char 'J' -> 21 one-hot channels.
The residue one-hot of the graph node features uses the same 20-letter
alphabetical order.
"""

from __future__ import annotations

import numpy as np

AMINO_ACIDS = "ACDEFGHIKLMNPQRSTVWY"
PADDING_CHAR = "J"
ALPHABET = AMINO_ACIDS + PADDING_CHAR  # 21 channels


def pad_sequence(sequence: str, max_length: int, padding_char: str = PADDING_CHAR) -> str:
    """Right-pad with the padding character (data/utils.py:70-73)."""
    return sequence.ljust(max_length, padding_char)


def one_hot_encode(sequence: str, alphabet: str = ALPHABET) -> np.ndarray:
    """[L, 21] one-hot; unknown characters encode as all-zero rows."""
    lut = np.full(128, -1, np.int64)
    for i, c in enumerate(alphabet):
        lut[ord(c)] = i
    idx = lut[np.frombuffer(sequence.encode("ascii"), np.uint8)]
    out = np.zeros((len(sequence), len(alphabet)), np.float32)
    known = idx >= 0
    out[np.nonzero(known)[0], idx[known]] = 1.0
    return out


def one_hot_encode_batch(sequences: list[str], max_length: int) -> np.ndarray:
    """Pad + one-hot over a corpus: [M, max_length, 21]."""
    out = np.zeros((len(sequences), max_length, len(ALPHABET)), np.float32)
    for i, s in enumerate(sequences):
        out[i] = one_hot_encode(pad_sequence(s, max_length))
    return out
