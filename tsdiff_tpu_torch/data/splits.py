"""Dataset splitting (reference preprocessing.py:14-73).

``index_split`` keeps forward/reverse reaction pairs together: the raw corpus
stores the original reaction at even index 2k and its reverse-augmented twin
at 2k+1; splitting happens over the k's and then expands to both members
(reference preprocessing.py:40-73, seed 42 in production).  Uses python's
``random`` module exactly like the reference so the split indices reproduce
bit-for-bit for a given seed.
"""

from __future__ import annotations

import random
from typing import List

import numpy as np


def random_split(data_list: List, train: float = 0.8, valid: float = 0.1, seed: int = 1234):
    assert train + valid < 1
    data_list = list(data_list)
    random.seed(seed)
    random.shuffle(data_list)
    n = len(data_list)
    n_train = int(n * train)
    n_valid = int(n * valid)
    return (
        data_list[:n_train],
        data_list[n_train : n_train + n_valid],
        data_list[n_train + n_valid :],
    )


def index_split(num_data: int, train: float = 0.8, valid: float = 0.1, seed: int = 1234):
    """Split over original-reaction indices; expand each k to (2k, 2k+1)."""
    assert train + valid < 1
    random.seed(seed)
    index_list = list(range(num_data))
    random.shuffle(index_list)

    n_train = int(num_data * train)
    n_valid = int(num_data * valid)
    tr = np.array(index_list[:n_train])
    va = np.array(index_list[n_train : n_train + n_valid])
    te = np.array(index_list[n_train + n_valid :])

    def expand(ix):
        out = list(np.concatenate((ix * 2, ix * 2 + 1))) if len(ix) else []
        out.sort()
        return out

    return expand(tr), expand(va), expand(te)
