"""Indexed accumulation (counterpart of ppg_tpu/ops/reduce.py).

ppg_tpu sorts and takes compensated prefix sums because scatter-add with
duplicate indices serialises on a TPU. Here it is PyTorch's index_add_,
which a card runs with float atomics: the sums then vary in their last
bits from run to run. On the CPU they are deterministic.
"""

from __future__ import annotations


def bincount_add(target_flat, idx, val):
    """target_flat[m] += sum(val[idx == m]), in place; returns target_flat.
    Invalid records carry val == 0 at any in-range idx."""
    return target_flat.index_add_(0, idx.long(), val)


def bincount_add2(targets, idx, val_a, val_b):
    """Two accumulations over one index (e.g. sum and statweight), in
    place; returns the pair of targets."""
    i = idx.long()
    return (targets[0].index_add_(0, i, val_a),
            targets[1].index_add_(0, i, val_b))
