"""Index sampling: splits and epoch orderings (counterpart of
``stylemesh_tpu/data/sampling.py``, a copy).

Mirrors Abstract_DataModule's split modes (folder / sequential) and sampler
modes (random / sequential / repeat with index_repeat)
(the reference's data/abstract_dataset.py:349-361,447-492), plus batching
into fixed view-batch sizes for the train step (the reference always uses
batch size 1).
"""

from typing import List, Sequence

import numpy as np

SPLIT_MODES = ("folder", "sequential")
SAMPLER_MODES = ("random", "sequential", "repeat")


def make_split(num_items, split=(0.8, 0.2), split_mode="sequential",
               shuffle=False, seed=None):
    """Returns (train_indices, val_indices)."""
    indices = list(range(num_items))
    if split_mode == "folder":
        # 'folder' mode: the caller already has separate train/ and val/
        # datasets, so each dataset keeps all of its own indices
        # (abstract_dataset.py:447-453).
        if shuffle:
            np.random.default_rng(seed).shuffle(indices)
        return indices, list(indices)
    train_n = int(split[0] * num_items)
    if shuffle:
        np.random.default_rng(seed).shuffle(indices)
    return indices[:train_n], indices[train_n:]


def epoch_indices(indices: Sequence[int], sampler_mode="repeat", index_repeat=1,
                  seed=None) -> List[int]:
    """The index stream for one epoch under the given sampler mode."""
    if sampler_mode == "sequential":
        return list(indices)
    if sampler_mode == "random":
        out = list(indices)
        np.random.default_rng(seed).shuffle(out)
        return out
    if sampler_mode == "repeat":
        if isinstance(index_repeat, int):
            return [i for i in indices for _ in range(index_repeat)]
        # per-index repeat counts (reference RepeatingSampler list form,
        # abstract_dataset.py:501-506: indexed by the dataset index itself)
        return [i for i in indices for _ in range(index_repeat[i])]
    raise ValueError(f"Unsupported sampler mode: {sampler_mode}")


def batched_repeat(indices: Sequence[int], batch_size: int, index_repeat: int):
    """Repeat-mode batching: groups of ``batch_size`` *distinct* views, each
    group repeated ``index_repeat`` times consecutively.

    The view-batched equivalent of the reference's RepeatingSampler at
    batch 1 (each view optimized for index_repeat consecutive steps): batches
    hold distinct views (no wasted duplicate compute) and consecutive steps
    reuse the same device-resident batch.
    """
    groups = batched(indices, batch_size)
    return [g for g in groups for _ in range(index_repeat)]


def batched(indices: Sequence[int], batch_size: int, drop_remainder=False,
            pad_to_full=True):
    """Split an index stream into view batches of size ``batch_size``.

    A trailing partial batch is padded by cycling from its start (keeps the
    step's batch shape) unless dropped.
    """
    out = []
    for s in range(0, len(indices), batch_size):
        chunk = list(indices[s:s + batch_size])
        if len(chunk) < batch_size:
            if drop_remainder:
                continue
            if pad_to_full:
                k = 0
                while len(chunk) < batch_size:
                    chunk.append(chunk[k % len(chunk)])
                    k += 1
        out.append(chunk)
    return out
