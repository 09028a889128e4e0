"""Read the portable parameter file the JAX package writes.

``save_params_npz`` in ``livelyspeaker_tpu/training/checkpoints.py`` stores a
parameter tree flat, as ``{'a/b/c': array}`` in one ``.npz``. This reader
needs numpy only; ``utils/convert.py`` turns its tree into a state_dict.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["load_params_npz"]


def load_params_npz(path: str) -> Dict:
    """Rebuild the nested param dict from a flat npz."""
    tree: Dict = {}
    with np.load(path) as flat:
        for key in flat.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = flat[key]
    return tree
