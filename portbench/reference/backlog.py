"""The merged text of a text backlog, worked out from its description.

Every run hangs off its target base element with the one shared head
counter (past the base's), so the runs after one base element follow
it in descending actor id, before the next base element; a base element
a change deletes is gone; inserts with no value add nothing. So the
text is the base in order, each surviving base char followed by the
runs that hang off it.
"""

from __future__ import annotations

import numpy as np


def backlog_text(bl) -> str:
    n = bl.base_n
    base = 97 + np.arange(1, n + 1) % 26
    alive = np.ones(n + 1, bool)
    targets, letters, names = [], [], []
    for b in bl.batches:
        targets.append(b.targets)
        letters.append(b.letters)
        names.extend(b.actors)
        if bl.deletes:
            idx = (b.del_start[:, None] + np.arange(bl.deletes)).ravel()
            alive[idx] = False
    targets = np.concatenate(targets)
    letters = np.concatenate(letters)
    # rank of each run's actor, largest id first
    desc = np.empty(len(names), np.int64)
    desc[np.argsort(np.array(names))[::-1]] = np.arange(len(names))
    # pieces: base char i -> key (i, -1); run after i -> key (i, desc rank)
    keys_t = np.concatenate([np.arange(1, n + 1), targets])
    keys_r = np.concatenate([np.full(n, -1), desc])
    order = np.lexsort((keys_r, keys_t))
    code = np.concatenate([base, letters])[order]
    length = np.concatenate([alive[1:].astype(np.int64),
                             np.full(len(targets), bl.pairs)])[order]
    return np.repeat(code, length).astype(np.uint8).tobytes().decode("ascii")
