"""Ops of every round the window completed over the window's seconds
(host clock); a round runs from its changes handed to apply_batches to
texts() returning."""


def read(r):
    return r.ops_per_s()
