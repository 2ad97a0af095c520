"""Ops of every session the window completed over the window's seconds
(host clock); a session opens the base document, merges the backlog and
reads the text, all inside the window."""


def read(r):
    return r.ops_per_s()
