"""Typed rejection errors for the resilience layer.

The sync tier historically surfaced malformed wire input as whatever the
first broken dict access happened to raise (``KeyError`` on a missing
``docId``, ``TypeError`` on a non-dict message). Transport and application
layers cannot distinguish those accidents from programming bugs, so they
cannot quarantine a misbehaving peer without pattern-matching on internals.
Every validation failure now raises :class:`ProtocolError` instead.
"""

from __future__ import annotations


class ProtocolError(ValueError):
    """A malformed or schema-violating wire input was rejected.

    Raised by the validation layer (``resilience.validation``) before any
    document state is touched.

    Subclasses ``ValueError`` so pre-existing callers that catch
    ``ValueError`` around apply paths keep working unchanged.
    """
