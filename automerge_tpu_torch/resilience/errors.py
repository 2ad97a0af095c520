"""Typed rejection errors for the resilience layer.

The sync tier historically surfaced malformed wire input as whatever the
first broken dict access happened to raise (``KeyError`` on a missing
``docId``, ``TypeError`` on a non-dict message). Transport and application
layers cannot distinguish those accidents from programming bugs, so they
cannot quarantine a misbehaving peer without pattern-matching on internals.
Every validation failure now raises :class:`ProtocolError` instead, and
a checkpoint bundle that fails its checks raises :class:`CheckpointError`.
"""

from __future__ import annotations


class ProtocolError(ValueError):
    """A malformed or schema-violating wire input was rejected.

    Raised by the validation layer (``resilience.validation``) before any
    document state is touched.

    Subclasses ``ValueError`` so pre-existing callers that catch
    ``ValueError`` around apply paths keep working unchanged.
    """


class CheckpointError(ProtocolError):
    """A checkpoint bundle failed structural or integrity validation.

    Raised by the checkpoint codec (``automerge_tpu_torch.checkpoint``)
    when a bundle is truncated, has a bad magic/format-version, or any
    per-array content hash mismatches — always BEFORE any restored state
    is handed out, so a consumer never sees a partially-restored
    document. ``restore_state_or_replay`` / ``restore_doc_or_replay``
    fall back to full log replay on it when given the change log.
    """
