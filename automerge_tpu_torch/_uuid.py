"""Injectable UUID factory — the determinism hook used throughout the tests.

Mirrors the reference's ``src/uuid.js`` (swappable factory, reset to default),
which the test-suite uses to pin nondeterminism (reference src/uuid.js:1-12).
"""

from __future__ import annotations

import uuid as _uuid_module


def _default_factory() -> str:
    return str(_uuid_module.uuid4())


_factory = _default_factory


def uuid() -> str:
    return _factory()


def set_factory(factory) -> None:
    global _factory
    _factory = factory


def reset() -> None:
    global _factory
    _factory = _default_factory
