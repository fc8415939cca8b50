"""One-shot user-facing notes for silent behaviour changes (port of
``fluid2d_tpu/utils/notes.py``): each message prints as ``note: <msg>``
once per process, so a repeated decision does not spam the log.
"""

from __future__ import annotations

__all__ = ["note_once", "reset_notes"]

_seen: set[str] = set()


def note_once(msg: str) -> None:
    """Print ``note: <msg>`` the first time this exact message appears."""
    if msg not in _seen:
        _seen.add(msg)
        print(f"note: {msg}")


def reset_notes() -> None:
    """Forget previously printed notes (test isolation)."""
    _seen.clear()
