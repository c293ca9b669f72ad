"""Output-mode controlled logging (reference: ``set_output_mode``, util.c).

The reference gates stderr chatter behind a silent/warning/info verbosity
global (SURVEY.md §5). Same model here, plus structured counter logging used
by the GCUPS instrumentation.
"""
from __future__ import annotations

import sys

from ..constants import OutputMode

_mode = OutputMode.WARNING


def set_output_mode(mode: OutputMode) -> None:
    global _mode
    _mode = OutputMode(mode)


def get_output_mode() -> OutputMode:
    return _mode


def log(level: OutputMode, message: str) -> None:
    if level <= _mode and level != OutputMode.SILENT:
        print(f"[libssa_tpu] {message}", file=sys.stderr)
