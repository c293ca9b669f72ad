"""Host allocator tuning for large-array data paths.

On virtualized hosts with lazy memory ballooning (measured on this
environment: ~40 us per 4 KiB first-touch page fault, i.e. seconds per
fresh multi-hundred-MB allocation), glibc's default behavior is
pathological for the packing/translation paths: every allocation above
the 128 KiB mmap threshold gets fresh mmap'd pages, so each large numpy
temporary re-pays the fault storm, and freed arenas are trimmed straight
back to the OS. Measured on this host: np.repeat of 8M int64 = 17.5 s
cold vs 0.009 s with retained pages (experiments log, round 2; the
six-frame expansion of a 100M-nt DB took 1073 s before this fix).

``retain_large_allocations()`` raises the mmap and trim thresholds so
big buffers ride the reused brk heap. Process-wide, idempotent, silently
a no-op off glibc. Called from SequenceDB and SearchEngine init.
"""
from __future__ import annotations

_done = False


def retain_large_allocations() -> None:
    global _done
    if _done:
        return
    _done = True
    import os

    # Embedders can keep default glibc behavior: the thresholds are
    # process-wide and permanently disable heap trimming for the whole
    # host program, which inflates resident memory outside this library.
    if os.environ.get("LIBSSA_NO_MALLOC_TUNING"):
        return
    try:
        import ctypes

        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        M_TRIM_THRESHOLD = -1
        M_MMAP_THRESHOLD = -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
        libc.mallopt(M_TRIM_THRESHOLD, 1 << 30)
    except Exception:  # non-glibc or mallopt refused: tuning is best-effort
        pass
