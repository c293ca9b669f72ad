"""ctypes bridge to the native C++ FASTA packer (``csrc/fastadb.cpp``).

The reference's database layer is native C (libsdb); ours is native C++
behind the same Python API. ``parse_fasta_native`` returns the packed
(codes, offsets, lengths, headers) tuple or ``None`` when the shared library
is unavailable (pure-Python fallback in ``io/fasta.py`` takes over) — the
native path is a throughput optimization, never a correctness dependency.

Build: at first use, by the host C++ compiler, through
``util/cudabuild.load_native`` into ``build/libssa_tpu_torch/`` (keyed on
the source, the flags and the host CPU).
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np

from ..constants import SymType


@functools.cache
def _find_lib():
    from ..util.cudabuild import load_native

    lib = load_native("fastadb.cpp")
    if lib is not None:
        lib.fastadb_parse.restype = ctypes.c_void_p
        lib.fastadb_parse.argtypes = [
            ctypes.c_char_p,  # path
            ctypes.POINTER(ctypes.c_uint8),  # 256-entry code table
        ]
        lib.fastadb_n_seqs.restype = ctypes.c_int64
        lib.fastadb_n_seqs.argtypes = [ctypes.c_void_p]
        lib.fastadb_total_residues.restype = ctypes.c_int64
        lib.fastadb_total_residues.argtypes = [ctypes.c_void_p]
        lib.fastadb_headers_size.restype = ctypes.c_int64
        lib.fastadb_headers_size.argtypes = [ctypes.c_void_p]
        lib.fastadb_export.restype = None
        lib.fastadb_export.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint8),  # codes out
            ctypes.POINTER(ctypes.c_int64),  # offsets out
            ctypes.POINTER(ctypes.c_int32),  # lengths out
            ctypes.c_char_p,  # headers out (NUL-joined)
        ]
        lib.fastadb_free.restype = None
        lib.fastadb_free.argtypes = [ctypes.c_void_p]
    return lib


def native_available() -> bool:
    return _find_lib() is not None


def parse_fasta_native(path: str, symtype: SymType):
    """Parse + pack a FASTA file natively. None if unavailable/not a file."""
    lib = _find_lib()
    if lib is None or not os.path.isfile(path):
        return None
    from .. import alphabet

    table = alphabet._AA_TABLE if symtype is SymType.AMINOACID else alphabet._NT_TABLE
    table = np.ascontiguousarray(table, dtype=np.uint8)
    handle = lib.fastadb_parse(
        path.encode(), table.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    )
    if not handle:
        raise ValueError(f"native FASTA parse failed for {path!r}")
    try:
        n = lib.fastadb_n_seqs(handle)
        total = lib.fastadb_total_residues(handle)
        hsize = lib.fastadb_headers_size(handle)
        codes = np.empty(total, dtype=np.uint8)
        offsets = np.empty(n, dtype=np.int64)
        lengths = np.empty(n, dtype=np.int32)
        headers_buf = ctypes.create_string_buffer(int(hsize))
        lib.fastadb_export(
            handle,
            codes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            headers_buf,
        )
        headers = [
            h.decode("utf-8", "replace").strip()  # python parser strips too
            for h in headers_buf.raw.split(b"\x00")[:n]
        ]
        return codes, offsets, lengths, headers
    finally:
        lib.fastadb_free(handle)
