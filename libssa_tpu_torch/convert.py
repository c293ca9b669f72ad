"""Carry search state from the JAX package to the port.

This system has no weights: its state is the packed database and the query
profiles, and both packages compute from the same state. The functions here
read plain attributes and NumPy arrays; they import nothing from JAX.
"""
from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

# The reference's kernel names -> the port's.
_KERNELS = {"auto": "auto", "scan": "plain", "pallas": "cuda"}


def params_from_reference(ref_params):
    """The port's ``SearchParams`` with a ``libssa_tpu`` params' values."""
    from .search.manager import SearchParams

    kw = {f.name: getattr(ref_params, f.name) for f in fields(SearchParams)}
    kw["kernel"] = _KERNELS.get(kw["kernel"], kw["kernel"])
    return SearchParams(**kw)


def db_from_reference(ref_db):
    """The port's ``SequenceDB`` over a ``libssa_tpu`` database's arrays."""
    from .constants import SymType
    from .io.db import SequenceDB

    return SequenceDB(ref_db.codes, ref_db.offsets, ref_db.lengths, ref_db.headers,
                      SymType[ref_db.symtype.name])


def matrix_from_reference(ref_matrix):
    """The port's ``ScoreMatrix`` with a ``libssa_tpu`` matrix's scores."""
    from .constants import SymType
    from .matrices import ScoreMatrix

    return ScoreMatrix(ref_matrix.name, SymType[ref_matrix.symtype.name], ref_matrix.scores)


def engine_from_reference(ref_engine, device):
    """The port's engine over a ``libssa_tpu`` engine's database and scoring,
    carried into the port's own types."""
    from .search.manager import SearchEngine

    return SearchEngine(
        db_from_reference(ref_engine.db), matrix_from_reference(ref_engine.matrix),
        ref_engine.gap_open, ref_engine.gap_extend,
        params_from_reference(ref_engine.params), device=device,
    )


def stacks_to_device(grouped, device) -> tuple:
    """``SequenceDB.grouped_stacks`` output as device tensors.

    Each group becomes ``(codes (g, n_pad, B) int8, lengths (g, B) int32,
    seq ids (g, B) int32)``, -1 marking padding lanes.
    """
    return tuple(
        (
            torch.as_tensor(np.ascontiguousarray(c, dtype=np.int8)).to(device),
            torch.as_tensor(np.ascontiguousarray(l, dtype=np.int32)).to(device),
            torch.as_tensor(np.stack(sids).astype(np.int32)).to(device),
        )
        for c, l, sids in grouped
    )
