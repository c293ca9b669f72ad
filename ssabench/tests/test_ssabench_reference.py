"""The plain reference against a brute-force scalar DP at tiny sizes."""
import numpy as np
import pytest
import torch

from ssabench.reference import alignment, dp, scoring

NEG = -(10**9)


def scalar(q, s, sub, Q, R, local):
    """Gotoh's recurrences cell by cell, in Python numbers: (score, H, E, F)."""
    m, n = len(q), len(s)
    H = [[NEG] * (n + 1) for _ in range(m + 1)]
    E = [[NEG] * (n + 1) for _ in range(m + 1)]
    F = [[NEG] * (n + 1) for _ in range(m + 1)]
    H[0][0] = 0
    for j in range(1, n + 1):
        H[0][j] = 0 if local else -(Q + (j - 1) * R)
    for i in range(1, m + 1):
        H[i][0] = 0 if local else -(Q + (i - 1) * R)
        for j in range(1, n + 1):
            E[i][j] = max(E[i][j - 1] - R, H[i][j - 1] - Q)
            F[i][j] = max(F[i - 1][j] - R, H[i - 1][j] - Q)
            h = max(H[i - 1][j - 1] + sub[q[i - 1]][s[j - 1]], E[i][j], F[i][j])
            H[i][j] = max(h, 0) if local else h
    best = max(max(r) for r in H) if local else H[m][n]
    return best, H


def traceback(q, s, sub, Q, R, H, local):
    """One optimal path of the scalar DP (any tie order): (q_begin, q_end,
    s_begin, s_end, cigar), from a plain cell-by-cell search."""
    m, n = len(q), len(s)
    if local:
        i, j = max(((i, j) for i in range(m + 1) for j in range(n + 1)), key=lambda c: H[c[0]][c[1]])
    else:
        i, j = m, n
    qe, se, ops = i, j, []
    while i > 0 or j > 0:
        if local and H[i][j] == 0:
            break
        if i and j and H[i][j] == H[i - 1][j - 1] + sub[q[i - 1]][s[j - 1]]:
            ops.append("M"); i -= 1; j -= 1
            continue
        for L in range(1, i + 1):  # a vertical gap of length L ending here
            if H[i][j] == H[i - L][j] - Q - R * (L - 1):
                ops += ["D"] * L; i -= L
                break
        else:
            for L in range(1, j + 1):
                if H[i][j] == H[i][j - L] - Q - R * (L - 1):
                    ops += ["I"] * L; j -= L
                    break
            else:
                raise AssertionError("no predecessor")
    return i, qe, j, se, "".join(reversed(ops))


def draw(rng, a, lo, hi):
    return rng.integers(0, a, int(rng.integers(lo, hi))).astype(np.uint8)


@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("gaps", [(12, 1), (11, 2), (5, 5), (20, 1)])
def test_database_sweep_equals_scalar(local, gaps):
    Q, R = gaps
    rng = np.random.default_rng(hash((local, gaps)) % 2**32)
    sub = scoring.substitution({"matrix": "BLOSUM62"})
    for _ in range(6):
        qs = [draw(rng, 20, 1, 12) for _ in range(3)]  # side by side, of other lengths
        subs = [draw(rng, 20, 1, 16) for _ in range(7)]
        lens = np.array([len(x) for x in subs])
        offs = np.concatenate(([0], np.cumsum(lens)[:-1]))
        db = dp.Database(np.concatenate(subs), offs, lens, 20, "cpu")
        got = db.scores(qs, sub, Q, R, local)
        for q, row in zip(qs, got):
            assert list(row) == [scalar(q, x, sub.tolist(), Q, R, local)[0] for x in subs]


@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("max_cells", [1, 1 << 28])
def test_queries_side_by_side_equal_one_at_a_time(local, max_cells):
    """Queries of many lengths (one empty) swept together, or one a sweep
    where ``max_cells`` allows no more, score as each does alone."""
    rng = np.random.default_rng(31 + local)
    sub = scoring.substitution({"matrix": "BLOSUM62"})
    qs = [draw(rng, 20, 1, 60) for _ in range(5)] + [np.zeros(0, np.uint8)]
    subs = [draw(rng, 20, 1, 90) for _ in range(40)]
    lens = np.array([len(x) for x in subs])
    offs = np.concatenate(([0], np.cumsum(lens)[:-1]))
    db = dp.Database(np.concatenate(subs), offs, lens, 20, "cpu")
    got = db.scores(qs, sub, 12, 1, local, max_cells=max_cells)
    assert got.shape == (6, 40)
    for q, row in zip(qs, got):
        assert (row == db.scores([q], sub, 12, 1, local)[0]).all()
    assert (got[-1] == (0 if local else -(12 + lens - 1))).all()


def test_buckets_hold_every_id_once_and_bound_their_width():
    lengths = np.random.default_rng(1).integers(1, 500, 1000)
    groups = dp.buckets(lengths, widen=1.05, max_cells=4000)
    ids = np.concatenate(groups)
    assert sorted(ids) == list(range(1000))
    for g in groups:
        assert lengths[g].max() <= 1.05 * max(lengths[g].min(), 1) or len(g) == 1
        assert len(g) * lengths[g].max() <= 4000 or len(g) == 1


@pytest.mark.parametrize("local", [True, False])
def test_blocked_prefix_maximum_equals_one_scan(local):
    rng = np.random.default_rng(21 + local)
    sub = scoring.substitution({"match": 10, "mismatch": -8})
    for _ in range(4):
        q, s = draw(rng, 4, 200, 400), draw(rng, 4, 300, 500)
        one = dp.pair_score(q, s, sub, 20, 1, local, "cpu", blocks=1)
        assert dp.pair_score(q, s, sub, 20, 1, local, "cpu", blocks=4) == one


def test_top_hits_order():
    scores = np.array([5, 9, 9, 1, 9])
    assert dp.top_hits(scores, 3) == [(1, 9), (2, 9), (4, 9)]


@pytest.mark.parametrize("saturate,cap", [("sat8", 255), ("sat16", 32767)])
def test_control_saturates(saturate, cap):
    rng = np.random.default_rng(5)
    sub = scoring.substitution({"match": 10, "mismatch": -8})
    q = rng.integers(0, 4, 4000).astype(np.uint8)
    exact = dp.pair_score(q, q, sub, 20, 1, True, "cpu")
    assert exact == 40000
    assert dp.pair_score(q, q, sub, 20, 1, True, "cpu", saturate) == cap
    assert dp.pair_score(q[:20], q[:20], sub, 20, 1, True, "cpu", saturate) == 200


@pytest.mark.parametrize("local", [True, False])
def test_rescore_scalar_paths(local):
    rng = np.random.default_rng(7)
    sub = scoring.substitution({"matrix": "BLOSUM62"})
    for _ in range(30):
        q, s = draw(rng, 20, 1, 14), draw(rng, 20, 1, 14)
        score, H = scalar(q, s, sub.tolist(), 12, 1, local)
        qb, qe, sb, se, cigar = traceback(q, s, sub.tolist(), 12, 1, H, local)
        assert alignment.rescore(q, s, sub, 12, 1, qb, qe, sb, se, cigar, local) == score
        runs = "".join(f"{len(g)}{g[0]}" for g in __import__("re").findall(r"M+|D+|I+", cigar))
        assert alignment.rescore(q, s, sub, 12, 1, qb, qe, sb, se, runs, local) == score


def test_rescore_refuses_malformed_paths():
    sub = scoring.substitution({"matrix": "BLOSUM62"})
    q = s = np.arange(5, dtype=np.uint8)
    assert alignment.rescore(q, s, sub, 12, 1, 0, 5, 0, 5, "MMMMM", False) == int(np.trace(sub[:5, :5]))
    assert alignment.rescore(q, s, sub, 12, 1, 0, 5, 0, 5, "MMMM", False) is None
    assert alignment.rescore(q, s, sub, 12, 1, 1, 5, 1, 5, "MMMM", False) is None  # NW spans all
    assert alignment.rescore(q, s, sub, 12, 1, 0, 5, 0, 5, "MMXMM", False) is None
    assert alignment.rescore(q, s, sub, 12, 1, 0, 4, 0, 5, "MMMMI", True) == int(
        np.trace(sub[:4, :4])) - 12


def emboss_scalar(q, s, local):
    """EMBOSS's own units: +5/-4, a gap of L costs 10 + 0.5 (L - 1)."""
    sub = [[5.0 if a == b else -4.0 for b in range(4)] for a in range(4)]
    return scalar(q, s, sub, 10.0, 0.5, local)


@pytest.mark.parametrize("local", [True, False])
def test_emboss_scaling_keeps_the_optimal_alignments(local):
    """Doubled integer scores give twice EMBOSS's optimum, and an optimal
    path of the doubled scoring is optimal in EMBOSS's units."""
    rng = np.random.default_rng(11 + local)
    sub2 = scoring.substitution({"match": 10, "mismatch": -8})
    sub_e = sub2 / 2.0
    Q, R = scoring.gap_qr(20, 1, False)
    assert (Q, R) == (20, 1)
    for _ in range(25):
        q, s = draw(rng, 4, 1, 13), draw(rng, 4, 1, 13)
        best_e, _ = emboss_scalar(q, s, local)
        got = dp.pair_score(q, s, sub2, Q, R, local, "cpu")
        assert got == 2 * best_e
        score, H = scalar(q, s, sub2.tolist(), Q, R, local)
        qb, qe, sb, se, cigar = traceback(q, s, sub2.tolist(), Q, R, H, local)
        ops = alignment.expand(cigar)
        # re-score the path in EMBOSS units: it reaches EMBOSS's optimum
        m_col = ops == ord("M")
        qi = qb + np.cumsum((ops == ord("M")) | (ops == ord("D"))) - 1
        sj = sb + np.cumsum((ops == ord("M")) | (ops == ord("I"))) - 1
        e_score = float(sub_e[q[qi[m_col]], s[sj[m_col]]].sum())
        for g in (ops == ord("D"), ops == ord("I")):
            opens = int((g & ~np.concatenate(([False], g[:-1]))).sum())
            e_score -= opens * (10 - 0.5) + 0.5 * int(g.sum())
        assert e_score == best_e


def test_the_ports_gap_convention_maps_the_configuration():
    """init_gap_penalties(20, 1, first_residue_opens=False) is Q = 20, R = 1 in
    the port, and its score of a pair is the reference's."""
    from libssa_tpu_torch import oracle

    assert oracle.gap_qr(20, 1, False) == scoring.gap_qr(20, 1, False) == (20, 1)
    assert oracle.gap_qr(11, 1, True) == scoring.gap_qr(11, 1, True) == (12, 1)
    rng = np.random.default_rng(3)
    sub = scoring.substitution({"match": 10, "mismatch": -8})
    for _ in range(10):
        q, s = draw(rng, 4, 1, 30), draw(rng, 4, 1, 30)
        assert oracle.sw_score(q, s, sub, 20, 1, False) == dp.pair_score(q, s, sub, 20, 1, True, "cpu")
        assert oracle.nw_score(q, s, sub, 20, 1, False) == dp.pair_score(q, s, sub, 20, 1, False, "cpu")


def test_frozen_tables_match_the_ports():
    from libssa_tpu_torch import alphabet, matrices
    from libssa_tpu_torch.constants import AA_ALPHABET, NT_ALPHABET, SymType

    assert AA_ALPHABET.startswith(scoring.AA_LETTERS) and NT_ALPHABET.startswith(scoring.NT_LETTERS)
    assert (matrices.builtin("BLOSUM62").scores[:20, :20] == scoring.MATRICES["BLOSUM62"]).all()
    nt = matrices.constant_scoring(10, -8, SymType.NUCLEOTIDE).scores[:4, :4]
    assert (nt == scoring.substitution({"match": 10, "mismatch": -8})).all()
    codes = np.arange(20, dtype=np.uint8)
    assert (alphabet.encode(scoring.decode(codes, "aminoacid"), SymType.AMINOACID) == codes).all()
    assert (alphabet.encode(scoring.decode(codes[:4], "nucleotide"), SymType.NUCLEOTIDE) == codes[:4]).all()


def test_sweep_runs_on_any_torch_device_given():
    codes = torch.zeros((2, 3), dtype=torch.uint8)
    out = dp.sweep([np.zeros(2, np.uint8)], codes, torch.tensor([3, 2]),
                   scoring.substitution({"match": 10, "mismatch": -8}), 20, 1, True)
    assert out.tolist() == [[20, 20]]
