// Native Myers-Miller LEAF solver: direction-matrix Gotoh fill + walk.
//
// Counterpart of the reference's scalar aligner (src/algo/aligner.c,
// SURVEY.md §3.3 — full DP with direction bits for bounded problems).
// Here it solves the O(LEAF_CELLS) leaf subproblems of the huge-pair
// Myers-Miller traceback (search/hirschberg.py): profiling showed the
// NumPy leaf fill (_ops_small) pays ~60 us of interpreter overhead PER
// DP ROW, and the total leaf row count equals the query length no
// matter how the leaves are sized — so a 30k x 30k NW traceback spent
// 2.0 of its 2.7 warm seconds in leaf fills at ~15 Mcells/s. This fill
// runs the identical recurrences, tie-breaks, and boundary contract at
// C speed; _ops_small remains the Python fallback and the differential
// oracle (tests/test_torch_hirschberg.py).
//
// Semantics mirrored EXACTLY from hirschberg._ops_small (min-cost form,
// gap(L) = g + h*L):
//   * boundary contract: a vertical run hugging the top-left corner
//     opens at tb, one hugging the bottom-right corner opens at te
//     (g for a fresh gap, 0 when the parent's gap crosses the boundary);
//   * E via the standard row recurrence E[j] = min(E[j-1], C[j-1]+g)+h,
//     value-equal to _ops_small's lazy prefix-min for g >= 0 (extending
//     through an E-sourced C cell is never strictly better than
//     continuing the same horizontal gap);
//   * tie-breaks: C prefers diagonal, then D, then E; Dopen/Eopen flag
//     equality with the "freshly opened" candidate; the te tail scan
//     takes the FIRST minimum (np.argmin).
//
// Build: at first use by the host C++ compiler (util/cudabuild.load_native,
// into build/libssa_tpu_torch/); loaded via ctypes in search/leafnative.py.

#include <cstdint>
#include <cstdlib>
#include <vector>

namespace {
constexpr int64_t INF = int64_t(1) << 60;
}

extern "C" int64_t leaf_ops(
    const int64_t* cost, int32_t A,   // (A, A) row-major substitution COST
    const int32_t* q, int64_t m,      // query codes (< A)
    const int32_t* s, int64_t n,      // subject codes (< A)
    int64_t g, int64_t h,             // gap open (beyond first), extend
    int64_t tb, int64_t te,           // boundary vertical-gap opens
    uint8_t* ops_out                  // capacity m + n; 'M'/'D'/'I'
) {
    if (m <= 0 || n <= 0 || A <= 0) return -1;
    std::vector<int64_t> C_prev(n + 1), C_cur(n + 1), D(n + 1);
    std::vector<int64_t> CcolN(m + 1);
    // dir byte: bits 0-1 = Cdir (0 diag, 1 from D, 2 from E),
    //           bit 2 = Dopen, bit 3 = Eopen.
    std::vector<uint8_t> dir((size_t)m * (size_t)n);

    C_prev[0] = 0;
    for (int64_t j = 1; j <= n; ++j) C_prev[j] = g + h * j;
    D[0] = tb;
    for (int64_t j = 1; j <= n; ++j) D[j] = C_prev[j] + g;
    CcolN[0] = C_prev[n];

    for (int64_t i = 1; i <= m; ++i) {
        const int64_t* crow = cost + (size_t)q[i - 1] * (size_t)A;
        const int64_t c0 = tb + h * i;
        C_cur[0] = c0;
        int64_t E = INF;
        uint8_t* drow = dir.data() + (size_t)(i - 1) * (size_t)n;
        for (int64_t j = 1; j <= n; ++j) {
            const int64_t open_d = C_prev[j] + g + h;
            const int64_t dv = (D[j] + h < open_d) ? D[j] + h : open_d;
            D[j] = dv;
            const uint8_t dopen = (dv == open_d) ? 1 : 0;
            const int64_t cand = C_prev[j - 1] + crow[s[j - 1]];
            const int64_t cnof = (dv < cand) ? dv : cand;
            const int64_t open_e = C_cur[j - 1] + g + h;
            const int64_t ev = (E + h < open_e) ? E + h : open_e;
            E = ev;
            const uint8_t eopen = (ev == open_e) ? 1 : 0;
            const int64_t cv = (cnof < ev) ? cnof : ev;
            C_cur[j] = cv;
            uint8_t cdir;
            if (cv == cand) cdir = 0;          // diagonal wins ties
            else if (cv == dv) cdir = 1;       // then the delete state
            else cdir = 2;                     // then the insert state
            drow[j - 1] =
                (uint8_t)(cdir | (dopen << 2) | (eopen << 3));
        }
        CcolN[i] = C_cur[n];
        C_prev.swap(C_cur);
    }
    // C_prev now holds row m.

    // te contract: a trailing delete run of length k ending at (m, n)
    // costs te + k*h above CcolN[m-k]; FIRST minimum (np.argmin).
    int64_t i = m, j = n;
    size_t pos = 0;  // ops written (reverse order)
    {
        int64_t best = INF, kbest = 1;
        for (int64_t k = 1; k <= m; ++k) {
            const int64_t t = CcolN[m - k] + te + k * h;
            if (t < best) { best = t; kbest = k; }
        }
        if (best < C_prev[n]) {
            for (int64_t k = 0; k < kbest; ++k) ops_out[pos++] = 'D';
            i -= kbest;
        }
    }
    int state = 0;  // 0 = C, 1 = D, 2 = E
    while (i > 0 && j > 0) {
        const uint8_t b = dir[(size_t)(i - 1) * (size_t)n + (size_t)(j - 1)];
        if (state == 0) {
            const int d = b & 3;
            if (d == 0) { ops_out[pos++] = 'M'; --i; --j; }
            else if (d == 1) state = 1;
            else state = 2;
        } else if (state == 1) {
            ops_out[pos++] = 'D';
            const int opened = (b >> 2) & 1;
            --i;
            if (opened) state = 0;
        } else {
            ops_out[pos++] = 'I';
            const int opened = (b >> 3) & 1;
            --j;
            if (opened) state = 0;
        }
    }
    while (i-- > 0) ops_out[pos++] = 'D';
    while (j-- > 0) ops_out[pos++] = 'I';
    // Reverse in place -> forward order.
    for (size_t a = 0, b2 = pos ? pos - 1 : 0; a < b2; ++a, --b2) {
        const uint8_t t = ops_out[a];
        ops_out[a] = ops_out[b2];
        ops_out[b2] = t;
    }
    return (int64_t)pos;
}
