"""The plain reference against the program's own arithmetic and against
brute force, on small sequences."""
import numpy as np
import pytest

from benchmarks.reference import align

RNG = np.random.default_rng(11)
MAT = align.mat(2, 4, 1)


def _cigar_of(ops):
    out = []
    for op in ops:
        if out and out[-1][1] == op:
            out[-1][0] += 1
        else:
            out.append([1, op])
    return [(n, op) for n, op in out]


def _random_alignment(n):
    """A random path: a query, a target and the CIGAR relating them."""
    ops = RNG.choice(list("MMMMMMMMID"), n).tolist()
    cig = _cigar_of(ops)
    if cig[0][1] != "M":
        cig.insert(0, (3, "M"))
    qn = sum(k for k, op in cig if op in "MI")
    tn = sum(k for k, op in cig if op in "MD")
    q = RNG.integers(0, 4, qn).astype(np.uint8)
    t = RNG.integers(0, 4, tn).astype(np.uint8)
    return q, t, cig


@pytest.mark.parametrize("log_gap", [True, False])
def test_replay_equals_the_programs_update_extra(log_gap):
    from minimap2_tpu_torch import native
    for _ in range(40):
        q, t, cig = _random_alignment(int(RNG.integers(5, 300)))
        code = {"M": 0, "I": 1, "D": 2}
        packed = [(n << 4) | code[op] for n, op in cig]
        cig = align.cigar(cig)
        blen, mlen, n_ambi, dp_max, _ = native.update_extra_scan(
            q, t, packed, MAT.reshape(-1).astype(np.int8), 5, 4, 2, log_gap)
        nm, ms = align.replay(cig, q, t, MAT, 4, 2, log_gap)
        assert (nm, ms) == (blen - mlen + n_ambi, dp_max)


def _brute(q, t, qo, e, q2, e2):
    """Full Gotoh DP with two gap pieces (no band)."""
    n, m = len(q), len(t)
    NEG = -10**9
    H = np.full((n + 1, m + 1), NEG)
    E = np.full((2, n + 1, m + 1), NEG)
    F = np.full((2, n + 1, m + 1), NEG)
    gp = [(qo, e), (q2, e2)]
    H[0, 0] = 0
    for i in range(n + 1):
        for j in range(m + 1):
            if i == 0 and j == 0:
                continue
            for k, (o, x) in enumerate(gp):
                if j:
                    E[k, i, j] = max(H[i, j - 1] - o - x, E[k, i, j - 1] - x)
                if i:
                    F[k, i, j] = max(H[i - 1, j] - o - x, F[k, i - 1, j] - x)
            d = H[i - 1, j - 1] + MAT[t[j - 1], q[i - 1]] if i and j else NEG
            H[i, j] = max(d, E[:, i, j].max(), F[:, i, j].max())
    return H[n, m]


def test_parse_cigar():
    n, op = align.parse_cigar("5S120M1I3D10=2X1N4H")
    assert n.tolist() == [5, 120, 1, 3, 10, 2, 1, 4]
    assert "".join(align.OPS[k] for k in op) == "SMIDN=XNH"[:0] + "SMID=XNH"


def test_best_global_equals_brute_force():
    qs, ts = [], []
    for _ in range(6):
        q, t, _ = _random_alignment(int(RNG.integers(3, 40)))
        qs.append(q)
        ts.append(t)
    got = align.best_global(qs, ts, MAT, 4, 2, 24, 1, 64, "cpu")
    want = [_brute(q, t, 4, 2, 24, 1) for q, t in zip(qs, ts)]
    assert got.tolist() == want


def test_a_path_never_beats_the_best_and_the_control_loses():
    q = RNG.integers(0, 4, 200).astype(np.uint8)
    t = q.copy()
    t[::10] = (t[::10] + 1) % 4          # mismatches only
    best = align.best_global([q], [t], MAT, 4, 2, 24, 1, 32, "cpu")[0]
    assert align.path_score(align.cigar([(200, "M")]), q, t, MAT, 4, 2, 24,
                            1) == best
    ctl = align.linear_path(q, t, MAT, 1, 32)
    assert int(ctl[0][ctl[1] <= 1].sum()) == 200
    assert align.path_score(ctl, q, t, MAT, 4, 2, 24, 1) < best


def _judge():
    from benchmarks.reference.check import Judge
    g = {"c0": RNG.integers(0, 4, 5000).astype(np.uint8),
         "c1": RNG.integers(0, 4, 5000).astype(np.uint8)}
    g["c1"][900:1200] = g["c0"][100:400]        # a copy, for secondaries
    sc = {"a": 2, "b": 8, "q": 12, "e": 2, "q2": 24, "e2": 1, "sc_ambi": 1,
          "bw": 100, "log_gap": False}
    return g, Judge(g, sc, {"max_frag_len": 800, "max_gap": 100})


def _rec(name, flag, g, ctg, pos0, n, mate=None, mapq=60):
    """A SAM record of n matches at pos0 (fields up to QUAL dropped as the
    sink drops them), with its read bases as sequenced."""
    from benchmarks.reference.check import revcomp
    t = g[ctg][pos0:pos0 + n]
    rnext, pnext = ("*", "0") if mate is None else (
        "=" if mate[0] == ctg else mate[0], str(mate[1] + 1))
    f = [name, str(flag), ctg, str(pos0 + 1), str(mapq), f"{n}M", rnext,
         pnext, "0", "NM:i:0", f"ms:i:{2 * n}"]
    return f, (revcomp(t) if flag & 16 else t)


@pytest.mark.parametrize("where,proper", [
    (("c0", 100, "c0", 400), True),       # FR, 150 bp apart
    (("c0", 100, "c0", 1200), False),     # past the pairing gap
    (("c0", 400, "c0", 100), False),      # RF
    (("c0", 100, "c1", 400), False)])     # two contigs
def test_the_proper_pair_flag_is_judged_by_the_fr_rule(where, proper):
    g, judge = _judge()
    c1, p1, c2, p2 = where
    base = 1 | 2
    f1, r1 = _rec("p", base | 0x40 | 0x20, g, c1, p1, 150, (c2, p2))
    f2, r2 = _rec("p", base | 0x80 | 0x10, g, c2, p2, 150, (c1, p1))
    truths = [(0, p1, p1 + 150, 0), (0, p2, p2 + 150, 1)]
    _, bad = judge.unit([f1, f2], [r1, r2], truths, False)
    assert (bad == 0) == proper and not judge.bad


def test_a_secondary_at_its_primary_or_above_mapq_0_is_bad():
    g, judge = _judge()
    pri = _rec("r", 0, g, "c0", 100, 300)
    ok = _rec("r", 0x100, g, "c1", 900, 300, mapq=0)
    judge.unit([pri[0], ok[0]], [pri[1]], [(0, 100, 400, 0)], False)
    assert not judge.bad
    same = _rec("r", 0x100, g, "c0", 100, 300, mapq=0)
    high = _rec("r", 0x100, g, "c1", 900, 300, mapq=7)
    judge.unit([pri[0], same[0], high[0]], [pri[1]], [(0, 100, 400, 0)],
               False)
    assert [why for _, why in judge.bad] == ["secondary at its primary",
                                            "secondary mapq 7"]
