"""The output check: the program's SAM records of the window judged against
the genome and the truth the benchmark drew, with the plain arithmetic of
reference/align.py.  Imports nothing of the program.

For every pool unit (a read, or a pair's fragment) written in the window,
each time it is written:
  missing      units the stream skipped (an answer that never came)
  bad_records  mapped records whose CIGAR does not span the read or lies
               off its contig, or whose NM:i or ms:i differ from the
               replay of the CIGAR over the read and the genome; secondary
               records (0x100) with a mapping quality other than 0, or at
               their primary's contig, strand and start
  bad_mates    pairs whose mate fields (0x1, RNEXT, PNEXT, 0x20, 0x8, the
               shared 0x2) disagree with the mate's own primary record, or
               whose proper-pair flag (0x2) is set on primaries that are
               no FR pair within the pairing gap (mm_pair's rule: the
               reverse mate starts at or after the forward mate, at most
               max(max_frag_len - both read lengths, max_gap) past its end)
  off_truth_pct  reads whose primary is missing, unmapped, or not on the
               contig, strand and interval the read was drawn from
  mapq60_off_pct  primaries of mapping quality 60 that are off their truth,
               over all primaries of mapping quality 60
  unpaired_pct  pairs whose primaries both lie on the FR fragment they
               were drawn from (a proper pair) without 0x2, over all such
               pairs
For a sample of units, drawn from the seed, the first time each is written:
  score_gap    the widest gap by which a primary's path scores below the
               best global alignment of the same read bases to the same
               genome bases (reference/align.best_global)
"""
from __future__ import annotations

import numpy as np

from . import align

COMP = np.array([3, 2, 1, 0, 4], np.uint8)


def revcomp(x):
    return COMP[x[::-1]]


def _tags(f):
    out = {}
    for t in f[9:]:
        if len(t) > 5 and t[3] == "i":
            out[t[:2]] = int(t[5:])
    return out


class Judge:
    """Judges records against ``genome`` (contig name -> host nt4 codes,
    in contig order: a truth names its contig by that order) under the
    configuration's scoring (its band bw is the reference DP's)."""

    def __init__(self, genome, sc, pairing=None):
        self.genome = genome
        self.pairing = pairing or {}
        self.names = list(genome)
        self.m = align.mat(sc["a"], sc["b"], sc["sc_ambi"])
        self.sc = sc
        self.log_gap = sc["log_gap"]
        self.band = sc["bw"]
        self.bad = []
        self.gap_jobs = []          # (qseg, tseg, program's path score)
        self.n = {"q60": 0, "q60_off": 0, "pairs_on": 0, "unpaired": 0}

    def record(self, f, read):
        """Check one mapped record's CIGAR against its read (nt4 codes as
        sequenced) and the genome; returns (rname, start, end, rev, qseg,
        tseg, cigar) or None when it fails."""
        flag = int(f[1])
        rname, pos0 = f[2], int(f[3]) - 1
        n, op = align.parse_cigar(f[5])
        q = revcomp(read) if flag & 16 else read
        clip = (op == 4) | (op == 5)
        clip5 = int(n[0]) if len(op) and clip[0] else 0
        clip3 = int(n[-1]) if len(op) > 1 and clip[-1] else 0
        body = (n[op < 4], op[op < 4]) if not (op >= 7).any() else \
            (n[(op < 4) | (op >= 7)], op[(op < 4) | (op >= 7)])
        mq = (op == 0) | (op == 1) | (op >= 7)
        mt = (op == 0) | (op == 2) | (op == 3) | (op >= 7)
        qc, tc = int(n[mq].sum()), int(n[mt].sum())
        g = self.genome.get(rname)
        if (g is None or clip5 + qc + clip3 != len(read) or pos0 < 0
                or pos0 + tc > len(g) or not len(body[0])):
            self.bad.append((f[0], "span"))
            return None
        qseg, tseg = q[clip5:clip5 + qc], g[pos0:pos0 + tc]
        nm, ms = align.replay(body, qseg, tseg, self.m, self.sc["q"],
                              self.sc["e"], self.log_gap)
        tg = _tags(f)
        if tg.get("NM") != nm or tg.get("ms") != ms:
            self.bad.append((f[0], f"NM {tg.get('NM')}/{nm} ms "
                             f"{tg.get('ms')}/{ms}"))
            return None
        return rname, pos0, pos0 + tc, bool(flag & 16), qseg, tseg, body

    def unit(self, recs, reads, truths, sampled: bool):
        """Judge one unit's records; reads and truths per segment (1 or 2).
        Returns (segments off their truth, bad mates)."""
        prim, sec = {}, []
        for f in recs:
            flag = int(f[1])
            seg = 1 if flag & 0x80 else 0
            if seg >= len(reads):
                self.bad.append((f[0], "segment"))
                continue
            if flag & 4:
                if not flag & 0x900:
                    prim.setdefault(seg, (f, None))
                continue
            got = self.record(f, reads[seg])
            if flag & 0x100:
                sec.append((seg, f, got))
            if not flag & 0x900:
                prim.setdefault(seg, (f, got))
                if got is not None and sampled:
                    sc = self.sc
                    self.gap_jobs.append((got[4], got[5], align.path_score(
                        got[6], got[4], got[5], self.m, sc["q"], sc["e"],
                        sc["q2"], sc["e2"])))
        for seg, f, got in sec:
            p = prim.get(seg, (None, None))[1]
            if int(f[4]) != 0:
                self.bad.append((f[0], f"secondary mapq {f[4]}"))
            elif got is not None and p is not None \
                    and got[:2] == p[:2] and got[3] == p[3]:
                self.bad.append((f[0], "secondary at its primary"))
        off = 0
        on = []
        for s, (c, st, en, minus) in enumerate(truths):
            f, got = prim.get(s, (None, None))
            ok = not (got is None or got[0] != self.names[c]
                      or got[3] != bool(minus)
                      or got[2] <= st or got[1] >= en)
            off += not ok
            on.append(ok)
            if got is not None and int(f[4]) >= 60:
                self.n["q60"] += 1
                self.n["q60_off"] += not ok
        if len(reads) != 2:
            return off, 0
        if all(on):
            self.n["pairs_on"] += 1
            self.n["unpaired"] += not int(prim[0][0][1]) & 2
        return off, self.mates(prim, [len(r) for r in reads])

    def proper(self, prim, qlens):
        """Whether a pair's two parsed primaries are an FR pair within the
        pairing gap (mm_pair's condition on the pair it marks proper)."""
        a, b = prim[0][1], prim[1][1]
        if a is None or b is None or a[0] != b[0] or a[3] == b[3]:
            return False
        fw, rv = (b, a) if a[3] else (a, b)
        pr = self.pairing
        gap = max(pr["max_frag_len"] - sum(qlens), pr["max_gap"])
        return fw[1] <= rv[1] and rv[1] - fw[2] <= gap

    def mates(self, prim, qlens):
        """Mate-field faults of a pair's two primaries (0 or 1)."""
        if 0 not in prim or 1 not in prim:
            return 1
        a, b = prim[0][0], prim[1][0]
        fa, fb = int(a[1]), int(b[1])
        if not (fa & 1 and fb & 1 and fa & 0x40 and fb & 0x80):
            return 1
        if (fa & 2) != (fb & 2):
            return 1
        if fa & 2 and not self.proper(prim, qlens):
            return 1
        for x, fx, y, fy in ((a, fa, b, fb), (b, fb, a, fa)):
            if fy & 4:
                if not fx & 8:
                    return 1
                continue
            if fx & 4:
                continue
            rnext = "=" if y[2] == x[2] else y[2]
            if x[6] != rnext or x[7] != y[3] or bool(fx & 0x20) != bool(
                    fy & 0x10) or fx & 8:
                return 1
        return 0

    def score_gap(self, device, control: bool = False):
        """The widest best-global-minus-path gap over the sampled primaries
        (the control's paths in place of the program's with control)."""
        if not self.gap_jobs:
            return None
        sc = self.sc
        qs = [j[0] for j in self.gap_jobs]
        ts = [j[1] for j in self.gap_jobs]
        best = align.best_global(qs, ts, self.m, sc["q"], sc["e"], sc["q2"],
                                 sc["e2"], self.band, device)
        if control:
            g = min(sc["e"], sc["e2"])
            paths = [align.path_score(align.linear_path(
                q, t, self.m, g, self.band), q, t, self.m, sc["q"], sc["e"],
                sc["q2"], sc["e2"]) for q, t in zip(qs, ts)]
        else:
            paths = [j[2] for j in self.gap_jobs]
        return int(max(int(b) - int(p) for b, p in zip(best, paths)))
