"""Index side data (copy of minimap2_tpu.index.sidedata): BED junctions
(--junc-bed), splice scores (--spsc), ALT contigs (--alt) and jump
junctions (-j, --pass1).  Reference: index.c:648-1074."""
from __future__ import annotations

import gzip

import numpy as np


class BedIntervals:
    """Per-contig sorted (st, en, score, strand) intervals (mm_idx_intv_t)."""

    def __init__(self, n_seq):
        self.per_ctg = [[] for _ in range(n_seq)]

    def junc(self, ctg, st, en):
        """mm_idx_bed_junc (index.c:803-826): per-position donor/acceptor flags."""
        out = np.zeros(en - st, dtype=np.uint8)
        for (s, e, sc, strand) in self.per_ctg[ctg]:
            if e <= st or s >= en:
                continue
            # donor/acceptor flag encoding (index.c:810-824)
            if strand > 0:
                if st <= s - 1 < en:
                    out[s - 1 - st] |= 2
                if st <= e < en:
                    out[e - st] |= 8
            elif strand < 0:
                if st <= s - 1 < en:
                    out[s - 1 - st] |= 4
                if st <= e < en:
                    out[e - st] |= 1
        return out


def read_bed_junc(path, mi):
    iv = BedIntervals(mi.n_seq)
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        for line in f:
            if not line.strip() or line.startswith(("#", "track", "browser")):
                continue
            fl = line.rstrip("\n").split("\t")
            cid = mi.name2id(fl[0])
            if cid < 0:
                continue
            st, en = int(fl[1]), int(fl[2])
            score = int(fl[4]) if len(fl) > 4 and fl[4].isdigit() else 0
            strand = 0
            if len(fl) > 5:
                strand = 1 if fl[5] == "+" else -1 if fl[5] == "-" else 0
            if len(fl) >= 12:  # BED12: emit introns between blocks
                n_blk = int(fl[9])
                sizes = [int(x) for x in fl[10].rstrip(",").split(",")]
                starts = [int(x) for x in fl[11].rstrip(",").split(",")]
                for b in range(n_blk - 1):
                    ist = st + starts[b] + sizes[b]
                    ien = st + starts[b + 1]
                    iv.per_ctg[cid].append((ist, ien, score, strand))
            else:
                iv.per_ctg[cid].append((st, en, score, strand))
    for lst in iv.per_ctg:
        lst.sort()
    return iv


def read_alt(path, mi) -> int:
    """mm_idx_alt_read (index.c:648-670): flag ALT contigs by name; returns
    the number of names found (MiniIndex.n_alt counts the contigs)."""
    op = gzip.open if path.endswith(".gz") else open
    n_alt = 0
    with op(path, "rt") as f:
        for line in f:
            name = line.split()[0] if line.split() else ""
            cid = mi.name2id(name)
            if cid >= 0:
                mi.seq[cid].is_alt = True
                n_alt += 1
    return n_alt


class SpliceScores:
    """mm_idx_spsc_t tables (index.c:965-1074): per (contig, strand) sorted
    pos<<8 | (score+64)<<1 | acceptor records; .get fills the per-position
    score array consumed by the splice extension kernel."""

    KSW_SPSC_OFFSET = 64

    def __init__(self, n_seq):
        self.tab = [[] for _ in range(n_seq * 2)]
        self.sorted = False

    def _finish(self):
        if not self.sorted:
            for t in self.tab:
                t.sort()
            self.sorted = True

    def get(self, cid, st, en, rev):
        """mm_idx_spsc_get (index.c:1054-1074)."""
        import bisect
        self._finish()
        sc = np.full(en - st, 0xFF, np.uint8)
        a = self.tab[(cid << 1) | (1 if rev else 0)]
        if a:
            lo = bisect.bisect_right(a, (st << 8) | 0x1FF) - 1
            hi = bisect.bisect_right(a, (en << 8) | 0x1FF) - 1
            for j in range(lo + 1, hi + 1):
                x = (a[j] >> 8) - st
                score = a[j] & 0xFF
                if x == en - st:
                    continue
                if sc[x] == 0xFF or sc[x] < score:
                    sc[x] = score
        return sc


def read_spsc(path, mi, max_sc: int, scale: float) -> int:
    """mm_idx_spsc_read2 (index.c:970-1037).

    Input lines: ctg  pos  strand(+/-)  type(D/A)  score."""
    max_sc = min(max_sc, 63)
    sp = SpliceScores(mi.n_seq)
    n_read = 0
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        for line in f:
            fl = line.rstrip("\n").split("\t")
            if len(fl) < 5:
                continue
            name, pos, strand_s, type_s, score = (
                fl[0], int(fl[1]), fl[2], fl[3], int(float(fl[4])))
            strand = 1 if strand_s == "+" else -1 if strand_s == "-" else 0
            ty = 0 if type_s == "D" else 1 if type_s == "A" else -1
            if 0.0 < scale < 1.0:
                score = int(score * scale + 0.499) if score > 0 \
                    else int(score * scale - 0.499)
            score = max(-max_sc, min(score, max_sc))
            cid = mi.name2id(name)
            if cid < 0 or ty < 0 or strand == 0 or pos < 0:
                continue
            if 0 < pos < mi.seq[cid].length:
                sp.tab[(cid << 1) | (0 if strand > 0 else 1)].append(
                    (pos << 8) | ((score + SpliceScores.KSW_SPSC_OFFSET) << 1)
                    | ty)
                n_read += 1
    mi.spsc = sp
    return n_read


def read_bed_merge(path, mi, read_junc: bool, min_sc: int):
    """mm_idx_bed_read_merge (index.c:683-795): per-contig (st, en, score,
    strand, cnt) interval lists, sorted by (st, en), duplicates merged
    with cnt = multiplicity."""
    per_ctg = [[] for _ in range(mi.n_seq)]
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        for line in f:
            fl = line.rstrip("\n").split("\t")
            if len(fl) < 3 or not fl[1].lstrip("-").isdigit():
                continue
            cid = mi.name2id(fl[0])
            if cid < 0:
                continue
            st, en = int(fl[1]), int(fl[2])
            score = int(fl[4]) if len(fl) > 4 and fl[4][:1].isdigit() else -1
            strand = 0
            if len(fl) > 5:
                strand = 1 if fl[5] == "+" else -1 if fl[5] == "-" else 0
            if st < 0 or st >= en:
                continue
            if min_sc > 0 and score < min_sc:
                continue
            if len(fl) >= 12 and read_junc:    # BED12 -> introns
                n_blk = int(fl[9])
                sizes = [int(x) for x in fl[10].rstrip(",").split(",")]
                starts = [int(x) for x in fl[11].rstrip(",").split(",")]
                en_b = st + starts[0] + sizes[0]
                for b in range(1, n_blk):
                    ist, ien = en_b, st + starts[b]
                    en_b = st + starts[b] + sizes[b]
                    if ien > ist:
                        per_ctg[cid].append([ist, ien, score, strand, 0])
            else:
                per_ctg[cid].append([st, en, score, strand, 0])
    out = []
    for lst in per_ctg:
        lst.sort(key=lambda t: (t[0], t[1]))
        merged = []
        j0 = 0
        for j in range(1, len(lst) + 1):
            if j == len(lst) or lst[j][0] != lst[j0][0] \
                    or lst[j][1] != lst[j0][1]:
                rec = lst[j0][:]
                rec[4] = j - j0
                merged.append(rec)
                j0 = j
        out.append(merged)
    return out


class JJump:
    """mm_idx_jjump_t (index.c:45-48, 832-930): per-contig sorted jump
    records (off, off2, cnt, strand, flag), both intron directions."""

    def __init__(self, n_seq):
        self.per_ctg = [[] for _ in range(n_seq)]

    @staticmethod
    def _sort_merge(lst):
        lst.sort(key=lambda t: (t[0], t[1]))
        merged = []
        j0 = 0
        for j in range(1, len(lst) + 1):
            if j == len(lst) or lst[j][0] != lst[j0][0] \
                    or lst[j][1] != lst[j0][1]:
                cnt = sum(t[2] for t in lst[j0:j])
                flag = 0
                for t in lst[j0:j]:
                    flag |= t[4]
                merged.append((lst[j0][0], lst[j0][1], cnt, lst[j0][3],
                               flag))
                j0 = j
        return merged

    def add_intervals(self, intervals, flag):
        """mm_idx_bed2jjump + jjump_merge (index.c:865-930)."""
        for cid, intv in enumerate(intervals):
            lst = list(self.per_ctg[cid])
            for st, en, score, strand, cnt in intv:
                lst.append((st, en, cnt, strand, flag))
                lst.append((en, st, cnt, strand, flag))
            self.per_ctg[cid] = self._sort_merge(lst)

    def get(self, cid, st, en):
        """mm_idx_jump_get (index.c:946-959): records with off in (st, en]."""
        import bisect
        if cid < 0 or cid >= len(self.per_ctg):
            return []
        a = self.per_ctg[cid]
        if not a:
            return []
        lo = bisect.bisect_right(a, (st,) + (float("inf"),)) - 1
        hi = bisect.bisect_right(a, (en,) + (float("inf"),)) - 1
        return a[lo + 1:hi + 1]


def jjump_read(path, mi, flag: int, min_sc: int) -> None:
    """mm_idx_jjump_read (index.c:905-930)."""
    intervals = read_bed_merge(path, mi, True, min_sc)
    if mi.jumps is None:
        mi.jumps = JJump(mi.n_seq)
    mi.jumps.add_intervals(intervals, flag)
