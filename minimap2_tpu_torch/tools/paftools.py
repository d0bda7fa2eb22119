"""paftools: PAF/SAM post-processing toolkit (copy of
minimap2_tpu.tools.paftools, the port's own, so that the port's tools
import nothing of the JAX package).

    python -m minimap2_tpu_torch.tools.paftools <command> [arguments]

Python port of all 27 reference misc/paftools.js subcommands (evaluation,
format conversion, variant calling and assembly statistics):

  sam2paf delta2paf splice2bed gff2bed gff2junc paf2gff   conversion
  view longcs2seq                                         display/seqs
  stat asmstat asmgene misjoin vcfstat                    statistics
  liftover vcfpair call vcfsel sveval                     calling/lifting
  mapeval pafcmp junceval exoneval ov-eval                evaluation
  mason2fq pbsim2fq badread2fa sim2bed bedcov             simulation/misc
  version

Field-for-field output parity with the JS (k8 `print` joins with TAB).
Same subcommands, options, output and return codes as the JAX package's
module.
"""
from __future__ import annotations

import re
import sys

MM_VERSION = "2.30-r1299-dirty"

_RE_CIGAR = re.compile(r"(\d+)([MIDNSHP=XB])")


def _print(*args, out=None):
    (out or sys.stdout).write("\t".join(str(a) for a in args) + "\n")


def _open(fn):
    if fn == "-":
        return sys.stdin
    if fn.endswith(".gz"):
        import gzip
        return gzip.open(fn, "rt")
    return open(fn)


# ---------------------------------------------------------------------------
# sam2paf (paftools.js:1741-1917)
# ---------------------------------------------------------------------------


def sam2paf(argv, out=None):
    pri_only = pri_pri_only = allow_unmapped = long_cs = False
    args = []
    for a in argv:
        if a == "-p":
            pri_only = True
        elif a == "-P":
            pri_pri_only = pri_only = True
        elif a == "-U":
            allow_unmapped = True
        elif a == "-L":
            long_cs = True
        else:
            args.append(a)
    if not args:
        print("Usage: paftools.py sam2paf [options] <in.sam>", file=sys.stderr)
        return 1
    re_tag = re.compile(r"\t(\S\S:[AZif]):(\S+)")
    re_MD = re.compile(r"(\d+)|(\^[A-Za-z]+)|([A-Za-z])")
    re_cig = re.compile(r"(\d+)([MIDSHNX=])")
    ctg_len = {}
    lineno = 0
    for line in _open(args[0]):
        line = line.rstrip("\n")
        lineno += 1
        if line.startswith("@"):
            if line.startswith("@SQ"):
                mname = re.search(r"\tSN:(\S+)", line)
                mlen = re.search(r"\tLN:(\d+)", line)
                if mname and mlen:
                    ctg_len[mname.group(1)] = int(mlen.group(1))
            continue
        t = line.split("\t")
        if len(t) < 11:
            continue
        flag = int(t[1])
        if t[9] != "*" and t[10] != "*" and len(t[9]) != len(t[10]):
            raise ValueError(f"at line {lineno}: inconsistent SEQ and QUAL")
        if t[2] == "*" or (flag & 4) or t[5] == "*":
            if allow_unmapped:
                qlen_val = 0 if t[9] == "*" else len(t[9])
                _print(t[0], qlen_val, 0, 0, "*", "*", 0, 0, 0, 0, 0, 0,
                       out=out)
            continue
        if pri_only and (flag & 0x100):
            continue
        if pri_pri_only and (flag & 0x900):
            continue
        tlen = ctg_len.get(t[2])
        if tlen is None:
            raise ValueError(f"at line {lineno}: can't find the length of "
                             f"contig {t[2]}")
        nn, NM, MD, cs_str = 0, None, None, None
        for m in re_tag.finditer(line):
            if m.group(1) == "NM:i":
                NM = int(m.group(2))
            elif m.group(1) == "nn:i":
                nn = int(m.group(2))
            elif m.group(1) == "MD:Z":
                MD = m.group(2)
            elif m.group(1) == "cs:Z":
                cs_str = m.group(2)
        if t[9] == "*":
            MD = cs_str = None
        clip = [0, 0]
        soft_clip = 0
        I = [0, 0]
        D = [0, 0]
        M = N = mm = 0
        have_M = have_ext = False
        cigar = []
        n_cigar = 0
        for m in re_cig.finditer(t[5]):
            ln, op = int(m.group(1)), m.group(2)
            if op == "M":
                M += ln
                have_M = True
            elif op == "I":
                I[0] += 1
                I[1] += ln
            elif op == "D":
                D[0] += 1
                D[1] += ln
            elif op == "N":
                N += ln
            elif op == "S":
                clip[0 if n_cigar == 0 else 1] = ln
                soft_clip += ln
            elif op == "H":
                clip[0 if n_cigar == 0 else 1] = ln
            elif op == "=":
                M += ln
                have_ext = True
                op = "M"
            elif op == "X":
                M += ln
                mm += ln
                have_ext = True
                op = "M"
            n_cigar += 1
            if MD is not None and op != "H":
                if cigar and cigar[-1][1] == op:
                    cigar[-1][0] += ln
                else:
                    cigar.append([ln, op])
        ql = M + I[1] + soft_clip
        tl = M + D[1] + N
        ts = int(t[3]) - 1
        te = ts + tl
        if n_cigar > 65535:
            print(f"WARNING at line {lineno}: {n_cigar} CIGAR operations",
                  file=sys.stderr)
        if te > tlen:
            print(f"WARNING at line {lineno}: alignment end position larger "
                  "than ref length; skipped", file=sys.stderr)
            continue
        if t[9] != "*" and len(t[9]) != ql:
            print(f"WARNING at line {lineno}: SEQ length inconsistent with "
                  f"CIGAR ({len(t[9])} != {ql}); skipped", file=sys.stderr)
            continue
        cs = []
        if MD is not None and cs_str is None and t[9] != "*":
            k = cx = cy = mx = my = 0
            for m in re_MD.finditer(MD):
                if m.group(2) is not None:   # deletion
                    ln = len(m.group(2)) - 1
                    cs.append("-" + m.group(2)[1:])
                    mx += ln
                    cx += ln
                    k += 1
                else:
                    ml = int(m.group(1)) if m.group(1) is not None else 1
                    while k < len(cigar) and cigar[k][1] != "D":
                        cl, op = cigar[k]
                        if op == "M":
                            if my + ml < cy + cl:
                                if ml > 0:
                                    if m.group(3) is not None:
                                        cs.append("*" + m.group(3)
                                                  + t[9][my])
                                    elif long_cs:
                                        cs.append("=" + t[9][my:my + ml])
                                    else:
                                        cs.append(f":{ml}")
                                mx += ml
                                my += ml
                                ml = 0
                                break
                            else:
                                dl = cy + cl - my
                                if long_cs:
                                    cs.append("=" + t[9][my:my + dl])
                                else:
                                    cs.append(f":{dl}")
                                cx += cl
                                cy += cl
                                k += 1
                                mx += dl
                                my += dl
                                ml -= dl
                        elif op == "I":
                            cs.append("+" + t[9][cy:cy + cl])
                            cy += cl
                            my += cl
                            k += 1
                        elif op == "S":
                            cy += cl
                            my += cl
                            k += 1
                        else:
                            raise ValueError(f"at line {lineno}: "
                                             "inconsistent MD tag")
                    if ml != 0:
                        raise ValueError(f"at line {lineno}: inconsistent "
                                         "MD tag")
            if cx != mx or cy != my:
                raise ValueError(f"at line {lineno}: inconsistent MD tag")
        if have_ext and not have_M:
            if NM is not None and NM != I[1] + D[1] + mm:
                print(f"WARNING at line {lineno}: NM is different from sum "
                      "of gaps and mismatches", file=sys.stderr)
            NM = I[1] + D[1] + mm
        elif NM is not None:
            if NM < I[1] + D[1]:
                print(f"WARNING at line {lineno}: NM is less than the total "
                      f"number of gaps ({NM} < {I[1] + D[1]})",
                      file=sys.stderr)
                NM = I[1] + D[1]
            mm = NM - (I[1] + D[1])
        else:
            print(f"WARNING at line {lineno}: unable to find the number of "
                  "mismatches; assuming zero", file=sys.stderr)
            mm = 0
        mlen = M - mm
        blen = M + I[1] + D[1]
        qlen = M + I[1] + clip[0] + clip[1]
        qname = t[0]
        if (flag & 1) and (flag & 0x40):
            qname += "/1"
        if (flag & 1) and (flag & 0x80):
            qname += "/2"
        if flag & 16:
            qs, qe = clip[1], qlen - clip[0]
        else:
            qs, qe = clip[0], qlen - clip[1]
        tags = ["tp:A:" + ("S" if flag & 0x100 else "P")]
        if NM is not None:
            tags.append(f"NM:i:{NM}")
            tags.append(f"mm:i:{mm}")
        tags.append(f"gn:i:{I[1] + D[1]}")
        tags.append(f"go:i:{I[0] + D[0]}")
        tags.append("cg:Z:" + re.sub(r"\d+[SH]", "", t[5]))
        if cs_str is not None:
            tags.append("cs:Z:" + cs_str)
        elif cs:
            tags.append("cs:Z:" + "".join(cs))
        _print(qname, qlen, qs, qe, "-" if flag & 16 else "+", t[2], tlen,
               ts, te, mlen, blen, t[4], *tags, out=out)
    return 0


# ---------------------------------------------------------------------------
# mapeval (paftools.js:2102-2280)
# ---------------------------------------------------------------------------

_RE_PBSIM = re.compile(r"^(\S+)!(\S+)!(\d+)!(\d+)!([\+\-])$")
_RE_MASON = re.compile(
    r"^(\S+)!(\S+)!(\d+)_(\d+)!(\d+)_(\d+)!([\+\-])([\+\-])/([12])$")


def mapeval(argv, out=None):
    max_mapq, mode, err_out_q, ovlp_ratio = 60, 0, 256, 0.1
    cap_short_mapq = False
    args = []
    it = iter(range(len(argv)))
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-Q":
            i += 1
            err_out_q = int(argv[i])
        elif a == "-r":
            i += 1
            ovlp_ratio = float(argv[i])
        elif a == "-m":
            i += 1
            mode = int(argv[i])
        elif a == "-c":
            cap_short_mapq = True
        else:
            args.append(a)
        i += 1
    if not args:
        print("Usage: paftools.py mapeval [options] <in.paf>|<in.sam>",
              file=sys.stderr)
        return 1

    tot = [0] * (max_mapq + 1)
    err = [0] * (max_mapq + 1)

    def is_correct(s, b):
        if s[0] != b[0] or s[3] != b[3]:
            return False
        if s[1] < b[1]:
            if s[2] <= b[1]:
                return False
            o = min(s[2], b[2]) - b[1]
            ll = max(s[2], b[2]) - s[1]
        else:
            if b[2] <= s[1]:
                return False
            o = min(s[2], b[2]) - s[1]
            ll = max(s[2], b[2]) - b[1]
        return o / ll > ovlp_ratio

    def count_err(qname, a):
        if not a:
            return
        m = _RE_PBSIM.match(qname)
        if m:
            s = [m.group(2), int(m.group(3)), int(m.group(4)), m.group(5)]
        else:
            m = _RE_MASON.match(qname)
            if m is None:
                raise ValueError("Failed to parse simulated read names "
                                 f"'{qname}'")
            if m.group(9) == "1":
                s = [m.group(2), int(m.group(3)), int(m.group(5)),
                     m.group(7)]
            else:
                s = [m.group(2), int(m.group(4)), int(m.group(6)),
                     m.group(8)]
        if mode in (0, 1):
            max_i = 0
            if mode == 0:
                mx = 0
                for i, ai in enumerate(a):
                    if ai[5] > mx:
                        mx, max_i = ai[5], i
            mapq = a[max_i][4]
            tot[mapq] += 1
            if not is_correct(s, a[max_i]):
                if mapq >= err_out_q:
                    _print("E", qname, "\t".join(map(str, a[max_i])), out=out)
                err[mapq] += 1
        elif mode == 2:
            if cap_short_mapq:
                mx, max_q = 0, 0
                for ai in a:
                    if ai[5] > mx:
                        mx, max_q = ai[5], ai[4]
                for ai in a:
                    ai[4] = min(max_q, ai[4])
            max_err_mapq, mx_mapq, max_err_i = -1, 0, -1
            for i, ai in enumerate(a):
                mx_mapq = max(mx_mapq, ai[4])
                if not is_correct(s, ai) and ai[4] > max_err_mapq:
                    max_err_mapq, max_err_i = ai[4], i
            if max_err_mapq >= 0:
                tot[max_err_mapq] += 1
                err[max_err_mapq] += 1
                if max_err_mapq >= err_out_q:
                    _print("E", qname, "\t".join(map(str, a[max_err_i])),
                           out=out)
            else:
                tot[mx_mapq] += 1

    re_cig = re.compile(r"(\d+)([MIDSHN=X])")
    last, a, n_unmapped = None, [], None
    for line in _open(args[0]):
        line = line.rstrip("\n")
        if not line or line.startswith("@"):
            continue
        t = line.split("\t")
        if len(t) > 4 and t[4] in "+-":     # PAF
            if last != t[0]:
                if last is not None:
                    count_err(last, a)
                a, last = [], t[0]
            if re.search(r"\ts1:i:\d+", line) and \
                    not re.search(r"\ts2:i:\d+", line):
                continue
            mapq = min(int(t[11]), max_mapq)
            a.append([t[5], int(t[7]), int(t[8]), t[4], mapq, int(t[9])])
        else:                               # SAM
            flag = int(t[1])
            read_no = flag >> 6 & 0x3
            qname = t[0]
            if not re.search(r"/[12]$", qname):
                qname = t[0] + "/" + str(read_no) if read_no in (1, 2) \
                    else t[0]
            if last != qname:
                if last is not None:
                    count_err(last, a)
                a, last = [], qname
            if flag & 0x100:
                continue
            if (flag & 0x4) or t[2] == "*":
                n_unmapped = (n_unmapped or 0) + 1
                continue
            mapq = min(int(t[4]), max_mapq)
            pos = int(t[3]) - 1
            pos_end = pos
            n_gap = mlen = 0
            for m in re_cig.finditer(t[5]):
                ln, op = int(m.group(1)), m.group(2)
                if op in "MX=":
                    pos_end += ln
                    mlen += ln
                elif op == "I":
                    n_gap += ln
                elif op == "D":
                    n_gap += ln
                    pos_end += ln
            score = pos_end - pos
            m = re.search(r"\tNM:i:(\d+)", line)
            if m:
                NM = int(m.group(1))
                if NM >= n_gap:
                    score = mlen - (NM - n_gap)
            a.append([t[2], pos, pos_end, "-" if flag & 16 else "+", mapq,
                      score])
    if last is not None:
        count_err(last, a)

    sum_tot = sum_err = sum_tot2 = sum_err2 = 0
    q_out = -1
    for q in range(max_mapq, -1, -1):
        if tot[q] == 0:
            continue
        if q_out < 0 or err[q] > 0:
            if q_out >= 0:
                _print("Q", q_out, sum_tot, sum_err,
                       f"{sum_err2 / sum_tot2:.9f}", sum_tot2, out=out)
            sum_tot = sum_err = 0
            q_out = q
        sum_tot += tot[q]
        sum_err += err[q]
        sum_tot2 += tot[q]
        sum_err2 += err[q]
    if q_out >= 0:
        _print("Q", q_out, sum_tot, sum_err, f"{sum_err2 / sum_tot2:.9f}",
               sum_tot2, out=out)
    if n_unmapped is not None:
        _print("U", n_unmapped, out=out)
    return 0


# ---------------------------------------------------------------------------
# stat (paftools.js:1009-1199)
# ---------------------------------------------------------------------------


def stat(argv, out=None):
    gap_out_len, count_err = None, False
    args = []
    i = 0
    while i < len(argv):
        if argv[i] == "-l":
            i += 1
            gap_out_len = int(argv[i])
        elif argv[i] == "-c":
            count_err = True
        else:
            args.append(argv[i])
        i += 1
    if not args:
        print("Usage: paftools.py stat [-c] [-l gapOutLen] <in.sam>|<in.paf>",
              file=sys.stderr)
        return 1
    re_cig = re.compile(r"(\d+)([MIDSHNX=])")
    lineno = n_pri = n_2nd = n_seq = n_cigar_64k = l_tot = l_cov = 0
    n_gap = [[0] * 6, [0] * 6]
    n_sub = 0

    def cov_len(regs):
        regs.sort(key=lambda x: x[0])
        st, en = regs[0]
        ll = 0
        for s0, e0 in regs[1:]:
            if s0 < en:
                en = max(en, e0)
            else:
                ll += en - st
                st, en = s0, e0
        return ll + en - st

    last = last_qlen = None
    regs = []
    for line in _open(args[0]):
        line = line.rstrip("\n")
        lineno += 1
        if line.startswith("@"):
            continue
        t = line.split("\t")
        if len(t) < 2:
            continue
        NM, nn, cigar, atlen = None, 0, None, None
        is_sam = is_rev = False
        if len(t) > 4 and t[4] in "+-*":    # PAF
            if t[4] == "*":
                continue
            if not re.search(r"\ts2:i:\d+", line):
                n_2nd += 1
                continue
            m = re.search(r"\tNM:i:(\d+)", line)
            NM = int(m.group(1)) if m else None
            m = re.search(r"\tnn:i:(\d+)", line)
            nn = int(m.group(1)) if m else 0
            m = re.search(r"\tcg:Z:(\S+)", line)
            cigar = m.group(1) if m else None
            if cigar is None:
                print(f"WARNING: no CIGAR at line {lineno}", file=sys.stderr)
                continue
            tname = t[5]
            qs, qe = int(t[2]), int(t[3])
            aqlen = qe - qs
            is_rev = t[4] != "+"
            rs = int(t[7])
            atlen = int(t[8]) - rs
            mapq = int(t[11])
            ori_qlen = int(t[1])
        else:                               # SAM
            flag = int(t[1])
            if (flag & 4) or t[2] == "*" or t[5] == "*":
                continue
            if flag & 0x100:
                n_2nd += 1
                continue
            m = re.search(r"\tNM:i:(\d+)", line)
            NM = int(m.group(1)) if m else None
            m = re.search(r"\tnn:i:(\d+)", line)
            nn = int(m.group(1)) if m else 0
            cigar = t[5]
            tname = t[2]
            rs = int(t[3]) - 1
            mapq = int(t[4])
            aqlen = len(t[9])
            is_sam = True
            is_rev = bool(flag & 0x10)
        n_pri += 1
        if last != t[0]:
            if last is not None:
                l_tot += last_qlen
                l_cov += cov_len(regs)
            regs = []
            n_seq += 1
            last = t[0]
        M = tl = ql = sclip = n_cigar = 0
        clip = [0, 0]
        n_gapo = n_gap_all = l_match = 0
        for m in re_cig.finditer(cigar):
            ln, op = int(m.group(1)), m.group(2)
            n_cigar += 1
            if op in "M=X":
                tl += ln
                ql += ln
                M += ln
                l_match += ln
            elif op in "ID":
                if ln < 50:
                    ty = 0
                elif ln < 100:
                    ty = 1
                elif ln < 300:
                    ty = 2
                elif ln < 400:
                    ty = 3
                elif ln < 1000:
                    ty = 4
                else:
                    ty = 5
                if op == "I":
                    ql += ln
                    n_gap[0][ty] += 1
                else:
                    tl += ln
                    n_gap[1][ty] += 1
                if gap_out_len is not None and ln >= gap_out_len:
                    _print(t[0], ql, "-" if is_rev else "+", tname, rs + tl,
                           op, ln, out=out)
                n_gapo += 1
                n_gap_all += ln
            elif op == "N":
                tl += ln
            elif op == "S":
                clip[0 if M == 0 else 1] = ln
                sclip += ln
            elif op == "H":
                clip[0 if M == 0 else 1] = ln
        if NM is not None:
            tmp = NM - n_gap_all - nn
            if tmp < 0 and nn == 0:
                print(f"WARNING: NM is smaller than the number of gaps at "
                      f"line {lineno}: NM={NM}, nn={nn}, G={n_gap_all}",
                      file=sys.stderr)
            n_sub += max(tmp, 0)
        if n_cigar > 65535:
            n_cigar_64k += 1
        if ql + sclip != aqlen:
            print("WARNING: aligned query length is inconsistent with CIGAR"
                  f" at line {lineno} ({ql + sclip} != {aqlen})",
                  file=sys.stderr)
        if atlen is not None and atlen != tl:
            print("WARNING: aligned reference length is inconsistent with "
                  f"CIGAR at line {lineno}", file=sys.stderr)
        if is_sam:
            qs = clip[1 if is_rev else 0]
            qe = qs + ql
            ori_qlen = clip[0] + ql + clip[1]
        if count_err and NM is not None:
            n_mm = max(NM - n_gap_all, 0)
            _print(t[0], ori_qlen, t[11] if len(t) > 11 else mapq,
                   ori_qlen - (qe - qs), NM, l_match + n_gap_all,
                   n_mm + n_gapo, l_match + n_gapo, out=out)
        regs.append([qs, qe])
        last_qlen = ori_qlen
    if regs:
        l_tot += last_qlen
        l_cov += cov_len(regs)
    if gap_out_len is None and not count_err:
        p = lambda s: _print(s, out=out)  # noqa: E731
        p(f"Number of mapped sequences: {n_seq}")
        p(f"Number of primary alignments: {n_pri}")
        p(f"Number of secondary alignments: {n_2nd}")
        p("Number of primary alignments with >65535 CIGAR operations: "
          f"{n_cigar_64k}")
        p(f"Number of bases in mapped sequences: {l_tot}")
        p(f"Number of mapped bases: {l_cov}")
        p(f"Number of substitutions: {n_sub}")
        for gi, nm in ((0, "insertions"), (1, "deletions")):
            for ti, rng in enumerate(("[0,50)", "[50,100)", "[100,300)",
                                      "[300,400)", "[400,1000)",
                                      "[1000,inf)")):
                p(f"Number of {nm} in {rng}: {n_gap[gi][ti]}")
    return 0


# ---------------------------------------------------------------------------
# junceval (paftools.js:2493-2706)
# ---------------------------------------------------------------------------


def junceval(argv, out=None):
    l_fuzzy, print_ovlp, print_err_only = 0, False, False
    first_only = chr_only = is_bed = False
    args = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-l":
            i += 1
            l_fuzzy = int(argv[i])
        elif a == "-e":
            print_err_only = print_ovlp = True
        elif a == "-p":
            print_ovlp = True
        elif a == "-c":
            chr_only = True
        elif a == "-b":
            is_bed = True
        elif a == "-1":
            first_only = True
        else:
            args.append(a)
        i += 1
    if len(args) < 1:
        print("Usage: paftools.py junceval [options] <gene.gtf> <aln.sam>",
              file=sys.stderr)
        return 1

    tr: dict = {}
    for line in _open(args[0]):
        t = line.rstrip("\n").split("\t")
        if t[0].startswith("#") or len(t) < 9 or t[2] != "exon":
            continue
        m = re.search(r'transcript_id "(\S+)"', t[8])
        if m is None:
            continue
        tid = m.group(1)
        tr.setdefault(tid, [t[0], t[6], 0, 0, []])[4].append(
            [int(t[3]) - 1, int(t[4])])
    anno: dict = {}
    for tid, t in tr.items():
        s = sorted(t[4])
        for j in range(len(s) - 1):
            if s[j][1] >= s[j + 1][0]:
                print(f"WARNING: incorrect annotation for transcript {tid} "
                      f"({s[j][1]} >= {s[j + 1][0]})", file=sys.stderr)
            anno.setdefault(t[0], []).append((s[j][1], s[j + 1][0]))
    for chrom in anno:
        anno[chrom] = sorted(set(anno[chrom]))

    def find_ovlp(e, st, en):
        import bisect
        res = []
        k = bisect.bisect_left(e, (en, -1))
        for j in range(k - 1, -1, -1):
            if e[j][0] >= en:
                continue
            if e[j][1] > st:
                res.append(e[j])
            # introns are short; a bounded backward scan suffices
            if st - e[j][0] > 1_000_000:
                break
        res.reverse()
        return res

    n_pri = n_unmapped = n_mapped = 0
    n_sgl = n_splice = n_splice_hit = n_splice_novel = 0
    last_qname = None
    re_cig = re.compile(r"(\d+)([MIDNSHP=XFGUV])")
    aln = _open(args[1]) if len(args) > 1 and args[1] != "-" else sys.stdin
    for line in aln:
        t = line.rstrip("\n").split("\t")
        if not t or t[0].startswith("@"):
            continue
        if t[0] == "##PAF":
            t = t[1:]
        qname = t[0]
        cigar = None
        if is_bed:
            ctg_name, pos = t[0], int(t[1])
        elif len(t) > 4 and t[4] in "+-*":  # PAF
            ctg_name, pos = t[5], int(t[7])
            ty = "P"
            for f in t[12:]:
                if f.startswith("tp:A:"):
                    ty = f[5:]
                elif f.startswith("cg:Z:"):
                    cigar = f[5:]
            if ty == "S":
                continue
        else:                                # SAM
            ctg_name, pos, cigar = t[2], int(t[3]) - 1, t[5]
            flag = int(t[1])
            if flag & 1:
                if flag & 0x40:
                    qname += "/1"
                elif flag & 0x80:
                    qname += "/2"
            if flag & 0x100:
                continue
        if chr_only and not re.match(r"^(chr)?([0-9]+|X|Y)$", ctg_name):
            continue
        if first_only and last_qname == qname:
            continue
        if ctg_name == "*":
            n_unmapped += 1
            continue
        n_pri += 1
        if last_qname != qname:
            n_mapped += 1
            last_qname = qname
        intron = []
        if is_bed:
            intron.append((pos, int(t[2])))
        else:
            for m in re_cig.finditer(cigar or ""):
                ln, op = int(m.group(1)), m.group(2)
                if op == "N":
                    intron.append((pos, pos + ln))
                    pos += ln
                elif op in "MX=D":
                    pos += ln
        if not intron:
            n_sgl += 1
            continue
        n_splice += len(intron)
        e = anno.get(ctg_name)
        if e is not None:
            for i2, (st, en) in enumerate(intron):
                o = find_ovlp(e, st, en)
                if o:
                    hit = False
                    for oj in o:
                        if abs(st - oj[0]) <= l_fuzzy \
                                and abs(en - oj[1]) <= l_fuzzy:
                            n_splice_hit += 1
                            hit = True
                        if hit:
                            break
                    if print_ovlp:
                        if hit and print_err_only:
                            continue
                        x = "[" + ", ".join(f"({a0},{b0})"
                                            for a0, b0 in o) + "]"
                        _print("C" if hit else "P", qname, i2 + 1, ctg_name,
                               st, en, x, out=out)
                else:
                    n_splice_novel += 1
                    if print_ovlp:
                        _print("N", qname, i2 + 1, ctg_name, st, en, out=out)
        else:
            n_splice_novel += len(intron)
    if not print_ovlp:
        p = lambda s: _print(s, out=out)  # noqa: E731
        p(f"# unmapped reads: {n_unmapped}")
        p(f"# mapped reads: {n_mapped}")
        p(f"# primary alignments: {n_pri}")
        p(f"# singletons: {n_sgl}")
        p(f"# predicted introns: {n_splice}")
        p(f"# non-overlapping introns: {n_splice_novel}")
        pct = n_splice_hit / n_splice * 100 if n_splice else 0.0
        p(f"# correct introns: {n_splice_hit} ({pct:.2f}%)")
    return 0


# ---------------------------------------------------------------------------
# view (paftools.js:1411-1533), BLAST-like 'aln' format
# ---------------------------------------------------------------------------

_RE_CS = re.compile(r"([:=\-\+\*])(\d+|[A-Za-z]+)")


def view(argv, out=None):
    line_len, fmt = 80, "aln"
    args = []
    i = 0
    while i < len(argv):
        if argv[i] == "-f":
            i += 1
            fmt = argv[i]
        elif argv[i] == "-l":
            i += 1
            line_len = int(argv[i])
        else:
            args.append(argv[i])
        i += 1
    if line_len == 0:
        line_len = 0x7FFFFFFF
    if not args:
        print("Usage: paftools.py view [options] <in.paf>", file=sys.stderr)
        return 1
    o = out or sys.stdout
    for line in _open(args[0]):
        t = line.rstrip("\n").split("\t")
        if len(t) < 12:
            continue
        cs = None
        for f in t[12:]:
            if f.startswith("cs:Z:"):
                cs = f[5:]
        if fmt == "lastz-cigar":
            cg = next((f[5:] for f in t[12:] if f.startswith("cg:Z:")), None)
            if cg is None:
                continue
            ops = []
            for m in _RE_CIGAR.finditer(cg):
                ops.append(m.group(2) + " " + m.group(1))
            o.write(" ".join(["cigar:", t[0], t[2], t[3], t[4], t[5], t[7],
                              t[8], "+", t[11]] + ops) + "\n")
            continue
        if cs is None:
            continue
        s_ref, s_qry, s_mid = [], [], []
        for m in _RE_CS.finditer(cs):
            op, arg = m.group(1), m.group(2)
            if op in ":=":
                ln = int(arg) if op == ":" else len(arg)
                seg = arg if op == "=" else "." * ln
                s_ref.append(seg.upper())
                s_qry.append(seg.upper())
                s_mid.append("|" * ln)
            elif op == "*":
                s_ref.append(arg[0].upper())
                s_qry.append(arg[1].upper())
                s_mid.append(" ")
            elif op == "+":
                s_ref.append("-" * len(arg))
                s_qry.append(arg.upper())
                s_mid.append(" " * len(arg))
            elif op == "-":
                s_ref.append(arg.upper())
                s_qry.append("-" * len(arg))
                s_mid.append(" " * len(arg))
        sr, sq, sm = "".join(s_ref), "".join(s_qry), "".join(s_mid)
        o.write(">" + "\t".join(t[:12]) + "\n")
        for st in range(0, len(sr), line_len):
            o.write("Ref+:  " + sr[st:st + line_len] + "\n")
            o.write("       " + sm[st:st + line_len] + "\n")
            o.write("Qry" + (t[4] if t[4] in "+-" else "?") + ":  "
                    + sq[st:st + line_len] + "\n\n")
    return 0


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------



# ---------------------------------------------------------------------------
# call (paftools.js:386-610): assembly-to-reference variant calling from cs
# ---------------------------------------------------------------------------


def call(argv, out=None, err=None):
    err = err or sys.stderr
    re_cs = re.compile(r"([:=*+\-])(\d+|[A-Za-z]+)")
    re_tag = re.compile(r"\t(\S\S:[AZif]):(\S+)")
    min_cov_len, min_var_len = 10000, 50000
    gap_thres, gap_thres_long, min_mapq = 50, 1000, 5
    fa, fa_lens, is_vcf, sample_name = None, [], False, "sample"
    args = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-l":
            i += 1
            min_cov_len = int(argv[i])
        elif a == "-L":
            i += 1
            min_var_len = int(argv[i])
        elif a == "-g":
            i += 1
            gap_thres = int(argv[i])
        elif a == "-G":
            i += 1
            gap_thres_long = int(argv[i])
        elif a == "-q":
            i += 1
            min_mapq = int(argv[i])
        elif a == "-s":
            i += 1
            sample_name = argv[i]
        elif a == "-f":
            i += 1
            fa, fa_lens = {}, []
            name, parts = None, []
            for line in _open(argv[i]):
                line = line.rstrip("\n")
                if line.startswith(">"):
                    if name is not None:
                        fa[name] = "".join(parts)
                        fa_lens.append((name, len(fa[name])))
                    name = line[1:].split()[0]
                    parts = []
                else:
                    parts.append(line)
            if name is not None:
                fa[name] = "".join(parts)
                fa_lens.append((name, len(fa[name])))
            is_vcf = True
        else:
            args.append(a)
        i += 1
    if not args:
        print("Usage: sort -k6,6 -k8,8n <with-cs.paf> | paftools.py call "
              "[options] -", file=err)
        return 1

    tot_len = 0
    n_sub = [0, 0, 0]
    n_ins = [0] * 5
    n_del = [0] * 5
    rev = False   # print_vcf quirk: QSTRAND uses the current alignment

    def print_vcf(o):
        if o[3] != 1:
            return
        if o[5] == "-" and o[6] == "-":
            return
        if o[5] != "-" and o[6] != "-":
            v = [o[0], o[1] + 1, ".", o[5].upper(), o[6].upper()]
        elif o[1] > 0:
            ref = fa[o[0]][o[1] - 1].upper()
            if o[5] == "-":
                v = [o[0], o[1], ".", ref, ref + o[6].upper()]
            else:
                v = [o[0], o[1], ".", ref + o[5].upper(), ref]
        else:
            return
        v += [o[4], ".", f"QNAME={o[7]};QSTART={o[8] + 1};QSTRAND="
              + ("-" if rev else "+"), "GT", "1/1"]
        _print(*v, out=out)

    def count_var(o):
        if o[3] > 1 or (o[5] == "-" and o[6] == "-"):
            return
        if o[5] == "-":
            ln = len(o[6])
            n_ins[0 if ln == 1 else 1 if ln == 2 else
                  2 if ln < gap_thres else 3 if ln < gap_thres_long
                  else 4] += 1
        elif o[6] == "-":
            ln = len(o[5])
            n_del[0 if ln == 1 else 1 if ln == 2 else
                  2 if ln < gap_thres else 3 if ln < gap_thres_long
                  else 4] += 1
        else:
            n_sub[0] += 1
            sx = (o[5] + o[6]).lower()
            if sx in ("ag", "ga", "ct", "tc"):
                n_sub[1] += 1
            else:
                n_sub[2] += 1

    if is_vcf:
        _print("##fileformat=VCFv4.1", out=out)
        for nm, ln in fa_lens:
            _print(f"##contig=<ID={nm},length={ln}>", out=out)
        _print('##INFO=<ID=QNAME,Number=1,Type=String,Description='
               '"Query name">', out=out)
        _print('##INFO=<ID=QSTART,Number=1,Type=Integer,Description='
               '"Query start">', out=out)
        _print('##INFO=<ID=QSTRAND,Number=1,Type=String,Description='
               '"Query strand">', out=out)
        _print('##FORMAT=<ID=GT,Number=1,Type=String,Description='
               '"Genotype">', out=out)
        _print("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
               + sample_name, out=out)

    a = []
    outq = []
    c1_ctg, c1_start, c1_end, c1_counted, c1_len = None, 0, 0, False, 0
    for line in _open(args[0]):
        line = line.rstrip("\n")
        t = line.split("\t")
        if len(t) < 12 or t[5] == "*":
            continue
        for ix in range(6, 12):
            t[ix] = int(t[ix])
        if t[10] < min_cov_len or t[11] < min_mapq:
            continue
        for ix in range(1, 4):
            t[ix] = int(t[ix])
        ctg, x, end = t[5], t[7], t[8]
        query = t[0]
        rev = t[4] == "-"
        y = t[3] if rev else t[2]
        cs = tp = None
        have_s1 = have_s2 = False
        for m in re_tag.finditer(line):
            if m.group(1) == "cs:Z":
                cs = m.group(2)
            elif m.group(1) == "tp:A":
                tp = m.group(2)
            elif m.group(1) == "s1:i":
                have_s1 = True
            elif m.group(1) == "s2:i":
                have_s2 = True
        if have_s1 and not have_s2:
            continue
        if tp in ("S", "i"):
            continue
        if ctg != c1_ctg or x >= c1_end:
            if c1_counted and c1_end > c1_start:
                c1_len += c1_end - c1_start
                if not is_vcf:
                    _print("R", c1_ctg, c1_start, c1_end, out=out)
            c1_ctg, c1_start, c1_end = ctg, x, end
            c1_counted = t[10] >= min_var_len
        elif end > c1_end:
            if c1_counted and x > c1_start:
                c1_len += x - c1_start
                if not is_vcf:
                    _print("R", c1_ctg, c1_start, x, out=out)
            c1_start, c1_end = c1_end, end
            c1_counted = t[10] >= min_var_len
        elif end > c1_start:
            if c1_counted and x > c1_start:
                c1_len += x - c1_start
                if not is_vcf:
                    _print("R", c1_ctg, c1_start, x, out=out)
            c1_start = end
        while outq:
            if outq[0][0] != ctg or outq[0][2] <= x:
                o = outq.pop(0)
                count_var(o)
                if is_vcf:
                    print_vcf(o)
                else:
                    _print("V", *o, out=out)
            else:
                break
        for o in outq:
            if o[1] >= x and o[2] <= end:
                o[3] += 1
        a = [ai for ai in a if ai[0] == ctg and ai[2] > x]
        if t[10] >= min_var_len:
            if cs is None:
                continue
            tot_len += t[10]
            for m in re_cs.finditer(cs):
                cov = 1
                if m.group(1) in "*+-":
                    cov += sum(1 for ai in a if ai[2] > x)
                if m.group(1) in "=:":
                    ln = len(m.group(2)) if m.group(1) == "=" \
                        else int(m.group(2))
                    y = y - ln if rev else y + ln
                    x += ln
                elif m.group(1) == "*":
                    if rev:
                        qs, qe = y - 1, y
                        y -= 1
                    else:
                        qs, qe = y, y + 1
                        y += 1
                    br, bq = m.group(2)[0], m.group(2)[1]
                    if br != "n" and bq != "n":
                        outq.append([t[5], x, x + 1, cov, t[11], br, bq,
                                     query, qs, qe, "-" if rev else "+"])
                    x += 1
                elif m.group(1) == "+":
                    ln = len(m.group(2))
                    if rev:
                        qs, qe = y - ln, y
                        y -= ln
                    else:
                        qs, qe = y, y + ln
                        y += ln
                    outq.append([t[5], x, x, cov, t[11], "-", m.group(2),
                                 query, qs, qe, "-" if rev else "+"])
                elif m.group(1) == "-":
                    ln = len(m.group(2))
                    outq.append([t[5], x, x + ln, cov, t[11], m.group(2),
                                 "-", query, y, y, "-" if rev else "+"])
                    x += ln
        a.append([t[5], t[7], t[8]])
    if c1_counted and c1_end > c1_start:
        c1_len += c1_end - c1_start
        if not is_vcf:
            _print("R", c1_ctg, c1_start, c1_end, out=out)
    while outq:
        o = outq.pop(0)
        count_var(o)
        if is_vcf:
            print_vcf(o)
        else:
            _print("V", *o, out=out)
    print(f"{c1_len} reference bases covered by exactly one contig",
          file=err)
    tstv = n_sub[1] / n_sub[2] if n_sub[2] else 0.0
    print(f"{n_sub[0]} substitutions; ts/tv = {tstv:.3f}", file=err)
    print(f"{n_del[0]} 1bp deletions", file=err)
    print(f"{n_ins[0]} 1bp insertions", file=err)
    print(f"{n_del[1]} 2bp deletions", file=err)
    print(f"{n_ins[1]} 2bp insertions", file=err)
    print(f"{n_del[2]} [3,{gap_thres}) deletions", file=err)
    print(f"{n_ins[2]} [3,{gap_thres}) insertions", file=err)
    print(f"{n_del[3]} [{gap_thres},{gap_thres_long}) deletions", file=err)
    print(f"{n_ins[3]} [{gap_thres},{gap_thres_long}) insertions", file=err)
    print(f"{n_del[4]} >={gap_thres_long} deletions", file=err)
    print(f"{n_ins[4]} >={gap_thres_long} insertions", file=err)
    return 0


# ---------------------------------------------------------------------------
# ov_eval (paftools.js ov-eval): overlap sensitivity from simulated reads
# ---------------------------------------------------------------------------


def ov_eval(argv, out=None):
    """Evaluate ava overlaps against pbsim-named read truth (misc/README
    ov-eval): an overlap is true if the reads' source intervals overlap
    by >= min_ovlp."""
    min_ovlp, min_frac = 100, 0.95
    args = []
    i = 0
    while i < len(argv):
        if argv[i] == "-l":
            i += 1
            min_ovlp = int(argv[i])
        elif argv[i] == "-f":
            i += 1
            min_frac = float(argv[i])
        else:
            args.append(argv[i])
        i += 1
    if not args:
        print("Usage: paftools.py ov-eval [-l min_ovlp] <ava.paf>",
              file=sys.stderr)
        return 1

    def parse(qn):
        m = _RE_PBSIM.match(qn)
        if m is None:
            raise ValueError(f"failed to parse read name '{qn}'")
        return m.group(2), int(m.group(3)), int(m.group(4))

    n, n_ov = 0, 0
    for line in _open(args[0]):
        t = line.rstrip("\n").split("\t")
        if len(t) < 11 or t[0] == t[5]:
            continue
        c1, s1, e1 = parse(t[0])
        c2, s2, e2 = parse(t[5])
        n += 1
        if c1 == c2:
            o = min(e1, e2) - max(s1, s2)
            if o >= min_ovlp:
                n_ov += 1
    _print(f"{n_ov} / {n} reported overlaps are true "
           f"({(n_ov / n * 100 if n else 0):.2f}%)", out=out)
    return 0




# ---------------------------------------------------------------------------
# gff2bed (paftools.js:1579-1740): GTF/GFF3 -> BED12 / junction BED
# ---------------------------------------------------------------------------

_RE_GTF = re.compile(r'\b(transcript_id|transcript_type|transcript_biotype'
                     r'|gene_name|gene_id|gbkey|transcript_name|tag)'
                     r' "([^"]+)";')
_RE_GFF3 = re.compile(r'\b(transcript_id|transcript_type|transcript_biotype'
                      r'|gene_name|gene_id|gbkey|transcript_name)=([^;]+)')

_BED_COLORS = {"protein_coding": "0,128,255", "mRNA": "0,128,255",
               "lincRNA": "0,192,0", "snRNA": "0,192,0",
               "miRNA": "0,192,0", "misc_RNA": "0,192,0"}


def gff2bed(argv, out=None):
    is_short = print_junc = ens_canon_only = False
    args = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-s":
            is_short = True
        elif a == "-j":
            print_junc = True
        elif a == "-e":
            ens_canon_only = True
        else:
            args.append(a)
        i += 1
    if not args:
        print("Usage: paftools.py gff2bed [-j] [-s] [-e] <in.gff>",
              file=sys.stderr)
        return 1

    def print_bed12(exons, cds_st, cds_en):
        if not exons:
            return
        name = (exons[0][7] + "|" + exons[0][5]) if is_short \
            else "|".join(str(x) for x in exons[0][4:7])
        a = sorted(exons, key=lambda x: x[1])
        if print_junc:
            for k in range(1, len(a)):
                _print(a[k][0], a[k - 1][2], a[k][1], name, 1000, a[k][3],
                       out=out)
            return
        st, en = a[0][1], a[-1][2]
        if cds_st == 1 << 30:
            cds_st = st
        if cds_en == 0:
            cds_en = en
        sizes = ",".join(str(x[2] - x[1]) for x in a) + ","
        starts = ",".join(str(x[1] - st) for x in a) + ","
        color = _BED_COLORS.get(a[0][5], "196,196,196")
        _print(a[0][0], st, en, name, 1000, a[0][3], cds_st, cds_en, color,
               len(a), sizes, starts, out=out)

    exons = []
    cds_st, cds_en = 1 << 30, 0
    last_id = None
    for line in _open(args[0]):
        t = line.rstrip("\n").split("\t")
        if not t or t[0].startswith("#") or len(t) < 9:
            continue
        if t[2] not in ("CDS", "exon"):
            continue
        st3 = int(t[3]) - 1
        en4 = int(t[4])
        tid, ttype, name, biotype, tname = None, "", "N/A", "", "N/A"
        ens_canonical = False
        for m in _RE_GTF.finditer(t[8]):
            k, vv = m.group(1), m.group(2)
            if k == "transcript_id":
                tid = vv
            elif k == "transcript_type":
                ttype = vv
            elif k in ("transcript_biotype", "gbkey"):
                biotype = vv
            elif k in ("gene_name", "gene_id"):
                name = vv
            elif k == "transcript_name":
                tname = vv
            elif k == "tag" and vv == "Ensembl_canonical":
                ens_canonical = True
        for m in _RE_GFF3.finditer(t[8]):
            k, vv = m.group(1), m.group(2)
            if k == "transcript_id":
                tid = vv
            elif k == "transcript_type":
                ttype = vv
            elif k in ("transcript_biotype", "gbkey"):
                biotype = vv
            elif k in ("gene_name", "gene_id"):
                name = vv
            elif k == "transcript_name":
                tname = vv
        if ens_canon_only and not ens_canonical:
            continue
        if ttype == "" and biotype != "":
            ttype = biotype
        if tid is None:
            raise ValueError("No transcript_id")
        if tid != last_id:
            print_bed12(exons, cds_st, cds_en)
            exons = []
            cds_st, cds_en = 1 << 30, 0
            last_id = tid
        if t[2] == "CDS":
            cds_st = min(cds_st, st3)
            cds_en = max(cds_en, en4)
        else:
            exons.append([t[0], st3, en4, t[6], tid, ttype, name, tname])
    if last_id is not None:
        print_bed12(exons, cds_st, cds_en)
    return 0



# ---------------------------------------------------------------------------
# Interval helpers (paftools.js:55-128)
# ---------------------------------------------------------------------------


def _intv_sort(a):
    a.sort(key=lambda x: (x[0], x[1]))


def _intv_merge(a, sorted_=True):
    if not sorted_:
        _intv_sort(a)
    k = 0
    for i in range(1, len(a)):
        if a[k][1] >= a[i][0]:
            a[k][1] = max(a[k][1], a[i][1])
        else:
            k += 1
            a[k] = list(a[i])
    del a[k + 1:]


def _intv_index_end(a, sorted_=True):
    """Appends the start-scan index used by find_ovlp (paftools.js:77-94)."""
    if not a:
        return
    if not sorted_:
        _intv_sort(a)
    a[0].append(0)
    k, k_en = 0, a[0][1]
    for i in range(1, len(a)):
        if k_en <= a[i][0]:
            k += 1
            while k < i:
                if a[k][1] > a[i][0]:
                    break
                k += 1
            k_en = a[k][1]
        a[i].append(k)


def _intv_find_ovlp(a, st, en):
    if not a or st >= en:
        return []
    left, right = -1, len(a)
    while right - left > 1:
        mid = left + ((right - left) >> 1)
        if a[mid][0] > st:
            right = mid
        elif a[mid][0] < st:
            left = mid
        else:
            left = mid
            break
    l = left
    k = 0 if l < 0 else a[l][-1]
    b = []
    for i in range(k, len(a)):
        if a[i][0] >= en:
            break
        if st < a[i][1]:
            b.append(a[i])
    return b


# ---------------------------------------------------------------------------
# liftover (paftools.js:252-383)
# ---------------------------------------------------------------------------


def liftover(argv, out=None):
    to_merge, min_mapq, min_len, max_div = False, 5, 50000, 2.0
    args = []
    i = 0
    while i < len(argv):
        if argv[i] == "-m":
            to_merge = True
        elif argv[i] == "-q":
            i += 1
            min_mapq = int(argv[i])
        elif argv[i] == "-l":
            i += 1
            min_len = int(argv[i])
        elif argv[i] == "-d":
            i += 1
            max_div = float(argv[i])
        else:
            args.append(argv[i])
        i += 1
    if len(args) < 2:
        print("Usage: paftools.py liftover [options] <aln.paf> <query.bed>",
              file=sys.stderr)
        return 1
    bed = {}
    for line in _open(args[1]):
        t = line.rstrip("\n").split("\t")
        bed.setdefault(t[0], []).append([int(t[1]), int(t[2])])
    for chrom in bed:
        _intv_sort(bed[chrom])
        if to_merge:
            _intv_merge(bed[chrom], True)
        _intv_index_end(bed[chrom], True)
    re_cigar = re.compile(r"(\d+)([MID])")
    re_tag = re.compile(r"^(\S\S):([AZif]):(\S+)$")
    for line in _open(args[0]):
        t = line.rstrip("\n").split("\t")
        if t[0] not in bed:
            continue
        tp = cg = None
        for fld in t[12:]:
            m = re_tag.match(fld)
            if m:
                if m.group(1) == "tp":
                    tp = m.group(3)
                elif m.group(1) == "cg":
                    cg = m.group(3)
        if tp not in ("P", "I"):
            continue
        if cg is None:
            raise RuntimeError("unable to find the 'cg' tag")
        for i2 in (1, 2, 3, 6, 7, 8, 9, 10, 11):
            t[i2] = int(t[i2])
        if t[11] < min_mapq or t[10] < min_len:
            continue
        regs = _intv_find_ovlp(bed[t[0]], t[2], t[3])
        if not regs:
            continue
        if 0.0 <= max_div < 1.0:
            n_gaps = n_opens = 0
            for m in re_cigar.finditer(cg):
                if m.group(2) in "ID":
                    n_gaps += int(m.group(1))
                    n_opens += 1
            n_mm = t[10] - t[9] - n_gaps
            n_diff2 = n_mm + n_opens
            if n_diff2 / (n_diff2 + t[9]) > max_div:
                continue
        a, r = [], []
        strand = t[4]
        for i2, reg in enumerate(regs):
            s_, e_ = reg[0], reg[1]
            if strand == "+":
                a.append([s_, 0, i2, -2])
                a.append([e_ - 1, 1, i2, -2])
            else:
                a.append([t[1] - e_, 0, i2, -2])
                a.append([t[1] - s_ - 1, 1, i2, -2])
            r.append([-2, -2])
        a.sort(key=lambda x: x[0])
        k = 0
        x = t[7]
        y = t[2] if strand == "+" else t[1] - t[3]
        for m in re_cigar.finditer(cg):
            ln = int(m.group(1))
            op = m.group(2)
            if op == "D":
                x += ln
                continue
            while k < len(a) and a[k][0] < y:
                k += 1
            for i2 in range(k, len(a)):
                if y <= a[i2][0] < y + ln:
                    a[i2][3] = x + (a[i2][0] - y) if op == "M" else x
                else:
                    break
            y += ln
            if op == "M":
                x += ln
        if x != t[8] or (strand == "+" and y != t[3]) or \
                (strand == "-" and y != t[1] - t[2]):
            raise RuntimeError("CIGAR is inconsistent with mapping "
                               "coordinates")
        for e in a:
            if e[1] == 0:
                r[e[2]][0] = e[3]
            else:
                r[e[2]][1] = e[3] + 1
        for i2, ri in enumerate(r):
            name = "_".join(map(str, [t[0], regs[i2][0], regs[i2][1]]))
            if ri[0] < 0:
                name += "_t5"
                ri[0] = t[7]
            if ri[1] < 0:
                name += "_t3"
                ri[1] = t[8]
            _print(t[5], ri[0], ri[1], name, 0, strand, out=out)
    return 0


# ---------------------------------------------------------------------------
# splice2bed (paftools.js:1982-2094)
# ---------------------------------------------------------------------------


def splice2bed(argv, out=None):
    colors = ["0,128,255", "255,0,0", "0,192,0"]
    fmt, fn_name_conv, keep_multi = "bed", None, False
    args = []
    i = 0
    while i < len(argv):
        if argv[i] == "-f":
            i += 1
            fmt = argv[i]
        elif argv[i] == "-n":
            i += 1
            fn_name_conv = argv[i]
        elif argv[i] == "-m":
            keep_multi = True
        else:
            args.append(argv[i])
        i += 1
    if not args:
        print("Usage: paftools.py splice2bed [options] <in.paf>|<in.sam>",
              file=sys.stderr)
        return 1
    conv = None
    if fn_name_conv is not None:
        conv = {}
        for line in _open(fn_name_conv):
            t = line.rstrip("\n").split("\t")
            conv[t[0]] = t[1]

    def print_lines(a):
        if not a:
            return
        if fmt == "bed":
            n_pri = sum(1 for e in a if e[8] == 0)
            if n_pri > 1:
                for e in a:
                    if e[8] == 0:
                        e[8] = 1
            elif n_pri == 0:
                print(f"Warning: {a[0][3]} doesn't have a primary alignment",
                      file=sys.stderr)
            for e in a:
                if not keep_multi and e[8] == 2:
                    continue
                e[8] = colors[e[8]]
                _print(*e, out=out)
        a.clear()

    a = []
    for line in _open(args[0]):
        line = line.rstrip("\n")
        if line.startswith("@"):
            continue
        t = line.split("\t")
        is_pri, cigar = False, None
        qname = conv.get(t[0]) if conv is not None else None
        if qname is not None:
            t[0] = qname
        if len(t) >= 10 and t[4] not in "+-" and re.match(r"^\d+", t[1]):
            flag = int(t[1])
            if flag & 1:
                t[0] += "/" + str(flag >> 6 & 3)
        if a and a[0][3] != t[0]:
            print_lines(a)
        if len(t) >= 12 and t[4] in "+-":       # PAF
            for fld in t[12:]:
                if fld.startswith("cg:Z:"):
                    cigar = fld[5:]
                elif fld.startswith("s2:i:"):
                    is_pri = True
            a1 = [t[5], int(t[7]), int(t[8]), t[0],
                  int(t[9]) * 1000 // int(t[10]), t[4]]
        elif len(t) >= 10:                      # SAM
            flag = int(t[1])
            if (flag & 4) or t[2] == "*":
                continue
            cigar = t[5]
            is_pri = not (flag & 0x100)
            a1 = [t[2], int(t[3]) - 1, None, t[0], 1000,
                  "-" if flag & 16 else "+"]
        else:
            raise RuntimeError("unrecognized input format")
        if cigar is None:
            raise RuntimeError("missing CIGAR")
        x0 = x = 0
        bs, bl = [], []
        for m in _RE_CIGAR.finditer(cigar):
            ln, op = int(m.group(1)), m.group(2)
            if op in "MD":
                x += ln
            elif op == "N":
                bs.append(x0)
                bl.append(x - x0)
                x += ln
                x0 = x
        bs.append(x0)
        bl.append(x - x0)
        if a1[2] is None:
            a1[2] = a1[1] + x
        a1 += [a1[1], a1[2], 0 if is_pri else 2, len(bs),
               ",".join(map(str, bl)) + ",", ",".join(map(str, bs)) + ","]
        a.append(a1)
    print_lines(a)
    return 0


# ---------------------------------------------------------------------------
# delta2paf (paftools.js:1919-1980)
# ---------------------------------------------------------------------------


def delta2paf(argv, out=None):
    if not argv:
        print("Usage: paftools.py delta2paf <in.delta>", file=sys.stderr)
        return 1
    re_hdr = re.compile(r"^>(\S+)\s+(\S+)\s+(\d+)\s+(\d+)")
    rname = qname = None
    rlen = qlen = qs = qe = rs = re_ = strand = NM = 0
    x = y = 0
    cigar = []
    seen_gt = False
    for line in _open(argv[0]):
        line = line.rstrip("\n")
        m = re_hdr.match(line)
        if m:
            rname, qname = m.group(1), m.group(2)
            rlen, qlen = int(m.group(3)), int(m.group(4))
            seen_gt = True
            continue
        if not seen_gt:
            continue
        t = line.split(" ")
        if len(t) == 7:
            ti = [int(v) for v in t[:5]]
            strand = 1 if (ti[0] < ti[1]) == (ti[2] < ti[3]) else -1
            rs = min(ti[0], ti[1]) - 1
            re_ = max(ti[0], ti[1])
            qs = min(ti[2], ti[3]) - 1
            qe = max(ti[2], ti[3])
            x = y = 0
            NM = ti[4]
            cigar = []
        elif len(t) == 1:
            d = int(t[0])
            if d == 0:
                blen = 0
                cigar_str = []
                if re_ - rs - x != qe - qs - y:
                    raise RuntimeError("inconsisnt alignment")
                cigar.append((re_ - rs - x) << 4)
                for c in cigar:
                    blen += c >> 4
                    cigar_str.append(str(c >> 4) + "MID"[c & 0xF])
                _print(qname, qlen, qs, qe, "+" if strand > 0 else "-",
                       rname, rlen, rs, re_, blen - NM, blen, 0,
                       f"NM:i:{NM}", "cg:Z:" + "".join(cigar_str), out=out)
            elif d > 0:
                ln = d - 1
                x += ln + 1
                y += ln
                if ln > 0:
                    cigar.append(ln << 4)
                if cigar and (cigar[-1] & 0xF) == 2:
                    cigar[-1] += 1 << 4
                else:
                    cigar.append(1 << 4 | 2)
            else:
                ln = -d - 1
                x += ln
                y += ln + 1
                if ln > 0:
                    cigar.append(ln << 4)
                if cigar and (cigar[-1] & 0xF) == 1:
                    cigar[-1] += 1 << 4
                else:
                    cigar.append(1 << 4 | 1)
    return 0


# ---------------------------------------------------------------------------
# bedcov (paftools.js:1187-1307)
# ---------------------------------------------------------------------------


def bedcov(argv, out=None):
    def read_bed(fn, to_merge_, to_dedup):
        h = {}
        for line in _open(fn):
            t = line.rstrip("\n").split("\t")
            bst, ben = int(t[1]), int(t[2])
            lst = h.setdefault(t[0], [])
            if len(t) >= 12 and re.match(r"^\d+$", t[9]):
                n = int(t[9])
                sz = t[10].split(",")
                st = t[11].split(",")
                for i in range(n):
                    sti, szi = int(st[i]), int(sz[i])
                    lst.append([bst + sti, bst + sti + szi, 0, 0, 0])
            else:
                lst.append([bst, ben, 0, 0, 0])
        for chrom in h:
            if to_merge_:
                _intv_merge(h[chrom], False)
            else:
                _intv_sort(h[chrom])
            _intv_index_end(h[chrom])
        return h

    print_len, to_merge, to_dedup, fn_excl = False, True, False, None
    args = []
    i = 0
    while i < len(argv):
        if argv[i] == "-p":
            print_len = True
        elif argv[i] == "-d":
            to_dedup, to_merge = True, False
        elif argv[i] == "-e":
            i += 1
            fn_excl = argv[i]
        else:
            args.append(argv[i])
        i += 1
    if len(args) < 2:
        print("Usage: paftools.py bedcov [options] <regions.bed> "
              "<target.bed>", file=sys.stderr)
        return 1
    excl = read_bed(fn_excl, True, False) if fn_excl else None
    target = read_bed(args[0], to_merge, to_dedup)
    tot_len = hit_len = 0
    for line in _open(args[1]):
        t = line.rstrip("\n").split("\t")
        a = []
        bst, ben = int(t[1]), int(t[2])
        if len(t) >= 12 and re.match(r"^\d+$", t[9]):
            n = int(t[9])
            sz = t[10].split(",")
            st = t[11].split(",")
            for i2 in range(n):
                sti, szi = int(st[i2]), int(sz[i2])
                a.append([bst + sti, bst + sti + szi, False])
        else:
            a.append([bst, ben, False])
        feat_len = 0
        for e in a:
            if excl is not None and t[0] in excl:
                if _intv_find_ovlp(excl[t[0]], e[0], e[1]):
                    continue
            e[2] = True
            feat_len += e[1] - e[0]
        tot_len += feat_len
        if t[0] not in target:
            continue
        b = []
        for e in a:
            if not e[2]:
                continue
            for o in _intv_find_ovlp(target[t[0]], e[0], e[1]):
                max_st = max(o[0], e[0])
                min_en = min(o[1], e[1])
                b.append([max_st, min_en])
                o[2] += min_en - max_st
                o[3] += 1
                if max_st == o[0] and min_en == o[1]:
                    o[4] += 1
        feat_hit_len = 0
        if b:
            b.sort(key=lambda v: v[0])
            st_, en_ = b[0]
            for e in b[1:]:
                if e[0] <= en_:
                    en_ = max(en_, e[1])
                else:
                    feat_hit_len += en_ - st_
                    st_, en_ = e
            feat_hit_len += en_ - st_
        hit_len += feat_hit_len
        if print_len:
            _print("F", "\t".join(t[:4]), feat_len, feat_hit_len, out=out)
    print(f"# target bases: {tot_len}", file=sys.stderr)
    pct = 100.0 * hit_len / tot_len if tot_len else 0.0
    print(f"# target bases overlapping regions: {hit_len} ({pct:.2f}%)",
          file=sys.stderr)
    return 0


# ---------------------------------------------------------------------------
# simulated-read converters (paftools.js:2271-2446)
# ---------------------------------------------------------------------------

_COMP = str.maketrans("ACGTUacgtuRYKMrykmBDHVbdhvNn",
                      "TGCAAtgcaaYRMKyrmkVHDBvhdbNn")


def _revcomp(s: str) -> str:
    return s.translate(_COMP)[::-1]


def mason2fq(argv, out=None):
    if not argv:
        print("Usage: paftools.py mason2fq <mason.sam>", file=sys.stderr)
        return 1
    o = out or sys.stdout

    def print_se(a):
        o.write("@" + "!".join(map(str, a[:5])) + " " + a[8] + "\n")
        o.write(a[5] + "\n+\n" + a[6] + "\n")

    last = None
    for line in _open(argv[0]):
        t = line.rstrip("\n").split("\t")
        if t[0].startswith("@"):
            continue
        l_ref = sum(int(m.group(1)) for m in _RE_CIGAR.finditer(t[5])
                    if m.group(2) in "DMN")
        flag = int(t[1])
        if flag & 16:
            seq = _revcomp(t[9])
            qual = t[10][::-1]
        else:
            seq, qual = t[9], t[10]
        qname = re.sub(r"^simulated\.", "", t[0])
        chrom = t[2]
        pos = int(t[3]) - 1
        strand = "-" if flag & 16 else "+"
        read_no = flag & 0xC0
        read_no = 1 if read_no == 0x40 else 2 if read_no == 0x80 else 0
        err = snp = indel = 0
        for fld in t[11:]:
            m = re.match(r"^XE:i:(\d+)", fld)
            if m:
                err = m.group(1)
                continue
            m = re.match(r"^XS:i:(\d+)", fld)
            if m:
                snp = m.group(1)
                continue
            m = re.match(r"^XI:i:(\d+)", fld)
            if m:
                indel = m.group(1)
        comment = f"{err}:{snp}:{indel}"
        rec = [qname, chrom, pos, pos + l_ref, strand, seq, qual, read_no,
               comment]
        if last is None:
            last = rec
        elif last[0] != qname:
            print_se(last)
            last = rec
        else:
            if read_no == 2:
                if last[7] != 1:
                    raise RuntimeError("ERROR: can't find read1")
                name = "!".join(map(str, [
                    qname, chrom, f"{last[2]}_{pos}",
                    f"{last[3]}_{pos + l_ref}", last[4] + strand]))
                o.write(f"@{name}/1 {last[8]}\n{last[5]}\n+\n{last[6]}\n")
                o.write(f"@{name}/2 {comment}\n{seq}\n+\n{qual}\n")
            else:
                if last[7] != 2:
                    raise RuntimeError("ERROR: can't find read2")
                name = "!".join(map(str, [
                    qname, chrom, f"{pos}_{last[2]}",
                    f"{pos + l_ref}_{last[3]}", strand + last[4]]))
                o.write(f"@{name}/1 {comment}\n{seq}\n+\n{qual}\n")
                o.write(f"@{name}/2 {last[8]}\n{last[5]}\n+\n{last[6]}\n")
            last = None
    if last is not None:
        print_se(last)
    return 0


def pbsim2fq(argv, out=None):
    if len(argv) < 2:
        print("Usage: paftools.py pbsim2fq <ref.fa.fai> <pbsim1.maf> "
              "[[pbsim2.maf] ...]", file=sys.stderr)
        return 1
    o = out or sys.stdout
    chr_list = [line.split()[0] for line in _open(argv[0]) if line.strip()]
    for fn in argv[1:]:
        state, reg = 0, None
        for line in _open(fn):
            line = line.rstrip("\n")
            if state == 0 and line.startswith("a"):
                state = 1
            elif state == 1 and line.startswith("s"):
                t = line.split()
                st = int(t[2])
                reg = [st, st + int(t[3])]
                state = 2
            elif state == 2 and line.startswith("s"):
                t = line.split()
                m = re.search(r"S(\d+)_\d+", t[1])
                if m is None:
                    raise RuntimeError("Failed to parse the read name")
                chr_id = int(m.group(1)) - 1
                if chr_id >= len(chr_list):
                    raise RuntimeError("Index outside the chr list")
                name = "!".join(map(str, [t[1], chr_list[chr_id], reg[0],
                                          reg[1], t[4]]))
                seq = t[6].replace("-", "")
                if len(seq) != int(t[5]):
                    raise RuntimeError("Inconsistent read length")
                if "NN" not in seq:
                    if t[4] == "-":
                        seq = _revcomp(seq)
                    o.write(">" + name + "\n" + seq + "\n")
                state = 0
    return 0


def sim2bed(argv, out=None):
    if not argv:
        print("Usage: paftools.py sim2bed <sim.txt>", file=sys.stderr)
        return 1
    seen = set()
    for line in _open(argv[0]):
        line = line.rstrip("\n")
        t = line.split("!")
        if len(t) < 5:
            continue
        chrom = t[1]
        if "_" in t[2]:     # mason paired-end
            pos = t[2].split("_")
            end = t[3].split("_")
            m = re.match(r"^(.)(.)/([12])$", t[4])
            if m is None:
                continue
            strand = m.group(1) if m.group(3) == "1" else m.group(2)
            read_no = int(m.group(3)) - 1
            st, en = int(pos[read_no]), int(end[read_no])
        else:               # badread/pbsim long reads
            st, en = int(t[2]), int(t[3])
            strand = t[4]
        if st > en:
            st, en = en, st
        if line in seen:
            continue
        seen.add(line)
        _print(chrom, st, en, line, 0, strand, out=out)
    return 0


# ---------------------------------------------------------------------------
# asmstat (paftools.js:612-864): assembly contiguity/accuracy statistics
# from asm-to-ref PAF(s): NG50/NGA50/AUNGA, ref & query coverage, dup rate,
# break counts.
# ---------------------------------------------------------------------------


def asmstat(argv, out=None):
    out = out or sys.stdout
    min_query_len, min_seg_len, max_diff = 0, 10000, 0.01
    bp_flank_len = 0
    args = []
    it = iter(argv)
    for a in it:
        if a == "-l":
            min_seg_len = int(next(it))
        elif a == "-d":
            max_diff = float(next(it))
        elif a == "-b":
            bp_flank_len = int(next(it))
        elif a == "-g":
            next(it)      # bp_gap_len: only used by the disabled nb-plot
        elif a == "-q":
            min_query_len = int(next(it))
        else:
            args.append(a)
    if not args:
        print("Usage: paftools.py asmstat [options] <ref.fa.fai> "
              "<asm1.paf> [...]", file=sys.stderr)
        return 1

    ref_len = 0
    for line in _open(args[0]):
        ref_len += int(line.rstrip("\n").split("\t")[1])

    def process_query(qblocks, qblock_len, bp, qi):
        qblocks.sort(key=lambda x: x[0])
        last_k = last_blen = None
        st = en = -1
        qcov = 0
        for k, qb in enumerate(qblocks):
            blen = qb[1] - qb[0]
            if k > 0 and qb[0] < qblocks[k - 1][1]:
                if qb[1] < qblocks[k - 1][1]:
                    continue
                blen = qb[1] - qblocks[k - 1][1]
            qblock_len.append(blen)
            if qb[0] > en:
                qcov += en - st
                st, en = qb[0], qb[1]
            else:
                en = max(en, qb[1])
            if last_k is not None:
                lb = qblocks[last_k]
                gap = 1000000000
                if qb[2] == lb[2] and qb[3] == lb[3]:
                    g1 = qb[0] - lb[1]
                    g2 = qb[4] - lb[5] if qb[2] == "+" else lb[4] - qb[5]
                    gap = abs(g1 - g2)
                bp.append((blen, gap))
                qi["bp"].append((blen, gap))
            last_k, last_blen = k, blen
        qcov += en - st
        return qcov

    def n50(lens, tot, quantile):
        lens = sorted(lens, reverse=True)
        if tot is None:
            tot = sum(lens)
        s = 0
        for x in lens:
            if s <= quantile * tot < s + x:
                return x
            s += x
        return None

    def aun(lens, tot):
        lens = sorted(lens, reverse=True)
        if tot is None:
            tot = sum(lens)
        x = y = 0
        for v in lens:
            ln_ = v if x + v <= tot else tot - x
            x += v
            y += ln_ * (ln_ / tot)
            if x >= tot:
                break
        return f"{y:.0f}"

    def count_bp(bp, min_blen, min_gap):
        return sum(1 for fl, g in bp if fl >= min_blen and g >= min_gap)

    re_md = re.compile(r"(\d+)([MID])")

    def compute_diff(cigar, NM):
        n_M = n_gapo = n_gaps = 0
        for m in re_md.finditer(cigar):
            ln_ = int(m.group(1))
            if m.group(2) == "M":
                n_M += ln_
            else:
                n_gapo += 1
                n_gaps += ln_
        if NM < n_gaps:
            raise RuntimeError("NM is smaller the number of gaps")
        return (NM - n_gaps + n_gapo) / (n_M + n_gapo)

    labels = ["Length", "l_cov", "Rcov", "Rdup", "Qcov", "NG75", "NG50",
              "NGA50", "AUNGA", "#breaks", f"bp({min_seg_len},0)",
              f"bp({min_seg_len},10k)"]
    n_asm = len(args) - 1
    rst = [[None] * n_asm for _ in labels]
    header = ["Metric"]
    for i in range(n_asm):
        fn = args[1 + i]
        header.append(re.sub(r"\.paf(\.gz)?$", "", fn))
        n_breaks = qcov = 0
        ref_blocks, qblock_len, qblocks, bp = [], [], [], []
        query, qinfo = {}, {}
        last_qname = None
        for line in _open(fn):
            line = line.rstrip("\n")
            t = line.split("\t")
            if len(t) < 2:
                continue
            t[1] = int(t[1])
            if t[1] < min_query_len:
                continue
            query[t[0]] = t[1]
            qinfo.setdefault(t[0], {})["len"] = t[1]
            qinfo[t[0]]["bp"] = []
            if len(t) < 9 or t[5] == "*":
                continue
            if not re.search(r"\ttp:A:[PI]", line):
                continue
            m = re.search(r"\tcg:Z:(\S+)", line)
            cigar = m.group(1) if m else None
            m = re.search(r"\tNM:i:(\d+)", line)
            NM = int(m.group(1)) if m else None
            diff = (compute_diff(cigar, NM)
                    if cigar is not None and NM is not None else 0)
            t[2], t[3] = int(t[2]), int(t[3])
            t[7], t[8] = int(t[7]), int(t[8])
            if t[0] == last_qname:
                n_breaks += 1
            if diff > max_diff:
                continue
            if t[3] - t[2] < min_seg_len:
                continue
            if t[0] != last_qname:
                if last_qname is not None:
                    qcov += process_query(qblocks, qblock_len, bp,
                                          qinfo[last_qname])
                qblocks = []
                last_qname = t[0]
            ref_blocks.append([t[5], t[7], t[8]])
            qblocks.append([t[2], t[3], t[4], t[5], t[7], t[8]])
        if last_qname is not None:
            qcov += process_query(qblocks, qblock_len, bp,
                                  qinfo[last_qname])

        asm_len = sum(query.values())
        rst[0][i] = asm_len
        rst[5][i] = n50(list(query.values()), ref_len, 0.75)
        rst[6][i] = n50(list(query.values()), ref_len, 0.5)

        l_cov = 0
        ref_blocks.sort(key=lambda r: (r[0], r[1]))
        last_ref, st, en = None, -1, -1
        for rb in ref_blocks:
            if rb[0] != last_ref or rb[1] > en:
                l_cov += en - st
                last_ref, st, en = rb[0], rb[1], rb[2]
            else:
                en = max(en, rb[2])
        l_cov += en - st
        rst[1][i] = l_cov
        rst[2][i] = f"{100.0 * l_cov / ref_len:.2f}%"
        rst[4][i] = (f"{100.0 * qcov / asm_len:.2f}%" if asm_len
                     else "0.00%")

        # single-coverage length (mirrors paf_call; paftools.js:805-824)
        c1_ctg, c1_start, c1_end, c1_len = None, 0, 0, 0
        for rb in ref_blocks:
            if rb[0] != c1_ctg or rb[1] >= c1_end:
                if c1_end > c1_start:
                    c1_len += c1_end - c1_start
                c1_ctg, c1_start, c1_end = rb[0], rb[1], rb[2]
            elif rb[2] > c1_end:
                if rb[1] > c1_start:
                    c1_len += rb[1] - c1_start
                c1_start, c1_end = c1_end, rb[2]
            elif rb[2] > c1_start:
                if rb[1] > c1_start:
                    c1_len += rb[1] - c1_start
                c1_start = rb[2]
        if c1_end > c1_start:
            c1_len += c1_end - c1_start
        rst[3][i] = (f"{100 * (l_cov - c1_len) / l_cov:.2f}%" if l_cov
                     else "0.00%")

        rst[7][i] = n50(qblock_len, ref_len, 0.5)
        rst[8][i] = aun(qblock_len, ref_len)
        rst[9][i] = n_breaks
        rst[10][i] = count_bp(bp, 500, 0)
        rst[11][i] = count_bp(bp, 500, 10000)

    if bp_flank_len <= 0:
        out.write("\t".join(header) + "\n")
        for i, lb in enumerate(labels):
            _print(lb, "\t".join(map(str, rst[i])), out=out)
    return 0


# ---------------------------------------------------------------------------
# exoneval (paftools.js:2708-2984): exon-level accuracy of spliced/protein
# alignments vs a GTF annotation (adapted from junceval in the JS).
# ---------------------------------------------------------------------------


def exoneval(argv, out=None, err=None):
    out = out or sys.stdout
    err = err or sys.stderr
    l_fuzzy = 0
    print_ovlp = print_err_only = first_only = chr_only = False
    aa = is_bed = use_cds = eval_base = False
    skip_start = skip_last = False
    args = []
    it = iter(argv)
    for a in it:
        if a == "-l":
            l_fuzzy = int(next(it))
        elif a.startswith("-l"):
            l_fuzzy = int(a[2:])
        elif a == "-e":
            print_err_only = print_ovlp = True
        elif a == "-p":
            print_ovlp = True
        elif a == "-c":
            chr_only = True
        elif a == "-a":
            aa = use_cds = True
        elif a == "-b":
            is_bed = True
        elif a == "-1":
            first_only = True
        elif a == "-d":
            use_cds = True
        elif a == "-s":
            eval_base = True
        elif a == "-f":
            skip_start = True
        elif a == "-t":
            skip_last = skip_start = True
        else:
            args.append(a)
    if not args:
        print("Usage: paftools.py exoneval [options] <gene.gtf> <aln.sam>",
              file=sys.stderr)
        return 1

    print("Reading reference GTF...", file=err)
    tr = {}
    for line in _open(args[0]):
        t = line.rstrip("\n").split("\t")
        if t[0].startswith("#") or len(t) < 9:
            continue
        if use_cds:
            if t[2] not in ("cds", "CDS"):
                continue
        elif t[2] != "exon":
            continue
        m = re.search(r'transcript_id "(\S+)"', t[8])
        if m is None:
            continue
        tr.setdefault(m.group(1), [t[0], t[6], 0, 0, []])[4].append(
            [int(t[3]) - 1, int(t[4])])

    anno = {}
    for tid, t in tr.items():
        _intv_sort(t[4])
        for s in t[4]:
            anno.setdefault(t[0], []).append([s[0], s[1]])
    for chrom, e in anno.items():
        _intv_sort(e)
        k = 0
        for i in range(1, len(e)):      # dedup
            if e[i][0] != e[k][0] or e[i][1] != e[k][1]:
                k += 1
                e[k] = e[i][:]
        del e[k + 1:]
        _intv_index_end(e)

    n_pri = n_unmapped = n_mapped = 0
    n_exon = n_exon_hit = n_exon_novel = 0
    last_qname = None
    qexon = {}
    re_cigar = re.compile(r"(\d+)([MIDNSHP=XFGUV])")
    re_chr = re.compile(r"^(chr)?([0-9]+|X|Y)$")

    print("Evaluating alignments...", file=err)
    fp = _open(args[1]) if len(args) > 1 and args[1] != "-" else sys.stdin
    for line in fp:
        t = line.rstrip("\n").split("\t")
        if t[0].startswith("@"):
            continue
        if t[0] == "##PAF":
            t = t[1:]
        qname = t[0]
        cigar = None
        strand = None
        if is_bed:
            ctg_name, pos = t[0], int(t[1])
        elif len(t) > 4 and t[4] in "+-*":      # PAF
            ctg_name, pos, strand = t[5], int(t[7]), t[4]
            typ = "P"
            for x in t[12:]:
                if x.startswith("tp:A:"):
                    typ = x[5:]
                elif x.startswith("cg:Z:"):
                    cigar = x[5:]
            if typ == "S":
                continue
        else:                                    # SAM
            ctg_name, pos, cigar = t[2], int(t[3]) - 1, t[5]
            if int(t[1]) & 0x100:
                continue
        if chr_only and not re_chr.match(ctg_name):
            continue
        if first_only and last_qname == qname:
            continue
        if ctg_name == "*":
            n_unmapped += 1
            continue
        n_pri += 1
        if last_qname != qname:
            n_mapped += 1
            last_qname = qname

        exon = []
        if is_bed:
            exon.append([pos, int(t[2])])
        elif aa:
            tmp_exon, tmp, tmp_st = [], 0, 0
            for m in re_cigar.finditer(cigar):
                ln_, op = int(m.group(1)), m.group(2)
                if op == "N":
                    tmp_exon.append([tmp_st, tmp])
                    tmp_st = tmp + ln_
                    tmp += ln_
                elif op == "U":
                    tmp_exon.append([tmp_st, tmp + 1])
                    tmp_st = tmp + ln_ - 2
                    tmp += ln_
                elif op == "V":
                    tmp_exon.append([tmp_st, tmp + 2])
                    tmp_st = tmp + ln_ - 1
                    tmp += ln_
                elif op in "MX=D":
                    tmp += ln_ * 3
                elif op in "FG":
                    tmp += ln_
            tmp_exon.append([tmp_st, tmp])
            if strand == "+":
                exon = [[pos + s, pos + e] for s, e in tmp_exon]
            elif strand == "-":
                glen = int(t[8]) - int(t[7])
                exon = [[pos + glen - e, pos + glen - s]
                        for s, e in reversed(tmp_exon)]
            if skip_start and exon:
                exon.pop(0)
            if skip_last and exon:
                exon.pop()
        else:
            tmp_st = pos
            for m in re_cigar.finditer(cigar):
                ln_, op = int(m.group(1)), m.group(2)
                if op == "N":
                    exon.append([tmp_st, pos])
                    tmp_st = pos + ln_
                    pos += ln_
                elif op in "MX=D":
                    pos += ln_
            exon.append([tmp_st, pos])
        n_exon += len(exon)

        chrom = anno.get(ctg_name)
        if chrom is None:
            n_exon_novel += len(exon)
            continue
        for i, (es, ee) in enumerate(exon):
            if eval_base:
                qexon.setdefault(ctg_name, []).append([es, ee])
            o = _intv_find_ovlp(chrom, es, ee)
            if o:
                hit = False
                for oj in o:
                    if (abs(es - oj[0]) <= l_fuzzy
                            and abs(ee - oj[1]) <= l_fuzzy):
                        n_exon_hit += 1
                        hit = True
                    if hit:
                        break
                if print_ovlp:
                    if hit and print_err_only:
                        continue
                    x = "[" + ", ".join(f"({oj[0]},{oj[1]})"
                                        for oj in o) + "]"
                    _print("C" if hit else "P", qname, i + 1, ctg_name,
                           es, ee, x, out=out)
            else:
                n_exon_novel += 1
                if print_ovlp:
                    _print("N", qname, i + 1, ctg_name, es, ee, out=out)

    if not print_ovlp:
        pct = n_exon_hit / n_exon * 100 if n_exon else float("nan")
        out.write(f"# unmapped reads: {n_unmapped}\n")
        out.write(f"# mapped reads: {n_mapped}\n")
        out.write(f"# primary alignments: {n_pri}\n")
        out.write(f"# predicted exons: {n_exon}\n")
        out.write(f"# non-overlapping exons: {n_exon_novel}\n")
        out.write(f"# correct exons: {n_exon_hit} ({pct:.2f}%)\n")

    def merge_and_index(ex):
        for chrom in list(ex):
            e = ex[chrom]
            a = []
            _intv_sort(e)
            st, en = e[0][0], e[0][1]
            for s, eo in ((r[0], r[1]) for r in e[1:]):
                if s > en:
                    a.append([st, en])
                    st, en = s, eo
                else:
                    en = max(en, eo)
            a.append([st, en])
            _intv_index_end(a)
            ex[chrom] = a

    def cal_sn(a0, a1):
        tot = cov = 0
        for chrom, e1 in a1.items():
            e0 = a0.get(chrom)
            for r in e1:
                tot += r[1] - r[0]
            if e0 is None:
                continue
            for r in e1:
                for oj in _intv_find_ovlp(e0, r[0], r[1]):
                    cov += min(r[1], oj[1]) - max(r[0], oj[0])
        return tot, cov

    if eval_base:
        print("Computing base Sn and Sp...", file=err)
        merge_and_index(qexon)
        merge_and_index(anno)
        sn = cal_sn(qexon, anno)
        sp = cal_sn(anno, qexon)
        out.write(f"Base Sn: {sn[1]} / {sn[0]} = "
                  f"{sn[1] / sn[0] * 100:.2f}%\n")
        out.write(f"Base Sp: {sp[1]} / {sp[0]} = "
                  f"{sp[1] / sp[0] * 100:.2f}%\n")
    return 0


# ---------------------------------------------------------------------------
# asmgene (paftools.js:866-1007): evaluate gene completeness of an assembly
# from cDNA-to-ref and cDNA-to-asm splice PAFs.
# ---------------------------------------------------------------------------


def asmgene(argv, out=None):
    out = out or sys.stdout
    min_cov = min_iden = 0.99
    print_err = auto_only = False
    args = []
    it = iter(argv)
    for a in it:
        if a == "-i":
            min_iden = float(next(it))
        elif a == "-c":
            min_cov = float(next(it))
        elif a == "-e":
            print_err = True
        elif a == "-a":
            auto_only = True
        elif a.startswith("-i"):
            min_iden = float(a[2:])
        elif a.startswith("-c"):
            min_cov = float(a[2:])
        else:
            args.append(a)
    n_fn = len(args)
    if n_fn < 2:
        print("Usage: paftools.py asmgene [options] <ref-splice.paf> "
              "<asm-splice.paf> [...]", file=sys.stderr)
        return 1

    def process_query(a):
        # a rows: [qname, ql, qs, qe, mlen, blen]
        cnt = [0, 0.0, 0]
        b = [r[:] for r in a if r[4] >= r[5] * min_iden]
        if not b:
            return cnt
        cnt[0] = sum(1 for r in b if r[3] - r[2] >= r[1] * min_cov)
        b.sort(key=lambda x: x[2])
        l_cov, st, en = 0, b[0][2], b[0][3]
        for r in b[1:]:
            if r[2] <= en:
                en = max(en, r[3])
            else:
                l_cov += en - st
        l_cov += en - st
        cnt[1] = l_cov / b[0][1]
        cnt[2] = len(b)
        return cnt

    gene, header, refpos = {}, [], {}
    for i, fn in enumerate(args):
        header.append(re.sub(r"\.paf(\.gz)?$", "", fn))
        a = []
        for line in _open(fn):
            t = line.rstrip("\n").split("\t")
            ql, qs, qe = int(t[1]), int(t[2]), int(t[3])
            mlen, blen = int(t[9]), int(t[10])
            if i == 0:
                refpos[t[0]] = [t[0], int(t[1]), t[5], int(t[7]),
                                int(t[8])]
            gene.setdefault(t[0], {})
            if a and t[0] != a[0][0]:
                gene[a[0][0]][i] = process_query(a)
                a = []
            a.append([t[0], ql, qs, qe, mlen, blen])
        if a:
            gene[a[0][0]][i] = process_query(a)

    # select the longest gene per overlapping ref locus (paftools.js:939-953)
    gene_list = sorted(refpos.values(), key=lambda r: (r[2], r[3]))
    gene_nr = {}
    if gene_list:
        last = 0
        for j in range(1, len(gene_list)):
            if (gene_list[j][2] != gene_list[last][2]
                    or gene_list[j][3] >= gene_list[last][4]):
                gene_nr[gene_list[last][0]] = 1
                last = j
            elif gene_list[j][1] > gene_list[last][1]:
                last = j
        gene_nr[gene_list[last][0]] = 1

    col1 = ["full_sgl", "full_dup", "frag", "part50+", "part10+",
            "part10-", "dup_cnt", "dup_sum"]
    rst = [[0] * n_fn for _ in col1]
    re_xy = re.compile(r"^(chr)?[XY]$")
    for g, gi in gene.items():       # single-copy genes
        if gi.get(0) is None or gi[0][0] != 1:
            continue
        if g not in gene_nr:
            continue
        if auto_only and re_xy.match(refpos[g][2]):
            continue
        rp = "\t".join(map(str, refpos[g]))
        for i in range(n_fn):
            c = gi.get(i)
            if c is None:
                rst[5][i] += 1
                if print_err:
                    _print("M", header[i], rp, out=out)
            elif c[0] == 1:
                rst[0][i] += 1
            elif c[0] > 1:
                rst[1][i] += 1
                if print_err:
                    _print("D", header[i], rp, out=out)
            elif c[1] >= min_cov:
                rst[2][i] += 1
                if print_err:
                    _print("F", header[i], rp, out=out)
            elif c[1] >= 0.5:
                rst[3][i] += 1
                if print_err:
                    _print("5", header[i], rp, out=out)
            elif c[1] >= 0.1:
                rst[4][i] += 1
                if print_err:
                    _print("1", header[i], rp, out=out)
            else:
                rst[5][i] += 1
                if print_err:
                    _print("0", header[i], rp, out=out)
    for g, gi in gene.items():       # multi-copy genes
        if gi.get(0) is None or gi[0][0] <= 1:
            continue
        if g not in gene_nr:
            continue
        if auto_only and re_xy.match(refpos[g][2]):
            continue
        for i in range(n_fn):
            c = gi.get(i)
            if c is not None:
                rst[7][i] += c[0]
            if c is not None and c[0] > 1:
                rst[6][i] += 1
            elif print_err:
                _print("d", header[i], gi[0][0],
                       "\t".join(map(str, refpos[g])), out=out)
    _print("H", "Metric", "\t".join(header), out=out)
    for k, name in enumerate(col1):
        _print("X", name, "\t".join(map(str, rst[k])), out=out)
    return 0


def _parse_num(s):
    """paf_parseNum (paftools.js:3122-3132): float with k/m/g suffix."""
    m = re.match(r"^(\d*\.?\d*)([mMgGkK]?)", s)
    x = float(m.group(1))
    suf = m.group(2).lower()
    if suf == "k":
        x *= 1000
    elif suf == "m":
        x *= 1000000
    elif suf == "g":
        x *= 1000000000
    import math
    return math.floor(x + .499)


# ---------------------------------------------------------------------------
# misjoin (paftools.js:3133-3268): detect assembly misjoins from contig-to-
# reference PAF.
# ---------------------------------------------------------------------------


def misjoin(argv, out=None):
    out = out or sys.stdout
    min_seg_len = max_gap = 1000000
    fn_cen = None
    show_long = show_err = False
    cen_ratio = 0.5
    n_diff, n_gap, n_inv, n_inv_end = [0, 0], [0, 0], [0, 0], [0, 0]
    args = []
    it = iter(argv)
    for a in it:
        if a == "-l":
            min_seg_len = _parse_num(next(it))
        elif a == "-g":
            max_gap = _parse_num(next(it))
        elif a == "-c":
            fn_cen = next(it)
        elif a == "-r":
            cen_ratio = float(next(it))
        elif a == "-p":
            show_long = True
        elif a == "-e":
            show_err = True
        else:
            args.append(a)
    if not args:
        print("Usage: paftools.py misjoin [options] <in.paf>",
              file=sys.stderr)
        return 0
    cen = {}
    if fn_cen is not None:
        for line in _open(fn_cen):
            t = line.rstrip("\n").split("\t")
            cen.setdefault(t[0], []).append((int(t[1]), int(t[2])))

    def test_cen(chrom, st, en):
        b = cen.get(chrom)
        if b is None:
            return False
        length = sum(min(e1, en) - max(s1, st)
                     for s1, e1 in b if s1 < en and e1 > st)
        return length >= (en - st) * cen_ratio

    def test_cen_point(chrom, x):
        b = cen.get(chrom)
        return b is not None and any(s1 <= x < e1 for s1, e1 in b)

    if show_err or show_long:
        out.write("C\tJ  inter-chromosomal misjoin\n")
        out.write("C\tj  inter-chromosomal misjoin with both breakpoints "
                  "ending in centromeres\n")
        out.write("C\tG  long gap on the reference genome\n")
        out.write("C\tg  long gap on the reference genome with both "
                  "breakpoints ending in centromeres\n")
        out.write("C\tM  closed inversion\n")
        out.write("C\n")

    def process(rows):
        a = []
        for t in rows:
            for j in range(1, 4):
                t[j] = int(t[j])
            for j in range(6, 12):
                t[j] = int(t[j])
            if t[10] >= min_seg_len:
                a.append(t)
        if len(a) <= 1:
            return
        a.sort(key=lambda x: x[2])
        if show_long:
            for t in a:
                out.write("\t".join(map(str, t)) + "\n")
        i = 1
        while i < len(a):
            p, q = a[i - 1], a[i]
            ov0 = test_cen(p[5], p[7], p[8])
            ov1 = test_cen(q[5], q[7], q[8])
            ec0 = test_cen_point(p[5], p[8] if p[4] == "+" else p[7])
            ec1 = test_cen_point(q[5], q[7] if q[4] == "+" else q[8])
            if p[5] != q[5]:
                if ov0 or ov1:
                    n_diff[1] += 1
                elif show_err:
                    lb = "j" if ec0 and ec1 else "J"
                    _print(lb, "\t".join(map(str, p[:12])), out=out)
                    _print(lb, "\t".join(map(str, q[:12])), out=out)
                n_diff[0] += 1
            elif p[4] == q[4]:
                dq = q[2] - p[3]
                dr = q[7] - p[8] if q[4] == "+" else p[7] - q[8]
                gap = abs(dr - dq)
                if gap > max_gap:
                    if ov0 or ov1:
                        n_gap[1] += 1
                    elif show_err:
                        lb = "g" if ec0 and ec1 else "G"
                        _print(lb, "\t".join(map(str, p[:12])), out=out)
                        _print(lb, "\t".join(map(str, q[:12])), out=out)
                    n_gap[0] += 1
            elif i + 1 < len(a) and a[i + 1][4] == p[4]:
                if ov0 or ov1:
                    n_inv[1] += 1
                elif show_err:
                    for t in (p, q, a[i + 1]):
                        _print("M", "\t".join(map(str, t[:12])), out=out)
                n_inv[0] += 1
                i += 1
            else:
                if ov0 or ov1:
                    n_inv_end[1] += 1
                n_inv_end[0] += 1
            i += 1

    rows = []
    for line in _open(args[0]):
        t = line.rstrip("\n").split("\t")
        if rows and rows[0][0] != t[0]:
            process(rows)
            rows = []
        rows.append(t)
    if rows:
        process(rows)
    out.write("# inter-chromosomal misjoins: %d,%d\n" % tuple(n_diff))
    out.write("# intra-chromosomal gaps: %d,%d\n" % tuple(n_gap))
    out.write("# candidate inversions in the middle: %d,%d\n"
              % tuple(n_inv))
    out.write("# candidate inversions at contig ends: %d,%d\n"
              % tuple(n_inv_end))
    return 0


# ---------------------------------------------------------------------------
# sveval (paftools.js:3291-3428): SV sensitivity/precision between a base
# and a call VCF with fuzzy windowed matching.
# ---------------------------------------------------------------------------


def sveval(argv, out=None):
    out = out or sys.stdout
    min_flt, min_size, max_size, win_size = 30, 50, 100000, 500
    print_err = print_match = False
    bed_fn = None
    len_diff_ratio = 0.5
    args = []
    it = iter(argv)
    for a in it:
        if a == "-f":
            min_flt = _parse_num(next(it))
        elif a == "-i":
            min_size = _parse_num(next(it))
        elif a == "-x":
            max_size = _parse_num(next(it))
        elif a == "-w":
            win_size = _parse_num(next(it))
        elif a == "-d":
            len_diff_ratio = float(next(it))
        elif a == "-r":
            bed_fn = next(it)
        elif a == "-e":
            print_err = True
        elif a == "-p":
            print_match = True
        else:
            args.append(a)
    if len(args) < 2:
        print("Usage: paftools.py sveval [options] <base.vcf> <call.vcf>",
              file=sys.stderr)
        return 0

    bed = None
    if bed_fn is not None:
        bed = {}
        for line in _open(bed_fn):
            t = line.rstrip("\n").split("\t")
            bed.setdefault(t[0], []).append([int(t[1]), int(t[2])])
        for x in bed:
            _intv_sort(bed[x])
            _intv_merge(bed[x])
            _intv_index_end(bed[x])

    def read_vcf(fn):
        v = {}
        for line in _open(fn):
            t = line.rstrip("\n").split("\t")
            if t[0].startswith("#"):
                continue
            if bed is not None and t[0] not in bed:
                continue
            if t[4] in ("<INV>", "<INVDUP>"):
                continue
            if "[" in t[4] or "]" in t[4]:
                continue
            if t[6] not in (".", "PASS"):
                continue
            st = int(t[1]) - 1
            en = st + len(t[3])
            svlen, _, _ = _vcf_get_alen(t)
            abslen = 0 if svlen is None else abs(svlen)
            if abslen < min_flt or abslen > max_size:
                continue
            m = re.search(r"(^|;)END=(\d+)", t[7])
            if m is not None:
                en = int(m.group(2))
            elif svlen is not None and svlen < 0:
                en = st - svlen
            if en < st:
                en = st
            if st == en:
                st -= 1
                en += 1
            if bed is not None and not _intv_find_ovlp(bed[t[0]], st, en):
                continue
            v.setdefault(t[0], []).append([st, en, svlen, abslen])
        for x in v:
            _intv_sort(v[x])
            _intv_index_end(v[x])
        return v

    def compare(v0, v1, label):
        m_cnt = n_cnt = 0
        for x, a1 in v1.items():
            a0 = v0.get(x)
            for r in a1:
                if r[3] < min_size:
                    continue
                n_cnt += 1
                if a0 is None:
                    continue
                ws = win_size + (r[3] >> 1)
                st = r[0] - ws if r[0] > ws else 0
                b = _intv_find_ovlp(a0, st, r[1] + ws)
                n_ins = n_del = 0
                sv_del = sv_ins = None
                for o in b:
                    if o[2] < 0:
                        n_del += 1
                        sv_del = -o[2]
                    elif o[2] > 0:
                        n_ins += 1
                        sv_ins = o[2]
                    if print_match:
                        _print("MA", x, "\t".join(map(str, r[:3])),
                               "\t".join(map(str, o[:3])), out=out)
                match = False
                if r[2] is not None and r[2] > 0:
                    if n_ins == 1:
                        diff = abs(sv_ins - r[3])
                        if diff < min_size or diff / r[3] < len_diff_ratio:
                            match = True
                    elif n_ins > 1:
                        match = True
                elif r[2] is not None and r[2] < 0:
                    if n_del == 1:
                        diff = abs(sv_del - r[3])
                        if diff < min_size or diff / r[3] < len_diff_ratio:
                            match = True
                    elif n_del > 1:
                        match = True
                if match:
                    m_cnt += 1
                elif print_err:
                    if ((r[2] is not None and r[2] > 0 and n_ins > 0)
                            or (r[2] is not None and r[2] < 0
                                and n_del > 0)):
                        _print("MM", x, "\t".join(map(str, r[:3])), out=out)
                    _print(label, x, "\t".join(map(str, r[:3])), out=out)
        return n_cnt, m_cnt

    v_base = read_vcf(args[0])
    v_call = read_vcf(args[1])
    fn = compare(v_call, v_base, "FN")
    fp = compare(v_base, v_call, "FP")
    _print("SN", fn[0], fn[1], f"{fn[1] / fn[0]:.6f}", out=out)
    _print("PC", fp[0], fp[1], f"{fp[1] / fp[0]:.6f}", out=out)
    _print("F1", f"{(fn[1] / fn[0] + fp[1] / fp[0]) / 2:.6f}", out=out)
    return 0


# ---------------------------------------------------------------------------
# paf2gff (paftools.js:3621-3714): miniprot-style PAF (with cg including
# F/G/R/N/U/V ops) to GFF.
# ---------------------------------------------------------------------------


def paf2gff(argv, out=None):
    out = out or sys.stdout
    aa = False
    args = []
    for x in argv:
        if x == "-a":
            aa = True
        else:
            args.append(x)
    if not args:
        print("Usage: paftools.py paf2gff [-a] <in.paf>", file=sys.stderr)
        return 0
    re_cigar = re.compile(r"(\d+)([A-Z=])")
    hid, last_name = 1, None
    for line in _open(args[0]):
        t = line.rstrip("\n").split("\t")
        if t[5] == "*":
            continue
        if t[0] != last_name:
            last_name, hid = t[0], 1
        else:
            hid += 1
        for i in range(1, 4):
            t[i] = int(t[i])
        for i in range(6, 12):
            t[i] = int(t[i])
        cigar = score = np_ = dist_stop = dist_start = None
        for x in t[12:]:
            if x.startswith("cg:Z:"):
                cigar = x[5:]
            elif x.startswith("AS:i:"):
                score = int(x[5:])
            elif x.startswith("np:i:"):
                np_ = int(x[5:])
            elif x.startswith("do:i:"):
                dist_stop = int(x[5:])
            elif x.startswith("da:i:"):
                dist_start = int(x[5:])
        if cigar is None:
            raise RuntimeError("failed to find the cg:Z tag")
        if score is None:
            raise RuntimeError("failed to find the AS:i tag")
        st = en = phase = fs = 0
        pseudo = False
        a = []
        if dist_start == 0:
            a.append([t[5], "paf2gff", "start_codon", 0, 3, 0, t[4],
                      ".", 0])
        for m in re_cigar.finditer(cigar):
            ln_, op = int(m.group(1)), m.group(2)
            if op in ("M", "D"):
                en += ln_ * 3 if aa else ln_
            elif op in ("F", "G", "R"):
                en += ln_
                pseudo = True
                fs = 1
            elif op == "N":
                a.append([t[5], "paf2gff", "exon", st, en, 0, t[4],
                          phase, fs])
                st = en + ln_
                en += ln_
                phase = fs = 0
            elif op == "U":      # ...xGT...AGxx...
                a.append([t[5], "paf2gff", "exon", st, en + 1, 0, t[4],
                          phase, fs])
                st = en + ln_ - 2
                en += ln_
                phase, fs = 2, 0
            elif op == "V":      # ...xxGT...AGx...
                a.append([t[5], "paf2gff", "exon", st, en + 2, 0, t[4],
                          phase, fs])
                st = en + ln_ - 1
                en += ln_
                phase, fs = 1, 0
        a.append([t[5], "paf2gff", "exon", st, en, 0, t[4], phase, fs])
        if en != t[8] - t[7]:
            raise RuntimeError("inconsistent cigar")
        if dist_stop == 0:
            a.append([t[5], "paf2gff", "stop_codon", en, en + 3, 0, t[4],
                      ".", 0])
        typ = "pseudogene" if pseudo else "protein_coding"
        attr = f"transcript_id={t[0]}#{hid};transcript_type={typ}"
        trans_attr = f"identity={t[9] / t[10]:.4f}"
        if np_ is not None:
            trans_attr += f";positive={np_ * 3 / t[10]:.4f}"
        trans_attr += f";aa_start={t[2]};aa_end={t[1] - t[3]}"
        if dist_start is not None and dist_start >= 0:
            trans_attr += f";dist_start_codon={dist_start}"
        if dist_stop is not None and dist_stop >= 0:
            trans_attr += f";dist_stop_codon={dist_stop}"
        trans_st, trans_en = t[7], t[8]
        if dist_stop == 0:
            if t[4] == "-":
                trans_st -= 3
            else:
                trans_en += 3
        _print(t[5], "paf2gff", "transcript", trans_st + 1, trans_en,
               score, t[4], ".", attr + ";" + trans_attr, out=out)
        if aa and t[4] == "-":
            ln_ = t[8] - t[7]
            b = []
            for r in reversed(a):
                r[3], r[4] = ln_ - r[4], ln_ - r[3]
                b.append(r)
            a = b
        for r in a:
            if not pseudo and r[2] == "exon":
                r[2] = "CDS"
            r[3] += t[7] + 1
            r[4] += t[7]
            r[8] = attr + f";frameshift={r[8]}"
            _print(*r, out=out)
    return 0


# ---------------------------------------------------------------------------
# badread2fa (paftools.js:2446-2492): rename Badread-simulated reads so that
# truth coordinates are encoded in the name (mapeval-compatible).
# ---------------------------------------------------------------------------


def badread2fa(argv, out=None, err=None):
    out = out or sys.stdout
    err = err or sys.stderr
    if len(argv) < 2:
        print("Usage: paftools.py badread2fa <ref.fa.fai> <badread.fq>",
              file=sys.stderr)
        return 1
    ln = {}
    for line in _open(argv[0]):
        t = line.rstrip("\n").split("\t")
        ln[t[0]] = int(t[1])
    re_hdr = re.compile(
        r"\s(\S+),([+-])strand,(\d+)-(\d+).*read_identity=([0-9.]+)%")
    rid = 0
    n_discard = 0
    f = _open(argv[1])
    it = iter(f)
    for line in it:
        line = line.rstrip("\n")
        is_fq = line.startswith("@")
        a = tag = None
        m = re_hdr.search(line)
        if " chimera " not in line and m is not None:
            if m.group(1) not in ln:
                raise RuntimeError(
                    "failed to find the contig length of " + m.group(1))
            st, en = int(m.group(3)), int(m.group(4))
            if m.group(2) == "+":
                a = [f"S{rid + 1}", m.group(1), st, en, "+"]
            else:
                L = ln[m.group(1)]
                a = [f"S{rid + 1}", m.group(1), L - en, L - st, "-"]
            tag = "ri:f:" + m.group(5)
        seq = next(it).rstrip("\n")
        if is_fq:
            next(it)
            next(it)
        if a is not None:
            _print(">" + "!".join(map(str, a)), tag, out=out)
            out.write(seq + "\n")
        else:
            n_discard += 1
        rid += 1
    print(f"WARNING: discarded {n_discard} reads", file=err)
    return 0


# ---------------------------------------------------------------------------
# longcs2seq (paftools.js:3582-3620): reconstruct target/query sequences from
# long-form cs tags.
# ---------------------------------------------------------------------------


def longcs2seq(argv, out=None):
    out = out or sys.stdout
    query = False
    args = []
    for a in argv:
        if a == "-q":
            query = True
        else:
            args.append(a)
    if not args:
        print("Usage: paftools.py longcs2seq [-q] <long-cs.paf>",
              file=sys.stderr)
        return 0
    re_cs = re.compile(r"([:=*+-])(\d+|[A-Za-z]+)")
    for line in _open(args[0]):
        t = line.rstrip("\n").split("\t")
        cs = None
        for x in t[12:]:
            if x.startswith("cs:Z:"):
                cs = x[5:]
                break
        if cs is None:
            continue
        ts, qs = [], []
        for m in re_cs.finditer(cs):
            op, s = m.group(1), m.group(2)
            if op == "=":
                ts.append(s)
                qs.append(s)
            elif op == "+":
                qs.append(s.upper())
            elif op == "-":
                ts.append(s.upper())
            elif op == "*":
                ts.append(s[0].upper())
                qs.append(s[1].upper())
            else:
                raise RuntimeError("Long cs is required")
        if query:
            out.write(f">{t[0]}_{t[2]}_{t[3]}\n{''.join(qs)}\n")
        else:
            out.write(f">{t[5]}_{t[7]}_{t[8]}\n{''.join(ts)}\n")
    return 0


# ---------------------------------------------------------------------------
# gff2junc (paftools.js:3716-3755): junction BED from GFF3 feature pairs.
# ---------------------------------------------------------------------------


def gff2junc(argv, out=None):
    feat = "CDS"
    args = []
    it = iter(argv)
    for a in it:
        if a == "-f":
            feat = next(it)
        elif a.startswith("-f"):
            feat = a[2:]
        else:
            args.append(a)
    if not args:
        print("Usage: paftools.py gff2junc [-f feature] <in.gff3>",
              file=sys.stderr)
        return 0

    def process_a(a):
        if len(a) < 2:
            return
        a.sort(key=lambda x: x[4])
        for i in range(1, len(a)):
            _print(a[i][1], a[i - 1][5], a[i][4], a[i][0], 0, a[i][7],
                   out=out)

    rows = []
    for line in _open(args[0]):
        t = line.rstrip("\n").split("\t")
        if t[0].startswith("#") or len(t) < 9:
            continue
        if t[2].lower() != feat.lower():
            continue
        m = re.search(r"\bParent=([^;]+)", t[8])
        if m is None:
            print("Can't find Parent", file=sys.stderr)
            continue
        t[3] = int(t[3]) - 1
        t[4] = int(t[4])
        t = [m.group(1)] + t
        if rows and rows[0][0] != m.group(1):
            process_a(rows)
            rows = [t]
        else:
            rows.append(t)
    process_a(rows)
    return 0


# ---------------------------------------------------------------------------
# vcfstat (paftools.js:3057-3121): substitution/indel-size summary of a VCF.
# ---------------------------------------------------------------------------


def vcfstat(argv, out=None):
    ts_set = {"AG", "GA", "CT", "TC"}
    x = dict(sub=0, ts=0, tv=0, ins=0, delc=0, ins1=0, del1=0, ins2=0,
             del2=0, ins50=0, del50=0, ins1k=0, del1k=0, ins7k=0, del7k=0,
             insinf=0, delinf=0)
    f = _open(argv[0]) if argv else sys.stdin
    for line in f:
        t = line.rstrip("\n").split("\t")
        if t[0].startswith("#") or len(t) < 5:
            continue
        ref = t[3]
        for a in t[4].split(","):
            # JS checks a[0]=='<' || a[1]=='>' (symbolic alleles)
            if a.startswith("<") or (len(a) > 1 and a[1] == ">"):
                continue
            for rj, aj in zip(ref, a):
                if rj != aj:
                    x["sub"] += 1
                    if rj + aj in ts_set:
                        x["ts"] += 1
                    else:
                        x["tv"] += 1
            d = len(a) - len(ref)
            if d > 0:
                x["ins"] += 1
                if d == 1:
                    x["ins1"] += 1
                elif d == 2:
                    x["ins2"] += 1
                elif d < 50:
                    x["ins50"] += 1
                elif d < 1000:
                    x["ins1k"] += 1
                elif d < 7000:
                    x["ins7k"] += 1
                else:
                    x["insinf"] += 1
            elif d < 0:
                d = -d
                x["delc"] += 1
                if d == 1:
                    x["del1"] += 1
                elif d == 2:
                    x["del2"] += 1
                elif d < 50:
                    x["del50"] += 1
                elif d < 1000:
                    x["del1k"] += 1
                elif d < 7000:
                    x["del7k"] += 1
                else:
                    x["delinf"] += 1
    o = out or sys.stdout
    tstv = x["ts"] / x["tv"] if x["tv"] else float("nan")
    o.write(f"# substitutions: {x['sub']}\n")
    o.write(f"ts/tv: {tstv:.3f}\n")
    o.write(f"# insertions: {x['ins']}\n")
    o.write(f"# 1bp insertions: {x['ins1']}\n")
    o.write(f"# 2bp insertions: {x['ins2']}\n")
    o.write(f"# [3,50) insertions: {x['ins50']}\n")
    o.write(f"# [50,1000) insertions: {x['ins1k']}\n")
    o.write(f"# [1000,7000) insertions: {x['ins7k']}\n")
    o.write(f"# >=7000 insertions: {x['insinf']}\n")
    o.write(f"# deletions: {x['delc']}\n")
    o.write(f"# 1bp deletions: {x['del1']}\n")
    o.write(f"# 2bp deletions: {x['del2']}\n")
    o.write(f"# [3,50) deletions: {x['del50']}\n")
    o.write(f"# [50,1000) deletions: {x['del1k']}\n")
    o.write(f"# [1000,7000) deletions: {x['del7k']}\n")
    o.write(f"# >=7000 deletions: {x['delinf']}\n")
    return 0


# ---------------------------------------------------------------------------
# vcfsel (paftools.js:3430-3467) + _paf_get_alen (:3270-3290): select VCF
# records by allele-length difference.
# ---------------------------------------------------------------------------


def _vcf_get_alen(t):
    """[alen, min_abs_diff, max_abs_diff] per paftools.js:3270-3290."""
    svlen = alen = None
    m = re.search(r"(^|;)SVLEN=(-?\d+)", t[7])
    if m is not None:
        svlen = int(m.group(2))
    min_abs = 1 << 30
    max_abs = 0
    if svlen is not None and svlen != 0:
        alen = svlen
        min_abs = max_abs = abs(svlen)
    rlen = len(t[3])
    for s in t[4].split(","):
        if re.match(r"^<\S+>$", s):
            continue
        diff = len(s) - rlen
        abs_diff = abs(diff)
        min_abs = min(min_abs, abs_diff)
        if max_abs < abs_diff:
            max_abs, alen = abs_diff, diff
    return alen, min_abs, max_abs


def vcfsel(argv, out=None, err=None):
    out = out or sys.stdout
    err = err or sys.stderr
    min_l, max_l = 0, 1 << 30
    args = []
    it = iter(argv)
    for a in it:
        if a == "-l":
            min_l = int(next(it))
        elif a == "-L":
            max_l = int(next(it))
        elif a.startswith("-l"):
            min_l = int(a[2:])
        elif a.startswith("-L"):
            max_l = int(a[2:])
        else:
            args.append(a)
    if not args:
        print("Usage: paftools.py vcfsel [options] <in.vcf>",
              file=sys.stderr)
        return 1
    for line in _open(args[0]):
        line = line.rstrip("\n")
        if line.startswith("#"):
            out.write(line + "\n")
            continue
        t = line.split("\t")
        st = int(t[1])
        en = st + len(t[3]) - 1
        m = re.search(r"(^|;)END=(\d+)", t[7])
        if m is not None:
            en = int(m.group(2))
        if en < st:
            print(f"END is smaller than POS: {en} < {st}", file=err)
        _, min_abs, max_abs = _vcf_get_alen(t)
        if max_abs < min_l or min_abs > max_l:
            continue
        out.write(line + "\n")
    return 0


# ---------------------------------------------------------------------------
# vcfpair (paftools.js:1308-1405): merge the per-haplotype pair VCF produced
# by `paftools call` on dipcall-style two-haplotype alignments.
# ---------------------------------------------------------------------------


def vcfpair(argv, out=None, err=None):
    out = out or sys.stdout
    err = err or sys.stderr
    is_male = False
    sample = "syndip"
    hgver = None
    PAR = {"37": [(0, 2699520), (154931043, 155260560)]}
    args = []
    it = iter(argv)
    for a in it:
        if a == "-m":
            is_male = True
        elif a == "-s":
            sample = next(it)
        elif a == "-g":
            hgver = next(it)
        elif a.startswith("-s"):
            sample = a[2:]
        elif a.startswith("-g"):
            hgver = a[2:]
        else:
            args.append(a)
    if is_male and (hgver is None or hgver not in PAR):
        raise RuntimeError(
            "for a male, -g must be specified to properly handle PARs on "
            "chrX")
    if not args:
        print("Usage: paftools.py vcfpair [options] <in.pair.vcf>",
              file=sys.stderr)
        return 1
    re_ctg = (re.compile(r"^(chr)?([0-9]+|X|Y)$") if is_male
              else re.compile(r"^(chr)?([0-9]+|X)$"))
    re_gt = re.compile(r"^(\.|[0-9]+)/(\.|[0-9]+):(\S+)")
    label = ["1", "2"]
    for line in _open(args[0]):
        line = line.rstrip("\n")
        if line.startswith("#"):
            if re.match(r"^##(source|reference)=", line):
                continue
            m = re.match(r"^##contig=.*ID=([^\s,]+)", line)
            if m is not None:
                if not re_ctg.match(m.group(1)):
                    continue
            elif line.startswith("#CHROM"):
                t = line.split("\t")[:-1]
                t[-1] = sample
                line = "\t".join(t)
                out.write('##FILTER=<ID=HET1,Description="Heterozygous in '
                          'the first haplotype">\n')
                out.write('##FILTER=<ID=HET2,Description="Heterozygous in '
                          'the second haplotype">\n')
                out.write('##FILTER=<ID=GAP1,Description="Uncalled in the '
                          'first haplotype">\n')
                out.write('##FILTER=<ID=GAP2,Description="Uncalled in the '
                          'second haplotype">\n')
            out.write(line + "\n")
            continue
        t = line.split("\t")
        if not re_ctg.match(t[0]):
            continue
        AD = None
        FILTER = []
        HT = [None, None]
        for i in range(2):
            m = re_gt.match(t[9 + i])
            if m is None:
                print(line, file=err)
                raise RuntimeError("malformatted VCF")
            s = m.group(3).split(",")
            if AD is None:
                AD = [0] * len(s)
            for j, v in enumerate(s):
                AD[j] += int(v)
            if m.group(1) == ".":
                FILTER.append("GAP" + label[i])
                HT[i] = "."
            elif m.group(1) != m.group(2):
                FILTER.append("HET" + label[i])
                HT[i] = "."
            else:
                HT[i] = m.group(1)
        t = t[:-1]
        # haploid-region special case (chrX outside PAR, chrY in males)
        hap = 0
        st = int(t[1])
        en = st + len(t[3])
        if is_male:
            if re.match(r"^(chr)?X", t[0]):
                if hgver is not None and hgver in PAR:
                    in_par = any(r0 <= st and en <= r1
                                 for r0, r1 in PAR[hgver])
                    hap = 0 if in_par else 2
            elif re.match(r"^(chr)?Y", t[0]):
                hap = 1
        if hap > 0 and len(FILTER) == 1:
            if ((hap == 2 and FILTER[0] == "GAP1")
                    or (hap == 1 and FILTER[0] == "GAP2")):
                FILTER = []
        t[5] = "30"
        t[6] = ";".join(FILTER) if FILTER else "."
        t[9] = "|".join(HT) + ":" + ",".join(map(str, AD))
        out.write("\t".join(map(str, t)) + "\n")
    return 0


# ---------------------------------------------------------------------------
# pafcmp (paftools.js:3468-3580): compare two PAFs of the same reads.
# ---------------------------------------------------------------------------


def pafcmp(argv, out=None, err=None):
    out = out or sys.stdout
    err = err or sys.stderr
    min_len, min_mapq, min_ovlp = 5000, 10, 0.5
    args = []
    it = iter(argv)
    for a in it:
        if a == "-q":
            min_mapq = int(next(it))
        elif a.startswith("-q"):
            min_mapq = int(a[2:])
        else:
            args.append(a)
    if len(args) < 2:
        print("Usage: paftools.py pafcmp [options] <base.paf> <test.paf>",
              file=sys.stderr)
        print(f"Options:\n  -q INT    min mapping quality [{min_mapq}]",
              file=sys.stderr)
        return 1
    ev = dict(n_base=0, n_test=0, n_hit=0, n_wrong=0, n_miss=0)
    # NB the JS increments opt.n_out_high/low (a quirk: the printed
    # eval.n_out_high therefore always stays 0); reproduced faithfully.
    base = {}

    def read_groups(fn):
        grp = []
        for line in _open(fn):
            line = line.rstrip("\n")
            if "\ttp:A:S" in line:
                continue
            t = line.split("\t")
            if grp and grp[0][0] != t[0]:
                yield grp
                grp = []
            grp.append(t)
        if grp:
            yield grp

    print(f"Reading {args[0]}...", file=err)
    for grp in read_groups(args[0]):
        if len(grp) != 1:
            continue
        r = grp[0]
        if int(r[1]) < min_len:
            continue
        if int(r[11]) >= min_mapq:
            ev["n_base"] += 1
        base[r[0]] = [r[5], int(r[7]), int(r[8]), int(r[11]), 0, 0]

    print(f"Reading {args[1]}...", file=err)
    for grp in read_groups(args[1]):
        r = grp[0]
        if int(r[1]) < min_len:
            continue
        if int(r[11]) >= min_mapq:
            ev["n_test"] += 1
        c = [r[5], int(r[7]), int(r[8]), int(r[11])]
        b = base.get(r[0])
        if b is None:
            continue  # JS counts into never-printed opt.n_out_* here
        inter = 0
        union = (b[2] - b[1]) + (c[2] - c[1])
        if b[0] == c[0]:
            if b[1] < c[1]:
                if b[2] > c[1]:
                    inter, union = b[2] - c[1], c[2] - b[1]
            else:
                if c[2] > b[1]:
                    inter, union = c[2] - b[1], b[2] - c[1]
        if inter >= union * min_ovlp:
            if b[3] >= min_mapq:
                ev["n_hit"] += 1
            b[4] += 1
        else:
            if b[3] >= min_mapq:
                _print("W", r[0], "\t".join(map(str, b[:4])),
                       "\t".join(map(str, c)), out=out)
                ev["n_wrong"] += 1
            b[5] += 1

    for name, b in base.items():
        if b[3] >= min_mapq and b[4] == 0 and b[5] == 0:
            ev["n_miss"] += 1
            _print("M", name, "\t".join(map(str, b[:4])), out=out)

    _print("X", f"{ev['n_base']} base alignments with mapQ>={min_mapq}",
           out=out)
    _print("X", f"{ev['n_hit']} base alignments correctly mapped by test",
           out=out)
    _print("X", f"{ev['n_wrong']} wrong test alignment", out=out)
    _print("X", f"{ev['n_miss']} base alignments missing", out=out)
    _print("X", f"0 additional test alignments with mapQ>={min_mapq}",
           out=out)
    return 0


_CMDS = {
    "sam2paf": sam2paf,
    "mapeval": mapeval,
    "stat": stat,
    "junceval": junceval,
    "view": view,
    "call": call,
    "ov-eval": ov_eval,
    "gff2bed": gff2bed,
    "liftover": liftover,
    "splice2bed": splice2bed,
    "delta2paf": delta2paf,
    "bedcov": bedcov,
    "mason2fq": mason2fq,
    "pbsim2fq": pbsim2fq,
    "sim2bed": sim2bed,
    "badread2fa": badread2fa,
    "longcs2seq": longcs2seq,
    "gff2junc": gff2junc,
    "vcfstat": vcfstat,
    "vcfsel": vcfsel,
    "vcfpair": vcfpair,
    "pafcmp": pafcmp,
    "misjoin": misjoin,
    "sveval": sveval,
    "paf2gff": paf2gff,
    "asmstat": asmstat,
    "asmgene": asmgene,
    "exoneval": exoneval,
}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("Usage: paftools.py <command> [arguments]", file=sys.stderr)
        print("Commands:", file=sys.stderr)
        for c in list(_CMDS) + ["version"]:
            print(f"  {c}", file=sys.stderr)
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "version":
        print(MM_VERSION.split("-")[0])
        return 0
    if cmd not in _CMDS:
        print(f"ERROR: unrecognized command '{cmd}'", file=sys.stderr)
        return 1
    return _CMDS[cmd](rest)


if __name__ == "__main__":
    sys.exit(main())
