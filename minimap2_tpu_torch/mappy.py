"""mappy-compatible Python API (reference python/mappy.pyx:10-297,
python/cmappy.h:60-152) over the port's host mapping path (copy of
minimap2_tpu.mappy): config's presets and mapopt_update, index.MiniIndex,
io.fastx, io.tags and map.pipeline.map_frag_core, whose sketch, anchors,
chaining and DPs run through native/host_map.cpp.  Like the JAX package's
mappy it touches no device.

    import minimap2_tpu_torch.mappy as mp
    a = mp.Aligner("ref.fa", preset="map-ont")
    for name, seq, qual in mp.fastx_read("reads.fq"):
        for hit in a.map(seq, name=name, cs=True):
            print(name, hit.ctg, hit.r_st, hit.r_en, hit.cigar_str)

A target that does not end in .npz is read as FASTA, as the JAX package
does, so a .mmi target is parsed as FASTA text (the reference mappy loads
it as an index).
"""
from __future__ import annotations

from . import config as C
from .config import IndexOptions, MapOptions, mapopt_update, set_opt
from .index.index import MiniIndex
from .io.fastx import FastxReader
from .io.tags import write_cs_ds_md
from .map.pipeline import map_frag_core

_COMP = bytes.maketrans(b"ACGTURYSWKMBDHVNacgturyswkmbdhvn",
                        b"TGCAAYRSWMKVHDBNtgcaayrswmkvhdbn")
_verbose = 1


def verbose(v=None):
    """mm_verbose_level (cmappy.h:60-64)."""
    global _verbose
    if v is None:
        v = -1
    if v >= 0:
        _verbose = v
    return _verbose


def revcomp(seq):
    """mappy.revcomp (cmappy.h:110-119)."""
    b = seq if isinstance(seq, bytes) else seq.encode()
    return b.translate(_COMP)[::-1].decode()


def fastx_read(fn, read_comment=False):
    """mappy.fastx_read (mappy.pyx:269-287): yields (name, seq, qual
    [, comment])."""
    rd = FastxReader(fn)
    try:
        while True:
            rec = rd.read1()
            if rec is None:
                break
            qual = rec.qual.decode() if rec.qual else None
            if read_comment:
                yield rec.name, rec.seq.decode(), qual, rec.comment or None
            else:
                yield rec.name, rec.seq.decode(), qual
    finally:
        rd.close()


class Alignment:
    """mappy.Alignment (mappy.pyx:10-105)."""

    def __init__(self, ctg, ctg_len, r_st, r_en, strand, q_st, q_en, mapq,
                 cigar, is_primary, mlen, blen, NM, trans_strand, seg_id,
                 cs_str="", ds_str="", MD_str=""):
        self._ctg, self._ctg_len = ctg, ctg_len
        self._r_st, self._r_en = r_st, r_en
        self._strand = strand
        self._q_st, self._q_en = q_st, q_en
        self._mapq = mapq
        self._cigar = cigar
        self._is_primary = is_primary
        self._mlen, self._blen, self._NM = mlen, blen, NM
        self._trans_strand = trans_strand
        self._seg_id = seg_id
        self._cs, self._ds, self._MD = cs_str, ds_str, MD_str

    ctg = property(lambda s: s._ctg)
    ctg_len = property(lambda s: s._ctg_len)
    r_st = property(lambda s: s._r_st)
    r_en = property(lambda s: s._r_en)
    strand = property(lambda s: s._strand)
    trans_strand = property(lambda s: s._trans_strand)
    blen = property(lambda s: s._blen)
    mlen = property(lambda s: s._mlen)
    NM = property(lambda s: s._NM)
    is_primary = property(lambda s: s._is_primary != 0)
    q_st = property(lambda s: s._q_st)
    q_en = property(lambda s: s._q_en)
    mapq = property(lambda s: s._mapq)
    cigar = property(lambda s: s._cigar)
    read_num = property(lambda s: s._seg_id + 1)
    cs = property(lambda s: s._cs)
    ds = property(lambda s: s._ds)
    MD = property(lambda s: s._MD)

    @property
    def cigar_str(self):
        return "".join(f"{l}{'MIDNSHP=XB'[op]}" for l, op in self._cigar)

    def __str__(self):
        strand = "+" if self._strand > 0 else ("-" if self._strand < 0
                                               else "?")
        tp = "tp:A:P" if self._is_primary else "tp:A:S"
        ts = ("ts:A:" + ("+" if self._trans_strand > 0
                         else "-" if self._trans_strand < 0 else ".")) \
            if self._trans_strand else None
        fields = [str(self._q_st), str(self._q_en), strand, self._ctg,
                  str(self._ctg_len), str(self._r_st), str(self._r_en),
                  str(self._mlen), str(self._blen), str(self._mapq), tp,
                  ts, "cg:Z:" + self.cigar_str]
        if self._cs:
            fields.append("cs:Z:" + self._cs)
        if self._MD:
            fields.append("MD:Z:" + self._MD)
        return "\t".join(f for f in fields if f is not None)


class ThreadBuffer:
    """API-compat placeholder (no per-thread arenas in this framework)."""


class Aligner:
    """mappy.Aligner (mappy.pyx:116-268)."""

    def __init__(self, fn_idx_in=None, preset=None, k=None, w=None,
                 min_cnt=None, min_chain_score=None, min_dp_score=None,
                 bw=None, bw_long=None, best_n=None, n_threads=3,
                 fn_idx_out=None, max_frag_len=None, extra_flags=None,
                 seq=None, scoring=None, sc_ambi=None, max_chain_skip=None):
        io = IndexOptions()
        mo = MapOptions()
        if preset is not None:
            if set_opt(preset, io, mo) < 0:
                raise ValueError(f"unknown preset '{preset}'")
        mo.flag |= C.MM_F_CIGAR                 # always perform alignment
        if k is not None:
            io.k = k
        if w is not None:
            io.w = w
        if min_cnt is not None:
            mo.min_cnt = min_cnt
        if min_chain_score is not None:
            mo.min_chain_score = min_chain_score
        if min_dp_score is not None:
            mo.min_dp_max = min_dp_score
        if bw is not None:
            mo.bw = bw
        if bw_long is not None:
            mo.bw_long = bw_long
        if best_n is not None:
            mo.best_n = best_n
        if max_frag_len is not None:
            mo.max_frag_len = max_frag_len
        if extra_flags is not None:
            mo.flag |= extra_flags
        if scoring is not None and len(scoring) >= 4:
            mo.a, mo.b, mo.q, mo.e = scoring[:4]
            mo.q2, mo.e2 = mo.q, mo.e
            if len(scoring) >= 6:
                mo.q2, mo.e2 = scoring[4], scoring[5]
                if len(scoring) >= 7:
                    mo.sc_ambi = scoring[6]
        if sc_ambi is not None:
            mo.sc_ambi = sc_ambi
        if max_chain_skip is not None:
            mo.max_chain_skip = max_chain_skip
        self.idx_opt, self.map_opt = io, mo
        self._idx = None
        if seq is not None:
            self._idx = MiniIndex.build(["N/A"], [seq], w=io.w, k=io.k,
                                        b=io.bucket_bits, flag=io.flag)
            mapopt_update(mo, self._idx)
            mo.mid_occ = 1000      # don't filter high-occ seeds (mappy.pyx)
        elif fn_idx_in is not None:
            if fn_idx_in.endswith(".npz"):
                self._idx = MiniIndex.load(fn_idx_in)
            else:
                from .io.fastx import read_fasta
                names, seqs = read_fasta(fn_idx_in)
                self._idx = MiniIndex.build(names, seqs, w=io.w, k=io.k,
                                            b=io.bucket_bits, flag=io.flag)
            if fn_idx_out is not None:
                self._idx.save(fn_idx_out)
            mapopt_update(mo, self._idx)

    def __bool__(self):
        return self._idx is not None

    def map(self, seq, seq2=None, name=None, buf=None, cs=False, ds=False,
            MD=False, max_frag_len=None, extra_flags=None):
        """Yield Alignment objects for one read (or read pair)."""
        if self._idx is None:
            return
        import copy
        mo = self.map_opt
        if max_frag_len is not None or extra_flags is not None:
            mo = copy.copy(mo)
            if max_frag_len is not None:
                mo.max_frag_len = max_frag_len
            if extra_flags is not None:
                mo.flag |= extra_flags
        seq1 = seq if isinstance(seq, bytes) else seq.encode()
        if seq2 is None:
            results = map_frag_core(self._idx, [seq1], mo, name)
            per_seg = [(results[0].regs, seq1)]
        else:
            # mm_map_aux (cmappy.h:73-108): revcomp the mate, map 2 segs,
            # flip the mate's strand back
            s2 = seq2 if isinstance(seq2, bytes) else seq2.encode()
            s2rc = s2.translate(_COMP)[::-1]
            results = map_frag_core(self._idx, [seq1, s2rc], mo, name)
            for r in results[1].regs:
                r.rev = 0 if r.rev else 1
            per_seg = [(results[0].regs, seq1), (results[1].regs, s2rc)]
        for regs, qseq in per_seg:
            for r in regs:
                if r.p is None:
                    continue
                cig = [[c >> 4, c & 0xF] for c in r.p.cigar]
                _cs = _ds = _MD = ""
                if cs:
                    _cs = write_cs_ds_md(self._idx, name, qseq, r, True,
                                         False, False, False, False)
                if ds:
                    _ds = write_cs_ds_md(self._idx, name, qseq, r, True,
                                         False, True, False, False)
                if MD:
                    _MD = write_cs_ds_md(self._idx, name, qseq, r, False,
                                         True, False, False, False)
                sm = self._idx.seq[r.rid]
                yield Alignment(
                    sm.name, sm.length, r.rs, r.re,
                    -1 if r.rev else 1, r.qs, r.qe, r.mapq, cig,
                    1 if r.id == r.parent else 0, r.mlen, r.blen,
                    r.blen - r.mlen + (r.p.n_ambi if r.p else 0),
                    (1 if r.p.trans_strand == 1 else
                     -1 if r.p.trans_strand == 2 else 0) if r.p else 0,
                    r.seg_id, _cs, _ds, _MD)

    def seq(self, name, start=0, end=0x7FFFFFFF):
        """mappy_fetch_seq (cmappy.h:122-138)."""
        if self._idx is None:
            return None
        rid = self._idx.name2id(name)
        if rid < 0:
            return None
        ln = self._idx.seq[rid].length
        if start >= ln or start >= end:
            return None
        end = min(end, ln) if end >= 0 else ln
        codes = self._idx.getseq(rid, start, end)
        return "".join("ACGTN"[c] for c in codes)

    @property
    def k(self):
        return self._idx.k

    @property
    def w(self):
        return self._idx.w

    @property
    def n_seq(self):
        return self._idx.n_seq

    @property
    def seq_names(self):
        if self._idx is None:
            return None
        return [s.name for s in self._idx.seq]
