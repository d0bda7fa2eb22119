"""Minimizer index built on the host (copy of minimap2_tpu.index.index,
both of its routes: mm_idx_gen index.c:389-408, worker_post
index.c:226-278, mm_idx_cal_max_occ index.c:198-220).

Three flat arrays: ``keys`` (sorted distinct minimizer hashes, u64),
``starts`` (offset of each key's run in ``pos``, len = n_keys + 1) and
``pos`` (y = rid<<32 | last_pos<<1 | strand, sorted by (key, y)).
DeviceIndex.from_host turns them into the device tables.  The index
also carries the side data the CLI attaches (--junc-bed intervals, --spsc
splice scores, -j/--pass1 jumps, --alt contigs), and reads and writes the
.npz form (save/load; the .mmi form is index/mmi.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.intfloat import SEQ_NT4
from .sketch import sketch


@dataclass
class SeqMeta:
    name: str
    offset: int
    length: int
    is_alt: bool = False


def _sketch_numpy(mi, hpc: bool):
    """The NumPy route's sketch: each contig of >= k bases by
    index/sketch.py, in turn."""
    xs, ys = [], []
    for rid, s in enumerate(mi.seq):
        if s.length >= mi.k:
            x, y = sketch(mi.S[s.offset:s.offset + s.length], mi.w, mi.k,
                          rid, hpc)
            xs.append(x)
            ys.append(y)
    if not xs:
        return np.empty(0, np.uint64), np.empty(0, np.uint64)
    return np.concatenate(xs), np.concatenate(ys)


class MiniIndex:
    """The minimizer index over a set of target sequences."""

    def __init__(self, w: int, k: int, b: int, flag: int):
        if k * 2 < b:
            b = k * 2
        if w < 1:
            w = 1
        self.w, self.k, self.b, self.flag = w, k, b, flag
        self.seq: list[SeqMeta] = []
        self.S: np.ndarray | None = None      # nt4 codes of concatenated refs
        self.keys = np.empty(0, dtype=np.uint64)
        self.starts = np.zeros(1, dtype=np.int64)
        self.pos = np.empty(0, dtype=np.uint64)
        # side data (index/sidedata.py), attached by the CLI after the build
        self.intervals = None
        self.spsc = None
        self.jumps = None
        self._name2id: dict[str, int] | None = None

    @classmethod
    def build(cls, names, seqs, w: int, k: int, b: int = 14,
              flag: int = 0) -> "MiniIndex":
        """Build from in-memory sequences (str/bytes). rid = list order."""
        codes_list = []
        for s in seqs:
            if isinstance(s, str):
                s = s.encode()
            codes_list.append(SEQ_NT4[np.frombuffer(s, dtype=np.uint8)])
        return cls.build_codes(names, codes_list, w, k, b, flag)

    @classmethod
    def build_codes(cls, names, codes_list, w: int, k: int, b: int = 14,
                    flag: int = 0) -> "MiniIndex":
        """Build from nt4 code arrays (uint8, 0-3 + 4=ambiguous).

        With the host library (``native.available()``) every contig is
        sketched by its batched mm_sketch and the (hash, y) stream ordered
        by its stable LSD radix sort on the hash, which keeps emission
        order within a key, as the reference's radix_sort_128x does
        (index.c:226-278).  Without it, the contigs are sketched in turn
        by the NumPy sketch and the stream ordered by np.lexsort on (hash,
        y).  Both give the same arrays: within a key, emission order is y
        order."""
        from .. import native
        mi = cls(w, k, b, flag)
        total = sum(len(c) for c in codes_list)
        mi.S = np.empty(total, dtype=np.uint8)
        off = 0
        for name, codes in zip(names, codes_list):
            mi.S[off:off + len(codes)] = codes
            mi.seq.append(SeqMeta(name=name, offset=off, length=len(codes)))
            off += len(codes)
        hpc = bool(flag & 0x1)
        use_native = native.available()
        if use_native:
            x, y = native.sketch_many(
                mi.S, np.array([s.offset for s in mi.seq], np.int64),
                np.array([s.length for s in mi.seq], np.int64), mi.w, mi.k,
                hpc)
        else:
            x, y = _sketch_numpy(mi, hpc)
        if len(x):
            h = np.ascontiguousarray(x >> np.uint64(8))   # span dropped
            y = np.ascontiguousarray(y)
            if use_native:
                native.radix_sort_pair(h, y, 2 * mi.k)
            else:
                order = np.lexsort((y, h))
                h, y = h[order], y[order]
            bnd = np.flatnonzero(h[1:] != h[:-1]) + 1
            mi.keys = h[np.concatenate(([0], bnd))]
            mi.starts = np.concatenate(([0], bnd, [len(h)])).astype(np.int64)
            mi.pos = y
        return mi

    @property
    def n_seq(self) -> int:
        return len(self.seq)

    @property
    def n_alt(self) -> int:
        """The number of ALT contigs (--alt, index/sidedata.read_alt)."""
        return sum(s.is_alt for s in self.seq)

    def get(self, minier):
        """Vectorized mm_idx_get (index.c:93-110): hash values -> (start,
        count) into self.pos."""
        q = np.atleast_1d(np.asarray(minier, dtype=np.uint64))
        nk = len(self.keys)
        idx = np.searchsorted(self.keys, q)
        idx_c = np.minimum(idx, nk - 1) if nk else idx
        found = (nk > 0) & (idx < nk)
        if nk:
            found = found & (self.keys[idx_c] == q)
        row = np.minimum(idx_c, len(self.starts) - 2)
        start = np.where(found, self.starts[row], 0)
        cnt = np.where(found, self.starts[row + 1] - self.starts[row], 0)
        return start.astype(np.int64), cnt.astype(np.int64)

    def getseq(self, rid: int, st: int, en: int,
               rev: bool = False) -> np.ndarray:
        """nt4 codes of reference rid in [st, en) (index.c:164-196),
        reverse-complemented with rev."""
        s = self.seq[rid]
        if st >= s.length:
            return np.empty(0, dtype=np.uint8)
        sub = self.S[s.offset + st:s.offset + min(en, s.length)]
        if rev:
            sub = sub[::-1]
            sub = np.where(sub < 4, 3 - sub, sub).astype(np.uint8)
        return sub

    def name2id(self, name: str) -> int:
        """The rid of a sequence name, or -1."""
        if self._name2id is None:
            self._name2id = {s.name: i for i, s in enumerate(self.seq)}
        return self._name2id.get(name, -1)

    def cal_max_occ(self, f: float) -> int:
        """index.c:198-220: occurrence threshold such that <= f of distinct
        minimizers occur more often."""
        if f <= 0.0 or len(self.keys) == 0:
            return 2147483647
        counts = (self.starts[1:] - self.starts[:-1]).astype(np.uint32)
        kk = int((1.0 - f) * len(counts))
        kk = min(kk, len(counts) - 1)
        return int(np.partition(counts, kk)[kk]) + 1

    def stat(self) -> str:
        """mm_idx_stat (index.c:112-134), without the timing field."""
        n = len(self.keys)
        counts = self.starts[1:] - self.starts[:-1]
        total_len = sum(s.length for s in self.seq)
        lines = [f"[M::mm_idx_stat] kmer size: {self.k}; skip: {self.w}; "
                 f"is_hpc: {self.flag & 0x1}; #seq: {self.n_seq}"]
        if n:
            n1 = int(np.sum(counts == 1))
            sum_occ = int(counts.sum())
            lines.append(
                f"[M::mm_idx_stat] distinct minimizers: {n} "
                f"({100.0 * n1 / n:.2f}% are singletons); average "
                f"occurrences: {sum_occ / n:.3f}; average spacing: "
                f"{total_len / sum_occ:.3f}; total length: {total_len}")
        return "\n".join(lines)

    def save(self, path: str) -> None:
        """The .npz form (minimap2_tpu's MiniIndex.save, compressed)."""
        np.savez_compressed(
            path,
            meta=np.array([self.w, self.k, self.b, self.flag, self.n_seq],
                          dtype=np.int64),
            names=np.array([s.name for s in self.seq]),
            lens=np.array([s.length for s in self.seq], dtype=np.uint32),
            offsets=np.array([s.offset for s in self.seq], dtype=np.uint64),
            is_alt=np.array([s.is_alt for s in self.seq], dtype=np.uint8),
            S=self.S if self.S is not None else np.empty(0, np.uint8),
            keys=self.keys, starts=self.starts, pos=self.pos)

    @classmethod
    def load(cls, path: str) -> "MiniIndex":
        """An index written by save."""
        z = np.load(path, allow_pickle=False)
        w, k, b, flag, n_seq = (int(v) for v in z["meta"])
        mi = cls(w, k, b, flag)
        names, lens, offs, alts = (z["names"], z["lens"], z["offsets"],
                                   z["is_alt"])
        for i in range(n_seq):
            mi.seq.append(SeqMeta(str(names[i]), int(offs[i]), int(lens[i]),
                                  bool(alts[i])))
        mi.S = z["S"]
        mi.keys, mi.starts, mi.pos = z["keys"], z["starts"], z["pos"]
        return mi
