"""FASTA/FASTQ streaming reader (bseq.c + kseq.h semantics), the port of
minimap2_tpu.io.fastx: plain or gzip input, mini-batch reading by total
bp (mm_bseq_read3 bseq.c:80-119, with frag mode), U->T conversion
(bseq.c:72-74), and the pairing helpers qname_same and revcomp_record.

Records come from the native buffer scanner (``native.fastx_scan``,
native/host_scans.cpp) over streamed chunks whenever ``native.available()``,
as in the JAX package; otherwise from the Python line parser, which gives
the same records.  Both raise ValueError on a non-blank line where a record
should start: a binary file is not read as an empty FASTA.  ``routes``
counts the scanner's calls ("native") and the records the Python parser
read ("python")."""
from __future__ import annotations

import gzip
import io
from collections import Counter
from dataclasses import dataclass

routes: Counter = Counter()


@dataclass
class SeqRecord:
    name: str
    seq: bytes
    qual: bytes | None = None
    comment: str | None = None
    rid: int = 0


_U2T = bytes.maketrans(b"Uu", b"Tt")


def _open(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=f))
    return io.BufferedReader(f)


class FastxReader:
    """Record-at-a-time FASTA/FASTQ parser: the native buffer scanner over
    ``_CHUNK``-byte reads, each carrying the unparsed tail of the last,
    or the Python line parser."""

    _CHUNK = 8 << 20

    def __init__(self, path: str):
        self._fp = _open(path)
        self._pending: bytes | None = None
        self.eof = False
        self._q: list[SeqRecord] = []
        self._carry = b""
        self._native = None
        from .. import native
        if native.available():
            self._native = native

    def close(self):
        self._fp.close()

    def _readline(self) -> bytes:
        if self._pending is not None:
            line, self._pending = self._pending, None
            return line
        return self._fp.readline()

    def _fill_native(self) -> None:
        nat = self._native
        while not self._q and not self.eof:
            chunk = self._fp.read(self._CHUNK)
            if not chunk:
                if not self._carry:
                    self.eof = True
                    return
                buf, final = self._carry, True
            else:
                buf, final = self._carry + chunk, False
            n, out_seq, meta, qmeta, consumed = nat.fastx_scan(buf, final)
            routes["native"] += 1
            sview = out_seq.tobytes()
            for i in range(n):
                no, nl, co, cl, so, sl = meta[i]
                qo, qlq = qmeta[i]
                self._q.append(SeqRecord(
                    name=buf[no:no + nl].decode(),
                    seq=sview[so:so + sl],
                    qual=sview[qo:qo + qlq] if qlq else None,
                    comment=buf[co:co + cl].decode() if cl else None))
            self._carry = b"" if final else buf[consumed:]
            if final:
                self.eof = True
                return

    def read1(self) -> SeqRecord | None:
        if self._native is not None and self._pending is None:
            if not self._q:
                self._fill_native()
            return self._q.pop(0) if self._q else None
        return self._read1_py()

    def _read1_py(self) -> SeqRecord | None:
        # find header
        while True:
            line = self._readline()
            if not line:
                self.eof = True
                return None
            if line[:1] in (b">", b"@"):
                line = line.rstrip()
                break
            if line.strip(b"\r\n"):   # as the native scanner
                raise ValueError("malformed FASTA/FASTQ input")
        routes["python"] += 1
        is_fq = line[:1] == b"@"
        head = line[1:].decode()
        parts = head.split(None, 1)
        name = parts[0] if parts else ""
        comment = parts[1] if len(parts) > 1 else None
        seq_parts = []
        qual = None
        while True:
            line = self._fp.readline()
            if not line:
                break
            s = line.rstrip()
            if s[:1] in (b">", b"@") and not is_fq:
                self._pending = line
                break
            if s[:1] == b"+" and is_fq:
                # read quality of equal length
                seq_len = sum(len(p) for p in seq_parts)
                q_parts = []
                got = 0
                while got < seq_len:
                    ql = self._fp.readline()
                    if not ql:
                        break
                    ql = ql.rstrip()
                    q_parts.append(ql)
                    got += len(ql)
                qual = b"".join(q_parts)
                break
            seq_parts.append(s)
        seq = b"".join(seq_parts).translate(_U2T)
        return SeqRecord(name=name, seq=seq, qual=qual, comment=comment)

    def read_batch(self, chunk_bp: int,
                   frag_mode: bool = False) -> list[SeqRecord]:
        """mm_bseq_read3: read records until >= chunk_bp total bases; in
        frag mode keep reading while consecutive names pair up (bseq.c:
        100-112)."""
        out: list[SeqRecord] = []
        total = 0
        while True:
            rec = self.read1()
            if rec is None:
                break
            out.append(rec)
            total += len(rec.seq)
            if total >= chunk_bp:
                if not frag_mode:
                    break
                # keep reading if the next record pairs with the last
                nxt = self.read1()
                if nxt is None:
                    break
                if qname_same(out[-1].name, nxt.name):
                    out.append(nxt)
                    continue
                self._push_back_record(nxt)
                break
        return out

    def _push_back_record(self, rec: SeqRecord):
        if self._native is not None:
            self._q.insert(0, rec)
            return
        # reconstruct minimal header + body and prepend (rare path, batch
        # edge)
        hdr = (b"@" if rec.qual is not None else b">") + rec.name.encode()
        if rec.comment:
            hdr += b" " + rec.comment.encode()
        body = hdr + b"\n" + rec.seq + b"\n"
        if rec.qual is not None:
            body += b"+\n" + rec.qual + b"\n"
        if self._pending is not None:   # the header read past rec's end
            body += self._pending
            self._pending = None
        self._fp = io.BufferedReader(_ConcatStream(io.BytesIO(body),
                                                   self._fp))


class _ConcatStream(io.RawIOBase):
    """One stream read to its end, then another."""

    def __init__(self, first, second):
        self.first, self.second = first, second

    def readable(self):
        return True

    def readinto(self, b):
        n = self.first.readinto(b)
        if n:
            return n
        return self.second.readinto(b)


def qname_same(a: str, b: str) -> bool:
    """bseq.h:38 mm_qname_same: names equal ignoring a trailing /[0-9]."""
    return qname_len(a) == qname_len(b) and a[:qname_len(a)] == b[:qname_len(b)]


def qname_len(s: str) -> int:
    """Length of a read name without a trailing /1 or /2."""
    n = len(s)
    if n >= 3 and s[n - 2] == "/" and s[n - 1].isdigit():
        return n - 2
    return n


def read_fasta(path: str) -> tuple[list[str], list[bytes]]:
    """Read an entire FASTA/FASTQ file."""
    r = FastxReader(path)
    names, seqs = [], []
    while True:
        rec = r.read1()
        if rec is None:
            break
        names.append(rec.name)
        seqs.append(rec.seq)
    r.close()
    return names, seqs


def revcomp_record(rec: SeqRecord) -> SeqRecord:
    """mm_revcomp_bseq (bseq.c): reverse-complement sequence and reverse qual."""
    comp = bytes.maketrans(b"ACGTUacgtuRYSWKMBDHVryswkmbdhv",
                           b"TGCAAtgcaaYRSWMKVHDByrswmkvhdb")
    return SeqRecord(name=rec.name, seq=rec.seq[::-1].translate(comp),
                     qual=rec.qual[::-1] if rec.qual else None,
                     comment=rec.comment, rid=rec.rid)
