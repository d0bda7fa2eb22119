"""FASTA/FASTQ streaming reader: the pure-Python path of
minimap2_tpu.io.fastx (bseq.c + kseq.h semantics: plain or gzip input,
U->T conversion), without the native scanner, and the pairing helpers
qname_same and revcomp_record.  As with the JAX package's native scanner
(its default reader), a non-blank line where a record should start raises
ValueError: a binary file is not read as an empty FASTA."""
from __future__ import annotations

import gzip
import io
from dataclasses import dataclass


@dataclass
class SeqRecord:
    name: str
    seq: bytes
    qual: bytes | None = None
    comment: str | None = None


_U2T = bytes.maketrans(b"Uu", b"Tt")


def _open(path: str):
    f = open(path, "rb")
    magic = f.read(2)
    f.seek(0)
    if magic == b"\x1f\x8b":
        return io.BufferedReader(gzip.GzipFile(fileobj=f))
    return io.BufferedReader(f)


class FastxReader:
    """Record-at-a-time FASTA/FASTQ parser."""

    def __init__(self, path: str):
        self._fp = _open(path)
        self._pending: bytes | None = None
        self.eof = False

    def close(self):
        self._fp.close()

    def _readline(self) -> bytes:
        if self._pending is not None:
            line, self._pending = self._pending, None
            return line
        return self._fp.readline()

    def read1(self) -> SeqRecord | None:
        # find header
        while True:
            line = self._readline()
            if not line:
                self.eof = True
                return None
            if line[:1] in (b">", b"@"):
                line = line.rstrip()
                break
            if line.strip(b"\r\n"):   # as the JAX package's native scanner
                raise ValueError("malformed FASTA/FASTQ input")
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
                     comment=rec.comment)
