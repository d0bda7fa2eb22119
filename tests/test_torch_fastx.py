"""The port's FASTA/FASTQ reader (minimap2_tpu_torch.io.fastx) against the
JAX package's (minimap2_tpu.io.fastx, which reads through its native
scanner by default): names, sequences, qualities and comments of every
record, and the same ValueError on malformed input.  The cases cover
multi-line FASTA, comments after a space or a tab, U->T, CRLF, blank
lines, gzip, FASTQ with a named '+' line, an empty sequence and no final
newline; every chunk size the streaming scanner can be given on one file;
the port's Python route forced; and read_batch in frag mode across a batch
edge."""
import gzip

import pytest

import minimap2_tpu.native as jax_native
from minimap2_tpu.io import fastx as jfastx
from minimap2_tpu_torch import native
from minimap2_tpu_torch.io import fastx

CASES = {
    "fasta_multiline": b">r1 first read\nACGTAC\nGTTA\n\n>r2\tcomment\twith tab"
                       b"\nacguuU\nNNNN\n>r3\nA\n",
    "crlf_blank": b"\r\n\n>a x\r\nACGU\r\nTT\r\n\r\n>b\r\nGG\r\n",
    "fastq": b"@q1 c1\nACGTU\n+q1\nIIIII\n@q2\nGGA\n+\n#$%\n\n@q3/1\nT\n+\n!\n",
    "empty_seq": b">e1\n>e2 only comment\nACGT\n>e3\n",
    "no_final_newline": b">n1\nACGT\n>n2\nGGTT",
    "fastq_no_final_newline": b"@n1\nACGT\n+\n!!!!\n@n2\nGG\n+\n##",
}
BAD = {
    "junk_before_header": b"junk line\n>r1\nACGT\n",
    "binary": b"\x00\x01\x02\x03ACGT\n",
    # the scanner skips the blank sequence line and finds no '+'
    "fastq_empty_seq": b"@f0\n\n+\n\n@f1\nAC\n+\n!!\n",
}


def _records(mod, path):
    r = mod.FastxReader(path)
    out = []
    while True:
        rec = r.read1()
        if rec is None:
            break
        out.append((rec.name, rec.seq, rec.qual, rec.comment))
    r.close()
    return out


def _write(tmp_path, name, data, gz=False):
    path = tmp_path / (name + (".gz" if gz else ""))
    path.write_bytes(gzip.compress(data) if gz else data)
    return str(path)


@pytest.fixture(scope="module", autouse=True)
def _natives():
    assert jax_native.available() and native.available()


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_reader_matches_jax(tmp_path, case, gz):
    path = _write(tmp_path, case, CASES[case], gz)
    want = _records(jfastx, path)
    assert want
    got = _records(fastx, path)
    assert got == want


@pytest.mark.parametrize("case", sorted(BAD))
def test_malformed_raises_in_both(tmp_path, case):
    """Junk or a binary file where a record should start, or a FASTQ
    record with an empty sequence line, raise in both readers."""
    path = _write(tmp_path, case, BAD[case])
    with pytest.raises(ValueError, match="malformed"):
        _records(jfastx, path)
    with pytest.raises(ValueError, match="malformed"):
        _records(fastx, path)


def test_every_chunk_split_matches_jax(tmp_path, monkeypatch):
    """The scanner streams _CHUNK bytes at a time and carries the
    unparsed tail: every chunk size from 1 to past the file's length gives
    the JAX reader's records, FASTA and FASTQ."""
    for case in ("fasta_multiline", "fastq", "crlf_blank"):
        data = CASES[case]
        path = _write(tmp_path, case, data)
        want = _records(jfastx, path)
        before = fastx.routes["native"]
        for chunk in range(1, len(data) + 2):
            monkeypatch.setattr(fastx.FastxReader, "_CHUNK", chunk)
            assert _records(fastx, path) == want, (case, chunk)
        assert fastx.routes["native"] > before


def test_python_route_matches_native(tmp_path, monkeypatch):
    """With the native library absent the port parses in Python: the same
    records, and the same error on junk."""
    paths = [_write(tmp_path, c, CASES[c]) for c in sorted(CASES)]
    want = [_records(fastx, p) for p in paths]
    monkeypatch.setattr(native, "available", lambda: False)
    before = fastx.routes["python"]
    assert [_records(fastx, p) for p in paths] == want
    assert fastx.routes["python"] > before
    with pytest.raises(ValueError, match="malformed"):
        _records(fastx, _write(tmp_path, "junk", BAD["junk_before_header"]))


def _batches(mod, path, chunk_bp):
    r = mod.FastxReader(path)
    out = []
    while True:
        b = r.read_batch(chunk_bp, frag_mode=True)
        if not b:
            break
        out.append([(x.name, x.seq, x.qual, x.comment) for x in b])
    r.close()
    return out


@pytest.mark.parametrize("python_route", [False, True])
@pytest.mark.parametrize("fmt", ["fa", "fq"])
def test_read_batch_frag_mode_matches_jax(tmp_path, monkeypatch, fmt,
                                          python_route):
    """mm_bseq_read3 in frag mode: a batch that reaches chunk_bp on a /1
    read takes its /2 mate across the edge; the record read past a batch
    is pushed back and starts the next batch."""
    recs = []
    for i in range(7):
        for m in ((1, 2) if i % 3 else (1,)):
            seq = b"ACGT"[i % 4:i % 4 + 1] * (5 + i)
            if fmt == "fa":
                recs.append(b">p%d/%d c%d\n%s\n" % (i, m, i, seq))
            else:
                recs.append(b"@p%d/%d\n%s\n+\n%s\n" % (i, m, seq,
                                                      b"I" * len(seq)))
    path = _write(tmp_path, "frag." + fmt, b"".join(recs))
    want = _batches(jfastx, path, 12)
    assert len(want) > 2 and any(len(b) > 1 for b in want)
    if python_route:
        monkeypatch.setattr(native, "available", lambda: False)
    assert _batches(fastx, path, 12) == want


def test_seqrecord_rid_and_revcomp():
    rec = fastx.SeqRecord("r", b"ACGTN", b"!#%&(", "c", rid=3)
    rc = fastx.revcomp_record(rec)
    want = jfastx.revcomp_record(jfastx.SeqRecord("r", b"ACGTN", b"!#%&(",
                                                  "c", rid=3))
    assert (rc.name, rc.seq, rc.qual, rc.comment, rc.rid) \
        == (want.name, want.seq, want.qual, want.comment, want.rid)
    assert fastx.SeqRecord("x", b"").rid == 0
