"""The port's --batch CLI routes on the options and inputs the JAX CLI takes
beyond the plain presets, byte-identical to the JAX CLI (tolerance 0):

(a) -ax splice:sr with one query file (the spliced -c/-a driver: exts2 +
    the splice traceback) and with two (the paired driver: extd2 + the
    traceback, which do not splice; a fragment goes to the host path whole
    only where an end fails its audit), with and without -j annotation;
(b) -a --eqx: the device records carry no =/X (the JAX device path does
    not read MM_F_EQX), the fallback reads' host records do;
(c) -a --write-junc on test_torch_align.py's reads (rd4, the junk middle,
    falls back): device records as SAM, fallback reads as junction BED;
(d) -a -R: the @RG header line and the RG:Z tag;
(e) -a --alt: ALT contigs reach the fallback reads' host path.
(b), (d) and (e) touch disjoint parts of the output, so they share one
run.  Both CLIs run at small widths (the drivers wrapped with
functools.partial) and write to the same -o path, as the SAM @PG line
carries it.  Each world's runs are made once for the module, one case
after another (in threads they ran slower on the CPU).  The JAX Pallas
kernels run in interpret mode (the JAX drivers pick it off the TPU); the
port runs its plain versions on the CPU.
"""
import functools

import numpy as np
import pytest

import jax

import minimap2_tpu.cli as jax_cli
import minimap2_tpu.parallel.engine as jax_engine
import minimap2_tpu_torch.cli as port_cli
from minimap2_tpu_torch.parallel import engine

jax.config.update("jax_platforms", "cpu")

ACGT = np.frombuffer(b"ACGT", np.uint8)
COMP = bytes.maketrans(b"ACGT", b"TGCA")
KW = {"QP": 256, "TP": 768, "W": 256, "sub": 4}        # test_align_batch.py
SPLICE_KW = {"QP": 256, "TP": 2048, "sub": 4, "RB": 32}
RG = r"@RG\tID:grp1\tSM:s1"

_last = {}          # the last driver call's (driver, result)


def _recorded(fn, key):
    def run(*a, **k):
        _last["res"] = (key, fn(*a, **k))
    return run


def _cli_cases(tmp, ref, cases, align_kw, L):
    """cli.main(["--batch", *opts, ref, *queries]) of both packages at small
    widths for each case (name -> (opts, queries)), the JAX run first and
    the port's to the same -o path, one case after another.  Returns name ->
    (jax text, port text, (driver, the port driver's result))."""
    def run(name):
        opts, queries = cases[name]
        out = tmp / name / "out"
        out.parent.mkdir()
        texts = []
        for cli, kw in ((jax_cli, {}), (port_cli, {"device": "cpu"})):
            _last.clear()
            assert cli.main(["--batch", *opts, "-o", str(out), ref,
                             *queries], **kw) == 0
            texts.append(out.read_text())
        return name, (*texts, _last.get("res"))
    with pytest.MonkeyPatch.context() as mp:
        for mod in (jax_engine, engine):
            mp.setattr(mod, "run_batched_align_cli", _recorded(
                functools.partial(mod.run_batched_align_cli, batch_reads=8,
                                  L=L, align_kw=align_kw), "align"))
            mp.setattr(mod, "run_batched_pe_cli", _recorded(
                functools.partial(mod.run_batched_pe_cli, batch_frags=8,
                                  L=L, align_kw=KW), "pe"))
        return dict(map(run, cases))


def _splice_world(tmp_path):
    """A 24 kb genome with 8 three-exon genes on both strands (GT-AG
    introns of 300-1500 bp), their BED12, and 24 FR pairs of 2 x 100 bp
    from the spliced transcripts (1% substitutions)."""
    rng = np.random.default_rng(12)
    g = rng.integers(0, 4, 24_000).astype(np.uint8)
    genes, bed = [], []
    st = 500
    for i in range(8):
        ex = [int(x) for x in rng.integers(90, 160, 3)]
        intr = [int(x) for x in rng.integers(300, 1500, 2)]
        pos, blocks = st, []
        for j in range(3):
            blocks.append((pos, pos + ex[j]))
            if j < 2:
                g[pos + ex[j]:pos + ex[j] + 2] = (2, 3)           # GT
                en = pos + ex[j] + intr[j]
                g[en - 2:en] = (0, 2)                             # AG
                pos = en
        genes.append((blocks, "+" if i % 2 == 0 else "-"))
        st = blocks[-1][1] + 400
    genome = ACGT[g].tobytes()
    ref = tmp_path / "ref.fa"
    ref.write_text(f">chrS\n{genome.decode()}\n")
    with open(tmp_path / "anno.bed", "w") as f:
        for i, (blocks, strand) in enumerate(genes):
            s0, e0 = blocks[0][0], blocks[-1][1]
            f.write(f"chrS\t{s0}\t{e0}\tg{i}\t0\t{strand}\t{s0}\t{e0}\t0\t3\t"
                    + ",".join(str(b - a) for a, b in blocks) + ",\t"
                    + ",".join(str(a - s0) for a, _ in blocks) + ",\n")
    r1, r2 = [], []
    for i in range(24):
        blocks, strand = genes[i % 8]
        tx = b"".join(genome[a:b] for a, b in blocks)
        if strand == "-":
            tx = tx.translate(COMP)[::-1]
        flen = int(rng.integers(200, len(tx)))
        fs = int(rng.integers(0, len(tx) - flen + 1))
        frag = bytearray(tx[fs:fs + flen])
        for p in np.flatnonzero(rng.random(len(frag)) < 0.01):
            frag[p] = ACGT[(ACGT.tolist().index(frag[p]) + 1) % 4]
        frag = bytes(frag)
        r1.append((f"p{i}", frag[:100]))
        r2.append((f"p{i}", frag[-100:].translate(COMP)[::-1]))
    files = []
    for name, recs in (("r1.fq", r1), ("r2.fq", r2)):
        with open(tmp_path / name, "w") as f:
            for n, s in recs:
                f.write(f"@{n}\n{s.decode()}\n+\n{'I' * len(s)}\n")
        files.append(str(tmp_path / name))
    return str(ref), str(tmp_path / "anno.bed"), files


@pytest.fixture(scope="module")
def splice_outs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("splice_sr")
    ref, bed, (r1, r2) = _splice_world(tmp)
    sr = ["-ax", "splice:sr"]
    return _cli_cases(tmp, ref, {
        "single": (sr, [r1]), "single-anno": ([*sr, "-j", bed], [r1]),
        "paired-anno": ([*sr, "-j", bed], [r1, r2])}, SPLICE_KW, 256)


@pytest.mark.parametrize("case", ["single", "single-anno", "paired-anno"])
def test_splice_sr_matches_jax(splice_outs, case):
    want, got, (driver, (n, fallbacks)) = splice_outs[case]
    assert got == want
    paired = case.startswith("paired")
    assert driver == ("pe" if paired else "align")
    assert n == 48 if paired else n == 24
    lines = [ln.split("\t") for ln in got.splitlines()
             if not ln.startswith("@")]
    assert {t[0] for t in lines} == {f"p{i}" for i in range(24)}


def _align_world(tmp_path):
    """test_torch_align.py's two references and six reads (rd2 longer
    than QP, rd4 with a junk middle)."""
    rng = np.random.default_rng(3)
    ref = rng.choice(ACGT, 4000).tobytes()
    rng2 = np.random.default_rng(11)
    dup = bytearray(rng2.choice(ACGT, 4000).tobytes())
    dup[3000:3220] = dup[1000:1220]
    rng = np.random.default_rng(9)
    read = bytearray(ref[1000:1220])
    read[40] = ord("A") if read[40] != ord("A") else ord("C")
    del read[120]
    reads = [bytes(read), ref[2000:2200].translate(COMP)[::-1],
             ref[500:1500], ref[1000:1150] + rng.choice(ACGT, 80).tobytes(),
             ref[800:1100] + rng.choice(ACGT, 600).tobytes()
             + ref[1700:2000], bytes(dup[1000:1220])]
    fa = tmp_path / "ref.fa"
    fa.write_text(f">chrT\n{ref.decode()}\n>chrD\n{dup.decode()}\n")
    rd = tmp_path / "reads.fa"
    rd.write_text("".join(f">rd{i}\n{s.decode()}\n"
                          for i, s in enumerate(reads)))
    (tmp_path / "alt.txt").write_text("chrD\n")
    return str(fa), str(rd)


@pytest.fixture(scope="module")
def align_outs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("align_opts")
    ref, reads = _align_world(tmp)
    return _cli_cases(tmp, ref, {
        "eqx-rg-alt": (["-a", "--eqx", "-R", RG, "--alt",
                        str(tmp / "alt.txt")], [reads]),
        "write-junc": (["-a", "--write-junc"], [reads])}, KW, 1536)


@pytest.mark.parametrize("case", ["eqx", "write-junc", "read-group", "alt"])
def test_align_options_match_jax(align_outs, case):
    want, got, (driver, (n, fallbacks)) = align_outs[
        "write-junc" if case == "write-junc" else "eqx-rg-alt"]
    assert got == want
    assert driver == "align"
    assert n == 6 and "rd4" in [name for name, _ in fallbacks]
    body = [ln.split("\t") for ln in got.splitlines()
            if not ln.startswith("@")]
    host = {name for name, _ in fallbacks}
    if case == "eqx":
        assert all(("M" in t[5]) != (t[0] in host) for t in body
                   if t[5] != "*")
    elif case == "write-junc":
        assert body and all(t[0] != "rd4" for t in body)
    elif case == "read-group":
        assert "@RG\tID:grp1\tSM:s1" in got.splitlines()
        assert all("RG:Z:grp1" in t for t in body)
