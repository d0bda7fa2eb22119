"""The port CLI's debug output (--print-seeds, --print-chains,
--print-aln-seq, --dbg-seed-occ, --print-qname) against the JAX CLI's and
the reference binary's goldens.

Each case runs both CLIs with -t 1 and with the default -t 3: the debug
lines on stderr (all of them but the time-stamped [M::], QT and QM lines;
QT lines compared but for their seconds) equal the JAX CLI's, and the
lines tests/test_golden_cli.py checks equal the golden's.  Stdout equals
the port's stdout without the flag.  As in the JAX package, only
--print-qname leaves the -t pool on, whose workers print no QR lines
(ROADMAP Queue 3).  Under --batch the lines are those of the reads the
host mapping path takes (here reads longer than L).
"""
import contextlib
import functools
import io

import numpy as np
import pytest

import minimap2_tpu.cli as jax_cli
import minimap2_tpu.parallel.engine as jax_engine
import minimap2_tpu_torch.cli as port_cli
from minimap2_tpu_torch.parallel import engine

GOLD = "tests/golden"
DATA = "tests/data"
MT = [f"{DATA}/MT-human.fa", f"{DATA}/MT-orang.fa"]
X3S = [f"{DATA}/x3s-ref.fa", f"{DATA}/x3s-qry.fa"]

# name: (argv without -t, golden, the golden's lines compared)
CASES = {
    "print-seeds": (["--print-seeds", *MT], "mt-seeds.err",
                    lambda l: l[:3] in ("SD\t", "RS\t")),
    "print-chains": (["--print-chains", *MT], "mt-chains.err",
                     lambda l: l.startswith("CN\t")),
    "print-chains-splice": (["-x", "splice", "--print-chains", *X3S],
                            "x3s-chains.err",
                            lambda l: l.startswith("CN\t")),
    "print-aln-seq": (["-a", "--print-aln-seq", *MT], "mt-alnseq.err",
                      lambda l: not l.startswith(("[M::", "QM\t", "QT\t"))),
    "dbg-seed-occ": (["--dbg-seed-occ", *MT], "mt-seedocc.err",
                     lambda l: l.startswith("SF\t")),
    "print-qname": (["-c", "--print-qname", *MT], None, None),
}
DBG_FLAGS = {"--print-seeds", "--print-chains", "--print-aln-seq",
             "--dbg-seed-occ", "--print-qname"}


def run(cli, argv, **kw):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv, **kw)
    assert rc == 0
    return out.getvalue(), err.getvalue()


def debug_lines(err):
    """stderr without the time-stamped lines; QT lines without seconds."""
    return [l.rsplit("\t", 1)[0] if l.startswith("QT\t") else l
            for l in err.splitlines()
            if not l.startswith(("[M::", "QM\t", "[WARNING]"))]


def _sam_body(text):
    return [l for l in text.splitlines() if not l.startswith("@PG")]


@pytest.mark.parametrize("threads", [["-t1"], []], ids=["t1", "t3"])
@pytest.mark.parametrize("case", list(CASES))
def test_debug_output_matches_jax_and_golden(case, threads):
    argv, golden, keep = CASES[case]
    argv = threads + argv
    j_out, j_err = run(jax_cli, argv)
    p_out, p_err = run(port_cli, argv, device="cpu")
    got = debug_lines(p_err)
    assert got == debug_lines(j_err)
    if golden:
        want = [l for l in open(f"{GOLD}/{golden}").read().splitlines()
                if keep(l)]
        assert want and [l for l in p_err.splitlines() if keep(l)] == want
    else:       # --print-qname: QR/QT with -t 1, none from the pool
        assert [l[:3] for l in got] == (["QR\t", "QT\t"] if threads else [])
    plain, _ = run(port_cli, [a for a in argv if a not in DBG_FLAGS],
                   device="cpu")
    assert _sam_body(p_out) == _sam_body(j_out)
    # the @PG line of a SAM carries the arguments, the flag among them
    assert _sam_body(p_out) == _sam_body(plain)


def test_batch_debug_output_matches_jax(tmp_path, monkeypatch):
    """--batch --print-seeds --print-chains on conc_world's genome: the
    debug lines are those of the reads longer than L (512 here), which
    the host path maps; equal to the JAX CLI's, PAF unchanged."""
    rng = np.random.default_rng(5)
    ref = "".join(rng.choice(list("ACGT"), 60000))
    comp = str.maketrans("ACGT", "TGCA")
    reads = tmp_path / "mixed.fa"
    with open(reads, "w") as f:
        for i in range(12):
            n = 1500 if i in (3, 9) else 400
            st = int(rng.integers(0, len(ref) - n))
            seq = ref[st:st + n]
            if i % 3 == 0:
                seq = seq.translate(comp)[::-1]
            f.write(f">q{i}\n{seq}\n")
    (tmp_path / "ref.fa").write_text(f">c1\n{ref}\n")
    for mod in (jax_engine, engine):
        monkeypatch.setattr(mod, "run_batched_cli", functools.partial(
            mod.run_batched_cli, batch_reads=8, L=512))
    argv = ["--batch", "--print-seeds", "--print-chains",
            str(tmp_path / "ref.fa"), str(reads)]
    j_out, j_err = run(jax_cli, argv)
    p_out, p_err = run(port_cli, argv, device="cpu")
    got = debug_lines(p_err)
    assert got == debug_lines(j_err)
    assert sum(l.startswith("RS\t") for l in got) == 2   # the two long reads
    assert p_out == j_out
    assert p_out == run(port_cli, argv[:1] + argv[3:], device="cpu")[0]
