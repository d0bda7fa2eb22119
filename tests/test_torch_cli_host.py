"""The port's CLI without --batch: the host mapping path, fragment by
fragment through map_fragment + write_fragment, serially (-t 1) or in a
spawn pool that keeps input order (-t N > 1, the default -t 3).

(a) byte-identical to the reference binary's goldens (tests/golden, made
    by tests/make_goldens.sh) for each case of tests/test_golden_cli.py
    whose options the port carries, with the same arguments (the SAM @PG
    line carries them); the MT alignment cases are slow, as there;
(b) byte-identical to the JAX CLI on the same cases with -t 1, and on two
    more of the options this route adds (--eqx, an RMQ preset);
    the cases include the splice side data (--junc-bed, --spsc, -j),
    --write-junc, splice:sr (align_sr_rna), --alt and a genome larger than
    -I (the multi-part split/merge path);
(c) -t 2 writes what -t 1 writes (but for the @PG line, which carries
    the arguments).
The default route touches no device; the CLI still resolves one first,
so the tests pass device="cpu".
"""
import contextlib
import io

import pytest

import minimap2_tpu.cli as jax_cli
import minimap2_tpu_torch.cli as port_cli

GOLD = "tests/golden"
DATA = "tests/data"
MT = [f"{DATA}/MT-human.fa", f"{DATA}/MT-orang.fa"]
INV = [f"{DATA}/t-inv.fa", f"{DATA}/q-inv.fa"]
X3S = [f"{DATA}/x3s-ref.fa", f"{DATA}/x3s-qry.fa"]
T2 = ["-k14", "-w4", "-m10", "-s10", f"{DATA}/t2.fa", f"{DATA}/q2.fa"]
SR = [f"{DATA}/MT-human.fa", f"{DATA}/sr-r1.fq", f"{DATA}/sr-r2.fq"]

CASES = {
    "inv-paf": (["-c", "--cs", *INV], "inv-paf.out"),
    "inv-sam": (["-a", *INV], "inv-sam.out"),
    "x3s-splice-sam": (["-ax", "splice", *X3S], "x3s-splice-sam.out"),
    "x3s-splice-paf": (["-cx", "splice", "--cs", *X3S],
                       "x3s-splice-paf.out"),
    "t2-splice-paf": (["-cx", "splice", *T2], "t2-paf.out"),
    "t2-splice-sam": (["-ax", "splice", *T2], "t2-sam.out"),
    "sr-paired-paf": (["-x", "sr", *SR], "sr-paf.out"),
    "mt-nocig": (MT, "mt-nocig.out"),
    "mt-ava": (["-x", "ava-ont", f"{DATA}/MT-both.fa", f"{DATA}/MT-both.fa"],
               "mt-ava.out"),
    "mt-gapscale": (["--chain-gap-scale", "3.0", "--chain-skip-scale", "1.0",
                     *MT], "mt-gapscale.out"),
    "mt-seed": (["--seed", "42", "-c", *MT], "mt-seed.out"),
    "mt-optmisc": (["--max-chain-skip", "1", "--max-chain-iter", "20",
                    "--mask-len", "500", "--heap-sort=yes", "--rmq=no", *MT],
                   "mt-optmisc.out"),
    "inv-endbonus": (["--end-bonus", "50", "-a", *INV], "inv-endbonus.out"),
    "x3s-juncbed": (["-ax", "splice", "--junc-bed", f"{DATA}/x3s-junc.bed",
                     *X3S], "x3s-juncbed.out"),
    "x3s-spsc": (["-ax", "splice", "--spsc", f"{DATA}/x3s.spsc", *X3S],
                 "x3s-spsc.out"),
    "x3s-jump": (["-ax", "splice:sr", "-j", f"{DATA}/x3s-anno.bed",
                  f"{DATA}/x3s-ref.fa", f"{DATA}/jumpreads.fa"],
                 "x3s-jump.out"),
    "x3s-wj": (["-cx", "splice", "--write-junc", *X3S], "x3s-wj.out"),
    "x3s-srrna": (["-ax", "splice:sr", f"{DATA}/x3s-ref.fa",
                   f"{DATA}/jumpreads.fa"], "x3s-srrna.out"),
    "mt-alt": (["-c", "--alt", f"{DATA}/alt.txt", f"{DATA}/MT-both.fa",
                f"{DATA}/MT-orang.fa"], "mt-alt.out"),
    "mt-split": (["-c", "-I", "10k", f"{DATA}/MT-both.fa",
                  f"{DATA}/MT-orang.fa"], "mt-split.out"),
}
SLOW = {
    "mt-paf": (["-c", "--cs", *MT], "mt-paf.out"),
    "mt-sam": (["-a", *MT], "mt-sam.out"),
    "mt-sam-eqx": (["-a", "--eqx", "--MD", *MT], "mt-sam-eqx.out"),
    "mt-asm": (["-cx", "asm20", *MT], "mt-asm.out"),
}
PARAMS = [pytest.param(*CASES[k], id=k) for k in CASES] + \
    [pytest.param(*SLOW[k], id=k, marks=pytest.mark.slow) for k in SLOW]


def run(cli, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(argv, **kw) == 0
    return buf.getvalue()


@pytest.mark.parametrize("argv,golden", PARAMS)
def test_default_route_matches_golden(argv, golden):
    with open(f"{GOLD}/{golden}") as f:
        want = f.read()
    assert run(port_cli, argv, device="cpu") == want


@pytest.mark.parametrize("argv,golden", PARAMS + [
    pytest.param(["-a", "--eqx", "--MD", *INV], None, id="inv-sam-eqx"),
    pytest.param(["-cx", "asm20", *INV], None, id="inv-asm20")])
def test_default_route_matches_jax(argv, golden):
    argv = ["-t", "1", *argv]
    assert run(port_cli, argv, device="cpu") == run(jax_cli, argv)


@pytest.mark.parametrize("case", ["sr-paired-paf", "inv-sam"])
def test_threads_match_serial(case):
    argv = CASES[case][0]
    one, two = ([ln for ln in run(port_cli, ["-t", t, *argv],
                                  device="cpu").splitlines()
                 if not ln.startswith("@PG")] for t in ("1", "2"))
    assert two == one and len(one) >= 3
