"""The port's paftools (minimap2_tpu_torch.tools.paftools) against the JAX
package's: every subcommand of _CMDS, `version` and the no-argument usage
run through both modules' ``main`` on the same inputs (the goldens, and
small files written here after tests/test_paftools*.py), with stdout,
stderr and the return code compared byte for byte."""
import contextlib
import io
import os

import pytest

from minimap2_tpu.tools import paftools as jax_pt
from minimap2_tpu_torch.tools import paftools as port_pt

HERE = os.path.dirname(os.path.abspath(__file__))
GOLD = os.path.join(HERE, "golden")

_HDR = "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\n"
_ROW = "{q}\t9000\t0\t8000\t+\t{t}\t50000\t{st}\t{en}\t7000\t8000\t{mq}"
_MJ = "{q}\t8000000\t{qs}\t{qe}\t+\t{t}\t50000000\t{ts}\t{te}\t{bm}\t{bl}\t60"
_GENE = "{g}\t{ql}\t0\t{ql}\t+\t{t}\t1000000\t{ts}\t{te}\t{ql}\t{ql}\t60"
_ASM = ("ctg1\t500000\t{qs}\t{qe}\t+\tchr1\t900000\t{ts}\t{te}\t{m}\t{m}"
        "\t60\ttp:A:P")

FILES = {
    "sim.paf": "".join(
        "\t".join(map(str, [f"r{i}!chr1!{1000 * i}!{1000 * i + 900}!+", 900,
                            0, 900, "+", "chr1", 99999, 1000 * i + 10,
                            1000 * i + 890, 880, 900, 60])) + "\n"
        for i in range(9))
    + "r9!chr1!50000!50900!+\t900\t0\t900\t+\tchr2\t99999\t7\t880\t870\t900"
      "\t30\n",
    "anno.gtf":
        'chr1\tx\texon\t1\t100\t.\t+\t.\ttranscript_id "t1";\n'
        'chr1\tx\texon\t201\t300\t.\t+\t.\ttranscript_id "t1";\n'
        'chr1\tx\texon\t401\t500\t.\t+\t.\ttranscript_id "t1";\n',
    "aln.sam":
        "@SQ\tSN:chr1\tLN:1000\n"
        "r1\t0\tchr1\t51\t60\t50M100N50M90N50M\t*\t0\t0\t*\t*\n"
        "r2\t0\tchr1\t1\t60\t100M\t*\t0\t0\t*\t*\n",
    "ov.paf":
        "r0!c!100!5000!+\t4900\t0\t4000\t+\tr1!c!3000!9000!+\t6000\t0\t4000"
        "\t3000\t4000\t0\n"
        "r2!c!100!2000!+\t1900\t0\t1000\t+\tr3!c!50000!52000!+\t2000\t0\t1000"
        "\t900\t1000\t0\n",
    "cds.gtf":
        'chr1\tx\texon\t1\t100\t.\t+\t.\tgene_id "g1"; transcript_id "t1"; '
        'transcript_type "protein_coding";\n'
        'chr1\tx\texon\t201\t300\t.\t+\t.\tgene_id "g1"; transcript_id '
        '"t1"; transcript_type "protein_coding";\n'
        'chr1\tx\tCDS\t10\t280\t.\t+\t.\tgene_id "g1"; transcript_id '
        '"t1";\n',
    "lift.bed": "MT_orang\t100\t200\nMT_orang\t5000\t5100\n",
    "t.delta": "/r /q\nNUCMER\n>r1 q1 100 90\n1 50 1 50 2 2 0\n10\n-20\n0\n",
    "reg.bed": "c1\t10\t50\nc1\t40\t80\n",
    "tgt.bed": "c1\t0\t20\nc1\t70\t100\nc2\t0\t5\n",
    "mason.sam":
        "@HD\tVN:1\n"
        "simulated.r7\t99\tchr3\t101\t60\t5M\t=\t0\t0\tACGTA\tIIIII"
        "\tXE:i:1\tXS:i:2\tXI:i:0\n"
        "simulated.r7\t147\tchr3\t201\t60\t5M\t=\t0\t0\tTTTTA\tJJJJJ"
        "\tXE:i:0\tXS:i:0\tXI:i:3\n",
    "ref.fai": "chrA\t1000\nchrB\t2000\n",
    "p.maf": "a\ns ref 100 10 + 1000 ACGTACGTAC\n"
             "s S2_1 0 10 - 10 ACGT-ACGTAC\n",
    "sim.txt": "r0!chr1!100!200!+\nr1!chr2!300_400!350_470!+-/2\n",
    "chr1.fai": "chr1\t1000\n",
    "br.fq":
        "@r1 chr1,+strand,100-200 length=100 read_identity=92.5%\n"
        "ACGT\n+\nIIII\n"
        "@r2 chr1,-strand,300-400 length=100 read_identity=88.0%\n"
        "TTTT\n+\nJJJJ\n"
        "@r3 junk chimera junk\nGGGG\n+\nKKKK\n",
    "cs.paf": "q1\t10\t0\t8\t+\tt1\t20\t5\t12\t8\t8\t60"
              "\tcs:Z:=ACG*ta+GG-TT=A\n",
    "t.gff3":
        "# comment\n"
        "chr1\tsrc\tCDS\t101\t200\t.\t+\t0\tID=c1;Parent=tx1\n"
        "chr1\tsrc\tCDS\t301\t400\t.\t+\t0\tID=c2;Parent=tx1\n"
        "chr1\tsrc\texon\t1\t500\t.\t+\t.\tParent=tx1\n"
        "chr2\tsrc\tCDS\t51\t60\t.\t-\t0\tParent=tx2\n",
    "stat.vcf":
        "##x\n" + _HDR
        + "c\t1\t.\tA\tG\t.\t.\t.\nc\t2\t.\tA\tC\t.\t.\t.\n"
          "c\t3\t.\tA\tAT\t.\t.\t.\nc\t4\t.\tATTT\tA\t.\t.\t.\n"
          "c\t5\t.\tA\t" + "A" * 60 + "\t.\t.\t.\n",
    "sel.vcf":
        _HDR + "c\t1\t.\tA\tG\t.\t.\t.\nc\t2\t.\tA\tATTTTT\t.\t.\t.\n"
               "c\t3\t.\tA\t<DEL>\t.\t.\tSVLEN=-100\n",
    "pair.vcf":
        "##source=x\n##contig=<ID=chr1,length=100>\n"
        "##contig=<ID=chr1_random,length=5>\n"
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tH1\tH2\n"
        "chr1\t10\t.\tA\tG\t.\t.\t.\tGT:AD\t1/1:0,5\t1/1:1,4\n"
        "chr1\t20\t.\tC\tT\t.\t.\t.\tGT:AD\t0/1:3,3\t1/1:0,6\n"
        "chr1\t30\t.\tG\tA\t.\t.\t.\tGT:AD\t./.:0,0\t0/0:7,0\n"
        "chrUn\t5\t.\tT\tC\t.\t.\t.\tGT:AD\t1/1:0,2\t1/1:0,2\n",
    "base.paf": "\n".join([
        _ROW.format(q="r1", t="c1", st=1000, en=9000, mq=60),
        _ROW.format(q="r2", t="c1", st=20000, en=28000, mq=60),
        _ROW.format(q="r3", t="c2", st=100, en=8100, mq=60)]) + "\n",
    "test.paf": "\n".join([
        _ROW.format(q="r1", t="c1", st=1100, en=9100, mq=60),
        _ROW.format(q="r2", t="c2", st=20000, en=28000, mq=60)]) + "\n",
    "asm.paf": "\n".join([
        _MJ.format(q="ctg1", qs=0, qe=3000000, t="chr1", ts=0, te=3000000,
                   bm=2900000, bl=3000000),
        _MJ.format(q="ctg1", qs=3000000, qe=7000000, t="chr2", ts=0,
                   te=4000000, bm=3900000, bl=4000000),
        _MJ.format(q="ctg2", qs=0, qe=3000000, t="chr3", ts=0, te=3000000,
                   bm=2900000, bl=3000000),
        _MJ.format(q="ctg2", qs=3000000, qe=7000000, t="chr3", ts=8000000,
                   te=12000000, bm=3900000, bl=4000000)]) + "\n",
    "cen.bed": "chr1\t0\t4000000\n",
    "base.vcf": _HDR + "c1\t1000\t.\tA\tA" + "G" * 100 + "\t.\tPASS\t.\n"
                + "c1\t5000\t.\tA" + "C" * 80 + "\tA\t.\tPASS\t.\n"
                + "c1\t9000\t.\tA\t" + "T" * 61 + "\t.\tPASS\t.\n",
    "call.vcf": _HDR + "c1\t1050\t.\tA\tA" + "G" * 100 + "\t.\tPASS\t.\n"
                + "c1\t5020\t.\tA" + "C" * 80 + "\tA\t.\t.\t.\n"
                + "c2\t100\t.\tA\t" + "T" * 70 + "\t.\tPASS\t.\n",
    "mp.paf": "p1\t100\t0\t100\t+\tchr1\t100000\t2000\t3450\t95\t100"
              "\t60\tAS:i:500\tcg:Z:300M1000N150M\n",
    "gref.paf": "\n".join([
        _GENE.format(g="g1", ql=1000, t="chr1", ts=1000, te=2000),
        _GENE.format(g="g2", ql=2000, t="chr1", ts=50000, te=52000)]) + "\n",
    "gasm.paf": _GENE.format(g="g1", ql=1000, t="ctg1", ts=100, te=1100)
                + "\n",
    "asm.fai": "chr1\t900000\n",
    "asmstat.paf": "\n".join([
        _ASM.format(qs=0, qe=200000, ts=0, te=200000, m=200000),
        _ASM.format(qs=200000, qe=500000, ts=300000, te=600000,
                    m=300000)]) + "\n",
    "ex.gtf":
        'chr1\tx\texon\t1001\t1200\t.\t+\t.\ttranscript_id "tx1";\n'
        'chr1\tx\texon\t2001\t2300\t.\t+\t.\ttranscript_id "tx1";\n',
    "ex.sam":
        "@SQ\tSN:chr1\tLN:100000\n"
        "r1\t0\tchr1\t1001\t60\t200M800N300M\t*\t0\t0\t*\t*\n"
        "r2\t0\tchr1\t5001\t60\t100M\t*\t0\t0\t*\t*\n",
}

# argv per case: "@name" is a file of FILES written to the test's tmp_path,
# "%name" a golden
CASES = {
    "sam2paf": ["sam2paf", "%mt-sam-eqx.out"],
    "mapeval": ["mapeval", "@sim.paf"],
    "stat": ["stat", "%mt-sam.out"],
    "junceval": ["junceval", "@anno.gtf", "@aln.sam"],
    "view": ["view", "%mt-paf.out"],
    "call": ["call", "-l", "1000", "-L", "1000", "%mt-paf.out"],
    "ov-eval": ["ov-eval", "@ov.paf"],
    "gff2bed": ["gff2bed", "-j", "@cds.gtf"],
    "liftover": ["liftover", "-l", "1000", "%mt-paf.out", "@lift.bed"],
    "splice2bed": ["splice2bed", "%x3s-splice-paf.out"],
    "delta2paf": ["delta2paf", "@t.delta"],
    "bedcov": ["bedcov", "-p", "@reg.bed", "@tgt.bed"],
    "mason2fq": ["mason2fq", "@mason.sam"],
    "pbsim2fq": ["pbsim2fq", "@ref.fai", "@p.maf"],
    "sim2bed": ["sim2bed", "@sim.txt"],
    "badread2fa": ["badread2fa", "@chr1.fai", "@br.fq"],
    "longcs2seq": ["longcs2seq", "-q", "@cs.paf"],
    "gff2junc": ["gff2junc", "@t.gff3"],
    "vcfstat": ["vcfstat", "@stat.vcf"],
    "vcfsel": ["vcfsel", "-l", "3", "@sel.vcf"],
    "vcfpair": ["vcfpair", "-s", "samp", "@pair.vcf"],
    "pafcmp": ["pafcmp", "@base.paf", "@test.paf"],
    "misjoin": ["misjoin", "-c", "@cen.bed", "@asm.paf"],
    "sveval": ["sveval", "@base.vcf", "@call.vcf"],
    "paf2gff": ["paf2gff", "@mp.paf"],
    "asmstat": ["asmstat", "@asm.fai", "@asmstat.paf"],
    "asmgene": ["asmgene", "@gref.paf", "@gasm.paf"],
    "exoneval": ["exoneval", "-s", "@ex.gtf", "@ex.sam"],
    "version": ["version"],
    "usage": [],
}


def _run(mod, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = mod.main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def test_cases_cover_every_command():
    assert set(CASES) == set(jax_pt._CMDS) | {"version", "usage"}
    assert port_pt._CMDS.keys() == jax_pt._CMDS.keys()


@pytest.mark.parametrize("case", sorted(CASES))
def test_paftools_matches_jax(case, tmp_path):
    argv = []
    for a in CASES[case]:
        if a[0] == "@":
            (tmp_path / a[1:]).write_text(FILES[a[1:]])
            a = str(tmp_path / a[1:])
        elif a[0] == "%":
            a = os.path.join(GOLD, a[1:])
        argv.append(a)
    want = _run(jax_pt, argv)
    got = _run(port_pt, argv)
    assert got == want
    assert want[1] or want[2]          # the case printed something
