"""The port's side-data readers, jump_split and align_sr_rna vs the JAX
package's on tests/data's files (tolerance 0):

(a) read_bed_junc and BedIntervals.junc (x3s-junc.bed, x3s-anno.bed as a
    BED12-less and a BED12 file), read_spsc and SpliceScores.get on both
    strands (x3s.spsc, scaled and not), read_alt (alt.txt), read_bed_merge
    and jjump_read with JJump.get (x3s-anno.bed, the -j and --pass1
    flags);
(b) jump_split on the splice:sr records of jumpreads.fa: each package's
    map_frag_core without jumps gives the same records, and each
    package's jump_split on them (jumps from x3s-anno.bed) gives the same
    records, some of them extended through the annotated intron;
(c) align_sr_rna on one-intron short reads (taken, or rejected for a long
    read, a mismatching end or a read whose ends do not match the gap's
    flanks), with and without junction flags.
"""
import copy
import dataclasses

import numpy as np
import pytest

from minimap2_tpu import config as jax_config
from minimap2_tpu.index import sidedata as jax_sd
from minimap2_tpu.index.index import MiniIndex as JaxMiniIndex
from minimap2_tpu.map import align_srrna as jax_srrna
from minimap2_tpu.map import jump as jax_jump
from minimap2_tpu.map import pipeline as jax_pipeline
from minimap2_tpu.map.align_engine import gen_simple_mat as jax_mat
from minimap2_tpu.ops.ksw2_np import ExtzResult as JaxEz
from minimap2_tpu_torch import config
from minimap2_tpu_torch.index import sidedata
from minimap2_tpu_torch.index.index import MiniIndex
from minimap2_tpu_torch.io.fastx import read_fasta
from minimap2_tpu_torch.map import align_srrna, jump, pipeline
from minimap2_tpu_torch.map.align_engine import gen_simple_mat
from minimap2_tpu_torch.ops import ksw2_np as K
from minimap2_tpu_torch.ops.ksw2_np import ExtzResult

DATA = "tests/data"


def _both(fa, w=5, k=15):
    names, seqs = read_fasta(fa)
    return (JaxMiniIndex.build(names, seqs, w=w, k=k),
            MiniIndex.build(names, seqs, w=w, k=k))


def test_bed_junc_and_spsc_match_jax():
    jmi, pmi = _both(f"{DATA}/x3s-ref.fa")
    n = pmi.seq[0].length
    for bed in ("x3s-junc.bed", "x3s-anno.bed"):
        want = jax_sd.read_bed_junc(f"{DATA}/{bed}", jmi)
        got = sidedata.read_bed_junc(f"{DATA}/{bed}", pmi)
        assert got.per_ctg == want.per_ctg and got.per_ctg[0]
        for st, en in ((0, n), (60, 140), (200, 270)):
            assert np.array_equal(got.junc(0, st, en), want.junc(0, st, en))
    for scale in (0.7, 1.0):
        nw = jax_sd.read_spsc(f"{DATA}/x3s.spsc", jmi, 20, scale)
        ng = sidedata.read_spsc(f"{DATA}/x3s.spsc", pmi, 20, scale)
        assert ng == nw == 3
        for rev in (False, True):
            for st, en in ((0, n), (50, 210), (69, 70)):
                assert np.array_equal(pmi.spsc.get(0, st, en, rev),
                                      jmi.spsc.get(0, st, en, rev))


def test_alt_and_jumps_match_jax():
    jmi, pmi = _both(f"{DATA}/MT-both.fa", w=10)
    assert sidedata.read_alt(f"{DATA}/alt.txt", pmi) == \
        jax_sd.read_alt(f"{DATA}/alt.txt", jmi) == 1
    assert [s.is_alt for s in pmi.seq] == [s.is_alt for s in jmi.seq]
    assert pmi.n_alt == jmi.n_alt == 1
    jmi, pmi = _both(f"{DATA}/x3s-ref.fa")
    for read_junc, min_sc in ((True, -1), (False, 5), (True, 7)):
        assert sidedata.read_bed_merge(f"{DATA}/x3s-anno.bed", pmi,
                                       read_junc, min_sc) == \
            jax_sd.read_bed_merge(f"{DATA}/x3s-anno.bed", jmi, read_junc,
                                  min_sc)
    for path, flag, min_sc in (("x3s-anno.bed", 0x1, -1),
                               ("x3s-anno.bed", 0x2, 5)):
        jax_sd.jjump_read(f"{DATA}/{path}", jmi, flag, min_sc)
        sidedata.jjump_read(f"{DATA}/{path}", pmi, flag, min_sc)
        assert pmi.jumps.per_ctg == jmi.jumps.per_ctg
    assert pmi.jumps.per_ctg[0]
    for st, en in ((0, 400), (120, 140), (128, 129), (260, 270), (-5, 0)):
        assert pmi.jumps.get(0, st, en) == jmi.jumps.get(0, st, en)


def test_jump_split_matches_jax():
    jmi, pmi = _both(f"{DATA}/x3s-ref.fa")
    jmo, pmo = jax_config.MapOptions(), config.MapOptions()
    for cfg, mi, mo in ((jax_config, jmi, jmo), (config, pmi, pmo)):
        cfg.set_opt("splice:sr", jax_config.IndexOptions(), mo)
        mo.flag |= cfg.MM_F_CIGAR | cfg.MM_F_OUT_SAM          # -a
        cfg.mapopt_update(mo, mi)
    jax_sd.jjump_read(f"{DATA}/x3s-anno.bed", jmi, 0x1, -1)
    sidedata.jjump_read(f"{DATA}/x3s-anno.bed", pmi, 0x1, -1)
    names, seqs = read_fasta(f"{DATA}/jumpreads.fa")
    n_moved = 0
    for name, seq in zip(names, seqs):
        seq = seq.encode() if isinstance(seq, str) else seq
        jregs = jax_pipeline.map_frag_core(_nojump(jmi), [seq], jmo,
                                           name)[0].regs
        pregs = pipeline.map_frag_core(_nojump(pmi), [seq], pmo,
                                       name)[0].regs
        assert [_d(r) for r in pregs] == [_d(r) for r in jregs]
        before = [_d(r) for r in pregs]
        for r in jregs:
            jax_jump.jump_split(jmi, jmo, len(seq), seq, r, 0)
        for r in pregs:
            jump.jump_split(pmi, pmo, len(seq), seq, r, 0)
        assert [_d(r) for r in pregs] == [_d(r) for r in jregs]
        n_moved += [_d(r) for r in pregs] != before
    assert n_moved >= 2
    pmo.flag |= config.MM_F_EQX
    with pytest.raises(AssertionError):
        jump.jump_split(pmi, pmo, len(seq), seq, pregs[0], 0)


def _nojump(mi):
    m = copy.copy(mi)
    m.jumps = None
    return m


def _d(r):
    return dataclasses.asdict(r)


def test_align_sr_rna_matches_jax():
    rng = np.random.default_rng(2)
    mo = config.MapOptions()
    config.set_opt("splice:sr", config.IndexOptions(), mo)
    mat = gen_simple_mat(5, mo.a, mo.b, mo.sc_ambi)
    assert np.array_equal(mat, jax_mat(5, mo.a, mo.b, mo.sc_ambi))
    taken = 0
    for case in range(12):
        left = rng.integers(0, 4, 60).astype(np.uint8)
        right = rng.integers(0, 4, 60).astype(np.uint8)
        intron = rng.integers(0, 4, 300).astype(np.uint8)
        intron[:2], intron[-2:] = (2, 3), (0, 2)            # GT ... AG
        la = int(rng.integers(20, 50))
        qseq = np.concatenate([left[-la:], right[:80 - la]])
        if case % 4 == 1:           # a mismatching end: rejected
            qseq[:12] = (qseq[:12] + 1) % 4
        if case % 4 == 2:           # longer than the flank limit
            qseq = np.concatenate([left[-la:], right[:60], left[:40]])
        tseq = np.concatenate([left[-la:], intron, right[:80 - la]])
        junc = None
        if case % 2:
            junc = np.zeros(len(tseq), np.uint8)
            junc[la - 1] |= 2
            junc[la + 300] |= 8
        flag = K.KSW_EZ_SPLICE_FOR | K.KSW_EZ_APPROX_MAX
        jez, pez = JaxEz(), ExtzResult()
        want = jax_srrna.align_sr_rna(mo, qseq, tseq, junc, mat, 100, -1,
                                      mo.zdrop, flag, jez)
        got = align_srrna.align_sr_rna(mo, qseq, tseq, junc, mat, 100, -1,
                                       mo.zdrop, flag, pez)
        assert got == want
        if got:
            assert (pez.cigar, pez.score) == (jez.cigar, jez.score)
            assert sum((c & 0xF) == 3 for c in pez.cigar) == 1
            taken += 1
    assert taken >= 4
