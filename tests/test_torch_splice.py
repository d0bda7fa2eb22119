"""The port's spliced alignment path (-x splice) vs the JAX package,
tolerance 0:

(a) splice_site_arrays (both strands, both site models);
(b) exts2_batch_plain vs exts_pallas.exts2_batch in interpret mode: p and
    ez bit-equal, on pairs with planted GT..AG / CT..AC introns, N codes,
    N not a multiple of G, and pairs that end on a chunk boundary inside
    and at the end of their group (the EZ_DEAD lane);
(c) the splice-mode traceback plain vs traceback_batch(splice=True) in
    interpret mode, and decode_ops with long_thres;
(d) run_batched_align_cli -x splice: PAF (cg:Z, ts:A, AS:i) and SAM
    byte-identical to the JAX package's on tests/data/x3s-* and on
    simulated 3-4 exon cDNA of both strands (splice, splice:hq, cdna); the
    CLI's --batch -x splice PAF and -a SAM;
(e) the packing of SpliceAlignBatcher (both strand rounds in one exts2
    launch, FOR rows first, sub-batches padded to a multiple of G, more
    jobs than one launch) byte-identical to the JAX package, and the
    longest-first job order of a launch;
(f) the exts2 kernel's CUDA source built for the host with g++ and
    tests/cuda_host_shim.h (one std::thread per CUDA thread) bit-equal to
    exts2_batch_plain: the packed lanes, band-only work and exported
    scalars, on the card's arithmetic but without nvcc or a card.
"""
import ctypes
import functools
import io
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import minimap2_tpu.cli as jax_cli
import minimap2_tpu.map.driver as jax_driver
import minimap2_tpu.parallel.engine as jax_engine
from minimap2_tpu import config as jax_config
from minimap2_tpu.index.index import MiniIndex as JaxMiniIndex
from minimap2_tpu.io.fastx import read_fasta as jax_read_fasta
from minimap2_tpu.ops import exts_pallas, traceback_pallas
import minimap2_tpu_torch.cli as port_cli
from minimap2_tpu_torch import config as port_config
from minimap2_tpu_torch.index.index import MiniIndex
from minimap2_tpu_torch.ops import exts, traceback
from minimap2_tpu_torch.parallel import align_batch, engine
from cuda_host import build_on_host

jax.config.update("jax_platforms", "cpu")

ACGT = np.frombuffer(b"ACGT", np.uint8)
Q, E, Q2, NONCAN = 2, 1, 32, 9
# (qlen, tlen): #2 ends on a chunk boundary (qlen + tlen - 1 = 256 = 8 * 32)
# inside its group (pair 0 is longer); #8 (224) is the longest of the last
# group for G = 4 and G = 8; #5 has the longer query, #6 is 1 x 1
LENS = [(90, 300), (60, 150), (80, 177), (40, 44), (96, 250), (70, 60),
        (1, 1), (50, 200), (64, 161), (30, 100), (45, 90)]


def _spliced_pairs(seed, lens_list, QP, TP):
    """Pairs of the given lengths: a planted canonical intron of tlen -
    qlen bases (GT..AG on even pairs, CT..AC on odd ones) where that is
    >= 20, else the query with indels; 3% substitutions, N runs."""
    rng = np.random.default_rng(seed)
    N = len(lens_list)
    qr = np.zeros((N, QP), np.uint8)
    sf = np.zeros((N, TP), np.uint8)
    lens = np.array(lens_list, np.int32)
    for n, (ql, tl) in enumerate(lens_list):
        q = rng.integers(0, 4, ql).astype(np.uint8)
        intron = tl - ql
        if intron >= 20:
            ex1 = int(rng.integers(min(10, ql - 1), max(ql - 10, 11)))
            iv = rng.integers(0, 4, intron).astype(np.uint8)
            if n % 2 == 0:
                iv[:2], iv[-2:] = (2, 3), (0, 2)        # GT..AG
            else:
                iv[:2], iv[-2:] = (1, 3), (0, 1)        # CT..AC
            t = np.concatenate([q[:ex1], iv, q[ex1:]])
        else:
            t = np.concatenate([q, rng.integers(0, 4, max(intron, 0))])
            t = np.delete(t, rng.integers(0, len(t), max(-intron, 0)))[:tl]
        t = t.astype(np.uint8)
        mm = rng.random(ql) < 0.03
        q[mm] = (q[mm] + 1) % 4
        if n % 4 == 3 and ql > 12:
            q[5:9] = 4
        if n % 4 == 1 and tl > 12:
            t[3:6] = 4
        qr[n, :ql] = q[::-1]
        sf[n, :tl] = t
    return qr, sf, lens


def _jax_p(p, N):
    NG, RC, RB, G, W = p.shape
    return np.asarray(p).transpose(0, 3, 1, 2, 4).reshape(
        NG * G, RC * RB, W)[:N]


@pytest.mark.parametrize("flag_for", [True, False])
@pytest.mark.parametrize("cmplx", [True, False])
def test_splice_site_arrays_match_jax(flag_for, cmplx):
    rng = np.random.default_rng(5)
    ts = rng.integers(0, 5, (6, 300)).astype(np.uint8)
    tl = np.array([300, 150, 64, 5, 1, 299], np.int32)
    for flank in (False, True):
        got = exts.splice_site_arrays(ts, tl, flag_for, NONCAN, cmplx, flank)
        want = exts_pallas.splice_site_arrays(ts, tl, flag_for, NONCAN,
                                              cmplx, flank)
        for g, w in zip(got, want):
            assert g.dtype == np.int8
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("flag_for,G,sc_N", [(True, 8, -1), (False, 4, -2)])
def test_exts2_and_traceback_match_jax(flag_for, G, sc_N):
    QP, TP, W, RB = 96, 320, 128, 32
    R = QP + TP
    qr, sf, lens = _spliced_pairs(7 + G, LENS, QP, TP)
    dn, ac = exts.splice_site_arrays(sf, lens[:, 1], flag_for, NONCAN, True,
                                     False)
    kw = dict(G=G, W=W, RB=RB, R=R, QP=QP, TP=TP, q=Q, e=E, q2=Q2, zdrop=-1,
              right_mode=False, approx_max=True, approx_drop=False,
              sc_mch=1, sc_mis=-2, sc_N=sc_N, with_cigar=True)
    jp, jez = exts_pallas.exts2_batch(qr, sf, dn, ac, lens, interpret=True,
                                      **kw)
    p, ez = exts.exts2_batch(*(torch.from_numpy(x)
                               for x in (qr, sf, dn, ac, lens)), **kw)
    N = len(LENS)
    want_ez = np.asarray(jez)
    np.testing.assert_array_equal(ez.numpy(), want_ez)
    np.testing.assert_array_equal(p.numpy(), _jax_p(jp, N))
    RT = p.shape[1]
    # the chunk-boundary pairs: EZ_DEAD set inside its group, not at the end
    assert (int(want_ez[2, exts_pallas.EZ_NR]), int(want_ez[8,
            exts_pallas.EZ_NR])) == (256, 224)
    assert want_ez[2, exts_pallas.EZ_DEAD] == 1
    assert want_ez[8, exts_pallas.EZ_DEAD] == 0

    jops, jfin = traceback_pallas.traceback_batch(
        jp, jnp.asarray(lens), G=G, W=W, RB=RB, R=R, w=0, splice=True, QP=QP,
        interpret=True)
    ops, fin = traceback.traceback_batch(p, torch.from_numpy(lens), RB=RB,
                                         w=0, splice=True, QP=QP)
    np.testing.assert_array_equal(ops.numpy(), np.asarray(jops)[:, :RT])
    np.testing.assert_array_equal(fin.numpy(), np.asarray(jfin))
    lt, _ = exts.long_thres_of(Q, E, Q2)
    n_intron = 0
    for i in range(N):
        args = (ops.numpy()[i], int(fin[i, 0]), int(fin[i, 1]))
        for spl in (False, True):
            got = traceback.decode_ops(*args, splice=spl, long_thres=lt)
            assert got == traceback_pallas.decode_ops(
                *args, splice=spl, long_thres=lt)
        n_intron += any((c & 0xF) == 3 for c in got)
    assert n_intron >= 4                       # the planted introns


def test_decode_ops_leading_intron():
    """A leftover i >= long_thres becomes a leading N in splice mode."""
    ops = np.array([1, 0, 1, 2, 4, 4, 1, 3, 1], np.uint8)
    for fin_i, fin_j in ((40, -1), (5, -1), (-1, 3), (40, 2)):
        for spl in (False, True):
            args = (ops, fin_i, fin_j)
            assert traceback.decode_ops(*args, splice=spl, long_thres=29) \
                == traceback_pallas.decode_ops(*args, splice=spl,
                                               long_thres=29)
    assert traceback.decode_ops(ops, 40, -1, splice=True,
                                long_thres=29)[0] == (41 << 4 | 3)


def test_exts2_modes_off_the_path_raise():
    """Every mode of the JAX kernel runs (test_exts2_modes_match_jax), and
    so does W past 4096 (the port kernel's limit before its slab route),
    bit-equal to the JAX kernel; what still raises is a shape the kernel
    does not take: W not a multiple of 128, W < QP + 32, W past MAX_W (the
    port kernel's ceiling), and planes that are not (N, QP), (N, TP)."""
    x = torch.zeros((1, 96), dtype=torch.uint8)
    t = torch.zeros((1, 128), dtype=torch.uint8)
    d = torch.zeros((1, 128), dtype=torch.int8)
    lens = torch.ones((1, 2), dtype=torch.int32)
    kw = dict(G=8, W=128, RB=32, R=224, QP=96, TP=128, q=Q, e=E, q2=Q2,
              zdrop=-1, right_mode=False, approx_max=True, approx_drop=False,
              sc_mch=1, sc_mis=-2, sc_N=-1)
    for mode in (dict(zdrop=200), dict(approx_max=False),
                 dict(right_mode=True), dict(approx_drop=True),
                 dict(with_cigar=False)):
        p, ez = exts.exts2_batch(x, t, d, d, lens, **{**kw, **mode})
        assert (p is None) == ("with_cigar" in mode)
    with pytest.raises(ValueError, match="W >= QP"):
        exts.exts2_batch(x, t, d, d, lens, **{**kw, "QP": 100})
    wide = {**kw, "W": 4224}
    jp, jez = exts_pallas.exts2_batch(
        *(jnp.asarray(a.numpy()) for a in (x, t, d, d, lens)),
        interpret=True, **wide)
    p, ez = exts.exts2_batch(x, t, d, d, lens, **wide)
    np.testing.assert_array_equal(ez.numpy(), np.asarray(jez))
    np.testing.assert_array_equal(p.numpy(), _jax_p(jp, 1))
    for bad in (dict(W=192), dict(W=exts.MAX_W + 128, QP=96), dict(TP=100)):
        with pytest.raises(ValueError):
            exts.exts2_batch(x, t, d, d, lens, **{**kw, **bad})


@pytest.mark.parametrize("approx_max", [True, False],
                         ids=["approx", "exact"])
def test_exts2_wide_matches_jax(approx_max):
    """exts2 at W 4224 (QP 4096's window, past the 256 threads of 16
    lanes the port kernel held before), on jobs of QP <= 256: the splice
    path's approx mode and the exact mode with z-drop; p and ez bit-equal
    to the JAX kernel's."""
    QP, TP, W, RB, G = 256, 512, 4224, 32, 4
    lens_l = [(240, 500), (256, 256), (100, 512), (1, 1), (200, 90)]
    qr, sf, lens = _spliced_pairs(W, lens_l, QP, TP)
    dn, ac = exts.splice_site_arrays(sf, lens[:, 1], True, NONCAN, True,
                                     False)
    planes = (qr, sf, dn, ac, lens)
    kw = dict(G=G, W=W, RB=RB, R=QP + TP, QP=QP, TP=TP, q=Q, e=E, q2=Q2,
              zdrop=-1 if approx_max else 60, right_mode=False,
              approx_max=approx_max, approx_drop=False, sc_mch=1, sc_mis=-2,
              sc_N=-1, with_cigar=True)
    jp, jez = exts_pallas.exts2_batch(*planes, interpret=True, **kw)
    p, ez = exts.exts2_batch(*(torch.from_numpy(x) for x in planes), **kw)
    np.testing.assert_array_equal(ez.numpy(), np.asarray(jez))
    np.testing.assert_array_equal(p.numpy(), _jax_p(jp, len(lens_l)))
    assert (ez.numpy()[:, exts_pallas.EZ_SCORE] > 0).sum() >= 3


# the mode grid: approx_max x right_mode x with_cigar x zdrop, and
# approx_drop (with approx_max) x right_mode x with_cigar.  Under the
# splice scoring an intron caps a row's drop (H at t stays within q2 + a
# site penalty of the maximum while the target lasts), so a z-drop needs a
# query tail past the target: zdrop 60 here, where 200 would need a
# longer query than these widths.
MODES = [(am, rm, wc, zd, False) for am in (True, False)
         for rm in (False, True) for wc in (True, False) for zd in (-1, 60)] \
    + [(True, rm, wc, 60, True) for rm in (False, True) for wc in (True, False)]
ZLENS = [(180, 250), (170, 230), (150, 256), (192, 192), (120, 240),
         (60, 150), (1, 1), (190, 200), (80, 177)]


def zdrop_spliced_pairs():
    """ZLENS spliced pairs; in #0-#3 and #7 the query turns random
    partway, so the exact and approx-drop modes z-drop there."""
    qr, sf, lens = _spliced_pairs(3, ZLENS, 192, 256)
    rng = np.random.default_rng(4)
    for n, k in ((0, 80), (1, 70), (2, 50), (3, 100), (7, 60)):
        ql = ZLENS[n][0]
        qr[n, :ql - k] = rng.integers(0, 4, ql - k)     # its last ql - k
    dn, ac = exts.splice_site_arrays(sf, lens[:, 1], True, NONCAN, True,
                                     False)
    return qr, sf, dn, ac, lens


def _mode_id(m):
    am, rm, wc, zd, ad = m
    return (("approx" if am else "exact") + ("-right" if rm else "-left")
            + ("-cigar" if wc else "-nocigar") + f"-z{zd}"
            + ("-adrop" if ad else ""))


@pytest.mark.parametrize("mode", MODES, ids=_mode_id)
def test_exts2_modes_match_jax(mode):
    """Each mode of the JAX kernel (exact-max with its H row, z-drop,
    approx-drop, right-align, no-cigar): p and ez bit-equal."""
    am, rm, wc, zd, ad = mode
    planes = zdrop_spliced_pairs()
    QP, TP, W, RB, G = 192, 256, 256, 32, 4
    kw = dict(G=G, W=W, RB=RB, R=QP + TP, QP=QP, TP=TP, q=Q, e=E, q2=Q2,
              zdrop=zd, right_mode=rm, approx_max=am, approx_drop=ad,
              sc_mch=1, sc_mis=-2, sc_N=-1, with_cigar=wc)
    jp, jez = exts_pallas.exts2_batch(*planes, interpret=True, **kw)
    p, ez = exts.exts2_batch(*(torch.from_numpy(x) for x in planes), **kw)
    np.testing.assert_array_equal(ez.numpy(), np.asarray(jez))
    if wc:
        np.testing.assert_array_equal(p.numpy(), _jax_p(jp, len(ZLENS)))
    else:
        assert p is None
    ezn = ez.numpy()
    dropped = ezn[:, exts_pallas.EZ_ZDROP] == 1
    if zd >= 0 and (not am or ad):
        assert dropped[[0, 1, 2, 7]].all() and (ezn[dropped, exts_pallas.EZ_DEAD]
                                                == 1).all()
        assert (ezn[dropped, exts_pallas.EZ_NR] < planes[4].sum(1)[dropped] - 1
                ).all()
    else:
        assert not dropped.any()
    if not am:
        assert (ezn[:, exts_pallas.EZ_MAX] > 0).sum() >= 7


COMP = bytes.maketrans(b"ACGT", b"TGCA")
KW_X3S = {"QP": 512, "TP": 1024, "sub": 4, "RB": 32}
KW_SIM = {"QP": 512, "TP": 2048, "sub": 4, "RB": 32}


def _sim_genes(seed, n_genes=4):
    """A 24 kb genome (longer above 4 genes) with n_genes planted 3-4
    exon genes (canonical
    GT..AG on the gene's strand, so CT..AC on the forward sequence for -
    genes) and one cDNA read per gene, in either orientation, with 1%
    substitutions.  Returns (genome bytes, reads, [(start, end, introns)])."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, max(24000, 2000 + 5500 * n_genes)).astype(np.uint8)
    reads, truth = [], []
    for i in range(n_genes):
        pos = 1000 + 5500 * i
        exons = []
        for j in range(int(rng.integers(3, 5))):
            ln = int(rng.integers(60, 130))
            exons.append((pos, pos + ln))
            pos += ln + int(rng.integers(80, 450))
        minus = i % 2 == 1
        introns = [(a[1], b[0]) for a, b in zip(exons, exons[1:])]
        for st, en in introns:
            if minus:
                g[st:st + 2], g[en - 2:en] = (1, 3), (0, 1)     # CT..AC
            else:
                g[st:st + 2], g[en - 2:en] = (2, 3), (0, 2)     # GT..AG
        tx = np.concatenate([g[a:b] for a, b in exons])
        m = rng.random(len(tx)) < 0.01
        tx[m] = (tx[m] + 1) % 4
        seq = ACGT[tx].tobytes()
        if minus ^ (i % 4 >= 2):
            seq = seq.translate(COMP)[::-1]
        reads.append(seq)
        truth.append((exons[0][0], exons[-1][1], introns))
    return ACGT[g].tobytes(), reads, truth


def _splice_world(names, seqs, flag, preset):
    """The same index and options in both packages for a splice preset."""
    out = []
    for cfg, MI in ((jax_config, JaxMiniIndex), (port_config, MiniIndex)):
        io_, mo = cfg.IndexOptions(), cfg.MapOptions()
        cfg.set_opt(preset, io_, mo)
        mo.flag |= flag
        mi = MI.build(names, seqs, w=io_.w, k=io_.k, flag=io_.flag)
        cfg.mapopt_update(mo, mi)
        out.append((mi, mo))
    return out


def _run_both_splice(monkeypatch, tmp_path, names, seqs, reads, flag, kw,
                     preset="splice", batch_reads=4):
    """run_batched_align_cli of both packages; the JAX package's host path
    records the names of its reads and maps them."""
    (jmi, jmo), (pmi, pmo) = _splice_world(names, seqs, flag, preset)
    fa = tmp_path / "reads.fa"
    fa.write_text("".join(f">rd{i}\n{s.decode()}\n"
                          for i, s in enumerate(reads)))
    host = []
    map_fragment = jax_driver.map_fragment
    monkeypatch.setattr(jax_driver, "map_fragment",
                        lambda mi, opt, frag: host.extend(
                            r.name for r in frag) or map_fragment(mi, opt,
                                                                  frag))
    want = io.StringIO()
    jax_engine.run_batched_align_cli(jmi, jmo, [str(fa)], want,
                                     batch_reads=batch_reads, L=512,
                                     align_kw=kw)
    got = io.StringIO()
    n, fallbacks = engine.run_batched_align_cli(
        pmi, pmo, [str(fa)], got, batch_reads=batch_reads, L=512,
        align_kw=kw, device="cpu")
    assert n == len(reads)
    assert [name for name, _ in fallbacks] == host
    return want.getvalue(), got.getvalue()


@pytest.mark.parametrize("sam", [False, True], ids=["paf", "sam"])
def test_splice_x3s_matches_jax(monkeypatch, tmp_path, sam):
    names, seqs = jax_read_fasta("tests/data/x3s-ref.fa")
    _, qs = jax_read_fasta("tests/data/x3s-qry.fa")
    flag = jax_config.MM_F_CIGAR | (jax_config.MM_F_OUT_SAM if sam
                                    else jax_config.MM_F_OUT_CG)
    want, got = _run_both_splice(monkeypatch, tmp_path, names, seqs,
                                 list(qs) * 2, flag, KW_X3S)
    assert got == want
    t = got.splitlines()[0].split("\t")
    assert ("N" in t[5]) if sam else any(x.startswith("cg:Z:") and "N" in x
                                          for x in t)


@pytest.mark.parametrize("preset", ["splice", "splice:hq", "cdna"])
def test_splice_sim_cdna_matches_jax(monkeypatch, tmp_path, preset):
    """Both strands and orientations: PAF cg:Z / ts:A / AS:i identical,
    and the planted introns placed exactly."""
    genome, reads, truth = _sim_genes(3)
    want, got = _run_both_splice(
        monkeypatch, tmp_path, ["chrS"], [genome], reads,
        jax_config.MM_F_CIGAR | jax_config.MM_F_OUT_CG, KW_SIM, preset)
    assert got == want
    lines = [ln.split("\t") for ln in got.splitlines()]
    prim = {t[0]: t for t in lines if "tp:A:P" in t}
    assert len(prim) == len(reads)
    n_exact = 0
    for i, (st, en, introns) in enumerate(truth):
        t = prim[f"rd{i}"]
        assert any(x.startswith("ts:A:") for x in t)
        assert any(x.startswith("AS:i:") for x in t)
        cg = [x for x in t if x.startswith("cg:Z:")][0][5:]
        pos, got_in = int(t[7]), []
        for n_, op in re.findall(r"(\d+)([MIDN])", cg):
            if op == "N":
                got_in.append((pos, pos + int(n_)))
            if op in "MDN":
                pos += int(n_)
        n_exact += got_in == introns
    assert n_exact >= len(truth) - 1


def test_cli_splice_matches_jax(monkeypatch, tmp_path):
    """cli.main --batch -x splice without -c (PAF) and with -a (SAM)."""
    genome, reads, _ = _sim_genes(5)
    refpath, rdpath = tmp_path / "ref.fa", tmp_path / "reads.fa"
    refpath.write_text(f">chrS\n{genome.decode()}\n")
    rdpath.write_text("".join(f">rd{i}\n{s.decode()}\n"
                              for i, s in enumerate(reads)))
    monkeypatch.setattr(jax_driver, "map_fragment",
                        lambda *a: pytest.fail("host path reached"))
    for opts in (["-x", "splice"], ["-a", "-x", "splice"]):
        outs = []
        for mod, cli, kw in ((jax_engine, jax_cli, {}),
                             (engine, port_cli, {"device": "cpu"})):
            monkeypatch.setattr(mod, "run_batched_cli", functools.partial(
                mod.run_batched_cli, batch_reads=4, L=512))
            monkeypatch.setattr(mod, "run_batched_align_cli",
                                functools.partial(mod.run_batched_align_cli,
                                                  batch_reads=4, L=512,
                                                  align_kw=KW_SIM))
            out = tmp_path / "out"      # the same path: the @PG line has it
            assert cli.main(["--batch", *opts, "-o", str(out), str(refpath),
                             str(rdpath)], **kw) == 0
            outs.append(out.read_text())
        assert outs[0] == outs[1]
        body = [ln for ln in outs[1].splitlines() if not ln.startswith("@")]
        assert len(body) >= len(reads)


def test_exts2_job_order():
    """Blocks take jobs longest first (qlen + tlen, ties in job order), and
    the wrapper puts each job's p and ez back in its own row."""
    QP, TP, W, RB, G = 96, 320, 128, 32, 4
    lens_l = LENS + [(60, 150), (1, 1)]         # ties with #1 and #6
    qr, sf, lens = _spliced_pairs(21, lens_l, QP, TP)
    order = exts.job_order(torch.from_numpy(lens))
    assert order.dtype == torch.int32
    o = order.numpy()
    assert sorted(o.tolist()) == list(range(len(lens_l)))
    tot = lens[o, 0].astype(np.int64) + lens[o, 1]
    assert (np.diff(tot) <= 0).all()
    ties = tot[1:] == tot[:-1]
    assert (o[1:][ties] > o[:-1][ties]).all() and ties.sum() >= 2
    assert (o != np.arange(len(o))).any()
    dn, ac = exts.splice_site_arrays(sf, lens[:, 1], True, NONCAN, True,
                                     False)
    args = [torch.from_numpy(x) for x in (qr, sf, dn, ac, lens)]
    p, ez = exts.exts2_batch(*args, G=G, W=W, RB=RB, R=QP + TP, QP=QP, TP=TP,
                             q=Q, e=E, q2=Q2, zdrop=-1, right_mode=False,
                             approx_max=True, approx_drop=False, sc_mch=1,
                             sc_mis=-2, sc_N=-1)
    RT = p.shape[1]
    pp, ezp = exts.exts2_batch_plain(*args, W=W, RT=RT, QP=QP, q=Q, e=E,
                                     q2=Q2, sc_mch=1, sc_mis=-2, sc_N=-1)
    assert torch.equal(p, pp)
    assert torch.equal(ez, exts._ez_dead(ezp, args[4], G, RB, RT))


@pytest.mark.parametrize("sub,sam", [(8, False), (16, True)],
                         ids=["sub8-paf", "sub16-sam"])
def test_splice_batcher_packing_matches_jax(monkeypatch, tmp_path, sub, sam):
    """More jobs than one launch: each launch holds both strand rounds of
    up to sub jobs (FOR rows, then the same jobs' REV rows), padded to a
    multiple of G = 8 with (1, 1) jobs, the last one too; the output is
    byte-identical to the JAX package's."""
    genome, reads, _ = _sim_genes(9, n_genes=20)
    launches = []
    exts2_batch = align_batch.exts2_batch

    def recording(qr, sf, dn, ac, lens, **kw):
        launches.append([x.clone() for x in (qr, sf, dn, ac, lens)])
        return exts2_batch(qr, sf, dn, ac, lens, **kw)
    monkeypatch.setattr(align_batch, "exts2_batch", recording)
    flag = jax_config.MM_F_CIGAR | (jax_config.MM_F_OUT_SAM if sam
                                    else jax_config.MM_F_OUT_CG)
    want, got = _run_both_splice(
        monkeypatch, tmp_path, ["chrS"], [genome], reads, flag,
        dict(KW_SIM, sub=sub), batch_reads=len(reads))
    assert got == want
    assert len([ln for ln in got.splitlines() if not ln.startswith("@")]) \
        >= len(reads)
    o = port_config.MapOptions()
    port_config.set_opt("splice", port_config.IndexOptions(), o)
    n_jobs, sizes = 0, []
    for qr, sf, dn, ac, lens in launches:
        npad = qr.shape[0] // 2
        sizes.append(npad)
        assert npad % 8 == 0 and qr.shape[0] == 2 * npad
        for x in (qr, sf, lens):
            assert torch.equal(x[:npad], x[npad:])
        real = int((lens[:npad] != 1).any(1).sum())
        assert (lens[real:npad] == 1).all()
        assert npad == -(-real // 8) * 8 and real <= sub
        n_jobs += real
        planes = [exts.splice_site_arrays(sf[:npad].numpy(),
                                          lens[:npad, 1].numpy(), ff,
                                          o.noncan, True, False)
                  for ff in (True, False)]
        assert np.array_equal(dn.numpy(), np.concatenate(
            [planes[0][0], planes[1][0]]))
        assert np.array_equal(ac.numpy(), np.concatenate(
            [planes[0][1], planes[1][1]]))
    assert len(launches) == -(-n_jobs // sub) >= 2
    assert sizes[:-1] == [sub] * (len(sizes) - 1)
    assert n_jobs % sub           # a partial last launch, padded to G only


_EMU_RUNNER = r"""
// the launch on the route plan_of picks when an instantiation takes at
// most tmax threads (the slab route at least 32) and a block at most smax
// bytes of shared memory
extern "C" int emu_exts2_route(const void* qr, const void* sf, const void* dn,
                               const void* ac, const void* lens,
                               const void* order, void* p, void* ez, int N,
                               int QP, int TP, int W, int RT, int q, int e,
                               int q2, int long_thres, int long_diff,
                               int sc_mch, int sc_mis, int sc_N,
                               int with_cigar, int exact, int right,
                               int adrop, int zdrop, int tmax, int smax) {
  const int tm[3] = {tmax, tmax, tmax > 32 ? tmax : 32};
  const Plan pl = plan_of(exact, W, QP, TP, tm, (size_t)smax);
  std::vector<uint32_t> rows(pl.scratch / 4 * N);
  const Exts2Args a = {(const uint8_t*)qr, (const uint8_t*)sf,
                       (const int8_t*)dn, (const int8_t*)ac, (const int*)lens,
                       (const int*)order, (uint8_t*)p, (int*)ez, rows.data(),
                       QP, TP, W, RT, q, e, q2, long_thres, long_diff, sc_mch,
                       sc_mis, sc_N, with_cigar, zdrop};
  const Exts2Fn fn = exts2_variant(exact, right, adrop, pl.route);
  emu_launch(N, pl.threads, [=] { fn(a); });
  return pl.route;
}

extern "C" int emu_exts2(const void* qr, const void* sf, const void* dn,
                         const void* ac, const void* lens, const void* order,
                         void* p, void* ez, int N, int QP, int TP, int W,
                         int RT, int q, int e, int q2, int long_thres,
                         int long_diff, int sc_mch, int sc_mis, int sc_N,
                         int with_cigar, int exact, int right, int adrop,
                         int zdrop) {
  return emu_exts2_route(qr, sf, dn, ac, lens, order, p, ez, N, QP, TP, W, RT,
                         q, e, q2, long_thres, long_diff, sc_mch, sc_mis,
                         sc_N, with_cigar, exact, right, adrop, zdrop, 1024,
                         232448);
}
"""


@pytest.fixture(scope="module")
def exts2_host(tmp_path_factory):
    """The device half of csrc/exts2.cu (everything before its host entry
    points) on the host shim, as a ctypes function."""
    lib = build_on_host("exts2", _EMU_RUNNER,
                        tmp_path_factory.mktemp("exts2_host"))
    fn, fn.route = lib.emu_exts2, lib.emu_exts2_route
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 18
    fn.route.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 20
    fn.restype = fn.route.restype = ctypes.c_int
    return fn


def _random_cases(seed, n):
    """n random (QP, TP, lens, q, e, q2, sc_mch, sc_mis, sc_N, flag_for,
    cmplx) cases: every query / target length, window steps, N codes."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        QP = int(rng.choice([32, 48, 96, 112, 224]))
        TP = int(rng.choice([64, 100, 200, 333, 512]))
        lens = [(int(rng.integers(1, QP + 1)), int(rng.integers(1, TP + 1)))
                for _ in range(int(rng.integers(1, 9)))]
        q, e = int(rng.integers(1, 5)), int(rng.integers(1, 3))
        out.append((QP, TP, lens, q, e, int(rng.integers(q + 2, 40)),
                    int(rng.integers(1, 3)), -int(rng.integers(1, 5)),
                    -int(rng.integers(0, 3)), bool(rng.integers(2)),
                    bool(rng.integers(2))))
    return out


@pytest.mark.parametrize("case", [
    (96, 320, LENS, Q, E, Q2, 1, -2, -1, True, True),
    (64, 512, [(64, 500), (60, 512), (17, 300), (64, 64), (33, 100),
               (5, 400), (64, 200), (2, 3)], Q, E, Q2, 1, -2, -1, False,
     False),
    (224, 384, [(224, 384), (200, 380), (224, 100), (150, 150), (223, 384),
                (1, 300), (224, 1)], Q, E, Q2, 1, -2, -2, True, True),
    *_random_cases(1, 12)], ids=lambda c: f"QP{c[0]}-TP{c[1]}-n{len(c[2])}")
def test_exts2_cuda_source_on_host_matches_plain(exts2_host, case):
    QP, TP, lens_l, q, e, q2, mch, mis, sc_n, flag_for, cmplx = case
    W = (QP + 32 + 127) // 128 * 128
    RT = (QP + TP + 31) // 32 * 32
    qr, sf, lens = _spliced_pairs(len(lens_l) + QP + TP, lens_l, QP, TP)
    dn, ac = exts.splice_site_arrays(sf, lens[:, 1], flag_for, NONCAN, cmplx,
                                     False)
    order = exts.job_order(torch.from_numpy(lens)).numpy()
    N = len(lens_l)
    p = np.zeros((N, RT, W), np.uint8)        # zeroed, as the wrapper does
    ez = np.zeros((N, exts.EZ_N), np.int32)
    ins = [np.ascontiguousarray(x) for x in (qr, sf, dn, ac, lens, order)]
    assert exts2_host(*[x.ctypes.data for x in ins], p.ctypes.data,
                      ez.ctypes.data, N, QP, TP, W, RT, q, e, q2,
                      *exts.long_thres_of(q, e, q2), mch, mis, sc_n, 1, 0, 0,
                      0, -1) == 0
    pp, ezp = exts.exts2_batch_plain(
        *(torch.from_numpy(x) for x in (qr, sf, dn, ac, lens)), W=W, RT=RT,
        QP=QP, q=q, e=e, q2=q2, sc_mch=mch, sc_mis=mis, sc_N=sc_n)
    np.testing.assert_array_equal(ez, ezp.numpy())
    np.testing.assert_array_equal(p, pp.numpy())


@pytest.mark.parametrize("mode", MODES, ids=_mode_id)
def test_exts2_modes_cuda_source_on_host_matches_plain(exts2_host, mode):
    """Each mode's instantiation of csrc/exts2.cu on the host shim against
    the plain version: p and ez bit-equal on the z-drop pairs (window
    steps, a chunk of wrapped slots a step) and, in the exact modes, on
    the reverse-strand sites of the case with the longest query."""
    am, rm, wc, zd, ad = mode
    cases = [(192, 256, zdrop_spliced_pairs())]
    if not am:
        lens_l = [(224, 384), (200, 380), (224, 100), (150, 150), (1, 300)]
        qr, sf, lens = _spliced_pairs(9, lens_l, 224, 384)
        qr[0, :124] = np.random.default_rng(6).integers(0, 4, 124)
        dn, ac = exts.splice_site_arrays(sf, lens[:, 1], False, NONCAN,
                                         False, False)
        cases.append((224, 384, (qr, sf, dn, ac, lens)))
    for QP, TP, planes in cases:
        W = (QP + 32 + 127) // 128 * 128
        RT = (QP + TP + 31) // 32 * 32
        lens = planes[4]
        N = lens.shape[0]
        order = exts.job_order(torch.from_numpy(lens)).numpy()
        p = np.zeros((N, RT, W) if wc else (1,), np.uint8)
        ez = np.zeros((N, exts.EZ_N), np.int32)
        ins = [np.ascontiguousarray(x) for x in (*planes, order)]
        assert exts2_host(*[x.ctypes.data for x in ins], p.ctypes.data,
                          ez.ctypes.data, N, QP, TP, W, RT, Q, E, Q2,
                          *exts.long_thres_of(Q, E, Q2), 1, -2, -1, int(wc),
                          int(not am), int(rm), int(ad), zd) == 0
        pp, ezp = exts.exts2_batch_plain(
            *(torch.from_numpy(x) for x in planes), W=W, RT=RT, QP=QP, q=Q,
            e=E, q2=Q2, sc_mch=1, sc_mis=-2, sc_N=-1, with_cigar=wc,
            approx_max=am, approx_drop=ad, right_mode=rm, zdrop=zd)
        np.testing.assert_array_equal(ez, ezp.numpy())
        if wc:
            np.testing.assert_array_equal(p, pp.numpy())
        else:
            assert pp is None and p[0] == 0


# every instantiation of the modes on the two routes past one block:
# (approx_max, right_mode, approx_drop, with_cigar)
ROUTE_MODES = [(True, False, False, True), (True, True, False, True),
               (True, False, True, True), (True, True, True, False),
               (False, False, False, True), (False, True, False, True)]


@pytest.mark.parametrize("route", ["gp", "slab"])
@pytest.mark.parametrize("mode", ROUTE_MODES,
                         ids=lambda m: _mode_id((m[0], m[1], m[3],
                                                 60 if not m[0] or m[2]
                                                 else -1, m[2])))
def test_exts2_routes_cuda_source_on_host_matches_plain(exts2_host, mode,
                                                        route):
    """Each mode's instantiation on the route past one block's shared
    memory (the target, donor, acceptor and query read from device
    memory: a block holds the edge words and scalars and 64 bytes more
    here) and on the slab route (a block of 32 threads takes the 64 groups
    of 16 lanes of W 1024 in turn, its rows in device memory), against the
    plain version: p and ez bit-equal on the z-drop pairs and on the
    reverse-strand sites of the case with the longest query."""
    am, rm, ad, wc = mode
    zd = 60 if not am or ad else -1
    lens_l = [(224, 384), (200, 380), (224, 100), (150, 150), (1, 300)]
    qr, sf, lens = _spliced_pairs(9, lens_l, 224, 384)
    qr[0, :124] = np.random.default_rng(6).integers(0, 4, 124)
    dn, ac = exts.splice_site_arrays(sf, lens[:, 1], False, NONCAN, False,
                                     False)
    for QP, TP, W, planes in ((192, 256, 256, zdrop_spliced_pairs()),
                              (224, 384, 1024, (qr, sf, dn, ac, lens))):
        RT = (QP + TP + 31) // 32 * 32
        lens_ = planes[4]
        N = lens_.shape[0]
        rows = 2 * (W // 16) * 4 * (1 if am else 2) + 64 + (0 if am else 512)
        tmax, smax = (1024, rows + 64) if route == "gp" else (0, 232448)
        order = exts.job_order(torch.from_numpy(lens_)).numpy()
        p = np.zeros((N, RT, W) if wc else (1,), np.uint8)
        ez = np.zeros((N, exts.EZ_N), np.int32)
        ins = [np.ascontiguousarray(x) for x in (*planes, order)]
        assert exts2_host.route(
            *[x.ctypes.data for x in ins], p.ctypes.data, ez.ctypes.data, N,
            QP, TP, W, RT, Q, E, Q2, *exts.long_thres_of(Q, E, Q2), 1, -2,
            -1, int(wc), int(not am), int(rm), int(ad), zd, tmax,
            smax) == (1 if route == "gp" else 2)
        pp, ezp = exts.exts2_batch_plain(
            *(torch.from_numpy(x) for x in planes), W=W, RT=RT, QP=QP, q=Q,
            e=E, q2=Q2, sc_mch=1, sc_mis=-2, sc_N=-1, with_cigar=wc,
            approx_max=am, approx_drop=ad, right_mode=rm, zdrop=zd)
        np.testing.assert_array_equal(ez, ezp.numpy())
        if wc:
            np.testing.assert_array_equal(p, pp.numpy())
        else:
            assert pp is None and p[0] == 0
