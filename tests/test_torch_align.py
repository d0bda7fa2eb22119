"""The port's --batch -c/-a path vs the JAX package (tolerance 0):

(a) the host scans (Kadane trim, z-drop scan, update_extra) against
    minimap2_tpu.native on random CIGARs;
(b) topk_chains(with_sec) and chain_waypoints planes;
(c) split_extent, build_reg and batch_build_regs: segments, regs and the
    fallback list;
(d) run_batched_align_cli end to end: byte-identical SAM and -c PAF, the
    fallback reads' host-path records included, and the same reads
    reported as fallbacks (the JAX package's host path records their
    names and maps them), at test_align_batch.py's KW shapes and at a
    wider query capacity where the short reads align on the device; the
    same without any patch on the JAX package; the SV deletion of
    test_longjoin.py through waypoints;
(e) cli.main -a / -c: the SAM header and the routing.
The JAX Pallas kernels run in interpret mode (AlignBatcher picks it off the
TPU); the port runs its plain versions on the CPU.
"""
import dataclasses
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
import minimap2_tpu.native as jax_native
import minimap2_tpu.parallel.engine as jax_engine
from minimap2_tpu import config as jax_config
from minimap2_tpu.index.index import MiniIndex as JaxMiniIndex
from minimap2_tpu.map.align_engine import gen_ts_mat as jax_gen_ts_mat
from minimap2_tpu.parallel import align_batch as jax_ab
from minimap2_tpu.parallel import batch as jax_batch
import minimap2_tpu_torch.cli as port_cli
from minimap2_tpu_torch import config as port_config
from minimap2_tpu_torch import native
from minimap2_tpu_torch.index.index import MiniIndex
from minimap2_tpu_torch.io.fastx import SeqRecord
from minimap2_tpu_torch.map.align_engine import gen_ts_mat
from minimap2_tpu_torch.parallel import align_batch, batch, engine

jax.config.update("jax_platforms", "cpu")

ACGT = np.frombuffer(b"ACGT", np.uint8)
KW = {"QP": 256, "TP": 768, "W": 256, "sub": 4}        # test_align_batch.py
KW_WIDE = {"QP": 768, "TP": 1280, "W": 256, "sub": 4}  # no capacity cuts
# more jobs a batch than a launch takes; the port pads the last launch to a
# multiple of G, the JAX package to sub
KW_MULTI = {"QP": 768, "TP": 1280, "W": 256, "sub": 32, "G": 8}


def _random_alignment(rng, n_ops):
    """A random M/I/D cigar and query/target codes consistent with it
    (4% N codes, 8% mismatches, a junk stretch in some M runs)."""
    cig, q, t = [], [], []
    for i in range(n_ops):
        op = 0 if i % 2 == 0 else int(rng.integers(1, 3))
        ln = int(rng.integers(1, 60 if op == 0 else 12))
        cig.append(ln << 4 | op)
        if op == 0:
            seg = rng.integers(0, 4, ln)
            tseg = np.where(rng.random(ln) < 0.08, rng.integers(0, 4, ln), seg)
            if rng.random() < 0.2:
                tseg = rng.integers(0, 4, ln)
            q.append(seg)
            t.append(tseg)
        elif op == 1:
            q.append(rng.integers(0, 4, ln))
        else:
            t.append(rng.integers(0, 4, ln))
    q, t = np.concatenate(q).astype(np.uint8), np.concatenate(t).astype(np.uint8)
    q[rng.random(len(q)) < 0.04] = 4
    t[rng.random(len(t)) < 0.04] = 4
    return cig, q, t


@pytest.mark.parametrize("seed", range(4))
def test_host_scans_match_jax(seed):
    rng = np.random.default_rng(seed)
    mat = gen_ts_mat(5, 2, 4, 4, 1)
    for _ in range(25):
        cig, q, t = _random_alignment(rng, int(rng.integers(1, 30)))
        for eb in (0, 10):
            args = (q, t, cig, mat, 5, 4, 2, 24, 1)
            assert native.cigar_kadane_trim(*args, end_bonus=eb) == \
                jax_native.cigar_kadane_trim(*args, end_bonus=eb)
        assert native.zdrop_scan(q, t, cig, mat, 5, 4, 2) == \
            jax_native.zdrop_scan(q, t, cig, mat, 5, 4, 2)
        for log_gap in (True, False):
            assert native.update_extra_scan(q, t, cig, mat, 5, 4, 2,
                                            log_gap) == \
                jax_native.update_extra_scan(q, t, cig, mat, 5, 4, 2, log_gap)


def _chain_planes(seed, B=6, A=192):
    """Anchor planes of a few overlapping chains per read: (f, qs_a, rs_a,
    rev, rid, rpos, qpos, av) as int32 / bool numpy arrays, with tied
    scores."""
    rng = np.random.default_rng(seed)
    qpos = np.sort(rng.integers(0, 3000, (B, A)), axis=1).astype(np.int32)
    rpos = (qpos + rng.integers(0, 40, (B, A)) * 25).astype(np.int32)
    chain = rng.integers(0, 7, (B, A))
    first = np.zeros((B, A), np.int64)
    for b in range(B):
        for c in range(7):
            idx = np.flatnonzero(chain[b] == c)
            first[b, idx] = idx[0] if len(idx) else 0
    rows = np.arange(B)[:, None]
    qs_a = (qpos[rows, first] - 14).astype(np.int32)
    rs_a = (rpos[rows, first] - 14).astype(np.int32)
    rev = (chain % 2).astype(np.int32)
    rid = (chain // 4).astype(np.int32)
    f = (rng.integers(0, 30, (B, A)) * 10).astype(np.int32)
    av = rng.random((B, A)) < 0.9
    return f, qs_a, rs_a, rev, rid, rpos, qpos, av


@pytest.mark.parametrize("seed", range(3))
def test_topk_with_sec_and_waypoints_match_jax(seed):
    planes = _chain_planes(seed)
    K, min_sc = 3, 40
    want = jax_batch.topk_chains(*map(jnp.asarray, planes), K, min_sc,
                                 with_sec=True)
    got = batch.topk_chains(*map(torch.from_numpy, planes), K, min_sc,
                            with_sec=True)
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].shape == (2 * K, planes[0].shape[0])
    f, qs_a, rs_a, rev, rid, rpos, qpos, av = planes
    rec0 = [got[i][0].numpy() for i in (2, 4, 6, 7)]
    for WP in (8, 64):
        wq, wr = jax_batch.chain_waypoints(
            *map(jnp.asarray, (qs_a, rs_a, rev, rid, rpos, qpos, av)),
            tuple(map(jnp.asarray, rec0)), WP)
        pq, pr = batch.chain_waypoints(
            *map(torch.from_numpy, (qs_a, rs_a, rev, rid, rpos, qpos, av)),
            tuple(map(torch.from_numpy, rec0)), WP)
        np.testing.assert_array_equal(pq.numpy(), np.asarray(wq))
        np.testing.assert_array_equal(pr.numpy(), np.asarray(wr))
        assert (pq.numpy() >= 0).sum() > 0


def test_split_extent_matches_jax():
    rng = np.random.default_rng(5)
    n_cut = 0
    for _ in range(200):
        qs, rs = (int(x) for x in rng.integers(0, 500, 2))
        n = int(rng.integers(2, 64))
        qv = np.sort(rng.integers(qs, qs + 6000, n))
        jumps = np.cumsum(np.where(rng.random(n) < 0.1,
                                   rng.integers(-900, 900, n), 0))
        rv = qv - qs + rs + jumps + rng.integers(-20, 20, n)
        wq = np.where(rng.random(n) < 0.2, -1, qv)
        qe, re_ = qs + 6100, rs + 6100 + int(jumps[-1])
        args = (qs, qe, rs, re_, wq, rv, 120, 2560, 3072)
        segs, joints = align_batch.split_extent(*args)
        assert (segs, joints) == jax_ab.split_extent(*args)
        n_cut += len(joints)
    assert n_cut > 50


def _worlds():
    rng = np.random.default_rng(3)
    ref = rng.choice(ACGT, 4000).tobytes()
    rng2 = np.random.default_rng(11)
    dup = bytearray(rng2.choice(ACGT, 4000).tobytes())
    dup[3000:3220] = dup[1000:1220]          # duplicated segment
    return ref, bytes(dup)


def _indexes(names, seqs, flag, **mo_kw):
    """The same index and options in both packages."""
    jmi = JaxMiniIndex.build(names, seqs, w=10, k=15)
    pmi = MiniIndex.build(names, seqs, w=10, k=15)
    opts = []
    for cfg, mi in ((jax_config, jmi), (port_config, pmi)):
        mo = cfg.MapOptions()
        mo.flag |= flag
        for k, v in mo_kw.items():
            setattr(mo, k, v)
        cfg.mapopt_update(mo, mi)
        opts.append(mo)
    return jmi, pmi, opts[0], opts[1]


def test_build_reg_and_batch_build_regs_match_jax():
    ref, _ = _worlds()
    jmi, pmi, jmo, pmo = _indexes(["chrT"], [ref], jax_config.MM_F_CIGAR
                                  | jax_config.MM_F_OUT_CG)
    # build_reg on random cigars over the reference
    rng = np.random.default_rng(7)
    jmat = jax_gen_ts_mat(5, jmo.a, jmo.b, jmo.transition, jmo.sc_ambi)
    mat = gen_ts_mat(5, pmo.a, pmo.b, pmo.transition, pmo.sc_ambi)
    for i in range(30):
        cig, q, t = _random_alignment(rng, int(rng.integers(1, 25)))
        rs = int(rng.integers(0, 4000 - len(t)))
        qlen = len(q) + int(rng.integers(0, 50))
        rec = {"sc": int(rng.integers(40, 400)), "sub": int(rng.integers(0, 60)),
               "cnt": int(rng.integers(3, 40)), "rev": i % 2, "rid": 0,
               "qs": 3, "qe": 3 + len(q), "rs": rs, "re": rs + len(t)}
        regs = [mod.build_reg(mi, mo, mt, qlen, q, rec, cig, 5, reg_id=i % 3,
                              parent=0)
                for mod, mi, mo, mt in ((jax_ab, jmi, jmo, jmat),
                                        (align_batch, pmi, pmo, mat))]
        assert dataclasses.asdict(regs[0]) == dataclasses.asdict(regs[1])
    # batch_build_regs on the port's mapping records of four reads: an
    # SNP/deletion read, a reverse-complement read, a read longer than QP
    # (oversize) and one with a junk tail
    read = bytearray(ref[1000:1220])
    read[40] = ord("A") if read[40] != ord("A") else ord("C")
    del read[120]
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    seqs = [bytes(read), ref[2000:2200].translate(comp)[::-1], ref[500:1500],
            ref[1000:1150] + rng.choice(ACGT, 80).tobytes()]
    recs = [SeqRecord(name=f"rd{i}", seq=s) for i, s in enumerate(seqs)]
    step = engine.PafStep(batch.DeviceIndex.from_host(pmi, "cpu"),
                          engine.batch_params(pmi, pmo, 256), K=3,
                          min_sc=pmo.min_chain_score, with_sec=True,
                          with_wp=True)
    stack, wp = engine.dispatch_batch(step, seqs, step.p, pad_to=4)
    for kw in (KW, KW_WIDE):
        want = jax_engine.batch_build_regs(
            recs, (stack.numpy(), wp.numpy()),
            jax_ab.AlignBatcher(jmi, jmo, **kw), jmi, jmo, jmat, True, False)
        got = engine.batch_build_regs(
            recs, (stack, wp), align_batch.AlignBatcher(
                pmi, pmo, device="cpu", **kw), pmi, pmo, mat, True)
        assert [r.name for r, _ in got[1]] == [r.name for r in want[1]]
        assert [r.name for r in got[2]] == [r.name for r in want[2]]
        assert list(got[0]) == list(want[0]) and got[0]
        for (_, gregs), (_, wregs) in zip(got[0].values(), want[0].values()):
            assert [dataclasses.asdict(r) for r in gregs] == \
                [dataclasses.asdict(r) for r in wregs]


def _run_both(monkeypatch, tmp_path, names, seqs, reads, flag, L, kw,
              batch_reads=4, **mo_kw):
    """run_batched_align_cli of both packages on the same reads; the JAX
    package's host path records the names of its reads and maps them.
    Returns (jax text, jax fallback names, port text, port result)."""
    jmi, pmi, jmo, pmo = _indexes(names, seqs, flag, **mo_kw)
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
                                     batch_reads=batch_reads, L=L,
                                     align_kw=kw)
    got = io.StringIO()
    res = engine.run_batched_align_cli(pmi, pmo, [str(fa)], got,
                                       batch_reads=batch_reads, L=L,
                                       align_kw=kw, device="cpu")
    return want.getvalue(), host, got.getvalue(), res


def _align_reads(ref, dup):
    rng = np.random.default_rng(9)
    read = bytearray(ref[1000:1220])
    read[40] = ord("A") if read[40] != ord("A") else ord("C")
    del read[120]
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    return [bytes(read),                                   # SNP + deletion
            ref[2000:2200].translate(comp)[::-1],          # reverse strand
            ref[500:1500],                                 # oversize
            ref[1000:1150] + rng.choice(ACGT, 80).tobytes(),    # junk tail
            ref[800:1100] + rng.choice(ACGT, 600).tobytes()
            + ref[1700:2000],                              # junk middle
            dup[1000:1220]]                                # secondary


def _align_flag(sam):
    """-a with the MD tag, or -c with the cs tag (io/tags.py)."""
    return jax_config.MM_F_CIGAR | (
        jax_config.MM_F_OUT_SAM | jax_config.MM_F_OUT_MD if sam
        else jax_config.MM_F_OUT_CG | jax_config.MM_F_OUT_CS)


@pytest.mark.parametrize("sam", [False, True], ids=["paf", "sam"])
@pytest.mark.parametrize("kw", [KW, KW_WIDE, KW_MULTI],
                         ids=["KW", "wide", "multi"])
def test_run_batched_align_cli_matches_jax(monkeypatch, tmp_path, sam, kw):
    ref, dup = _worlds()
    reads = _align_reads(ref, dup)
    flag = _align_flag(sam)
    rows = []               # rows of each port launch
    pack = align_batch._pack_jobs
    monkeypatch.setattr(align_batch, "_pack_jobs", lambda ab, chunk, n: (
        rows.append((len(chunk), n)) or pack(ab, chunk, n)))
    batch_reads = 4
    if kw is KW_MULTI:      # 48 reads in one batch: > 32 jobs
        reads, batch_reads = reads * 8, 48
    want, host, got, (n, fallbacks) = _run_both(
        monkeypatch, tmp_path, ["chrT", "chrD"], [ref, dup], reads, flag,
        1536, kw, batch_reads=batch_reads)
    assert got == want
    assert n == len(reads)
    assert [name for name, _ in fallbacks] == host
    assert "rd4" in host                    # junk middle
    if kw is KW_MULTI:
        assert len(rows) > 1 and rows[0] == (32, 32)
        jobs, npad = rows[-1]
        assert npad == -(-jobs // 8) * 8 < 32
    lines = [ln.split("\t") for ln in got.splitlines()]
    assert lines
    tag = "MD:Z:" if sam else "cs:Z:"
    assert all(any(x.startswith(tag) for x in t) for t in lines
               if not (sam and int(t[1]) & 4))
    if kw is not KW:        # the short reads align on the device
        assert {"rd0", "rd1", "rd3", "rd5"} <= {t[0] for t in lines}
        sec = [t for t in lines if "tp:A:S" in t]
        assert sec and all(int(t[0][2:]) % 6 == 5 for t in sec)    # rd5


def test_run_batched_align_cli_full_band_matches_jax(monkeypatch, tmp_path):
    """-a at the full band of 1000 (asm presets, -r 1000): W 1152 gives
    extd2 a band of 1000 lanes (at the default W the batcher clamps it to
    W - 48 - drift); the SAM is the JAX package's byte for byte."""
    ref, dup = _worlds()
    reads = _align_reads(ref, dup)
    kw = {"QP": 768, "TP": 1280, "W": 1152, "sub": 4}
    _, pmi, _, pmo = _indexes(["chrT", "chrD"], [ref, dup],
                              _align_flag(True), bw=1000)
    assert align_batch.AlignBatcher(pmi, pmo, device="cpu", **kw).w == 1000
    want, host, got, (n, fallbacks) = _run_both(
        monkeypatch, tmp_path, ["chrT", "chrD"], [ref, dup], reads,
        _align_flag(True), 1536, kw, bw=1000)
    assert got == want
    assert n == len(reads)
    assert [name for name, _ in fallbacks] == host
    lines = [ln.split("\t") for ln in got.splitlines()
             if not ln.startswith("@")]
    assert {"rd0", "rd1", "rd3", "rd5"} <= {t[0] for t in lines
                                            if not int(t[1]) & 4}


@pytest.mark.parametrize("sam", [False, True], ids=["paf", "sam"])
def test_run_batched_align_cli_unpatched_matches_jax(tmp_path, sam):
    """No patch on the JAX package: its whole output, host-path records of
    the oversize (rd2) and junk-middle (rd4) reads included, is the
    port's byte for byte."""
    ref, dup = _worlds()
    reads = _align_reads(ref, dup)
    flag = _align_flag(sam)
    jmi, pmi, jmo, pmo = _indexes(["chrT", "chrD"], [ref, dup], flag)
    fa = tmp_path / "reads.fa"
    fa.write_text("".join(f">rd{i}\n{s.decode()}\n"
                          for i, s in enumerate(reads)))
    want = io.StringIO()
    jax_engine.run_batched_align_cli(jmi, jmo, [str(fa)], want,
                                     batch_reads=4, L=1536, align_kw=KW)
    got = io.StringIO()
    engine.host_path.clear()
    n, fallbacks = engine.run_batched_align_cli(
        pmi, pmo, [str(fa)], got, batch_reads=4, L=1536, align_kw=KW,
        device="cpu")
    assert got.getvalue() == want.getvalue()
    assert n == len(reads)
    fb = [name for name, _ in fallbacks]
    assert "rd4" in fb
    assert engine.host_path["reads"] == len(fb)
    written = [ln.split("\t")[0] for ln in got.getvalue().splitlines()]
    assert {"rd2", "rd4"} <= set(written)


def test_sv_deletion_through_waypoints(monkeypatch, tmp_path):
    """test_longjoin.py:84's read: 2 kb + 2 kb around a 3 kb deletion
    aligns on the device as two segments joined by the deletion."""
    rng = np.random.default_rng(21)
    ref = rng.integers(0, 4, 100_000, dtype=np.uint8)
    st = 40_000
    read = np.concatenate([ref[st:st + 2000], ref[st + 5000:st + 7000]])
    m = rng.random(len(read)) < 0.02
    read[m] = (read[m] + rng.integers(1, 4, int(m.sum()),
                                      dtype=np.uint8)) % 4
    reads = [ACGT[read].tobytes()] * 4
    kw = {"QP": 4096, "TP": 4608, "sub": 8}
    want, host, got, (n, fallbacks) = _run_both(
        monkeypatch, tmp_path, ["c1"], [ACGT[ref].tobytes()], reads,
        jax_config.MM_F_CIGAR | jax_config.MM_F_OUT_CG, 4096, kw,
        batch_reads=4, bw_long=20000)
    assert got == want
    assert host == [] and fallbacks == []
    cg = got.splitlines()[0].split("cg:Z:")[1].split("\t")[0]
    dels = [int(x) for x, op in re.findall(r"(\d+)([MID])", cg) if op == "D"]
    assert max(dels) > 2700, cg


@pytest.mark.parametrize("opt", ["-a", "-c"])
def test_cli_align_route_and_sam_header(monkeypatch, tmp_path, opt):
    ref, _ = _worlds()
    refpath = tmp_path / "ref.fa"
    refpath.write_text(f">chrT\n{ref.decode()}\n")
    reads = tmp_path / "reads.fa"
    reads.write_text("".join(f">q{i}\n{ref[300 * i:300 * i + 220].decode()}\n"
                             for i in range(6)))
    outs = []
    for mod, cli, kw in ((jax_engine, jax_cli, {}),
                         (engine, port_cli, {"device": "cpu"})):
        monkeypatch.setattr(mod, "run_batched_align_cli", functools.partial(
            mod.run_batched_align_cli, batch_reads=4, L=512,
            align_kw=KW_WIDE))
        out = tmp_path / "out"       # the same path: the @PG line has it
        monkeypatch.setattr(jax_driver, "map_fragment",
                            lambda *a: pytest.fail("host path reached"))
        assert cli.main(["--batch", opt, "-o", str(out), str(refpath),
                         str(reads)], **kw) == 0
        outs.append(out.read_text())
    assert outs[0] == outs[1]
    lines = outs[1].splitlines()
    if opt == "-a":
        assert lines[0].startswith("@HD") and lines[1].startswith("@SQ")
        assert lines[2].startswith("@PG\tID:minimap2")
        assert sum(not ln.startswith("@") for ln in lines) == 6
    else:
        assert len(lines) == 6 and all("\tcg:Z:" in ln for ln in lines)
