"""The port's index files vs the JAX package's (tolerance 0):

(a) dump_mmi writes the bytes of minimap2_tpu's dump_mmi, on MT-human and
    on a 2 Mb simulated genome with a repeat family and an N run;
(b) load_mmi gives the arrays of minimap2_tpu's load_mmi, which are those
    of the index built from the FASTA (each key's positions in y order),
    also on a file whose runs are not in y order (as the reference's);
(c) MiniIndex.save/load (.npz) round-trips, to and from the JAX package;
(d) PAF and SAM through .mmi, .npz and FASTA targets, on the host route
    (-t 1) and the --batch route, equal the JAX CLI's on the same target,
    and a target's records do not depend on its form (but for the @PG
    line, which carries the arguments).
"""
import contextlib
import functools
import io

import numpy as np
import pytest

import jax

import minimap2_tpu.cli as jax_cli
import minimap2_tpu.parallel.engine as jax_engine
from minimap2_tpu.index import mmi as jax_mmi
from minimap2_tpu.index.index import MiniIndex as JaxMiniIndex
import minimap2_tpu_torch.cli as port_cli
from minimap2_tpu_torch.index import mmi
from minimap2_tpu_torch.index.index import MiniIndex
from minimap2_tpu_torch.io.fastx import read_fasta
from minimap2_tpu_torch.parallel import engine

jax.config.update("jax_platforms", "cpu")

DATA = "tests/data"
ARRAYS = ("keys", "starts", "pos", "S")


def _sim_genome():
    """2 Mb in two contigs: random bases, 200 copies of a 3 kb repeat and a
    100 bp N run."""
    rng = np.random.default_rng(1)
    g = rng.integers(0, 4, 2_000_000).astype(np.uint8)
    fam = rng.integers(0, 4, 3000).astype(np.uint8)
    for st in rng.integers(0, 1_990_000, 200):
        g[st:st + 3000] = fam
    g[5000:5100] = 4
    return ["a", "b"], [g[:1_200_000], g[1_200_000:]]


def _same(a, b):
    assert [(s.name, s.offset, s.length, s.is_alt) for s in a.seq] == \
        [(s.name, s.offset, s.length, s.is_alt) for s in b.seq]
    assert (a.w, a.k, a.b, a.flag) == (b.w, b.k, b.b, b.flag)
    for x in ARRAYS:
        assert np.array_equal(getattr(a, x), getattr(b, x)), x


@pytest.mark.parametrize("world", ["MT-human", "sim2M"])
def test_mmi_matches_jax(tmp_path, world):
    if world == "sim2M":
        names, codes = _sim_genome()
        pmi = MiniIndex.build_codes(names, codes, w=10, k=15)
        jmi = JaxMiniIndex.build_codes(names, codes, w=10, k=15)
    else:
        names, seqs = read_fasta(f"{DATA}/MT-human.fa")
        pmi = MiniIndex.build(names, seqs, w=10, k=15)
        jmi = JaxMiniIndex.build(names, seqs, w=10, k=15)
    mmi.dump_mmi(pmi, tmp_path / "p.mmi")
    jax_mmi.dump_mmi(jmi, tmp_path / "j.mmi")
    assert (tmp_path / "p.mmi").read_bytes() == \
        (tmp_path / "j.mmi").read_bytes()
    got = mmi.load_mmi(str(tmp_path / "j.mmi"))
    _same(got, jax_mmi.load_mmi(str(tmp_path / "j.mmi")))
    _same(got, pmi)
    assert len(got.keys) > 1000
    if world == "sim2M":
        assert (np.diff(got.starts) > 1).any()
        # the reference binary writes a run in (span, y) order: a file
        # whose first multi-occurrence bucket has its p reversed loads as
        # the JAX package loads it
        buf = bytearray((tmp_path / "j.mmi").read_bytes())
        off = 24 + sum(5 + len(s.name) for s in pmi.seq)
        while True:
            n = int.from_bytes(buf[off:off + 4], "little")
            if n >= 3:
                break
            off += 4 + 8 * n
            off += 4 + 16 * int.from_bytes(buf[off:off + 4], "little")
        p = np.frombuffer(bytes(buf[off + 4:off + 4 + 8 * n]), "<u8")
        buf[off + 4:off + 4 + 8 * n] = p[::-1].tobytes()
        (tmp_path / "r.mmi").write_bytes(bytes(buf))
        _same(mmi.load_mmi(str(tmp_path / "r.mmi")),
              jax_mmi.load_mmi(str(tmp_path / "r.mmi")))


def test_npz_round_trip(tmp_path):
    names, seqs = read_fasta(f"{DATA}/MT-both.fa")
    pmi = MiniIndex.build(names, seqs, w=5, k=15)
    pmi.seq[1].is_alt = True
    pmi.save(str(tmp_path / "p.npz"))
    _same(MiniIndex.load(str(tmp_path / "p.npz")), pmi)
    _same(JaxMiniIndex.load(str(tmp_path / "p.npz")), pmi)
    jmi = JaxMiniIndex.build(names, seqs, w=5, k=15)
    jmi.save(str(tmp_path / "j.npz"))
    got = MiniIndex.load(str(tmp_path / "j.npz"))
    _same(got, jmi)
    assert got.n_alt == 0 and MiniIndex.load(str(tmp_path / "p.npz")).n_alt


def _run(cli, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), \
            contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(argv, **kw) == 0
    return buf.getvalue()


@pytest.fixture(scope="module")
def targets(tmp_path_factory):
    """t-inv.fa as FASTA, and as .mmi and .npz written by the port's -d;
    and "reads": six 400 bp reads of it with 2% substitutions, half
    reverse-complemented, short enough for the device path."""
    tmp = tmp_path_factory.mktemp("targets")
    fa = f"{DATA}/t-inv.fa"
    out = {"fa": fa}
    for ext in ("mmi", "npz"):
        out[ext] = str(tmp / f"t-inv.{ext}")
        assert port_cli.main(["-d", out[ext], fa], device="cpu") == 0
    ref = read_fasta(fa)[1][0]
    ref = ref.decode() if isinstance(ref, bytes) else ref
    rng = np.random.default_rng(4)
    comp = str.maketrans("ACGT", "TGCA")
    with open(tmp / "reads.fa", "w") as f:
        for i in range(6):
            st = int(rng.integers(0, len(ref) - 400))
            r = list(ref[st:st + 400])
            for p in np.flatnonzero(rng.random(400) < 0.02):
                r[p] = "ACGT"[("ACGT".index(r[p]) + 1) % 4]
            r = "".join(r)
            f.write(f">s{i}\n{r.translate(comp)[::-1] if i % 2 else r}\n")
    return out, str(tmp / "reads.fa")


def _body(text):
    return [ln for ln in text.splitlines() if not ln.startswith("@PG")]


@pytest.mark.parametrize("fmt", ["paf", "sam"])
def test_host_route_targets_match_jax(targets, fmt):
    opts = ["-t", "1", "-a" if fmt == "sam" else "-c"]
    outs = {}
    for ext, tgt in targets[0].items():
        argv = [*opts, tgt, f"{DATA}/q-inv.fa"]
        outs[ext] = _run(port_cli, argv, device="cpu")
        assert outs[ext] == _run(jax_cli, argv)
    assert _body(outs["mmi"]) == _body(outs["fa"]) == _body(outs["npz"])
    assert len(_body(outs["fa"])) >= 2


@pytest.mark.parametrize("ext,fmt", [("mmi", "sam"), ("npz", "paf")])
def test_batch_route_targets_match_jax(monkeypatch, tmp_path, targets, ext,
                                       fmt):
    tgts, reads = targets
    engine.host_path.clear()
    outs = []
    for mod, cli, kw in ((jax_engine, jax_cli, {}),
                         (engine, port_cli, {"device": "cpu"})):
        monkeypatch.setattr(mod, "run_batched_align_cli", functools.partial(
            mod.run_batched_align_cli, batch_reads=8, L=512,
            align_kw={"QP": 512, "TP": 1024, "W": 256, "sub": 8}))
        monkeypatch.setattr(mod, "run_batched_cli", functools.partial(
            mod.run_batched_cli, batch_reads=8, L=512))
        out = tmp_path / "out"
        assert cli.main(["--batch", *(["-a"] if fmt == "sam" else []),
                         "-o", str(out), tgts[ext], reads], **kw) == 0
        outs.append(out.read_text())
    assert outs[0] == outs[1] and engine.host_path["reads"] == 0
    assert len([ln for ln in outs[1].splitlines()
                if not ln.startswith("@")]) == 6
