"""The port's HPC mapping path (map-pb, -H) vs the JAX package, tolerance 0:

(a) sort1_rows_plain vs sort_pallas.sort1_rows in interpret mode, with
    0x7FFFFFFF pads;
(b) hpc_compact vs the JAX hpc_compact on homopolymer-rich reads, through
    both JAX routes (rank scatter, and sort1 in interpret mode);
(c) PafStep with hpc=True vs make_paf_step(interpret=True), record for
    record, and on the chain-kernel route (B % 128 == 0) vs make_paf_step
    (interpret=False) with every Pallas kernel in interpret mode;
(d) run_batched_cli / cli.main --batch -x map-pb / -H PAF and -c -x
    map-pb byte-identical to the JAX package's.
"""
import functools
import io

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
from minimap2_tpu.ops import chain_pallas, sketch_pallas, sort_pallas
from minimap2_tpu.parallel import batch as jb
import minimap2_tpu_torch.cli as port_cli
from minimap2_tpu_torch import config as port_config
from minimap2_tpu_torch.index.index import MiniIndex
from minimap2_tpu_torch.ops import sort as tsort
from minimap2_tpu_torch.parallel import batch as tb
from minimap2_tpu_torch.parallel import engine

jax.config.update("jax_platforms", "cpu")

ACGT = np.frombuffer(b"ACGT", np.uint8)
KW_WIDE = {"QP": 768, "TP": 1280, "W": 256, "sub": 4}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _hp_genome(seed, n=12000, runs=4):
    """A genome of stretched homopolymers (runs of 1..runs-1 bases)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 4, n, dtype=np.uint8)
    # break most equal neighbours in the base stream: runs keep their length
    base[1:][base[1:] == base[:-1]] = (base[:-1][base[1:] == base[:-1]] + 1) % 4
    return np.repeat(base, rng.integers(1, runs, n)), rng


def _hp_reads(ref, rng, n, ln, err=0.03, rc_every=2):
    reads = []
    for i in range(n):
        st = int(rng.integers(0, len(ref) - ln - 1))
        seq = ref[st:st + ln].copy()
        mut = rng.random(ln) < err
        seq[mut] = rng.integers(0, 4, int(mut.sum()))
        if i % rc_every == 1:
            seq = (3 - seq)[::-1]
        reads.append(ACGT[seq].tobytes())
    return reads


@pytest.mark.parametrize("A", [512, 2048])
def test_sort1_rows_plain_matches_pallas(A):
    rng = np.random.default_rng(A)
    B = 8
    k1 = rng.integers(0, 1 << 32, (B, A), dtype=np.uint64).astype(np.uint32)
    k1[:, ::3] = rng.integers(0, 50, (B, len(range(0, A, 3))))   # duplicates
    k1[rng.random((B, A)) < 0.3] = 0x7FFFFFFF
    k1[:, A - A // 4:] = 0x7FFFFFFF                              # the pad
    want = np.asarray(sort_pallas.sort1_rows(jnp.asarray(k1), G=8,
                                             interpret=True))
    got = tsort.sort1_rows(_t(k1))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    np.testing.assert_array_equal(
        tsort.sort1_rows_plain(_t(k1)).numpy().view(np.uint32), want)
    assert (np.diff(want.astype(np.int64), axis=1) >= 0).all()


@pytest.mark.parametrize("route", ["scatter", "sort1"])
@pytest.mark.parametrize("L", [512, 1000])
def test_hpc_compact_matches_jax(monkeypatch, route, L):
    rng = np.random.default_rng(L)
    B = 8
    codes = np.repeat(rng.integers(0, 5, (B, L)), rng.integers(1, 6, L),
                      axis=1)[:, :L].astype(np.uint8)
    codes[rng.random((B, L)) < 0.02] = 4
    lens = rng.integers(L // 3, L + 1, B).astype(np.int32)
    lens[0], lens[1] = L, 0
    orig = sort_pallas.sort1_rows
    monkeypatch.setattr(sort_pallas, "sort1_rows",
                        lambda k, G=8, interpret=False:
                        orig(k, G=G, interpret=True))
    want = jb.hpc_compact(jnp.asarray(codes), jnp.asarray(lens),
                          use_pallas=route == "sort1")
    got = tb.hpc_compact(torch.from_numpy(codes), torch.from_numpy(lens))
    for name, g, w in zip(("hcodes", "hpos", "lc"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert got[0].dtype == torch.uint8 and got[1].dtype == torch.int32
    assert int(got[2][0]) < L // 2 and int(got[2][1]) == 0


def _hpc_world(B):
    ref, rng = _hp_genome(6)
    ref = ref[:30000]
    reads = _hp_reads(ref, rng, B, 800)
    return ref, reads


def test_paf_step_hpc_matches_jax_interpret():
    """test_batch.py:234's shapes (B=8, L=1024, M=256, A=512, k19 w5)."""
    ref, reads = _hpc_world(8)
    shape = dict(k=19, w=5, L=1024, M=256, A=512, occ_cap=16,
                 chain_window=32, hpc=True)
    jmi = JaxMiniIndex.build_codes(["chrH"], [ref], w=5, k=19,
                                   flag=jax_config.MM_I_HPC)
    jstep = jax_engine.make_paf_step(jb.DeviceIndex.from_host(jmi, 1)[0],
                                     jb.BatchParams(**shape), K=3, min_sc=20,
                                     interpret=True)
    codes, lens = engine.encode_batch(reads, 1024)
    packed, nbits = engine.pack_codes(codes)
    want = np.asarray(jstep(jnp.asarray(packed), jnp.asarray(nbits),
                            jnp.asarray(lens)))
    pmi = MiniIndex.build_codes(["chrH"], [ref], w=5, k=19,
                                flag=port_config.MM_I_HPC)
    step = engine.PafStep(tb.DeviceIndex.from_host(pmi, "cpu"),
                          tb.BatchParams(**shape), K=3, min_sc=20)
    got = step(*(torch.from_numpy(x) for x in (packed, nbits, lens))).numpy()
    assert got.shape == want.shape == (10, 3, 8)
    np.testing.assert_array_equal(got, want)
    assert (want[0, 0] > 50).all()                   # every read maps


def test_paf_step_hpc_matches_jax_kernel_route(monkeypatch):
    """The on-chip dispatch: sort1 route of hpc_compact, sketch and sort3
    kernels, chain kernel (B % 128 == 0), long-join pass; the Pallas
    kernels in interpret mode."""
    ref, reads = _hpc_world(128)
    shape = dict(k=19, w=10, L=1024, M=256, A=256, occ_cap=16,
                 chain_window=64, bw=500, bw_long=20000, hpc=True)
    sk, s1, s3, ch = (sketch_pallas.sketch_batch, sort_pallas.sort1_rows,
                      sort_pallas.sort3_rows, chain_pallas.chain_batch)
    monkeypatch.setattr(sketch_pallas, "sketch_batch",
                        functools.partial(sk, interpret=True))
    monkeypatch.setattr(sort_pallas, "sort1_rows",
                        lambda k, G=8, interpret=False:
                        s1(k, G=G, interpret=True))
    monkeypatch.setattr(sort_pallas, "sort3_rows",
                        lambda a, b, c, G=8, interpret=False:
                        s3(a, b, c, G=G, interpret=True))
    monkeypatch.setattr(chain_pallas, "chain_batch",
                        functools.partial(ch, interpret=True))
    jmi = JaxMiniIndex.build_codes(["chrH"], [ref], w=10, k=19,
                                   flag=jax_config.MM_I_HPC)
    jstep = jax_engine.make_paf_step(jb.DeviceIndex.from_host(jmi, 1)[0],
                                     jb.BatchParams(**shape), K=5, min_sc=40,
                                     interpret=False)
    codes, lens = engine.encode_batch(reads, 1024)
    packed, nbits = engine.pack_codes(codes)
    want = np.asarray(jstep(jnp.asarray(packed), jnp.asarray(nbits),
                            jnp.asarray(lens)))
    pmi = MiniIndex.build_codes(["chrH"], [ref], w=10, k=19,
                                flag=port_config.MM_I_HPC)
    step = engine.PafStep(tb.DeviceIndex.from_host(pmi, "cpu"),
                          tb.BatchParams(**shape), K=5, min_sc=40)
    got = step(*(torch.from_numpy(x) for x in (packed, nbits, lens))).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want[0, 0] > 40).sum() > 100


@pytest.fixture(scope="module")
def hpc_files(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_hpc")
    ref, rng = _hp_genome(8, n=30000)
    reads = _hp_reads(ref, rng, 12, 600)
    refpath, rdpath = tmp / "ref.fa", tmp / "reads.fa"
    refpath.write_text(f">chrH\n{ACGT[ref].tobytes().decode()}\n")
    rdpath.write_text("".join(f">r{i}\n{s.decode()}\n"
                              for i, s in enumerate(reads)))
    return str(refpath), str(rdpath)


@pytest.mark.parametrize("opts", [["-x", "map-pb"], ["-H"],
                                  ["-x", "map-pb", "-c"]],
                         ids=["map-pb", "H", "map-pb-c"])
def test_cli_hpc_matches_jax(monkeypatch, hpc_files, opts):
    """cli.main --batch: the same PAF text from both packages (map-pb and
    -H PAF through run_batched_cli, -c through run_batched_align_cli; the
    JAX package's host path records the names of its reads and maps
    them)."""
    refpath, rdpath = hpc_files
    host = []
    map_fragment = jax_driver.map_fragment
    monkeypatch.setattr(jax_driver, "map_fragment",
                        lambda mi, opt, frag: host.extend(
                            r.name for r in frag) or map_fragment(mi, opt,
                                                                  frag))
    outs = []
    for mod, cli, kw in ((jax_engine, jax_cli, {}),
                         (engine, port_cli, {"device": "cpu"})):
        monkeypatch.setattr(mod, "run_batched_cli", functools.partial(
            mod.run_batched_cli, batch_reads=8, L=1024))
        monkeypatch.setattr(mod, "run_batched_align_cli", functools.partial(
            mod.run_batched_align_cli, batch_reads=8, L=1024,
            align_kw=KW_WIDE))
        buf = io.StringIO()
        monkeypatch.setattr("sys.stdout", buf)
        assert cli.main(["--batch", *opts, refpath, rdpath], **kw) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    lines = [ln.split("\t") for ln in outs[1].splitlines()]
    assert len({t[0] for t in lines}) + len(host) >= 12
    assert len(host) <= 4                  # most reads align on the device
    if "-c" in opts:
        assert all(any(x.startswith("cg:Z:") for x in t) for t in lines)


def test_run_batched_cli_hpc_matches_jax(hpc_files):
    refpath, rdpath = hpc_files
    from minimap2_tpu.io.fastx import read_fasta as jax_read_fasta
    names, seqs = jax_read_fasta(refpath)
    outs = []
    for cfg, MI, run, kw in (
            (jax_config, JaxMiniIndex, jax_engine.run_batched_cli, {}),
            (port_config, MiniIndex, engine.run_batched_cli,
             {"device": "cpu"})):
        io_, mo = cfg.IndexOptions(), cfg.MapOptions()
        cfg.set_opt("map-pb", io_, mo)
        mi = MI.build(names, seqs, w=io_.w, k=io_.k, flag=io_.flag)
        cfg.mapopt_update(mo, mi)
        out = io.StringIO()
        assert run(mi, mo, [rdpath], out, batch_reads=4, L=1024, **kw) == 12
        outs.append(out.getvalue())
    assert outs[0] == outs[1] and len(outs[0].splitlines()) >= 10


def test_batch_params_hpc():
    ref, _ = _hp_genome(6)
    mi = MiniIndex.build_codes(["chrH"], [ref[:5000]], w=10, k=19,
                               flag=port_config.MM_I_HPC)
    mo = port_config.MapOptions()
    port_config.mapopt_update(mo, mi)
    assert engine.batch_params(mi, mo, 1024).hpc
    mi2 = MiniIndex.build_codes(["chrH"], [ref[:5000]], w=10, k=19)
    assert not engine.batch_params(mi2, mo, 1024).hpc
