"""The port's sharded mapping step vs the JAX package's (tolerance 0):

(a) key-range shards: ``DeviceIndex.from_host(mi, n_shards=n)`` for n 2
    and 3 gives every shard's leaves and aux ints equal to JAX
    ``DeviceIndex.from_host(mi, n)``, in the h2r layout, the h2 layout
    (MM2TPU_H2R=0), the krows bucket layout (MM2TPU_H2R=0 and the host
    library unavailable in both packages) and at pos_fmt 2;
(b) the n-shard .npz cache both ways between the packages, a shard-count
    mismatch rebuilt, one shard read alone; ``stack_shards`` equal to the
    JAX package's leaf for leaf, ``DeviceIndex.shard`` its inverse, and a
    JAX stacked index carried across by ``from_numpy``;
(c) the merge: ``sharded.merge_anchors`` on two shards' anchor keys
    against the JAX step's lax.sort over (key1, rpos, qpos) on the same
    planes, compared on the valid lanes and on av (the invalid lanes hold
    the sentinel's unpacking here, leftovers there); no two valid anchors
    tie on the sort keys; 3 and 5 shards merged two at a time (the route
    past one sort row's width) equal to one sort;
(d) the step: gloo CPU ranks spawned by ``ranks.spawn_ranks``
    at (n_data, n_idx) (1, 2), (2, 1) and (2, 2) on three worlds of
    __graft_entry__._build_tiny (seed 7, B 8; seed 13 skewed, B 16; seed
    7 at A 32, where reads' anchors exceed A): every field of the
    gathered output, n_mapped and the (n_data, n_idx) anchor counts equal
    JAX make_sharded_step's on the conftest's 8 virtual devices
    (interpret=True), and the port's map_batch on the first two worlds;
    on the third the reads where the step differs from map_batch are
    named (each shard caps a read's anchors at A by itself).
"""
import dataclasses
import os
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
import minimap2_tpu.native as jax_native
from minimap2_tpu.parallel import batch as jb
from minimap2_tpu_torch import native
from minimap2_tpu_torch.ops import sort as tsort
from minimap2_tpu_torch.parallel import batch, ranks, sharded

jax.config.update("jax_platforms", "cpu")

CONFIGS = [(1, 2), (2, 1), (2, 2)]
RANK_TIMEOUT = 240


def _leaves_equal(jdi, tdi):
    """Every leaf (values, dtypes, presence) and aux int equal."""
    assert tdi.aux_dict() == {a: int(v) for a, v in jdi.aux_dict().items()}
    got = tdi.to_numpy()
    for name in batch.DeviceIndex.LEAVES:
        a = getattr(jdi, name)
        assert (a is None) == (name not in got), name
        if a is not None:
            a = np.asarray(a)
            assert got[name].dtype == a.dtype, name
            np.testing.assert_array_equal(got[name], a, err_msg=name)


def _worlds():
    """The three worlds in both packages: (JAX (mi, p, codes, lens), port
    (mi, p, codes, lens)); the third is the first at A 32."""
    out = []
    for kw in (dict(B=8, seed=7), dict(B=16, seed=13, skew=True)):
        j = graft._build_tiny(**kw)
        t = ranks.build_tiny(**kw)
        np.testing.assert_array_equal(t[2], np.asarray(j[2]))
        np.testing.assert_array_equal(t[3], np.asarray(j[3]))
        out.append((j, t))
    j, t = out[0]
    out.append(((j[0], dataclasses.replace(j[1], A=32)) + j[2:],
                (t[0], dataclasses.replace(t[1], A=32)) + t[2:]))
    return out


@pytest.fixture(scope="module")
def worlds():
    return _worlds()


# ---------------------------------------------------------------------------
# (a) shards
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("layout", ["h2r", "h2", "krows", "pos_fmt2"])
def test_shards_match_jax(worlds, monkeypatch, layout, n):
    (jmi, *_), (tmi, *_) = worlds[1]
    kw = {}
    if layout in ("h2", "krows"):
        monkeypatch.setenv("MM2TPU_H2R", "0")
    if layout == "krows":
        monkeypatch.setattr(jax_native, "available", lambda: False)
        monkeypatch.setattr(native, "available", lambda: False)
    if layout == "pos_fmt2":
        kw = dict(force_pos_fmt=2)
    want = jb.DeviceIndex.from_host(jmi, n, **kw)
    got = batch.DeviceIndex.from_host(tmi, "cpu", n_shards=n, **kw)
    assert len(got) == len(want) == n
    for j, t in zip(want, got):
        _leaves_equal(j, t)
    assert batch.probe_layout(got[0]) == ("krows" if layout == "krows" else
                                          "h2" if layout == "h2" else "h2r")
    if layout == "pos_fmt2":
        assert got[0].pstrand is not None
    # one shape for every shard, positions padded to the largest shard's
    for name in batch.DeviceIndex.LEAVES:
        shapes = {None if getattr(t, name) is None
                  else tuple(getattr(t, name).shape) for t in got}
        assert len(shapes) == 1, name


# ---------------------------------------------------------------------------
# (b) the cache and stacking
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["jax_to_port", "port_to_jax", "mismatch"])
def test_sharded_cache_matches_jax(worlds, tmp_path, monkeypatch, case):
    (jmi, *_), (tmi, *_) = worlds[0]
    path = str(tmp_path / "idx.npz")
    fresh = jb.DeviceIndex.from_host(jmi, 2)
    if case == "jax_to_port":
        jb.DeviceIndex.from_host(jmi, 2, cache=path)
        monkeypatch.setattr(batch, "host_layout", None)    # a load only
        got = batch.DeviceIndex.from_host(tmi, "cpu", n_shards=2,
                                          cache=path)
        for j, t in zip(fresh, got):
            _leaves_equal(j, t)
        for i in range(2):
            _leaves_equal(fresh[i], batch.DeviceIndex._load_cache(
                path, "cpu", 2, shard=i))
    elif case == "port_to_jax":
        batch.DeviceIndex.from_host(tmi, "cpu", n_shards=2, cache=path)
        for j, t in zip(jb.DeviceIndex._load_cache(path, 2), fresh):
            assert j.aux_dict() == t.aux_dict()
            for name in batch.DeviceIndex.LEAVES:
                a, b = getattr(j, name), getattr(t, name)
                assert (a is None) == (b is None), name
                if a is not None:
                    np.testing.assert_array_equal(np.asarray(a),
                                                  np.asarray(b))
    else:
        # a 2-shard file asked for 3 shards (or 1) is rebuilt and rewritten
        batch.DeviceIndex.from_host(tmi, "cpu", n_shards=2, cache=path)
        with pytest.raises(ValueError, match="shard count"):
            batch.DeviceIndex._load_cache(path, "cpu", 3)
        with pytest.raises(ValueError, match="shard count"):
            batch.DeviceIndex._load_cache(path, "cpu")
        got = batch.DeviceIndex.from_host(tmi, "cpu", n_shards=3,
                                          cache=path)
        for j, t in zip(jb.DeviceIndex.from_host(jmi, 3), got):
            _leaves_equal(j, t)
        for j, t in zip(jb.DeviceIndex._load_cache(path, 3), got):
            _leaves_equal(j, t)


def test_stack_shards_matches_jax(worlds):
    (jmi, *_), (tmi, *_) = worlds[0]
    jst = jb.stack_shards(jb.DeviceIndex.from_host(jmi, 2))
    shards = batch.DeviceIndex.from_host(tmi, "cpu", n_shards=2)
    st = batch.stack_shards(shards)
    _leaves_equal(jst, st)
    assert st.h2r.shape[0] == 2
    for i in range(2):
        _leaves_equal(jb.DeviceIndex.from_host(jmi, 2)[i], st.shard(i))
    # a JAX stacked index carried across as NumPy leaves
    leaves = {n: None if getattr(jst, n) is None
              else np.asarray(getattr(jst, n))
              for n in batch.DeviceIndex.LEAVES}
    _leaves_equal(jst, batch.DeviceIndex.from_numpy(leaves, jst.aux_dict(),
                                                    "cpu"))
    # shards of another layout or shape do not stack
    other = batch.DeviceIndex.from_host(tmi, "cpu", n_shards=2,
                                        force_pos_fmt=2)
    with pytest.raises(ValueError, match="aux"):
        batch.stack_shards([shards[0], other[1]])
    leaves = shards[1].to_numpy()
    leaves["pos2"] = np.concatenate([leaves["pos2"],
                                     np.zeros_like(leaves["pos2"][:64])])
    bigger = batch.DeviceIndex.from_numpy(leaves, shards[1].aux_dict(),
                                          "cpu")
    with pytest.raises(ValueError, match="pos2"):
        batch.stack_shards([shards[0], bigger])


# ---------------------------------------------------------------------------
# (c) the merge
# ---------------------------------------------------------------------------


def _shard_parts(world, n):
    """Each of n shards' anchor planes for the world's reads, and their
    sort keys stacked as the step gathers them."""
    mi, p, codes, lens = world
    shards = batch.DeviceIndex.from_host(mi, "cpu", n_shards=n)
    c_t, l_t = torch.from_numpy(codes), torch.from_numpy(lens)
    hhi, hlo, z, mini = sharded.sketch_batch(c_t, l_t, p.k, p.w)
    front = batch._compact_minimizers(hhi, hlo, z, mini, p.M)
    planes = [batch._lookup_anchors(di, *front, l_t, p)[:6] for di in shards]
    return planes, [torch.stack(batch.anchor_keys(*pl)) for pl in planes]


def test_merge_matches_jax_sort(worlds):
    """Two shards' anchors of the skewed world merged by the port and by
    the JAX step's lax.sort (batch.py:1561-1571) on the same planes."""
    p = worlds[1][1][1]
    planes, parts = _shard_parts(worlds[1][1], 2)
    got = [x.numpy() for x in sharded.merge_anchors(parts, p.A)]
    cat = [np.concatenate([pl[q].numpy() for pl in planes], axis=1)
           for q in range(6)]
    rev, rid, rpos, qpos, span, av = (jnp.asarray(x.astype(np.int32))
                                      for x in cat)
    key1 = jnp.where(av.astype(bool), (rev.astype(jnp.uint32) << 30)
                     | rid.astype(jnp.uint32), jnp.uint32(0xFFFFFFFF))
    s = jax.lax.sort((key1, rpos.astype(jnp.uint32), qpos.astype(jnp.uint32),
                      rev, rid, rpos, qpos, span, av), dimension=1,
                     num_keys=3)
    want = [np.asarray(x)[:, :p.A] for x in s[3:]]
    v = want[5].astype(bool)
    np.testing.assert_array_equal(got[5], v)
    assert v.sum() > 200 and (~v).any()
    for q in range(5):
        np.testing.assert_array_equal(got[q][v], want[q][v], err_msg=str(q))
    # no two valid anchors tie on the keys, so any sort gives this order
    k = [np.asarray(x)[:, :p.A].astype(np.int64) for x in s[:3]]
    packed = (k[0] << 40) | (k[1] << 20) | k[2]
    same = (packed[:, 1:] == packed[:, :-1]) & v[:, 1:]
    assert not same.any()
    assert (cat[4][cat[5].astype(bool)] == p.k).all()      # span is k


@pytest.mark.parametrize("n", [3, 5])
def test_merge_in_groups_matches_one_sort(worlds, n):
    """More shards than one sort row takes (max_width 2A: two parts a
    row): merged in rounds of pairs, the result is the one sort's, on
    every plane and lane; parts too wide to pair (max_width A) go to one
    sort of their concatenation, with the same result."""
    p = worlds[1][1][1]
    _planes, parts = _shard_parts(worlds[1][1], n)
    one = sharded.merge_anchors(parts, p.A)
    grouped = sharded.merge_anchors(parts, p.A, max_width=2 * p.A)
    unpaired = sharded.merge_anchors(parts, p.A, max_width=p.A)
    for q, (a, b, c) in enumerate(zip(grouped, one, unpaired)):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=str(q))
        np.testing.assert_array_equal(c.numpy(), b.numpy(), err_msg=str(q))
    assert one[5].sum() > 200


def test_merge_past_one_row_matches_one_sort():
    """Two shards of A 16384 anchors (32768 lanes, past sort.MAX_WIDTH):
    the merge takes the wide route and equals one plain sort of the
    concatenated keys."""
    rng = np.random.default_rng(18)
    A, B = 16384, 2

    def part():
        av = torch.from_numpy(rng.random((B, A)) < 0.7)
        rev = torch.from_numpy(rng.integers(0, 2, (B, A), dtype=np.int32))
        rid = torch.from_numpy(rng.integers(0, 3, (B, A), dtype=np.int32))
        rpos = torch.from_numpy(rng.integers(0, 1 << 20, (B, A),
                                             dtype=np.int32))
        qpos = torch.from_numpy(rng.integers(0, 1 << 14, (B, A),
                                             dtype=np.int32))
        return batch.anchor_keys(rev, rid, rpos, qpos,
                                 torch.full_like(rpos, 15), av)
    parts = [part(), part()]
    got = sharded.merge_anchors(parts, A)
    keys = [torch.cat([p[j] for p in parts], dim=1) for j in range(3)]
    want = batch.anchors_of_keys(
        *(x[:, :A] for x in tsort.sort3_rows_plain(*keys)))
    for q, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=str(q))
    assert got[5].all()


# ---------------------------------------------------------------------------
# (d) the step
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def step_runs(worlds, tmp_path_factory):
    """Every (config, world): the port's gathered output from gloo CPU
    ranks (one spawn a config, its three worlds in turn), and JAX
    make_sharded_step's; the rank spawns run while JAX compiles."""
    tmp = str(tmp_path_factory.mktemp("sharded"))
    jobs, ports, errors = {}, {}, []
    for nd, ni in CONFIGS:
        runs = [ranks.write_run(tmp, f"w{w}", *t, ni)
                for w, (_j, t) in enumerate(worlds)]
        jobs[nd, ni] = dict(n_data=nd, n_idx=ni, device="cpu", runs=runs,
                            out=os.path.join(tmp, f"job{nd}x{ni}"))

    def spawn(cfg):
        try:
            ports[cfg] = ranks.spawn_ranks(jobs[cfg], RANK_TIMEOUT)
        except Exception as e:            # re-raised in the test thread
            errors.append(e)
    threads = [threading.Thread(target=spawn, args=(cfg,)) for cfg in jobs]
    for th in threads:
        th.start()

    def jax_run(args):
        (nd, ni), w = args
        mi, p, codes, lens = worlds[w][0]
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:nd * ni]).reshape(
            nd, ni), ("data", "idx"))
        return graft._sharded(mi, p, codes, lens, mesh, ni)
    keys = [(cfg, w) for cfg in CONFIGS for w in range(len(worlds))]
    with ThreadPoolExecutor(3) as ex:
        jax_out = dict(zip(keys, ex.map(jax_run, keys)))
    for th in threads:
        th.join()
    if errors:
        raise errors[0]
    refs = []
    for _j, (mi, p, codes, lens) in worlds:
        di = batch.DeviceIndex.from_host(mi, "cpu")
        out = batch.map_batch(di, torch.from_numpy(codes),
                              torch.from_numpy(lens), p)
        refs.append({k: v.numpy() for k, v in out.items()})
    port = {(cfg, w): ranks.load_result(jobs[cfg], w) for cfg, w in keys}
    return dict(port=port, jax=jax_out, ref=refs, reports=ports)


def _total0(world):
    """Each read's one-shard anchor count before the cap (total0 in
    _expand_anchors): the occurrences of its seeds under occ_cap."""
    mi, p, codes, lens = world
    di = batch.DeviceIndex.from_host(mi, "cpu")
    c_t, l_t = torch.from_numpy(codes), torch.from_numpy(lens)
    hhi, hlo, z, mini = sharded.sketch_batch(c_t, l_t, p.k, p.w)
    front = batch._compact_minimizers(hhi, hlo, z, mini, p.M)
    _start, cnt, _flt = batch.probe_seeds(di, front[0], front[1], front[4],
                                          p.occ_cap)
    return cnt.sum(1).numpy()


@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: f"{c[0]}x{c[1]}")
def test_sharded_step_matches_jax(worlds, step_runs, cfg):
    nd, ni = cfg
    for w, world in enumerate(worlds):
        got = step_runs["port"][cfg, w]
        out, n_mapped, n_anc = step_runs["jax"][cfg, w]
        for f in sharded.OUT_FIELDS:
            assert got[f].dtype == np.asarray(out[f]).dtype, f
            np.testing.assert_array_equal(got[f], out[f],
                                          err_msg=f"world {w} {f}")
        assert int(got["n_mapped"]) == n_mapped
        assert int(got["n_mapped"]) == int((got["chain_score"] > 0).sum())
        np.testing.assert_array_equal(got["n_anc"], n_anc)
        assert got["n_anc"].shape == (nd, ni) and got["n_anc"].min() > 0
        ref = step_runs["ref"][w]
        diff = [i for i in range(len(ref["rs"]))
                if any(got[f][i] != ref[f][i] for f in sharded.OUT_FIELDS)]
        total0 = _total0(world[1])
        A = world[1][1].A
        if w < 2:
            assert (total0 <= A).all() and diff == []
        else:
            # reads past A: the shards' own caps keep other anchors
            over = np.flatnonzero(total0 > A).tolist()
            assert over
            assert set(diff) <= set(over), (diff, over)
            print(f"world {w} at {cfg}: reads over A={A}: {over} "
                  f"(total0 {total0[over].tolist()}); differing from "
                  f"map_batch: {diff}")
    for rep in step_runs["reports"][cfg]:
        assert rep["device"] == "cpu"
