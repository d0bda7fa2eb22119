"""Binary MMI index format, the reference's own (mm_idx_dump/mm_idx_load,
index.c:475-569; magic "MMI\\x02"), read into and written from the flat
MiniIndex.  Same files as minimap2_tpu.index.mmi, byte for byte, but with
numpy array operations over all keys instead of a Python loop per key, so
a 100 Mb genome's ~13 M keys load and dump in seconds.

Layout:
  magic[4]  "MMI\\x02"
  u32 x[5]  w, k, b, n_seq, flag
  per seq:  u8 name_len, name bytes, u32 len
  per bucket (2^b):
     i32 n; u64 p[n];           # y records of the bucket's multi-occurrence
                                # keys, key by key in key order
     u32 size;                  # hash entries
     size x (u64 key, u64 val)  # key = (hash>>b)<<1 | singleton;
                                # val = y (singleton) or start<<32|n into p
  packed 4-bit reference (unless MM_I_NO_SEQ), (sum_len+7)/8 u32 words

A dump writes each bucket's entries sorted by key (the reference writes
khash iteration order, which its loader does not depend on), so the
reference binary loads these files.
"""
from __future__ import annotations

import struct

import numpy as np

MM_IDX_MAGIC = b"MMI\x02"
MM_I_NO_SEQ = 0x2

_U32 = np.uint64(0xFFFFFFFF)


def _runs(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Concatenated index ranges [starts[i], starts[i] + counts[i])."""
    counts = counts.astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, np.int64)
    first = np.cumsum(counts) - counts
    return (np.repeat(starts.astype(np.int64) - first, counts)
            + np.arange(total, dtype=np.int64))


def load_mmi(path: str):
    """mm_idx_load (index.c:517-569) -> MiniIndex, with each key's
    positions in y order."""
    from .index import MiniIndex, SeqMeta
    with open(path, "rb") as fp:
        buf = fp.read()
    if buf[:4] != MM_IDX_MAGIC:
        raise ValueError(f"{path}: not an MMI file")
    w, k, b, n_seq, flag = struct.unpack_from("<5I", buf, 4)
    off = 24
    mi = MiniIndex(w, k, b, flag)
    sum_len = 0
    for _ in range(n_seq):
        nl = buf[off]
        name = buf[off + 1:off + 1 + nl].decode() if nl else ""
        (ln,) = struct.unpack_from("<I", buf, off + 1 + nl)
        off += 5 + nl
        mi.seq.append(SeqMeta(name=name, offset=sum_len, length=ln))
        sum_len += ln
    # the buckets' p and kv spans, decoded below in one pass over all
    n_bkt = 1 << b
    p_parts, kv_parts = [], []
    p_len = np.empty(n_bkt, np.int64)
    kv_len = np.empty(n_bkt, np.int64)
    for i in range(n_bkt):
        (n,) = struct.unpack_from("<i", buf, off)
        p_parts.append(np.frombuffer(buf, "<u8", n, off + 4))
        off += 4 + 8 * n
        (size,) = struct.unpack_from("<I", buf, off)
        kv_parts.append(np.frombuffer(buf, "<u8", 2 * size, off + 4))
        off += 4 + 16 * size
        p_len[i], kv_len[i] = n, size
    P = np.concatenate(p_parts)
    kv = np.concatenate(kv_parts).reshape(-1, 2)
    if len(kv):
        bucket = np.repeat(np.arange(n_bkt, dtype=np.uint64), kv_len)
        key, val = kv[:, 0], kv[:, 1]
        single = (key & np.uint64(1)) != 0
        p_base = np.cumsum(p_len) - p_len      # bucket i's p in P
        cnt = np.where(single, 1, (val & _U32).astype(np.int64))
        st = (val >> np.uint64(32)).astype(np.int64) \
            + p_base[bucket.astype(np.int64)]
        minier = ((key >> np.uint64(1)) << np.uint64(b)) | bucket
        order = np.argsort(minier)              # each key once in a file
        minier, single, cnt, st, val = (x[order] for x in
                                        (minier, single, cnt, st, val))
        starts = np.concatenate(([0], np.cumsum(cnt))).astype(np.int64)
        y = np.empty(int(starts[-1]), np.uint64)
        y[starts[:-1][single]] = val[single]
        m = ~single
        y[_runs(starts[:-1][m], cnt[m])] = P[_runs(st[m], cnt[m])]
        # the port's and the JAX package's files keep a run in y order; the
        # reference orders a run by (span, y): sort such runs by y
        down = y[1:] < y[:-1]
        down[starts[1:-1] - 1] = False          # across a run boundary
        if down.any():
            run = np.repeat(np.arange(len(cnt)), cnt)
            y = y[np.lexsort((y, run))]
        mi.keys, mi.starts, mi.pos = minier, starts, y
    if not (flag & MM_I_NO_SEQ):
        n_words = (sum_len + 7) // 8
        S4 = np.frombuffer(buf, "<u4", n_words, off)
        mi.S = unpack_seq4(S4, sum_len)
    return mi


def dump_mmi(mi, path: str) -> None:
    """mm_idx_dump (index.c:475-514) from a MiniIndex: the bytes
    minimap2_tpu.index.mmi.dump_mmi writes."""
    b = mi.b
    n_bkt = 1 << b
    out = [MM_IDX_MAGIC, struct.pack("<5I", mi.w, mi.k, b, mi.n_seq,
                                     mi.flag)]
    sum_len = 0
    for s in mi.seq:
        nb = s.name.encode()[:255]
        out += [struct.pack("<B", len(nb)), nb, struct.pack("<I", s.length)]
        sum_len += s.length
    keys = np.asarray(mi.keys, np.uint64)
    starts = np.asarray(mi.starts, np.int64)
    pos = np.asarray(mi.pos, np.uint64)
    cnts = starts[1:] - starts[:-1]
    bucket_of = (keys & np.uint64(n_bkt - 1)).astype(
        np.uint16 if b <= 16 else np.int64)     # uint16: a radix sort
    # key order within a bucket, which is also its entries' order, as
    # their key field (hash >> b) << 1 | singleton rises with the key
    order = np.argsort(bucket_of, kind="stable")
    bk, K, C, S = (bucket_of[order].astype(np.int64), keys[order],
                   cnts[order], starts[order])
    multi = C > 1
    # p: the multi keys' runs, bucket by bucket in key order
    P = pos[_runs(S[multi], C[multi])]
    n_p = np.bincount(bk[multi], weights=C[multi],
                      minlength=n_bkt).astype(np.int64)
    p_bnd = np.concatenate(([0], np.cumsum(n_p)))
    # a multi key's start in its bucket's p
    cm = np.where(multi, C, 0)
    excl = np.cumsum(cm) - cm
    start_p = excl - p_bnd[bk]
    kfield = ((K >> np.uint64(b)) << np.uint64(1)) \
        | (~multi).astype(np.uint64)
    vfield = np.where(multi, (start_p.astype(np.uint64) << np.uint64(32))
                      | C.astype(np.uint64), pos[S])
    kv = np.empty((len(K), 2), "<u8")
    kv[:, 0], kv[:, 1] = kfield, vfield
    kv_bnd = np.searchsorted(bk, np.arange(n_bkt + 1))
    P = P.astype("<u8")
    for i in range(n_bkt):
        out.append(struct.pack("<i", int(n_p[i])))
        if n_p[i]:
            out.append(P[p_bnd[i]:p_bnd[i + 1]].tobytes())
        out.append(struct.pack("<I", int(kv_bnd[i + 1] - kv_bnd[i])))
        if kv_bnd[i + 1] > kv_bnd[i]:
            out.append(kv[kv_bnd[i]:kv_bnd[i + 1]].tobytes())
    if not (mi.flag & MM_I_NO_SEQ) and mi.S is not None:
        out.append(pack_seq4(mi.S).tobytes())
    with open(path, "wb") as fp:
        fp.writelines(out)


def unpack_seq4(S4: np.ndarray, total_len: int) -> np.ndarray:
    """4-bit packed u32 words -> nt4 uint8 codes (mm_seq4_get)."""
    bytes_ = S4.view(np.uint8)
    out = np.empty(len(bytes_) * 2, np.uint8)
    out[0::2] = bytes_ & 0xF
    out[1::2] = bytes_ >> 4
    return np.minimum(out[:total_len], 4).astype(np.uint8)


def pack_seq4(codes: np.ndarray) -> np.ndarray:
    """nt4 uint8 codes -> 4-bit packed u32 words (mm_seq4_set)."""
    total = len(codes)
    padded = np.zeros((total + 7) // 8 * 8, np.uint8)
    padded[:total] = np.minimum(codes, 4)
    return (padded[0::2] | (padded[1::2] << 4)).astype(np.uint8).view("<u4")
