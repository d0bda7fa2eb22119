"""`minimap2 -a` on single reads: engine.align_queries, the mapping step
with secondaries and waypoints, then the aligner, SAM out.  A client
streams its pool file over and over through one call."""
from __future__ import annotations

from benchmarks import reads

UNIT_READS = 1


def pool(cell, client: int, gen):
    """The client's reads: names, query files, per unit its read codes and
    their truths."""
    t = cell.traffic
    codes, truth = reads.ont(cell.parts, cell.n_big, t["pool"], gen,
                             **t.get("read_model", {}))
    names = [f"c{client}r{i}" for i in range(len(codes))]
    path = cell.tmp / f"c{client}.fa"
    reads.write_fasta(path, names, codes)
    return dict(names=names, files=[str(path)],
                reads=[(c,) for c in codes],
                truths=[[tuple(int(x) for x in row)] for row in truth])


def client(cell, pl):
    """A callable that maps and aligns the pool until the sink closes."""
    from minimap2_tpu_torch.parallel import engine
    from minimap2_tpu_torch.parallel.align_batch import AlignBatcher
    opt, mi, c = cell.opt, cell.mi, cell.config
    sec = opt.best_n > 0 and opt.pri_ratio > 0
    step = engine.PafStep(cell.di, engine.batch_params(mi, opt, c["L"]),
                          K=3 if sec else 1, min_sc=opt.min_chain_score,
                          with_sec=sec, with_wp=True)
    ab = AlignBatcher(mi, opt, device=cell.device, **c["align"])
    files = pl["files"] * 100_000

    def run(sink):
        engine.align_queries(step, ab, mi, opt, files, sink,
                             cell.traffic["batch"])
    return run
