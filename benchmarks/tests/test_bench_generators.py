"""The benchmark's generators: the same seed gives the same genome and
reads, another seed others; the read models keep their truths."""
import numpy as np
import torch

from benchmarks import genome, reads


def _genome(seed):
    return genome.make(seed, 1_200_000, 6, "cpu", n_big=4)


def test_plan_keeps_the_envelope():
    p = genome.plan(3_100_000_000, 195)
    assert len(p) == 195 and sum(1 for n, _ in p if n.startswith("chr")) == 24
    assert abs(sum(ln for _, ln in p) - 3_100_000_000) < 200_000


def test_genome_is_a_function_of_the_seed():
    (n1, a), (n2, b), (_, c) = _genome(3), _genome(3), _genome(4)
    assert n1 == n2
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))
    assert all(int(x.max()) <= 3 for x in a)


def test_reads_are_a_function_of_the_seed():
    _, parts = _genome(5)
    r1, t1 = reads.ont(parts, 4, 8, genome.generator(5, 1, "cpu"), 300, 400)
    r2, t2 = reads.ont(parts, 4, 8, genome.generator(5, 1, "cpu"), 300, 400)
    r3, _ = reads.ont(parts, 4, 8, genome.generator(6, 1, "cpu"), 300, 400)
    assert np.array_equal(t1, t2)
    assert all(np.array_equal(x, y) for x, y in zip(r1, r2))
    assert not all(len(x) == len(y) and np.array_equal(x, y)
                   for x, y in zip(r1, r3))


def test_error_free_reads_are_their_truth():
    _, parts = _genome(7)
    codes, truth = reads.ont(parts, 4, 16, genome.generator(7, 2, "cpu"),
                             300, 400, sub=0, dele=0, ins=0)
    for x, (c, st, en, minus) in zip(codes, truth):
        src = parts[c][st:en].numpy()
        want = (3 - src)[::-1] if minus else src
        assert np.array_equal(x, want)
    r1, r2, tr = reads.sr(parts, 16, genome.generator(7, 3, "cpu"), sub=0,
                          dele=0, ins=0)
    for a, b, row in zip(r1, r2, tr):
        for end, x in ((1, a), (2, b)):
            c, st, en, minus = reads.sr_end_truth(row, end)
            src = parts[c][st:en].numpy()
            assert np.array_equal(x, (3 - src)[::-1] if minus else src)
