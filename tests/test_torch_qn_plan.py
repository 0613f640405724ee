"""``kernels/qn_apply.plan``: how ``broyden_step`` and ``qn_apply_multi``
cut their ring over CTAs, checked on the CPU.

Every plan must cover the flattened ``[0, B*D)`` axis exactly once, put its
slice boundaries on the 16-byte vector (relative to the sample where a
cluster owns it), give no CTA more than two samples, and fit its tile
buffers in shared memory with fewer tiles in flight than buffers.  At the
paths' shapes (m=8, B=4, bf16 ring) the decode shape (D = 2304) must be
resident and the prefill shape (D = 256 x 2304) streaming.
"""

import pytest

from repro_torch.kernels import qn_apply as q

D = 2304
# (op, m, B, D, itemsize, k, ctas)
PATH = [
    ("broyden", 8, 4, D, 2, 1, q.H100_CTAS),
    ("qn", 8, 4, D, 2, 1, q.H100_CTAS),
    ("broyden", 8, 4, 256 * D, 2, 1, q.H100_CTAS),
    ("qn", 8, 4, 256 * D, 2, 1, q.H100_CTAS),
]
EDGE = [
    ("broyden", 8, 5, 1030, 2, 1, 264),       # ragged D, resident
    ("qn", 30, 5, 520, 4, 4, 264),            # m=30, K=4, f32
    ("broyden", 1, 4, 4096, 2, 1, 264),       # the resident threshold
    ("broyden", 1, 4, 4097, 2, 1, 264),       # just above it
    ("broyden", 8, 5, 30003, 2, 1, 264),      # ragged D, streaming
    ("qn", 8, 3, 100008, 4, 2, 264),          # f32, K=2
    ("broyden", 30, 4, 20000, 2, 1, 264),     # m=30 streaming
    ("qn", 8, 1, 256 * D, 2, 1, 264),         # one sample
    ("broyden", 8, 300, 5000, 2, 1, 264),     # B above the CTAs
    ("broyden", 8, 264, 8192, 2, 1, 264),     # B equal to the CTAs
    ("qn", 8, 4, 256 * D, 2, 1, 7),           # few co-resident CTAs
    ("qn", 32, 4, 256 * D, 4, 4, 132),        # the largest tile
]


def _check(op, m, bsz, dim, itemsize, k, ctas):
    p = q.plan(op, m, bsz, dim, itemsize, k, ctas)
    cuts = q.slices(p, bsz, dim)
    assert len(cuts) == p.n_cta
    covered = sorted((f0, f1) for f0, f1 in cuts if f1 > f0)
    pos = 0
    for f0, f1 in covered:  # contiguous, no overlap, no gap
        assert f0 == pos
        pos = f1
    assert pos == bsz * dim
    for f0, f1 in cuts:
        base = (f0 // dim) * dim if p.cluster else 0
        assert (f0 - base) % p.vec == 0
        if f1 > f0:
            assert (f1 - 1) // dim - f0 // dim <= 1  # at most two samples
            if p.cluster:
                assert f0 // dim == (f1 - 1) // dim
    assert 1 <= p.pref < p.nbuf
    assert p.smem <= q.SMEM_BUDGET
    if p.coop:
        assert p.n_cta <= ctas and p.cluster == 0
    else:
        assert p.n_cta == bsz * p.cluster
        assert 1 <= p.cluster <= q.MAX_CLUSTER
    if p.schedule == "resident":  # each CTA holds its whole slice
        assert -(-p.slice // p.tile) <= p.nbuf
    return p


@pytest.mark.parametrize("case", PATH + EDGE, ids=lambda c: "-".join(map(
    str, c)))
def test_plan_covers_each_element_once_on_the_vector(case):
    _check(*case)


def test_plan_picks_resident_for_decode_and_streaming_for_prefill():
    schedules = [_check(*case).schedule for case in PATH]
    assert schedules == ["resident", "resident", "streaming", "streaming"]
    prefill = q.plan(*PATH[2])
    assert prefill.coop and prefill.n_cta == q.H100_CTAS
    # a streaming slice that straddles a sample boundary
    assert any(f0 // (256 * D) != (f1 - 1) // (256 * D)
               for f0, f1 in q.slices(prefill, 4, 256 * D))


def test_plan_threshold_and_many_samples():
    assert q.plan("broyden", 1, 4, 4096, 2).schedule == "resident"
    assert q.plan("broyden", 1, 4, 4097, 2).schedule == "streaming"
    p = q.plan("broyden", 8, 300, 5000, 2, 1, 264)
    assert (p.schedule, p.coop, p.n_cta, p.slice) == ("streaming", False,
                                                      300, 5000)

