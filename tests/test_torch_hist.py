"""The port's `LogHistogram` (`solvingpapers_tpu_torch/metrics/hist.py`)
against the JAX package's (`solvingpapers_tpu/metrics/hist.py`).

The same seeded samples (log-uniform latencies across the layout, values
under and over it, zeros and repeats) go into both: bucket counts, count,
min and max are equal, sums within 1e-12 relative, every quantile and
the snapshot percentiles within 1e-12, and merging shards equals one
histogram of all samples (counts exactly, the sum up to addition order).
The serving metrics' snapshot keys read the histograms.
"""

import math

import numpy as np
import pytest

from solvingpapers_tpu.metrics.hist import LogHistogram as JLogHistogram
from solvingpapers_tpu_torch.metrics import LogHistogram
from solvingpapers_tpu_torch.serve.metrics import ServeMetrics

TOL = 1e-12
QS = (0.0, 0.01, 0.1, 0.25, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0)


def _samples(seed, n=2000):
    r = np.random.default_rng(seed)
    x = 10.0 ** r.uniform(-5, 5, size=n)  # spills under and over the layout
    x[:5] = [0.0, 1e-4, 1e4, 0.5, 0.5]     # zero, both edges, a repeat
    return x


def _fill(h, xs, ns=None):
    for i, x in enumerate(xs):
        h.add(float(x), 1 if ns is None else int(ns[i]))
    return h


@pytest.mark.parametrize("layout", [dict(), dict(lo=1e-3, hi=10.0, buckets_per_decade=5)],
                         ids=["serve", "coarse"])
def test_same_samples_give_the_reference_histogram(layout):
    xs = _samples(0)
    ns = np.random.default_rng(1).integers(1, 9, size=xs.size)  # block ITL
    t = _fill(LogHistogram(**layout), xs, ns)
    j = _fill(JLogHistogram(**layout), xs, ns)
    assert t.layout == j.layout and t.n_buckets == j.n_buckets
    np.testing.assert_array_equal(t.counts, j.counts)
    assert t.count == j.count == int(ns.sum()) == len(t)
    assert t.min == j.min and t.max == j.max
    assert math.isclose(t.sum, j.sum, rel_tol=TOL)
    assert math.isclose(t.mean(), j.mean(), rel_tol=TOL)
    for q in QS:
        assert math.isclose(t.quantile(q), j.quantile(q), rel_tol=TOL, abs_tol=TOL)
    for k, v in j.percentiles((50, 90, 99, 99.9)).items():
        assert math.isclose(t.percentiles((50, 90, 99, 99.9))[k], v, rel_tol=TOL)
    assert t.bucket_bounds() == j.bucket_bounds()
    assert t.cumulative_counts() == j.cumulative_counts()


def test_merge_equals_one_histogram_of_all_samples():
    xs = _samples(2)
    shards = np.array_split(xs, 3)
    merged = LogHistogram.merge(_fill(LogHistogram(), s) for s in shards)
    whole = _fill(LogHistogram(), xs)
    jmerged = JLogHistogram.merge(_fill(JLogHistogram(), s) for s in shards)
    np.testing.assert_array_equal(merged.counts, whole.counts)
    np.testing.assert_array_equal(merged.counts, jmerged.counts)
    assert merged.count == whole.count and merged.min == whole.min
    assert merged.max == whole.max
    assert math.isclose(merged.sum, whole.sum, rel_tol=TOL)
    for q in QS:
        assert merged.quantile(q) == whole.quantile(q)
    with pytest.raises(ValueError, match="layouts"):
        merged.merge_from(LogHistogram(buckets_per_decade=8))


def test_quantile_lands_in_the_exact_samples_bucket():
    xs = _samples(3)
    h = _fill(LogHistogram(), xs)
    ordered = np.sort(xs)
    width = 10 ** (1 / h.buckets_per_decade) - 1
    for q in (0.5, 0.9, 0.99):
        exact = ordered[max(1, math.ceil(q * xs.size)) - 1]
        if h.lo <= exact < h.hi:
            assert abs(h.quantile(q) - exact) <= width * exact


def test_serve_metrics_record_into_histograms():
    m = ServeMetrics()

    class Req:
        prompt = np.zeros(5)
        submit_time = 0.0
        admit_time = 0.25

    m.record_admit(Req, 0.25)
    m.record_first_token(Req, 0.5, prefilled=3)
    m.record_tokens(4, 0.2, 0.7)
    snap = m.snapshot()
    assert len(m.ttft) == 1 and len(m.itl) == 4 and len(m.queue_wait) == 1
    assert snap["serve/tokens_prefilled"] == 3
    assert snap["serve/ttft_s_count"] == 1 and snap["serve/itl_s_count"] == 4
    assert math.isclose(snap["serve/ttft_s_mean"], 0.5)
    assert math.isclose(snap["serve/itl_s_sum"], 0.2)
    for name in ("ttft_s", "itl_s", "queue_wait_s", "prefill_s"):
        assert {f"serve/{name}_{k}" for k in ("p50", "p90", "p99")} <= snap.keys()
