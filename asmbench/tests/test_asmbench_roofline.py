"""The byte arithmetic against hand-counted bytes, and the shares it
gives against synthetic device timelines."""

import pytest
import torch

from asmbench import trace
from asmbench.roofline import bytes as rb
from asmbench.roofline import peaks


def test_kmer_rows():
    # 46 bases: 92 bits in three 32-bit words, and a 32-bit count
    assert rb.kmer_row_bytes(46) == 3 * 4 + 4
    assert rb.kmer_row_bytes(64) == 4 * 4 + 4
    assert rb.kmer_row_bytes(16) == 4 + 4


def test_count_bytes_by_hand():
    # 1,000 reads of 152 codes and a 4-byte length; 300 rows of 46 bases
    hbm, link, ops = rb.count(1000, 152, 300, 46)
    assert link == 156_000
    assert hbm == 156_000 + 300 * 16
    assert ops == 0


def test_build_and_map_bytes_by_hand():
    hbm, link, _ = rb.build(300, 46, 5_000, 20)
    assert link == 5_000 + 20 * 40
    assert hbm == 300 * 16 + 5_000 + 800
    hbm, link, _ = rb.map_reads(1000, 152, 7_000)
    assert link == 156_000 + 8_000
    assert hbm == 156_000 + 7_000 + 8_000


def test_least_time_names_what_binds():
    t, by = peaks.least_time(3.35e12, 0.0)
    assert by == "hbm" and t == pytest.approx(1.0)
    t, by = peaks.least_time(1.0, 64e9)
    assert by == "link" and t == pytest.approx(1.0)
    t, by = peaks.least_time(0.0, 0.0, 67e12 * 2)
    assert by == "ops" and t == pytest.approx(2.0)


def _view(events, spans, least):
    walls = trace.Spans(torch.device("cpu"))
    return trace.TraceView(spans, events, walls, least)


@pytest.mark.parametrize("n_reads", [10_000, 1_548_000])
@pytest.mark.parametrize("extra", [0.0, 1e-4, 3e-3])
def test_share_stays_under_100_on_timelines_the_card_can_run(n_reads, extra):
    """A copy at the link's peak and kernels no faster than HBM's peak
    read at most 100%; idle time or slower work reads less."""
    hbm, link, _ = rb.count(n_reads, 152, n_reads * 20, 46)
    least = peaks.least_time(hbm, link)[0]
    copy = link / peaks.LINK_BYTES_PER_S
    kern = hbm / peaks.HBM_BYTES_PER_S
    ev = [("Memcpy HtoD (Pageable -> Device)", 0.0, copy),
          ("extract_kernel", copy + extra, copy + extra + kern)]
    span = [(0.0, copy + extra + kern + 1e-3)]
    v = _view(ev, {"job": span, "count": span}, [{"count": least}])
    pct = v.roofline_pct("count")
    assert 0 < pct <= 100.0 + 1e-9
    assert v.roofline_pct("build") is None
    assert v.copy_ms("HtoD") == pytest.approx(1e3 * copy)
    assert 0 <= v.idle_pct() < 100


def test_overlapping_device_work_counts_once():
    ev = [("a", 0.0, 2.0), ("b", 1.0, 3.0), ("c", 5.0, 6.0)]
    v = _view(ev, {"job": [(0.0, 10.0)], "map": [(0.0, 4.0)]},
              [{"map": 1.5}])
    assert trace.measure(v.busy()) == pytest.approx(4.0)
    assert v.roofline_pct("map") == pytest.approx(50.0)
    assert v.idle_pct() == pytest.approx(60.0)
    assert v.breakdown()["idle_gaps"] == [["job", pytest.approx(4.0)],
                                          ["job", pytest.approx(2.0)]]
    assert v.breakdown()["device_ops"][0] == ["a", pytest.approx(2.0)]


def test_a_reader_with_nothing_to_read_returns_nothing():
    v = _view([], {}, [])
    assert v.roofline_pct("count") is None
    assert v.copy_ms() is None and v.idle_pct() is None
    assert v.span_mean_ms("count") is None
