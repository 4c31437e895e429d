"""Seed to sequences, the compared sample and the arithmetic over all
frames."""

import numpy as np
import pytest

from svobench import stats, traffic


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1, 2 ** 31 + 7, 2 ** 40 + 3,
                                  -5])
def test_sequence_seeds_repeat_and_differ(seed):
    a = traffic.sequence_seeds(seed, 8)
    assert a == traffic.sequence_seeds(seed, 8)
    assert len(set(a)) == 8
    assert a[:4] == traffic.sequence_seeds(seed, 4)
    assert a != traffic.sequence_seeds(seed + 1, 8)


def test_a_pool_is_one_set_in_a_seeded_order():
    a = traffic.sequence_seeds(2 ** 31 + 3, 8, pool=0)
    b = traffic.sequence_seeds(2 ** 40 + 9, 8, pool=0)
    assert sorted(a) == sorted(b) and len(set(a)) == 8
    assert a == traffic.sequence_seeds(2 ** 31 + 3, 8, pool=0)
    assert a != b
    assert sorted(traffic.sequence_seeds(5, 8, pool=1)) != sorted(a)


def test_compared_is_a_seeded_sample():
    picks = {tuple(traffic.compared(s, 8, 2)) for s in range(200)}
    assert all(len(p) == 2 and 0 <= p[0] < p[1] < 8 for p in picks)
    assert len(picks) > 10
    assert traffic.compared(9, 8, 2) == traffic.compared(9, 8, 2)
    assert traffic.compared(9, 3, 5) == [0, 1, 2]


def test_percentiles_over_every_frame():
    lat = list(range(1, 101))
    assert stats.percentile(lat, 50) == 50.5
    assert stats.percentile(lat, 95) == pytest.approx(95.05)
    assert np.isnan(stats.percentile([], 50))


def test_rate_and_timeline():
    assert stats.rate(300, 2.5) == 120.0
    # 100 frames over 0.5 s, then 100 over 1.5 s
    line = stats.timeline([(0.5, 100), (2.0, 100)])
    assert line == pytest.approx([100 + 100 / 3, 100 / 1.5])
    assert sum(line) == pytest.approx(200)


def test_every_traffic_file_names_its_mode():
    from pathlib import Path
    modes = {p.stem for p in (Path(traffic.TRAFFIC_DIR).parent / "modes")
             .glob("*.py")}
    for f in Path(traffic.TRAFFIC_DIR).glob("*.json"):
        tr = traffic.load(f.stem)
        assert tr["mode"] in modes
        assert set(tr["limits"]) == {"pose_gap_m"}
