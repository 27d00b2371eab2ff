"""The bounded Zipfian generator against YCSB's distribution."""

import numpy as np
import pytest

from perfbench.zipf import ScrambledZipfian, Zipfian, fnv64, zeta


def test_zeta_is_the_generalized_harmonic_number():
    assert zeta(1, 0.99) == 1.0
    assert zeta(3, 0.5) == pytest.approx(1 + 2 ** -0.5 + 3 ** -0.5)


def test_same_seed_same_draws_other_seed_other_draws():
    z = Zipfian(128)
    a = z.draw(np.random.default_rng(5), 10_000)
    b = z.draw(np.random.default_rng(5), 10_000)
    c = z.draw(np.random.default_rng(6), 10_000)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


@pytest.mark.parametrize("n", [2, 128, 10_000])
def test_draws_stay_in_range(n):
    x = Zipfian(n).draw(np.random.default_rng(1), 200_000)
    assert x.min() >= 0 and x.max() <= n - 1


def test_head_probabilities_are_ycsb_s():
    # YCSB's nextLong: P(0) = 1 / zeta(n), P(1) = 0.5**theta / zeta(n)
    n, theta, draws = 128, 0.99, 400_000
    z = Zipfian(n, theta)
    x = z.draw(np.random.default_rng(7), draws)
    p0 = 1 / zeta(n, theta)
    p1 = 0.5 ** theta / zeta(n, theta)
    sd0 = (p0 * (1 - p0) / draws) ** 0.5
    sd1 = (p1 * (1 - p1) / draws) ** 0.5
    assert abs((x == 0).mean() - p0) < 5 * sd0
    assert abs((x == 1).mean() - p1) < 5 * sd1


def test_tail_follows_ycsb_s_inverse():
    # past item 1, YCSB draws n * (eta * u - eta + 1) ** alpha: the share
    # of draws at or above item i is where that inverse reaches i
    n, theta, draws = 128, 0.99, 400_000
    z = Zipfian(n, theta)
    x = z.draw(np.random.default_rng(9), draws)
    for i in (2, 8, 32, 100):
        u = (((i / n) ** (1 / z.alpha)) - 1 + z.eta) / z.eta
        u = max(u, (1 + 0.5 ** theta) / z.zetan)
        want = 1 - u
        sd = (want * (1 - want) / draws) ** 0.5
        assert abs((x >= i).mean() - want) < 5 * sd + 1e-3


def test_popularity_falls_with_rank():
    x = Zipfian(128).draw(np.random.default_rng(3), 400_000)
    counts = np.bincount(x, minlength=128)
    assert counts[0] > counts[1] > counts[4] > counts[16] > counts[100]


def test_refuses_bad_parameters():
    with pytest.raises(ValueError):
        Zipfian(0)
    with pytest.raises(ValueError):
        Zipfian(10, 1.0)


def _fnv_plain(v):
    # YCSB's Utils.fnvhash64, on Python integers
    h = 0xCBF29CE484222325
    for _ in range(8):
        h ^= v & 0xFF
        v >>= 8
        h = (h * 1099511628211) & ((1 << 64) - 1)
    return abs(h - (1 << 64) if h >= 1 << 63 else h)


def test_fnv64_is_ycsb_s_hash():
    xs = [0, 1, 2, 255, 256, 10 ** 6, 2 ** 40 + 7, 10 ** 10]
    assert fnv64(xs).tolist() == [_fnv_plain(x) for x in xs]


def test_scrambled_zipfian_hashes_ycsb_s_zipfian_onto_the_records():
    n = 1000
    z = ScrambledZipfian(n)
    assert z.gen.n == ScrambledZipfian.ITEM_COUNT + 1
    x = z.draw(np.random.default_rng(11), 200_000)
    assert x.min() >= 0 and x.max() <= n - 1
    # item 0 of the inner Zipfian lands on record fnv64(0) % n
    counts = np.bincount(x, minlength=n)
    hot = int(fnv64([0])[0] % n)
    assert counts.argmax() == hot
    assert abs(counts[hot] / x.size - 1 / ScrambledZipfian.ZETAN) < 0.005
    again = z.draw(np.random.default_rng(11), 200_000)
    assert np.array_equal(x, again)
