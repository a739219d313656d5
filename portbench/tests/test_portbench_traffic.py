"""The traffic generator: seeded, within each mix's ranges, stratified."""

import math
from pathlib import Path

import pytest

from portbench import traffic

MIXES = sorted(p.stem for p in (Path(__file__).resolve().parents[1] / "traffic").glob("*.json"))


def _mix(name):
    return traffic.load_mix(Path(__file__).resolve().parents[1] / "traffic" / f"{name}.json")


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    mix = _mix(name)
    seed = 2**31 + 977
    for e in range(len(mix.engines)):
        a = traffic.ClientPool(mix, e, 32001, seed)
        b = traffic.ClientPool(mix, e, 32001, seed)
        assert [(s.prompt, s.max_new_tokens) for s in a.warmup()] == \
               [(s.prompt, s.max_new_tokens) for s in b.warmup()]
        for c in range(70):
            x, y = a.next(c % mix.engines[e].clients), b.next(c % mix.engines[e].clients)
            assert (x.prompt, x.max_new_tokens) == (y.prompt, y.max_new_tokens)
        other = traffic.ClientPool(mix, e, 32001, seed + 1)
        assert [other.next(0).prompt for _ in range(4)] != [a.next(0).prompt for _ in range(4)]


@pytest.mark.parametrize("name", MIXES)
def test_lengths_within_ranges(name):
    mix = _mix(name)
    pool = traffic.ClientPool(mix, 0, 50280, 12345)
    warm = pool.warmup()
    assert len(warm) == mix.engines[0].clients
    assert all(1 <= s.max_new_tokens <= mix.output.max for s in warm)
    for i in range(5 * mix.deck):
        s = pool.next(i % mix.engines[0].clients)
        assert mix.prompt.min <= len(s.prompt) <= mix.prompt.max
        assert mix.output.min <= s.max_new_tokens <= mix.output.max
        assert all(0 <= t < 50280 for t in s.prompt)
        assert len(s.prompt) + s.max_new_tokens < mix.max_len


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_deals_the_same_sizes_in_the_same_order(name):
    """Two seeds serve the same prompt and output lengths in the same order
    (the seed draws only the token ids), and the lengths are the deck's
    stratified quantiles, deck by deck."""
    mix = _mix(name)
    for e in range(len(mix.engines)):
        a = traffic.ClientPool(mix, e, 1000, 1)
        b = traffic.ClientPool(mix, e, 1000, 2**31 + 5)
        assert [s.max_new_tokens for s in a.warmup()] == [s.max_new_tokens for s in b.warmup()]
        a = traffic.ClientPool(mix, e, 1000, 1)
        b = traffic.ClientPool(mix, e, 1000, 2**31 + 5)
        for _ in range(3):
            da = [a.next(0) for _ in range(mix.deck)]
            db = [b.next(0) for _ in range(mix.deck)]
            assert [len(s.prompt) for s in da] == [len(s.prompt) for s in db]
            assert [s.max_new_tokens for s in da] == [s.max_new_tokens for s in db]
            assert sorted(len(s.prompt) for s in da) == mix.prompt.stratified(mix.deck)
            assert sorted(s.max_new_tokens for s in da) == mix.output.stratified(mix.deck)
            assert [s.prompt for s in da] != [s.prompt for s in db]


def test_log_uniform_quantiles():
    d = traffic.LengthDist("log_uniform", 64, 1024)
    xs = d.stratified(32)
    assert xs == sorted(xs) and xs[0] >= 64 and xs[-1] <= 1024
    # the median of log-uniform [64, 1025) is sqrt(64 * 1025)
    assert abs(d.quantile(0.5) - math.sqrt(64 * 1025)) <= 1
    u = traffic.LengthDist("uniform", 16, 64)
    assert u.stratified(49) == list(range(16, 65))


def test_bad_mixes_raise(tmp_path):
    with pytest.raises(ValueError):
        traffic.LengthDist("normal", 1, 2)
    with pytest.raises(ValueError):
        traffic.LengthDist("uniform", 5, 4)
    p = tmp_path / "x.json"
    p.write_text('{"engines": [{"name": "a", "placement": "device", "slots": 1, "clients": 1}],'
                 ' "prompt": {"dist": "uniform", "min": 1, "max": 60}, "output": '
                 '{"dist": "uniform", "min": 1, "max": 8}, "max_len": 64, "deck": 4, '
                 '"window_ns": 1e6}')
    with pytest.raises(ValueError, match="max_len"):
        traffic.load_mix(p)


def test_warmup_outputs_are_the_steady_state_residuals():
    """A slot in steady state is part way through a request: r tokens are
    left with weight P(output >= r), flat up to the shortest output and
    falling to 0 after the longest."""
    d = traffic.LengthDist("uniform", 16, 64)
    r = d.residual_stratified(4000)
    assert min(r) == 1 and max(r) == 64
    # mean residual E[L(L+1)]/(2 E[L]) for L uniform on 16..64
    ls = range(16, 65)
    want = sum(x * (x + 1) for x in ls) / (2 * sum(ls))
    assert abs(sum(r) / len(r) - want) < 0.05
    assert r.count(5) == pytest.approx(r.count(10), abs=2)  # flat below 16


def test_warmup_residuals_of_a_log_uniform_output():
    """The same for a log-uniform output, its probabilities from the CDF."""
    d = traffic.LengthDist("log_uniform", 32, 512)
    assert d.cdf(31) == 0.0 and d.cdf(512) == 1.0
    assert d.cdf(d.quantile(0.3)) >= 0.3 > d.cdf(d.quantile(0.3) - 1)
    pmf = {x: d.cdf(x) - d.cdf(x - 1) for x in range(32, 513)}
    assert sum(pmf.values()) == pytest.approx(1.0)
    want = sum(p * x * (x + 1) for x, p in pmf.items()) / (2 * sum(p * x for x, p in pmf.items()))
    r = d.residual_stratified(8000)
    assert min(r) == 1 and 480 < max(r) <= 512
    assert sum(r) / len(r) == pytest.approx(want, rel=2e-3)
    assert r.count(5) == pytest.approx(r.count(20), abs=2)  # flat below 32
