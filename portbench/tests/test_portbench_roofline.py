"""The kernels' operation and byte counts against hand counts at small
shapes, and the roofline share's arithmetic."""
import pytest

from portbench import roofline


def test_k1_counts_by_hand():
    # C 2 candidates, J 3 jobs, S 4 servers, terms shared across the stack:
    # 24 cells x 6 ops + 6 rows x 14 ops; Y 24 words, G/share/compute 3 x 3
    # words, p/n_srv/tau 3 x 6 words.
    assert roofline.tau_counts(2, 3, 4, False) == (24 * 6 + 6 * 14,
                                                   8 * (24 + 9 + 18))
    # Per-candidate terms: 3 x 6 words instead of 3 x 3.
    assert roofline.tau_counts(2, 3, 4, True)[1] == 8 * (24 + 18 + 18)


def test_k3_counts_by_hand():
    # B 2 rows of N 5 GPUs on S 3 servers: log2 ceilings 3 and 2.
    ops = 2 * (8 * 5 + 2 * 5 * 3 + 3 + 2 * 3 * 2)
    words_in = 2 * 5 + 4 * 2 + 2 * 3 + 5
    words_out = 5 * 2 + 2 * 5 + 2 * 2 * 3
    assert roofline.pool_counts(2, 5, 3) == (ops, 8 * (words_in + words_out))


def test_bound_and_share():
    assert roofline.bound_s(67e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 3.35e12) == pytest.approx(1.0)
    shape = (64, 161, 20, False)
    bound = roofline.bound_s(*roofline.tau_counts(*shape))
    rec = {"shapes": {"tau": [shape] * 10},
           "kernels": {"tau_kernel<false>": (10, 10 * 4 * bound)}}
    assert roofline.share(rec, "tau") == pytest.approx(25.0)
    # The profiler saw 5 of the 10 launches: the time a launch is taken
    # over those it saw.
    rec["kernels"]["tau_kernel<false>"] = (5, 5 * 2 * bound)
    assert roofline.share(rec, "tau") == pytest.approx(50.0)
    rec["kernels"]["tau_kernel<false>"] = (0, 0.0)
    assert roofline.share(rec, "tau") is None
