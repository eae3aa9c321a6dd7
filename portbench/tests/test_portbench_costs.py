"""The work counts give the repository's kernel-table bounds at 1000^3."""
import pytest

from costs import msc as costs


def test_kernel_table_bounds():
    assert costs.bound_s(*costs.power_chunk(1000, 1000, 1000, 6)) * 1e3 \
        == pytest.approx(1.196, abs=5e-4)
    assert costs.bound_s(*costs.abs_rowsum(1000, 1000)) * 1e3 \
        == pytest.approx(0.0299, abs=5e-5)
    assert costs.bound_s(*costs.batched_gram(1000, 1000, 1000)) * 1e3 \
        == pytest.approx(14.94, abs=5e-3)


def test_a_solve_is_its_modes():
    # 40 sweeps a mode in chunks of 6: 7 chunks of T read once, then the
    # epilogue
    mode = 7 * costs.bound_s(*costs.power_chunk(1000, 1000, 1000, 6)) \
        + costs.bound_s(*costs.abs_rowsum(1000, 1000))
    assert costs.solve_s((1000,) * 3, [40, 40, 40], 6, True) \
        == pytest.approx(3 * mode)
    gram = costs.bound_s(*costs.batched_gram(1000, 1000, 1000)) \
        + 7 * costs.bound_s(*costs.gram_chunk(1000, 1000, 6)) \
        + costs.bound_s(*costs.abs_rowsum(1000, 1000))
    assert costs.mode_s((1000,) * 3, 40, 6, False) == pytest.approx(gram)
