"""The frozen counts equal ``chip_smoke.py``'s bounds as they stood when
the benchmark was defined, at the shapes of PERF.md's kernel table."""

import pytest

from portbench.counts import diag_quadratic, logistic

# chip_smoke.bound(...)["bound_ms"] read from chip_smoke.py at the
# benchmark's definition
KERNEL_A = [((102400, 32, 16), 0.012972704477611941),
            ((409600, 32, 16), 0.051890817910447765),
            ((8192, 32, 16), 0.0010378163582089551)]
LOGISTIC = [((102400, 32, 16), 1.2083811343283581),
            ((409600, 32, 16), 4.833524537313433),
            ((8192, 32, 16), 0.09667049074626866),
            ((102400, 32, 4), 0.35973884179104476)]


@pytest.mark.parametrize("shape,ms", KERNEL_A)
def test_kernel_a_bound(shape, ms):
    assert 1e3 * diag_quadratic.transition_bound_s(*shape, {}) == \
        pytest.approx(ms, rel=1e-12)


@pytest.mark.parametrize("shape,ms", LOGISTIC)
def test_logistic_bound(shape, ms):
    assert 1e3 * logistic.transition_bound_s(
        *shape, {"num_rows": 256}) == pytest.approx(ms, rel=1e-12)
