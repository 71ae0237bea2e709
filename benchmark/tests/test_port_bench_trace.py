"""The reading of a traced window (benchmark/trace.py) on made-up
intervals: the device's busy time is the union of its intervals, each
idle gap goes to the innermost host range open at its middle, and kernel
names lose their namespaces and parameter lists."""
import pytest

from benchmark import trace

MS = 1_000_000  # ns


def test_busy_time_is_the_union():
    device = [(0, 4 * MS, "a"), (2 * MS, 5 * MS, "b"), (7 * MS, 8 * MS, "a")]
    assert trace.union_s(device) == pytest.approx(6e-3)
    assert trace.kernel_seconds(device) == {"a": [pytest.approx(5e-3), 2],
                                            "b": [pytest.approx(3e-3), 1]}


def test_idle_gaps_go_to_the_innermost_host_range():
    window = (0, 10 * MS)
    device = [(1 * MS, 2 * MS, "k"), (6 * MS, 9 * MS, "k")]
    host = [(0, 10 * MS, "bench.window"), (0, 5 * MS, "train.step"),
            (3 * MS, 4 * MS, "aten::mm")]
    gaps = trace.idle_gaps(window, device, host)
    # 0-1 ms: the step; 2-6 ms, whose middle (4 ms) the mm's range
    # reaches: the mm; 9-10 ms: the window alone
    assert gaps == {"aten::mm": pytest.approx(4e-3),
                    "train.step": pytest.approx(1e-3),
                    "bench.window": pytest.approx(1e-3)}


@pytest.mark.parametrize("raw,want", [
    ("void (anonymous namespace)::mp_pair_bwd_kernel<0>(Params<0>)",
     "mp_pair_bwd_kernel<0>"),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul> >(int, "
     "at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)",
     "vectorized_elementwise_kernel<4, CUDAFunctor_add<float>, "
     "array<char*, 3ul> >"),
    ("lem_bwd_sweep", "lem_bwd_sweep"),
])
def test_short_names(raw, want):
    assert trace.short(raw) == want
