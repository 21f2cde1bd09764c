"""The end-to-end arithmetic on synthetic batch timings."""

import pytest

from benchmark.harness import stats


def _batches(lat_ms, frames=100, gap_s=0.01):
    out, t = [], 0.0
    for lat in lat_ms:
        out.append((t, t + lat / 1e3, frames))
        t += gap_s
    return out


def test_rate_is_all_frames_over_all_time():
    b = _batches([30.0] * 50, frames=1000)
    assert stats.frames_per_s(b, 10.0) == pytest.approx(5000.0)
    # uneven batches: every frame counts, over the window's length
    b = [(0.0, 0.1, 10), (0.1, 0.2, 30), (0.2, 0.9, 60)]
    assert stats.frames_per_s(b, 2.0) == pytest.approx(50.0)


def test_p95_of_all_batches():
    lat = [float(i) for i in range(1, 101)]           # 1..100 ms
    assert stats.batch_ms_p95(_batches(lat)) == pytest.approx(95.05)


def test_a_stall_moves_the_p95():
    base = [30.0] * 100
    steady = stats.batch_ms_p95(_batches(base))
    stalled = stats.batch_ms_p95(_batches(base[:-10] + [300.0] * 10))
    assert steady == pytest.approx(30.0)
    assert stalled == pytest.approx(300.0)
    # the median of chunks would hide it; the p95 of all batches does not
    assert stats.batch_ms_p95(_batches(base[:-4] + [300.0] * 4)) == \
        pytest.approx(30.0)


def test_p95_needs_two_batches():
    with pytest.raises(ValueError):
        stats.batch_ms_p95(_batches([30.0]))


@pytest.mark.parametrize("full,short,layer", [
    ("(anonymous namespace)::preprocess_rgb565_kernel(unsigned short "
     "const*, signed char*, int)", "preprocess_rgb565_kernel", "preprocess"),
    ("void (anonymous namespace)::arena_stage_kernel<false>(yf::Op const*, "
     "int, unsigned char const*, yf::Globals, int)",
     "arena_stage_kernel<false>", "net"),
    ("void (anonymous namespace)::tiled_section_kernel<false, true>("
     "yf::StripOp const*, int)", "tiled_section_kernel<false, true>", "net"),
    ("(anonymous namespace)::detect_head_kernel(signed char const*, float*, "
     "float*, bool*, int, (anonymous namespace)::HeadArgs)",
     "detect_head_kernel", "head"),
    ("void at::native::reduce_kernel<512, 1>(at::native::ReduceOp<int>)",
     "at::native::reduce_kernel<512, 1>", "torch"),
])
def test_kernel_names_map_to_layers(full, short, layer):
    """Kernel names as the card's profiler writes them."""
    from benchmark.harness import trace
    assert trace.short(full) == short
    assert trace.layer_of(full) == layer
