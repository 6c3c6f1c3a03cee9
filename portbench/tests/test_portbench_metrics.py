"""The metric readers and the trace reduction on synthetic records."""

import pytest

from portbench import readers, run, trace

MS = 1_000_000  # ns


def events():
    # host ranges: the stretch, two units, a wait inside the second
    host = [("portbench.stretch", False, 0, 100 * MS), ("portbench.unit", False, 0, 50 * MS),
            ("portbench.unit", False, 50 * MS, 100 * MS),
            ("portbench.next_batch", False, 50 * MS, 70 * MS)]
    device = [("resized_crop_tiled_kernel<ElemU8>", True, 10 * MS, 12 * MS),
              ("sm90_conv", True, 11 * MS, 40 * MS),
              ("jpeg_decode_tiled_kernel", True, 45 * MS, 48 * MS),
              ("sm90_conv", True, 75 * MS, 95 * MS), ("late", True, 99 * MS, 120 * MS)]
    return host + device


def test_busy_union_kernels_and_gaps():
    facts = trace.reduce_events(events(), (0, 100 * MS))
    assert facts["window_s"] == pytest.approx(0.1)
    # [10, 40] + [45, 48] + [75, 95] + [99, 100] (clipped to the stretch)
    assert facts["busy_s"] == pytest.approx((30 + 3 + 20 + 1) / 1e3)
    assert facts["kernels"]["sm90_conv"] == pytest.approx(0.049)
    gaps = dict((round(t * 1e3), name) for name, t in facts["idle_gaps"])
    assert gaps == {27: "portbench.next_batch", 10: "portbench.unit", 5: "portbench.unit",
                    4: "portbench.unit"}
    assert [round(t * 1e3) for _, t in facts["idle_gaps"]] == [27, 10, 5, 4]


def record(**trace_extra):
    facts = trace.reduce_events(events(), (0, 100 * MS))
    facts["work"] = {"b3": {"bytes": 3.35e12 * 0.001, "flops": 0.0},
                     "b2": {"bytes": 1.0, "flops": 67e12 * 0.0006}}
    facts.update(trace_extra)
    return {"kind": "train", "samples_per_s": 1000.0, "flops_per_sample": 24.7e9,
            "peak_flops": 989e12,
            "window": {"window_s": 10.0, "input_wait_s": 0.5, "samples": 1, "units": 1,
                       "intervals_ms": [float(x) for x in range(1, 101)]},
            "decode": {"busy_s": 4.0, "items": 10, "rows_per_item": 256}, "trace": facts}


def test_readers_on_a_synthetic_record():
    rec = record()
    assert readers.decode_ms_per_row(rec) == pytest.approx(4000 / 2560)
    assert readers.input_wait_pct(rec) == pytest.approx(5.0)
    assert readers.mfu_pct(rec) == pytest.approx(100 * 24.7e12 / 989e12)
    assert readers.device_idle_pct(rec) == pytest.approx(46.0)
    # 1 ms of least time over 2 ms of the crop kernel; 0.6 ms over 3 ms of B2
    assert readers.roofline_pct(rec, "b3", readers.B3_KERNELS) == pytest.approx(50.0)
    assert readers.roofline_pct(rec, "b2", readers.B2_KERNELS) == pytest.approx(20.0)


def test_readers_with_nothing_to_read_return_none():
    rec = record()
    rec["trace"]["kernels"] = {"sm90_conv": 0.05}
    assert readers.roofline_pct(rec, "b2", readers.B2_KERNELS) is None
    assert readers.roofline_pct(rec, "b3", readers.B3_KERNELS) is None
    del rec["trace"], rec["decode"]
    assert readers.device_idle_pct(rec) is None and readers.decode_ms_per_row(rec) is None


@pytest.mark.parametrize("name", [m["name"] for m in run.load_json(
    run.os.path.join(run.ROOT, "BENCHMARK.json"))["per_layer"]])
def test_every_metric_file_reads_a_record(name):
    value = run.load_metric(name).read(record())
    assert value is not None and value >= 0


def test_the_stretch_maps_the_host_clock_by_either_marker():
    # host launches at 1_000 and 9_000; the device clock runs 500 ahead
    assert trace._offset([1_500, 9_500], 1_000, 9_000, latest=9_000) == 500
    # one marker lost: the first is followed by device work, the last is not
    assert trace._offset([1_500], 1_000, 9_000, latest=9_000) == 500
    assert trace._offset([9_500], 1_000, 9_000, latest=9_000) == 500
    with pytest.raises(RuntimeError):
        trace._offset([], 1_000, 9_000, latest=9_000)
