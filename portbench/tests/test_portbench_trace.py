"""The reading of a profiler trace (``harness.device_busy``) on events
made by hand: a CUDA graph launch is busy from its first recorded device
operation to its last, its unrecorded body between them; other device
operations count by their own spans; the host's ranges copied onto the
card's timeline are no operations; idle gaps are named by the host range
they fall in."""

import pytest

from portbench import harness


class Ev:
    def __init__(self, name, start, end, corr, device):
        self._n, self._s, self._d, self._c, self._dev = (
            name, start, end - start, corr, device)

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def correlation_id(self):
        return self._c

    def device_type(self):
        return self._dev


class DeviceType:
    CPU, CUDA = "cpu", "cuda"


def events(launch_recorded=True):
    cpu, dev = DeviceType.CPU, DeviceType.CUDA
    out = [
        Ev(harness.SUBMIT, 0, 100, 0, cpu),
        Ev("cudaGraphLaunch", 90, 95, 7, cpu),
        Ev(harness.READ, 100, 1000, 0, cpu),
        # the graph's straight parts; its body runs from 200 to 800
        Ev("pre", 100, 200, 7, dev),
        Ev("post", 800, 850, 7, dev),
        # the stats copied behind it
        Ev("Memcpy DtoH", 860, 870, 9, dev),
        # the profiler's copy of a host range on the card's timeline
        Ev(harness.SUBMIT, 100, 990, 3, dev),
    ]
    if not launch_recorded:
        out = [e for e in out if e.name() != "cudaGraphLaunch"]
    return out


@pytest.mark.parametrize("launch_recorded", [True, False])
def test_graph_body_counts_as_busy(launch_recorded):
    got = harness.device_busy(events(launch_recorded), DeviceType)
    assert got["window"] == 1000
    assert got["busy"] == 750 + 10
    assert got["recorded"] == 100 + 50 + 10
    assert got["in_graphs"] == 2
    gaps = sorted(got["gaps"])
    assert gaps == [(10, harness.READ), (100, harness.SUBMIT),
                    (130, harness.READ)]
    assert got["ops"]["pre"] == 100
    assert harness.SUBMIT not in got["ops"]


def test_no_host_range_reads_nothing():
    evs = [e for e in events() if e.name() not in (harness.SUBMIT,
                                                   harness.READ)]
    assert harness.device_busy(evs, DeviceType) is None
