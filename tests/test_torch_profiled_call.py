"""`probes/prefill_profile.py`'s profiler sessions on the CPU: a session
that records no device activity is run again after a doubling pause, and
the search gives up after its time; `device_split` keeps the sessions
with the most device events. torch.profiler, the CUDA synchronisation and
the clock are stood in for, so no device is needed."""

from __future__ import annotations

import time
from types import SimpleNamespace

import pytest
import torch

from bark_tpu_torch.probes import prefill_profile as pp


def _event(name, start, end):
    return SimpleNamespace(
        name=name, device_type=torch.autograd.DeviceType.CUDA,
        time_range=SimpleNamespace(start=start, end=end))


class _Sessions:
    """Stands in for torch.profiler.profile: the i-th session records
    `script[i]` (a list of device events; [] for an empty session)."""

    def __init__(self, script):
        self.script = list(script)
        self.opened = 0

    def __call__(self, activities):
        sessions = self

        class _Session:
            def __enter__(self):
                self.events_ = sessions.script[
                    min(sessions.opened, len(sessions.script) - 1)]
                sessions.opened += 1
                return self

            def __exit__(self, *exc):
                return False

            def events(self):
                return self.events_ + [SimpleNamespace(
                    name="host op", device_type=torch.autograd.DeviceType.CPU,
                    time_range=SimpleNamespace(start=0.0, end=1.0))]

        return _Session()


@pytest.fixture
def stand_ins(monkeypatch):
    """Install a scripted profiler, a no-op synchronise and a fake clock;
    returns (install(script) -> _Sessions, the pauses slept)."""
    clock, pauses = [0.0], []

    def sleep(s):
        pauses.append(s)
        clock[0] += s

    monkeypatch.setattr(time, "sleep", sleep)
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)

    def install(script):
        sessions = _Sessions(script)
        monkeypatch.setattr(torch.profiler, "profile", sessions)
        return sessions

    return install, pauses


@pytest.mark.parametrize("empty", [0, 1, 12])
def test_empty_sessions_are_run_again_after_doubling_pauses(stand_ins,
                                                            empty):
    install, pauses = stand_ins
    step = [_event("lane_step_kernel", 5.0, 9.0)]
    sessions = install([[]] * empty + [step])
    calls = []
    got = pp.profiled_call(lambda: calls.append(1))
    assert [e.name for e in got] == ["lane_step_kernel"]
    assert sessions.opened == len(calls) == empty + 1
    assert pauses == [min(0.01 * 2 ** i, 2.0) for i in range(empty)]


def test_no_device_activity_raises_after_its_time(stand_ins):
    install, pauses = stand_ins
    install([[]])
    with pytest.raises(AssertionError, match="no device activity"):
        pp.profiled_call(lambda: None, wait_s=5.0)
    assert sum(pauses) <= 5.0
    assert sum(pauses) + min(2 * pauses[-1], 2.0) > 5.0


def test_events_come_in_start_order(stand_ins):
    install, _ = stand_ins
    install([[_event("b", 7.0, 8.0), _event("a", 1.0, 2.0)]])
    assert [e.name for e in pp.profiled_call(lambda: None)] == ["a", "b"]


def test_device_split_keeps_the_sessions_with_the_most_events(stand_ins):
    install, _ = stand_ins
    full = [_event("gemm_tma_kernel", 0.0, 10.0),
            _event("attn_prefill_tc_kernel", 12.0, 16.0)]
    dropped = full[:1]
    sessions = install([dropped, [], full, dropped, full])
    s = pp.device_split(lambda: None, n=2)
    assert sessions.opened == 5
    assert s["events"] == 2 and s["sessions"] == 2
    assert s["busy_us"] == pytest.approx(14.0)
    assert s["span_us"] == pytest.approx(16.0)
    assert s["gaps_us"] == pytest.approx(2.0)
    assert s["kinds"] == {"gemm": pytest.approx(10.0),
                          "attention": pytest.approx(4.0)}


def test_profiler_sessions_probe_needs_a_card(monkeypatch, capsys):
    from bark_tpu_torch.probes import profiler_sessions

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert profiler_sessions.main(["--sessions", "3"]) == 1
    assert capsys.readouterr().out == ""
