"""The span tool's reading of a profiler trace (``harness/spans.py``):
the program's spans with the device work, idle time, ops and syncs each
holds, from hand-built Chrome-trace events."""
import pytest

from bench_port.harness import spans as spans_mod


def ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def rt(name, ts, corr=None, tid=1):
    """A runtime call (``cuda_runtime``) on host thread ``tid``."""
    return ev("cuda_runtime", name, ts, 1, tid, **(
        {} if corr is None else {"correlation": corr}))


def span(name, ts, dur, tid=1):
    return ev("user_annotation", name, ts, dur, tid)


def op(name, ts, dur, tid=1):
    return ev("cpu_op", name, ts, dur, tid)


def attribute(events):
    return spans_mod.attribute(spans_mod.read(events))


def test_backward_kernel_launched_from_another_thread():
    # autograd's worker (tid 2) launches while the main thread waits in
    # the span; a kernel launched after the span lies in none
    got = attribute([
        span("learner.ppo", 0, 100),
        rt("cudaLaunchKernel", 40, corr=7, tid=2),
        ev("kernel", "bwd", 50, 20, correlation=7),
        rt("cudaLaunchKernel", 150, corr=8),
        ev("kernel", "late", 160, 5, correlation=8),
    ])
    assert got["learner.ppo"]["dev_ms"] == pytest.approx(0.020)
    assert got["learner.ppo"]["runtime_ms"] == pytest.approx(0.001)
    assert got[spans_mod.ANY]["dev_ms"] == pytest.approx(0.020)
    assert got[spans_mod.NONE]["dev_ms"] == pytest.approx(0.005)
    assert got["learner.ppo"]["calls"] == 1
    assert spans_mod.share(got, "dev_ms") == pytest.approx(80.0)


def test_idle_in_a_child_span_counts_for_its_parent():
    # the gap 10-70 has its middle (40) in sim.traffic, inside env.step,
    # and in no host op
    got = attribute([
        op("aten::a", 0, 5), op("aten::b", 95, 5),
        span("env.step", 0, 100), span("sim.traffic", 20, 40),
        rt("cudaLaunchKernel", 0, corr=1),
        ev("kernel", "k1", 0, 10, correlation=1),
        rt("cudaLaunchKernel", 65, corr=2),
        ev("kernel", "k2", 70, 30, correlation=2),
    ])
    for name in ("sim.traffic", "env.step", spans_mod.ANY):
        assert got[name]["idle_ms"] == pytest.approx(0.060), name
        assert got[name]["idle_no_op_ms"] == pytest.approx(0.060), name
    assert got["sim.traffic"]["dev_ms"] == 0
    assert got["env.step"]["dev_ms"] == pytest.approx(0.040)


def test_nested_ops_count_once():
    got = attribute([
        span("env.step", 0, 100),
        op("aten::outer", 10, 50), op("aten::inner", 20, 10),
        op("aten::inner2", 20, 10),
        op("aten::other_thread", 30, 5, tid=2),
        op("aten::after", 120, 5),
    ])
    assert got["env.step"]["ops"] == 2
    assert got[spans_mod.NONE]["ops"] == 1


def test_device_to_host_copy_is_one_sync():
    got = attribute([
        span("env.step", 0, 100), span("policy.act", 200, 100),
        # a blocking copy: the copy's launch, then a synchronise (one sync)
        rt("cudaMemcpyAsync", 30, corr=5), rt("cudaStreamSynchronize", 31),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 32, 3,
           correlation=5),
        # a copy to the host with no synchronise after it: one sync
        rt("cudaMemcpyAsync", 50, corr=6), rt("cudaLaunchKernel", 51, corr=9),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 52, 3,
           correlation=6),
        ev("kernel", "k", 56, 3, correlation=9),
        # a copy to the device: no sync
        rt("cudaMemcpyAsync", 60, corr=7),
        ev("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 61, 3,
           correlation=7),
        rt("cudaEventSynchronize", 250),
        rt("cudaDeviceSynchronize", 400),
    ])
    assert got["env.step"]["syncs"] == 2
    assert got["policy.act"]["syncs"] == 1
    assert got[spans_mod.ANY]["syncs"] == 3
    assert got[spans_mod.NONE]["syncs"] == 1


def test_gaps_named_as_the_traced_run_names_them():
    # the idle intervals and their host ops agree with the breakdown of
    # traced.read_trace; a program without spans reads nothing
    from bench_port.harness import traced

    events = [
        op("aten::conv", 0, 100), op("aten::nonzero", 100, 50),
        ev("kernel", "k1", 10, 40), ev("kernel", "k2", 30, 40),
        ev("gpu_memcpy", "copy", 120, 10), ev("kernel", "k1", 140, 10),
    ]
    r = spans_mod.read(events)
    assert r["gaps"] == [(0, 10, "aten::conv"), (70, 120, "aten::conv"),
                         (130, 140, "aten::nonzero")]
    named = dict(map(tuple, traced.read_trace(events, 0.0)["breakdown"][
        "idle_gaps"]))
    for name in ("aten::conv", "aten::nonzero"):
        assert named[name] == pytest.approx(sum(
            b - a for a, b, n in r["gaps"] if n == name) * 1e-6)
    assert spans_mod.attribute(r) == {}
    assert spans_mod.share({}, "dev_ms") is None


@pytest.mark.parametrize("name", ["bev6.rollout.dense.4096",
                                  "bev6.train.4096"])
def test_the_tool_on_a_tiny_cell(name):
    # the CPU profiles the host's ops alone: spans, calls and ops, no
    # device work
    import torch

    from bench_port.tests.tinycells import tiny_cell

    cell = tiny_cell(name)
    out = spans_mod.run(cell, 7, torch.device("cpu"), pairs=1)
    got = out["spans"]
    if cell.workload["entry"] == "rollout":
        T = cell.workload["traffic"]["steps_per_chunk"]
        for span_name, calls in (("env.step", T), ("sim.traffic", T),
                                 ("rollout.obs", T + 1),
                                 ("policy.act", T + 1)):
            assert got[span_name]["calls"] == calls, span_name
            assert out["pairs"][0]["recorded"]["calls"][span_name] == calls
        assert got["env.step"]["ops"] >= got["sim.traffic"]["ops"] > 0
    else:
        assert {"learner.rollout", "learner.validation", "learner.critic",
                "learner.relabel", "learner.returns",
                "learner.ppo"} <= set(got)
        assert got["learner.validation"]["calls"] == 2
        assert "pairs" not in out
    assert out["dev_share"] is None
