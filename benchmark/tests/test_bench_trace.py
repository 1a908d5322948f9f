"""The spans around entry points hold their own forward and backward work
and no one else's; the interval arithmetic of the trace's reduction."""

import sys
import types

import torch

from benchmark.trace import BWD, FWD, EntryPoints, Trace, profiler, union_length


def test_spans_hold_their_own_backward(monkeypatch):
    mod = types.ModuleType("bench_toy_layers")
    mod.f = lambda x: torch.sin(x) * 2.0          # "encoder": SinBackward0, MulBackward0
    mod.g = lambda z: torch.exp(z).sum()          # "trajectory": ExpBackward0, SumBackward0
    monkeypatch.setitem(sys.modules, "bench_toy_layers", mod)
    x = torch.randn(64, requires_grad=True)
    with EntryPoints(["bench_toy_layers:f", "bench_toy_layers:g"]), profiler() as prof:
        for _ in range(3):
            mod.g(mod.f(x)).backward()
    assert mod.f(x).grad_fn is not None and "bench_toy_layers" in sys.modules
    t = Trace(prof)

    def inside(op, span):
        starts = [(s, e) for s, e, name in t.host_ops if name == op]
        return [any(a <= s and e <= b for a, b in t.spans[span]) for s, e in starts]

    assert len(t.spans[FWD + "bench_toy_layers:f"]) == 3
    assert all(inside("SinBackward0", BWD + "bench_toy_layers:f"))
    assert not any(inside("SinBackward0", BWD + "bench_toy_layers:g"))
    assert all(inside("ExpBackward0", BWD + "bench_toy_layers:g"))
    assert not any(inside("ExpBackward0", BWD + "bench_toy_layers:f"))
    # the entry points are the originals again once the context has closed
    assert mod.f.__name__ == "<lambda>" and FWD not in str(mod.f)


def test_union_length():
    assert union_length([(0, 10), (5, 15), (20, 30)], 0, 100) == 25
    assert union_length([(0, 10), (5, 15), (20, 30)], 8, 25) == 12
    assert union_length([], 0, 10) == 0
