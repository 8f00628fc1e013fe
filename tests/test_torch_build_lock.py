"""The kernel library's first build runs once in a process, however many
threads ask for it at the same moment (the pipeline's dispatch thread and
a ``processFn`` on the main thread can both reach a kernel first). The
compile step is stubbed, so this runs without nvcc: two threads call
``_build.build()`` together, the stub must run once, and both threads must
get the same library object."""

import threading
import time

import pytest

from theia_tpu_torch import _build


@pytest.fixture
def stubbed(monkeypatch):
    calls = []

    def compile_stub(csrc, defines, signatures):
        calls.append((csrc, defines, signatures))
        time.sleep(0.2)  # long enough for the second thread to arrive mid-build
        return object()

    monkeypatch.setattr(_build, "_compile", compile_stub)
    monkeypatch.setattr(_build, "_BUILT", {})
    return calls


@pytest.mark.parametrize("threads", [2, 8])
def test_concurrent_first_build_compiles_once(stubbed, threads):
    start = threading.Barrier(threads)
    got = [None] * threads

    def ask(i):
        start.wait()
        got[i] = _build.build()

    workers = [threading.Thread(target=ask, args=(i,)) for i in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=10)
    assert len(stubbed) == 1, stubbed
    assert all(g is got[0] for g in got) and got[0] is not None
    assert _build.library() is got[0]
    assert len(stubbed) == 1


def test_other_arguments_build_apart(stubbed):
    a = _build.build()
    b = _build.build(defines=("THEIA_HISTOGRAM_SHARED_MAX=0",))
    assert a is not b and _build.build() is a
    assert [c[1] for c in stubbed] == [(), ("THEIA_HISTOGRAM_SHARED_MAX=0",)]
