"""The harness's tests beside the repo's: each test of ``perfbench/tests``
sees ``sys.modules`` as the benchmark's own process has it, without JAX
or the JAX package ``repro``, which the repo's other tests load into the
same worker process when one run collects both."""
import sys

import pytest

from perfbench.util import FORBIDDEN


@pytest.fixture(autouse=True)
def _modules_as_the_benchmark_has_them(monkeypatch):
    for name in list(sys.modules):
        if name.split(".", 1)[0] in FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
