"""The comparison that decides `correct` fails what it must fail: the
controls (the plain reference computed in a lower precision, or the
program's own lower-precision path, in the program's place) and faults
planted in the program, each driven through a whole run of the harness at
a tiny size on the CPU. Clean runs of the same cells come out correct."""

import pytest

from faults import INDEX, VIDEO
from h100_bench_support import run_cell


@pytest.mark.parametrize("workload", ["video_b4", "index_query",
                                      "video_b4_limit2048"])
def test_clean_run_is_correct(tiny_root, workload):
    r = run_cell(tiny_root, workload, 2 ** 31 + 77)
    assert r["correct"], r["checks"]
    assert r["forbidden"] == []


@pytest.mark.parametrize("workload,control", [
    ("video_b4", "bf16_storage"),
    ("index_query", "bf16_product"),
])
def test_control_is_not_correct(tiny_root, workload, control):
    r = run_cell(tiny_root, workload, 2 ** 31 + 78, control=control)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("fault", VIDEO + INDEX)
def test_fault_is_not_correct(tiny_root, fault):
    workload = "video_b4" if fault in VIDEO else "index_query"
    r = run_cell(tiny_root, workload, 2 ** 31 + 79, fault=fault)
    assert not r["correct"], r["checks"]
