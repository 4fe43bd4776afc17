"""The perf-regression gate (``observability.gate``, the port's own copy)
gives the reference's reports on the same records: every status (OK,
IMPROVED, REGRESSION, PRESENT, MISSING, SKIP, NEW), both directions
(time-like units regress upward, rates downward), the tolerance edge, and
the loaded, compared and formatted forms."""
import json

import pytest

from paddle_tpu.observability import gate as ref_gate
from paddle_tpu_torch.observability import gate

BASE = [
    {"metric": "gpt_step_ms", "value": 50.0, "unit": "ms", "backend": "gpu"},
    {"metric": "gpt_tokens_per_s", "value": 1000.0, "unit": "tokens/s",
     "backend": "gpu"},
    {"metric": "bert_mfu", "value": 0.2, "unit": "mfu", "backend": "gpu"},
    {"metric": "serve_ms", "value": 10.0, "unit": "ms", "backend": "gpu"},
    {"metric": "ckpt_gbps", "value": 0.3, "unit": "GB/s", "backend": "gpu",
     "gate": "presence"},
    {"metric": "gone", "value": 1.0, "unit": "x", "backend": "gpu"},
    {"metric": "broken", "error": "crashed", "backend": "gpu"},
    {"metric": "host_ms", "value": 3.0, "unit": "ms", "backend": "tpu"},
]
CURRENT = [
    {"metric": "gpt_step_ms", "value": 56.0, "unit": "ms", "backend": "gpu"},
    {"metric": "gpt_tokens_per_s", "value": 1200.0, "unit": "tokens/s",
     "backend": "gpu"},
    {"metric": "bert_mfu", "value": 0.19, "unit": "mfu", "backend": "gpu"},
    {"metric": "serve_ms", "value": 10.5, "unit": "ms", "backend": "gpu"},
    {"metric": "ckpt_gbps", "value": 0.01, "unit": "GB/s", "backend": "gpu"},
    {"metric": "broken", "value": 2.0, "unit": "x", "backend": "gpu"},
    {"metric": "host_ms", "value": 30.0, "unit": "ms", "backend": "gpu"},
    {"metric": "new_row", "value": 7.0, "unit": "ms", "backend": "gpu"},
]


@pytest.mark.parametrize("tolerance", [0.05, 0.10, 0.5])
def test_compare_gives_the_reference_report(tolerance):
    base = {r["metric"]: r for r in BASE}
    cur = {r["metric"]: r for r in CURRENT}
    want = ref_gate.compare(base, cur, tolerance=tolerance)
    got = gate.compare(base, cur, tolerance=tolerance)
    assert got == want
    assert got[0] is False  # a regression or a missing row fails the gate
    assert gate.format_report(got[1]) == ref_gate.format_report(want[1])
    if tolerance == 0.05:
        status = {e["metric"]: e["status"] for e in got[1]}
        assert status["gpt_step_ms"] == "REGRESSION"
        assert status["gpt_tokens_per_s"] == "IMPROVED"
        assert status["serve_ms"] == "OK"
        assert status["ckpt_gbps"] == "PRESENT"
        assert status["gone"] == "MISSING"
        assert status["new_row"] == "NEW"
        assert status["broken"] == "SKIP"


def test_loaded_records_and_baseline_round_trip(tmp_path):
    path = tmp_path / "results.jsonl"
    path.write_text("\n".join(json.dumps(r) for r in CURRENT))
    assert gate.load_results(str(path)) == ref_gate.load_results(str(path))
    gate.write_baseline(BASE, str(tmp_path / "port.json"))
    ref_gate.write_baseline(BASE, str(tmp_path / "ref.json"))
    assert (tmp_path / "port.json").read_text() == \
        (tmp_path / "ref.json").read_text()
    for rec in BASE + CURRENT:
        assert gate.higher_is_better(rec) == ref_gate.higher_is_better(rec)
