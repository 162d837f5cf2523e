"""Profiling / observability utilities (SURVEY.md §5: tracing + metrics)."""

import json

import numpy as np

from tpumcia.utils.logging import MetricsLogger
from tpumcia.utils.profiling import ThroughputMeter


def test_throughput_meter_accumulates():
    m = ThroughputMeter()
    with m.measure("extract", 100):
        pass
    with m.measure("extract", 50):
        pass
    with m.measure("fit", 10):
        pass
    rep = m.report()
    assert rep["extract"]["items"] == 150
    assert rep["fit"]["items"] == 10
    assert rep["extract"]["per_second"] == m.rate("extract") > 0
    assert m.rate("missing") == 0.0


def test_metrics_logger_jsonl(tmp_path):
    path = tmp_path / "metrics.jsonl"
    log = MetricsLogger(path)
    log.log("stage_done", stage="features", images=12, rate=3.5)
    log.log("stage_done", stage="fit", accuracy=0.9)
    lines = [json.loads(l) for l in path.read_text().splitlines()]
    assert len(lines) == 2
    assert lines[0]["stage"] == "features" and lines[0]["images"] == 12
    assert all("ts" in l and l["event"] == "stage_done" for l in lines)
