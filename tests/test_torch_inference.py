"""The port's inference API and serving engine over a saved artifact, on
the CPU: ``inference.Predictor`` and ``serving.Engine(path)`` case for
case with the reference's ``tests/test_serving.py`` and
``tests/test_serialization_serving.py`` where the port has the feature.

The artifact is a batch-polymorphic MLP (Linear, ReLU, Linear) saved
with ``jit.save``; the expected values are the port's eager forward of the
same layer. Every comparison is bitwise (float32: the engine pads a batch
to its bucket and runs the same program; an MLP's rows do not mix), except
the ``bf16`` pass on a live layer: 5e-2 relative and absolute against
float32 (bf16 keeps ~3 significant digits through 2 layers), as the
reference's test. torch's CPU product takes a matrix-vector kernel for a
single row, whose sums differ in the last bit from the matrix kernel's, so
a one-row request is compared only where both sides run one row. On the
CPU the engine runs eagerly (CUDA graphs are the card's, checked by
``chip_smoke.py`` phase 12).
"""
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from paddle_tpu_torch import jit, monitor, nn, serving
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.jit.export import ServedProgram, save_exported
from paddle_tpu_torch.jit.to_static import InputSpec
from paddle_tpu_torch.observability import export as obs_export
from paddle_tpu_torch.testing import faults


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _mlp(in_dim=8, hidden=16, out_dim=4, seed=7):
    torch.manual_seed(seed)
    m = nn.Sequential(nn.Linear(in_dim, hidden, device="cpu"), nn.ReLU(),
                      nn.Linear(hidden, out_dim, device="cpu"))
    return m.eval()


class TwoHead(nn.Layer):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(8, 8, device="cpu")
        self.a = nn.Linear(8, 4, device="cpu")
        self.b = nn.Linear(8, 2, device="cpu")

    def forward(self, x):
        h = torch.tanh(self.fc(x))
        return self.a(h), self.b(h)


def _eager(model, x):
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    outs = out if isinstance(out, tuple) else (out,)
    return [o.numpy() for o in outs]


def _engine(prefix, **kw):
    return serving.Engine(prefix, device="cpu", **kw)


def _config(prefix, **engine):
    cfg = Config(prefix + ".pdmodel", prefix + ".pdiparams")
    cfg.disable_gpu()
    if engine:
        cfg.enable_serving_engine(**engine)
    return cfg


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """A saved batch-polymorphic artifact and the live model."""
    model = _mlp()
    prefix = str(tmp_path_factory.mktemp("serving") / "m")
    jit.save(model, prefix,
             input_spec=[InputSpec([None, 8], "float32", name="feat")])
    return model, prefix


@pytest.fixture(scope="module")
def two_head(tmp_path_factory):
    torch.manual_seed(13)
    model = TwoHead().eval()
    prefix = str(tmp_path_factory.mktemp("two") / "two")
    jit.save(model, prefix, input_spec=[InputSpec([None, 8], "float32")])
    return model, prefix


class TestBucketedEngine:
    def test_ragged_batches_bitwise_equal_unbatched(self, artifact):
        """Padded-bucket outputs equal per-request unbatched Predictor
        runs, bitwise."""
        _model, prefix = artifact
        pred = create_predictor(_config(prefix))
        with _engine(prefix, bucket_ladder=(1, 4, 8),
                     batch_timeout_ms=1.0) as eng:
            rng = np.random.RandomState(0)
            for rows in (1, 2, 3, 4, 5, 7, 8):
                x = rng.randn(rows, 8).astype(np.float32)
                (want,) = pred.run([x])
                (got,) = eng.predict(x)
                assert got.dtype == np.float32
                np.testing.assert_array_equal(got, want)

    def test_bucket_selection(self, artifact):
        _model, prefix = artifact
        with _engine(prefix, bucket_ladder=(1, 4, 8)) as eng:
            assert [eng.bucket_for(r) for r in (1, 2, 4, 5, 8)] == \
                [1, 4, 4, 8, 8]
            with pytest.raises(ValueError, match="exceed"):
                eng.bucket_for(9)

    def test_every_bucket_warmed_at_load_none_on_request(self, artifact):
        """One forward per bucket at load and none besides the served
        batches afterwards; on the CPU nothing is captured."""
        _model, prefix = artifact
        with _engine(prefix, bucket_ladder=(1, 4, 8),
                     batch_timeout_ms=1.0) as eng:
            loaded = eng.stats()
            assert loaded["warmup_runs"] == 3 == len(eng.bucket_ladder)
            rng = np.random.RandomState(1)
            for rows in (2, 1, 5, 3, 8, 7, 4, 6):
                eng.predict(rng.randn(rows, 8).astype(np.float32))
            stats = eng.stats()
        assert stats["warmup_runs"] == 3 and stats["batches"] == 8
        assert stats["executables"] == 0 and stats["capture_ms"] == {}

    def test_oversized_request_chunks_transparently(self, artifact):
        model, prefix = artifact
        with _engine(prefix, bucket_ladder=(1, 4),
                     batch_timeout_ms=1.0) as eng:
            x = np.random.RandomState(2).randn(11, 8).astype(np.float32)
            (got,) = eng.predict(x)
            np.testing.assert_array_equal(got, _eager(model, x)[0])
            assert eng.stats()["chunked_requests"] == 1

    def test_input_validation(self, artifact):
        _model, prefix = artifact
        with _engine(prefix, bucket_ladder=(4,)) as eng:
            with pytest.raises(ValueError, match="expected 1 inputs"):
                eng.predict(np.ones((2, 8), np.float32),
                            np.ones((2, 8), np.float32))
            with pytest.raises(ValueError, match="got shape"):
                eng.predict(np.ones((2, 9), np.float32))
            with pytest.raises(ValueError, match="empty request"):
                eng.predict(np.zeros((0, 8), np.float32))

    def test_non_batch_major_output_rejected(self, tmp_path):
        """An output whose axis 0 is not the batch cannot be sliced back to
        requests: the engine refuses at load."""

        class Reduce(nn.Layer):
            def __init__(self):
                super().__init__()
                self.fc = nn.Linear(4, 4, device="cpu")

            def forward(self, x):
                return self.fc(x).sum()

        prefix = str(tmp_path / "red")
        jit.save(Reduce(), prefix, input_spec=[InputSpec([None, 4])])
        with pytest.raises(ValueError, match="not batch-major"):
            _engine(prefix, bucket_ladder=(2,))

    def test_unreachable_buckets_not_warmed(self, artifact):
        """max_batch_size caps batch rows, so buckets above it are never
        selected and never loaded."""
        model, prefix = artifact
        with _engine(prefix, bucket_ladder=(1, 4, 16), max_batch_size=4,
                     batch_timeout_ms=1.0) as eng:
            assert eng.bucket_ladder == (1, 4)
            assert eng.stats()["warmup_runs"] == 2
            x = np.random.RandomState(21).randn(7, 8).astype(np.float32)
            (got,) = eng.predict(x)
            np.testing.assert_array_equal(got, _eager(model, x)[0])

    def test_fixed_batch_artifact_rejected(self, tmp_path):
        prefix = str(tmp_path / "fixed")
        jit.save(_mlp(), prefix, input_spec=[InputSpec([2, 8], "float32")])
        with pytest.raises(ValueError, match="batch-polymorphic"):
            _engine(prefix, bucket_ladder=(1, 4))

    @pytest.mark.parametrize("source", ["path", "pdmodel", "config",
                                        "served_program", "create_engine"])
    def test_engine_sources(self, artifact, source):
        model, prefix = artifact
        make = {
            "path": lambda: _engine(prefix),
            "pdmodel": lambda: _engine(prefix + ".pdmodel"),
            "config": lambda: serving.Engine(_config(prefix)),
            "served_program": lambda: serving.Engine(
                ServedProgram(prefix, device="cpu")),
            "create_engine": lambda: serving.create_engine(
                _config(prefix), bucket_ladder=(4,))}[source]
        x = np.random.RandomState(22).randn(3, 8).astype(np.float32)
        with make() as eng:
            assert eng.input_names == ["feat"]
            assert eng.output_names == ["output_0"]
            assert eng.run(x)[0].shape == (3, 4)
            np.testing.assert_array_equal(eng.predict(x)[0],
                                          _eager(model, x)[0])

    def test_engine_refuses_what_is_not_an_artifact(self, tmp_path):
        with pytest.raises(TypeError, match="Engine.from_layer"):
            serving.Engine(_mlp(), device="cpu")
        with pytest.raises(FileNotFoundError, match="jit.save"):
            _engine(str(tmp_path / "nothing"))


class TestConcurrentBatching:
    def test_concurrent_clients_coalesce(self, artifact):
        """N threads of ragged traffic: every future resolves with its
        rows, and at least one device step served several requests."""
        model, prefix = artifact
        with _engine(prefix, bucket_ladder=(1, 4, 16),
                     batch_timeout_ms=20.0) as eng:
            results = {}

            def client(i):
                rng = np.random.RandomState(100 + i)
                for j in range(5):
                    # 2-4 rows: a 1-row request coalesced into a larger
                    # batch would take another CPU product kernel (below)
                    x = rng.randn(2 + (i + j) % 3, 8).astype(np.float32)
                    results[(i, j)] = (x, eng.predict(x))

            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            stats = eng.stats()
        assert len(results) == 40
        for x, (out,) in results.values():
            assert out.shape[0] == x.shape[0]
            np.testing.assert_array_equal(out, _eager(model, x)[0])
        assert stats["requests"] == 40
        assert stats["multi_request_batches"] >= 1
        assert stats["batches"] < 40

    def test_timeout_flushes_partial_batch(self, artifact):
        _model, prefix = artifact
        with _engine(prefix, bucket_ladder=(16,),
                     batch_timeout_ms=30.0) as eng:
            t0 = time.perf_counter()
            (out,) = eng.predict(np.ones((2, 8), np.float32))
            assert out.shape == (2, 4)
            assert time.perf_counter() - t0 < 10.0
            assert eng.stats()["padded_rows"] == 14
        g = obs_export.gauges()
        assert g["serving_batch_fill_ratio"] == pytest.approx(2 / 16)

    def test_submit_returns_future(self, artifact):
        _model, prefix = artifact
        with _engine(prefix, bucket_ladder=(4,),
                     batch_timeout_ms=1.0) as eng:
            futs = [eng.submit(np.ones((1, 8), np.float32))
                    for _ in range(6)]
            outs = [f.result(timeout=30) for f in futs]
        assert all(o[0].shape == (1, 4) for o in outs)

    def test_cancelled_future_does_not_poison_batch(self, artifact):
        model, prefix = artifact
        with _engine(prefix, bucket_ladder=(1, 4, 16),
                     batch_timeout_ms=200.0) as eng:
            x = np.random.RandomState(30).randn(2, 8).astype(np.float32)
            f1 = eng.submit(x)
            f2 = eng.submit(np.ones((1, 8), np.float32))
            f2.cancel()
            (out,) = f1.result(timeout=30)
        np.testing.assert_array_equal(out, _eager(model, x)[0])

    def test_close_rejects_new_requests(self, artifact):
        _model, prefix = artifact
        eng = _engine(prefix, bucket_ladder=(4,))
        eng.close()
        with pytest.raises(RuntimeError, match="closed"):
            eng.predict(np.ones((1, 8), np.float32))


class TestPasses:
    def test_fp32_from_layer_bitwise(self):
        model = _mlp(seed=11)
        x = np.random.RandomState(3).randn(5, 8).astype(np.float32)
        with serving.Engine.from_layer(
                model, [InputSpec([None, 8], "float32")],
                bucket_ladder=(1, 8), batch_timeout_ms=1.0,
                device="cpu") as eng:
            (got,) = eng.predict(x)
        np.testing.assert_array_equal(got, _eager(model, x)[0])

    def test_bf16_pass_within_tolerance(self):
        model = _mlp(seed=12)
        x = np.random.RandomState(4).randn(6, 8).astype(np.float32)
        want = _eager(model, x)[0]
        with serving.Engine.from_layer(
                model, [InputSpec([None, 8], "float32")],
                bucket_ladder=(8,), passes=("bf16",), device="cpu") as eng:
            (got,) = eng.predict(x)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=5e-2, atol=5e-2)
        assert not np.array_equal(got, want)

    def test_bf16_on_artifact_raises(self, artifact):
        _model, prefix = artifact
        with pytest.raises(ValueError, match="serialized torch.export"):
            _engine(prefix, passes=("bf16",))

    def test_unknown_pass_raises(self, artifact):
        _model, prefix = artifact
        with pytest.raises(ValueError, match="unknown serving pass"):
            _engine(prefix, passes=("fuse_everything",))

    def test_donate_pass_serves_correctly(self, artifact):
        model, prefix = artifact
        x = np.random.RandomState(5).randn(3, 8).astype(np.float32)
        with _engine(prefix, bucket_ladder=(4,), passes=("donate",)) as eng:
            (got,) = eng.predict(x)
        np.testing.assert_array_equal(got, _eager(model, x)[0])

    def test_output_pruning_subset(self, two_head):
        """outputs= serves a fetch subset: the unfetched head leaves the
        exported graph; unknown names raise with the valid list."""
        model, prefix = two_head
        x = np.random.RandomState(6).randn(2, 8).astype(np.float32)
        _wa, wb = _eager(model, x)
        with _engine(prefix, bucket_ladder=(4,),
                     outputs=["output_1"]) as eng:
            assert eng.output_names == ["output_1"]
            outs = eng.predict(x)
            graph = eng._prep.module.graph
        assert len(outs) == 1
        np.testing.assert_array_equal(outs[0], wb)
        full = ServedProgram(prefix, device="cpu").graph_module().graph
        assert len(graph.nodes) < len(full.nodes)
        # the parameters in the artifact's order: fc, a, b (weight, bias);
        # head a's are no longer read
        args = [n for n in graph.nodes if n.op == "placeholder"]
        assert len(args) == 7
        assert not args[2].users and not args[3].users
        assert args[4].users and args[5].users
        with pytest.raises(ValueError, match="valid output names"):
            _engine(prefix, outputs=["output_9"])

    def test_outputs_on_a_live_layer(self):
        torch.manual_seed(14)
        model = TwoHead().eval()
        x = np.random.RandomState(7).randn(3, 8).astype(np.float32)
        with serving.Engine.from_layer(
                model, [InputSpec([None, 8], "float32")],
                bucket_ladder=(4,), outputs=["output_0"],
                device="cpu") as eng:
            assert eng.output_names == ["output_0"]
            (got,) = eng.predict(x)
        np.testing.assert_array_equal(got, _eager(model, x)[0])


class TestSLOTelemetry:
    def test_percentile_summaries_and_counters_export(self, artifact):
        _model, prefix = artifact
        obs_export.clear_summaries()
        with _engine(prefix, bucket_ladder=(1, 4),
                     batch_timeout_ms=1.0) as eng:
            rng = np.random.RandomState(7)
            for _ in range(12):
                eng.predict(rng.randn(1 + rng.randint(4), 8)
                            .astype(np.float32))
        text = obs_export.prometheus_text()
        assert "# TYPE paddle_tpu_serving_latency_ms summary" in text
        for q in ('quantile="0.5"', 'quantile="0.95"', 'quantile="0.99"'):
            assert f"paddle_tpu_serving_latency_ms{{{q}}}" in text
        assert "paddle_tpu_serving_latency_ms_count" in text
        assert 'paddle_tpu_serving_requests_total{bucket="' in text
        assert "paddle_tpu_serving_batch_fill_ratio" in text
        tele = obs_export.telemetry_dict()
        lat = tele["summaries"]["serving_latency_ms"]
        assert lat["count"] >= 12
        assert lat["p50"] <= lat["p95"] <= lat["p99"]
        assert "serving_queue_wait_ms" in tele["summaries"]
        assert "serving_device_ms" in tele["summaries"]

    def test_empty_summary_serializes_as_valid_json(self):
        obs_export.clear_summaries()
        obs_export.summary("t_empty")
        try:
            snap = obs_export.summaries()["t_empty"]
            assert snap["p50"] is None and snap["count"] == 0
            text = json.dumps(obs_export.telemetry_dict())
            json.loads(text)
            assert "NaN" not in text
        finally:
            obs_export.clear_summaries()

    def test_clear_summaries_keeps_live_engine_exporting(self, artifact):
        _model, prefix = artifact
        with _engine(prefix, bucket_ladder=(1, 4),
                     batch_timeout_ms=1.0) as eng:
            eng.predict(np.ones((1, 8), np.float32))
            obs_export.clear_summaries()
            snap = obs_export.summaries()["serving_latency_ms"]
            assert snap["p50"] is None
            before = snap["count"]
            eng.predict(np.ones((1, 8), np.float32))
            snap = obs_export.summaries()["serving_latency_ms"]
            assert snap["p50"] is not None
            assert snap["count"] == before + 1

    def test_max_batch_size_validated(self, artifact):
        _model, prefix = artifact
        for bad in (0, -3):
            with pytest.raises(ValueError, match="max_batch_size"):
                _engine(prefix, bucket_ladder=(1, 4), max_batch_size=bad)
        with pytest.raises(ValueError, match="exceeds the top bucket"):
            _engine(prefix, bucket_ladder=(1, 4), max_batch_size=9)

    def test_submit_snapshots_caller_buffer(self, artifact):
        model, prefix = artifact
        with _engine(prefix, bucket_ladder=(1, 4, 16),
                     batch_timeout_ms=100.0) as eng:
            x = np.random.RandomState(31).randn(2, 8).astype(np.float32)
            want = _eager(model, x)[0]
            fut = eng.submit(x)
            x[:] = 0.0
            (out,) = fut.result(timeout=30)
        np.testing.assert_array_equal(out, want)

    def test_summary_quantiles(self):
        s = obs_export.Summary("t_unit", window=128)
        for v in range(1, 101):
            s.observe(float(v))
        q = s.quantiles()
        assert q[0.5] == pytest.approx(50.5, abs=1.0)
        assert q[0.99] == pytest.approx(100.0, abs=2.0)
        assert s.count == 100 and s.sum == pytest.approx(5050.0)

    def test_serving_spans_recorded(self, artifact):
        _model, prefix = artifact
        obs.tracing.reset()
        obs.enable(categories=["serving"])
        try:
            with _engine(prefix, bucket_ladder=(2,),
                         batch_timeout_ms=1.0) as eng:
                eng.predict(np.ones((1, 8), np.float32))
        finally:
            obs.disable()
        spans = obs.tracing.spans()
        names = {s["name"] for s in spans}
        assert {"serving/batch", "serving/pad", "serving/device_step",
                "serving/queue_wait", "serving/request"} <= names
        request = next(s for s in spans if s["name"] == "serving/request")
        batch = next(s for s in spans if s["name"] == "serving/batch")
        assert request["attrs"]["links"] == [
            f"{batch['trace_id']:016x}:{batch['span_id']:016x}"]

    def test_injected_device_step_fault_resolves_every_future(self,
                                                              artifact):
        """A failed device step resolves each co-batched future with the
        error; the worker stays serviceable."""
        model, prefix = artifact
        before = monitor.stat_get("serving_request_errors_total")
        with _engine(prefix, bucket_ladder=(4,),
                     batch_timeout_ms=100.0) as eng:
            faults.inject("serving/device_step")
            try:
                futs = [eng.submit(np.ones((1, 8), np.float32))
                        for _ in range(3)]
                for f in futs:
                    with pytest.raises(faults.FaultInjected):
                        f.result(timeout=30)
            finally:
                faults.clear("serving/device_step")
            assert eng.health()["status"] == "ok"
            x = np.ones((2, 8), np.float32)
            np.testing.assert_array_equal(eng.predict(x)[0],
                                          _eager(model, x)[0])
            assert eng.stats()["errors"] == 3
        assert monitor.stat_get("serving_request_errors_total") \
            == before + 3

    def test_memory_stats_per_bucket(self, artifact):
        _model, prefix = artifact
        with _engine(prefix, bucket_ladder=(1, 4)) as eng:
            mem = eng.memory_stats()
        params = 8 * 16 + 16 + 16 * 4 + 4
        assert sorted(mem) == [1, 4]
        for b, m in mem.items():
            assert m["argument_bytes"] == 4 * (params + b * 8)
            assert m["output_bytes"] == 4 * b * 4
            assert m["alias_bytes"] == m["generated_code_bytes"] == 0
            # the CPU captures no graph: its pool is not measured
            assert m["temp_bytes"] is None and m["peak_bytes"] is None


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class TestHealth:
    def test_health_ok_then_closed(self, artifact):
        _model, prefix = artifact
        eng = _engine(prefix, bucket_ladder=(1,))
        h = eng.health()
        assert h["status"] == "ok" and h["ready"]
        assert h["bucket_ladder"] == [1] and h["device"] == "cpu"
        eng.close()
        assert eng.health()["status"] == "closed"
        assert not eng.health()["ready"]

    def test_healthz_over_http(self, artifact):
        """/healthz answers 200 while every component is ok, lists the
        engine for its life, and 503 once a component degrades."""
        _model, prefix = artifact
        server = obs_export.start_http_server(0, addr="127.0.0.1")
        url = f"http://127.0.0.1:{server.port}"
        try:
            eng = _engine(prefix, bucket_ladder=(1,))
            name = eng._health_name
            code, body = _get(url + "/healthz")
            assert code == 200 and body["status"] == "ok"
            assert body["components"][name]["status"] == "ok"
            eng.close()
            code, body = _get(url + "/healthz")
            assert name not in body["components"]
            obs_export.register_health("t_down", lambda: {"status": "dead"})
            try:
                code, body = _get(url + "/healthz")
                assert code == 503 and body["status"] == "degraded"
            finally:
                obs_export.unregister_health("t_down")
            with urllib.request.urlopen(url + "/metrics", timeout=10) as r:
                assert b"# TYPE" in r.read()
        finally:
            server.stop()


class TestPredictor:
    def test_predictor_handles(self, artifact):
        model, prefix = artifact
        x = np.random.RandomState(1).randn(3, 8).astype(np.float32)
        pred = create_predictor(_config(prefix))
        assert pred.get_input_names() == ["feat"]
        pred.get_input_handle("feat").copy_from_cpu(x)
        pred.run()
        out = pred.get_output_handle(
            pred.get_output_names()[0]).copy_to_cpu()
        np.testing.assert_array_equal(out, _eager(model, x)[0])

    def test_config_enable_serving_engine(self, artifact):
        model, prefix = artifact
        pred = create_predictor(_config(prefix, bucket_ladder=(1, 4),
                                        batch_timeout_ms=1.0))
        x = np.random.RandomState(8).randn(3, 8).astype(np.float32)
        pred.get_input_handle("feat").copy_from_cpu(x)
        outs = pred.run()
        np.testing.assert_array_equal(outs[0], _eager(model, x)[0])
        assert pred._engine.stats()["requests"] == 1
        np.testing.assert_array_equal(
            pred.get_output_handle("output_0").copy_to_cpu(), outs[0])
        pred.close()
        assert pred._engine is None

    def test_delegation_with_output_subset(self, two_head):
        model, prefix = two_head
        pred = create_predictor(_config(prefix, bucket_ladder=(4,),
                                        batch_timeout_ms=1.0,
                                        outputs=["output_1"]))
        assert pred.get_output_names() == ["output_1"]
        x = np.random.RandomState(9).randn(2, 8).astype(np.float32)
        pred.get_input_handle(pred.get_input_names()[0]).copy_from_cpu(x)
        pred.run()
        np.testing.assert_array_equal(
            pred.get_output_handle("output_1").copy_to_cpu(),
            _eager(model, x)[1])
        with pytest.raises(ValueError, match="valid output names"):
            pred.get_output_handle("output_0")
        pred.close()

    def test_as_engine_from_predictor(self, artifact):
        model, prefix = artifact
        pred = create_predictor(_config(prefix))
        with pred.as_engine(bucket_ladder=(2,),
                            batch_timeout_ms=1.0) as eng:
            x = np.ones((2, 8), np.float32)
            np.testing.assert_array_equal(eng.predict(x)[0],
                                          _eager(model, x)[0])

    def test_as_engine_artifact_ignores_input_specs(self, artifact):
        _model, prefix = artifact
        pred = create_predictor(_config(prefix))
        with pytest.warns(UserWarning, match="records its own input"):
            eng = pred.as_engine(
                input_specs=[InputSpec([None, 8], "float32")],
                bucket_ladder=(2,), batch_timeout_ms=1.0)
        with eng:
            assert eng.predict(np.ones((1, 8), np.float32))[0].shape == \
                (1, 4)

    def test_predictor_context_manager_closes_engine(self, artifact):
        _model, prefix = artifact
        with create_predictor(_config(prefix, bucket_ladder=(1,))) as pred:
            engine = pred._engine
            pred.run([np.ones((1, 8), np.float32)])
        assert pred._engine is None
        assert engine.health()["status"] == "closed"

    def test_reshape_declares_and_enforces(self, artifact):
        _model, prefix = artifact
        pred = create_predictor(_config(prefix))
        h = pred.get_input_handle("feat")
        x = np.ones((3, 8), np.float32)
        h.reshape([3, 8])
        h.copy_from_cpu(x)
        h.reshape([-1, 8])
        h.copy_from_cpu(x)
        h.reshape([2, 8])
        with pytest.raises(ValueError, match="declared via reshape"):
            h.copy_from_cpu(x)
        with pytest.raises(ValueError, match="declared via reshape"):
            pred.get_input_handle("feat").copy_from_cpu(x)
        with pytest.raises(ValueError, match="declared via reshape"):
            h.copy_from_cpu(np.ones((2, 9), np.float32))

    def test_output_handle_bad_name_lists_valid(self, artifact):
        _model, prefix = artifact
        pred = create_predictor(_config(prefix))
        with pytest.raises(ValueError, match=r"valid output names: "
                                             r"\['output_0'\]"):
            pred.get_output_handle("logits")

    def test_positional_names_still_work_on_named_artifacts(self,
                                                            tmp_path):
        model = _mlp(seed=15)
        prefix = str(tmp_path / "named")
        save_exported(prefix, model.forward, list(
            model.state_dict(keep_vars=True).items()),
            [InputSpec([None, 8], "float32", name="feat")],
            output_names=["logits"])
        pred = create_predictor(_config(prefix))
        assert pred.get_output_names() == ["logits"]
        x = np.ones((2, 8), np.float32)
        pred.get_input_handle("feat").copy_from_cpu(x)
        pred.run()
        np.testing.assert_array_equal(
            pred.get_output_handle("output_0").copy_to_cpu(),
            pred.get_output_handle("logits").copy_to_cpu())
        with pytest.raises(ValueError, match="valid output names"):
            pred.get_output_handle("output_1")
        with pytest.raises(ValueError, match="valid output names"):
            pred.get_output_handle("logit")

    def test_results_do_not_alias_batch_buffer(self, artifact):
        _model, prefix = artifact
        with _engine(prefix, bucket_ladder=(16,),
                     batch_timeout_ms=1.0) as eng:
            (out,) = eng.predict(np.ones((2, 8), np.float32))
        assert out.shape == (2, 4)
        assert out.base is None or out.base.shape == out.shape

    def test_legacy_output_handle_validation(self, tmp_path):
        """A same-codebase artifact (no recorded output names): malformed
        names raise with the valid list."""
        model = nn.Sequential(nn.Linear(4, 4, device="cpu"))
        prefix = str(tmp_path / "leg")
        with pytest.warns(UserWarning, match="input_spec"):
            jit.save(model, prefix)
        pred = create_predictor(Config(prefix))
        with pytest.raises(ValueError, match="valid output names"):
            pred.get_output_handle("fetch/0")
        pred.run([np.ones((2, 4), np.float32)])
        with pytest.raises(ValueError, match="valid output names"):
            pred.get_output_handle("output_3")
        assert pred.get_output_handle("output_0").copy_to_cpu().shape == \
            (2, 4)
        with pytest.raises(ValueError, match="input_specs"):
            pred.as_engine()
        with pred.as_engine(input_specs=[InputSpec([None, 4])],
                            bucket_ladder=(2,)) as eng:
            np.testing.assert_array_equal(
                eng.predict(np.ones((2, 4), np.float32))[0],
                _eager(model, np.ones((2, 4), np.float32))[0])

    def test_config_knobs(self, artifact):
        _model, prefix = artifact
        cfg = Config(prefix + ".pdmodel", prefix + ".pdiparams")
        assert cfg.prog_file() == prefix + ".pdmodel"
        assert cfg.params_file() == prefix + ".pdiparams"
        cfg.enable_use_gpu(256, 1)
        assert cfg._device == torch.device("cuda", 1)
        cfg.disable_gpu()
        assert cfg._device == torch.device("cpu")
        cfg.enable_memory_optim()
        with pytest.warns(UserWarning, match="no effect"):
            cfg.switch_ir_optim(False)
        with pytest.warns(UserWarning, match="torch.set_num_threads"):
            cfg.set_cpu_math_library_num_threads(4)
        assert create_predictor(cfg).run(
            [np.ones((1, 8), np.float32)])[0].shape == (1, 4)

    def test_default_device_is_the_card(self, artifact):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present: the default is legal")
        _model, prefix = artifact
        with pytest.raises(RuntimeError, match="device='cpu'"):
            create_predictor(Config(prefix + ".pdmodel",
                                    prefix + ".pdiparams"))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            serving.Engine(prefix)
