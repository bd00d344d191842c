"""The port's serving host (cm3d_tpu_torch/serve.py): micro-batching over
its `.pt2` artifacts; the 26 tests of tests/test_serve.py on the port.

Pins the contract the module documents: grouped requests produce ONE
device call, per-slot outputs are independent of what shares the batch
(padding invariance), both wire formats work, and client errors are 400s.
Then the wire contract against the JAX package's server: the same JSON,
.npy and .npz bodies (plain and gzip) to JAX's server on JAX's artifact and
to the port's on the port's get the same status and the same answer
(detections within tests/test_torch_deploy.py's BOX_TOL on carried-over
parameters; the lift exact in counts, keep, labels and sizes, its trig
outputs within tests/test_torch_lift.py's TRIG), and ROADMAP C4 is pinned:
a gzip body of several members is served from its first, by both.
"""

import io
import json
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from test_deploy import _small_batch

from cm3d_tpu_torch.datasets.types import keyframe_from_numpy


@pytest.fixture(scope="module")
def served():
    """One tiny detect artifact + in-process oracle + running HTTP server."""
    import tempfile

    from cm3d_tpu_torch.config import class_arrays
    from cm3d_tpu_torch.deploy import detect_model, export_detect_step, save_artifact
    from cm3d_tpu_torch.pipelines.detect import make_detect_fn
    from cm3d_tpu_torch.serve import make_server
    from cm3d_tpu_torch.train import PillarConfig
    from cm3d_tpu_torch.train.train import model_tensors

    max_points, batch, top_k = 256, 2, 8
    tmp = tempfile.TemporaryDirectory()
    path = f"{tmp.name}/detect_b2.pt2"
    # score_thresh=0 so the random-init model keeps real detections
    save_artifact(
        export_detect_step(batch_size=batch, max_points=max_points,
                           top_k=top_k, score_thresh=0.0, device="cpu"),
        path,
    )

    # seeded weights, served and run in-process alike
    torch.manual_seed(0)
    model = detect_model()
    _, _, radii = class_arrays()
    oracle = make_detect_fn(model, PillarConfig(),
                            radii[: model.cfg.num_classes], top_k=top_k,
                            score_thresh=0.0)
    params, batch_stats = model_tensors(model)
    server = make_server(path, {k: v.detach() for k, v in params.items()}, batch_stats,
                         port=0, flush_ms=1000.0, verbose=False)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://127.0.0.1:%d" % server.server_address[1]

    def oracle_single(points):
        """Direct in-process call with the cloud alone in slot 0: the
        reference result a served request must match regardless of
        batching."""
        pts = np.zeros((batch, max_points, 4), np.float32)
        val = np.zeros((batch, max_points), bool)
        pts[0, : len(points)] = points
        val[0, : len(points)] = True
        boxes, scores, classes, keep = (
            a.numpy() for a in oracle(torch.from_numpy(pts), torch.from_numpy(val))
        )
        k = keep[0]
        return boxes[0][k], scores[0][k], classes[0][k]

    yield {"server": server, "url": url, "oracle_single": oracle_single,
           "max_points": max_points}

    server.shutdown()
    server.detect.close()
    server.server_close()
    tmp.cleanup()


def _cloud(seed, n=200):
    rng = np.random.default_rng(seed)
    pts = np.zeros((n, 4), np.float32)
    pts[:, :3] = rng.uniform(-40, 40, (n, 3))
    pts[:, 3] = rng.uniform(0, 1, n)
    return pts


def _post(url, body, content_type):
    req = urllib.request.Request(
        url + "/v1/detect", data=body,
        headers={"Content-Type": content_type},
    )
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def _post_json(url, points):
    return _post(url, json.dumps({"points": points.tolist()}).encode(),
                 "application/json")


def _post_npy(url, points):
    buf = io.BytesIO()
    np.save(buf, points)
    return _post(url, buf.getvalue(), "application/octet-stream")


def _check(resp, want):
    boxes, scores, classes = want
    assert resp["n_kept"] == len(scores)
    # JSON empty lists lose the trailing box axis; reshape before comparing.
    got_boxes = np.asarray(resp["boxes"], np.float32).reshape(-1, 7)
    np.testing.assert_array_equal(got_boxes, boxes)
    np.testing.assert_array_equal(np.asarray(resp["scores"], np.float32),
                                  scores)
    np.testing.assert_array_equal(np.asarray(resp["classes"]), classes)


def test_concurrent_requests_share_one_device_call(served):
    """Two concurrent requests (one JSON, one .npy) group into a single
    batched call, and each result matches its solo-oracle exactly."""
    stats0 = dict(served["server"].detect.stats)
    clouds = [_cloud(1), _cloud(2)]
    results = [None, None]

    def call(i, post):
        results[i] = post(served["url"], clouds[i])

    threads = [threading.Thread(target=call, args=(0, _post_json)),
               threading.Thread(target=call, args=(1, _post_npy))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()

    stats = served["server"].detect.stats
    assert stats["requests"] - stats0["requests"] == 2
    assert stats["batches"] - stats0["batches"] == 1  # micro-batched
    for cloud, resp in zip(clouds, results):
        _check(resp, served["oracle_single"](cloud))
    # the run produced real detections, not empty keeps
    assert sum(r["n_kept"] for r in results) > 0


def test_single_request_pads_without_changing_result(served):
    cloud = _cloud(3)
    resp = _post_json(served["url"], cloud)
    _check(resp, served["oracle_single"](cloud))


def test_healthz_reports_geometry(served):
    with urllib.request.urlopen(served["url"] + "/healthz", timeout=30) as r:
        h = json.loads(r.read())
    assert h["ok"] and h["batch_size"] == 2
    assert h["max_points"] == served["max_points"]
    assert h["stats"]["batches"] >= 1


@pytest.mark.parametrize("payload, ctype", [
    (b'{"points": "nope"}', "application/json"),
    (b"not npy", "application/octet-stream"),
])
def test_malformed_requests_are_400(served, payload, ctype):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(served["url"], payload, ctype)
    assert e.value.code == 400


def test_oversized_and_misshapen_clouds_are_400(served):
    too_many = np.zeros((served["max_points"] + 1, 4), np.float32)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post_json(served["url"], too_many)
    assert e.value.code == 400
    assert "capacity" in json.loads(e.value.read())["error"]

    with pytest.raises(urllib.error.HTTPError) as e:
        _post_json(served["url"], np.zeros((8, 3), np.float32))
    assert e.value.code == 400


def test_truncated_npy_body_is_400(served):
    buf = io.BytesIO()
    np.save(buf, _cloud(4))
    body = buf.getvalue()[:20]  # valid magic, cut mid-header
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(served["url"], body, "application/octet-stream")
    assert e.value.code == 400


def test_dispatch_failure_is_500(served):
    """A server-side failure must come back as a JSON 500, not a dropped
    connection with no status line."""
    detect = served["server"].detect
    orig = detect.submit

    def boom(points, timeout=60.0):
        raise RuntimeError("device fell over")

    detect.submit = boom
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post_json(served["url"], _cloud(5))
        assert e.value.code == 500
        msg = json.loads(e.value.read())["error"]
        # the exception TYPE is reported; the message text (possible
        # path/state leak) stays server-side
        assert "RuntimeError" in msg
        assert "device fell over" not in msg
    finally:
        detect.submit = orig


def test_unknown_route_is_404(served):
    req = urllib.request.Request(served["url"] + "/v1/nope", data=b"{}")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 404


def test_bad_content_length_is_400(served):
    req = urllib.request.Request(
        served["url"] + "/v1/detect", data=b"{}",
        headers={"Content-Type": "application/json"},
    )
    # urllib would set a correct header; force a malformed one
    req.add_unredirected_header("Content-Length", "banana")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400
    assert "Content-Length" in json.loads(e.value.read())["error"]


def test_npz_body_on_detect_route_is_400(served):
    buf = io.BytesIO()
    np.savez(buf, points=_cloud(6))
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(served["url"], buf.getvalue(), "application/octet-stream")
    assert e.value.code == 400
    assert "npz" in json.loads(e.value.read())["error"]


# ---- lift serving ------------------------------------------------------


@pytest.fixture(scope="module")
def served_lift():
    """Tiny lift artifact + in-process oracle + running HTTP server.

    Uses the same SMALL preset as tests/test_torch_deploy.py so the
    artifact is cheap; batch 2 exercises micro-batching and padding
    invariance."""
    import tempfile

    from test_torch_deploy import SMALL

    from cm3d_tpu_torch.deploy import export_lift_step, save_artifact
    from cm3d_tpu_torch.parallel import make_keyframe_step_fn
    from cm3d_tpu_torch.serve import artifact_kind, make_lift_server

    tmp = tempfile.TemporaryDirectory()
    path = f"{tmp.name}/lift_b2.pt2"
    save_artifact(export_lift_step(SMALL, batch_size=2, device="cpu"), path)
    assert artifact_kind(path) == "lift"

    server = make_lift_server(path, port=0, flush_ms=1000.0, verbose=False)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://127.0.0.1:%d" % server.server_address[1]

    step = make_keyframe_step_fn(SMALL, device="cpu")

    def oracle_single(frame_idx, seed=0):
        """In-process step on the full batch: per-slot truth."""
        _, boxes = step(keyframe_from_numpy(_small_batch(batch=2, seed=seed), "cpu"))
        k = boxes.keep[frame_idx].numpy()
        out = np.concatenate(
            [boxes.centers[frame_idx].numpy()[k],
             boxes.sizes[frame_idx].numpy()[k],
             boxes.yaws[frame_idx].numpy()[k][:, None]], axis=1,
        )
        return (out, boxes.scores[frame_idx].numpy()[k],
                boxes.labels[frame_idx].numpy()[k])

    yield {"server": server, "url": url, "oracle_single": oracle_single,
           "cfg": SMALL, "tmp": tmp}
    server.shutdown()
    server.backend.close()
    server.server_close()
    tmp.cleanup()


def _frame_npz_body(frame) -> bytes:
    from cm3d_tpu_torch.serve import _keyframe_fields

    buf = io.BytesIO()
    np.savez(buf, **_keyframe_fields(frame))
    return buf.getvalue()


def _post_lift(url, body, content_type="application/octet-stream"):
    req = urllib.request.Request(
        url + "/v1/lift", data=body,
        headers={"Content-Type": content_type},
    )
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())


def test_lift_request_matches_in_process_step(served_lift):
    """A served keyframe (npz wire format) returns exactly the boxes the
    in-process step produces for that slot, padding slot ignored."""
    batch = _small_batch(batch=2, seed=0)
    frame0 = type(batch.frames)(*[
        np.asarray(x)[0] if not hasattr(x, "_asdict")
        else type(x)(*[np.asarray(c)[0] for c in x])
        for x in batch.frames
    ])
    resp = _post_lift(served_lift["url"], _frame_npz_body(frame0))

    # oracle slot 0 of a batch whose OTHER slot differs from the server's
    # zero padding — per-slot independence makes both match
    boxes, scores, classes = served_lift["oracle_single"](0, seed=0)
    got = np.asarray(resp["boxes"], np.float32).reshape(-1, 7)
    np.testing.assert_array_equal(got, boxes.astype(np.float32))
    np.testing.assert_array_equal(
        np.asarray(resp["scores"], np.float32), scores.astype(np.float32)
    )
    np.testing.assert_array_equal(np.asarray(resp["classes"]), classes)
    assert resp["n_kept"] == len(scores)
    assert resp["n_masks_with_points"] >= resp["n_kept"]
    assert resp["n_kept"] > 0  # the artifact does real work


def test_lift_healthz_reports_fields(served_lift):
    with urllib.request.urlopen(served_lift["url"] + "/healthz",
                                timeout=30) as r:
        h = json.loads(r.read())
    assert h["ok"] and h["route"] == "/v1/lift" and h["batch_size"] == 2
    cfg = served_lift["cfg"]
    assert h["fields"]["points"]["shape"] == [cfg.max_points, 4]
    assert h["fields"]["cameras.intrinsics"]["shape"][-2:] == [3, 3]


def test_lift_unknown_field_is_400(served_lift):
    buf = io.BytesIO()
    np.savez(buf, pointz=np.zeros((4, 4), np.float32))
    with pytest.raises(urllib.error.HTTPError) as e:
        _post_lift(served_lift["url"], buf.getvalue())
    assert e.value.code == 400
    assert "pointz" in json.loads(e.value.read())["error"]


def test_lift_bad_shape_is_400(served_lift):
    cfg = served_lift["cfg"]
    buf = io.BytesIO()
    np.savez(buf, points=np.zeros((cfg.max_points + 1, 4), np.float32))
    with pytest.raises(urllib.error.HTTPError) as e:
        _post_lift(served_lift["url"], buf.getvalue())
    assert e.value.code == 400

    buf = io.BytesIO()
    np.savez(buf, ego_translation=np.zeros(4, np.float32))
    with pytest.raises(urllib.error.HTTPError) as e:
        _post_lift(served_lift["url"], buf.getvalue())
    assert e.value.code == 400
    assert "ego_translation" in json.loads(e.value.read())["error"]


def test_lift_npy_body_is_400(served_lift):
    buf = io.BytesIO()
    np.save(buf, np.zeros((4, 4), np.float32))
    with pytest.raises(urllib.error.HTTPError) as e:
        _post_lift(served_lift["url"], buf.getvalue())
    assert e.value.code == 400
    assert "npz" in json.loads(e.value.read())["error"]


def test_lift_partial_points_derive_validity(served_lift):
    """points sent [n <= N] with no point_valid: the server pads and
    marks exactly the sent rows valid — same result as explicit mask."""
    from cm3d_tpu_torch.serve import _keyframe_fields

    cfg = served_lift["cfg"]
    batch = _small_batch(batch=1, seed=1)
    fields = {
        k: np.asarray(v)[0]
        for k, v in _keyframe_fields(batch.frames).items()
    }
    # truncate to n points: the explicit request zeroes the tail and
    # masks it invalid; the partial request just sends the first n rows
    # — the server must reconstruct the identical device input
    n = cfg.max_points // 2
    explicit = dict(fields)
    explicit["points"] = fields["points"].copy()
    explicit["points"][n:] = 0
    explicit["point_valid"] = np.zeros(cfg.max_points, bool)
    explicit["point_valid"][:n] = True
    partial = dict(fields)
    partial["points"] = explicit["points"][:n]
    del partial["point_valid"]

    def post(d):
        buf = io.BytesIO()
        np.savez(buf, **d)
        return _post_lift(served_lift["url"], buf.getvalue())

    a, b = post(explicit), post(partial)
    assert a == b


def test_lift_accepts_compressed_npz(served_lift):
    """np.savez_compressed bodies work identically (np.load handles both
    formats) — the ~12 MB keyframe payload is mostly sparse mask planes,
    so compression is the client-side lever against upload-bound latency."""
    from cm3d_tpu_torch.serve import _keyframe_fields

    batch = _small_batch(batch=1, seed=3)
    fields = {k: np.asarray(v)[0]
              for k, v in _keyframe_fields(batch.frames).items()}

    raw, comp = io.BytesIO(), io.BytesIO()
    np.savez(raw, **fields)
    np.savez_compressed(comp, **fields)
    assert len(comp.getvalue()) < len(raw.getvalue())
    a = _post_lift(served_lift["url"], raw.getvalue())
    b = _post_lift(served_lift["url"], comp.getvalue())
    assert a == b


def test_oversized_content_length_is_413(served):
    """An attacker-controlled Content-Length beyond the server cap is
    refused (413) BEFORE the body is read — no unbounded allocation."""
    big = served["server"].max_body_bytes + 1
    req = urllib.request.Request(
        served["url"] + "/v1/detect", data=b"{}",
        headers={"Content-Type": "application/json"},
    )
    req.add_unredirected_header("Content-Length", str(big))
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 413
    assert "limit" in json.loads(e.value.read())["error"]


def test_negative_content_length_is_400(served):
    req = urllib.request.Request(
        served["url"] + "/v1/detect", data=b"{}",
        headers={"Content-Type": "application/json"},
    )
    req.add_unredirected_header("Content-Length", "-5")
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400


def test_lift_partial_points_with_overreaching_mask_is_400(served_lift):
    """A partial points stream accompanied by a point_valid mask marking
    rows beyond the sent count is rejected: zero-filled phantom points
    must not silently enter the lift."""
    from cm3d_tpu_torch.serve import _keyframe_fields

    cfg = served_lift["cfg"]
    batch = _small_batch(batch=1, seed=1)
    fields = {k: np.asarray(v)[0]
              for k, v in _keyframe_fields(batch.frames).items()}
    n = cfg.max_points // 2
    bad = dict(fields)
    bad["points"] = fields["points"][:n]
    bad["point_valid"] = np.ones(cfg.max_points, bool)  # over-marks
    buf = io.BytesIO()
    np.savez(buf, **bad)
    with pytest.raises(urllib.error.HTTPError) as e:
        _post_lift(served_lift["url"], buf.getvalue())
    assert e.value.code == 400
    assert "phantom" in json.loads(e.value.read())["error"]

    # a consistent explicit mask alongside partial data stays accepted
    ok = dict(fields)
    ok["points"] = fields["points"][:n]
    ok["point_valid"] = np.zeros(cfg.max_points, bool)
    ok["point_valid"][:n] = True
    buf = io.BytesIO()
    np.savez(buf, **ok)
    assert "boxes" in _post_lift(served_lift["url"], buf.getvalue())


def test_lift_gzip_content_encoding(served_lift):
    """Transport compression: a gzip level-1 body (Content-Encoding:
    gzip) returns exactly the plain-body response."""
    import gzip

    batch = _small_batch(batch=1, seed=5)
    body = _frame_npz_body(type(batch.frames)(*[
        np.asarray(x)[0] if not hasattr(x, "_asdict")
        else type(x)(*[np.asarray(c)[0] for c in x])
        for x in batch.frames
    ]))
    plain = _post_lift(served_lift["url"], body)
    gz = gzip.compress(body, compresslevel=1)
    assert len(gz) < len(body)
    req = urllib.request.Request(
        served_lift["url"] + "/v1/lift", data=gz,
        headers={"Content-Type": "application/octet-stream",
                 "Content-Encoding": "gzip"},
    )
    with urllib.request.urlopen(req, timeout=300) as r:
        assert json.loads(r.read()) == plain


def _post_encoded(served, payload, encoding):
    req = urllib.request.Request(
        served["url"] + "/v1/detect", data=payload,
        headers={"Content-Type": "application/json",
                 "Content-Encoding": encoding},
    )
    return urllib.request.urlopen(req, timeout=30)


def test_decompression_bomb_is_rejected(served):
    """A small gzip body expanding past the body cap must be refused
    without allocating the expansion."""
    import gzip

    bomb = gzip.compress(
        b"\0" * (served["server"].max_body_bytes + 1024), compresslevel=9
    )
    assert len(bomb) < served["server"].max_body_bytes
    with pytest.raises(urllib.error.HTTPError) as e:
        _post_encoded(served, bomb, "gzip")
    assert e.value.code == 400
    assert "limit" in json.loads(e.value.read())["error"]


def test_corrupt_and_unsupported_encodings_are_400(served):
    with pytest.raises(urllib.error.HTTPError) as e:
        _post_encoded(served, b"not gzip at all", "gzip")
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post_encoded(served, b"{}", "br")
    assert e.value.code == 400
    assert "Content-Encoding" in json.loads(e.value.read())["error"]


def test_lift_batch_buckets(tmp_path):
    """A lift server over {batch-1, batch-2} bucket artifacts dispatches
    a singleton request through the batch-1 artifact (no padded-batch
    upload) and a concurrent pair through batch-2 — results identical to
    the single-artifact server's."""
    import threading as _threading

    from test_torch_deploy import SMALL

    from cm3d_tpu_torch.deploy import export_lift_step, save_artifact
    from cm3d_tpu_torch.serve import make_lift_server

    p1 = tmp_path / "lift_b1.pt2"
    p2 = tmp_path / "lift_b2.pt2"
    save_artifact(export_lift_step(SMALL, batch_size=1, device="cpu"), p1)
    save_artifact(export_lift_step(SMALL, batch_size=2, device="cpu"), p2)
    server = make_lift_server([str(p1), str(p2)], port=0,
                              flush_ms=300.0, verbose=False)
    thread = _threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    url = "http://127.0.0.1:%d" % server.server_address[1]
    try:
        with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
            h = json.loads(r.read())
        assert h["batch_buckets"] == [1, 2] and h["batch_size"] == 2

        batch = _small_batch(batch=2, seed=7)
        frames = [
            type(batch.frames)(*[
                np.asarray(x)[i] if not hasattr(x, "_asdict")
                else type(x)(*[np.asarray(c)[i] for c in x])
                for x in batch.frames
            ])
            for i in range(2)
        ]
        bodies = [_frame_npz_body(f) for f in frames]

        # singleton -> batch-1 bucket (flush_ms elapses with 1 queued)
        r0 = _post_lift(url, bodies[0])
        # concurrent pair -> batch-2 bucket, same per-slot results
        results = [None, None]

        def post(i):
            results[i] = _post_lift(url, bodies[i])

        b0 = server.backend.stats["batches"]
        ts = [_threading.Thread(target=post, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        assert server.backend.stats["batches"] == b0 + 1  # one device call
        assert results[0] == r0  # bucket choice does not change results
        assert results[1]["n_kept"] >= 0
    finally:
        server.shutdown()
        server.backend.close()
        server.server_close()


def test_lift_bucket_geometry_mismatch_rejected(tmp_path):
    import dataclasses

    from test_torch_deploy import SMALL

    from cm3d_tpu_torch.deploy import export_lift_step, save_artifact
    from cm3d_tpu_torch.serve import LiftServer

    p1 = tmp_path / "a.pt2"
    p2 = tmp_path / "b.pt2"
    save_artifact(export_lift_step(SMALL, batch_size=1, device="cpu"), p1)
    other = dataclasses.replace(SMALL, max_points=SMALL.max_points // 2)
    save_artifact(export_lift_step(other, batch_size=2, device="cpu"), p2)
    with pytest.raises(ValueError, match="geometry"):
        LiftServer([str(p1), str(p2)])


def test_lift_mask_without_stream_is_400(served_lift):
    """The mirror phantom hole: a point_valid mask sent WITHOUT points
    would mark zero-filled slots valid."""
    cfg = served_lift["cfg"]
    buf = io.BytesIO()
    np.savez(buf, point_valid=np.ones(cfg.max_points, bool))
    with pytest.raises(urllib.error.HTTPError) as e:
        _post_lift(served_lift["url"], buf.getvalue())
    assert e.value.code == 400
    assert "no points were sent" in json.loads(e.value.read())["error"]

    # an all-False mask without the stream stays acceptable (explicitly
    # empty cloud)
    buf = io.BytesIO()
    np.savez(buf, point_valid=np.zeros(cfg.max_points, bool))
    assert "boxes" in _post_lift(served_lift["url"], buf.getvalue())


# ---- the wire contract against the JAX package's server ------------------


def _start(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return "http://127.0.0.1:%d" % server.server_address[1]


def _stop(server):
    server.shutdown()
    server.backend.close()
    server.server_close()


def _request(url, route, body, ctype, encoding=""):
    """(status, parsed JSON body) of one POST, errors included."""
    headers = {"Content-Type": ctype}
    if encoding:
        headers["Content-Encoding"] = encoding
    req = urllib.request.Request(url + route, data=body, headers=headers)
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module")
def jax_and_port_detect(tmp_path_factory):
    """JAX's server on JAX's detect artifact with PRNGKey(0) parameters,
    and the port's server on the port's artifact with those parameters
    carried over (models/convert.py centerpoint_state_dict_from_flax)."""
    from test_torch_deploy import jax_centerpoint

    from cm3d_tpu.deploy import export_detect_step as jexport
    from cm3d_tpu.deploy import save_artifact as jsave
    from cm3d_tpu.serve import make_server as jmake_server
    from cm3d_tpu_torch.deploy import export_detect_step, save_artifact
    from cm3d_tpu_torch.serve import make_server

    variables, params, stats = jax_centerpoint()
    tmp = tmp_path_factory.mktemp("parity_detect")
    kw = dict(batch_size=2, max_points=256, top_k=8, score_thresh=0.0)
    jpath = jsave(jexport(**kw), tmp / "d.stablehlo")
    path = save_artifact(export_detect_step(device="cpu", **kw), tmp / "d.pt2")
    servers = (jmake_server(str(jpath), variables["params"], variables["batch_stats"],
                            port=0, flush_ms=50.0, verbose=False),
               make_server(str(path), params, stats, port=0, flush_ms=50.0, verbose=False))
    yield [_start(s) for s in servers]
    for s in servers:
        _stop(s)


def _gzip_members(*bodies):
    import gzip

    return b"".join(gzip.compress(b, compresslevel=1) for b in bodies)


def _detect_bodies():
    """(name, body, content type, encoding) of the detect wire formats,
    good and bad, and of a gzip body of two members (ROADMAP C4)."""
    import gzip

    cloud = _cloud(11)
    js = json.dumps({"points": cloud.tolist()}).encode()
    buf = io.BytesIO()
    np.save(buf, _cloud(12))
    npy = buf.getvalue()
    npz = io.BytesIO()
    np.savez(npz, points=cloud)
    return [
        ("json", js, "application/json", ""),
        ("npy", npy, "application/octet-stream", ""),
        ("json gzip", gzip.compress(js, compresslevel=1), "application/json", "gzip"),
        ("npy gzip", gzip.compress(npy, compresslevel=1), "application/octet-stream", "gzip"),
        ("two gzip members", _gzip_members(npy, b"trailing member"),
         "application/octet-stream", "gzip"),
        ("npz on detect", npz.getvalue(), "application/octet-stream", ""),
        ("bad json", b'{"points": "nope"}', "application/json", ""),
        ("misshapen", json.dumps({"points": [[0.0, 1.0, 2.0]]}).encode(),
         "application/json", ""),
        ("over capacity", json.dumps({"points": np.zeros((257, 4)).tolist()}).encode(),
         "application/json", ""),
        ("truncated npy", npy[:20], "application/octet-stream", ""),
        ("corrupt gzip", b"not gzip at all", "application/json", "gzip"),
        ("brotli", js, "application/json", "br"),
    ]


def _assert_same_detect_answer(got, want):
    from test_torch_deploy import BOX_TOL

    assert got.keys() == want.keys()
    assert got["n_kept"] == want["n_kept"] and got["classes"] == want["classes"]
    boxes = np.asarray(got["boxes"], np.float32).reshape(-1, 7)
    jboxes = np.asarray(want["boxes"], np.float32).reshape(-1, 7)
    np.testing.assert_allclose(boxes[:, :3], jboxes[:, :3], atol=BOX_TOL["translation"])
    np.testing.assert_allclose(boxes[:, 3:6], jboxes[:, 3:6], rtol=BOX_TOL["size"])
    np.testing.assert_allclose(boxes[:, 6], jboxes[:, 6], atol=BOX_TOL["yaw"])
    np.testing.assert_allclose(got["scores"], want["scores"], atol=BOX_TOL["score"])


def test_detect_wire_contract_matches_jax(jax_and_port_detect):
    """Every detect body gets the JAX server's status from the port's;
    answers agree within BOX_TOL and error messages word for word. The
    two-member gzip body is answered from its first member (C4)."""
    jurl, url = jax_and_port_detect
    answers = {}
    for name, body, ctype, enc in _detect_bodies():
        jstatus, jresp = _request(jurl, "/v1/detect", body, ctype, enc)
        status, resp = _request(url, "/v1/detect", body, ctype, enc)
        assert status == jstatus, (name, resp, jresp)
        if status == 200:
            _assert_same_detect_answer(resp, jresp)
            answers[name] = resp
        else:
            assert resp == jresp, name
    assert answers["npy gzip"] == answers["npy"]
    assert answers["two gzip members"] == answers["npy"]  # C4: the rest is ignored
    assert answers["json"]["n_kept"] > 0
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        h = json.loads(r.read())
    with urllib.request.urlopen(jurl + "/healthz", timeout=30) as r:
        jh = json.loads(r.read())
    for key in ("ok", "route", "batch_size", "max_points"):
        assert h[key] == jh[key]


@pytest.fixture(scope="module")
def jax_and_port_lift(tmp_path_factory):
    """JAX's and the port's lift servers on their SMALL batch-2 artifacts."""
    from test_deploy import SMALL as JSMALL
    from test_torch_deploy import SMALL

    from cm3d_tpu.deploy import export_lift_step as jexport
    from cm3d_tpu.deploy import save_artifact as jsave
    from cm3d_tpu.serve import make_lift_server as jmake_lift_server
    from cm3d_tpu_torch.deploy import export_lift_step, save_artifact
    from cm3d_tpu_torch.serve import make_lift_server

    tmp = tmp_path_factory.mktemp("parity_lift")
    jpath = jsave(jexport(JSMALL, batch_size=2), tmp / "l.stablehlo")
    path = save_artifact(export_lift_step(SMALL, batch_size=2, device="cpu"), tmp / "l.pt2")
    servers = (jmake_lift_server(str(jpath), port=0, flush_ms=50.0, verbose=False),
               make_lift_server(str(path), port=0, flush_ms=50.0, verbose=False))
    yield [_start(s) for s in servers]
    for s in servers:
        _stop(s)


def _lift_bodies():
    import gzip

    from cm3d_tpu_torch.serve import _keyframe_fields

    fields = {k: np.asarray(v)[0]
              for k, v in _keyframe_fields(_small_batch(batch=1, seed=9).frames).items()}
    assert fields["mask_bits"].dtype == np.uint32  # the wire's words
    raw, comp = io.BytesIO(), io.BytesIO()
    np.savez(raw, **fields)
    np.savez_compressed(comp, **fields)
    partial = dict(fields, points=fields["points"][:300])
    del partial["point_valid"]
    buf = io.BytesIO()
    np.savez(buf, **partial)
    js = json.dumps({k: v.tolist() for k, v in fields.items()
                     if k not in ("mask_bits",)}).encode()
    bad = io.BytesIO()
    np.savez(bad, pointz=np.zeros((4, 4), np.float32))
    npy = io.BytesIO()
    np.save(npy, fields["points"])
    return [
        ("npz", raw.getvalue(), "application/octet-stream", ""),
        ("npz compressed", comp.getvalue(), "application/octet-stream", ""),
        ("npz gzip", gzip.compress(raw.getvalue(), compresslevel=1),
         "application/octet-stream", "gzip"),
        ("two gzip members", _gzip_members(raw.getvalue(), b"trailing member"),
         "application/octet-stream", "gzip"),
        ("partial points", buf.getvalue(), "application/octet-stream", ""),
        ("json without masks", js, "application/json", ""),
        ("unknown field", bad.getvalue(), "application/octet-stream", ""),
        ("npy body", npy.getvalue(), "application/octet-stream", ""),
    ]


def test_lift_wire_contract_matches_jax(jax_and_port_lift):
    """Every lift body gets the JAX server's status and answer from the
    port's (uint32 mask words reinterpreted as int32 bit patterns at the
    batch), /healthz the same field inventory (mask_bits as uint32), and
    the two-member gzip body is answered from its first member (C4)."""
    from test_torch_lift import TRIG

    jurl, url = jax_and_port_lift
    answers = {}
    for name, body, ctype, enc in _lift_bodies():
        jstatus, jresp = _request(jurl, "/v1/lift", body, ctype, enc)
        status, resp = _request(url, "/v1/lift", body, ctype, enc)
        assert status == jstatus, (name, resp, jresp)
        if status != 200:
            assert resp == jresp, name
            continue
        assert resp.keys() == jresp.keys()
        for key in ("n_kept", "classes", "n_masks_with_points", "n_truncated"):
            assert resp[key] == jresp[key], (name, key)
        boxes = np.asarray(resp["boxes"], np.float32).reshape(-1, 7)
        jboxes = np.asarray(jresp["boxes"], np.float32).reshape(-1, 7)
        np.testing.assert_array_equal(boxes[:, 3:6], jboxes[:, 3:6])  # sizes: exact
        np.testing.assert_allclose(boxes[:, [0, 1, 2, 6]], jboxes[:, [0, 1, 2, 6]], **TRIG)
        np.testing.assert_allclose(resp["scores"], jresp["scores"], **TRIG)
        answers[name] = resp
    assert answers["npz"]["n_kept"] > 0
    assert answers["npz gzip"] == answers["npz"] == answers["npz compressed"]
    assert answers["two gzip members"] == answers["npz"]  # C4
    with urllib.request.urlopen(url + "/healthz", timeout=30) as r:
        h = json.loads(r.read())
    with urllib.request.urlopen(jurl + "/healthz", timeout=30) as r:
        jh = json.loads(r.read())
    assert h["fields"] == jh["fields"]
    assert h["fields"]["mask_bits"]["dtype"] == "uint32"
    for key in ("ok", "route", "batch_size", "batch_buckets"):
        assert h[key] == jh[key]


def test_trailing_gzip_members_are_ignored_as_in_jax():
    """ROADMAP C4, copied from the JAX package and pinned: _decompress_body
    stops at the end of the first gzip member and drops the rest (a
    corrupt or oversized second member included), in both packages."""
    from cm3d_tpu.serve import _decompress_body as jdecompress

    from cm3d_tpu_torch.serve import _decompress_body

    body = _gzip_members(b"first", b"second member")
    assert _decompress_body(body, "gzip", 1 << 20) == jdecompress(body, "gzip", 1 << 20) \
        == b"first"
    body = _gzip_members(b"first") + b"\x1f\x8b corrupt"
    assert _decompress_body(body, "gzip", 1 << 20) == b"first"
    big = _gzip_members(b"first", b"\0" * 4096)
    assert _decompress_body(big, "gzip", 1024) == jdecompress(big, "gzip", 1024) == b"first"
