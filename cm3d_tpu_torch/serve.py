"""Serving host for cm3d_tpu_torch artifacts: HTTP + micro-batching.
Mirrors `cm3d_tpu/serve.py`; its wire contract is the JAX package's, so a
client gets the same answer from either server.

`python -m cm3d_tpu_torch.serve` is the online half of the deployment path
started by `python -m cm3d_tpu_torch.deploy`: it loads a *detect* artifact
(a `torch.export` program whose parameters are runtime INPUTS, so one
artifact serves every same-shape checkpoint) plus a checkpoint directory of
the port's (`models/checkpoints.py`, the format `run_pretrain` writes), and
serves point clouds over HTTP.

Serving shape: the program is traced for ONE static batch size B, so the
host runs a micro-batching dispatcher: requests queue, a single dispatcher
thread groups up to B of them within a flush window, pads empty slots with
valid=False rows, and issues ONE device call per group. Per-slot outputs
are independent (the step is batched sample by sample), so padding slots
never change a request's result; tests/test_torch_serve.py pins that
invariance.

Request formats (POST /v1/detect):
- ``application/json``: ``{"points": [[x, y, z, intensity], ...]}``
- anything else: the body is a ``.npy`` blob of a float32 [n, 4] array
  (``np.save``; no JSON float printing).
Response: ``{"boxes": [[x,y,z,w,l,h,yaw]...], "scores": [...],
"classes": [...], "n_kept": k}``: kept detections only, ego frame.

``--artifact`` may also be a *lift* artifact (``deploy --what lift``,
recognised from the artifact's own input structure): the server then hosts
the pseudo-label lift step at POST /v1/lift. One request = ONE keyframe,
sent as an ``.npz`` body (``np.savez``) whose keys are Keyframe fields
(camera calibration as ``cameras.<field>``); missing keys zero-fill
(validity masks default False), ``points`` / ``lane_points`` may be sent
partial ([n <= N, ...]) with their valid masks derived. ``mask_bits`` are
uint32 words on the wire, as in the JAX package, and ride to the device as
the port's int32 bit patterns (datasets/types.py). Response: the same
boxes/scores/classes contract plus lift diagnostics (mask/truncation
counts). Requests micro-batch into the program's static keyframe batch
exactly like detect. ``GET /healthz`` reports the artifact kind/geometry
and serving counters.

Wire and batching levers, as in the JAX package: lift accepts batch-BUCKET
artifact lists (a singleton request rides the batch-1 artifact instead of
uploading a zero-padded max batch), and both routes accept
``Content-Encoding: gzip|deflate`` bodies (bounded decompression). As in
the JAX package, a gzip body of several members is served from its first
member; the rest is ignored (ROADMAP C4, pinned by
tests/test_torch_serve.py).
"""

from __future__ import annotations

import argparse
import io
import json
import queue
import threading
import zipfile
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Any, NamedTuple, Optional

import numpy as np
import torch


class RequestError(ValueError):
    """Client-side error (HTTP 400): malformed or oversized request."""


@dataclass
class _Pending:
    payload: Any  # validated per-request payload (kind-specific)
    done: threading.Event = field(default_factory=threading.Event)
    result: Optional[dict] = None
    error: Optional[BaseException] = None


class _MicroBatchServer:
    """Micro-batching executor over one static-batch artifact.

    Owns the single dispatcher thread that talks to the device; any number
    of request threads call :meth:`submit` concurrently. ``flush_ms`` is
    the max time the dispatcher waits to fill a batch after the first
    request of a group arrives (latency/occupancy knob). Subclasses
    implement :meth:`validate` (request thread, raises RequestError) and
    :meth:`_execute` (dispatcher thread: one device call for the group,
    fills each pending.result)."""

    route: str  # HTTP route this executor serves

    def __init__(self, batch_size: int, flush_ms: float):
        self.batch_size = int(batch_size)
        self.flush_ms = float(flush_ms)
        self.stats = {"requests": 0, "batches": 0, "slots_used": 0,
                      "last_batch_ms": 0.0}
        self._queue: queue.Queue[_Pending] = queue.Queue()
        self._closed = False
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="cm3d-serve-dispatch",
                                        daemon=True)
        self._thread.start()

    # ---- request side -------------------------------------------------

    def validate(self, payload):  # pragma: no cover - abstract
        raise NotImplementedError

    def submit(self, payload, timeout: float = 60.0) -> dict:
        """Block until the batched device call returns this request's
        result dict."""
        if self._closed:
            raise RuntimeError("server is closed")
        pending = _Pending(self.validate(payload))
        self._queue.put(pending)
        if not pending.done.wait(timeout):
            raise TimeoutError("device call did not return in time")
        if pending.error is not None:
            raise pending.error
        assert pending.result is not None
        return pending.result

    def close(self) -> None:
        self._closed = True
        self._queue.put(None)  # type: ignore[arg-type]  # wake the loop
        self._thread.join(timeout=10)

    # ---- device side (single thread) ----------------------------------

    def _execute(self, group: list) -> None:  # pragma: no cover - abstract
        raise NotImplementedError

    def _dispatch_loop(self) -> None:
        while True:
            first = self._queue.get()
            if first is None:
                return
            group = [first]
            # fill the batch for up to flush_ms after the first arrival
            deadline = _now() + self.flush_ms / 1e3
            while len(group) < self.batch_size:
                try:
                    nxt = self._queue.get(timeout=max(0.0, deadline - _now()))
                except queue.Empty:
                    break
                if nxt is None:
                    self._run_group(group)
                    return
                group.append(nxt)
            self._run_group(group)

    def _run_group(self, group: list) -> None:
        t0 = _now()
        try:
            self._execute(group)
        except BaseException as e:  # propagate to every waiter
            for pending in group:
                pending.error = e
        finally:
            self.stats["requests"] += len(group)
            self.stats["batches"] += 1
            self.stats["slots_used"] += len(group)
            self.stats["last_batch_ms"] = round((_now() - t0) * 1e3, 3)
            for pending in group:
                pending.done.set()


class DetectServer(_MicroBatchServer):
    """Micro-batching executor over a detect artifact."""

    route = "/v1/detect"

    def __init__(self, artifact_path: str | Path, params: Any,
                 batch_stats: Any = None, flush_ms: float = 5.0):
        import torch.utils._pytree as pytree

        from cm3d_tpu_torch.deploy import load_artifact

        self._artifact = load_artifact(artifact_path)
        avals = self._artifact.in_avals
        # Locate the batch geometry from the artifact's own inputs: the
        # validity mask is the unique bool input, shaped [B, max_points].
        bool_avals = [a for a in avals if a.dtype == torch.bool]
        if len(bool_avals) != 1 or len(bool_avals[0].shape) != 2:
            raise ValueError(
                "not a detect artifact: expected exactly one [B, N] bool "
                f"valid-mask input, got avals {avals}"
            )
        batch_size, self.max_points = map(int, bool_avals[0].shape)
        # Camera-fusion artifacts take 3 extra operands; serving those
        # needs per-request images, which this host does not accept.
        batch_stats = batch_stats or {}
        n_leaves = len(pytree.tree_leaves((params, batch_stats)))
        if len(avals) != n_leaves + 2:
            raise ValueError(
                "artifact expects operands beyond (params, batch_stats, "
                "points, valid) — camera-fusion artifacts are not servable "
                "by this host"
            )
        (want_params, want_stats, *_), _ = pytree.tree_unflatten(
            avals, self._artifact.in_tree)
        for what, got, want in (("params", params, want_params),
                                ("batch_stats", batch_stats, want_stats)):
            if set(got) != set(want):
                raise ValueError(
                    f"checkpoint {what} do not fit the artifact: missing "
                    f"{sorted(set(want) - set(got))[:8]}, extra "
                    f"{sorted(set(got) - set(want))[:8]}")
        self.device = _artifact_device(self._artifact)

        self._params, self._batch_stats = (
            {k: torch.as_tensor(v).detach().to(self.device) for k, v in tree.items()}
            for tree in (params, batch_stats))
        super().__init__(batch_size, flush_ms)

    def validate(self, points: np.ndarray) -> np.ndarray:
        points = np.asarray(points, np.float32)
        if points.ndim != 2 or points.shape[1] != 4:
            raise RequestError(
                f"points must be [n, 4] (x, y, z, intensity); got "
                f"{points.shape}"
            )
        if len(points) > self.max_points:
            raise RequestError(
                f"{len(points)} points exceeds the artifact capacity "
                f"{self.max_points}; re-export with a larger --max_points"
            )
        return points

    def _execute(self, group: list) -> None:
        pts = np.zeros((self.batch_size, self.max_points, 4), np.float32)
        val = np.zeros((self.batch_size, self.max_points), bool)
        for j, pending in enumerate(group):
            n = len(pending.payload)
            pts[j, :n] = pending.payload
            val[j, :n] = True
        from cm3d_tpu_torch.utils.fetch import device_fetch

        boxes, scores, classes, keep = device_fetch(tuple(self._artifact.call(
            self._params, self._batch_stats,
            torch.from_numpy(pts).to(self.device), torch.from_numpy(val).to(self.device))))
        for j, pending in enumerate(group):
            k = keep[j]
            pending.result = {
                "boxes": boxes[j][k],
                "scores": scores[j][k],
                "classes": classes[j][k],
            }


def _keyframe_fields(frames) -> dict:
    """Flatten a Keyframe(-of-avals or -of-arrays) into the wire naming:
    top-level fields by name, camera calibration as ``cameras.<field>``."""
    out = {}
    for name, v in frames._asdict().items():
        if hasattr(v, "_asdict"):  # CameraParams
            for cn, cv in v._asdict().items():
                out[f"{name}.{cn}"] = cv
        else:
            out[name] = v
    return out


class _WireField(NamedTuple):
    """A Keyframe field on the wire: its batched shape and numpy dtype."""

    shape: tuple
    dtype: np.dtype


def _wire_field(name: str, aval) -> _WireField:
    """The wire dtype of an artifact input: the torch dtype's numpy name,
    except the mask words, which are uint32 on the wire (the JAX package's
    layout, and the port's host keyframes') and int32 bit patterns in the
    port's programs."""
    dtype = np.dtype(str(aval.dtype).removeprefix("torch."))
    if name == "mask_bits":
        dtype = np.dtype(np.uint32)
    return _WireField(tuple(aval.shape), dtype)


def _artifact_device(artifact) -> torch.device:
    """The device an artifact's program runs on (its one platform)."""
    from cm3d_tpu_torch.utils.device import resolve_device

    (platform,) = artifact.platforms
    return resolve_device(platform)


# Fields a client may send partial ([n <= N, ...]); each maps to the valid
# mask derived (first n rows True) when the mask itself is not sent.
_PARTIAL_FIELDS = {"points": "point_valid", "lane_points": "lane_valid"}


class LiftServer(_MicroBatchServer):
    """Micro-batching executor over the lift artifact (deploy --what
    lift): keyframes in, pseudo-label boxes out.

    The artifact's single input is a batched Keyframe pytree; its slot
    geometry (and the wire field inventory) is recovered from the
    artifact's own inputs, so one host serves any per-dataset preset.
    Empty batch slots stay all-zero (validity masks False -> no boxes),
    and the step is slot-independent, so padding never changes a
    request's result. No parameters: the lift step is pure geometry.
    """

    route = "/v1/lift"

    def __init__(self, artifact_path, flush_ms: float = 5.0):
        """artifact_path: one artifact, or a LIST of same-geometry
        artifacts exported at different batch sizes (batch BUCKETS). A
        group dispatches through the smallest bucket that fits it, so a
        singleton request does not upload a full max-batch of zero
        padding (the keyframe is about 12 MB at nuScenes geometry)."""
        import torch.utils._pytree as pytree

        from cm3d_tpu_torch.datasets.types import Keyframe
        from cm3d_tpu_torch.deploy import load_artifact

        paths = (list(artifact_path)
                 if isinstance(artifact_path, (list, tuple))
                 else [artifact_path])
        self._by_size: dict = {}
        slot_specs = None
        for p in paths:
            exported = load_artifact(p)
            args, kwargs = pytree.tree_unflatten(exported.in_avals, exported.in_tree)
            if kwargs or len(args) != 1 or not isinstance(args[0], Keyframe):
                raise ValueError(
                    "not a lift artifact: expected one batched Keyframe "
                    f"input, got tree {exported.in_tree} ({p})"
                )
            fields = {name: _wire_field(name, a)
                      for name, a in _keyframe_fields(args[0]).items()}
            batch_sizes = {int(a.shape[0]) for a in fields.values()}
            if len(batch_sizes) != 1:
                raise ValueError(
                    f"inconsistent batch dims in lift artifact {p}: "
                    f"{batch_sizes}"
                )
            b = batch_sizes.pop()
            if b in self._by_size:
                raise ValueError(f"duplicate batch-{b} lift artifact: {p}")
            spec = {n: (a.shape[1:], str(a.dtype))
                    for n, a in fields.items()}
            if slot_specs is None:
                slot_specs = spec
                self._frame_avals = args[0]
                self._fields = fields
            elif spec != slot_specs:
                raise ValueError(
                    f"lift artifact {p} has different per-keyframe "
                    "geometry than the first artifact — buckets must "
                    "share one wire contract"
                )
            self._by_size[b] = (exported, fields)
        self.device = _artifact_device(exported)
        self.bucket_sizes = sorted(self._by_size)
        super().__init__(self.bucket_sizes[-1], flush_ms)

    @property
    def field_specs(self) -> dict:
        """Wire contract for /healthz: per-field slot shape + dtype."""
        return {
            name: {"shape": list(a.shape[1:]), "dtype": str(a.dtype)}
            for name, a in self._fields.items()
        }

    def validate(self, payload: dict) -> dict:
        if not isinstance(payload, dict):
            raise RequestError(
                f"lift request must be a mapping of Keyframe fields, got "
                f"{type(payload).__name__}"
            )
        unknown = sorted(set(payload) - set(self._fields))
        if unknown:
            raise RequestError(
                f"unknown Keyframe fields {unknown}; valid fields: "
                f"{sorted(self._fields)}"
            )
        out = {}
        for name, raw in payload.items():
            aval = self._fields[name]
            slot_shape = aval.shape[1:]
            try:
                arr = np.asarray(raw, aval.dtype)
            except (TypeError, ValueError) as e:
                raise RequestError(
                    f"field {name}: cannot cast to {aval.dtype}: {e}"
                ) from e
            if name in _PARTIAL_FIELDS:
                if (arr.ndim != len(slot_shape)
                        or arr.shape[1:] != slot_shape[1:]
                        or arr.shape[0] > slot_shape[0]):
                    raise RequestError(
                        f"field {name}: expected [n <= {slot_shape[0]}"
                        f", {', '.join(map(str, slot_shape[1:]))}], got "
                        f"{list(arr.shape)}"
                    )
            elif arr.shape != slot_shape:
                raise RequestError(
                    f"field {name}: expected shape {list(slot_shape)} "
                    f"({aval.dtype}), got {list(arr.shape)}"
                )
            out[name] = arr
        # derive validity for partial streams whose mask was not sent; an
        # explicit mask sent ALONGSIDE a partial stream must not mark rows
        # the client never sent (zero-filled slots would silently enter the
        # lift as phantom points at the origin)
        for name, valid_name in _PARTIAL_FIELDS.items():
            if name not in out:
                # a validity mask WITHOUT its data stream marks zero-fill
                # slots valid — the same phantom-point hole from the other
                # side: reject any True bits
                if valid_name in out and out[valid_name].any():
                    raise RequestError(
                        f"field {valid_name}: marks "
                        f"{int(out[valid_name].sum())} rows valid but no "
                        f"{name} were sent — send the {name} stream or an "
                        f"all-False mask"
                    )
                continue
            n_sent = len(out[name])
            if valid_name not in out:
                n_slot = self._fields[name].shape[1]
                mask = np.zeros(n_slot, bool)
                mask[:n_sent] = True
                out[valid_name] = mask
            elif out[valid_name][n_sent:].any():
                raise RequestError(
                    f"field {valid_name}: marks "
                    f"{int(out[valid_name][n_sent:].sum())} rows valid "
                    f"beyond the {n_sent} {name} rows sent — phantom "
                    f"zero rows are rejected; send the full {name} "
                    f"stream or trim the mask"
                )
        return out

    def _build_batch(self, group: list, fields=None):
        """The group's device Keyframe batch: uint32 mask words become the
        port's int32 bit patterns on the way (datasets/types.py)."""
        from cm3d_tpu_torch.datasets.types import CameraParams, Keyframe, to_device

        batch = {
            name: np.zeros(a.shape, a.dtype)
            for name, a in (fields or self._fields).items()
        }
        for j, pending in enumerate(group):
            for name, arr in pending.payload.items():
                if name in _PARTIAL_FIELDS:
                    batch[name][j, : len(arr)] = arr
                else:
                    batch[name][j] = arr
        cams = CameraParams(**{
            n.split(".", 1)[1]: batch.pop(n)
            for n in [k for k in batch if k.startswith("cameras.")]
        })
        return to_device(Keyframe(cameras=cams, **batch), self.device)

    def _execute(self, group: list) -> None:
        from cm3d_tpu_torch.utils.fetch import device_fetch

        # smallest bucket that fits the group: a singleton request rides
        # the batch-1 artifact instead of uploading max-batch padding
        b = next(s for s in self.bucket_sizes if s >= len(group))
        exported, fields = self._by_size[b]
        lift, boxes = exported.call(self._build_batch(group, fields))
        # one batched device->host transfer for the eight leaves
        centers, sizes, yaws, scores, labels, keep, has_points, truncated = \
            device_fetch((boxes.centers, boxes.sizes, boxes.yaws,
                          boxes.scores, boxes.labels, boxes.keep,
                          lift.has_points, lift.truncated))
        for j, pending in enumerate(group):
            k = keep[j]
            pending.result = {
                "boxes": np.concatenate(
                    [centers[j][k], sizes[j][k], yaws[j][k][:, None]], axis=1
                ),
                "scores": scores[j][k],
                "classes": labels[j][k],
                "n_masks_with_points": int(has_points[j].sum()),
                "n_truncated": int(truncated[j].sum()),
            }


def _now() -> float:
    import time

    return time.monotonic()


# ---- HTTP layer --------------------------------------------------------


def _parse_points(body: bytes, content_type: str) -> np.ndarray:
    if content_type.startswith("application/json"):
        try:
            payload = json.loads(body)
            return np.asarray(payload["points"], np.float32)
        except (json.JSONDecodeError, KeyError, TypeError, ValueError) as e:
            raise RequestError(f"bad JSON request: {e}") from e
    try:
        arr = np.load(io.BytesIO(body), allow_pickle=False)
    except (ValueError, EOFError, OSError, zipfile.BadZipFile) as e:
        # np.load raises ValueError on bad magic, EOFError/OSError on
        # truncated or otherwise unreadable bodies, BadZipFile on corrupt
        # zip-format (.npz) bodies — all client errors.
        raise RequestError(f"bad .npy request body: {e}") from e
    if not isinstance(arr, np.ndarray):
        # an .npz body deserializes to an NpzFile, not an array
        raise RequestError(
            "body must be a single .npy array (got an .npz archive — "
            "that is the /v1/lift wire format)"
        )
    return arr


def _parse_frame(body: bytes, content_type: str) -> dict:
    """Lift wire formats: JSON mapping of Keyframe fields, or an .npz
    archive (np.savez) — one keyframe per request."""
    if content_type.startswith("application/json"):
        try:
            payload = json.loads(body)
        except json.JSONDecodeError as e:
            raise RequestError(f"bad JSON request: {e}") from e
        if not isinstance(payload, dict):
            raise RequestError("lift JSON body must be a field mapping")
        return payload
    try:
        npz = np.load(io.BytesIO(body), allow_pickle=False)
    except (ValueError, EOFError, OSError, zipfile.BadZipFile) as e:
        raise RequestError(f"bad .npz request body: {e}") from e
    if isinstance(npz, np.ndarray):
        raise RequestError(
            "lift request body must be an .npz archive of Keyframe "
            "fields (np.savez), not a bare .npy array"
        )
    with npz:
        return {k: npz[k] for k in npz.files}


def _decompress_body(body: bytes, encoding: str, max_bytes: int) -> bytes:
    """Bounded transport decompression: raises RequestError (400) on
    corrupt streams and enforces the same cap as Content-Length AFTER
    expansion (413-class bombs surface as RequestError here; the caller
    already replied 413 to oversized declared lengths)."""
    import zlib

    # gzip = zlib with the gzip header (wbits 47 auto-detects both)
    d = zlib.decompressobj(47 if encoding == "gzip" else zlib.MAX_WBITS)
    try:
        out = d.decompress(body, max_bytes + 1)
    except zlib.error as e:
        raise RequestError(f"bad {encoding} request body: {e}") from e
    if len(out) > max_bytes or d.unconsumed_tail:
        raise RequestError(
            f"decompressed body exceeds the {max_bytes}-byte limit"
        )
    if not d.eof:
        raise RequestError(f"truncated {encoding} request body")
    return out


class _Handler(BaseHTTPRequestHandler):
    server: "ServingHTTPServer"

    def _reply(self, code: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        if self.path != "/healthz":
            return self._reply(404, {"error": f"no route {self.path}"})
        b = self.server.backend
        info = {
            "ok": True, "route": b.route, "batch_size": b.batch_size,
            "flush_ms": b.flush_ms, "stats": dict(b.stats),
        }
        if isinstance(b, DetectServer):
            info["max_points"] = b.max_points
        else:
            info["fields"] = b.field_specs
            info["batch_buckets"] = b.bucket_sizes
        self._reply(200, info)

    def do_POST(self) -> None:  # noqa: N802
        backend = self.server.backend
        if self.path != backend.route:
            return self._reply(404, {"error": f"no route {self.path}"})
        try:
            length = int(self.headers.get("Content-Length", 0))
        except ValueError:
            return self._reply(400, {"error": "bad Content-Length header"})
        if length < 0:
            return self._reply(400, {"error": "bad Content-Length header"})
        if length > self.server.max_body_bytes:
            # the header is attacker-controlled; never allocate/read an
            # unbounded body on its say-so
            return self._reply(413, {
                "error": f"request body {length} bytes exceeds the "
                         f"{self.server.max_body_bytes}-byte limit"})
        try:
            body = self.rfile.read(length)
            encoding = self.headers.get("Content-Encoding", "").lower()
            if encoding in ("gzip", "deflate"):
                # transport compression (Content-Encoding): the ~12 MB lift
                # keyframe is mostly sparse mask bit-planes. Decompress
                # with the same body cap: a tiny bomb must not expand
                # unbounded.
                body = _decompress_body(
                    body, encoding, self.server.max_body_bytes
                )
            elif encoding:
                return self._reply(400, {
                    "error": f"unsupported Content-Encoding {encoding!r}; "
                             "supported: gzip, deflate"})
            ctype = self.headers.get("Content-Type", "")
            if isinstance(backend, DetectServer):
                out = backend.submit(_parse_points(body, ctype))
            else:
                out = backend.submit(_parse_frame(body, ctype))
        except RequestError as e:
            return self._reply(400, {"error": str(e)})
        except TimeoutError as e:
            return self._reply(503, {"error": str(e)})
        except Exception as e:
            # Device/dispatch failure: the client still deserves a JSON
            # error, not a dropped connection — but internal exception
            # text stays out of the response (path/state leak); log it
            # server-side instead.
            self.log_error("dispatch failure: %r", e)
            return self._reply(
                500, {"error": f"internal serving error "
                               f"({type(e).__name__})"})
        resp = {
            "boxes": out["boxes"].tolist(),
            "scores": out["scores"].tolist(),
            "classes": out["classes"].tolist(),
            "n_kept": int(len(out["scores"])),
        }
        for key in ("n_masks_with_points", "n_truncated"):
            if key in out:
                resp[key] = out[key]
        self._reply(200, resp)

    def log_message(self, fmt: str, *args: Any) -> None:
        if self.server.verbose:
            super().log_message(fmt, *args)


class ServingHTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    # hard cap on request bodies (413 beyond this): generous vs the
    # largest legitimate wire frame (~12 MB uncompressed lift npz)
    DEFAULT_MAX_BODY_BYTES = 64 * 1024 * 1024

    def __init__(self, address, backend: _MicroBatchServer,
                 verbose: bool = True,
                 max_body_bytes: int | None = None):
        self.backend = backend
        self.verbose = verbose
        self.max_body_bytes = (self.DEFAULT_MAX_BODY_BYTES
                               if max_body_bytes is None else max_body_bytes)
        super().__init__(address, _Handler)

    @property
    def detect(self) -> _MicroBatchServer:
        """Back-compat alias (the host predates the lift backend)."""
        return self.backend


def make_server(artifact: str | Path, params: Any, batch_stats: Any = None,
                host: str = "127.0.0.1", port: int = 0,
                flush_ms: float = 5.0, verbose: bool = True
                ) -> ServingHTTPServer:
    """Build the detect HTTP server (unstarted). ``port=0`` binds an
    ephemeral port — read it back from ``server.server_address``."""
    detect = DetectServer(artifact, params, batch_stats, flush_ms=flush_ms)
    return ServingHTTPServer((host, port), detect, verbose=verbose)


def make_lift_server(artifact, host: str = "127.0.0.1",
                     port: int = 0, flush_ms: float = 5.0,
                     verbose: bool = True) -> ServingHTTPServer:
    """Build the lift HTTP server (unstarted) over one ``deploy --what
    lift`` artifact or a list of batch-bucket artifacts. No checkpoint: the
    lift step is pure geometry."""
    lift = LiftServer(artifact, flush_ms=flush_ms)
    return ServingHTTPServer((host, port), lift, verbose=verbose)


def artifact_kind(artifact: str | Path) -> str:
    """'lift' if the artifact's input pytree is a batched Keyframe,
    else 'detect'."""
    import torch.utils._pytree as pytree

    from cm3d_tpu_torch.datasets.types import Keyframe
    from cm3d_tpu_torch.deploy import load_artifact

    ex = load_artifact(artifact)
    args, kwargs = pytree.tree_unflatten(ex.in_avals, ex.in_tree)
    if not kwargs and len(args) == 1 and isinstance(args[0], Keyframe):
        return "lift"
    return "detect"


def main(argv=None):
    p = argparse.ArgumentParser(
        description="serve a cm3d_tpu_torch.deploy artifact (detect or lift, "
        "auto-detected) over HTTP"
    )
    p.add_argument("--artifact", required=True,
                   help="a .pt2 artifact from cm3d_tpu_torch.deploy; for lift, a "
                   "comma-separated list serves batch BUCKETS (e.g. the "
                   "same step exported at batch 1 and 4) — groups "
                   "dispatch through the smallest bucket that fits")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint dir (pretrain's {out}/centerpoint;"
                   " required for detect artifacts, unused for lift)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8712)
    p.add_argument("--flush_ms", type=float, default=5.0,
                   help="max wait to fill a device batch after the first "
                   "request of a group arrives")
    args = p.parse_args(argv)

    artifacts = [a for a in args.artifact.split(",") if a]
    kind = artifact_kind(artifacts[0])
    if kind == "lift":
        server = make_lift_server(artifacts, host=args.host,
                                  port=args.port, flush_ms=args.flush_ms)
    elif len(artifacts) > 1:
        p.error("batch buckets (comma-separated artifacts) are a lift "
                "feature; detect takes one artifact")
    else:
        if not args.ckpt:
            p.error("--ckpt is required for detect artifacts")

        from cm3d_tpu_torch.models.checkpoints import load_params

        restored = load_params(args.ckpt)
        params = restored["params"] if "params" in restored else restored
        batch_stats = restored.get("batch_stats", {})
        server = make_server(artifacts[0], params, batch_stats,
                             host=args.host, port=args.port,
                             flush_ms=args.flush_ms)
    host, port = server.server_address[:2]
    d = server.backend
    print(f"cm3d_tpu_torch.serve [{kind}] on http://{host}:{port}  "
          f"batch={d.batch_size} flush_ms={d.flush_ms}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.detect.close()
        server.server_close()


if __name__ == "__main__":
    main()
