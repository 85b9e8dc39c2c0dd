"""Serving daemon: the fused ViMoCLIP cascade behind a JSON API (the port's
copy of ``vimoclip_tpu/cli/serve.py``).

Weights load once and stay on the card; every request reuses them. Two
frontends over the same predictor (``cli/predict.py``'s ``build_predictor``,
with the same flags):

- default: JSON lines on stdin, one JSON prediction line per request on
  stdout. Request: ``{"video": "/path.mp4"[, "motion_video": "...",
  "top_k": 5, "max_frames": N]}`` or ``{"videos": [paths...][,
  "motion_videos": {path: motion_path}, "top_k", "max_frames"]}``. EOF ends
  the process.
- ``--port N``: a threaded HTTP endpoint. ``POST /predict`` takes the same
  bodies (``{"videos": [...]}`` answers ``{"results": [...]}``);
  ``GET /healthz`` answers 200 once the models are resident; ``GET /stats``
  reports the batcher's counters. It binds 127.0.0.1 unless ``--host``
  says otherwise.

Under HTTP, concurrent requests coalesce: one worker thread drains a queue
and runs the videos of several in-flight requests through one pooled
``predict_batch`` call (``DynamicBatcher``): shared embedding windows and one
fusion call. Masked (batch-invariant) pooling makes a coalesced prediction
equal to the solo one; ``--quirk-batch-pooling`` restores the reference's
batch-max pooling, whose output depends on the co-batched clips, so it turns
coalescing off.

Responses use ``vimo-predict-torch``'s record shape.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import queue
import signal
import sys
import threading
import time

from vimoclip_tpu_torch.cli.predict import find_motion_match, prediction_record
from vimoclip_tpu_torch.utils.logging import setup_logging


@dataclasses.dataclass
class _PendingVideo:
    """One video waiting for the batcher's worker (a request may enqueue
    several)."""

    video: str
    motion: str | None
    top_k: int
    max_frames: int | None
    done: threading.Event = dataclasses.field(default_factory=threading.Event)
    result: object | None = None
    error: Exception | None = None


_SHUTDOWN = object()


class Overloaded(RuntimeError):
    """The backlog is at the batcher's bound: shed load instead of queueing
    without limit (HTTP 503 with Retry-After)."""


class RequestTimeout(RuntimeError):
    """A request waited past its deadline (HTTP 504). Its work may still
    finish on the card; only the wait is abandoned."""


class DynamicBatcher:
    """Cross-request dynamic batching around one predictor on one card.

    Handler threads enqueue their request (all its videos, one queue entry)
    and wait; one worker thread drains the queue, waiting up to
    ``max_wait_ms`` after the first arrival for concurrent requests to pile
    on and stopping once ``max_batch`` videos have coalesced (a single
    larger request still pools whole), and runs the group through
    ``predictor.predict_batch``. The worker is the only user of the
    predictor and its CUDA stream, so no device lock is needed.

    Semantics are those of the solo calls:
    - ``top_k`` may differ within a group: the pooled call asks for the
      group's largest and each response is sliced back (``top_classes`` is
      ordered by probability, so a prefix is the smaller top-k);
    - videos with a precomputed motion file run serially in the worker (the
      pooled path covers the frame-difference modality only);
    - ``max_frames`` changes the decoded input, so only videos with equal
      ``max_frames`` share a pooled call;
    - the predictor must be batch-invariant (masked pooling); under
      ``--quirk-batch-pooling`` the daemon builds no batcher.

    If a pooled call raises, the group is retried serially, so only the
    faulty videos carry errors and co-batched requests are unaffected.
    """

    def __init__(self, predictor, max_batch: int = 8,
                 max_wait_ms: float = 10.0, max_pending: int = 256,
                 request_timeout_s: float | None = None):
        self.predictor = predictor
        self.max_batch = max(1, int(max_batch))
        self.max_wait = max(0.0, float(max_wait_ms)) / 1e3
        self.max_pending = max(1, int(max_pending))
        self.request_timeout = (None if request_timeout_s is None
                                else max(0.0, float(request_timeout_s)))
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        self._pending = 0  # videos enqueued and not yet done (backpressure)
        self._pending_lock = threading.Lock()
        self._stats_lock = threading.Lock()
        self._stats = {
            "requests": 0,          # videos submitted
            "predictor_calls": 0,   # pooled or serial predictor calls
            "pooled_videos": 0,     # videos served by pooled calls
            "max_coalesced": 0,     # largest pooled group so far
            "shed": 0,              # videos refused by backpressure (503)
            "timeouts": 0,          # requests abandoned past the deadline
        }
        self._worker = threading.Thread(target=self._run, name="vimo-batcher",
                                        daemon=True)
        self._worker.start()

    # -- handler-thread side ------------------------------------------------

    def predict_many(self, videos: list[str], motions: list[str | None],
                     top_k: int, max_frames: int | None) -> list:
        """Enqueue one request's videos, wait, and return their predictions
        in order.

        Raises the first per-video error (a request with a bad path fails
        whole; co-batched requests do not). Raises ``Overloaded`` at the
        backlog bound and ``RequestTimeout`` past the per-request deadline.
        """
        items = [_PendingVideo(v, m, top_k, max_frames)
                 for v, m in zip(videos, motions)]
        # one queue entry per request: the worker sees it whole, so a
        # multi-video request pools into one call even with no wait
        if self._closed or not self._worker.is_alive():
            raise RuntimeError(
                "batcher is shut down or its worker died; restart the daemon")
        with self._pending_lock:
            if self._pending + len(items) > self.max_pending:
                with self._stats_lock:
                    self._stats["shed"] += len(items)
                raise Overloaded(
                    f"backlog full ({self._pending} pending videos, "
                    f"limit {self.max_pending}); retry later")
            self._pending += len(items)
        self._q.put(items)
        deadline = (None if self.request_timeout is None
                    else time.monotonic() + self.request_timeout)
        for item in items:
            # bounded waits with a liveness check: if the worker dies of a
            # non-Exception, handler threads must not wait forever
            while True:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    with self._stats_lock:
                        self._stats["timeouts"] += 1
                    raise RequestTimeout(
                        f"request exceeded {self.request_timeout:.1f}s "
                        "deadline waiting for the batcher")
                wait = 1.0 if remaining is None else min(1.0, remaining)
                if item.done.wait(timeout=wait):
                    break
                if not self._worker.is_alive() and not item.done.is_set():
                    raise RuntimeError(
                        "batcher worker died mid-request; restart the daemon")
        for item in items:
            if item.error is not None:
                raise item.error
        return [item.result for item in items]

    def stats(self) -> dict:
        with self._stats_lock:
            return dict(self._stats)

    def shutdown(self) -> None:
        """Stop accepting, let the worker finish what is already queued (the
        sentinel queues behind it), then fail any entry that raced past the
        ``_closed`` check and landed behind the sentinel."""
        self._closed = True
        self._q.put(_SHUTDOWN)
        self._worker.join(timeout=30)
        self._drain_failed()

    # -- worker side ---------------------------------------------------------

    def _finish(self, item: _PendingVideo) -> None:
        with self._pending_lock:
            self._pending -= 1
        item.done.set()

    def _drain_failed(self) -> None:
        """Fail every entry still queued (the shutdown path)."""
        while True:
            try:
                group = self._q.get_nowait()
            except queue.Empty:
                return
            if group is _SHUTDOWN:
                continue
            for item in group:
                if not item.done.is_set():
                    item.error = RuntimeError("batcher shut down before this request ran")
                    self._finish(item)

    def _run(self) -> None:
        while True:
            first = self._q.get()
            if first is _SHUTDOWN:
                self._drain_failed()
                return
            batch = list(first)
            deadline = time.monotonic() + self.max_wait
            stop = False
            # entries are whole requests, so max_batch caps coalescing
            # across requests; past the deadline entries already queued
            # still drain, the wait only gates those not yet arrived
            while len(batch) < self.max_batch:
                wait = deadline - time.monotonic()
                try:
                    group = (self._q.get_nowait() if wait <= 0
                             else self._q.get(timeout=wait))
                except queue.Empty:
                    break
                if group is _SHUTDOWN:
                    stop = True
                    break
                batch.extend(group)
            try:
                self._process(batch)
            except Exception:  # noqa: BLE001 — the worker must not die
                logging.exception("batcher worker: unexpected group failure")
                for item in batch:
                    if not item.done.is_set():
                        item.error = item.error or RuntimeError(
                            "batcher worker failed; see daemon log")
                        self._finish(item)
            if stop:
                self._drain_failed()
                return

    def _serial(self, item: _PendingVideo) -> None:
        try:
            item.result = self.predictor.predict(
                item.video, motion_video_path=item.motion,
                top_k=item.top_k, max_frames=item.max_frames)
        except Exception as e:  # noqa: BLE001 — per-video fault tolerance
            item.error = e
        finally:
            with self._stats_lock:
                self._stats["predictor_calls"] += 1
            self._finish(item)

    def _process(self, batch: list[_PendingVideo]) -> None:
        with self._stats_lock:
            self._stats["requests"] += len(batch)
        pooled: dict[int | None, list[_PendingVideo]] = {}
        for item in batch:
            if item.motion is not None:
                self._serial(item)
            else:
                pooled.setdefault(item.max_frames, []).append(item)
        for max_frames, items in pooled.items():
            if len(items) == 1:
                self._serial(items[0])
                continue
            group_k = max(i.top_k for i in items)
            try:
                preds = self.predictor.predict_batch(
                    [i.video for i in items], top_k=group_k, max_frames=max_frames)
            except Exception:  # noqa: BLE001 — isolate the faulty video
                logging.exception("pooled call failed; retrying %d videos serially",
                                  len(items))
                for item in items:
                    self._serial(item)
                continue
            if len(preds) != len(items):
                # a short list would leave the tail's events unset forever
                logging.error("pooled call returned %d predictions for %d videos; "
                              "retrying serially", len(preds), len(items))
                for item in items:
                    self._serial(item)
                continue
            with self._stats_lock:
                self._stats["predictor_calls"] += 1
                self._stats["pooled_videos"] += len(items)
                self._stats["max_coalesced"] = max(self._stats["max_coalesced"],
                                                   len(items))
            for item, pred in zip(items, preds):
                item.result = dataclasses.replace(
                    pred, top_classes=pred.top_classes[: item.top_k])
                self._finish(item)


def handle_request(predictor, req: dict, default_top_k: int = 5,
                   motion_videos_dir: str | None = None,
                   batcher: DynamicBatcher | None = None,
                   default_max_frames: int | None = None) -> dict:
    """One request -> one response dict (both frontends).

    With ``batcher`` every video is enqueued instead of reaching the
    predictor directly, so videos of concurrent requests share pooled calls;
    the response is the same either way."""
    top_k = int(req.get("top_k", default_top_k))
    if "max_frames" in req:
        # an explicit null means "no cap", over the daemon's --max-frames
        mf = req["max_frames"]
        max_frames = None if mf is None else int(mf)
    else:
        max_frames = default_max_frames
    if "videos" in req:
        videos = list(req["videos"])
        explicit = req.get("motion_videos")
        explicit = explicit if isinstance(explicit, dict) else {}
        # an explicit entry wins, else the --motion-videos-dir match; an
        # explicit null forces the frame-difference path despite a match
        motions = [explicit[v] if v in explicit
                   else find_motion_match(motion_videos_dir, v) for v in videos]
        if batcher is not None:
            preds = batcher.predict_many(videos, motions, top_k, max_frames)
        elif any(m is not None for m in motions):
            # the pooled path covers the frame-difference modality only
            preds = [predictor.predict(v, motion_video_path=m, top_k=top_k,
                                       max_frames=max_frames)
                     for v, m in zip(videos, motions)]
        else:
            preds = predictor.predict_batch(videos, top_k=top_k, max_frames=max_frames)
        return {"results": [prediction_record(v, p) for v, p in zip(videos, preds)]}
    video = req["video"]
    motion = (req["motion_video"] if "motion_video" in req
              else find_motion_match(motion_videos_dir, video))
    if batcher is not None:
        pred = batcher.predict_many([video], [motion], top_k, max_frames)[0]
    else:
        pred = predictor.predict(video, motion_video_path=motion, top_k=top_k,
                                 max_frames=max_frames)
    return prediction_record(video, pred)


def serve_stdin(predictor, in_stream, out_stream, default_top_k: int = 5,
                motion_videos_dir: str | None = None,
                default_max_frames: int | None = None) -> int:
    """The JSON-lines loop; returns the number of requests served. A failed
    request answers ``{"error": ...}`` and the loop goes on."""
    served = 0
    for line in in_stream:
        line = line.strip()
        if not line:
            continue
        try:
            resp = handle_request(predictor, json.loads(line), default_top_k,
                                  motion_videos_dir,
                                  default_max_frames=default_max_frames)
        except Exception as e:  # noqa: BLE001 — fault-tolerant loop
            logging.exception("request failed")
            resp = {"error": str(e)}
        out_stream.write(json.dumps(resp) + "\n")
        out_stream.flush()
        served += 1
    return served


def make_http_server(predictor, host: str = "127.0.0.1", port: int = 0,
                     default_top_k: int = 5,
                     motion_videos_dir: str | None = None,
                     batcher: DynamicBatcher | None = None,
                     default_max_frames: int | None = None):
    """Build (without starting) the threaded HTTP server. Port 0 picks a
    free port; ``server.server_address[1]`` has the real one.

    With ``batcher`` its worker is the only predictor user and handler
    threads only enqueue and wait. Without one (``--quirk-batch-pooling``)
    a lock serialises the handlers' predictor calls."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, payload: dict,
                   retry_after: float | None = None) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            if retry_after is not None:
                self.send_header("Retry-After", str(int(max(1, retry_after))))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — BaseHTTPRequestHandler API
            if self.path == "/healthz":
                self._reply(200, {"status": "ok"})
            elif self.path == "/stats":
                self._reply(200, batcher.stats() if batcher is not None
                            else {"dynamic_batching": False})
            else:
                self._reply(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/predict":
                self._reply(404, {"error": f"no route {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                if batcher is not None:
                    resp = handle_request(predictor, req, default_top_k,
                                          motion_videos_dir, batcher=batcher,
                                          default_max_frames=default_max_frames)
                else:
                    with lock:
                        resp = handle_request(predictor, req, default_top_k,
                                              motion_videos_dir,
                                              default_max_frames=default_max_frames)
                self._reply(200, resp)
            except Overloaded as e:
                self._reply(503, {"error": str(e)}, retry_after=1.0)
            except RequestTimeout as e:
                self._reply(504, {"error": str(e)})
            except (json.JSONDecodeError, KeyError, TypeError, ValueError, OSError) as e:
                # malformed request or unreadable video: the client's fault
                logging.exception("bad request")
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — server-side fault
                logging.exception("request failed server-side")
                self._reply(500, {"error": str(e)})

        def log_message(self, fmt, *fmt_args):
            logging.info("http: " + fmt, *fmt_args)

    return ThreadingHTTPServer((host, port), Handler)


def serve_http(server, batcher: DynamicBatcher | None = None,
               install_signal_handlers: bool = True) -> None:
    """Run the HTTP server until shutdown. SIGTERM/SIGINT drain: the accept
    loop stops, in-flight handler threads finish their responses
    (non-daemon threads, which ``server_close`` joins), the batcher serves
    what it already queued, and this returns. A second signal exits at once
    with the signal's default action, for a drain wedged on a predictor
    that never returns. The handler only starts ``server.shutdown()`` on a
    side thread: called from the serving thread it would deadlock."""
    server.daemon_threads = False
    if install_signal_handlers:
        draining = threading.Event()

        def _drain(signum, frame):
            if draining.is_set():
                logging.warning("signal %d again: hard exit", signum)
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                signal.signal(signal.SIGINT, signal.SIG_DFL)
                signal.raise_signal(signum)
                return
            draining.set()
            logging.info("signal %d: draining (no new connections)", signum)
            threading.Thread(target=server.shutdown, daemon=True).start()

        signal.signal(signal.SIGTERM, _drain)
        signal.signal(signal.SIGINT, _drain)
    try:
        server.serve_forever()
    finally:
        server.server_close()
        if batcher is not None:
            batcher.shutdown()
        logging.info("drained; exiting")


def main(argv: list[str] | None = None) -> None:
    from vimoclip_tpu_torch.cli.predict import (
        add_model_args,
        build_predictor,
        validate_model_args,
    )

    p = argparse.ArgumentParser(
        description="Serve the fused ViMoCLIP cascade (stdin JSON lines or HTTP; "
                    "PyTorch/CUDA port)")
    add_model_args(p)
    p.add_argument("--port", type=int, default=None,
                   help="serve HTTP on this port instead of stdin/stdout")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--probe-video", default=None,
                   help="the video --warmup runs once at startup, and the one "
                        "the --verify-fidelity probe samples (a daemon has no "
                        "request video yet; it refuses to start below "
                        "--fidelity-threshold)")
    p.add_argument("--warmup", action="store_true",
                   help="run one throwaway predict on --probe-video before "
                        "accepting traffic, so cuBLAS and the allocator are "
                        "set up before the first request")
    p.add_argument("--max-batch", type=int, default=8,
                   help="dynamic batching: stop coalescing requests once this "
                        "many videos are grouped (HTTP; one larger request "
                        "still pools whole)")
    p.add_argument("--batch-wait-ms", type=float, default=10.0,
                   help="dynamic batching: how long the worker waits after the "
                        "first queued video for concurrent requests (0: no "
                        "wait; queued requests still coalesce and a "
                        "multi-video request always pools whole)")
    p.add_argument("--max-pending", type=int, default=256,
                   help="backpressure: answer 503 + Retry-After once this many "
                        "videos are queued and not yet served")
    p.add_argument("--request-timeout-s", type=float, default=None,
                   help="per-request deadline: a request still waiting on the "
                        "batcher past this answers 504 (default: none)")
    args = p.parse_args(argv)
    validate_model_args(p, args)
    if args.verify_fidelity and not args.probe_video:
        p.error("--verify-fidelity needs --probe-video PATH in the daemon "
                "(no request video exists at startup to sample from)")
    if args.warmup and not args.probe_video:
        p.error("--warmup needs --probe-video PATH (a representative video)")

    setup_logging(log_file=None)
    if args.output:
        logging.warning("--output is ignored by the daemon: responses stream to "
                        "stdout/HTTP per request (vimo-predict-torch writes a file)")
    predictor = build_predictor(args, probe_video=args.probe_video)
    if args.warmup:
        t0 = time.monotonic()
        predictor.predict(args.probe_video, top_k=1)
        logging.info("warmup predict done in %.1fs", time.monotonic() - t0)
    logging.info("models resident; serving")
    if args.port is not None:
        batcher = None
        if not args.quirk_batch_pooling:
            batcher = DynamicBatcher(predictor, args.max_batch, args.batch_wait_ms,
                                     max_pending=args.max_pending,
                                     request_timeout_s=args.request_timeout_s)
        else:
            logging.info("dynamic batching off under --quirk-batch-pooling "
                         "(outputs would depend on co-batched requests)")
        server = make_http_server(predictor, args.host, args.port, args.top_k,
                                  args.motion_videos_dir, batcher=batcher,
                                  default_max_frames=args.max_frames)
        logging.info("listening on %s:%d (dynamic batching: %s)",
                     *server.server_address, "on" if batcher else "off")
        serve_http(server, batcher)
    else:
        n = serve_stdin(predictor, sys.stdin, sys.stdout, args.top_k,
                        args.motion_videos_dir, default_max_frames=args.max_frames)
        logging.info("stdin closed after %d requests", n)


if __name__ == "__main__":
    main()
