"""HTTP key-value rendezvous server + client: the port's copy of
``horovod_tpu/runner/http_server.py``, on the same wire (paths, HMAC
signature header, status codes), so either package's client talks to
either package's server with one secret.

Reference parity: `horovod/runner/http/http_server.py` (`RendezvousServer`,
`KVStoreHandler`) and `http_client.py` (`put_data_into_kvstore`,
`read_data_from_kvstore`). The driver runs one of these; workers (and the
elastic machinery) GET/PUT keys under scopes. Values are opaque bytes;
requests carry an HMAC signature header when the server was given a key.

GET on a missing key returns 404 and clients poll — that is the rendezvous
barrier (same semantics the reference's Gloo context relies on).

Observability: both servers here also expose the process's metrics
registry (``horovod_tpu_torch/observability/metrics.py``) as Prometheus
text at ``GET /metrics`` — the driver's RendezvousServer piggybacks it on
the KV port, and :class:`MetricsServer` is the standalone per-worker
endpoint (the port's ``hvd.init()`` does not start one yet). ``/metrics`` is
read-only health data and scrapers cannot sign requests, so it is served
without the HMAC check.
"""

import os
import random
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from . import util

SIG_HEADER = "X-Hvd-Sig"
METRICS_PATH = "/metrics"
_METRICS_CONTENT_TYPE = "text/plain; version=0.0.4; charset=utf-8"

# Transient-failure retry policy for the KV client: a driver mid-restart or
# a loaded accept queue must not fail the worker on one ECONNREFUSED.
# Bounded attempts with exponential backoff + full jitter; 404 (the
# rendezvous barrier) and signature failures are NOT transient and are
# never retried here. HVD_KV_RETRIES=0 restores single-shot behavior.
_RETRY_BASE_S = 0.05
_RETRY_CAP_S = 2.0

_retry_lock = threading.Lock()
_retry_count = 0


def retry_count():
    """Transient KV-client retries performed by this process (the
    ``kv_retries`` field of ``hvd.elastic_stats()``)."""
    return _retry_count


def _note_retry():
    global _retry_count
    from ..observability import metrics

    with _retry_lock:
        _retry_count += 1
        metrics.ELASTIC_KV_RETRIES.set(_retry_count)


def _serve_metrics(handler):
    """Write the registry's Prometheus exposition as the response."""
    from .. import observability

    body = observability.metrics.render_text().encode()
    handler.send_response(200)
    handler.send_header("Content-Type", _METRICS_CONTENT_TYPE)
    handler.send_header("Content-Length", str(len(body)))
    handler.end_headers()
    handler.wfile.write(body)


class _KVHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):  # quiet
        pass

    def _check_sig(self, payload=b""):
        # The signature binds METHOD + path + payload: a sniffed signed GET
        # must not be replayable as a DELETE or empty-body PUT of the same
        # path. (Verbatim replay of a signed PUT remains possible on a
        # cleartext network — but workers only ever PUT /ctl/reset/*, whose
        # replay just requests an extra epoch; /ctl/epoch is written by the
        # driver directly, never over HTTP, so no resize/rollback PUT ever
        # crosses the wire to capture.)
        key = self.server.secret_key
        if key is None:
            return True
        sig = self.headers.get(SIG_HEADER, "")
        return util.check_signature(
            key, self.command.encode() + self.path.encode() + payload, sig)

    def do_GET(self):
        if self.path == METRICS_PATH:
            _serve_metrics(self)
            return
        if not self._check_sig():
            self.send_error(403)
            return
        with self.server.kv_lock:
            value = self.server.kv.get(self.path)
        if value is None:
            self.send_error(404)
            return
        self.send_response(200)
        self.send_header("Content-Length", str(len(value)))
        self.end_headers()
        self.wfile.write(value)

    def do_PUT(self):
        length = int(self.headers.get("Content-Length", 0))
        payload = self.rfile.read(length)
        if not self._check_sig(payload):
            self.send_error(403)
            return
        with self.server.kv_lock:
            self.server.kv[self.path] = payload
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_DELETE(self):
        if not self._check_sig():
            self.send_error(403)
            return
        with self.server.kv_lock:
            self.server.kv.pop(self.path, None)
        self.send_response(200)
        self.send_header("Content-Length", "0")
        self.end_headers()


class RendezvousServer:
    """In-driver KV store. start() returns the bound port."""

    def __init__(self, secret_key=None, addr="0.0.0.0"):
        self._addr = addr
        self._httpd = None
        self._thread = None
        self.secret_key = secret_key

    def start(self, port=0):
        self._httpd = ThreadingHTTPServer((self._addr, port), _KVHandler)
        self._httpd.kv = {}
        self._httpd.kv_lock = threading.Lock()
        self._httpd.secret_key = self.secret_key
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    @property
    def port(self):
        return self._httpd.server_address[1] if self._httpd else None

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None

    # Driver-side direct access (no HTTP round trip)
    def get(self, path):
        with self._httpd.kv_lock:
            return self._httpd.kv.get(path)

    def put(self, path, value: bytes):
        with self._httpd.kv_lock:
            self._httpd.kv[path] = value

    def scan(self, prefix):
        """Snapshot of all (path, value) pairs under a path prefix."""
        with self._httpd.kv_lock:
            return {k: v for k, v in self._httpd.kv.items()
                    if k.startswith(prefix)}

    def delete(self, path):
        with self._httpd.kv_lock:
            self._httpd.kv.pop(path, None)


class _MetricsOnlyHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, *args):  # quiet
        pass

    def do_GET(self):
        if self.path == METRICS_PATH:
            _serve_metrics(self)
            return
        self.send_error(404)


class MetricsServer:
    """Standalone ``/metrics`` endpoint for a worker process (the driver's
    RendezvousServer already serves it on the KV port). start() returns
    the bound port; the serving thread is a daemon, so a forgotten stop()
    never blocks process exit."""

    def __init__(self, addr="0.0.0.0"):
        self._addr = addr
        self._httpd = None
        self._thread = None

    def start(self, port=0):
        self._httpd = ThreadingHTTPServer((self._addr, port),
                                          _MetricsOnlyHandler)
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self._httpd.server_address[1]

    @property
    def port(self):
        return self._httpd.server_address[1] if self._httpd else None

    def stop(self):
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None


def _request_once(method, url, payload=b"", secret_key=None, timeout=10.0):
    req = urllib.request.Request(url, data=payload or None, method=method)
    if secret_key is not None:
        from urllib.parse import urlparse
        path = urlparse(url).path
        req.add_header(SIG_HEADER,
                       util.sign(secret_key,
                                 method.encode() + path.encode() + payload))
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.read()


def _transient(exc):
    """Connect/read failures worth retrying. HTTP status responses (404
    rendezvous misses, 403 bad signature) reached the server — retrying
    cannot change the outcome and 404 has its own poll loop in read_kv."""
    if isinstance(exc, urllib.error.HTTPError):
        return False
    return isinstance(exc, (urllib.error.URLError, ConnectionError,
                            TimeoutError, OSError))


def _request(method, url, payload=b"", secret_key=None, timeout=10.0):
    attempts = int(os.environ.get("HVD_KV_RETRIES", "5")) + 1
    for attempt in range(attempts):
        try:
            return _request_once(method, url, payload, secret_key, timeout)
        except Exception as e:
            if attempt == attempts - 1 or not _transient(e):
                raise
            _note_retry()
            # Full jitter keeps a herd of workers retrying a restarting
            # driver from re-colliding in lockstep.
            delay = min(_RETRY_CAP_S, _RETRY_BASE_S * (2 ** attempt))
            time.sleep(random.uniform(0, delay))


def put_kv(addr, scope, key, value: bytes, secret_key=None):
    _request("PUT", f"http://{addr}/{scope}/{key}", value, secret_key)


def read_kv(addr, scope, key, secret_key=None, wait=False, timeout=60.0):
    """GET a key; with wait=True, poll until it exists (rendezvous)."""
    import time
    deadline = time.time() + timeout
    while True:
        try:
            return _request("GET", f"http://{addr}/{scope}/{key}",
                            secret_key=secret_key)
        except urllib.error.HTTPError as e:
            if e.code == 404 and wait and time.time() < deadline:
                time.sleep(0.1)
                continue
            raise
