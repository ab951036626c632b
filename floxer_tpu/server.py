"""Persistent alignment server: amortize per-process costs across CLI runs.

The reference is a batch CLI (src/main/floxer.cpp): every invocation pays
index load and, here, the device backend's one-time start-up (backend
initialization, program compiles and first executions). For repeated
production runs that cost dominates short jobs, so the framework adds a
serving mode the reference never needed:

    floxer-tpu --serve /tmp/floxer.sock         # daemon: warm backend,
                                                # cached indexes, compiled
                                                # kernels live here
    floxer-tpu --server /tmp/floxer.sock ...    # any normal CLI invocation,
                                                # executed inside the daemon

Protocol: newline-delimited JSON over a Unix stream socket. The client
sends one request line `{"argv": [...], "cwd": "..."}`; the server streams
back `{"log": {...}}` lines (mirrored logging records) followed by one
`{"exit": N}` line. Jobs are executed one at a time — the process owns one
card, and serialized jobs are what keeps its compiled kernels and backend
state coherent.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import socketserver
import sys
import threading

logger = logging.getLogger("floxer-tpu")


class _JobLogHandler(logging.Handler):
    """Mirrors log records of one job to the client connection."""

    def __init__(self, send_line):
        super().__init__(level=logging.DEBUG)
        self._send_line = send_line

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self._send_line(
                {
                    "log": {
                        "level": record.levelname,
                        "message": record.getMessage(),
                    }
                }
            )
        except Exception:  # noqa: BLE001 - client may have disconnected
            pass


def _execute_job(request: dict, send_line) -> int:
    from .cli import parse_and_validate
    from . import pipeline

    argv = request.get("argv", [])
    cwd = request.get("cwd")
    if cwd:
        os.chdir(cwd)
    try:
        cli = parse_and_validate(argv)
    except (ValueError, SystemExit) as error:
        send_line({"log": {"level": "ERROR", "message": f"[CLI PARSER ERROR] {error}"}})
        return -1
    handler = _JobLogHandler(send_line)
    try:
        return pipeline.run(cli, extra_log_handler=handler)
    except Exception as error:  # noqa: BLE001 - a job must not kill the daemon
        send_line(
            {"log": {"level": "ERROR", "message": f"job failed: {error}"}}
        )
        return -1
    finally:
        logger.removeHandler(handler)


def serve(socket_path: str) -> int:
    """Run the alignment daemon on a Unix socket (blocks forever)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from .backend import accelerator, ensure_backend

    # a backend that cannot start is an error (ensure_backend raises); a
    # server on a GPU probes with a real execution before it reports ready
    backend = ensure_backend()
    print(f"floxer-tpu server: backend {backend}", file=sys.stderr)
    if accelerator():
        probe = float(np.asarray(jnp.ones((8, 128)).sum()))
        if probe != 8 * 128:
            raise RuntimeError(f"backend probe returned {probe}")
        print(
            f"floxer-tpu server: backend probe ok on "
            f"{jax.devices()[0].device_kind}",
            file=sys.stderr,
        )

    # begin the one-time device warmup now, not at the first job; mark
    # the process persistent so jobs don't abort the shared warmup
    from . import pipeline as _pipeline

    _pipeline._PERSISTENT_PROCESS = True
    _pipeline._start_device_warmup()

    def report_warmup() -> None:
        # readiness line for deployments (bench.py blocks on it): printed
        # once the warmup thread — including the warm-shape replay of
        # previously recorded fused plans — has finished, with the number
        # of fused plans now live on the device
        thread = _pipeline._WARMUP_THREAD
        if thread is not None:
            thread.join()
        result = _pipeline._WARM_REPLAY_RESULT
        fused = result[1] if result else 0
        print(
            f"floxer-tpu server: warm replay done fused={fused}",
            file=sys.stderr,
        )
        sys.stderr.flush()

    threading.Thread(target=report_warmup, daemon=True).start()

    job_lock = threading.Lock()

    class Handler(socketserver.StreamRequestHandler):
        def handle(self) -> None:
            line = self.rfile.readline()
            if not line:
                return
            try:
                request = json.loads(line)
            except json.JSONDecodeError as error:
                self._send({"exit": -1, "error": f"bad request: {error}"})
                return

            def send_line(obj) -> None:
                self._send(obj)

            if request.get("op") == "ping":
                self._send({"exit": 0})
                return
            if request.get("op") == "shutdown":
                self._send({"exit": 0})
                threading.Thread(
                    target=self.server.shutdown, daemon=True
                ).start()
                return
            with job_lock:
                code = _execute_job(request, send_line)
            self._send({"exit": code})

        def _send(self, obj) -> None:
            # a disconnected client must not kill or noisy-fail the job —
            # the run completes and writes its output file regardless
            try:
                self.wfile.write((json.dumps(obj) + "\n").encode())
                self.wfile.flush()
            except (BrokenPipeError, ConnectionResetError, ValueError):
                pass

    if os.path.exists(socket_path):
        os.remove(socket_path)

    class Server(socketserver.ThreadingUnixStreamServer):
        daemon_threads = True
        allow_reuse_address = True

    with Server(socket_path, Handler) as server:
        print(f"floxer-tpu server: listening on {socket_path}", file=sys.stderr)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            if os.path.exists(socket_path):
                os.remove(socket_path)
    return 0


def run_via_server(socket_path: str, argv: list[str]) -> int:
    """Send one CLI invocation to a running daemon; mirror its logs to
    stderr; return the job's exit code."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as conn:
        conn.connect(socket_path)
        request = {"argv": argv, "cwd": os.getcwd()}
        conn.sendall((json.dumps(request) + "\n").encode())
        reader = conn.makefile("r")
        for line in reader:
            event = json.loads(line)
            if "exit" in event:
                if event.get("error"):
                    print(event["error"], file=sys.stderr)
                return int(event["exit"])
            log = event.get("log")
            if log:
                print(
                    f"[server] [{log['level']}] {log['message']}",
                    file=sys.stderr,
                )
    return -1


def shutdown_server(socket_path: str) -> int:
    """Ask a running daemon to exit."""
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as conn:
        conn.connect(socket_path)
        conn.sendall((json.dumps({"op": "shutdown"}) + "\n").encode())
        reader = conn.makefile("r")
        for line in reader:
            event = json.loads(line)
            if "exit" in event:
                return int(event["exit"])
    return -1
