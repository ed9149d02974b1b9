"""A local release document for the update checker's tests: an HTTP
server on 127.0.0.1 answering every GET with ``{"latest": <version>}``
(the same fake as JAX's ``tests/test_update_check.py``)."""

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer


class FakeReleases:
    def __init__(self, latest: str) -> None:
        self.latest = latest
        self.hits = 0
        outer = self

        class H(BaseHTTPRequestHandler):
            def log_message(self, *a):  # noqa: N802
                pass

            def do_GET(self):  # noqa: N802
                outer.hits += 1
                body = json.dumps({"latest": outer.latest}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._srv = ThreadingHTTPServer(("127.0.0.1", 0), H)
        self._srv.daemon_threads = True
        self.url = f"http://127.0.0.1:{self._srv.server_address[1]}/"

    def __enter__(self) -> "FakeReleases":
        threading.Thread(target=self._srv.serve_forever,
                         daemon=True).start()
        return self

    def __exit__(self, *exc) -> bool:
        self._srv.shutdown()
        self._srv.server_close()
        return False
