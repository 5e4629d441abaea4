"""External CA example server: a minimal CFSSL-protocol sign endpoint
backed by a RootCA key.

Reference: cmd/external-ca-example — demonstrates holding the cluster's
signing key OUTSIDE the managers: the cluster's CAServer (with a
key-less RootCA) posts CSRs here and this daemon signs them.

POST body:  {"certificate_request": pem, "subject": {"CN", "names": [{"OU","O"}]},
             "hosts": [...]}
Response:   {"success": true, "result": {"certificate": pem}}
"""

from __future__ import annotations

import argparse
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from swarmkit_tpu_torch.ca.certificates import RootCA


def make_handler(root_ca: RootCA):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet
            pass

        def do_POST(self):
            try:
                body = json.loads(self.rfile.read(
                    int(self.headers.get("Content-Length", 0))))
                csr = body["certificate_request"].encode()
                subject = body.get("subject", {})
                cn = subject.get("CN", "")
                names = subject.get("names") or [{}]
                role_ou = names[0].get("OU", "")
                org = names[0].get("O", "")
                issued = root_ca.issue_node_certificate(
                    cn, role_ou, org, csr_pem=csr)
                resp = {"success": True,
                        "result": {"certificate":
                                   issued.cert_pem.decode()}}
                code = 200
            except Exception as e:
                resp = {"success": False, "errors": [str(e)]}
                code = 400
            raw = json.dumps(resp).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(raw)))
            self.end_headers()
            self.wfile.write(raw)

    return Handler


def serve(root_ca: RootCA, host: str = "127.0.0.1", port: int = 0):
    """Start in a daemon thread; returns (server, actual_port). Tests and
    embedders call server.shutdown() when done."""
    server = ThreadingHTTPServer((host, port), make_handler(root_ca))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return server, server.server_address[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="external-ca-example",
        description="CFSSL-protocol signer for swarmkit external-CA mode")
    p.add_argument("--ca-cert", required=True)
    p.add_argument("--ca-key", required=True)
    p.add_argument("--listen", default="127.0.0.1:8888")
    args = p.parse_args(argv)
    root = RootCA(open(args.ca_cert, "rb").read(),
                  open(args.ca_key, "rb").read())
    host, port = args.listen.rsplit(":", 1)
    server, port = serve(root, host, int(port))
    print(f"external CA signing on {host}:{port}")
    try:
        threading.Event().wait()
    except KeyboardInterrupt:
        server.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
