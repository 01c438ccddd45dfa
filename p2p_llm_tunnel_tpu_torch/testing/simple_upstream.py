"""Prefix-less minimal OpenAI-style upstream — the advertise-prefix fixture.

Counterpart of the reference's second mock (tmp/test_upstream.py:7-45): a
non-streaming fake whose routes carry NO ``/v1`` prefix (``/models``,
``/chat/completions``), so a serve peer configured with ``--advertise /v1``
must strip the prefix for requests to land (serve.rs:167-185 behavior).
Runnable standalone: ``python -m p2p_llm_tunnel_tpu_torch.testing.simple_upstream
--port 3002``.
"""

from __future__ import annotations

import asyncio
import json
from p2p_llm_tunnel_tpu_torch.endpoints.http11 import (
    Handler,
    HttpRequest,
    HttpResponse,
    start_http_server,
)

_JSON = {"content-type": "application/json"}


def _json_resp(status: int, obj) -> HttpResponse:
    return HttpResponse(status, dict(_JSON), json.dumps(obj).encode())


def create_simple_upstream_handler(model: str = "simple-model") -> Handler:
    async def handler(req: HttpRequest) -> HttpResponse:
        path = req.path.split("?")[0]
        if req.method == "GET" and path == "/models":
            return _json_resp(
                200, {"object": "list", "data": [{"id": model, "object": "model"}]}
            )
        if req.method == "POST" and path == "/chat/completions":
            try:
                payload = json.loads(req.body or b"{}")
            except json.JSONDecodeError:
                return _json_resp(400, {"error": "bad json"})
            last = ""
            for m in payload.get("messages", []):
                last = m.get("content", last)
            return _json_resp(
                200,
                {
                    "id": "cmpl-simple",
                    "object": "chat.completion",
                    "model": model,
                    "choices": [
                        {
                            "index": 0,
                            "message": {
                                "role": "assistant",
                                "content": f"echo: {last}",
                            },
                            "finish_reason": "stop",
                        }
                    ],
                },
            )
        return _json_resp(404, {"error": f"no route {req.method} {path}"})

    return handler


async def serve(host: str = "127.0.0.1", port: int = 3002) -> None:
    server = await start_http_server(create_simple_upstream_handler(), host, port)
    async with server:
        await server.serve_forever()


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=3002)
    ap.add_argument("--host", default="127.0.0.1")
    args = ap.parse_args()
    asyncio.run(serve(args.host, args.port))
