"""OpenAI-shaped mock LLM upstream with genuine SSE pacing.

The conformance spec for token streaming through the tunnel — same surface as
the reference fixture (tmp/mock_llm.py:36-88): GET /v1/models and /health,
POST /v1/chat/completions honouring ``stream:true`` with paced
``chat.completion.chunk`` events ending in ``data: [DONE]``, else a JSON
completion with usage.  Runnable standalone: ``python -m
p2p_llm_tunnel_tpu_torch.testing.mock_llm --port 3001 [--pace 0.1]``.
"""

from __future__ import annotations

import asyncio
import json
from typing import AsyncIterator, List

from p2p_llm_tunnel_tpu_torch.endpoints.http11 import (
    Handler,
    HttpRequest,
    HttpResponse,
    start_http_server,
)

DEFAULT_TOKENS = ["Hello", " from", " the", " tunnel", "!"]


def _sse_event(obj: dict) -> bytes:
    return f"data: {json.dumps(obj)}\n\n".encode()


def _chunk(token: str | None, finish: str | None) -> dict:
    delta = {"content": token} if token is not None else {}
    return {
        "id": "chatcmpl-test",
        "object": "chat.completion.chunk",
        "choices": [{"index": 0, "delta": delta, "finish_reason": finish}],
    }


def create_mock_llm_handler(
    tokens: List[str] | None = None, pace_s: float = 0.1
) -> Handler:
    toks = tokens if tokens is not None else list(DEFAULT_TOKENS)

    async def sse_body() -> AsyncIterator[bytes]:
        for tok in toks:
            yield _sse_event(_chunk(tok, None))
            await asyncio.sleep(pace_s)
        yield _sse_event(_chunk(None, "stop"))
        yield b"data: [DONE]\n\n"

    async def handler(req: HttpRequest) -> HttpResponse:
        if req.method == "GET" and req.path == "/v1/models":
            body = json.dumps(
                {"object": "list", "data": [{"id": "test-model", "object": "model"}]}
            ).encode()
            return HttpResponse(200, {"content-type": "application/json"}, body)
        if req.method == "GET" and req.path == "/health":
            return HttpResponse(200, {"content-type": "text/plain"}, b"ok")
        if req.method == "POST" and req.path == "/v1/chat/completions":
            try:
                payload = json.loads(req.body) if req.body else {}
            except json.JSONDecodeError:
                payload = {}
            if payload.get("stream"):
                return HttpResponse(
                    200,
                    {"content-type": "text/event-stream", "cache-control": "no-cache"},
                    sse_body(),
                )
            completion = {
                "id": "chatcmpl-test",
                "object": "chat.completion",
                "choices": [
                    {
                        "index": 0,
                        "message": {"role": "assistant", "content": "".join(toks)},
                        "finish_reason": "stop",
                    }
                ],
                "usage": {
                    "prompt_tokens": 10,
                    "completion_tokens": len(toks),
                    "total_tokens": 10 + len(toks),
                },
            }
            return HttpResponse(
                200, {"content-type": "application/json"}, json.dumps(completion).encode()
            )
        return HttpResponse(404, {"content-type": "text/plain"}, b"not found")

    return handler


def main(argv: List[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(description="mock OpenAI-style LLM upstream")
    ap.add_argument("--port", type=int, default=3001)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--pace", type=float, default=0.1, help="seconds between SSE tokens")
    args = ap.parse_args(argv)

    async def run() -> None:
        server = await start_http_server(
            create_mock_llm_handler(pace_s=args.pace), args.host, args.port
        )
        bound = server.sockets[0].getsockname()[1]
        print(f"Mock LLM server running on http://{args.host}:{bound}", flush=True)
        async with server:
            await server.serve_forever()

    asyncio.run(run())


if __name__ == "__main__":
    main()
