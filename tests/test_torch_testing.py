"""The port's ``testing/`` fixtures: copies of the JAX package's, on the
port's tunnel plane.

``__init__``, ``mock_llm``, ``simple_upstream`` and ``frame_client``
import only the tunnel plane (``endpoints/http11``, ``protocol/frames``,
``transport/base``, ``utils/logging``), which the port holds as its own
copies: their syntax trees equal the JAX sources' once the package name
in imports and the docstrings are set aside.  The mock LLM then answers
behind the port's ``run_serve`` / ``run_proxy`` as behind the JAX
package's (``tests/test_endpoints.py``).
"""

import ast
import asyncio
import contextlib
import json
from pathlib import Path

import pytest

from p2p_llm_tunnel_tpu_torch.endpoints import http11
from p2p_llm_tunnel_tpu_torch.endpoints.http11 import start_http_server
from p2p_llm_tunnel_tpu_torch.endpoints.proxy import run_proxy
from p2p_llm_tunnel_tpu_torch.endpoints.serve import run_serve
from p2p_llm_tunnel_tpu_torch.testing import create_mock_llm_handler
from p2p_llm_tunnel_tpu_torch.transport import loopback_pair

REPO = Path(__file__).resolve().parent.parent


class _Normalise(ast.NodeTransformer):
    """Drops docstrings and renames the port's package in imports."""

    def _strip_doc(self, node):
        body = node.body
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        return node

    def visit_Module(self, node):
        return self._strip_doc(self.generic_visit(node))

    visit_FunctionDef = visit_AsyncFunctionDef = visit_ClassDef = visit_Module

    def visit_ImportFrom(self, node):
        if node.module:
            node.module = node.module.replace("p2p_llm_tunnel_tpu_torch",
                                              "p2p_llm_tunnel_tpu")
        return node


def _tree(path: Path) -> str:
    return ast.dump(_Normalise().visit(ast.parse(path.read_text())))


@pytest.mark.parametrize("name", ["__init__", "mock_llm", "simple_upstream",
                                  "frame_client"])
def test_copies_equal_the_jax_sources(name):
    port = REPO / "p2p_llm_tunnel_tpu_torch" / "testing" / f"{name}.py"
    ref = REPO / "p2p_llm_tunnel_tpu" / "testing" / f"{name}.py"
    assert _tree(port) == _tree(ref)
    # Nothing of the JAX package is imported.
    for node in ast.walk(ast.parse(port.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module.startswith("p2p"):
            assert node.module.startswith("p2p_llm_tunnel_tpu_torch.")


@contextlib.asynccontextmanager
async def _tunnel(pace_s: float):
    """Mock LLM upstream + the port's serve and proxy over a loopback pair;
    yields the proxy's base URL."""
    upstream = await start_http_server(create_mock_llm_handler(pace_s=pace_s),
                                       "127.0.0.1", 0)
    up_port = upstream.sockets[0].getsockname()[1]
    serve_ch, proxy_ch = loopback_pair()
    ready = asyncio.get_running_loop().create_future()
    tasks = [asyncio.create_task(run_serve(
                 serve_ch, upstream_url=f"http://127.0.0.1:{up_port}",
                 advertise_prefix="/")),
             asyncio.create_task(run_proxy(proxy_ch, "127.0.0.1", 0, ready=ready))]
    try:
        yield f"http://127.0.0.1:{await asyncio.wait_for(ready, 5.0)}"
    finally:
        for t in tasks:
            t.cancel()
        serve_ch.close()
        await asyncio.gather(*tasks, return_exceptions=True)
        upstream.close()
        await upstream.wait_closed()


async def _check_models(base):
    resp = await http11.http_request("GET", f"{base}/v1/models")
    assert resp.status == 200 and b"test-model" in await resp.read_all()


async def _check_health(base):
    resp = await http11.http_request("GET", f"{base}/health")
    assert resp.status == 200 and await resp.read_all() == b"ok"


async def _check_404(base):
    resp = await http11.http_request("GET", f"{base}/nope")
    assert resp.status == 404


async def _check_completion(base):
    resp = await http11.http_request(
        "POST", f"{base}/v1/chat/completions", {"content-type": "application/json"},
        json.dumps({"messages": [], "stream": False}).encode())
    assert resp.status == 200
    obj = json.loads(await resp.read_all())
    assert obj["choices"][0]["message"]["content"] == "Hello from the tunnel!"


async def _check_sse(base):
    async def one():
        resp = await http11.http_request(
            "POST", f"{base}/v1/chat/completions", {},
            json.dumps({"stream": True}).encode())
        assert resp.status == 200
        assert "text/event-stream" in resp.headers.get("content-type", "")
        chunks = [c async for c in resp.iter_chunks()]
        body = b"".join(chunks)
        assert body.strip().endswith(b"data: [DONE]")
        assert body.count(b"data:") == 7  # 5 tokens + finish + DONE
        return len(chunks)

    # Paced chunks arrive as separate chunks, concurrently.
    assert min(await asyncio.gather(*[one() for _ in range(4)])) >= 3


@pytest.mark.parametrize("check", [_check_models, _check_health, _check_404,
                                   _check_completion, _check_sse])
def test_mock_llm_behind_the_ports_tunnel(check):
    async def run():
        async with _tunnel(pace_s=0.02) as base:
            await check(base)

    asyncio.run(run())
