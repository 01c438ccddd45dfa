"""Minimal asyncio HTTP/1.1 server and streaming client.

The reference uses hyper (server, proxy.rs:174-220) and reqwest (client,
serve.rs:219).  This module is the stdlib-only equivalent: enough of
HTTP/1.1 for the tunnel's needs — keep-alive, Content-Length and chunked
bodies in both directions, and *streaming* response bodies (each upstream
flush is surfaced as one chunk, which is what makes SSE token relay work).
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import AsyncIterator, Awaitable, Callable, Dict, Optional, Tuple, Union
from urllib.parse import urlsplit

from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger

log = get_logger(__name__)

MAX_HEADER_BYTES = 64 * 1024
MAX_BODY_BYTES = 64 * 1024 * 1024

BodyLike = Union[bytes, AsyncIterator[bytes]]

REASONS = {
    200: "OK", 201: "Created", 204: "No Content", 400: "Bad Request",
    404: "Not Found", 405: "Method Not Allowed", 500: "Internal Server Error",
    502: "Bad Gateway", 503: "Service Unavailable", 504: "Gateway Timeout",
}


class HttpError(Exception):
    pass


@dataclass
class HttpRequest:
    method: str
    path: str  # path + query, as received
    headers: Dict[str, str]
    body: bytes = b""


@dataclass
class HttpResponse:
    status: int = 200
    headers: Dict[str, str] = field(default_factory=dict)
    body: BodyLike = b""


Handler = Callable[[HttpRequest], Awaitable[HttpResponse]]


def query_flags(path: str) -> "set[str]":
    """The raw ``k=v`` tokens of a request path's query string, order- and
    duplicate-insensitive (``/healthz?trace=1&local=1`` → {"trace=1",
    "local=1"}).  The ONE parser behind the serve/proxy loop-served route
    flags — per-site hand-rolled variants can silently diverge on
    reordered or repeated parameters."""
    return {tok for tok in path.partition("?")[2].split("&") if tok}


def ops_route(method: str, path: str) -> "Optional[Tuple[str, set[str]]]":
    """``(endpoint, flags)`` when the request targets a loop-served
    operational endpoint — ``("healthz" | "metrics", query_flags(path))``
    — else None for ordinary proxied traffic.

    THE shared route parser behind the proxy's and serve loop's
    ``/healthz`` / ``/metrics`` handling: both sites
    used to hand-roll the same method-upper + path-split + flag-membership
    dance, and the ``?fleet=1`` surfaces would have minted a third copy —
    a divergence in any one of them silently changes which requests reach
    the backend.
    """
    if method.upper() != "GET":
        return None
    base = path.partition("?")[0]
    if base not in ("/healthz", "/metrics"):
        return None
    return base[1:], query_flags(path)


# ---------------------------------------------------------------------------
# shared parsing helpers
# ---------------------------------------------------------------------------

class BufReader:
    """StreamReader wrapper with an explicit pushback buffer.

    Header parsing over-reads; bytes past the blank line must be replayed to
    the body reader without touching asyncio private attributes.
    """

    def __init__(self, reader: asyncio.StreamReader):
        self._reader = reader
        self._buf = bytearray()

    def _take(self, n: int) -> bytes:
        out = bytes(self._buf[:n])
        del self._buf[:n]
        return out

    async def read(self, n: int) -> bytes:
        if self._buf:
            return self._take(min(n, len(self._buf)))
        return await self._reader.read(n)

    async def readexactly(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = await self._reader.read(65536)
            if not chunk:
                raise asyncio.IncompleteReadError(bytes(self._buf), n)
            self._buf += chunk
        return self._take(n)

    async def readline(self, limit: int = MAX_HEADER_BYTES) -> bytes:
        while b"\n" not in self._buf:
            if len(self._buf) > limit:
                raise HttpError("line too long")
            chunk = await self._reader.read(65536)
            if not chunk:
                return self._take(len(self._buf))
            self._buf += chunk
        idx = self._buf.index(b"\n") + 1
        return self._take(idx)


async def _read_headers(reader: BufReader) -> Optional[list[bytes]]:
    """Read up to the blank line; returns header lines or None on clean EOF."""
    raw = bytearray()
    while b"\r\n\r\n" not in raw:
        chunk = await reader.read(4096)
        if not chunk:
            if not raw:
                return None
            _fail("truncated headers")
        raw += chunk
        if len(raw) > MAX_HEADER_BYTES:
            _fail("headers too large")
    head, rest = bytes(raw).split(b"\r\n\r\n", 1)
    if rest:
        reader._buf[:0] = rest
    return head.split(b"\r\n")


def _fail(msg: str):
    raise HttpError(msg)


def _parse_header_lines(lines: list[bytes]) -> Dict[str, str]:
    headers: Dict[str, str] = {}
    for line in lines:
        if b":" not in line:
            continue
        k, _, v = line.partition(b":")
        headers[k.decode("latin-1").strip().lower()] = v.decode("latin-1").strip()
    return headers


async def _read_body(reader: BufReader, headers: Dict[str, str]) -> bytes:
    """Fully read a request body (the proxy buffers requests, proxy.rs:280-289)."""
    te = headers.get("transfer-encoding", "").lower()
    if "chunked" in te:
        out = b""
        async for chunk in _iter_chunked(reader):
            out += chunk
            if len(out) > MAX_BODY_BYTES:
                _fail("body too large")
        return out
    try:
        length = int(headers.get("content-length", "0") or "0")
    except ValueError:
        raise HttpError("bad content-length")
    if length < 0 or length > MAX_BODY_BYTES:
        _fail("bad body length")
    return await reader.readexactly(length) if length else b""


async def _iter_chunked(reader: BufReader) -> AsyncIterator[bytes]:
    while True:
        size_line = await reader.readline()
        if not size_line:
            _fail("truncated chunked body")
        try:
            size = int(size_line.strip().split(b";")[0], 16)
        except ValueError:
            raise HttpError(f"bad chunk size line: {size_line[:64]!r}")
        if size < 0 or size > MAX_BODY_BYTES:
            _fail("chunk size out of bounds")
        if size == 0:
            # consume trailer lines until blank
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
            return
        data = await reader.readexactly(size)
        await reader.readexactly(2)  # CRLF
        yield data


# ---------------------------------------------------------------------------
# server
# ---------------------------------------------------------------------------

async def _write_response(writer: asyncio.StreamWriter, resp: HttpResponse) -> None:
    reason = REASONS.get(resp.status, "Unknown")
    lines = [f"HTTP/1.1 {resp.status} {reason}"]
    headers = {k.lower(): v for k, v in resp.headers.items()}
    headers.pop("connection", None)

    if isinstance(resp.body, (bytes, bytearray)):
        headers.setdefault("content-length", str(len(resp.body)))
        for k, v in headers.items():
            lines.append(f"{k}: {v}")
        writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))
        if resp.body:
            writer.write(bytes(resp.body))
        await writer.drain()
        return

    # Streaming body → chunked transfer, flushed per chunk (SSE relies on it).
    headers.pop("content-length", None)
    headers["transfer-encoding"] = "chunked"
    for k, v in headers.items():
        lines.append(f"{k}: {v}")
    writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1"))
    await writer.drain()
    try:
        async for chunk in resp.body:
            if not chunk:
                continue
            writer.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
            await writer.drain()
    finally:
        writer.write(b"0\r\n\r\n")
        await writer.drain()


async def _serve_connection(
    handler: Handler, raw_reader: asyncio.StreamReader, writer: asyncio.StreamWriter
) -> None:
    reader = BufReader(raw_reader)
    try:
        while True:
            lines = await _read_headers(reader)
            if lines is None:
                return  # client closed between requests
            request_line = lines[0].decode("latin-1")
            parts = request_line.split(" ")
            if len(parts) < 3:
                raise HttpError(f"bad request line: {request_line!r}")
            method, target = parts[0], parts[1]
            headers = _parse_header_lines(lines[1:])
            body = await _read_body(reader, headers)
            req = HttpRequest(method=method, path=target, headers=headers, body=body)
            try:
                resp = await handler(req)
            except Exception as e:  # handler bug → 500, keep the connection log
                log.exception("handler error for %s %s", method, target)
                resp = HttpResponse(500, {"content-type": "text/plain"}, f"internal error: {e}".encode())
            await _write_response(writer, resp)
            if headers.get("connection", "").lower() == "close":
                return
    except (HttpError, asyncio.IncompleteReadError, ConnectionError) as e:
        log.debug("connection ended: %s", e)
    finally:
        try:
            writer.close()
        except Exception:
            pass


async def start_http_server(handler: Handler, host: str, port: int) -> asyncio.AbstractServer:
    """Bind a streaming HTTP/1.1 server; returns the asyncio server handle."""
    async def on_conn(reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        await _serve_connection(handler, reader, writer)

    server = await asyncio.start_server(on_conn, host, port)
    return server


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class ClientResponse:
    """A streaming HTTP response: status, headers, and an async chunk iterator."""

    def __init__(self, status: int, headers: Dict[str, str],
                 reader: BufReader, writer: asyncio.StreamWriter):
        self.status = status
        self.headers = headers
        self._reader = reader
        self._writer = writer

    async def iter_chunks(self) -> AsyncIterator[bytes]:
        """Yield body chunks as the upstream flushes them."""
        try:
            te = self.headers.get("transfer-encoding", "").lower()
            if "chunked" in te:
                async for chunk in _iter_chunked(self._reader):
                    yield chunk
            elif "content-length" in self.headers:
                remaining = int(self.headers["content-length"])
                while remaining > 0:
                    chunk = await self._reader.read(min(65536, remaining))
                    if not chunk:
                        _fail("upstream closed mid-body")
                    remaining -= len(chunk)
                    yield chunk
            else:
                # Read until close (HTTP/1.0-style streaming).
                while True:
                    chunk = await self._reader.read(65536)
                    if not chunk:
                        return
                    yield chunk
        finally:
            self.close()

    async def read_all(self) -> bytes:
        out = b""
        async for chunk in self.iter_chunks():
            out += chunk
        return out

    def close(self) -> None:
        try:
            self._writer.close()
        except Exception:
            pass


async def http_request(
    method: str,
    url: str,
    headers: Optional[Dict[str, str]] = None,
    body: bytes = b"",
    timeout: float = 30.0,
) -> ClientResponse:
    """Open a one-shot HTTP/1.1 request; response body streams via iter_chunks."""
    parts = urlsplit(url)
    if parts.scheme not in ("http", ""):
        raise HttpError(f"unsupported scheme: {parts.scheme}")
    host = parts.hostname or "127.0.0.1"
    port = parts.port or 80
    path = parts.path or "/"
    if parts.query:
        path += "?" + parts.query

    raw_reader, writer = await asyncio.wait_for(asyncio.open_connection(host, port), timeout)
    reader = BufReader(raw_reader)
    hdrs = {k.lower(): v for k, v in (headers or {}).items()}
    hdrs.setdefault("host", f"{host}:{port}")
    hdrs["connection"] = "close"
    hdrs.pop("transfer-encoding", None)
    hdrs["content-length"] = str(len(body))

    lines = [f"{method} {path} HTTP/1.1"]
    lines += [f"{k}: {v}" for k, v in hdrs.items()]
    writer.write(("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body)
    await writer.drain()

    status_headers = await asyncio.wait_for(_read_headers(reader), timeout)
    if status_headers is None:
        raise HttpError("upstream closed before response")
    status_line = status_headers[0].decode("latin-1")
    try:
        status = int(status_line.split(" ")[1])
    except (IndexError, ValueError):
        raise HttpError(f"bad status line: {status_line!r}")
    resp_headers = _parse_header_lines(status_headers[1:])
    return ClientResponse(status, resp_headers, reader, writer)
