"""OpenAI- and Ollama-shaped API over the in-process engine.

This is the serve-endpoint backend that replaces the reference's external
HTTP hop (serve.rs:219): instead of forwarding frames to an upstream LLM
server, requests terminate here and stream straight out of the TPU decode
loop — one RES_BODY frame per SSE event.

Surfaces (BASELINE.md configs):
- OpenAI: GET /v1/models, POST /v1/chat/completions, POST /v1/completions
  (stream + non-stream; temperature/top_k/top_p, frequency_penalty/
  presence_penalty over generated tokens, string `stop` sequences with
  boundary-safe matching, logprobs/top_logprobs — chat shape + legacy
  completions shape — stream_options.include_usage, legacy `echo` with
  prompt logprobs incl. max_tokens=0 pure scoring, ignore_eos, `n`
  samples per prompt, batched legacy prompts — list of strings /
  token ids / token-id lists, each choice indexed, all generations
  sharing one continuous batch — per-request `seed` with
  batch-composition-independent reproducibility, and `logit_bias`
  applied on-device)
- Ollama: GET /api/tags, /api/version, POST /api/show, /api/generate,
  /api/chat (NDJSON streaming; options.stop/num_predict (incl. -1/-2/0
  sentinels)/temperature/top_k/top_p/seed), /api/embed + legacy
  /api/embeddings (mean-pooled normalized final hidden states; also
  OpenAI /v1/embeddings)
- GET /health

SSE chunk shape matches the conformance fixture tmp/mock_llm.py:36-88.
"""

from __future__ import annotations

import json
import time
from typing import AsyncIterator, Dict, Tuple

from p2p_llm_tunnel_tpu_torch.engine.engine import DeadlineExceeded, InferenceEngine
from p2p_llm_tunnel_tpu_torch.engine.scheduler import QueueFull
from p2p_llm_tunnel_tpu_torch.protocol.frames import (
    ERROR_CODE_HEADER,
    RequestHeaders,
    parse_deadline_ms,
    parse_tenant,
)
from p2p_llm_tunnel_tpu_torch.utils.logging import get_logger
from p2p_llm_tunnel_tpu_torch.utils.tracing import parse_trace_context

log = get_logger(__name__)

_JSON = {"content-type": "application/json"}
_SSE = {"content-type": "text/event-stream", "cache-control": "no-cache"}
_NDJSON = {"content-type": "application/x-ndjson"}


async def _once(data: bytes) -> AsyncIterator[bytes]:
    yield data


def _json_response(status: int, obj) -> Tuple[int, Dict[str, str], AsyncIterator[bytes]]:
    return status, dict(_JSON), _once(json.dumps(obj).encode())


def _error(status: int, message: str):
    return _json_response(status, {"error": {"message": message, "type": "invalid_request_error"}})


def _overloaded(retry_after_s: float = 1.0, code: str = "busy"):
    """HTTP 429 + Retry-After: shed, don't buffer (the goodput argument of
    DistServe/AlignedServe, PAPERS.md).

    ``retry_after_s`` is the queue-depth-derived advisory (engine
    retry_after_s()), never a constant; ``code`` is the typed tunnel-error
    vocabulary entry ("busy" for a full global queue, "tenant_overlimit"
    when THIS tenant is over its fair share) — carried in the
    x-tunnel-error-code response header so the serve loop can follow the
    relayed 429 with the matching typed ERROR frame.
    """
    if code == "tenant_overlimit":
        msg = ("tenant over fair-share limit: this API key is consuming "
               "more than its weighted share of a contended server")
    elif code == "memory":
        msg = ("server memory exhausted: KV cache pool and host spill "
               "tier are both full; retry after the advertised backoff "
               "or against another peer")
    else:
        msg = "server overloaded: admission queue full"
    status, headers, it = _json_response(
        429, {"error": {"message": msg, "type": "overloaded_error"}},
    )
    headers["retry-after"] = str(max(1, int(retry_after_s + 0.5)))
    headers[ERROR_CODE_HEADER] = code
    return status, headers, it


def _timeout(message: str):
    return _json_response(
        504, {"error": {"message": message or "deadline exceeded",
                        "type": "timeout_error"}},
    )


def render_chat_prompt(messages) -> str:
    """Flatten an OpenAI messages list into a plain prompt.

    Deliberately template-minimal: real chat templates are tokenizer-specific
    and belong to the checkpoint adapter; this keeps the byte-level path
    deterministic.

    Assistant turns render as ``assistant:<content>`` — NO space after the
    cue — because generation continues the bare ``assistant:`` cue
    directly: a turn-N+1 request that resends the conversation then
    re-renders to a BYTE-EXACT extension of turn-N's prompt + response
    stream, which is what lets the conversation cache match a
    returning user's history page-for-page instead of re-prefilling it.
    """
    parts = []
    for m in messages:
        role = m.get("role", "user")
        content = m.get("content", "")
        if role == "assistant":
            parts.append(f"assistant:{content}")
        else:
            parts.append(f"{role}: {content}")
    parts.append("assistant:")
    return "\n".join(parts)


class _StopMatcher:
    """Boundary-safe string-stop detection over a token text stream.

    OpenAI's ``stop`` sequences are strings that may span token (and SSE
    chunk) boundaries; text that could be the PREFIX of a stop is held back
    until disambiguated, so clients never see any part of a stop sequence
    (the same contract Ollama/OpenAI upstreams give the reference tunnel).
    """

    def __init__(self, stops):
        self._stops = [s for s in (stops or []) if s]
        self._hold_max = max((len(s) for s in self._stops), default=1) - 1
        self._buf = ""

    def feed(self, text: str):
        """Returns (emittable_text, stopped)."""
        if not self._stops:
            return text, False
        self._buf += text
        first = -1
        for s in self._stops:
            i = self._buf.find(s)
            if i != -1 and (first == -1 or i < first):
                first = i
        if first != -1:
            out, self._buf = self._buf[:first], ""
            return out, True
        hold = 0
        if self._hold_max > 0:
            for s in self._stops:
                for k in range(min(len(s) - 1, len(self._buf)), hold, -1):
                    if self._buf.endswith(s[:k]):
                        hold = k
                        break
        cut = len(self._buf) - hold
        out, self._buf = self._buf[:cut], self._buf[cut:]
        return out, False

    def flush(self) -> str:
        """End of stream: held text was not a stop after all — emit it."""
        out, self._buf = self._buf, ""
        return out


def _legacy_lp_obj(tokenizer, events, n_top: int) -> dict:
    """Legacy /v1/completions logprobs arrays (stream + non-stream)."""
    return {
        "tokens": [tokenizer.decode_token(e.token_id) for e in events],
        "token_logprobs": [e.logprob for e in events],
        "top_logprobs": [
            {tokenizer.decode_token(tid): tlp
             for tid, tlp in (e.top_logprobs or [])[:n_top]}
            for e in events
        ],
    }


def _usage(prompt_tokens: int, n_tokens: int) -> dict:
    """The one place the usage shape lives (all three response paths)."""
    return {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": n_tokens,
        "total_tokens": prompt_tokens + n_tokens,
    }


def _lp_entry(tokenizer, ev, n_top: int) -> dict:
    """One OpenAI chat-shape logprobs entry for a token event, with the
    alternatives sliced to the REQUESTED count (which may be zero even when
    the chosen-token logprob was computed)."""
    return {
        "token": tokenizer.decode_token(ev.token_id),
        "logprob": ev.logprob,
        "top_logprobs": [
            {"token": tokenizer.decode_token(tid), "logprob": tlp}
            for tid, tlp in (ev.top_logprobs or [])[:n_top]
        ],
    }


class EngineAPI:
    """Routes tunneled requests to the engine; one instance per serve peer."""

    def __init__(self, engine: InferenceEngine, model_name: str | None = None):
        self.engine = engine
        self.model_name = model_name or engine.mcfg.name

    # -- shared generation plumbing --------------------------------------

    def _gen_kwargs(self, body: dict):
        """Extract sampling/generation controls; raises ValueError on invalid
        values so the router can 400 *before* any stream starts.

        Returns (engine_kwargs, n_top): ``n_top`` is how many top-logprob
        ALTERNATIVES the response should render per token — distinct from
        the engine gate (kwargs['logprobs']), which is >=1 whenever any
        logprob reporting is on (the chosen-token logprob needs the device
        computation even with zero alternatives requested).

        Ollama clients nest their sampling knobs under ``options`` (the
        Modelfile parameter names); those are honored as fallbacks so
        /api/generate and /api/chat behave like a real Ollama upstream
        (num_predict/temperature/top_k/top_p — options.stop is handled in
        _stop_strings).  Top-level OpenAI names win when both are given."""
        opts = body.get("options")
        opts = opts if isinstance(opts, dict) else {}

        def field(name, ollama_name=None):
            v = body.get(name)
            return opts.get(ollama_name or name) if v is None else v

        max_tokens = body.get("max_tokens")
        if max_tokens is None:
            max_tokens = body.get("max_new_tokens")
        if max_tokens is None:
            np_opt = opts.get("num_predict")
            if np_opt is not None and int(np_opt) < 0:
                # Ollama sentinels: -1 = unlimited, -2 = fill context.
                # Both mean "up to the context bound" here (the engine
                # stops at max_seq regardless).
                max_tokens = self.engine.ecfg.max_seq
            else:
                max_tokens = np_opt
        max_tokens = 64 if max_tokens is None else int(max_tokens)
        # max_tokens=0 is the pure-scoring form (lm-eval-harness style
        # loglikelihood: prompt + echo + logprobs, no generation); the
        # engine still samples one throwaway token, the response omits it.
        score_only = max_tokens == 0 and bool(body.get("echo"))
        if score_only:
            max_tokens = 1
        if max_tokens < 1:
            raise ValueError(
                "max_tokens must be >= 1 (0 is allowed only with echo)"
            )
        temperature = float(field("temperature") or 0.0)
        if temperature < 0:
            raise ValueError("temperature must be >= 0")
        freq_pen = float(body.get("frequency_penalty") or 0.0)
        pres_pen = float(body.get("presence_penalty") or 0.0)
        if not (-2.0 <= freq_pen <= 2.0 and -2.0 <= pres_pen <= 2.0):
            raise ValueError("penalties must be in [-2, 2]")
        # OpenAI: chat uses logprobs(bool)+top_logprobs(int); completions
        # uses logprobs(int).  Normalize to one int (0 = off); requesting
        # logprobs without top_logprobs still returns the chosen-token
        # logprob (n=... clamped to >=1 when the bool is set).
        from p2p_llm_tunnel_tpu_torch.engine.sampling import TOP_LOGPROBS_CAP

        raw_lp = body.get("logprobs")
        if body.get("top_logprobs") is not None and not (raw_lp is True):
            raise ValueError("top_logprobs requires logprobs to be true")
        if isinstance(raw_lp, bool):
            n_top = int(body.get("top_logprobs") or 0) if raw_lp else 0
            lp_on = raw_lp
        elif raw_lp is None:
            n_top, lp_on = 0, False
        else:
            # Legacy /v1/completions: logprobs=N (N may be 0 = chosen-token
            # logprob only, no alternatives).
            n_top, lp_on = int(raw_lp), True
        if not 0 <= n_top <= TOP_LOGPROBS_CAP:
            raise ValueError(
                f"logprobs/top_logprobs must be in [0, {TOP_LOGPROBS_CAP}]"
            )
        # Engine gate: >=1 enables the device-side logprob computation; the
        # RESPONSE slices alternatives to n_top (possibly zero).
        n_lp = max(1, n_top) if lp_on else 0
        echo = bool(body.get("echo"))
        kwargs = dict(
            max_new_tokens=max_tokens,
            temperature=temperature,
            top_k=int(field("top_k") or 0),
            top_p=float(field("top_p") if field("top_p") is not None else 1.0),
            freq_pen=freq_pen,
            pres_pen=pres_pen,
            logprobs=n_lp,
        )
        if body.get("ignore_eos"):  # vLLM-style benchmarking knob
            kwargs["stop_ids"] = ()
        seed = field("seed")  # OpenAI `seed` / Ollama options.seed
        if seed is not None:
            kwargs["seed"] = int(seed)
        lb = body.get("logit_bias")
        if lb:
            if not isinstance(lb, dict):
                raise ValueError("logit_bias must be an object")
            if len(lb) > 300:
                raise ValueError("logit_bias supports at most 300 entries")
            vocab = self.engine.mcfg.vocab_size
            entries = []
            for k, v in lb.items():
                t = int(k)
                if not 0 <= t < vocab:
                    raise ValueError(
                        f"logit_bias token {t} outside vocab [0, {vocab})"
                    )
                # OpenAI clamps to [-100, 100]
                entries.append((t, max(-100.0, min(100.0, float(v)))))
            kwargs["logit_bias"] = tuple(entries)
        return kwargs, n_top, echo, score_only

    @staticmethod
    def _stop_strings(body: dict) -> list:
        """OpenAI ``stop`` (str | [str]) or Ollama ``options.stop``."""
        stop = body.get("stop")
        if stop is None and isinstance(body.get("options"), dict):
            stop = body["options"].get("stop")
        if stop is None:
            return []
        if isinstance(stop, str):
            return [stop]
        if isinstance(stop, list) and all(isinstance(s, str) for s in stop):
            return [s for s in stop if s]
        raise ValueError("stop must be a string or a list of strings")

    async def _events(self, prompt_ids, kwargs, stops):
        """Engine stream with string-stop handling applied.

        Yields ``(text, ev, finish)`` per engine token event: ``text`` is
        what may be emitted now (may be '' while a potential stop prefix is
        held), ``finish`` is None mid-stream and set exactly once on the
        final yield ('stop' for stop strings/tokens, 'length', ...).
        """
        m = _StopMatcher(stops)
        gen = self.engine.generate(prompt_ids, **kwargs)
        try:
            async for ev in gen:
                text, hit = m.feed(ev.text) if ev.text else ("", False)
                if hit:
                    yield text, ev, "stop"
                    return
                if ev.finish_reason is not None:
                    yield text + m.flush(), ev, ev.finish_reason
                    return
                yield text, ev, None
        finally:
            # Deterministic teardown on early exit (stop hit, consumer
            # cancel): generate()'s finally frees the batch slot NOW, not
            # whenever the asyncgen finalizer happens to collect it.
            await gen.aclose()

    def _chat_prompt_ids(self, messages) -> list:
        """Tokenize a chat: the tokenizer's OWN chat template when it has
        one (HFTokenizer on a real checkpoint — the rendering the model was
        tuned on), else the generic role-prefixed flattening
        (render_chat_prompt; byte/numeric tokenizers, template-less HF)."""
        tok = self.engine.tokenizer
        apply = getattr(tok, "apply_chat_template", None)
        if apply is not None:
            try:
                ids = apply(messages)
            except (ValueError, TypeError):
                raise
            except Exception as e:
                # Real templates reject messages via jinja raise_exception
                # (gemma: system role; llama-2: non-alternating roles) — a
                # TemplateError the router wouldn't map to 400.  It IS an
                # invalid-request error: surface it as one.
                raise ValueError(f"chat template rejected messages: {e}")
            if ids is not None:
                return ids
        return tok.encode(render_chat_prompt(messages))

    def _check_prompt(self, prompt_ids) -> None:
        """Reject unservable prompts eagerly (scheduler would raise lazily,
        after a streaming 200 has already gone out)."""
        if not prompt_ids:
            raise ValueError("prompt must be non-empty")
        max_seq = self.engine.ecfg.max_seq
        if len(prompt_ids) >= max_seq:
            raise ValueError(
                f"prompt of {len(prompt_ids)} tokens exceeds max context {max_seq}"
            )

    def _request_prompt_ids(self, path: str, payload: dict) -> list:
        """The prompt token ids a generation request at ``path`` would
        prefill — the same tokenization handle() runs, factored out so the
        disagg export path computes KV for EXACTLY the prompt
        the decode peer will serve."""
        if path in ("/v1/chat/completions", "/api/chat"):
            messages = payload.get("messages")
            if not isinstance(messages, list):
                raise ValueError("messages must be a list")
            return self._chat_prompt_ids(messages)
        if path == "/v1/completions":
            prompts = self._parse_prompts(payload.get("prompt", ""))
            return prompts[0] if prompts else []
        if path == "/api/generate":
            return self.engine.tokenizer.encode(
                str(payload.get("prompt", ""))
            )
        raise ValueError(f"path {path} has no prompt to export KV for")

    async def kv_export(self, req: RequestHeaders, body: bytes):
        """Prefill-role export entry: parse the request exactly
        like handle() would, run admission + prefill for ONE token so the
        prompt's pages land in the pool (ragged/chunked/mux paths all
        unchanged — this IS a normal generation, truncated), then export
        the resident chain prefix for the wire.

        Returns the engine's export dict, or None when there is nothing
        to ship — parse failure, admission shed, empty pool.  None means
        "dispatch without pages" to the orchestrator; disaggregation must
        never fail a request that plain routing would have served."""
        try:
            payload = json.loads(body or b"{}")
            if not isinstance(payload, dict):
                return None
            prompt_ids = self._request_prompt_ids(req.path, payload)
            self._check_prompt(prompt_ids)
            tenant = parse_tenant(req.headers)
            if self.engine.admission_check(1, tenant) is not None:
                return None
            kwargs: dict = {"max_new_tokens": 1, "temperature": 0.0}
            if tenant:
                kwargs["tenant"] = tenant
            deadline_ms = parse_deadline_ms(req.headers)
            if deadline_ms is not None:
                kwargs["deadline"] = (
                    time.monotonic() + deadline_ms / 1000.0
                )
            gen = self.engine.generate(prompt_ids, **kwargs)
            try:
                async for _ev in gen:
                    pass
            finally:
                await gen.aclose()
            return await self.engine.export_kv_pages(prompt_ids)
        except (QueueFull, DeadlineExceeded, ValueError, TypeError,
                json.JSONDecodeError):
            return None

    # -- OpenAI ----------------------------------------------------------

    def _models_payload(self):
        return {
            "object": "list",
            "data": [{"id": self.model_name, "object": "model", "owned_by": "p2p-llm-tunnel-tpu"}],
        }

    async def _openai_stream(
        self, prompt_ids, kwargs, stops, n_top: int, chat: bool,
        object_name: str, completion_id: str, include_usage: bool = False,
    ) -> AsyncIterator[bytes]:
        # Per-token cost matters at 1800+ tok/s x 32 streams: fold the
        # stream-constant envelope once and splice only the delta/finish in.
        # ``created`` is stamped once per stream (OpenAI semantics: chunks of
        # one completion share a created time).
        created = int(time.time())  # shared by EVERY chunk of this stream
        # Per the OpenAI spec, when include_usage is on every non-final
        # chunk carries "usage": null; the final chunk carries the totals.
        tail = ', "usage": null}' if include_usage else "}"
        # Chunk grammar per endpoint family (legacy completion
        # streams must carry choices[].text — object "text_completion" —
        # not chat-style delta objects, or OpenAI-SDK clients reading
        # .choices[0].text get nothing).
        head = (
            'data: {"id": ' + json.dumps(completion_id)
            + ', "object": ' + json.dumps(object_name)
            + f', "created": {created}'
            + ', "model": ' + json.dumps(self.model_name)
            + ', "choices": [{"index": 0, '
            + ('"delta": ' if chat else '"text": ')
        )

        def chunk(delta, finish):
            return (
                head + json.dumps(delta) + ', "finish_reason": '
                + json.dumps(finish) + "}]" + tail + "\n\n"
            ).encode()

        content_head = head + ('{"content": ' if chat else "")
        content_tail = (
            ('}' if chat else ', "logprobs": null')
            + ', "finish_reason": null}]' + tail + "\n\n"
        )

        def content_chunk(text):  # the hot path: one per decoded token
            return (content_head + json.dumps(text) + content_tail).encode()

        def legacy_chunk(text, lp_obj, finish):
            return (
                head + json.dumps(text)
                + ', "logprobs": ' + json.dumps(lp_obj)
                + ', "finish_reason": ' + json.dumps(finish)
                + "}]" + tail + "\n\n"
            ).encode()

        tok = self.engine.tokenizer

        def lp_obj_of(events):
            # Logprobs shape per endpoint family: chat chunks carry the
            # modern {"content": [...]} object; legacy completions chunks
            # carry the tokens/token_logprobs/top_logprobs arrays — the
            # SAME shapes their non-stream counterparts return.
            if chat:
                return {"content": [_lp_entry(tok, e, n_top) for e in events]}
            return _legacy_lp_obj(tok, events, n_top)

        def lp_chunk(text, events):
            return (
                head + json.dumps({"content": text})
                + ', "logprobs": ' + json.dumps(lp_obj_of(events))
                + ', "finish_reason": null}]' + tail + "\n\n"
            ).encode()

        finish_reason = "stop"
        first = True
        n_tokens = 0
        pending_lp = []  # events for tokens whose text is still held
        try:
            async for text, ev, finish in self._events(prompt_ids, kwargs,
                                                       stops):
                if ev is not None:
                    n_tokens += 1
                if first and chat:
                    # OpenAI chat streams open with a role-only delta chunk;
                    # emitting it when the FIRST token lands (not at accept)
                    # also gives clients an honest time-to-first-token signal
                    # even when the token's text is empty (mid-codepoint
                    # byte, special id).  Legacy streams have no role chunk.
                    yield chunk({"role": "assistant"}, None)
                first = False
                if ev is not None and ev.logprob is not None:
                    pending_lp.append(ev)
                if text:
                    if pending_lp:
                        yield lp_chunk(text, pending_lp) if chat else \
                            legacy_chunk(text, lp_obj_of(pending_lp), None)
                        pending_lp = []
                    else:
                        yield content_chunk(text)
                if finish is not None:
                    finish_reason = finish
        except (QueueFull, DeadlineExceeded) as e:
            # Same contract as _openai_stream_multi's per-choice handling:
            # the 200/SSE headers are already on the wire, so a mid-queue
            # shed (tenant-fair displacement) or deadline eviction must end
            # the stream with the typed code as its finish_reason — not
            # propagate and truncate the body mid-stream, which a plain
            # HTTP client can't tell apart from a dropped connection.
            finish_reason = getattr(e, "tunnel_code", None) or "error"
        if pending_lp:
            # Entries whose text never emitted (mid-codepoint final byte,
            # zero-text stop): attach them to the final chunk so stream and
            # non-stream logprob counts agree.
            if chat:
                yield (
                    head + json.dumps({})
                    + ', "logprobs": ' + json.dumps(lp_obj_of(pending_lp))
                    + ', "finish_reason": ' + json.dumps(finish_reason)
                    + "}]" + tail + "\n\n"
                ).encode()
            else:
                yield legacy_chunk("", lp_obj_of(pending_lp), finish_reason)
        else:
            yield chunk({}, finish_reason) if chat else \
                legacy_chunk("", None, finish_reason)
        if include_usage:
            # OpenAI stream_options.include_usage: one final chunk with
            # empty choices and the usage totals.
            yield ("data: " + json.dumps({
                "id": completion_id, "object": object_name,
                "created": created, "model": self.model_name,
                "choices": [],
                "usage": _usage(len(prompt_ids), n_tokens),
            }) + "\n\n").encode()
        yield b"data: [DONE]\n\n"

    def _parse_prompts(self, raw) -> list:
        """OpenAI legacy ``prompt``: str | [str, ...] | [int, ...] |
        [[int, ...], ...] -> list of token-id prompts (one completion
        choice per entry × n).  Token-id forms serve pre-tokenized
        clients (lm-eval loglikelihood batches); only THEY get the vocab
        range check — server-tokenized ids are valid by construction."""
        enc = self.engine.tokenizer.encode

        def ints(xs):
            return xs and all(
                isinstance(t, int) and not isinstance(t, bool) for t in xs
            )

        def checked(ids):
            vocab = self.engine.mcfg.vocab_size
            if ids and not 0 <= min(ids) <= max(ids) < vocab:
                raise ValueError(f"token ids outside vocab [0, {vocab})")
            return list(ids)

        if isinstance(raw, str):
            return [enc(raw)]
        if isinstance(raw, list):
            if not raw:
                raise ValueError("prompt must be non-empty")
            if all(isinstance(x, str) for x in raw):
                return [enc(x) for x in raw]
            if ints(raw):
                return [checked(raw)]
            if all(isinstance(x, list) and ints(x) for x in raw):
                return [checked(x) for x in raw]
        raise ValueError(
            "prompt must be a string, list of strings, list of token ids, "
            "or list of token-id lists"
        )

    async def _openai_stream_multi(
        self, prompts, n, kwargs, stops, n_top: int, chat: bool,
        object_name: str, completion_id: str, include_usage: bool,
    ) -> AsyncIterator[bytes]:
        """Merged SSE stream over multiple (prompt, sample) runs.

        Every chunk carries its choice ``index``; chunks interleave across
        choices in token-arrival order (the runs share the continuous
        batch), per-choice order is preserved.  The single-run path keeps
        the envelope-folded `_openai_stream` — this generator trades that
        micro-optimization for generality."""
        import asyncio as _aio

        created = int(time.time())
        runs = [pids for pids in prompts for _ in range(n)]
        queue: "_aio.Queue" = _aio.Queue()

        def run_kwargs(i):
            # Same per-run seed offsetting as the non-stream path.
            if "seed" not in kwargs or len(runs) == 1:
                return kwargs
            return dict(kwargs, seed=kwargs["seed"] + i)

        async def pump(i, pids):
            try:
                async for item in self._events(pids, run_kwargs(i), stops):
                    await queue.put((i, item))
            except (QueueFull, DeadlineExceeded) as e:
                # A mid-queue shed (tenant-fair displacement) or deadline
                # eviction of ONE choice must not masquerade as a clean
                # "stop": the merged stream cannot abort its siblings, so
                # the typed code becomes this choice's finish_reason.
                await queue.put(
                    (i, (None, None, getattr(e, "tunnel_code", "error")))
                )
            finally:
                await queue.put((i, None))

        tasks = [
            _aio.create_task(pump(i, pids)) for i, pids in enumerate(runs)
        ]
        tok = self.engine.tokenizer

        def chunk_of(choice, usage=None):
            obj = {
                "id": completion_id, "object": object_name,
                "created": created, "model": self.model_name,
                "choices": [choice] if choice is not None else [],
            }
            if include_usage:
                obj["usage"] = usage
            return ("data: " + json.dumps(obj) + "\n\n").encode()

        def lp_obj_of(events):
            if chat:
                return {"content": [_lp_entry(tok, e, n_top) for e in events]}
            return _legacy_lp_obj(tok, events, n_top)

        first = [True] * len(runs)
        finish_of = ["stop"] * len(runs)
        pending_lp = [[] for _ in runs]
        n_tokens = 0
        live = len(runs)
        try:
            while live:
                i, item = await queue.get()
                if item is None:
                    live -= 1
                    lps = pending_lp[i]
                    if chat:
                        c = {"index": i, "delta": {},
                             "finish_reason": finish_of[i]}
                        if lps:
                            c["logprobs"] = lp_obj_of(lps)
                    else:
                        c = {"index": i, "text": "",
                             "logprobs": lp_obj_of(lps) if lps else None,
                             "finish_reason": finish_of[i]}
                    yield chunk_of(c)
                    continue
                text, ev, finish = item
                if ev is not None:
                    n_tokens += 1
                    if ev.logprob is not None:
                        pending_lp[i].append(ev)
                if first[i]:
                    first[i] = False
                    if chat:
                        yield chunk_of({"index": i,
                                        "delta": {"role": "assistant"},
                                        "finish_reason": None})
                if finish is not None:
                    finish_of[i] = finish
                if text:
                    lps = pending_lp[i]
                    pending_lp[i] = []
                    if chat:
                        c = {"index": i, "delta": {"content": text},
                             "finish_reason": None}
                        if lps:
                            c["logprobs"] = lp_obj_of(lps)
                    else:
                        c = {"index": i, "text": text,
                             "logprobs": lp_obj_of(lps) if lps else None,
                             "finish_reason": None}
                    yield chunk_of(c)
            if include_usage:
                pt = sum(len(p) for p in prompts)
                yield chunk_of(None, usage=_usage(pt, n_tokens))
            yield b"data: [DONE]\n\n"
        finally:
            for t in tasks:
                t.cancel()
            for t in tasks:
                try:
                    await t
                except BaseException:
                    pass

    async def _collect(self, prompt_ids, kwargs, stops, score_only=False):
        """Drain one generation: (content, finish, lp_entries, prompt_lps,
        n_tokens)."""
        parts = []
        finish_reason = "stop"
        n_tokens = 0
        lp_entries = []
        prompt_lps = None
        async for text, ev, finish in self._events(prompt_ids, kwargs, stops):
            n_tokens += 1
            if text:
                parts.append(text)
            if ev is not None and ev.logprob is not None:
                lp_entries.append(ev)
            if ev is not None and ev.prompt_logprobs is not None:
                prompt_lps = ev.prompt_logprobs
            if finish is not None:
                finish_reason = finish
        if score_only:
            # Pure scoring (max_tokens=0 + echo): the single sampled token
            # exists only to drive the engine; the response omits it.
            parts, lp_entries, n_tokens = [], [], 0
            finish_reason = "length"
        return "".join(parts), finish_reason, lp_entries, prompt_lps, n_tokens

    async def _openai_complete(self, prompts, kwargs, stops, n_top: int,
                               chat: bool, echo: bool = False,
                               score_only: bool = False, n: int = 1):
        """Non-stream completion over one or more prompts × n samples.

        ``prompts`` is a list of token-id prompts; choice ``index`` runs
        prompt-major then sample (OpenAI semantics for list prompts + n).
        All generations run CONCURRENTLY through the continuous batch —
        a 4-prompt lm-eval style request occupies 4 slots of one burst,
        not 4 sequential round-trips."""
        import asyncio as _aio

        runs = [pids for pids in prompts for _ in range(n)]

        def run_kwargs(i):
            # An explicit seed must still yield DISTINCT choices across the
            # fan-out: offset it per run (same rule as the stream path).
            if "seed" not in kwargs or len(runs) == 1:
                return kwargs
            return dict(kwargs, seed=kwargs["seed"] + i)

        tasks = [
            _aio.ensure_future(
                self._collect(pids, run_kwargs(i), stops, score_only)
            )
            for i, pids in enumerate(runs)
        ]
        try:
            results = await _aio.gather(*tasks)
        except BaseException:
            # One run failing must not leave siblings generating into the
            # void (they hold batch slots); the stream path's finally does
            # the same for its pump tasks.
            for t in tasks:
                t.cancel()
            await _aio.gather(*tasks, return_exceptions=True)
            raise
        tok = self.engine.tokenizer
        lp_requested = kwargs.get("logprobs", 0) > 0
        choices = []
        total_new = 0
        for i, (pids, (content, finish_reason, lp_entries, prompt_lps,
                       n_tokens)) in enumerate(zip(runs, results)):
            total_new += n_tokens
            if chat:
                choice = {
                    "index": i,
                    "message": {"role": "assistant", "content": content},
                    "finish_reason": finish_reason,
                }
                if lp_requested:
                    # Always present when requested — possibly with an
                    # empty list, never missing.
                    choice["logprobs"] = {"content": [
                        _lp_entry(tok, e, n_top) for e in lp_entries
                    ]}
            else:
                if echo:
                    # Legacy echo: the response text begins with the prompt.
                    content = tok.decode(list(pids)) + content
                choice = {"index": i, "text": content,
                          "finish_reason": finish_reason}
                if lp_requested:
                    lp_obj = _legacy_lp_obj(tok, lp_entries, n_top)
                    if echo and prompt_lps is not None:
                        # Prepend the prompt tokens' scores: the first
                        # prompt token has no context -> null, matching
                        # OpenAI; no alternatives for prompt positions.
                        lp_obj = {
                            "tokens": [tok.decode_token(t) for t in pids]
                            + lp_obj["tokens"],
                            "token_logprobs": [None] + [
                                float(x) for x in prompt_lps[1:]
                            ] + lp_obj["token_logprobs"],
                            "top_logprobs": [None] * len(pids)
                            + lp_obj["top_logprobs"],
                        }
                    choice["logprobs"] = lp_obj
            choices.append(choice)
        # Usage counts each submitted prompt once (n samples share it).
        prompt_tokens = sum(len(p) for p in prompts)
        return _json_response(
            200,
            {
                "id": f"cmpl-{int(time.time() * 1000)}",
                "object": "chat.completion" if chat else "text_completion",
                "created": int(time.time()),
                "model": self.model_name,
                "choices": choices,
                "usage": _usage(prompt_tokens, total_new),
            },
        )

    # -- Ollama ----------------------------------------------------------

    async def _ollama_generate_stream(
        self, prompt_ids, kwargs, stops
    ) -> AsyncIterator[bytes]:
        done_reason = "stop"
        async for text, ev, finish in self._events(prompt_ids, kwargs, stops):
            if finish is not None:
                done_reason = finish
            if text:
                yield (json.dumps(
                    {"model": self.model_name, "response": text, "done": False}
                ) + "\n").encode()
        yield (json.dumps(
            {"model": self.model_name, "response": "", "done": True,
             "done_reason": done_reason}
        ) + "\n").encode()

    async def _ollama_chat_stream(
        self, prompt_ids, kwargs, stops
    ) -> AsyncIterator[bytes]:
        done_reason = "stop"
        async for text, ev, finish in self._events(prompt_ids, kwargs, stops):
            if finish is not None:
                done_reason = finish
            if text:
                yield (json.dumps(
                    {"model": self.model_name,
                     "message": {"role": "assistant", "content": text},
                     "done": False}
                ) + "\n").encode()
        yield (json.dumps(
            {"model": self.model_name,
             "message": {"role": "assistant", "content": ""},
             "done": True, "done_reason": done_reason}
        ) + "\n").encode()

    # -- router ----------------------------------------------------------

    async def handle(self, req: RequestHeaders, body: bytes):
        path = req.path.split("?")[0]
        method = req.method.upper()

        if method == "GET" and path == "/health":
            return 200, {"content-type": "text/plain"}, _once(b"ok")
        if method == "GET" and path == "/metrics":
            # Prometheus text exposition for the full catalog (SURVEY.md
            # §5: the reference greps logs; we expose tok/s, TTFT, queue
            # depth, occupancy as a first-class scrape surface).  The
            # serve loop intercepts /metrics identically for tunneled
            # requests; this route covers direct EngineAPI embedding.
            from p2p_llm_tunnel_tpu_torch.utils.metrics import (
                Metrics,
                global_metrics,
            )
            from p2p_llm_tunnel_tpu_torch.utils.slo import global_slo

            global_slo.publish()  # slo_* series current at every scrape
            return (
                200,
                {"content-type": Metrics.PROM_CONTENT_TYPE},
                _once(global_metrics.prometheus_text().encode()),
            )
        if method == "GET" and path == "/v1/models":
            return _json_response(200, self._models_payload())
        if method == "GET" and path == "/api/tags":
            return _json_response(
                200, {"models": [{"name": self.model_name, "model": self.model_name}]}
            )
        if method == "GET" and path == "/api/version":
            return _json_response(200, {"version": "0.1.0-tpu"})

        if method == "POST" and path == "/api/show":
            # Minimal Ollama model-info surface (clients probe it before
            # chatting); architecture details come from the model config.
            # quantization_level follows Ollama's naming (Q4_0/Q8_0/F16 for
            # our int4/int8-family/bf16) so clients that branch on it —
            # context sizing, capability probes — see the served reality.
            m = self.engine.mcfg
            quant = self.engine.ecfg.quant
            qlevel = {"int4": "Q4_0", "int8": "Q8_0", "w8a8": "Q8_0"}.get(
                quant, "F16"
            )
            return _json_response(200, {
                "modelfile": "",
                "details": {"family": m.name, "parameter_size": "",
                            "quantization_level": qlevel},
                "model_info": {
                    "general.architecture": m.name,
                    "num_layers": m.n_layers,
                    "num_heads": m.n_heads,
                    "num_kv_heads": m.n_kv_heads,
                    "embedding_dim": m.dim,
                    "context_length": self.engine.ecfg.max_seq,
                    "vocab_size": m.vocab_size,
                },
            })

        if method != "POST":
            return _error(405, f"method {method} not allowed on {path}")

        try:
            payload = json.loads(body) if body else {}
        except json.JSONDecodeError as e:
            return _error(400, f"invalid JSON body: {e}")

        if path in ("/v1/embeddings", "/api/embed", "/api/embeddings"):
            # Handled before any generation-param parsing: max_tokens/n/
            # stream knobs are meaningless here and must not 400 a valid
            # embeddings payload.
            try:
                if path == "/v1/embeddings":
                    if payload.get("encoding_format", "float") != "float":
                        return _error(
                            400, "only encoding_format 'float' is supported"
                        )
                    if payload.get("dimensions") is not None:
                        return _error(
                            400, "dimensions is not supported (full-width "
                                 "vectors only)"
                        )
                if path == "/api/embeddings":
                    raw_in = payload.get("prompt", "")
                else:
                    raw_in = payload.get("input", "")
                prompts = self._parse_prompts(raw_in)
                if len(prompts) > 64:
                    return _error(400, "at most 64 inputs per request")
                if path != "/v1/embeddings" and payload.get(
                        "truncate", True):
                    # Ollama semantics: over-length inputs truncate to the
                    # context window by default (truncate=false rejects).
                    limit = self.engine.ecfg.max_seq - 1
                    prompts = [p[:limit] for p in prompts]
                for pids in prompts:
                    self._check_prompt(pids)
            except (ValueError, TypeError) as e:
                return _error(400, str(e))
            vecs = await self.engine.embed(prompts)
            pt = sum(len(p) for p in prompts)
            if path == "/v1/embeddings":
                return _json_response(200, {
                    "object": "list",
                    "model": self.model_name,
                    "data": [
                        {"object": "embedding", "index": i,
                         "embedding": v}
                        for i, v in enumerate(vecs.tolist())
                    ],
                    "usage": {"prompt_tokens": pt, "total_tokens": pt},
                })
            if path == "/api/embed":
                return _json_response(200, {
                    "model": self.model_name,
                    "embeddings": vecs.tolist(),
                })
            # legacy /api/embeddings: single prompt, singular key
            return _json_response(200, {"embedding": vecs[0].tolist()})

        opts_np = payload.get("options")
        opts_np = opts_np.get("num_predict") if isinstance(opts_np, dict) \
            else None
        if path in ("/api/generate", "/api/chat") and opts_np == 0:
            # Ollama semantics: num_predict 0 generates nothing (a real
            # upstream 200s with eval_count 0; our engine needs >=1 token,
            # so short-circuit before _gen_kwargs rejects max_tokens=0).
            body_key = ("response" if path == "/api/generate"
                        else "message")
            body_val = ("" if path == "/api/generate"
                        else {"role": "assistant", "content": ""})
            return _json_response(
                200, {"model": self.model_name, body_key: body_val,
                      "done": True, "done_reason": "length",
                      "eval_count": 0})

        try:
            kwargs, n_top, echo, score_only = self._gen_kwargs(payload)
            tenant = parse_tenant(req.headers)
            if tenant:
                # Fair-admission identity + per-tenant accounting; ""
                # (direct untagged embedding) opts out of both.
                kwargs["tenant"] = tenant
            deadline_ms = parse_deadline_ms(req.headers)
            if deadline_ms is not None:
                # Absolute monotonic deadline: enforced by the scheduler
                # (slot eviction) AND by the serve endpoint (frame path),
                # so neither a stuck engine nor a stalled tunnel can pin
                # the request past its budget.
                kwargs["deadline"] = time.monotonic() + deadline_ms / 1000.0
            tctx = parse_trace_context(req.headers)
            if tctx is not None:
                # Propagated trace context: the engine parents
                # its request spans under the serve-side dispatch span.
                # The recorder decides sampling; passing the context is
                # free when tracing is off.
                kwargs["trace"] = tctx
            stops = self._stop_strings(payload)
            stream = bool(
                payload.get("stream", path == "/api/generate" or path == "/api/chat")
            )
            stream_opts = payload.get("stream_options")
            if stream_opts is not None and not stream:
                return _error(400, "stream_options requires stream to be true")
            include_usage = bool(
                isinstance(stream_opts, dict)
                and stream_opts.get("include_usage")
            )
            raw_n = payload.get("n")
            n_choices = 1 if raw_n is None else int(raw_n)
            if not 1 <= n_choices <= 16:
                return _error(400, "n must be in [1, 16]")
            # Total per-request fan-out cap (prompts x n): the batched
            # prompt-list dimension must not escape the bound n has.
            max_fanout = 16
            # Admission control BEFORE any streaming 200 goes out: a full
            # waiting queue — or a tenant over its fair share of one —
            # means this request would only buffer or displace, so shed it
            # now with 429 + a queue-derived Retry-After.  (QueueFull /
            # TenantOverLimit from a submit race is additionally caught
            # below for the non-stream paths.)
            shed_code = self.engine.admission_check(n_choices, tenant)
            if shed_code is not None:
                if shed_code == "tenant_overlimit":
                    from p2p_llm_tunnel_tpu_torch.utils.metrics import (
                        global_metrics,
                    )

                    global_metrics.tenant_shed(tenant)
                return _overloaded(self.engine.retry_after_s(), shed_code)

            if path == "/v1/chat/completions":
                if echo:
                    return _error(400, "echo is only supported on /v1/completions")
                messages = payload.get("messages")
                if not isinstance(messages, list):
                    return _error(400, "messages must be a list")
                prompt_ids = self._chat_prompt_ids(messages)
                self._check_prompt(prompt_ids)
                if stream:
                    cid = f"chatcmpl-{int(time.time() * 1000)}"
                    if n_choices == 1:
                        return 200, dict(_SSE), self._openai_stream(
                            prompt_ids, kwargs, stops, n_top, True,
                            "chat.completion.chunk", cid, include_usage,
                        )
                    return 200, dict(_SSE), self._openai_stream_multi(
                        [prompt_ids], n_choices, kwargs, stops, n_top,
                        True, "chat.completion.chunk", cid, include_usage,
                    )
                return await self._openai_complete(
                    [prompt_ids], kwargs, stops, n_top, chat=True,
                    n=n_choices,
                )

            if path == "/v1/completions":
                prompts = self._parse_prompts(payload.get("prompt", ""))
                if len(prompts) * n_choices > max_fanout:
                    return _error(
                        400,
                        f"prompts x n = {len(prompts) * n_choices} exceeds "
                        f"the per-request completion cap of {max_fanout}",
                    )
                for pids in prompts:
                    self._check_prompt(pids)
                if stream:
                    if echo:
                        return _error(
                            400, "echo is not supported with stream=true"
                        )
                    cid = f"cmpl-{int(time.time() * 1000)}"
                    # OpenAI legacy streams keep object "text_completion"
                    # (there is no ".chunk" variant in the legacy spec).
                    if len(prompts) == 1 and n_choices == 1:
                        return 200, dict(_SSE), self._openai_stream(
                            prompts[0], kwargs, stops, n_top, False,
                            "text_completion", cid, include_usage,
                        )
                    return 200, dict(_SSE), self._openai_stream_multi(
                        prompts, n_choices, kwargs, stops, n_top, False,
                        "text_completion", cid, include_usage,
                    )
                if echo:
                    # Engage the engine's scoring path only where its output
                    # is consumed (an /api/* body carrying "echo" must not
                    # silently trigger the expensive full-prompt variant).
                    kwargs = dict(
                        kwargs, echo_logprobs=kwargs["logprobs"] > 0,
                    )
                return await self._openai_complete(
                    prompts, kwargs, stops, n_top, chat=False, echo=echo,
                    score_only=score_only, n=n_choices,
                )

            if path == "/api/generate":
                prompt_ids = self.engine.tokenizer.encode(str(payload.get("prompt", "")))
                self._check_prompt(prompt_ids)
                if stream:
                    return 200, dict(_NDJSON), self._ollama_generate_stream(
                        prompt_ids, kwargs, stops
                    )
                text, n, finish = await self._drain(prompt_ids, kwargs, stops)
                return _json_response(
                    200, {"model": self.model_name, "response": text, "done": True,
                          "done_reason": finish, "eval_count": n},
                )

            if path == "/api/chat":
                messages = payload.get("messages") or []
                prompt_ids = self._chat_prompt_ids(messages)
                self._check_prompt(prompt_ids)
                if stream:
                    return 200, dict(_NDJSON), self._ollama_chat_stream(
                        prompt_ids, kwargs, stops
                    )
                text, n, finish = await self._drain(prompt_ids, kwargs, stops)
                return _json_response(
                    200, {"model": self.model_name,
                          "message": {"role": "assistant", "content": text},
                          "done": True, "done_reason": finish, "eval_count": n},
                )
        except QueueFull as e:
            # TenantOverLimit subclasses QueueFull and carries its own
            # typed code; both get the live queue-derived Retry-After.
            return _overloaded(
                self.engine.retry_after_s(),
                getattr(e, "tunnel_code", "busy"),
            )
        except DeadlineExceeded as e:
            return _timeout(str(e))
        except (ValueError, TypeError) as e:
            return _error(400, str(e))

        return _error(404, f"unknown path {path}")

    async def _drain(self, prompt_ids, kwargs, stops):
        parts, n, done = [], 0, "stop"
        async for text, ev, finish in self._events(prompt_ids, kwargs, stops):
            n += 1
            if text:
                parts.append(text)
            if finish is not None:
                done = finish
        return "".join(parts), n, done


def engine_backend(engine: InferenceEngine, model_name: str | None = None):
    """Adapter: EngineAPI as a serve-endpoint Backend (endpoints/serve.py).

    Disaggregation hooks ride as attributes so run_serve can
    discover them with getattr — the Backend callable contract itself is
    unchanged, and http_backend (no engine, no pool) simply has none:
    ``kv_export`` answers a prefill-side page export, ``kv_import``
    splices a transfer into this engine's pool, ``disagg_stats`` feeds
    the /healthz "disagg" section, and ``engine_role`` is stamped into
    the AGREE handshake so the proxy's PeerSet routes by role.
    """
    api = EngineAPI(engine, model_name)

    async def backend(req: RequestHeaders, body: bytes):
        return await api.handle(req, body)

    backend.kv_export = api.kv_export
    backend.kv_import = engine.import_kv_pages
    backend.disagg_stats = engine.disagg_stats
    backend.engine_role = engine.ecfg.role
    return backend
