"""Tokenizers: a dependency-free byte-level tokenizer for tests/benches and
an adapter for HuggingFace tokenizers for real checkpoints."""

from __future__ import annotations

from typing import List, Optional, Protocol


class Tokenizer(Protocol):
    bos_id: int
    eos_id: int

    @property
    def vocab_size(self) -> int: ...

    def encode(self, text: str) -> List[int]: ...

    def decode(self, ids: List[int]) -> str: ...

    def decode_token(self, token_id: int) -> str: ...


class ByteTokenizer:
    """UTF-8 bytes + BOS/EOS/PAD. Deterministic, zero deps, vocab 259.

    ``decode_token`` is incremental-safe for ASCII; multi-byte codepoints are
    buffered by StreamDecoder below.

    ``vocab_size`` can be widened (e.g. to a real model's full vocabulary so
    a benchmark exercises the true embed/lm_head shapes); ids >= 256 decode
    to "" and encode never produces them.
    """

    PAD = 256
    BOS = 257
    EOS = 258

    bos_id = BOS
    eos_id = EOS

    def __init__(self, vocab_size: int = 259):
        self._vocab_size = max(int(vocab_size), 259)

    @property
    def vocab_size(self) -> int:
        return self._vocab_size

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: List[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", "replace")

    def decode_token(self, token_id: int) -> str:
        if token_id >= 256:
            return ""
        return bytes([token_id]).decode("utf-8", "replace")


class Latin1Tokenizer(ByteTokenizer):
    """ByteTokenizer with a BIJECTIVE byte<->text mapping (latin-1).

    Random-weight models generate arbitrary bytes, which the UTF-8
    ByteTokenizer cannot round-trip through client-visible text
    (invalid sequences decode to replacement chars).  Latin-1 maps every
    byte to exactly one codepoint, so a chat client that replays an
    assistant message re-encodes to the EXACT bytes sitting in the KV
    cache — the property the conversation-cache replay experiment
    (loadgen --turns against testing.local_stack) needs to hit
    finished-stream pages with random weights.  Real checkpoints emit
    valid UTF-8 and don't need this.
    """

    def encode(self, text: str) -> List[int]:
        return list(text.encode("latin-1", "replace"))

    def decode(self, ids: List[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("latin-1")

    def decode_token(self, token_id: int) -> str:
        if token_id >= 256:
            return ""
        return bytes([token_id]).decode("latin-1")


class NumericTokenizer:
    """Renders EVERY id as visible text (``"<id> "``), unlike ByteTokenizer
    where ids ≥ 256 decode to "".

    Exists for end-to-end benchmarks with random weights: each decoded token
    becomes a non-empty SSE delta, so every token crosses the tunnel as a
    RES_BODY frame and client-side counts equal engine counts — making frame
    mux, flow control, and SSE emission part of the measurement (the loop
    replaced is reference serve.rs:263-277).  Encoding is
    byte-level like ByteTokenizer so prompts stay well-formed.
    """

    PAD = 256
    BOS = 257
    EOS = 258

    bos_id = BOS
    eos_id = EOS

    def __init__(self, vocab_size: int = 259):
        self._vocab_size = max(int(vocab_size), 259)

    @property
    def vocab_size(self) -> int:
        return self._vocab_size

    def encode(self, text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def decode(self, ids: List[int]) -> str:
        return "".join(f"{i} " for i in ids)

    def decode_token(self, token_id: int) -> str:
        return f"{token_id} "


class StreamDecoder:
    """Incremental detokenizer that never emits broken UTF-8 mid-codepoint.

    Only the undecoded tail is kept, so each push costs O(pending tokens)
    (normally 1-4), not O(all tokens so far).
    """

    def __init__(self, tokenizer) -> None:
        self._tok = tokenizer
        self._pending: List[int] = []

    def push(self, token_id: int) -> str:
        """Feed one token id; returns newly-complete text (may be '')."""
        self._pending.append(token_id)
        text = self._tok.decode(self._pending)
        # A trailing replacement char usually means a split codepoint; hold
        # the pending ids until the codepoint completes.
        if text.endswith("�") and len(self._pending) < 8:
            return ""
        self._pending.clear()
        return text


class HFTokenizer:
    """transformers.AutoTokenizer adapter (lazy import; CPU-only dep)."""

    def __init__(self, name_or_path: str):
        from transformers import AutoTokenizer  # lazy: big import

        self._t = AutoTokenizer.from_pretrained(name_or_path)
        self.bos_id = self._t.bos_token_id or 0
        self.eos_id = self._t.eos_token_id or 0

    @property
    def vocab_size(self) -> int:
        return len(self._t)

    def encode(self, text: str) -> List[int]:
        return self._t.encode(text, add_special_tokens=False)

    def decode(self, ids: List[int]) -> str:
        return self._t.decode(ids, skip_special_tokens=True)

    def decode_token(self, token_id: int) -> str:
        return self._t.decode([token_id], skip_special_tokens=True)

    def apply_chat_template(self, messages) -> Optional[List[int]]:
        """Token ids via the checkpoint's OWN chat template (the exact
        rendering the model was instruction-tuned on), or None when the
        tokenizer ships no template — the API layer then falls back to the
        generic render_chat_prompt flattening.

        Capability parity with the reference serving real Ollama models
        transparently (tunnel/src/serve.rs:219): Ollama applies the model's
        Modelfile template server-side; our engine mode does the same via
        the HF tokenizer's template."""
        if not getattr(self._t, "chat_template", None):
            return None
        return self._t.apply_chat_template(
            messages, add_generation_prompt=True, tokenize=True
        )
