"""Env-filtered structured logging.

The reference initialises `tracing-subscriber` from `RUST_LOG` with default
level "info" (reference tunnel/src/main.rs:20-25).  We mirror that contract
with the stdlib: `TUNNEL_LOG` holds either a bare level (``debug``) or a
comma-separated filter list (``info,p2p_llm_tunnel_tpu_torch.endpoints=debug``).
"""

from __future__ import annotations

import logging
import os
import sys

_INITIALIZED = False

_LEVELS = {
    "trace": logging.DEBUG,  # stdlib has no TRACE; map to DEBUG
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "error": logging.ERROR,
}


def init_logging(default: str = "info") -> None:
    """Configure root logging once, honouring the TUNNEL_LOG filter string."""
    global _INITIALIZED
    if _INITIALIZED:
        return
    _INITIALIZED = True

    spec = os.environ.get("TUNNEL_LOG", default)
    base_level = logging.INFO
    directives: list[tuple[str, int]] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            target, _, lvl = part.partition("=")
            directives.append((target.strip(), _LEVELS.get(lvl.strip().lower(), logging.INFO)))
        else:
            base_level = _LEVELS.get(part.lower(), logging.INFO)

    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)-5s %(name)s: %(message)s", "%H:%M:%S")
    )
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(base_level)
    for target, lvl in directives:
        logging.getLogger(target).setLevel(lvl)


def get_logger(name: str) -> logging.Logger:
    init_logging()
    return logging.getLogger(name)
