"""Shared prefix-hash vocabulary for the prefix-aware router: the port's
copy of tf_operator_tpu/serve/prefix.py (the engine's BlockPool names its
cached blocks with `prefix_hash`; the router hashes a prompt's
block-aligned prefixes with `block_prefix_hashes`).

The engine's prefix cache keys blocks on exact block-aligned
token tuples (``prompt[:block_size]``, ``prompt[:2*block_size]``,
...). The router can't ship whole token tuples around — a replica's
digest would be megabytes — so both sides hash each key down to a
short stable digest: the engine publishes the hashes of its cached
keys (``/kv/digest``) and the router hashes an incoming prompt's
block-aligned prefixes the same way, making prefix overlap a cheap
set intersection. blake2b over the token bytes (not Python ``hash``,
which is salted per process) keeps the digest stable across replicas.
"""

from __future__ import annotations

import hashlib


def prefix_hash(tokens) -> str:
    """Stable 16-hex-char digest of one exact token sequence."""
    h = hashlib.blake2b(digest_size=8)
    for tok in tokens:
        h.update(int(tok).to_bytes(8, "little", signed=True))
    return h.hexdigest()


def block_prefix_hashes(tokens, block_size: int, limit: int = 32) -> list:
    """Digests of every block-aligned prefix of ``tokens`` (the same
    keys the engine's prefix cache would index), longest-first capped
    at ``limit`` — incremental, so hashing N prefixes costs one pass
    over the tokens."""
    block_size = int(block_size)
    if block_size < 1:
        return []
    toks = [int(t) for t in tokens]
    out = []
    h = hashlib.blake2b(digest_size=8)
    full = min(len(toks) // block_size, int(limit))
    for j in range(full):
        for tok in toks[j * block_size:(j + 1) * block_size]:
            h.update(tok.to_bytes(8, "little", signed=True))
        out.append(h.copy().hexdigest())
    return out
