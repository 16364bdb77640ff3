"""Draft-free speculation: n-gram prompt-lookup proposals — a copy of
``byteps_tpu/serving/spec.py`` (numpy only; the port imports nothing of
the JAX package).

Speculative decoding guesses ``k`` continuations of a request and
verifies them all in ONE forward of ``k + 1`` query positions; the
proposer here guesses from the request's OWN history (prompt lookup):
repetitive output keeps emitting spans that already appeared, and a
trailing-n-gram match finds them for the cost of a CPU substring scan.

This module is the proposer; the engine owns verification
(``serving/engine.py`` ``_verify_tick``, the paged-attention kernel at
``tq = k + 1``).  A proposal is only a guess: the verifier accepts a
proposed token only when it equals the token the model itself produced
at that position, so a wrong proposal can never change the output
stream, only waste verify width.

Determinism: the scan is pure (numpy over the request's token history,
most-recent match wins, longest n-gram first).
"""

from __future__ import annotations

from typing import List

import numpy as np

__all__ = ["NgramProposer"]


class NgramProposer:
    """Propose up to ``k`` continuation tokens for a request from its
    own prompt + emitted history.

    For ``n`` from ``ngram`` down to ``min_ngram``, the context's
    trailing ``n`` tokens are matched against every earlier position;
    the most recent (rightmost) occurrence wins and the tokens
    following it are proposed.  Longest-n-first mirrors vLLM's ngram
    speculator: a long match is stronger evidence the continuation
    repeats.  Returns an empty list when nothing matches — the engine
    then runs the plain one-token decode for free (no verify width is
    ever spent on requests with nothing to propose).

    ``min_ngram`` floors the match length at 2 by default: a single
    repeated token is near-certain noise on non-repetitive output
    (any vocabulary reuse fires it), and every false proposal costs a
    widened verify forward — the floor is what keeps speculation's
    overhead near zero on workloads it cannot help.
    """

    __slots__ = ("k", "ngram", "min_ngram")

    def __init__(self, k: int, ngram: int = 3, min_ngram: int = 2):
        if k < 1:
            raise ValueError(f"speculation depth k must be >= 1, got {k}")
        if ngram < 1:
            raise ValueError(f"ngram must be >= 1, got {ngram}")
        self.k = k
        self.ngram = ngram
        self.min_ngram = max(1, min(min_ngram, ngram))

    def propose(self, context: np.ndarray, max_tokens: int) -> List[int]:
        """Up to ``min(k, max_tokens)`` proposed continuations of
        ``context`` (``[T]`` int32: prompt + every emitted token, the
        last entry being the token the next decode step will input).
        ``max_tokens`` lets the engine cap proposals at the request's
        remaining row space / token budget — proposing past either
        would waste verify width on tokens that can never be emitted."""
        cap = min(self.k, max_tokens)
        T = int(context.shape[0])
        if cap < 1 or T < 2:
            return []
        # byte-level search: int32 tokens as a byte string lets C-speed
        # rfind do the scan (this runs per active slot per tick on the
        # engine's tick thread — a numpy sliding-window compare measured
        # ~50us/call vs ~3us here).  A match must be 4-byte aligned to
        # be a real token match; misaligned hits (possible when token
        # byte patterns straddle values) just continue the search left.
        data = context.tobytes()
        for n in range(min(self.ngram, T - 1), self.min_ngram - 1, -1):
            pat = data[(T - n) * 4:]
            # prefer the most recent occurrence with a FULL cap-token
            # continuation: on short-period repetition the rightmost
            # occurrence of the tail sits inside the last period and
            # would cap proposals at the period length (the tail of
            # [... 7 7 7 7] recurs one token back, proposing a single
            # 7 per tick).  Fall back to the rightmost occurrence
            # overall — its continuation must still be non-empty, i.e.
            # end at or before position T-1.
            i = self._rfind_aligned(data, pat, (T - cap) * 4)
            if i < 0:
                i = self._rfind_aligned(data, pat, (T - 1) * 4)
            if i < 0:
                continue
            j = i // 4
            cont = context[j + n:j + n + cap]
            if cont.size:
                return [int(t) for t in cont]
        return []

    @staticmethod
    def _rfind_aligned(data: bytes, pat: bytes, end: int) -> int:
        """Rightmost occurrence of ``pat`` fully inside ``data[:end]``
        starting on a 4-byte (int32 token) boundary, or -1."""
        i = data.rfind(pat, 0, end)
        while i >= 0 and i % 4:
            i = data.rfind(pat, 0, i + len(pat) - 1)
        return i
