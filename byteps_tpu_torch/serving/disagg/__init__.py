"""Disaggregated prefill/decode serving tiers — the port of
``byteps_tpu/serving/disagg``.

A **prefill** replica runs a request's prompt, parks its finished KV
blocks, and ships them block by block over ``OP_KV_BLOCKS`` to the
**decode** replica a router picked, which stages them in its own paged
pool and adopts them at the decode dispatch's admission in place of a
prefill.  Every failure downgrades to decode-side re-prefill (the
resume path), never to a wrong answer.  The wire is the JAX package's,
so a ship crosses between the two packages in either direction.
"""

from .ship import (  # noqa: F401
    KVShipAbortedError,
    KVShipDigestError,
    KVShipError,
    KVShipGeometryError,
    KVShipSequenceError,
    KVStager,
    pool_geometry,
    ship_parked,
)
