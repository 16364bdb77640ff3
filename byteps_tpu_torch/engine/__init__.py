"""The engine: the wire codec and per-shard I/O workers shared with the
JAX package (``wire.py``), endpoints (``transport.py``), the eager
push_pull engine (``dispatcher.py``, ``handles.py``) and the async
parameter-server tier (``async_ps.py``, ``ps_server.py``)."""
