"""Process launcher — the port's ``python -m byteps_tpu_torch.launcher``.

This slice ports one role of ``byteps_tpu/launcher.py``:
``DMLC_ROLE=serve`` builds the serving engine from ``BYTEPS_SERVE_*``
(the dense slot engine, or with ``BYTEPS_SERVE_PAGED=1`` the paged one)
and blocks on the TCP frontend (``serving/frontend.py:serve_from_env``),
on the GPU.  The worker, parameter-server and router roles are later
slices and exit non-zero with a notice.

Usage::

    DMLC_ROLE=serve BYTEPS_SERVE_PORT=9000 python -m byteps_tpu_torch.launcher

(``BYTEPS_SERVE_MODEL`` overrides the default model, d_model 128 over
4 heads of 32, as in the JAX serve role.)
"""

from __future__ import annotations

import os
import sys


def main() -> int:
    env = dict(os.environ)
    role = env.get("DMLC_ROLE", "worker")
    if role == "serve":
        from .serving.frontend import serve_from_env

        return serve_from_env(env)
    print(f"byteps_tpu_torch.launcher: role {role!r} is not ported yet; "
          f"only DMLC_ROLE=serve runs in this package (use "
          f"byteps_tpu.launcher for the others)", file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
