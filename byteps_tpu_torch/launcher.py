"""Process launcher — the port's ``python -m byteps_tpu_torch.launcher``.

This package ports two roles of ``byteps_tpu/launcher.py``:

* ``DMLC_ROLE=serve`` builds the serving engine from ``BYTEPS_SERVE_*``
  (the dense slot engine, or with ``BYTEPS_SERVE_PAGED=1`` the paged
  one) and blocks on the TCP frontend (``serving/frontend.py:
  serve_from_env``), on the GPU;
* ``DMLC_ROLE=router`` builds the serving router from
  ``BYTEPS_ROUTER_*`` (with ``BYTEPS_DISAGG``, ``BYTEPS_SLO_*`` and, with
  ``BYTEPS_AUTOSCALE=1``, the autoscaler) and blocks on its TCP frontend
  (``serving/router.py:router_from_env``).  The router is host code and
  touches no device.

The worker, parameter-server and scheduler roles are later slices and
exit non-zero with a notice.

Usage::

    DMLC_ROLE=serve BYTEPS_SERVE_PORT=9000 python -m byteps_tpu_torch.launcher
    DMLC_ROLE=router BYTEPS_ROUTER_REPLICAS=host:9000,host:9001 \\
        python -m byteps_tpu_torch.launcher

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
    if role == "router":
        from .serving.router import router_from_env

        return router_from_env(env)
    print(f"byteps_tpu_torch.launcher: role {role!r} is not ported yet; "
          f"only DMLC_ROLE=serve and DMLC_ROLE=router run in this "
          f"package (use byteps_tpu.launcher for the others)",
          file=sys.stderr)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())
