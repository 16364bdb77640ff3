"""Process launcher — the port's ``python -m byteps_tpu_torch.launcher``,
after ``byteps_tpu/launcher.py``.

* ``DMLC_ROLE=worker`` (the default) runs the command given on the
  command line as one worker: it checks the DMLC cluster contract and
  starts the command with the variables ``api.init`` reads
  (``BYTEPS_COORDINATOR_ADDR`` from ``DMLC_PS_ROOT_URI`` and
  ``DMLC_PS_ROOT_PORT``, ``BYTEPS_NUM_PROCESSES``, ``BYTEPS_PROCESS_ID``
  and ``BYTEPS_LOCAL_RANK``), and exits with its exit code.  One launch a
  worker: ``DMLC_NUM_WORKER=2`` needs two launches, with
  ``DMLC_WORKER_ID`` 0 and 1.
* ``DMLC_ROLE=serve`` builds the serving engine from ``BYTEPS_SERVE_*``
  and blocks on the TCP frontend (``serving/frontend.py:
  serve_from_env``), on the GPU;
* ``DMLC_ROLE=router`` builds the serving router from
  ``BYTEPS_ROUTER_*`` and blocks on its TCP frontend
  (``serving/router.py:router_from_env``), host code only;
* ``DMLC_ROLE=server`` with ``BYTEPS_ENABLE_ASYNC=1`` runs one async
  parameter-server shard (``engine/ps_server.py:serve``), host code only,
  on ``BYTEPS_SERVER_PORT`` (default ``DMLC_PS_ROOT_PORT`` + 100 +
  ``DMLC_SERVER_ID``), restarting it after a crash up to
  ``BYTEPS_SERVER_MAX_RESTARTS`` times, ``BYTEPS_SERVER_RESTART_BACKOFF_MS``
  apart (a fresh store each time: the workers' client re-seeds it);
  without async mode it exits 0 with a notice (the synchronous path
  needs no server tier);
* ``DMLC_ROLE=scheduler`` exits 0 with a notice: ``torch.distributed``'s
  TCP rendezvous replaces the DMLC scheduler.

Usage::

    DMLC_NUM_WORKER=2 DMLC_WORKER_ID=0 DMLC_PS_ROOT_URI=10.0.0.1 \\
        DMLC_PS_ROOT_PORT=29500 python -m byteps_tpu_torch.launcher \\
        python train.py ...
    DMLC_ROLE=serve BYTEPS_SERVE_PORT=9000 python -m byteps_tpu_torch.launcher
    DMLC_ROLE=server BYTEPS_ENABLE_ASYNC=1 DMLC_SERVER_ID=0 \\
        DMLC_PS_ROOT_PORT=29500 python -m byteps_tpu_torch.launcher
"""

from __future__ import annotations

import os
import subprocess
import sys
import time


def _serve_supervised(serve, port: int, env: dict) -> int:
    """Run one PS shard, restarting on a crash up to
    ``BYTEPS_SERVER_MAX_RESTARTS`` times (0 = die on the first crash).
    Each restart binds the same port with a fresh store; the workers'
    client re-seeds the tensors it finds missing."""
    max_restarts = int(env.get("BYTEPS_SERVER_MAX_RESTARTS", "0") or "0")
    backoff = float(env.get("BYTEPS_SERVER_RESTART_BACKOFF_MS",
                            "1000")) / 1e3
    attempt = 0
    while True:
        try:
            serve(port)
            return 0
        except KeyboardInterrupt:
            return 0
        except Exception as e:
            attempt += 1
            if attempt > max_restarts:
                print(f"byteps_tpu_torch.launcher: PS shard crashed "
                      f"({e!r}); restart budget exhausted "
                      f"({max_restarts})", file=sys.stderr)
                return 1
            print(f"byteps_tpu_torch.launcher: PS shard crashed ({e!r}); "
                  f"restart {attempt}/{max_restarts} in {backoff:.1f}s",
                  file=sys.stderr)
            time.sleep(backoff)


def _check_env(env: dict) -> None:
    """Validate the cluster contract (reference launch.py:10-31)."""
    required = ["DMLC_NUM_WORKER", "DMLC_ROLE"]
    if int(env.get("DMLC_NUM_WORKER", "1")) > 1:
        required += ["DMLC_WORKER_ID", "DMLC_PS_ROOT_URI",
                     "DMLC_PS_ROOT_PORT"]
    missing = [k for k in required if k not in env]
    if missing:
        raise SystemExit(f"byteps_tpu_torch.launcher: missing required "
                         f"env: {', '.join(missing)}")


def build_child_env(env: dict) -> dict:
    """The worker command's environment: the DMLC contract rendered as
    the variables ``api.init`` reads."""
    child = dict(env)
    nproc = int(env.get("DMLC_NUM_WORKER", "1"))
    if nproc > 1:
        uri = env["DMLC_PS_ROOT_URI"]
        port = env.get("DMLC_PS_ROOT_PORT", "1234")
        child["BYTEPS_COORDINATOR_ADDR"] = f"{uri}:{port}"
        child["BYTEPS_NUM_PROCESSES"] = str(nproc)
        child["BYTEPS_PROCESS_ID"] = env.get("DMLC_WORKER_ID", "0")
    # one worker per launch: its local rank is 0 unless the caller says
    # otherwise (api.local_rank)
    child.setdefault("BYTEPS_LOCAL_RANK", "0")
    return child


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    env = dict(os.environ)
    env.setdefault("DMLC_ROLE", "worker")
    role = env["DMLC_ROLE"]
    if role == "server":
        if env.get("BYTEPS_ENABLE_ASYNC", "0") == "1":
            from .engine import ps_server

            root = int(env.get("DMLC_PS_ROOT_PORT", "1234"))
            server_id = int(env.get("DMLC_SERVER_ID", "0"))
            port = int(env.get("BYTEPS_SERVER_PORT",
                               str(root + 100 + server_id)))
            return _serve_supervised(ps_server.serve, port, env)
        print("byteps_tpu_torch.launcher: role 'server' is only needed for "
              "async-PS mode (BYTEPS_ENABLE_ASYNC=1); the synchronous path "
              "reduces over torch.distributed without a parameter-server "
              "tier. Exiting.")
        return 0
    if role == "serve":
        from .serving.frontend import serve_from_env

        return serve_from_env(env)
    if role == "router":
        from .serving.router import router_from_env

        return router_from_env(env)
    if role == "scheduler":
        print("byteps_tpu_torch.launcher: role 'scheduler' is not needed "
              "(torch.distributed's TCP rendezvous replaces the DMLC "
              "scheduler); exiting.")
        return 0
    if role != "worker":
        print(f"byteps_tpu_torch.launcher: unknown role {role!r}: "
              f"DMLC_ROLE is worker, server, serve, router or scheduler",
              file=sys.stderr)
        return 2
    if not argv:
        raise SystemExit("usage: python -m byteps_tpu_torch.launcher "
                         "COMMAND [ARGS...]")
    _check_env(env)
    proc = subprocess.Popen(argv, env=build_child_env(env))
    try:
        return proc.wait()
    except KeyboardInterrupt:
        proc.terminate()
        return proc.wait()


if __name__ == "__main__":
    raise SystemExit(main())
