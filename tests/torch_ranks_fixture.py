"""Shared machinery of the tests whose port side runs in two real ranks
of a gloo group on localhost (tests/test_torch_ranks.py,
tests/test_torch_ranks_models.py): a free port, and a worker script
started once per rank that prints its results as one ``RESULT <json>``
line."""

import json
import os
import socket
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HELD = {0: (0, 1), 1: (2, 3)}  # the partitions or blocks of each rank


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_ranks(script_text, out, n=2):
    """Write ``script_text`` to ``out/worker.py`` and start it once per
    rank with ``(rank, port, out)``; returns the processes."""
    script = out / "worker.py"
    script.write_text(script_text)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    return [subprocess.Popen(
        [sys.executable, str(script), str(r), str(port), str(out)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)]


def collect_ranks(procs, timeout=240):
    """Each rank's ``RESULT`` object; a rank that failed fails the
    caller with the end of its standard error. Kills what is left."""
    res = {}
    try:
        for r, p in enumerate(procs):
            stdout, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, err[-4000:]
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("RESULT ")][-1]
            res[r] = json.loads(line[len("RESULT "):])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return res
