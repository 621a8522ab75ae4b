"""The plan build's allocator tuning (the reference's ``_tune_allocator``
and ``_trim_allocator``, dccrg_tpu/grid.py:74-108).

The tune raises glibc's mmap and trim thresholds once, lazily, at the
first plan build (never on import); ``DCCRG_NO_MALLOPT=1`` opts out;
``malloc_trim(0)`` runs after a build of more than 2^20 cells, once the
build's frame is gone. The tune changes no value: two child processes,
tuned and opted out, build the refined 32^3 grid of
bench/recommit_bench.py and get plans equal bit for bit. The call sites
are the reference's: the tune at the top of ``_build_plan_impl``, the
trim in ``_construct_plan`` after the impl returns.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

import dccrg_tpu.grid as ref_grid

import dccrg_tpu_torch.grid as G

ROOT = Path(__file__).resolve().parents[1]

CHILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import dccrg_tpu_torch.grid as G
from dccrg_tpu_torch.profiling import amr_slab_grid, plan_digest
state = [G._allocator_tuned]
g = amr_slab_grid(32, "cpu")
print(json.dumps({"tuned_on_import": state[0], "tuned": G._allocator_tuned,
                  "libc": G._libc is not None, "digest": plan_digest(g),
                  "cells": len(g.plan.cells)}))
"""


def _child(opt_out):
    env = dict(os.environ)
    env.pop("DCCRG_NO_MALLOPT", None)
    if opt_out:
        env["DCCRG_NO_MALLOPT"] = "1"
    out = subprocess.run([sys.executable, "-c", CHILD, str(ROOT)], env=env,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_tuned_and_opted_out_builds_are_equal():
    tuned, plain = _child(False), _child(True)
    assert not tuned["tuned_on_import"] and not plain["tuned_on_import"]
    assert tuned["tuned"] and plain["tuned"]
    assert tuned["libc"] and not plain["libc"]
    assert tuned["cells"] == plain["cells"] > 32 ** 3
    assert tuned["digest"] == plain["digest"]


def test_call_sites_match_the_reference(monkeypatch):
    """The tune runs at the top of every build, the trim after builds
    of more than 2^20 cells only — where the reference calls them."""
    import ast
    import inspect
    import textwrap

    for mod in (ref_grid, G):
        fn = ast.parse(textwrap.dedent(
            inspect.getsource(mod.Grid._build_plan_impl))).body[0]
        body = [st for st in fn.body if not (
            isinstance(st, ast.Expr) and isinstance(st.value, ast.Constant))]
        assert ast.unparse(body[0]) == "_tune_allocator()"
        assert "_trim_allocator()" in inspect.getsource(mod.Grid._construct_plan)
    calls = []
    monkeypatch.setattr(G, "_trim_allocator", lambda: calls.append(1))
    g = G.Grid(cell_data={"v": torch.float32})
    monkeypatch.setattr(g, "_build_plan_impl", lambda c, o, h=None: "plan")
    assert g._construct_plan(np.zeros((1 << 20) + 1), None) == "plan"
    assert calls == [1]
    assert g._construct_plan(np.zeros(1 << 20), None) == "plan"
    assert calls == [1]


def test_tune_applies_once_and_honours_the_opt_out(monkeypatch):
    monkeypatch.setattr(G, "_allocator_tuned", False)
    monkeypatch.setattr(G, "_libc", None)
    monkeypatch.setenv("DCCRG_NO_MALLOPT", "1")
    G._tune_allocator()
    assert G._allocator_tuned and G._libc is None
    G._trim_allocator()  # opted out: nothing to trim with
    monkeypatch.setattr(G, "_allocator_tuned", False)
    monkeypatch.delenv("DCCRG_NO_MALLOPT")

    class FakeLibc:
        def __init__(self):
            self.calls = []

        def mallopt(self, *a):
            self.calls.append(("mallopt",) + a)

        def malloc_trim(self, *a):
            self.calls.append(("malloc_trim",) + a)

    fake = FakeLibc()
    import ctypes

    monkeypatch.setattr(ctypes, "CDLL", lambda name: fake)
    G._tune_allocator()
    G._tune_allocator()  # once only
    G._trim_allocator()
    assert fake.calls == [("mallopt", -3, 1 << 30), ("mallopt", -1, 1 << 30),
                          ("malloc_trim", 0)]
