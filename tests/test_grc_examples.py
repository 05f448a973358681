"""The example flowgraph corpus (examples/grc/*.grc) must be coherent:
every file parses, every connection resolves to declared blocks, and every
clenabled_tpu_* block instantiates a REAL wrapped JAX block by rendering
its grc/*.block.yml make template with the flowgraph's own parameter
values through the fake-gr adapter (the same role the reference's
examples/test_flowgraphs/*.grc corpus plays for its pybind bindings)."""

from __future__ import annotations

import glob
import os
import re
import sys
import types

import numpy as np
import pytest
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRC_DIR = os.path.join(REPO, "examples", "grc")
YML_DIR = os.path.join(REPO, "grc")

GRC_FILES = sorted(glob.glob(os.path.join(GRC_DIR, "*.grc")))


@pytest.fixture()
def fake_gr(monkeypatch):
    from tests.test_gr_compat import _FakeBasicBlock

    gr_mod = types.ModuleType("gnuradio.gr")
    gr_mod.basic_block = _FakeBasicBlock
    gnuradio = types.ModuleType("gnuradio")
    gnuradio.gr = gr_mod
    pmt_mod = types.ModuleType("pmt")
    pmt_mod.intern = lambda s: ("sym", s)
    pmt_mod.to_pmt = lambda x: ("pmt", x)
    monkeypatch.setitem(sys.modules, "gnuradio", gnuradio)
    monkeypatch.setitem(sys.modules, "gnuradio.gr", gr_mod)
    monkeypatch.setitem(sys.modules, "pmt", pmt_mod)
    return gr_mod


def _load_yml(block_id: str) -> dict:
    path = os.path.join(YML_DIR, f"{block_id}.block.yml")
    assert os.path.exists(path), f"no descriptor {path} for {block_id}"
    with open(path) as f:
        return yaml.safe_load(f)


def _eval_variables(doc) -> dict:
    """Evaluate the flowgraph's `variable` blocks into a namespace
    (fixed-point iteration — variables may reference each other)."""
    ns = {"np": np}
    pending = {b["name"]: b["parameters"]["value"]
               for b in doc["blocks"] if b["id"] == "variable"}
    for _ in range(len(pending) + 1):
        for name, expr in list(pending.items()):
            try:
                ns[name] = eval(expr, dict(ns))  # noqa: S307 - test corpus
                del pending[name]
            except Exception:
                continue
    assert not pending, f"unresolvable variables: {pending}"
    return ns


def _render_make(yml: dict, grc_params: dict, ns: dict):
    """Substitute ${param} in the make template with the .grc's values
    (falling back to the descriptor defaults), then eval it."""
    defaults = {p["id"]: str(p["default"])
                for p in yml.get("parameters", [])}
    values = dict(defaults)
    values.update({k: v for k, v in grc_params.items() if k in defaults})

    def sub(m):
        pid = m.group(1).strip().split()[0] if m.group(1) else ""
        assert pid in values, \
            f"{yml['id']}: template references undeclared param {pid!r}"
        return values[pid]

    make = re.sub(r"\$\{\s*([a-zA-Z_0-9]+)\s*\}", sub,
                  yml["templates"]["make"])
    import clenabled_tpu.blocks
    import clenabled_tpu.gr_compat

    glb = dict(ns)
    glb["clenabled_tpu"] = clenabled_tpu
    return eval(make, glb)  # noqa: S307 - rendered descriptor template


def test_corpus_exists_and_is_large_enough():
    """The reference ships 16 demo + 19 per-block flowgraphs;
    the corpus must cover at least 12 mirrors plus the clLog descriptor."""
    assert len(GRC_FILES) >= 12, [os.path.basename(p) for p in GRC_FILES]
    assert len(glob.glob(os.path.join(YML_DIR, "*.block.yml"))) >= 31
    assert os.path.exists(os.path.join(
        YML_DIR, "clenabled_tpu_clLog.block.yml"))


@pytest.mark.parametrize("path", GRC_FILES,
                         ids=[os.path.basename(p) for p in GRC_FILES])
def test_flowgraph_parses_and_connects(path):
    with open(path) as f:
        doc = yaml.safe_load(f)
    assert doc["metadata"]["file_format"] == 1
    assert doc["options"]["parameters"]["title"]
    names = {b["name"] for b in doc["blocks"]}
    assert len(names) == len(doc["blocks"]), "duplicate block names"
    for src, sport, dst, dport in doc["connections"]:
        assert src in names, f"connection from unknown block {src}"
        assert dst in names, f"connection to unknown block {dst}"
        # stream ports are numeric strings; message ports are names
        assert re.fullmatch(r"\d+|[a-z_]+", str(sport))
        assert re.fullmatch(r"\d+|[a-z_]+", str(dport))


@pytest.mark.parametrize("path", GRC_FILES,
                         ids=[os.path.basename(p) for p in GRC_FILES])
def test_tpu_blocks_instantiate_from_descriptors(path, fake_gr,
                                                 monkeypatch):
    """Render each clenabled_tpu_* block's make template with the
    flowgraph's parameters and instantiate it — a loadability check of
    BOTH the flowgraph and the descriptor."""
    monkeypatch.chdir(REPO)   # clKernel1To1 filenames are repo-relative
    with open(path) as f:
        doc = yaml.safe_load(f)
    ns = _eval_variables(doc)
    cl_blocks = {}
    n_cl = 0
    for b in doc["blocks"]:
        if not b["id"].startswith("clenabled_tpu_"):
            continue
        yml = _load_yml(b["id"])
        g = _render_make(yml, b["parameters"], ns)
        assert hasattr(g, "general_work"), b["id"]
        cl_blocks[b["name"]] = (g, yml)
        n_cl += 1
    assert n_cl >= 1, "corpus flowgraph without any clenabled_tpu block"

    # stream/message connection indices must fit the instantiated
    # signatures and registered message ports
    for src, sport, dst, dport in doc["connections"]:
        if src in cl_blocks and str(sport).isdigit():
            g, yml = cl_blocks[src]
            assert int(sport) < len(g._out_sig), \
                f"{src} out port {sport} exceeds signature"
        if src in cl_blocks and not str(sport).isdigit():
            g, yml = cl_blocks[src]
            assert ("sym", sport) in g.registered_ports, \
                f"{src} message port {sport} not registered"
        if dst in cl_blocks and str(dport).isdigit():
            g, yml = cl_blocks[dst]
            assert int(dport) < len(g._in_sig), \
                f"{dst} in port {dport} exceeds signature"
