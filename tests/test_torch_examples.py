"""The port's examples run from the command line on the CPU
(``python -m repro_torch.examples.<name> --device cpu``) and print what the
JAX package's examples print: the same channels, ledger bytes, SST rows and
KVStore results in the quickstart, the same prefill, operation and oracle
counts in the KV-store application (its online oracle checks every read),
at a small size, and the same page-table statistics in the serving demo.
Only the wall-clock time and rate differ, and the serving demo's sampled
tokens, which come from each package's own random weights."""
import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")
from torch_port_ref import reference_core  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _port(name, *args):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in [env.get("PYTHONPATH")] if p])
    out = subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}", "--device",
         "cpu", *args], capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def _reference(name, capsys, **kw):
    reference_core()
    spec = importlib.util.spec_from_file_location(
        f"examples_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    capsys.readouterr()
    mod.main(**kw)
    return capsys.readouterr().out


def _untimed(out):
    return re.sub(r" in [0-9.]+s \([0-9]+ ops/s wall,", " in <t>,", out)


def test_quickstart_prints_what_the_reference_prints(capsys):
    out = _port("quickstart")
    assert "quickstart done." in out and "registered channels:" in out
    assert out == _reference("quickstart", capsys)


def test_kvstore_app_prints_what_the_reference_prints(capsys):
    out = _port("kvstore_app", "--keyspace", "64", "--rounds", "4")
    assert "linearizability holds." in out
    assert _untimed(out) == _untimed(
        _reference("kvstore_app", capsys, keyspace=64, rounds=4))


def test_serve_demo_prints_what_the_reference_prints(capsys):
    """The serving demo's page table: the same requests, tokens and
    kvstore statistics (INSERT = DELETE; the launcher checks it)."""
    out = _port("serve_demo").splitlines()
    ref = _reference("serve_demo", capsys).splitlines()
    assert out[0].startswith("[serve] 8 requests × 8 tokens on cpu in ")
    assert ref[0].startswith("[serve] 8 requests × 8 tokens in ")
    assert len(out[1].split(",")) == 8 and out[1].startswith(
        "[serve] sample output: [")
    assert out[2].startswith("[serve] page-table (kvstore) stats: ")
    assert out[2:] == ref[2:]
