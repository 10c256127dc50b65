"""The port stands alone: ``repro_torch``, ``chip_smoke.py``,
``chip_compare.py`` and ``chip_bwd_faults.py`` import neither JAX nor the
JAX package, and the port's entry points run on the card unless the
caller asks for the CPU."""
import ast
from pathlib import Path

import pytest
import torch

import repro_torch.core as pt

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "chip_compare.py",
       ROOT / "chip_bwd_faults.py"]


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {mod}"


def test_default_device_is_the_card(monkeypatch):
    """make_manager(P) means the card; with none present it raises rather
    than running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.make_manager(4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.state_from_numpy(pt.state_to_numpy(_tiny_state()))
    assert pt.make_manager(4, device="cpu").device.type == "cpu"


def _tiny_state():
    mgr = pt.make_manager(2, device="cpu")
    return pt.KVStore(None, "kv", mgr, slots_per_node=2).init_state()


def test_channel_names_and_regions_mirror_the_reference():
    mgr = pt.make_manager(2, device="cpu", backend="pallas")
    kv = pt.KVStore(None, "kv", mgr, slots_per_node=4, num_locks=3,
                    index_capacity=16)
    assert kv.backend.name == "pallas" and kv.rows_region.backend is kv.backend
    assert sorted(mgr.channels) == ["kv", "kv/data", "kv/locks",
                                    "kv/tracker_acks", "kv/tracker_acks/ov0",
                                    "kv/tracker_acks/ov1"]
    assert mgr.regions["kv.index"].nbytes == 16 * 5 * 4
    assert mgr.regions["kv/data.buf"].nbytes == 4 * 5 * 4
    with pytest.raises(ValueError, match="collision"):
        pt.KVStore(None, "kv", mgr, slots_per_node=4)
