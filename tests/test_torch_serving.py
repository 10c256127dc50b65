"""The port's ServingEngine against the JAX package's, mirroring
tests/test_serving_and_roofline.py::TestServingEngine: the smoke configs of
llama3.2-3b (dense), recurrentgemma-2b (hybrid), rwkv6-7b (ssm),
llama4-maverick-400b-a17b (moe), llama-3.2-vision-11b (vlm) and
whisper-large-v3 (audio; both engines hand these two a zero context) in
float32, max_batch=2, max_seq=48, four 12-token prompts, 4 generated tokens
each.  The port's engine carries the JAX engine's weights
(``params_from_jax``) and runs on the CPU.

Checked: the generated tokens are equal; ``stats()["kv_ops"]`` and
``["locality"]`` are equal; the page-table ``KVStoreState`` (read cache
included) and the admission queue's state are bitwise equal.  With
``replicas=2`` and a ``FaultPlan`` (a leader kill; a kill and a revive on
the remote-DMA backend), the tokens, ``stats()["replication"]`` (detector
included), the page table, every replica, the log and the detector states
are equal too.  The logits
agree to float32 rounding (tests/test_torch_model.py,
tests/test_torch_recurrent.py, tests/test_torch_moe.py), so greedy tokens
are compared exactly."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
from torch_port_ref import (assert_trees_equal, jax_to_numpy,  # noqa: E402
                            reference_core, torch_to_numpy)

import repro_torch.core as pt  # noqa: E402
from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.core.queue import queue_state_to_numpy  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving import MAX_WINDOW, P_NODES, ServingEngine  # noqa: E402


@pytest.fixture(scope="module",
                params=["llama3.2-3b", "recurrentgemma-2b", "rwkv6-7b",
                        "llama4-maverick-400b-a17b", "llama-3.2-vision-11b",
                        "whisper-large-v3"])
def engines(request):
    reference_core()
    from repro.configs import get_smoke_config as jax_smoke
    from repro.serving.engine import ServingEngine as JaxEngine
    jcfg = jax_smoke(request.param).replace(dtype="float32")
    jeng = JaxEngine(jcfg, max_batch=2, max_seq=48)
    cfg = get_smoke_config(request.param).replace(dtype="float32")
    eng = ServingEngine(cfg, max_batch=2, max_seq=48, device="cpu",
                        params=params_from_jax(jax_to_numpy(jeng.params),
                                               device="cpu"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, cfg.vocab, size=(12,)).astype(np.int32)
               for _ in range(4)]
    return jeng.generate(prompts, gen_len=4), jeng, \
        eng.generate(prompts, gen_len=4), eng


def test_tokens_and_stats_match_the_reference(engines):
    jouts, jeng, outs, eng = engines
    assert outs == [[int(t) for t in o] for o in jouts]
    assert len(outs) == 4 and all(len(o) == 4 for o in outs)
    js, ts = jeng.stats(), eng.stats()
    assert ts["kv_ops"] == js["kv_ops"]
    assert ts["locality"] == js["locality"]
    assert ts["kv_ops"][pt.INSERT] == ts["kv_ops"][pt.DELETE]
    assert ts["locality"]["local_fraction"] == 1.0
    assert ts["registered_region_bytes"] == js["registered_region_bytes"]
    assert eng.pages.L >= P_NODES * MAX_WINDOW


def test_channel_states_match_the_reference(engines):
    _jo, jeng, _o, eng = engines
    assert_trees_equal(jax_to_numpy(jeng._kv_state),
                       pt.state_to_numpy(eng._kv_state), "page table")
    assert_trees_equal(jax_to_numpy(jeng._q_state),
                       queue_state_to_numpy(eng._q_state), "admission queue")


# The replicated page table with failover, mirroring
# tests/test_failover.py::TestEngineFailover: a leader kill (one-sided
# backend), and a kill plus a revive past the ring's capacity, so that the
# snapshot rejoin runs (remote-DMA backend).
REPLICATED = {
    "kill": dict(backend=None, plan=dict(kills={0: 1}), n_prompts=2),
    "kill_revive_pallas": dict(backend="pallas",
                               plan=dict(kills={0: 1}, revives={0: 6}),
                               n_prompts=4),
}


@pytest.fixture(scope="module", params=sorted(REPLICATED))
def replicated(request):
    core = reference_core()
    from repro.configs import get_smoke_config as jax_smoke
    from repro.distributed.fault import FaultPlan as JaxPlan
    from repro.serving.engine import ServingEngine as JaxEngine
    from repro_torch.distributed import FaultPlan
    case = REPLICATED[request.param]
    jcfg = jax_smoke("llama3.2-3b").replace(dtype="float32")
    jeng = JaxEngine(jcfg, max_batch=2, max_seq=32, replicas=2,
                     fault_plan=JaxPlan(**case["plan"]),
                     backend=case["backend"])
    cfg = get_smoke_config("llama3.2-3b").replace(dtype="float32")
    eng = ServingEngine(cfg, max_batch=2, max_seq=32, replicas=2,
                        fault_plan=FaultPlan(**case["plan"]),
                        backend=case["backend"], device="cpu",
                        params=params_from_jax(jax_to_numpy(jeng.params),
                                               device="cpu"))
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, cfg.vocab, size=(8,)).astype(np.int32)
               for _ in range(case["n_prompts"])]
    return request.param, core, jeng.generate(prompts, gen_len=2), jeng, \
        eng.generate(prompts, gen_len=2), eng


def test_replicated_engine_survives_failover_like_the_reference(replicated):
    name, _core, jouts, jeng, outs, eng = replicated
    assert outs == [[int(t) for t in o] for o in jouts]
    rep, jrep = eng.stats()["replication"], jeng.stats()["replication"]
    assert rep == jrep
    assert rep["failovers"] == 1 and rep["epoch"] == 1
    assert rep["detected_failovers"] == 1 and rep["leader"] != 0
    assert rep["dropped"] == 0 and rep["lag"] == 0
    assert rep["diverged_leaves"] == [0, 0]
    assert eng.replica_divergence() == [0, 0]
    if name == "kill":
        assert rep["alive"][0] is False
    else:
        assert rep["alive"] == [True] * P_NODES
        assert rep["rejoins_snapshot"] == 1 and rep["rejoin_chunks"] > 0
        assert rep["detector"]["alive"] == [True] * P_NODES
        assert eng.page_log.ring.publishes > 0


def test_replicated_engine_states_match_the_reference(replicated):
    _name, _core, _jo, jeng, _o, eng = replicated
    assert_trees_equal(jax_to_numpy(jeng._kv_state),
                       pt.state_to_numpy(eng._kv_state), "page table")
    for i, (a, b) in enumerate(zip(jeng._rep_states, eng._rep_states)):
        assert_trees_equal(jax_to_numpy(a), pt.state_to_numpy(b),
                           f"replica {i}")
    assert_trees_equal(jax_to_numpy(jeng._log_state),
                       torch_to_numpy(eng._log_state), "page log")
    assert_trees_equal(jax_to_numpy(jeng._det_state),
                       torch_to_numpy(eng._det_state), "detector")
    ts, js = eng.stats(), jeng.stats()
    assert ts["kv_ops"] == js["kv_ops"] and ts["backend"] == js["backend"]
    assert ts["registered_region_bytes"] == js["registered_region_bytes"]


def test_fault_plan_requires_replicas():
    from repro_torch.distributed import FaultPlan
    cfg = get_smoke_config("llama3.2-3b")
    with pytest.raises(ValueError, match="replicas"):
        ServingEngine(cfg, fault_plan=FaultPlan(kills={0: 0}), device="cpu")


def test_serve_launcher_runs_the_replicated_engine(capsys):
    from repro_torch.launch.serve import main
    outs, stats = main(["--arch", "llama3.2-3b", "--smoke", "--device",
                        "cpu", "--requests", "4", "--prompt-len", "8",
                        "--gen-len", "2", "--max-batch", "2", "--replicas",
                        "2", "--kill-leader-at", "1", "--revive-at", "6",
                        "--backend", "pallas"])
    rep = stats["replication"]
    assert len(outs) == 4 and rep["detected_failovers"] == 1
    assert rep["rejoins_snapshot"] == 1 and rep["diverged_leaves"] == [0, 0]
    assert "[serve] replication" in capsys.readouterr().out


def test_engine_defaults_to_the_card(monkeypatch):
    """Without ``device`` the engine (and the launcher) run on the card;
    with none present they raise instead of falling back to the CPU."""
    import torch
    from repro_torch.launch.serve import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_smoke_config("llama3.2-3b")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--arch", "llama3.2-3b", "--smoke"])


def _serve_on_the_cpu(capsys, arch):
    from repro_torch.launch.serve import main
    outs, stats = main(["--arch", arch, "--smoke", "--device",
                        "cpu", "--requests", "3", "--prompt-len", "8",
                        "--gen-len", "3", "--max-batch", "2"])
    assert len(outs) == 3 and all(len(o) == 3 for o in outs)
    assert stats["kv_ops"][pt.INSERT] == stats["kv_ops"][pt.DELETE]
    assert "[serve] 3 requests" in capsys.readouterr().out


def test_serve_launcher_runs_on_the_cpu(capsys):
    _serve_on_the_cpu(capsys, "llama3.2-3b")


def test_serve_launcher_takes_llama4_maverick(capsys):
    _serve_on_the_cpu(capsys, "llama4-maverick-400b-a17b")
